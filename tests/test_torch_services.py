"""The compaction services in the port (paimon_tpu_torch) against the JAX
package, on the CPU (device="cpu" for the port): space-filling curves and
sort-compact, the dedicated and adaptive compactors with the ingest gate,
the append compaction coordinator, bucket rescale, TableCommit's
expire_after_commit switch, and the kernel build's lock.

The JAX package's tests/test_zorder.py (all five), tests/test_compactor.py
(all seventeen), tests/test_dedicated_compaction.py's three single-process
tests, tests/test_options_wave_c.py::test_zorder_var_length_contribution
and tests/test_review_regressions.py's two expire_after_commit tests each
have a counterpart here, run against both packages where the JAX package
takes part. Cross-package: the curves' lanes bit for bit; a sort-compact by
each package leaves the same rows in the same order in its files, under
every sort engine (K1 admitted or not: its cap is lowered); a table
rescaled by the port reads the same in the JAX package, also at the
snapshot before the rescale.

Where the packages differ on purpose: the JAX package's sort-compact and
append coordinator rewrite files without their deletion vectors, and the
COMPACT commit then drops those vectors, so deleted rows come back; the
port drops the deleted rows (ROADMAP Queue 3 item 22). The tests state the
port's rows outright.

Tolerance: exact. Every value is copied or an integer, never a float
computed differently.
"""

import io
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import paimon_tpu as jt
import paimon_tpu_torch as tt
from paimon_tpu.catalog import FileSystemCatalog as JaxCatalog
from paimon_tpu.data import predicate as jp
from paimon_tpu.ops import zorder as jz
from paimon_tpu.table import compactor as jc
from paimon_tpu.table import load_table as jax_load_table
from paimon_tpu.table import sort_compact as jsc
from paimon_tpu.table import write as jw
from paimon_tpu_torch import metrics as tm
from paimon_tpu_torch.catalog import FileSystemCatalog as PortCatalog
from paimon_tpu_torch.data import predicate as tp
from paimon_tpu_torch.ops import hopper_kernels as hk
from paimon_tpu_torch.ops import zorder as tz
from paimon_tpu_torch.table import compactor as tc
from paimon_tpu_torch.table import load_table as port_load_table
from paimon_tpu_torch.table import rescale as tr
from paimon_tpu_torch.table import sort_compact as tsc
from paimon_tpu_torch.table import write as tw

PKGS = ("jax", "port")


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


def _mod(pkg):
    return jt if pkg == "jax" else tt


def _compactor(pkg):
    return jc if pkg == "jax" else tc


def _catalog(pkg, warehouse, user=None):
    if pkg == "jax":
        return JaxCatalog(warehouse, commit_user=user or pkg)
    return PortCatalog(warehouse, commit_user=user or pkg, device="cpu")


def _open(pkg, path, options=None, user=None):
    if pkg == "jax":
        return jax_load_table(path, commit_user=user or pkg, dynamic_options=options)
    return port_load_table(path, commit_user=user or pkg, dynamic_options=options, device="cpu")


def _py(v):
    return v.item() if hasattr(v, "item") else v


def _rows(batch) -> list[tuple]:
    return [tuple(_py(v) for v in row) for row in batch.to_pylist()]


def _read(table, predicate=None) -> list[tuple]:
    rb = table.new_read_builder()
    if predicate is not None:
        rb = rb.with_filter(predicate)
    return _rows(rb.new_read().read_all(rb.new_scan().plan()))


def _write(table, data):
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.write(data)
    wb.new_commit().commit(w.prepare_commit())


# ---------------------------------------------------------------------------
# space-filling curves (tests/test_zorder.py)
# ---------------------------------------------------------------------------


def _zorder(pkg):
    return jz if pkg == "jax" else tz


@pytest.mark.parametrize("pkg", PKGS)
def test_z_order_interleave_2d(pkg):
    lanes = np.array([[0b1, 0b0], [0b0, 0b1], [0b1, 0b1]], dtype=np.uint32)
    z = _zorder(pkg).z_order_lanes(lanes)

    def zval(row):
        return (int(z[row, 0]) << 32) | int(z[row, 1])

    assert (zval(0), zval(1), zval(2)) == (0b10, 0b01, 0b11)


@pytest.mark.parametrize("pkg", PKGS)
def test_z_order_locality(pkg):
    xs, ys = np.meshgrid(np.arange(16, dtype=np.uint32), np.arange(16, dtype=np.uint32))
    lanes = np.stack([xs.ravel(), ys.ravel()], axis=1)
    z = _zorder(pkg).z_order_lanes(lanes)
    zv = (z[:, 0].astype(np.uint64) << np.uint64(32)) | z[:, 1].astype(np.uint64)
    pts = lanes[np.argsort(zv)].astype(np.int64)
    step = np.abs(np.diff(pts[:, 0])) + np.abs(np.diff(pts[:, 1]))
    assert np.median(step) == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_hilbert_visits_all_points_once(pkg):
    xs, ys = np.meshgrid(np.arange(8, dtype=np.uint32), np.arange(8, dtype=np.uint32))
    lanes = np.stack([xs.ravel(), ys.ravel()], axis=1)
    h = _zorder(pkg).hilbert_lanes(lanes, bits=3)
    assert len({(int(a) << 32) | int(b) for a, b in h}) == 64


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("curve", ["z_order_lanes", "hilbert_lanes"])
def test_curve_lanes_equal_the_reference(curve, k):
    rng = np.random.default_rng(100 + k)
    lanes = rng.integers(0, 1 << 32, size=(3000, k), dtype=np.uint64).astype(np.uint32)
    lanes[:100] = lanes[100:200]  # ties
    got = getattr(tz, curve)(lanes)
    want = getattr(jz, curve)(lanes)
    assert got.dtype == want.dtype == np.uint32
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# sort-compact
# ---------------------------------------------------------------------------


def _xy_table(pkg, warehouse, ident="db.sc", options=None):
    m = _mod(pkg)
    schema = m.RowType.of(("x", m.INT()), ("y", m.INT()), ("v", m.BIGINT()))
    return _catalog(pkg, warehouse, "sc").create_table(ident, schema, options={"bucket": "1", **(options or {})})


@pytest.mark.parametrize("pkg", PKGS)
def test_sort_compact_zorder(pkg, tmp_warehouse):
    t = _xy_table(pkg, tmp_warehouse)
    rng = np.random.default_rng(3)
    n = 2000
    _write(t, {"x": rng.integers(0, 100, n).tolist(), "y": rng.integers(0, 100, n).tolist(), "v": list(range(n))})
    sort_compact = (jsc if pkg == "jax" else tsc).sort_compact
    assert sort_compact(t, ["x", "y"], order="zorder") == n
    out = _read(t)
    assert len(out) == n and sorted(r[2] for r in out) == list(range(n))
    preds = jp if pkg == "jax" else tp
    got = _read(t, preds.and_(preds.between("x", 10, 20), preds.between("y", 10, 20)))
    assert len(got) == sum(1 for r in out if 10 <= r[0] <= 20 and 10 <= r[1] <= 20)


@pytest.mark.parametrize("pkg", PKGS)
def test_sort_compact_rejects_pk(pkg, tmp_warehouse):
    m = _mod(pkg)
    t = _catalog(pkg, tmp_warehouse, "sc2").create_table(
        "db.pk", m.RowType.of(("k", m.BIGINT()), ("v", m.BIGINT())), primary_keys=["k"], options={"bucket": "1"}
    )
    sort_compact = (jsc if pkg == "jax" else tsc).sort_compact
    with pytest.raises(ValueError, match="append-only"):
        sort_compact(t, ["v"])


def _clustered_table(pkg, warehouse, ident, options):
    """An append table of 3,000 rows in 3 commits: two int columns, a
    string column with nulls elsewhere, and the row number."""
    m = _mod(pkg)
    schema = m.RowType.of(("x", m.INT()), ("s", m.STRING()), ("y", m.BIGINT()), ("n", m.BIGINT()), ("w", m.STRING()))
    t = _catalog(pkg, warehouse).create_table(ident, schema, options=options)
    rng = np.random.default_rng(7)
    for c in range(3):
        n = 1000
        w = np.array([None if i % 7 == 0 else f"w{i % 13}" for i in range(n)], dtype=object)
        _write(t, {"x": rng.integers(-50, 50, n), "s": np.array([f"k{v:03d}" for v in rng.integers(0, 300, n)],
                                                                      dtype=object),
                   "y": rng.integers(0, 1 << 40, n), "n": np.arange(c * n, (c + 1) * n), "w": w})
    return t


def _file_rows(table) -> list[list[tuple]]:
    """Each live file's rows in file order, files by (min_sequence_number,
    file_name) order of their first row's n."""
    store = table.store
    out = []
    for partition, buckets in sorted(store.new_scan().plan().grouped().items()):
        for bucket, files in sorted(buckets.items()):
            rf = store.reader_factory(partition, bucket)
            for f in files:
                out.append(_rows(rf.read(f).data))
    return sorted(out)


@pytest.mark.parametrize("k1_cap", [1 << 18, 1 << 10], ids=["k1", "k2"])
@pytest.mark.parametrize("engine", ["numpy", "xla-segmented", "pallas"])
@pytest.mark.parametrize("order,columns", [("zorder", ["x", "y"]), ("hilbert", ["x", "s"]), ("order", ["s", "x"]),
                                           ("zorder", ["s", "y", "x"])])
def test_sort_compact_leaves_the_reference_order(tmp_warehouse, monkeypatch, order, columns, engine, k1_cap):
    """The same rows in the same order in each file as the JAX package's
    sort-compact. Each bucket pads to 2048 rows: under pallas K1 takes it,
    or, with K1's cap lowered under that, the library sort and K2."""
    monkeypatch.setattr(hk, "_FUSE_MAX_ROWS", k1_cap)
    opts = {"bucket": "2", "bucket-key": "n", "target-file-size": "24 kb", "sort-engine": engine}
    tables = {pkg: _clustered_table(pkg, tmp_warehouse, f"db.sc_{pkg}", opts) for pkg in PKGS}
    assert jsc.sort_compact(tables["jax"], columns, order=order) == 3000
    assert tsc.sort_compact(tables["port"], columns, order=order) == 3000
    files = {pkg: _file_rows(t) for pkg, t in tables.items()}
    assert len(files["port"]) > 2
    assert files["port"] == files["jax"]
    snap = {pkg: t.store.snapshot_manager.latest_snapshot() for pkg, t in tables.items()}
    assert snap["port"].commit_kind == snap["jax"].commit_kind == "COMPACT"
    assert snap["port"].commit_identifier == snap["jax"].commit_identifier == (1 << 63) - 3
    assert sorted(_read(_open("jax", tables["port"].path))) == sorted(_read(tables["jax"]))


@pytest.mark.parametrize("pkg", PKGS)
def test_zorder_var_length_contribution(pkg, tmp_warehouse):
    """tests/test_options_wave_c.py: a one-byte contribution and the size
    range strategy cluster losslessly."""
    m = _mod(pkg)
    schema = m.RowType.of(("id", m.BIGINT()), ("s", m.STRING()))
    t = _catalog(pkg, tmp_warehouse).create_table(
        "db.z", schema,
        options={"bucket": "1", "zorder.var-length-contribution": "1", "sort-compaction.range-strategy": "size"},
    )
    _write(t, {"id": list(range(500)), "s": [f"s{i % 37}" for i in range(500)]})
    sort_compact = (jsc if pkg == "jax" else tsc).sort_compact
    assert sort_compact(t, ["s", "id"], order="zorder") == 500
    assert sorted(r[0] for r in _read(t)) == list(range(500))


@pytest.mark.parametrize("strategy", ["quantity", "size"])
@pytest.mark.parametrize("contrib", ["1", "2", "8"])
def test_var_length_options_match_the_reference(tmp_warehouse, contrib, strategy):
    opts = {"bucket": "1", "zorder.var-length-contribution": contrib, "sort-compaction.range-strategy": strategy,
            "target-file-size": "16 kb"}
    tables = {pkg: _clustered_table(pkg, tmp_warehouse, f"db.v_{pkg}", opts) for pkg in PKGS}
    jsc.sort_compact(tables["jax"], ["s", "x"], order="zorder")
    tsc.sort_compact(tables["port"], ["s", "x"], order="zorder")
    assert _file_rows(tables["port"]) == _file_rows(tables["jax"])


def _dv_append_table(warehouse):
    m = tt
    t = _catalog("port", warehouse).create_table(
        "db.dv", m.RowType.of(("x", m.INT()), ("y", m.INT()), ("n", m.BIGINT())),
        options={"bucket": "1", "deletion-vectors.enabled": "true", "write-only": "true"},
    )
    rng = np.random.default_rng(11)
    for c in range(3):
        _write(t, {"x": rng.integers(0, 64, 400), "y": rng.integers(0, 64, 400), "n": np.arange(c * 400, (c + 1) * 400)})
    deleted = t.delete_where(tp.less_than("n", 150))
    assert deleted == 150
    return t


def test_sort_compact_keeps_deleted_rows_deleted(tmp_warehouse):
    """Fault of the JAX package: its rewrite reads the files without their
    deletion vectors, then the COMPACT commit drops the vectors. The port's
    rewrite drops the deleted rows first."""
    t = _dv_append_table(tmp_warehouse)
    assert tsc.sort_compact(t, ["x", "y"], order="zorder") == 1050
    ns = sorted(r[2] for r in _read(t))
    assert ns == list(range(150, 1200))
    assert sorted(r[2] for r in _read(_open("jax", t.path))) == list(range(150, 1200))


def test_append_coordinator_keeps_deleted_rows_deleted(tmp_warehouse):
    t = _dv_append_table(tmp_warehouse)
    coord = tc.AppendCompactionCoordinator(t)
    tasks = coord.plan(full=True)
    assert len(tasks) == 1 and len(tasks[0].files) == 3
    coord.commit([tc.execute_compaction_task(t, task) for task in tasks])
    assert t.store.snapshot_manager.latest_snapshot().commit_kind == "COMPACT"
    assert len(t.store.new_scan().plan().entries) == 1
    assert [r[2] for r in _read(t)] == list(range(150, 1200))


# ---------------------------------------------------------------------------
# dedicated compaction and the append coordinator
# (tests/test_dedicated_compaction.py)
# ---------------------------------------------------------------------------


def _kv_schema(pkg):
    m = _mod(pkg)
    return m.RowType.of(("k", m.BIGINT()), ("v", m.DOUBLE()))


@pytest.mark.parametrize("pkg", PKGS)
def test_write_only_ingest_plus_compactor(pkg, tmp_warehouse):
    cat = _catalog(pkg, tmp_warehouse, "ingest")
    t = cat.create_table("db.dc", _kv_schema(pkg), primary_keys=["k"], options={"bucket": "1", "write-only": "true"})
    for r in range(6):
        _write(t, {"k": list(range(20)), "v": [float(r * 100 + i) for i in range(20)]})
    assert len(t.store.new_scan().plan().entries) == 6
    before = sorted(_read(t))
    compactor = _compactor(pkg).DedicatedCompactor(t)
    assert compactor.run_once(full=True) is True
    t2 = cat.get_table("db.dc")
    entries = t2.store.new_scan().plan().entries
    assert len(entries) < 6
    assert all(e.file.level == t2.store.options.num_levels - 1 for e in entries)
    assert sorted(_read(t2)) == before
    assert t2.store.snapshot_manager.latest_snapshot().commit_kind == "COMPACT"
    assert compactor.run_once(full=True) is False


@pytest.mark.parametrize("pkg", PKGS)
def test_compactor_abandons_on_conflict(pkg, tmp_warehouse):
    cat = _catalog(pkg, tmp_warehouse, "race")
    t = cat.create_table("db.race", _kv_schema(pkg), primary_keys=["k"], options={"bucket": "1", "write-only": "true"})
    for r in range(4):
        _write(t, {"k": list(range(10)), "v": [float(r * 10 + i) for i in range(10)]})
    before = sorted(_read(t))
    mod = _compactor(pkg)
    c1, c2 = mod.DedicatedCompactor(cat.get_table("db.race")), mod.DedicatedCompactor(cat.get_table("db.race"))
    w1 = c1.table.new_batch_write_builder().new_write()
    w2 = c2.table.new_batch_write_builder().new_write()
    w1.compact(full=True)
    w2.compact(full=True)
    m1, m2 = w1.prepare_commit(), w2.prepare_commit()
    write = jw if pkg == "jax" else tw
    write.TableCommit(c1.table).commit_messages(write.BatchWriteBuilder.COMMIT_IDENTIFIER, m1)
    conflict = mod.CommitConflictError
    with pytest.raises(conflict):
        write.TableCommit(c2.table).commit_messages(write.BatchWriteBuilder.COMMIT_IDENTIFIER, m2)
    assert sorted(_read(cat.get_table("db.race"))) == before
    # the dedicated compactor abandons such a round instead of raising
    assert mod.DedicatedCompactor(cat.get_table("db.race")).run_once(full=True) is False


@pytest.mark.parametrize("pkg", PKGS)
def test_append_coordinator_worker_split(pkg, tmp_warehouse):
    m = _mod(pkg)
    cat = _catalog(pkg, tmp_warehouse, "coord")
    t = cat.create_table("db.ap", m.RowType.of(("p", m.BIGINT()), ("x", m.BIGINT())), partition_keys=["p"],
                         options={"write-only": "true", "compaction.min.file-num": "3"})
    for r in range(4):
        _write(t, {"p": [1] * 5 + [2] * 5, "x": list(range(r * 10, r * 10 + 10))})
    rows_before = sorted(_read(t))
    assert len(t.store.new_scan().plan().entries) == 8
    mod = _compactor(pkg)
    coord = mod.AppendCompactionCoordinator(t)
    tasks = coord.plan()
    assert {(tuple(task.partition), task.bucket) for task in tasks} == {((1,), 0), ((2,), 0)}
    coord.commit([mod.execute_compaction_task(t, task) for task in reversed(tasks)])
    t2 = cat.get_table("db.ap")
    assert sorted(_read(t2)) == rows_before
    assert len(t2.store.new_scan().plan().entries) < 8
    assert t2.store.snapshot_manager.latest_snapshot().commit_kind == "COMPACT"


@pytest.mark.parametrize("full", [False, True])
def test_coordinator_plans_equal_the_reference(tmp_warehouse, full):
    """The same tasks (partition, bucket, file row counts) over the same
    files, and the same rows after each package compacts its copy."""
    tables = {}
    for pkg in PKGS:
        m = _mod(pkg)
        t = _catalog(pkg, tmp_warehouse).create_table(
            f"db.cp_{pkg}", m.RowType.of(("p", m.BIGINT()), ("x", m.BIGINT())), partition_keys=["p"],
            options={"write-only": "true", "compaction.min.file-num": "3", "bucket": "2", "bucket-key": "x"})
        for r in range(7):
            _write(t, {"p": [1] * 6 + [2] * 4, "x": list(range(r * 10, r * 10 + 10))})
        tables[pkg] = t
    plans = {}
    for pkg, t in tables.items():
        tasks = _compactor(pkg).AppendCompactionCoordinator(t).plan(full=full)
        plans[pkg] = sorted((tuple(k.partition), k.bucket, tuple(f.row_count for f in k.files)) for k in tasks)
        coord = _compactor(pkg).AppendCompactionCoordinator(t)
        coord.commit([_compactor(pkg).execute_compaction_task(t, k) for k in tasks])
    assert plans["port"] == plans["jax"] and plans["port"]
    assert _read(tables["port"]) == _read(tables["jax"])


def test_coordinator_refuses_a_primary_key_table(tmp_warehouse):
    t = _catalog("port", tmp_warehouse).create_table("db.pk", _kv_schema("port"), primary_keys=["k"],
                                                     options={"bucket": "1"})
    with pytest.raises(ValueError, match="DedicatedCompactor"):
        tc.AppendCompactionCoordinator(t)


@pytest.mark.parametrize("writer", PKGS)
def test_dedicated_compaction_parity(tmp_warehouse, writer):
    """Write-only commits by one package, each package's DedicatedCompactor
    on a copy of its own: the same live files (level, rows, key range) and
    rows, read by both."""
    tables = {}
    m = _mod(writer)
    for pkg in PKGS:
        t = _catalog(writer, tmp_warehouse).create_table(
            f"db.dp_{pkg}", m.RowType.of(("k", m.BIGINT()), ("v", m.DOUBLE()), ("s", m.STRING())),
            primary_keys=["k"], options={"bucket": "2", "write-only": "true",
                                         "compaction.max-size-amplification-percent": "0"})
        rng = np.random.default_rng(5)
        for r in range(5):
            ks = rng.integers(0, 300, 200)
            _write(t, {"k": ks, "v": ks * 0.5 + r, "s": np.array([f"s{r}"] * 200, dtype=object)})
        tables[pkg] = _open(pkg, t.path)
    for full in (False, True):
        for pkg, t in tables.items():
            _compactor(pkg).DedicatedCompactor(t).run_once(full=full)
    layouts = {}
    for pkg, t in tables.items():
        layouts[pkg] = sorted((e.bucket, e.file.level, e.file.row_count, tuple(e.file.min_key), tuple(e.file.max_key))
                              for e in t.store.new_scan().plan().entries)
    assert layouts["port"] == layouts["jax"]
    assert _read(_open("jax", tables["port"].path)) == _read(tables["jax"]) == _read(tables["port"])


# ---------------------------------------------------------------------------
# the adaptive policy (tests/test_compactor.py)
# ---------------------------------------------------------------------------


def shape(mod, bucket, runs, write_rate=0.0, debt_files=None, partition=()):
    debt = (runs - 1) if debt_files is None else debt_files
    return mod.BucketShape(partition=partition, bucket=bucket, runs=runs, level0_files=max(runs - 1, 0), files=runs,
                           bytes=runs * 1000, debt_files=debt if runs > 1 else 0,
                           debt_bytes=debt * 1000 if runs > 1 else 0, write_rate=write_rate, max_seq=0)


def policy(mod, **kw):
    base = dict(read_amp_ceiling=10, trigger=3, deep_runs=8, max_buckets=1, starvation_s=5.0)
    base.update(kw)
    return mod.AdaptiveCompactionPolicy(**base)


@pytest.mark.parametrize("pkg", PKGS)
def test_hot_bucket_compacts_before_cold(pkg):
    mod = _compactor(pkg)
    decisions, deferred = policy(mod).decide([shape(mod, 1, 4, 1.0), shape(mod, 0, 4, 1000.0)], now_s=0.0)
    assert [d.bucket for d in decisions] == [0] and decisions[0].reason == "hot" and deferred == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_read_amp_ceiling_is_unconditional(pkg):
    mod = _compactor(pkg)
    p = policy(mod, read_amp_ceiling=6, max_buckets=1, deep_runs=8)
    shapes = [shape(mod, b, 6 + b) for b in range(4)] + [shape(mod, 9, 5, 1e9)]
    decisions, _ = p.decide(shapes, now_s=0.0)
    ceiling = [d for d in decisions if d.reason == "ceiling"]
    assert [d.bucket for d in ceiling] == [3, 2, 1, 0]
    assert [d.deep for d in ceiling] == [True, True, False, False]


@pytest.mark.parametrize("pkg", PKGS)
def test_deep_vs_shallow_by_debt_depth(pkg):
    mod = _compactor(pkg)
    decisions, _ = policy(mod, deep_runs=6, max_buckets=2).decide(
        [shape(mod, 0, 7, 10.0), shape(mod, 1, 3, 10.0)], now_s=0.0)
    by_bucket = {d.bucket: d for d in decisions}
    assert by_bucket[0].deep is True and by_bucket[1].deep is False


@pytest.mark.parametrize("pkg", PKGS)
def test_below_trigger_defers(pkg):
    mod = _compactor(pkg)
    decisions, deferred = policy(mod, trigger=4).decide([shape(mod, 0, 2), shape(mod, 1, 3)], now_s=0.0)
    assert decisions == [] and deferred == 2


@pytest.mark.parametrize("pkg", PKGS)
def test_single_run_bucket_is_not_debt(pkg):
    mod = _compactor(pkg)
    decisions, deferred = policy(mod).decide([shape(mod, 0, 1), shape(mod, 1, 0)], now_s=0.0)
    assert decisions == [] and deferred == 0


@pytest.mark.parametrize("pkg", PKGS)
def test_starvation_promotion(pkg):
    mod = _compactor(pkg)
    p = policy(mod, max_buckets=1, starvation_s=5.0, trigger=3)
    cold, hot = shape(mod, 1, 3, 0.0), shape(mod, 0, 4, 1000.0)
    assert [d.bucket for d in p.decide([cold, hot], now_s=0.0)[0]] == [0]
    assert [d.bucket for d in p.decide([cold, hot], now_s=4.0)[0]] == [0]
    assert {d.bucket: d.reason for d in p.decide([cold, hot], now_s=5.5)[0]}[1] == "starvation"


@pytest.mark.parametrize("pkg", PKGS)
def test_starvation_clock_resets_on_compaction(pkg):
    mod = _compactor(pkg)
    p = policy(mod, max_buckets=1, starvation_s=5.0)
    cold = shape(mod, 1, 3)
    p.decide([cold], now_s=0.0)
    p.note_compacted((), 1)
    assert all(d.reason != "starvation" for d in p.decide([cold], now_s=6.0)[0])


@pytest.mark.parametrize("pkg", PKGS)
def test_starvation_free_under_sustained_skew(pkg):
    mod = _compactor(pkg)
    p = policy(mod, max_buckets=1, starvation_s=3.0, trigger=3)
    shapes = [shape(mod, 0, 5, 1e6)] + [shape(mod, b, 3, 0.0) for b in (1, 2, 3)]
    compacted: set[int] = set()
    for step in range(20):
        for d in p.decide(shapes, now_s=float(step))[0]:
            compacted.add(d.bucket)
            p.note_compacted(d.partition, d.bucket)
        if compacted >= {0, 1, 2, 3}:
            break
    assert compacted >= {0, 1, 2, 3}


def test_policy_decisions_equal_the_reference():
    """Random shape sequences: the same decisions and deferrals, round after
    round, from both packages' policies."""
    rng = np.random.default_rng(17)
    pols = {pkg: policy(_compactor(pkg), read_amp_ceiling=7, trigger=3, deep_runs=5, max_buckets=2,
                        starvation_s=4.0) for pkg in PKGS}
    for step in range(40):
        runs = rng.integers(0, 10, 6)
        rates = rng.choice([0.0, 1.0, 50.0, 1e4], 6)
        outs = {}
        for pkg, p in pols.items():
            mod = _compactor(pkg)
            shapes = [shape(mod, b, int(r), float(w), partition=(b % 2,)) for b, (r, w) in enumerate(zip(runs, rates))]
            decisions, deferred = p.decide(shapes, now_s=float(step) * 0.7)
            outs[pkg] = ([(d.partition, d.bucket, d.deep, d.reason, d.runs) for d in decisions], deferred)
            for d in decisions[:1]:
                p.note_compacted(d.partition, d.bucket)
        assert outs["port"] == outs["jax"], step


# ---------------------------------------------------------------------------
# the adaptive service against a table (tests/test_compactor.py)
# ---------------------------------------------------------------------------


def _write_rounds(table, rng, rounds, rows=150, keyspace=400):
    for _ in range(rounds):
        ks = rng.integers(0, keyspace, rows)
        _write(table, {"k": ks, "v": ks.astype(np.float64)})


def _pk_table(warehouse, buckets=2, extra=None, pkg="port", ident="db.ac"):
    opts = {"bucket": str(buckets), "write-only": "true", "write-buffer-rows": "64"}
    opts.update(extra or {})
    return _catalog(pkg, warehouse, "ac").create_table(ident, _kv_schema(pkg), primary_keys=["k"], options=opts)


def _service(t, **kw):
    return tc.AdaptiveCompactorService(t, policy=tc.AdaptiveCompactionPolicy(**kw))


def test_service_round_drains_debt(tmp_warehouse, rng):
    t = _pk_table(tmp_warehouse)
    _write_rounds(t, rng, 6)
    svc = _service(t, read_amp_ceiling=5, trigger=2, deep_runs=6, max_buckets=4)
    assert max(s.runs for s in svc.observe()) > 1
    rows_before = _read(t)
    assert svc.run_round() > 0
    assert all(s.runs <= 1 for s in svc.observe())
    assert _read(t) == rows_before


def test_service_read_amp_bound_enforced(tmp_warehouse, rng):
    t = _pk_table(tmp_warehouse, buckets=3)
    _write_rounds(t, rng, 10, rows=120)
    svc = _service(t, read_amp_ceiling=4, trigger=3, deep_runs=6, max_buckets=1)
    assert max(s.runs for s in svc.observe()) >= 4
    svc.run_round()
    assert all(s.read_amp < 4 for s in svc.observe())


def test_service_skips_clean_table(tmp_warehouse, rng):
    t = _pk_table(tmp_warehouse)
    _write_rounds(t, rng, 1)
    assert tc.AdaptiveCompactorService(t).run_round() == 0


def _compactor_threads():
    return [th for th in threading.enumerate() if th.is_alive() and th.name.startswith("paimon-compactor")]


def test_service_background_thread_lifecycle(tmp_warehouse, rng):
    t = _pk_table(tmp_warehouse, extra={"compaction.adaptive.interval": "50 ms"})
    _write_rounds(t, rng, 6)
    with _service(t, read_amp_ceiling=5, trigger=2, max_buckets=4) as svc:
        deadline = time.time() + 20.0
        while time.time() < deadline:
            if svc.compactions > 0 and all(s.runs <= 1 for s in svc.observe()):
                break
            time.sleep(0.05)
        assert svc.compactions > 0 and svc._errors == []
        assert _compactor_threads()
    assert not _compactor_threads()


def test_service_concurrent_ingest_consistency(tmp_warehouse, rng):
    t = _pk_table(tmp_warehouse, extra={"compaction.adaptive.interval": "30 ms"})
    expected: dict[int, float] = {}
    svc = _service(t, read_amp_ceiling=4, trigger=2, max_buckets=4).start()
    try:
        for i in range(12):
            ks = rng.integers(0, 300, 120)
            vs = ks.astype(np.float64) + i
            _write(t, {"k": ks, "v": vs})
            expected.update(zip(ks.tolist(), vs.tolist()))
    finally:
        svc.close()
    out = _read(t)
    assert len(out) == len(dict(out)) == len(expected)
    assert dict(out) == expected
    assert not _compactor_threads()


def test_admission_gate_bounds_projected_runs(tmp_warehouse, rng):
    tm.registry.reset()
    t = _pk_table(tmp_warehouse, buckets=1)
    _write_rounds(t, rng, 2)
    svc = _service(t, read_amp_ceiling=4, trigger=2, max_buckets=1)
    svc.observe()
    assert svc.admit([0], timeout_s=0.1)
    assert svc.admit([0], timeout_s=0.1)
    t0 = time.time()
    assert not svc.admit([0], timeout_s=0.3)
    assert time.time() - t0 >= 0.25
    assert svc.admit([5], timeout_s=0.1)
    svc.settle([0], landed=False)
    assert svc.admit([0], timeout_s=0.1)
    svc.settle([0], landed=True)
    assert not svc.admit([0], timeout_s=0.2)
    waiter_ok = []
    th = threading.Thread(target=lambda: waiter_ok.append(svc.admit([0], timeout_s=10.0)))
    th.start()
    time.sleep(0.1)
    assert svc.run_round() > 0
    svc.observe()
    th.join(timeout=10.0)
    assert waiter_ok == [True]
    assert tm.compaction_metrics().counter("admission_waits").count >= 2


def test_ingest_gate_wired_into_writer(tmp_warehouse, rng):
    """A write-only flush over the ceiling blocks in the writer itself until
    the service drains the bucket."""
    tm.registry.reset()
    t = _pk_table(tmp_warehouse, buckets=1, extra={
        "compaction.adaptive.read-amp-ceiling": "3", "compaction.adaptive.interval": "60 s",
        "compaction.adaptive.ingest-gate-timeout": "30 s"})
    svc = tc.AdaptiveCompactorService(t).start()
    try:
        assert tc.active_debt_gate(t.path) is svc
        # the service's first round runs as it starts; let it end on the
        # empty table, or it can meet the runs below and compact them
        deadline = time.monotonic() + 30
        while svc.rounds == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        _write_rounds(t, rng, 3, rows=64)
        done = []
        th = threading.Thread(target=lambda: (_write_rounds(t, rng, 1, rows=64), done.append(True)))
        th.start()
        time.sleep(0.5)
        assert not done, "a flush over the ceiling should block"
        svc.run_round()
        th.join(timeout=30)
        assert done
        # counted once the wait ended
        assert tm.compaction_metrics().counter("admission_waits").count >= 1
    finally:
        svc.close()
    assert tc.active_debt_gate(t.path) is None
    assert len(_read(t)) > 0


def test_ingest_gate_off_by_option(tmp_warehouse, rng):
    t = _pk_table(tmp_warehouse, buckets=1, extra={
        "compaction.adaptive.read-amp-ceiling": "2", "compaction.adaptive.interval": "60 s",
        "compaction.adaptive.ingest-gate": "false"})
    svc = tc.AdaptiveCompactorService(t).start()
    try:
        _write_rounds(t, rng, 5, rows=64)
    finally:
        svc.close()
    assert max(s.runs for s in svc.observe()) >= 2


def test_metrics_surface(tmp_warehouse, rng):
    tm.registry.reset()
    t = _pk_table(tmp_warehouse)
    _write_rounds(t, rng, 5)
    svc = _service(t, read_amp_ceiling=50, trigger=2, max_buckets=1)
    svc.observe()
    snap = tm.registry.snapshot()["compaction"]
    assert snap["debt_files"] > 0 and snap["debt_bytes"] > 0 and snap["read_amplification_p99"] > 1
    svc.run_round()
    snap = tm.registry.snapshot()["compaction"]
    assert snap["adaptive_runs"] >= 1 and snap["deferred_buckets"] >= 1


def test_service_rounds_equal_the_reference(tmp_warehouse):
    """The same table written by each package, each package's service for
    three rounds: the same shapes, decisions' effects (live files by level
    and rows) and rows."""
    tables = {pkg: _pk_table(tmp_warehouse, buckets=3, pkg=pkg, ident=f"db.sr_{pkg}",
                             extra={"compaction.max-size-amplification-percent": "0"}) for pkg in PKGS}
    for pkg, t in tables.items():
        _write_rounds(t, np.random.default_rng(8), 7, rows=100)
    seen = {}
    for pkg, t in tables.items():
        mod = _compactor(pkg)
        svc = mod.AdaptiveCompactorService(t, policy=mod.AdaptiveCompactionPolicy(
            read_amp_ceiling=6, trigger=2, deep_runs=5, max_buckets=1, starvation_s=1e9))
        shapes = []
        for _ in range(3):
            shapes.append(sorted((s.bucket, s.runs, s.level0_files, s.files, s.debt_files) for s in svc.observe()))
            svc.run_round()
        seen[pkg] = (shapes, sorted((e.bucket, e.file.level, e.file.row_count) for e in
                                    t.store.new_scan().plan().entries))
    assert seen["port"] == seen["jax"]
    assert _read(tables["port"]) == _read(tables["jax"])


def test_execute_group_seam(tmp_warehouse, rng):
    t = _pk_table(tmp_warehouse, buckets=2)
    _write_rounds(t, rng, 5)
    calls = []
    svc = tc.AdaptiveCompactorService(t, policy=tc.AdaptiveCompactionPolicy(read_amp_ceiling=50, trigger=2,
                                                                            max_buckets=4),
                                      execute_group=lambda group, deep: calls.append((len(group), deep)) or 7)
    assert svc.run_round() == 7 * len(calls) and calls
    assert len(t.store.new_scan().plan().entries) > 2  # nothing compacted locally


# ---------------------------------------------------------------------------
# bucket rescale
# ---------------------------------------------------------------------------


def _rescale_source(warehouse, pkg="port", options=None):
    m = _mod(pkg)
    t = _catalog(pkg, warehouse, "rs").create_table(
        "db.rs", m.RowType.of(("k", m.BIGINT()), ("v", m.DOUBLE()), ("s", m.STRING())), primary_keys=["k"],
        options={"bucket": "1", **(options or {})})
    rng = np.random.default_rng(21)
    for r in range(4):
        ks = rng.integers(0, 2000, 600)
        _write(t, {"k": ks, "v": ks * 1.5 + r, "s": np.array([f"r{r}"] * 600, dtype=object)})
    _write(t, {"k": [5, 6], "v": [None, 1.0], "s": [None, "x"]})
    return t


@pytest.mark.parametrize("new_buckets", [1, 3, 4])
def test_rescale_by_the_port_reads_the_same_in_both(tmp_warehouse, new_buckets):
    t = _rescale_source(tmp_warehouse)
    before = sorted(_read(t))
    pinned = t.store.snapshot_manager.latest_snapshot_id()
    t2 = tr.rescale_table(t, new_buckets)
    assert t2.options.bucket == new_buckets
    assert sorted(_read(t2)) == before
    jax_t = _open("jax", t.path)
    assert jax_t.store.options.bucket == new_buckets
    assert sorted(_read(jax_t)) == before
    snap = t2.store.snapshot_manager.latest_snapshot()
    assert snap.commit_kind == "OVERWRITE" and snap.schema_id == t2.schema.id
    entries = t2.store.new_scan().plan().entries
    assert {e.bucket for e in entries} == set(range(new_buckets)) and {e.total_buckets for e in entries} == {new_buckets}
    # every row lies in hash(key) % new
    for e in entries:
        ks = t2.store.reader_factory(e.partition, e.bucket).read(e.file).data
        assert set(tt.table.bucket.bucket_ids(ks, ["k"], new_buckets).tolist()) == {e.bucket}
    # a reader pinned before the rescale reads the old layout
    for pkg in PKGS:
        old = _open(pkg, t.path, {"scan.snapshot-id": str(pinned)})
        assert sorted(_read(old)) == before


def test_rescale_matches_the_reference(tmp_warehouse):
    """The JAX package's rescale of the same table writes the same files
    per bucket (rows in order) and the same schema."""
    tables = {}
    for pkg in PKGS:
        import os

        wh = os.path.join(tmp_warehouse, pkg)
        os.makedirs(wh)
        tables[pkg] = _rescale_source(wh, pkg)
    from paimon_tpu.table import rescale as jr

    out = {"jax": jr.rescale_table(tables["jax"], 3), "port": tr.rescale_table(tables["port"], 3)}
    per_bucket = {}
    for pkg, t in out.items():
        store = t.store
        per_bucket[pkg] = sorted((e.bucket, e.file.level, _rows(store.reader_factory(e.partition, e.bucket)
                                                                 .read(e.file).data))
                                 for e in store.new_scan().plan().entries)
    assert per_bucket["port"] == per_bucket["jax"]
    assert out["port"].schema.options == out["jax"].schema.options


def test_rescale_keeps_old_vectors_in_the_index_manifest(tmp_warehouse):
    t = _rescale_source(tmp_warehouse, options={"deletion-vectors.enabled": "true"})
    t.delete_where(tp.less_than("k", 100))
    before = sorted(_read(t))
    assert all(r[0] >= 100 for r in before)
    dv_before = t.store.new_scan().plan().dv_indexes()
    assert dv_before
    t2 = tr.rescale_table(t, 2)
    assert sorted(_read(t2)) == before
    plan = t2.store.new_scan().plan()
    assert plan.dv_indexes() == dv_before  # kept, naming files no snapshot lists
    live = {e.file.file_name for e in plan.entries}
    from paimon_tpu_torch.core.deletionvectors import DeletionVectorsIndexFile

    named = DeletionVectorsIndexFile(t2.file_io, t2.path).read_all(next(iter(dv_before.values())))
    assert named and not set(named) & live
    assert sorted(_read(_open("jax", t.path))) == before


def test_rescale_refuses_dynamic_buckets(tmp_warehouse):
    m = tt
    t = _catalog("port", tmp_warehouse).create_table("db.dyn", _kv_schema("port"), primary_keys=["k"])
    with pytest.raises(ValueError, match="fixed-bucket"):
        tr.rescale_messages(t, 2)
    with pytest.raises(ValueError, match=">= 1"):
        tr.rescale_messages(t, 0)
    assert m is tt


# ---------------------------------------------------------------------------
# TableCommit(expire_after_commit=False) (tests/test_review_regressions.py)
# ---------------------------------------------------------------------------


def _expiring(pkg, warehouse, extra=None):
    m = _mod(pkg)
    opts = {"bucket": "1", "snapshot.num-retained.min": "1", "snapshot.num-retained.max": "1",
            "snapshot.time-retained.ms": "0", **(extra or {})}
    return _catalog(pkg, warehouse).create_table(
        f"db.ex_{pkg}", m.RowType.of(("id", m.BIGINT()), ("v", m.DOUBLE())), primary_keys=["id"], options=opts)


@pytest.mark.parametrize("pkg", PKGS)
def test_expire_changelog_files_after_deferred_expiry(pkg, tmp_warehouse):
    import glob
    import os

    t = _expiring(pkg, tmp_warehouse, {"changelog-producer": "input"})
    write = jw if pkg == "jax" else tw
    for i in range(4):
        wb = t.new_batch_write_builder()
        w = wb.new_write()
        w.write({"id": [1], "v": [float(i)]})
        write.TableCommit(t, expire_after_commit=False).commit_messages(wb.COMMIT_IDENTIFIER, w.prepare_commit())
    assert len(glob.glob(os.path.join(t.path, "**", "changelog-*"), recursive=True)) == 4
    assert t.expire_snapshots() == 3
    assert len(glob.glob(os.path.join(t.path, "**", "changelog-*"), recursive=True)) == 1
    assert _read(t) == [(1, 3.0)]


@pytest.mark.parametrize("pkg", PKGS)
def test_expire_hint_stops_at_protected_snapshot(pkg, tmp_warehouse):
    t = _expiring(pkg, tmp_warehouse)
    write = jw if pkg == "jax" else tw
    for i in range(5):
        wb = t.new_batch_write_builder()
        w = wb.new_write()
        w.write({"id": [1], "v": [float(i)]})
        write.TableCommit(t, expire_after_commit=False).commit_messages(wb.COMMIT_IDENTIFIER, w.prepare_commit())
    assert t.store.snapshot_manager.snapshot_count() == 5
    t.create_tag("keep", snapshot_id=2)
    t.expire_snapshots()
    sm = t.store.snapshot_manager
    assert sm.snapshot_exists(2) and sm.earliest_snapshot_id() == 2


# ---------------------------------------------------------------------------
# the kernel build's lock
# ---------------------------------------------------------------------------


def test_kernel_build_runs_once_for_two_threads(monkeypatch):
    """Two threads that launch a kernel first at once build it once and bind
    the same entry."""
    builds = []

    def fake_build():
        builds.append(threading.get_ident())
        time.sleep(0.2)
        return {name: f"/nonexistent/{name}.so" for name in hk.KERNEL_SOURCES}

    class FakeLib:
        def __init__(self, path):
            class Fn:
                argtypes = None
                restype = None

            self.paimon_sort_segments = self.paimon_keep_last = self.paimon_segment_sum = Fn()

    monkeypatch.setattr(hk, "build_kernels", fake_build)
    monkeypatch.setattr(hk.ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(hk, "_KERNELS", {})
    got = []
    barrier = threading.Barrier(2)

    def first_launch():
        barrier.wait()
        got.append(hk._kernel("sort_segments"))

    threads = [threading.Thread(target=first_launch) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
    assert len(builds) == 1
    assert len(got) == 2 and got[0] is got[1]


def test_launch_counts_lose_no_update_across_threads(monkeypatch):
    """Launch counts from several threads at once (the adaptive compactor's
    and a writer's) add up, under a short switch interval."""
    import sys

    monkeypatch.setattr(hk, "launches", dict.fromkeys(hk.KERNEL_SOURCES, 0))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [hk._count("keep_last_mask") for _ in range(20_000)])
                   for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert hk.launches["keep_last_mask"] == 8 * 20_000


@pytest.mark.parametrize("pkg", PKGS)
def test_gate_owners_heat_and_headroom(pkg, tmp_warehouse, rng):
    """The gate's other surface, alike in both packages: charges tagged by
    owner and released at once, the buckets over the ceiling, the write
    heat per bucket and the wait for headroom."""
    mod = _compactor(pkg)
    t = _pk_table(tmp_warehouse, buckets=2, pkg=pkg)
    _write_rounds(t, rng, 3)
    runs = {s.bucket: s.runs for s in mod.AdaptiveCompactorService(t).observe()}
    ceiling = max(runs.values()) + 3
    svc = mod.AdaptiveCompactorService(t, policy=mod.AdaptiveCompactionPolicy(read_amp_ceiling=ceiling, trigger=2))
    svc.observe()
    assert svc.over_ceiling() == []
    assert svc.admit([0, 1], owner="w1") and svc.admit([0], owner="w1")
    assert svc.over_ceiling() == []  # charges are not observed runs
    assert svc.release_owner("w1") == 3 and svc.release_owner("w1") == 0
    for _ in range(ceiling - runs[0]):
        svc.settle([0], landed=True)
    assert [k[1] for k in svc.over_ceiling()] == [0]
    assert not svc.wait_for_headroom(timeout_s=0.1)
    _write_rounds(t, rng, 2)
    svc.observe()
    assert set(svc.heat()) == {0, 1} and all(v >= 0 for v in svc.heat().values())
    svc.run_round()
    svc.observe()
    assert svc.wait_for_headroom(timeout_s=0.1)


@pytest.mark.parametrize("buckets", [None, [0]])
def test_rescale_messages_of_a_pinned_snapshot(tmp_warehouse, buckets):
    """rescale_messages rewrites the rows of the snapshot it is given, and
    of the buckets asked for, committing nothing; both packages write the
    same rows for the same table."""
    from paimon_tpu.table import rescale as jr

    out = {}
    for pkg, mod in (("jax", jr), ("port", tr)):
        import os

        wh = os.path.join(tmp_warehouse, pkg)
        os.makedirs(wh)
        t = _rescale_source(wh, pkg, {"bucket": "2"})
        pinned = t.store.snapshot_manager.latest_snapshot_id() - 1
        latest = t.store.snapshot_manager.latest_snapshot_id()
        sid, msgs, rows = mod.rescale_messages(t, 3, buckets=buckets, snapshot_id=pinned)
        assert sid == pinned and t.store.snapshot_manager.latest_snapshot_id() == latest
        out[pkg] = (rows, sorted((m.bucket, m.total_buckets, tuple(f.row_count for f in m.new_files)) for m in msgs))
    assert out["port"] == out["jax"] and out["port"][0] > 0
