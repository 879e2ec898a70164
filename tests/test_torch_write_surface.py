"""The write surface of the port (paimon_tpu_torch) against the JAX package,
on the CPU (device="cpu" for the port): table and dynamic-partition
overwrite, rowkind.field, the local merge buffer and cross-partition
upsert.

Each table is written by each package from the same seeded rows and read
by both. Compared: the rows, in order; every snapshot (commit kind, commit
identifier, total and delta record counts) with its delta manifest
entries field for field (kind, partition, bucket, total buckets, row
count, key range, sequence range, level, file source, -D rows) and its
index entries (kind, partition, bucket, rows). File names, sizes and times
differ between the packages and are not compared;
compaction.max-size-amplification-percent=0 keeps compaction choices off
file sizes. The JAX package merges with its numpy engine, the port with
its kernels' plain versions (sort-engine=pallas) unless a test says
otherwise.

- Overwrite: a static partition filter, dynamic-partition overwrite (the
  default) and a whole-table overwrite (dynamic-partition-overwrite=false)
  over fixed buckets, dynamic buckets and an unpartitioned table, then a
  commit after the overwrite; the deletion vectors an OVERWRITE keeps
  (ROADMAP Queue 3 item 14).
- rowkind.field: streaming commits whose op column carries +I/-U/+U/-D,
  over a fixed and a dynamic-bucket table; the KeyError of an unknown op.
- Local merge: ColumnBatch.byte_size equal to the JAX package's (the
  buffer drains on it); the buffer's selection equal to the JAX package's
  deduplicate_select on every port engine, below and above K1's bound;
  tables written through a buffer that drains several times a commit;
  every ValueError of the JAX package.
- Cross-partition upsert: keys moving partitions, -D rows without their
  partition, a restart that bootstraps the global index from the files,
  the index TTL; (partition, bucket) per key and the bootstrapped index
  equal to the JAX package's.

The JAX package's tests tests/test_table.py (test_delete_via_rowkind,
test_overwrite_partition, test_local_merge_buffer,
test_local_merge_partitioned_keeps_cross_partition_rows),
tests/test_options_wave.py (test_dynamic_partition_overwrite,
test_rowkind_field), tests/test_options_wave_c.py
(test_cross_partition_index_ttl) and tests/test_crosspartition.py (all)
each have a counterpart here, run against both packages.

Tolerance: exact. Every value is copied, never computed.
"""

import io

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import paimon_tpu as jt
import paimon_tpu_torch as tt
from paimon_tpu.catalog import FileSystemCatalog as JaxCatalog
from paimon_tpu.core.manifest import ManifestCommittable as JaxCommittable
from paimon_tpu.data import predicate as jp
from paimon_tpu.data.batch import ColumnBatch as JaxBatch
from paimon_tpu.data.batch import concat_batches as jax_concat
from paimon_tpu.data.keys import encode_key_lanes_with_pools as jax_lanes
from paimon_tpu.ops.merge import deduplicate_select as jax_dedup_select
from paimon_tpu.table import load_table as jax_load_table
from paimon_tpu.table.crosspartition import CrossPartitionUpsertWrite as JaxCross
from paimon_tpu_torch.catalog import FileSystemCatalog as PortCatalog
from paimon_tpu_torch.core.manifest import ManifestCommittable as PortCommittable
from paimon_tpu_torch.core.mergefn import MergeExecutor
from paimon_tpu_torch.data import predicate as tp
from paimon_tpu_torch.data.batch import ColumnBatch as PortBatch
from paimon_tpu_torch.data.batch import concat_batches as port_concat
from paimon_tpu_torch.data.keys import encode_key_lanes_with_pools as port_lanes
from paimon_tpu_torch.ops import hopper_kernels as hk
from paimon_tpu_torch.options import CoreOptions
from paimon_tpu_torch.table import load_table as port_load_table
from paimon_tpu_torch.table.crosspartition import CrossPartitionUpsertWrite as PortCross

PKGS = ("jax", "port")
ENGINE = {"jax": {"sort-engine": "numpy"}, "port": {"sort-engine": "pallas"}}
STABLE = {"compaction.max-size-amplification-percent": "0"}
DAYS = np.array(["2024-05-01", "2024-05-02", "2024-05-03"], dtype=object)
KINDS = ("+I", "-U", "+U", "-D")


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


@pytest.fixture(autouse=True)
def _plain_download(monkeypatch):
    # the JAX package's plain index download, which the port mirrors
    monkeypatch.setenv("PAIMON_TPU_FORCE_COMPACT", "0")


def _mod(pkg):
    return jt if pkg == "jax" else tt


def _catalog(pkg, warehouse):
    if pkg == "jax":
        return JaxCatalog(warehouse, commit_user=pkg)
    return PortCatalog(warehouse, commit_user=pkg, device="cpu")


def _open(pkg, path, options=None):
    if pkg == "jax":
        return jax_load_table(path, commit_user=pkg, dynamic_options=options)
    return port_load_table(path, commit_user=pkg, dynamic_options=options, device="cpu")


def _schema(pkg, op=False):
    m = _mod(pkg)
    cols = [("dt", m.STRING(False)), ("id", m.BIGINT(False)), ("v", m.DOUBLE()), ("s", m.STRING())]
    return m.RowType.of(*cols, *([("op", m.STRING())] if op else []))


def _create(pkg, warehouse, ident, options, partitioned=True, pk=("dt", "id"), op=False):
    return _catalog(pkg, warehouse).create_table(
        ident, _schema(pkg, op), partition_keys=["dt"] if partitioned else [], primary_keys=list(pk),
        options={**ENGINE[pkg], **options})


def _py(v):
    return v.item() if hasattr(v, "item") else v


def _rows(batch) -> list[tuple]:
    return [tuple(_py(v) for v in row) for row in batch.to_pylist()]


def _read(table, predicate=None) -> list[tuple]:
    rb = table.new_read_builder()
    if predicate is not None:
        rb = rb.with_filter(predicate)
    return _rows(rb.new_read().read_all(rb.new_scan().plan()))


def _batch(seed, n, ids, days=DAYS, kinds=None, op=False) -> tuple[dict, list | None]:
    """n rows over ids [0, ids) and the given days, from one seed; with
    kinds, a row kind each drawn from them (the first row +I)."""
    rng = np.random.default_rng(seed)
    id_ = rng.integers(0, ids, n).astype(np.int64)
    data = {"dt": days[rng.integers(0, len(days), n)], "id": id_, "v": id_ * 0.5 + seed,
            "s": np.array([None if (i + seed) % 5 == 0 else f"s{i}-{seed}" for i in id_], dtype=object)}
    ks = None if kinds is None else [kinds[k] for k in rng.integers(0, len(kinds), n)]
    if op:
        data["op"] = np.array(ks, dtype=object)
        ks = None
    return data, ks


def _commit(table, data, kinds=None, overwrite=None):
    """One batch commit; overwrite=(filter,) makes it an INSERT OVERWRITE."""
    wb = table.new_batch_write_builder()
    if overwrite is not None:
        wb = wb.with_overwrite(*overwrite)
    w = wb.new_write()
    w.write(data, kinds)
    return wb.new_commit().commit(w.prepare_commit())


def _history(path) -> list:
    """Per snapshot: its kind, identifier and record counts, its delta
    manifest entries and its index entries, as the port reads them (the
    entries sorted: the packages list a compaction's inputs in other
    orders)."""
    table = port_load_table(path, device="cpu")
    store = table.store
    sm = store.snapshot_manager
    scan = store.new_scan()
    out = []
    for sid in range(sm.earliest_snapshot_id(), sm.latest_snapshot_id() + 1):
        snap = sm.snapshot(sid)
        entries = sorted(
            (int(e.kind), e.partition, e.bucket, e.total_buckets, e.file.row_count, tuple(e.file.min_key),
             tuple(e.file.max_key), e.file.min_sequence_number, e.file.max_sequence_number, e.file.level,
             e.file.file_source, e.file.delete_row_count)
            for m in scan.manifest_list.read(snap.delta_manifest_list) for e in scan.manifest_file.read(m.file_name)
        )
        index = sorted((e.kind, e.partition, e.bucket, e.row_count)
                       for e in store.new_scan().with_snapshot(sid).plan().index_entries)
        out.append((sid, snap.commit_kind.value, snap.commit_identifier, snap.total_record_count,
                    snap.delta_record_count, entries, index))
    return out


def _parity(paths: dict) -> list[tuple]:
    """The tables each package wrote (paths by writer) have the same
    history, and each reads the same rows in both packages; returns them."""
    assert _history(paths["port"]) == _history(paths["jax"])
    reads = {(w, r): _read(_open(r, p, ENGINE[r])) for w, p in paths.items() for r in PKGS}
    first = reads[("jax", "jax")]
    assert all(got == first for got in reads.values()), {k: len(v) for k, v in reads.items()}
    return first


def _write_both(warehouse, name, scenario, options, **create) -> dict:
    """Run scenario(pkg, table) on a table each package creates; the paths."""
    paths = {}
    for pkg in PKGS:
        table = _create(pkg, warehouse, f"db.{name}_{pkg}", options, **create)
        scenario(pkg, table)
        paths[pkg] = table.path
    return paths


def _last_per_key(batches, key=("dt", "id")) -> dict:
    """key -> (row, kind) of the last row per key over (data, kinds)."""
    out = {}
    for data, kinds in batches:
        n = len(data["id"])
        ks = kinds if kinds is not None else ["+I"] * n
        for i in range(n):
            k = tuple(_py(data[c][i]) for c in key)
            out[k] = (tuple(_py(data[c][i]) for c in ("dt", "id", "v", "s")), ks[i])
    return out


# ---------------------------------------------------------------------------
# table and dynamic-partition overwrite
# ---------------------------------------------------------------------------

OW_LAYOUTS = {
    "fixed": ({"bucket": "2"}, True),
    "dynamic": ({"dynamic-bucket.target-row-num": "15"}, True),
    "unpartitioned": ({"bucket": "1"}, False),
}
OW_MODES = ("static", "dynamic", "whole")


@pytest.mark.parametrize("mode", OW_MODES)
@pytest.mark.parametrize("layout", list(OW_LAYOUTS))
def test_overwrite_parity(tmp_path, layout, mode):
    """Three commits over three days, an overwrite of day 2's rows, one more
    commit: the same snapshots, entries and rows from either writer. Days
    the overwrite does not replace keep their rows; a replaced day (or
    table) holds exactly the new rows and what came after."""
    options, partitioned = OW_LAYOUTS[layout]
    options = {**options, **STABLE, "num-sorted-run.compaction-trigger": "2"}
    if mode == "whole":
        options["dynamic-partition-overwrite"] = "false"
    pk = ("dt", "id") if partitioned else ("id",)
    before = [_batch(s, 40, 30) for s in range(3)]
    new = _batch(10, 25, 40, days=DAYS[1:2])
    after = _batch(11, 10, 40)

    def scenario(pkg, table):
        for data, _ in before:
            _commit(table, data)
        flt = ((lambda p: p == (DAYS[1],)) if partitioned else (lambda p: True),) if mode == "static" else ()
        sids = _commit(table, new[0], overwrite=flt)
        assert [table.store.snapshot_manager.snapshot(i).commit_kind.value for i in sids] == ["OVERWRITE"]
        _commit(table, after[0])

    rows = _parity(_write_both(str(tmp_path), f"ow_{layout}_{mode}", scenario, options, partitioned=partitioned, pk=pk))
    replaced = (lambda r: r[0] == DAYS[1]) if partitioned and mode != "whole" else (lambda r: True)
    kept = {k: v for k, v in _last_per_key(before, pk).items() if not replaced(v[0])}
    want = {**kept, **_last_per_key([new, after], pk)}
    assert sorted(rows) == sorted(v[0] for v in want.values())


def test_overwrite_partition(tmp_path):
    """tests/test_table.py::test_overwrite_partition in both packages."""
    for pkg in PKGS:
        m = _mod(pkg)
        schema = m.RowType.of(("id", m.BIGINT()), ("region", m.STRING()), ("amount", m.DOUBLE()))
        t = _catalog(pkg, str(tmp_path)).create_table(f"db.ow_{pkg}", schema, partition_keys=["region"],
                                                      primary_keys=["region", "id"], options={"bucket": "2"})
        _commit(t, {"id": [1, 2], "region": ["eu", "us"], "amount": [1.0, 2.0]})
        _commit(t, {"id": [9], "region": ["eu"], "amount": [9.0]}, overwrite=(lambda p: p == ("eu",),))
        assert sorted((r[0], r[1]) for r in _read(t)) == [(2, "us"), (9, "eu")]


def test_dynamic_partition_overwrite(tmp_path):
    """tests/test_options_wave.py::test_dynamic_partition_overwrite in both
    packages: the default replaces only the touched partition, false the
    whole table."""
    for pkg in PKGS:
        m = _mod(pkg)
        schema = m.RowType.of(("id", m.BIGINT(False)), ("v", m.DOUBLE()), ("p", m.STRING(False)))
        t = _catalog(pkg, str(tmp_path)).create_table(f"db.dpo_{pkg}", schema, primary_keys=["id", "p"],
                                                      partition_keys=["p"], options={"bucket": "1"})

        def write_p(table, part, ids, overwrite=False):
            arr = np.asarray(ids, dtype=np.int64)
            _commit(table, {"id": arr, "v": arr * 1.0, "p": np.array([part] * len(arr), dtype=object)},
                    overwrite=() if overwrite else None)

        write_p(t, "a", [1, 2])
        write_p(t, "b", [3, 4])
        write_p(t, "a", [9], overwrite=True)
        assert [r[0] for r in sorted(_read(t))] == [3, 4, 9]
        t2 = t.copy({"dynamic-partition-overwrite": "false"})
        write_p(t2, "a", [7], overwrite=True)
        assert [r[0] for r in sorted(_read(t2))] == [7]


def test_overwrite_keeps_deletion_vectors(tmp_path):
    """An OVERWRITE leaves the replaced files' deletion vectors in the index
    manifest in both packages (ROADMAP Queue 3 item 14); no read uses them."""
    def scenario(pkg, table):
        _commit(table, _batch(1, 40, 30)[0])
        assert table.delete_where((jp if pkg == "jax" else tp).less_than("id", 10)) > 0
        _commit(table, _batch(2, 20, 30, days=DAYS[:1])[0], overwrite=())

    paths = _write_both(str(tmp_path), "ow_dv", scenario, {"bucket": "1", "deletion-vectors.enabled": "true"})
    rows = _parity(paths)
    last = _history(paths["port"])[-1]
    assert last[1] == "OVERWRITE" and any(e[0] == "DELETION_VECTORS" for e in last[6])
    new = {k: v[0] for k, v in _last_per_key([_batch(2, 20, 30, days=DAYS[:1])]).items()}
    assert sorted(r for r in rows if r[0] == DAYS[0]) == sorted(new.values())
    assert not any(r[1] < 10 for r in rows if r[0] != DAYS[0]) and {r[0] for r in rows} == set(DAYS)


def test_overwrite_runs_maintenance(tmp_path):
    """Snapshot expiry runs after an OVERWRITE commit, as after any commit."""
    def scenario(pkg, table):
        for s in range(3):
            _commit(table, _batch(s, 20, 30)[0])
        _commit(table, _batch(9, 20, 30)[0], overwrite=())
        sm = table.store.snapshot_manager
        assert (sm.earliest_snapshot_id(), sm.latest_snapshot_id()) == (3, 4)

    _parity(_write_both(str(tmp_path), "ow_expire", scenario,
                        {"bucket": "1", "snapshot.num-retained.min": "1", "snapshot.num-retained.max": "2"}))


# ---------------------------------------------------------------------------
# rowkind.field
# ---------------------------------------------------------------------------

RK_LAYOUTS = {
    "bucket_1": ({"bucket": "1"}, False, ("id",)),
    "dynamic_partitioned": ({"dynamic-bucket.target-row-num": "15"}, True, ("dt", "id")),
}


@pytest.mark.parametrize("layout", list(RK_LAYOUTS))
def test_rowkind_field_parity(tmp_path, layout):
    """Streaming commits whose op column holds each row's kind: the same
    snapshots, entries and rows from either writer, each key at its last
    row unless that row is -D or -U."""
    options, partitioned, pk = RK_LAYOUTS[layout]
    batches = [_batch(s, 40, 30, kinds=("+I",) if s == 0 else KINDS, op=True) for s in range(4)]

    def scenario(pkg, table):
        wb = table.new_stream_write_builder()
        w, c = wb.new_write(), wb.new_commit()
        for i, (data, _) in enumerate(batches, start=1):
            w.write(data)
            c.commit_messages(i, w.prepare_commit())

    paths = _write_both(str(tmp_path), f"rk_{layout}", scenario,
                        {**options, **STABLE, "rowkind.field": "op", "num-sorted-run.compaction-trigger": "3"},
                        partitioned=partitioned, pk=pk, op=True)
    rows = _parity(paths)
    last = {}
    for data, _ in batches:
        for i in range(len(data["id"])):
            last[tuple(_py(data[c][i]) for c in pk)] = tuple(_py(data[c][i]) for c in ("dt", "id", "v", "s", "op"))
    assert sorted(rows) == sorted(r for r in last.values() if r[4] in ("+I", "+U"))
    assert any(r[4] == "-D" for r in last.values())


def test_rowkind_field(tmp_path):
    """tests/test_options_wave.py::test_rowkind_field in both packages."""
    for pkg in PKGS:
        m = _mod(pkg)
        schema = m.RowType.of(("id", m.BIGINT(False)), ("v", m.DOUBLE()), ("rk", m.STRING()))
        t = _catalog(pkg, str(tmp_path)).create_table(f"db.rk_{pkg}", schema, primary_keys=["id"],
                                                      options={"bucket": "1", "rowkind.field": "rk"})
        _commit(t, {"id": np.array([1, 2, 1], dtype=np.int64), "v": np.array([1.0, 2.0, 0.0]),
                    "rk": np.array(["+I", "+I", "-D"], dtype=object)})
        assert [r[0] for r in _read(t)] == [2]


def test_delete_via_rowkind(tmp_path):
    """tests/test_table.py::test_delete_via_rowkind in both packages."""
    for pkg in PKGS:
        m = _mod(pkg)
        schema = m.RowType.of(("id", m.BIGINT()), ("region", m.STRING()), ("amount", m.DOUBLE()))
        t = _catalog(pkg, str(tmp_path)).create_table(f"db.del_{pkg}", schema, primary_keys=["id"],
                                                      options={"bucket": "2"})
        _commit(t, {"id": [1, 2, 3], "region": ["a", "b", "c"], "amount": [1.0, 2.0, 3.0]})
        _commit(t, {"id": [2], "region": [None], "amount": [None]}, kinds=["-D"])
        assert sorted(r[0] for r in _read(t)) == [1, 3]


@pytest.mark.parametrize("bad", ["+X", None, "i"], ids=["unknown", "null", "lower"])
def test_rowkind_field_unknown_op_raises_the_same_keyerror(tmp_path, bad):
    """The first op in row order that is no row kind raises the same
    KeyError in both packages, before anything is written; a kinds argument
    wins over the column."""
    errors = {}
    for pkg in PKGS:
        t = _create(pkg, str(tmp_path), f"db.rk_bad_{pkg}", {"bucket": "1", "rowkind.field": "op"},
                    partitioned=False, pk=("id",), op=True)
        data = {"dt": DAYS[[0, 0, 0]], "id": np.array([1, 2, 3]), "v": [1.0, 2.0, 3.0], "s": ["a", "b", "c"],
                "op": np.array(["+I", bad, "-Q"], dtype=object)}
        w = t.new_batch_write_builder().new_write()
        with pytest.raises(KeyError) as err:
            w.write(data)
        errors[pkg] = err.value.args
        assert _read(t) == []
        _commit(t, data, kinds=["+I"] * 3)
        assert [r[1] for r in _read(t)] == [1, 2, 3]
    assert errors["port"] == errors["jax"]


# ---------------------------------------------------------------------------
# the local merge buffer
# ---------------------------------------------------------------------------


def _bench_batch(pkg, seed, n, nulls=True):
    """The bench schema's columns (id BIGINT, seven values with doubles,
    ints and strings), with nulls where asked."""
    m = _mod(pkg)
    rng = np.random.default_rng(seed)
    schema = m.RowType.of(("id", m.BIGINT(False)), ("c1", m.INT()), ("c2", m.BIGINT()), ("d1", m.DOUBLE()),
                          ("d2", m.FLOAT()), ("s1", m.STRING()), ("s2", m.STRING()), ("b", m.BOOLEAN()))
    ids = rng.integers(0, 10 * n, n)
    nul = (rng.random(n) < 0.2) if nulls else np.zeros(n, dtype=bool)
    data = {
        "id": ids, "c1": [None if x else int(v) for x, v in zip(nul, rng.integers(0, 1000, n))],
        "c2": rng.integers(-(1 << 40), 1 << 40, n), "d1": rng.random(n),
        "d2": [None if x else float(v) for x, v in zip(nul, rng.random(n))],
        "s1": np.array([None if x else "k" * int(v) for x, v in zip(nul, rng.integers(0, 40, n))], dtype=object),
        "s2": np.array([f"value-{v}" for v in rng.integers(0, 10**9, n)], dtype=object),
        "b": [None if x else bool(v) for x, v in zip(nul, rng.integers(0, 2, n))],
    }
    return (JaxBatch if pkg == "jax" else PortBatch).from_pydict(schema, data)


@pytest.mark.parametrize("nulls", [False, True], ids=["no-nulls", "nulls"])
@pytest.mark.parametrize("n", [1, 700, 3000])
def test_byte_size_parity(n, nulls):
    """ColumnBatch.byte_size (the local merge buffer's and the append
    writer's trigger) gives the JAX package's number, also after take,
    slice, filter and concat."""
    j, p = _bench_batch("jax", n, n, nulls), _bench_batch("port", n, n, nulls)
    assert p.byte_size() == j.byte_size()
    idx = np.arange(n)[::-3]
    assert p.take(idx).byte_size() == j.take(idx).byte_size()
    assert p.slice(n // 3, n).byte_size() == j.slice(n // 3, n).byte_size()
    mask = np.arange(n) % 2 == 0
    assert p.filter(mask).byte_size() == j.filter(mask).byte_size()
    assert port_concat([p, p.slice(0, n // 2)]).byte_size() == jax_concat([j, j.slice(0, n // 2)]).byte_size()


def _selection_input(pkg, n):
    m = _mod(pkg)
    rng = np.random.default_rng(n)
    schema = m.RowType.of(("dt", m.STRING(False)), ("id", m.BIGINT(False)), ("v", m.DOUBLE()))
    data = {"dt": DAYS[rng.integers(0, 3, n)], "id": rng.integers(0, max(n // 3, 1), n), "v": rng.random(n)}
    return (JaxBatch if pkg == "jax" else PortBatch).from_pydict(schema, data)


@pytest.mark.parametrize("engine", ["pallas", "xla-segmented", "numpy"])
@pytest.mark.parametrize("n", [5, 1000, (1 << 18) + 4096], ids=["5", "1000", "above_k1_bound"])
def test_local_merge_selection_equals_the_jax_package(engine, n):
    """The buffer's selection over the full primary key (dt STRING, id):
    the lanes, then the rows kept, equal the JAX package's
    deduplicate_select (its xla engine) under every port sort-engine; under
    pallas a batch above K1's bound takes the stock sort + K2."""
    j, p = _selection_input("jax", n), _selection_input("port", n)
    lanes = port_lanes(p, ["dt", "id"])
    assert np.array_equal(lanes, jax_lanes(j, ["dt", "id"]))
    want = jax_dedup_select(lanes)
    ex = MergeExecutor(p.schema, ["id"], options=CoreOptions({"sort-engine": engine}), device="cpu")
    assert np.array_equal(ex.select_last(lanes), want)
    assert (n > hk._FUSE_MAX_ROWS) == (n == (1 << 18) + 4096)


LM_LAYOUTS = {
    "fixed_partitioned": ({"bucket": "2"}, True, ("dt", "id")),
    "dynamic": ({"dynamic-bucket.target-row-num": "20"}, False, ("id",)),
}


@pytest.mark.parametrize("engine", ["pallas", "xla-segmented", "numpy"])
@pytest.mark.parametrize("layout", list(LM_LAYOUTS))
def test_local_merge_table_parity(tmp_path, layout, engine):
    """A 4 kb buffer drains several times in each of three streaming commits
    (batches of 40 rows with -D rows); the same snapshots, entries and rows
    from either writer, whatever the port's sort-engine; the oracle is each
    key's last row."""
    options, partitioned, pk = LM_LAYOUTS[layout]
    commits = [[_batch(10 * c + b, 40, 60, kinds=("+I", "+I", "-D")) for b in range(4)] for c in range(3)]

    def scenario(pkg, table):
        if pkg == "port":
            table = table.copy({"sort-engine": engine})
        wb = table.new_stream_write_builder()
        w, c = wb.new_write(), wb.new_commit()
        for i, batches in enumerate(commits, start=1):
            for data, kinds in batches:
                w.write(data, kinds)
            c.commit_messages(i, w.prepare_commit())

    paths = _write_both(str(tmp_path), f"lm_{layout}_{engine.replace('-', '_')}", scenario,
                        {**options, **STABLE, "local-merge-buffer-size": "4 kb", "write-buffer-rows": "50"},
                        partitioned=partitioned, pk=pk)
    rows = _parity(paths)
    last = _last_per_key([b for batches in commits for b in batches], pk)
    assert sorted(rows) == sorted(r for r, k in last.values() if k == "+I")


def test_local_merge_buffer(tmp_path):
    """tests/test_table.py::test_local_merge_buffer in both packages: churn
    collapses before the memtable, the state is the same, and a
    first-row table is refused."""
    for pkg in PKGS:
        m = _mod(pkg)
        cat = _catalog(pkg, str(tmp_path))
        schema = m.RowType.of(("id", m.BIGINT()), ("region", m.STRING()), ("amount", m.DOUBLE()))
        opts = {"bucket": "2", "write-only": "true", "write-buffer-rows": "30"}
        plain = cat.create_table(f"db.lm_plain_{pkg}", schema, primary_keys=["id"], options=opts)
        local = cat.create_table(f"db.lm_local_{pkg}", schema, primary_keys=["id"],
                                 options={**opts, "local-merge-buffer-size": "64 mb"})
        churn = [{"id": list(range(20)), "region": ["x"] * 20, "amount": [float(r * 100 + i) for i in range(20)]}
                 for r in range(5)]
        for t in (plain, local):
            wb = t.new_batch_write_builder()
            w = wb.new_write()
            for batch in churn:
                w.write(batch)
            w.write({"id": [0], "region": ["x"], "amount": [None]}, kinds=["-D"])
            wb.new_commit().commit(w.prepare_commit())
        assert sorted(_read(plain)) == sorted(_read(local))
        rows_plain = sum(e.file.row_count for e in plain.store.new_scan().plan().entries)
        rows_local = sum(e.file.row_count for e in local.store.new_scan().plan().entries)
        assert rows_local < rows_plain and rows_local <= 20
        with pytest.raises(ValueError, match="deduplicate"):
            cat.create_table(f"db.lm_bad_{pkg}", schema, primary_keys=["id"],
                             options={"bucket": "1", "merge-engine": "first-row",
                                      "local-merge-buffer-size": "1 mb"}).new_batch_write_builder().new_write()


def test_local_merge_partitioned_keeps_cross_partition_rows(tmp_path):
    """tests/test_table.py::test_local_merge_partitioned_keeps_cross_partition_rows
    in both packages: the same id in two partitions keeps both rows."""
    for pkg in PKGS:
        m = _mod(pkg)
        cat = _catalog(pkg, str(tmp_path))
        schema = m.RowType.of(("region", m.STRING()), ("id", m.BIGINT()), ("amount", m.DOUBLE()))
        t = cat.create_table(f"db.lm_part_{pkg}", schema, primary_keys=["region", "id"], partition_keys=["region"],
                             options={"bucket": "1", "local-merge-buffer-size": "64 mb"})
        wb = t.new_batch_write_builder()
        w = wb.new_write()
        w.write({"region": ["a"], "id": [1], "amount": [10.0]})
        w.write({"region": ["b"], "id": [1], "amount": [20.0]})
        wb.new_commit().commit(w.prepare_commit())
        assert sorted(_read(t)) == [("a", 1, 10.0), ("b", 1, 20.0)]


LM_GUARDS = {
    "merge_engine": ({"merge-engine": "partial-update"}, ("id",), (), "requires merge-engine=deduplicate"),
    "primary_key": ({}, (), (), "requires a primary-key table"),
    "sequence_field": ({"sequence.field": "v"}, ("id",), (), "cannot combine with sequence.field"),
    "ignore_delete": ({"ignore-delete": "true"}, ("id",), (), "cannot combine with ignore-delete"),
    "cross_partition": ({"bucket": "-1"}, ("id",), ("dt",), "not supported with cross-partition upsert"),
    "two_at_once": ({"merge-engine": "first-row", "sequence.field": "v"}, ("id",), (), "merge-engine=deduplicate"),
}


@pytest.mark.parametrize("guard", list(LM_GUARDS))
def test_local_merge_value_errors(tmp_path, guard):
    """Each ValueError of the JAX package's local merge checks, raised by
    the port in the same order with the same words, when the write is made."""
    options, pk, parts, message = LM_GUARDS[guard]
    errors = {}
    for pkg in PKGS:
        t = _catalog(pkg, str(tmp_path)).create_table(
            f"db.lm_{guard}_{pkg}", _schema(pkg), partition_keys=list(parts), primary_keys=list(pk),
            options={"bucket": "1", "local-merge-buffer-size": "1 mb", **options})
        with pytest.raises(ValueError, match=message) as err:
            t.new_batch_write_builder().new_write()
        errors[pkg] = str(err.value)
    assert errors["port"] == errors["jax"]


# ---------------------------------------------------------------------------
# cross-partition upsert
# ---------------------------------------------------------------------------

XP_OPTIONS = {"bucket": "-1", "dynamic-bucket.target-row-num": "12", **STABLE}


def _locations(path) -> dict:
    """id -> (partition, bucket) of every live row (read per split)."""
    table = port_load_table(path, device="cpu")
    rb = table.new_read_builder()
    out = {}
    for s in rb.new_scan().plan():
        for row in _rows(rb.new_read().read(s)):
            assert row[1] not in out, f"id {row[1]} read twice"
            out[row[1]] = (s.partition, s.bucket)
    return out


def _index(cross) -> tuple:
    """The global index without birth times, and the bucket counts."""
    idx = {tuple(_py(k) for k in key): (tuple(p), b) for key, (p, b, _) in cross.assigner.index.items()}
    return idx, dict(cross.assigner._bucket_counts)


def _live_ids(path) -> list:
    """The ids of the live rows, as the port reads them, with repeats."""
    return sorted(r[1] for r in _read(_open("port", path)))


def test_cross_partition_parity(tmp_path):
    """A batch commit of distinct ids, then one streaming write (which
    bootstraps the index from it) moving keys and deleting some by -D rows
    whose partition is unknown, over four commits: the same snapshots,
    entries, rows and (partition, bucket) per key from either writer; every
    id once, at its last day. A new write's bootstrapped index then equals
    where the rows are; the JAX package's agrees wherever it holds the key."""
    rng = np.random.default_rng(1)
    ids = rng.permutation(60)[:50].astype(np.int64)
    first = ({"dt": DAYS[rng.integers(0, 3, 50)], "id": ids, "v": ids * 0.5, "s": [f"f{i}" for i in ids]}, None)
    later = [_batch(s, 50, 70, kinds=("+I", "+I", "+I", "-D")) for s in (2, 3, 4, 5)]

    def scenario(pkg, table):
        _commit(table, first[0])
        wb = table.new_stream_write_builder()
        w, c = wb.new_write(), wb.new_commit()
        for i, (data, kinds) in enumerate(later, start=1):
            w.write(data, kinds)
            c.commit_messages(i, w.prepare_commit())

    paths = _write_both(str(tmp_path), "xp", scenario, XP_OPTIONS, pk=("id",))
    rows = _parity(paths)
    where = _locations(paths["port"])
    assert where == _locations(paths["jax"])
    last = _last_per_key([first, *later], key=("id",))
    assert sorted(rows) == sorted(r for r, k in last.values() if k == "+I")
    for path in paths.values():
        port_index, port_counts = _index(PortCross(_open("port", path)))
        jax_index, jax_counts = _index(JaxCross(_open("jax", path)))
        assert port_index == {(k,): loc for k, loc in where.items()}
        assert port_counts == jax_counts
        assert all(port_index[k] == loc for k, loc in jax_index.items())
    retractions = [e for snap in _history(paths["port"]) for e in snap[5] if e[0] == 0 and e[11] > 0]
    assert retractions, "no -D row was written"


def test_cross_partition_restart_after_moves(tmp_path):
    """Five batch commits, each a new write that bootstraps the index from
    the files after keys moved: the port reads every id once, at its last
    day. The JAX package compares sequence numbers across buckets at
    bootstrap, so it drops a moved key whose retraction outnumbers its new
    row: its next write duplicates the key, and a -D row of it finds nothing
    to retract (ROADMAP Queue 3)."""
    batches = [_batch(1, 80, 60)] + [_batch(s, 50, 70, kinds=("+I", "+I", "+I", "-D")) for s in (2, 3, 4, 5)]

    def scenario(pkg, table):
        for data, kinds in batches:
            _commit(table, data, kinds)

    paths = _write_both(str(tmp_path), "xp_restart", scenario, XP_OPTIONS, pk=("id",))
    last = _last_per_key(batches, key=("id",))
    want = sorted(r for r, k in last.values() if k == "+I")
    for reader in PKGS:
        assert sorted(_read(_open(reader, paths["port"], ENGINE[reader]))) == want
    assert sorted(_locations(paths["port"])) == sorted(r[1] for r in want)
    jax_ids = _live_ids(paths["jax"])
    assert len(jax_ids) > len(set(jax_ids)) and {r[1] for r in want} <= set(jax_ids)


def _xp_table(pkg, warehouse, name):
    m = _mod(pkg)
    schema = m.RowType.of(("region", m.STRING()), ("id", m.BIGINT()), ("v", m.DOUBLE()))
    return _catalog(pkg, warehouse).create_table(
        f"db.{name}_{pkg}", schema, partition_keys=["region"], primary_keys=["id"],
        options={"bucket": "-1", "dynamic-bucket.target-row-num": "100"})


def _xp_commit(pkg, t, w, ident):
    cls = JaxCommittable if pkg == "jax" else PortCommittable
    t.store.new_commit().commit(cls(ident, messages=w.prepare_commit()))


def _cross(pkg, t):
    return (JaxCross if pkg == "jax" else PortCross)(t)


@pytest.mark.parametrize("pkg", PKGS)
def test_pk_without_partition_key_requires_dynamic_bucket(tmp_path, pkg):
    m = _mod(pkg)
    schema = m.RowType.of(("region", m.STRING()), ("id", m.BIGINT()), ("v", m.DOUBLE()))
    with pytest.raises(ValueError, match="primary key must contain"):
        _catalog(pkg, str(tmp_path)).create_table("db.bad", schema, partition_keys=["region"], primary_keys=["id"],
                                                  options={"bucket": "2"})


@pytest.mark.parametrize("pkg", PKGS)
def test_cross_partition_update_moves_row(tmp_path, pkg):
    t = _xp_table(pkg, str(tmp_path), "xp_move")
    w = _cross(pkg, t)
    w.write({"region": ["eu", "eu"], "id": [1, 2], "v": [1.0, 2.0]})
    _xp_commit(pkg, t, w, 1)
    assert sorted(_read(t)) == [("eu", 1, 1.0), ("eu", 2, 2.0)]
    w2 = _cross(pkg, t)
    w2.write({"region": ["us"], "id": [1], "v": [10.0]})
    _xp_commit(pkg, t, w2, 2)
    assert sorted(_read(t)) == [("eu", 2, 2.0), ("us", 1, 10.0)]


@pytest.mark.parametrize("pkg", PKGS)
def test_cross_partition_delete(tmp_path, pkg):
    t = _xp_table(pkg, str(tmp_path), "xp_del")
    w = _cross(pkg, t)
    w.write({"region": ["eu"], "id": [7], "v": [7.0]})
    _xp_commit(pkg, t, w, 1)
    w2 = _cross(pkg, t)
    w2.write({"region": ["??"], "id": [7], "v": [None]}, kinds=["-D"])
    _xp_commit(pkg, t, w2, 2)
    assert _read(t) == []


@pytest.mark.parametrize("pkg", PKGS)
def test_bootstrap_after_restart(tmp_path, pkg):
    t = _xp_table(pkg, str(tmp_path), "xp_boot")
    w = _cross(pkg, t)
    w.write({"region": ["eu"], "id": [5], "v": [5.0]})
    _xp_commit(pkg, t, w, 1)
    w2 = _cross(pkg, t)
    assert (5,) in w2.assigner.index
    w2.write({"region": ["ap"], "id": [5], "v": [55.0]})
    _xp_commit(pkg, t, w2, 2)
    assert sorted(_read(t)) == [("ap", 5, 55.0)]


@pytest.mark.parametrize("pkg", PKGS)
def test_standard_table_write_routes_cross_partition(tmp_path, pkg):
    t = _xp_table(pkg, str(tmp_path), "xp_std")
    _commit(t, {"region": ["eu"], "id": [1], "v": [1.0]})
    _commit(t, {"region": ["us"], "id": [1], "v": [10.0]})
    assert _read(t) == [("us", 1, 10.0)]


@pytest.mark.parametrize("pkg", PKGS)
def test_bootstrap_resolves_moves_by_sequence(tmp_path, pkg):
    t = _xp_table(pkg, str(tmp_path), "xp_mv")
    w = _cross(pkg, t)
    w.write({"region": ["us", "eu"], "id": [9, 1], "v": [9.0, 1.0]})
    _xp_commit(pkg, t, w, 1)
    w2 = _cross(pkg, t)
    w2.write({"region": ["us"], "id": [1], "v": [10.0]})
    _xp_commit(pkg, t, w2, 2)
    w3 = _cross(pkg, t)
    assert w3.assigner.index[(1,)][0] == ("us",)
    w3.write({"region": ["ap"], "id": [1], "v": [100.0]})
    _xp_commit(pkg, t, w3, 3)
    assert sorted(_read(t)) == [("ap", 1, 100.0), ("us", 9, 9.0)]


@pytest.mark.parametrize("pkg", PKGS)
def test_cross_partition_index_ttl(tmp_path, pkg):
    """tests/test_options_wave_c.py::test_cross_partition_index_ttl: the
    options reach the assigner, and an entry born at the epoch is expired."""
    m = _mod(pkg)
    schema = m.RowType.of(("pt", m.STRING(False)), ("id", m.BIGINT(False)), ("v", m.DOUBLE()))
    t = _catalog(pkg, str(tmp_path)).create_table(
        "db.xp_ttl", schema, primary_keys=["id"], partition_keys=["pt"],
        options={"bucket": "-1", "cross-partition-upsert.index-ttl": "0 ms",
                 "cross-partition-upsert.bootstrap-parallelism": "2"})
    w = _cross(pkg, t)
    assert w.assigner.index_ttl_millis == 0
    assert w.assigner.bootstrap_parallelism == 2
    w.assigner.index[("k",)] = ((), 0, 0)
    assert w.assigner._get_live(("k",)) is None


def test_cross_partition_ttl_reallocates_on_a_pinned_clock(tmp_path, monkeypatch):
    """Under an index TTL an expired key is allocated again as a new one
    (its old copy stays), in both packages alike, on a clock both read."""
    import paimon_tpu.utils as jax_utils
    import paimon_tpu_torch.table.crosspartition as port_xp

    clock = {"now": 1_000_000}
    monkeypatch.setattr(jax_utils, "now_millis", lambda: clock["now"])
    monkeypatch.setattr(port_xp, "now_millis", lambda: clock["now"])

    def scenario(pkg, table):
        w = table.new_batch_write_builder().new_write()
        w.write({"dt": DAYS[[0, 0]], "id": np.array([1, 2]), "v": [1.0, 2.0], "s": ["a", "b"]})
        clock["now"] += 5_000
        w.write({"dt": DAYS[[1, 1]], "id": np.array([1, 3]), "v": [10.0, 3.0], "s": ["c", "d"]})
        table.new_batch_write_builder().new_commit().commit(w.prepare_commit())
        clock["now"] = 1_000_000

    paths = _write_both(str(tmp_path), "xp_ttl_clock", scenario, {**XP_OPTIONS, "cross-partition-upsert.index-ttl": "1 s"},
                        pk=("id",))
    rows = _parity(paths)
    assert sorted((r[0], r[1]) for r in rows) == [(DAYS[0], 1), (DAYS[0], 2), (DAYS[1], 1), (DAYS[1], 3)]
