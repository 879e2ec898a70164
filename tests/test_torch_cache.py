"""The caches and the file indexes of the port (paimon_tpu_torch/utils/cache.py,
format/fileindex.py) against the JAX package, on the CPU (device="cpu").

- ByteBudgetLRU: eviction at the byte budget, oversized values,
  get_or_load and the cache{...} counters, invalidation by file and by
  prefix, budget shrinking, and concurrent readers.
- Reads with the manifest and data-file caches on (the default) equal the
  reads of the same table at '0 b', through upserts, deletes, compactions,
  filtered reads and deletion vectors; a second plan hits the manifest
  cache; a caller changing a cached manifest list changes nothing cached.
- Each deleting route evicts what it deletes and a read after it sees no
  stale row: snapshot expiry, compaction, rollback (which mints snapshot
  ids again), dropping a branch and creating it again, and dropping or
  renaming a table and creating another at its path.
- Bloom payloads (per-column blooms and the composite key bloom, embedded
  and in sidecars) are byte-identical to the JAX package's, for a batch
  and for the files of a table each package writes from the same rows.
- A key bloom or a column bloom written by either package prunes in the
  other: the filtered read's plan and the get's files_pruned. A missing
  sidecar prunes nothing and drops no row.

Tolerance: exact. Every value is copied, never computed.
"""

import io
import os
import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import paimon_tpu as jt
import paimon_tpu_torch as tt
from paimon_tpu.catalog import FileSystemCatalog as JaxCatalog
from paimon_tpu.data import predicate as jp
from paimon_tpu.format import fileindex as jfi
from paimon_tpu.metrics import get_metrics as jax_get_metrics
from paimon_tpu.table import load_table as jax_load_table
from paimon_tpu.table.bucket import key_hashes as jax_key_hashes
from paimon_tpu.table.query import LocalTableQuery as JaxQuery
from paimon_tpu_torch.catalog import FileSystemCatalog as PortCatalog
from paimon_tpu_torch.data import predicate as tp
from paimon_tpu_torch.format import fileindex as tfi
from paimon_tpu_torch.metrics import get_metrics, registry
from paimon_tpu_torch.table import load_table as port_load_table
from paimon_tpu_torch.table.bucket import key_hashes
from paimon_tpu_torch.table.branch import BranchManager
from paimon_tpu_torch.table.query import LocalTableQuery
from paimon_tpu_torch.utils.cache import ByteBudgetLRU, data_file_cache, manifest_cache

OFF = {"cache.manifest.max-memory-size": "0 b", "cache.data-file.max-memory-size": "0 b"}


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


@pytest.fixture(autouse=True)
def _plain_download(monkeypatch):
    monkeypatch.setenv("PAIMON_TPU_FORCE_COMPACT", "0")


def _schema(pkg):
    m = jt if pkg == "jax" else tt
    return m.RowType.of(("k", m.BIGINT(False)), ("s", m.STRING()), ("v", m.DOUBLE()))


def _catalog(pkg, warehouse):
    if pkg == "jax":
        return JaxCatalog(warehouse, commit_user=pkg)
    return PortCatalog(warehouse, commit_user=pkg, device="cpu")


def _write(table, keys, step, kinds=None, compact=False):
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    keys = [int(k) for k in keys]
    w.write({"k": keys, "s": [f"s{k}-{step}" for k in keys], "v": [float(step) + k / 1000 for k in keys]}, kinds)
    if compact:
        w.compact(full=True)
    wb.new_commit().commit(w.prepare_commit())


def _read(table, predicate=None):
    rb = table.new_read_builder()
    if predicate is not None:
        rb = rb.with_filter(predicate)
    return sorted(rb.new_read().read_all(rb.new_scan().plan()).to_pylist())


# ---------------------------------------------------------------------------
# the LRU
# ---------------------------------------------------------------------------


def test_lru_evicts_at_byte_budget():
    c = ByteBudgetLRU("t-evict", 1000)
    for i in range(3):
        c.put(("k", i), f"v{i}", 300)
    assert len(c) == 3 and c.total_bytes == 900
    c.get(("k", 0))  # LRU order now 1, 2, 0
    c.put(("k", 3), "v3", 300)
    assert ("k", 1) not in c and all(("k", i) in c for i in (0, 2, 3))
    assert registry.group("cache", cache="t-evict").counter("evictions").count == 1


def test_lru_oversized_value_and_zero_budget():
    c = ByteBudgetLRU("t-big", 1000)
    c.put(("small",), "s", 100)
    c.put(("big",), "b", 5000)
    assert ("big",) not in c and ("small",) in c
    off = ByteBudgetLRU("t-off", 0)
    assert not off.enabled
    calls = []
    assert off.get_or_load(("a",), lambda: calls.append(1) or "x", len) == "x"
    assert off.get_or_load(("a",), lambda: calls.append(1) or "x", len) == "x"
    assert len(calls) == 2 and len(off) == 0


def test_lru_get_or_load_and_counters():
    c = ByteBudgetLRU("t-load", 10_000)
    calls = []
    v1 = c.get_or_load(("a",), lambda: calls.append(1) or "val", lambda v: 100)
    v2 = c.get_or_load(("a",), lambda: calls.append(1) or "val", lambda v: 100)
    assert v1 == v2 == "val" and len(calls) == 1
    g = registry.group("cache", cache="t-load")
    assert g.counter("hits").count == 1 and g.counter("misses").count >= 1
    assert g.metrics["bytes"].value == 100 and g.metrics["entries"].value == 1


def test_lru_invalidation_by_file_and_prefix_and_budget():
    c = ByteBudgetLRU("t-inval", 10_000)
    c.put(("a", "f1"), 1, 100, file_id="/w/t/f1")
    c.put(("b", "f1"), 2, 100, file_id="/w/t/f1")
    c.put(("a", "f2"), 3, 100, file_id="/w/t/f2")
    c.put(("a", "f3"), 4, 100, file_id="/w/u/f3")
    assert c.invalidate_file("/w/t/f1") == 2 and not c.contains_file("/w/t/f1")
    assert c.invalidate_prefix("/w/t/") == 1 and len(c) == 1
    assert c.invalidate(("a", "f3")) and not c.invalidate(("a", "f3"))
    for i in range(10):
        c.put(("x", i), i, 100)
    c.set_budget(300)
    assert c.total_bytes <= 300 and ("x", 9) in c and ("x", 0) not in c


def test_lru_concurrent_readers():
    c = ByteBudgetLRU("t-threads", 50_000)
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(2000):
                k = int(rng.integers(0, 200))
                v = c.get_or_load(("k", k), lambda k=k: ("v", k), lambda v: 500, file_id=f"f{k % 10}")
                assert v == ("v", k)
                if rng.random() < 0.01:
                    c.invalidate_file(f"f{int(rng.integers(0, 10))}")
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors
    assert c.total_bytes == 500 * len(c) <= 50_000


# ---------------------------------------------------------------------------
# reads with the caches on equal the reads at '0 b'
# ---------------------------------------------------------------------------


def test_cached_reads_match_uncached(tmp_warehouse):
    t = _catalog("port", tmp_warehouse).create_table(
        "db.par",
        _schema("port"),
        primary_keys=["k"],
        options={"bucket": "2", "num-sorted-run.compaction-trigger": "3", "target-file-size": "4 kb"},
    )
    plain = t.copy(OFF)
    assert plain.store.manifest_obj_cache is None and plain.store.data_file_obj_cache is None
    hits = registry.group("cache", cache="data-file").counter("hits")
    for step in range(5):
        keys = range(step * 7, step * 7 + 25)
        _write(t, keys, step, kinds=["-D" if k % 11 == 0 else "+I" for k in keys], compact=(step == 3))
        for pred in (None, tp.greater_than("k", 20), tp.equal("s", f"s30-{step}")):
            assert _read(t, pred) == _read(plain, pred), f"cache parity broke at step {step}"
    assert hits.count > 0


def test_cached_reads_with_deletion_vectors_and_time_travel(tmp_warehouse):
    t = _catalog("port", tmp_warehouse).create_table(
        "db.dv", _schema("port"), primary_keys=["k"], options={"bucket": "1", "deletion-vectors.enabled": "true"}
    )
    _write(t, range(40), 0)
    _read(t)  # the files' batches are cached now
    assert t.delete_where(tp.less_than("k", 10)) == 10
    _write(t, range(35, 45), 1)
    plain = t.copy(OFF)
    assert _read(t) == _read(plain) and len(_read(t)) == 35
    for sid in (1, 2):
        assert _read(t.copy({"scan.snapshot-id": str(sid)})) == _read(plain.copy({"scan.snapshot-id": str(sid)}))


def test_second_plan_hits_manifest_cache(tmp_warehouse):
    t = _catalog("port", tmp_warehouse).create_table("db.hits", _schema("port"), primary_keys=["k"], options={"bucket": "1"})
    _write(t, range(50), 0)
    g = registry.group("cache", cache="manifest")
    rb = t.new_read_builder()
    plan1 = rb.new_scan().plan()
    hits_before = g.counter("hits").count
    plan2 = rb.new_scan().plan()
    assert g.counter("hits").count > hits_before
    assert [s.to_dict() for s in plan1] == [s.to_dict() for s in plan2]


def test_cached_manifest_lists_are_mutation_proof(tmp_warehouse):
    t = _catalog("port", tmp_warehouse).create_table("db.mut", _schema("port"), primary_keys=["k"], options={"bucket": "1"})
    _write(t, range(10), 0)
    scan = t.store.new_scan()
    snap = scan.snapshot_manager.latest_snapshot()
    metas = scan.manifest_list.read(snap.delta_manifest_list)
    metas.append("junk")
    again = scan.manifest_list.read(snap.delta_manifest_list)
    assert "junk" not in again and len(again) == len(metas) - 1


# ---------------------------------------------------------------------------
# invalidation: every deleting route
# ---------------------------------------------------------------------------


def test_expire_invalidates_deleted_files(tmp_warehouse):
    t = _catalog("port", tmp_warehouse).create_table(
        "db.exp",
        _schema("port"),
        primary_keys=["k"],
        options={
            "bucket": "1",
            "snapshot.num-retained.min": "1",
            "snapshot.num-retained.max": "1",
            "snapshot.time-retained": "0 ms",
            "manifest.merge-min-count": "1",
        },
    )
    _write(t, range(30), 0)
    assert _read(t)
    old_files = [e.file.file_name for e in t.store.new_scan().plan().entries]
    assert any(data_file_cache().contains_file(f) for f in old_files)
    sm = t.store.snapshot_manager
    assert sm.snapshot(1) is not None
    wb = t.new_batch_write_builder().with_overwrite()
    w = wb.new_write()
    w.write({"k": [1], "s": ["a"], "v": [1.0]})
    wb.new_commit().commit(w.prepare_commit())
    _write(t, [2], 2)
    on_disk = {st.path.rsplit("/", 1)[-1] for st in t.file_io.list_files(f"{t.path}/bucket-0")}
    assert not (on_disk & set(old_files)), "precondition: the old files are deleted"
    for f in old_files:
        assert not data_file_cache().contains_file(f)
    assert not manifest_cache().contains_file(sm.snapshot_path(1))
    with pytest.raises(FileNotFoundError):
        sm.snapshot(1)
    assert _read(t) == [(1, "a", 1.0), (2, "s2-2", 2.002)]


def test_compaction_invalidates_rewritten_inputs(tmp_warehouse):
    t = _catalog("port", tmp_warehouse).create_table(
        "db.cmp", _schema("port"), primary_keys=["k"], options={"bucket": "1", "write-only": "true"}
    )
    for step in range(3):
        _write(t, range(0, 40), step)
    before = _read(t)
    inputs = [e.file.file_name for e in t.store.new_scan().plan().entries]
    assert any(data_file_cache().contains_file(f) for f in inputs)
    view = t.copy({"write-only": "false"})
    wb = view.new_batch_write_builder()
    w = wb.new_write()
    w.compact(full=True)
    wb.new_commit().commit(w.prepare_commit())
    for f in inputs:
        assert not data_file_cache().contains_file(f)
    assert _read(t) == before


def test_append_compaction_invalidates_inputs(tmp_warehouse):
    t = _catalog("port", tmp_warehouse).create_table(
        "db.app", _schema("port"), options={"bucket": "1", "write-only": "true"}
    )
    for step in range(6):
        _write(t, range(step * 5, step * 5 + 5), step)
    before = _read(t)
    inputs = [e.file.file_name for e in t.store.new_scan().plan().entries]
    view = t.copy({"write-only": "false", "compaction.min.file-num": "2"})
    wb = view.new_batch_write_builder()
    w = wb.new_write()
    w.compact(full=True)
    wb.new_commit().commit(w.prepare_commit())
    live = {e.file.file_name for e in t.store.new_scan().plan().entries}
    assert set(inputs) - live, "precondition: the compaction rewrote inputs"
    for f in set(inputs) - live:
        assert not data_file_cache().contains_file(f)
    assert _read(t) == before


def test_rollback_invalidates_snapshot_and_latest_pointer(tmp_warehouse):
    t = _catalog("port", tmp_warehouse).create_table("db.rb", _schema("port"), primary_keys=["k"], options={"bucket": "1"})
    _write(t, [1], 1)
    _write(t, [1], 2)
    assert _read(t) == [(1, "s1-2", 2.001)]
    t.rollback_to(1)
    _write(t, [1], 3)  # mints snapshot 2 again, with other content
    assert _read(t) == [(1, "s1-3", 3.001)]
    assert t.store.snapshot_manager.latest_snapshot_id() == 2


def test_branch_delete_invalidates_its_tree(tmp_warehouse):
    t = _catalog("port", tmp_warehouse).create_table("db.br", _schema("port"), primary_keys=["k"], options={"bucket": "1"})
    _write(t, range(5), 0)
    bm = BranchManager(t.file_io, t.path)
    bm.create("b1")
    b = port_load_table(t.path, dynamic_options={"branch": "b1"}, device="cpu")
    _write(b, [1], 7)
    assert _read(b)[1] == (1, "s1-7", 7.001)
    bm.delete("b1")
    assert not any(k.startswith(bm.branch_path("b1")) for k in manifest_cache()._by_file)
    bm.create("b1")
    b2 = port_load_table(t.path, dynamic_options={"branch": "b1"}, device="cpu")
    assert _read(b2) == _read(t)


@pytest.mark.parametrize("route", ["drop", "rename", "drop_database"])
def test_drop_and_rename_table_invalidate(tmp_warehouse, route):
    cat = _catalog("port", tmp_warehouse)
    t = cat.create_table("db.x", _schema("port"), primary_keys=["k"], options={"bucket": "1"})
    _write(t, range(10), 0)
    _write(t, range(5), 1)
    assert len(_read(t)) == 10
    if route == "drop":
        cat.drop_table("db.x")
    elif route == "rename":
        cat.rename_table("db.x", "db.y")
        assert len(_read(cat.get_table("db.y"))) == 10
        with pytest.raises(ValueError, match="destination exists"):
            cat.rename_table("db.y", "db.y")
    else:
        with pytest.raises(ValueError, match="not empty"):
            cat.drop_database("db")
        cat.drop_database("db", cascade=True)
    assert not any(k.startswith(t.path + "/") for k in manifest_cache()._by_file)
    t2 = cat.create_table("db.x", _schema("port"), primary_keys=["k"], options={"bucket": "1"})
    _write(t2, [100], 9)  # snapshot 1 again, other content
    assert _read(t2) == [(100, "s100-9", 9.1)]
    assert cat.list_tables("db") == (["x", "y"] if route == "rename" else ["x"])


# ---------------------------------------------------------------------------
# file indexes: bytes and cross-package pruning
# ---------------------------------------------------------------------------


def test_bloom_payload_bytes_identical_to_jax():
    rng = np.random.default_rng(3)
    n = 3000
    data = {
        "a": rng.integers(-(1 << 40), 1 << 40, n).tolist(),
        "b": [None if rng.random() < 0.1 else f"v{int(x)}" for x in rng.integers(0, 500, n)],
        "c": [float(x) if x % 7 else -0.0 for x in rng.integers(0, 100, n)],
    }
    spec = lambda m: m.RowType.of(("a", m.BIGINT()), ("b", m.STRING()), ("c", m.DOUBLE()))  # noqa: E731
    jb = jt.ColumnBatch.from_pydict(spec(jt), data)
    tb = tt.ColumnBatch.from_pydict(spec(tt), data)
    for cols, keys in ((["a", "b", "c"], None), ([], ["a", "b"]), (["b"], ["a"])):
        jh = None if keys is None else jax_key_hashes(jb, keys)
        th = None if keys is None else key_hashes(tb, keys)
        if keys is not None:
            np.testing.assert_array_equal(th, jh)
        jpay = jfi.build_index_payload(jb, cols, 0.05, key_hashes=jh, key_fpp=0.001)
        tpay = tfi.build_index_payload(tb, cols, 0.05, key_hashes=th, key_fpp=0.001)
        assert tpay == jpay
        pred = tfi.FileIndexPredicate.from_bytes(tpay)
        if keys is not None:
            assert pred.test_key_hashes(th).all()
    assert tfi.build_index_payload(tb.slice(0, 0), ["a"]) is None


@pytest.mark.parametrize("threshold", ["500 b", "0 b", "64 kb"])
def test_table_index_files_identical_to_jax(tmp_warehouse, threshold):
    """Both packages write the same rows: each file's index payload
    (embedded or sidecar, by file-index.in-manifest-threshold) is the same
    bytes."""
    opts = {
        "bucket": "1",
        "file-index.bloom-filter.columns": "s",
        "file-index.bloom-filter.primary-key.enabled": "true",
        "file-index.in-manifest-threshold": threshold,
    }
    payloads = {}
    for pkg in ("jax", "port"):
        wh = f"{tmp_warehouse}/{pkg}"
        os.makedirs(wh)
        t = _catalog(pkg, wh).create_table("db.i", _schema(pkg), primary_keys=["k"], options=opts)
        _write(t, range(0, 300, 3), 0)
        _write(t, range(1, 300, 3), 1)
        out = []
        for e in sorted(t.store.new_scan().plan().entries, key=lambda e: e.file.min_key):
            f = e.file
            if f.embedded_index is not None:
                out.append(("embedded", f.embedded_index))
            else:
                (sidecar,) = f.extra_files
                out.append(("sidecar", t.file_io.read_bytes(f"{t.path}/bucket-0/{sidecar}")))
        payloads[pkg] = out
    assert payloads["port"] == payloads["jax"]
    assert {kind for kind, _ in payloads["port"]} == ({"embedded"} if threshold == "64 kb" else {"sidecar"})


def _splits(table, predicate):
    rb = table.new_read_builder().with_filter(predicate)
    return [(s.bucket, sorted(f.file_name for f in s.files)) for s in rb.new_scan().plan()]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("threshold", ["500 b", "0 b"])
def test_blooms_prune_across_packages(tmp_warehouse, writer, threshold):
    """A table written by one package is pruned by its blooms in the other:
    the filtered read of an append table (column bloom) and of a
    primary-key table (key conjuncts only) plans the same files in both,
    fewer than without the index; the batched get prunes files in both."""
    opts = {
        "bucket": "1",
        "write-only": "true",
        "file-index.bloom-filter.columns": "k,s",
        "file-index.bloom-filter.primary-key.enabled": "true",
        "file-index.in-manifest-threshold": threshold,
    }
    cat = _catalog(writer, tmp_warehouse)
    keyed = cat.create_table("db.pk", _schema(writer), primary_keys=["k"], options=opts)
    app = cat.create_table("db.ap", _schema(writer), options=opts)
    for t in (keyed, app):
        _write(t, range(0, 400, 2), 0)
        _write(t, range(1, 400, 2), 1)
    for name, pred_args in (("pk", ("k", 7)), ("ap", ("s", "s7-1"))):
        path = f"{tmp_warehouse}/db.db/{name}"
        jtab, ttab = jax_load_table(path), port_load_table(path, device="cpu")
        jsplits = _splits(jtab, jp.equal(*pred_args))
        tsplits = _splits(ttab, tp.equal(*pred_args))
        assert tsplits == jsplits and sum(len(f) for _, f in tsplits) == 1
        off = _splits(ttab.copy({"file-index.read.enabled": "false"}), tp.equal(*pred_args))
        assert sum(len(f) for _, f in off) == 2
        assert _read(ttab, tp.equal(*pred_args)) == sorted(_read(jtab, jp.equal(*pred_args)))
    path = f"{tmp_warehouse}/db.db/pk"
    q, jq = LocalTableQuery(port_load_table(path, device="cpu"), device="cpu"), JaxQuery(jax_load_table(path))
    g, jg = get_metrics(), jax_get_metrics()
    p0, jp0 = g.counter("files_pruned").count, jg.counter("files_pruned").count
    keys = [1, 3, 5, 7, 9, 11]
    assert q.get_batch(keys).to_pylist() == jq.get_batch(keys).to_pylist()
    assert g.counter("files_pruned").count > p0 and jg.counter("files_pruned").count > jp0


def test_missing_sidecar_prunes_nothing(tmp_warehouse):
    opts = {
        "bucket": "1",
        "write-only": "true",
        "file-index.bloom-filter.primary-key.enabled": "true",
        "file-index.in-manifest-threshold": "0 b",
    }
    t = _catalog("port", tmp_warehouse).create_table("db.m", _schema("port"), primary_keys=["k"], options=opts)
    _write(t, range(0, 100, 2), 0)
    _write(t, range(1, 100, 2), 1)
    for e in t.store.new_scan().plan().entries:
        for x in e.file.extra_files:
            os.remove(f"{t.path}/bucket-0/{x}")
    assert _read(t, tp.equal("k", 7)) == [(7, "s7-1", 1.007)]
    assert len(_splits(t, tp.equal("k", 7))[0][1]) == 2
    q = LocalTableQuery(t, device="cpu")
    assert q.get_batch([6, 7]).to_pylist() == [(6, "s6-0", 0.006), (7, "s7-1", 1.007)]
