"""Point gets and lookup tables in the port (paimon_tpu_torch/table/query.py,
table/get.py, lookup/) against the JAX package, on the CPU (device="cpu").

- LocalTableQuery.get_batch against the JAX package's get_batch on the same
  table, against the port's scalar lookup() walk and against a dict fold of
  the commits: tables written by either package, with and without the
  composite key bloom, at fixed buckets and at bucket=-1 (dynamic), with
  -D rows. The probe holds absent keys.
- The input shapes, bloom pruning with no data IO, the read-your-writes
  tier (buffered rows, a buffered delete, flushed but uncommitted files,
  and a get made while a flush is writing its files), refresh's per-bucket
  diff, the lookup file cache's eviction and the local store's save,
  reload and retention sweep, a compaction chain that upgrades a file
  within one commit, deletion vectors (the counterpart of
  tests/test_deletion_vectors.py test_lookup_respects_deletion_vectors)
  and the get{...} metrics.
- FullCacheLookupTable in its three modes (primary, secondary, no-pk) and
  lookup_join, against the JAX package's on the same table, across a
  refresh with deletes.

Left out of the JAX package's cases: the KV server and Flight, which the
port does not have yet (ROADMAP Queue 1 item 15). Lookups over code-domain
(merge.dict-domain) tables are in tests/test_torch_dict_domain.py.

Tolerance: exact. Every value is copied, never computed.
"""

import io
import os
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import paimon_tpu as jt
import paimon_tpu_torch as tt
from paimon_tpu.catalog import FileSystemCatalog as JaxCatalog
from paimon_tpu.lookup.tables import FullCacheLookupTable as JaxLookupTable
from paimon_tpu.lookup.tables import lookup_join as jax_lookup_join
from paimon_tpu.table import load_table as jax_load_table
from paimon_tpu.table.query import LocalTableQuery as JaxQuery
from paimon_tpu_torch.catalog import FileSystemCatalog as PortCatalog
from paimon_tpu_torch.data.predicate import equal
from paimon_tpu_torch.lookup.tables import FullCacheLookupTable, lookup_join
from paimon_tpu_torch.metrics import get_metrics
from paimon_tpu_torch.table import load_table as port_load_table
from paimon_tpu_torch.table.query import LocalTableQuery
from paimon_tpu_torch.table.write import TableWrite


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


@pytest.fixture(autouse=True)
def _plain_download(monkeypatch):
    monkeypatch.setenv("PAIMON_TPU_FORCE_COMPACT", "0")


def _schema(pkg, kind="int"):
    m = jt if pkg == "jax" else tt
    if kind == "str":
        return m.RowType.of(("code", m.STRING(False)), ("grp", m.STRING()), ("v", m.DOUBLE()))
    return m.RowType.of(("id", m.BIGINT(False)), ("name", m.STRING()), ("v", m.DOUBLE()))


def _catalog(pkg, warehouse):
    if pkg == "jax":
        return JaxCatalog(warehouse, commit_user=pkg)
    return PortCatalog(warehouse, commit_user=pkg, device="cpu")


def write(t, data, kinds=None):
    wb = t.new_batch_write_builder()
    w = wb.new_write()
    w.write(data, kinds)
    wb.new_commit().commit(w.prepare_commit())


def scalar_oracle(q, keys, partition=()):
    out = []
    for k in keys:
        row = q.lookup(partition, k)
        out.append(None if row is None else row.to_pylist()[0])
    return out


def _port_table(path):
    return port_load_table(path, device="cpu")


# ---------------------------------------------------------------------------
# get_batch parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("bloom", [True, False])
@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("buckets", ["fixed", "dynamic"])
def test_get_batch_parity(tmp_warehouse, seed, bloom, writer, buckets):
    rng = np.random.default_rng(seed)
    kind = "str" if seed == 1 else "int"
    key = "code" if kind == "str" else "id"
    keyspace = [f"k{i:05d}" for i in range(400)] if kind == "str" else list(range(400))
    opts = {
        "bucket": str(int(rng.integers(1, 4))) if buckets == "fixed" else "-1",
        "file-index.bloom-filter.primary-key.enabled": str(bloom).lower(),
    }
    if buckets == "dynamic":
        opts["dynamic-bucket.target-row-num"] = "40"
    t = _catalog(writer, tmp_warehouse).create_table("db.g", _schema(writer, kind), primary_keys=[key], options=opts)
    fold = {}
    for commit in range(4):
        ks = list(dict.fromkeys(keyspace[i] for i in rng.integers(0, len(keyspace), int(rng.integers(20, 80)))))
        deleted = rng.random(len(ks)) < 0.15
        vals = [float(commit * 100 + i) for i in range(len(ks))]
        second = [f"g{i % 5}" for i in range(len(ks))] if kind == "str" else [f"n{k}" for k in ks]
        write(t, {key: ks, _schema(writer, kind).field_names[1]: second, "v": vals}, ["-D" if d else "+I" for d in deleted])
        for k, d, s, v in zip(ks, deleted, second, vals):
            if d:
                fold.pop(k, None)
            else:
                fold[k] = (k, s, v)
    path = f"{tmp_warehouse}/db.db/g"
    q = LocalTableQuery(_port_table(path), device="cpu")
    jq = JaxQuery(jax_load_table(path))
    probe = [keyspace[i] for i in rng.integers(0, len(keyspace), 120)]
    probe += ["zzz-absent", "absent2"] if kind == "str" else [99999, -5]
    got = q.get_batch(probe).to_pylist()
    assert got == jq.get_batch(probe).to_pylist()
    assert got == scalar_oracle(q, probe)
    assert got == [fold.get(k) for k in probe]


def test_get_batch_input_shapes(tmp_warehouse):
    t = _catalog("port", tmp_warehouse).create_table("db.s", _schema("port"), primary_keys=["id"], options={"bucket": "1"})
    write(t, {"id": [1, 2], "name": ["a", "b"], "v": [1.0, 2.0]})
    q = LocalTableQuery(t, device="cpu")
    expect = [(1, "a", 1.0), None]
    assert q.get_batch([1, 3]).to_pylist() == expect
    assert q.get_batch([(1,), (3,)]).to_pylist() == expect
    assert q.get_batch({"id": [1, 3]}).to_pylist() == expect
    key_batch = tt.ColumnBatch.from_pydict(t.row_type.project(["id"]), {"id": [1, 3]})
    assert q.get_batch(key_batch).to_pylist() == expect
    res = q.get_batch([2, 9])
    assert res.row(0) == (2, "b", 2.0) and res.row(1) is None
    assert q.get_batch([]).to_pylist() == []
    with pytest.raises(ValueError, match="primary-key table"):
        LocalTableQuery(_catalog("port", tmp_warehouse).create_table("db.app", _schema("port")), device="cpu")


def test_bloom_key_index_prunes_without_data_io(tmp_warehouse, monkeypatch):
    """Two files with interleaved keys (their ranges cannot tell them
    apart): a key only one holds is bloom-pruned in the other, with no read
    of its data; out-of-range keys are range-pruned; with
    lookup.get.bloom-prune.enabled=false no bloom is consulted."""
    t = _catalog("port", tmp_warehouse).create_table(
        "db.b",
        _schema("port"),
        primary_keys=["id"],
        options={"bucket": "1", "write-only": "true", "file-index.bloom-filter.primary-key.enabled": "true"},
    )
    write(t, {"id": list(range(0, 400, 2)), "name": ["e"] * 200, "v": [0.0] * 200})
    write(t, {"id": list(range(1, 400, 2)), "name": ["o"] * 200, "v": [1.0] * 200})
    files = t.store.new_scan().plan().entries
    assert all(e.file.embedded_index is not None or e.file.extra_files for e in files)
    from paimon_tpu_torch.core.datafile import KeyValueFileReaderFactory

    reads = []
    real_read = KeyValueFileReaderFactory.read
    monkeypatch.setattr(KeyValueFileReaderFactory, "read", lambda self, meta, *a, **kw: reads.append(meta.file_name) or real_read(self, meta, *a, **kw))
    q = LocalTableQuery(t, device="cpu")
    g = get_metrics()
    pruned0 = g.counter("files_pruned").count
    for k in range(1, 41, 2):
        assert q.get_batch([k]).to_pylist() == [(k, "o", 1.0)]
    assert g.counter("files_pruned").count > pruned0 and g.counter("index_hits").count > 0
    even = next(e.file.file_name for e in files if e.file.min_key == (0,))
    assert even not in reads  # pruned with no data IO
    pruned1 = g.counter("files_pruned").count
    assert q.get_batch([-5, 5000]).to_pylist() == [None, None]
    assert g.counter("files_pruned").count >= pruned1 + 2
    q2 = LocalTableQuery(t.copy({"lookup.get.bloom-prune.enabled": "false"}), device="cpu")
    hits0 = g.counter("index_hits").count
    assert q2.get_batch([398, 399]).to_pylist() == [(398, "e", 0.0), (399, "o", 1.0)]
    assert g.counter("index_hits").count == hits0


def test_read_your_writes_tiers(tmp_warehouse):
    t = _catalog("port", tmp_warehouse).create_table("db.r", _schema("port"), primary_keys=["id"], options={"bucket": "2"})
    write(t, {"id": [1, 2], "name": ["a", "b"], "v": [1.0, 2.0]})
    q = LocalTableQuery(t, device="cpu")
    tw = TableWrite(t)
    q.attach_write(tw)
    tw.write({"id": [2, 5], "name": ["b2", "e"], "v": [20.0, 50.0]})
    g = get_metrics()
    m0 = g.counter("memtable_hits").count
    assert q.get_batch([1, 2, 5, 9]).to_pylist() == [(1, "a", 1.0), (2, "b2", 20.0), (5, "e", 50.0), None]
    assert g.counter("memtable_hits").count > m0
    tw.write({"id": [1], "name": [None], "v": [None]}, kinds=["-D"])  # a buffered delete masks a committed row
    assert q.get_batch([1]).to_pylist() == [None]
    for w in tw._writers.values():
        w.flush()
    assert q.get_batch([1, 2, 5]).to_pylist() == [None, (2, "b2", 20.0), (5, "e", 50.0)]
    t.new_batch_write_builder().new_commit().commit(tw.prepare_commit())
    q.attach_write(None)
    q.refresh()
    assert q.get_batch([1, 2, 5]).to_pylist() == [None, (2, "b2", 20.0), (5, "e", 50.0)]


def test_read_your_writes_during_a_flush(tmp_warehouse):
    """A get made while a flush is writing its files (here from inside the
    file write, as another thread would interleave) sees every buffered
    row: delta_snapshot hands out the flush's in-flight batches."""
    t = _catalog("port", tmp_warehouse).create_table("db.f", _schema("port"), primary_keys=["id"], options={"bucket": "1"})
    write(t, {"id": [1], "name": ["a"], "v": [1.0]})
    q = LocalTableQuery(t, device="cpu")
    tw = TableWrite(t)
    q.attach_write(tw)
    tw.write({"id": [1, 7], "name": ["a2", "g"], "v": [10.0, 70.0]})
    (w,) = tw._writers.values()
    seen = []
    real = w.writer_factory.write

    def write_and_get(kv, *a, **kw):
        seen.append(q.get_batch([1, 7]).to_pylist())
        return real(kv, *a, **kw)

    w.writer_factory.write = write_and_get
    w.flush()
    assert seen == [[(1, "a2", 10.0), (7, "g", 70.0)]]
    assert w.delta_snapshot()[0] == [] and len(w.delta_snapshot()[1]) == 1
    assert q.get_batch([1, 7]).to_pylist() == [(1, "a2", 10.0), (7, "g", 70.0)]


def test_refresh_diff_keeps_unchanged_buckets(tmp_warehouse):
    t = _catalog("port", tmp_warehouse).create_table("db.d", _schema("port"), primary_keys=["id"], options={"bucket": "4"})
    write(t, {"id": list(range(40)), "name": ["x"] * 40, "v": [float(i) for i in range(40)]})
    q = LocalTableQuery(t, device="cpu")
    before_levels, before_idx = dict(q._levels), dict(q._get_indexes)
    write(t, {"id": [0], "name": ["y"], "v": [100.0]})  # one bucket
    q.refresh()
    changed = [pb for pb in before_levels if q._levels[pb] is not before_levels[pb]]
    unchanged = [pb for pb in before_levels if q._levels[pb] is before_levels[pb]]
    assert len(changed) == 1 and len(unchanged) == 3
    assert all(q._get_indexes[pb] is before_idx[pb] for pb in unchanged)
    assert q.get_batch([0]).to_pylist() == [(0, "y", 100.0)]
    ids = {pb: id(v) for pb, v in q._levels.items()}
    q.refresh()  # the same snapshot: nothing changes
    assert {pb: id(v) for pb, v in q._levels.items()} == ids
    import threading

    lock = threading.Lock()
    write(t, {"id": [1], "name": ["z"], "v": [1.5]})
    q.refresh(swap_lock=lock)  # two-phase: built and warmed outside the lock
    assert not lock.locked() and q.get_batch([1, 0]).to_pylist() == [(1, "z", 1.5), (0, "y", 100.0)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_scalar_lookups_match_jax(tmp_warehouse, writer):
    t = _catalog(writer, tmp_warehouse).create_table("db.l", _schema(writer), primary_keys=["id"], options={"bucket": "2"})
    write(t, {"id": list(range(50)), "name": [f"n{i}" for i in range(50)], "v": [float(i) for i in range(50)]})
    write(t, {"id": [2], "name": ["b2"], "v": [22.0]})
    write(t, {"id": [3], "name": [None], "v": [None]}, kinds=["-D"])
    wb = t.new_batch_write_builder()
    w = wb.new_write()
    w.write({"id": [7], "name": ["seven"], "v": [77.0]})
    w.compact(full=True)
    wb.new_commit().commit(w.prepare_commit())
    path = f"{tmp_warehouse}/db.db/l"
    q, jq = LocalTableQuery(_port_table(path), device="cpu"), JaxQuery(jax_load_table(path))
    for k in (0, 2, 3, 7, 49, 99):
        got, want = q.lookup((), k), jq.lookup((), k)
        assert (None if got is None else got.to_pylist()) == (None if want is None else want.to_pylist())


def test_lookup_file_cache_eviction_and_local_store(tmp_warehouse, tmp_path):
    t = _catalog("port", tmp_warehouse).create_table(
        "db.c", _schema("port"), primary_keys=["id"], options={"bucket": "1", "write-only": "true"}
    )
    for lo in range(0, 400, 100):
        write(t, {"id": list(range(lo, lo + 100)), "name": [f"n{i}" for i in range(lo, lo + 100)], "v": [float(i) for i in range(lo, lo + 100)]})
    store_dir = str(tmp_path / "lookup-store")
    q = LocalTableQuery(t, cache_bytes=1, local_store_dir=store_dir, device="cpu")
    for k in (5, 150, 250, 399, 5):  # a one-byte budget keeps one file: every other probe reloads
        assert q.lookup((), k).to_pylist() == [(k, f"n{k}", float(k))]
    assert len(q.cache._cache) == 1
    names = sorted(os.listdir(store_dir))
    assert len(names) == 8 and sum(n.endswith(".hidx") for n in names) == 4
    # a new query reloads from the local store, not the data files
    from paimon_tpu_torch.lookup import LookupFile

    loads = []
    real_load = LookupFile.load
    LookupFile.load = staticmethod(lambda *a, **kw: loads.append(a[1]) or real_load(*a, **kw))
    try:
        q2 = LocalTableQuery(t, local_store_dir=store_dir, device="cpu")
        assert scalar_oracle(q2, [0, 199, 301, 1000]) == [(0, "n0", 0.0), (199, "n199", 199.0), (301, "n301", 301.0), None]
        assert len(loads) == 3
    finally:
        LookupFile.load = real_load
    # the sweep drops expired pairs whole, then the oldest past the disk budget
    old = time.time() - 7200
    for n in names[:2]:
        os.utime(os.path.join(store_dir, n), (old, old))
    levels = next(iter(q2._levels.values()))
    levels._sweep_local_store()
    assert len(os.listdir(store_dir)) == 6
    levels.max_disk_bytes = 1
    levels._sweep_local_store()
    assert os.listdir(store_dir) == []


def test_compaction_chain_upgrade_keeps_rows(tmp_warehouse):
    """One commit that rewrites level-0 runs into a file F at a middle level
    and then upgrades F to the top level keeps F: the cancel of files made
    and consumed within a commit keys on (name, level)."""
    from paimon_tpu_torch.core.kv import KVBatch
    from paimon_tpu_torch.core.manifest import CommitMessage, ManifestCommittable

    t = _catalog("port", tmp_warehouse).create_table(
        "db.ch", _schema("port"), primary_keys=["id"], options={"bucket": "1", "write-buffer-rows": "8"}
    )
    store = t.store
    wf = store.writer_factory((), 0)
    schema = _schema("port")

    def mk(ids, seq0, level):
        batch = tt.ColumnBatch.from_pydict(schema, {"id": ids, "name": [f"n{k}" for k in ids], "v": [float(k) for k in ids]})
        return wf.write(KVBatch.from_rows(batch, seq0), level=level)

    metas = mk(list(range(0, 10000)), 0, 5) + mk(list(range(20000, 23000)), 10000, 4)
    store.new_commit().commit(
        ManifestCommittable(1, messages=[CommitMessage(partition=(), bucket=0, total_buckets=1, new_files=metas)])
    )
    wb = t.new_batch_write_builder()
    w = wb.new_write()
    for i in range(6):
        ids = [50000 + i * 10 + j for j in range(8)]
        w.write({"id": ids, "name": [f"n{k}" for k in ids], "v": [float(k) for k in ids]})
    w.compact(full=True)
    wb.new_commit().commit(w.prepare_commit())
    expect = set(range(10000)) | set(range(20000, 23000)) | {50000 + i * 10 + j for i in range(6) for j in range(8)}
    rb = t.new_read_builder()
    assert sorted(rb.new_read().read_all(rb.new_scan().plan()).column("id").values.tolist()) == sorted(expect)
    q = LocalTableQuery(t, device="cpu")
    probe = [0, 9999, 20000, 22999, 50000, 50057, 10000]
    assert q.get_batch(probe).to_pylist() == scalar_oracle(q, probe)
    assert [r is None for r in q.get_batch(probe).to_pylist()] == [False] * 6 + [True]


def test_lookup_respects_deletion_vectors(tmp_warehouse):
    t = _catalog("port", tmp_warehouse).create_table(
        "db.dv", _schema("port"), primary_keys=["id"], options={"bucket": "1", "deletion-vectors.enabled": "true"}
    )
    write(t, {"id": [1, 2], "name": ["a", "b"], "v": [1.0, 2.0]})
    assert t.delete_where(equal("id", 1)) == 1
    q = LocalTableQuery(t, device="cpu")
    assert q.lookup((), 1) is None
    assert q.lookup((), 2) is not None
    assert q.get_batch([1, 2]).to_pylist() == [None, (2, "b", 2.0)]
    jq = JaxQuery(jax_load_table(f"{tmp_warehouse}/db.db/dv"))
    assert jq.get_batch([1, 2]).to_pylist() == [None, (2, "b", 2.0)]


def test_get_metric_group(tmp_warehouse):
    t = _catalog("port", tmp_warehouse).create_table(
        "db.m", _schema("port"), primary_keys=["id"], options={"bucket": "1", "file-index.bloom-filter.primary-key.enabled": "true"}
    )
    write(t, {"id": [1, 2], "name": ["a", "b"], "v": [1.0, 2.0]})
    q = LocalTableQuery(t, device="cpu")
    g = get_metrics()
    gets0, probed0 = g.counter("gets").count, g.counter("keys_probed").count
    q.get_batch([1, 2, 3])
    assert g.counter("gets").count == gets0 + 3
    assert g.counter("keys_probed").count > probed0
    assert g.histogram("probe_ms").count > 0


def test_entry_points_raise_without_a_gpu(tmp_warehouse):
    t = _catalog("port", tmp_warehouse).create_table("db.e", _schema("port"), primary_keys=["id"], options={"bucket": "1"})
    write(t, {"id": [1], "name": ["a"], "v": [1.0]})
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalTableQuery(t)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FullCacheLookupTable(t)


# ---------------------------------------------------------------------------
# full-cache lookup tables
# ---------------------------------------------------------------------------


def _dim(pkg, tmp_warehouse, keyed=True):
    m = jt if pkg == "jax" else tt
    rt = m.RowType.of(("id", m.BIGINT(False)), ("name", m.STRING()), ("grp", m.STRING()))
    t = _catalog(pkg, tmp_warehouse).create_table("db.dim", rt, primary_keys=["id"] if keyed else [], options={"bucket": "1"})
    n = 300
    write(t, {"id": list(range(n)), "name": [f"n{i}" for i in range(n)], "grp": [f"g{i % 7}" for i in range(n)]})
    return t


def _lookup_pair(path, join_keys):
    return (
        FullCacheLookupTable(_port_table(path), join_keys=join_keys, device="cpu"),
        JaxLookupTable(jax_load_table(path), join_keys=join_keys),
    )


def _assert_lookup_parity(lt, jlt, probe_rows):
    assert lt.mode == jlt.mode and len(lt) == len(jlt)
    assert lt.state_batch().to_pylist() == jlt.state_batch().to_pylist()
    for how in ("inner", "left"):
        batch, lidx = lt.get_batch(probe_rows, how=how)
        jbatch, jlidx = jlt.get_batch(probe_rows, how=how)
        assert batch.to_pylist() == jbatch.to_pylist()
        np.testing.assert_array_equal(lidx, jlidx)
    for k in probe_rows[:20]:
        assert lt.get(k) == jlt.get(k) == jlt._legacy_get(tuple(k))


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("mode", ["primary", "secondary", "no-pk"])
def test_full_cache_lookup_table_parity_across_refresh(tmp_warehouse, writer, mode):
    t = _dim(writer, tmp_warehouse, keyed=mode != "no-pk")
    path = f"{tmp_warehouse}/db.db/dim"
    join_keys = {"primary": None, "secondary": ["grp"], "no-pk": ["grp"]}[mode]
    lt, jlt = _lookup_pair(path, join_keys)
    rng = np.random.default_rng(5)
    if join_keys is None:
        probe = [(int(k),) for k in rng.integers(-20, 330, 200)]
    else:
        probe = [(f"g{int(k)}",) for k in rng.integers(0, 9, 60)]
    _assert_lookup_parity(lt, jlt, probe)
    # changes: upserts and deletes (keyed) or appends (no-pk), then refresh
    if mode == "no-pk":
        write(t, {"id": [1000, 1001, 1002], "name": ["x", "y", "z"], "grp": ["g1", "g8", "g1"]})
    else:
        write(t, {"id": [5, 6, 400], "name": ["CHANGED", "moved", "new"], "grp": ["g5", "g1", "g3"]})
        write(t, {"id": [7, 8, 9999], "name": [None] * 3, "grp": [None] * 3}, kinds=["-D"] * 3)
    assert lt.refresh() == jlt.refresh() > 0
    _assert_lookup_parity(lt, jlt, probe)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_lookup_join_matches_jax(tmp_warehouse, writer):
    _dim(writer, tmp_warehouse)
    path = f"{tmp_warehouse}/db.db/dim"
    lt, jlt = _lookup_pair(path, None)
    rng = np.random.default_rng(43)
    ids, xs = rng.integers(0, 450, 1000).tolist(), rng.random(1000).tolist()
    probe = tt.ColumnBatch.from_pydict(tt.RowType.of(("id", tt.BIGINT()), ("x", tt.DOUBLE())), {"id": ids, "x": xs})
    jprobe = jt.ColumnBatch.from_pydict(jt.RowType.of(("id", jt.BIGINT()), ("x", jt.DOUBLE())), {"id": ids, "x": xs})
    out, jout = lookup_join(lt, probe), jax_lookup_join(jlt, jprobe)
    assert out.schema.field_names == jout.schema.field_names == ["id", "x", "id_lookup", "name", "grp"]
    assert out.to_pylist() == jout.to_pylist()
    names = dict(zip(range(300), (f"n{i}" for i in range(300))))
    assert [r[3] for r in out.to_pylist()] == [names.get(i) for i in ids]
