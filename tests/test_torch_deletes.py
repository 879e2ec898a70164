"""Row-level deletes in the port against the JAX package: deletion vectors
(paimon_tpu_torch/core/deletionvectors.py), DELETE FROM
(paimon_tpu_torch/table/delete.py), and record-level TTL on read and in
compaction (core/store.py record_expire_predicate).

- Containers: each package reads the other's deletion-vector index files,
  one container and a chain (a 64-byte target size), positions drawn with
  seed 3.
- Positions: the same table copied twice, one DELETE by each package on
  its copy: equal positions for every data file, and the same rows.
- The primary-key cases of tests/test_deletion_vectors.py, each table
  written by one package and deleted from, compacted and read by either.
- A bucket-2 table of four overlapping runs, an upsert and -D rows,
  deleted from by key and by value, read under the numpy, xla-segmented
  and pallas sort engines (the JAX package's Pallas in interpret mode).
- changelog-producer=lookup on a deletion-vector table: the lookup of a
  later flush must not see the deleted rows.
- The -D retract strategy, with and without delete.force-produce-changelog.
- TTL: expired rows dropped on read and by a full compaction, the time
  field in seconds, millis and micros; timestamps lie days from the
  cutoff, so the clock's progress between the packages changes nothing.

Tolerance: exact.
"""

import io
import shutil
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import paimon_tpu as jt
import paimon_tpu_torch as tt
from paimon_tpu.catalog import FileSystemCatalog as JaxCatalog
from paimon_tpu.core import deletionvectors as jdv
from paimon_tpu.data import predicate as jp
from paimon_tpu.fs import LocalFileIO as JaxFileIO
from paimon_tpu_torch.catalog import FileSystemCatalog as PortCatalog
from paimon_tpu_torch.core import deletionvectors as pdv
from paimon_tpu_torch.core.commit import FileStoreCommit
from paimon_tpu_torch.core.snapshot import SnapshotManager
from paimon_tpu_torch.data import predicate as tp
from paimon_tpu_torch.fs import LocalFileIO
from paimon_tpu_torch.options import CoreOptions as PortOptions

ENGINES = ["numpy", "xla-segmented", "pallas"]
PAIRS = [("jax", "port"), ("port", "jax"), ("port", "port")]
DV = {"bucket": "1", "deletion-vectors.enabled": "true"}


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


@pytest.fixture(scope="module")
def warehouse(tmp_path_factory):
    return str(tmp_path_factory.mktemp("torch_deletes_warehouse"))


def _catalog(who: str, warehouse: str):
    return JaxCatalog(warehouse) if who == "jax" else PortCatalog(warehouse, device="cpu")


def _pkg(who: str):
    return jt if who == "jax" else tt


def _preds(who: str):
    return jp if who == "jax" else tp


def _schema(pkg):
    return pkg.RowType.of(("id", pkg.BIGINT(False)), ("s", pkg.STRING()), ("v", pkg.DOUBLE()))


def _commit(table, rows: dict, kinds=None) -> None:
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.write(rows, kinds) if kinds is not None else w.write(rows)
    wb.new_commit().commit(w.prepare_commit())


def _compact(table) -> None:
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.compact(full=True)
    wb.new_commit().commit(w.prepare_commit())


def _read(table, engine=None, predicate=None) -> list:
    if engine is not None:
        table = table.copy({"sort-engine": engine})
    rb = table.new_read_builder()
    if predicate is not None:
        rb = rb.with_filter(predicate)
    with pytest.MonkeyPatch.context() as mp:
        # the JAX package's plain index download (what the port mirrors)
        mp.setenv("PAIMON_TPU_FORCE_COMPACT", "0")
        out = rb.new_read().read_all(rb.new_scan().plan())
    return [tuple(v.item() if hasattr(v, "item") else v for v in row) for row in out.to_pylist()]


def _both(warehouse, ident, engine=None, predicate_of=None) -> list:
    """The table's rows as each package reads them; asserts they agree."""
    reads = [_read(_catalog(who, warehouse).get_table(ident), engine,
                   predicate_of(_preds(who)) if predicate_of else None) for who in ("jax", "port")]
    assert reads[0] == reads[1]
    return reads[1]


def _dvs(warehouse, ident) -> dict:
    """{data file name: positions} of the latest snapshot, read by the port."""
    table = PortCatalog(warehouse, device="cpu").get_table(ident)
    plan = table.store.new_scan().plan()
    idx = pdv.DeletionVectorsIndexFile(LocalFileIO(), table.path)
    return {name: dv.positions.tolist()
            for container in plan.dv_indexes().values() for name, dv in idx.read_all(container).items()}


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("target", [2 << 20, 64], ids=["one-container", "chain"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_containers_read_across_packages(tmp_path, writer, target):
    rng = np.random.default_rng(3)
    vectors = {f"data-{i}.parquet": rng.choice(1 << 20, int(rng.integers(1, 3000)), replace=False)
               for i in range(6)}
    mod = jdv if writer == "jax" else pdv
    fio = JaxFileIO() if writer == "jax" else LocalFileIO()
    name, total = mod.DeletionVectorsIndexFile(fio, str(tmp_path), target).write(
        {f: mod.DeletionVector(p) for f, p in vectors.items()})
    assert total == sum(len(p) for p in vectors.values())
    for reader, rfio in ((jdv, JaxFileIO()), (pdv, LocalFileIO())):
        idx = reader.DeletionVectorsIndexFile(rfio, str(tmp_path))
        got = idx.read_all(name)
        assert sorted(got) == sorted(vectors)
        for f, p in vectors.items():
            assert got[f].positions.dtype == np.uint32
            assert np.array_equal(got[f].positions, np.unique(p).astype(np.uint32))
        assert len(idx.chain_names(name)) == (1 if target > 1 << 16 else len(vectors))
    # an empty bucket's maintainer writes nothing; a merge keeps both sets
    m = pdv.DeletionVectorsMaintainer(pdv.DeletionVectorsIndexFile(LocalFileIO(), str(tmp_path)))
    assert m.prepare_commit((), 0) is None
    m.notify_deletion("f", np.array([5, 1]))
    m.notify_deletion("f", np.array([1, 9]))
    assert m.dvs["f"].positions.tolist() == [1, 5, 9]
    assert np.flatnonzero(m.dvs["f"].deleted_mask(8)).tolist() == [1, 5]
    assert m.prepare_commit(("p",), 3).to_dict()["rowCount"] == 3


# ---------------------------------------------------------------------------
# the reference's primary-key cases, across packages
# ---------------------------------------------------------------------------


def _make(warehouse, who, ident, options=DV):
    return _catalog(who, warehouse).create_table(ident, _schema(_pkg(who)), primary_keys=["id"], options=options)


@pytest.mark.parametrize("writer, deleter", PAIRS)
def test_dv_pk_table_read_applies_vectors(warehouse, writer, deleter):
    ident = f"db.dv4_{writer}_{deleter}"
    t = _make(warehouse, writer, ident)
    _commit(t, {"id": np.array([1, 2, 3]), "s": np.array(["a", "b", "c"], dtype=object), "v": np.array([1.0, 2.0, 3.0])})
    _commit(t, {"id": np.array([2]), "s": np.array(["b2"], dtype=object), "v": np.array([22.0])})
    assert _catalog(deleter, warehouse).get_table(ident).delete_where(_preds(deleter).equal("id", 1)) == 1
    assert _both(warehouse, ident) == [(2, "b2", 22.0), (3, "c", 3.0)]
    assert sum(len(p) for p in _dvs(warehouse, ident).values()) == 1


@pytest.mark.parametrize("writer, deleter", PAIRS)
def test_dv_pk_delete_does_not_resurrect_old_version(warehouse, writer, deleter):
    ident = f"db.dv5_{writer}_{deleter}"
    t = _make(warehouse, writer, ident)
    _commit(t, {"id": np.array([2, 5]), "s": np.array(["old", "x"], dtype=object), "v": np.array([2.0, 5.0])})
    _commit(t, {"id": np.array([2]), "s": np.array(["new"], dtype=object), "v": np.array([22.0])})
    # the predicate matches only id 2's newest version: the older one must not come back
    assert _catalog(deleter, warehouse).get_table(ident).delete_where(_preds(deleter).greater_than("v", 20.0)) == 1
    assert _both(warehouse, ident) == [(5, "x", 5.0)]
    # and a predicate matching only the old version deletes nothing
    assert _catalog(deleter, warehouse).get_table(ident).delete_where(_preds(deleter).equal("s", "old")) == 0
    assert sorted(map(len, _dvs(warehouse, ident).values())) == [1, 1]


@pytest.mark.parametrize("writer, compactor", PAIRS)
def test_compaction_does_not_resurrect_dv_rows(warehouse, writer, compactor):
    """A full compaction by either package rewrites the files with vectors,
    dropping their rows, and its commit drops the vectors."""
    ident = f"db.dv6_{writer}_{compactor}"
    t = _make(warehouse, writer, ident)
    _commit(t, {"id": np.array([1, 2, 3]), "s": np.array(["a", "b", "c"], dtype=object), "v": np.array([1.0, 2.0, 3.0])})
    assert t.delete_where(_preds(writer).equal("id", 2)) == 1
    _compact(_catalog(compactor, warehouse).get_table(ident))
    assert [r[0] for r in _both(warehouse, ident)] == [1, 3]
    for who in ("jax", "port"):
        plan = _catalog(who, warehouse).get_table(ident).store.new_scan().plan()
        assert plan.dv_index_for((), 0) is None
        assert sum(e.file.row_count for e in plan.entries) == 2
        assert not [e for e in plan.index_entries if e.kind == "DELETION_VECTORS"]


def test_upgraded_file_keeps_its_vector(warehouse):
    """A streaming writer restored before a DELETE compacts fully: the file
    holding id 7 moves to the top level under its name (DELETE + ADD of one
    name), so the commit must keep its vector, and id 7 stays deleted. Both
    packages leave the same vector and rows. (Files of other sizes may be
    rewritten: the packages' encoders differ.)"""
    seen = {}
    for who in ("jax", "port"):
        t = _make(warehouse, who, f"db.upgrade_{who}", {**DV, "target-file-size": "1 kb"})
        wb = t.new_stream_write_builder()
        w, c = wb.new_write(), wb.new_commit()
        ids = np.arange(1, 61)
        w.write({"id": ids, "s": np.array([f"x{i}" for i in ids], dtype=object), "v": ids * 1.0})
        c.commit_messages(1, w.prepare_commit())
        # the first file (ids 1-32 at 1 kb a file) holds id 7
        (first,) = [f.file_name for f in _catalog("port", warehouse).get_table(f"db.upgrade_{who}").store.restore_files(
            (), 0) if f.min_key == (1,)]
        # another user deletes (under the writer's own user, the DELETE's
        # identifier would mark the writer's later commits as replayed)
        other = (JaxCatalog(warehouse, commit_user="eraser") if who == "jax"
                 else PortCatalog(warehouse, commit_user="eraser", device="cpu"))
        assert other.get_table(f"db.upgrade_{who}").delete_where(_preds(who).equal("id", 7)) == 1
        w.compact(full=True)
        assert c.commit_messages(2, w.prepare_commit())
        port = PortCatalog(warehouse, device="cpu").get_table(f"db.upgrade_{who}")
        files = port.store.restore_files((), 0)
        assert first in [f.file_name for f in files]
        assert {f.level for f in files} == {port.store.options.num_levels - 1}
        dvs = _dvs(warehouse, f"db.upgrade_{who}")
        assert list(dvs) == [first]
        seen[who] = (dvs[first], _both(warehouse, f"db.upgrade_{who}"))
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == [6] and [r[0] for r in seen["port"][1]] == [i for i in range(1, 61) if i != 7]


@pytest.mark.parametrize("writer, deleter", PAIRS)
def test_delete_where_pk_table_retract(warehouse, writer, deleter):
    ident = f"db.dv2_{writer}_{deleter}"
    _make(warehouse, writer, ident, {"bucket": "1"})
    t = _catalog(writer, warehouse).get_table(ident)
    _commit(t, {"id": np.array([1, 2, 3]), "s": np.array(["a", "b", "c"], dtype=object), "v": np.array([1.0, 2.0, 3.0])})
    assert _catalog(deleter, warehouse).get_table(ident).delete_where(_preds(deleter).in_("id", [1, 3])) == 2
    assert [r[0] for r in _both(warehouse, ident)] == [2]


# ---------------------------------------------------------------------------
# a larger table: positions, engines, compaction, continuation
# ---------------------------------------------------------------------------


def _bench_rows(ids: np.ndarray, r: int) -> dict:
    return {"id": ids.astype(np.int64),
            "s": np.array([None if x % 13 == r else f"r{r}-{int(x) % 30}" for x in ids], dtype=object),
            "v": ids * 0.5 + (0 if r < 4 else 1000 + ids % 97)}


def _bench_table(warehouse, who, ident, extra=None):
    """Bucket 2, four overlapping runs, a 200-id upsert, -D rows for 100 ids."""
    t = _make(warehouse, who, ident, {"bucket": "2", "deletion-vectors.enabled": "true", "write-only": "true",
                                      **(extra or {})})
    rng = np.random.default_rng(7)
    ids = rng.permutation(2000)
    for r in range(4):
        _commit(t, _bench_rows(np.sort(ids[r * 600 : r * 600 + 800] % 2000), r))
    _commit(t, _bench_rows(rng.choice(2000, 200, replace=False), 4))
    dead = rng.choice(2000, 100, replace=False)
    _commit(t, _bench_rows(dead, 5), np.full(100, int(jt.RowKind.DELETE), dtype=np.uint8))
    return t


def _deletes(p):
    """An erasure by key, then a value predicate that an upsert's newest
    version fails (v >= 1000 for the upserted ids) where its older one
    passes."""
    return [p.in_("id", list(range(0, 2000, 7))), p.less_than("v", 300.0)]


def test_delete_positions_match_the_reference(warehouse):
    """One table, two copies: the JAX package deletes from one, the port
    from the other; every data file gets the same positions."""
    t = _bench_table(warehouse, "jax", "db.positions_jax")
    shutil.copytree(t.path, t.path.replace("positions_jax", "positions_port"))
    counts = {}
    for who in ("jax", "port"):
        table = _catalog(who, warehouse).get_table(f"db.positions_{who}")
        counts[who] = [table.delete_where(pred) for pred in _deletes(_preds(who))]
    assert counts["jax"] == counts["port"] and all(counts["port"])
    jax_dvs, port_dvs = _dvs(warehouse, "db.positions_jax"), _dvs(warehouse, "db.positions_port")
    assert port_dvs == jax_dvs and sum(map(len, port_dvs.values())) > 500
    assert _both(warehouse, "db.positions_jax") == _both(warehouse, "db.positions_port")


@pytest.mark.parametrize("writer, deleter", PAIRS)
def test_deletes_read_and_compact_like_the_reference(warehouse, writer, deleter):
    ident = f"db.bench_{writer}_{deleter}"
    t = _bench_table(warehouse, writer, ident)
    before = _both(warehouse, ident)  # bucket 0's rows by id, then bucket 1's
    d = _catalog(deleter, warehouse).get_table(ident)
    erased, by_value = (d.delete_where(p) for p in _deletes(_preds(deleter)))
    want = [r for r in before if r[0] % 7 and not r[2] < 300.0]
    assert erased == sum(1 for r in before if r[0] % 7 == 0) and by_value == len(before) - erased - len(want)
    for engine in ENGINES:
        assert _both(warehouse, ident, engine) == want
        assert _both(warehouse, ident, engine, lambda p: p.between("id", 500, 900)) == [
            r for r in want if 500 <= r[0] <= 900]
    # new versions of deleted keys come back; the next writer continues
    _commit(_catalog(writer, warehouse).get_table(ident), _bench_rows(np.arange(0, 70, 7), 6))
    want = sorted(want + [tuple(x.item() if hasattr(x, "item") else x for x in row)
                          for row in zip(*_bench_rows(np.arange(0, 70, 7), 6).values())])
    assert sorted(_both(warehouse, ident, "pallas")) == want
    _compact(_catalog(deleter, warehouse).get_table(ident).copy({"write-only": "false"}))
    assert sorted(_both(warehouse, ident)) == want and _dvs(warehouse, ident) == {}


def test_vectors_on_files_of_many_row_groups(warehouse):
    """Files of 16 row groups (the JAX package's parquet.row-group.rows=64)
    with vectors: a filtered read must not skip a row group of such a file,
    or the vector's positions land on other rows. A single-run and a
    merged section, under each sort engine."""
    ident = "db.dv_row_groups"
    t = _make(warehouse, "jax", ident, {**DV, "write-only": "true", "parquet.row-group.rows": "64"})
    _commit(t, _bench_rows(np.arange(1024), 0))
    _commit(t, _bench_rows(np.arange(2000, 2100), 1))
    _commit(t, _bench_rows(np.arange(2050, 3074), 2))
    assert t.delete_where(jp.in_("id", list(range(3, 3074, 5)))) == 420
    for engine in ENGINES:
        for lo, hi in ((130, 700), (2060, 2900)):
            got = _both(warehouse, ident, engine, lambda p: p.between("id", lo, hi))
            assert [r[0] for r in got] == [i for i in range(lo, hi + 1) if i % 5 != 3 and not 1024 <= i < 2000]


# ---------------------------------------------------------------------------
# lookup changelog, retract changelog
# ---------------------------------------------------------------------------


def _changelog(path) -> list:
    """Per snapshot: its kind and the (row kinds, rows) of each changelog file."""
    io_ = LocalFileIO()
    sm = SnapshotManager(io_, path)
    commit = FileStoreCommit(io_, path, "reader", 0, PortOptions())
    out = []
    for sid in range(1, sm.latest_snapshot_id() + 1):
        snap = sm.snapshot(sid)
        files = []
        for meta in commit.manifest_list.read(snap.changelog_manifest_list) if snap.changelog_manifest_list else []:
            for e in commit.manifest_file.read(meta.file_name):
                t = pq.read_table(f"{path}/bucket-0/{e.file.file_name}")
                files.append((t.column("_VALUE_KIND").to_pylist(),
                              list(zip(*(t.column(c).to_pylist() for c in ("id", "s", "v"))))))
        out.append((snap.commit_kind.value, files))
    return out


def test_lookup_changelog_skips_deleted_rows(warehouse):
    """changelog-producer=lookup on a deletion-vector table: after id 2 is
    deleted, its new version is an insert (+I), not an update of the
    deleted row; both packages write the same changelog."""
    seen = {}
    for who in ("jax", "port"):
        ident = f"db.lookup_{who}"
        t = _make(warehouse, who, ident, {**DV, "changelog-producer": "lookup"})
        _commit(t, {"id": np.array([1, 2, 3]), "s": np.array(["a", "b", "c"], dtype=object), "v": np.array([1.0, 2.0, 3.0])})
        assert t.delete_where(_preds(who).equal("id", 2)) == 1
        _commit(t, {"id": np.array([2, 3]), "s": np.array(["b2", "c2"], dtype=object), "v": np.array([2.5, 3.5])})
        seen[who] = (_changelog(t.path), _read(t))
    assert seen["port"] == seen["jax"]
    changelog, rows = seen["port"]
    assert rows == [(1, "a", 1.0), (2, "b2", 2.5), (3, "c2", 3.5)]
    kinds = {row[0]: k for _, files in changelog[2:] for ks, rs in files for k, row in zip(ks, rs)}
    assert kinds[2] == int(jt.RowKind.INSERT) and kinds[3] == int(jt.RowKind.UPDATE_AFTER)


@pytest.mark.parametrize("force", [False, True], ids=["no-changelog", "force-produce-changelog"])
def test_retract_strategy_and_its_changelog(warehouse, force):
    seen = {}
    for who in ("jax", "port"):
        ident = f"db.retract_{who}_{int(force)}"
        t = _make(warehouse, who, ident, {"bucket": "1", "delete.force-produce-changelog": str(force).lower()})
        _commit(t, {"id": np.arange(6), "s": np.array(list("abcdef"), dtype=object), "v": np.arange(6) * 1.5})
        assert t.delete_where(_preds(who).greater_than("v", 4.0)) == 3
        seen[who] = (_changelog(t.path), _read(t))
    assert seen["port"] == seen["jax"]
    changelog, rows = seen["port"]
    assert [r[0] for r in rows] == [0, 1, 2]
    retracts = [(ks, rs) for _, files in changelog for ks, rs in files]
    if force:
        assert retracts == [([int(jt.RowKind.DELETE)] * 3, [(3, "d", 4.5), (4, "e", 6.0), (5, "f", 7.5)])]
    else:
        assert retracts == []


def test_delete_on_append_table_raises(warehouse):
    """DELETE on an append table, once refused by the port, is the JAX
    package's copy-on-write rewrite: each package deletes from its own
    table, and each table reads the same rows in both packages
    (tests/test_torch_append.py holds the rest)."""
    rows = {"id": np.array([1, 2, 3, 2]), "s": np.array(["a", "b", "c", "d"], dtype=object),
            "v": np.array([1.0, 2.0, 3.0, 4.0])}
    seen = {}
    for who in ("jax", "port"):
        t = _catalog(who, warehouse).create_table(f"db.append_guard_{who}", _schema(_pkg(who)), options={"bucket": "1"})
        _commit(t, rows)
        assert t.delete_where(_preds(who).equal("id", 2)) == 2
        seen[who] = [_read(_catalog(reader, warehouse).get_table(f"db.append_guard_{who}")) for reader in ("jax", "port")]
    assert seen["port"] == seen["jax"] == [[(1, "a", 1.0), (3, "c", 3.0)]] * 2


# ---------------------------------------------------------------------------
# record-level TTL
# ---------------------------------------------------------------------------

UNITS = {"seconds": 1, "millis": 1000, "micros": 1_000_000}


def _ttl_schema(pkg):
    return pkg.RowType.of(("id", pkg.BIGINT(False)), ("ts", pkg.BIGINT()), ("v", pkg.BIGINT()))


@pytest.mark.parametrize("unit", list(UNITS))
def test_record_ttl_on_read_and_in_compaction(warehouse, unit):
    """A tenth of the ids are 3 days old, a few have no time, the rest are
    fresh; expire-time 1 d. Both packages read the same rows, and a full
    compaction by each (one copy each) leaves only the kept rows on disk."""
    now = time.time()
    ids = np.arange(300)
    age_s = np.where(ids % 10 == 0, 3 * 86400, 60)
    ts = [None if i % 37 == 5 else int((now - a) * UNITS[unit]) for i, a in zip(ids, age_s)]
    options = {"bucket": "1", "write-only": "true", "record-level.expire-time": "1 d",
               "record-level.time-field": "ts", "record-level.time-field-type": unit}
    kept = [int(i) for i, t in zip(ids, ts) if t is None or i % 10]
    for writer in ("jax", "port"):
        ident = f"db.ttl_{unit}_{writer}"
        t = _catalog(writer, warehouse).create_table(ident, _ttl_schema(_pkg(writer)), primary_keys=["id"],
                                                    options=options)
        _commit(t, {"id": ids, "ts": ts, "v": ids * 2})
        _commit(t, {"id": ids[::3], "ts": [ts[i] for i in ids[::3]], "v": ids[::3] * 3})
        assert [r[0] for r in _both(warehouse, ident)] == kept
        assert [r[0] for r in _both(warehouse, ident, "pallas", lambda p: p.less_than("id", 100))] == [
            i for i in kept if i < 100]
        shutil.copytree(t.path, t.path + "_c")
        for compactor, name in (("jax", ident), ("port", ident + "_c")):
            _compact(_catalog(compactor, warehouse).get_table(name).copy({"write-only": "false"}))
        rows = {}
        for suffix in ("", "_c"):
            table = PortCatalog(warehouse, device="cpu").get_table(ident + suffix)
            rows[suffix] = sum(e.file.row_count for e in table.store.new_scan().plan().entries)
            assert [r[0] for r in _both(warehouse, ident + suffix)] == kept
        assert rows[""] == rows["_c"] == len(kept)
