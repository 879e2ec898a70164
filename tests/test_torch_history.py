"""Table history in the port (paimon_tpu_torch) against the JAX package, on
the CPU (device="cpu" for the port): time travel, incremental scans,
rollback and branches.

- Time travel: tables of six commits (ids with repeats, -D rows, a
  watermark per commit, COMPACT snapshots between them, changelog-producer
  =input) written by either package at bucket 1, bucket 2, and bucket 2
  partitioned by dt; tags t2 and t4. Each package reads each table under
  every selector (scan.snapshot-id, scan.tag-name, scan.version,
  scan.timestamp-millis, scan.timestamp, scan.watermark,
  scan.file-creation-time-millis) and incremental-between /
  incremental-between-timestamp in delta and changelog mode, by ids, tags
  and times. Compared: the splits (partition, bucket, file names, snapshot
  id, raw_convertible, is_changelog, deletion-vector container) and each
  split's rows with their kinds. The JAX package's ValueErrors for bad
  ranges are the port's, message for message.
- Deletion vectors and record TTL at an old snapshot: a DELETE by either
  package; each snapshot's read takes that snapshot's vectors, and the TTL
  applies to every snapshot's read.
- Rollback to an id, to a tag, and to a tag whose snapshot is gone, by
  each package on copytree twins of one table: the directories are equal
  file for file, and so are the reads. A tag of a rolled-back snapshot
  stays in both packages, naming deleted files (ROADMAP Queue 3).
- Branches created by one package and read or written by the other;
  fast-forward on twins; a copied branch view; expiry on a branch view,
  which deletes no data file in either package (ROADMAP Queue 3).

Tolerance: exact. Every value is copied, never computed.
"""

import datetime
import io
import os
import shutil
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import paimon_tpu as jt
import paimon_tpu_torch as tt
from paimon_tpu.catalog import FileSystemCatalog as JaxCatalog
from paimon_tpu.data import predicate as jp
from paimon_tpu.table import load_table as jax_load_table
from paimon_tpu.table.branch import BranchManager as JaxBranchManager
from paimon_tpu.table.branch import branch_table as jax_branch_table
from paimon_tpu.types import RowKind as JaxRowKind
from paimon_tpu_torch.catalog import FileSystemCatalog as PortCatalog
from paimon_tpu_torch.data import predicate as tp
from paimon_tpu_torch.table import load_table as port_load_table
from paimon_tpu_torch.table.branch import BranchManager as PortBranchManager
from paimon_tpu_torch.table.branch import branch_table as port_branch_table

PKGS = ("jax", "port")
ENGINE = {"jax": {"sort-engine": "numpy"}, "port": {"sort-engine": "pallas"}}
COMPACTING = {"num-sorted-run.compaction-trigger": "3", "compaction.max-size-amplification-percent": "0"}
LAYOUTS = {
    "bucket1": ({"bucket": "1"}, False),
    "bucket2": ({"bucket": "2"}, False),
    "partitioned": ({"bucket": "2"}, True),
}
DTS = np.array(["2024-01-01", "2024-01-02"], dtype=object)
KINDS = ("+I", "-D")
COMMITS = 6
IDS = 60


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


@pytest.fixture(autouse=True)
def _plain_download(monkeypatch):
    # the JAX package's plain index download, which the port mirrors
    monkeypatch.setenv("PAIMON_TPU_FORCE_COMPACT", "0")


def _catalog(pkg, warehouse):
    if pkg == "jax":
        return JaxCatalog(warehouse, commit_user=pkg)
    return PortCatalog(warehouse, commit_user=pkg, device="cpu")


def _schema(pkg, partitioned):
    m = jt if pkg == "jax" else tt
    cols = [("id", m.BIGINT(False)), ("v", m.DOUBLE()), ("tag", m.STRING())]
    return m.RowType.of(*([("dt", m.STRING(False))] if partitioned else []), *cols)


def _create(pkg, warehouse, ident, options, partitioned=False):
    return _catalog(pkg, warehouse).create_table(
        ident, _schema(pkg, partitioned), partition_keys=["dt"] if partitioned else [],
        primary_keys=["dt", "id"] if partitioned else ["id"], options=options)


def _open(pkg, path, options=None, user=None):
    """The table at `path` through each package's load_table."""
    if pkg == "jax":
        return jax_load_table(path, commit_user=user or pkg, dynamic_options=options)
    return port_load_table(path, commit_user=user or pkg, dynamic_options=options, device="cpu")


def _commits(seed, n=COMMITS, rows=40, partitioned=False):
    rng = np.random.default_rng(seed)
    out = []
    for c in range(n):
        ids = rng.integers(0, IDS, rows).astype(np.int64)
        data = {"id": ids, "v": ids * 0.5 + c, "tag": np.array([f"c{c}"] * rows, dtype=object)}
        if partitioned:
            data = {"dt": DTS[rng.integers(0, 2, rows)], **data}
        kinds = [KINDS[k] for k in rng.choice(2, rows, p=[0.85, 0.15])] if c else ["+I"] * rows
        out.append((data, kinds))
    return out


def _stream(table, commits, first_ident=1, watermark=True):
    """One streaming commit per batch, 5 ms apart, the i-th carrying
    watermark 1000 * i."""
    wb = table.new_stream_write_builder()
    w, c = wb.new_write(), wb.new_commit()
    for i, (rows, kinds) in enumerate(commits, start=first_ident):
        w.write(rows, kinds)
        c.commit_messages(i, w.prepare_commit(), watermark=1000 * i if watermark else None)
        time.sleep(0.005)


def _py(v):
    return v.item() if hasattr(v, "item") else v


def _rows(batch) -> list[tuple]:
    return [tuple(_py(v) for v in row) for row in batch.to_pylist()]


def _split_key(s) -> tuple:
    return (tuple(s.partition), s.bucket, tuple(f.file_name for f in s.files), s.snapshot_id, s.raw_convertible,
            s.is_changelog, s.dv_index_file)


def _plan_and_read(table, predicate=None) -> list:
    """Per split of the batch plan: its key, and its rows with kinds."""
    rb = table.new_read_builder()
    if predicate is not None:
        rb = rb.with_filter(predicate)
    read = rb.new_read()
    out = []
    for s in rb.new_scan().plan():
        data, kinds = read.read_with_kinds(s)
        out.append((_split_key(s), [JaxRowKind(int(k)).short_string for k in kinds], _rows(data)))
    return out


def _read(table) -> list[tuple]:
    rb = table.new_read_builder()
    return _rows(rb.new_read().read_all(rb.new_scan().plan()))


def _both(path, options=None, predicate=None) -> dict:
    """Each package's plan and rows of the table at `path` under `options`."""
    out = {}
    for pkg in PKGS:
        pred = None if predicate is None else predicate(jp if pkg == "jax" else tp)
        out[pkg] = _plan_and_read(_open(pkg, path, {**ENGINE[pkg], **(options or {})}), pred)
    return out


def _disk(path) -> list:
    """Every file under `path` (temp files aside) by relative path, with
    the bytes of the LATEST and EARLIEST hints."""
    out = []
    for root, _, files in os.walk(path):
        for n in files:
            if n.startswith("."):
                continue
            rel = os.path.relpath(os.path.join(root, n), path)
            out.append((rel, open(os.path.join(root, n), "rb").read() if n in ("LATEST", "EARLIEST") else None))
    return sorted(out)


def _snapshot(table, sid):
    return table.store.snapshot_manager.snapshot(sid)


# ---------------------------------------------------------------------------
# time travel and incremental scans
# ---------------------------------------------------------------------------


_HISTORY: dict = {}


@pytest.fixture(scope="module")
def history_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("history"))


def _history(root, writer, layout):
    """The table of `layout` written by `writer`: six streaming commits, tags
    t2 and t4; cached per module."""
    key = (writer, layout)
    if key not in _HISTORY:
        options, partitioned = LAYOUTS[layout]
        table = _create(writer, root, f"db.h_{writer}_{layout}",
                        {**options, **COMPACTING, "changelog-producer": "input"}, partitioned)
        _stream(table, _commits(7, partitioned=partitioned))
        table.create_tag("t2", 2)
        table.create_tag("t4", 4)
        _HISTORY[key] = table
    return _HISTORY[key]


def _iso(millis: float) -> str:
    return datetime.datetime.fromtimestamp(millis / 1000).isoformat(sep=" ")


SELECTORS = {
    "snapshot-id=1": lambda t: {"scan.snapshot-id": "1"},
    "snapshot-id=2": lambda t: {"scan.snapshot-id": "2"},
    "snapshot-id=3": lambda t: {"scan.snapshot-id": "3"},
    "snapshot-id=latest": lambda t: {"scan.snapshot-id": str(t.store.snapshot_manager.latest_snapshot_id())},
    "tag-name=t2": lambda t: {"scan.tag-name": "t2"},
    "version=t4": lambda t: {"scan.version": "t4"},
    "version=3": lambda t: {"scan.version": "3"},
    "timestamp-millis=snapshot 2": lambda t: {"scan.timestamp-millis": str(_snapshot(t, 2).time_millis)},
    "timestamp-millis=before the first": lambda t: {"scan.timestamp-millis": str(_snapshot(t, 1).time_millis - 1)},
    "timestamp=snapshot 3": lambda t: {"scan.timestamp": _iso(_snapshot(t, 3).time_millis + 0.5)},
    "watermark=3500": lambda t: {"scan.watermark": "3500"},
    "watermark=past every": lambda t: {"scan.watermark": "1000000"},
    "file-creation-time-millis=snapshot 3": lambda t: {
        "scan.file-creation-time-millis": str(_snapshot(t, 3).time_millis)},
    "incremental-between=1,4": lambda t: {"incremental-between": "1,4"},
    "incremental-between=t2,t4": lambda t: {"incremental-between": "t2,t4"},
    "incremental-between=0,latest changelog": lambda t: {
        "incremental-between": f"0,{t.store.snapshot_manager.latest_snapshot_id()}",
        "incremental-between-scan-mode": "changelog"},
    "incremental-between=t2,6 changelog": lambda t: {
        "incremental-between": "t2,6", "incremental-between-scan-mode": "changelog"},
    "incremental-between-timestamp": lambda t: {
        "incremental-between-timestamp": f"{_snapshot(t, 1).time_millis},{_snapshot(t, 4).time_millis}"},
    "incremental-between-timestamp empty": lambda t: {
        "incremental-between-timestamp": f"{_snapshot(t, 2).time_millis},{_snapshot(t, 2).time_millis}"},
}


@pytest.mark.parametrize("selector", list(SELECTORS))
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("writer", PKGS)
def test_selectors_match_the_reference(history_root, writer, layout, selector):
    table = _history(history_root, writer, layout)
    got = _both(table.path, SELECTORS[selector](table))
    assert got["port"] == got["jax"]
    assert bool(got["port"]) != selector.endswith("empty")
    if selector.startswith("incremental-between"):
        assert all(key[5] for key, _, _ in got["port"]), "an incremental split is not a changelog split"


@pytest.mark.parametrize("writer", PKGS)
def test_selectors_move_the_read(history_root, writer):
    """The selectors read other rows than the latest snapshot, and those
    that name snapshot 2 read the same rows."""
    table = _history(history_root, writer, "bucket1")
    latest = _read(_open("port", table.path))
    at2 = [_read(_open("port", table.path, SELECTORS[s](table)))
           for s in ("snapshot-id=2", "tag-name=t2", "timestamp-millis=snapshot 2")]
    assert at2[0] == at2[1] == at2[2] != latest
    assert _read(_open("port", table.path, SELECTORS["timestamp-millis=before the first"](table))) == latest
    assert _read(_open("port", table.path, SELECTORS["watermark=past every"](table))) == latest


@pytest.mark.parametrize("writer", PKGS)
def test_time_travel_with_a_filter(history_root, writer):
    table = _history(history_root, writer, "partitioned")
    got = _both(table.path, {"scan.snapshot-id": "3"},
                lambda m: m.and_(m.less_than("id", 30), m.equal("dt", "2024-01-02")))
    assert got["port"] == got["jax"] and got["port"]
    assert all(key[0] == ("2024-01-02",) for key, _, _ in got["port"])


@pytest.mark.parametrize("spec,mode", [
    ("nope,alsono", "delta"), ("3,1", "delta"), ("2,2", "delta"), ("1", "delta"), ("1,2,3", "delta"),
    ("t2,nope", "delta"), ("1,3", "bogus"),
])
def test_incremental_between_errors_match_the_reference(history_root, spec, mode):
    table = _history(history_root, "port", "bucket1")
    errors = {}
    for pkg in PKGS:
        view = _open(pkg, table.path, {"incremental-between": spec, "incremental-between-scan-mode": mode})
        with pytest.raises(ValueError) as e:
            view.new_read_builder().new_scan().plan()
        errors[pkg] = str(e.value)
    assert errors["port"] == errors["jax"]


@pytest.mark.parametrize("writer", PKGS)
def test_incremental_between_prunes_partitions(history_root, writer):
    table = _history(history_root, writer, "partitioned")
    got = _both(table.path, {"incremental-between": "1,5"}, lambda m: m.equal("dt", "2024-01-01"))
    assert got["port"] == got["jax"] and got["port"]
    assert {key[0] for key, _, _ in got["port"]} == {("2024-01-01",)}


@pytest.mark.parametrize("writer", PKGS)
def test_limit_matches_the_reference(history_root, writer):
    table = _history(history_root, writer, "bucket2")
    reads = {}
    for pkg in PKGS:
        rb = _open(pkg, table.path, {**ENGINE[pkg], "scan.snapshot-id": "3"}).new_read_builder().with_limit(7)
        reads[pkg] = _rows(rb.new_read().read_all(rb.new_scan().plan()))
    assert reads["port"] == reads["jax"] and len(reads["port"]) == 7


@pytest.mark.parametrize("writer,deleter", [("jax", "port"), ("port", "jax"), ("port", "port")])
def test_deletion_vectors_at_an_old_snapshot(tmp_path, writer, deleter):
    """Each snapshot's read takes that snapshot's deletion vectors: before
    the DELETE every id is there, after it none of the deleted."""
    table = _create(writer, str(tmp_path), "db.dv", {"bucket": "1", "deletion-vectors.enabled": "true"})
    _stream(table, _commits(3, n=3), watermark=False)
    deleted = _open(deleter, table.path).delete_where((jp if deleter == "jax" else tp).less_than("id", 20))
    assert deleted > 0
    _stream(_open(writer, table.path), _commits(4, n=2), first_ident=10, watermark=False)
    latest = table.store.snapshot_manager.latest_snapshot_id()
    reads = {}
    for sid in range(1, latest + 1):
        got = _both(table.path, {"scan.snapshot-id": str(sid)})
        assert got["port"] == got["jax"]
        reads[sid] = got["port"]
    ids = {sid: {r[0] for _, _, rows in plan for r in rows} for sid, plan in reads.items()}
    assert min(ids[3]) < 20
    with_dv = [sid for sid, plan in reads.items() if any(key[6] for key, _, _ in plan)]
    assert with_dv and min(with_dv) > 3
    assert not any(i < 20 for i in ids[min(with_dv)])


def test_record_ttl_at_an_old_snapshot(tmp_path):
    """The record TTL applies to every snapshot's read."""
    now_s = int(time.time())
    options = {"bucket": "1", "record-level.expire-time": "1 h", "record-level.time-field": "ts"}
    tables = {}
    for pkg in PKGS:
        m = jt if pkg == "jax" else tt
        schema = m.RowType.of(("id", m.BIGINT(False)), ("ts", m.BIGINT()))
        tables[pkg] = _catalog(pkg, str(tmp_path)).create_table(f"db.ttl_{pkg}", schema, primary_keys=["id"],
                                                              options=options)
        for c in range(3):
            ids = np.arange(c * 10, c * 10 + 20, dtype=np.int64)
            ts = np.where(ids % 3 == 0, now_s - 86_400, now_s + 86_400)
            wb = tables[pkg].new_batch_write_builder()
            w = wb.new_write()
            w.write({"id": ids, "ts": ts})
            wb.new_commit().commit(w.prepare_commit())
    for writer in PKGS:
        for sid in (1, 2, 3):
            got = _both(tables[writer].path, {"scan.snapshot-id": str(sid)})
            assert got["port"] == got["jax"]
            rows = [r for _, _, rs in got["port"] for r in rs]
            assert rows and all(r[0] % 3 for r in rows)


# ---------------------------------------------------------------------------
# rollback
# ---------------------------------------------------------------------------


def _twins(table, root) -> dict:
    """Two copytree copies of `table`'s directory, one per package."""
    out = {}
    for pkg in PKGS:
        dst = os.path.join(root, f"twin_{pkg}")
        shutil.copytree(table.path, dst)
        out[pkg] = dst
    return out


@pytest.mark.parametrize("target", ["id", "tag", "expired tag"])
@pytest.mark.parametrize("writer", PKGS)
def test_rollback_matches_the_reference(tmp_path, writer, target):
    table = _create(writer, str(tmp_path), "db.rb", {"bucket": "2", **COMPACTING, "changelog-producer": "input"})
    _stream(table, _commits(5))
    table.create_tag("t2", 2)
    latest = table.store.snapshot_manager.latest_snapshot_id()
    at_t2 = _both(table.path, {"scan.tag-name": "t2"})["jax"]
    if target == "expired tag":
        # snapshot 2 gone from snapshot/ (as after an expiry that ran before
        # the tag protected it): rollback writes it back from the tag
        os.remove(f"{table.path}/snapshot/snapshot-2")
        os.remove(f"{table.path}/snapshot/snapshot-1")
        with open(f"{table.path}/snapshot/EARLIEST", "w") as f:
            f.write("3")
    twins = _twins(table, str(tmp_path))
    for pkg in PKGS:
        _open(pkg, twins[pkg]).rollback_to(2 if target == "id" else "t2")
    assert _disk(twins["port"]) == _disk(twins["jax"])
    assert len(_disk(twins["port"])) < len(_disk(table.path))
    for pkg in PKGS:
        assert _open(pkg, twins[pkg]).store.snapshot_manager.latest_snapshot_id() == 2 < latest
    reads = {pkg: _both(twins[pkg]) for pkg in PKGS}
    assert reads["port"]["port"] == reads["port"]["jax"] == reads["jax"]["port"] == reads["jax"]["jax"]
    assert reads["port"]["port"] == at_t2
    # the table is writable after the rollback
    for pkg in PKGS:
        _stream(_open(pkg, twins[pkg]), _commits(6, n=1), first_ident=100)
        got = _both(twins[pkg])
        assert got["port"] == got["jax"]


@pytest.mark.parametrize("writer", PKGS)
def test_rollback_keeps_a_later_tag(tmp_path, writer):
    """A tag of a snapshot newer than the target stays after a rollback in
    both packages; the files only it reached are deleted, so reading it
    fails in both."""
    table = _create(writer, str(tmp_path), "db.rbtag", {"bucket": "1", "write-only": "true"})
    _stream(table, _commits(5, n=4))
    table.create_tag("t4", 4)
    twins = _twins(table, str(tmp_path))
    for pkg in PKGS:
        _open(pkg, twins[pkg]).rollback_to(2)
    assert _disk(twins["port"]) == _disk(twins["jax"])
    for pkg in PKGS:
        assert _open(pkg, twins[pkg]).tags() == {"t4": 4}
        for reader in PKGS:
            with pytest.raises(FileNotFoundError):
                _read(_open(reader, twins[pkg], {**ENGINE[reader], "scan.tag-name": "t4"}))


# ---------------------------------------------------------------------------
# branches
# ---------------------------------------------------------------------------


_BM = {"jax": JaxBranchManager, "port": PortBranchManager}
_BT = {"jax": jax_branch_table, "port": port_branch_table}


def _branch_write(pkg, path, commits, first_ident, options=None):
    _stream(_open(pkg, path, {"branch": "b", **(options or {})}), commits, first_ident)


@pytest.mark.parametrize("creator,writer", [("jax", "port"), ("port", "jax"), ("port", "port")])
def test_branch_across_packages(tmp_path, creator, writer):
    """A branch created by one package from a tag, written by the other,
    read by both through branch_table and load_table; main unchanged."""
    table = _create(creator, str(tmp_path), "db.br", {"bucket": "2", **COMPACTING})
    _stream(table, _commits(8, n=4))
    table.create_tag("t2", 2)
    main_before = _both(table.path)
    bm = _BM[creator](table.file_io, table.path)
    bm.create("b", from_tag="t2")
    bm.create("e", from_snapshot=3)
    for pkg in PKGS:
        assert _BM[pkg](table.file_io, table.path).list_branches() == ["b", "e"]
        assert _BM[pkg](table.file_io, table.path).created_from("b") == 2
    at_tag = _both(table.path, {"scan.tag-name": "t2"})
    for pkg in PKGS:
        got = _plan_and_read(_BT[pkg](_open(pkg, table.path), "b").copy(ENGINE[pkg]))
        assert got == at_tag[pkg]
    _branch_write(writer, table.path, _commits(9, n=3), 50)
    via_load = _both(table.path, {"branch": "b"})
    assert via_load["port"] == via_load["jax"]
    for pkg in PKGS:
        view = _BT[pkg](_open(pkg, table.path), "b")
        assert _plan_and_read(view.copy(ENGINE[pkg])) == via_load["port"]
        # a copied view or another user's view keeps reading the main tree
        assert _read(view.copy(ENGINE[pkg]).with_user("other")) == _read(_open(pkg, table.path, {"branch": "b"}))
    assert _both(table.path) == main_before
    # the branch's data files lie in the main tree
    assert not any("bucket-" in d for d in os.listdir(PortBranchManager(None, table.path).branch_path("b")))


@pytest.mark.parametrize("writer", PKGS)
def test_fast_forward_matches_the_reference(tmp_path, writer):
    table = _create(writer, str(tmp_path), "db.ff", {"bucket": "1", **COMPACTING})
    _stream(table, _commits(10, n=3))
    _BM[writer](table.file_io, table.path).create("b", from_snapshot=2)
    _branch_write(writer, table.path, _commits(11, n=3), 20)
    twins = _twins(table, str(tmp_path))
    for pkg in PKGS:
        _BM[pkg](_open(pkg, twins[pkg]).file_io, twins[pkg]).fast_forward("b")
    assert _disk(twins["port"]) == _disk(twins["jax"])
    branch_rows = _both(table.path, {"branch": "b"})["jax"]
    for pkg in PKGS:
        got = _both(twins[pkg])
        assert got["port"] == got["jax"]
        assert [r for _, _, rows in got["port"] for r in rows] == [r for _, _, rows in branch_rows for r in rows]


def test_copy_with_a_branch_option_reads_main(tmp_path):
    """copy({"branch": x}) only merges the option in both packages: the
    view reads main (ROADMAP Queue 3)."""
    table = _create("port", str(tmp_path), "db.copy", {"bucket": "1"})
    _stream(table, _commits(12, n=2))
    PortBranchManager(table.file_io, table.path).create("b", from_snapshot=1)
    main = _both(table.path)
    for pkg in PKGS:
        view = _open(pkg, table.path).copy({**ENGINE[pkg], "branch": "b"})
        assert _plan_and_read(view) == main[pkg]
    assert _both(table.path, {"branch": "b"}) != main


@pytest.mark.parametrize("writer", PKGS)
def test_expiry_on_a_branch_deletes_no_data_file(tmp_path, writer):
    """Snapshot expiry on a branch view builds its data paths from the
    branch directory in both packages, so it deletes no data file; the
    branch's snapshots and manifests expire as on main."""
    table = _create(writer, str(tmp_path), "db.brexp", {"bucket": "1", **COMPACTING})
    _stream(table, _commits(13, n=2))
    _BM[writer](table.file_io, table.path).create("b", from_snapshot=2)
    twins = _twins(table, str(tmp_path))
    retention = {"snapshot.num-retained.min": "1", "snapshot.num-retained.max": "2"}
    written = {}
    for pkg in PKGS:
        _branch_write(pkg, twins[pkg], _commits(14, n=6), 30, retention)
        view = _open(pkg, twins[pkg], {"branch": "b"})
        sm = view.store.snapshot_manager
        assert sm.earliest_snapshot_id() > 3, "no branch snapshot expired"
        written[pkg] = (sm.earliest_snapshot_id(), sm.latest_snapshot_id(), sm.snapshot_count())
        data = [n for n in os.listdir(f"{twins[pkg]}/bucket-0") if n.startswith("data-")]
        ever = {f.file_name for sid in range(1, sm.latest_snapshot_id() + 1)
                for f in _delta_files(view, sid, twins[pkg])}
        assert ever <= set(data)
        written[pkg] += (len(data),)
    assert written["port"] == written["jax"]
    for pkg in PKGS:
        got = _both(twins[pkg], {"branch": "b"})
        assert got["port"] == got["jax"]


def _delta_files(view, sid, main_path):
    """The data files snapshot `sid` of the branch view added (its own, or
    main's copy for the snapshots before the branch)."""
    sm = view.store.snapshot_manager
    path = view.path if sm.snapshot_exists(sid) else main_path
    table = _open("port", path)
    if not table.store.snapshot_manager.snapshot_exists(sid):
        return []
    return [e.file for e in table.store.new_scan().with_snapshot(sid).with_kind("delta").plan().entries]


@pytest.mark.parametrize("deleter", PKGS)
def test_branch_delete(tmp_path, deleter):
    table = _create("port", str(tmp_path), "db.brdel", {"bucket": "1"})
    _stream(table, _commits(15, n=2))
    PortBranchManager(table.file_io, table.path).create("b")
    _BM[deleter](table.file_io, table.path).delete("b")
    for pkg in PKGS:
        assert _BM[pkg](table.file_io, table.path).list_branches() == []
        with pytest.raises(ValueError, match="does not exist"):
            _open(pkg, table.path, {"branch": "b"})


def test_load_table_auto_create(tmp_path):
    """auto-create=true with a row type creates a missing table in both
    packages: the keys from the options, the session options applied to the
    view and not persisted; without a row type there is no table."""
    options = {"auto-create": "true", "primary-key": "id", "bucket": "1", "scan.snapshot-id": "1",
               "consumer-id": "c"}
    for pkg in PKGS:
        path = str(tmp_path / pkg / "t")
        with pytest.raises(FileNotFoundError):
            _open(pkg, path, dict(options))
        m = jt if pkg == "jax" else tt
        row_type = m.RowType.of(("id", m.BIGINT(False)), ("v", m.DOUBLE()))
        if pkg == "jax":
            table = jax_load_table(path, dynamic_options=dict(options), row_type=row_type)
        else:
            table = port_load_table(path, dynamic_options=dict(options), row_type=row_type, device="cpu")
        assert list(table.schema.primary_keys) == ["id"]
        assert table.options.options.get(type(table.options).SCAN_SNAPSHOT_ID) == 1
        persisted = _open(pkg, path).schema.options
        assert persisted == {"bucket": "1"}
