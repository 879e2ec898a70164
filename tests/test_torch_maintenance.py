"""Commit-time maintenance in the port (paimon_tpu_torch) against the JAX
package, on the CPU (device="cpu" for the port).

Each case runs the same commits through both packages, on a clock both
share (now_millis is monkeypatched in every module that reads it, so no
case sleeps), and compares what each leaves on disk: the snapshot ids, the
EARLIEST hint, the tags, the consumer files, the changelog copies, the
number of data manifests, manifest lists and index manifests, the hash
index entries, and the data files, held by (partition, bucket, levels, row
count, min and max key) since file names are UUIDs. Both tables must also
pass the integrity checks: every file a retained snapshot or tag
references exists, and every data file on disk is referenced by one.

Covered: retention by snapshot.num-retained.max, by snapshot.time-retained
bounded by snapshot.num-retained.min, by snapshot.expire.limit and at the
default options, on write-only and compacting tables, streaming and batch;
tags and consumers written by either package; consumer.expiration-time;
async expiry; the decoupled changelog of a table the JAX package wrote
with changelog-producer=input; partition expiry and drop_partition on
fixed- and dynamic-bucket tables with a rewrite of the dropped partition;
manifest merging, which lets expiry delete data files; automatic tags;
commit and tag callbacks; forced snapshots; each package continuing the
other's expired table; and the best-effort contract (a failed delete is
counted, a failed maintenance step warns and the commit stands).

Compacting tables set compaction.max-size-amplification-percent=0, so that
every pick is a full compaction once the runs pass the trigger: the two
packages' Parquet encoders write files of other sizes, and a size-based
pick could then choose other runs in each.

Tolerance: exact. Ids, names, counts, keys and row values are compared
for equality.
"""

import collections
import datetime
import io
import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import paimon_tpu as jt
import paimon_tpu_torch as tt
from paimon_tpu.catalog import FileSystemCatalog as JaxCatalog
from paimon_tpu.fs import LocalFileIO as JaxIO
from paimon_tpu.table import consumer as jconsumer
from paimon_tpu.table import maintenance as jmaintenance
from paimon_tpu.table import tags as jtags
from paimon_tpu_torch.catalog import FileSystemCatalog as PortCatalog
from paimon_tpu_torch.core.indexmanifest import read_index_manifest
from paimon_tpu_torch.core.manifest import ManifestFile, ManifestList
from paimon_tpu_torch.core.snapshot import Snapshot
from paimon_tpu_torch.fs import LocalFileIO
from paimon_tpu_torch.table import consumer as pconsumer
from paimon_tpu_torch.table import maintenance as pmaintenance
from paimon_tpu_torch.table import tags as ptags

BASE = int(datetime.datetime(2026, 1, 10, 12, 30).timestamp() * 1000)
MINUTE = 60_000
HOUR = 60 * MINUTE
DAY = 24 * HOUR
COMPACTING = {"num-sorted-run.compaction-trigger": "2", "compaction.max-size-amplification-percent": "0"}
WRITE_ONLY = {"write-only": "true"}
ENGINE = {"jax": {"sort-engine": "numpy"}, "port": {"sort-engine": "pallas"}}
PKG = {"jax": jt, "port": tt}

JAX_CLOCKS = ["paimon_tpu.utils", "paimon_tpu.core.commit", "paimon_tpu.core.expire", "paimon_tpu.table.maintenance"]
PORT_CLOCKS = [
    "paimon_tpu_torch.core.commit",
    "paimon_tpu_torch.core.expire",
    "paimon_tpu_torch.table.tags",
    "paimon_tpu_torch.table.consumer",
    "paimon_tpu_torch.table.maintenance",
    "paimon_tpu_torch.table.write",
]


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


class Clock:
    def __init__(self):
        self.t = BASE

    def __call__(self) -> int:
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    for module in JAX_CLOCKS + PORT_CLOCKS:
        monkeypatch.setattr(f"{module}.now_millis", c)
    return c


@pytest.fixture
def warehouse(tmp_path):
    return str(tmp_path)


def _catalog(name, warehouse):
    if name == "jax":
        return JaxCatalog(warehouse, commit_user=name)
    return PortCatalog(warehouse, commit_user=name, device="cpu")


def _schema(pkg):
    return pkg.RowType.of(("id", pkg.BIGINT(False)), ("v", pkg.DOUBLE()), ("tag", pkg.STRING()))


def _part_schema(pkg):
    return pkg.RowType.of(("dt", pkg.STRING(False)), ("id", pkg.BIGINT(False)), ("v", pkg.BIGINT()))


def _rows(c, n=40):
    """Commit c's rows: ids overlapping the previous commit's by half."""
    ids = np.arange(n, dtype=np.int64) + c * (n // 2)
    return {"id": ids, "v": ids * 0.5 + c, "tag": np.array([f"t{c}"] * n, dtype=object)}


def _create(name, warehouse, ident, options, partitioned=False):
    pkg = PKG[name]
    opts = {**options, **ENGINE[name]}
    if partitioned:
        return _catalog(name, warehouse).create_table(
            f"{ident}_{name}", _part_schema(pkg), partition_keys=["dt"], primary_keys=["dt", "id"], options=opts)
    return _catalog(name, warehouse).create_table(f"{ident}_{name}", _schema(pkg), primary_keys=["id"], options=opts)


def _open(name, warehouse, ident):
    return _catalog(name, warehouse).get_table(ident)


def _commit_all(table, batches, mode, clock, step, first_identifier=1, after=None):
    """One commit per batch (stream: one write and ascending identifiers;
    batch: a builder per commit), the clock advanced by `step` before
    each; after(i, table) runs after commit i."""
    if mode == "stream":
        wb = table.new_stream_write_builder()
        w, c = wb.new_write(), wb.new_commit()
    for i, batch in enumerate(batches):
        clock.t += step
        if mode == "stream":
            w.write(batch)
            c.commit_messages(first_identifier + i, w.prepare_commit())
        else:
            wb = table.new_batch_write_builder()
            bw = wb.new_write()
            bw.write(batch)
            wb.new_commit().commit(bw.prepare_commit())
        if after is not None:
            after(i, table)


def _py(v):
    return v.item() if hasattr(v, "item") else v


def _read(table) -> list[tuple]:
    rb = table.new_read_builder()
    return [tuple(_py(v) for v in row) for row in rb.new_read().read_all(rb.new_scan().plan()).to_pylist()]


def _oracle(batches, key=("id",)) -> list[tuple]:
    names = list(batches[0])
    last = {}
    for batch in batches:
        cols = [batch[n].tolist() if hasattr(batch[n], "tolist") else list(batch[n]) for n in names]
        for row in zip(*cols):
            last[tuple(row[names.index(k)] for k in key)] = row
    return [last[k] for k in sorted(last)]


# ---------------------------------------------------------------------------
# what a table leaves on disk
# ---------------------------------------------------------------------------

_IO = LocalFileIO()


def _listing(d, prefix):
    return sorted(n for n in os.listdir(d) if n.startswith(prefix)) if os.path.isdir(d) else []


def _snapshot_ids(path):
    return sorted(int(n[len("snapshot-"):]) for n in _listing(f"{path}/snapshot", "snapshot-"))


def _retained_roots(path):
    """(snapshot, its manifest lists that keep files alive) of the retained
    snapshots and tags, and of the changelog copies, which keep only their
    changelog list."""
    roots = []
    for d, prefix in (("snapshot", "snapshot-"), ("tag", "tag-")):
        for n in _listing(f"{path}/{d}", prefix):
            snap = Snapshot.from_json(_IO.read_bytes(f"{path}/{d}/{n}"))
            roots.append((snap, (snap.base_manifest_list, snap.delta_manifest_list, snap.changelog_manifest_list)))
    for n in _listing(f"{path}/changelog", "changelog-"):
        snap = Snapshot.from_json(_IO.read_bytes(f"{path}/changelog/{n}"))
        roots.append((snap, (snap.changelog_manifest_list,)))
    return roots


def _referenced(path):
    """(manifest names, {data file name: [entries]}) that the retained
    snapshots, tags and changelog copies reach; FileNotFoundError when one
    of their manifests is missing."""
    ml, mf = ManifestList(_IO, f"{path}/manifest"), ManifestFile(_IO, f"{path}/manifest")
    manifests, files = set(), collections.defaultdict(list)
    for snap, lists in _retained_roots(path):
        for lst in lists:
            if not lst:
                continue
            manifests.add(lst)
            for meta in ml.read(lst):
                manifests.add(meta.file_name)
                for e in mf.read(meta.file_name):
                    files[e.file.file_name].append(e)
        if snap.index_manifest and len(lists) > 1:
            manifests.add(snap.index_manifest)
            for e in read_index_manifest(_IO, path, snap.index_manifest):
                assert os.path.exists(f"{path}/index/{e.file_name}"), e.file_name
    return manifests, files


def _data_files(path):
    """(bucket directory relative to the table, file name) of every data
    or changelog file on disk."""
    out = []
    for root, _, names in os.walk(path):
        if os.path.basename(root).startswith("bucket-"):
            out += [(os.path.relpath(root, path), n) for n in names if not n.startswith(".")]
    return sorted(out)


def _check_integrity(path):
    """Every file a retained snapshot, tag or changelog copy references is
    on disk, and every data file on disk is referenced by one of them."""
    manifests, files = _referenced(path)
    on_disk = {n for _, n in _data_files(path)}
    missing = sorted(n for n in files if n not in on_disk)
    assert not missing, f"referenced data files missing: {missing}"
    orphans = sorted(n for n in on_disk if n not in files)
    assert not orphans, f"data files no retained snapshot references: {orphans}"
    assert all(os.path.exists(f"{path}/manifest/{m}") for m in manifests)


def _view(path) -> dict:
    """What a table leaves on disk, free of file names."""
    _check_integrity(path)
    _, files = _referenced(path)
    data = collections.Counter()
    for rel, name in _data_files(path):
        es = files[name]
        f = es[0].file
        data[(rel, name.split("-")[0], tuple(sorted({e.file.level for e in es})), f.row_count, tuple(f.min_key),
              tuple(f.max_key))] += 1
    manifest_kinds = collections.Counter(
        "list" if n.startswith("manifest-list-") else "index" if n.startswith("index-manifest-") else "data"
        for n in _listing(f"{path}/manifest", "") if not n.startswith(".")
    )
    ids = _snapshot_ids(path)
    latest = Snapshot.from_json(_IO.read_bytes(f"{path}/snapshot/snapshot-{ids[-1]}")) if ids else None
    index = sorted((tuple(e.partition), e.bucket, e.kind, e.row_count)
                   for e in read_index_manifest(_IO, path, latest.index_manifest)) if latest and latest.index_manifest else []
    earliest = f"{path}/snapshot/EARLIEST"
    return {
        "snapshots": ids,
        "kinds": [Snapshot.from_json(_IO.read_bytes(f"{path}/snapshot/snapshot-{i}")).commit_kind.value for i in ids],
        "earliest": int(_IO.read_text(earliest)) if os.path.exists(earliest) else None,
        "tags": {n[len("tag-"):]: Snapshot.from_json(_IO.read_bytes(f"{path}/tag/{n}")).id
                 for n in _listing(f"{path}/tag", "tag-")},
        "consumers": {n: json.loads(_IO.read_bytes(f"{path}/consumer/{n}"))
                      for n in _listing(f"{path}/consumer", "consumer-")},
        "changelogs": _listing(f"{path}/changelog", "changelog-"),
        "manifests": dict(manifest_kinds),
        "index": index,
        "index_files": len(_listing(f"{path}/index", "")),
        "data": dict(data),
        "bucket_dirs": sorted({rel for rel, _ in _data_files(path)} | {
            os.path.relpath(r, path) for r, _, _ in os.walk(path) if os.path.basename(r).startswith("bucket-")}),
    }


def _assert_same_disk(jax_table, port_table):
    jv, pv = _view(jax_table.path), _view(port_table.path)
    assert pv == jv
    return pv


# ---------------------------------------------------------------------------
# retention
# ---------------------------------------------------------------------------

RETENTION = {
    "max-write-only-stream": ({**WRITE_ONLY, "snapshot.num-retained.max": "3"}, "stream", 8, MINUTE),
    "max-write-only-batch": ({**WRITE_ONLY, "snapshot.num-retained.max": "3"}, "batch", 8, MINUTE),
    "max-compacting-stream": ({**COMPACTING, "snapshot.num-retained.max": "4"}, "stream", 8, MINUTE),
    "max-compacting-batch": ({**COMPACTING, "snapshot.num-retained.max": "4"}, "batch", 8, MINUTE),
    "time-with-min-write-only-stream": (
        {**WRITE_ONLY, "snapshot.time-retained": "1 h", "snapshot.num-retained.min": "2"}, "stream", 8, 25 * MINUTE),
    "time-with-min-compacting-batch": (
        {**COMPACTING, "snapshot.time-retained": "1 h", "snapshot.num-retained.min": "3"}, "batch", 8, 25 * MINUTE),
    "time-held-by-min-compacting-stream": (
        {**COMPACTING, "snapshot.time-retained": "1 ms", "snapshot.num-retained.min": "5"}, "stream", 8, MINUTE),
    "defaults-write-only-stream": (dict(WRITE_ONLY), "stream", 14, 10 * MINUTE),
    "defaults-compacting-stream": (dict(COMPACTING), "stream", 12, 10 * MINUTE),
    "limit-write-only-stream": (
        {**WRITE_ONLY, "snapshot.num-retained.max": "1", "snapshot.expire.limit": "1"}, "stream", 6, MINUTE),
}


@pytest.mark.parametrize("case", list(RETENTION))
def test_retention_matches_the_reference(warehouse, clock, case):
    """The same commits under each retention option leave the same
    snapshots, EARLIEST hint, manifests and data files in both packages,
    and the port reads the oracle."""
    options, mode, commits, step = RETENTION[case]
    batches = [_rows(c) for c in range(commits)]
    tables = {}
    for name in ("jax", "port"):
        clock.t = BASE
        tables[name] = _create(name, warehouse, "db.retention", options)
        _commit_all(tables[name], batches, mode, clock, step)
    view = _assert_same_disk(tables["jax"], tables["port"])
    assert view["earliest"] == view["snapshots"][0]
    assert len(view["snapshots"]) < commits or case.startswith("time-held")
    assert _read(tables["port"]) == _read(tables["jax"]) == _oracle(batches)


def test_expire_limit_bounds_one_run(warehouse, clock):
    """snapshot.expire.limit caps what one expire_snapshots() call removes:
    2 of the 5 expirable snapshots, then 2 more, then the last."""
    batches = [_rows(c) for c in range(6)]
    tables = {}
    for name in ("jax", "port"):
        clock.t = BASE
        tables[name] = _create(name, warehouse, "db.limit", WRITE_ONLY)
        _commit_all(tables[name], batches, "stream", clock, MINUTE)
    counts = {"jax": [], "port": []}
    for _ in range(3):
        for name, table in tables.items():
            counts[name].append(table.copy({"snapshot.num-retained.max": "1", "snapshot.expire.limit": "2"})
                                .expire_snapshots())
        assert _view(tables["port"].path) == _view(tables["jax"].path)
    assert counts["port"] == counts["jax"] == [2, 2, 1]


# ---------------------------------------------------------------------------
# tags and consumers
# ---------------------------------------------------------------------------


def _tag_and_pin(maker, table, tag_snapshot, consumer_next):
    """A tag on `tag_snapshot` and a consumer at `consumer_next`, written
    through `maker`'s own TagManager and ConsumerManager."""
    if maker == "jax":
        jtags.TagManager(JaxIO(), table.path).create("keep", tag_snapshot)
        jconsumer.ConsumerManager(JaxIO(), table.path).record("reader", consumer_next)
    else:
        ptags.TagManager(LocalFileIO(), table.path).create("keep", tag_snapshot)
        pconsumer.ConsumerManager(LocalFileIO(), table.path).record("reader", consumer_next)


@pytest.mark.parametrize("maker", ["jax", "port"])
@pytest.mark.parametrize("kind", ["write-only", "compacting"])
def test_tags_and_consumers_protect_their_snapshots(warehouse, clock, maker, kind):
    """A tag on snapshot 2 and a consumer at snapshot 5, made by either
    package after the fifth commit, keep those snapshots (and the consumer's
    run to the latest) and their files through later expiry in both."""
    options = {**(WRITE_ONLY if kind == "write-only" else COMPACTING), "snapshot.num-retained.max": "2"}
    batches = [_rows(c) for c in range(10)]
    tables = {}
    for name in ("jax", "port"):
        clock.t = BASE
        tables[name] = _create(name, warehouse, f"db.protect_{maker}_{kind.replace('-', '_')}",
                               {k: v for k, v in options.items() if k != "snapshot.num-retained.max"})

        def after(i, table):
            if i == 4:
                _tag_and_pin(maker, table, 2, 5)

        _commit_all(tables[name], batches[:5], "stream", clock, MINUTE, after=after)
        tables[name] = tables[name].copy({"snapshot.num-retained.max": "2"})
        _commit_all(tables[name], batches[5:], "stream", clock, MINUTE, first_identifier=6)
    view = _assert_same_disk(tables["jax"], tables["port"])
    assert view["tags"] == {"keep": 2}
    assert view["consumers"] == {"consumer-reader": {"nextSnapshot": 5}}
    assert 2 in view["snapshots"] and all(i in view["snapshots"] for i in range(5, view["snapshots"][-1] + 1))
    assert 1 not in view["snapshots"] and view["earliest"] == 2
    # the pinned and tagged snapshots' files are all there
    assert _read(tables["port"]) == _oracle(batches)
    # once released, the next commit expires them in both
    for name in ("jax", "port"):
        mod = (jtags, jconsumer) if name == "jax" else (ptags, pconsumer)
        io_ = JaxIO() if name == "jax" else LocalFileIO()
        mod[0].TagManager(io_, tables[name].path).delete("keep")
        mod[1].ConsumerManager(io_, tables[name].path).delete("reader")
        _commit_all(tables[name], [_rows(10)], "stream", clock, MINUTE, first_identifier=11)
    view = _assert_same_disk(tables["jax"], tables["port"])
    assert 2 not in view["snapshots"] and len(view["snapshots"]) <= 3


def test_consumer_expiration_time_releases_stale_consumers(warehouse, clock):
    """consumer.expiration-time: a consumer whose file was last written
    over 1 h ago is deleted before expiry and pins nothing; a fresh one
    keeps pinning. By the file's mtime in both packages."""
    options = {**WRITE_ONLY, "snapshot.num-retained.max": "2", "consumer.expiration-time": "1 h"}
    batches = [_rows(c) for c in range(8)]
    tables = {}
    for name in ("jax", "port"):
        clock.t = BASE
        table = _create(name, warehouse, "db.consumer_ttl", WRITE_ONLY)
        _commit_all(table, batches[:4], "stream", clock, MINUTE)
        cm = (jconsumer.ConsumerManager(JaxIO(), table.path) if name == "jax"
              else pconsumer.ConsumerManager(LocalFileIO(), table.path))
        cm.record("stale", 1)
        cm.record("fresh", 3)
        os.utime(f"{table.path}/consumer/consumer-stale", ((clock.t - 2 * HOUR) / 1000,) * 2)
        os.utime(f"{table.path}/consumer/consumer-fresh", ((clock.t - 10 * MINUTE) / 1000,) * 2)
        tables[name] = table.copy(options)
        _commit_all(tables[name], batches[4:], "stream", clock, MINUTE, first_identifier=5)
    view = _assert_same_disk(tables["jax"], tables["port"])
    assert list(view["consumers"]) == ["consumer-fresh"]
    assert view["snapshots"][0] == 3


@pytest.mark.parametrize("port_join", ["each_commit", "once"])
def test_async_expiry_matches_the_reference(warehouse, clock, port_join):
    """snapshot.expire.execution-mode=async: each commit hands expiry to a
    background thread. The JAX package's runs are joined after every
    commit; the port's are joined likewise (each_commit) or only after the
    last commit (once), so that its runs overlap the commits that follow.
    Both leave the synchronous result."""
    options = {**COMPACTING, "snapshot.num-retained.max": "3", "snapshot.expire.execution-mode": "async"}
    batches = [_rows(c) for c in range(8)]
    tables = {}
    for name in ("jax", "port"):
        clock.t = BASE
        tables[name] = _create(name, warehouse, "db.async", options)

        def join(i, table, name=name):
            (table._expire_future if name == "jax" else table.expire_future).result()

        each = name == "jax" or port_join == "each_commit"
        _commit_all(tables[name], batches, "stream", clock, MINUTE, after=join if each else None)
    tables["port"].expire_future.result()
    view = _assert_same_disk(tables["jax"], tables["port"])
    assert len(view["snapshots"]) == 3
    assert tables["port"].expire_future.done() and tables["port"].expire_future.exception() is None


def test_decoupled_changelog_expired_by_the_port(warehouse, clock):
    """A write-only table the JAX package wrote with
    changelog-producer=input (one changelog file per commit): expired once
    by each package under snapshot.num-retained.max=2 and
    changelog.num-retained.max=3, it keeps changelog copies of the last 3
    expired snapshots with their changelog files, in both."""
    options = {**WRITE_ONLY, "changelog-producer": "input"}
    batches = [_rows(c) for c in range(7)]
    paths = {}
    for who in ("jax", "port"):
        clock.t = BASE
        table = _create("jax", warehouse, f"db.changelog_{who}", options)
        _commit_all(table, batches, "stream", clock, MINUTE)
        paths[who] = table.path
        expiring = {"snapshot.num-retained.max": "2", "changelog.num-retained.max": "3"}
        opened = _open(who, warehouse, f"db.changelog_{who}_jax")
        assert opened.copy(expiring).expire_snapshots() == 5
    jv, pv = _view(paths["jax"]), _view(paths["port"])
    assert pv == jv
    assert pv["changelogs"] == ["changelog-3", "changelog-4", "changelog-5"]
    assert pv["snapshots"] == [6, 7]
    assert sum(n for k, n in pv["data"].items() if k[1] == "changelog") == 5  # 3 copies + 2 snapshots
    assert _read(_open("port", warehouse, "db.changelog_port_jax")) == _oracle(batches)


# ---------------------------------------------------------------------------
# partitions
# ---------------------------------------------------------------------------


def _day(offset_days):
    return datetime.datetime.fromtimestamp((BASE - offset_days * DAY) / 1000).strftime("%Y-%m-%d")


def _part_rows(days, ids, v):
    ids = np.asarray(ids, dtype=np.int64)
    return {"dt": np.array([_day(d) for d in days], dtype=object), "id": ids, "v": ids * 10 + v}


@pytest.mark.parametrize("bucket", ["2", "-1"], ids=["fixed", "dynamic"])
def test_partition_expiry_and_drop_match_the_reference(warehouse, clock, bucket):
    """Four daily partitions (0-3 days old) under partition.expiration-time
    = 2 d: the commit drops the 2 oldest in one OVERWRITE snapshot;
    drop_partition drops one more; the hash index keeps the dropped
    partitions' entries; rewriting a dropped partition puts its keys in the
    same buckets in both packages."""
    options = {"bucket": bucket, "partition.expiration-time": "2 d", "partition.expiration-check-interval": "0 ms",
               "dynamic-bucket.target-row-num": "30"}
    first = _part_rows([d for d in range(4) for _ in range(60)], list(range(60)) * 4, 0)
    tables, dropped, expired = {}, {}, {}
    for name in ("jax", "port"):
        clock.t = BASE
        table = _create(name, warehouse, f"db.parts_{bucket.replace('-', 'm')}", options, partitioned=True)
        _commit_all(table, [first], "batch", clock, 0)
        expired[name] = table.store.snapshot_manager.latest_snapshot().commit_kind.value
        drop = jmaintenance.drop_partition if name == "jax" else pmaintenance.drop_partition
        dropped[name] = drop(table, {"dt": _day(1)})
        tables[name] = table
    assert expired["jax"] == expired["port"] == "OVERWRITE"
    assert dropped["jax"] == dropped["port"] == [(_day(1),)]
    view = _assert_same_disk(tables["jax"], tables["port"])
    assert view["kinds"] == ["APPEND", "OVERWRITE", "OVERWRITE"]
    want = [r for r in _oracle([first], key=("dt", "id")) if r[0] == _day(0)]
    assert _read(tables["port"]) == _read(tables["jax"])
    assert sorted(_read(tables["port"])) == want
    # the dropped partition written again, with more keys than before
    again = _part_rows([1] * 90, range(90), 1)
    for name in ("jax", "port"):
        _commit_all(tables[name], [again], "batch", clock, MINUTE)
    view = _assert_same_disk(tables["jax"], tables["port"])
    assert _read(tables["port"]) == _read(tables["jax"])
    assert sorted(_read(tables["port"])) == sorted(want + _oracle([again], key=("dt", "id")))
    if bucket == "-1":
        assert {e[0] for e in view["index"]} == {(_day(d),) for d in range(4)}


def test_partition_expiry_honours_the_check_interval_and_patterns(warehouse, clock):
    """partition.timestamp-pattern picks the column and
    partition.timestamp-formatter parses it; a sweep runs at most once per
    partition.expiration-check-interval, kept on the store."""
    options = {**WRITE_ONLY, "bucket": "1", "partition.expiration-time": "1 d",
               "partition.expiration-check-interval": "1 h", "partition.timestamp-pattern": "$dt",
               "partition.timestamp-formatter": "%Y%m%d"}
    days = [datetime.datetime.fromtimestamp((BASE - d * DAY) / 1000).strftime("%Y%m%d") for d in range(4)]

    def rows(d, c):
        return {"dt": np.array([days[d]] * 3, dtype=object), "id": np.arange(3) + c, "v": np.arange(3) + c}

    tables = {}
    for name in ("jax", "port"):
        clock.t = BASE
        table = _create(name, warehouse, "db.parts_interval", options, partitioned=True)
        # first commit sweeps (nothing old yet); the second lands 10 min
        # later with an old partition and is not swept; the third, 2 h
        # later, sweeps
        _commit_all(table, [rows(0, 0)], "batch", clock, 0)
        _commit_all(table, [rows(3, 1)], "batch", clock, 10 * MINUTE)
        assert len(_read(table)) == 6
        _commit_all(table, [rows(0, 2)], "batch", clock, 2 * HOUR)
        tables[name] = table
    view = _assert_same_disk(tables["jax"], tables["port"])
    assert view["kinds"] == ["APPEND", "APPEND", "APPEND", "OVERWRITE"]
    assert _read(tables["port"]) == _read(tables["jax"])
    assert {r[0] for r in _read(tables["port"])} == {days[0]}


def test_manifest_merging_lets_expiry_delete_dropped_files(warehouse, clock):
    """Only a merge of the base manifests resolves a file's ADD against its
    DELETE: with manifest.full-compaction-threshold-size=1 b a commit
    merges all of them once there are more than 2, so the second commit
    after a drop_partition merges, and expiry deletes the dropped
    partition's files and, with snapshot.expire.clean-empty-directories,
    its directories, in both packages; the retained snapshot references no
    missing file."""
    options = {"bucket": "-1", "snapshot.num-retained.max": "1", "manifest.full-compaction-threshold-size": "1 b",
               "snapshot.expire.clean-empty-directories": "true"}
    first = _part_rows([d for d in range(3) for _ in range(20)], list(range(20)) * 3, 0)
    tables = {}
    for name in ("jax", "port"):
        clock.t = BASE
        table = _create(name, warehouse, "db.merge_drop", options, partitioned=True)
        _commit_all(table, [first], "batch", clock, 0)
        (jmaintenance if name == "jax" else pmaintenance).drop_partition(table, {"dt": _day(2)})
        _commit_all(table, [_part_rows([0] * 5, range(5), 3)], "batch", clock, MINUTE)
        assert os.path.isdir(os.path.join(table.path, f"dt={_day(2)}"))
        _commit_all(table, [_part_rows([1] * 5, range(5), 4)], "batch", clock, MINUTE)
        tables[name] = table
    view = _assert_same_disk(tables["jax"], tables["port"])
    assert not any(d.startswith(f"dt={_day(2)}") for d in view["bucket_dirs"])
    assert not os.path.exists(os.path.join(tables["port"].path, f"dt={_day(2)}"))
    assert view["snapshots"] == [4]


def test_manifest_merging_at_the_count_threshold(warehouse, clock):
    """manifest.merge-min-count (default 30): past 30 base manifests both
    packages merge the small ones (deletes kept), leaving the same
    manifests and files."""
    options = {**COMPACTING, "snapshot.num-retained.max": "3"}
    batches = [_rows(c, 8) for c in range(24)]
    tables = {}
    for name in ("jax", "port"):
        clock.t = BASE
        tables[name] = _create(name, warehouse, "db.merge_count", options)
        _commit_all(tables[name], batches, "stream", clock, MINUTE)
    view = _assert_same_disk(tables["jax"], tables["port"])
    assert view["snapshots"][-1] > 31
    assert _read(tables["port"]) == _oracle(batches)


# ---------------------------------------------------------------------------
# automatic tags, callbacks and forced snapshots
# ---------------------------------------------------------------------------

TAG_CASES = {
    "daily-with-dashes": ({"tag.creation-period": "daily"}, 9 * HOUR),
    "daily-without-dashes-retained-2": (
        {"tag.creation-period": "daily", "tag.period-formatter": "without_dashes", "tag.num-retained-max": "2"},
        9 * HOUR),
    "hourly-with-dashes-retained-3": ({"tag.creation-period": "hourly", "tag.num-retained-max": "3"}, 50 * MINUTE),
    "hourly-without-dashes-delay": (
        {"tag.creation-period": "hourly", "tag.period-formatter": "without_dashes", "tag.creation-delay": "30 min"},
        70 * MINUTE),
    "daily-time-retained": ({"tag.creation-period": "daily", "tag.default-time-retained": "1 d"}, 9 * HOUR),
}


@pytest.mark.parametrize("case", list(TAG_CASES))
def test_automatic_tags_match_the_reference(warehouse, clock, case):
    """tag.automatic-creation=process-time: the same tag names on the same
    snapshots in both packages after 8 commits spread by `step`, with only
    automatic tags pruned (a user tag stays)."""
    extra, step = TAG_CASES[case]
    options = {**WRITE_ONLY, "tag.automatic-creation": "process-time", **extra}
    batches = [_rows(c, 4) for c in range(8)]
    tags = {}
    for name in ("jax", "port"):
        clock.t = BASE
        table = _create(name, warehouse, f"db.autotag_{case.replace('-', '_')}", options)

        def after(i, table):
            if i == 0:
                table.create_tag("user-tag", 1)

        _commit_all(table, batches, "stream", clock, step, after=after)
        tags[name] = table.tags()
        assert _view(table.path)["tags"] == tags[name]
    assert tags["port"] == tags["jax"]
    assert "user-tag" in tags["port"] and len(tags["port"]) > 1


def test_watermark_tags_match_the_reference(warehouse, clock):
    """tag.automatic-creation=watermark: the tag follows the watermark that
    commit_messages carries, not the clock; no watermark, no tag."""
    options = {**WRITE_ONLY, "tag.automatic-creation": "watermark", "tag.creation-period": "hourly"}
    marks = [None, BASE - 5 * HOUR, BASE - 3 * HOUR, BASE - 3 * HOUR + MINUTE, BASE + HOUR]
    tags = {}
    for name in ("jax", "port"):
        clock.t = BASE
        table = _create(name, warehouse, "db.watermark_tags", options)
        wb = table.new_stream_write_builder()
        w, c = wb.new_write(), wb.new_commit()
        for i, mark in enumerate(marks):
            w.write(_rows(i, 4))
            c.commit_messages(i + 1, w.prepare_commit(), watermark=mark)
        tags[name] = table.tags()
    assert tags["port"] == tags["jax"]
    assert sorted(tags["port"].values()) == [2, 3, 5]


CALLS = []


def commit_first(table, snapshot):
    CALLS.append(("first", snapshot.id, snapshot.commit_kind.value))


def commit_second(table, snapshot):
    CALLS.append(("second", snapshot.id, table.path.endswith("_jax") or table.path.endswith("_port")))


def tag_made(table, name, snapshot):
    CALLS.append(("tag", name, snapshot.id))


def test_callbacks_run_in_order_with_the_reference_arguments(warehouse, clock):
    """commit.callbacks run after each commit, in the option's order, with
    (table, latest snapshot); tag.callbacks run once per automatic tag with
    (table, tag name, snapshot); a COMPACT commit passes its own snapshot."""
    options = {**COMPACTING, "commit.callbacks": f"{__name__}:commit_first,{__name__}:commit_second",
               "tag.automatic-creation": "process-time", "tag.callbacks": f"{__name__}:tag_made"}
    calls = {}
    for name in ("jax", "port"):
        clock.t = BASE
        CALLS.clear()
        table = _create(name, warehouse, "db.callbacks", options)
        _commit_all(table, [_rows(c, 4) for c in range(4)], "stream", clock, 12 * HOUR)
        calls[name] = list(CALLS)
    assert calls["port"] == calls["jax"]
    assert [c[1] for c in calls["port"] if c[0] == "first"] == [1, 2, 4, 5]
    assert sum(c[0] == "tag" for c in calls["port"]) == 2


def test_force_create_snapshot_on_an_empty_batch_commit(warehouse, clock):
    """commit.force-create-snapshot: an empty batch commit writes an APPEND
    snapshot in both packages; without it, none."""
    for force in ("true", "false"):
        views = {}
        for name in ("jax", "port"):
            clock.t = BASE
            table = _create(name, warehouse, f"db.force_{force}", {**WRITE_ONLY,
                                                                   "commit.force-create-snapshot": force})
            _commit_all(table, [_rows(0, 4)], "batch", clock, MINUTE)
            wb = table.new_batch_write_builder()
            wb.new_commit().commit(wb.new_write().prepare_commit())
            views[name] = _view(table.path)
        assert views["port"] == views["jax"]
        assert views["port"]["snapshots"] == ([1, 2] if force == "true" else [1])


# ---------------------------------------------------------------------------
# each package continues the other's expired table; best effort
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("first, second", [("jax", "port"), ("port", "jax")])
def test_each_package_continues_the_others_expired_table(warehouse, clock, first, second):
    """`first` writes 6 commits with expiry and a tag; `second` opens the
    table, writes 6 more and expires on; a table written by `second`
    alone over the same commits ends with the same disk and rows."""
    options = {**COMPACTING, "snapshot.num-retained.max": "3"}
    batches = [_rows(c) for c in range(12)]
    clock.t = BASE
    table = _create(first, warehouse, f"db.continue_{first}", options)

    def tag(i, t):
        if i == 1:
            t.create_tag("early", 2)

    _commit_all(table, batches[:6], "stream", clock, MINUTE, after=tag)
    other = _open(second, warehouse, f"db.continue_{first}_{first}")
    _commit_all(other, batches[6:], "stream", clock, MINUTE, first_identifier=7)
    clock.t = BASE
    alone = _create(second, warehouse, f"db.continue_alone_{first}", options)
    _commit_all(alone, batches, "stream", clock, MINUTE, after=tag)
    assert _view(other.path) == _view(alone.path)
    assert _read(other) == _read(_open(first, warehouse, f"db.continue_{first}_{first}")) == _oracle(batches)


def test_a_failed_delete_is_counted_and_expiry_goes_on(warehouse, clock, monkeypatch):
    """Deletion is best effort: a data file whose delete fails is counted
    in cleanup_failures, and the rest of the run completes."""
    options = {"bucket": "1", "manifest.full-compaction-threshold-size": "1 b", **COMPACTING}
    clock.t = BASE
    table = _create("port", warehouse, "db.failed_delete", options)
    _commit_all(table, [_rows(c) for c in range(6)], "stream", clock, MINUTE)
    expire = table.copy({"snapshot.num-retained.max": "1"}).store.new_expire()
    real = expire.file_io.delete
    failed = []

    def delete(path):
        if path.endswith(".parquet") and not failed:
            failed.append(path)
            raise PermissionError(path)
        return real(path)

    monkeypatch.setattr(expire.file_io, "delete", delete)
    assert expire.expire() > 0
    assert expire.cleanup_failures == 1 and os.path.exists(failed[0])
    assert _snapshot_ids(table.path) == [_snapshot_ids(table.path)[-1]]


def boom(table, snapshot):
    raise RuntimeError("callback boom")


def test_a_failed_maintenance_step_warns_and_the_commit_stands(warehouse, clock, monkeypatch):
    """The JAX package swallows maintenance errors so that a commit never
    fails; the port keeps that and warns, naming the exception."""
    table = _create("port", warehouse, "db.warns", {**WRITE_ONLY, "commit.callbacks": f"{__name__}:boom"})
    with pytest.warns(RuntimeWarning, match="callback boom"):
        _commit_all(table, [_rows(0, 4)], "stream", clock, MINUTE)

    def broken():
        raise OSError("expiry boom")

    table = table.copy({"commit.callbacks": ""})
    monkeypatch.setattr(table, "expire_snapshots", broken)
    with pytest.warns(RuntimeWarning, match="expiry boom"):
        _commit_all(table, [_rows(1, 4)], "stream", clock, MINUTE, first_identifier=2)
    assert _snapshot_ids(table.path) == [1, 2]
