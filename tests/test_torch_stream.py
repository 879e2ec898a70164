"""The streaming reader of the port (paimon_tpu_torch/table/stream.py and
table/enumerator.py) against the JAX package's, on the CPU
(device="cpu" for the port).

- Every startup mode under every changelog producer (none, input, lookup,
  full-compaction), on tables either package writes (bucket 2, COMPACT
  snapshots between the commits): both packages' scans plan after each
  commit until nothing is new; each plan must give the same splits
  (partition, bucket, file names, snapshot id, raw_convertible,
  is_changelog, deletion-vector container) and the same rows and kinds.
- checkpoint/restore, both consumer modes (the same consumer positions
  after every plan, and a new scan resuming from them),
  consumer.ignore-progress, scan.bounded.watermark on the first and later
  plans, streaming-read-overwrite, stream-scan-mode=file-monitor, the
  expired-snapshot changelog fallback, deletion vectors in the starting
  plan, current_watermark, plan_aligned, and the option errors.
- SplitEnumerator and AlignedSplitEnumerator: the same splits for each
  reader; checkpoints restored across packages.
- DataSplit.to_dict read by the other package's from_dict.

Tests that wait poll every 20-50 ms with timeouts under 2 s, and join
their writer thread with a bound.

Tolerance: exact.
"""

import io
import json
import os
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
from paimon_tpu.table import load_table as jax_load_table
from paimon_tpu.table.consumer import ConsumerManager as JaxConsumers
from paimon_tpu.table.enumerator import AlignedSplitEnumerator as JaxAligned
from paimon_tpu.table.enumerator import SplitEnumerator as JaxEnumerator
from paimon_tpu.table.read import DataSplit as JaxSplit
from paimon_tpu.types import RowKind as JaxRowKind
from paimon_tpu_torch.catalog import FileSystemCatalog as PortCatalog
from paimon_tpu_torch.data import predicate as tp
from paimon_tpu_torch.table import load_table as port_load_table
from paimon_tpu_torch.table.consumer import ConsumerManager as PortConsumers
from paimon_tpu_torch.table.enumerator import AlignedSplitEnumerator as PortAligned
from paimon_tpu_torch.table.enumerator import SplitEnumerator as PortEnumerator
from paimon_tpu_torch.table.read import DataSplit as PortSplit

PKGS = ("jax", "port")
ENGINE = {"jax": {"sort-engine": "numpy"}, "port": {"sort-engine": "pallas"}}
COMPACTING = {"bucket": "2", "num-sorted-run.compaction-trigger": "3",
              "compaction.max-size-amplification-percent": "0"}
PRODUCERS = ("none", "input", "lookup", "full-compaction")
MODES = {
    "default": {},
    "latest-full": {"scan.mode": "latest-full"},
    "full": {"scan.mode": "full"},
    "latest": {"scan.mode": "latest"},
    "from-snapshot": {"scan.mode": "from-snapshot", "scan.snapshot-id": "2"},
    "default-with-snapshot-id": {"scan.snapshot-id": "2"},
    "from-snapshot-full": {"scan.mode": "from-snapshot-full", "scan.snapshot-id": "2"},
    "from-timestamp": {"scan.mode": "from-timestamp"},
    "compacted-full": {"scan.mode": "compacted-full"},
}
KINDS = ("+I", "-U", "+U", "-D")
IDS = 50


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


@pytest.fixture(autouse=True)
def _plain_download(monkeypatch):
    # the JAX package's plain index download, which the port mirrors
    monkeypatch.setenv("PAIMON_TPU_FORCE_COMPACT", "0")


def _create(pkg, warehouse, ident, options, partitioned=False):
    m = jt if pkg == "jax" else tt
    cols = [("id", m.BIGINT(False)), ("v", m.DOUBLE()), ("tag", m.STRING())]
    schema = m.RowType.of(*([("dt", m.STRING(False))] if partitioned else []), *cols)
    cat = JaxCatalog(warehouse, commit_user=pkg) if pkg == "jax" else PortCatalog(warehouse, commit_user=pkg,
                                                                                  device="cpu")
    return cat.create_table(ident, schema, partition_keys=["dt"] if partitioned else [],
                            primary_keys=["dt", "id"] if partitioned else ["id"], options=options)


def _open(pkg, path, options=None):
    if pkg == "jax":
        return jax_load_table(path, commit_user=pkg, dynamic_options=options)
    return port_load_table(path, commit_user=pkg, dynamic_options=options, device="cpu")


def _commits(seed, n, rows=24, partitioned=False):
    rng = np.random.default_rng(seed)
    out = []
    for c in range(n):
        ids = rng.integers(0, IDS, rows).astype(np.int64)
        data = {"id": ids, "v": (ids % 7) * 0.5 + rng.integers(0, 2, rows),
                "tag": np.array([f"c{c}"] * rows, dtype=object)}
        if partitioned:
            data = {"dt": np.array(["a", "b", "c"], dtype=object)[rng.integers(0, 3, rows)], **data}
        kinds = [KINDS[k] for k in rng.choice(4, rows, p=[0.7, 0.05, 0.15, 0.1])] if c else ["+I"] * rows
        out.append((data, kinds))
    return out


class Writer:
    """One streaming writer of the table, identifiers from 1, the i-th
    commit carrying watermark 1000 * i, 5 ms apart."""

    def __init__(self, table):
        wb = table.new_stream_write_builder()
        self.w, self.c, self.ident = wb.new_write(), wb.new_commit(), 0

    def commit(self, rows, kinds=None):
        self.ident += 1
        self.w.write(rows, kinds)
        self.c.commit_messages(self.ident, self.w.prepare_commit(), watermark=1000 * self.ident)
        time.sleep(0.005)

    def compact_full(self):
        self.ident += 1
        self.w.compact(full=True)
        self.c.commit_messages(self.ident, self.w.prepare_commit())


def _py(v):
    return v.item() if hasattr(v, "item") else v


def _split_key(s) -> tuple:
    return (tuple(s.partition), s.bucket, tuple(f.file_name for f in s.files), s.snapshot_id, s.raw_convertible,
            s.is_changelog, s.dv_index_file)


def _read_split(read, s) -> tuple:
    data, kinds = read.read_with_kinds(s)
    return (_split_key(s), [JaxRowKind(int(k)).short_string for k in kinds],
            [tuple(_py(v) for v in row) for row in data.to_pylist()])


class Streams:
    """Both packages' stream scans of the table at `path` under `options`."""

    def __init__(self, path, options=None, predicate=None):
        self.scans, self.reads = {}, {}
        for pkg in PKGS:
            rb = _open(pkg, path, {**ENGINE[pkg], **(options or {})}).new_read_builder()
            if predicate is not None:
                rb = rb.with_filter(predicate(jp if pkg == "jax" else tp))
            self.scans[pkg], self.reads[pkg] = rb.new_stream_scan(), rb.new_read()

    def plan(self, pkg):
        """One plan: None, or its splits with rows."""
        splits = self.scans[pkg].plan()
        return None if splits is None else [_read_split(self.reads[pkg], s) for s in splits]

    def drain(self, pkg, after_each=None) -> list:
        """Plans until None."""
        out = []
        while True:
            plan = self.plan(pkg)
            if plan is None:
                return out
            out.append(plan)
            if after_each is not None:
                after_each(pkg)

    def both(self, after_each=None) -> list:
        got = {pkg: self.drain(pkg, after_each) for pkg in PKGS}
        assert got["port"] == got["jax"]
        return got["port"]


def _snapshot_time(path, sid):
    return _open("port", path).store.snapshot_manager.snapshot(sid).time_millis


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("producer", PRODUCERS)
@pytest.mark.parametrize("writer", PKGS)
def test_stream_plans_match_the_reference(tmp_path, writer, producer, mode):
    table = _create(writer, str(tmp_path), "db.s", {**COMPACTING, "changelog-producer": producer})
    commits = _commits(5, 9)
    w = Writer(table)
    for rows, kinds in commits[:3]:
        w.commit(rows, kinds)
    options = dict(MODES[mode])
    if mode == "from-timestamp":
        options["scan.timestamp-millis"] = str(_snapshot_time(table.path, 2))
    streams = Streams(table.path, options)
    plans = [streams.both()]
    for rows, kinds in commits[3:]:
        w.commit(rows, kinds)
        plans.append(streams.both())
    w.compact_full()
    plans.append(streams.both())
    assert any(plan for plan in plans), "no plan"
    if producer in ("input", "lookup"):
        assert any(split[0][5] for plan in plans for p in plan for split in p)


@pytest.mark.parametrize("writer", PKGS)
def test_changelog_split_replays_its_files_in_sequence_order(tmp_path, writer):
    """Each commit writes three 8-row batches and write-buffer-rows=8
    flushes after each, so a changelog split holds three files of one
    bucket, replayed by (min_sequence_number, file_name): an id's later
    kinds must follow its earlier ones."""
    table = _create(writer, str(tmp_path), "db.order", {"bucket": "1", "write-only": "true",
                                                        "changelog-producer": "input", "write-buffer-rows": "8"})
    w = Writer(table)
    streams = Streams(table.path, {"scan.mode": "from-snapshot", "scan.snapshot-id": "1"})
    plans = []
    for rows, kinds in _commits(20, 4):
        for lo in (0, 8, 16):
            w.w.write({k: v[lo:lo + 8] for k, v in rows.items()}, kinds[lo:lo + 8])
        w.commit({k: v[:0] for k, v in rows.items()}, [])
        plans += streams.both()
    assert max(len(split[0][2]) for plan in plans for split in plan) >= 3
    inc = {pkg: [_read_split(_open(pkg, table.path, ENGINE[pkg]).new_read_builder().new_read(), s)
                 for s in _open(pkg, table.path, {**ENGINE[pkg], "incremental-between": "0,4",
                                                  "incremental-between-scan-mode": "changelog"})
                 .new_read_builder().new_scan().plan()] for pkg in PKGS}
    assert inc["port"] == inc["jax"]
    # the same files, kinds and rows as the stream's (raw_convertible aside)
    assert [(k[2], kinds, rows) for k, kinds, rows in inc["port"]] == [
        (k[2], kinds, rows) for plan in plans for k, kinds, rows in plan]


def _replayed(plans) -> dict:
    state = {}
    for plan in plans:
        for _, kinds, rows in plan:
            for k, row in zip(kinds, rows):
                if k in ("+I", "+U"):
                    state[row[0]] = row
                else:
                    state.pop(row[0], None)
    return state


@pytest.mark.parametrize("producer", ["input", "lookup"])
def test_replay_equals_the_batch_read(tmp_path, producer):
    """Replaying a latest-full stream after every commit gives the batch
    read of the latest snapshot."""
    table = _create("port", str(tmp_path), "db.replay", {**COMPACTING, "bucket": "1",
                                                         "changelog-producer": producer})
    w = Writer(table)
    streams = Streams(table.path)
    seen = []
    for rows, kinds in _commits(6, 6):
        w.commit(rows, kinds)
        seen += streams.both()
        rb = _open("port", table.path).new_read_builder()
        batch = {r[0]: tuple(map(_py, r)) for r in rb.new_read().read_all(rb.new_scan().plan()).to_pylist()}
        assert _replayed(seen) == batch


@pytest.mark.parametrize("writer", PKGS)
def test_checkpoint_and_restore(tmp_path, writer):
    table = _create(writer, str(tmp_path), "db.cp", {**COMPACTING, "changelog-producer": "input"})
    w = Writer(table)
    commits = _commits(7, 6)
    for rows, kinds in commits[:2]:
        w.commit(rows, kinds)
    streams = Streams(table.path)
    streams.both()
    tokens = {pkg: streams.scans[pkg].checkpoint() for pkg in PKGS}
    assert tokens["port"] == tokens["jax"]
    for rows, kinds in commits[2:]:
        w.commit(rows, kinds)
    restored = Streams(table.path)
    for pkg in PKGS:
        restored.scans[pkg].restore(tokens["jax"])
    after = restored.both()
    assert after == streams.both()


@pytest.mark.parametrize("consumer_mode", ["exactly-once", "at-least-once"])
def test_consumer_positions_match_the_reference(tmp_path, consumer_mode):
    table = _create("port", str(tmp_path), "db.cons", {**COMPACTING, "changelog-producer": "input"})
    w = Writer(table)
    commits = _commits(8, 6)
    for rows, kinds in commits[:3]:
        w.commit(rows, kinds)
    consumers = {"jax": JaxConsumers(table.file_io, table.path), "port": PortConsumers(table.file_io, table.path)}
    positions = {pkg: [] for pkg in PKGS}
    streams = {pkg: Streams(table.path, {"consumer-id": f"c-{pkg}", "consumer.mode": consumer_mode,
                                          "scan.mode": "from-snapshot", "scan.snapshot-id": "1"})
               for pkg in PKGS}

    def ack(pkg):
        scan = streams[pkg].scans[pkg]
        scan.checkpoint()
        scan.notify_checkpoint_complete()
        positions[pkg].append([consumers[c].consumer(f"c-{pkg}") for c in PKGS])

    plans = {pkg: streams[pkg].drain(pkg, ack) for pkg in PKGS}
    assert plans["port"] == plans["jax"]
    assert positions["port"] == positions["jax"] and positions["port"]
    # the consumer files hold the same JSON
    files = {pkg: json.loads(open(f"{table.path}/consumer/consumer-c-{pkg}").read()) for pkg in PKGS}
    assert files["port"] == files["jax"]
    for rows, kinds in commits[3:]:
        w.commit(rows, kinds)
    # new scans resume from the saved positions, not from the startup mode
    resumed = {pkg: Streams(table.path, {"consumer-id": f"c-{pkg}", "consumer.mode": consumer_mode}).drain(pkg)
               for pkg in PKGS}
    assert resumed["port"] == resumed["jax"] and resumed["port"]
    ignored = {pkg: Streams(table.path, {"consumer-id": f"c-{pkg}", "consumer.ignore-progress": "true",
                                         "scan.mode": "latest"}).drain(pkg) for pkg in PKGS}
    assert ignored["port"] == ignored["jax"] == []


@pytest.mark.parametrize("bound", ["2500", "500", "100000"])
def test_bounded_watermark(tmp_path, bound):
    table = _create("port", str(tmp_path), "db.bw", {"bucket": "1", "write-only": "true"})
    w = Writer(table)
    commits = _commits(9, 5)
    w.commit(*commits[0])
    streams = Streams(table.path, {"scan.bounded.watermark": bound})
    plans = [streams.both()]
    for rows, kinds in commits[1:]:
        w.commit(rows, kinds)
        plans.append(streams.both())
        assert streams.scans["port"].ended == streams.scans["jax"].ended
    assert streams.scans["port"].ended == (bound != "100000")
    for pkg in PKGS:
        streams.scans[pkg].restore(2)
        assert not streams.scans[pkg].ended
    # snapshot 2 carries watermark 2000
    assert bool(streams.both()) == (bound != "500")


@pytest.mark.parametrize("writer", PKGS)
def test_streaming_read_overwrite(tmp_path, writer):
    """OVERWRITE snapshots, written by either package, surface only under
    streaming-read-overwrite."""
    table = _create(writer, str(tmp_path), "db.ow", {"bucket": "1"})
    w = Writer(table)
    w.commit(*_commits(10, 1)[0])
    wb = table.new_batch_write_builder().with_overwrite()
    ow = wb.new_write()
    ow.write({"id": np.array([9, 3], dtype=np.int64), "v": np.array([9.0, 3.0]),
              "tag": np.array(["o", "o"], dtype=object)})
    wb.new_commit().commit(ow.prepare_commit())
    for flag in ("true", "false"):
        got = Streams(table.path, {"scan.mode": "from-snapshot", "scan.snapshot-id": "1",
                                   "streaming-read-overwrite": flag}).both()
        overwrite = got[-1]
        assert bool(overwrite) == (flag == "true")


def test_file_monitor_sees_compactions(tmp_path):
    table = _create("port", str(tmp_path), "db.fm", {**COMPACTING, "bucket": "1"})
    w = Writer(table)
    streams = Streams(table.path, {"stream-scan-mode": "file-monitor", "scan.mode": "from-snapshot",
                                   "scan.snapshot-id": "1"})
    plans = []
    for rows, kinds in _commits(11, 6):
        w.commit(rows, kinds)
        plans += streams.both()
    sm = table.store.snapshot_manager
    kinds = {sm.snapshot(split[0][3]).commit_kind.value for plan in plans for split in plan}
    assert kinds == {"APPEND", "COMPACT"}


@pytest.mark.parametrize("writer", PKGS)
def test_changelog_survives_snapshot_expiry(tmp_path, writer):
    """A stream from snapshot 1 reads the whole change history through the
    decoupled changelog copies of expired snapshots."""
    options = {"bucket": "1", "changelog-producer": "input", "snapshot.num-retained.min": "1",
               "snapshot.num-retained.max": "1", "snapshot.time-retained": "1 ms",
               "changelog.num-retained.max": "50"}
    table = _create(writer, str(tmp_path), "db.cls", options)
    w = Writer(table)
    for i in range(1, 5):
        w.commit({"id": np.array([i], dtype=np.int64), "v": np.array([i * 1.0]),
                  "tag": np.array(["x"], dtype=object)})
    table.expire_snapshots()
    sm = _open("port", table.path).store.snapshot_manager
    assert sm.earliest_snapshot_id() > 1 and sm.changelog_ids()
    assert sm.snapshot(1).id == 1  # read from changelog/changelog-1
    plans = Streams(table.path, {"scan.mode": "from-snapshot", "scan.snapshot-id": "1"}).both()
    assert [r[0] for plan in plans for _, _, rows in plan for r in rows] == [1, 2, 3, 4]


def test_starting_plan_applies_deletion_vectors(tmp_path):
    table = _create("port", str(tmp_path), "db.sdv", {"bucket": "1", "deletion-vectors.enabled": "true"})
    w = Writer(table)
    for rows, kinds in _commits(12, 3):
        w.commit(rows, kinds)
    assert table.delete_where(tp.less_than("id", 10)) > 0
    plans = Streams(table.path).both()
    assert plans[0] and all(split[0][6] for split in plans[0])
    assert not [r for _, _, rows in plans[0] for r in rows if r[0] < 10]


def test_current_watermark(tmp_path):
    table = _create("port", str(tmp_path), "db.wm", {"bucket": "1"})
    w = Writer(table)
    w.commit(*_commits(13, 1)[0])
    streams = Streams(table.path, {"scan.mode": "from-snapshot", "scan.snapshot-id": "1"})
    streams.both()
    assert streams.scans["port"].current_watermark() == streams.scans["jax"].current_watermark() == 1000
    idle = Streams(table.path, {"scan.mode": "from-snapshot", "scan.snapshot-id": "1",
                                "snapshot.watermark-idle-timeout": "10 ms"})
    idle.both()
    assert idle.scans["port"].current_watermark() == 1000  # planned just now
    time.sleep(0.02)
    t0 = int(time.time() * 1000)
    assert idle.scans["port"].current_watermark() >= t0


def test_plan_aligned(tmp_path):
    table = _create("port", str(tmp_path), "db.al", {"bucket": "1", "write-only": "true"})
    w = Writer(table)
    w.commit(*_commits(14, 1)[0])
    streams = Streams(table.path)
    streams.both()
    for pkg in PKGS:
        t0 = time.monotonic()
        assert streams.scans[pkg].plan_aligned(timeout_seconds=0.2, poll_seconds=0.05) is None
        assert time.monotonic() - t0 < 1.5
    later = _commits(15, 1)[0]
    th = threading.Thread(target=lambda: (time.sleep(0.2), w.commit(*later)))
    th.start()
    try:
        splits = streams.scans["port"].plan_aligned(timeout_seconds=1.5, poll_seconds=0.02)
    finally:
        th.join(timeout=5)
    assert not th.is_alive() and splits
    jax_splits = streams.scans["jax"].plan_aligned(timeout_seconds=1.5, poll_seconds=0.02)
    assert [_split_key(s) for s in splits] == [_split_key(s) for s in jax_splits]


@pytest.mark.parametrize("option,value", [("streaming-read-mode", "log"), ("stream-scan-mode", "bogus"),
                                          ("consumer.mode", "bogus")])
def test_option_errors_match_the_reference(tmp_path, option, value):
    table = _create("port", str(tmp_path), "db.err", {"bucket": "1"})
    errors = {}
    for pkg in PKGS:
        with pytest.raises(ValueError) as e:
            _open(pkg, table.path, {option: value}).new_read_builder().new_stream_scan()
        errors[pkg] = str(e.value)
    assert errors["port"] == errors["jax"]


# ---------------------------------------------------------------------------
# enumerators and split serialisation
# ---------------------------------------------------------------------------


def _drain_readers(enum, readers) -> list:
    return [[_split_key(s) for s in enum.next_splits(r, max_splits=3)] for r in range(readers)]


@pytest.mark.parametrize("writer", PKGS)
def test_enumerator_assignments_match_the_reference(tmp_path, writer):
    table = _create(writer, str(tmp_path), "db.en", {"bucket": "4", "write-only": "true"}, partitioned=True)
    w = Writer(table)
    enums = {"jax": JaxEnumerator(_open("jax", table.path, ENGINE["jax"]), num_readers=3),
             "port": PortEnumerator(_open("port", table.path, ENGINE["port"]), num_readers=3)}
    assigned = {pkg: [] for pkg in PKGS}
    for rows, kinds in _commits(16, 4, partitioned=True):
        w.commit(rows, kinds)
        for pkg in PKGS:
            enums[pkg].discover()
            assigned[pkg].append(_drain_readers(enums[pkg], 3))
    assert assigned["port"] == assigned["jax"]
    assert sum(len(r) for step in assigned["port"] for r in step) > 8
    assert all(isinstance(v, str) for step in assigned["port"] for r in step for key in r for v in key[0])
    # undrained splits and the scan's position, restored by the other package
    w.commit(*_commits(17, 1, partitioned=True)[0])
    for pkg in PKGS:
        enums[pkg].discover()
    states = {pkg: enums[pkg].checkpoint() for pkg in PKGS}
    assert json.dumps(states["port"], sort_keys=True) == json.dumps(states["jax"], sort_keys=True)
    crossed = {"jax": JaxEnumerator(_open("jax", table.path, ENGINE["jax"]), num_readers=2),
               "port": PortEnumerator(_open("port", table.path, ENGINE["port"]), num_readers=2)}
    crossed["jax"].restore(states["port"])
    crossed["port"].restore(states["jax"])
    assert crossed["port"].pending_count == crossed["jax"].pending_count == enums["port"].pending_count > 0
    assert _drain_readers(crossed["port"], 2) == _drain_readers(crossed["jax"], 2)
    for pkg in PKGS:
        assert crossed[pkg].discover() == 0


def test_aligned_enumerator_matches_the_reference(tmp_path):
    table = _create("port", str(tmp_path), "db.aen", {"bucket": "2", "changelog-producer": "input"})
    w = Writer(table)
    for rows, kinds in _commits(18, 3):
        w.commit(rows, kinds)
    opts = {"scan.mode": "from-snapshot", "scan.snapshot-id": "1"}
    enums = {"jax": JaxAligned(_open("jax", table.path, {**ENGINE["jax"], **opts}), num_readers=2),
             "port": PortAligned(_open("port", table.path, {**ENGINE["port"], **opts}), num_readers=2)}
    states = {pkg: [] for pkg in PKGS}
    for pkg in PKGS:
        enum = enums[pkg]
        while enum.discover():
            assert enum.discover() == 0
            with pytest.raises(TimeoutError):
                enum.aligned_checkpoint(timeout_seconds=0.05, poll_seconds=0.01)
            _drain_readers(enum, 2)
            state = enum.aligned_checkpoint(timeout_seconds=1, poll_seconds=0.01)
            states[pkg].append((state["alignedSnapshot"], state["nextSnapshot"]))
    assert states["port"] == states["jax"] == [(1, 2), (2, 3), (3, 4)]


@pytest.mark.parametrize("producer", ["none", "input"])
def test_split_dicts_cross_packages(tmp_path, producer):
    """A split serialised by one package opens in the other and reads the
    same rows there."""
    table = _create("port", str(tmp_path), "db.sd", {**COMPACTING, "changelog-producer": producer,
                                                     "deletion-vectors.enabled": "true"}, partitioned=True)
    w = Writer(table)
    for rows, kinds in _commits(19, 4, partitioned=True):
        w.commit(rows, kinds)
    table.delete_where(tp.less_than("id", 5))
    views = {pkg: _open(pkg, table.path, ENGINE[pkg]) for pkg in PKGS}
    splits = {pkg: views[pkg].new_read_builder().new_scan().plan() for pkg in PKGS}
    inc = {pkg: _open(pkg, table.path, {**ENGINE[pkg], "incremental-between": "1,4"}).new_read_builder()
           for pkg in PKGS}
    splits = {pkg: splits[pkg] + inc[pkg].new_scan().plan() for pkg in PKGS}
    dicts = {pkg: [s.to_dict() for s in splits[pkg]] for pkg in PKGS}
    assert json.dumps(dicts["port"], sort_keys=True) == json.dumps(dicts["jax"], sort_keys=True)
    reads = {pkg: views[pkg].new_read_builder().new_read() for pkg in PKGS}
    for d in dicts["port"]:
        js, ps = JaxSplit.from_dict(d), PortSplit.from_dict(d)
        assert ps.to_dict() == js.to_dict() == d
        assert ps.row_count == js.row_count
        assert _read_split(reads["port"], ps) == _read_split(reads["jax"], js)
    assert any(s.dv_index_file for s in splits["port"]) and any(s.is_changelog for s in splits["port"])
    assert os.path.isdir(f"{table.path}/index")
