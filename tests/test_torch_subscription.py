"""The port's changelog subscription service (paimon_tpu_torch/service/
subscription.py, FileStoreTable.subscribe, LocalTableQuery.follow) against
the JAX package's, on the CPU (device="cpu").

The cases of tests/test_subscription.py but its three Flight cases and its
stage soak: each script runs through both packages in-process, on a twin
table per package written with the same rows, and asserts the same
delivered batches (snapshot ids and their (RowKind, row) events), the
same folds, checkpoints, typed sheds and their restart offsets, the same
decode-once counters, expiry pins and CDC wire round trips. The subscriber
process runs as the port's child on --device cpu, is killed with SIGKILL
and respawned; its journal's fold is held to the JAX package's subscription
of the twin table run in-process (no JAX child process is started: those
die in pyarrow). Added: follow / unfollow of a LocalTableQuery, and a CPU
and a CUDA view of one table path taking separate hubs. Every hub is
closed and every follower unfollowed by the end of each case; every wait
carries a timeout. The port's tables merge under sort-engine=pallas (the
kernels' plain versions on the CPU).

Tolerance: exact.
"""

import io
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import paimon_tpu as jt
import paimon_tpu.catalog as jcat_mod
import paimon_tpu.metrics as jmetrics
import paimon_tpu.service.subscription as jsub
import paimon_tpu.table.cdc_format as jcdc
import paimon_tpu.table.consumer as jconsumer
import paimon_tpu_torch as tt
import paimon_tpu_torch.catalog as pcat_mod
import paimon_tpu_torch.metrics as pmetrics
import paimon_tpu_torch.service.subscription as psub
import paimon_tpu_torch.table.cdc_format as pcdc
import paimon_tpu_torch.table.consumer as pconsumer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("jax", "port")
TYPES = {"jax": jt, "port": tt}
SUB = {"jax": jsub, "port": psub}
METRICS = {"jax": jmetrics, "port": pmetrics}
CDC = {"jax": jcdc, "port": pcdc}
CONSUMER = {"jax": jconsumer, "port": pconsumer}
ENGINE = {"jax": {"sort-engine": "numpy"}, "port": {"sort-engine": "pallas"}}


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


@pytest.fixture(autouse=True)
def _hubs_down():
    yield
    jsub.SubscriptionHub.shutdown_all()
    psub.SubscriptionHub.shutdown_all()


def catalog(pkg, warehouse, user="subs"):
    if pkg == "jax":
        return jcat_mod.FileSystemCatalog(str(warehouse), commit_user=user)
    return pcat_mod.FileSystemCatalog(str(warehouse), commit_user=user, device="cpu")


def schema(pkg):
    t = TYPES[pkg]
    return t.RowType.of(("k", t.BIGINT()), ("v", t.DOUBLE()))


def twins(tmp_path, name, options=None):
    """The same table in a warehouse per package."""
    return {pkg: catalog(pkg, tmp_path / pkg).create_table(
        f"db.{name}", schema(pkg), primary_keys=["k"], options={"bucket": "1", **ENGINE[pkg], **(options or {})})
        for pkg in PKGS}


def write(t, data, kinds=None):
    wb = t.new_batch_write_builder()
    w = wb.new_write()
    w.write(data, kinds)
    wb.new_commit().commit(w.prepare_commit())


def scan_rows(t, sid=None):
    tt_ = t.copy({"scan.snapshot-id": str(sid)}) if sid is not None else t
    rb = tt_.new_read_builder()
    return {row[0]: tuple(row) for row in rb.new_read().read_all(rb.new_scan().plan()).to_pylist()}


def fold_sub(pkg, batches):
    state = {}
    for b in sorted(batches, key=lambda b: b.snapshot_id):
        SUB[pkg].fold_changelog(state, b, ["k"])
    return {k[0]: v for k, v in state.items()}


def drain(sub, timeout=10.0, idle=0.4):
    """Poll until the stream goes idle; the received batches."""
    out = []
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        b = sub.poll(timeout=idle)
        if b is None:
            if out:
                return out
            continue
        out.append(b)
    return out


def seen(batches):
    """What a consumer saw: each batch's snapshot id and events."""
    return [(b.snapshot_id, b.events()) for b in batches]


def sub_counts(pkg):
    g = METRICS[pkg].sub_metrics()
    return {k: g.counter(k).count for k in ("batches_fanned", "rows_fanned", "decode_reuse_hits", "shed_subscribers")}


def reset_sub_metrics():
    for pkg in PKGS:
        METRICS[pkg].registry.groups.pop(("sub", ()), None)


def test_subscribe_fold_equals_scan(tmp_path):
    out = {}
    for pkg, t in twins(tmp_path, "basic", {"bucket": "2"}).items():
        write(t, {"k": [1, 2], "v": [1.0, 2.0]})
        write(t, {"k": [2, 3], "v": [22.0, 3.0]})
        sub = t.subscribe(consumer_id="c1", from_snapshot=1)
        try:
            batches = drain(sub)
            steps = [seen(batches), sub.checkpoint, fold_sub(pkg, batches) == scan_rows(t)]
            write(t, {"k": [4], "v": [4.0]})
            b = sub.poll(timeout=10.0)
            batches.append(b)
            steps += [seen([b]), b.is_catchup, fold_sub(pkg, batches) == scan_rows(t)]
        finally:
            sub.close()
        out[pkg] = steps
    assert out["port"] == out["jax"]
    assert [sid for sid, _ in out["port"][0]] == [1, 2] and out["port"][1] == 3 and out["port"][2] and out["port"][5]


def test_changelog_kinds_delivered(tmp_path):
    out = {}
    for pkg, t in twins(tmp_path, "kinds", {"changelog-producer": "input"}).items():
        write(t, {"k": [1], "v": [1.0]})
        wb = t.new_batch_write_builder()
        w = wb.new_write()
        w.write({"k": [1], "v": [1.0]}, kinds=["-U"])
        w.write({"k": [1], "v": [11.0]}, kinds=["+U"])
        w.write({"k": [2], "v": [2.0]}, kinds=["-D"])
        wb.new_commit().commit(w.prepare_commit())
        sub = t.subscribe(consumer_id="ck", from_snapshot=1)
        try:
            batches = drain(sub)
            out[pkg] = (seen(batches), fold_sub(pkg, batches) == scan_rows(t))
        finally:
            sub.close()
    assert out["port"] == out["jax"]
    events = [e for _, evs in out["port"][0] for e in evs]
    assert ("+I", 1, 1.0) in events and ("-U", 1, 1.0) in events and ("+U", 1, 11.0) in events
    assert ("-D", 2, 2.0) in events and out["port"][1]


def test_decode_once_fanout(tmp_path):
    """N subscribers receive the same decoded batch objects; the counters
    equal the JAX package's."""
    reset_sub_metrics()
    out = {}
    for pkg, t in twins(tmp_path, "fan").items():
        hub = SUB[pkg].SubscriptionHub.for_table(t)
        subs = [hub.subscribe(consumer_id=f"f{i}", from_snapshot=1) for i in range(4)]
        write(t, {"k": [1, 2, 3], "v": [1.0, 2.0, 3.0]})
        got = [s.poll(timeout=10.0) for s in subs]
        deadline = time.monotonic() + 10
        while hub.health_dict()["frontier"] < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        try:
            out[pkg] = ([b.snapshot_id for b in got], all(b.data is got[0].data for b in got[1:]), sub_counts(pkg),
                        seen(got[:1]), {k: v for k, v in hub.health_dict().items() if k != "buffered_bytes"})
        finally:
            for s in subs:
                s.close()
    assert out["port"] == out["jax"]
    assert out["port"][:3] == ([1, 1, 1, 1], True, {"batches_fanned": 4, "rows_fanned": 12, "decode_reuse_hits": 3,
                                                    "shed_subscribers": 0})


def test_catchup_rides_data_file_cache(tmp_path):
    out = {}
    for pkg, t in twins(tmp_path, "late").items():
        first = t.subscribe(consumer_id="early", from_snapshot=1)
        try:
            write(t, {"k": [1], "v": [1.0]})
            write(t, {"k": [2], "v": [2.0]})
            assert len(drain(first)) == 2
            METRICS[pkg].registry.groups.pop(("sub", ()), None)
            late = t.subscribe(consumer_id="late", from_snapshot=1)
            try:
                batches = drain(late)
                out[pkg] = (seen(batches), [b.is_catchup for b in batches], sub_counts(pkg),
                            fold_sub(pkg, batches) == scan_rows(t))
            finally:
                late.close()
        finally:
            first.close()
    assert out["port"] == out["jax"]
    assert out["port"][1] == [True, True] and out["port"][2]["decode_reuse_hits"] >= 2 and out["port"][3]


def test_resume_from_consumer_id(tmp_path):
    out = {}
    for pkg, t in twins(tmp_path, "resume").items():
        write(t, {"k": [1], "v": [1.0]})
        write(t, {"k": [2], "v": [2.0]})
        sub = t.subscribe(consumer_id="r1", from_snapshot=1)
        first = sub.poll(timeout=10.0)
        sub.close()
        saved = CONSUMER[pkg].ConsumerManager(t.file_io, t.path).consumer("r1")
        write(t, {"k": [3], "v": [3.0]})
        sub2 = t.subscribe(consumer_id="r1")
        try:
            batches = drain(sub2)
            out[pkg] = (first.snapshot_id, saved, seen(batches), fold_sub(pkg, batches) == scan_rows(t))
        finally:
            sub2.close()
    assert out["port"] == out["jax"]
    assert out["port"][0] == 1 and [sid for sid, _ in out["port"][2]] == [1, 2, 3] and out["port"][3]


def test_max_subscribers_typed_busy(tmp_path):
    out = {}
    for pkg, t in twins(tmp_path, "cap", {"subscription.max-subscribers": "1"}).items():
        sub = t.subscribe(consumer_id="one")
        try:
            with pytest.raises(SUB[pkg].SubscriberShedError) as exc:
                t.subscribe(consumer_id="two")
            out[pkg] = (exc.value.payload, exc.value.retry_after_ms, exc.value.consumer_id, str(exc.value))
        finally:
            sub.close()
    assert out["port"] == out["jax"]
    assert out["port"][0]["state"] == "busy-subscribers" and out["port"][1] > 0


def test_slow_consumer_shed_typed_then_resume(tmp_path):
    """A consumer that takes one batch and stalls is shed with its restart
    offset while its peer keeps the whole stream; resumed from its consumer
    id it loses nothing. The shed payload and the folds equal the JAX
    package's."""
    out = {}
    options = {"subscription.queue-depth": "2", "subscription.shed-timeout": "300 ms",
               "subscription.poll-backoff": "10 ms"}
    for pkg, t in twins(tmp_path, "slow", options).items():
        hub = SUB[pkg].SubscriptionHub.for_table(t)
        slow = hub.subscribe(consumer_id="slow", from_snapshot=1)
        peer = hub.subscribe(consumer_id="peer", from_snapshot=1)
        peer_batches = []
        stop = threading.Event()

        def peer_loop():
            while not stop.is_set():
                b = peer.poll(timeout=0.2)
                if b is not None:
                    peer_batches.append(b)

        th = threading.Thread(target=peer_loop)
        th.start()
        try:
            for i in range(8):
                write(t, {"k": [i], "v": [float(i)]})
            first = slow.poll(timeout=10.0)
            deadline = time.monotonic() + 20.0
            shed = None
            while shed is None and time.monotonic() < deadline:
                time.sleep(0.1)
                if slow.is_shed:
                    with pytest.raises(SUB[pkg].SubscriberShedError) as e:
                        slow.poll(timeout=0.1)
                    shed = e.value
            assert shed is not None, f"{pkg}: the slow consumer was never shed"
            resumed = hub.subscribe(consumer_id="slow")
            try:
                batches = [first] + drain(resumed)
            finally:
                resumed.close()
            deadline = time.monotonic() + 20.0
            while len(peer_batches) < 8 and time.monotonic() < deadline:
                time.sleep(0.05)
            stop.set()
            th.join(timeout=10.0)
            out[pkg] = (first.snapshot_id, shed.payload["consumer_id"], shed.payload["state"],
                        shed.next_snapshot is not None, fold_sub(pkg, batches) == scan_rows(t),
                        seen(peer_batches), peer.is_shed, METRICS[pkg].sub_metrics().counter("shed_subscribers").count >= 1)
        finally:
            stop.set()
            th.join(timeout=10.0)
            slow.close()
            peer.close()
    assert out["port"] == out["jax"]
    assert out["port"][1:5] == ("slow", "queue-full", True, True) and not out["port"][6]


def test_consumer_enoent_is_none_transient_raises(tmp_path):
    """Only a missing consumer file reads as no consumer: a transient read
    fault raises (retries off) or is absorbed (the retry budget), in each
    package's ConsumerManager on its fault-injecting store."""
    import paimon_tpu.fs.testing as jtesting
    import paimon_tpu_torch.fs.testing as ptesting

    testing = {"jax": jtesting, "port": ptesting}
    out = {}
    for pkg in PKGS:
        domain = f"cm{pkg}"
        testing[pkg].FailingFileIO.reset(domain, 0, 0)
        t = catalog(pkg, f"fail://{domain}{tmp_path}/{pkg}").create_table(
            "db.ct", schema(pkg), primary_keys=["k"], options={"bucket": "1", "fs.retry.max-attempts": "1"})
        cm = CONSUMER[pkg].ConsumerManager(t.store.file_io, t.path)
        steps = [cm.consumer("nope")]
        cm.record("c1", 7)
        steps.append(cm.consumer("c1"))
        testing[pkg].FailingFileIO.schedule(domain, testing[pkg].FaultRule("read", "consumer-c1"))
        try:
            cm.consumer("c1")
            steps.append("no error")
        except testing[pkg].ArtificialException:
            steps.append("ArtificialException")
        t2 = t.copy({"fs.retry.max-attempts": "4", "fs.retry.initial-backoff": "1 ms"})
        testing[pkg].FailingFileIO.schedule(domain, testing[pkg].FaultRule("read", "consumer-c1"))
        steps.append(CONSUMER[pkg].ConsumerManager(t2.store.file_io, t2.path).consumer("c1"))
        testing[pkg].FailingFileIO.reset(domain, 0, 0)
        out[pkg] = steps
    assert out["port"] == out["jax"] == [None, 7, "ArtificialException", 7]


def test_expiry_aborts_on_consumer_read_fault_keeps_pin(tmp_path):
    import paimon_tpu.fs.testing as jtesting
    import paimon_tpu_torch.fs.testing as ptesting

    testing = {"jax": jtesting, "port": ptesting}
    out = {}
    for pkg in PKGS:
        domain = f"cmexp{pkg}"
        testing[pkg].FailingFileIO.reset(domain, 0, 0)
        t = catalog(pkg, f"fail://{domain}{tmp_path}/{pkg}").create_table(
            "db.et", schema(pkg), primary_keys=["k"],
            options={"bucket": "1", "fs.retry.max-attempts": "1", "snapshot.num-retained.min": "1",
                     "snapshot.num-retained.max": "2"})
        write(t, {"k": [0], "v": [0.0]})
        sm = t.store.snapshot_manager
        CONSUMER[pkg].ConsumerManager(t.store.file_io, t.path).record("pinned-reader", 1)
        for i in range(1, 6):
            write(t, {"k": [i], "v": [float(i)]})
        steps = [sm.snapshot_exists(1)]
        testing[pkg].FailingFileIO.schedule(domain, testing[pkg].FaultRule("read", "consumer-pinned-reader", count=0))
        try:
            t.expire_snapshots()
            steps.append("no error")
        except testing[pkg].ArtificialException:
            steps.append("ArtificialException")
        testing[pkg].FailingFileIO.reset(domain, 0, 0)
        steps.append(sm.snapshot_exists(1))
        t.expire_snapshots()
        steps.append(sm.snapshot_exists(1))
        out[pkg] = steps
    assert out["port"] == out["jax"] == [True, "ArtificialException", True, True]


def test_lagging_subscriber_never_sees_missing_snapshot(tmp_path):
    out = {}
    options = {"snapshot.num-retained.min": "1", "snapshot.num-retained.max": "2",
               "subscription.heartbeat-interval": "200 ms"}
    for pkg, t in twins(tmp_path, "lag", options).items():
        write(t, {"k": [0], "v": [0.0]})
        sub = t.subscribe(consumer_id="laggard", from_snapshot=1)
        try:
            for i in range(1, 11):
                write(t, {"k": [i], "v": [float(i)]})
                t.expire_snapshots()
            sm = t.store.snapshot_manager
            earliest = sm.earliest_snapshot_id()
            batches = drain(sub, timeout=30.0)
            steps = [earliest, len(batches), [b.snapshot_id for b in batches] == sorted(b.snapshot_id for b in batches),
                     fold_sub(pkg, batches) == scan_rows(t)]
            time.sleep(0.5)  # a heartbeat records the advanced position
            t.expire_snapshots()
            steps.append(sm.earliest_snapshot_id() > 1)
        finally:
            sub.close()
        out[pkg] = steps
    assert out["port"] == out["jax"] == [1, 11, True, True, True]


def test_expire_stale_releases_abandoned_pin_heartbeat_keeps_live(tmp_path):
    out = {}
    options = {"snapshot.num-retained.min": "1", "snapshot.num-retained.max": "2",
               "consumer.expiration-time": "700 ms", "subscription.heartbeat-interval": "150 ms"}
    for pkg, t in twins(tmp_path, "stale", options).items():
        write(t, {"k": [0], "v": [0.0]})
        cm = CONSUMER[pkg].ConsumerManager(t.store.file_io, t.path)
        cm.record("abandoned", 1)
        sub = t.subscribe(consumer_id="alive", from_snapshot=1)
        try:
            steps = [len(drain(sub))]
            time.sleep(1.0)
            for i in range(1, 6):
                write(t, {"k": [i], "v": [float(i)]})
            t.expire_snapshots()
            steps += [cm.consumer("abandoned"), cm.consumer("alive") is not None, len(drain(sub, timeout=30.0)) > 0]
        finally:
            sub.close()
        out[pkg] = steps
    assert out["port"] == out["jax"] == [1, None, True, True]


EVENTS = [
    ("+I", {"k": 1, "s": "a", "v": 1.0}),
    ("+I", {"k": 2, "s": "b", "v": 2.0}),
    ("-U", {"k": 1, "s": "a", "v": 1.0}),
    ("+U", {"k": 1, "s": "a2", "v": 1.5}),
    ("-D", {"k": 2, "s": "b", "v": 2.0}),
]


@pytest.mark.parametrize("fmt", ["debezium-json", "canal-json", "maxwell-json"])
def test_cdc_format_roundtrip_pure(fmt):
    """Each package's formatter gives the same messages, and each parser
    reads the other's back to the events."""
    messages = {pkg: CDC[pkg].get_cdc_formatter(fmt)(EVENTS) for pkg in PKGS}
    assert messages["port"] == messages["jax"]
    for pkg in PKGS:
        other = "jax" if pkg == "port" else "port"
        back = [(r.kind, dict(r)) for m in messages[other] for r in CDC[pkg].get_cdc_parser(fmt)(m)]
        assert back == EVENTS


def test_cdc_format_json_insert_only():
    inserts = [e for e in EVENTS if e[0] == "+I"]
    for pkg in PKGS:
        back = [(r.kind, dict(r)) for m in CDC[pkg].format_json(inserts) for r in CDC[pkg].parse_json(m)]
        assert back == inserts
        with pytest.raises(ValueError):
            CDC[pkg].format_json(EVENTS)
    assert pcdc.format_json(inserts) == jcdc.format_json(inserts)


def test_follow_refreshes_on_the_hub(tmp_path):
    """LocalTableQuery.follow() serves each new commit without a refresh
    call (within a few seconds), a compaction-only snapshot included, and
    unfollow() stops its thread and deletes its consumer, as in the JAX
    package."""
    from paimon_tpu.table.query import LocalTableQuery as JaxQuery
    from paimon_tpu_torch.table.query import LocalTableQuery as PortQuery

    out = {}
    for pkg, t in twins(tmp_path, "follow", {"write-only": "false", "num-sorted-run.compaction-trigger": "3"}).items():
        write(t, {"k": [1, 2], "v": [1.0, 2.0]})
        q = JaxQuery(t) if pkg == "jax" else PortQuery(t, device="cpu")
        lock = threading.Lock()
        q.follow(lock=lock)
        steps = []
        try:
            for i in range(5):
                write(t, {"k": [i, 10 + i], "v": [float(i) * 3, 1.5]})
                want = [scan_rows(t).get(k) for k in range(16)]
                deadline = time.monotonic() + 10
                while True:
                    with lock:
                        got = q.get_batch(list(range(16))).to_pylist()
                    if got == want or time.monotonic() > deadline:
                        break
                    time.sleep(0.02)
                steps.append(got == want)
            steps.append(sorted(c.startswith("qryref-") for c in CONSUMER[pkg].ConsumerManager(
                t.file_io, t.path).list_consumers()))
        finally:
            q.unfollow()
        steps += [q._follow_thread is None, CONSUMER[pkg].ConsumerManager(t.file_io, t.path).list_consumers()]
        q.unfollow()  # a second unfollow is a no-op
        out[pkg] = steps
    assert out["port"] == out["jax"] == [True] * 5 + [[True], True, {}]
    assert not [th for th in threading.enumerate() if th.name.startswith("paimon-qryref")]


def test_a_cpu_and_a_cuda_view_of_one_path_take_separate_hubs(tmp_path):
    """The registry keys hubs by (table path, device): a table opened on
    the CPU and the same path opened for the card get their own hubs, and a
    second CPU view of the path shares the first's."""
    t = twins(tmp_path, "dev")["port"]
    cuda_view = pcat_mod.FileSystemCatalog(str(tmp_path / "port"), device="cpu").get_table("db.dev")
    cuda_view.device = torch.device("cuda")  # a view for the card, never read here
    cpu_hub = psub.SubscriptionHub.for_table(t)
    assert psub.SubscriptionHub.for_table(t.copy({"subscription.queue-depth": "3"})) is cpu_hub
    cuda_hub = psub.SubscriptionHub.for_table(cuda_view)
    assert cuda_hub is not cpu_hub and cuda_hub.table.device.type == "cuda" and cpu_hub.table.device.type == "cpu"
    assert set(psub.SubscriptionHub._hubs) == {(t.store.table_path, "cpu"), (t.store.table_path, "cuda")}
    cpu_hub.close()
    assert psub.SubscriptionHub.for_table(cuda_view) is cuda_hub
    cuda_hub.close()
    assert not psub.SubscriptionHub._hubs


def test_subscriber_process_kill9_resume(tmp_path):
    """tests/test_subscription.py::test_subscriber_process_kill9_resume with
    the port's subscriber process on --device cpu: killed with SIGKILL once
    its journal holds a batch, respawned with the same consumer id after
    six more commits, its journal's fold equals the table, and equals the
    fold of the JAX package's subscription of the twin table, run
    in-process."""
    tables = twins(tmp_path, "pk", {"bucket": "2"})
    t = tables["port"]
    journal = str(tmp_path / "sub.journal")

    def spawn(duration):
        cmd = [sys.executable, "-m", "paimon_tpu_torch.service.subscription", "--table", t.path, "--consumer",
               "pksub", "--journal", journal, "--duration", str(duration), "--from-snapshot", "1", "--device", "cpu"]
        return subprocess.Popen(cmd, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)

    def commits(lo, hi):
        for i in range(lo, hi):
            data = {"k": [i] if i >= 10 else [i, i + 100], "v": [float(i)] if i >= 10 else [float(i), float(i)]}
            for table in tables.values():
                write(table, data)

    proc = spawn(60.0)
    try:
        commits(0, 10)
        deadline = time.monotonic() + 120.0
        while not (os.path.exists(journal) and os.path.getsize(journal) > 0):
            assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
            assert time.monotonic() < deadline, "the subscriber child never journaled"
            time.sleep(0.1)
        os.kill(proc.pid, signal.SIGKILL)
        assert proc.wait(timeout=30) == -signal.SIGKILL
        proc.stderr.close()
        commits(10, 16)
        proc = spawn(3.0)
        rc = proc.wait(timeout=180)
        assert rc == 0, proc.stderr.read().decode()[-2000:]
        proc.stderr.close()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    by_sid, done = {}, None
    with open(journal, encoding="utf-8") as f:
        for line in f:
            if line.strip():
                rec = json.loads(line)
                if "sid" in rec:
                    by_sid[rec["sid"]] = rec
                elif rec.get("done"):
                    done = rec
    state = {}
    for sid in sorted(by_sid):
        for row, kind in zip(by_sid[sid]["rows"], by_sid[sid]["kinds"]):
            if kind in (0, 2):
                state[row[0]] = tuple(row)
            elif kind == 3:
                state.pop(row[0], None)
    assert state == scan_rows(t), "journal fold across the kill != the table"
    assert done == {"done": True, "checkpoint": t.store.snapshot_manager.latest_snapshot_id()}
    jax_sub = tables["jax"].subscribe(consumer_id="inproc", from_snapshot=1)
    try:
        jax_batches = drain(jax_sub, timeout=30.0)
    finally:
        jax_sub.close()
    assert sorted(by_sid) == [b.snapshot_id for b in jax_batches]
    assert {sid: [tuple(r) for r in by_sid[sid]["rows"]] for sid in by_sid} == {
        b.snapshot_id: b.data.to_pylist() for b in jax_batches}
    assert state == fold_sub("jax", jax_batches)
