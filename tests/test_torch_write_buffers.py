"""The write-buffer surface of the port (paimon_tpu_torch) against the JAX
package, on the CPU (device="cpu" for the port).

- Admission control (core/admission.py): the port's WriteBufferController
  and the JAX package's run the same sequence of calls to the same
  results, counters and health; a TableWrite builds one from
  write.buffer.max-memory or takes a shared one; a write over the stop
  trigger throttles through the writer's offloaded drain, and one whose
  block timeout passes is rejected with nothing buffered; every reserved
  byte is released exactly once, on commit and on close with a flush in
  flight; a worker's error raises at the barrier and leaves no
  paimon-flush thread.
- The offloaded flush (core/writer.py): the same files, entries and rows
  with scan.prefetch-splits at its default and at 0, and as the JAX
  package writes them.
- The spilling append buffer (core/disk.py, core/append.py): the buffer
  replays in order and spills on rows or bytes; spilled append tables
  write the JAX package's files (rows per file) and rows; the max-disk
  gate stops spilling and flushes.

Every wait on another thread is on an event or a condition the test
controls, never a sleep against a deadline; throttles and rejects come
from a held flush or a block timeout of 0. They mirror tests/test_soak.py
(:62, :127, :299), tests/test_proc_soak.py:357, tests/test_aux.py (:168,
:211) and tests/test_options_wave_c.py (:224, :240).

Tolerance: exact.
"""

import io
import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import paimon_tpu as jt
import paimon_tpu_torch as tt
from paimon_tpu.catalog import FileSystemCatalog as JaxCatalog
from paimon_tpu.core import admission as jadm
from paimon_tpu.core import disk as jdisk
from paimon_tpu.metrics import soak_metrics as jsoak
from paimon_tpu.table.write import TableWrite as JaxTableWrite
from paimon_tpu_torch.catalog import FileSystemCatalog as PortCatalog
from paimon_tpu_torch.core import admission as padm
from paimon_tpu_torch.core import disk as pdisk
from paimon_tpu_torch.metrics import soak_metrics as psoak
from paimon_tpu_torch.table.write import TableWrite as PortTableWrite

PKGS = ("jax", "port")
ADM = {"jax": jadm, "port": padm}
SOAK = {"jax": jsoak, "port": psoak}
TABLE_WRITE = {"jax": JaxTableWrite, "port": PortTableWrite}
HEALTH_KEYS = ("state", "buffered_bytes", "max_memory", "stop_trigger_bytes", "pending_flushes",
               "max_pending_flushes", "writes_throttled", "writes_rejected", "retry_after_ms")


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


def _mod(pkg):
    return jt if pkg == "jax" else tt


def _catalog(pkg, warehouse):
    if pkg == "jax":
        return JaxCatalog(warehouse, commit_user=pkg)
    return PortCatalog(warehouse, commit_user=pkg, device="cpu")


def _soak_counts(pkg) -> tuple:
    """(writes_throttled, writes_rejected, backpressure_ms updates) of the
    package's soak group: tests take differences of two readings, so no
    registry is reset under the other tests of the process."""
    g = SOAK[pkg]()
    return (g.counter("writes_throttled").count, g.counter("writes_rejected").count,
            g.histogram("backpressure_ms").count)


def _since(pkg, before: tuple) -> tuple:
    return tuple(a - b for a, b in zip(_soak_counts(pkg), before))


def _py(v):
    return v.item() if hasattr(v, "item") else v


def _kv_table(pkg, warehouse, ident, options):
    m = _mod(pkg)
    schema = m.RowType.of(("k", m.BIGINT(False)), ("v", m.DOUBLE()))
    return _catalog(pkg, warehouse).create_table(ident, schema, primary_keys=["k"], options={"bucket": "1", **options})


def _kv_rows(keys, base=0.0) -> dict:
    keys = np.asarray(list(keys), dtype=np.int64)
    return {"k": keys, "v": keys + base}


def _commit(table, tw) -> list:
    return table.new_batch_write_builder().new_commit().commit(tw.prepare_commit())


def _read(table) -> list[tuple]:
    rb = table.new_read_builder()
    return [tuple(_py(v) for v in r) for r in rb.new_read().read_all(rb.new_scan().plan()).to_pylist()]


class _SignallingCondition(threading.Condition):
    """A Condition whose wait() first sets `waiting`: a thread blocked in
    admission is then known to be inside the wait, holding no lock."""

    def __init__(self):
        super().__init__()
        self.waiting = threading.Event()

    def wait(self, timeout=None):
        self.waiting.set()
        return super().wait(timeout)


def _held_flushes(writer):
    """Hold the writer's file writes until the returned event is set."""
    go = threading.Event()
    real = writer.writer_factory.write

    def held(kv, *a, **kw):
        go.wait()
        return real(kv, *a, **kw)

    writer.writer_factory.write = held
    return go


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------


def _run_sequence(pkg) -> list:
    """The admit / throttle / reject state machine under a block timeout
    of 0 (so a throttled call is decided at once), and the flush-depth
    cap; each step's result and the health after it."""
    adm = ADM[pkg]
    before = _soak_counts(pkg)
    c = adm.WriteBufferController(1000, stop_trigger=0.5, block_timeout_ms=0, max_pending_flushes=2)
    out = []

    def step(name, fn):
        try:
            result = fn()
        except adm.WriterBackpressureError:
            result = "rejected"
        h = c.health_dict()
        out.append((name, result, c.in_use, c.pending_flushes, tuple(h[k] for k in HEALTH_KEYS)))

    step("try 400", lambda: c.try_reserve(400))
    step("try 200 over the trigger", lambda: c.try_reserve(200))
    step("reserve 200 over the trigger", lambda: c.reserve(200))
    step("release 400", lambda: c.release(400))
    step("reserve 200", lambda: c.reserve(200))
    step("reserve 5000 oversized", lambda: c.reserve(5000))
    step("release 5200", lambda: c.release(5200))
    step("reserve 5000 when empty", lambda: c.reserve(5000))
    step("reserve 1 over", lambda: c.reserve(1))
    step("release 5000", lambda: c.release(5000))
    step("flush_begin 1", c.flush_begin)
    step("flush_begin 2", c.flush_begin)
    step("flush_begin at the cap", c.flush_begin)
    step("flush_end", c.flush_end)
    step("flush_begin again", c.flush_begin)
    step("release nothing", lambda: c.release(0))
    out.append(("metrics", *_since(pkg, before)))
    return out


def test_controller_state_machine_equals_the_jax_controller():
    port, jax = _run_sequence("port"), _run_sequence("jax")
    assert port == jax
    states = [s[4][0] for s in port[:-1]]
    assert "throttling" in states and "rejecting" in states and states[-1] == "ok"
    assert port[-1] == ("metrics", 4, 3, 4)


@pytest.mark.parametrize("pkg", PKGS)
def test_blocked_reserve_wakes_on_release(pkg):
    c = ADM[pkg].WriteBufferController(1000, stop_trigger=0.5, block_timeout_ms=60_000)
    c._cond = _SignallingCondition()
    c.reserve(500)
    got = []
    t = threading.Thread(target=lambda: (c.reserve(300), got.append(c.in_use)))
    t.start()
    assert c._cond.waiting.wait(30)
    assert not got  # throttled
    c.release(500)
    t.join(30)
    assert got == [300]


@pytest.mark.parametrize("pkg", PKGS)
def test_controller_from_options(tmp_path, pkg):
    t = _kv_table(pkg, str(tmp_path), "db.off", {})
    assert TABLE_WRITE[pkg](t).admission is None  # write.buffer.max-memory=0 b, the default
    t2 = _kv_table(pkg, str(tmp_path), "db.on", {"write.buffer.max-memory": "64 kb", "write.buffer.stop-trigger": "0.5",
                                                 "write.buffer.block-timeout": "2 s",
                                                 "write.buffer.max-pending-flushes": "3"})
    tw = TABLE_WRITE[pkg](t2)
    c = tw.admission
    assert (c.max_memory, c.stop_trigger, c.block_timeout_ms, c.max_pending_flushes) == (65536, 0.5, 2000, 3)
    h = tw.health()
    assert h["state"] == "ok" and h["max_memory"] == 65536 and h["writers"] == {}


@pytest.mark.parametrize("pkg", PKGS)
def test_table_write_health_reports_the_admission_schema(tmp_path, pkg):
    t = _kv_table(pkg, str(tmp_path), "db.tw", {})
    ctrl = ADM[pkg].WriteBufferController(10_000, stop_trigger=0.5, block_timeout_ms=50)
    tw = TABLE_WRITE[pkg](t, buffer_controller=ctrl)
    try:
        tw.write(_kv_rows([1, 2]))
        h = tw.health()
        for key in ("state", "buffered_bytes", "pending_flushes", "backpressure_ms", "retry_after_ms",
                    "writes_throttled", "writes_rejected", "buffered_rows", "pending_flushes_writers"):
            assert key in h, key
        assert h["state"] == "ok" and h["buffered_rows"] == 2 and h["buffered_bytes"] == ctrl.in_use > 0
        (w,) = h["writers"].values()
        assert w == {"buffered_bytes": ctrl.in_use, "buffered_rows": 2, "pending_flushes": 0,
                     "reserved_bytes": ctrl.in_use}
    finally:
        tw.close()
    assert ctrl.in_use == 0


# ---------------------------------------------------------------------------
# the writer under admission
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_writer_throttles_through_its_offloaded_drain(tmp_path, pkg):
    """The first batch fills the memtable past the stop trigger and its
    flush is held on the worker; the next write throttles (it is seen
    waiting inside admission) until the held flush lands and releases,
    then buffers. Rows intact, the throttle counted, nothing left
    reserved."""
    before = _soak_counts(pkg)
    t = _kv_table(pkg, str(tmp_path), "db.thr", {"write-buffer-rows": "512"})
    ctrl = ADM[pkg].WriteBufferController(20 * 1024, stop_trigger=0.3, block_timeout_ms=60_000)
    ctrl._cond = _SignallingCondition()
    tw = TABLE_WRITE[pkg](t, buffer_controller=ctrl)
    go = _held_flushes(tw._writer((), 0))
    tw.write(_kv_rows(range(512)))  # admitted into the empty budget; its auto-flush is held on the worker
    assert ctrl.in_use > ctrl.health_dict()["stop_trigger_bytes"]
    second = threading.Thread(target=lambda: tw.write(_kv_rows(range(512, 700))))
    second.start()
    assert ctrl._cond.waiting.wait(30)  # the second write waits in admission
    assert ctrl.health_dict()["state"] == "throttling"
    go.set()
    second.join(30)
    assert not second.is_alive()
    _commit(t, tw)
    tw.close()
    assert _since(pkg, before) == (1, 0, 1)
    assert sorted(r[0] for r in _read(t)) == list(range(700))
    assert ctrl.in_use == 0 and ctrl.pending_flushes == 0


@pytest.mark.parametrize("pkg", PKGS)
def test_writer_rejects_on_deadline_then_recovers(tmp_path, pkg):
    """With the budget pinned over the trigger and a block timeout of 0, a
    write is rejected with nothing buffered and the sequence untouched, and
    is admitted again once the pressure lifts."""
    before = _soak_counts(pkg)
    ctrl = ADM[pkg].WriteBufferController(10_000, stop_trigger=0.5, block_timeout_ms=0)
    t = _kv_table(pkg, str(tmp_path), "db.rej", {"write-buffer-rows": "100000"})
    tw = TABLE_WRITE[pkg](t, buffer_controller=ctrl)
    ctrl.reserve(6_000)  # over the 5,000-byte trigger, held by another writer
    with pytest.raises(ADM[pkg].WriterBackpressureError):
        tw.write(_kv_rows(range(200)))
    (w,) = tw._writers.values()
    assert w.seq == 0 and w._buffered_rows == 0 and ctrl.in_use == 6_000
    assert _since(pkg, before)[1] == 1
    assert ctrl.health_dict()["state"] == "rejecting"
    ctrl.release(6_000)
    tw.write(_kv_rows(range(200)))
    _commit(t, tw)
    tw.close()
    assert _read(t) == [(k, float(k)) for k in range(200)]
    (e,) = t.store.new_scan().plan().entries
    assert (e.file.min_sequence_number, e.file.max_sequence_number) == (0, 199)
    assert ctrl.in_use == 0


@pytest.mark.parametrize("pkg", PKGS)
def test_close_releases_an_inflight_flush_exactly_once(tmp_path, pkg):
    """close() while an offloaded flush is held on the worker, with a
    partly filled memtable behind it: the worker returns the flushed
    batch's bytes and close the rest; together exactly what was reserved."""
    ctrl = ADM[pkg].WriteBufferController(1 << 20, block_timeout_ms=5000, max_pending_flushes=4)
    reserved, released = [], []
    real_reserve, real_try, real_release = ctrl.reserve, ctrl.try_reserve, ctrl.release

    def try_reserve(n):
        ok = real_try(n)
        if ok:
            reserved.append(n)
        return ok

    ctrl.try_reserve = try_reserve
    ctrl.reserve = lambda n: (real_reserve(n), reserved.append(n))[0]
    ctrl.release = lambda n: (released.append(n), real_release(n))[1]
    t = _kv_table(pkg, str(tmp_path), "db.close", {"write-buffer-rows": "64"})
    tw = TABLE_WRITE[pkg](t, buffer_controller=ctrl)
    w = tw._writer((), 0)
    go = _held_flushes(w)
    real_close = w.close
    w.close = lambda: (go.set(), real_close())[1]  # the flush is still held when close begins
    tw.write(_kv_rows(range(64)))  # the auto-flush, held on the worker
    tw.write(_kv_rows(range(64, 100)))  # a partly filled memtable
    assert ctrl.in_use == sum(reserved) > 0 and ctrl.pending_flushes == 1
    tw.close()
    assert ctrl.in_use == 0 and ctrl.pending_flushes == 0
    assert sum(released) == sum(reserved)
    tw.close()  # a second close releases nothing more
    assert sum(released) == sum(reserved) and ctrl.in_use == 0


@pytest.mark.parametrize("pkg", PKGS)
def test_flush_worker_error_raises_at_the_barrier(tmp_path, pkg):
    """A failing offloaded flush raises at prepare_commit and leaves no
    paimon-flush thread behind; its bytes are released."""
    ctrl = ADM[pkg].WriteBufferController(1 << 20)
    t = _kv_table(pkg, str(tmp_path), "db.fail", {"write-buffer-rows": "32"})
    tw = TABLE_WRITE[pkg](t, buffer_controller=ctrl)
    w = tw._writer((), 0)

    def broken(*a, **kw):
        raise OSError("disk gone")

    w.writer_factory.write = broken
    tw.write(_kv_rows(range(64)))  # auto-flush on the worker, which fails
    with pytest.raises(OSError, match="disk gone"):
        w.prepare_commit()
    assert not [th for th in threading.enumerate() if th.name.startswith("paimon-flush") and th.is_alive()]
    tw.close()
    assert ctrl.in_use == 0


def _gated_writer(tmp_path, ident, options):
    """A port TableWrite under admission whose writer resolves the debt
    gate to an adaptive compactor service that is not started (its admit
    and settle need no round), with the service and the controller."""
    from paimon_tpu_torch.table import compactor as tc

    ctrl = padm.WriteBufferController(1 << 20, max_pending_flushes=4)
    t = _kv_table("port", str(tmp_path), ident, {"write-only": "true", **options})
    svc = tc.AdaptiveCompactorService(t, policy=tc.AdaptiveCompactionPolicy(read_amp_ceiling=100))
    tw = PortTableWrite(t, buffer_controller=ctrl)
    w = tw._writer((), 0)
    w.debt_gate = lambda: svc
    return tw, w, svc, ctrl


def test_close_settles_a_queued_flush_that_never_ran(tmp_path):
    """An auto-flush queued behind a busy worker and cancelled by close()
    never runs: close gives back its debt-gate charge, its pending-flush
    slot, its bytes and its in-flight batch."""
    from concurrent.futures import ThreadPoolExecutor

    from paimon_tpu_torch.parallel.pipeline import FLUSH_THREAD_PREFIX

    tw, w, svc, ctrl = _gated_writer(tmp_path, "db.gate_close", {"write-buffer-rows": "64"})
    go, started, ran = threading.Event(), threading.Event(), []
    real_complete = w.flush_complete
    w.flush_complete = lambda state: (ran.append(state), real_complete(state))[1]
    w._flush_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix=FLUSH_THREAD_PREFIX)
    try:
        w._flush_pool.submit(lambda: (started.set(), go.wait()))  # the worker is busy until go
        assert started.wait(30)
        tw.write(_kv_rows(range(64)))  # its auto-flush is admitted and queued, not started
        assert svc._inflight == {((), 0): 1} and ctrl.pending_flushes == 1 and ctrl.in_use > 0
        real_shutdown = w._shutdown_flush_pool
        w._shutdown_flush_pool = lambda: (go.set(), real_shutdown())[1]  # the cancel comes first
        tw.close()
    finally:
        go.set()
    assert ran == []
    assert svc._inflight == {} and svc._runs == {}
    assert ctrl.pending_flushes == 0 and ctrl.in_use == 0
    assert w._inflight_delta == [] and w._flush_pending == []


def test_failed_dispatch_settles_the_debt_gate(tmp_path):
    """An input changelog write that fails after the gate admitted the
    flush settles the charge as not landed and returns the drained bytes
    before the error raises."""
    tw, w, svc, ctrl = _gated_writer(tmp_path, "db.gate_fail",
                                     {"write-buffer-rows": "100000", "changelog-producer": "input"})

    def broken(kv):
        raise OSError("changelog disk gone")

    w._write_changelog = broken
    tw.write(_kv_rows(range(64)))
    assert ctrl.in_use > 0
    with pytest.raises(OSError, match="changelog disk gone"):
        w.flush()
    assert svc._inflight == {} and svc._runs == {}
    assert ctrl.in_use == 0 and w._inflight_delta == [] and w._buffer == []
    tw.close()
    assert ctrl.in_use == 0


# ---------------------------------------------------------------------------
# the offloaded flush writes what the inline flush writes
# ---------------------------------------------------------------------------


def _entries(table) -> list[tuple]:
    """Each snapshot's kind and live files (level, rows, key range,
    sequence range, source)."""
    out = []
    sm = table.store.snapshot_manager
    for sid in range(1, sm.latest_snapshot_id() + 1):
        files = sorted((e.file.level, e.file.row_count, tuple(e.file.min_key), tuple(e.file.max_key),
                        e.file.min_sequence_number, e.file.max_sequence_number, e.file.file_source)
                       for e in table.store.new_scan().with_snapshot(sid).plan().entries)
        out.append((str(sm.snapshot(sid).commit_kind.value), files))
    return out


@pytest.mark.parametrize("prefetch", [None, "1"])
@pytest.mark.parametrize("pkg", PKGS)
def test_offloaded_flush_writes_the_inline_files(tmp_path, pkg, prefetch):
    """Three streaming commits of 900 rows, written 100 at a time through a
    256-row memtable, with compaction on: every snapshot's live files (level, rows, key range,
    sequence range, source) and the rows equal those of the inline flush
    (scan.prefetch-splits=0) of the same package and of the other
    package."""
    opts = {"write-buffer-rows": "256", "num-sorted-run.compaction-trigger": "3"}
    tables = {}
    for writer in PKGS:
        for p in (prefetch, "0"):
            o = dict(opts) if p is None else {**opts, "scan.prefetch-splits": p}
            t = _kv_table(writer, str(tmp_path), f"db.off_{writer}_{p}", o)
            rng = np.random.default_rng(5)
            wb = t.new_stream_write_builder()
            w = wb.new_write()
            for ident in range(1, 4):
                keys = rng.permutation(2000)[:900]
                for chunk in np.split(keys, 9):  # a flush every third write
                    w.write(_kv_rows(chunk, base=ident))
                wb.new_commit().commit_messages(ident, w.prepare_commit())
            w.close()
            tables[(writer, p)] = t
    want = _entries(tables[(pkg, "0")])
    assert len(want) >= 4  # APPEND and COMPACT snapshots
    assert _entries(tables[(pkg, prefetch)]) == want
    assert _entries(tables[(PKGS[PKGS.index(pkg) - 1], prefetch)]) == want
    rows = _read(tables[(pkg, "0")])
    assert _read(tables[(pkg, prefetch)]) == rows and len(rows) > 1000


# ---------------------------------------------------------------------------
# the spilling append buffer
# ---------------------------------------------------------------------------

DISK = {"jax": jdisk, "port": pdisk}


def _log_schema(pkg):
    m = _mod(pkg)
    return m.RowType.of(("a", m.BIGINT()), ("t", m.STRING()))


@pytest.mark.parametrize("pkg", PKGS)
def test_spillable_buffer_replays_in_order(tmp_path, pkg):
    batch_cls = jt.data.ColumnBatch if pkg == "jax" else tt.data.ColumnBatch
    io_mgr = DISK[pkg].IOManager(str(tmp_path / "spill"))
    buf = DISK[pkg].SpillableBuffer(io_mgr, in_memory_rows=100)
    for i in range(5):
        t = [None if j % 7 == 0 else f"x{i}-{j}" for j in range(60)]
        buf.add(batch_cls.from_pydict(_log_schema(pkg), {"a": list(range(i * 60, i * 60 + 60)), "t": t}))
    assert buf.num_rows == 300 and buf.spilled_bytes > 0
    got = [r for b in buf.batches() for r in b.to_pylist()]
    assert [r[0] for r in got] == list(range(300))
    assert [r[1] for r in got[:60]] == [None if j % 7 == 0 else f"x0-{j}" for j in range(60)]
    assert [b.num_rows for b in buf.batches()] == [120, 120, 60]
    buf.clear()
    assert buf.num_rows == 0
    io_mgr.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_spillable_buffer_spills_on_bytes(tmp_path, pkg):
    batch_cls = jt.data.ColumnBatch if pkg == "jax" else tt.data.ColumnBatch
    io_mgr = DISK[pkg].IOManager(str(tmp_path / "bspill"))
    buf = DISK[pkg].SpillableBuffer(io_mgr, in_memory_rows=10**9, in_memory_bytes=64 * 1024)
    wide = "x" * 4096
    for i in range(40):
        buf.add(batch_cls.from_pydict(_log_schema(pkg), {"a": [i], "t": [wide]}))
    assert buf.num_rows == 40 and buf.spilled_bytes > 0
    assert [r[0] for b in buf.batches() for r in b.to_pylist()] == list(range(40))
    io_mgr.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_spill_max_disk_gate(pkg):
    batch_cls = jt.data.ColumnBatch if pkg == "jax" else tt.data.ColumnBatch
    schema = _mod(pkg).RowType.of(("x", _mod(pkg).BIGINT()))
    buf = DISK[pkg].SpillableBuffer(DISK[pkg].IOManager(), in_memory_rows=1, max_disk_bytes=1)
    buf.add(batch_cls.from_pydict(schema, {"x": list(range(10))}))
    buf.add(batch_cls.from_pydict(schema, {"x": list(range(10))}))
    assert buf.disk_full
    before = len(buf._spilled)
    buf.add(batch_cls.from_pydict(schema, {"x": list(range(10))}))
    assert len(buf._spilled) == before  # no further spilling
    assert buf.num_rows == 30
    buf.clear()
    assert not buf.disk_full
    buf.io_manager.close()


SPILL_CASES = {
    "rows_cap": {"write-buffer-spillable": "true", "write-buffer-spill.rows": "50"},
    "for_append": {"write-buffer-for-append": "true", "write-buffer-spill.rows": "10",
                   "write-buffer-spill.max-disk-size": "100 mb"},
    "flush_on_rows": {"write-buffer-spillable": "true", "write-buffer-spill.rows": "45", "write-buffer-rows": "100"},
    "bytes_cap": {"write-buffer-spillable": "true", "write-buffer-spill.size": "2 kb"},
    "max_disk_gate": {"write-buffer-spillable": "true", "write-buffer-spill.rows": "30",
                      "write-buffer-spill.max-disk-size": "1 b"},
}


@pytest.mark.parametrize("case", list(SPILL_CASES))
def test_spilled_append_tables_equal_the_jax_package(tmp_path, case):
    """Append tables under the spill options, each package writing the same
    seeded batches in two commits: the same files (rows per file, in
    sequence order) and the same rows in the same order."""
    files, rows = {}, {}
    for pkg in PKGS:
        m = _mod(pkg)
        t = _catalog(pkg, str(tmp_path)).create_table(
            f"db.sp_{pkg}", m.RowType.of(("x", m.BIGINT()), ("s", m.STRING()), ("d", m.DOUBLE())),
            options={"bucket": "1", "write-only": "true", **SPILL_CASES[case]})
        rng = np.random.default_rng(17)
        for _ in range(2):
            wb = t.new_batch_write_builder()
            w = wb.new_write()
            for _ in range(6):
                n = int(rng.integers(5, 40))
                x = rng.integers(0, 10**6, n)
                w.write({"x": x, "s": [None if v % 5 == 0 else f"s{v}" for v in x], "d": x * 0.5})
            wb.new_commit().commit(w.prepare_commit())
            w.close()
        files[pkg] = [f.row_count for f in sorted(t.store.restore_files((), 0), key=lambda f: f.min_sequence_number)]
        rows[pkg] = _read(t)
    assert files["port"] == files["jax"] and len(files["port"]) > 2
    assert rows["port"] == rows["jax"]


def test_spilling_writer_reports_its_spilled_bytes(tmp_path):
    """The port's append writer counts the bytes of every segment it
    spilled (the chip smoke reads it); the spill directory is gone after
    the flush."""
    t = _catalog("port", str(tmp_path)).create_table(
        "db.sb", _log_schema("port"), options={"bucket": "1", "write-buffer-spillable": "true",
                                               "write-buffer-spill.rows": "50"})
    tw = t.new_batch_write_builder().new_write()
    for i in range(4):
        tw.write({"a": list(range(i * 40, i * 40 + 40)), "t": ["v"] * 40})
    (w,) = tw._writers.values()
    spill_dir = w._spill.io_manager.base
    assert w.spilled_bytes_total > 0 and spill_dir is not None
    t.new_batch_write_builder().new_commit().commit(tw.prepare_commit())
    assert not __import__("os").path.exists(spill_dir)
    assert sorted(r[0] for r in _read(t)) == list(range(160))
