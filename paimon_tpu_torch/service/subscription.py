"""The changelog subscription service: decode once, fan out to every
subscriber (port of paimon_tpu/service/subscription.py).

* SubscriptionHub: one per table and device in the process-wide registry
  (`SubscriptionHub.for_table`), or a private one built directly. It
  starts at the table's live frontier (scan.mode latest). One tailer
  thread (paimon-subtail-*) follows the snapshot chain through a
  StreamTableScan, polling with an exponential backoff, reads each new
  snapshot's splits once (changelog files under a changelog-producer, else
  the delta's merged rows) and hands the same ChangelogBatch to every
  subscriber's bounded queue; `sub{decode_reuse_hits}` counts the
  deliveries that reused it.

* Durable consumer ids: a subscriber's consumer file
  (table/consumer.py) is written before anything is read, so snapshot
  expiry keeps every snapshot from its position on. Progress is
  at-least-once: the file holds the last snapshot handed out, and a
  heartbeat thread (paimon-subhb-*) re-records it every
  subscription.heartbeat-interval, which keeps consumer.expiration-time
  from collecting a live reader.

* Flow control: each queue holds at most subscription.queue-depth
  batches, and all queued batches count against one
  WriteBufferController budget (subscription.buffer.max-memory). A
  subscriber that stays full past subscription.shed-timeout is shed with
  SubscriberShedError, which carries its restart offset; it resumes with
  `subscribe(consumer_id=...)` and loses nothing.

* Catch-up: a subscriber that starts behind the frontier replays the
  missing snapshots through its own StreamTableScan, reusing the hub's
  replay cache of decoded batches (subscription.replay-cache.max-memory)
  and the data-file cache.

The tailer's and the catch-up reads run on the table's device. Every hub
must be closed (`close()` or `SubscriptionHub.shutdown_all()`): its two
threads are not daemons.

`python -m paimon_tpu_torch.service.subscription --table PATH --consumer
ID --journal FILE [--device cuda|cpu]` runs a subscriber process that
journals every batch it receives (one JSON line, fsynced), as the JAX
package's does, so that a supervisor can kill it and check that the
respawned process resumes from its consumer id.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass

import numpy as np

from ..core.admission import WriteBufferController, WriterBackpressureError
from ..data.batch import ColumnBatch, concat_batches
from ..metrics import sub_metrics
from ..options import CoreOptions
from ..table.consumer import ConsumerManager
from ..table.stream import StreamTableScan
from ..types import RowKind
from ..utils.cache import data_file_cache
from .shed import ShedError, ShedInfo

__all__ = [
    "ChangelogBatch",
    "SubscriberShedError",
    "Subscription",
    "SubscriptionHub",
    "fold_changelog",
]


class SubscriberShedError(ShedError):
    """The hub shed this subscriber: its queue stayed full, or the shared
    buffer budget stayed exhausted, past subscription.shed-timeout. The
    ShedInfo (kind "subscribe") carries `consumer_id` and `next_snapshot`,
    the restart offset that `subscribe(consumer_id=...)` resumes from."""

    default_kind = "subscribe"

    def __init__(self, payload: "dict | ShedInfo"):
        super().__init__(payload, message=f"subscriber shed: {payload}")
        self.consumer_id = self.payload.get("consumer_id")
        self.next_snapshot = self.payload.get("next_snapshot")


@dataclass(frozen=True)
class ChangelogBatch:
    """One snapshot's change stream: its rows and their RowKinds. The same
    object goes to every subscriber, which must not mutate it."""

    snapshot_id: int
    data: ColumnBatch
    kinds: np.ndarray  # uint8 RowKind per row
    is_catchup: bool = False

    @property
    def num_rows(self) -> int:
        return self.data.num_rows

    def byte_size(self) -> int:
        """The bytes the batch holds: its columns' arrays (ColumnBatch
        byte_size) and the kinds."""
        return int(self.data.byte_size()) + int(self.kinds.nbytes)

    def events(self) -> list[tuple]:
        """[(kind short string, *row), ...]."""
        return [(RowKind(int(k)).short_string, *row) for row, k in zip(self.data.to_pylist(), self.kinds.tolist())]


def fold_changelog(state: dict, batch: ChangelogBatch, key_fields: list[str]) -> dict:
    """Fold one batch into {key tuple: row tuple}: +I and +U upsert, -D
    deletes, -U is skipped (its +U follows). Folded to a checkpoint, it
    equals the table read at that snapshot."""
    names = batch.data.schema.field_names
    key_idx = [names.index(k) for k in key_fields]
    for row, kind in zip(batch.data.to_pylist(), batch.kinds.tolist()):
        key = tuple(row[i] for i in key_idx)
        if kind in (RowKind.INSERT, RowKind.UPDATE_AFTER):
            state[key] = tuple(row)
        elif kind == RowKind.DELETE:
            state.pop(key, None)
    return state


class _SubscriberState:
    """The hub's view of one consumer: its bounded queue, shed latch and
    position. `expected_next` is the next snapshot not yet handed out;
    `progress` the last one handed out (-1 before the first), which is the
    durable at-least-once position."""

    def __init__(self, consumer_id: str, start: int, catch_up_until: int):
        self.consumer_id = consumer_id
        self.start = start
        self.catch_up_until = catch_up_until
        self.cond = threading.Condition()
        self.queue: deque[ChangelogBatch] = deque()
        self.reserved_bytes = 0
        self.shed_payload: dict | None = None
        self.closed = False
        self.expected_next = start
        self.progress = -1
        self.queue_high_water = 0
        # set when the queue first fills, cleared once the consumer drains
        # it to half depth: the shed clock runs over the whole window, or a
        # consumer freeing one slot per offer would pace the tailer forever
        self.pressure_since: float | None = None

    @property
    def durable_position(self) -> int:
        """Where a resume must replay from: the last snapshot handed out,
        or the start before the first."""
        return self.progress if self.progress >= 0 else self.start

    def restart_offset(self) -> int:
        """The first snapshot a shed subscriber still needs."""
        with self.cond:
            return self.queue[0].snapshot_id if self.queue else self.expected_next


class Subscription:
    """One consumer's handle, an iterator of ChangelogBatch in snapshot
    order. `poll(timeout)` gives the next batch or None on timeout (and
    always None after close()), and raises SubscriberShedError once the hub
    has shed it. `checkpoint` is the next snapshot not handed out: the fold
    of everything received equals the table at checkpoint - 1."""

    def __init__(self, hub: "SubscriptionHub", st: _SubscriberState, scan: StreamTableScan):
        self._hub = hub
        self._st = st
        self._scan = scan  # the subscriber's own, for catch-up
        self._pending: tuple[int, list] | None = None  # (snapshot, splits) to read again
        self._read = hub.table.new_read_builder().new_read()

    @property
    def consumer_id(self) -> str:
        return self._st.consumer_id

    @property
    def checkpoint(self) -> int:
        return self._st.expected_next

    @property
    def is_shed(self) -> bool:
        return self._st.shed_payload is not None

    # ---- consuming -----------------------------------------------------
    def poll(self, timeout: float | None = None) -> ChangelogBatch | None:
        st = self._st
        if st.shed_payload is not None:
            raise SubscriberShedError(st.shed_payload)
        if st.closed:
            return None
        # catch-up: replay [start, catch_up_until) through the caches
        while st.expected_next < st.catch_up_until:
            batch = self._catchup_next()
            if batch is not None:
                self._handed(batch)
                return batch
        # live: the tailer fills the queue
        deadline = None if timeout is None else time.monotonic() + timeout
        with st.cond:
            while not st.queue:
                if st.shed_payload is not None:
                    raise SubscriberShedError(st.shed_payload)
                if st.closed:
                    return None
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None
                st.cond.wait(remaining if remaining is not None else 0.5)
            batch = st.queue.popleft()
            nbytes = batch.byte_size()
            st.reserved_bytes = max(0, st.reserved_bytes - nbytes)
            if st.pressure_since is not None and len(st.queue) <= self._hub.queue_depth // 2:
                st.pressure_since = None
            st.cond.notify_all()
        if self._hub.controller is not None:
            self._hub.controller.release(nbytes)
        if batch.snapshot_id < st.expected_next:
            return self.poll(timeout)  # a replayed enqueue never regresses the fold
        self._handed(batch)
        return batch

    def _handed(self, batch: ChangelogBatch) -> None:
        self._st.progress = batch.snapshot_id
        self._st.expected_next = batch.snapshot_id + 1

    def _catchup_next(self) -> ChangelogBatch | None:
        """The next catch-up batch, or None when that snapshot was empty or
        the chain ended (the position advanced either way). A failed read
        keeps the snapshot's splits pending for the next poll."""
        st = self._st
        g = sub_metrics()
        if self._pending is None:
            cached = self._hub._replay_get(st.expected_next)
            if cached is not None:
                # the tailer or an earlier catch-up decoded this snapshot
                self._scan.restore(cached.snapshot_id + 1)
                if cached.num_rows == 0:
                    st.expected_next = min(cached.snapshot_id + 1, st.catch_up_until)
                    return None
                g.counter("batches_fanned").inc()
                g.counter("rows_fanned").inc(cached.num_rows)
                g.counter("decode_reuse_hits").inc()
                return ChangelogBatch(cached.snapshot_id, cached.data, cached.kinds, is_catchup=True)
            splits = self._scan.plan()
            if splits is None:
                st.expected_next = st.catch_up_until  # the chain is shorter: go live
                return None
            if not splits:
                st.expected_next = min(self._scan._next, st.catch_up_until)
                return None
            self._pending = (splits[0].snapshot_id, splits)
        sid, splits = self._pending
        cache = data_file_cache()
        reused = all(cache.contains_file(f.file_name) for s in splits for f in s.files)
        parts = [self._read.read_with_kinds(s) for s in splits]
        self._pending = None
        batch = _concat_parts(sid, parts, is_catchup=True)
        self._hub._replay_put(batch)
        g.counter("batches_fanned").inc()
        g.counter("rows_fanned").inc(batch.num_rows)
        if reused:
            g.counter("decode_reuse_hits").inc()
        if batch.num_rows == 0:
            st.expected_next = min(sid + 1, st.catch_up_until)
            return None
        return batch

    def __iter__(self):
        return self

    def __next__(self) -> ChangelogBatch:
        while True:
            b = self.poll(timeout=None)
            if b is not None:
                return b
            if self._st.closed:
                raise StopIteration

    # ---- lifecycle -----------------------------------------------------
    def close(self, delete_consumer: bool = False) -> None:
        """Detach from the hub. The consumer file stays (the resume
        token) unless delete_consumer, which also drops the expiry pin."""
        self._hub._detach(self._st, delete_consumer=delete_consumer)


def _concat_parts(sid: int, parts: list[tuple], is_catchup: bool = False) -> ChangelogBatch:
    datas = [p[0] for p in parts]
    kinds = [p[1] for p in parts]
    data = datas[0] if len(datas) == 1 else concat_batches(datas)
    kind = kinds[0] if len(kinds) == 1 else np.concatenate(kinds)
    return ChangelogBatch(sid, data, kind, is_catchup=is_catchup)


class SubscriptionHub:
    """One tailer, N subscribers, for one table on one device."""

    _hubs: dict[tuple, "SubscriptionHub"] = {}
    _hubs_lock = threading.Lock()

    @staticmethod
    def _key(table) -> tuple:
        # a CPU and a CUDA view of one path read on different devices
        return (table.store.table_path, str(table.device))

    @classmethod
    def for_table(cls, table) -> "SubscriptionHub":
        key = cls._key(table)
        with cls._hubs_lock:
            hub = cls._hubs.get(key)
            if hub is None or hub._stop.is_set():
                hub = cls._hubs[key] = SubscriptionHub(table)
            return hub

    @classmethod
    def shutdown_all(cls) -> None:
        with cls._hubs_lock:
            hubs = list(cls._hubs.values())
            cls._hubs.clear()
        for hub in hubs:
            hub.close()

    def __init__(self, table):
        self.table = table
        o = table.options.options
        self.queue_depth = int(o.get(CoreOptions.SUBSCRIPTION_QUEUE_DEPTH))
        self.poll_backoff_ms = int(o.get(CoreOptions.SUBSCRIPTION_POLL_BACKOFF))
        self.shed_timeout_ms = int(o.get(CoreOptions.SUBSCRIPTION_SHED_TIMEOUT))
        self.heartbeat_ms = int(o.get(CoreOptions.SUBSCRIPTION_HEARTBEAT_INTERVAL))
        self.max_subscribers = int(o.get(CoreOptions.SUBSCRIPTION_MAX_SUBSCRIBERS))
        self.backoff_cap_ms = int(o.get(CoreOptions.CONTINUOUS_DISCOVERY_INTERVAL) or 10_000)
        budget = int(o.get(CoreOptions.SUBSCRIPTION_BUFFER_MAX_MEMORY))
        # the writers' admission controller as the fan-out byte budget: an
        # offer blocks at most shed-timeout, then sheds that subscriber
        self.controller = (
            WriteBufferController(budget, stop_trigger=1.0, block_timeout_ms=self.shed_timeout_ms,
                                  max_pending_flushes=0)
            if budget > 0
            else None
        )
        # through the store's retrying FileIO
        self.consumers = ConsumerManager(table.store.file_io, table.path)
        # decoded batches by snapshot id (byte-budgeted, oldest out first):
        # a late joiner's catch-up and a shed consumer's resume reuse them
        self._replay: dict[int, ChangelogBatch] = {}
        self._replay_order: deque[int] = deque()
        self._replay_bytes = 0
        self._replay_budget = int(o.get(CoreOptions.SUBSCRIPTION_REPLAY_CACHE_MAX_MEMORY))
        self._replay_lock = threading.Lock()
        self._cond = threading.Condition()
        self._subs: dict[str, _SubscriberState] = {}
        self._frontier: int | None = None
        self._inflight_sid: int | None = None  # a fan-out in progress
        self._stop = threading.Event()
        self._tailer: threading.Thread | None = None
        self._heartbeat: threading.Thread | None = None
        self._read = table.new_read_builder().new_read()
        self._scan: StreamTableScan | None = None

    # ---- replay cache ---------------------------------------------------
    def _replay_get(self, sid: int) -> ChangelogBatch | None:
        with self._replay_lock:
            return self._replay.get(sid)

    def _replay_put(self, batch: ChangelogBatch) -> None:
        nbytes = batch.byte_size()
        if self._replay_budget <= 0 or nbytes > self._replay_budget:
            return
        with self._replay_lock:
            if batch.snapshot_id in self._replay:
                return
            self._replay[batch.snapshot_id] = batch
            self._replay_order.append(batch.snapshot_id)
            self._replay_bytes += nbytes
            while self._replay_bytes > self._replay_budget and self._replay_order:
                old = self._replay.pop(self._replay_order.popleft(), None)
                if old is not None:
                    self._replay_bytes -= old.byte_size()

    # ---- lifecycle -----------------------------------------------------
    def _ensure_started(self) -> None:
        """Called under self._cond."""
        if self._tailer is not None:
            return
        latest = self.table.store.snapshot_manager.latest_snapshot_id()
        self._frontier = (latest + 1) if latest is not None else 1
        self._scan = StreamTableScan(self.table.copy({"scan.mode": "latest"}))
        self._scan.restore(self._frontier)
        name = self.table.name or "table"
        self._tailer = threading.Thread(target=self._tail_loop, name=f"paimon-subtail-{name}", daemon=False)
        self._heartbeat = threading.Thread(target=self._heartbeat_loop, name=f"paimon-subhb-{name}", daemon=False)
        self._tailer.start()
        self._heartbeat.start()

    def close(self) -> None:
        """Stop the tailer and the heartbeat and detach every subscriber."""
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
            subs = list(self._subs.values())
        for st in subs:
            self._detach(st)
        for t in (self._tailer, self._heartbeat):
            if t is not None:
                t.join(timeout=30.0)
        key = self._key(self.table)
        with SubscriptionHub._hubs_lock:
            if SubscriptionHub._hubs.get(key) is self:
                del SubscriptionHub._hubs[key]

    def health_dict(self) -> dict:
        with self._cond:
            subs = list(self._subs.values())
            frontier = self._frontier
        lag = max((frontier - st.expected_next for st in subs), default=0) if frontier else 0
        full = len(subs) >= self.max_subscribers
        out = {
            "state": "busy-subscribers" if full else "ok",
            "subscribers": len(subs),
            "frontier": frontier,
            "lag_snapshots": int(lag),
            "retry_after_ms": max(1, self.shed_timeout_ms // 2) if full else 0,
        }
        if self.controller is not None:
            out["buffered_bytes"] = self.controller.in_use
        return out

    # ---- subscribing ---------------------------------------------------
    def subscribe(self, consumer_id: str | None = None, from_snapshot: int | None = None) -> Subscription:
        """Register a subscriber. It starts at the consumer id's saved
        position (a resume), else at `from_snapshot`, else at the live
        frontier (new changes only). Its consumer file is written before
        anything is read, so expiry pins the whole replay from the moment
        this returns."""
        with self._cond:
            if self._stop.is_set():
                # a close() raced us: a typed shed, never a subscriber on a
                # hub whose tailer has gone
                raise SubscriberShedError(
                    ShedInfo(kind="subscribe", state="shutting-down",
                             retry_after_ms=max(1, self.shed_timeout_ms // 2),
                             extras={"consumer_id": consumer_id})
                )
            if len(self._subs) >= self.max_subscribers:
                sub_metrics().counter("shed_subscribers").inc()
                raise SubscriberShedError({
                    "state": "busy-subscribers",
                    "consumer_id": consumer_id,
                    "next_snapshot": None,
                    "subscribers": len(self._subs),
                    "retry_after_ms": max(1, self.shed_timeout_ms // 2),
                })
            self._ensure_started()
            cid = consumer_id or f"sub-{uuid.uuid4().hex[:12]}"
            saved = self.consumers.consumer(cid) if consumer_id else None
            if saved is not None:
                start = saved
            elif from_snapshot is not None:
                start = from_snapshot
            else:
                start = self._frontier
            self.consumers.record(cid, start)
            catch_up_until = self._frontier
            if self._inflight_sid is not None:
                # a fan-out that started without us: replay its snapshot
                catch_up_until = max(catch_up_until, self._inflight_sid + 1)
            old = self._subs.get(cid)
            st = _SubscriberState(cid, start, catch_up_until)
            self._subs[cid] = st
            self._cond.notify_all()
            sub_metrics().gauge("subscribers").set(len(self._subs))
        if old is not None:
            # the consumer id was taken over: the old handle closes
            with old.cond:
                old.closed = True
                old.cond.notify_all()
            self._release_queue(old)
        scan = StreamTableScan(self.table.copy({"scan.mode": "latest"}))
        scan.restore(start)
        return Subscription(self, st, scan)

    def _detach(self, st: _SubscriberState, delete_consumer: bool = False) -> None:
        with self._cond:
            if self._subs.get(st.consumer_id) is st:
                del self._subs[st.consumer_id]
            sub_metrics().gauge("subscribers").set(len(self._subs))
        with st.cond:
            st.closed = True
            st.cond.notify_all()
        self._release_queue(st)
        try:
            if delete_consumer:
                self.consumers.delete(st.consumer_id)
            else:
                self.consumers.record(st.consumer_id, st.durable_position)
        except OSError:
            pass  # the heartbeat recorded a position already

    def _release_queue(self, st: _SubscriberState) -> None:
        with st.cond:
            st.queue.clear()
            reserved, st.reserved_bytes = st.reserved_bytes, 0
            st.cond.notify_all()
        if reserved and self.controller is not None:
            self.controller.release(reserved)

    # ---- shedding ------------------------------------------------------
    def _shed(self, st: _SubscriberState, reason: str) -> None:
        restart = st.restart_offset()
        payload = {
            "state": reason,
            "consumer_id": st.consumer_id,
            "next_snapshot": min(restart, st.durable_position if st.progress >= 0 else restart),
            "retry_after_ms": max(1, self.shed_timeout_ms // 2),
        }
        with self._cond:
            if self._subs.get(st.consumer_id) is st:
                del self._subs[st.consumer_id]
            sub_metrics().counter("shed_subscribers").inc()
            sub_metrics().gauge("subscribers").set(len(self._subs))
        try:
            self.consumers.record(st.consumer_id, payload["next_snapshot"])  # the resume replays from here
        except OSError:
            pass
        with st.cond:
            st.shed_payload = payload
            st.cond.notify_all()
        self._release_queue(st)

    # ---- the tailer ----------------------------------------------------
    def _tail_loop(self) -> None:
        backoff_ms = self.poll_backoff_ms
        while not self._stop.is_set():
            with self._cond:
                if not self._subs:
                    self._cond.wait(0.5)  # no subscribers: no planning
                    continue
            try:
                splits = self._scan.plan()
            except Exception:  # noqa: BLE001 - plan() keeps its position: plan again
                splits = None
            if splits is None:
                # nothing new (or a failed plan): back off
                if self._stop.wait(backoff_ms / 1000.0):
                    return
                backoff_ms = min(backoff_ms * 2, self.backoff_cap_ms)
                continue
            backoff_ms = self.poll_backoff_ms
            if not splits:
                # a snapshot without changes (a compaction): the frontier moves
                with self._cond:
                    self._frontier = self._scan._next
                continue
            sid = splits[0].snapshot_id
            batch = None
            while batch is None and not self._stop.is_set():
                try:
                    batch = _concat_parts(sid, [self._read.read_with_kinds(s) for s in splits])
                except Exception:  # noqa: BLE001 - data files are immutable: read again
                    if self._stop.wait(min(backoff_ms, 100) / 1000.0):
                        return
            if batch is None:
                return
            self._replay_put(batch)
            with self._cond:
                self._inflight_sid = sid
                subs = list(self._subs.values())
            g = sub_metrics()
            if batch.num_rows:
                fanned = sum(1 for st in subs if self._offer(st, batch))
                g.counter("batches_fanned").inc(fanned)
                g.counter("rows_fanned").inc(batch.num_rows * fanned)
                if fanned > 1:
                    g.counter("decode_reuse_hits").inc(fanned - 1)
            with self._cond:
                self._inflight_sid = None
                self._frontier = sid + 1
                lag = max((self._frontier - s.expected_next for s in self._subs.values()), default=0)
            g.gauge("lag_snapshots").set(int(lag))

    def _offer(self, st: _SubscriberState, batch: ChangelogBatch) -> bool:
        """Queue the batch for one subscriber, waiting at most shed-timeout
        for room (and for the byte budget), then shed that subscriber: the
        tailer and the other subscribers never wait on the slowest."""
        if batch.snapshot_id < st.catch_up_until:
            return False  # the subscriber replays this one itself
        with st.cond:
            if len(st.queue) >= self.queue_depth and st.pressure_since is None:
                st.pressure_since = time.monotonic()
            while len(st.queue) >= self.queue_depth:
                if st.shed_payload is not None or st.closed:
                    return False
                remaining = st.pressure_since + self.shed_timeout_ms / 1000.0 - time.monotonic()
                if remaining <= 0:
                    break
                st.cond.wait(min(remaining, 0.1))
            if st.shed_payload is not None or st.closed:
                return False
            still_full = len(st.queue) >= self.queue_depth
        if still_full:
            # outside st.cond: _shed takes the hub's lock first, as _detach does
            self._shed(st, "queue-full")
            return False
        nbytes = batch.byte_size()
        if self.controller is not None:
            try:
                self.controller.reserve(nbytes)
            except WriterBackpressureError:
                self._shed(st, "buffer-exhausted")
                return False
        with st.cond:
            if st.shed_payload is not None or st.closed:
                if self.controller is not None:
                    self.controller.release(nbytes)
                return False
            st.queue.append(batch)
            st.reserved_bytes += nbytes
            st.queue_high_water = max(st.queue_high_water, len(st.queue))
            st.cond.notify_all()
        hw = sub_metrics().gauge("queue_high_water")
        if st.queue_high_water > hw.value:
            hw.set(st.queue_high_water)
        return True

    # ---- heartbeat -----------------------------------------------------
    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_ms / 1000.0):
            with self._cond:
                subs = list(self._subs.values())
            for st in subs:
                try:
                    # refreshes the file's mtime and advances the position
                    self.consumers.record(st.consumer_id, st.durable_position)
                except OSError:
                    pass  # the next beat tries again


# ---------------------------------------------------------------------------
# the subscriber process
# ---------------------------------------------------------------------------


def _run_subscriber_process(argv: list[str] | None = None) -> int:
    """A subscriber in its own process, journaling each batch it receives
    as one JSON line, fsynced ({"sid", "rows", "kinds"}; a shed as
    {"shed": payload}, the end as {"done": true, "checkpoint": n}). Killed
    and started again with the same consumer id, it resumes from the
    durable position: the journal folded by snapshot id equals the table
    at its checkpoint."""
    import argparse
    import json

    from ..resilience.faults import crash_point
    from ..table import load_table

    ap = argparse.ArgumentParser(description="paimon_tpu_torch subscriber process")
    ap.add_argument("--table", required=True, help="table path (any registered scheme)")
    ap.add_argument("--consumer", required=True)
    ap.add_argument("--journal", required=True)
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--from-snapshot", type=int, default=1)
    ap.add_argument("--slow-ms", type=float, default=0.0, help="sleep per batch (slow-consumer modeling)")
    ap.add_argument("--idle-exit", type=float, default=2.0, help="exit after deadline once idle this long")
    ap.add_argument("--format", default=None, dest="cdc_format",
                    help="CDC wire format: each batch is encoded to this format and parsed back before journaling")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device of the merge kernels (default cuda)")
    args = ap.parse_args(argv)

    if args.table.startswith(("fail:", "fail-s3", "latency:", "traceable:", "chaos:")):
        # the fault-injecting schemes register on import
        from ..fs import testing as _testing  # noqa: F401

    table = load_table(args.table, commit_user=f"subscriber-{args.consumer}", device=args.device)
    hub = SubscriptionHub(table)
    sub = hub.subscribe(consumer_id=args.consumer, from_snapshot=args.from_snapshot)
    deadline = time.monotonic() + args.duration
    last_batch = time.monotonic()
    jf = open(args.journal, "a", encoding="utf-8")

    def journal(obj: dict) -> None:
        jf.write(json.dumps(obj) + "\n")
        jf.flush()
        os.fsync(jf.fileno())

    try:
        while True:
            now = time.monotonic()
            if now >= deadline and (now - last_batch) >= args.idle_exit:
                break
            try:
                batch = sub.poll(timeout=0.25)
            except SubscriberShedError as exc:
                journal({"shed": exc.payload})
                sub = hub.subscribe(consumer_id=args.consumer)
                continue
            if batch is None:
                continue
            rows, kinds = batch.data.to_pylist(), batch.kinds.tolist()
            if args.cdc_format:
                # the journal holds what a reader of this format decodes
                from ..table.cdc_format import encode_changelog, get_cdc_parser

                names = batch.data.schema.field_names
                parse = get_cdc_parser(args.cdc_format)
                decoded = [rec for m in encode_changelog(batch.data, batch.kinds, args.cdc_format)
                           for rec in parse(m)]
                rows = [[rec.get(n) for n in names] for rec in decoded]
                kinds = [int(RowKind.from_short_string(rec.kind)) for rec in decoded]
            journal({"sid": batch.snapshot_id, "rows": rows, "kinds": kinds})
            # after the fsync, before advancing: a respawn replays from the
            # durable position and the journal's fold absorbs the replay
            crash_point("subscriber:batch-journaled")
            last_batch = time.monotonic()
            if args.slow_ms > 0:
                time.sleep(args.slow_ms / 1000.0)
        journal({"done": True, "checkpoint": sub.checkpoint - 1})
        return 0
    finally:
        jf.close()
        sub.close()
        hub.close()


if __name__ == "__main__":
    raise SystemExit(_run_subscriber_process())
