"""Streaming scans: a starting plan, then one plan per new snapshot (port
of paimon_tpu/table/stream.py).

The first plan follows scan.mode (StartupMode): latest-full and
compacted-full read the latest snapshot whole (compacted-full only its
top level) and go on after it; latest starts after it; from-snapshot
starts at scan.snapshot-id; from-snapshot-full reads that snapshot whole
and goes on after it; from-timestamp starts after the last snapshot at or
before scan.timestamp-millis. default is latest-full, or from-snapshot
when scan.snapshot-id is set. A consumer's saved position (consumer-id,
unless consumer.ignore-progress) wins over the startup mode.

Each later plan reads one snapshot: its delta files (APPEND snapshots
only) under changelog-producer=none; its changelog files on APPEND
snapshots under input and lookup, on COMPACT snapshots under
full-compaction; an OVERWRITE's new files only under
streaming-read-overwrite; and under stream-scan-mode=file-monitor every
snapshot's delta files, compactions included. A snapshot that gives no
split plans as []; None means nothing new (or the end of a bounded
stream: scan.bounded.watermark ends it once a snapshot's watermark passes
the bound, the first plan included).

checkpoint() returns the next snapshot to read and remembers it;
notify_checkpoint_complete() records it as the consumer's position
(consumer.mode=exactly-once); under at-least-once every plan records the
snapshot it planned.
"""

from __future__ import annotations

import time
from typing import TYPE_CHECKING

from ..core.levels import IntervalPartition
from ..core.snapshot import CommitKind, Snapshot
from ..data.predicate import Predicate
from ..options import ChangelogProducer, CoreOptions, StartupMode
from ..utils import now_millis, partition_sort_key
from .consumer import ConsumerManager
from .read import DataSplit

if TYPE_CHECKING:
    from . import FileStoreTable

__all__ = ["StreamTableScan"]


class StreamTableScan:
    def __init__(self, table: "FileStoreTable", predicate: Predicate | None = None):
        self.table = table
        self.predicate = predicate
        self.store = table.store
        opts = self.store.options.options
        self.mode: StartupMode = opts.get(CoreOptions.SCAN_MODE)
        read_mode = opts.get(CoreOptions.STREAMING_READ_MODE)
        if read_mode != "file":
            raise ValueError(
                f"streaming-read-mode={read_mode!r}: only 'file' is supported "
                "('log' needs an external log system, which is out of scope)"
            )
        self.scan_mode = opts.get(CoreOptions.STREAM_SCAN_MODE)
        if self.scan_mode not in ("none", "file-monitor"):
            raise ValueError(f"unknown stream-scan-mode {self.scan_mode!r}")
        self.consumer_mode = opts.get(CoreOptions.CONSUMER_MODE)
        if self.consumer_mode not in ("exactly-once", "at-least-once"):
            raise ValueError(f"unknown consumer.mode {self.consumer_mode!r}")
        self.consumer_id = opts.get(CoreOptions.CONSUMER_ID)
        self.consumers = ConsumerManager(self.store.file_io, table.path)
        self._next: int | None = None  # the next snapshot to read
        self._started = False
        self._ended = False
        self._last_checkpoint: int | None = None
        self._last_watermark: int | None = None
        self._last_emit_monotonic: float | None = None
        if self.consumer_id and not opts.get(CoreOptions.CONSUMER_IGNORE_PROGRESS):
            saved = self.consumers.consumer(self.consumer_id)
            if saved is not None:
                self._next = saved
                self._started = True

    # ---- checkpoints ---------------------------------------------------
    def checkpoint(self) -> int | None:
        """The next snapshot to read (the restore token), remembered for
        notify_checkpoint_complete, so that the consumer never records a
        position past what was checkpointed."""
        self._last_checkpoint = self._next
        return self._next

    def restore(self, next_snapshot: int | None) -> None:
        self._next = next_snapshot
        self._started = next_snapshot is not None
        self._ended = False

    def notify_checkpoint_complete(self) -> None:
        if self.consumer_id and self._last_checkpoint is not None:
            self.consumers.record(self.consumer_id, self._last_checkpoint)

    # ---- planning ------------------------------------------------------
    def plan_aligned(self, timeout_seconds: float = 60.0, poll_seconds: float | None = None) -> list[DataSplit] | None:
        """plan() until it returns splits, polling every poll_seconds
        (continuous.discovery-interval by default); None once
        timeout_seconds have passed."""
        if poll_seconds is None:
            poll_seconds = (self.store.options.options.get(CoreOptions.CONTINUOUS_DISCOVERY_INTERVAL) or 10_000) / 1000
        deadline = time.monotonic() + timeout_seconds
        while True:
            splits = self.plan()
            if splits is not None:
                return splits
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            time.sleep(min(poll_seconds, remaining))

    def current_watermark(self) -> int | None:
        """The last planned snapshot's watermark; once no snapshot has been
        planned for snapshot.watermark-idle-timeout, the later of it and
        the wall clock."""
        wm = self._last_watermark
        idle_ms = self.store.options.options.get(CoreOptions.SNAPSHOT_WATERMARK_IDLE_TIMEOUT)
        if idle_ms is None:
            return wm
        last = self._last_emit_monotonic
        if last is None or (time.monotonic() - last) * 1000 >= idle_ms:
            now = now_millis()
            return now if wm is None else max(wm, now)
        return wm

    def _past_bound(self, snap: Snapshot | None) -> bool:
        bound = self.store.options.options.get(CoreOptions.SCAN_BOUNDED_WATERMARK)
        if bound is None or snap is None or snap.watermark is None:
            return False
        return snap.watermark > bound

    @property
    def ended(self) -> bool:
        return self._ended

    def plan(self) -> list[DataSplit] | None:
        """The starting plan on the first call, then one snapshot's splits
        a call; None when nothing is new or the stream has ended."""
        sm = self.store.snapshot_manager
        if self._ended:
            return None
        if not self._started:
            if self._past_bound(sm.latest_snapshot()):
                self._ended = True
                return None
            self._started = True
            splits = self._starting_plan()
            if splits is not None:
                return splits
        latest = sm.latest_snapshot_id()
        if latest is None or self._next is None or self._next > latest:
            return None
        snap = sm.snapshot(self._next)
        if self._past_bound(snap):
            self._ended = True
            return None
        planned = self._next
        splits = self._delta_splits(snap)
        self._next += 1
        self._last_watermark = snap.watermark
        self._last_emit_monotonic = time.monotonic()
        if self.consumer_id and self.consumer_mode == "at-least-once":
            # the planned snapshot, not the next: a crash before it is
            # processed replays it, and expiry keeps it meanwhile
            self.consumers.record(self.consumer_id, planned)
        return splits

    def _starting_plan(self) -> list[DataSplit] | None:
        sm = self.store.snapshot_manager
        opts = self.store.options.options
        latest = sm.latest_snapshot_id()
        mode = self.mode
        if mode == StartupMode.DEFAULT:
            mode = StartupMode.LATEST_FULL if opts.get(CoreOptions.SCAN_SNAPSHOT_ID) is None else StartupMode.FROM_SNAPSHOT
        if mode in (StartupMode.LATEST_FULL, StartupMode.COMPACTED_FULL):
            if latest is None:
                self._next = 1
                return None
            self._next = latest + 1
            return self._full_splits(latest, compacted=mode == StartupMode.COMPACTED_FULL)
        if mode == StartupMode.LATEST:
            self._next = (latest + 1) if latest is not None else 1
            return None
        if mode == StartupMode.FROM_SNAPSHOT:
            self._next = opts.get(CoreOptions.SCAN_SNAPSHOT_ID) or 1
            return None
        if mode == StartupMode.FROM_SNAPSHOT_FULL:
            sid = opts.get(CoreOptions.SCAN_SNAPSHOT_ID) or latest
            if sid is None:
                self._next = 1
                return None
            self._next = sid + 1
            return self._full_splits(sid)
        if mode == StartupMode.FROM_TIMESTAMP:
            snap = sm.earlier_or_equal_time_millis(opts.get(CoreOptions.SCAN_TIMESTAMP_MILLIS) or 0)
            self._next = (snap.id + 1) if snap else (sm.earliest_snapshot_id() or 1)
            return None
        raise ValueError(f"unsupported startup mode {mode}")

    def _full_splits(self, snapshot_id: int, compacted: bool = False) -> list[DataSplit]:
        """One split per bucket of the snapshot's live files (compacted:
        only the top level's)."""
        scan = self.store.new_scan().with_snapshot(snapshot_id)
        if compacted:
            scan = scan.with_level(self.store.options.num_levels - 1)
        plan = scan.plan()
        return [
            DataSplit(
                partition=partition,
                bucket=bucket,
                files=files,
                snapshot_id=snapshot_id,
                raw_convertible=all(len(s) == 1 for s in IntervalPartition(files).partition()),
                dv_index_file=plan.dv_index_for(partition, bucket),
            )
            for partition, buckets in sorted(plan.grouped().items(), key=lambda kv: partition_sort_key(kv[0]))
            for bucket, files in sorted(buckets.items())
        ]

    def _delta_splits(self, snap: Snapshot) -> list[DataSplit]:
        if self.scan_mode == "file-monitor":
            return self._snapshot_splits(snap.id, "delta")
        if snap.commit_kind == CommitKind.OVERWRITE:
            if self.store.options.options.get(CoreOptions.STREAMING_READ_OVERWRITE):
                return self._snapshot_splits(snap.id, "delta")
            return []
        producer = self.store.options.changelog_producer
        if producer in (ChangelogProducer.INPUT, ChangelogProducer.LOOKUP):
            return self._snapshot_splits(snap.id, "changelog") if snap.commit_kind == CommitKind.APPEND else []
        if producer == ChangelogProducer.FULL_COMPACTION:
            return self._snapshot_splits(snap.id, "changelog") if snap.commit_kind == CommitKind.COMPACT else []
        if snap.commit_kind != CommitKind.APPEND:
            return []  # a compaction adds no records
        return self._snapshot_splits(snap.id, "delta", with_dv=True)

    def _snapshot_splits(self, snapshot_id: int, kind: str, with_dv: bool = False) -> list[DataSplit]:
        """One raw split per bucket of the snapshot's delta or changelog
        files; the delta follow-up of changelog-producer=none carries the
        bucket's deletion-vector container."""
        plan = self.store.new_scan().with_snapshot(snapshot_id).with_kind(kind).plan()
        return [
            DataSplit(
                partition=partition,
                bucket=bucket,
                files=files,
                snapshot_id=snapshot_id,
                raw_convertible=True,
                dv_index_file=plan.dv_index_for(partition, bucket) if with_dv else None,
                is_changelog=kind == "changelog",
            )
            for partition, buckets in sorted(plan.grouped().items(), key=lambda kv: partition_sort_key(kv[0]))
            for bucket, files in sorted(buckets.items())
        ]
