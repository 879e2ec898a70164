"""Streaming split enumerators: a stream scan's splits handed out to N
readers (port of paimon_tpu/table/enumerator.py).

A bucket's splits always go to one reader, so that its deltas apply in
order: the reader is zlib.crc32 of repr((partition, bucket)) modulo the
reader count, a hash stable across processes, and the JAX package's (the
partition tuples hold Python ints and strs in both packages, so the reprs
agree). checkpoint() holds the scan's position and the undrained splits;
restore() routes them again for the new reader count.
AlignedSplitEnumerator discovers one snapshot at a time and checkpoints
only once its splits are drained.
"""

from __future__ import annotations

import time
import zlib
from typing import TYPE_CHECKING

from ..options import CoreOptions
from .read import DataSplit

if TYPE_CHECKING:
    from . import FileStoreTable

__all__ = ["SplitEnumerator", "AlignedSplitEnumerator"]


class SplitEnumerator:
    def __init__(self, table: "FileStoreTable", num_readers: int, predicate=None):
        if num_readers < 1:
            raise ValueError(f"num_readers must be at least 1, got {num_readers}")
        self.table = table
        self.num_readers = num_readers
        rb = table.new_read_builder()
        if predicate is not None:
            rb = rb.with_filter(predicate)
        self.scan = rb.new_stream_scan()
        self._pending: dict[int, list[DataSplit]] = {r: [] for r in range(num_readers)}

    def owner(self, split: DataSplit) -> int:
        """The reader of the split's bucket."""
        return zlib.crc32(repr((split.partition, split.bucket)).encode()) % self.num_readers

    def discover(self) -> int:
        """Plan the scan once and queue the new splits; their number."""
        splits = self.scan.plan()
        if not splits:
            return 0
        for s in splits:
            self._pending[self.owner(s)].append(s)
        return len(splits)

    def next_splits(self, reader_id: int, max_splits: int | None = None) -> list[DataSplit]:
        """Up to max_splits (scan.max-splits-per-task by default) of the
        reader's queued splits."""
        if max_splits is None:
            max_splits = self.table.options.options.get(CoreOptions.SCAN_MAX_SPLITS_PER_TASK)
        q = self._pending[reader_id]
        out, self._pending[reader_id] = q[:max_splits], q[max_splits:]
        return out

    @property
    def pending_count(self) -> int:
        return sum(len(q) for q in self._pending.values())

    def checkpoint(self) -> dict:
        return {
            "nextSnapshot": self.scan.checkpoint(),
            "pending": {str(r): [s.to_dict() for s in q] for r, q in self._pending.items()},
        }

    def restore(self, state: dict) -> None:
        self.scan.restore(state.get("nextSnapshot"))
        self._pending = {r: [] for r in range(self.num_readers)}
        for splits in state.get("pending", {}).values():
            for d in splits:
                s = DataSplit.from_dict(d)
                self._pending[self.owner(s)].append(s)

    def notify_checkpoint_complete(self) -> None:
        self.scan.notify_checkpoint_complete()


class AlignedSplitEnumerator(SplitEnumerator):
    """One snapshot's splits per discovery; aligned_checkpoint waits until
    the readers have drained them, so each checkpoint sits on a snapshot
    boundary."""

    def __init__(self, table: "FileStoreTable", num_readers: int, predicate=None):
        super().__init__(table, num_readers, predicate)
        self._current_snapshot: int | None = None

    def discover(self) -> int:
        """0 while the previous snapshot's splits are undrained."""
        if self.pending_count:
            return 0
        splits = self.scan.plan()
        if not splits:
            self._current_snapshot = None
            return 0
        self._current_snapshot = splits[0].snapshot_id
        for s in splits:
            self._pending[self.owner(s)].append(s)
        return len(splits)

    def aligned_checkpoint(self, timeout_seconds: float = 10.0, poll_seconds: float = 0.02) -> dict:
        """The checkpoint once every queued split is drained, with
        "alignedSnapshot"; TimeoutError when they are not drained within
        timeout_seconds."""
        deadline = time.monotonic() + timeout_seconds
        while self.pending_count:
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"alignment timeout: {self.pending_count} splits of snapshot "
                    f"{self._current_snapshot} still undrained"
                )
            time.sleep(poll_seconds)
        state = self.checkpoint()
        state["alignedSnapshot"] = self._current_snapshot
        return state
