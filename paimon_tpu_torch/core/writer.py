"""The merge-tree writer (port of paimon_tpu/core/writer.py, without the
pipelined flush, admission control or changelog producers).

Rows get sequence numbers in arrival order and buffer in a memtable; a
flush merges the buffer through the MergeExecutor (the table's merge
engine, on the device) and writes the result as level-0 files. A table that is not write-only has a
compaction manager: each flush puts its files at the head of level 0 and
lets the manager compact. prepare_commit flushes and hands the new files,
and the compaction's before and after files, over as a CommitMessage.
"""

from __future__ import annotations

import numpy as np

from ..data.batch import ColumnBatch
from ..options import CoreOptions
from .compact import CompactResult, MergeTreeCompactManager
from .datafile import DataFileMeta, KeyValueFileWriterFactory
from .kv import KVBatch
from .manifest import CommitMessage
from .mergefn import MergeExecutor

__all__ = ["MergeTreeWriter"]


class MergeTreeWriter:
    def __init__(
        self,
        partition: tuple,
        bucket: int,
        total_buckets: int,
        writer_factory: KeyValueFileWriterFactory,
        merge_executor: MergeExecutor,
        options: CoreOptions,
        restored_max_seq: int = -1,
        compact_manager: MergeTreeCompactManager | None = None,
    ):
        self.partition = partition
        self.bucket = bucket
        self.total_buckets = total_buckets
        self.writer_factory = writer_factory
        self.merge = merge_executor
        self.options = options
        self.compact_manager = compact_manager
        self.seq = restored_max_seq + 1
        self._buffer: list[KVBatch] = []
        self._buffered_rows = 0
        self._buffered_bytes = 0
        self._new_files: list[DataFileMeta] = []
        self._compact_before: list[DataFileMeta] = []
        self._compact_after: list[DataFileMeta] = []

    def write(self, data: ColumnBatch, kinds: np.ndarray | None = None) -> None:
        n = data.num_rows
        if n == 0:
            return
        kv = KVBatch.from_rows(data, self.seq, kinds)
        self.seq += n
        self._buffer.append(kv)
        self._buffered_rows += n
        self._buffered_bytes += kv.byte_size()
        if (
            self._buffered_bytes >= self.options.write_buffer_size
            or self._buffered_rows >= self.options.write_buffer_rows
        ):
            self.flush()

    def flush(self) -> None:
        """Merge the memtable (its rows arrive in seq order, so stability
        replaces sequence lanes), write level-0 files, then compact."""
        if not self._buffer:
            return
        kv = KVBatch.concat(self._buffer)
        self._buffer = []
        self._buffered_rows = 0
        self._buffered_bytes = 0
        merged = self.merge.merge(kv, seq_ascending=True)
        files = self.writer_factory.write(merged, level=0)
        self._new_files.extend(files)
        if self.compact_manager is not None:
            for f in files:
                self.compact_manager.levels.level0.insert(0, f)
            self._absorb(self.compact_manager.trigger_compaction())

    def compact(self, full: bool = False) -> None:
        """Explicit compaction: full=True compacts every run into the
        highest level."""
        self.flush()
        if self.compact_manager is not None:
            self._absorb(self.compact_manager.trigger_compaction(full=full))

    def _absorb(self, result: CompactResult | None) -> None:
        # files created and consumed within one commit keep both their ADD
        # and their DELETE, as in the JAX package
        if result is None or result.is_empty():
            return
        self._compact_before.extend(result.before)
        self._compact_after.extend(result.after)

    def prepare_commit(self) -> CommitMessage:
        self.flush()
        # a file produced by one compaction and consumed by a later one
        # within this commit cancels out. Keyed by (name, level), not by name:
        # an upgrade emits DELETE(F@k) + ADD(F@higher) under one name, and a
        # name-only cancel would drop F from the table
        before_keys = {(f.file_name, f.level) for f in self._compact_before}
        after_keys = {(f.file_name, f.level) for f in self._compact_after}
        cancel = before_keys & after_keys
        msg = CommitMessage(
            self.partition,
            self.bucket,
            self.total_buckets,
            list(self._new_files),
            compact_before=[f for f in self._compact_before if (f.file_name, f.level) not in cancel],
            compact_after=[f for f in self._compact_after if (f.file_name, f.level) not in cancel],
        )
        self._new_files.clear()
        self._compact_before.clear()
        self._compact_after.clear()
        return msg

    @property
    def max_sequence_number(self) -> int:
        return self.seq - 1
