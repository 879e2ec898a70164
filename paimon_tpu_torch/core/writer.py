"""The merge-tree writer for write-only tables (port of
paimon_tpu/core/writer.py, without compaction or the pipelined flush).

Rows get sequence numbers in arrival order and buffer in a memtable; a
flush merges the buffer through the MergeExecutor (the device dedup) and
writes the result as level-0 files. prepare_commit flushes and hands the
new files over as a CommitMessage.
"""

from __future__ import annotations

import numpy as np

from ..data.batch import ColumnBatch
from ..options import CoreOptions
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
    ):
        self.partition = partition
        self.bucket = bucket
        self.total_buckets = total_buckets
        self.writer_factory = writer_factory
        self.merge = merge_executor
        self.options = options
        self.seq = restored_max_seq + 1
        self._buffer: list[KVBatch] = []
        self._buffered_rows = 0
        self._buffered_bytes = 0
        self._new_files: list[DataFileMeta] = []

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
        replaces sequence lanes) and write level-0 files."""
        if not self._buffer:
            return
        kv = KVBatch.concat(self._buffer)
        self._buffer = []
        self._buffered_rows = 0
        self._buffered_bytes = 0
        merged = self.merge.merge(kv, seq_ascending=True)
        self._new_files.extend(self.writer_factory.write(merged, level=0))

    def prepare_commit(self) -> CommitMessage:
        self.flush()
        msg = CommitMessage(self.partition, self.bucket, self.total_buckets, list(self._new_files))
        self._new_files.clear()
        return msg

    @property
    def max_sequence_number(self) -> int:
        return self.seq - 1
