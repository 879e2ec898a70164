"""Append-only tables: the writer and small-file compaction (port of
paimon_tpu/core/append.py).

An append table has no primary key: its files hold plain rows (no system
columns, no key range), each write is kept as it came, and a read
concatenates the files in (min_sequence_number, file_name) order. The
writer rolls its buffer into files at write-buffer-size or
write-buffer-rows; unless the table is write-only, each flush then
concatenates a run of small files (fewer than target-file-size bytes each)
once compaction.min.file-num of them, or target-file-size bytes, are in a
row. No merge runs on this path, so no kernel is launched.

One difference from the JAX package: the bucket's deletion vectors are
applied when files are concatenated, so a row a DELETE marked stays
deleted (the JAX package's writer concatenates without them, and its
COMPACT commit then drops the vectors: the rows come back; ROADMAP Queue
3).

Under write-buffer-spillable or write-buffer-for-append the buffer is a
SpillableBuffer (core/disk.py): batches past write-buffer-spill.rows rows
or write-buffer-spill.size bytes go to local disk as segments, and the
buffer flushes at write-buffer-rows rows or once
write-buffer-spill.max-disk-size of segments are on disk. A flush streams
each segment, and then each batch still in memory, into files of its own,
so its peak memory stays near the spill cap; the files, and their rows,
are the JAX package's.
"""

from __future__ import annotations

import numpy as np

from ..data.batch import ColumnBatch, concat_batches
from ..options import CoreOptions
from ..types import RowKind
from ..utils.cache import invalidate_data_file
from .datafile import DataFileMeta, KeyValueFileReaderFactory, KeyValueFileWriterFactory
from .disk import IOManager, SpillableBuffer
from .kv import KVBatch
from .manifest import CommitMessage

__all__ = ["AppendOnlyWriter", "AppendOnlyCompactManager", "concat_rewrite"]


class AppendOnlyCompactManager:
    """Picks a run of consecutive small files and concatenates them, order
    kept."""

    def __init__(
        self,
        reader_factory: KeyValueFileReaderFactory,
        writer_factory: KeyValueFileWriterFactory,
        options: CoreOptions,
        deletion_vectors: dict | None = None,
    ):
        self.reader_factory = reader_factory
        self.writer_factory = writer_factory
        self.options = options
        self.deletion_vectors = deletion_vectors or {}

    def pick(self, files: list[DataFileMeta], full: bool = False) -> list[DataFileMeta] | None:
        """The first run (in sequence order) of files under the target size
        that reaches compaction.min.file-num files or the target size in
        bytes; full=True takes every file when there are two or more."""
        files = sorted(files, key=lambda f: (f.min_sequence_number, f.file_name))
        if full:
            return files if len(files) > 1 else None
        target = self.options.target_file_size
        min_count = self.options.compaction_min_file_num
        small: list[DataFileMeta] = []
        for f in files:
            if f.file_size < target:
                small.append(f)
                if len(small) >= min_count or sum(x.file_size for x in small) >= target:
                    return small
            else:
                small = []
        return None

    def compact(self, files: list[DataFileMeta], full: bool = False) -> tuple[list[DataFileMeta], list[DataFileMeta]]:
        """(files consumed, files written); both empty when nothing is
        picked."""
        pick = self.pick(files, full)
        if not pick:
            return [], []
        return pick, concat_rewrite(self.reader_factory, self.writer_factory, pick, self.deletion_vectors)


def concat_rewrite(
    reader_factory: KeyValueFileReaderFactory,
    writer_factory: KeyValueFileWriterFactory,
    files: list[DataFileMeta],
    deletion_vectors: dict | None = None,
) -> list[DataFileMeta]:
    """The files' rows, without those their deletion vectors mark,
    concatenated in the given order into level-0 files of source
    "compact". Unkeyed files carry no sequence numbers, so the output's
    run from the inputs' smallest."""
    dvs = deletion_vectors or {}
    batches = []
    for f in files:
        kv = reader_factory.read(f)
        dv = dvs.get(f.file_name)
        if dv is not None:
            alive = ~dv.deleted_mask(kv.num_rows)
            if not alive.all():
                kv = kv.filter(alive)
        batches.append(kv)
    kv = KVBatch.concat(batches)
    base = min(f.min_sequence_number for f in files)
    kv = KVBatch(kv.data, np.arange(base, base + kv.num_rows, dtype=np.int64), kv.kind)
    out = writer_factory.write(kv, level=0, file_source="compact")
    # the inputs leave the live view: free their data-file cache budget
    for f in files:
        invalidate_data_file(f.file_name)
    return out


class AppendOnlyWriter:
    """Buffers +I batches and rolls them into data files; sequence numbers
    go on from the bucket's largest and order the files for reads."""

    def __init__(
        self,
        partition: tuple,
        bucket: int,
        total_buckets: int,
        writer_factory: KeyValueFileWriterFactory,
        compact_manager: AppendOnlyCompactManager | None,
        options: CoreOptions,
        existing_files: list[DataFileMeta] | None = None,
        restored_max_seq: int = -1,
    ):
        self.partition = partition
        self.bucket = bucket
        self.total_buckets = total_buckets
        self.writer_factory = writer_factory
        self.compact_manager = compact_manager
        self.options = options
        self.seq = restored_max_seq + 1
        self._existing = list(existing_files or [])
        self._buffer: list[ColumnBatch] = []
        self._buffered_rows = 0
        self._buffered_bytes = 0
        self._spill: SpillableBuffer | None = None
        opts = options.options
        if opts.get(CoreOptions.WRITE_BUFFER_SPILLABLE) or opts.get(CoreOptions.WRITE_BUFFER_FOR_APPEND):
            self._spill = SpillableBuffer(
                IOManager(),
                in_memory_rows=opts.get(CoreOptions.WRITE_BUFFER_SPILL_ROWS),
                in_memory_bytes=int(opts.get(CoreOptions.WRITE_BUFFER_SPILL_SIZE)),
                max_disk_bytes=int(opts.get(CoreOptions.WRITE_BUFFER_SPILL_MAX_DISK_SIZE)),
            )
        self._new_files: list[DataFileMeta] = []
        self._compact_before: list[DataFileMeta] = []
        self._compact_after: list[DataFileMeta] = []

    def write(self, data: ColumnBatch, kinds: np.ndarray | None = None) -> None:
        if kinds is not None and (np.asarray(kinds) != int(RowKind.INSERT)).any():
            raise ValueError("append-only tables accept only +I records")
        if data.num_rows == 0:
            return
        if self._spill is not None:
            # the spill caps bound the memory; only rows and the disk cap
            # flush, as in the JAX package
            self._spill.add(data)
            self._buffered_rows = self._spill.num_rows
        else:
            self._buffer.append(data)
            self._buffered_rows += data.num_rows
            self._buffered_bytes += data.byte_size()
        if (
            self._buffered_rows >= self.options.write_buffer_rows
            or self._buffered_bytes >= self.options.write_buffer_size
            or (self._spill is not None and self._spill.disk_full)
        ):
            self.flush()

    @property
    def spilled_bytes_total(self) -> int:
        """Bytes of every spill segment this writer has written."""
        return 0 if self._spill is None else self._spill.spilled_bytes_total

    def flush(self) -> None:
        """Write the buffer as level-0 files, then compact small files
        unless the table is write-only."""
        wrote = False
        if self._spill is not None:
            for segment in self._spill.batches():
                self._write_rows(segment)
                wrote = True
            self._spill.clear()
            self._spill.io_manager.close()
        elif self._buffer:
            self._write_rows(concat_batches(self._buffer))
            wrote = True
        self._buffer.clear()
        self._buffered_rows = self._buffered_bytes = 0
        if wrote and self.compact_manager is not None and not self.options.write_only:
            self._maybe_compact()

    def _write_rows(self, data: ColumnBatch) -> None:
        kv = KVBatch.from_rows(data, self.seq)
        self.seq += data.num_rows
        self._new_files.extend(self.writer_factory.write(kv, level=0, file_source="append"))

    def _maybe_compact(self, full: bool = False) -> None:
        consumed = {f.file_name for f in self._compact_before}
        current = [f for f in self._existing + self._new_files + self._compact_after if f.file_name not in consumed]
        before, after = self.compact_manager.compact(current, full=full)
        self._compact_before.extend(before)
        self._compact_after.extend(after)

    def compact(self, full: bool = False) -> None:
        self.flush()
        if self.compact_manager is not None:
            self._maybe_compact(full=full)

    def prepare_commit(self) -> CommitMessage:
        """The new files, and the compaction's inputs and outputs, less the
        files a compaction both wrote and consumed within this commit."""
        self.flush()
        cancel = {f.file_name for f in self._compact_before} & {f.file_name for f in self._compact_after}
        before = [f for f in self._compact_before if f.file_name not in cancel]
        after = [f for f in self._compact_after if f.file_name not in cancel]
        msg = CommitMessage(
            partition=self.partition,
            bucket=self.bucket,
            total_buckets=self.total_buckets,
            new_files=list(self._new_files),
            compact_before=before,
            compact_after=after,
        )
        consumed = {f.file_name for f in before}
        self._existing = [f for f in self._existing + self._new_files + after if f.file_name not in consumed]
        self._new_files.clear()
        self._compact_before.clear()
        self._compact_after.clear()
        return msg

    def close(self) -> None:
        """Drop the buffer without writing it, and its spill segments."""
        self._buffer.clear()
        self._buffered_rows = self._buffered_bytes = 0
        if self._spill is not None:
            self._spill.clear()
            self._spill.io_manager.close()
