"""The merge-tree writer (port of paimon_tpu/core/writer.py, without the
pipelined flush or the memory admission control).

Rows get sequence numbers in arrival order and buffer in a memtable; a
flush merges the buffer through the MergeExecutor (the table's merge
engine, on the device) and writes the result as level-0 files. A table that is not write-only has a
compaction manager: each flush puts its files at the head of level 0 and
lets the manager compact. Changelog producers: under `input` a flush
writes its raw buffer as changelog files; under `lookup` (with
changelog-producer.lookup-wait, the default) it reads the bucket's files
that overlap the flushed keys (without their deletion vectors' rows),
merges them with the flushed rows and diffs the state before against the
state after (core/changelog.py). The
compactions' changelog (full-compaction, or lookup without waiting) comes
from the compaction manager. prepare_commit flushes and hands the new
files, the compaction's before and after files and the changelog files
over as a CommitMessage. delta_snapshot gives another thread the
writer's uncommitted state for read-your-writes gets (table/get.py): the
buffered batches, the batches of a flush in progress, and the level-0
files no snapshot holds yet. A write-only writer under
compaction.adaptive.ingest-gate resolves the adaptive compactor's debt
gate at each flush (table/compactor.py): it admits the flush's sorted run
against the read-amplification ceiling, blocking up to
compaction.adaptive.ingest-gate-timeout, and settles it once the files
are written (or the flush failed).
"""

from __future__ import annotations

import numpy as np

from ..data.batch import ColumnBatch
from ..options import ChangelogProducer, CoreOptions
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
        debt_gate=None,
    ):
        self.partition = partition
        self.bucket = bucket
        self.total_buckets = total_buckets
        self.writer_factory = writer_factory
        self.merge = merge_executor
        self.options = options
        self.compact_manager = compact_manager
        # () -> the running AdaptiveCompactorService of the table, or None
        self.debt_gate = debt_gate
        self.seq = restored_max_seq + 1
        self._buffer: list[KVBatch] = []
        # the batches a flush is turning into files: readers see them until
        # the files are in _new_files
        self._inflight_delta: list[KVBatch] = []
        self._buffered_rows = 0
        self._buffered_bytes = 0
        self._new_files: list[DataFileMeta] = []
        self._compact_before: list[DataFileMeta] = []
        self._compact_after: list[DataFileMeta] = []
        self._changelog: list[DataFileMeta] = []
        self._compact_changelog: list[DataFileMeta] = []

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
        gate = self.debt_gate() if self.debt_gate is not None else None
        if gate is None:
            self._flush()
            return
        # a timeout proceeds: the gate bounds the runs, it never wedges ingest
        timeout_ms = self.options.options.get(CoreOptions.COMPACTION_ADAPTIVE_INGEST_GATE_TIMEOUT)
        gate.admit([(self.partition, self.bucket)], timeout_s=timeout_ms / 1000.0)
        landed = False
        try:
            self._flush()
            landed = True
        finally:
            gate.settle([(self.partition, self.bucket)], landed=landed)

    def _flush(self) -> None:
        try:
            self._flush_buffer()
        finally:
            self._inflight_delta = []

    def _flush_buffer(self) -> None:
        # in-flight first, then the buffer cleared: a concurrent
        # delta_snapshot sees the rows in one place or both, never in none
        self._inflight_delta = list(self._buffer)
        kv = KVBatch.concat(self._buffer)
        self._buffer = []
        self._buffered_rows = 0
        self._buffered_bytes = 0
        producer = self.options.changelog_producer
        if producer == ChangelogProducer.INPUT:
            self._write_changelog(kv)
        merged = self.merge.merge(kv, seq_ascending=True)
        if producer == ChangelogProducer.LOOKUP and self.options.options.get(
            CoreOptions.CHANGELOG_PRODUCER_LOOKUP_WAIT
        ):
            self._write_changelog(self._lookup_changelog(merged))
        files = self.writer_factory.write(merged, level=0)
        self._new_files.extend(files)
        if self.compact_manager is not None:
            for f in files:
                self.compact_manager.levels.level0.insert(0, f)
            self._absorb(self.compact_manager.trigger_compaction())

    def _write_changelog(self, kv: KVBatch) -> None:
        """Changelog files keep their rows' order (no key sort)."""
        self._changelog.extend(
            self.writer_factory.write(kv, level=0, file_source="append", prefix="changelog", sorted_input=False)
        )

    def _lookup_changelog(self, merged: KVBatch) -> KVBatch:
        """The bucket's state before this flush against the state after it,
        over the files whose key range meets the flushed keys."""
        from .changelog import state_changelog
        from .read import MergeFileSplitRead

        if merged.num_rows == 0 or self.compact_manager is None:
            return merged.slice(0, 0)
        key_names = self.merge.key_names
        lo = tuple(merged.data.column(k).values[0] for k in key_names)
        hi = tuple(merged.data.column(k).values[-1] for k in key_names)
        overlapping = [
            f for f in self.compact_manager.levels.all_files() if not (f.max_key < lo or f.min_key > hi)
        ]
        reader = MergeFileSplitRead(self.compact_manager.rewriter.reader_factory, self.merge, key_names)
        before = reader.read_kv(
            overlapping, drop_delete=True, deletion_vectors=self.compact_manager.rewriter.deletion_vectors
        )
        after = self.merge.merge(KVBatch.concat([before, merged]), seq_ascending=True).drop_deletes()
        return state_changelog(
            before, after, key_names, self.options.options.get(CoreOptions.CHANGELOG_PRODUCER_ROW_DEDUPLICATE)
        )

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
        self._compact_changelog.extend(result.changelog)

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
            changelog_files=list(self._changelog),
            compact_changelog_files=list(self._compact_changelog),
        )
        for pending in (self._new_files, self._compact_before, self._compact_after, self._changelog,
                        self._compact_changelog):
            pending.clear()
        return msg

    def delta_snapshot(self) -> tuple[list[KVBatch], list[DataFileMeta]]:
        """(buffered and in-flight batches, uncommitted level-0 files): list
        copies, safe to take from another thread while this writer ingests.
        Read in this order (buffer, in-flight, files) against the flush's
        order (in-flight set, buffer cleared, files added, in-flight
        cleared), a row is always in one of them; a row seen twice has one
        sequence number and one value, and resolves the same."""
        return list(self._buffer) + list(self._inflight_delta), list(self._new_files)

    @property
    def max_sequence_number(self) -> int:
        return self.seq - 1
