"""The merge-tree writer (port of paimon_tpu/core/writer.py).

Rows get sequence numbers in arrival order and buffer in a memtable; a
flush merges the buffer through the MergeExecutor (the table's merge
engine, on the device) and writes the result as level-0 files. A table
that is not write-only has a compaction manager: each flush puts its files
at the head of level 0 and lets the manager compact. Changelog producers:
under `input` a flush writes its raw buffer as changelog files; under
`lookup` (with changelog-producer.lookup-wait, the default) it reads the
bucket's files that overlap the flushed keys (without their deletion
vectors' rows), merges them with the flushed rows and diffs the state
before against the state after (core/changelog.py). The compactions'
changelog (full-compaction, or lookup without waiting) comes from the
compaction manager. prepare_commit flushes and hands the new files, the
compaction's before and after files and the changelog files over as a
CommitMessage.

A flush has two phases. flush_dispatch, on the caller's thread, drains the
memtable (and writes the input changelog); flush_complete merges, writes
the level-0 files and compacts. While scan.prefetch-splits is above 0 (the
default, 2), an auto-flush hands its complete phase to one paimon-flush
worker thread, so the next memtable fills while the last one encodes; one
worker taking them in order keeps the levels and compactions in the
sequential order, and the files are those the inline flush writes.
flush() and prepare_commit are the barrier: they wait for every offloaded
flush, and the first worker error raises there.

Admission control (core/admission.py): every buffered byte is reserved
against the WriteBufferController and released exactly once, when its
flush has encoded, or when the writer is closed or abandoned. Over the
stop trigger, a write first drains this writer's own memtable, then
blocks, and may raise WriterBackpressureError with nothing buffered.

delta_snapshot gives another thread the writer's uncommitted state for
read-your-writes gets (table/get.py): the buffered batches, the batches of
flushes in progress, and the level-0 files no snapshot holds yet. A
write-only writer under compaction.adaptive.ingest-gate resolves the
adaptive compactor's debt gate at each flush (table/compactor.py): it
admits the flush's sorted run against the read-amplification ceiling,
blocking up to compaction.adaptive.ingest-gate-timeout, and settles it
once the files are written (or the flush failed). The crash points
flush:before-dispatch (the memtable drains next) and flush:files-written
(the level-0 files landed, no commit names them) are the JAX package's
(core/writer.py:306, :383).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..data.batch import ColumnBatch
from ..metrics import pipeline_metrics
from ..options import ChangelogProducer, CoreOptions
from ..parallel.pipeline import FLUSH_THREAD_PREFIX, pipeline_config
from .compact import CompactResult, MergeTreeCompactManager
from .datafile import DataFileMeta, KeyValueFileWriterFactory
from .kv import KVBatch
from .manifest import CommitMessage
from .mergefn import MergeExecutor
from ..resilience.faults import crash_point

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
        admission=None,
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
        # the WriteBufferController, or None; _accounted is what this
        # writer holds reserved, so teardown returns only the rest of what
        # its flushes have not returned
        self.admission = admission
        self._accounted = 0
        self._acct_lock = threading.Lock()
        self.seq = restored_max_seq + 1
        self._buffer: list[KVBatch] = []
        # batches drained from the memtable whose files have not landed:
        # readers see them until the files are in _new_files
        self._inflight_delta: list[KVBatch] = []
        self._buffered_rows = 0
        self._buffered_bytes = 0
        self._new_files: list[DataFileMeta] = []
        self._compact_before: list[DataFileMeta] = []
        self._compact_after: list[DataFileMeta] = []
        self._changelog: list[DataFileMeta] = []
        self._compact_changelog: list[DataFileMeta] = []
        self._async_flush = pipeline_config(options) > 0
        self._flush_pool: ThreadPoolExecutor | None = None
        self._flush_pending: list = []

    # ---- ingest --------------------------------------------------------
    def write(self, data: ColumnBatch, kinds: np.ndarray | None = None) -> None:
        n = data.num_rows
        if n == 0:
            return
        kv = KVBatch.from_rows(data, self.seq, kinds)
        nbytes = kv.byte_size()
        self._reserve(nbytes)  # may raise, with nothing buffered and seq as it was
        self.seq += n
        self._buffer.append(kv)
        self._buffered_rows += n
        self._buffered_bytes += nbytes
        if (
            self._buffered_bytes >= self.options.write_buffer_size
            or self._buffered_rows >= self.options.write_buffer_rows
        ):
            self._flush_async()

    # ---- admission accounting ------------------------------------------
    def _reserve(self, nbytes: int) -> None:
        """Admission for nbytes of memtable: over the stop trigger, drain
        this writer's own memtable first, then take the blocking reserve."""
        if self.admission is None:
            return
        if not self.admission.try_reserve(nbytes):
            if self._buffered_bytes > 0:
                self._flush_async()
            self.admission.reserve(nbytes)
        with self._acct_lock:
            self._accounted += nbytes

    def _acct_release(self, nbytes: int) -> None:
        if self.admission is None or nbytes <= 0:
            return
        with self._acct_lock:
            nbytes = min(nbytes, self._accounted)
            self._accounted -= nbytes
        self.admission.release(nbytes)

    def _acct_release_all(self) -> None:
        if self.admission is None:
            return
        with self._acct_lock:
            n, self._accounted = self._accounted, 0
        self.admission.release(n)

    # ---- flush ---------------------------------------------------------
    def flush(self) -> None:
        """Drain the memtable and wait for every offloaded flush; a worker's
        error raises here."""
        self._flush_async()
        self._drain_flushes()

    def _flush_async(self) -> None:
        """Drain the memtable; its complete phase runs on the flush worker
        when the offload is on, else here."""
        state = self.flush_dispatch()
        if state is None:
            return
        if not self._async_flush:
            self.flush_complete(state)
            return
        slot = self.admission is not None
        if slot and not self.admission.flush_begin():
            # the pending-flush cap held for the block timeout: encode
            # here, and the caller pays
            self.flush_complete(state)
            return
        if self._flush_pool is None:
            self._flush_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix=FLUSH_THREAD_PREFIX)
        g = pipeline_metrics()
        busy = g.histogram("flush_busy_ms")
        g.counter("splits_prefetched").inc()

        def run():
            t0 = time.perf_counter()
            try:
                self.flush_complete(state)
            finally:
                if slot:
                    self.admission.flush_end()
                busy.update((time.perf_counter() - t0) * 1000)

        self._flush_pending.append((self._flush_pool.submit(run), state, slot))

    def _cancel(self, future, state, slot: bool) -> bool:
        """Cancel an offloaded flush its worker has not started; its run()
        never executes, so its batch, bytes, debt-gate charge and
        pending-flush slot are given back here. False if it has started."""
        if not future.cancel():
            return False
        self._finish(state, landed=False)
        if slot:
            self.admission.flush_end()
        return True

    def _drain_flushes(self) -> None:
        """Wait for the offloaded flushes in order; after the first failure
        the rest are cancelled (or awaited) and that failure raises."""
        pending, self._flush_pending = self._flush_pending, []
        error = None
        for future, state, slot in pending:
            if error is not None and self._cancel(future, state, slot):
                continue
            try:
                future.result()
            except BaseException as exc:  # noqa: BLE001 - raised below
                error = error or exc
        if error is not None:
            self._shutdown_flush_pool()
            raise error

    def _shutdown_flush_pool(self) -> None:
        if self._flush_pool is not None:
            self._flush_pool.shutdown(wait=True)
            self._flush_pool = None

    def close(self) -> None:
        """Stop the flush worker without committing. Flushes not yet started
        are cancelled, and errors of the others dropped (prepare_commit is
        where they surface); every byte this writer still holds reserved
        returns to the admission controller here, once."""
        pending, self._flush_pending = self._flush_pending, []
        try:
            for future, state, slot in pending:
                if not self._cancel(future, state, slot):
                    future.exception()
        finally:
            self._shutdown_flush_pool()
            self._acct_release_all()
            self._inflight_delta.clear()

    def flush_dispatch(self):
        """Phase 1, on the caller's thread: land any flush still in flight
        (so the levels change in flush order), admit the run at the debt
        gate, drain the memtable and write the input changelog. None when
        the memtable is empty. A failure here gives back the gate's charge
        and the drained batch's bytes before it raises."""
        self._drain_flushes()
        if not self._buffer:
            return None
        # the memtable is full and nothing drained: a kill here loses only
        # rows no commit acknowledged
        crash_point("flush:before-dispatch")
        gate = self.debt_gate() if self.debt_gate is not None else None
        if gate is not None:
            # a timeout proceeds: the gate bounds the runs, it never wedges ingest
            timeout_ms = self.options.options.get(CoreOptions.COMPACTION_ADAPTIVE_INGEST_GATE_TIMEOUT)
            gate.admit([(self.partition, self.bucket)], timeout_s=timeout_ms / 1000.0)
        state = None
        try:
            kv = KVBatch.concat(self._buffer) if len(self._buffer) > 1 else self._buffer[0]
            state = (kv, self._buffered_bytes, gate)
            # in flight first, then the buffer cleared: a concurrent
            # delta_snapshot sees the rows in one place or both, never in none
            self._inflight_delta.append(kv)
            self._buffer = []
            self._buffered_rows = 0
            self._buffered_bytes = 0
            if self.options.changelog_producer == ChangelogProducer.INPUT:
                self._write_changelog(kv)
        except BaseException:
            if state is not None:
                self._finish(state, landed=False)
            elif gate is not None:
                gate.settle([(self.partition, self.bucket)], landed=False)
            raise
        return state

    def flush_complete(self, state) -> None:
        """Phase 2: merge, write the level-0 files (and the lookup
        changelog), compact. The batch's reservation returns when the
        encode has landed or failed; the debt gate's charge settles then."""
        landed = False
        try:
            self._flush_merged(state[0])
            landed = True
        finally:
            self._finish(state, landed)

    def _finish(self, state, landed: bool) -> None:
        """A drained batch is done with: its bytes return, readers stop
        seeing it in flight, and its debt-gate charge settles."""
        kv, drained_bytes, gate = state
        self._acct_release(drained_bytes)
        try:
            self._inflight_delta.remove(kv)
        except ValueError:
            pass  # close() cleared the window already
        if gate is not None:
            gate.settle([(self.partition, self.bucket)], landed=landed)

    def _flush_merged(self, kv: KVBatch) -> None:
        # memtable rows arrive in seq order: stability replaces seq lanes
        merged = self.merge.merge(kv, seq_ascending=True)
        if self.options.changelog_producer == ChangelogProducer.LOOKUP and self.options.options.get(
            CoreOptions.CHANGELOG_PRODUCER_LOOKUP_WAIT
        ):
            self._write_changelog(self._lookup_changelog(merged))
        files = self.writer_factory.write(merged, level=0)
        # the level-0 files are durable and no snapshot names them: a kill
        # here leaves orphan data files for remove_orphan_files
        crash_point("flush:files-written")
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
        try:
            self.flush()  # the barrier: offloaded encodes land first
        finally:
            # the error path too: a worker failure must not leave the
            # paimon-flush thread alive
            self._shutdown_flush_pool()
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
        order (in-flight added, buffer cleared, files added, in-flight
        removed), a row is always in one of them; a row seen twice has one
        sequence number and one value, and resolves the same."""
        return list(self._buffer) + list(self._inflight_delta), list(self._new_files)

    @property
    def max_sequence_number(self) -> int:
        return self.seq - 1

    def health(self) -> dict:
        """This writer's buffer and flush state, for TableWrite.health."""
        return {
            "buffered_bytes": self._buffered_bytes,
            "buffered_rows": self._buffered_rows,
            "pending_flushes": len(self._flush_pending),
            "reserved_bytes": self._accounted,
        }
