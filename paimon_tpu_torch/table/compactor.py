"""Dedicated and adaptive compaction, and the append compaction coordinator
(port of paimon_tpu/table/compactor.py).

- DedicatedCompactor: ingest writers run write-only and a separate job owns
  every compaction of the table, committing COMPACT snapshots. A rival
  commit that removed the same files fails the conflict check, and the
  round is abandoned.
- AppendCompactionCoordinator, CompactionTask, execute_compaction_task: on
  an append table a coordinator plans runs of small files, workers
  concatenate each run into one file, and the coordinator commits their
  results at once. Unlike the JAX package, a rewrite drops the rows the
  bucket's deletion vectors mark: the COMPACT commit drops the vectors of
  the files it rewrote, so the JAX package's rewrite brings deleted rows
  back.
- AdaptiveCompactionPolicy, AdaptiveCompactorService: a background thread
  (named paimon-compactor-*) observes every bucket's sorted runs in the
  latest snapshot and compacts by priority: buckets at or over the
  read-amplification ceiling first, then buckets whose debt waited past the
  starvation timeout, then the hottest buckets at or over the trigger, deep
  (a full rewrite) from deep-runs sorted runs on. Under
  compaction.adaptive.ingest-gate a write-only writer's flush admits
  against the ceiling first (active_debt_gate, core/store.py).
  close() always stops the thread.

Compactions run through the same TableWrite and merge as inline ones, so
under sort-engine=pallas they launch K1 and K2 as any flush or compaction.
"""

from __future__ import annotations

import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable

import numpy as np

from ..core.append import concat_rewrite
from ..core.commit import BATCH_COMMIT_IDENTIFIER, CommitConflictError, CommitGiveUpError
from ..core.datafile import DataFileMeta
from ..core.manifest import CommitMessage
from ..metrics import compaction_metrics
from ..options import CoreOptions
from .write import TableCommit, TableWrite

if TYPE_CHECKING:
    from . import FileStoreTable

__all__ = [
    "DedicatedCompactor",
    "AppendCompactionCoordinator",
    "CompactionTask",
    "execute_compaction_task",
    "BucketShape",
    "CompactionDecision",
    "AdaptiveCompactionPolicy",
    "AdaptiveCompactorService",
    "active_debt_gate",
]

# running services by table path: a write-only writer finds the gate of the
# compactor draining its table here
_ACTIVE_GATES: dict[str, "AdaptiveCompactorService"] = {}
_GATES_LOCK = threading.Lock()


def active_debt_gate(table_path) -> "AdaptiveCompactorService | None":
    """The running AdaptiveCompactorService for a table path, if any."""
    with _GATES_LOCK:
        return _ACTIVE_GATES.get(str(table_path))


class DedicatedCompactor:
    """Compaction rounds against the latest snapshot, each committed as one
    COMPACT snapshot. The table's handle is taken with write-only=false,
    whatever its writers run with."""

    def __init__(self, table: "FileStoreTable"):
        self.table = table.copy({"write-only": "false"}) if table.options.write_only else table

    def run_once(self, full: bool = False) -> bool:
        """One round over every live bucket: True when a COMPACT snapshot was
        committed, False when there was nothing to do or a rival commit won
        (the round is abandoned; the next one sees the new state)."""
        w = self.table.new_batch_write_builder().new_write()
        try:
            w.compact(full=full)
            msgs = w.prepare_commit()
            if not msgs:
                return False
            TableCommit(self.table).commit_messages(BATCH_COMMIT_IDENTIFIER, msgs)
            return True
        except CommitConflictError:
            return False


@dataclass
class CompactionTask:
    """One unit of a compaction worker's work: consecutive small files of
    one (partition, bucket)."""

    partition: tuple
    files: list[DataFileMeta] = field(default_factory=list)
    bucket: int = 0


class AppendCompactionCoordinator:
    """Plans small-file concatenations over an append table, per
    (partition, bucket); the workers' results go into one commit."""

    def __init__(self, table: "FileStoreTable"):
        if table.is_primary_key_table:
            raise ValueError(
                "AppendCompactionCoordinator serves append-only tables; "
                "primary-key tables compact through DedicatedCompactor"
            )
        self.table = table

    def plan(self, full: bool = False) -> list[CompactionTask]:
        """In each bucket's (min_sequence_number, file_name) order: runs of
        files under the target size, cut at compaction.min.file-num files or
        the target size, and runs of two or more before a large file or at
        the end; full=True takes every bucket of two or more files whole."""
        store = self.table.store
        target = store.options.target_file_size
        min_count = store.options.compaction_min_file_num
        by_pb: dict[tuple, list[DataFileMeta]] = {}
        for e in store.new_scan().plan().entries:
            by_pb.setdefault((e.partition, e.bucket), []).append(e.file)
        tasks: list[CompactionTask] = []
        for (partition, bucket), files in by_pb.items():
            files = sorted(files, key=lambda f: (f.min_sequence_number, f.file_name))
            if full:
                if len(files) > 1:
                    tasks.append(CompactionTask(partition, files, bucket))
                continue
            small: list[DataFileMeta] = []
            for f in files:
                if f.file_size < target:
                    small.append(f)
                    if len(small) >= min_count or sum(x.file_size for x in small) >= target:
                        tasks.append(CompactionTask(partition, small, bucket))
                        small = []
                else:
                    if len(small) > 1:
                        tasks.append(CompactionTask(partition, small, bucket))
                    small = []
            if len(small) > 1:
                tasks.append(CompactionTask(partition, small, bucket))
        return tasks

    def commit(self, messages: list[CommitMessage]) -> None:
        """The workers' results as one commit."""
        messages = [m for m in messages if not m.is_empty()]
        if messages:
            TableCommit(self.table).commit_messages(BATCH_COMMIT_IDENTIFIER, messages)


def execute_compaction_task(table: "FileStoreTable", task: CompactionTask) -> CommitMessage:
    """A worker's half: the task's files concatenated in order into new
    files, without the rows the bucket's deletion vectors mark; returns the
    CommitMessage for the coordinator."""
    store = table.store
    _, dvs = store.restore_state(task.partition, task.bucket)
    out = concat_rewrite(
        store.reader_factory(task.partition, task.bucket),
        store.writer_factory(task.partition, task.bucket),
        task.files,
        dvs,
    )
    return CommitMessage(
        partition=task.partition,
        bucket=task.bucket,
        total_buckets=max(store.options.bucket, -1),
        compact_before=list(task.files),
        compact_after=out,
    )


@dataclass
class BucketShape:
    """One bucket's LSM shape as the latest snapshot shows it."""

    partition: tuple
    bucket: int
    runs: int  # sorted runs: level-0 files plus populated levels above 0
    level0_files: int
    files: int
    bytes: int
    debt_files: int  # files outside the top populated level
    debt_bytes: int
    write_rate: float  # moving average of the sequence numbers' advance per second
    max_seq: int

    @property
    def read_amp(self) -> int:
        """The sorted runs a merge-read of this bucket consults."""
        return self.runs


@dataclass
class CompactionDecision:
    partition: tuple
    bucket: int
    deep: bool  # a full rewrite to the top level, or a shallow universal pick
    reason: str  # "ceiling" | "starvation" | "hot"
    runs: int = 0  # sorted runs when the decision was made


class AdaptiveCompactionPolicy:
    """The scoring, without IO. Each round, in order:
      1. ceiling: every bucket at or over `read_amp_ceiling` runs, worst
         first, outside the per-round budget;
      2. starvation: buckets whose debt waited `starvation_s` or longer,
         oldest first;
      3. hot: up to `max_buckets` in all, the buckets at or over `trigger`
         runs with the largest (write_rate + 1) x debt_files.
    A decision is deep from `deep_runs` runs on. Buckets with debt left out
    are the round's deferrals."""

    def __init__(
        self,
        read_amp_ceiling: int = 12,
        trigger: int = 3,
        deep_runs: int = 8,
        max_buckets: int = 2,
        starvation_s: float = 10.0,
    ):
        self.read_amp_ceiling = read_amp_ceiling
        self.trigger = trigger
        self.deep_runs = deep_runs
        self.max_buckets = max_buckets
        self.starvation_s = starvation_s
        # (partition, bucket) -> when its current debt was first seen
        self._debt_since: dict[tuple, float] = {}

    def _deep(self, shape: BucketShape) -> bool:
        return shape.runs >= self.deep_runs

    def decide(self, shapes: list[BucketShape], now_s: float) -> tuple[list[CompactionDecision], int]:
        """(decisions in execution order, deferred bucket count)."""
        decisions: list[CompactionDecision] = []
        chosen: set[tuple] = set()
        live = set()
        for s in shapes:
            key = (s.partition, s.bucket)
            live.add(key)
            if s.runs > 1:
                self._debt_since.setdefault(key, now_s)
            else:
                self._debt_since.pop(key, None)
        for key in list(self._debt_since):
            if key not in live:
                self._debt_since.pop(key)

        for s in sorted(shapes, key=lambda x: -x.runs):
            if s.read_amp >= self.read_amp_ceiling:
                decisions.append(CompactionDecision(s.partition, s.bucket, self._deep(s), "ceiling", s.runs))
                chosen.add((s.partition, s.bucket))

        starving = [
            s
            for s in shapes
            if (s.partition, s.bucket) not in chosen
            and s.runs > 1
            and now_s - self._debt_since.get((s.partition, s.bucket), now_s) >= self.starvation_s
        ]
        for s in sorted(starving, key=lambda x: self._debt_since[(x.partition, x.bucket)]):
            decisions.append(CompactionDecision(s.partition, s.bucket, self._deep(s), "starvation", s.runs))
            chosen.add((s.partition, s.bucket))

        slots = max(0, self.max_buckets - len(decisions))
        eligible = [s for s in shapes if (s.partition, s.bucket) not in chosen and s.runs >= self.trigger]
        eligible.sort(key=lambda s: (-(s.write_rate + 1.0) * s.debt_files, -s.runs))
        for s in eligible[:slots]:
            decisions.append(CompactionDecision(s.partition, s.bucket, self._deep(s), "hot", s.runs))
            chosen.add((s.partition, s.bucket))

        deferred = sum(1 for s in shapes if s.runs > 1 and (s.partition, s.bucket) not in chosen)
        return decisions, deferred

    def note_compacted(self, partition: tuple, bucket: int) -> None:
        self._debt_since.pop((partition, bucket), None)


class AdaptiveCompactorService:
    """Background compaction of one table. Each round observes the latest
    snapshot's buckets (write rate: a moving average of the largest
    sequence number's advance between rounds), asks the policy, and
    commits its deep and its shallow decisions as one COMPACT snapshot
    each; a lost race is counted in compaction{adaptive_conflicts} and
    observed afresh next round. start() runs the rounds on one
    paimon-compactor thread; close() (or leaving the context) stops it and
    releases every waiting writer."""

    THREAD_PREFIX = "paimon-compactor"

    def __init__(
        self,
        table: "FileStoreTable",
        policy: AdaptiveCompactionPolicy | None = None,
        execute_group: "Callable[[list[CompactionDecision], bool], int] | None" = None,
    ):
        """`execute_group(group, deep) -> buckets compacted` replaces the
        local execution (_compact_group) of a round's group; observation,
        policy, pacing and the gate stay as they are."""
        opts = table.options.options
        base = table.copy({"write-only": "false"}) if table.options.write_only else table
        if policy is None:
            policy = AdaptiveCompactionPolicy(
                read_amp_ceiling=opts.get(CoreOptions.COMPACTION_ADAPTIVE_READ_AMP_CEILING),
                trigger=opts.get(CoreOptions.COMPACTION_ADAPTIVE_TRIGGER),
                deep_runs=opts.get(CoreOptions.COMPACTION_ADAPTIVE_DEEP_RUNS),
                max_buckets=opts.get(CoreOptions.COMPACTION_ADAPTIVE_MAX_BUCKETS),
                starvation_s=opts.get(CoreOptions.COMPACTION_ADAPTIVE_STARVATION_TIMEOUT) / 1000.0,
            )
        self.policy = policy
        # a shallow decision must find work: the service's handle picks at
        # the adaptive trigger, not the writers' inline one
        self.table = base.copy({"num-sorted-run.compaction-trigger": str(max(policy.trigger - 1, 1))})
        self.interval_s = opts.get(CoreOptions.COMPACTION_ADAPTIVE_INTERVAL) / 1000.0
        self.parallelism = max(1, opts.get(CoreOptions.COMPACTION_ADAPTIVE_PARALLELISM))
        self._execute_group = execute_group
        self._pool: ThreadPoolExecutor | None = None
        self._prev: dict[tuple, tuple[int, float]] = {}  # (p, b) -> (max_seq, t)
        self._rate: dict[tuple, float] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._errors: list[str] = []
        self.rounds = 0
        self.compactions = 0
        # the gate: the last observed runs per bucket plus the runs of
        # admitted flushes not yet observed, under one condition
        self._runs_cond = threading.Condition()
        self._runs: dict[tuple, int] = {}
        self._inflight: dict[tuple, int] = {}
        self._owner_charges: dict[object, list[tuple]] = {}

    def observe(self) -> list[BucketShape]:
        now = time.monotonic()
        plan = self.table.store.new_scan().plan()
        shapes: list[BucketShape] = []
        for partition, buckets in plan.grouped().items():
            for bucket, files in buckets.items():
                level0 = [f for f in files if f.level == 0]
                upper = sorted({f.level for f in files if f.level > 0})
                runs = len(level0) + len(upper)
                top = upper[-1] if upper else None
                debt = [f for f in files if top is None or f.level != top]
                max_seq = max((f.max_sequence_number for f in files), default=0)
                key = (partition, bucket)
                prev = self._prev.get(key)
                if prev is not None and now > prev[1]:
                    inst = max(0.0, (max_seq - prev[0]) / (now - prev[1]))
                    self._rate[key] = 0.5 * self._rate.get(key, inst) + 0.5 * inst
                self._prev[key] = (max_seq, now)
                shapes.append(
                    BucketShape(
                        partition=partition,
                        bucket=bucket,
                        runs=runs,
                        level0_files=len(level0),
                        files=len(files),
                        bytes=sum(f.file_size for f in files),
                        debt_files=len(debt) if runs > 1 else 0,
                        debt_bytes=sum(f.file_size for f in debt) if runs > 1 else 0,
                        write_rate=self._rate.get(key, 0.0),
                        max_seq=max_seq,
                    )
                )
        with self._runs_cond:
            self._runs = {(s.partition, s.bucket): s.runs for s in shapes}
            self._runs_cond.notify_all()
        self._publish(shapes)
        return shapes

    def over_ceiling(self) -> list[tuple]:
        """Buckets at or over the ceiling at the last observation."""
        bound = self.policy.read_amp_ceiling
        with self._runs_cond:
            return [k for k, r in self._runs.items() if r >= bound]

    def heat(self) -> dict[int, float]:
        """The write-rate average per bucket id, summed over partitions."""
        out: dict[int, float] = {}
        for (_, bucket), rate in list(self._rate.items()):
            out[bucket] = out.get(bucket, 0.0) + rate
        return out

    def wait_for_headroom(self, timeout_s: float = 30.0) -> bool:
        """Block until no bucket sits at or over the ceiling; False on
        timeout."""
        return self.admit(buckets=None, timeout_s=timeout_s, project=False)

    def _keys_for(self, b):
        if isinstance(b, tuple):
            return [b]
        hits = [k for k in self._runs if k[1] == b]
        return hits or [((), b)]

    def _projected(self, key) -> int:
        return self._runs.get(key, 0) + self._inflight.get(key, 0)

    def admit(self, buckets=None, timeout_s: float = 30.0, project: bool = True, owner=None) -> bool:
        """Admit one flush or commit: block while a target bucket's projected
        runs (observed plus admitted and not yet settled) sit at or over the
        ceiling, then (project=True) charge it one run per target bucket.
        `buckets` holds bucket ids (any partition) or (partition, bucket)
        tuples; None waits for headroom everywhere and charges nothing.
        False on timeout. A blocked admission counts in
        compaction{admission_waits}."""
        bound = self.policy.read_amp_ceiling
        waited = False
        with self._runs_cond:
            targets = None if buckets is None else [k for b in buckets for k in self._keys_for(b)]

            def ok():
                if self._stop.is_set():
                    return True  # a closing service strands no waiter
                keys = self._runs if targets is None else targets
                return all(self._projected(k) < bound for k in keys)

            if not ok():
                waited = True
                admitted = self._runs_cond.wait_for(ok, timeout_s)
            else:
                admitted = True
            if admitted and project and targets is not None:
                for k in targets:
                    self._inflight[k] = self._inflight.get(k, 0) + 1
                if owner is not None:
                    self._owner_charges.setdefault(owner, []).extend(targets)
        if waited:
            compaction_metrics().counter("admission_waits").inc()
        return admitted

    def settle(self, buckets, landed: bool = True, owner=None) -> None:
        """Release admit()'s charge: a landed run moves into the observed
        count until the next observation, an aborted one vanishes."""
        with self._runs_cond:
            for b in buckets:
                for k in self._keys_for(b):
                    self._settle_key(k, landed)
                    if owner is not None:
                        ledger = self._owner_charges.get(owner)
                        if ledger is not None and k in ledger:
                            ledger.remove(k)
                            if not ledger:
                                self._owner_charges.pop(owner, None)
            self._runs_cond.notify_all()

    def _settle_key(self, k: tuple, landed: bool) -> None:
        cur = self._inflight.get(k, 0)
        if cur <= 1:
            self._inflight.pop(k, None)
        else:
            self._inflight[k] = cur - 1
        if landed:
            self._runs[k] = self._runs.get(k, 0) + 1

    def release_owner(self, owner) -> int:
        """Drop every charge `owner` still holds; returns how many."""
        with self._runs_cond:
            ledger = self._owner_charges.pop(owner, None) or []
            for k in ledger:
                self._settle_key(k, landed=False)
            if ledger:
                self._runs_cond.notify_all()
            return len(ledger)

    @staticmethod
    def _publish(shapes: list[BucketShape]) -> None:
        g = compaction_metrics()
        g.gauge("debt_files").set(sum(s.debt_files for s in shapes))
        g.gauge("debt_bytes").set(sum(s.debt_bytes for s in shapes))
        if shapes:
            g.gauge("read_amplification_p99").set(float(np.percentile([s.read_amp for s in shapes], 99)))

    def _compact_group(self, group: list[CompactionDecision], deep: bool) -> int:
        """One COMPACT commit over every bucket of the group; 0 when there
        was nothing to do or a rival commit won."""
        if self._stop.is_set() or not group:
            return 0
        g = compaction_metrics()
        tw = TableWrite(self.table)
        try:
            for d in group:
                tw._writer(d.partition, d.bucket)  # these buckets only
            tw.compact(full=deep)
            msgs = tw.prepare_commit()
            if not msgs:
                return 0
            TableCommit(self.table).commit_messages(BATCH_COMMIT_IDENTIFIER, msgs)
        except (CommitConflictError, CommitGiveUpError):
            g.counter("adaptive_conflicts").inc()
            return 0
        g.counter("adaptive_runs").inc(len(group))
        self.note_compaction_landed(group)
        return len(group)

    def note_compaction_landed(self, group: list[CompactionDecision]) -> None:
        """After a group's COMPACT commit landed: a deep rewrite consumed the
        runs observed at decision time, so the gate counts them as one now
        (runs landed since stay counted) and wakes its waiters."""
        for d in group:
            self.policy.note_compacted(d.partition, d.bucket)
            if d.deep:
                key = (d.partition, d.bucket)
                with self._runs_cond:
                    cur = self._runs.get(key, d.runs)
                    self._runs[key] = max(1, cur - d.runs + 1)
                    self._runs_cond.notify_all()

    def run_round(self) -> int:
        """One observe, decide, execute round; returns the buckets
        compacted. Safe from any thread."""
        g = compaction_metrics()
        shapes = self.observe()
        decisions, deferred = self.policy.decide(shapes, time.monotonic())
        if deferred:
            g.counter("deferred_buckets").inc(deferred)
        deep_group = [d for d in decisions if d.deep]
        shallow_group = [d for d in decisions if not d.deep]
        groups = [(grp, deep) for grp, deep in ((deep_group, True), (shallow_group, False)) if grp]
        if self._execute_group is not None:
            done = sum(self._execute_group(grp, deep) for grp, deep in groups)
        elif len(groups) > 1 and self.parallelism > 1:
            # the two groups commit independently through the snapshot CAS
            done = sum(self._executor().map(lambda gd: self._compact_group(*gd), groups))
        else:
            done = sum(self._compact_group(grp, deep) for grp, deep in groups)
        self.rounds += 1
        self.compactions += done
        return done

    def _executor(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.parallelism, thread_name_prefix=f"{self.THREAD_PREFIX}-exec")
        return self._pool

    def start(self) -> "AdaptiveCompactorService":
        if self._thread is not None:
            return self
        self._stop.clear()
        with _GATES_LOCK:
            _ACTIVE_GATES[str(self.table.path)] = self
        self._thread = threading.Thread(
            target=self._loop, name=f"{self.THREAD_PREFIX}-{id(self) & 0xFFFF:x}", daemon=False
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            done = 0
            try:
                done = self.run_round()
            except Exception:
                # a race with expiry or a failed round: keep it, observe again
                self._errors.append(traceback.format_exc())
                del self._errors[:-20]
            # a round that compacted looks again at once; an idle one sleeps
            self._stop.wait(self.interval_s if done == 0 else 0.005)

    def close(self) -> None:
        self._stop.set()
        with _GATES_LOCK:
            if _ACTIVE_GATES.get(str(self.table.path)) is self:
                _ACTIVE_GATES.pop(str(self.table.path))
        with self._runs_cond:
            self._runs_cond.notify_all()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=120.0)
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def __enter__(self) -> "AdaptiveCompactorService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
