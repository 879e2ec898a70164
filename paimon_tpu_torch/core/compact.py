"""LSM compaction: the universal strategy, upgrade-or-rewrite planning and
the rewriter (port of paimon_tpu/core/compact.py, its sequential route).

UniversalCompaction picks which sorted runs to compact (size
amplification, then size ratio, then run count). The manager splits the
picked unit into sections: a lone file is upgraded to the output level
(its metadata moves, its bytes stay), unless it is a small level-0 file or
carries deletes that this compaction must drop; everything else is
rewritten through the same merge as a flush or a read (MergeExecutor, so
K1 or K2 under sort-engine=pallas). Under the full-compaction changelog
producer (and lookup without lookup-wait) a rewrite that drops deletes
also diffs each section's merged rows against its previous top-level rows
(core/changelog.py) and writes the diff as changelog files; every file of
such a compaction that is not at the output level yet is rewritten, not
upgraded, so that the diff sees it. The rewriter reads each file without
the rows its deletion vector marks and the rows record-level TTL expires,
so neither comes back; a lone file with a deletion vector is rewritten,
not upgraded, and the commit then drops the vectors of the files that
left (core/commit.py). The JAX package's pipelined and mesh rewrite
routes give the same outputs and are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..options import CoreOptions
from ..utils import now_millis
from ..utils.cache import invalidate_data_file
from .changelog import state_changelog
from .datafile import DataFileMeta, KeyValueFileReaderFactory, KeyValueFileWriterFactory
from .kv import KVBatch
from .levels import IntervalPartition, Levels, SortedRun
from .mergefn import MergeExecutor

__all__ = ["CompactUnit", "CompactResult", "UniversalCompaction", "MergeTreeCompactRewriter", "MergeTreeCompactManager"]


@dataclass
class CompactUnit:
    output_level: int
    files: list[DataFileMeta]
    file_num_based: bool = False


@dataclass
class CompactResult:
    before: list[DataFileMeta] = field(default_factory=list)
    after: list[DataFileMeta] = field(default_factory=list)
    changelog: list[DataFileMeta] = field(default_factory=list)

    def is_empty(self) -> bool:
        return not self.before and not self.after


class UniversalCompaction:
    """Pick which sorted runs to compact (RocksDB-style universal
    compaction, as in the JAX package)."""

    def __init__(
        self,
        max_size_amp_percent: int = 200,
        size_ratio_percent: int = 1,
        num_run_compaction_trigger: int = 5,
        optimization_interval_millis: int | None = None,
        max_file_num: int = 50,
    ):
        self.max_size_amp = max_size_amp_percent
        self.size_ratio = size_ratio_percent
        self.num_run_trigger = num_run_compaction_trigger
        self.opt_interval = optimization_interval_millis
        # bounds one size-ratio pick's input file count
        self.max_file_num = max_file_num
        self._last_opt_millis = now_millis()

    def pick(self, num_levels: int, runs: list[tuple[int, SortedRun]]) -> CompactUnit | None:
        max_level = num_levels - 1
        if self.opt_interval is not None and now_millis() - self._last_opt_millis >= self.opt_interval:
            self._last_opt_millis = now_millis()
            return self._unit(runs, max_level, len(runs))
        unit = self._pick_size_amp(max_level, runs)
        if unit is not None:
            return unit
        unit = self._pick_size_ratio(max_level, runs)
        if unit is not None:
            return unit
        if len(runs) > self.num_run_trigger:
            candidate = len(runs) - self.num_run_trigger + 1
            return self._unit(runs, max_level, candidate, file_num_based=True)
        return None

    def _pick_size_amp(self, max_level: int, runs) -> CompactUnit | None:
        if len(runs) <= self.num_run_trigger:
            return None
        candidate = sum(r.total_size() for _, r in runs[:-1])
        earliest = runs[-1][1].total_size()
        if earliest and candidate * 100 / earliest >= self.max_size_amp:
            return self._unit(runs, max_level, len(runs))
        return None

    def _pick_size_ratio(self, max_level: int, runs) -> CompactUnit | None:
        if len(runs) <= self.num_run_trigger:
            return None
        candidate_size = runs[0][1].total_size()
        count = 1
        files = len(runs[0][1].files)
        for _, run in runs[1:]:
            if candidate_size * (100.0 + self.size_ratio) / 100.0 < run.total_size():
                break
            if files + len(run.files) > self.max_file_num:
                break
            candidate_size += run.total_size()
            files += len(run.files)
            count += 1
        if count > 1:
            return self._unit(runs, max_level, count)
        return None

    @staticmethod
    def _unit(runs, max_level: int, count: int, file_num_based: bool = False) -> CompactUnit:
        """The output level for the first `count` runs: one below the first
        excluded run. When that is level 0 the unit takes in the remaining
        level-0 runs and the first run above level 0, and outputs at its
        level (else that level would hold two runs), or at max_level when
        every run is taken."""
        if count < len(runs):
            output = runs[count][0] - 1
            if output <= 0:
                while count < len(runs):
                    level = runs[count][0]
                    count += 1
                    if level != 0:
                        output = level
                        break
        if count == len(runs):
            output = max_level
        files = [f for _, r in runs[:count] for f in r.files]
        return CompactUnit(output, files, file_num_based)

    def force_full(self, num_levels: int, runs) -> CompactUnit | None:
        return self._unit(runs, num_levels - 1, len(runs)) if runs else None


class MergeTreeCompactRewriter:
    """Merge-read each section's runs and write the result at the output
    level. Sections are read, merged and written one after another. With
    emit_full_changelog, a rewrite that drops deletes also writes the diff
    of each section against its files at the output level as changelog."""

    def __init__(
        self,
        reader_factory: KeyValueFileReaderFactory,
        writer_factory: KeyValueFileWriterFactory,
        merge_executor: MergeExecutor,
        deletion_vectors: dict | None = None,
        emit_full_changelog: bool = False,
        row_deduplicate: bool = True,
        expire_predicate=None,
    ):
        self.reader_factory = reader_factory
        self.writer_factory = writer_factory
        self.merge = merge_executor
        # {data file name: DeletionVector} of the bucket when the writer
        # was restored
        self.deletion_vectors = deletion_vectors or {}
        # record-level TTL: the rows to keep (core/store.py)
        self.expire_predicate = expire_predicate
        self.emit_full_changelog = emit_full_changelog
        self.row_deduplicate = row_deduplicate

    def read(self, f: DataFileMeta) -> KVBatch:
        """A file's rows without its deletion vector's and the expired."""
        from .read import read_live

        kv = read_live(self.reader_factory, f, self.deletion_vectors)
        if self.expire_predicate is not None and kv.num_rows:
            keep = self.expire_predicate.eval(kv.data)
            if not keep.all():
                kv = kv.filter(keep)
        return kv

    def rewrite(
        self, sections: list[list[SortedRun]], output_level: int, drop_delete: bool
    ) -> tuple[list[DataFileMeta], list[DataFileMeta]]:
        """(files written, changelog files written)."""
        out: list[DataFileMeta] = []
        changelog: list[DataFileMeta] = []
        for section in sections:
            kv, seq_ascending, old_top = self._read_section(section, output_level)
            merged = self._merge_section(kv, seq_ascending, drop_delete)
            if self.emit_full_changelog and drop_delete:
                cl = self._section_changelog(old_top, merged)
                changelog.extend(self.writer_factory.write(cl, level=0, file_source="compact", prefix="changelog"))
            out.extend(self._write_section(merged, output_level))
        return out, changelog

    def _section_changelog(self, old_top: list[KVBatch], merged: KVBatch) -> KVBatch:
        """The section's rows at the output level before this compaction
        against its merged rows."""
        before = KVBatch.concat(old_top) if old_top else merged.slice(0, 0)
        return state_changelog(before, merged, self.merge.key_names, self.row_deduplicate)

    def _read_section(self, section: list[SortedRun], output_level: int) -> tuple[KVBatch, bool, list[KVBatch]]:
        """The section's runs concatenated in merge order, whether their
        sequence ranges ascend disjointly (then stability orders equal keys),
        and the rows of its files at the output level."""
        from .read import order_runs_for_merge

        runs, seq_ascending = order_runs_for_merge(section)
        files = [f for run in runs for f in run.files]
        batches = [self.read(f) for f in files]
        old_top = [b for f, b in zip(files, batches) if f.level == output_level]
        return KVBatch.concat(batches), seq_ascending, old_top

    def _merge_section(self, kv: KVBatch, seq_ascending: bool, drop_delete: bool) -> KVBatch:
        merged = self.merge.merge(kv, seq_ascending=seq_ascending)
        return merged.drop_deletes() if drop_delete else merged

    def _write_section(self, merged: KVBatch, output_level: int) -> list[DataFileMeta]:
        return self.writer_factory.write(merged, output_level, file_source="compact")

    def upgrade(self, file: DataFileMeta, output_level: int) -> DataFileMeta:
        return file.upgrade(output_level)


class MergeTreeCompactManager:
    """Decides when and what to compact for one bucket's Levels, and runs
    the compaction synchronously."""

    def __init__(
        self,
        levels: Levels,
        strategy: UniversalCompaction,
        rewriter: MergeTreeCompactRewriter,
        options: CoreOptions,
    ):
        self.levels = levels
        self.strategy = strategy
        self.rewriter = rewriter
        self.options = options

    def trigger_compaction(self, full: bool = False) -> CompactResult | None:
        plan = self._plan_unit(full)
        if plan is None:
            return None
        unit, drop_delete, result, rewrite_sections = plan
        after, changelog = (
            self.rewriter.rewrite(rewrite_sections, unit.output_level, drop_delete) if rewrite_sections else ([], [])
        )
        result.changelog.extend(changelog)
        return self._finish(result, rewrite_sections, after)

    def _plan_unit(self, full: bool = False):
        """Pick the unit and split it into upgrades and rewrites without
        reading any file: (unit, drop_delete, result, rewrite_sections), or
        None when there is nothing to compact."""
        runs = self.levels.level_sorted_runs()
        if full:
            unit = self.strategy.force_full(self.levels.num_levels, runs)
        else:
            unit = self.strategy.pick(self.levels.num_levels, runs)
        if unit is None or not unit.files:
            return None
        # deletes are dropped only where no older level lies below the output
        drop_delete = unit.output_level != 0 and unit.output_level >= self.levels.non_empty_highest_level()
        result = CompactResult()
        rewrite_sections: list[list[SortedRun]] = []
        min_rewrite_size = self.options.target_file_size  # files below target get merged together
        # the full changelog must see every row that reaches the top level:
        # an upgrade would move a file there unseen
        force_rewrite = self.rewriter.emit_full_changelog and drop_delete
        for section in IntervalPartition(unit.files).partition():
            if len(section) > 1:
                rewrite_sections.append(section)
                continue
            for f in section[0].files:
                # a deletion vector's rows leave the file only by a rewrite
                if (
                    f.file_name in self.rewriter.deletion_vectors
                    or (force_rewrite and f.level != unit.output_level)
                    or not self._can_upgrade(f, drop_delete, min_rewrite_size)
                ):
                    rewrite_sections.append([SortedRun([f])])
                elif f.level != unit.output_level:  # at the output level already: untouched
                    result.before.append(f)
                    result.after.append(self.rewriter.upgrade(f, unit.output_level))
        return unit, drop_delete, result, rewrite_sections

    def _finish(self, result: CompactResult, rewrite_sections, after: list[DataFileMeta]) -> CompactResult:
        """Fold the rewrite's outputs into the result, drop the rewritten
        inputs from the data-file cache (they left the live view; an
        upgraded file keeps its name and stays) and update Levels."""
        rewritten = [f for section in rewrite_sections for run in section for f in run.files]
        result.before.extend(rewritten)
        result.after.extend(after)
        for f in rewritten:
            invalidate_data_file(f.file_name)
        if not result.is_empty():
            self.levels.update(result.before, result.after)
        return result

    @staticmethod
    def _can_upgrade(f: DataFileMeta, drop_delete: bool, min_size: int) -> bool:
        if f.level == 0 and f.file_size < min_size:
            return False  # small level-0 files are merged together
        if drop_delete and f.delete_row_count > 0:
            return False  # rewritten so that its deletes are dropped
        return True
