"""LSM levels, sorted runs and section partitioning (port of
paimon_tpu/core/levels.py).

Level 0 holds one sorted run per file, newest (highest max sequence
number) first; every higher level holds one sorted run. A section is a set of files whose key ranges chain into one interval;
different sections never share a key, so they concatenate, while the runs
within a section must merge. IntervalPartition packs each section into the
fewest sorted runs (greedy min-heap on each run's last max_key).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

from .datafile import DataFileMeta

__all__ = ["SortedRun", "Levels", "IntervalPartition"]


@dataclass
class SortedRun:
    """Files sorted by min_key with pairwise-disjoint key ranges."""

    files: list[DataFileMeta] = field(default_factory=list)

    @staticmethod
    def from_sorted(files: list[DataFileMeta]) -> "SortedRun":
        return SortedRun(sorted(files, key=lambda f: f.min_key))

    def total_size(self) -> int:
        return sum(f.file_size for f in self.files)

    def row_count(self) -> int:
        return sum(f.row_count for f in self.files)

    def validate(self) -> None:
        for a, b in zip(self.files, self.files[1:]):
            if not a.max_key < b.min_key:
                raise ValueError(f"overlapping run: {a.file_name} .. {b.file_name}")


class Levels:
    """The level structure of one bucket."""

    def __init__(self, files: list[DataFileMeta], num_levels: int):
        self.num_levels = max(num_levels, max((f.level for f in files), default=0) + 1)
        self.level0: list[DataFileMeta] = sorted(
            [f for f in files if f.level == 0], key=lambda f: -f.max_sequence_number
        )
        self.runs: dict[int, SortedRun] = {}
        for lv in range(1, self.num_levels):
            lv_files = [f for f in files if f.level == lv]
            if lv_files:
                run = SortedRun.from_sorted(lv_files)
                run.validate()
                self.runs[lv] = run

    def all_files(self) -> list[DataFileMeta]:
        out = list(self.level0)
        for lv in sorted(self.runs):
            out.extend(self.runs[lv].files)
        return out

    def number_of_sorted_runs(self) -> int:
        return len(self.level0) + len(self.runs)

    def non_empty_highest_level(self) -> int:
        for lv in range(self.num_levels - 1, 0, -1):
            if lv in self.runs:
                return lv
        return 0 if self.level0 else -1

    def level_sorted_runs(self) -> list[tuple[int, SortedRun]]:
        """(level, run) pairs; each level-0 file is its own run."""
        out: list[tuple[int, SortedRun]] = [(0, SortedRun([f])) for f in self.level0]
        for lv in sorted(self.runs):
            out.append((lv, self.runs[lv]))
        return out

    def update(self, before: list[DataFileMeta], after: list[DataFileMeta]) -> None:
        """Drop `before` (by file name: an upgraded file leaves its old level)
        and add `after`."""
        remove = {f.file_name for f in before}
        files = [f for f in self.all_files() if f.file_name not in remove] + list(after)
        fresh = Levels(files, self.num_levels)
        self.level0, self.runs, self.num_levels = fresh.level0, fresh.runs, fresh.num_levels


class IntervalPartition:
    """Partition a set of files into sections of minimal sorted runs."""

    def __init__(self, files: list[DataFileMeta]):
        # order by (min_key, max_key) — reference IntervalPartition ctor
        self.files = sorted(files, key=lambda f: (f.min_key, f.max_key))

    def partition(self) -> list[list[SortedRun]]:
        sections: list[list[DataFileMeta]] = []
        current: list[DataFileMeta] = []
        bound = None
        for f in self.files:
            if current and f.min_key > bound:
                sections.append(current)
                current = []
                bound = None
            current.append(f)
            bound = f.max_key if bound is None else max(bound, f.max_key)
        if current:
            sections.append(current)
        return [self._pack(sec) for sec in sections]

    @staticmethod
    def _pack(section: list[DataFileMeta]) -> list[SortedRun]:
        """Greedy minimal-run packing: a min-heap keyed by each run's current
        max_key; a file extends the run it doesn't overlap, else opens a new
        run (reference IntervalPartition.partition :93-125)."""
        heap: list[tuple[tuple, int, list[DataFileMeta]]] = []
        counter = 0
        for f in section:  # already sorted by (min_key, max_key)
            if heap and heap[0][0] < f.min_key:
                _, _, run = heapq.heappop(heap)
                run.append(f)
                heapq.heappush(heap, (f.max_key, counter, run))
            else:
                heapq.heappush(heap, (f.max_key, counter, [f]))
            counter += 1
        return [SortedRun(run) for _, _, run in sorted(heap, key=lambda t: t[1])]
