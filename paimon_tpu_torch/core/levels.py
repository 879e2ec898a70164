"""Sorted runs and section partitioning (port of paimon_tpu/core/levels.py;
the Levels structure that compaction uses is not ported yet).

A section is a set of files whose key ranges chain into one interval;
different sections never share a key, so they concatenate, while the runs
within a section must merge. IntervalPartition packs each section into the
fewest sorted runs (greedy min-heap on each run's last max_key).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

from .datafile import DataFileMeta

__all__ = ["SortedRun", "IntervalPartition"]


@dataclass
class SortedRun:
    """Files sorted by min_key with pairwise-disjoint key ranges."""

    files: list[DataFileMeta] = field(default_factory=list)


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
