"""Read builder: scan planning -> splits -> merge reads (port of
paimon_tpu/table/read.py; predicates and partition pruning, time travel,
incremental and streaming scans are not ported yet).

Splits come in the JAX package's order: each partition's splits by sorted
bucket, the partitions sorted and taken round-robin (one split of each in
turn) or, under scan.plan-sort-partition=true, one after another; read_all
concatenates them in that order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Sequence

from ..core.datafile import DataFileMeta
from ..core.levels import IntervalPartition
from ..data.batch import ColumnBatch, concat_batches
from ..options import CoreOptions

if TYPE_CHECKING:
    from . import FileStoreTable

__all__ = ["ReadBuilder", "TableScan", "TableRead", "DataSplit"]


@dataclass
class DataSplit:
    """A self-contained unit of read work."""

    partition: tuple
    bucket: int
    files: list[DataFileMeta]
    snapshot_id: int | None = None


class ReadBuilder:
    def __init__(self, table: "FileStoreTable"):
        self.table = table
        self._projection: Sequence[str] | None = None

    def with_filter(self, predicate) -> "ReadBuilder":
        raise NotImplementedError(
            "with_filter: predicates, and with them partition pruning, are not ported to the torch port yet"
        )

    def with_projection(self, fields: Sequence[str]) -> "ReadBuilder":
        self._projection = list(fields)
        return self

    def new_scan(self) -> "TableScan":
        return TableScan(self.table)

    def new_read(self) -> "TableRead":
        return TableRead(self.table, self._projection)


def _pack_bucket_splits(files, target: int, open_cost: int) -> list[list]:
    """Bin-pack one bucket's sections (files that must merge together stay
    in one split) into read splits, weighing each section max(total size,
    open-file cost)."""
    packs: list[list] = []
    cur: list = []
    cur_weight = 0
    for section in IntervalPartition(files).partition():
        unit = [f for run in section for f in run.files]
        w = max(sum(f.file_size for f in unit), open_cost)
        if cur and cur_weight + w > target:
            packs.append(cur)
            cur, cur_weight = [], 0
        cur.extend(unit)
        cur_weight += w
    if cur:
        packs.append(cur)
    return packs


class TableScan:
    def __init__(self, table: "FileStoreTable"):
        self.table = table

    def plan(self) -> list[DataSplit]:
        store = self.table.store
        plan = store.new_scan().plan()
        target = int(store.options.options.get(CoreOptions.SOURCE_SPLIT_TARGET_SIZE))
        open_cost = int(store.options.options.get(CoreOptions.SOURCE_SPLIT_OPEN_FILE_COST))
        snapshot = plan.snapshot.id if plan.snapshot else None
        lanes = [
            [
                DataSplit(partition, bucket, pack, snapshot)
                for bucket, files in sorted(buckets.items())
                for pack in _pack_bucket_splits(files, target, open_cost)
            ]
            for partition, buckets in sorted(plan.grouped().items(), key=lambda kv: kv[0])
        ]
        if store.options.options.get(CoreOptions.SCAN_PLAN_SORT_PARTITION):
            return [split for lane in lanes for split in lane]
        # round-robin across the sorted partitions: the i-th split of each
        # partition, then the (i+1)-th
        return [lane[i] for i in range(max(map(len, lanes), default=0)) for lane in lanes if i < len(lane)]


class TableRead:
    def __init__(self, table: "FileStoreTable", projection: Sequence[str] | None):
        self.table = table
        self.projection = projection

    def read(self, split: DataSplit) -> ColumnBatch:
        return self.table.store.read_bucket(split.partition, split.bucket, split.files, self.projection)

    def read_all(self, splits: Sequence[DataSplit]) -> ColumnBatch:
        batches = [self.read(s) for s in splits]
        if not batches:
            schema = self.table.row_type
            return ColumnBatch.empty(schema if self.projection is None else schema.project(self.projection))
        return concat_batches(batches)
