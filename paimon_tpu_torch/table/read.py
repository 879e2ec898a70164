"""Read builder: scan planning -> splits -> merge reads (port of
paimon_tpu/table/read.py; time travel, incremental and streaming scans
are not ported yet).

with_filter ANDs predicates. The scan keeps the partitions that the
predicate's partition-only conjuncts accept and the files whose key stats
its key-only conjuncts accept; the read pushes the predicate into the
merge (core/read.py) and applies the split's deletion vectors.

Splits come in the JAX package's order: each partition's splits by sorted
bucket, the partitions sorted and taken round-robin (one split of each in
turn) or, under scan.plan-sort-partition=true, one after another; read_all
concatenates them in that order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Sequence

from ..core.datafile import DataFileMeta
from ..core.deletionvectors import DeletionVectorsIndexFile
from ..core.levels import IntervalPartition
from ..data.batch import ColumnBatch, concat_batches
from ..data.predicate import Predicate, PredicateBuilder, and_
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
    dv_index_file: str | None = None  # the bucket's deletion-vector container


class ReadBuilder:
    def __init__(self, table: "FileStoreTable"):
        self.table = table
        self._predicate: Predicate | None = None
        self._projection: Sequence[str] | None = None

    def with_filter(self, predicate: Predicate) -> "ReadBuilder":
        self._predicate = predicate if self._predicate is None else (self._predicate & predicate)
        return self

    def with_projection(self, fields: Sequence[str]) -> "ReadBuilder":
        self._projection = list(fields)
        return self

    def new_scan(self) -> "TableScan":
        return TableScan(self.table, self._predicate)

    def new_read(self) -> "TableRead":
        return TableRead(self.table, self._predicate, self._projection)


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
    def __init__(self, table: "FileStoreTable", predicate: Predicate | None = None):
        self.table = table
        self.predicate = predicate

    def _partition_predicate(self):
        """partition tuple -> bool from the predicate's partition-only
        conjuncts, or None when none prunes."""
        store = self.table.store
        parts = PredicateBuilder.pick_by_fields(PredicateBuilder.split_and(self.predicate), set(store.partition_keys))
        if not parts:
            return None
        pred = and_(*parts)
        keys = store.partition_keys
        row_type = self.table.row_type.project(keys)

        def accept(partition: tuple) -> bool:
            row = ColumnBatch.from_pydict(row_type, {k: [v] for k, v in zip(keys, partition)})
            return bool(pred.eval(row)[0])

        return accept

    def plan(self) -> list[DataSplit]:
        store = self.table.store
        scan = store.new_scan()
        if self.predicate is not None:
            key_parts = PredicateBuilder.pick_by_fields(PredicateBuilder.split_and(self.predicate), set(store.key_names))
            if key_parts:
                scan = scan.with_key_filter(and_(*key_parts))
            accept = self._partition_predicate()
            if accept is not None:
                scan = scan.with_partition_filter(accept)
        plan = scan.plan()
        target = int(store.options.options.get(CoreOptions.SOURCE_SPLIT_TARGET_SIZE))
        open_cost = int(store.options.options.get(CoreOptions.SOURCE_SPLIT_OPEN_FILE_COST))
        snapshot = plan.snapshot.id if plan.snapshot else None
        lanes = [
            [
                DataSplit(partition, bucket, pack, snapshot, plan.dv_index_for(partition, bucket))
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
    def __init__(self, table: "FileStoreTable", predicate: Predicate | None, projection: Sequence[str] | None):
        self.table = table
        self.predicate = predicate
        self.projection = projection

    def read(self, split: DataSplit) -> ColumnBatch:
        dvs = None
        if split.dv_index_file:
            every = DeletionVectorsIndexFile(self.table.file_io, self.table.path).read_all(split.dv_index_file)
            names = {f.file_name for f in split.files}
            dvs = {name: dv for name, dv in every.items() if name in names}
        return self.table.store.read_bucket(
            split.partition, split.bucket, split.files, self.predicate, self.projection, deletion_vectors=dvs
        )

    def read_all(self, splits: Sequence[DataSplit]) -> ColumnBatch:
        batches = [self.read(s) for s in splits]
        if not batches:
            schema = self.table.row_type
            return ColumnBatch.empty(schema if self.projection is None else schema.project(self.projection))
        return concat_batches(batches)
