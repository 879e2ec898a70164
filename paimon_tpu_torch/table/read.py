"""Read builder: scan planning -> splits -> merge reads (port of
paimon_tpu/table/read.py).

with_filter ANDs predicates. The scan keeps the partitions that the
predicate's partition-only conjuncts accept and the files whose key stats
its key-only conjuncts accept (on an append table, whose rows are all
final, the files whose value stats the whole predicate accepts); the read
pushes the predicate into the merge (core/read.py) or the concatenation
(core/store.py) and applies the split's deletion vectors. Under
file-index.read.enabled (the default) the plan also drops the files whose
bloom index (format/fileindex.py, embedded or a sidecar) proves that no
row can match: the key conjuncts on a primary-key table, the whole
predicate on an append table. A missing or unreadable index keeps the
file.

A batch scan plans the latest snapshot or the one the time-travel options
select: scan.snapshot-id, scan.tag-name, scan.timestamp-millis or
scan.timestamp (the last snapshot at or before it; the latest when none
is), scan.version (a tag name, else an id) and scan.watermark (the
earliest snapshot whose watermark reaches it). scan.mode and branch do not
move a batch scan: a branch is read through load_table or branch_table.
incremental-between='a,b' (ids or tags, a exclusive) and
incremental-between-timestamp read the changes of (a, b] instead: the new
files of APPEND snapshots (delta mode) or the changelog files (changelog
mode), one changelog split per snapshot and bucket, read unmerged with
their row kinds.

Splits come in the JAX package's order: each partition's splits by sorted
bucket, the partitions sorted and taken round-robin (one split of each in
turn) or, under scan.plan-sort-partition=true, one after another; read_all
concatenates them in that order, up to the limit.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import TYPE_CHECKING, Sequence

import numpy as np

from ..core.datafile import DataFileMeta
from ..core.deletionvectors import DeletionVectorsIndexFile
from ..core.levels import IntervalPartition
from ..core.snapshot import CommitKind
from ..data.batch import ColumnBatch, concat_batches
from ..data.predicate import Predicate, PredicateBuilder, and_
from ..options import CoreOptions
from ..types import RowKind
from .tags import TagManager

if TYPE_CHECKING:
    from . import FileStoreTable
    from .stream import StreamTableScan

__all__ = ["ReadBuilder", "TableScan", "TableRead", "DataSplit"]


@dataclass
class DataSplit:
    """A self-contained unit of read work; to_dict/from_dict use the JAX
    package's keys, so a split serialised by one package opens in the
    other."""

    partition: tuple
    bucket: int
    files: list[DataFileMeta]
    snapshot_id: int | None = None
    raw_convertible: bool = False  # one sorted run per section: no merge needed
    dv_index_file: str | None = None  # the bucket's deletion-vector container
    is_changelog: bool = False  # read unmerged, row kinds kept

    @property
    def row_count(self) -> int:
        return sum(f.row_count for f in self.files)

    def to_dict(self) -> dict:
        return {
            "partition": list(self.partition),
            "bucket": self.bucket,
            "files": [f.to_dict() for f in self.files],
            "snapshotId": self.snapshot_id,
            "rawConvertible": self.raw_convertible,
            "dvIndexFile": self.dv_index_file,
            "isChangelog": self.is_changelog,
        }

    @staticmethod
    def from_dict(d: dict) -> "DataSplit":
        return DataSplit(
            partition=tuple(d["partition"]),
            bucket=d["bucket"],
            files=[DataFileMeta.from_dict(f) for f in d["files"]],
            snapshot_id=d.get("snapshotId"),
            raw_convertible=d.get("rawConvertible", False),
            dv_index_file=d.get("dvIndexFile"),
            is_changelog=d.get("isChangelog", False),
        )


class ReadBuilder:
    def __init__(self, table: "FileStoreTable"):
        self.table = table
        self._predicate: Predicate | None = None
        self._projection: Sequence[str] | None = None
        self._limit: int | None = None

    def with_filter(self, predicate: Predicate) -> "ReadBuilder":
        self._predicate = predicate if self._predicate is None else (self._predicate & predicate)
        return self

    def with_projection(self, fields: Sequence[str]) -> "ReadBuilder":
        self._projection = list(fields)
        return self

    def with_limit(self, limit: int) -> "ReadBuilder":
        self._limit = limit
        return self

    def new_scan(self) -> "TableScan":
        return TableScan(self.table, self._predicate)

    def new_stream_scan(self) -> "StreamTableScan":
        from .stream import StreamTableScan

        return StreamTableScan(self.table, self._predicate)

    def new_read(self) -> "TableRead":
        return TableRead(self.table, self._predicate, self._projection, self._limit)


def _pack_bucket_splits(files, target: int, open_cost: int, keyed: bool = True) -> list[tuple[list, bool]]:
    """Bin-pack one bucket's units into read splits, weighing each unit
    max(total size, open-file cost); (files, raw_convertible) per pack. On
    a primary-key table a unit is a section (files that must merge together
    stay in one split), raw when it is one sorted run; on an append table
    it is one file, in (min_sequence_number, file_name) order, always raw."""
    if keyed:
        units = [([f for run in section for f in run.files], len(section) == 1)
                 for section in IntervalPartition(files).partition()]
    else:
        units = [([f], True) for f in sorted(files, key=lambda f: (f.min_sequence_number, f.file_name))]
    packs: list[tuple[list, bool]] = []
    cur: list = []
    cur_raw = True
    cur_weight = 0
    for unit, raw in units:
        w = max(sum(f.file_size for f in unit), open_cost)
        if cur and cur_weight + w > target:
            packs.append((cur, cur_raw))
            cur, cur_raw, cur_weight = [], True, 0
        cur.extend(unit)
        cur_raw = cur_raw and raw
        cur_weight += w
    if cur:
        packs.append((cur, cur_raw))
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

    def _resolve_snapshot(self) -> int | None:
        """The snapshot the time-travel options select, or None (the
        latest)."""
        opts = self.table.options.options
        sid = opts.get(CoreOptions.SCAN_SNAPSHOT_ID)
        if sid is not None:
            return sid
        tags = TagManager(self.table.file_io, self.table.path)
        tag = opts.get(CoreOptions.SCAN_TAG_NAME)
        if tag:
            return tags.snapshot_id(tag)
        sm = self.table.store.snapshot_manager
        ts = opts.get(CoreOptions.SCAN_TIMESTAMP_MILLIS)
        if ts is None:
            iso = opts.get(CoreOptions.SCAN_TIMESTAMP)
            if iso:
                # a naive time is in the local zone, as the JAX package reads it
                ts = int(datetime.datetime.fromisoformat(iso).timestamp() * 1000)
        if ts is not None:
            snap = sm.earlier_or_equal_time_millis(ts)
            return snap.id if snap else None
        version = opts.get(CoreOptions.SCAN_VERSION)
        if version:
            return tags.snapshot_id(version) if version in tags.list_tags() else int(version)
        wm = opts.get(CoreOptions.SCAN_WATERMARK)
        if wm is not None:
            return next((s.id for s in sm.snapshots() if s.watermark is not None and s.watermark >= wm), None)
        return None

    def _incremental_splits(self, spec: str) -> list[DataSplit]:
        """The changes of snapshots (start, end] of `spec` ('start,end', ids
        or tag names): one changelog split per snapshot and bucket."""
        store = self.table.store
        sm = store.snapshot_manager
        tags = TagManager(self.table.file_io, self.table.path)

        def resolve(token: str) -> int:
            token = token.strip()
            if token.lstrip("-").isdigit():
                return int(token)
            try:
                return tags.snapshot_id(token)
            except FileNotFoundError:
                raise ValueError(f"unknown tag {token!r} in incremental-between") from None

        parts = spec.split(",")
        if len(parts) != 2:
            raise ValueError(f"incremental-between expects 'start,end', got {spec!r}")
        start, end = resolve(parts[0]), resolve(parts[1])
        if start >= end:
            raise ValueError(f"incremental-between start must precede end, got {start} >= {end}")
        mode = store.options.options.get(CoreOptions.INCREMENTAL_BETWEEN_SCAN_MODE).lower()
        if mode not in ("delta", "changelog"):
            raise ValueError(f"unknown incremental-between-scan-mode {mode!r}")
        accept = self._partition_predicate()
        splits: list[DataSplit] = []
        for sid in range(start + 1, end + 1):
            if not sm.snapshot_exists(sid):
                continue
            snap = sm.snapshot(sid)
            if mode == "changelog":
                # COMPACT snapshots carry the full-compaction producer's files
                if not snap.changelog_manifest_list:
                    continue
            elif snap.commit_kind != CommitKind.APPEND:
                continue  # a compaction or overwrite adds no change
            scan = store.new_scan().with_snapshot(sid).with_kind(mode)
            if accept is not None:
                scan = scan.with_partition_filter(accept)
            splits += [
                DataSplit(partition=partition, bucket=bucket, files=files, snapshot_id=sid, is_changelog=True)
                for partition, buckets in sorted(scan.plan().grouped().items())
                for bucket, files in sorted(buckets.items())
            ]
        return splits

    def plan(self) -> list[DataSplit]:
        store = self.table.store
        opts = store.options.options
        inc = opts.get(CoreOptions.INCREMENTAL_BETWEEN)
        if inc:
            return self._incremental_splits(inc)
        inc_ts = opts.get(CoreOptions.INCREMENTAL_BETWEEN_TIMESTAMP)
        if inc_ts:
            t1, t2 = (int(x) for x in inc_ts.split(","))
            s1 = store.snapshot_manager.earlier_or_equal_time_millis(t1)
            s2 = store.snapshot_manager.earlier_or_equal_time_millis(t2)
            start = s1.id if s1 else 0
            if s2 is None or start >= s2.id:
                return []  # no snapshot landed between t1 and t2
            return self._incremental_splits(f"{start},{s2.id}")
        keyed = self.table.is_primary_key_table
        scan = store.new_scan()
        snapshot_id = self._resolve_snapshot()
        if snapshot_id is not None:
            scan = scan.with_snapshot(snapshot_id)
        if self.predicate is not None:
            key_parts = PredicateBuilder.pick_by_fields(PredicateBuilder.split_and(self.predicate), set(store.key_names))
            if key_parts:
                scan = scan.with_key_filter(and_(*key_parts))
            if not keyed:
                # every row of an append table is final: value stats may
                # skip whole files
                scan = scan.with_value_filter(self.predicate)
            accept = self._partition_predicate()
            if accept is not None:
                scan = scan.with_partition_filter(accept)
        plan = scan.plan()
        target = int(opts.get(CoreOptions.SOURCE_SPLIT_TARGET_SIZE))
        open_cost = int(opts.get(CoreOptions.SOURCE_SPLIT_OPEN_FILE_COST))
        created_after = opts.get(CoreOptions.SCAN_FILE_CREATION_TIME_MILLIS)
        snapshot = plan.snapshot.id if plan.snapshot else None
        index_pred = self._file_index_predicate(keyed)
        lanes = []
        for partition, buckets in sorted(plan.grouped().items(), key=lambda kv: kv[0]):
            lane = []
            for bucket, files in sorted(buckets.items()):
                if created_after is not None:
                    files = [f for f in files if f.creation_time_millis > created_after]
                if index_pred is not None:
                    bd = store.bucket_dir(partition, bucket)
                    files = [f for f in files if self._index_accepts(f, bd, index_pred)]
                lane += [
                    DataSplit(
                        partition=partition,
                        bucket=bucket,
                        files=pack,
                        snapshot_id=snapshot,
                        raw_convertible=raw,
                        dv_index_file=plan.dv_index_for(partition, bucket),
                    )
                    for pack, raw in _pack_bucket_splits(files, target, open_cost, keyed)
                ]
            lanes.append(lane)
        if opts.get(CoreOptions.SCAN_PLAN_SORT_PARTITION):
            return [split for lane in lanes for split in lane]
        # round-robin across the sorted partitions: the i-th split of each
        # partition, then the (i+1)-th
        return [lane[i] for i in range(max(map(len, lanes), default=0)) for lane in lanes if i < len(lane)]

    def _file_index_predicate(self, keyed: bool) -> Predicate | None:
        """The predicate the files' bloom indexes are tested against, or
        None. A primary-key table tests its key conjuncts only: a value
        matching in an old file may be overridden by a newer one, but a key
        absent from every index cannot exist."""
        if self.predicate is None:
            return None
        if not self.table.store.options.options.get(CoreOptions.FILE_INDEX_READ_ENABLED):
            return None
        if not keyed:
            return self.predicate
        parts = PredicateBuilder.pick_by_fields(
            PredicateBuilder.split_and(self.predicate), set(self.table.store.key_names)
        )
        return and_(*parts) if parts else None

    def _index_accepts(self, f: DataFileMeta, bucket_dir: str, pred: Predicate) -> bool:
        """False only where the file's index proves that no row matches."""
        from ..format.fileindex import FileIndexPredicate

        try:
            if f.embedded_index is not None:
                return FileIndexPredicate.from_bytes(f.embedded_index).test(pred)
            if f"{f.file_name}.index" in f.extra_files:
                return FileIndexPredicate(self.table.file_io, f"{bucket_dir}/{f.file_name}.index").test(pred)
        except (OSError, ValueError):
            return True
        return True


class TableRead:
    def __init__(
        self,
        table: "FileStoreTable",
        predicate: Predicate | None,
        projection: Sequence[str] | None,
        limit: int | None = None,
    ):
        self.table = table
        self.predicate = predicate
        self.projection = projection
        self.limit = limit

    def read_with_kinds(self, split: DataSplit) -> tuple[ColumnBatch, np.ndarray]:
        """(rows, RowKind uint8 per row). A changelog split's files are read
        unmerged in (min_sequence_number, file_name) order, their kinds
        kept, filtered by the predicate (no deletion vectors, no record
        TTL, no limit); a data split's merged rows are all +I."""
        if not split.is_changelog:
            out = self.read(split)
            return out, np.full(out.num_rows, int(RowKind.INSERT), dtype=np.uint8)
        kv = self.table.store.read_raw(split.partition, split.bucket, split.files)
        data, kinds = kv.data, kv.kind
        if self.predicate is not None and data.num_rows:
            mask = self.predicate.eval(data)
            if not mask.all():
                data, kinds = data.filter(mask), kinds[mask]
        if self.projection is not None:
            data = data.select(self.projection)
        return data, kinds

    def read(self, split: DataSplit) -> ColumnBatch:
        if split.is_changelog:
            return self.read_with_kinds(split)[0]
        dvs = None
        if split.dv_index_file:
            every = DeletionVectorsIndexFile(self.table.file_io, self.table.path).read_all(split.dv_index_file)
            names = {f.file_name for f in split.files}
            dvs = {name: dv for name, dv in every.items() if name in names}
        out = self.table.store.read_bucket(
            split.partition, split.bucket, split.files, self.predicate, self.projection, deletion_vectors=dvs
        )
        if self.limit is not None and out.num_rows > self.limit:
            out = out.slice(0, self.limit)
        return out

    def read_all(self, splits: Sequence[DataSplit]) -> ColumnBatch:
        """The splits' rows in order, at most `limit` of them (the splits
        past it are not read)."""
        batches = []
        remaining = self.limit
        for s in splits:
            if remaining is not None and remaining <= 0:
                break
            b = self.read(s)
            if remaining is not None:
                b = b.slice(0, min(b.num_rows, remaining))
                remaining -= b.num_rows
            batches.append(b)
        if not batches:
            schema = self.table.row_type
            return ColumnBatch.empty(schema if self.projection is None else schema.project(self.projection))
        return concat_batches(batches)
