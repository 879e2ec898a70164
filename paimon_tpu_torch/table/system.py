"""System tables: table metadata read as tables (port of
paimon_tpu/table/system.py): $snapshots, $schemas, $options, $files,
$manifests, $tags, $branches, $consumers, $partitions, $buckets,
$audit_log, $read_optimized, $statistics, $aggregation_fields and
$file_monitor, each with the JAX package's columns.

Opened as `catalog.get_table("db.t$snapshots")` or `system_table(t, name)`.
$audit_log and $read_optimized read the data on the table's device; the
others are static batches built from the metadata on the host.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from ..data.batch import ColumnBatch
from ..types import BIGINT, INT, STRING, RowKind, RowType

if TYPE_CHECKING:
    from . import FileStoreTable

__all__ = ["system_table", "SYSTEM_TABLES"]


def system_table(table: "FileStoreTable", name: str):
    try:
        fn = SYSTEM_TABLES[name]
    except KeyError:
        raise ValueError(f"unknown system table {name!r}; known: {sorted(SYSTEM_TABLES)}") from None
    return fn(table)


class _StaticTable:
    """A read-only snapshot of metadata as a ColumnBatch-producing table."""

    def __init__(self, name: str, batch: ColumnBatch):
        self.name = name
        self._batch = batch
        self.row_type = batch.schema

    def read(self) -> ColumnBatch:
        return self._batch

    def to_pylist(self):
        return self._batch.to_pylist()


def _snapshots(table: "FileStoreTable") -> _StaticTable:
    schema = RowType.of(
        ("snapshot_id", BIGINT(False)),
        ("schema_id", BIGINT(False)),
        ("commit_user", STRING(False)),
        ("commit_identifier", BIGINT(False)),
        ("commit_kind", STRING(False)),
        ("commit_time", BIGINT(False)),
        ("total_record_count", BIGINT()),
        ("delta_record_count", BIGINT()),
        ("watermark", BIGINT()),
    )
    rows = [
        (s.id, s.schema_id, s.commit_user, s.commit_identifier, s.commit_kind.value, s.time_millis,
         s.total_record_count, s.delta_record_count, s.watermark)
        for s in table.store.snapshot_manager.snapshots()
    ]
    return _StaticTable("snapshots", ColumnBatch.from_pylist(schema, rows))


def _schemas(table: "FileStoreTable") -> _StaticTable:
    schema = RowType.of(
        ("schema_id", BIGINT(False)),
        ("fields", STRING(False)),
        ("partition_keys", STRING(False)),
        ("primary_keys", STRING(False)),
        ("options", STRING(False)),
        ("update_time", BIGINT(False)),
    )
    from ..utils import dumps

    rows = [
        (sid, dumps([f.to_dict() for f in ts.fields]), dumps(list(ts.partition_keys)),
         dumps(list(ts.primary_keys)), dumps(ts.options), ts.time_millis)
        for sid, ts in sorted(table.store.schema_manager.all_schemas().items())
    ]
    return _StaticTable("schemas", ColumnBatch.from_pylist(schema, rows))


def _options(table: "FileStoreTable") -> _StaticTable:
    schema = RowType.of(("key", STRING(False)), ("value", STRING(False)))
    rows = sorted(table.schema.options.items())
    return _StaticTable("options", ColumnBatch.from_pylist(schema, rows))


def _files(table: "FileStoreTable") -> _StaticTable:
    schema = RowType.of(
        ("partition", STRING(False)),
        ("bucket", INT(False)),
        ("file_path", STRING(False)),
        ("level", INT(False)),
        ("record_count", BIGINT(False)),
        ("file_size_in_bytes", BIGINT(False)),
        ("min_key", STRING()),
        ("max_key", STRING()),
        ("min_sequence_number", BIGINT(False)),
        ("max_sequence_number", BIGINT(False)),
        ("creation_time", BIGINT(False)),
    )
    rows = []
    plan = table.store.new_scan().plan()
    for e in plan.entries:
        f = e.file
        rows.append(
            (str(list(e.partition)), e.bucket, f.file_name, f.level, f.row_count, f.file_size,
             str(list(f.min_key)), str(list(f.max_key)), f.min_sequence_number, f.max_sequence_number,
             f.creation_time_millis)
        )
    return _StaticTable("files", ColumnBatch.from_pylist(schema, rows))


def _manifests(table: "FileStoreTable") -> _StaticTable:
    schema = RowType.of(
        ("file_name", STRING(False)),
        ("file_size", BIGINT(False)),
        ("num_added_files", BIGINT(False)),
        ("num_deleted_files", BIGINT(False)),
        ("schema_id", BIGINT(False)),
    )
    snap = table.store.snapshot_manager.latest_snapshot()
    rows = []
    if snap is not None:
        from ..core.manifest import ManifestList

        ml = ManifestList(table.file_io, f"{table.path}/manifest")
        metas = ml.read(snap.base_manifest_list) + ml.read(snap.delta_manifest_list)
        rows = [(m.file_name, m.file_size, m.num_added_files, m.num_deleted_files, m.schema_id) for m in metas]
    return _StaticTable("manifests", ColumnBatch.from_pylist(schema, rows))


def _tags(table: "FileStoreTable") -> _StaticTable:
    schema = RowType.of(("tag_name", STRING(False)), ("snapshot_id", BIGINT(False)))
    rows = sorted(table.tags().items())
    return _StaticTable("tags", ColumnBatch.from_pylist(schema, rows))


def _branches(table: "FileStoreTable") -> _StaticTable:
    from ..core.schema import SchemaManager
    from ..core.snapshot import SnapshotManager
    from .branch import BranchManager

    schema = RowType.of(
        ("branch_name", STRING(False)),
        ("created_from_snapshot", BIGINT()),
        ("latest_snapshot", BIGINT()),
        ("latest_schema_id", BIGINT()),
    )
    bm = BranchManager(table.file_io, table.path)
    rows = []
    for name in bm.list_branches():
        bp = bm.branch_path(name)
        bsm = SnapshotManager(table.file_io, bp)
        latest_schema = SchemaManager(table.file_io, bp).latest()
        rows.append(
            (name, bm.created_from(name), bsm.latest_snapshot_id(), latest_schema.id if latest_schema else None)
        )
    return _StaticTable("branches", ColumnBatch.from_pylist(schema, rows))


def _consumers(table: "FileStoreTable") -> _StaticTable:
    from .consumer import ConsumerManager

    schema = RowType.of(("consumer_id", STRING(False)), ("next_snapshot_id", BIGINT(False)))
    rows = sorted(ConsumerManager(table.file_io, table.path).list_consumers().items())
    return _StaticTable("consumers", ColumnBatch.from_pylist(schema, rows))


def _partitions(table: "FileStoreTable") -> _StaticTable:
    schema = RowType.of(
        ("partition", STRING(False)),
        ("record_count", BIGINT(False)),
        ("file_size_in_bytes", BIGINT(False)),
        ("file_count", BIGINT(False)),
    )
    agg: dict[str, list[int]] = {}
    for e in table.store.new_scan().plan().entries:
        key = str(list(e.partition))
        acc = agg.setdefault(key, [0, 0, 0])
        acc[0] += e.file.row_count
        acc[1] += e.file.file_size
        acc[2] += 1
    rows = [(k, v[0], v[1], v[2]) for k, v in sorted(agg.items())]
    return _StaticTable("partitions", ColumnBatch.from_pylist(schema, rows))


def _buckets(table: "FileStoreTable") -> _StaticTable:
    schema = RowType.of(
        ("partition", STRING(False)),
        ("bucket", INT(False)),
        ("record_count", BIGINT(False)),
        ("file_size_in_bytes", BIGINT(False)),
        ("file_count", BIGINT(False)),
    )
    agg: dict[tuple, list[int]] = {}
    for e in table.store.new_scan().plan().entries:
        key = (str(list(e.partition)), e.bucket)
        acc = agg.setdefault(key, [0, 0, 0])
        acc[0] += e.file.row_count
        acc[1] += e.file.file_size
        acc[2] += 1
    rows = [(k[0], k[1], v[0], v[1], v[2]) for k, v in sorted(agg.items())]
    return _StaticTable("buckets", ColumnBatch.from_pylist(schema, rows))


class _AuditLogTable:
    """Rows with their changelog kind as a leading `rowkind` column
    (Apache Paimon's AuditLogTable: -U/-D rows are not dropped)."""

    def __init__(self, table: "FileStoreTable"):
        self.table = table
        self.name = f"{table.name}$audit_log"
        from ..types import DataField

        self.row_type = RowType(
            [DataField(-1, "rowkind", STRING(False)), *table.row_type.fields]
        )

    def read(self) -> ColumnBatch:
        from ..core.read import MergeFileSplitRead

        store = self.table.store
        splits = self.table.new_read_builder().new_scan().plan()
        batches = []
        for s in splits:
            read = MergeFileSplitRead(
                store.reader_factory(s.partition, s.bucket), store.merge_executor(), store.key_names
            )
            kv = read.read_kv(s.files)
            from ..data.batch import Column

            kinds = np.array([RowKind(int(k)).short_string for k in kv.kind], dtype=object)
            data = kv.data
            cols = {"rowkind": Column(kinds)}
            cols.update(data.columns)
            batches.append(ColumnBatch(self.row_type, cols))
        from ..data.batch import concat_batches

        return concat_batches(batches) if batches else ColumnBatch.empty(self.row_type)

    def to_pylist(self):
        return self.read().to_pylist()


class _ReadOptimizedTable:
    """Top-level-only read: no merge cost, possibly stale
    (Apache Paimon's ReadOptimizedTable)."""

    def __init__(self, table: "FileStoreTable"):
        self.table = table
        self.name = f"{table.name}$read_optimized"
        self.row_type = table.row_type

    def read(self) -> ColumnBatch:
        store = self.table.store
        max_level = store.options.num_levels - 1
        plan = store.new_scan().with_level(max_level).plan()
        batches = []
        for partition, buckets in sorted(plan.grouped().items()):
            for bucket, files in sorted(buckets.items()):
                batches.append(store.read_bucket(partition, bucket, files))
        from ..data.batch import concat_batches

        return concat_batches(batches) if batches else ColumnBatch.empty(self.row_type)

    def to_pylist(self):
        return self.read().to_pylist()


def _statistics(table: "FileStoreTable") -> _StaticTable:
    from .statistics import read_statistics

    schema = RowType.of(
        ("snapshot_id", BIGINT(False)),
        ("schema_id", BIGINT(False)),
        ("mergedRecordCount", BIGINT()),
        ("mergedRecordSize", BIGINT()),
        ("colstat", STRING()),
    )
    stats = read_statistics(table)
    rows = []
    if stats is not None:
        from ..utils import dumps

        rows = [(stats.snapshot_id, stats.schema_id, stats.merged_record_count, stats.merged_record_size, dumps(stats.col_stats))]
    return _StaticTable("statistics", ColumnBatch.from_pylist(schema, rows))


def _aggregation_fields(table: "FileStoreTable") -> _StaticTable:
    schema = RowType.of(
        ("field_name", STRING(False)),
        ("field_type", STRING(False)),
        ("function", STRING()),
        ("function_options", STRING()),
        ("comment", STRING()),
    )
    co = table.options
    rows = []
    for f in table.row_type.fields:
        fn = co.field_option(f.name, "aggregate-function")
        opts = []
        for suffix in ("ignore-retract", "distinct", "list-agg-delimiter", "sequence-group"):
            v = co.field_option(f.name, suffix)
            if v is not None:
                opts.append(f"{suffix}={v}")
        rows.append((f.name, str(f.type), fn, ",".join(opts) or None, f.description))
    return _StaticTable("aggregation_fields", ColumnBatch.from_pylist(schema, rows))


def _file_monitor(table: "FileStoreTable") -> _StaticTable:
    """Per-snapshot file changes (Apache Paimon's FileMonitorTable: _SNAPSHOT_ID,
    _PARTITION, _BUCKET, _BEFORE_FILES, _DATA_FILES) — the input of the
    dedicated-compaction and lookup-refresh topologies."""
    from json import dumps

    schema = RowType.of(
        ("_SNAPSHOT_ID", BIGINT(False)),
        ("_PARTITION", STRING(False)),
        ("_BUCKET", INT(False)),
        ("_BEFORE_FILES", STRING(False)),
        ("_DATA_FILES", STRING(False)),
    )
    store = table.store
    sm = store.snapshot_manager
    rows = []
    latest = sm.latest_snapshot_id()
    earliest = sm.earliest_snapshot_id()
    if latest is not None and earliest is not None:
        for sid in range(earliest, latest + 1):
            if not sm.snapshot_exists(sid):
                continue
            plan = store.new_scan().with_snapshot(sid).with_kind("delta").plan()
            by_pb: dict[tuple, dict[str, list]] = {}
            for e in plan.entries:
                slot = by_pb.setdefault((e.partition, e.bucket), {"before": [], "after": []})
                slot["after" if e.kind.name == "ADD" else "before"].append(e.file.file_name)
            for (partition, bucket), slot in sorted(by_pb.items()):
                rows.append(
                    (
                        sid,
                        dumps(list(partition)),
                        bucket,
                        dumps(sorted(slot["before"])),
                        dumps(sorted(slot["after"])),
                    )
                )
    return _StaticTable("file_monitor", ColumnBatch.from_pylist(schema, rows))


SYSTEM_TABLES = {
    "snapshots": _snapshots,
    "statistics": _statistics,
    "aggregation_fields": _aggregation_fields,
    "schemas": _schemas,
    "options": _options,
    "files": _files,
    "manifests": _manifests,
    "tags": _tags,
    "branches": _branches,
    "consumers": _consumers,
    "partitions": _partitions,
    "buckets": _buckets,
    "audit_log": _AuditLogTable,
    "read_optimized": _ReadOptimizedTable,
    "file_monitor": _file_monitor,
}
