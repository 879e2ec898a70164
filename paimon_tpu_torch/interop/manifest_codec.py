"""ManifestEntry and ManifestFileMeta <-> the reference's Avro records
(port of paimon_tpu/interop/manifest_codec.py).

Partitions, key bounds and stats travel as BinaryRows (interop/binary_row.py)
positioned by the schema that wrote the file (`resolver`: schema id ->
StatsContext), inside the records of interop/golden.py's schemas, through
the OCF codec of interop/avro_io.py. As in the JAX package, an embedded file
index is not carried (the entry reads back without it, and pruning by it
keeps the file), a stats value the BinaryRow subset cannot hold reads back
as null, and a manifest list's partition stats are written all null.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..format import FieldStats
from ..types import DataField, DataType
from .avro_io import read_ocf, write_ocf
from .binary_row import deserialize_binary_row, serialize_binary_row
from .golden import manifest_entry_schema, manifest_meta_schema

__all__ = ["StatsContext", "write_entries_avro", "read_entries_avro", "write_metas_avro", "read_metas_avro"]

# a resolver maps schema_id -> StatsContext: stats travel as positional
# BinaryRows, so they decode under the schema that wrote them (JSON-lines
# manifests key stats by name)

_FILE_SOURCES = {"append": 0, "compact": 1}
_FILE_SOURCES_BACK = {0: "append", 1: "compact"}


@dataclass
class StatsContext:
    """Field order and types of the BinaryRow-encoded parts, from a table
    schema: partition keys, trimmed primary keys, value fields."""

    partition_types: list[DataType]
    key_fields: list[DataField]  # trimmed primary key fields, in order
    value_fields: list[DataField]  # full value row fields, in order

    @staticmethod
    def from_table_schema(ts) -> "StatsContext":
        by_name = {f.name: f for f in ts.fields}
        return StatsContext(
            partition_types=[by_name[k].type for k in ts.partition_keys],
            key_fields=[by_name[k] for k in ts.trimmed_primary_keys],
            value_fields=list(ts.fields),
        )


def _stats_to_avro(stats: dict[str, FieldStats], fields: list[DataField]) -> dict:
    mins, maxs, nulls = [], [], []
    for f in fields:
        st = stats.get(f.name)
        if st is None:
            mins.append(None)
            maxs.append(None)
            nulls.append(None)
            continue
        mins.append(_safe(st.min))
        maxs.append(_safe(st.max))
        nulls.append(st.null_count)
    types = [f.type for f in fields]
    return {
        "_MIN_VALUES": serialize_binary_row(mins, types),
        "_MAX_VALUES": serialize_binary_row(maxs, types),
        "_NULL_COUNTS": nulls,
    }


def _safe(v):
    """A value the BinaryRow subset cannot carry becomes null (pruning on
    that field then keeps every file)."""
    if isinstance(v, (bool, int, float, str, bytes)) or v is None:
        return v
    return None


def _stats_from_avro(node: dict, fields: list[DataField], row_count: int) -> dict[str, FieldStats]:
    types = [f.type for f in fields]
    try:
        mins = deserialize_binary_row(node["_MIN_VALUES"], types)
        maxs = deserialize_binary_row(node["_MAX_VALUES"], types)
    except Exception:
        return {}
    nulls = node.get("_NULL_COUNTS") or [None] * len(fields)
    out = {}
    for f, mn, mx, nc in zip(fields, mins, maxs, nulls):
        out[f.name] = FieldStats(mn, mx, nc, row_count)
    return out


def entry_to_avro(entry, resolver) -> dict:
    f = entry.file
    ctx = resolver(f.schema_id)
    key_types = [kf.type for kf in ctx.key_fields]
    return {
        "_VERSION": 2,
        "_KIND": int(entry.kind),
        "_PARTITION": serialize_binary_row([_safe(v) for v in entry.partition], ctx.partition_types),
        "_BUCKET": entry.bucket,
        "_TOTAL_BUCKETS": entry.total_buckets,
        "_FILE": {
            "_FILE_NAME": f.file_name,
            "_FILE_SIZE": f.file_size,
            "_ROW_COUNT": f.row_count,
            "_MIN_KEY": serialize_binary_row([_safe(v) for v in f.min_key], key_types),
            "_MAX_KEY": serialize_binary_row([_safe(v) for v in f.max_key], key_types),
            "_KEY_STATS": _stats_to_avro(f.key_stats, ctx.key_fields),
            "_VALUE_STATS": _stats_to_avro(f.value_stats, ctx.value_fields),
            "_MIN_SEQUENCE_NUMBER": f.min_sequence_number,
            "_MAX_SEQUENCE_NUMBER": f.max_sequence_number,
            "_SCHEMA_ID": f.schema_id,
            "_LEVEL": f.level,
            "_EXTRA_FILES": list(f.extra_files),
            "_CREATION_TIME": f.creation_time_millis or None,
            "_DELETE_ROW_COUNT": f.delete_row_count,
            "_EMBEDDED_FILE_INDEX": None,
            "_FILE_SOURCE": _FILE_SOURCES.get(f.file_source, 0),
        },
    }


def entry_from_avro(node: dict, resolver):
    from ..core.datafile import DataFileMeta
    from ..core.manifest import FileKind, ManifestEntry

    f = node["_FILE"]
    ctx = resolver(f["_SCHEMA_ID"])
    key_types = [kf.type for kf in ctx.key_fields]
    meta = DataFileMeta(
        file_name=f["_FILE_NAME"],
        file_size=f["_FILE_SIZE"],
        row_count=f["_ROW_COUNT"],
        min_key=tuple(deserialize_binary_row(f["_MIN_KEY"], key_types)),
        max_key=tuple(deserialize_binary_row(f["_MAX_KEY"], key_types)),
        key_stats=_stats_from_avro(f["_KEY_STATS"], ctx.key_fields, f["_ROW_COUNT"]),
        value_stats=_stats_from_avro(f["_VALUE_STATS"], ctx.value_fields, f["_ROW_COUNT"]),
        min_sequence_number=f["_MIN_SEQUENCE_NUMBER"],
        max_sequence_number=f["_MAX_SEQUENCE_NUMBER"],
        schema_id=f["_SCHEMA_ID"],
        level=f["_LEVEL"],
        delete_row_count=f.get("_DELETE_ROW_COUNT") or 0,
        creation_time_millis=f.get("_CREATION_TIME") or 0,
        file_source=_FILE_SOURCES_BACK.get(f.get("_FILE_SOURCE") or 0, "append"),
        extra_files=tuple(f.get("_EXTRA_FILES") or ()),
    )
    return ManifestEntry(
        FileKind(node["_KIND"]),
        tuple(deserialize_binary_row(node["_PARTITION"], ctx.partition_types)),
        node["_BUCKET"],
        node["_TOTAL_BUCKETS"],
        meta,
    )


def write_entries_avro(entries, resolver, codec: str = "deflate") -> bytes:
    return write_ocf(manifest_entry_schema(), [entry_to_avro(e, resolver) for e in entries], codec=codec)


def read_entries_avro(data: bytes, resolver):
    _, records = read_ocf(data)
    return [entry_from_avro(r, resolver) for r in records]


def write_metas_avro(metas, resolver, codec: str = "deflate") -> bytes:
    records = []
    for m in metas:
        ctx = resolver(m.schema_id)
        arity = len(ctx.partition_types)
        records.append(
            {
                "_VERSION": 2,
                "_FILE_NAME": m.file_name,
                "_FILE_SIZE": m.file_size,
                "_NUM_ADDED_FILES": m.num_added_files,
                "_NUM_DELETED_FILES": m.num_deleted_files,
                # all-null stats at the partition's own arity: a reference
                # reader decodes them against the partition row type
                "_PARTITION_STATS": {
                    "_MIN_VALUES": serialize_binary_row([None] * arity, ctx.partition_types),
                    "_MAX_VALUES": serialize_binary_row([None] * arity, ctx.partition_types),
                    "_NULL_COUNTS": [None] * arity,
                },
                "_SCHEMA_ID": m.schema_id,
            }
        )
    return write_ocf(manifest_meta_schema(), records, codec=codec)


def read_metas_avro(data: bytes):
    from ..core.manifest import ManifestFileMeta

    _, records = read_ocf(data)
    return [
        ManifestFileMeta(
            r["_FILE_NAME"], r["_FILE_SIZE"], r["_NUM_ADDED_FILES"], r["_NUM_DELETED_FILES"], r["_SCHEMA_ID"]
        )
        for r in records
    ]
