"""The reference's Avro manifest schemas (port of the two schema
builders of paimon_tpu/interop/golden.py).

manifest_entry_schema: manifest/ManifestEntry.schema() + DataFileMeta.SCHEMA
+ stats/SimpleStatsConverter.schema(), wrapped with the _VERSION field
(utils/VersionedObjectSerializer), names per AvroSchemaConverter.
manifest_meta_schema: manifest/ManifestFileMeta.schema(), version 2.
"""

from __future__ import annotations

__all__ = ["manifest_entry_schema", "manifest_meta_schema"]

_RECORD = "org.apache.paimon.avro.generated.record"


def _nullable(t):
    return ["null", t]


def _stats_schema(name: str) -> dict:
    return {
        "type": "record",
        "name": name,
        "fields": [
            {"name": "_MIN_VALUES", "type": "bytes"},
            {"name": "_MAX_VALUES", "type": "bytes"},
            {"name": "_NULL_COUNTS", "type": _nullable({"type": "array", "items": _nullable("long")})},
        ],
    }


def manifest_entry_schema() -> dict:
    file_rec = {
        "type": "record",
        "name": f"{_RECORD}__FILE",
        "fields": [
            {"name": "_FILE_NAME", "type": "string"},
            {"name": "_FILE_SIZE", "type": "long"},
            {"name": "_ROW_COUNT", "type": "long"},
            {"name": "_MIN_KEY", "type": "bytes"},
            {"name": "_MAX_KEY", "type": "bytes"},
            {"name": "_KEY_STATS", "type": _stats_schema(f"{_RECORD}__FILE__KEY_STATS")},
            {"name": "_VALUE_STATS", "type": _stats_schema(f"{_RECORD}__FILE__VALUE_STATS")},
            {"name": "_MIN_SEQUENCE_NUMBER", "type": "long"},
            {"name": "_MAX_SEQUENCE_NUMBER", "type": "long"},
            {"name": "_SCHEMA_ID", "type": "long"},
            {"name": "_LEVEL", "type": "int"},
            {"name": "_EXTRA_FILES", "type": {"type": "array", "items": "string"}},
            {
                "name": "_CREATION_TIME",
                "type": _nullable({"type": "long", "logicalType": "timestamp-millis"}),
                "default": None,
            },
            {"name": "_DELETE_ROW_COUNT", "type": _nullable("long"), "default": None},
            {"name": "_EMBEDDED_FILE_INDEX", "type": _nullable("bytes"), "default": None},
            {"name": "_FILE_SOURCE", "type": _nullable("int"), "default": None},
        ],
    }
    return {
        "type": "record",
        "name": _RECORD,
        "fields": [
            {"name": "_VERSION", "type": "int"},
            {"name": "_KIND", "type": "int"},
            {"name": "_PARTITION", "type": "bytes"},
            {"name": "_BUCKET", "type": "int"},
            {"name": "_TOTAL_BUCKETS", "type": "int"},
            {"name": "_FILE", "type": file_rec},
        ],
    }


def manifest_meta_schema() -> dict:
    return {
        "type": "record",
        "name": _RECORD,
        "fields": [
            {"name": "_VERSION", "type": "int"},
            {"name": "_FILE_NAME", "type": "string"},
            {"name": "_FILE_SIZE", "type": "long"},
            {"name": "_NUM_ADDED_FILES", "type": "long"},
            {"name": "_NUM_DELETED_FILES", "type": "long"},
            {"name": "_PARTITION_STATS", "type": _stats_schema(f"{_RECORD}__PARTITION_STATS")},
            {"name": "_SCHEMA_ID", "type": "long"},
        ],
    }
