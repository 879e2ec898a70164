"""Versioned table schemas (port of paimon_tpu/core/schema.py: the JSON
form, reading, and creation; schema evolution is not ported yet)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from ..fs import LocalFileIO
from ..options import CoreOptions
from ..types import DataField, RowType
from ..utils import dumps, loads, now_millis

__all__ = ["TableSchema", "SchemaManager"]


@dataclass(frozen=True)
class TableSchema:
    id: int
    fields: tuple[DataField, ...]
    highest_field_id: int
    partition_keys: tuple[str, ...]
    primary_keys: tuple[str, ...]
    options: dict[str, str]
    comment: str | None = None
    time_millis: int = 0

    @property
    def trimmed_primary_keys(self) -> list[str]:
        """PK minus partition keys: the in-bucket merge key."""
        trimmed = [k for k in self.primary_keys if k not in self.partition_keys]
        return trimmed if trimmed else list(self.primary_keys)

    @property
    def bucket_keys(self) -> list[str]:
        """The columns a fixed-bucket table hashes: bucket-key, else the
        trimmed primary key."""
        opt = self.options.get("bucket-key")
        if opt:
            return [s.strip() for s in opt.split(",")]
        return self.trimmed_primary_keys if self.primary_keys else [f.name for f in self.fields]

    def core_options(self) -> CoreOptions:
        return CoreOptions(dict(self.options))

    def to_json(self) -> str:
        return dumps(
            {
                "version": 1,
                "id": self.id,
                "fields": [f.to_dict() for f in self.fields],
                "highestFieldId": self.highest_field_id,
                "partitionKeys": list(self.partition_keys),
                "primaryKeys": list(self.primary_keys),
                "options": self.options,
                "comment": self.comment,
                "timeMillis": self.time_millis,
            }
        )

    @staticmethod
    def from_json(s: str | bytes) -> "TableSchema":
        d = loads(s)
        return TableSchema(
            id=d["id"],
            fields=tuple(DataField.from_dict(f) for f in d["fields"]),
            highest_field_id=d["highestFieldId"],
            partition_keys=tuple(d["partitionKeys"]),
            primary_keys=tuple(d["primaryKeys"]),
            options=d["options"],
            comment=d.get("comment"),
            time_millis=d.get("timeMillis", 0),
        )


class SchemaManager:
    def __init__(self, file_io: LocalFileIO, table_path: str):
        self.file_io = file_io
        self.table_path = table_path
        self.schema_dir = f"{table_path}/schema"
        self._decoded: dict[int, TableSchema] = {}

    def schema_path(self, schema_id: int) -> str:
        return f"{self.schema_dir}/schema-{schema_id}"

    def schema(self, schema_id: int) -> TableSchema:
        out = self._decoded.get(schema_id)
        if out is None:
            out = TableSchema.from_json(self.file_io.read_bytes(self.schema_path(schema_id)))
            self._decoded[schema_id] = out
        return out

    def _listed_ids(self) -> list[int]:
        out = []
        for st in self.file_io.list_files(self.schema_dir):
            base = st.path.rsplit("/", 1)[-1]
            if base.startswith("schema-") and base[len("schema-") :].isdigit():
                out.append(int(base[len("schema-") :]))
        return sorted(out)

    def latest(self) -> TableSchema | None:
        ids = self._listed_ids()
        return self.schema(ids[-1]) if ids else None

    def all_schemas(self) -> dict[int, TableSchema]:
        return {i: self.schema(i) for i in self._listed_ids()}

    def create_table(
        self,
        row_type: RowType,
        partition_keys: Sequence[str] = (),
        primary_keys: Sequence[str] = (),
        options: dict[str, str] | None = None,
    ) -> TableSchema:
        existing = self.latest()
        if existing is not None:
            return existing
        for k in list(partition_keys) + list(primary_keys):
            if k not in row_type:
                raise ValueError(f"key column {k!r} not in schema {row_type.field_names}")
        missing = [p for p in partition_keys if p not in primary_keys]
        if primary_keys and missing and CoreOptions(options or {}).bucket != -1:
            raise ValueError(
                f"primary key must contain all partition keys (missing {missing}) "
                f"unless bucket=-1 enables cross-partition upsert"
            )
        fields = []
        for i, f in enumerate(row_type.fields):
            t = f.type.with_nullable(False) if f.name in primary_keys else f.type
            fields.append(DataField(i, f.name, t, f.description))
        schema = TableSchema(
            id=0,
            fields=tuple(fields),
            highest_field_id=len(fields) - 1,
            partition_keys=tuple(partition_keys),
            primary_keys=tuple(primary_keys),
            options={k: str(v) for k, v in (options or {}).items()},
            time_millis=now_millis(),
        )
        if not self.file_io.try_atomic_write(self.schema_path(0), schema.to_json().encode()):
            return self.latest()
        return schema
