"""Versioned table schemas and their evolution (port of
paimon_tpu/core/schema.py).

A schema is a numbered JSON file, schema-N, immutable once written; each
field keeps its id across renames, so a reader maps an old file's columns
by id (core/datafile.py). SchemaManager.commit_changes applies
SchemaChanges (add, drop, rename, update a column's type, set or remove an
option) to the latest schema and writes schema-(N+1) with an atomic
create, retrying against the new latest when another writer won. A type
change must widen (data/casting.py can_cast): a DECIMAL must keep its scale
and integer digits, a string its length, which the JAX package does not
check. A key column can be neither dropped nor renamed, and its type may
change only where its stored values keep their order under the new type
(an integer to a wider integer, FLOAT to DOUBLE, a longer string): files'
key ranges and partition values are compared as stored.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Sequence

from ..data.casting import can_cast, stats_comparable
from ..fs import LocalFileIO
from ..options import CoreOptions
from ..types import DataField, DataType, RowType
from ..utils import dumps, loads, now_millis

__all__ = ["TableSchema", "SchemaManager", "SchemaChange"]


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


class SchemaChange:
    """Declarative evolution operations, as the dicts the JAX package uses."""

    @staticmethod
    def add_column(name: str, dtype: DataType, description: str | None = None) -> dict:
        return {"op": "add", "name": name, "type": dtype, "description": description}

    @staticmethod
    def drop_column(name: str) -> dict:
        return {"op": "drop", "name": name}

    @staticmethod
    def rename_column(name: str, new_name: str) -> dict:
        return {"op": "rename", "name": name, "newName": new_name}

    @staticmethod
    def update_column_type(name: str, dtype: DataType) -> dict:
        return {"op": "updateType", "name": name, "type": dtype}

    @staticmethod
    def set_option(key: str, value: str) -> dict:
        return {"op": "setOption", "key": key, "value": value}

    @staticmethod
    def remove_option(key: str) -> dict:
        return {"op": "removeOption", "key": key}


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
        self._validate(row_type, partition_keys, primary_keys, options)
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

    @staticmethod
    def _validate(
        row_type: RowType, partition_keys: Sequence[str], primary_keys: Sequence[str], options: dict | None = None
    ) -> None:
        """Key columns exist, and a primary key holds every partition key
        unless bucket=-1 enables cross-partition upsert."""
        for k in list(partition_keys) + list(primary_keys):
            if k not in row_type:
                raise ValueError(f"key column {k!r} not in schema {row_type.field_names}")
        missing = [p for p in partition_keys if p not in primary_keys]
        if primary_keys and missing and CoreOptions(options or {}).bucket != -1:
            raise ValueError(
                f"primary key must contain all partition keys (missing {missing}) "
                f"unless bucket=-1 enables cross-partition upsert"
            )

    def commit_changes(self, *changes: dict) -> TableSchema:
        """Apply `changes` to the latest schema and write the next one; a
        writer that loses the race retries against the new latest."""
        while True:
            base = self.latest()
            if base is None:
                raise RuntimeError("no table schema to evolve")
            evolved = self._apply(base, changes)
            if self.file_io.try_atomic_write(self.schema_path(evolved.id), evolved.to_json().encode()):
                self._decoded[evolved.id] = evolved
                return evolved

    def _apply(self, base: TableSchema, changes: Sequence[dict]) -> TableSchema:
        fields = list(base.fields)
        options = dict(base.options)
        highest = base.highest_field_id
        keys = set(base.primary_keys) | set(base.partition_keys)
        for ch in changes:
            op = ch["op"]
            names = [f.name for f in fields]
            if op == "add":
                if ch["name"] in names:
                    raise ValueError(f"column {ch['name']} exists")
                highest += 1
                fields.append(DataField(highest, ch["name"], ch["type"], ch.get("description")))
            elif op == "drop":
                if ch["name"] in keys:
                    raise ValueError(f"cannot drop key column {ch['name']}")
                fields = [f for f in fields if f.name != ch["name"]]
            elif op == "rename":
                if ch["name"] in keys:
                    raise ValueError(f"cannot rename key column {ch['name']}")
                if ch["newName"] in names:
                    raise ValueError(f"column {ch['newName']} exists")
                fields = [replace(f, name=ch["newName"]) if f.name == ch["name"] else f for f in fields]
            elif op == "updateType":
                for i, f in enumerate(fields):
                    if f.name == ch["name"]:
                        if not can_cast(f.type, ch["type"]):
                            raise ValueError(
                                f"cannot evolve {f.name!r} from {f.type.serialize()} to {ch['type'].serialize()}: "
                                "not a widening"
                            )
                        if f.name in keys and not stats_comparable(f.type, ch["type"]):
                            # old files' key ranges and partition values
                            # would compare out of order with the new ones
                            raise ValueError(
                                f"cannot evolve key column {f.name!r} from {f.type.serialize()} to "
                                f"{ch['type'].serialize()}: its stored values do not order as the new type's"
                            )
                        fields[i] = replace(f, type=ch["type"])
            elif op == "setOption":
                options[ch["key"]] = ch["value"]
            elif op == "removeOption":
                options.pop(ch["key"], None)
            else:
                raise ValueError(f"unknown schema change {op}")
        return TableSchema(
            id=base.id + 1,
            fields=tuple(fields),
            highest_field_id=highest,
            partition_keys=base.partition_keys,
            primary_keys=base.primary_keys,
            options=options,
            comment=base.comment,
            time_millis=now_millis(),
        )
