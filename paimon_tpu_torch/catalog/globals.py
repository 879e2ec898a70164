"""Catalog-scope system tables and the lineage store (port of
paimon_tpu/catalog/globals.py).

`get_table("sys.<name>")` opens one of six tables, each a snapshot of the
catalog taken when it is opened:

  * all_table_options (database_name, table_name, key, value): every
    table's options, by database, table and key;
  * catalog_options (key, value): the warehouse;
  * source_table_lineage, sink_table_lineage, source_data_lineage and
    sink_data_lineage: the entries of FsLineageMeta.

FsLineageMeta keeps one JSON file per entry under <warehouse>/.lineage/
<kind>/e-<uuid>.json, with the JAX package's directory names and fields,
so that each package reads the lineage the other saved.
"""

from __future__ import annotations

import json
import uuid
from typing import TYPE_CHECKING

from ..data.batch import ColumnBatch
from ..table.system import _StaticTable
from ..types import BIGINT, STRING, RowType
from ..utils import now_millis

if TYPE_CHECKING:
    from . import Catalog

__all__ = ["FsLineageMeta", "global_system_table", "GLOBAL_SYSTEM_TABLES"]


class FsLineageMeta:
    """Table- and data-level lineage entries, one exclusively named file
    each, so that concurrent jobs never lose each other's entries."""

    def __init__(self, catalog: "Catalog"):
        self.file_io = catalog.file_io
        self.dir = f"{catalog.warehouse}/.lineage"

    def _append(self, name: str, entry: dict) -> None:
        d = f"{self.dir}/{name}"
        self.file_io.mkdirs(d)
        self.file_io.write_bytes(f"{d}/e-{uuid.uuid4().hex}.json", json.dumps(entry).encode())

    def _read(self, name: str) -> list[dict]:
        d = f"{self.dir}/{name}"
        out = [
            json.loads(self.file_io.read_bytes(st.path))
            for st in self.file_io.list_status(d)
            if not st.is_dir and st.path.endswith(".json")
        ]
        out.sort(key=lambda e: e.get("create_time", 0))
        return out

    @staticmethod
    def _names(table: str) -> dict:
        return {"database_name": table.split(".")[0], "table_name": table.split(".")[-1]}

    def save_source_table_lineage(self, job: str, table: str) -> None:
        self._append("source_table", {**self._names(table), "job_name": job, "create_time": now_millis()})

    def save_sink_table_lineage(self, job: str, table: str) -> None:
        self._append("sink_table", {**self._names(table), "job_name": job, "create_time": now_millis()})

    def save_source_data_lineage(self, job: str, table: str, barrier_id: int, snapshot_id: int) -> None:
        self._append("source_data", {**self._names(table), "job_name": job, "barrier_id": barrier_id,
                                     "snapshot_id": snapshot_id, "create_time": now_millis()})

    def save_sink_data_lineage(self, job: str, table: str, barrier_id: int, snapshot_id: int) -> None:
        self._append("sink_data", {**self._names(table), "job_name": job, "barrier_id": barrier_id,
                                   "snapshot_id": snapshot_id, "create_time": now_millis()})

    def table_lineages(self, kind: str) -> list[dict]:
        return self._read(f"{kind}_table")

    def data_lineages(self, kind: str) -> list[dict]:
        return self._read(f"{kind}_data")


def _all_table_options(catalog: "Catalog") -> _StaticTable:
    schema = RowType.of(
        ("database_name", STRING(False)),
        ("table_name", STRING(False)),
        ("key", STRING(False)),
        ("value", STRING(False)),
    )
    rows = []
    for db in catalog.list_databases():
        for name in catalog.list_tables(db):
            options = catalog.get_table(f"{db}.{name}").schema.options
            rows += [(db, name, k, str(v)) for k, v in sorted(options.items())]
    return _StaticTable("all_table_options", ColumnBatch.from_pylist(schema, rows))


def _catalog_options(catalog: "Catalog") -> _StaticTable:
    schema = RowType.of(("key", STRING(False)), ("value", STRING(False)))
    return _StaticTable("catalog_options", ColumnBatch.from_pylist(schema, [("warehouse", catalog.warehouse)]))


_TABLE_LINEAGE_SCHEMA = RowType.of(
    ("database_name", STRING(False)),
    ("table_name", STRING(False)),
    ("job_name", STRING(False)),
    ("create_time", BIGINT(False)),
)
_DATA_LINEAGE_SCHEMA = RowType.of(
    ("database_name", STRING(False)),
    ("table_name", STRING(False)),
    ("job_name", STRING(False)),
    ("barrier_id", BIGINT(False)),
    ("snapshot_id", BIGINT(False)),
    ("create_time", BIGINT(False)),
)


def _table_lineage(kind: str):
    def load(catalog: "Catalog") -> _StaticTable:
        rows = [(e["database_name"], e["table_name"], e["job_name"], e["create_time"])
                for e in FsLineageMeta(catalog).table_lineages(kind)]
        return _StaticTable(f"{kind}_table_lineage", ColumnBatch.from_pylist(_TABLE_LINEAGE_SCHEMA, rows))

    return load


def _data_lineage(kind: str):
    def load(catalog: "Catalog") -> _StaticTable:
        rows = [(e["database_name"], e["table_name"], e["job_name"], e["barrier_id"], e["snapshot_id"],
                 e["create_time"]) for e in FsLineageMeta(catalog).data_lineages(kind)]
        return _StaticTable(f"{kind}_data_lineage", ColumnBatch.from_pylist(_DATA_LINEAGE_SCHEMA, rows))

    return load


GLOBAL_SYSTEM_TABLES = {
    "all_table_options": _all_table_options,
    "catalog_options": _catalog_options,
    "source_table_lineage": _table_lineage("source"),
    "sink_table_lineage": _table_lineage("sink"),
    "source_data_lineage": _data_lineage("source"),
    "sink_data_lineage": _data_lineage("sink"),
}


def global_system_table(catalog: "Catalog", name: str) -> _StaticTable:
    try:
        fn = GLOBAL_SYSTEM_TABLES[name]
    except KeyError:
        raise ValueError(
            f"unknown global system table {name!r}; known: {sorted(GLOBAL_SYSTEM_TABLES)}"
        ) from None
    return fn(catalog)
