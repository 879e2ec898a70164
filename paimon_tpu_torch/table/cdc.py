"""Schema-evolving CDC ingestion (port of paimon_tpu/table/cdc.py):
CdcRecord, infer_type and CdcTableWrite.

CdcTableWrite buffers change records (field dicts with a row kind) and, on
flush, evolves the table first: a field the table lacks is added with the
type inferred from its values (BOOLEAN, BIGINT, DOUBLE or STRING; a later
value of a wider type widens it), and a field whose values infer a wider
type than its column (can_cast) gets an updateType change, the last such
value winning. The records are then written through the stream write
builder under the caller's commit identifier, so a replayed identifier is
filtered. The evolved table keeps the old one's device.

The JAX package walks every record's fields through infer_type and
_coerce one value at a time; here the inference visits each (field, Python
type) pair's first and last occurrence and the coercion runs column by
column, with the same schema changes and the same values.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Mapping

import numpy as np

from ..core.schema import SchemaChange, SchemaManager
from ..data.batch import ColumnBatch
from ..data.casting import can_cast
from ..types import BIGINT, BOOLEAN, DOUBLE, STRING, DataType, RowKind, TypeRoot

if TYPE_CHECKING:
    from . import FileStoreTable

__all__ = ["CdcRecord", "CdcTableWrite", "infer_type"]

_INTEGERS = (TypeRoot.TINYINT, TypeRoot.SMALLINT, TypeRoot.INT, TypeRoot.BIGINT)


class CdcRecord(dict):
    """A change record: field map + row kind (+I default)."""

    def __init__(self, fields: Mapping[str, Any], kind: str = "+I"):
        super().__init__(fields)
        self.kind = kind


def infer_type(value: Any) -> DataType:
    if isinstance(value, bool):
        return BOOLEAN()
    if isinstance(value, int):
        return BIGINT()
    if isinstance(value, float):
        return DOUBLE()
    return STRING()


def _coerce_column(values: list, dtype: DataType) -> list:
    """The JAX package's per-value _coerce over one column."""
    root = dtype.root
    if root in (TypeRoot.VARCHAR, TypeRoot.CHAR):
        fn = str
    elif root in _INTEGERS:
        fn = int
    elif root in (TypeRoot.FLOAT, TypeRoot.DOUBLE):
        fn = float
    elif root == TypeRoot.BOOLEAN:
        fn = bool
    else:
        return values
    return [None if v is None else fn(v) for v in values]


class CdcTableWrite:
    """Buffers CDC records, evolving the table schema when records carry new
    columns or wider types, then writes through the normal Table API."""

    def __init__(self, table: "FileStoreTable"):
        self.table = table
        self._records: list[CdcRecord] = []

    def write(self, record: CdcRecord | Mapping[str, Any], kind: str = "+I") -> None:
        if not isinstance(record, CdcRecord):
            record = CdcRecord(record, kind)
        self._records.append(record)

    def flush(self, commit_identifier: int) -> int:
        """Evolve schema if needed, write all buffered records, commit."""
        if not self._records:
            return 0
        self._evolve_schema()
        table = self.table
        schema = table.row_type
        records = self._records
        data = {f.name: _coerce_column([r.get(f.name) for r in records], f.type) for f in schema.fields}
        codes: dict[str, int] = {}
        kinds = np.empty(len(records), dtype=np.uint8)
        for i, r in enumerate(records):
            code = codes.get(r.kind)
            if code is None:
                code = codes[r.kind] = int(RowKind.from_short_string(r.kind))
            kinds[i] = code
        n = len(records)
        self._records = []
        wb = table.new_stream_write_builder()
        w = wb.new_write()
        w.write(ColumnBatch.from_pydict(schema, data), kinds)
        committed = wb.new_commit().commit_messages(commit_identifier, w.prepare_commit())
        # an already-seen identifier is filtered as a replay: report 0 applied
        return n if committed else 0

    def _evolve_schema(self) -> None:
        table = self.table
        schema = table.row_type
        # infer_type depends on the value's class alone: each (field, class)
        # pair counts at its first occurrence (where the JAX package's change
        # list first holds it) and at its last (whose type wins the dedup)
        first: dict[tuple, int] = {}
        last: dict[tuple, int] = {}
        at = 0
        for r in self._records:
            for name, value in r.items():
                if value is None:
                    continue
                key = (name, value.__class__)
                if key not in first:
                    first[key] = at
                last[key] = at
                at += 1
        updates: dict[str, list] = {}  # name -> [first position, last position, type]
        seen_new: dict[str, DataType] = {}
        for (name, cls), pos in sorted(first.items(), key=lambda kv: kv[1]):
            inferred = _infer_class(cls)
            if name not in schema:
                prev = seen_new.get(name)
                if prev is None or (prev != inferred and can_cast(prev, inferred)):
                    seen_new[name] = inferred
                continue
            current = schema.field(name).type
            if current.root != inferred.root and can_cast(current, inferred):
                end = last[(name, cls)]
                u = updates.setdefault(name, [pos, -1, None])
                if end > u[1]:
                    u[1:] = [end, inferred]
        changes = [SchemaChange.update_column_type(name, t)
                   for name, (_, _, t) in sorted(updates.items(), key=lambda kv: kv[1][0])]
        changes += [SchemaChange.add_column(name, t) for name, t in seen_new.items()]
        if changes:
            sm = SchemaManager(table.file_io, table.path)
            new_schema = sm.commit_changes(*changes)
            from . import FileStoreTable

            self.table = FileStoreTable(table.file_io, table.path, new_schema, table.store.commit_user, table.device)


def _infer_class(cls: type) -> DataType:
    """infer_type of any value of class `cls`."""
    if issubclass(cls, bool):
        return BOOLEAN()
    if issubclass(cls, int):
        return BIGINT()
    if issubclass(cls, float):
        return DOUBLE()
    return STRING()
