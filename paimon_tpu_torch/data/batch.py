"""Columnar batches on numpy (port of paimon_tpu/data/batch.py).

A ColumnBatch is a RowType plus one dense numpy vector per field and an
optional validity vector (True = present). Strings and bytes are object
vectors with no arrow backing. Structural ops (take/slice/filter/concat)
are O(columns) numpy calls.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping, Sequence

import numpy as np

from ..types import DataType, RowType

__all__ = ["Column", "ColumnBatch", "concat_batches", "gather_column"]

_OBJ = np.dtype(object)


class Column:
    """values + optional validity; validity None means every slot valid."""

    __slots__ = ("values", "validity")

    def __init__(self, values: np.ndarray, validity: np.ndarray | None = None):
        if validity is not None:
            assert validity.dtype == np.bool_ and len(validity) == len(values)
            if bool(validity.all()):
                validity = None
        self.values = values
        self.validity = validity

    def __len__(self) -> int:
        return len(self.values)

    @property
    def null_count(self) -> int:
        return 0 if self.validity is None else int((~self.validity).sum())

    def valid_mask(self) -> np.ndarray:
        if self.validity is None:
            return np.ones(len(self.values), dtype=np.bool_)
        return self.validity

    def value_at(self, i: int):
        if self.validity is not None and not self.validity[i]:
            return None
        return self.values[i]

    def byte_size(self) -> int:
        """Approximate heap footprint, the write buffer's currency."""
        if self.values.dtype == _OBJ:
            sample = self.values[:1024]
            payload = sum(len(x) if isinstance(x, (str, bytes)) else 16 for x in sample if x is not None)
            total = int(len(self.values) * (8 + payload / max(len(sample), 1) + 49))
        else:
            total = self.values.nbytes
        return total + (0 if self.validity is None else self.validity.nbytes)

    def take(self, indices: np.ndarray) -> "Column":
        return Column(self.values.take(indices), None if self.validity is None else self.validity.take(indices))

    def slice(self, start: int, stop: int) -> "Column":
        return Column(self.values[start:stop], None if self.validity is None else self.validity[start:stop])

    def filter(self, mask: np.ndarray) -> "Column":
        return Column(self.values[mask], None if self.validity is None else self.validity[mask])

    def to_pylist(self) -> list:
        if self.validity is None:
            return self.values.tolist()
        return [v if ok else None for v, ok in zip(self.values.tolist(), self.validity.tolist())]

    @staticmethod
    def from_pylist(data: Sequence[Any], dtype: DataType) -> "Column":
        np_dtype = dtype.numpy_dtype()
        if isinstance(data, np.ndarray):
            if np_dtype != _OBJ and data.dtype.kind in "biuf":
                return Column(np.ascontiguousarray(data, dtype=np_dtype))
            if np_dtype == data.dtype == _OBJ:
                validity = np.asarray(data != None, dtype=np.bool_)  # noqa: E711 - elementwise
                return Column(data, validity)
        validity = np.array([x is not None for x in data], dtype=np.bool_)
        if np_dtype == _OBJ:
            values = np.empty(len(data), dtype=object)
            for i, x in enumerate(data):
                values[i] = x
        else:
            values = np.array([0 if x is None else x for x in data], dtype=np_dtype)
        return Column(values, validity)

    @staticmethod
    def concat(cols: Sequence["Column"]) -> "Column":
        validity = None
        if not all(c.validity is None for c in cols):
            validity = np.concatenate([c.valid_mask() for c in cols])
        return Column(np.concatenate([c.values for c in cols]), validity)


class ColumnBatch:
    """A schema-carrying bundle of equal-length Columns."""

    def __init__(self, schema: RowType, columns: Mapping[str, Column] | Sequence[Column]):
        self.schema = schema
        if isinstance(columns, Mapping):
            cols = {name: columns[name] for name in schema.field_names}
        else:
            cols = {f.name: c for f, c in zip(schema.fields, columns)}
        assert len(cols) == len(schema.fields), (list(cols), schema.field_names)
        lengths = {len(c) for c in cols.values()}
        assert len(lengths) <= 1, f"ragged columns: { {n: len(c) for n, c in cols.items()} }"
        self.columns: dict[str, Column] = cols
        self._num_rows = lengths.pop() if lengths else 0

    @staticmethod
    def from_pydict(schema: RowType, data: Mapping[str, Sequence[Any]]) -> "ColumnBatch":
        return ColumnBatch(schema, {f.name: Column.from_pylist(data[f.name], f.type) for f in schema.fields})

    @staticmethod
    def empty(schema: RowType) -> "ColumnBatch":
        return ColumnBatch(schema, {f.name: Column(np.empty(0, dtype=f.type.numpy_dtype())) for f in schema.fields})

    @property
    def num_rows(self) -> int:
        return self._num_rows

    def __len__(self) -> int:
        return self._num_rows

    def byte_size(self) -> int:
        return sum(c.byte_size() for c in self.columns.values())

    def column(self, name: str) -> Column:
        return self.columns[name]

    def take(self, indices: np.ndarray) -> "ColumnBatch":
        return ColumnBatch(self.schema, {n: c.take(indices) for n, c in self.columns.items()})

    def slice(self, start: int, stop: int) -> "ColumnBatch":
        return ColumnBatch(self.schema, {n: c.slice(start, stop) for n, c in self.columns.items()})

    def filter(self, mask: np.ndarray) -> "ColumnBatch":
        return ColumnBatch(self.schema, {n: c.filter(mask) for n, c in self.columns.items()})

    def select(self, names: Iterable[str]) -> "ColumnBatch":
        names = list(names)
        return ColumnBatch(self.schema.project(names), {n: self.columns[n] for n in names})

    def to_pylist(self) -> list[tuple]:
        cols = [self.columns[n].to_pylist() for n in self.schema.field_names]
        return list(zip(*cols)) if cols else []

    def __repr__(self) -> str:  # pragma: no cover
        return f"ColumnBatch(rows={self.num_rows}, schema={self.schema.field_names})"


def concat_batches(batches: Sequence[ColumnBatch]) -> ColumnBatch:
    batches = list(batches)
    if len(batches) == 1:
        return batches[0]
    schema = batches[0].schema
    return ColumnBatch(schema, {n: Column.concat([b.column(n) for b in batches]) for n in schema.field_names})


def gather_column(column: Column, src: np.ndarray) -> Column:
    """column.take(src) where src -1 gives null (the merge engines' picks:
    a field no row supplied). Null slots of a fixed-width column hold 0, of
    an object column whatever value sat at the clipped index; validity says
    which are null (port of paimon_tpu/ops/aggregates.py `_gather_column`)."""
    ok = src >= 0
    safe = np.clip(src, 0, max(len(column) - 1, 0))
    validity = ok & column.valid_mask().take(safe)
    vals = column.values.take(safe)
    if column.values.dtype != _OBJ:
        vals = np.where(validity, vals, np.zeros((), column.values.dtype))
    return Column(vals, validity if not validity.all() else None)
