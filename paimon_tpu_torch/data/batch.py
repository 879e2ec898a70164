"""Columnar batches on numpy (port of paimon_tpu/data/batch.py).

A ColumnBatch is a RowType plus one dense numpy vector per field and an
optional validity vector (True = present). Strings and bytes are object
vectors with no arrow backing; an ARRAY, MAP or ROW column is an object
vector of the Python values the JAX package reads back (a list, a dict, a
dict by field name), never code-backed. Structural ops
(take/slice/filter/concat) are O(columns) numpy calls.

A Column may be code-backed (`from_codes`, the reader's form under
merge.dict-domain): a sorted pool and full-length uint32 codes, no values.
Its structural ops touch only the codes, concat unifies the inputs' pools
in the code domain (ops/dicts.py), and the values expand on first access
to `.values` (counted in dict{fallback_expanded}). Any column may also
carry a `dict_cache` (pool, codes) pair, which the key-lane encoder
attaches to string keys and the page encoder writes as the dictionary
page; structural ops carry it along, concat of expanded columns drops it.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping, Sequence

import numpy as np

from ..types import DataType, RowType

__all__ = ["Column", "ColumnBatch", "concat_batches", "gather_column"]

_OBJ = np.dtype(object)


class Column:
    """values + optional validity; validity None means every slot valid."""

    __slots__ = ("_values", "validity", "_len", "dict_cache")

    def __init__(self, values: np.ndarray, validity: np.ndarray | None = None):
        if validity is not None:
            assert validity.dtype == np.bool_ and len(validity) == len(values)
            if bool(validity.all()):
                validity = None
        self._values = values
        self._len = len(values)
        self.validity = validity
        self.dict_cache = None

    @staticmethod
    def from_codes(pool: np.ndarray, codes: np.ndarray, validity: np.ndarray | None = None) -> "Column":
        """A code-backed column over a sorted pool: codes are full-length
        uint32 ranks into it; a code at an invalid slot means nothing."""
        col = Column.__new__(Column)
        col._values = None
        col._len = len(codes)
        col.dict_cache = (pool, codes.astype(np.uint32, copy=False))
        if validity is not None:
            assert validity.dtype == np.bool_ and len(validity) == col._len
            if bool(validity.all()):
                validity = None
        col.validity = validity
        return col

    @property
    def is_code_backed(self) -> bool:
        return self._values is None

    @property
    def values(self) -> np.ndarray:
        """The value vector; a code-backed column expands pool[codes] here
        once, nulls filled with None (object pools) or 0 (fixed width),
        as the expanded decode fills them."""
        if self._values is None:
            from ..metrics import dict_metrics

            pool, codes = self.dict_cache
            if len(pool):
                v = pool.take(np.minimum(codes, len(pool) - 1))
            else:
                v = np.empty(self._len, dtype=pool.dtype)
                if pool.dtype != _OBJ:
                    v[:] = 0
            if self.validity is not None:
                v[~self.validity] = None if pool.dtype == _OBJ else 0
            dict_metrics().counter("fallback_expanded").inc(self._len)
            self._values = v
        return self._values

    @property
    def dtype(self) -> np.dtype:
        """The values' dtype, read without expanding a code-backed column."""
        return self.dict_cache[0].dtype if self._values is None else self._values.dtype

    def __len__(self) -> int:
        return self._len

    @property
    def null_count(self) -> int:
        return 0 if self.validity is None else int((~self.validity).sum())

    def valid_mask(self) -> np.ndarray:
        if self.validity is None:
            return np.ones(self._len, dtype=np.bool_)
        return self.validity

    def value_at(self, i: int):
        if self.validity is not None and not self.validity[i]:
            return None
        if self._values is None:
            pool, codes = self.dict_cache
            return pool[int(codes[i])]
        return self._values[i]

    def byte_size(self) -> int:
        """Approximate heap footprint, the write buffer's currency."""
        if self._values is None:
            # codes plus a sampled estimate of the pool's payload
            pool, codes = self.dict_cache
            sample = pool[:1024]
            payload = sum(len(x) if isinstance(x, (str, bytes)) else 16 for x in sample if x is not None)
            total = codes.nbytes + int(len(pool) * (8 + payload / max(len(sample), 1)))
        elif self._values.dtype == _OBJ:
            sample = self._values[:1024]
            payload = sum(len(x) if isinstance(x, (str, bytes)) else 16 for x in sample if x is not None)
            total = int(self._len * (8 + payload / max(len(sample), 1) + 49))
        else:
            total = self._values.nbytes
        return total + (0 if self.validity is None else self.validity.nbytes)

    def _structural(self, validity, pick) -> "Column":
        """The column with `pick` applied to its codes (code-backed) or to
        its values and cache."""
        if self._values is None:
            pool, codes = self.dict_cache
            return Column.from_codes(pool, pick(codes), validity)
        out = Column(pick(self._values), validity)
        if self.dict_cache is not None:
            pool, codes = self.dict_cache
            out.dict_cache = (pool, pick(codes))
        return out

    def take(self, indices: np.ndarray) -> "Column":
        return self._structural(None if self.validity is None else self.validity.take(indices), lambda a: a.take(indices))

    def slice(self, start: int, stop: int) -> "Column":
        return self._structural(None if self.validity is None else self.validity[start:stop], lambda a: a[start:stop])

    def filter(self, mask: np.ndarray) -> "Column":
        return self._structural(None if self.validity is None else self.validity[mask], lambda a: a[mask])

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
        if cols and all(c.is_code_backed for c in cols):
            # code-domain concat; None: the unified pool would pass the
            # pool limit, and the columns expand
            from ..ops.dicts import unify_columns

            got = unify_columns([c.dict_cache for c in cols])
            if got is not None:
                return Column.from_codes(got[0], got[1], validity)
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
    def from_pylist(schema: RowType, rows: Sequence[Sequence[Any]]) -> "ColumnBatch":
        return ColumnBatch.from_pydict(schema, {f.name: [r[i] for r in rows] for i, f in enumerate(schema.fields)})

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
    which are null (port of paimon_tpu/ops/aggregates.py `_gather_column`).
    A code-backed column gathers its codes and keeps its pool."""
    ok = src >= 0
    safe = np.clip(src, 0, max(len(column) - 1, 0))
    validity = ok & column.valid_mask().take(safe)
    if column.is_code_backed:
        pool, codes = column.dict_cache
        return Column.from_codes(pool, codes.take(safe), validity)
    vals = column.values.take(safe)
    if column.values.dtype != _OBJ:
        vals = np.where(validity, vals, np.zeros((), column.values.dtype))
    return Column(vals, validity if not validity.all() else None)
