"""Nested columns -> their leaves' levels and values, and their schema
elements (the write-side dual of decode/nested.py).

The layout is pyarrow's, which the JAX package writes through
`pq.write_table`: every group and leaf OPTIONAL but a map's key
(REQUIRED), an ARRAY as `<name> (LIST) { repeated group list { element } }`,
a MAP as `<name> (MAP) { repeated group key_value { key; value } }` and a
ROW as a plain group of its fields. Inside a nested column a leaf's
physical type follows its numpy dtype (a DATE element is a plain INT32), as
the JAX package's pyarrow types make it.

`flatten` walks a column's Python values once per level: a level's
instances are split with `map(len, ...)` and joined with
`itertools.chain.from_iterable`, and every leaf's repetition and
definition levels are placed with numpy, one entry per null or empty
instance and the child's entries for the others. A list, a map and a row
are each one instance; their elements are the instances of the level
below.
"""

from __future__ import annotations

import itertools
import operator

import numpy as np

from ..decode.container import (
    CONVERTED_LIST,
    CONVERTED_MAP,
    LOGICAL_LIST,
    LOGICAL_MAP,
    OPTIONAL,
    REPEATED,
    REQUIRED,
    physical_type,
)
from ..format.thrift import build_struct
from ..types import DataType, TypeRoot

__all__ = ["NestedLeaf", "flatten", "schema_elements"]

_I32, _BINARY, _STRUCT = 5, 8, 12
_OBJ = np.dtype(object)


class NestedLeaf:
    """One leaf of a nested column: its column path and type, its
    repetition and definition levels, and the values of its entries at
    the maximum definition level. While `flatten` builds it, `counts` holds
    its entries per instance of the level being built."""

    __slots__ = ("path", "dtype", "counts", "rep", "def_", "values", "max_def", "max_rep")

    def __init__(self, path, dtype, counts, rep, def_, values, max_def, max_rep):
        self.path, self.dtype, self.counts, self.rep, self.def_ = path, dtype, counts, rep, def_
        self.values, self.max_def, self.max_rep = values, max_def, max_rep


def _objects(values, n: int) -> np.ndarray:
    return np.fromiter(values, dtype=_OBJ, count=n)


def _wrap(parts: list, n: int, present: np.ndarray, marker_def: np.ndarray, groups: np.ndarray, rep_level):
    """Lift the child leaves `parts` one level up: instance i (of n) holds
    the child instances groups[j]:groups[j+1] when it is the j-th of
    `present`, else one entry at definition level marker_def[i]. The first
    entry of every child instance repeats at `rep_level` (None for a ROW's
    fields); the first of every instance is left at 0 for the parent."""
    idle = np.flatnonzero(~present)
    for part in parts:
        child_off = np.zeros(len(part.counts) + 1, dtype=np.int64)
        np.cumsum(part.counts, out=child_off[1:])
        counts = np.ones(n, dtype=np.int64)
        counts[present] = child_off[groups[1:]] - child_off[groups[:-1]]
        starts = np.zeros(n, dtype=np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        total = int(counts.sum())
        from_child = np.ones(total, dtype=np.bool_)
        from_child[starts[idle]] = False
        def_ = np.empty(total, dtype=np.int16)
        rep = np.zeros(total, dtype=np.int16)
        def_[~from_child] = marker_def[idle]
        def_[from_child] = part.def_
        rep[from_child] = part.rep
        if rep_level is not None and len(part.counts):
            rep[np.flatnonzero(from_child)[child_off[:-1]]] = rep_level
        rep[starts] = 0
        part.counts, part.rep, part.def_ = counts, rep, def_


def _flatten(dtype: DataType, values: np.ndarray, path: str, base_def: int, base_rep: int, required: bool) -> list:
    """The leaves of `values` (an object vector, None = null) of
    type `dtype` at `path`, whose parent is present at definition level
    base_def and repeats at base_rep."""
    n = len(values)
    present = values != None  # noqa: E711 - elementwise
    if required:
        if not present.all():
            raise ValueError(f"a null in the required parquet field {path}")
        own = base_def
    else:
        own = base_def + 1
    root = dtype.root
    if root not in (TypeRoot.ARRAY, TypeRoot.MAP, TypeRoot.ROW):
        np_dtype = dtype.numpy_dtype()
        kept = values[present]
        if np_dtype != _OBJ:
            kept = np.array(kept.tolist(), dtype=np_dtype) if len(kept) else np.zeros(0, dtype=np_dtype)
        def_ = np.where(present, own, own - 1).astype(np.int16)
        return [NestedLeaf(path, dtype, np.ones(n, dtype=np.int64), np.zeros(n, dtype=np.int16), def_, kept, own,
                           base_rep)]
    live = values[present].tolist()
    k = len(live)
    if root == TypeRoot.ROW:
        parts = []
        for f in dtype.fields:
            child = _objects(map(operator.methodcaller("get", f.name), live), k)
            parts += _flatten(f.type, child, f"{path}.{f.name}", own, base_rep, False)
        marker = np.full(n, own - 1, dtype=np.int16)
        _wrap(parts, n, present, marker, np.arange(k + 1, dtype=np.int64), None)
        return parts
    # a list or a map: the repeated group is present at own + 1
    lens = np.fromiter(map(len, live), dtype=np.int64, count=k)
    groups = np.zeros(k + 1, dtype=np.int64)
    np.cumsum(lens, out=groups[1:])
    m = int(groups[-1])
    rep_level = base_rep + 1
    if root == TypeRoot.ARRAY:
        elems = _objects(itertools.chain.from_iterable(live), m)
        parts = _flatten(dtype.element, elems, f"{path}.list.element", own + 1, rep_level, False)
    else:
        if not all(isinstance(x, dict) for x in live):
            live = [dict(x) for x in live]
        keys = _objects(itertools.chain.from_iterable(map(dict.keys, live)), m)
        vals = _objects(itertools.chain.from_iterable(map(dict.values, live)), m)
        parts = _flatten(dtype.key, keys, f"{path}.key_value.key", own + 1, rep_level, True)
        parts += _flatten(dtype.value, vals, f"{path}.key_value.value", own + 1, rep_level, False)
    nonempty = lens > 0
    at = np.flatnonzero(present)
    full = np.zeros(n, dtype=np.bool_)
    full[at[nonempty]] = True
    marker = np.full(n, own - 1, dtype=np.int16)
    marker[at[~nonempty]] = own  # an empty list: present, no element
    _wrap(parts, n, full, marker, np.concatenate([[0], groups[1:][nonempty]]), rep_level)
    return parts


def flatten(dtype: DataType, values: np.ndarray, validity, name: str) -> list[NestedLeaf]:
    """The leaves of one nested column (values at invalid slots are
    ignored), in schema order."""
    if validity is not None:
        values = values.copy()
        values[~validity] = None
    return _flatten(dtype, values, name, 0, 0, False)


def schema_elements(name: str, dtype: DataType, repetition: int = OPTIONAL, converted=None) -> list[bytes]:
    """The schema elements of one nested field, depth first; `converted`
    gives a leaf's converted type."""
    root = dtype.root
    if root == TypeRoot.ARRAY:
        head = _group(name, repetition, 1, CONVERTED_LIST, LOGICAL_LIST)
        return [head, _group("list", REPEATED, 1)] + schema_elements("element", dtype.element, OPTIONAL, converted)
    if root == TypeRoot.MAP:
        head = _group(name, repetition, 1, CONVERTED_MAP, LOGICAL_MAP)
        return ([head, _group("key_value", REPEATED, 2)] + schema_elements("key", dtype.key, REQUIRED, converted)
                + schema_elements("value", dtype.value, OPTIONAL, converted))
    if root == TypeRoot.ROW:
        out = [_group(name, repetition, len(dtype.fields))]
        for f in dtype.fields:
            out += schema_elements(f.name, f.type, OPTIONAL, converted)
        return out
    return [build_struct([(1, _I32, physical_type(dtype)), (3, _I32, repetition), (4, _BINARY, name),
                          (6, _I32, converted(root) if converted else None)])]


def _group(name: str, repetition: int, children: int, converted=None, logical=None) -> bytes:
    fields = [(3, _I32, repetition), (4, _BINARY, name), (5, _I32, children), (6, _I32, converted)]
    if logical is not None:
        fields.append((10, _STRUCT, build_struct([(logical, _STRUCT, build_struct([]))])))
    return build_struct(fields)
