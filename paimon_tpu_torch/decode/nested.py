"""Record assembly of nested columns from their leaves' levels (Dremel).

Each leaf of a nested column decodes to its repetition levels, definition
levels and the values of its entries at the maximum definition level
(pages.py `decode_leaf`). Every instance of a schema element is located,
leaf by leaf, by the index of its first level entry there:

  * the records are the entries at repetition level 0;
  * an instance is present when the definition level of its first entry
    reaches the element's own (`SchemaNode.def_level`), so a null list, an
    empty list, a null element and a value differ by that level alone;
  * the elements of a repeated group R start at the first entry of each
    non-empty instance and at every entry whose repetition level is R's.

Only these index arrays are built per level, with numpy; the Python lists,
dicts and field dicts are built once per element, bottom up, at the end.
The values are those the JAX package reads back through pyarrow
(paimon_tpu/data/batch.py `_restore_nested`): an ARRAY is a list, a MAP a
dict in the file's entry order, a ROW a dict by field name in the type's
field order (a field the file lacks reads as None, and a field the type
lacks is not read).

The layouts are pyarrow's: a LIST-annotated group holding one repeated
group of one element (three levels), a MAP-annotated group holding one
repeated group of key and value, and a plain group for a ROW. Anything
else raises ParquetFormatError naming the layout.
"""

from __future__ import annotations

import functools
import itertools
import operator

import numpy as np

from ..types import DataType, TypeRoot
from .container import REPEATED, ParquetFormatError, SchemaNode

__all__ = ["assemble_column", "check_layout", "leaf_types"]

_OBJ = np.dtype(object)


def _objects(values, n: int) -> np.ndarray:
    """n Python values as a 1-d object vector (a list value stays one
    element; np.array would make it a dimension)."""
    return np.fromiter(values, dtype=_OBJ, count=n)


def _runs(seq: list, offsets: np.ndarray):
    """seq[offsets[i]:offsets[i + 1]] for each i, sliced without a Python
    frame per run."""
    return map(operator.getitem, itertools.repeat(seq), map(slice, offsets[:-1].tolist(), offsets[1:].tolist()))


@functools.lru_cache(maxsize=256)
def _row_maker(names: tuple[str, ...]):
    """A function from the field columns to the ROW dicts, one dict display
    per row (about 3x faster than dict(zip(names, row))); the names enter
    the code as repr() literals."""
    args = ", ".join(f"c{i}" for i in range(len(names)))
    items = ", ".join(f"{name!r}: v{i}" for i, name in enumerate(names))
    values = ", ".join(f"v{i}" for i in range(len(names)))
    return eval(f"lambda {args}: ({{{items}}} for {values}{',' if len(names) == 1 else ''} in zip({args}))")


def _repeated_child(node: SchemaNode, dtype: DataType, want: int) -> SchemaNode:
    """The repeated group under a LIST or MAP group, with `want` children."""
    kind = "LIST" if dtype.root == TypeRoot.ARRAY else "MAP"
    if node.is_leaf:
        raise ParquetFormatError(f"column {node.path}: a primitive where the type is {kind}")
    if node.annotation != kind:
        raise ParquetFormatError(f"column {node.path}: a group annotated {node.annotation} where the type is {kind}")
    if len(node.children) != 1 or node.children[0].repetition != REPEATED or node.children[0].is_leaf:
        raise ParquetFormatError(f"column {node.path}: a {kind} group without one repeated group inside")
    rep = node.children[0]
    if len(rep.children) != want or (kind == "LIST" and rep.name in ("array", f"{node.name}_tuple")):
        raise ParquetFormatError(f"column {node.path}: a two-level (legacy) {kind} layout")
    return rep


def check_layout(node: SchemaNode, dtype: DataType) -> None:
    """Raise ParquetFormatError unless `node` is the layout of `dtype`."""
    if node.repetition == REPEATED and node.annotation is None and not node.is_leaf:
        raise ParquetFormatError(f"column {node.path}: a repeated group outside a LIST or MAP")
    root = dtype.root
    if root == TypeRoot.ARRAY:
        check_layout(_repeated_child(node, dtype, 1).children[0], dtype.element)
    elif root == TypeRoot.MAP:
        rep = _repeated_child(node, dtype, 2)
        check_layout(rep.children[0], dtype.key)
        check_layout(rep.children[1], dtype.value)
    elif root == TypeRoot.ROW:
        if node.is_leaf or node.annotation is not None:
            raise ParquetFormatError(f"column {node.path}: not a plain group where the type is ROW")
        by_name = {c.name: c for c in node.children}
        for f in dtype.fields:
            if f.name in by_name:
                check_layout(by_name[f.name], f.type)
    elif not node.is_leaf or node.repetition == REPEATED:
        raise ParquetFormatError(f"column {node.path}: a group or repeated field where the type is {dtype}")


def leaf_types(node: SchemaNode, dtype: DataType) -> dict:
    """{leaf path: flat type} of the leaves under `node` that `dtype`
    reads; the leaves of a ROW field the type lacks are not read."""
    if node.is_leaf:
        return {node.path: dtype}
    if dtype.root == TypeRoot.ARRAY:
        return leaf_types(node.children[0].children[0], dtype.element)
    if dtype.root == TypeRoot.MAP:
        key, value = node.children[0].children
        return {**leaf_types(key, dtype.key), **leaf_types(value, dtype.value)}
    out = {}
    for child in node.children:
        if child.name in dtype:
            out.update(leaf_types(child, dtype.field(child.name).type))
    return out


class _Leaf:
    """One leaf's levels and values, and each entry's value index."""

    def __init__(self, rep: np.ndarray, def_: np.ndarray, values: np.ndarray, max_def: int):
        self.rep, self.def_, self.values = rep, def_, values
        self.vidx = np.cumsum(def_ == max_def) - 1  # the value of an entry at max_def


def _present(node: SchemaNode, leaves: dict, firsts: dict) -> np.ndarray:
    path = next(iter(firsts))  # any leaf read under the node
    return leaves[path].def_[firsts[path]] >= node.def_level


def _under(node: SchemaNode, firsts: dict) -> dict:
    return {p: x for p, x in firsts.items() if p == node.path or p.startswith(node.path + ".")}


def _build(node: SchemaNode, dtype: DataType, leaves: dict, firsts: dict) -> np.ndarray:
    """The values (an object vector, None where null) of the instances of
    `node` whose first entries, leaf by leaf, are `firsts`."""
    n = len(next(iter(firsts.values())))
    present = _present(node, leaves, firsts)
    if present.all():
        sub = firsts
    else:
        sub = {p: f[present] for p, f in firsts.items()}
    k = int(present.sum())
    root = dtype.root
    if node.is_leaf:
        leaf = leaves[node.path]
        built = leaf.values[leaf.vidx[sub[node.path]]]
        if built.dtype != _OBJ:
            built = _objects(built.tolist(), k)
    elif root == TypeRoot.ROW:
        by_name = {c.name: c for c in node.children}
        columns = []
        for f in dtype.fields:
            child = by_name.get(f.name)
            if child is None:
                columns.append([None] * k)
                continue
            columns.append(_build(child, f.type, leaves, _under(child, sub)).tolist())
        built = _objects(_row_maker(tuple(dtype.field_names))(*columns), k)
    else:
        rep_node = node.children[0]
        elem_firsts, offsets = {}, None
        for p, first in sub.items():
            leaf = leaves[p]
            nonempty = leaf.def_[first] >= rep_node.def_level
            more = np.flatnonzero(leaf.rep == rep_node.rep_level)
            starts = np.sort(np.concatenate([first[nonempty], more]))
            if offsets is None:
                counts = nonempty.astype(np.int64)
                if len(more):
                    counts += np.bincount(np.searchsorted(first, more, side="right") - 1, minlength=k)
                offsets = np.zeros(k + 1, dtype=np.int64)
                np.cumsum(counts, out=offsets[1:])
            elif len(starts) != offsets[-1]:
                raise ParquetFormatError(f"column {node.path}: leaves disagree on the element count")
            elem_firsts[p] = starts
        if root == TypeRoot.ARRAY:
            elems = _build(rep_node.children[0], dtype.element, leaves, elem_firsts).tolist()
            built = _objects(_runs(elems, offsets), k)
        else:
            key_node, value_node = rep_node.children
            keys = _build(key_node, dtype.key, leaves, _under(key_node, elem_firsts))
            vals = _build(value_node, dtype.value, leaves, _under(value_node, elem_firsts))
            built = _objects(map(dict, _runs(list(zip(keys.tolist(), vals.tolist())), offsets)), k)
    if k == n:
        return built
    out = np.full(n, None, dtype=_OBJ)
    out[present] = built
    return out


def assemble_column(node: SchemaNode, dtype: DataType, leaves: dict, num_rows: int):
    """(object vector, validity or None) of one nested column of a row
    group, from {leaf path: (rep, def, values)} of the leaves of `node`
    that `leaf_types` names."""
    check_layout(node, dtype)
    by_path = {leaf.path: leaf for leaf in node.leaves()}
    state, firsts = {}, {}
    for path, (rep, def_, values) in leaves.items():
        leaf = by_path[path]
        state[path] = _Leaf(rep, def_, values, leaf.def_level)
        first = np.flatnonzero(rep == 0) if leaf.rep_level else np.arange(len(rep))
        if len(first) != num_rows:
            raise ParquetFormatError(f"column {path}: {len(first)} records, row group has {num_rows}")
        firsts[path] = first
    values = _build(node, dtype, state, firsts)
    validity = _present(node, state, firsts)
    return values, (None if validity.all() else validity)
