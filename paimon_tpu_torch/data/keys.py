"""Key columns as order-preserving uint32 lanes (port of
paimon_tpu/data/keys.py, fixed-width keys).

Unsigned lexicographic comparison of a row's lane tuple equals the typed
comparison of its key tuple: signed ints flip the sign bit, 64-bit values
split into (hi, lo) lanes, floats map onto IEEE total order. String and
bytes keys (dictionary-rank lanes over a merge-wide pool) are not ported
yet and raise NotImplementedError.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..types import STRING_ROOTS, TypeRoot
from .batch import ColumnBatch

__all__ = ["encode_key_lanes", "split_int64_lanes", "lexsort_rows"]


def split_int64_lanes(v: np.ndarray, signed: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """int64 -> (hi, lo) uint32 lanes, order preserving."""
    u = v.astype(np.int64).view(np.uint64)
    if signed:
        u = u ^ np.uint64(1 << 63)
    return (u >> np.uint64(32)).astype(np.uint32), (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def encode_column(values: np.ndarray, root: TypeRoot) -> list[np.ndarray]:
    if root == TypeRoot.BOOLEAN:
        return [values.astype(np.uint32)]
    if root in (TypeRoot.TINYINT, TypeRoot.SMALLINT, TypeRoot.INT, TypeRoot.DATE, TypeRoot.TIME):
        return [values.astype(np.int32).view(np.uint32) ^ np.uint32(0x80000000)]
    if root in (TypeRoot.BIGINT, TypeRoot.TIMESTAMP, TypeRoot.TIMESTAMP_LTZ, TypeRoot.DECIMAL):
        return list(split_int64_lanes(values))
    if root == TypeRoot.FLOAT:
        b = values.astype(np.float32).view(np.uint32)
        neg = (b & np.uint32(0x80000000)) != 0
        return [np.where(neg, ~b, b | np.uint32(0x80000000))]
    if root == TypeRoot.DOUBLE:
        b = values.astype(np.float64).view(np.uint64)
        neg = (b & np.uint64(1 << 63)) != 0
        u = np.where(neg, ~b, b | np.uint64(1 << 63))
        return [(u >> np.uint64(32)).astype(np.uint32), (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)]
    if root in STRING_ROOTS:
        raise NotImplementedError("string/bytes key columns are not supported by the torch port yet")
    raise ValueError(f"type {root} not supported as a key column")


def encode_key_lanes(batch: ColumnBatch, key_names: Sequence[str]) -> np.ndarray:
    """(N, L) uint32 lanes for the given (non-null) key columns."""
    lanes: list[np.ndarray] = []
    for name in key_names:
        col = batch.column(name)
        if col.null_count:
            raise ValueError(f"key column {name!r} contains nulls")
        lanes.extend(encode_column(col.values, batch.schema.field(name).type.root))
    if not lanes:
        return np.zeros((batch.num_rows, 0), dtype=np.uint32)
    return np.stack(lanes, axis=1)


def lexsort_rows(lanes: np.ndarray, *tiebreakers: np.ndarray) -> np.ndarray:
    """Host stable lexicographic argsort: lanes left to right are most to
    least significant, then the tie-breaker arrays; remaining ties keep
    input order."""
    keys = list(tiebreakers)[::-1] + [lanes[:, i] for i in range(lanes.shape[1] - 1, -1, -1)]
    if not keys:
        return np.arange(lanes.shape[0])
    return np.lexsort(keys)
