"""Key columns as order-preserving uint32 lanes (port of
paimon_tpu/data/keys.py).

Unsigned lexicographic comparison of a row's lane tuple equals the typed
comparison of its key tuple: signed ints flip the sign bit, 64-bit values
split into (hi, lo) lanes, floats map onto IEEE total order, and string
and bytes columns become one lane of dictionary ranks against a sorted
pool built over every input of one merge (exact, collision-free; the
strings themselves never reach the device).

Pools and ranks come from a fixed-width image of the values, not from
object comparisons: each string's code points (each byte of a bytes
value) plus one, zero-padded to the longest value, packed big-endian
into uint64 words. Python orders str by code point and bytes by unsigned
byte, so the words sort as the values do; the +1 keeps a real U+0000 (or
0x00 byte) above the padding, so 'a' < 'a\\x00' < 'a\\x00\\x00'. One
stable lexsort of the words then gives the sorted distinct values and
every row's rank, where the JAX package uses np.unique and searchsorted
over objects (and pyarrow's hash table from 65,536 rows on): the pools
are equal element for element and the ranks bit for bit.

A column that carries dictionary codes (code-backed under
merge.dict-domain, or with a dict_cache) stays in the code domain: its
pool is pruned to the codes in use and unified with the others'
(`exact_string_pool`, object work the size of the pools), and its ranks
come from a search of its pool in the merge pool plus one uint32 gather
through the codes (`_ranks_from_cache`). A fixed-width code-backed key
encodes its pool once and gathers each lane through the codes. String key
columns keep their (pool, ranks) as `dict_cache`, which the page encoder
writes as the dictionary page.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from ..types import STRING_ROOTS, RowType, TypeRoot
from .batch import Column, ColumnBatch

__all__ = [
    "encode_key_lanes",
    "encode_key_lanes_with_pools",
    "lane_count",
    "build_string_pool",
    "exact_string_pool",
    "split_int64_lanes",
    "lexsort_rows",
]

_ONE_LANE = (
    TypeRoot.BOOLEAN,
    TypeRoot.TINYINT,
    TypeRoot.SMALLINT,
    TypeRoot.INT,
    TypeRoot.DATE,
    TypeRoot.TIME,
    TypeRoot.FLOAT,
    *STRING_ROOTS,
)
_TWO_LANES = (TypeRoot.BIGINT, TypeRoot.TIMESTAMP, TypeRoot.TIMESTAMP_LTZ, TypeRoot.DOUBLE, TypeRoot.DECIMAL)
_MISSING = "string key value(s) missing from pool; pool must cover all merge inputs"


def lane_count(row_type: RowType, key_names: Sequence[str]) -> int:
    return sum(_lanes_for(row_type.field(name).type.root) for name in key_names)


def _lanes_for(root: TypeRoot) -> int:
    if root in _ONE_LANE:
        return 1
    if root in _TWO_LANES:
        return 2
    raise ValueError(f"type {root} not supported as a key column")


def split_int64_lanes(v: np.ndarray, signed: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """int64 -> (hi, lo) uint32 lanes, order preserving."""
    u = v.astype(np.int64).view(np.uint64)
    if signed:
        u = u ^ np.uint64(1 << 63)
    return (u >> np.uint64(32)).astype(np.uint32), (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)


# ---------------------------------------------------------------------------
# string and bytes pools
# ---------------------------------------------------------------------------


# above this many bytes of fixed-width image (rows x longest value) the
# pool is built from Python objects instead, as a few very long values
# would make the image too large
_IMAGE_BYTES_MAX = 1 << 28


def _sort_words(values: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """(n, w) uint64 words whose unsigned lexicographic order is the
    values' order (all str or all bytes)."""
    n = len(values)
    if isinstance(values[0], bytes):
        units = np.array(values, dtype=bytes)
        units = units.view(np.uint8).reshape(n, -1)
    else:
        units = values.astype(str)
        units = units.view(np.uint32).reshape(n, -1)
    top = int(units.max()) + 1
    width = 1 if top < 1 << 8 else 2 if top < 1 << 16 else 4
    codes = units.astype(f"u{width}")
    codes += 1
    # fixed-width arrays pad with zeros and cannot tell them from a real
    # trailing U+0000: the lengths say which slots are padding
    codes *= np.arange(units.shape[1]) < lengths[:, None]
    packed = codes.astype(f">u{width}").view(np.uint8).reshape(n, -1)
    pad = -packed.shape[1] % 8
    if pad or packed.shape[1] == 0:
        packed = np.concatenate([packed, np.zeros((n, pad or 8), np.uint8)], axis=1)
    return packed.view(">u8").astype(np.uint64)


def _pool_and_ranks(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The sorted distinct values (an object array) and every row's uint32
    rank in them: build_string_pool and the ranks against its result, from
    one sort."""
    n = len(values)
    if n == 0:
        return np.empty(0, dtype=object), np.empty(0, dtype=np.uint32)
    lengths = np.fromiter(map(len, values), np.int64, n)
    if n * int(lengths.max()) * 4 > _IMAGE_BYTES_MAX:
        distinct = sorted(set(values.tolist()))
        index = {v: i for i, v in enumerate(distinct)}
        pool = np.empty(len(distinct), dtype=object)
        pool[:] = distinct
        return pool, np.fromiter(map(index.__getitem__, values.tolist()), np.uint32, n)
    words = _sort_words(values, lengths)
    order = np.lexsort(words.T[::-1]) if words.shape[1] > 1 else np.argsort(words[:, 0], kind="stable")
    ordered = words[order]
    starts = np.ones(n, dtype=np.bool_)
    starts[1:] = (ordered[1:] != ordered[:-1]).any(axis=1)
    ranks = np.empty(n, dtype=np.uint32)
    ranks[order] = np.cumsum(starts, dtype=np.int64).astype(np.uint32) - np.uint32(1)
    return values.take(order[starts]), ranks


def pool_positions(pool: np.ndarray, values: np.ndarray) -> np.ndarray:
    """int64 index of each value in the sorted pool (its first equal entry),
    -1 where the value is not there: one sort of pool and values together,
    no object comparison."""
    if len(values) == 0:
        return np.empty(0, dtype=np.int64)
    if len(pool) == 0:
        return np.full(len(values), -1, dtype=np.int64)
    _, ranks = _pool_and_ranks(np.concatenate([pool, values]))
    pool_ranks, value_ranks = ranks[: len(pool)], ranks[len(pool) :]
    slot = np.full(int(ranks.max()) + 1, -1, dtype=np.int64)
    slot[pool_ranks[::-1]] = np.arange(len(pool) - 1, -1, -1)
    return slot[value_ranks]


def _ranks_in_pool(values: np.ndarray, pool: np.ndarray) -> np.ndarray:
    """uint32 rank of each value in the sorted pool; a value not in the pool
    raises."""
    out = pool_positions(pool, values)
    if (out < 0).any():
        raise ValueError(_MISSING)
    return out.astype(np.uint32)


def build_string_pool(column_values: Sequence[np.ndarray]) -> np.ndarray:
    """Sorted distinct values across every input of one merge, as an object
    array: ranks against it are exact order-preserving surrogates for the
    values themselves."""
    non_empty = [v for v in column_values if len(v)]
    if not non_empty:
        return np.empty(0, dtype=object)
    return _pool_and_ranks(np.concatenate(non_empty))[0]


def exact_string_pool(cols: Sequence[Column]) -> np.ndarray:
    """Sorted distinct present values across the columns: build_string_pool
    over their values, computed in the code domain when every column
    carries codes (each pool pruned to its valid rows' codes, then the
    pruned pools unified)."""
    from ..ops.dicts import cache_usable, prune_pool, unify_pools

    cols = list(cols)
    if cols and all(cache_usable(c) for c in cols):
        pruned = [prune_pool(c.dict_cache[0], c.dict_cache[1], c.validity)[0] for c in cols]
        return unify_pools(pruned)[0]
    return build_string_pool([c.values for c in cols])


def _ranks_from_cache(pool: np.ndarray, cache: tuple, validity: np.ndarray | None = None) -> np.ndarray:
    """Ranks of a (pool_c, codes) column in the sorted merge pool: a search
    the size of pool_c, then one uint32 gather through the codes. A valid
    row whose value is missing from the pool raises; a null row ranks 0."""
    from ..ops.dicts import remap_codes

    pool_c, codes = cache
    if pool_c is pool:
        return codes.astype(np.uint32, copy=False)
    live = codes if validity is None else codes[validity]
    if len(pool) == 0 or len(pool_c) == 0:
        if len(live) == 0:
            return np.zeros(len(codes), dtype=np.uint32)
        raise ValueError(_MISSING)
    idx = pool_positions(pool, pool_c)
    if len(live) and bool((idx.take(live.astype(np.int64)) < 0).any()):
        raise ValueError(_MISSING)
    return remap_codes(np.maximum(idx, 0).astype(np.uint32), np.minimum(codes, len(pool_c) - 1))


# ---------------------------------------------------------------------------
# lanes
# ---------------------------------------------------------------------------


def _encode_column(values: np.ndarray, root: TypeRoot, pool: np.ndarray | None) -> list[np.ndarray]:
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
        if pool is None:
            raise ValueError("string key column requires a pool (build_string_pool)")
        if len(pool) == 0:
            raise ValueError(_MISSING)
        return [_ranks_in_pool(values, pool)]
    raise ValueError(f"type {root} not supported as key column")


def _checked_column(batch: ColumnBatch, name: str) -> tuple[Column, TypeRoot]:
    col = batch.column(name)
    if col.null_count:
        raise ValueError(f"key column {name!r} contains nulls")
    return col, batch.schema.field(name).type.root


def _stack(lanes: list[np.ndarray], num_rows: int) -> np.ndarray:
    if not lanes:
        return np.zeros((num_rows, 0), dtype=np.uint32)
    return np.stack(lanes, axis=1)


def _fixed_lanes(col: Column, root: TypeRoot) -> list[np.ndarray]:
    """A fixed-width key's lanes; a code-backed one encodes its pool and
    gathers each lane through the codes (the same numbers)."""
    if col.is_code_backed:
        pool, codes = col.dict_cache
        return [lane.take(codes) for lane in _encode_column(pool, root, None)]
    return _encode_column(col.values, root, None)


def encode_key_lanes(
    batch: ColumnBatch,
    key_names: Sequence[str],
    string_pools: Mapping[str, np.ndarray] | None = None,
) -> np.ndarray:
    """(N, L) uint32 lanes for the given (non-null) key columns; each string
    or bytes column ranks against its pool in string_pools and keeps
    (pool, ranks) as its dict_cache."""
    from ..ops.dicts import cache_usable

    lanes: list[np.ndarray] = []
    for name in key_names:
        col, root = _checked_column(batch, name)
        pool = None if string_pools is None else string_pools.get(name)
        if root in STRING_ROOTS and pool is not None:
            if cache_usable(col):
                ranks = _ranks_from_cache(pool, col.dict_cache)
            else:
                ranks = _encode_column(col.values, root, pool)[0]
            col.dict_cache = (pool, ranks)
            lanes.append(ranks)
        elif root in STRING_ROOTS:
            lanes.extend(_encode_column(col.values, root, pool))
        else:
            lanes.extend(_fixed_lanes(col, root))
    return _stack(lanes, batch.num_rows)


def encode_key_lanes_with_pools(batch: ColumnBatch, key_names: Sequence[str]) -> np.ndarray:
    """encode_key_lanes with each string or bytes key column's pool built
    over the batch itself, so the batch must hold every input of the merge.
    The pool and the ranks come from one sort of the column, or from its
    codes when it carries them; either way the column keeps them as its
    dict_cache."""
    from ..ops.dicts import cache_usable

    lanes: list[np.ndarray] = []
    for name in key_names:
        col, root = _checked_column(batch, name)
        if root in STRING_ROOTS:
            if cache_usable(col):
                pool = exact_string_pool([col])
                ranks = _ranks_from_cache(pool, col.dict_cache)
            else:
                pool, ranks = _pool_and_ranks(col.values)
            col.dict_cache = (pool, ranks)
            lanes.append(ranks)
        else:
            lanes.extend(_fixed_lanes(col, root))
    return _stack(lanes, batch.num_rows)


def lexsort_rows(lanes: np.ndarray, *tiebreakers: np.ndarray) -> np.ndarray:
    """Host stable lexicographic argsort: lanes left to right are most to
    least significant, then the tie-breaker arrays; remaining ties keep
    input order."""
    keys = list(tiebreakers)[::-1] + [lanes[:, i] for i in range(lanes.shape[1] - 1, -1, -1)]
    if not keys:
        return np.arange(lanes.shape[0])
    return np.lexsort(keys)
