"""Dictionary codes as the merge currency (port of paimon_tpu/ops/dicts.py:
resolve_dict_domain, resolve_pool_limit, sort_dictionary, unify_pools,
remap_codes, cache_usable, unify_columns, encode_column and prune_pool).

A pool is the sorted distinct value set of a column and its codes are the
values' ranks in it, so codes compare as the values do. Under the table
option merge.dict-domain the reader (decode/) hands dictionary-encoded
chunks over as code-backed Columns; `unify_pools` merges the inputs' pools
into one and returns each input's gather table, `remap_codes` is that
|rows|-sized gather (on the host for a numpy array, as a torch gather on
the codes' device for a tensor, the JAX package's `remap_codes_jax`), and
`unify_columns` is Column.concat's code-domain seam. The codes then
become key lanes (data/keys.py), join keys (ops/join.py), GROUP BY codes
(`encode_column`, NULL rows coded as the sentinel len(pool)) and, pruned
by `prune_pool`, the dictionary pages of the files written (encode/).

The options are read as the table gives them; the JAX package's
PAIMON_TPU_DICT_* environment overrides are not copied. The large-pool
route of `unify_pools` through pyarrow's hash table is not ported (the
port does not import pyarrow): every pool set goes through np.unique, whose
output the JAX package's arrow route equals. `pool_value_hashes` and
`partition_rows*` belong to the SQL cluster's shuffle and wait with it.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from ..metrics import dict_metrics

__all__ = [
    "resolve_dict_domain",
    "resolve_pool_limit",
    "sort_dictionary",
    "unify_pools",
    "remap_codes",
    "remap_codes_np",
    "remap_codes_torch",
    "unify_columns",
    "prune_pool",
    "cache_usable",
    "encode_column",
]

DEFAULT_POOL_LIMIT = 1 << 20  # codes stay far inside uint32/int32 range


def resolve_dict_domain(enabled: "bool | str | None") -> bool:
    """merge.dict-domain as given (a bool or its string form); off when
    absent."""
    if enabled is None:
        return False
    if isinstance(enabled, str):
        return enabled.strip().lower() in ("1", "on", "true")
    return bool(enabled)


def resolve_pool_limit(limit: "int | str | None") -> int:
    """merge.dict-domain.pool-limit as given; 1 << 20 when absent. It bounds
    a single file's dictionary (reader admission) and a unified merge
    domain (the concat fallback) alike."""
    return DEFAULT_POOL_LIMIT if limit is None else int(limit)


def sort_dictionary(dictionary: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(sorted pool, remap) for one file dictionary: the sorted distinct
    values, and remap[old_code] the value's rank in the pool. String and
    bytes pools are object vectors; fixed-width ones keep their dtype."""
    if len(dictionary) == 0:
        return dictionary, np.zeros(0, dtype=np.uint32)
    pool, inverse = np.unique(dictionary, return_inverse=True)
    if pool.dtype != np.dtype(object) and pool.dtype.kind not in "biufM":
        pool = pool.astype(object)
    return pool, inverse.astype(np.uint32, copy=False)


def unify_pools(pools: Sequence[np.ndarray]) -> tuple[np.ndarray, list[np.ndarray | None]]:
    """Merge sorted pools into one sorted pool; returns each input's gather
    table from its ranks to the unified ranks (None = identity, when every
    pool holds the same values)."""
    g = dict_metrics()
    t0 = time.perf_counter()
    first = pools[0]
    same = all(p is first for p in pools)
    if not same and all(len(p) == len(first) for p in pools):
        try:
            same = all(bool(np.asarray(p == first).all()) for p in pools[1:])
        except (TypeError, ValueError):
            same = False
    g.counter("pools_unified").inc(len(pools))
    if same:
        g.histogram("unify_ms").update((time.perf_counter() - t0) * 1000)
        return first, [None] * len(pools)
    merged = np.concatenate(list(pools))
    if len(merged) == 0:
        return merged, [np.zeros(0, dtype=np.uint32) for _ in pools]
    unified, inverse = np.unique(merged, return_inverse=True)
    if unified.dtype != np.dtype(object) and merged.dtype == np.dtype(object):
        unified = unified.astype(object)
    inverse = inverse.astype(np.uint32, copy=False)
    remaps, off = [], 0
    for p in pools:
        remaps.append(inverse[off : off + len(p)])
        off += len(p)
    g.histogram("unify_ms").update((time.perf_counter() - t0) * 1000)
    return unified, remaps


def remap_codes_np(remap: np.ndarray, codes: np.ndarray) -> np.ndarray:
    return remap.take(codes).astype(np.uint32, copy=False)


def remap_codes_torch(remap: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """remap[codes] as one gather on the codes' device (int64 tensors: torch
    indexes by int64 and has no ordered uint32)."""
    return remap.index_select(0, codes)


def remap_codes(remap, codes):
    """codes -> remap[codes]: on the host for numpy arrays (uint32 out), as
    a torch gather on the codes' device for tensors."""
    if isinstance(codes, torch.Tensor):
        if remap is None or codes.numel() == 0:
            return codes
        return remap_codes_torch(torch.as_tensor(remap, dtype=torch.int64, device=codes.device), codes.long())
    codes = codes.astype(np.uint32, copy=False)
    if remap is None or len(codes) == 0 or len(remap) == 0:
        return codes
    dict_metrics().counter("codes_remapped").inc(len(codes))
    return remap_codes_np(remap, codes)


def cache_usable(col) -> bool:
    """True when a Column carries a full-length (pool, codes) cache: the
    precondition every code-domain consumer checks."""
    cache = getattr(col, "dict_cache", None)
    return cache is not None and len(cache[1]) == len(col)


def unify_columns(pools_and_codes: Sequence[tuple[np.ndarray, np.ndarray]], limit: int | None = None):
    """Concatenate (pool, codes) pairs without leaving the code domain:
    unify the pools and re-map and concatenate the codes (Column.concat of
    code-backed columns). Returns (pool, codes), or None when the unified
    domain would pass the pool limit; the rows then count as
    fallback_expanded."""
    pools = [p for p, _ in pools_and_codes]
    cap = resolve_pool_limit(limit)
    rows = sum(len(c) for _, c in pools_and_codes)
    if sum(len(p) for p in pools) > cap and len(set(map(id, pools))) > 1:
        # the cheap upper bound first: the exact size needs the unify itself
        dict_metrics().counter("fallback_expanded").inc(rows)
        return None
    unified, remaps = unify_pools(pools)
    if len(unified) > cap:
        dict_metrics().counter("fallback_expanded").inc(rows)
        return None
    return unified, np.concatenate([remap_codes(r, c) for r, (_, c) in zip(remaps, pools_and_codes)])


def encode_column(col) -> tuple[np.ndarray, np.ndarray]:
    """One Column -> (sorted pool, uint32 codes), NULL rows coded as the
    sentinel len(pool): the GROUP BY key currency. A column carrying codes
    stays in the code domain: its pool is pruned to the entries valid rows
    use and the codes re-rank, no value expanded. Other columns encode with
    np.unique over the valid rows (fixed-width pools keep their dtype,
    strings are object pools); a mixed-type object column that numpy cannot
    sort falls back to a first-seen walk, whose pool is then unsorted,
    which grouping does not mind."""
    n = len(col)
    valid = col.valid_mask()
    if cache_usable(col):
        pool, codes = col.dict_cache
        pool, codes = prune_pool(pool, codes, None if valid.all() else valid)
        codes = codes.astype(np.uint32, copy=True)
        codes[~valid] = len(pool)
        return pool, codes
    values = col.values
    live = values[valid]
    codes = np.empty(n, dtype=np.uint32)
    try:
        pool, inv = np.unique(live, return_inverse=True)
        if pool.dtype != np.dtype(object) and values.dtype == np.dtype(object):
            pool = pool.astype(object)
    except TypeError:
        seen: dict = {}
        inv = np.empty(len(live), dtype=np.uint32)
        for i, v in enumerate(live):
            inv[i] = seen.setdefault(v, len(seen))
        pool = np.empty(len(seen), dtype=object)
        for v, c in seen.items():
            pool[c] = v
    codes[valid] = inv.astype(np.uint32, copy=False)
    codes[~valid] = len(pool)
    return pool, codes


def prune_pool(pool: np.ndarray, codes: np.ndarray, validity: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Restrict a (pool, codes) pair to the entries valid rows reference:
    returns (pruned pool, re-mapped codes). Codes at invalid slots map
    through a clip (their value is meaningless)."""
    if len(pool) == 0:
        return pool, codes.astype(np.uint32, copy=False)
    live = codes if validity is None else codes[validity]
    used = np.zeros(len(pool), dtype=np.bool_)
    used[live] = True
    if used.all():
        return pool, codes.astype(np.uint32, copy=False)
    remap = np.cumsum(used, dtype=np.int64) - 1
    remap[~used] = 0
    return pool[used], remap_codes(remap.astype(np.uint32), codes)
