"""Row -> (partition, bucket) routing (port of paimon_tpu/table/bucket.py).

A fixed-bucket table sends each row to hash(bucket key) % bucket; the
hash is format/fileindex.py's, bit for bit the JAX package's, so both
packages route a key to the same bucket. Routing a batch is a handful of
numpy calls, not a loop over rows.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..data.batch import ColumnBatch
from ..format.fileindex import _hash64

__all__ = ["key_hashes", "bucket_ids", "group_by_partition_bucket"]


def key_hashes(batch: ColumnBatch, key_names: Sequence[str]) -> np.ndarray:
    """(n,) uint64 combined hash of the key columns. A null-free column
    carrying dictionary codes hashes its pool once and gathers through the
    codes (the same hashes, no value expanded)."""
    from ..ops.dicts import cache_usable

    h = np.zeros(batch.num_rows, dtype=np.uint64)
    for name in key_names:
        col = batch.column(name)
        if cache_usable(col) and col.validity is None:
            pool, codes = col.dict_cache
            hv = _hash64(pool)[codes] if len(pool) else np.zeros(len(col), dtype=np.uint64)
        else:
            hv = _hash64(col.values)
        h = h * np.uint64(0x100000001B3) ^ hv
    return h


def bucket_ids(batch: ColumnBatch, bucket_keys: Sequence[str], num_buckets: int) -> np.ndarray:
    """(n,) int32 bucket per row: combined column hashes mod num_buckets."""
    return (key_hashes(batch, bucket_keys) % np.uint64(num_buckets)).astype(np.int32)


def group_by_partition_bucket(
    batch: ColumnBatch,
    partition_keys: Sequence[str],
    bucket_keys: Sequence[str],
    num_buckets: int,
) -> list[tuple[tuple, int, np.ndarray]]:
    """[(partition, bucket, row indices)], grouped in the JAX package's order
    (by bucket, then by each partition column's sorted values). A null
    partition value raises: the JAX package fails on it (np.unique cannot
    order None among strings, and a null number would be written as 0), so
    the port refuses it rather than choose a layout."""
    n = batch.num_rows
    buckets = bucket_ids(batch, bucket_keys, num_buckets) if num_buckets > 1 else np.zeros(n, dtype=np.int32)
    if not partition_keys:
        return [((), int(b), np.flatnonzero(buckets == b)) for b in np.unique(buckets)]
    codes = buckets.astype(np.int64)
    for name in partition_keys:
        col = batch.column(name)
        if col.validity is not None or (col.values.dtype == np.dtype(object) and (col.values == None).any()):  # noqa: E711
            raise NotImplementedError(
                f"null value in partition column {name!r}: the torch port does not write null partition values "
                "(the partition.default-name directory) yet"
            )
        u, inv = np.unique(col.values, return_inverse=True)
        codes = codes * np.int64(len(u)) + inv
    out = []
    for code in np.unique(codes):
        rows = np.flatnonzero(codes == code)
        r0 = rows[0]
        partition = tuple(
            v.item() if hasattr((v := batch.column(k).values[r0]), "item") else v for k in partition_keys
        )
        out.append((partition, int(buckets[r0]), rows))
    return out
