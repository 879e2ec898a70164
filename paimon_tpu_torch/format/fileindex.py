"""Column hashes for bucket routing and the hash index (port of the two
hash functions of paimon_tpu/format/fileindex.py; the file indexes
themselves are not ported).

Both packages must give the same 64 bits for the same value: a key that
one package routes to a bucket is routed there by the other too, so a
table written by both keeps each key in one bucket. Numbers hash their
int64 image (floats their float64 image, with -0.0 made 0.0 first);
strings and bytes hash crc32 | adler32 << 32 of their UTF-8 bytes; every
image then goes through splitmix64.
"""

from __future__ import annotations

import zlib

import numpy as np

__all__ = ["_splitmix64", "_hash64"]


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)).astype(np.uint64)
    x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)).astype(np.uint64)
    return x ^ (x >> np.uint64(31))


def _hash64(values: np.ndarray) -> np.ndarray:
    """(n,) uint64 hashes of a column's values (validity is not looked at)."""
    if values.dtype == np.dtype(object):
        out = np.empty(len(values), dtype=np.uint64)
        for i, v in enumerate(values):
            b = v.encode("utf-8") if isinstance(v, str) else (v if isinstance(v, bytes) else str(v).encode())
            out[i] = (zlib.crc32(b) | (np.uint64(zlib.adler32(b)) << np.uint64(32))) & np.uint64(0xFFFFFFFFFFFFFFFF)
        return _splitmix64(out)
    if values.dtype.kind == "f":
        values = values + 0.0  # -0.0 hashes as 0.0
        values = values.astype(np.float64).view(np.uint64)
    else:
        values = values.astype(np.int64).view(np.uint64)
    return _splitmix64(values)
