"""zstd, snappy, lz4 and gzip for the port (port of paimon_tpu/utils/compression.py,
same names for zstd).

The JAX package gets its zstd from `zstandard` or pyarrow; the port may
import neither, so both directions run through its own C codec
(native/zstd.c). Frames are standard RFC 8878 frames: either package reads
what the other writes.

Decompression writes straight into one preallocated buffer whose size is
known: the caller's (a Parquet page header's uncompressed size) or the
frames' declared content size. A frame that declares no content size (as
`zstandard`'s stream writer makes them) is decoded into a buffer that grows.
A malformed frame raises ValueError.

The encoder has one strength: `level` is taken for the JAX package's
signature and changes nothing.

snappy is the raw block format of Parquet's SNAPPY pages, through the
port's own C codec (native/snappy.c); lz4 is the raw block format of
Parquet's LZ4_RAW pages and of ORC's LZ4 chunks (native/lz4.c); gzip goes
through the standard library's zlib, writing gzip members and reading gzip
or zlib streams.
"""

from __future__ import annotations

import ctypes
import zlib

import numpy as np

from ..native import lz4_library, snappy_library, zstd_library

__all__ = [
    "ZSTD_MAGIC",
    "zstd_compress",
    "zstd_decompress",
    "snappy_compress",
    "snappy_decompress",
    "lz4_compress",
    "lz4_decompress",
    "gzip_compress",
    "gzip_decompress",
]

ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"

_E_DST_TOO_SMALL = -12  # E_DST_TOO_SMALL in native/zstd.c
_FIRST_GUESS = 1 << 16


def _error(lib, code: int) -> ValueError:
    return ValueError(f"malformed zstd frame: {lib.pz_error(code).decode()}")


def zstd_compress(data, level: int = 3) -> bytes:
    """One zstd frame holding `data`, with its content size; the same frame
    at every level."""
    lib = zstd_library()
    src = np.frombuffer(data, dtype=np.uint8)
    cap = lib.pz_compress_bound(len(src))
    out = np.empty(cap, dtype=np.uint8)
    n = lib.pz_compress(out.ctypes.data, cap, src.ctypes.data, len(src))
    if n < 0:
        raise _error(lib, n)
    return out[:n].tobytes()


def zstd_decompress(data, size: int | None = None) -> memoryview:
    """The content of every zstd frame in `data`, as a memoryview over a
    fresh buffer. `size`, when given, is the exact decompressed size the
    caller expects; any other size raises ValueError."""
    lib = zstd_library()
    src = np.frombuffer(data, dtype=np.uint8)
    declared = ctypes.c_int64(-1)
    bound = lib.pz_frame_bound(src.ctypes.data, len(src), ctypes.byref(declared))
    if bound < 0:
        raise _error(lib, bound)
    want = size if size is not None else (declared.value if declared.value >= 0 else None)
    if want is not None and (want > bound or (declared.value >= 0 and declared.value != want)):
        raise ValueError(f"zstd frames hold {declared.value} bytes (at most {bound}), not the {want} expected")
    cap = want if want is not None else min(bound, max(_FIRST_GUESS, 4 * len(src)))
    while True:
        out = np.empty(cap, dtype=np.uint8)
        n = lib.pz_decompress(out.ctypes.data, cap, src.ctypes.data, len(src))
        if n == _E_DST_TOO_SMALL and want is None and cap < bound:
            cap = min(bound, 2 * cap)
            continue
        if n < 0:
            raise _error(lib, n)
        if want is not None and n != want:
            raise ValueError(f"zstd frames decompress to {n} bytes, not the {want} expected")
        return memoryview(out)[:n]


def snappy_compress(data) -> bytes:
    """One snappy raw block holding `data`."""
    lib = snappy_library()
    src = np.frombuffer(data, dtype=np.uint8)
    cap = lib.ps_compress_bound(len(src))
    out = np.empty(cap, dtype=np.uint8)
    n = lib.ps_compress(src.ctypes.data, len(src), out.ctypes.data, cap)
    if n < 0:
        raise ValueError(f"snappy encoder failed ({n})")
    return out[:n].tobytes()


def snappy_decompress(data, size: int | None = None) -> memoryview:
    """The content of a snappy raw block. `size`, when given, is the exact
    length the caller expects; a malformed block or another length raises
    ValueError."""
    lib = snappy_library()
    src = np.frombuffer(data, dtype=np.uint8)
    declared = lib.ps_uncompressed_length(src.ctypes.data, len(src))
    if declared < 0 or (size is not None and declared != size):
        raise ValueError(f"snappy block declares {declared} bytes, not the {size} expected")
    out = np.empty(declared, dtype=np.uint8)
    n = lib.ps_decompress(src.ctypes.data, len(src), out.ctypes.data, declared)
    if n != declared:
        raise ValueError(f"malformed snappy block ({n})")
    return memoryview(out)


_LZ4_E_DST_TOO_SMALL = -2  # PL_E_DST_TOO_SMALL in native/lz4.c


def lz4_compress(data) -> bytes:
    """One LZ4 raw block holding `data`."""
    lib = lz4_library()
    src = np.frombuffer(data, dtype=np.uint8)
    cap = lib.pl_compress_bound(len(src))
    out = np.empty(cap, dtype=np.uint8)
    n = lib.pl_compress(src.ctypes.data, len(src), out.ctypes.data, cap)
    if n < 0:
        raise ValueError(f"lz4 encoder failed ({n})")
    return out[:n].tobytes()


def lz4_decompress(data, size: int | None = None, limit: int | None = None) -> memoryview:
    """The content of an LZ4 raw block, which declares no length. `size`,
    when given, is the exact length the caller expects; else `limit`, when
    given, bounds it (an ORC chunk's compression block size); else the
    buffer grows until the block fits. A malformed block, another length or
    one past the limit raises ValueError."""
    lib = lz4_library()
    src = np.frombuffer(data, dtype=np.uint8)
    cap = size if size is not None else limit if limit is not None else max(_FIRST_GUESS, 4 * len(src))
    while True:
        out = np.empty(cap, dtype=np.uint8)
        n = lib.pl_decompress(src.ctypes.data, len(src), out.ctypes.data, cap)
        if n == _LZ4_E_DST_TOO_SMALL and size is None and limit is None:
            cap *= 2
            continue
        if n < 0 or (size is not None and n != size):
            raise ValueError(f"malformed lz4 block ({n}; {size} bytes expected)")
        return memoryview(out)[:n]


def gzip_compress(data) -> bytes:
    """One gzip member holding `data`."""
    c = zlib.compressobj(6, zlib.DEFLATED, 31)
    return c.compress(data) + c.flush()


def gzip_decompress(data, size: int | None = None) -> memoryview:
    """The content of a gzip (or zlib) stream; `size`, when given, must
    match."""
    try:
        out = zlib.decompress(data, 47)
    except zlib.error as e:
        raise ValueError(f"malformed gzip stream: {e}") from None
    if size is not None and len(out) != size:
        raise ValueError(f"gzip stream holds {len(out)} bytes, not the {size} expected")
    return memoryview(out)
