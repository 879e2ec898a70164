"""Column -> page assembly: one column of one row group into a dictionary
page, data pages and chunk statistics (port of paimon_tpu/encode/pages.py).

Encoding per chunk:
  * a column carrying (pool, codes), code-backed or with the key-lane
    encoder's dict_cache: the dictionary page straight from the pool
    pruned to the codes in use (ops/dicts.py prune_pool), RLE_DICTIONARY
    codes straight from the codes, the chunk statistics from the pool's
    edges; no value is expanded;
  * other BYTE_ARRAY: a sorted dictionary when the distinct values are at
    most 2/3 of the valid rows, PLAIN otherwise;
  * INT32/INT64: DELTA_BINARY_PACKED when the valid values are sorted (64
    or more), else a numeric dictionary under the same 2/3 rule, else PLAIN;
  * BOOLEAN / FLOAT / DOUBLE: PLAIN.
`enable_dict` False (parquet.enable.dictionary=false) writes no dictionary.
Definition levels are always written (every leaf is OPTIONAL); an all-valid
page's levels are one RLE run. Pages hold about `page_size` bytes of values
(parquet.page-size); `page_v2` writes DATA_PAGE_V2 headers
(parquet.data-page-version=2.0).
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass, field

import numpy as np

from ..data.batch import Column
from ..format.thrift import append_uvarint, build_struct
from ..ops.dicts import cache_usable, prune_pool
from ..types import DataType
from ..utils.compression import zstd_compress
from . import kernels
from ..decode.container import (
    CODEC_ZSTD,
    ENC_DELTA_BINARY_PACKED,
    ENC_PLAIN,
    ENC_RLE,
    ENC_RLE_DICTIONARY,
    PAGE_DATA,
    PAGE_DATA_V2,
    PAGE_DICTIONARY,
    PLAIN_DTYPES,
    T_BOOLEAN,
    T_BYTE_ARRAY,
    T_DOUBLE,
    T_FLOAT,
    T_INT32,
    T_INT64,
)

__all__ = ["EncodedChunk", "encode_chunk"]

_BOOL, _I32, _I64, _BINARY, _STRUCT = 1, 5, 6, 8, 12
_DICT_RATIO_NUM, _DICT_RATIO_DEN = 2, 3
_STAT_MAX_LEN = 64  # byte-array statistics this long or longer are left out
_ITEMSIZE = {T_INT32: 4, T_INT64: 8, T_FLOAT: 4, T_DOUBLE: 8}


@dataclass
class EncodedChunk:
    """One column chunk, ready for the row group."""

    pages: list[bytes] = field(default_factory=list)  # header + body, dictionary page first
    encodings: tuple[int, ...] = ()
    total_uncompressed: int = 0
    total_compressed: int = 0
    dict_page_len: int = 0  # 0 = no dictionary page
    stats: bytes = b""
    num_pages: int = 0  # data pages


def _stat_bytes(v, physical: int) -> bytes | None:
    if physical == T_BOOLEAN:
        return b"\x01" if bool(v) else b"\x00"
    if physical == T_BYTE_ARRAY:
        raw = v.encode("utf-8") if isinstance(v, str) else bytes(v)
        return raw if len(raw) < _STAT_MAX_LEN else None
    return np.asarray([v], dtype=PLAIN_DTYPES[physical]).tobytes()


def _stats_struct(lo, hi, physical: int, null_count: int) -> bytes:
    lo_b = hi_b = None
    if lo is not None and hi is not None:
        lo_b, hi_b = _stat_bytes(lo, physical), _stat_bytes(hi, physical)
    return build_struct([(3, _I64, null_count), (5, _BINARY, hi_b), (6, _BINARY, lo_b)])


def _min_max(compact: np.ndarray, physical: int):
    """(min, max) of the valid values, or (None, None) (empty, or a NaN in
    a float column)."""
    if len(compact) == 0:
        return None, None
    if physical in (T_FLOAT, T_DOUBLE):
        with np.errstate(invalid="ignore"):
            lo, hi = np.nanmin(compact), np.nanmax(compact)
        return (None, None) if np.isnan(lo) or np.isnan(hi) else (lo, hi)
    if compact.dtype == np.dtype(object):
        return min(compact), max(compact)
    return compact.min(), compact.max()


class _PageSink:
    """Accumulates one chunk's pages, v1 or v2."""

    def __init__(self, chunk: EncodedChunk, codec: int, page_v2: bool):
        self.chunk = chunk
        self.codec = codec
        self.page_v2 = page_v2

    def _compress(self, raw: bytes) -> bytes:
        return zstd_compress(raw) if self.codec == CODEC_ZSTD else raw

    def add_dict_page(self, payload: bytes, num_values: int) -> None:
        body = self._compress(payload)
        dh = build_struct([(1, _I32, num_values), (2, _I32, ENC_PLAIN), (3, _BOOL, True)])
        header = build_struct([(1, _I32, PAGE_DICTIONARY), (2, _I32, len(payload)), (3, _I32, len(body)), (7, _STRUCT, dh)])
        self.chunk.pages.append(header + body)
        self.chunk.dict_page_len = len(header) + len(body)
        self.chunk.total_uncompressed += len(header) + len(payload)
        self.chunk.total_compressed += len(header) + len(body)

    def add_data_page(self, levels: bytes, values: bytes, n: int, n_valid: int, enc: int) -> None:
        if self.page_v2:
            body = self._compress(values)
            dh = build_struct(
                [
                    (1, _I32, n),
                    (2, _I32, n - n_valid),
                    (3, _I32, n),
                    (4, _I32, enc),
                    (5, _I32, len(levels)),
                    (6, _I32, 0),
                    (7, _BOOL, self.codec == CODEC_ZSTD),
                ]
            )
            header = build_struct(
                [(1, _I32, PAGE_DATA_V2), (2, _I32, len(levels) + len(values)), (3, _I32, len(levels) + len(body)), (8, _STRUCT, dh)]
            )
            page = header + levels + body
            self.chunk.total_uncompressed += len(header) + len(levels) + len(values)
        else:
            raw = struct.pack("<I", len(levels)) + levels + values
            body = self._compress(raw)
            dh = build_struct([(1, _I32, n), (2, _I32, enc), (3, _I32, ENC_RLE), (4, _I32, ENC_RLE)])
            header = build_struct([(1, _I32, PAGE_DATA), (2, _I32, len(raw)), (3, _I32, len(body)), (5, _STRUCT, dh)])
            page = header + body
            self.chunk.total_uncompressed += len(header) + len(raw)
        self.chunk.total_compressed += len(page)
        self.chunk.pages.append(page)
        self.chunk.num_pages += 1


def _levels(validity: np.ndarray | None, start: int, stop: int) -> bytes:
    """A page's definition levels: one RLE run when every row is valid,
    else one bit-packed span (a run per stretch of rows between sparse
    nulls would cost the reader a header each)."""
    out = bytearray()
    if validity is None:  # all valid: one RLE run of level 1
        append_uvarint(out, (stop - start) << 1)
        out += b"\x01"
        return bytes(out)
    append_uvarint(out, (((stop - start + 7) >> 3) << 1) | 1)
    out += np.packbits(validity[start:stop], bitorder="little").tobytes()
    return bytes(out)


def _page_bounds(n: int, bytes_per_value: float, page_size: int) -> range:
    return range(0, max(n, 1), max(1, int(page_size / max(bytes_per_value, 1e-9))))


def _write_dictionary(sink, chunk, validity, cidx, n, pool_bytes: bytes, dict_size: int, codes, page_size, metrics):
    """The dictionary page, then the RLE_DICTIONARY data pages of `codes`
    (the valid rows' codes)."""
    sink.add_dict_page(pool_bytes, dict_size)
    if metrics is not None:
        metrics.counter("dict_pages").inc()
    width = kernels.bit_width_for(max(dict_size - 1, 0))
    if len(codes) > 50_000 and 0 < width < 32 and width % 8:
        width = (width + 7) & ~7  # byte-aligned widths pack without a bit matrix
    bounds = _page_bounds(n, max(width, 1) / 8 + 0.125, page_size)
    for start in bounds:
        stop = min(start + bounds.step, n)
        page_codes = codes[int(cidx[start]) : int(cidx[stop])]
        body = bytes([width]) + kernels.encode_rle_hybrid(page_codes, width)
        sink.add_data_page(_levels(validity, start, stop), body, stop - start, len(page_codes), ENC_RLE_DICTIONARY)
    chunk.encodings = (ENC_PLAIN, ENC_RLE, ENC_RLE_DICTIONARY)


def _dictionary_of(col: Column, validity, compact_fn, n_valid: int, physical: int):
    """(pool, codes of the valid rows) for the dictionary route, or None for
    PLAIN/DELTA. A column carrying codes gives its pruned pool (a string
    column always: its codes are free; a fixed-width one under the 2/3
    rule); others encode their valid values under the 2/3 rule."""
    if cache_usable(col):
        pool, codes = col.dict_cache
        if validity is not None:
            codes = codes[validity]
        pool, codes = prune_pool(pool, codes)
        if physical == T_BYTE_ARRAY or len(pool) * _DICT_RATIO_DEN <= n_valid * _DICT_RATIO_NUM:
            return pool, codes.astype(np.int64)
        return None
    compact = compact_fn()
    if physical == T_BYTE_ARRAY:
        from ..data.keys import _pool_and_ranks

        pool, codes = _pool_and_ranks(compact)
    else:
        if n_valid < 64:
            return None
        pool, codes = np.unique(compact, return_inverse=True)
    if len(pool) * _DICT_RATIO_DEN > n_valid * _DICT_RATIO_NUM:
        return None
    return pool, np.asarray(codes, dtype=np.int64).reshape(-1)


def encode_chunk(col: Column, dtype: DataType, physical: int, *, page_size: int, page_v2: bool, enable_dict: bool,
                 codec: int, metrics=None) -> EncodedChunk:
    """Encode one column (one row group's rows) into an EncodedChunk."""
    t0 = time.perf_counter()
    n = len(col)
    validity = col.validity
    n_valid = n if validity is None else int(validity.sum())
    if validity is None:
        cidx = np.arange(n + 1, dtype=np.int64)
    else:
        cidx = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(validity, out=cidx[1:])
    chunk = EncodedChunk()
    sink = _PageSink(chunk, codec, page_v2)
    null_count = n - n_valid

    def compact_values():
        v = col.values
        return v if validity is None else v[validity]

    route = None
    if enable_dict and n_valid and physical in (T_BYTE_ARRAY, T_INT32, T_INT64):
        if physical != T_BYTE_ARRAY and not cache_usable(col):
            compact = np.ascontiguousarray(compact_values(), dtype=PLAIN_DTYPES[physical])
            sorted_ints = n_valid >= 64 and bool(np.all(np.diff(compact) >= 0))
            route = None if sorted_ints else _dictionary_of(col, validity, lambda: compact, n_valid, physical)
        else:
            route = _dictionary_of(col, validity, compact_values, n_valid, physical)
    if route is not None:
        pool, codes = route
        # a sorted, fully referenced pool: the statistics are its edges
        t_stats = time.perf_counter()
        chunk.stats = _stats_struct(pool[0], pool[-1], physical, null_count)
        stats_s = time.perf_counter() - t_stats
        if physical == T_BYTE_ARRAY:
            lens, payload = kernels.byte_array_parts(pool)
            pool_bytes = kernels.encode_plain_byte_array(lens, payload)
        else:
            pool_bytes = kernels.encode_plain(pool, physical)
        _write_dictionary(sink, chunk, validity, cidx, n, pool_bytes, len(pool), codes, page_size, metrics)
    else:
        compact = compact_values()
        t_stats = time.perf_counter()
        lo, hi = _min_max(compact, physical)
        chunk.stats = _stats_struct(lo, hi, physical, null_count)
        stats_s = time.perf_counter() - t_stats
        enc = ENC_PLAIN
        if physical == T_BYTE_ARRAY:
            lens, payload = kernels.byte_array_parts(compact)
            offs = np.zeros(len(lens) + 1, dtype=np.int64)
            np.cumsum(lens, out=offs[1:])
            bpv = 4 + (float(lens.mean()) if len(lens) else 0.0)
        else:
            if physical != T_BOOLEAN:
                compact = np.ascontiguousarray(compact, dtype=PLAIN_DTYPES[physical])
                if physical in (T_INT32, T_INT64) and n_valid >= 64 and bool(np.all(np.diff(compact) >= 0)):
                    enc = ENC_DELTA_BINARY_PACKED  # sorted ints: the delta stream
            bpv = 0.125 if physical == T_BOOLEAN else _ITEMSIZE[physical]
        bounds = _page_bounds(n, bpv, page_size)
        for start in bounds:
            stop = min(start + bounds.step, n)
            vs, ve = int(cidx[start]), int(cidx[stop])
            if physical == T_BYTE_ARRAY:
                body = kernels.encode_plain_byte_array(lens[vs:ve], payload[offs[vs] : offs[ve]])
            elif enc == ENC_DELTA_BINARY_PACKED and ve > vs:
                body = kernels.encode_delta_binary_packed(compact[vs:ve], physical)
            else:
                body = kernels.encode_plain(compact[vs:ve], physical)
            sink.add_data_page(_levels(validity, start, stop), body, stop - start, ve - vs, enc)
        chunk.encodings = tuple(sorted({ENC_RLE, enc}))
    if metrics is not None:
        metrics.counter("pages_written").inc(chunk.num_pages)
        metrics.histogram("stats_ms").update(stats_s * 1000)
    return chunk
