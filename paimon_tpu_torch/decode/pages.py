"""Page -> column assembly (port of paimon_tpu/decode/pages.py).

`decode_chunk` expands one column chunk into (values, validity); under a
per-row keep mask (decode/pushdown.py) a data page whose rows are all dead
is never decompressed nor decoded, and its rows keep the null fill until
the mask drops them. `chunk_codes` is the code-domain read of a fully
dictionary-encoded chunk: (dictionary, uint32 codes, validity) with no
value expanded, or None when a PLAIN page sits among the dictionary pages
(that chunk then expands as before). `chunk_code_pages` is the pushdown's
view: the dictionary and, per page, its index run.

Nulls fill with 0 in fixed-width columns and None in object columns.
Metrics (group decode): pages_decoded, pages_skipped, bytes_expanded.
"""

from __future__ import annotations

import numpy as np

from ..types import DataType
from . import kernels
from .container import (
    ENC_DELTA_BINARY_PACKED,
    ENC_PLAIN,
    ENC_PLAIN_DICTIONARY,
    ENC_RLE,
    ENC_RLE_DICTIONARY,
    PAGE_DATA,
    PAGE_DICTIONARY,
    T_BOOLEAN,
    T_BYTE_ARRAY,
    ChunkInfo,
    ParquetFormatError,
    decompress_page,
    is_utf8,
    iter_pages,
)

__all__ = ["decode_chunk", "chunk_codes", "chunk_code_pages", "decode_dictionary"]

_DICT_ENCODINGS = (ENC_RLE_DICTIONARY, ENC_PLAIN_DICTIONARY)


def decode_dictionary(chunk: ChunkInfo, hdr: dict, raw, dtype: DataType) -> np.ndarray:
    return _dictionary_and_sizes(chunk, hdr, raw, dtype)[0]


def _dictionary_and_sizes(chunk: ChunkInfo, hdr: dict, raw, dtype: DataType) -> tuple[np.ndarray, np.ndarray]:
    """A dictionary page's values and each entry's byte size (the weight a
    page's codes gather for the bytes_expanded metric)."""
    dh = hdr[7]
    if dh.get(2, ENC_PLAIN) not in (ENC_PLAIN, ENC_PLAIN_DICTIONARY):
        raise ParquetFormatError(f"dictionary page encoding {dh.get(2)}")
    if chunk.physical == T_BYTE_ARRAY:
        return kernels.decode_byte_array(raw, 0, dh[1], is_utf8(dtype))
    dictionary = kernels.decode_plain(raw, 0, chunk.physical, dh[1], False)
    return dictionary, np.full(len(dictionary), dictionary.dtype.itemsize, dtype=np.int64)


def _page_layout(chunk: ChunkInfo, kind: int, hdr: dict, raw) -> tuple[int, int, np.ndarray | None, int]:
    """(num rows, encoding, validity or None when all valid, offset of the
    values) of one decompressed data page."""
    if kind == PAGE_DATA:
        dh = hdr[5]
        n, enc = dh[1], dh[2]
        off = 0
        valid = None
        if chunk.max_def:
            ln = int.from_bytes(raw[0:4], "little")
            valid = kernels.decode_rle_hybrid(raw, 4, 4 + ln, 1, n) == 1
            off = 4 + ln
    else:
        dh = hdr[8]
        n, enc = dh[1], dh[4]
        if dh.get(6, 0):
            raise ParquetFormatError("repetition levels in a flat file")
        off = dh.get(5, 0)
        valid = kernels.decode_rle_hybrid(raw, 0, off, 1, n) == 1 if chunk.max_def else None
    if valid is not None and valid.all():
        valid = None
    return n, enc, valid, off


def _page_rows(kind: int, hdr: dict) -> tuple[int, int]:
    """(num rows, encoding) from a data page's header alone."""
    dh = hdr[5] if kind == PAGE_DATA else hdr[8]
    return dh[1], dh[2] if kind == PAGE_DATA else dh[4]


def _page_codes(raw, off: int, n_valid: int) -> np.ndarray:
    return kernels.decode_rle_hybrid(raw, off + 1, len(raw), raw[off], n_valid)


def decode_chunk(data: bytes, chunk: ChunkInfo, dtype: DataType, num_rows: int, keep=None, metrics=None):
    """One column chunk -> (values, validity or None) over num_rows rows;
    pages whose rows are all dead under `keep` are skipped."""
    np_dtype = dtype.numpy_dtype()
    values = np.empty(num_rows, dtype=object) if np_dtype == np.dtype(object) else np.zeros(num_rows, dtype=np_dtype)
    validity = np.ones(num_rows, dtype=np.bool_)
    utf8 = is_utf8(dtype)
    dict_page = None
    dictionary = entry_nbytes = None
    row = 0
    for kind, hdr, payload in iter_pages(data, chunk):
        if kind == PAGE_DICTIONARY:
            dict_page = (hdr, payload)  # decoded on the first page that needs it
            continue
        n, _ = _page_rows(kind, hdr)
        sl = slice(row, row + n)
        row += n
        if keep is not None and not keep[sl].any():
            validity[sl] = False  # dead rows, dropped by keep
            if metrics is not None:
                metrics.counter("pages_skipped").inc()
            continue
        raw = decompress_page(chunk, kind, hdr, payload)
        n, enc, page_valid, off = _page_layout(chunk, kind, hdr, raw)
        n_valid = n if page_valid is None else int(page_valid.sum())
        if n_valid:
            if enc in _DICT_ENCODINGS:
                if dictionary is None:
                    if dict_page is None:
                        raise ParquetFormatError("dictionary-encoded page without a dictionary")
                    dh, dp = dict_page
                    raw_dict = decompress_page(chunk, PAGE_DICTIONARY, dh, dp)
                    dictionary, entry_nbytes = _dictionary_and_sizes(chunk, dh, raw_dict, dtype)
                codes = _page_codes(raw, off, n_valid)
                compact = kernels.gather(dictionary, codes)
                nbytes = int(entry_nbytes[codes].sum())
            elif enc == ENC_PLAIN:
                compact = kernels.decode_plain(raw, off, chunk.physical, n_valid, utf8)
                # a byte-array page's payloads: its bytes less the lengths
                nbytes = len(raw) - off - 4 * n_valid if chunk.physical == T_BYTE_ARRAY else compact.nbytes
            elif enc == ENC_DELTA_BINARY_PACKED:
                compact = kernels.decode_delta_binary_packed(raw, off, n_valid, chunk.physical)
                nbytes = compact.nbytes
            elif enc == ENC_RLE and chunk.physical == T_BOOLEAN:
                ln = int.from_bytes(raw[off : off + 4], "little")
                compact = kernels.decode_rle_hybrid(raw, off + 4, off + 4 + ln, 1, n_valid).astype(np.bool_)
                nbytes = compact.nbytes
            else:
                raise ParquetFormatError(f"data page encoding {enc} is not supported by the torch port")
            if page_valid is None:
                values[sl] = compact
            else:
                values[sl][page_valid] = compact
            if metrics is not None:
                metrics.counter("pages_decoded").inc()
                metrics.counter("bytes_expanded").inc(nbytes)
        if page_valid is not None:
            validity[sl] = page_valid
    if row != num_rows:
        raise ParquetFormatError(f"column {chunk.name}: pages cover {row} rows, row group has {num_rows}")
    return values, (None if validity.all() else validity)


def chunk_code_pages(data: bytes, chunk: ChunkInfo, dtype: DataType):
    """(dictionary or None, [(row start, num rows, codes or None, validity)])
    of one chunk: only levels and index runs decode; a non-dictionary page
    has codes None."""
    dictionary = None
    pages = []
    row = 0
    for kind, hdr, payload in iter_pages(data, chunk):
        if kind == PAGE_DICTIONARY:
            dictionary = decode_dictionary(chunk, hdr, decompress_page(chunk, kind, hdr, payload), dtype)
            continue
        n, enc = _page_rows(kind, hdr)
        if enc in _DICT_ENCODINGS:
            raw = decompress_page(chunk, kind, hdr, payload)
            n, _, page_valid, off = _page_layout(chunk, kind, hdr, raw)
            n_valid = n if page_valid is None else int(page_valid.sum())
            codes = _page_codes(raw, off, n_valid) if n_valid else np.zeros(0, dtype=np.int64)
            pages.append((row, n, codes, page_valid))
        else:
            pages.append((row, n, None, None))
        row += n
    return dictionary, pages


def chunk_codes(data: bytes, chunk: ChunkInfo, dtype: DataType, num_rows: int, keep=None, metrics=None, reuse=None):
    """(dictionary, full-length uint32 codes, validity or None) of a fully
    dictionary-encoded chunk, or None. `reuse` is the (dictionary, pages)
    pair the pushdown already decoded for this chunk; without it pages
    dead under `keep` are skipped before decompression. Codes at null or
    dead rows are 0."""
    if not chunk.has_dictionary:
        return None
    codes_full = np.zeros(num_rows, dtype=np.uint32)
    validity = np.ones(num_rows, dtype=np.bool_)
    if reuse is not None:
        dictionary, pages = reuse
        if dictionary is None or any(codes is None for _, _, codes, _ in pages):
            return None
        for row_start, n, codes, page_valid in pages:
            sl = slice(row_start, row_start + n)
            if page_valid is None:
                codes_full[sl] = codes
            else:
                validity[sl] = page_valid
                codes_full[sl][page_valid] = codes
        return dictionary, codes_full, (None if validity.all() else validity)
    dict_page = None
    row = 0
    for kind, hdr, payload in iter_pages(data, chunk):
        if kind == PAGE_DICTIONARY:
            dict_page = (hdr, payload)
            continue
        n, enc = _page_rows(kind, hdr)
        if enc not in _DICT_ENCODINGS:
            return None  # a PLAIN page among the dictionary pages
        sl = slice(row, row + n)
        row += n
        if keep is not None and not keep[sl].any():
            validity[sl] = False
            if metrics is not None:
                metrics.counter("pages_skipped").inc()
            continue
        raw = decompress_page(chunk, kind, hdr, payload)
        n, _, page_valid, off = _page_layout(chunk, kind, hdr, raw)
        n_valid = n if page_valid is None else int(page_valid.sum())
        if page_valid is not None:
            validity[sl] = page_valid
        if n_valid:
            codes = _page_codes(raw, off, n_valid)
            if page_valid is None:
                codes_full[sl] = codes
            else:
                codes_full[sl][page_valid] = codes
        if metrics is not None:
            # decoded, but never expanded: bytes_expanded stays untouched
            metrics.counter("pages_decoded").inc()
    if row != num_rows:
        raise ParquetFormatError(f"column {chunk.name}: pages cover {row} rows, row group has {num_rows}")
    if dict_page is None:
        return None
    dh, dp = dict_page
    dictionary = decode_dictionary(chunk, dh, decompress_page(chunk, PAGE_DICTIONARY, dh, dp), dtype)
    return dictionary, codes_full, (None if validity.all() else validity)
