"""The Parquet container on numpy alone: footer, column chunks, pages,
codecs and chunk statistics (port of paimon_tpu/decode/container.py).

Envelope: flat schemas; physical types BOOLEAN, INT32, INT64, FLOAT,
DOUBLE and BYTE_ARRAY (UTF8 or raw); REQUIRED or OPTIONAL leaves; data
pages v1 and v2; codecs UNCOMPRESSED and ZSTD (the port's own codec,
utils/compression.py). Any other codec raises NotImplementedError naming
file.compression; a malformed file or a feature outside the envelope
raises ParquetFormatError.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from ..format import FieldStats
from ..format.thrift import ThriftError, read_struct
from ..types import STRING_ROOTS, DataType, TypeRoot
from ..utils.compression import zstd_decompress

__all__ = [
    "ParquetFormatError",
    "ChunkInfo",
    "parse_footer",
    "iter_pages",
    "decompress_page",
    "chunk_field_stats",
    "physical_type",
]

MAGIC = b"PAR1"

# parquet.thrift enums
T_BOOLEAN, T_INT32, T_INT64, T_INT96, T_FLOAT, T_DOUBLE, T_BYTE_ARRAY, T_FLBA = range(8)
ENC_PLAIN, ENC_PLAIN_DICTIONARY, ENC_RLE, ENC_DELTA_BINARY_PACKED, ENC_RLE_DICTIONARY = 0, 2, 3, 5, 8
PAGE_DATA, PAGE_INDEX, PAGE_DICTIONARY, PAGE_DATA_V2 = 0, 1, 2, 3
REQUIRED, OPTIONAL, REPEATED = 0, 1, 2
CODEC_NONE, CODEC_ZSTD = 0, 6
CODEC_NAMES = {1: "snappy", 2: "gzip", 3: "lzo", 4: "brotli", 5: "lz4", 6: "zstd", 7: "lz4_raw"}

PLAIN_DTYPES = {T_INT32: np.dtype("<i4"), T_INT64: np.dtype("<i8"), T_FLOAT: np.dtype("<f4"), T_DOUBLE: np.dtype("<f8")}


class ParquetFormatError(ValueError):
    """Malformed file, or a feature outside the port's Parquet envelope."""


def codec_error(codec: int) -> NotImplementedError:
    name = CODEC_NAMES.get(codec, f"codec {codec}")
    return NotImplementedError(
        f"parquet {name} compression cannot be decoded by the torch port "
        f"(file.compression={name}); it reads file.compression=zstd or none"
    )


def physical_type(dtype: DataType) -> int:
    root = dtype.root
    if root == TypeRoot.BOOLEAN:
        return T_BOOLEAN
    if root in (TypeRoot.TINYINT, TypeRoot.SMALLINT, TypeRoot.INT, TypeRoot.DATE, TypeRoot.TIME):
        return T_INT32
    if root in (TypeRoot.BIGINT, TypeRoot.TIMESTAMP, TypeRoot.TIMESTAMP_LTZ, TypeRoot.DECIMAL):
        return T_INT64
    if root == TypeRoot.FLOAT:
        return T_FLOAT
    if root == TypeRoot.DOUBLE:
        return T_DOUBLE
    if root in STRING_ROOTS:
        return T_BYTE_ARRAY
    raise NotImplementedError(f"type {root} has no parquet mapping in the torch port")


def is_utf8(dtype: DataType) -> bool:
    return dtype.root in (TypeRoot.CHAR, TypeRoot.VARCHAR)


@dataclass(frozen=True)
class ChunkInfo:
    name: str
    physical: int
    codec: int
    num_values: int
    max_def: int
    start: int
    size: int
    has_dictionary: bool
    stats: dict | None = None  # the chunk's Statistics struct, as thrift fields


def parse_footer(data: bytes) -> list[tuple[int, dict[str, ChunkInfo]]]:
    """[(row count, {column name: ChunkInfo})] per row group."""
    if len(data) < 12 or data[:4] != MAGIC or data[-4:] != MAGIC:
        raise ParquetFormatError("not a parquet file (bad magic)")
    meta_len = struct.unpack_from("<I", data, len(data) - 8)[0]
    meta_start = len(data) - 8 - meta_len
    if meta_start < 4:
        raise ParquetFormatError("footer length exceeds file")
    try:
        fmd, _ = read_struct(data, meta_start)
    except ThriftError as e:
        raise ParquetFormatError(f"footer parse: {e}") from e
    elems = fmd.get(2) or []
    if not elems or elems[0].get(5, 0) != len(elems) - 1:
        raise ParquetFormatError("nested parquet schemas are not supported")
    max_def: dict[str, int] = {}
    for elem in elems[1:]:
        rep = elem.get(3, REQUIRED)
        if elem.get(5) or rep == REPEATED:
            raise ParquetFormatError("nested or repeated parquet fields are not supported")
        max_def[elem[4].decode("utf-8")] = 1 if rep == OPTIONAL else 0
    groups = []
    for rg in fmd.get(4) or []:
        cols: dict[str, ChunkInfo] = {}
        for cc in rg.get(1) or []:
            md = cc[3]
            name = md[3][0].decode("utf-8")
            data_off = md[9]
            dict_off = md.get(11)
            has_dict = dict_off is not None and 0 < dict_off < data_off
            start = dict_off if has_dict else data_off
            cols[name] = ChunkInfo(name, md[1], md.get(4, 0), md[5], max_def[name], start, md[7], has_dict, md.get(12))
        groups.append((rg[3], cols))
    return groups


def decompress_page(chunk: ChunkInfo, kind: int, hdr: dict, payload: memoryview) -> memoryview:
    """A page's payload as the encodings see it. zstd compresses a v1 data
    page or a dictionary page whole; a v2 data page keeps its level bytes
    raw and compresses the rest only when is_compressed (default true)."""
    if chunk.codec == CODEC_NONE:
        return payload
    size, levels = hdr[2], 0
    if kind == PAGE_DATA_V2:
        dh = hdr[8]
        if not dh.get(7, True):
            return payload
        levels = dh.get(5, 0) + dh.get(6, 0)
        if not 0 <= levels <= min(len(payload), size):
            raise ParquetFormatError(f"column {chunk.name}: v2 page levels of {levels} bytes")
    try:
        values = zstd_decompress(payload[levels:], size - levels)
    except ValueError as e:
        raise ParquetFormatError(f"column {chunk.name}: zstd page: {e}") from e
    if not levels:
        return values
    out = np.empty(size, dtype=np.uint8)
    out[:levels] = np.frombuffer(payload[:levels], dtype=np.uint8)
    out[levels:] = np.frombuffer(values, dtype=np.uint8)
    return memoryview(out)


def iter_pages(data: bytes, chunk: ChunkInfo):
    """(kind, header dict, raw payload) for each dictionary and data page
    of a chunk; the payload is decompressed by decompress_page only when
    the page is decoded, so a skipped page costs its header alone."""
    if chunk.codec not in (CODEC_NONE, CODEC_ZSTD):
        raise codec_error(chunk.codec)
    mv = memoryview(data)
    pos = chunk.start
    end = chunk.start + chunk.size
    seen = 0
    while pos < end and seen < chunk.num_values:
        try:
            hdr, pos = read_struct(data, pos)
        except ThriftError as e:
            raise ParquetFormatError(f"page header parse: {e}") from e
        comp = hdr[3]
        payload = mv[pos : pos + comp]
        pos += comp
        kind = hdr[1]
        if kind == PAGE_DATA:
            seen += hdr[5][1]
        elif kind == PAGE_DATA_V2:
            seen += hdr[8][1]
        elif kind == PAGE_INDEX:
            continue
        elif kind != PAGE_DICTIONARY:
            raise ParquetFormatError(f"page type {kind}")
        yield kind, hdr, payload


def _stat_value(raw: bytes | None, physical: int, dtype: DataType):
    """One min or max of a chunk's statistics, as the port's columns hold
    the value (an int, a float, a bool, a str or bytes)."""
    if raw is None:
        return None
    if physical == T_BYTE_ARRAY:
        return raw.decode("utf-8") if is_utf8(dtype) else bytes(raw)
    if physical == T_BOOLEAN:
        return bool(raw[0]) if raw else None
    np_dtype = PLAIN_DTYPES.get(physical)
    if np_dtype is None or len(raw) != np_dtype.itemsize:
        return None
    return np.frombuffer(raw, dtype=np_dtype)[0].item()


def chunk_field_stats(chunk: ChunkInfo, dtype: DataType, num_rows: int) -> FieldStats | None:
    """A chunk's min_value/max_value/null_count, or None when its writer
    recorded no min and max; an absent null count is unknown."""
    st = chunk.stats or {}
    lo, hi = _stat_value(st.get(6), chunk.physical, dtype), _stat_value(st.get(5), chunk.physical, dtype)
    if lo is None or hi is None:
        return None
    return FieldStats(lo, hi, st.get(3), num_rows)
