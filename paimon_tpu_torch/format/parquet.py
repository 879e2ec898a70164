"""Parquet reader and writer on numpy alone (port of
paimon_tpu/format/parquet.py with the native decoder of
paimon_tpu/decode/{container,kernels,pages}.py and the native encoder of
paimon_tpu/encode/{kernels,pages,writer}.py, numpy engine only).

Envelope, both directions: flat schemas; physical types BOOLEAN, INT32,
INT64, FLOAT, DOUBLE and BYTE_ARRAY (UTF8 or raw); REQUIRED or OPTIONAL
leaves; PLAIN and dictionary (PLAIN dictionary page + RLE/bit-packed
codes) encodings, and on read also DELTA_BINARY_PACKED integers (the JAX
package's native encoder writes sorted integer columns so); data pages
v1 (v2 is read too); codecs UNCOMPRESSED and ZSTD (the port's own codec,
utils/compression.py); chunk min/max/null-count statistics, written and,
under a predicate, read to skip row groups. It reads the
files pyarrow writes with those codecs, and pyarrow reads the files it
writes. Any other codec, on read or as file.compression on write, raises
NotImplementedError naming file.compression.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from ..data.batch import Column, ColumnBatch
from ..types import STRING_ROOTS, DataType, RowType, TypeRoot
from ..utils.compression import zstd_compress, zstd_decompress
from . import FieldStats
from .thrift import ThriftError, append_uvarint, build_struct, read_struct, read_varint, zigzag

__all__ = ["read_parquet", "write_parquet", "ParquetFormatError"]

MAGIC = b"PAR1"

# parquet.thrift enums
T_BOOLEAN, T_INT32, T_INT64, T_INT96, T_FLOAT, T_DOUBLE, T_BYTE_ARRAY, T_FLBA = range(8)
ENC_PLAIN, ENC_PLAIN_DICTIONARY, ENC_RLE, ENC_DELTA_BINARY_PACKED, ENC_RLE_DICTIONARY = 0, 2, 3, 5, 8
PAGE_DATA, PAGE_INDEX, PAGE_DICTIONARY, PAGE_DATA_V2 = 0, 1, 2, 3
_REQUIRED, _OPTIONAL, _REPEATED = 0, 1, 2
CODEC_NONE, CODEC_ZSTD = 0, 6
_CODEC_NAMES = {1: "snappy", 2: "gzip", 3: "lzo", 4: "brotli", 5: "lz4", 6: "zstd", 7: "lz4_raw"}
# file.compression values the writer takes -> parquet codec
WRITE_CODECS = {"none": CODEC_NONE, "uncompressed": CODEC_NONE, "zstd": CODEC_ZSTD}

# thrift compact type nibbles used by the writer
_BOOL, _I32, _I64, _BINARY, _LIST, _STRUCT = 1, 5, 6, 8, 9, 12
_CONVERTED_UTF8, _CONVERTED_INT8, _CONVERTED_INT16 = 0, 15, 16
_CREATED_BY = b"paimon_tpu_torch version 1.0.0"

_PAGE_BYTES = 1 << 20
_ROW_GROUP_ROWS = 1 << 20
_DICT_RATIO_NUM, _DICT_RATIO_DEN = 2, 3
_STAT_MAX_LEN = 64

_PLAIN_DTYPES = {T_INT32: np.dtype("<i4"), T_INT64: np.dtype("<i8"), T_FLOAT: np.dtype("<f4"), T_DOUBLE: np.dtype("<f8")}


class ParquetFormatError(ValueError):
    """Malformed file, or a feature outside the port's Parquet envelope."""


def _codec_error(codec: int) -> NotImplementedError:
    name = _CODEC_NAMES.get(codec, f"codec {codec}")
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


def _is_utf8(dtype: DataType) -> bool:
    return dtype.root in (TypeRoot.CHAR, TypeRoot.VARCHAR)


# ---------------------------------------------------------------------------
# decode kernels
# ---------------------------------------------------------------------------


def unpack_bits(data: np.ndarray, bit_width: int, count: int) -> np.ndarray:
    """`count` LSB-first packed unsigned values of `bit_width` bits -> int64."""
    if count == 0:
        return np.empty(0, dtype=np.int64)
    if bit_width == 0:
        return np.zeros(count, dtype=np.int64)
    if bit_width > 32:
        raise ParquetFormatError(f"bit width {bit_width}")
    bits = np.unpackbits(np.ascontiguousarray(data, dtype=np.uint8), bitorder="little")
    need = count * bit_width
    if len(bits) < need:
        raise ParquetFormatError(f"bit stream too short: {len(bits)} < {need}")
    weights = np.left_shift(np.int64(1), np.arange(bit_width, dtype=np.int64))
    return bits[:need].reshape(count, bit_width).astype(np.int64) @ weights


def decode_rle_hybrid(buf, pos: int, end: int, bit_width: int, count: int) -> np.ndarray:
    """Parquet's RLE/bit-packed hybrid run stream -> `count` int64 values."""
    out = np.empty(count, dtype=np.int64)
    filled = 0
    byte_w = (bit_width + 7) >> 3
    while filled < count:
        if pos >= end:
            raise ParquetFormatError(f"RLE stream exhausted at {filled}/{count} values")
        header, pos = read_varint(buf, pos)
        if header & 1:  # bit-packed: (header >> 1) groups of 8 values
            groups = header >> 1
            nbytes = groups * bit_width
            vals = unpack_bits(np.frombuffer(buf, dtype=np.uint8, count=nbytes, offset=pos), bit_width, groups * 8)
            take = min(groups * 8, count - filled)
            out[filled : filled + take] = vals[:take]
            pos += nbytes
            filled += take
        else:  # RLE: one value repeated (header >> 1) times
            run = header >> 1
            v = int.from_bytes(bytes(buf[pos : pos + byte_w]), "little") if byte_w else 0
            pos += byte_w
            take = min(run, count - filled)
            out[filled : filled + take] = v
            filled += take
    return out


def decode_plain(buf, pos: int, physical: int, count: int, utf8: bool) -> np.ndarray:
    if physical in _PLAIN_DTYPES:
        return np.frombuffer(buf, dtype=_PLAIN_DTYPES[physical], count=count, offset=pos)
    if physical == T_BOOLEAN:
        raw = np.frombuffer(buf, dtype=np.uint8, count=(count + 7) >> 3, offset=pos)
        return np.unpackbits(raw, bitorder="little")[:count].astype(np.bool_)
    if physical == T_BYTE_ARRAY:
        # (u32 length, payload) pairs: inherently sequential
        out = np.empty(count, dtype=object)
        mv = memoryview(buf)
        unpack = struct.Struct("<I").unpack_from
        for i in range(count):
            (n,) = unpack(mv, pos)
            pos += 4
            raw = bytes(mv[pos : pos + n])
            out[i] = raw.decode("utf-8") if utf8 else raw
            pos += n
        return out
    raise ParquetFormatError(f"PLAIN physical type {physical}")


def decode_delta_binary_packed(buf, pos: int, count: int, physical: int) -> np.ndarray:
    """DELTA_BINARY_PACKED int32/int64: bit-packed miniblocks of deltas,
    then first value + wrap-around uint64 prefix sum."""
    if physical not in (T_INT32, T_INT64):
        raise ParquetFormatError("DELTA_BINARY_PACKED on a non-integer column")
    block_size, pos = read_varint(buf, pos)
    n_mini, pos = read_varint(buf, pos)
    total, pos = read_varint(buf, pos)
    v, pos = read_varint(buf, pos)
    first = zigzag(v)
    n = min(count, total)
    if n == 0:
        return np.empty(0, dtype=np.int32 if physical == T_INT32 else np.int64)
    if n_mini == 0 or block_size % n_mini:
        raise ParquetFormatError("malformed DELTA_BINARY_PACKED header")
    per_mini = block_size // n_mini
    deltas = np.empty(n - 1, dtype=np.uint64)
    got = 0
    while got < n - 1:
        v, pos = read_varint(buf, pos)
        min_delta = np.uint64(zigzag(v) & 0xFFFFFFFFFFFFFFFF)
        widths = bytes(buf[pos : pos + n_mini])
        pos += n_mini
        for w in widths:
            if got >= n - 1:
                break  # trailing miniblocks of the last block carry no data
            nbytes = (w * per_mini) >> 3
            vals = _unpack_bits_u64(np.frombuffer(buf, dtype=np.uint8, count=nbytes, offset=pos), w, per_mini)
            pos += nbytes
            take = min(per_mini, n - 1 - got)
            deltas[got : got + take] = vals[:take] + min_delta
            got += take
    out = np.empty(n, dtype=np.uint64)
    out[0] = np.uint64(first & 0xFFFFFFFFFFFFFFFF)
    out[1:] = out[0] + np.cumsum(deltas, dtype=np.uint64)
    if physical == T_INT32:
        return (out & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    return out.view(np.int64)


def _unpack_bits_u64(data: np.ndarray, bit_width: int, count: int) -> np.ndarray:
    """unpack_bits for delta miniblocks, whose widths reach 64 bits."""
    if bit_width == 0:
        return np.zeros(count, dtype=np.uint64)
    bits = np.unpackbits(np.ascontiguousarray(data, dtype=np.uint8), bitorder="little")[: count * bit_width]
    weights = np.left_shift(np.uint64(1), np.arange(bit_width, dtype=np.uint64))
    return (bits.reshape(count, bit_width).astype(np.uint64) * weights).sum(axis=1, dtype=np.uint64)


# ---------------------------------------------------------------------------
# container
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _Chunk:
    name: str
    physical: int
    codec: int
    num_values: int
    max_def: int
    start: int
    size: int
    stats: dict | None = None  # the chunk's Statistics struct, as thrift fields


def _parse_footer(data: bytes):
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
        rep = elem.get(3, _REQUIRED)
        if elem.get(5) or rep == _REPEATED:
            raise ParquetFormatError("nested or repeated parquet fields are not supported")
        max_def[elem[4].decode("utf-8")] = 1 if rep == _OPTIONAL else 0
    groups = []
    for rg in fmd.get(4) or []:
        cols: dict[str, _Chunk] = {}
        for cc in rg.get(1) or []:
            md = cc[3]
            name = md[3][0].decode("utf-8")
            data_off = md[9]
            dict_off = md.get(11)
            start = dict_off if dict_off is not None and 0 < dict_off < data_off else data_off
            cols[name] = _Chunk(name, md[1], md.get(4, 0), md[5], max_def[name], start, md[7], md.get(12))
        groups.append((rg[3], cols))
    return groups


def _decompress_page(chunk: _Chunk, kind: int, hdr: dict, payload: memoryview) -> memoryview:
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


def _iter_pages(data: bytes, chunk: _Chunk):
    """(kind, header dict, decompressed payload) for each page of a chunk."""
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
        yield kind, hdr, _decompress_page(chunk, kind, hdr, payload)


def _decode_chunk(data: bytes, chunk: _Chunk, dtype: DataType, num_rows: int):
    """One column chunk -> (values, validity or None) over num_rows rows;
    nulls fill with 0 / None."""
    if chunk.codec not in (CODEC_NONE, CODEC_ZSTD):
        raise _codec_error(chunk.codec)
    np_dtype = dtype.numpy_dtype()
    values = np.empty(num_rows, dtype=object) if np_dtype == np.dtype(object) else np.zeros(num_rows, dtype=np_dtype)
    validity = np.ones(num_rows, dtype=np.bool_)
    utf8 = _is_utf8(dtype)
    dictionary = None
    row = 0
    for kind, hdr, raw in _iter_pages(data, chunk):
        if kind == PAGE_DICTIONARY:
            dh = hdr[7]
            if dh.get(2, ENC_PLAIN) not in (ENC_PLAIN, ENC_PLAIN_DICTIONARY):
                raise ParquetFormatError(f"dictionary page encoding {dh.get(2)}")
            dictionary = decode_plain(raw, 0, chunk.physical, dh[1], utf8)
            continue
        if kind == PAGE_DATA:
            dh = hdr[5]
            n, enc = dh[1], dh[2]
            off = 0
            page_valid = None
            if chunk.max_def:
                ln = int.from_bytes(raw[0:4], "little")
                page_valid = decode_rle_hybrid(raw, 4, 4 + ln, 1, n) == 1
                off = 4 + ln
        else:
            dh = hdr[8]
            n, enc = dh[1], dh[4]
            if dh.get(6, 0):
                raise ParquetFormatError("repetition levels in a flat file")
            ln = dh.get(5, 0)
            page_valid = decode_rle_hybrid(raw, 0, ln, 1, n) == 1 if chunk.max_def else None
            off = ln
        if page_valid is not None and page_valid.all():
            page_valid = None
        n_valid = n if page_valid is None else int(page_valid.sum())
        if n_valid:
            if enc in (ENC_RLE_DICTIONARY, ENC_PLAIN_DICTIONARY):
                if dictionary is None:
                    raise ParquetFormatError("dictionary-encoded page without a dictionary")
                codes = decode_rle_hybrid(raw, off + 1, len(raw), raw[off], n_valid)
                compact = dictionary.take(codes)
            elif enc == ENC_PLAIN:
                compact = decode_plain(raw, off, chunk.physical, n_valid, utf8)
            elif enc == ENC_DELTA_BINARY_PACKED:
                compact = decode_delta_binary_packed(raw, off, n_valid, chunk.physical)
            elif enc == ENC_RLE and chunk.physical == T_BOOLEAN:
                ln2 = int.from_bytes(raw[off : off + 4], "little")
                compact = decode_rle_hybrid(raw, off + 4, off + 4 + ln2, 1, n_valid).astype(np.bool_)
            else:
                raise ParquetFormatError(f"data page encoding {enc} is not supported by the torch port")
            sl = slice(row, row + n)
            if page_valid is None:
                values[sl] = compact
            else:
                values[row : row + n][page_valid] = compact
        if page_valid is not None:
            validity[row : row + n] = page_valid
        row += n
    if row != num_rows:
        raise ParquetFormatError(f"column {chunk.name}: pages cover {row} rows, row group has {num_rows}")
    return values, (None if validity.all() else validity)


def _stat_value(raw: bytes | None, physical: int, dtype: DataType):
    """One min or max of a chunk's statistics, as the port's columns hold
    the value (an int, a float, a bool, a str or bytes)."""
    if raw is None:
        return None
    if physical == T_BYTE_ARRAY:
        return raw.decode("utf-8") if _is_utf8(dtype) else bytes(raw)
    if physical == T_BOOLEAN:
        return bool(raw[0]) if raw else None
    np_dtype = _PLAIN_DTYPES.get(physical)
    if np_dtype is None or len(raw) != np_dtype.itemsize:
        return None
    return np.frombuffer(raw, dtype=np_dtype)[0].item()


def _chunk_field_stats(chunk: _Chunk, dtype: DataType, num_rows: int) -> FieldStats | None:
    """A chunk's min_value/max_value/null_count, or None when its writer
    recorded no min and max; an absent null count is unknown."""
    st = chunk.stats or {}
    lo, hi = _stat_value(st.get(6), chunk.physical, dtype), _stat_value(st.get(5), chunk.physical, dtype)
    if lo is None or hi is None:
        return None
    return FieldStats(lo, hi, st.get(3), num_rows)


def _row_group_matches(predicate, cols: dict, schema: RowType, num_rows: int) -> bool:
    stats = {}
    for name in predicate.referenced_fields():
        chunk = cols.get(name)
        if chunk is not None and name in schema:
            st = _chunk_field_stats(chunk, schema.field(name).type, num_rows)
            if st is not None:
                stats[name] = st
    return predicate.test_stats(stats)


def read_parquet(data: bytes, schema: RowType, projection, predicate=None) -> list[ColumnBatch]:
    """Decode the projected columns of one file: one ColumnBatch per row
    group, rows in file order. Under a predicate, row groups whose chunk
    statistics cannot match are skipped; which ones depends on the
    predicate alone, so two reads of one file under one predicate return
    the same rows whatever they project."""
    read_schema = schema.project(projection)
    out = []
    for num_rows, cols in _parse_footer(data):
        if num_rows == 0 or (predicate is not None and not _row_group_matches(predicate, cols, schema, num_rows)):
            continue
        columns = {}
        for f in read_schema.fields:
            chunk = cols.get(f.name)
            if chunk is None:
                raise ParquetFormatError(f"column {f.name!r} not in file")
            values, validity = _decode_chunk(data, chunk, f.type, num_rows)
            columns[f.name] = Column(values, validity)
        out.append(ColumnBatch(read_schema, columns))
    return out


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


def encode_rle_hybrid(values: np.ndarray, bit_width: int) -> bytes:
    """Bit-packed runs (groups of 8 values, LSB first) of the whole vector."""
    n = len(values)
    if n == 0:
        return b""
    if bit_width == 0:
        out = bytearray()
        append_uvarint(out, n << 1)
        return bytes(out)
    groups = (n + 7) // 8
    padded = np.zeros(groups * 8, dtype=np.int64)
    padded[:n] = values
    bits = ((padded[:, None] >> np.arange(bit_width, dtype=np.int64)) & 1).astype(np.uint8)
    out = bytearray()
    append_uvarint(out, (groups << 1) | 1)
    out += np.packbits(bits.reshape(-1), bitorder="little").tobytes()
    return bytes(out)


def _levels(validity: np.ndarray | None, start: int, stop: int) -> bytes:
    if validity is None:  # all valid: one RLE run of level 1
        out = bytearray()
        append_uvarint(out, (stop - start) << 1)
        out += b"\x01"
        return bytes(out)
    return encode_rle_hybrid(validity[start:stop].astype(np.int64), 1)


def _byte_array_plain(values) -> bytes:
    """PLAIN BYTE_ARRAY stream: u32 little-endian length then payload."""
    encoded = [v.encode("utf-8") if isinstance(v, str) else bytes(v) for v in values]
    n = len(encoded)
    if n == 0:
        return b""
    lens = np.fromiter((len(b) for b in encoded), dtype=np.int64, count=n)
    starts = np.zeros(n, dtype=np.int64)
    np.cumsum(lens[:-1] + 4, out=starts[1:])
    total = int(starts[-1] + 4 + lens[-1])
    buf = np.zeros(total, dtype=np.uint8)
    is_len = np.zeros(total, dtype=np.bool_)
    len_pos = (starts[:, None] + np.arange(4)).reshape(-1)
    buf[len_pos] = lens.astype("<u4").view(np.uint8)
    is_len[len_pos] = True
    buf[~is_len] = np.frombuffer(b"".join(encoded), dtype=np.uint8)
    return buf.tobytes()


def _plain(compact: np.ndarray, physical: int) -> bytes:
    if physical == T_BOOLEAN:
        return np.packbits(compact.astype(np.uint8), bitorder="little").tobytes()
    if physical == T_BYTE_ARRAY:
        return _byte_array_plain(compact)
    return np.ascontiguousarray(compact, dtype=_PLAIN_DTYPES[physical]).tobytes()


def _stat_bytes(v, physical: int) -> bytes | None:
    if physical == T_BOOLEAN:
        return b"\x01" if bool(v) else b"\x00"
    if physical == T_BYTE_ARRAY:
        raw = v.encode("utf-8") if isinstance(v, str) else bytes(v)
        return raw if len(raw) < _STAT_MAX_LEN else None
    return np.asarray([v], dtype=_PLAIN_DTYPES[physical]).tobytes()


def _chunk_stats(compact: np.ndarray, physical: int, null_count: int) -> bytes:
    lo = hi = None
    if len(compact):
        if physical in (T_FLOAT, T_DOUBLE):
            with np.errstate(invalid="ignore"):
                a, b = np.nanmin(compact), np.nanmax(compact)
            if not (np.isnan(a) or np.isnan(b)):
                lo, hi = _stat_bytes(a, physical), _stat_bytes(b, physical)
        else:
            lo, hi = _stat_bytes(min(compact) if compact.dtype == object else compact.min(), physical), _stat_bytes(
                max(compact) if compact.dtype == object else compact.max(), physical
            )
    return build_struct([(3, _I64, null_count), (5, _BINARY, hi), (6, _BINARY, lo)])


def _page(kind: int, raw: bytes, page_header: tuple, codec: int) -> tuple[bytes, int]:
    """One page (thrift header + payload compressed by codec) -> (its bytes,
    its size with the payload uncompressed)."""
    payload = zstd_compress(raw) if codec == CODEC_ZSTD else raw
    header = build_struct([(1, _I32, kind), (2, _I32, len(raw)), (3, _I32, len(payload)), page_header])
    return header + payload, len(header) + len(raw)


def _encode_chunk(col: Column, dtype: DataType, physical: int, codec: int):
    """-> (pages bytes, dict page length, encodings, stats struct, size of
    the pages uncompressed)."""
    n = len(col)
    validity = col.validity
    compact = col.values if validity is None else col.values[validity]
    n_valid = len(compact)
    cidx = None
    if validity is not None:
        cidx = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(validity, out=cidx[1:])
    stats = _chunk_stats(compact, physical, n - n_valid)
    pages = bytearray()
    dict_len = uncompressed = 0
    codes = None
    if physical == T_BYTE_ARRAY and n_valid:
        pool, inv = np.unique(compact, return_inverse=True)
        if len(pool) * _DICT_RATIO_DEN <= n_valid * _DICT_RATIO_NUM:
            dict_header = build_struct([(1, _I32, len(pool)), (2, _I32, ENC_PLAIN), (3, _BOOL, True)])
            page, uncompressed = _page(PAGE_DICTIONARY, _byte_array_plain(pool), (7, _STRUCT, dict_header), codec)
            pages += page
            dict_len = len(page)
            codes = inv.reshape(-1).astype(np.int64)
            width = max(int(len(pool) - 1).bit_length(), 1)
    if codes is not None:
        bpv, enc = width / 8 + 0.125, ENC_RLE_DICTIONARY
        encodings = (ENC_PLAIN, ENC_RLE, ENC_RLE_DICTIONARY)
    else:
        sample = compact[:1024]
        if physical == T_BYTE_ARRAY:
            bpv = 4 + (sum(len(v) for v in sample) / max(len(sample), 1))
        elif physical == T_BOOLEAN:
            bpv = 0.125
        else:
            bpv = _PLAIN_DTYPES[physical].itemsize
        enc = ENC_PLAIN
        encodings = (ENC_PLAIN, ENC_RLE)
    rows_per_page = max(1, int(_PAGE_BYTES / max(bpv, 1e-9)))
    for start in range(0, max(n, 1), rows_per_page):
        stop = min(start + rows_per_page, n)
        vs, ve = (start, stop) if cidx is None else (int(cidx[start]), int(cidx[stop]))
        if codes is not None:
            body = bytes([width]) + encode_rle_hybrid(codes[vs:ve], width)
        else:
            body = _plain(compact[vs:ve], physical)
        levels = _levels(validity, start, stop)
        data_header = build_struct([(1, _I32, stop - start), (2, _I32, enc), (3, _I32, ENC_RLE), (4, _I32, ENC_RLE)])
        page, size = _page(PAGE_DATA, struct.pack("<I", len(levels)) + levels + body, (5, _STRUCT, data_header), codec)
        pages += page
        uncompressed += size
    return bytes(pages), dict_len, encodings, stats, uncompressed


def _converted_type(root: TypeRoot) -> int | None:
    if root in (TypeRoot.CHAR, TypeRoot.VARCHAR):
        return _CONVERTED_UTF8
    if root == TypeRoot.TINYINT:
        return _CONVERTED_INT8
    if root == TypeRoot.SMALLINT:
        return _CONVERTED_INT16
    return None


def write_parquet(batch: ColumnBatch, compression: str = "none") -> bytes:
    """One ColumnBatch -> complete parquet file bytes, every page compressed
    by `compression` (a key of WRITE_CODECS). Every leaf is OPTIONAL, as the
    JAX package's writers make them."""
    codec = WRITE_CODECS.get(str(compression).lower())
    if codec is None:
        raise NotImplementedError(
            f"file.compression={compression} cannot be written by the torch port; "
            f"it writes {', '.join(WRITE_CODECS)}"
        )
    physicals = {f.name: physical_type(f.type) for f in batch.schema.fields}
    schema_elems = [build_struct([(4, _BINARY, b"schema"), (5, _I32, len(batch.schema.fields))])]
    for f in batch.schema.fields:
        schema_elems.append(
            build_struct(
                [
                    (1, _I32, physicals[f.name]),
                    (3, _I32, _OPTIONAL),
                    (4, _BINARY, f.name),
                    (6, _I32, _converted_type(f.type.root)),
                ]
            )
        )
    body = bytearray(MAGIC)
    row_groups = []
    n = batch.num_rows
    for rg_start in range(0, n, _ROW_GROUP_ROWS):
        rg = batch if n <= _ROW_GROUP_ROWS else batch.slice(rg_start, min(rg_start + _ROW_GROUP_ROWS, n))
        chunks = []
        total = 0
        for f in rg.schema.fields:
            pages, dict_len, encodings, stats, uncompressed = _encode_chunk(
                rg.column(f.name), f.type, physicals[f.name], codec
            )
            start = len(body)
            body += pages
            meta = build_struct(
                [
                    (1, _I32, physicals[f.name]),
                    (2, _LIST, (_I32, list(encodings))),
                    (3, _LIST, (_BINARY, [f.name])),
                    (4, _I32, codec),
                    (5, _I64, rg.num_rows),
                    (6, _I64, uncompressed),
                    (7, _I64, len(pages)),
                    (9, _I64, start + dict_len),
                    (11, _I64, start if dict_len else None),
                    (12, _STRUCT, stats),
                ]
            )
            chunks.append(build_struct([(2, _I64, start), (3, _STRUCT, meta)]))
            total += uncompressed
        row_groups.append(build_struct([(1, _LIST, (_STRUCT, chunks)), (2, _I64, total), (3, _I64, rg.num_rows)]))
    type_order = build_struct([(1, _STRUCT, build_struct([]))])
    footer = build_struct(
        [
            (1, _I32, 1),
            (2, _LIST, (_STRUCT, schema_elems)),
            (3, _I64, n),
            (4, _LIST, (_STRUCT, row_groups)),
            (6, _BINARY, _CREATED_BY),
            (7, _LIST, (_STRUCT, [type_order] * len(batch.schema.fields))),
        ]
    )
    body += footer
    body += struct.pack("<I", len(footer))
    body += MAGIC
    return bytes(body)
