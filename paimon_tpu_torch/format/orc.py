"""ORC data files, read and written by the port's own codec (port of
paimon_tpu/format/orc.py, which goes through pyarrow.orc).

A file is the magic "ORC", stripes, then the tail (format/orc_meta.py).
Each stripe holds its index streams, its data streams and a stripe footer
that lists every stream (kind, column, length) in file order and each
column's encoding. The reader:

- parses the tail once, and skips each stripe whose statistics
  `Predicate.test_stats` rules out (counted in scan.orc_stripes_skipped,
  the JAX package's counter);
- locates the projected columns' streams from the stripe footer, skipping
  the ROW_INDEX area and every other column, and decompresses only those;
- decodes PRESENT, DATA, LENGTH, DICTIONARY_DATA and SECONDARY through the
  C run-length codes of native/orcdec.c: integer RLE v1 and v2 (encodings
  DIRECT, DIRECT_V2, DICTIONARY and DICTIONARY_V2), byte and boolean RLE,
  and DECIMAL's varints;
- maps columns by name from the footer's root struct. Types: BOOLEAN,
  BYTE, SHORT, INT, LONG, FLOAT, DOUBLE, STRING, VARCHAR, CHAR, BINARY,
  DECIMAL (precision 18 at most, unscaled at the file type's scale),
  DATE (days) and TIMESTAMP (micros; seconds count from 2015-01-01 in the
  writer's timezone, which must be GMT or UTC, nanos carry a trailing-zero
  count in their low 3 bits);
- reads LIST, MAP and STRUCT columns (ARRAY, MAP and ROW fields) as
  PRESENT, then a LIST's or MAP's LENGTH, then the children at the counts
  those give: a child holds entries only where its parent is present, a
  LIST's element and a MAP's key and value one per entry of the present
  lists and maps, a STRUCT's fields one per present struct. Only these
  counts and index arrays are built per column; the Python values are
  built once per element, bottom up, as decode/nested.py builds them from
  Parquet: an ARRAY is a list, a MAP a dict in the file's entry order, a
  ROW a dict by field name in the type's field order (matched by name
  against the file's STRUCT: a field the file lacks reads as None, one
  the type lacks is not read). UNION raises NotImplementedError.

The writer writes what pyarrow writes for the JAX package's
`ColumnBatch.to_arrow` of the same batch, so that package reads the file
back into the same batch: the ORC kind follows the column's numpy dtype
(bool BOOLEAN, int8 BYTE, int16 SHORT, int32 INT, int64 LONG, float32
FLOAT, float64 DOUBLE; strings STRING, bytes BINARY), inside nested
columns too (a DATE element is an INT), an ARRAY is a LIST, a MAP a MAP
and a ROW a STRUCT with its field names, column ids in pre-order over the
type tree; integers, string lengths and list and map lengths as RLE v2
(DIRECT_V2; a STRUCT is DIRECT), a PRESENT stream only for a column with
nulls, no row index (rowIndexStride 0), the writer timezone GMT, and the
stripe and file statistics the JAX package's `read_tail` prunes by (a
LIST, MAP or STRUCT column counts its present values and nulls only). One
choice is the reference's (Java) writer's, not pyarrow's: a STRING column
whose distinct values are at most 80% of its present ones
(orc.dictionary.key.threshold's default) is written DICTIONARY_V2, a
sorted dictionary and RLE v2 codes, so a read gathers from the
dictionary instead of making a string per row. A code-backed string
column gives its pool as the dictionary (pyarrow refuses the
DictionaryArray the JAX package hands it). Stripes hold orc.stripe.size
bytes of the batch (file.block-size when unset, 64 MiB by default), at
least 1024 rows. Compression: file.compression zstd, zlib, snappy, lz4 or
uncompressed in any case, in 64 KiB chunks; any other name raises
ValueError, as pyarrow's writer does.
"""

from __future__ import annotations

import ctypes
import itertools
import operator
import time
import zlib
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from ..data.batch import Column, ColumnBatch
from ..data.keys import _pool_and_ranks
from ..decode.nested import _objects, _row_maker, _runs
from ..encode.kernels import byte_array_parts
from ..metrics import registry
from ..native import orc_library
from ..ops.dicts import cache_usable, prune_pool
from ..types import NESTED_ROOTS, DataType, RowType, TypeRoot
from ..utils.compression import lz4_compress, snappy_compress, zstd_compress
from .avro import strings_from_offsets
from .orc_meta import OrcTail, decompress_stream, fields_of, message, read_tail, zigzag_encode

__all__ = ["ORC_MAGIC", "read_orc", "write_orc", "decompress_column_streams"]

ORC_MAGIC = b"ORC"

# orc_proto.Type.Kind
K_BOOLEAN, K_BYTE, K_SHORT, K_INT, K_LONG, K_FLOAT, K_DOUBLE, K_STRING, K_BINARY, K_TIMESTAMP = range(10)
K_LIST, K_MAP, K_STRUCT, K_UNION, K_DECIMAL, K_DATE, K_VARCHAR, K_CHAR, K_TIMESTAMP_INSTANT = range(10, 19)
_INT_KINDS = (K_SHORT, K_INT, K_LONG, K_DATE)
_COMPOUND_KINDS = (K_LIST, K_MAP, K_STRUCT, K_UNION)
_NESTED_KINDS = {TypeRoot.ARRAY: K_LIST, TypeRoot.MAP: K_MAP, TypeRoot.ROW: K_STRUCT}
_STRING_KINDS = (K_STRING, K_VARCHAR, K_CHAR, K_BINARY)
# orc_proto.Stream.Kind
S_PRESENT, S_DATA, S_LENGTH, S_DICTIONARY_DATA, S_DICTIONARY_COUNT, S_SECONDARY, S_ROW_INDEX = range(7)
# orc_proto.ColumnEncoding.Kind
E_DIRECT, E_DICTIONARY, E_DIRECT_V2, E_DICTIONARY_V2 = range(4)
_COMPRESSION_KINDS = {"uncompressed": 0, "zlib": 1, "snappy": 2, "lz4": 4, "zstd": 5}
_BLOCK_SIZE = 1 << 16  # compression chunk bytes, pyarrow's default
_DEFAULT_STRIPE_SIZE = 64 << 20
_MIN_STRIPE_ROWS = 1024
_DICT_KEY_THRESHOLD = 0.8
_ORC_EPOCH_SECONDS = 1420070400  # 2015-01-01 00:00:00 GMT
_UTC_ZONES = ("", "GMT", "UTC", "Etc/GMT", "Etc/UTC", "Z")
_WRITER_VERSION = 6  # ORC-135: statistics of every kind are trustworthy
_SOFTWARE = "paimon_tpu_torch"

_NUMPY_KINDS = {np.dtype(np.bool_): K_BOOLEAN, np.dtype(np.int8): K_BYTE, np.dtype(np.int16): K_SHORT,
                np.dtype(np.int32): K_INT, np.dtype(np.int64): K_LONG, np.dtype(np.float32): K_FLOAT,
                np.dtype(np.float64): K_DOUBLE}
_POW10 = np.array([10**i for i in range(19)], dtype=np.int64)
_OBJ = np.dtype(object)


# ---------------------------------------------------------------------------
# the run-length codes (native/orcdec.c)
# ---------------------------------------------------------------------------


def _check(n: int, what: str) -> int:
    if n < 0:
        raise ValueError(f"malformed ORC {what} stream ({n})")
    return n


def _ptr(a: np.ndarray):
    return ctypes.c_void_p(a.ctypes.data)


def decode_ints(buf, count: int, version: int, signed: bool, runs: np.ndarray | None = None) -> np.ndarray:
    """`count` integers of RLE `version`; `runs`, an int64 array of 4, adds
    the RLE v2 runs of each sub-encoding (SHORT_REPEAT, DIRECT,
    PATCHED_BASE, DELTA)."""
    out = np.empty(count, dtype=np.int64)
    src = np.frombuffer(buf, dtype=np.uint8)
    counts = None if runs is None else _ptr(runs)
    _check(orc_library().po_int_decode(_ptr(src), len(src), count, version, int(signed), _ptr(out), counts), "integer")
    return out


def decode_bytes(buf, count: int) -> np.ndarray:
    out = np.empty(count, dtype=np.uint8)
    src = np.frombuffer(buf, dtype=np.uint8)
    _check(orc_library().po_byte_decode(_ptr(src), len(src), count, _ptr(out)), "byte")
    return out


def decode_bools(buf, count: int) -> np.ndarray:
    out = np.empty(count, dtype=np.uint8)
    src = np.frombuffer(buf, dtype=np.uint8)
    _check(orc_library().po_bool_decode(_ptr(src), len(src), count, _ptr(out)), "boolean")
    return out.view(np.bool_)


def decode_varints(buf, count: int) -> np.ndarray:
    out = np.empty(count, dtype=np.int64)
    src = np.frombuffer(buf, dtype=np.uint8)
    _check(orc_library().po_varint_decode(_ptr(src), len(src), count, _ptr(out)), "decimal")
    return out


def _encoded(fn, values: np.ndarray, cap: int, *args) -> bytes:
    out = np.empty(cap, dtype=np.uint8)
    n = fn(_ptr(values), len(values), *args, _ptr(out), cap)
    if n < 0:  # every capacity below bounds its encoder's output
        raise ValueError(f"ORC stream encoder ran out of its {cap}-byte buffer")
    return out[:n].tobytes()


def encode_ints(values: np.ndarray, signed: bool) -> bytes:
    v = np.ascontiguousarray(values, dtype=np.int64)
    # a DIRECT run of 512 values costs 2 header bytes and at most 8 per value
    return _encoded(orc_library().po_int_encode, v, 9 * len(v) + 2 * (len(v) // 512 + 1) + 16, int(signed))


def encode_bytes(values: np.ndarray) -> bytes:
    v = np.ascontiguousarray(values).view(np.uint8)
    return _encoded(orc_library().po_byte_encode, v, len(v) + len(v) // 128 + 16)


def encode_bools(values: np.ndarray) -> bytes:
    v = np.ascontiguousarray(values, dtype=np.bool_).view(np.uint8)
    packed = (len(v) + 7) // 8
    return _encoded(orc_library().po_bool_encode, v, 2 * packed + packed // 128 + 16)


def encode_varints(values: np.ndarray) -> bytes:
    v = np.ascontiguousarray(values, dtype=np.int64)
    return _encoded(orc_library().po_varint_encode, v, 10 * len(v) + 16)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


@dataclass
class _Stripe:
    streams: dict[tuple[int, int], tuple[int, int]]  # (column, kind) -> (offset, length)
    encodings: list[tuple[int, int]]  # per column: (kind, dictionary size)
    timezone: str
    rows: int


def _stripe_footer(data, tail: OrcTail, s: int) -> _Stripe:
    info = tail.stripes[s]
    start = info.offset + info.index_length + info.data_length
    raw = decompress_stream(data[start : start + info.footer_length], tail.compression, tail.block_size)
    streams: dict[tuple[int, int], tuple[int, int]] = {}
    encodings: list[tuple[int, int]] = []
    timezone = ""
    pos = info.offset
    for fnum, _, v in fields_of(raw):
        if fnum == 1:  # Stream
            st = {f2: v2 for f2, _, v2 in fields_of(v)}
            length = st.get(3, 0)
            streams[(st.get(2, 0), st.get(1, 0))] = (pos, length)
            pos += length
        elif fnum == 2:  # ColumnEncoding
            enc = {f2: v2 for f2, _, v2 in fields_of(v)}
            encodings.append((enc.get(1, E_DIRECT), enc.get(2, 0)))
        elif fnum == 3:
            timezone = v.decode("utf-8")
    return _Stripe(streams, encodings, timezone, info.rows)


class _Streams:
    """The decompressed streams of one column of one stripe."""

    def __init__(self, data, tail: OrcTail, stripe: _Stripe, column: int):
        self.data, self.tail, self.stripe, self.column = data, tail, stripe, column

    def get(self, kind: int, required: bool = True):
        loc = self.stripe.streams.get((self.column, kind))
        if loc is None:
            if required:
                raise ValueError(f"ORC column {self.column} lacks its stream of kind {kind}")
            return None
        off, length = loc
        return decompress_stream(self.data[off : off + length], self.tail.compression, self.tail.block_size)


def _strings(lengths: np.ndarray, body, utf8: bool) -> np.ndarray:
    offsets = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    data = np.frombuffer(body, dtype=np.uint8)
    if offsets[-1] > len(data):
        raise ValueError(f"ORC string lengths sum to {offsets[-1]} bytes past the {len(data)} of DATA")
    return strings_from_offsets(offsets, data, np.ones(len(lengths), dtype=np.bool_), utf8)


def _decode_present(kind: int, otype, enc: tuple[int, int], streams: _Streams, count: int, zone: str, name: str):
    """The values of the `count` present slots of the flat column `name`."""
    version = 2 if enc[0] in (E_DIRECT_V2, E_DICTIONARY_V2) else 1
    if kind == K_BOOLEAN:
        return decode_bools(streams.get(S_DATA), count)
    if kind == K_BYTE:
        return decode_bytes(streams.get(S_DATA), count).view(np.int8)
    if kind in _INT_KINDS:
        return decode_ints(streams.get(S_DATA), count, version, True)
    if kind in (K_FLOAT, K_DOUBLE):
        body = streams.get(S_DATA)
        dtype = np.dtype("<f4") if kind == K_FLOAT else np.dtype("<f8")
        if len(body) < count * dtype.itemsize:
            raise ValueError(f"ORC {dtype} DATA stream holds {len(body)} bytes for {count} values")
        return np.frombuffer(body, dtype=dtype, count=count)
    if kind in _STRING_KINDS:
        utf8 = kind != K_BINARY
        if enc[0] in (E_DICTIONARY, E_DICTIONARY_V2):
            codes = decode_ints(streams.get(S_DATA), count, version, False)
            size = enc[1]
            pool = _strings(decode_ints(streams.get(S_LENGTH), size, version, False),
                            streams.get(S_DICTIONARY_DATA, required=size > 0) or b"", utf8)
            if count and (codes.min() < 0 or codes.max() >= size):
                raise ValueError(f"ORC dictionary code past the {size}-entry dictionary")
            return pool[codes]
        return _strings(decode_ints(streams.get(S_LENGTH), count, version, False), streams.get(S_DATA), utf8)
    if kind == K_DECIMAL:
        if otype.precision > 18:
            raise NotImplementedError(f"ORC DECIMAL({otype.precision},{otype.scale}) is past precision 18")
        unscaled = decode_varints(streams.get(S_DATA), count)
        scales = decode_ints(streams.get(S_SECONDARY), count, version, True)
        shift = otype.scale - scales
        if count and (shift.min() < -18 or shift.max() > 18):
            raise ValueError("ORC DECIMAL value scale out of range")
        up, down = np.maximum(shift, 0), np.maximum(-shift, 0)
        return unscaled * _POW10[up] // _POW10[down]
    if kind in (K_TIMESTAMP, K_TIMESTAMP_INSTANT):
        if kind == K_TIMESTAMP and zone not in _UTC_ZONES:
            raise NotImplementedError(f"ORC TIMESTAMP written in timezone {zone!r}: the torch port reads GMT/UTC")
        secs = decode_ints(streams.get(S_DATA), count, version, True) + _ORC_EPOCH_SECONDS
        raw = decode_ints(streams.get(S_SECONDARY), count, version, False)
        zeros = raw & 7
        nanos = (raw >> 3) * np.where(zeros > 0, _POW10[np.minimum(zeros + 1, 18)], 1)
        secs -= (secs < 0) & (nanos > 999_999)  # the writer moved these one second up
        return secs * 1_000_000 + nanos // 1000
    raise NotImplementedError(f"ORC type kind {kind} of column {name!r} is not supported by the torch port")


def _present_mask(streams: _Streams, count: int) -> np.ndarray | None:
    raw = streams.get(S_PRESENT, required=False)
    return None if raw is None else decode_bools(raw, count)


def _nested_values(data, tail: OrcTail, stripe: _Stripe, cid: int, target: DataType, count: int,
                   name: str) -> tuple[np.ndarray, np.ndarray | None]:
    """(object vector of the `count` entries of column `cid`, None where
    null; the present mask, or None when every entry is present), read as
    `target`. A child's counts follow from its parent's PRESENT and LENGTH."""
    otype = tail.types[cid]
    if otype.kind == K_UNION:
        raise NotImplementedError(f"ORC type kind {K_UNION} (UNION) of column {name!r} is not supported by the "
                                  "torch port")
    expect = _NESTED_KINDS.get(target.root)
    if (otype.kind if otype.kind in _COMPOUND_KINDS else None) != expect:
        raise ValueError(f"ORC column {name!r} of kind {otype.kind} read into a {target} field")
    if count == 0:
        return np.empty(0, dtype=_OBJ), None
    streams = _Streams(data, tail, stripe, cid)
    enc = stripe.encodings[cid] if cid < len(stripe.encodings) else (E_DIRECT, 0)
    valid = _present_mask(streams, count)
    k = count if valid is None else int(valid.sum())
    if k == 0:  # every entry null: the value streams may be absent
        built = np.empty(0, dtype=_OBJ)
    elif expect is None:
        got = _decode_present(otype.kind, otype, enc, streams, k, stripe.timezone, name)
        np_dtype = target.numpy_dtype()
        if (got.dtype == _OBJ) != (np_dtype == _OBJ):
            raise ValueError(f"ORC column {name!r} of kind {otype.kind} read into a {target} field")
        built = got if got.dtype == _OBJ else _objects(got.astype(np_dtype, copy=False).tolist(), k)
    elif expect == K_STRUCT:
        by_name = dict(zip(otype.names, otype.subtypes))
        columns = []
        for f in target.fields:
            sub = by_name.get(f.name)
            if sub is None:
                columns.append(itertools.repeat(None, k))
            else:
                columns.append(_nested_values(data, tail, stripe, sub, f.type, k, f"{name}.{f.name}")[0].tolist())
        built = _objects(_row_maker(tuple(target.field_names))(*columns), k)
    else:
        version = 2 if enc[0] in (E_DIRECT_V2, E_DICTIONARY_V2) else 1
        lengths = decode_ints(streams.get(S_LENGTH), k, version, False)
        if lengths.min() < 0:
            raise ValueError(f"ORC column {name!r}: a LENGTH past int64")
        offsets = np.zeros(k + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        m = int(offsets[-1])
        if expect == K_LIST:
            elems = _nested_values(data, tail, stripe, otype.subtypes[0], target.element, m, f"{name}.element")[0]
            built = _objects(_runs(elems.tolist(), offsets), k)
        else:
            key_id, value_id = otype.subtypes
            keys = _nested_values(data, tail, stripe, key_id, target.key, m, f"{name}.key")[0]
            vals = _nested_values(data, tail, stripe, value_id, target.value, m, f"{name}.value")[0]
            built = _objects(map(dict, _runs(list(zip(keys.tolist(), vals.tolist())), offsets)), k)
    if valid is None:
        return built, None
    out = np.full(count, None, dtype=_OBJ)
    out[valid] = built
    return out, valid


def _decode_column(data, tail: OrcTail, stripe: _Stripe, cid: int, target, name: str) -> Column:
    otype = tail.types[cid]
    rows = stripe.rows
    if otype.kind in _COMPOUND_KINDS or target.root in NESTED_ROOTS:
        values, valid = _nested_values(data, tail, stripe, cid, target, rows, name)
        return Column(values, valid)
    enc = stripe.encodings[cid] if cid < len(stripe.encodings) else (E_DIRECT, 0)
    streams = _Streams(data, tail, stripe, cid)
    valid = _present_mask(streams, rows)
    count = rows if valid is None else int(valid.sum())
    got = _decode_present(otype.kind, otype, enc, streams, count, stripe.timezone, name)
    np_dtype = target.numpy_dtype()
    if np_dtype == _OBJ:
        if got.dtype != _OBJ:
            raise ValueError(f"ORC column of kind {otype.kind} read into a {target.root.value} field")
        if valid is None:
            return Column(got)
        values = np.full(rows, None, dtype=object)
        values[valid] = got
        return Column(values, valid.copy())
    if got.dtype == _OBJ:
        raise ValueError(f"ORC string column read into a {target.root.value} field")
    if valid is None:
        return Column(got.astype(np_dtype, copy=False))
    values = np.zeros(rows, dtype=np_dtype)
    values[valid] = got
    return Column(values, valid.copy())


def read_orc(data, schema: RowType, projection: Sequence[str] | None = None, predicate=None) -> list[ColumnBatch]:
    """The projected fields of one ORC file (every field of `schema` the
    file holds when projection is None), one ColumnBatch per stripe read,
    rows in file order. Under a predicate, stripes whose statistics cannot
    match it are skipped; rows of the stripes read may still fail it."""
    if bytes(data[:3]) != ORC_MAGIC:
        raise ValueError("not an ORC file (bad magic)")
    tail = read_tail(data)
    names = list(projection) if projection is not None else [n for n in schema.field_names if n in tail.field_columns]
    missing = [n for n in names if n not in tail.field_columns]
    if missing:
        raise ValueError(f"ORC file lacks the columns {missing}")
    read_schema = schema.project(names)
    out = []
    for s in range(tail.nstripes):
        if predicate is not None and s < len(tail.stripe_col_stats):
            if not predicate.test_stats(tail.stripe_stats(s)):
                registry.group("scan").counter("orc_stripes_skipped").inc()
                continue
        stripe = _stripe_footer(data, tail, s)
        if stripe.rows == 0:
            continue
        out.append(ColumnBatch(read_schema, {
            n: _decode_column(data, tail, stripe, tail.field_columns[n], read_schema.field(n).type, n) for n in names}))
    return out


def decompress_column_streams(data, columns: Sequence[str]) -> int:
    """Decompress every stream of `columns` in every stripe (a nested
    column's whole subtree), as the reader does, without decoding values;
    returns the bytes decompressed."""
    tail = read_tail(data)
    ids = {c for name in columns for c in tail.subtree(tail.field_columns[name])}
    total = 0
    for s in range(tail.nstripes):
        stripe = _stripe_footer(data, tail, s)
        for (col, kind), (off, length) in stripe.streams.items():
            if col in ids and kind != S_ROW_INDEX:
                total += len(decompress_stream(data[off : off + length], tail.compression, tail.block_size))
    return total


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def _compressor(compression: str):
    name = str(compression).lower()
    if name not in _COMPRESSION_KINDS:
        raise ValueError(f"Unknown CompressionKind: {str(compression).upper()}")
    if name == "zlib":
        def deflate(raw):
            c = zlib.compressobj(6, zlib.DEFLATED, -15)
            return c.compress(raw) + c.flush()

        return name, deflate
    return name, {"uncompressed": None, "snappy": snappy_compress, "lz4": lz4_compress, "zstd": zstd_compress}[name]


def _chunked(raw: bytes, compress) -> bytes:
    """A section as ORC's compressed chunks; raw as it is when uncompressed."""
    if compress is None:
        return raw
    out = bytearray()
    view = memoryview(raw)
    for start in range(0, len(raw), _BLOCK_SIZE):
        piece = view[start : start + _BLOCK_SIZE]
        packed = compress(piece)
        if len(packed) < len(piece):
            out += (len(packed) << 1).to_bytes(3, "little")
            out += packed
        else:
            out += ((len(piece) << 1) | 1).to_bytes(3, "little")
            out += piece
    return bytes(out)


def _kind_of(name: str, dtype: DataType) -> int:
    root = dtype.root
    if root in _NESTED_KINDS:
        return _NESTED_KINDS[root]
    if root in (TypeRoot.BINARY, TypeRoot.VARBINARY):
        return K_BINARY
    np_dtype = dtype.numpy_dtype()
    if np_dtype == _OBJ:
        if root not in (TypeRoot.CHAR, TypeRoot.VARCHAR):
            raise NotImplementedError(f"column {name!r}: type {root} has no ORC mapping in the torch port")
        return K_STRING
    return _NUMPY_KINDS[np_dtype]


@dataclass
class _Node:
    """One column of the written type tree: its id, kind and type, and its
    children (a LIST's element, a MAP's key and value, a STRUCT's fields)."""

    cid: int
    kind: int
    dtype: DataType
    children: list = field(default_factory=list)

    def type_message(self) -> bytes:
        if self.kind not in _COMPOUND_KINDS:
            return message([(1, self.kind)])
        names = [(3, f.name) for f in self.dtype.fields] if self.kind == K_STRUCT else []
        return message([(1, self.kind), (2, [c.cid for c in self.children])] + names)


def _type_tree(name: str, dtype: DataType, nodes: list) -> _Node:
    """The node of one field, its subtree numbered in pre-order after the
    ids already in `nodes` (the root struct is id 0), as ORC and pyarrow
    number them; every node is appended to `nodes`."""
    node = _Node(len(nodes) + 1, _kind_of(name, dtype), dtype)
    nodes.append(node)
    if node.kind == K_LIST:
        node.children = [_type_tree(name, dtype.element, nodes)]
    elif node.kind == K_MAP:
        node.children = [_type_tree(name, dtype.key, nodes)]
        node.children.append(_type_tree(name, dtype.value, nodes))
    elif node.kind == K_STRUCT:
        node.children = [_type_tree(f"{name}.{f.name}", f.type, nodes) for f in dtype.fields]
    return node


def _plain_strings(values: np.ndarray, binary: bool) -> np.ndarray:
    """A string column's present values as str (a non-string value as
    str() of it, as the JAX package's writer writes it); bytes as they are."""
    if binary or all(isinstance(v, str) for v in values):
        return values
    return np.array([v if isinstance(v, str) else str(v) for v in values], dtype=object)


@dataclass
class _Stats:
    """One column's statistics over the rows seen so far."""

    kind: int
    count: int = 0
    has_null: bool = False
    lo: object = None
    hi: object = None
    total: object = 0  # sum of the values (None once it cannot be kept), or of the lengths
    nan: bool = False

    @staticmethod
    def of(kind: int, values: np.ndarray, has_null: bool, lengths: np.ndarray | None,
           count: int | None = None) -> "_Stats":
        """The statistics of one stripe's present values; `count`, when
        given, is their number where `values` holds only their extremes."""
        st = _Stats(kind, has_null=has_null)
        count = len(values) if count is None else count
        if not count:
            return st
        lo = hi = None
        if kind == K_BOOLEAN:
            total = int(np.count_nonzero(values))
        elif kind in (K_FLOAT, K_DOUBLE):
            wide = values.astype(np.float64)
            st.nan = bool(np.isnan(wide).any())
            if not st.nan:
                lo, hi = float(wide.min()), float(wide.max())
            total = float(wide.sum())
        elif kind in (K_STRING, K_BINARY):
            if kind == K_STRING:
                lo, hi = min(values), max(values)
            total = int(lengths.sum())
        else:
            lo, hi = int(values.min()), int(values.max())
            fits = -(2**62) < lo * len(values) and hi * len(values) < 2**62
            total = int(values.astype(np.int64).sum()) if fits else None
        st.count, st.lo, st.hi, st.total = count, lo, hi, total
        return st

    def merge(self, other: "_Stats") -> None:
        self.has_null |= other.has_null
        self.nan |= other.nan
        if not other.count:
            return
        if self.count:
            self.lo = None if self.lo is None or other.lo is None else min(self.lo, other.lo)
            self.hi = None if self.hi is None or other.hi is None else max(self.hi, other.hi)
            self.total = None if self.total is None or other.total is None else self.total + other.total
        else:
            self.lo, self.hi, self.total = other.lo, other.hi, other.total
        self.count += other.count

    def encode(self) -> bytes:
        """The ColumnStatistics message; a LIST, MAP or STRUCT column's
        holds its count and hasNull only."""
        typed, kind = None, self.kind
        if self.count and kind not in _COMPOUND_KINDS:
            if kind == K_BOOLEAN:
                typed = (5, message([(1, [self.total])]))
            elif kind in (K_FLOAT, K_DOUBLE):
                if not self.nan:  # NaN bounds nothing: no statistics
                    typed = (3, message([(1, self.lo), (2, self.hi), (3, self.total)]))
            elif kind == K_STRING:
                typed = (4, message([(1, self.lo), (2, self.hi), (3, zigzag_encode(self.total))]))
            elif kind == K_BINARY:
                typed = (8, message([(1, zigzag_encode(self.total))]))
            else:
                total = None if self.total is None or not -(2**63) <= self.total < 2**63 else zigzag_encode(self.total)
                typed = (2, message([(1, zigzag_encode(self.lo)), (2, zigzag_encode(self.hi)), (3, total)]))
        return message([(1, self.count), typed or (2, None), (10, int(self.has_null))])


def _string_dictionary(col: Column, values: np.ndarray | None):
    """(sorted pool, codes of the present values) when a STRING column
    takes DICTIONARY_V2, else None: a column carrying codes always (its
    pool is free), others when the distinct values are at most 80% of the
    present ones (orc.dictionary.key.threshold's default in the reference's
    writer)."""
    if values is None:
        pool, codes = col.dict_cache
        if col.validity is not None:
            codes = codes[col.validity]
        pool, codes = prune_pool(pool, codes)
        return _plain_strings(pool, False), codes
    if len(values) < 64:
        return None
    pool, codes = _pool_and_ranks(values)
    if len(pool) > _DICT_KEY_THRESHOLD * len(values):
        return None
    return pool, codes


def _column_streams(kind: int, col: Column) -> tuple[list[tuple[int, bytes]], tuple[int, int], _Stats]:
    """[(stream kind, raw bytes)] of one column of one stripe, its
    encoding (kind, dictionary size) and its statistics."""
    valid = col.validity
    values = None if kind == K_STRING and cache_usable(col) else col.values
    if valid is not None and values is not None:
        values = values[valid]
    streams = []
    if valid is not None:
        streams.append((S_PRESENT, encode_bools(valid)))
    encoding, lengths = (E_DIRECT, 0), None
    if kind == K_BOOLEAN:
        streams.append((S_DATA, encode_bools(values)))
    elif kind == K_BYTE:
        streams.append((S_DATA, encode_bytes(values.astype(np.int8, copy=False))))
    elif kind in (K_SHORT, K_INT, K_LONG):
        streams.append((S_DATA, encode_ints(values, True)))
        encoding = (E_DIRECT_V2, 0)
    elif kind == K_FLOAT:
        streams.append((S_DATA, np.ascontiguousarray(values, dtype="<f4").tobytes()))
    elif kind == K_DOUBLE:
        streams.append((S_DATA, np.ascontiguousarray(values, dtype="<f8").tobytes()))
    else:
        if kind == K_STRING:
            values = None if values is None else _plain_strings(values, False)
            dictionary = _string_dictionary(col, values)
            if dictionary is not None:
                pool, codes = dictionary
                pool_lengths, payload = byte_array_parts(pool)
                pool_lengths = np.asarray(pool_lengths, dtype=np.int64)
                streams.append((S_DATA, encode_ints(codes, False)))
                streams.append((S_DICTIONARY_DATA, bytes(payload)))
                streams.append((S_LENGTH, encode_ints(pool_lengths, False)))
                # a sorted pool that every code uses: the bounds are its edges
                edges = pool[[0, -1]] if len(pool) else pool
                stats = _Stats.of(kind, edges, valid is not None, pool_lengths[codes], count=len(codes))
                return streams, (E_DICTIONARY_V2, len(pool)), stats
        lengths, payload = byte_array_parts(values)
        lengths = np.asarray(lengths, dtype=np.int64)
        streams.append((S_DATA, bytes(payload)))
        streams.append((S_LENGTH, encode_ints(lengths, False)))
        encoding = (E_DIRECT_V2, 0)
    return streams, encoding, _Stats.of(kind, values, valid is not None, lengths)


def _nested_streams(node: _Node, values: np.ndarray, out: list) -> None:
    """Append (streams, encoding, statistics) of `node` and then of its
    subtree, in pre-order, for the entries `values` (an object vector,
    None = null). A child holds entries only where its parent is present:
    a LIST's element and a MAP's key and value one per entry of the
    present lists and maps, a STRUCT's fields one per present struct."""
    n = len(values)
    present = values != None  # noqa: E711 - elementwise
    has_null = not present.all()
    if node.kind not in _COMPOUND_KINDS:  # a leaf: a flat column of its present entries
        np_dtype = node.dtype.numpy_dtype()
        if np_dtype != _OBJ:
            typed = np.zeros(n, dtype=np_dtype)
            typed[present] = np.array(values[present].tolist(), dtype=np_dtype)
            values = typed
        out.append(_column_streams(node.kind, Column(values, present if has_null else None)))
        return
    live = values[present].tolist() if has_null else values.tolist()
    k = len(live)
    streams = [(S_PRESENT, encode_bools(present))] if has_null else []
    stats = _Stats(node.kind, count=k, has_null=has_null)
    if node.kind == K_STRUCT:
        out.append((streams, (E_DIRECT, 0), stats))
        for f, child in zip(node.dtype.fields, node.children):
            _nested_streams(child, _objects(map(operator.methodcaller("get", f.name), live), k), out)
        return
    lengths = np.fromiter(map(len, live), dtype=np.int64, count=k)
    streams.append((S_LENGTH, encode_ints(lengths, False)))
    out.append((streams, (E_DIRECT_V2, 0), stats))
    m = int(lengths.sum())
    if node.kind == K_LIST:
        _nested_streams(node.children[0], _objects(itertools.chain.from_iterable(live), m), out)
        return
    if not all(isinstance(x, dict) for x in live):
        live = [dict(x) for x in live]
    _nested_streams(node.children[0], _objects(itertools.chain.from_iterable(map(dict.keys, live)), m), out)
    _nested_streams(node.children[1], _objects(itertools.chain.from_iterable(map(dict.values, live)), m), out)


def _field_streams(node: _Node, col: Column) -> list:
    """[(streams, encoding, statistics)] of one field's columns, in id order."""
    if node.kind not in _COMPOUND_KINDS:
        return [_column_streams(node.kind, col)]
    values = col.values
    if col.validity is not None:
        values = values.copy()
        values[~col.validity] = None
    out = []
    _nested_streams(node, values, out)
    return out


def _stripe_rows(batch: ColumnBatch, opts: dict) -> int:
    from ..options import MemorySize

    size = opts.get("orc.stripe.size")
    if size is None:
        size = opts.get("file.block-size")
    stripe_bytes = _DEFAULT_STRIPE_SIZE if size is None else int(MemorySize.parse(size))
    per_row = max(1, batch.byte_size() // max(batch.num_rows, 1))
    return max(_MIN_STRIPE_ROWS, stripe_bytes // per_row)


def write_orc(batch: ColumnBatch, compression: str = "zstd", format_options: dict | None = None) -> bytes:
    """One ColumnBatch -> complete ORC file bytes."""
    from ..metrics import encode_metrics

    t0 = time.perf_counter()
    name, compress = _compressor(compression)
    opts = {k: v for k, v in (format_options or {}).items() if v is not None}
    fields = batch.schema.fields
    nodes: list[_Node] = []
    tops = [_type_tree(f.name, f.type, nodes) for f in fields]
    body = bytearray(ORC_MAGIC)
    stripes, stripe_stats = [], []
    file_stats = [_Stats(node.kind) for node in nodes]
    n = batch.num_rows
    per_stripe = _stripe_rows(batch, opts)
    for start in range(0, n, per_stripe):
        part = batch if per_stripe >= n else batch.slice(start, min(start + per_stripe, n))
        offset = len(body)
        stream_entries, col_stats, encodings = [], [message([(1, part.num_rows), (10, 0)])], []
        columns = [c for f, top in zip(fields, tops) for c in _field_streams(top, part.column(f.name))]
        for cid, (streams, encoding, stats) in enumerate(columns, start=1):
            encodings.append(message([(1, encoding[0]), (2, encoding[1] or None)]))
            col_stats.append(stats.encode())
            file_stats[cid - 1].merge(stats)
            for skind, raw in streams:
                packed = _chunked(raw, compress)
                body += packed
                stream_entries.append(message([(1, skind), (2, cid), (3, len(packed))]))
        data_length = len(body) - offset
        footer = message([(1, e) for e in stream_entries]
                         + [(2, message([(1, E_DIRECT)]))]
                         + [(2, e) for e in encodings]
                         + [(3, "GMT")])
        footer = _chunked(footer, compress)
        body += footer
        stripes.append(message([(1, offset), (2, 0), (3, data_length), (4, len(footer)), (5, part.num_rows)]))
        stripe_stats.append(message([(1, s) for s in col_stats]))
    types = [message([(1, K_STRUCT), (2, [top.cid for top in tops])] + [(3, f.name) for f in fields])]
    types += [node.type_message() for node in nodes]
    metadata = _chunked(message([(1, s) for s in stripe_stats]), compress)
    footer = _chunked(message([(1, 3), (2, len(body) - 3)] + [(3, s) for s in stripes] + [(4, t) for t in types]
                              + [(6, n), (7, message([(1, n), (10, 0)]))] + [(7, s.encode()) for s in file_stats]
                              + [(8, 0), (12, _SOFTWARE)]), compress)
    body += metadata
    body += footer
    postscript = message([(1, len(footer)), (2, _COMPRESSION_KINDS[name]),
                          (3, _BLOCK_SIZE if compress is not None else None), (4, [0, 12]), (5, len(metadata)),
                          (6, _WRITER_VERSION), (8000, ORC_MAGIC)])
    body += postscript
    body.append(len(postscript))
    metrics = encode_metrics()
    metrics.counter("orc_files").inc()
    metrics.counter("bytes_written").inc(len(body))
    metrics.histogram("encode_ms").update((time.perf_counter() - t0) * 1000)
    return bytes(body)

