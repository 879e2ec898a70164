"""ORC file tail and stripe statistics, read and written without an ORC
library (port of paimon_tpu/format/orc_meta.py).

The tail is PostScript -> Footer (types, stripes, file statistics) ->
Metadata (per-stripe column statistics), protobuf messages read by the
minimal wire-format reader below and written by its writer half. The
shapes the pruning sees are the JAX module's: `OrcTail.stripe_stats`
gives one FieldStats per top-level field, from the integer, double,
string, boolean (true-count) and date statistics; other kinds give none,
so the stripe is read. A LIST, MAP or STRUCT field gives its null count
alone: a stripe is never pruned on a nested column. Column ids are
pre-order over the type tree, so a field's id is its field index only
while no nested field comes before it; `field_columns` maps the names.

Compressed sections (footer, metadata, stripe footers and streams) are
chunked: a 3-byte little-endian header (length << 1 | is_original), then
the chunk, raw deflate under ZLIB and raw blocks under SNAPPY, ZSTD and
LZ4, through the port's own codecs (utils/compression.py). LZO raises
NotImplementedError naming file.compression.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field

from ..format import FieldStats
from ..utils.compression import lz4_decompress, snappy_decompress, zstd_decompress

__all__ = ["OrcTail", "read_tail", "fields_of", "message", "decompress_stream"]


# ---------------------------------------------------------------------------
# protobuf wire format
# ---------------------------------------------------------------------------


def _varint(buf, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _zigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def fields_of(buf):
    """Yield (field_number, wire_type, value) over a protobuf message.
    value: int for varint/fixed, bytes for length-delimited."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _varint(buf, pos)
        fnum, wire = key >> 3, key & 7
        if wire == 0:  # varint
            v, pos = _varint(buf, pos)
        elif wire == 1:  # fixed64
            v = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _varint(buf, pos)
            v = bytes(buf[pos : pos + ln])
            pos += ln
        elif wire == 5:  # fixed32
            v = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield fnum, wire, v


def _packed_varints(v) -> list[int]:
    if isinstance(v, int):
        return [v]
    out = []
    pos = 0
    while pos < len(v):
        x, pos = _varint(v, pos)
        out.append(x)
    return out


def _put_varint(out: bytearray, v: int) -> None:
    v &= (1 << 64) - 1  # a negative int64 takes ten bytes, as protobuf writes it
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def zigzag_encode(v: int) -> int:
    return (v << 1) ^ (v >> 63)


def message(items) -> bytes:
    """A protobuf message from (field, value) pairs, in order: an int is a
    varint, a float a fixed64 double, bytes or str length-delimited, a list
    of ints one packed field; a None value is left out."""
    out = bytearray()
    for fnum, v in items:
        if v is None:
            continue
        if isinstance(v, bool) or isinstance(v, int):
            _put_varint(out, fnum << 3)
            _put_varint(out, int(v))
        elif isinstance(v, float):
            _put_varint(out, (fnum << 3) | 1)
            out += struct.pack("<d", v)
        elif isinstance(v, list):
            body = bytearray()
            for x in v:
                _put_varint(body, x)
            _put_varint(out, (fnum << 3) | 2)
            _put_varint(out, len(body))
            out += body
        else:
            raw = v.encode("utf-8") if isinstance(v, str) else bytes(v)
            _put_varint(out, (fnum << 3) | 2)
            _put_varint(out, len(raw))
            out += raw
    return bytes(out)


# ---------------------------------------------------------------------------
# ORC tail structures
# ---------------------------------------------------------------------------

_COMPRESSION = {0: "none", 1: "zlib", 2: "snappy", 3: "lzo", 4: "lz4", 5: "zstd"}

_KIND_STRUCT = 12  # orc_proto.Type.Kind.STRUCT
_COMPOUND_KINDS = (10, 11, 12, 13)  # LIST, MAP, STRUCT, UNION


def decompress_stream(raw, kind: str, block_size: int | None = None) -> bytes:
    """ORC compressed sections are chunked: 3-byte LE header
    (length << 1 | isOriginal) then chunk payload."""
    if kind == "none":
        return bytes(raw)
    if kind not in ("zlib", "snappy", "zstd", "lz4"):
        raise NotImplementedError(
            f"ORC {kind} compression cannot be decoded by the torch port (file.compression={kind}); "
            "it reads zstd, zlib, snappy, lz4 and none"
        )
    parts = []
    pos = 0
    raw = memoryview(raw)
    while pos + 3 <= len(raw):
        header = raw[pos] | (raw[pos + 1] << 8) | (raw[pos + 2] << 16)
        pos += 3
        length = header >> 1
        chunk = raw[pos : pos + length]
        if len(chunk) != length:
            raise ValueError(f"ORC {kind} chunk of {length} bytes cut short")
        pos += length
        if header & 1:  # original (stored uncompressed)
            parts.append(chunk)
        elif kind == "zlib":
            parts.append(zlib.decompress(chunk, -15))  # raw deflate
        elif kind == "zstd":
            parts.append(zstd_decompress(chunk))
        elif kind == "lz4":
            parts.append(lz4_decompress(chunk, limit=block_size))
        else:
            parts.append(snappy_decompress(chunk))
    return b"".join(parts)


@dataclass
class _ColStats:
    values: int = 0
    has_null: bool = False
    min: object = None
    max: object = None
    true_count: int | None = None


def _parse_col_stats(buf: bytes) -> _ColStats:
    cs = _ColStats()
    for fnum, wire, v in fields_of(buf):
        if fnum == 1:
            cs.values = v
        elif fnum == 10:
            cs.has_null = bool(v)
        elif fnum == 2:  # IntegerStatistics (sint64 min/max)
            for f2, _, v2 in fields_of(v):
                if f2 == 1:
                    cs.min = _zigzag(v2)
                elif f2 == 2:
                    cs.max = _zigzag(v2)
        elif fnum == 3:  # DoubleStatistics (double min/max)
            for f2, w2, v2 in fields_of(v):
                if f2 in (1, 2):
                    x = struct.unpack("<d", struct.pack("<Q", v2))[0]
                    if f2 == 1:
                        cs.min = x
                    else:
                        cs.max = x
        elif fnum == 4:  # StringStatistics
            for f2, _, v2 in fields_of(v):
                if f2 == 1:
                    cs.min = v2.decode("utf-8", "replace")
                elif f2 == 2:
                    cs.max = v2.decode("utf-8", "replace")
        elif fnum == 5:  # BucketStatistics { repeated uint64 count [packed] }
            counts: list[int] = []
            for f2, _, v2 in fields_of(v):
                if f2 == 1:
                    counts.extend(_packed_varints(v2))
            if counts:
                cs.true_count = counts[0]
        elif fnum == 7:  # DateStatistics (sint32 days)
            for f2, _, v2 in fields_of(v):
                if f2 == 1:
                    cs.min = _zigzag(v2)
                elif f2 == 2:
                    cs.max = _zigzag(v2)
    return cs


@dataclass(frozen=True)
class StripeInfo:
    offset: int
    index_length: int
    data_length: int
    footer_length: int
    rows: int


@dataclass(frozen=True)
class OrcType:
    kind: int
    subtypes: tuple[int, ...]
    names: tuple[str, ...]
    precision: int = 0
    scale: int = 0


@dataclass
class OrcTail:
    compression: str
    stripe_rows: list[int]  # rows per stripe (Footer.stripes)
    field_columns: dict[str, int]  # top-level field name -> flattened column id
    stripe_col_stats: list[list[_ColStats]]  # [stripe][column]
    # what the reader needs beyond the pruning
    block_size: int = 1 << 18
    stripes: list[StripeInfo] = field(default_factory=list)
    types: list[OrcType] = field(default_factory=list)

    @property
    def nstripes(self) -> int:
        return len(self.stripe_rows)

    def subtree(self, cid: int) -> list[int]:
        """Column `cid` and every column under it, in pre-order."""
        out, todo = [], [cid]
        while todo:
            c = todo.pop()
            out.append(c)
            subtypes = self.types[c].subtypes
            if any(not c < s < len(self.types) for s in subtypes):
                raise ValueError(f"ORC type {c} lists subtypes {list(subtypes)} outside the pre-order numbering")
            todo.extend(reversed(subtypes))
        return out

    def stripe_stats(self, stripe: int) -> dict[str, FieldStats]:
        """FieldStats per top-level field for one stripe — the same shape the
        scan layer feeds Predicate.test_stats, so file- and stripe-level
        pruning share one evaluator."""
        out: dict[str, FieldStats] = {}
        if stripe >= len(self.stripe_col_stats):
            return out
        cols = self.stripe_col_stats[stripe]
        rows = self.stripe_rows[stripe]
        for name, cid in self.field_columns.items():
            if cid >= len(cols):
                continue
            cs = cols[cid]
            null_count = rows - cs.values if cs.values <= rows else (0 if not cs.has_null else None)
            mn, mx = cs.min, cs.max
            if cid < len(self.types) and self.types[cid].kind in _COMPOUND_KINDS:
                mn = mx = None  # nested values have no order to prune by
            elif cs.true_count is not None:  # boolean column
                mn = cs.true_count >= cs.values  # min True iff NO False rows
                mx = cs.true_count > 0
            out[name] = FieldStats(mn, mx, null_count, rows)
        return out


def read_tail(data) -> OrcTail:
    """Parse the ORC tail from the file's final bytes (pass at least the last
    few KB; the whole file also works)."""
    ps_len = data[-1]
    ps = data[-1 - ps_len : -1]
    footer_len = metadata_len = 0
    compression = "none"
    block_size = 1 << 18
    for fnum, _, v in fields_of(ps):
        if fnum == 1:
            footer_len = v
        elif fnum == 2:
            compression = _COMPRESSION.get(v, "unknown")
        elif fnum == 3:
            block_size = v
        elif fnum == 5:
            metadata_len = v
    tail_needed = 1 + ps_len + footer_len + metadata_len
    if len(data) < tail_needed:
        raise ValueError("need more trailing bytes for ORC tail")
    footer_raw = data[-1 - ps_len - footer_len : -1 - ps_len]
    meta_raw = data[-1 - ps_len - footer_len - metadata_len : -1 - ps_len - footer_len]
    footer = decompress_stream(footer_raw, compression, block_size)
    meta = decompress_stream(meta_raw, compression, block_size)

    stripes: list[StripeInfo] = []
    types: list[OrcType] = []
    for fnum, _, v in fields_of(footer):
        if fnum == 3:  # StripeInformation
            info = {f2: v2 for f2, _, v2 in fields_of(v)}
            stripes.append(StripeInfo(info.get(1, 0), info.get(2, 0), info.get(3, 0), info.get(4, 0), info.get(5, 0)))
        elif fnum == 4:  # Type
            kind = precision = scale = 0
            subtypes: list[int] = []
            names: list[str] = []
            for f2, w2, v2 in fields_of(v):
                if f2 == 1:
                    kind = v2
                elif f2 == 2:
                    subtypes.extend(_packed_varints(v2))
                elif f2 == 3:
                    names.append(v2.decode("utf-8"))
                elif f2 == 5:
                    precision = v2
                elif f2 == 6:
                    scale = v2
            types.append(OrcType(kind, tuple(subtypes), tuple(names), precision, scale))

    field_columns: dict[str, int] = {}
    if types and types[0].kind == _KIND_STRUCT:
        for name, cid in zip(types[0].names, types[0].subtypes):
            field_columns[name] = cid

    stripe_col_stats: list[list[_ColStats]] = []
    for fnum, _, v in fields_of(meta):
        if fnum == 1:  # StripeStatistics
            cols = [_parse_col_stats(v2) for f2, _, v2 in fields_of(v) if f2 == 1]
            stripe_col_stats.append(cols)

    return OrcTail(compression, [s.rows for s in stripes], field_columns, stripe_col_stats, block_size, stripes, types)
