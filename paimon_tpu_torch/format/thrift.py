"""Thrift compact-protocol reader and writer for Parquet metadata (port of
paimon_tpu/decode/thrift.py, unchanged in substance).

Parquet's footer (FileMetaData) and every page header are TCompactProtocol
structs. `read_struct` returns {field_id: value} dicts with nested structs
and lists parsed recursively; `build_struct` takes (field_id, type, value)
triples and emits the bytes `read_struct` parses.

Wire format: ULEB128 varints; zigzag i16/i32/i64; one-byte field headers
((id-delta << 4) | type, delta 0 = long form); bools folded into the header
type nibble (full bytes inside collections); binary = varint length +
bytes; list header (size << 4 | elem type, size 15 = varint follows);
doubles 8 bytes little-endian.
"""

from __future__ import annotations

import struct

__all__ = [
    "ThriftError",
    "read_struct",
    "read_varint",
    "zigzag",
    "zigzag_encode",
    "append_uvarint",
    "build_struct",
]


class ThriftError(ValueError):
    """Malformed compact-protocol bytes (truncated varint, bad type nibble)."""


# compact-protocol type nibbles
CT_STOP = 0
CT_TRUE = 1
CT_FALSE = 2
CT_BYTE = 3
CT_I16 = 4
CT_I32 = 5
CT_I64 = 6
CT_DOUBLE = 7
CT_BINARY = 8
CT_LIST = 9
CT_SET = 10
CT_MAP = 11
CT_STRUCT = 12


def read_varint(buf, pos: int) -> tuple[int, int]:
    """(value, new_pos) — ULEB128."""
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ThriftError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ThriftError("varint too long")


def zigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _read_value(buf, pos: int, ctype: int):
    if ctype == CT_BYTE:
        v = buf[pos]
        return v - 256 if v >= 128 else v, pos + 1
    if ctype in (CT_I16, CT_I32, CT_I64):
        v, pos = read_varint(buf, pos)
        return zigzag(v), pos
    if ctype == CT_DOUBLE:
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if ctype == CT_BINARY:
        n, pos = read_varint(buf, pos)
        return bytes(buf[pos : pos + n]), pos + n
    if ctype in (CT_LIST, CT_SET):
        return _read_list(buf, pos)
    if ctype == CT_MAP:
        return _read_map(buf, pos)
    if ctype == CT_STRUCT:
        return read_struct(buf, pos)
    raise ThriftError(f"unexpected compact type {ctype}")


def _read_list(buf, pos: int):
    header = buf[pos]
    pos += 1
    size = header >> 4
    etype = header & 0xF
    if size == 15:
        size, pos = read_varint(buf, pos)
    out = []
    for _ in range(size):
        if etype in (CT_TRUE, CT_FALSE):
            # bool elements are full bytes inside collections
            out.append(buf[pos] == CT_TRUE)
            pos += 1
        else:
            v, pos = _read_value(buf, pos, etype)
            out.append(v)
    return out, pos


def _read_map(buf, pos: int):
    size, pos = read_varint(buf, pos)
    out = {}
    if size == 0:
        return out, pos
    kv = buf[pos]
    pos += 1
    ktype, vtype = kv >> 4, kv & 0xF
    for _ in range(size):
        k, pos = _read_value(buf, pos, ktype)
        v, pos = _read_value(buf, pos, vtype)
        out[k] = v
    return out, pos


def read_struct(buf, pos: int = 0) -> tuple[dict[int, object], int]:
    """Parse one struct starting at `pos`: ({field_id: value}, end_pos).

    Booleans folded into field headers come back as Python bools; nested
    structs as dicts; lists as Python lists; binaries as bytes.
    """
    out: dict[int, object] = {}
    fid = 0
    while True:
        if pos >= len(buf):
            raise ThriftError("truncated struct (no STOP)")
        header = buf[pos]
        pos += 1
        if header == CT_STOP:
            return out, pos
        delta = header >> 4
        ctype = header & 0xF
        if delta:
            fid += delta
        else:
            v, pos = read_varint(buf, pos)
            fid = zigzag(v)
        if ctype == CT_TRUE:
            out[fid] = True
        elif ctype == CT_FALSE:
            out[fid] = False
        else:
            out[fid], pos = _read_value(buf, pos, ctype)


# ---- writer (the encode dual) --------------------------------------------


def zigzag_encode(n: int) -> int:
    """Signed int → zigzag unsigned (inverse of `zigzag`)."""
    return (n << 1) ^ (n >> 63)


def append_uvarint(out: bytearray, v: int) -> None:
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _append_value(out: bytearray, ctype: int, value) -> None:
    if ctype in (CT_I16, CT_I32, CT_I64):
        append_uvarint(out, zigzag_encode(int(value)))
    elif ctype == CT_BYTE:
        out.append(int(value) & 0xFF)
    elif ctype == CT_DOUBLE:
        out += struct.pack("<d", float(value))
    elif ctype == CT_BINARY:
        raw = value.encode("utf-8") if isinstance(value, str) else bytes(value)
        append_uvarint(out, len(raw))
        out += raw
    elif ctype == CT_STRUCT:
        # nested structs are pre-built bytes (build_struct output) or
        # field-triple lists, appended in place
        out += value if isinstance(value, (bytes, bytearray)) else build_struct(value)
    elif ctype in (CT_LIST, CT_SET):
        etype, elems = value
        if len(elems) < 15:
            out.append((len(elems) << 4) | etype)
        else:
            out.append((15 << 4) | etype)
            append_uvarint(out, len(elems))
        for e in elems:
            if etype in (CT_TRUE, CT_FALSE):
                out.append(CT_TRUE if e else CT_FALSE)
            else:
                _append_value(out, etype, e)
    else:
        raise ThriftError(f"cannot write compact type {ctype}")


def build_struct(fields) -> bytes:
    """(field_id, ctype, value) triples → compact-protocol struct bytes.

    None values are skipped (optional thrift fields). Bools use CT_TRUE with
    a bool value — the writer folds them into the field header exactly like
    the spec. Nested structs pass pre-built bytes (or a triple list); lists
    pass (elem_ctype, [values]). Fields are sorted by id so the short-form
    delta header applies wherever it can."""
    out = bytearray()
    prev = 0
    for fid, ctype, value in sorted(fields, key=lambda f: f[0]):
        if value is None:
            continue
        if ctype in (CT_TRUE, CT_FALSE):
            ctype = CT_TRUE if value else CT_FALSE
            delta = fid - prev
            if 0 < delta <= 15:
                out.append((delta << 4) | ctype)
            else:
                out.append(ctype)
                append_uvarint(out, zigzag_encode(fid))
            prev = fid
            continue
        delta = fid - prev
        if 0 < delta <= 15:
            out.append((delta << 4) | ctype)
        else:
            out.append(ctype)
            append_uvarint(out, zigzag_encode(fid))
        prev = fid
        _append_value(out, ctype, value)
    out.append(CT_STOP)
    return bytes(out)
