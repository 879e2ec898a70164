"""The reference's BinaryRow byte layout (port of
paimon_tpu/interop/binary_row.py, bit for bit the JAX package's bytes).

One row over a little-endian memory segment:
  [null bitset]  ((arity + 63 + 8) / 64) * 8 bytes; bits 0-7 of byte 0 hold
                 the RowKind header, field i's null bit is bit (i + 8),
                 LSB-first within each byte
  [fixed part]   8 bytes per field: primitives stored directly (LE);
                 var-length values of at most 7 bytes inline (mark bit 0x80
                 of the last byte + length in bits 56-62, payload at byte 0);
                 longer values as (offset << 32 | length) pointing into
  [var part]     8-byte-aligned payloads appended after the fixed part

Inside manifests the row bytes carry a 4-byte BIG-endian arity prefix.
Flat rows of the types partitions, keys and stats rows hold are supported
(bool, int8..64, float32/64, string, bytes, date, compact timestamp).
"""

from __future__ import annotations

import struct

from ..types import DataType, TypeRoot

__all__ = ["encode_binary_row", "decode_binary_row", "serialize_binary_row", "deserialize_binary_row"]

_FIXED8 = {
    TypeRoot.BIGINT: "<q",
    TypeRoot.DOUBLE: "<d",
    TypeRoot.TIMESTAMP: "<q",
    TypeRoot.TIMESTAMP_LTZ: "<q",
}
_FIXED4 = {
    TypeRoot.INT: "<i",
    TypeRoot.DATE: "<i",
    TypeRoot.TIME: "<i",
    TypeRoot.FLOAT: "<f",
}


def _bitset_bytes(arity: int) -> int:
    return ((arity + 63 + 8) // 64) * 8


def encode_binary_row(values: list, types: list[DataType], row_kind: int = 0) -> bytes:
    """values -> BinaryRow bytes (no arity prefix)."""
    arity = len(values)
    nb = _bitset_bytes(arity)
    fixed = nb + 8 * arity
    buf = bytearray(fixed)
    buf[0] = row_kind & 0xFF
    var = bytearray()

    def set_null(i: int) -> None:
        idx = i + 8
        buf[idx >> 3] |= 1 << (idx & 7)

    for i, (v, t) in enumerate(zip(values, types)):
        off = nb + 8 * i
        if v is None:
            set_null(i)
            continue
        root = t.root
        if root == TypeRoot.BOOLEAN:
            buf[off] = 1 if v else 0
        elif root in (TypeRoot.TINYINT, TypeRoot.SMALLINT):
            struct.pack_into("<h" if root == TypeRoot.SMALLINT else "<b", buf, off, int(v))
        elif root in _FIXED4:
            struct.pack_into(_FIXED4[root], buf, off, v if root == TypeRoot.FLOAT else int(v))
        elif root in _FIXED8:
            struct.pack_into(_FIXED8[root], buf, off, float(v) if root == TypeRoot.DOUBLE else int(v))
        elif root in (TypeRoot.CHAR, TypeRoot.VARCHAR, TypeRoot.BINARY, TypeRoot.VARBINARY):
            data = v.encode("utf-8") if isinstance(v, str) else bytes(v)
            if len(data) <= 7:
                buf[off : off + len(data)] = data
                buf[off + 7] = 0x80 | len(data)
            else:
                # var part is 8-byte aligned; offset is from row start
                cursor = fixed + len(var)
                var += data
                pad = (-len(data)) % 8
                var += b"\x00" * pad
                struct.pack_into("<q", buf, off, (cursor << 32) | len(data))
        else:
            raise ValueError(f"binary-row type {root} not supported in metadata rows")
    return bytes(buf) + bytes(var)


def decode_binary_row(data: bytes, types: list[DataType]) -> list:
    """BinaryRow bytes (no prefix) -> values."""
    arity = len(types)
    nb = _bitset_bytes(arity)
    out = []
    for i, t in enumerate(types):
        idx = i + 8
        if data[idx >> 3] & (1 << (idx & 7)):
            out.append(None)
            continue
        off = nb + 8 * i
        root = t.root
        if root == TypeRoot.BOOLEAN:
            out.append(bool(data[off]))
        elif root == TypeRoot.TINYINT:
            out.append(struct.unpack_from("<b", data, off)[0])
        elif root == TypeRoot.SMALLINT:
            out.append(struct.unpack_from("<h", data, off)[0])
        elif root in _FIXED4:
            out.append(struct.unpack_from(_FIXED4[root], data, off)[0])
        elif root in _FIXED8:
            out.append(struct.unpack_from(_FIXED8[root], data, off)[0])
        elif root in (TypeRoot.CHAR, TypeRoot.VARCHAR, TypeRoot.BINARY, TypeRoot.VARBINARY):
            slot = struct.unpack_from("<Q", data, off)[0]
            if slot & (0x80 << 56):
                ln = (slot >> 56) & 0x7F
                raw = data[off : off + ln]
            else:
                sub = slot >> 32
                ln = slot & 0xFFFFFFFF
                raw = data[sub : sub + ln]
            out.append(raw.decode("utf-8") if root in (TypeRoot.CHAR, TypeRoot.VARCHAR) else bytes(raw))
        else:
            raise ValueError(f"binary-row type {root} not supported in metadata rows")
    return out


def serialize_binary_row(values: list, types: list[DataType], row_kind: int = 0) -> bytes:
    """4-byte big-endian arity + row bytes (SerializationUtils.serializeBinaryRow)."""
    row = encode_binary_row(values, types, row_kind)
    return struct.pack(">i", len(values)) + row


def deserialize_binary_row(data: bytes, types: list[DataType]) -> list:
    arity = struct.unpack_from(">i", data, 0)[0]
    assert arity == len(types), (arity, len(types))
    return decode_binary_row(data[4:], types)
