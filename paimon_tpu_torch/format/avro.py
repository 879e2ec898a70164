"""Avro data files (port of paimon_tpu/format/avro.py).

An Avro object container: magic 'Obj\\x01', a metadata map (the schema
JSON and the codec), a 16-byte sync marker, then blocks of (record count,
byte size, payload, sync), the payload raw deflate under the deflate
codec. Records are zigzag varints, IEEE floats and length-prefixed bytes,
a nullable field a ["null", T] union with null as branch 0. The writer
writes one block, deflate under file.compression zstd (the default); the
reader takes any number of blocks under the null and deflate codecs.

Which route codes a block is decided by the types of its fields: when
every field is an int, long, float, double, boolean, string or bytes (all
that the writers of either package produce), the block goes through the C
codec (native/avrodec.c); otherwise through the Python loop here. A
malformed block raises ValueError.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Sequence

import numpy as np

from ..data.batch import Column, ColumnBatch
from ..encode.kernels import byte_array_parts
from ..native import CODE_BOOL, CODE_DOUBLE, CODE_FLOAT, CODE_LONG, CODE_STRING, avro_decoder, avro_encoder
from ..types import RowType, TypeRoot

__all__ = ["AVRO_MAGIC", "write_avro", "read_avro", "strings_from_offsets"]

AVRO_MAGIC = b"Obj\x01"

_AVRO_TYPES = {
    TypeRoot.BOOLEAN: "boolean",
    TypeRoot.TINYINT: "int",
    TypeRoot.SMALLINT: "int",
    TypeRoot.INT: "int",
    TypeRoot.DATE: "int",
    TypeRoot.TIME: "int",
    TypeRoot.BIGINT: "long",
    TypeRoot.TIMESTAMP: "long",
    TypeRoot.TIMESTAMP_LTZ: "long",
    TypeRoot.DECIMAL: "long",
    TypeRoot.FLOAT: "float",
    TypeRoot.DOUBLE: "double",
    TypeRoot.CHAR: "string",
    TypeRoot.VARCHAR: "string",
    TypeRoot.BINARY: "bytes",
    TypeRoot.VARBINARY: "bytes",
}
# Avro type -> the C codec's field code
_CODES = {"int": CODE_LONG, "long": CODE_LONG, "float": CODE_FLOAT, "double": CODE_DOUBLE,
          "boolean": CODE_BOOL, "string": CODE_STRING, "bytes": CODE_STRING}


def _write_long(out: bytearray, v: int) -> None:
    v = (v << 1) ^ (v >> 63)  # zigzag
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_long(buf, pos: int) -> tuple[int, int]:
    shift = acc = 0
    while True:
        b = buf[pos]
        pos += 1
        acc |= (b & 0x7F) << shift
        if not b & 0x80:
            return (acc >> 1) ^ -(acc & 1), pos
        shift += 7


def _avro_schema(schema: RowType) -> dict:
    fields = []
    for f in schema.fields:
        t = _AVRO_TYPES.get(f.type.root)
        if t is None:
            raise ValueError(f"avro format does not support {f.type.root}")
        fields.append({"name": f.name, "type": ["null", t] if f.type.nullable else t})
    return {"type": "record", "name": "record", "fields": fields}


def _string_column(col: Column, utf8: bool) -> tuple[np.ndarray, np.ndarray]:
    """(int32 offsets, uint8 data) of a string or bytes column; a null slot
    is empty, a non-string value in a string column is written as str()
    of it, as the JAX package's writer writes it."""
    values = col.values
    if col.validity is not None:
        values = values.copy()
        values[~col.validity] = "" if utf8 else b""
    if utf8 and not all(isinstance(v, str) for v in values):
        values = np.array([v if isinstance(v, str) else str(v) for v in values], dtype=object)
    lengths, payload = byte_array_parts(values)
    offsets = np.zeros(len(values) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    if offsets[-1] > 0x7FFFFFFF:
        raise ValueError(f"avro block string column of {offsets[-1]} bytes exceeds int32 offsets")
    return offsets.astype(np.int32), np.frombuffer(payload, dtype=np.uint8)


def _encode_block(batch: ColumnBatch) -> bytes:
    specs, cols = [], []
    for f in batch.schema.fields:
        code = _CODES[_AVRO_TYPES[f.type.root]]
        specs.append((code, f.type.nullable))
        col = batch.column(f.name)
        if code == CODE_STRING:
            cols.append((*_string_column(col, f.type.root in (TypeRoot.CHAR, TypeRoot.VARCHAR)), col.validity))
        else:
            cols.append((col.values, col.validity))
    return avro_encoder(batch.num_rows, specs, cols)


def write_avro(batch: ColumnBatch, compression: str = "deflate") -> bytes:
    """One ColumnBatch -> an Avro object container of one block. As in the
    JAX package, `compression` deflate, zstd or zlib writes the deflate
    codec, and any other value the null codec."""
    codec = b"deflate" if str(compression).lower() in ("deflate", "zstd", "zlib") else b"null"
    meta = {"avro.schema": json.dumps(_avro_schema(batch.schema)).encode(), "avro.codec": codec}
    sync = os.urandom(16)
    out = bytearray(AVRO_MAGIC)
    _write_long(out, len(meta))
    for k, v in meta.items():
        kb = k.encode()
        _write_long(out, len(kb))
        out += kb
        _write_long(out, len(v))
        out += v
    _write_long(out, 0)  # end of the metadata map
    out += sync
    block = _encode_block(batch)
    if codec == b"deflate":
        block = zlib.compress(block)[2:-4]  # raw deflate, as the Avro spec has it
    _write_long(out, batch.num_rows)
    _write_long(out, len(block))
    out += block
    out += sync
    return bytes(out)


def _field_types(file_schema: dict) -> list[tuple[bool, object]]:
    out = []
    for f in file_schema["fields"]:
        t = f["type"]
        if isinstance(t, list):
            out.append((True, [x for x in t if x != "null"][0]))
        else:
            out.append((False, t))
    return out


def strings_from_offsets(offsets: np.ndarray, data: np.ndarray, valid: np.ndarray, utf8: bool) -> np.ndarray:
    """Object vector of str (utf8) or bytes from offsets + data; None at
    null slots. ASCII payloads free of NUL bytes go through one fixed-width
    matrix; others decode value by value."""
    n = len(offsets) - 1
    lengths = np.diff(offsets.astype(np.int64))
    total = int(offsets[-1]) if n else 0
    body = data[:total]
    width = int(lengths.max()) if n else 0
    if 0 < width <= 256 and n * width <= (64 << 20) and (not utf8 or int(body.max(initial=0)) < 128) and body.all():
        mat = np.zeros((n, width), dtype=np.uint8)
        rows = np.repeat(np.arange(n), lengths)
        cols = np.arange(total) - np.repeat(offsets[:-1].astype(np.int64), lengths)
        mat[rows, cols] = body
        fixed = mat.view(f"S{width}").ravel()
        out = (fixed.astype(f"U{width}") if utf8 else fixed).astype(object)
    else:
        raw = body.tobytes()
        bounds = offsets.tolist()
        out = np.empty(n, dtype=object)
        for i in range(n):
            v = raw[bounds[i] : bounds[i + 1]]
            out[i] = v.decode("utf-8") if utf8 else v
    if not valid.all():
        out[~valid] = None
    return out


def _decode_native(payload: bytes, count: int, field_types, names, read_schema: RowType) -> dict[str, Column]:
    results = avro_decoder(payload, count, [(_CODES[t], nullable) for nullable, t in field_types])
    cols: dict[str, Column] = {}
    for name, (nullable, t), res in zip(names, field_types, results):
        if name not in read_schema.field_names:
            continue
        target = read_schema.field(name).type
        if t in ("string", "bytes"):
            offsets, data, validity = res
            valid = validity.astype(np.bool_)
            cols[name] = Column(strings_from_offsets(offsets, data, valid, t == "string"), valid)
        else:
            values, validity = res
            np_dtype = target.numpy_dtype()
            if values.dtype != np_dtype:
                values = values.astype(np_dtype)
            cols[name] = Column(values, validity.astype(np.bool_))
    return cols


def _decode_python(payload: bytes, count: int, field_types, names, read_schema: RowType) -> dict[str, Column]:
    """The record-by-record loop, for blocks whose fields are not all flat
    primitives or strings."""
    buf = memoryview(payload)
    pos = 0
    rows = []
    for _ in range(count):
        row = []
        for nullable, t in field_types:
            if nullable:
                branch, pos = _read_long(buf, pos)
                if branch == 0:
                    row.append(None)
                    continue
            if t == "boolean":
                row.append(buf[pos] == 1)
                pos += 1
            elif t == "float":
                row.append(struct.unpack_from("<f", buf, pos)[0])
                pos += 4
            elif t == "double":
                row.append(struct.unpack_from("<d", buf, pos)[0])
                pos += 8
            elif t in ("string", "bytes"):
                n, pos = _read_long(buf, pos)
                raw = bytes(buf[pos : pos + n])
                row.append(raw.decode() if t == "string" else raw)
                pos += n
            elif t in ("int", "long"):
                v, pos = _read_long(buf, pos)
                row.append(v)
            else:
                raise ValueError(f"avro field type {t!r} is outside the flat record envelope")
        rows.append(row)
    wanted = [(i, n) for i, n in enumerate(names) if n in read_schema.field_names]
    return {
        n: Column.from_pylist([r[i] for r in rows], read_schema.field(n).type) for i, n in wanted
    }


def read_avro(data: bytes, schema: RowType, projection: Sequence[str] | None = None) -> ColumnBatch:
    """The projected fields of one Avro object container (every field of
    `schema` the file holds when projection is None), rows in file order;
    fields of the file outside the projection (the _KEY_ columns among
    them) are decoded and dropped."""
    if data[:4] != AVRO_MAGIC:
        raise ValueError("not an avro object container (bad magic)")
    buf = memoryview(data)
    pos = 4
    meta: dict[str, bytes] = {}
    while True:
        count, pos = _read_long(buf, pos)
        if count == 0:
            break
        if count < 0:  # a block of the map with its byte size
            _, pos = _read_long(buf, pos)
        for _ in range(abs(count)):
            klen, pos = _read_long(buf, pos)
            k = bytes(buf[pos : pos + klen]).decode()
            pos += klen
            vlen, pos = _read_long(buf, pos)
            meta[k] = bytes(buf[pos : pos + vlen])
            pos += vlen
    codec = meta.get("avro.codec", b"null")
    if codec not in (b"null", b"deflate"):
        raise ValueError(f"avro codec {codec.decode()!r} is not supported (null and deflate are)")
    file_schema = json.loads(meta["avro.schema"].decode())
    pos += 16  # sync
    field_types = _field_types(file_schema)
    names = [f["name"] for f in file_schema["fields"]]
    out_names = list(projection) if projection is not None else [n for n in schema.field_names if n in names]
    read_schema = schema.project(out_names)
    native = all(isinstance(t, str) and t in _CODES for _, t in field_types)
    decode = _decode_native if native else _decode_python
    blocks: list[dict[str, Column]] = []
    while pos < len(buf):
        count, pos = _read_long(buf, pos)
        size, pos = _read_long(buf, pos)
        payload = bytes(buf[pos : pos + size])
        pos += size + 16  # the block's sync marker
        if codec == b"deflate":
            payload = zlib.decompress(payload, -15)
        blocks.append(decode(payload, count, field_types, names, read_schema))
    if not blocks:
        return ColumnBatch.empty(read_schema)
    if len(blocks) == 1:
        return ColumnBatch(read_schema, blocks[0])
    return ColumnBatch(read_schema, {n: Column.concat([b[n] for b in blocks]) for n in out_names})
