"""Avro object-container files of Python dict records (port of
paimon_tpu/interop/avro_io.py).

format/avro.py is the columnar codec of flat data files. Manifests need
the other trade: small files of deeply nested records (ManifestEntry ->
DataFileMeta -> SimpleStats) under exact schema names, so this module
walks record, array and union schemas recursively. Types: null, boolean,
int, long, float, double, bytes, string, record, array and union (logical
types pass through as their base type); codecs null and deflate.
"""

from __future__ import annotations

import json
import os
import struct
import zlib

__all__ = ["write_ocf", "read_ocf"]

_MAGIC = b"Obj\x01"


def _zz(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _unzz(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _write_long(out: bytearray, v: int) -> None:
    v = _zz(v)
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_long(buf, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return _unzz(result), pos
        shift += 7


def _encode(out: bytearray, schema, value) -> None:
    if isinstance(schema, list):  # union
        for idx, branch in enumerate(schema):
            btype = branch if isinstance(branch, str) else branch.get("type")
            if value is None and btype == "null":
                _write_long(out, idx)
                return
            if value is not None and btype != "null":
                _write_long(out, idx)
                _encode(out, branch, value)
                return
        raise ValueError(f"no union branch for {value!r} in {schema}")
    stype = schema if isinstance(schema, str) else schema["type"]
    if stype == "null":
        return
    if stype == "boolean":
        out.append(1 if value else 0)
    elif stype in ("int", "long"):
        _write_long(out, int(value))
    elif stype == "float":
        out += struct.pack("<f", value)
    elif stype == "double":
        out += struct.pack("<d", value)
    elif stype == "bytes":
        data = bytes(value)
        _write_long(out, len(data))
        out += data
    elif stype == "string":
        data = value.encode("utf-8")
        _write_long(out, len(data))
        out += data
    elif stype == "record":
        for f in schema["fields"]:
            _encode(out, f["type"], value.get(f["name"]))
    elif stype == "array":
        items = list(value)
        if items:
            _write_long(out, len(items))
            for item in items:
                _encode(out, schema["items"], item)
        _write_long(out, 0)
    else:
        raise ValueError(f"unsupported avro type {stype}")


def _decode(buf, pos: int, schema):
    if isinstance(schema, list):  # union
        idx, pos = _read_long(buf, pos)
        return _decode(buf, pos, schema[idx])
    stype = schema if isinstance(schema, str) else schema["type"]
    if stype == "null":
        return None, pos
    if stype == "boolean":
        return bool(buf[pos]), pos + 1
    if stype in ("int", "long"):
        return _read_long(buf, pos)
    if stype == "float":
        return struct.unpack_from("<f", buf, pos)[0], pos + 4
    if stype == "double":
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if stype == "bytes":
        ln, pos = _read_long(buf, pos)
        return bytes(buf[pos : pos + ln]), pos + ln
    if stype == "string":
        ln, pos = _read_long(buf, pos)
        return bytes(buf[pos : pos + ln]).decode("utf-8"), pos + ln
    if stype == "record":
        rec = {}
        for f in schema["fields"]:
            rec[f["name"]], pos = _decode(buf, pos, f["type"])
        return rec, pos
    if stype == "array":
        items = []
        while True:
            count, pos = _read_long(buf, pos)
            if count == 0:
                return items, pos
            if count < 0:  # block with byte size
                _, pos = _read_long(buf, pos)
                count = -count
            for _ in range(count):
                v, pos = _decode(buf, pos, schema["items"])
                items.append(v)
    raise ValueError(f"unsupported avro type {stype}")


def write_ocf(schema: dict, records: list[dict], codec: str = "deflate") -> bytes:
    """Records -> Avro object container file bytes."""
    out = bytearray(_MAGIC)
    meta = {"avro.schema": json.dumps(schema).encode(), "avro.codec": codec.encode()}
    _write_long(out, len(meta))
    for k, v in meta.items():
        kb = k.encode()
        _write_long(out, len(kb))
        out += kb
        _write_long(out, len(v))
        out += v
    _write_long(out, 0)
    sync = os.urandom(16)
    out += sync
    if records:
        body = bytearray()
        for r in records:
            _encode(body, schema, r)
        payload = bytes(body)
        if codec == "deflate":
            payload = zlib.compress(payload)[2:-4]  # raw deflate per avro spec
        _write_long(out, len(records))
        _write_long(out, len(payload))
        out += payload
        out += sync
    return bytes(out)


def read_ocf(data: bytes) -> tuple[dict, list[dict]]:
    """Avro OCF bytes -> (schema, records)."""
    assert data[:4] == _MAGIC, "not an avro object container file"
    buf = memoryview(data)
    pos = 4
    meta: dict[str, bytes] = {}
    while True:
        count, pos = _read_long(buf, pos)
        if count == 0:
            break
        if count < 0:
            _, pos = _read_long(buf, pos)
            count = -count
        for _ in range(count):
            kl, pos = _read_long(buf, pos)
            k = bytes(buf[pos : pos + kl]).decode()
            pos += kl
            vl, pos = _read_long(buf, pos)
            meta[k] = bytes(buf[pos : pos + vl])
            pos += vl
    schema = json.loads(meta["avro.schema"])
    codec = meta.get("avro.codec", b"null").decode()
    pos += 16  # sync
    records: list[dict] = []
    n = len(data)
    while pos < n:
        count, pos = _read_long(buf, pos)
        size, pos = _read_long(buf, pos)
        payload = bytes(buf[pos : pos + size])
        pos += size + 16  # skip sync
        if codec == "deflate":
            payload = zlib.decompress(payload, -15)
        elif codec != "null":
            raise ValueError(f"unsupported avro codec {codec}")
        p2 = 0
        pv = memoryview(payload)
        for _ in range(count):
            rec, p2 = _decode(pv, p2, schema)
            records.append(rec)
    return schema, records
