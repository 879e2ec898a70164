"""Host C code of the port, built at first use and loaded via ctypes (the
counterpart of paimon_tpu/native/).

- `zstd.c`: the port's Zstandard codec (RFC 8878).
- `snappy.c`: the snappy raw block codec of Parquet's SNAPPY pages.
- `avrodec.c`: the Avro block decoder and encoder of format/avro.py (the
  counterpart of the JAX package's native/avrodec.c).
- `lz4.c`: the LZ4 raw block codec of Parquet's LZ4_RAW pages and ORC's
  LZ4 chunks.
- `orcdec.c`: ORC's run-length codes (integer RLE v1 and v2, byte and
  boolean RLE, base-128 varints) of format/orc.py, both directions.

Each source is compiled with `cc -O3 -shared -fPIC` into
paimon_tpu_torch/_build/, under a name keyed by the hash of the source and
the flags, and loaded with ctypes.CDLL, which releases the GIL during every
call. Several processes may build at once (tests run in parallel workers):
a build holds an exclusive file lock, writes to a private temporary name
and renames it into place, so no process ever loads a half-written
library. There is no fallback: without a C compiler, or when a build
fails, loading raises RuntimeError with the compiler's output.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

__all__ = [
    "zstd_library",
    "build_zstd",
    "snappy_library",
    "avro_library",
    "lz4_library",
    "orc_library",
    "build_native",
    "avro_decoder",
    "avro_encoder",
    "CODE_LONG",
    "CODE_FLOAT",
    "CODE_DOUBLE",
    "CODE_BOOL",
    "CODE_STRING",
]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(_DIR, "zstd.c")
_SNAPPY_SOURCE = os.path.join(_DIR, "snappy.c")
_AVRO_SOURCE = os.path.join(_DIR, "avrodec.c")
_LZ4_SOURCE = os.path.join(_DIR, "lz4.c")
_ORC_SOURCE = os.path.join(_DIR, "orcdec.c")
_BUILD = os.path.join(os.path.dirname(_DIR), "_build")
_FLAGS = ["-O3", "-shared", "-fPIC"]
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None  # zstd
_LIBS: dict[str, ctypes.CDLL] = {}  # snappy, avro, lz4, orc

# Avro field type codes; must match avrodec.c
CODE_LONG = 0
CODE_FLOAT = 1
CODE_DOUBLE = 2
CODE_BOOL = 3
CODE_STRING = 4
_NUMERIC_DTYPES = {CODE_LONG: np.int64, CODE_FLOAT: np.float64, CODE_DOUBLE: np.float64, CODE_BOOL: np.uint8}


def _build(source: str, stem: str) -> str:
    """Compile `source` unless its library exists; returns the library path."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    path = os.path.join(_BUILD, f"lib{stem}-{digest}.so")
    if os.path.exists(path):
        return path
    name = os.path.basename(source)
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        raise RuntimeError(f"no C compiler ('cc' or 'gcc') on PATH: the port's native/{name} cannot be built")
    os.makedirs(_BUILD, exist_ok=True)
    with open(os.path.join(_BUILD, f"{stem}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(path):  # another process may have built it while this one waited
            tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
            out = subprocess.run([cc, *_FLAGS, "-o", tmp, source], capture_output=True, text=True)
            if out.returncode != 0:
                raise RuntimeError(f"building native/{name} failed (cc exited {out.returncode}):\n{out.stdout}{out.stderr}")
            os.replace(tmp, path)
    return path


def build_zstd() -> str:
    """Compile zstd.c unless its library exists; returns the library path."""
    return _build(_SOURCE, "zstd_codec")


def build_native() -> list[str]:
    """Build every C source of the port; returns the library paths."""
    return [build_zstd(), _build(_SNAPPY_SOURCE, "snappy_codec"), _build(_AVRO_SOURCE, "avro_codec"),
            _build(_LZ4_SOURCE, "lz4_codec"), _build(_ORC_SOURCE, "orc_codec")]


def zstd_library() -> ctypes.CDLL:
    """The zstd library, built and bound on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build_zstd())
            u8p, size, i64 = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int64
            lib.pz_frame_bound.argtypes = [u8p, size, ctypes.POINTER(i64)]
            lib.pz_decompress.argtypes = [u8p, size, u8p, size]
            lib.pz_compress_bound.argtypes = [size]
            lib.pz_compress.argtypes = [u8p, size, u8p, size]
            lib.pz_error.argtypes = [i64]
            for fn in (lib.pz_frame_bound, lib.pz_decompress, lib.pz_compress_bound, lib.pz_compress):
                fn.restype = i64
            lib.pz_error.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def snappy_library() -> ctypes.CDLL:
    """The snappy library, built and bound on first use."""
    with _LOCK:
        lib = _LIBS.get("snappy")
        if lib is None:
            lib = ctypes.CDLL(_build(_SNAPPY_SOURCE, "snappy_codec"))
            u8p, size, i64 = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int64
            lib.ps_compress_bound.argtypes = [size]
            lib.ps_uncompressed_length.argtypes = [u8p, size]
            lib.ps_compress.argtypes = [u8p, size, u8p, size]
            lib.ps_decompress.argtypes = [u8p, size, u8p, size]
            for fn in (lib.ps_compress_bound, lib.ps_uncompressed_length, lib.ps_compress, lib.ps_decompress):
                fn.restype = i64
            _LIBS["snappy"] = lib
        return lib


def avro_library() -> ctypes.CDLL:
    """The Avro block codec, built and bound on first use."""
    with _LOCK:
        lib = _LIBS.get("avro")
        if lib is None:
            lib = ctypes.CDLL(_build(_AVRO_SOURCE, "avro_codec"))
            lib.decode_block.restype = ctypes.c_int
            lib.encode_block.restype = ctypes.c_int64
            _LIBS["avro"] = lib
        return lib


def lz4_library() -> ctypes.CDLL:
    """The LZ4 raw block codec, built and bound on first use."""
    with _LOCK:
        lib = _LIBS.get("lz4")
        if lib is None:
            lib = ctypes.CDLL(_build(_LZ4_SOURCE, "lz4_codec"))
            u8p, size, i64 = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int64
            lib.pl_compress_bound.argtypes = [size]
            lib.pl_compress.argtypes = [u8p, size, u8p, size]
            lib.pl_decompress.argtypes = [u8p, size, u8p, size]
            for fn in (lib.pl_compress_bound, lib.pl_compress, lib.pl_decompress):
                fn.restype = i64
            _LIBS["lz4"] = lib
        return lib


def orc_library() -> ctypes.CDLL:
    """ORC's run-length codes, built and bound on first use."""
    with _LOCK:
        lib = _LIBS.get("orc")
        if lib is None:
            lib = ctypes.CDLL(_build(_ORC_SOURCE, "orc_codec"))
            p, size, i64, i32 = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int64, ctypes.c_int
            lib.po_int_decode.argtypes = [p, size, i64, i32, i32, p, p]
            lib.po_byte_decode.argtypes = [p, size, i64, p]
            lib.po_bool_decode.argtypes = [p, size, i64, p]
            lib.po_varint_decode.argtypes = [p, size, i64, p]
            lib.po_int_encode.argtypes = [p, i64, i32, p, size]
            lib.po_byte_encode.argtypes = [p, i64, p, size]
            lib.po_bool_encode.argtypes = [p, i64, p, size]
            lib.po_varint_encode.argtypes = [p, i64, p, size]
            for fn in (lib.po_int_decode, lib.po_byte_decode, lib.po_bool_decode, lib.po_varint_decode,
                       lib.po_int_encode, lib.po_byte_encode, lib.po_bool_encode, lib.po_varint_encode):
                fn.restype = i64
            _LIBS["orc"] = lib
        return lib


def _specs(field_specs: list[tuple[int, bool]]):
    type_codes = np.array([c for c, _ in field_specs], dtype=np.int32)
    nullable = np.array([1 if n else 0 for _, n in field_specs], dtype=np.uint8)
    return type_codes, nullable


def avro_decoder(payload: bytes, count: int, field_specs: list[tuple[int, bool]]) -> list:
    """Decode one Avro block of `count` records. field_specs: [(type code,
    nullable)] per field. Returns one result per field:
      numeric/bool: (values ndarray, uint8 validity)
      string:       (int32 offsets (count+1), uint8 data, uint8 validity)
    A malformed block raises ValueError."""
    lib = avro_library()
    nfields = len(field_specs)
    type_codes, nullable = _specs(field_specs)
    num_out = (ctypes.c_void_p * nfields)()
    valid_out = (ctypes.POINTER(ctypes.c_uint8) * nfields)()
    str_offsets = (ctypes.POINTER(ctypes.c_int32) * nfields)()
    str_data = (ctypes.POINTER(ctypes.c_uint8) * nfields)()
    str_cap = np.zeros(nfields, dtype=np.int64)
    results: list = [None] * nfields
    n_strings = sum(1 for c, _ in field_specs if c == CODE_STRING)
    # the string fields' bytes together fit in the payload, but one field
    # may own almost all of it: an even share first, the whole payload on
    # the one retry an overflow (rc -2) asks for
    cap = max(64, len(payload) // max(n_strings, 1) + 1024)
    for attempt in range(2):
        for f, (code, _) in enumerate(field_specs):
            validity = np.empty(count, dtype=np.uint8)
            valid_out[f] = validity.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
            if code == CODE_STRING:
                offsets = np.empty(count + 1, dtype=np.int32)
                data = np.empty(cap, dtype=np.uint8)
                str_offsets[f] = offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
                str_data[f] = data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
                str_cap[f] = cap
                results[f] = (offsets, data, validity)
            else:
                values = np.empty(count, dtype=_NUMERIC_DTYPES[code])
                num_out[f] = values.ctypes.data_as(ctypes.c_void_p)
                results[f] = (values, validity)
        rc = lib.decode_block(
            payload,
            ctypes.c_size_t(len(payload)),
            ctypes.c_int64(count),
            ctypes.c_int(nfields),
            type_codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            nullable.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            num_out,
            valid_out,
            str_offsets,
            str_data,
            str_cap.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if rc == 0:
            return results
        if rc == -2 and attempt == 0:
            cap = max(64, len(payload))
            continue
        break
    raise ValueError(f"malformed avro block ({count} records, {len(payload)} bytes)")


def avro_encoder(count: int, field_specs: list[tuple[int, bool]], columns: list) -> bytes:
    """Encode one Avro block body. `columns` mirrors avro_decoder's results:
    numeric/bool (values, validity or None); string (int32 offsets, uint8
    data, validity or None)."""
    lib = avro_library()
    nfields = len(field_specs)
    type_codes, nullable = _specs(field_specs)
    num_in = (ctypes.c_void_p * nfields)()
    valid_in = (ctypes.POINTER(ctypes.c_uint8) * nfields)()
    str_offsets = (ctypes.POINTER(ctypes.c_int32) * nfields)()
    str_data = (ctypes.POINTER(ctypes.c_uint8) * nfields)()
    keep = []
    cap = 64
    for f, (code, _) in enumerate(field_specs):
        if code == CODE_STRING:
            offsets, data, validity = columns[f]
            offsets = np.ascontiguousarray(offsets, dtype=np.int32)
            data = np.ascontiguousarray(data, dtype=np.uint8)
            keep.extend([offsets, data])
            str_offsets[f] = offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
            str_data[f] = data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
            cap += len(data) + count * 12
        else:
            values, validity = columns[f]
            values = np.ascontiguousarray(values, dtype=_NUMERIC_DTYPES[code])
            keep.append(values)
            num_in[f] = values.ctypes.data_as(ctypes.c_void_p)
            cap += count * 12
        if validity is None:
            valid_in[f] = ctypes.cast(None, ctypes.POINTER(ctypes.c_uint8))
        else:
            v = np.ascontiguousarray(validity, dtype=np.uint8)
            keep.append(v)
            valid_in[f] = v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    out = np.empty(cap, dtype=np.uint8)
    n = lib.encode_block(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_size_t(cap),
        ctypes.c_int64(count),
        ctypes.c_int(nfields),
        type_codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nullable.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        num_in,
        valid_in,
        str_offsets,
        str_data,
    )
    if n < 0:  # the capacity bounds every row's bytes: unreachable
        raise ValueError(f"avro block encoder ran out of its {cap}-byte buffer")
    return out[:n].tobytes()
