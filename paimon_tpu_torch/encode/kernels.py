"""Vectorized Parquet page-encode kernels (port of
paimon_tpu/encode/kernels.py), the write-side duals of decode/kernels.py.

Run boundaries come from one np.diff pass and the values of every run,
miniblock and page pack through one numpy expression. The numpy forms are
the default engine; `pack_bits_torch` is the torch form of the JAX
package's XLA program `pack_bits_jax`, run on the device of its input, and
`set_encode_engine("torch", device)` routes the bit-packing of dictionary
codes and levels through it. The tests hold both engines to each other and
to the JAX twin.

  * pack_bits / pack_bits_torch — LSB-first bit-packing
  * encode_rle_hybrid     — parquet's <bit-packed|RLE> hybrid runs: runs of
                            8 or more become RLE, the rest bit-packed spans
                            of whole groups of 8
  * encode_plain / encode_plain_byte_array — PLAIN
  * byte_array_parts      — str/bytes vector -> (lengths, payload)
  * encode_delta_binary_packed — DELTA_BINARY_PACKED int32/int64
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..decode.container import PLAIN_DTYPES, T_BOOLEAN, T_INT32, T_INT64, ParquetFormatError
from ..format.thrift import append_uvarint, zigzag_encode
from ..utils import resolve_device

__all__ = [
    "encode_engine",
    "set_encode_engine",
    "pack_bits",
    "pack_bits_torch",
    "encode_rle_hybrid",
    "encode_plain",
    "encode_plain_byte_array",
    "byte_array_parts",
    "encode_delta_binary_packed",
    "bit_width_for",
]

# "numpy" (the default) or "torch": which engine packs bit streams of up to
# 32 bits; _DEVICE is the torch engine's device
_ENGINE = "numpy"
_DEVICE = torch.device("cpu")


def encode_engine() -> str:
    return _ENGINE


def set_encode_engine(name: str, device: "str | torch.device" = "cuda") -> None:
    """Select the encode engine; the torch engine runs on `device` (CUDA
    unless the caller asks for the CPU, which raises without a card)."""
    global _ENGINE, _DEVICE
    if name not in ("numpy", "torch"):
        raise ValueError(f"encode engine must be 'numpy' or 'torch', got {name!r}")
    if name == "torch":
        _DEVICE = resolve_device(device)
    _ENGINE = name


def bit_width_for(max_value: int) -> int:
    """Bits needed for unsigned values up to max_value (0 for a single-entry
    domain, the dictionary-index convention)."""
    return int(max_value).bit_length()


# ---- bit packing ---------------------------------------------------------


def pack_bits(values: np.ndarray, bit_width: int) -> bytes:
    """LSB-first pack of unsigned values into bytes (the inverse of
    decode.kernels.unpack_bits); the last byte pads with zero bits."""
    count = len(values)
    if count == 0 or bit_width == 0:
        return b""
    if bit_width > 64:
        raise ParquetFormatError(f"bit width {bit_width}")
    if bit_width % 8 == 0:
        # a byte-aligned width is the value's little-endian bytes, truncated
        v = np.ascontiguousarray(values, dtype="<u8")
        return v.view(np.uint8).reshape(count, 8)[:, : bit_width >> 3].tobytes()
    if _ENGINE == "torch" and bit_width <= 32:
        t = torch.from_numpy(np.ascontiguousarray(values, dtype=np.int64)).to(_DEVICE)
        return pack_bits_torch(t, bit_width).cpu().numpy().tobytes()
    v = np.ascontiguousarray(values, dtype=np.uint64)
    bits = ((v[:, None] >> np.arange(bit_width, dtype=np.uint64)) & np.uint64(1)).astype(np.uint8)
    return np.packbits(bits.reshape(-1), bitorder="little").tobytes()


def pack_bits_torch(values: torch.Tensor, bit_width: int) -> torch.Tensor:
    """The torch form of `pack_bits_jax`: non-negative integer values ->
    ceil(count * bit_width / 8) packed uint8 bytes, on the device of
    `values`. Width at most 32."""
    if bit_width > 32:
        raise ParquetFormatError(f"bit width {bit_width}")
    dev = values.device
    if bit_width == 0 or values.numel() == 0:
        return torch.zeros(0, dtype=torch.uint8, device=dev)
    v = values.to(torch.int64)
    bits = ((v[:, None] >> torch.arange(bit_width, dtype=torch.int64, device=dev)) & 1).to(torch.uint8).reshape(-1)
    pad = (-bits.numel()) % 8
    if pad:
        bits = torch.cat([bits, torch.zeros(pad, dtype=torch.uint8, device=dev)])
    weights = torch.ones(1, dtype=torch.int32, device=dev) << torch.arange(8, dtype=torch.int32, device=dev)
    return (bits.reshape(-1, 8).to(torch.int32) * weights).sum(dim=1).to(torch.uint8)


# ---- RLE / bit-packed hybrid --------------------------------------------

_MIN_RLE_RUN = 8


def encode_rle_hybrid(values: np.ndarray, bit_width: int) -> bytes:
    """Non-negative integers -> parquet's hybrid run stream. The loop runs
    over the runs long enough to become RLE only; a bit-packed span before
    an RLE run borrows that run's first values to fill whole groups of 8,
    so the reader never misaligns."""
    n = len(values)
    out = bytearray()
    if n == 0:
        return b""
    if bit_width == 0:  # single-entry domain: one RLE run, no value bytes
        append_uvarint(out, n << 1)
        return bytes(out)
    v = np.ascontiguousarray(values, dtype=np.int64)
    byte_w = (bit_width + 7) >> 3
    change = np.flatnonzero(v[1:] != v[:-1]) + 1
    starts = np.concatenate([np.zeros(1, dtype=np.int64), change])
    lengths = np.diff(np.append(starts, n))
    long_runs = np.flatnonzero(lengths >= _MIN_RLE_RUN)
    mask = (1 << (8 * byte_w)) - 1

    def flush_bitpack(lo: int, hi: int) -> None:
        if hi <= lo:
            return
        groups = (hi - lo + 7) >> 3
        append_uvarint(out, (groups << 1) | 1)
        vals = v[lo:hi]
        if len(vals) < groups * 8:  # a group always carries 8 values' bits
            vals = np.concatenate([vals, np.zeros(groups * 8 - len(vals), dtype=np.int64)])
        out.extend(pack_bits(vals, bit_width))

    pos = 0
    for ri in long_runs:
        rs, rl = int(starts[ri]), int(lengths[ri])
        borrow = (-(rs - pos)) % 8
        if rl - borrow < _MIN_RLE_RUN:
            continue  # too short once aligned: stays in the pending span
        flush_bitpack(pos, rs + borrow)
        append_uvarint(out, (rl - borrow) << 1)
        out += (int(v[rs]) & mask).to_bytes(byte_w, "little")
        pos = rs + rl
    flush_bitpack(pos, n)
    return bytes(out)


# ---- PLAIN ---------------------------------------------------------------


def encode_plain(values: np.ndarray, physical: int) -> bytes:
    if physical in PLAIN_DTYPES:
        return np.ascontiguousarray(values, dtype=PLAIN_DTYPES[physical]).tobytes()
    if physical == T_BOOLEAN:
        return np.packbits(np.ascontiguousarray(values, dtype=np.bool_), bitorder="little").tobytes()
    raise ParquetFormatError(f"PLAIN encode physical type {physical}")


def encode_plain_byte_array(lengths: np.ndarray, payload: bytes) -> bytes:
    """(lengths, concatenated payload) -> the PLAIN BYTE_ARRAY stream of
    u32 length-prefixed values, built with one vectorized scatter."""
    n = len(lengths)
    if n == 0:
        return b""
    lens = np.ascontiguousarray(lengths, dtype=np.int64)
    if n > 1 and int(lens.min()) == int(lens.max()):
        w = int(lens[0])  # uniform lengths: one reshape, no scatter
        out = np.empty((n, 4 + w), dtype=np.uint8)
        out[:, :4] = np.frombuffer(struct.pack("<I", w), dtype=np.uint8)
        if w:
            out[:, 4:] = np.frombuffer(payload, dtype=np.uint8).reshape(n, w)
        return out.tobytes()
    out = np.zeros(int(lens.sum()) + 4 * n, dtype=np.uint8)
    src_starts = np.concatenate([np.zeros(1, dtype=np.int64), np.cumsum(lens)[:-1]])
    len_pos = src_starts + 4 * np.arange(n, dtype=np.int64)
    out[(len_pos[:, None] + np.arange(4, dtype=np.int64)).reshape(-1)] = lens.astype("<u4").view(np.uint8)
    src = np.frombuffer(payload, dtype=np.uint8)
    if len(src):
        value_id = np.repeat(np.arange(n, dtype=np.int64), lens)
        out[np.arange(len(src), dtype=np.int64) + 4 * (value_id + 1)] = src
    return out.tobytes()


def byte_array_parts(values: np.ndarray) -> tuple[np.ndarray, bytes]:
    """A str/bytes object vector -> (byte lengths, concatenated payload).
    Pure-ASCII strings take a fixed-width code-point matrix; others encode
    one by one."""
    n = len(values)
    if n == 0:
        return np.zeros(0, dtype=np.int64), b""
    if isinstance(values[0], str):
        try:
            u = np.asarray(values, dtype=np.str_)
            k = u.dtype.itemsize // 4
            if k == 0:
                return np.zeros(n, dtype=np.int64), b""
            if k <= 4096:
                mat = np.ascontiguousarray(u).view(np.uint32).reshape(n, k)
                lens = (k - (mat[:, ::-1] != 0).argmax(axis=1)).astype(np.int64)
                lens[~(mat != 0).any(axis=1)] = 0
                # a trailing U+0000 would be lost: the total length tells
                if int(mat.max()) < 128 and int(lens.sum()) == sum(map(len, values)):
                    return lens, mat[np.arange(k) < lens[:, None]].astype(np.uint8).tobytes()
        except (TypeError, ValueError):
            pass
    encoded = [x.encode("utf-8") if isinstance(x, str) else bytes(x) for x in values]
    return np.fromiter(map(len, encoded), dtype=np.int64, count=n), b"".join(encoded)


# ---- DELTA_BINARY_PACKED -------------------------------------------------

_DELTA_BLOCK = 1024  # a multiple of 128
_DELTA_MINI = 4  # miniblocks per block, 256 values each


def _bit_widths(values: np.ndarray) -> np.ndarray:
    """Bits needed for each uint64 value (0 for 0)."""
    widths = np.zeros(len(values), dtype=np.int64)
    v = values.copy()
    while v.any():
        nz = v != 0
        widths += nz
        v >>= np.uint64(1)
    return widths


def _pack_rows(rows: np.ndarray, bit_width: int) -> np.ndarray:
    """(k, per_row) uint64 values -> (k, per_row * bit_width / 8) packed
    bytes, LSB first (the miniblocks of one width at once)."""
    k, per_row = rows.shape
    le = np.ascontiguousarray(rows, dtype="<u8").view(np.uint8).reshape(k, per_row, 8)
    bits = np.unpackbits(le, axis=2, bitorder="little")[:, :, :bit_width]
    return np.packbits(bits.reshape(k, per_row * bit_width), axis=1, bitorder="little")


def encode_delta_binary_packed(values: np.ndarray, physical: int) -> bytes:
    """DELTA_BINARY_PACKED int32/int64 (the inverse of the decode kernel):
    wrap-around uint64 deltas, one signed min per block subtracted, each
    miniblock packed at its own width. The mins, widths and the miniblocks
    of each width are computed for all blocks at once; the loop over blocks
    only joins their bytes."""
    if physical not in (T_INT32, T_INT64):
        raise ParquetFormatError("DELTA_BINARY_PACKED on a non-integer column")
    v = np.ascontiguousarray(values, dtype=np.int64)
    n = len(v)
    out = bytearray()
    per = _DELTA_BLOCK // _DELTA_MINI
    append_uvarint(out, _DELTA_BLOCK)
    append_uvarint(out, _DELTA_MINI)
    append_uvarint(out, n)
    append_uvarint(out, zigzag_encode(int(v[0]) if n else 0))
    if n <= 1:
        return bytes(out)
    u = v.view(np.uint64)
    deltas = u[1:] - u[:-1]  # wrap-around uint64
    nd = len(deltas)
    blocks = -(-nd // _DELTA_BLOCK)
    signed = np.full(blocks * _DELTA_BLOCK, np.iinfo(np.int64).max, dtype=np.int64)
    signed[:nd] = deltas.view(np.int64)
    mins = signed.reshape(blocks, _DELTA_BLOCK).min(axis=1)
    # miniblocks holding deltas: adjusted by their block's min, the tail of
    # the last one padded with zeros
    n_minis = -(-nd // per)
    adj = np.zeros(n_minis * per, dtype=np.uint64)
    adj[:nd] = deltas - mins.view(np.uint64).repeat(_DELTA_BLOCK)[:nd]
    adj = adj.reshape(n_minis, per)
    widths = _bit_widths(adj.max(axis=1))
    packed: list = [b""] * n_minis
    for w in np.unique(widths):
        if w:
            rows = np.flatnonzero(widths == w)
            for r, b in zip(rows.tolist(), _pack_rows(adj[rows], int(w))):
                packed[r] = b.tobytes()
    for b in range(blocks):
        append_uvarint(out, zigzag_encode(int(mins[b])))
        lo, hi = b * _DELTA_MINI, min((b + 1) * _DELTA_MINI, n_minis)
        out += bytes(widths[lo:hi].tolist()) + bytes(_DELTA_MINI - (hi - lo))
        for p in packed[lo:hi]:
            out += p
    return bytes(out)
