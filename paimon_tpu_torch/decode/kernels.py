"""Vectorized Parquet page-decode kernels (port of
paimon_tpu/decode/kernels.py).

Run headers parse in a thin Python loop (runs are few); the values of every
run, miniblock and page expand through one numpy expression. The numpy
forms are the default engine; `unpack_bits_torch` and `gather_torch` are
the torch forms of the JAX package's XLA programs `unpack_bits_jax` and
`gather_jax`, run on the device of their input. `set_decode_engine("torch",
device)` routes the bit-unpacking of RLE/bit-packed runs and the gathers of
fixed-width dictionaries through them; the tests hold both engines to each
other and to the JAX twins.

  * unpack_bits / unpack_bits_torch — LSB-first bit-unpacking
  * decode_rle_hybrid   — parquet's <bit-packed|RLE> hybrid runs
                          (definition levels and dictionary indices)
  * decode_plain        — PLAIN for the six physical types
  * decode_delta_binary_packed — DELTA_BINARY_PACKED int32/int64
  * gather / gather_torch — dictionary expansion
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..format.thrift import read_varint, zigzag
from ..utils import resolve_device
from .container import PLAIN_DTYPES, T_BOOLEAN, T_BYTE_ARRAY, T_INT32, T_INT64, ParquetFormatError

__all__ = [
    "decode_engine",
    "set_decode_engine",
    "unpack_bits",
    "unpack_bits_torch",
    "decode_rle_hybrid",
    "decode_plain",
    "decode_byte_array",
    "decode_delta_binary_packed",
    "gather",
    "gather_torch",
]

# "numpy" (the default) or "torch": which engine unpacks bit-packed runs
# and gathers fixed-width dictionaries; _DEVICE is the torch engine's device
_ENGINE = "numpy"
_DEVICE = torch.device("cpu")


def decode_engine() -> str:
    return _ENGINE


def set_decode_engine(name: str, device: "str | torch.device" = "cuda") -> None:
    """Select the decode engine; the torch engine runs on `device` (CUDA
    unless the caller asks for the CPU, which raises without a card)."""
    global _ENGINE, _DEVICE
    if name not in ("numpy", "torch"):
        raise ValueError(f"decode engine must be 'numpy' or 'torch', got {name!r}")
    if name == "torch":
        _DEVICE = resolve_device(device)
    _ENGINE = name


# ---- bit unpacking -------------------------------------------------------


def _read_bits(data: np.ndarray, bit_offsets: np.ndarray, widths) -> np.ndarray:
    """The unsigned values of `widths` bits (a scalar or one per value, up to
    64) that start at `bit_offsets` of the LSB-first stream `data`: each
    value is one 8-byte little-endian window read at its first byte,
    shifted, and topped up from the ninth byte when it spills over."""
    padded = np.zeros(len(data) + 9, dtype=np.uint8)
    padded[: len(data)] = data
    # the 8-byte little-endian word starting at every byte of the stream
    words = np.ascontiguousarray(np.lib.stride_tricks.sliding_window_view(padded, 8)).view("<u8").ravel()
    first = bit_offsets >> 3
    shift = (bit_offsets & 7).astype(np.uint64)
    out = words[first] >> shift
    spill = padded[first + 8].astype(np.uint64) << ((np.uint64(64) - shift) & np.uint64(63))
    out |= np.where(shift > 0, spill, np.uint64(0))
    w = np.asarray(widths, dtype=np.uint64)
    mask = np.where(w >= 64, np.uint64(0xFFFFFFFFFFFFFFFF), (np.uint64(1) << (w & np.uint64(63))) - np.uint64(1))
    return out & mask


def unpack_bits(data: np.ndarray, bit_width: int, count: int) -> np.ndarray:
    """`count` LSB-first packed unsigned values of `bit_width` bits -> int64."""
    if count == 0:
        return np.empty(0, dtype=np.int64)
    if bit_width == 0:
        return np.zeros(count, dtype=np.int64)
    if bit_width > 32:
        raise ParquetFormatError(f"bit width {bit_width}")
    data = np.ascontiguousarray(data, dtype=np.uint8)
    need = count * bit_width
    if len(data) * 8 < need:
        raise ParquetFormatError(f"bit stream too short: {len(data) * 8} < {need}")
    if bit_width in (8, 16, 32):  # byte-aligned widths: a view
        return data[: need >> 3].view(f"<u{bit_width >> 3}").astype(np.int64)
    if bit_width < 8:  # narrow values: the bit matrix is the cheaper pass
        bits = np.unpackbits(data, bitorder="little")[:need].reshape(count, bit_width)
        return bits.astype(np.int64) @ np.left_shift(np.int64(1), np.arange(bit_width, dtype=np.int64))
    offsets = np.arange(count, dtype=np.int64) * bit_width
    return _read_bits(data, offsets, bit_width).astype(np.int64)


def unpack_bits_torch(data: torch.Tensor, bit_width: int, count: int) -> torch.Tensor:
    """The torch form of `unpack_bits_jax`: a uint8 tensor of packed bytes
    -> `count` int64 values, on the device of `data`. Width at most 32."""
    dev = data.device
    if bit_width == 0 or count == 0:
        return torch.zeros(count, dtype=torch.int64, device=dev)
    if bit_width > 32:
        raise ParquetFormatError(f"bit width {bit_width}")
    if data.numel() * 8 < count * bit_width:
        raise ParquetFormatError(f"bit stream too short: {data.numel() * 8} < {count * bit_width}")
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    bits = ((data.to(torch.uint8)[:, None] >> shifts) & 1).reshape(-1)[: count * bit_width]
    weights = torch.ones(1, dtype=torch.int64, device=dev) << torch.arange(bit_width, dtype=torch.int64, device=dev)
    return (bits.reshape(count, bit_width).to(torch.int64) * weights).sum(dim=1)


def _unpack(buf, pos: int, nbytes: int, bit_width: int, count: int) -> np.ndarray:
    raw = np.frombuffer(buf, dtype=np.uint8, count=nbytes, offset=pos)
    if _ENGINE == "torch" and bit_width:
        return unpack_bits_torch(torch.from_numpy(raw.copy()).to(_DEVICE), bit_width, count).cpu().numpy()
    return unpack_bits(raw, bit_width, count)


# ---- RLE / bit-packed hybrid --------------------------------------------


def decode_rle_hybrid(buf, pos: int, end: int, bit_width: int, count: int) -> np.ndarray:
    """Parquet's RLE/bit-packed hybrid run stream -> `count` int64 values.
    The loop only parses run headers; the bit-packed runs, whose bytes are
    whole groups of 8 values, unpack together in one call, and the RLE
    runs fill the rows between them in one repeat."""
    out = np.empty(count, dtype=np.int64)
    filled = 0
    byte_w = (bit_width + 7) >> 3
    packed: list = []  # (byte offset, byte count, first row, rows) per bit-packed run
    rle_rows: list = []
    rle_values: list = []
    while filled < count:
        if pos >= end:
            raise ParquetFormatError(f"RLE stream exhausted at {filled}/{count} values")
        header, pos = read_varint(buf, pos)
        if header & 1:  # bit-packed: (header >> 1) groups of 8 values
            groups = header >> 1
            nbytes = groups * bit_width
            take = min(groups * 8, count - filled)
            packed.append((pos, nbytes, filled, take))
            pos += nbytes
        else:  # RLE: one value repeated (header >> 1) times
            take = min(header >> 1, count - filled)
            rle_rows.append(take)
            rle_values.append(int.from_bytes(bytes(buf[pos : pos + byte_w]), "little") if byte_w else 0)
            pos += byte_w
        filled += take
    if not packed:
        return np.repeat(np.asarray(rle_values, dtype=np.int64), rle_rows)
    if len(packed) == 1 and not rle_rows:
        p, nbytes, _, take = packed[0]
        return _unpack(buf, p, nbytes, bit_width, take + (-take % 8))[:take]
    # only the stream's last run can stop short of its groups, so the
    # concatenated runs' first sum(rows) values are the packed rows in order
    data = b"".join(bytes(buf[p : p + nb]) for p, nb, _, _ in packed)
    rows = sum(take for _, _, _, take in packed)
    vals = _unpack(data, 0, len(data), bit_width, len(data) * 8 // bit_width)[:rows] if bit_width else np.zeros(rows, np.int64)
    if not rle_rows:
        return vals
    edges = np.zeros(count + 1, dtype=np.int64)
    starts = np.array([r for _, _, r, _ in packed], dtype=np.int64)
    np.add.at(edges, starts, 1)
    np.add.at(edges, starts + np.array([t for _, _, _, t in packed], dtype=np.int64), -1)
    is_packed = np.cumsum(edges[:-1]) > 0
    out[is_packed] = vals
    out[~is_packed] = np.repeat(np.asarray(rle_values, dtype=np.int64), rle_rows)
    return out


# ---- PLAIN ---------------------------------------------------------------


def decode_plain(buf, pos: int, physical: int, count: int, utf8: bool) -> np.ndarray:
    if physical in PLAIN_DTYPES:
        return np.frombuffer(buf, dtype=PLAIN_DTYPES[physical], count=count, offset=pos)
    if physical == T_BOOLEAN:
        raw = np.frombuffer(buf, dtype=np.uint8, count=(count + 7) >> 3, offset=pos)
        return np.unpackbits(raw, bitorder="little")[:count].astype(np.bool_)
    if physical == T_BYTE_ARRAY:
        return decode_byte_array(buf, pos, count, utf8)[0]
    raise ParquetFormatError(f"PLAIN physical type {physical}")


def decode_byte_array(buf, pos: int, count: int, utf8: bool) -> tuple[np.ndarray, np.ndarray]:
    """PLAIN BYTE_ARRAY: (u32 length, payload) pairs -> (object values,
    int64 byte lengths). A stream whose values all have the first one's
    length (fixed-width business keys) is one reshape; others walk the
    pairs one by one, as the format forces."""
    if count > 1 and pos + 4 <= len(buf):
        n0 = struct.unpack_from("<I", buf, pos)[0]
        width = 4 + n0
        if n0 and pos + count * width <= len(buf):
            mat = np.frombuffer(buf, dtype=np.uint8, count=count * width, offset=pos).reshape(count, width)
            # every length field equal (so every value is n0 bytes, by
            # induction) and no value ending in NUL, which the S dtype drops
            if (np.ascontiguousarray(mat[:, :4]).view("<u4").ravel() == n0).all() and mat[:, -1].all():
                body = np.ascontiguousarray(mat[:, 4:])
                payload = body.view(f"S{n0}").ravel()
                if not utf8:
                    values = payload
                elif int(body.max()) < 128:  # ASCII: a C cast, no codec
                    values = payload.astype(f"U{n0}")
                else:
                    values = np.char.decode(payload, "utf-8")
                return values.astype(object), np.full(count, n0, dtype=np.int64)
    out = np.empty(count, dtype=object)
    lengths = [0] * count
    mv = memoryview(buf)
    unpack = struct.Struct("<I").unpack_from
    for i in range(count):
        (n,) = unpack(mv, pos)
        pos += 4
        raw = bytes(mv[pos : pos + n])
        out[i] = raw.decode("utf-8") if utf8 else raw
        lengths[i] = n
        pos += n
    return out, np.array(lengths, dtype=np.int64)


# ---- DELTA_BINARY_PACKED -------------------------------------------------


def decode_delta_binary_packed(buf, pos: int, count: int, physical: int) -> np.ndarray:
    """DELTA_BINARY_PACKED int32/int64: bit-packed miniblocks of deltas,
    then first value + wrap-around uint64 prefix sum. The headers parse in
    a loop over blocks; the deltas of every miniblock then unpack at once."""
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
    need = n - 1
    # one pass over the block headers: each block's min delta and where its
    # miniblock widths sit; a block's bytes are its widths' sum x per_mini / 8
    n_blocks = -(-need // block_size)
    data = buf if isinstance(buf, bytes) else bytes(buf)
    min_list, at_list = [], []
    for _ in range(n_blocks):
        v, pos = read_varint(data, pos)
        min_list.append(zigzag(v) & 0xFFFFFFFFFFFFFFFF)
        at_list.append(pos)
        end = pos + n_mini
        pos = end + ((sum(data[pos:end]) * per_mini) >> 3)
    mins = np.array(min_list, dtype=np.uint64)
    width_at = np.array(at_list, dtype=np.int64)
    deltas = np.zeros(0, dtype=np.uint64)
    if need:
        raw = np.frombuffer(data, dtype=np.uint8)
        widths = raw[width_at[:, None] + np.arange(n_mini, dtype=np.int64)].astype(np.int64)
        sizes = (widths * per_mini) >> 3
        offsets = (width_at + n_mini)[:, None] + np.cumsum(sizes, axis=1) - sizes
        # every delta's miniblock width and bit offset in the buffer
        ws = widths.reshape(-1).repeat(per_mini)[:need]
        starts = offsets.reshape(-1).repeat(per_mini)[:need] * 8
        starts += np.tile(np.arange(per_mini, dtype=np.int64), n_blocks * n_mini)[:need] * ws
        deltas = mins.repeat(block_size)[:need]
        packed = np.flatnonzero(ws)  # width-0 miniblocks hold their min alone
        if len(packed):
            deltas[packed] += _read_bits(raw, starts[packed], ws[packed])
    out = np.empty(n, dtype=np.uint64)
    out[0] = np.uint64(first & 0xFFFFFFFFFFFFFFFF)
    out[1:] = out[0] + np.cumsum(deltas, dtype=np.uint64)
    if physical == T_INT32:
        return (out & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    return out.view(np.int64)


# ---- dictionary expansion ------------------------------------------------


def gather_torch(dictionary: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """The torch form of `gather_jax`: dictionary[codes] on the device of
    the codes."""
    return dictionary.to(codes.device).index_select(0, codes.to(torch.int64))


def gather(dictionary: np.ndarray, codes: np.ndarray) -> np.ndarray:
    """dictionary[codes]. Fixed-width dictionaries go through the configured
    engine; object dictionaries (strings) always gather on the host."""
    if _ENGINE == "torch" and dictionary.dtype != np.dtype(object) and dictionary.dtype.kind != "b":
        d = torch.from_numpy(np.ascontiguousarray(dictionary))
        c = torch.from_numpy(np.ascontiguousarray(codes, dtype=np.int64)).to(_DEVICE)
        return gather_torch(d, c).cpu().numpy()
    return dictionary.take(codes)
