"""Per-file bloom indexes in the PTIX container, and the column hashes for
bucket routing (port of paimon_tpu/format/fileindex.py).

Both packages must give the same 64 bits for the same value: a key that
one package routes to a bucket is routed there by the other too, and a
bloom one package writes prunes in the other. Numbers hash their int64
image (floats their float64 image, with -0.0 made 0.0 first); strings and
bytes hash crc32 | adler32 << 32 of their UTF-8 bytes; every image then
goes through splitmix64.

Container layout (embedded in the manifest entry below
file-index.in-manifest-threshold, else one `<data file>.index` sidecar):
  [4 bytes magic "PTIX"] [4 bytes header length, little-endian] [JSON header] [bitmap blobs]
  header = {"columns": {name: {"type": "bloom", "offset": o, "length": l,
                               "numHashFunctions": k, "numBits": m}}}
The composite primary-key bloom rides under the pseudo column "__KEY__"
with "key": true: one bloom over table/bucket.py key_hashes, which the
batched gets prune files by. The bytes are the JAX package's, bit for
bit: the header is the same json.dumps, the blooms the same bits.
"""

from __future__ import annotations

import json
import math
import struct
import zlib
from typing import Sequence

import numpy as np

from ..data.batch import ColumnBatch
from ..data.predicate import CompoundPredicate, LeafPredicate, Predicate

__all__ = [
    "_splitmix64",
    "_hash64",
    "BloomFilter",
    "build_index_payload",
    "write_file_index",
    "FileIndexPredicate",
    "index_path",
    "KEY_INDEX_NAME",
    "resolve_key_bloom",
]

_MAGIC = b"PTIX"
KEY_INDEX_NAME = "__KEY__"


def resolve_key_bloom(enabled: bool | str | None) -> bool:
    """file-index.bloom-filter.primary-key.enabled as a bool (default off)."""
    if enabled is None:
        return False
    if isinstance(enabled, str):
        return enabled.strip().lower() in ("1", "on", "true")
    return bool(enabled)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)).astype(np.uint64)
    x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)).astype(np.uint64)
    return x ^ (x >> np.uint64(31))


def _hash64(values: np.ndarray) -> np.ndarray:
    """(n,) uint64 hashes of a column's values (validity is not looked at)."""
    if values.dtype == np.dtype(object):
        out = np.empty(len(values), dtype=np.uint64)
        for i, v in enumerate(values):
            b = v.encode("utf-8") if isinstance(v, str) else (v if isinstance(v, bytes) else str(v).encode())
            out[i] = (zlib.crc32(b) | (np.uint64(zlib.adler32(b)) << np.uint64(32))) & np.uint64(0xFFFFFFFFFFFFFFFF)
        return _splitmix64(out)
    if values.dtype.kind == "f":
        values = values + 0.0  # -0.0 hashes as 0.0
        values = values.astype(np.float64).view(np.uint64)
    else:
        values = values.astype(np.int64).view(np.uint64)
    return _splitmix64(values)


def _hash_scalar(v) -> np.uint64:
    if isinstance(v, (str, bytes)):
        arr = np.empty(1, dtype=object)
        arr[0] = v
        return _hash64(arr)[0]
    if isinstance(v, float):
        return _hash64(np.array([v], dtype=np.float64))[0]
    if isinstance(v, bool):
        return _hash64(np.array([int(v)], dtype=np.int64))[0]
    return _hash64(np.array([v], dtype=np.int64))[0]


class BloomFilter:
    """A k-hash bloom over double hashing h1 + i*h2, vectorised over a
    batch of hashes."""

    def __init__(self, num_bits: int, num_hashes: int, bits: np.ndarray | None = None):
        self.num_bits = num_bits
        self.num_hashes = num_hashes
        nwords = (num_bits + 63) // 64
        self.words = bits if bits is not None else np.zeros(nwords, dtype=np.uint64)

    @staticmethod
    def for_items(n: int, fpp: float) -> "BloomFilter":
        n = max(n, 1)
        m = max(1024, int(-n * math.log(fpp) / (math.log(2) ** 2)))
        k = max(1, min(20, round(-math.log(fpp) / math.log(2))))
        return BloomFilter(m, k)

    def _positions(self, hashes: np.ndarray) -> np.ndarray:
        h1 = hashes & np.uint64(0xFFFFFFFF)
        h2 = hashes >> np.uint64(32)
        i = np.arange(self.num_hashes, dtype=np.uint64)
        combined = h1[:, None] + i[None, :] * h2[:, None]
        return (combined % np.uint64(self.num_bits)).astype(np.uint64)

    def add_hashes(self, hashes: np.ndarray) -> None:
        pos = self._positions(hashes).ravel()
        np.bitwise_or.at(self.words, (pos >> np.uint64(6)).astype(np.int64), np.uint64(1) << (pos & np.uint64(63)))

    def might_contain_hashes(self, hashes: np.ndarray) -> np.ndarray:
        pos = self._positions(hashes)
        word = self.words[(pos >> np.uint64(6)).astype(np.int64)]
        bit = (word >> (pos & np.uint64(63))) & np.uint64(1)
        return bit.all(axis=1)

    def might_contain(self, value) -> bool:
        return bool(self.might_contain_hashes(np.array([_hash_scalar(value)], dtype=np.uint64))[0])

    def to_bytes(self) -> bytes:
        return self.words.tobytes()

    @staticmethod
    def from_bytes(data: bytes, num_bits: int, num_hashes: int) -> "BloomFilter":
        return BloomFilter(num_bits, num_hashes, np.frombuffer(data, dtype=np.uint64).copy())


def index_path(data_file_path: str) -> str:
    return data_file_path + ".index"


def build_index_payload(
    batch: ColumnBatch,
    columns: Sequence[str],
    fpp: float = 0.05,
    key_hashes: np.ndarray | None = None,
    key_fpp: float = 0.001,
) -> bytes | None:
    """The PTIX bytes for `columns` (and the composite key bloom over
    `key_hashes`, at the tighter key_fpp: a get batch probes many keys per
    file), or None when there is nothing to index. The caller places them:
    embedded in the manifest entry or in a sidecar."""
    cols = [c for c in columns if c in batch.schema]
    if (not cols and key_hashes is None) or batch.num_rows == 0:
        return None
    header: dict = {"columns": {}}
    blobs: list[bytes] = []
    offset = 0

    def add(name: str, bf: BloomFilter, extra: dict | None = None) -> None:
        nonlocal offset
        blob = bf.to_bytes()
        header["columns"][name] = {
            "type": "bloom",
            "offset": offset,
            "length": len(blob),
            "numHashFunctions": bf.num_hashes,
            "numBits": bf.num_bits,
            **(extra or {}),
        }
        blobs.append(blob)
        offset += len(blob)

    for name in cols:
        col = batch.column(name)
        values = col.values[col.valid_mask()]
        bf = BloomFilter.for_items(len(values), fpp)
        if len(values):
            bf.add_hashes(_hash64(values))
        add(name, bf)
    if key_hashes is not None and len(key_hashes):
        bf = BloomFilter.for_items(len(key_hashes), key_fpp)
        bf.add_hashes(np.asarray(key_hashes, dtype=np.uint64))
        add(KEY_INDEX_NAME, bf, {"key": True})
    hdr = json.dumps(header).encode()
    return _MAGIC + struct.pack("<I", len(hdr)) + hdr + b"".join(blobs)


def write_file_index(file_io, data_file_path: str, batch: ColumnBatch, columns: Sequence[str], fpp: float = 0.05):
    """Bloom indexes for `columns` of one data file as its sidecar; returns
    the sidecar's path, or None when nothing was indexed."""
    payload = build_index_payload(batch, columns, fpp)
    if payload is None:
        return None
    path = index_path(data_file_path)
    file_io.write_bytes(path, payload, overwrite=True)
    return path


class FileIndexPredicate:
    """A file's PTIX index, tested against a predicate: False means the
    file provably holds no matching row."""

    def __init__(self, file_io, idx_path: str):
        self._load(file_io.read_bytes(idx_path))

    def _load(self, data: bytes) -> None:
        if data[:4] != _MAGIC:
            raise ValueError("bad index magic")
        (hlen,) = struct.unpack("<I", data[4:8])
        self.header = json.loads(data[8 : 8 + hlen])
        self.blob = data[8 + hlen :]

    @classmethod
    def from_bytes(cls, data: bytes) -> "FileIndexPredicate":
        self = cls.__new__(cls)
        self._load(data)
        return self

    def _bloom(self, name: str) -> BloomFilter | None:
        meta = self.header["columns"].get(name)
        if meta is None or meta["type"] != "bloom":
            return None
        raw = self.blob[meta["offset"] : meta["offset"] + meta["length"]]
        return BloomFilter.from_bytes(raw, meta["numBits"], meta["numHashFunctions"])

    def key_bloom(self) -> BloomFilter | None:
        """The composite primary-key bloom, or None for a file without one."""
        return self._bloom(KEY_INDEX_NAME)

    def test_key_hashes(self, hashes: np.ndarray) -> np.ndarray | None:
        """(n,) bool, True where the key may be in the file; None when the
        file has no key bloom (it cannot prune)."""
        bf = self.key_bloom()
        if bf is None:
            return None
        return bf.might_contain_hashes(np.asarray(hashes, dtype=np.uint64))

    def test(self, predicate: Predicate | None) -> bool:
        if predicate is None:
            return True
        return self._test(predicate)

    def _test(self, p: Predicate) -> bool:
        if isinstance(p, CompoundPredicate):
            if p.function == "and":
                return all(self._test(c) for c in p.children)
            return any(self._test(c) for c in p.children)
        assert isinstance(p, LeafPredicate)
        if p.function == "equal":
            bf = self._bloom(p.field)
            return True if bf is None else bf.might_contain(p.literals)
        if p.function == "in":
            bf = self._bloom(p.field)
            if bf is None:
                return True
            return any(bf.might_contain(v) for v in p.literals)
        return True  # only equality can use a bloom
