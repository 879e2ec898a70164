"""Deletion vectors: per-data-file sets of deleted row positions, and the
index files that hold them (port of paimon_tpu/core/deletionvectors.py,
byte for byte).

A vector is a sorted array of unique uint32 row positions, absolute in
its data file's row order; on disk it is the zstd frame of those
positions as little-endian uint32 (the port's own codec, native/zstd.c).
Many vectors pack into one index file under the table's index/ directory:

    [4 bytes "PTDV"][<I header length][JSON header][blobs]
    header = {data_file_name: {"offset": o, "length": l, "cardinality": c},
              "__next__": next container's name (only in a chain)}

A container passes deletion-vector.index-file.target-size by rolling
into a chain; readers follow "__next__". The index manifest names the
chain's first file under kind DELETION_VECTORS, one entry per (partition,
bucket).
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass
from typing import Mapping

import numpy as np

from ..fs import LocalFileIO
from ..utils import new_file_name
from ..utils.compression import zstd_compress, zstd_decompress

__all__ = ["DeletionVector", "DeletionVectorsIndexFile", "DeletionVectorsMaintainer", "IndexFileEntry"]

_MAGIC = b"PTDV"


class DeletionVector:
    """Sorted unique uint32 row positions marked deleted."""

    def __init__(self, positions: np.ndarray | None = None):
        self.positions = (
            np.unique(positions.astype(np.uint32))
            if positions is not None and len(positions)
            else np.empty(0, np.uint32)
        )

    @property
    def cardinality(self) -> int:
        return len(self.positions)

    def is_empty(self) -> bool:
        return len(self.positions) == 0

    def merge(self, other: "DeletionVector") -> "DeletionVector":
        return DeletionVector(np.concatenate([self.positions, other.positions]))

    def deleted_mask(self, num_rows: int) -> np.ndarray:
        mask = np.zeros(num_rows, dtype=np.bool_)
        mask[self.positions[self.positions < num_rows]] = True
        return mask

    def to_bytes(self) -> bytes:
        return zstd_compress(self.positions.astype("<u4").tobytes())

    @staticmethod
    def from_bytes(data: bytes) -> "DeletionVector":
        return DeletionVector(np.frombuffer(zstd_decompress(data), dtype="<u4").astype(np.uint32))


@dataclass(frozen=True)
class IndexFileEntry:
    """One index file registered for a (partition, bucket)."""

    kind: str  # "DELETION_VECTORS" | "HASH_INDEX"
    partition: tuple
    bucket: int
    file_name: str
    row_count: int

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "partition": list(self.partition),
            "bucket": self.bucket,
            "fileName": self.file_name,
            "rowCount": self.row_count,
        }

    @staticmethod
    def from_dict(d: dict) -> "IndexFileEntry":
        return IndexFileEntry(d["kind"], tuple(d["partition"]), d["bucket"], d["fileName"], d["rowCount"])


class DeletionVectorsIndexFile:
    """Reads and writes the packed containers in the table's index/ dir."""

    def __init__(self, file_io: LocalFileIO, table_path: str, target_size: int = 2 << 20):
        self.file_io = file_io
        self.index_dir = f"{table_path}/index"
        self.target_size = max(1, target_size)

    def write(self, dvs: Mapping[str, DeletionVector]) -> tuple[str, int]:
        """Write the vectors (by data file name) as one container, or a
        chain once the blobs pass target_size; returns (first container's
        name, total positions)."""
        chunks: list[list] = [[]]
        size = 0
        for data_file, dv in sorted(dvs.items()):
            blob = dv.to_bytes()
            if size and size + len(blob) > self.target_size:
                chunks.append([])
                size = 0
            chunks[-1].append((data_file, blob, dv.cardinality))
            size += len(blob)
        next_name: str | None = None
        for chunk in reversed(chunks):  # the tail first, so each head knows its successor
            header: dict = {}
            offset = 0
            for data_file, blob, card in chunk:
                header[data_file] = {"offset": offset, "length": len(blob), "cardinality": card}
                offset += len(blob)
            if next_name is not None:
                header["__next__"] = next_name
            hdr = json.dumps(header).encode()
            next_name = new_file_name("index")
            payload = _MAGIC + struct.pack("<I", len(hdr)) + hdr + b"".join(blob for _, blob, _ in chunk)
            self.file_io.write_bytes(f"{self.index_dir}/{next_name}", payload)
        return next_name, sum(dv.cardinality for dv in dvs.values())

    def _read_one(self, name: str) -> tuple[dict, bytes]:
        data = self.file_io.read_bytes(f"{self.index_dir}/{name}")
        if data[:4] != _MAGIC:
            raise ValueError(f"index file {name} is not a deletion-vector container (bad magic)")
        (hlen,) = struct.unpack("<I", data[4:8])
        return json.loads(data[8 : 8 + hlen]), data[8 + hlen :]

    def read_all(self, name: str | None) -> dict[str, DeletionVector]:
        out: dict[str, DeletionVector] = {}
        while name is not None:
            header, blob = self._read_one(name)
            name = header.pop("__next__", None)
            for data_file, meta in header.items():
                out[data_file] = DeletionVector.from_bytes(blob[meta["offset"] : meta["offset"] + meta["length"]])
        return out

    def chain_names(self, name: str) -> list[str]:
        """Every container of the chain that starts at `name`."""
        out = []
        while name is not None:
            out.append(name)
            name = self._read_one(name)[0].get("__next__")
        return out


class DeletionVectorsMaintainer:
    """Gathers one (partition, bucket)'s deletions and writes its whole
    replacement container at commit."""

    def __init__(self, index_file: DeletionVectorsIndexFile, restored: Mapping[str, DeletionVector] | None = None):
        self.index_file = index_file
        self.dvs: dict[str, DeletionVector] = dict(restored or {})

    def notify_deletion(self, data_file: str, positions: np.ndarray) -> None:
        dv = DeletionVector(positions)
        if data_file in self.dvs:
            dv = self.dvs[data_file].merge(dv)
        self.dvs[data_file] = dv

    def prepare_commit(self, partition: tuple, bucket: int) -> IndexFileEntry | None:
        live = {f: dv for f, dv in self.dvs.items() if not dv.is_empty()}
        if not live:
            return None
        name, total = self.index_file.write(live)
        return IndexFileEntry("DELETION_VECTORS", partition, bucket, name, total)
