"""Dynamic bucket mode: the durable key-hash -> bucket assignment (port of
paimon_tpu/core/bucket_index.py).

A primary-key table with bucket=-1 assigns each new key to a bucket that
is not full (dynamic-bucket.target-row-num keys) and keeps it there: the
per-bucket sets of key hashes are the durable record, one hash index file
per (partition, bucket) under index/, listed in the index manifest. A
batch is assigned by one membership probe per bucket (searchsorted
against its sorted hashes) and one allocation pass over the new keys.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..fs import FileIO
from ..utils import new_file_name
from ..utils.compression import zstd_compress, zstd_decompress
from .deletionvectors import IndexFileEntry

__all__ = ["HashIndexFile", "SimpleHashBucketAssigner"]


class HashIndexFile:
    """One file per (partition, bucket): a zstd frame of the sorted uint64
    key hashes living in that bucket."""

    def __init__(self, file_io: FileIO, table_path: str):
        self.file_io = file_io
        self.index_dir = f"{table_path}/index"

    def write(self, hashes: np.ndarray) -> str:
        name = new_file_name("index-hash")
        payload = zstd_compress(np.sort(hashes.astype(np.uint64)).tobytes())
        self.file_io.write_bytes(f"{self.index_dir}/{name}", payload)
        return name

    def read(self, name: str) -> np.ndarray:
        raw = zstd_decompress(self.file_io.read_bytes(f"{self.index_dir}/{name}"))
        return np.frombuffer(raw, dtype=np.uint64).copy()


@dataclass
class _PartitionIndex:
    buckets: dict[int, np.ndarray]  # bucket -> sorted uint64 hashes
    dirty: set


class SimpleHashBucketAssigner:
    """The assigner of a writer that owns every bucket of the partitions it
    writes."""

    def __init__(
        self,
        index_file: HashIndexFile,
        target_bucket_rows: int,
        initial_buckets: int | None = None,
        assign_id: int = 0,
        num_assigners: int = 1,
    ):
        self.index_file = index_file
        self.target = target_bucket_rows
        # dynamic-bucket.initial-buckets: new keys round-robin over this many
        # buckets from the start; dynamic-bucket.assigner-parallelism: this
        # assigner creates only the buckets with bucket % num_assigners ==
        # assign_id
        self.initial_buckets = initial_buckets
        self.assign_id = assign_id
        self.num_assigners = max(1, num_assigners)
        self._partitions: dict[tuple, _PartitionIndex] = {}
        self._rr: dict[tuple, int] = {}  # round-robin cursor per partition

    def _allocate_new(self, partition: tuple, counts: dict[int, int]) -> int:
        """The bucket of a new key: striped to this assigner, round-robin
        over the initial window while any of it has room, then growing."""
        p = self.num_assigners
        width = max(1, ((self.initial_buckets or 1) + p - 1) // p)
        rr = self._rr.get(partition, 0)
        base = 0
        while True:
            window = [self.assign_id + (base + j) * p for j in range(width)]
            open_ = [b for b in window if counts.get(b, 0) < self.target]
            if open_:
                b = open_[rr % len(open_)]
                self._rr[partition] = rr + 1
                return b
            base += width

    def bootstrap(self, partition: tuple, bucket_indexes: dict[int, np.ndarray]) -> None:
        self._partitions[partition] = _PartitionIndex(
            {b: np.sort(h.astype(np.uint64)) for b, h in bucket_indexes.items()}, set()
        )

    def assign(self, partition: tuple, hashes: np.ndarray) -> np.ndarray:
        """(n,) uint64 key hashes -> (n,) int32 buckets."""
        pi = self._partitions.setdefault(partition, _PartitionIndex({}, set()))
        n = len(hashes)
        out = np.full(n, -1, dtype=np.int32)
        for b, hs in pi.buckets.items():
            if len(hs) == 0:
                continue
            unassigned = out == -1
            if not unassigned.any():
                break
            idx = np.searchsorted(hs, hashes)
            hit = (idx < len(hs)) & (hs[np.minimum(idx, len(hs) - 1)] == hashes)
            out = np.where(unassigned & hit, b, out)
        # new keys (a key repeated within the batch takes one slot)
        missing = np.flatnonzero(out == -1)
        if len(missing):
            uniq, inv = np.unique(hashes[missing], return_inverse=True)
            alloc = np.empty(len(uniq), dtype=np.int32)
            counts = {b: len(hs) for b, hs in pi.buckets.items()}
            for i in range(len(uniq)):
                b = self._allocate_new(partition, counts)
                alloc[i] = b
                counts[b] = counts.get(b, 0) + 1
            out[missing] = alloc[inv]
            for b in np.unique(alloc):
                new_hashes = uniq[alloc == b]
                old = pi.buckets.get(b, np.empty(0, np.uint64))
                pi.buckets[b] = np.unique(np.concatenate([old, new_hashes]))
                pi.dirty.add(int(b))
        return out

    def prepare_commit(self) -> dict[tuple, list[IndexFileEntry]]:
        """Write a new hash index file for each bucket that took new keys."""
        out: dict[tuple, list[IndexFileEntry]] = {}
        for partition, pi in self._partitions.items():
            entries = []
            for b in sorted(pi.dirty):
                name = self.index_file.write(pi.buckets[b])
                entries.append(IndexFileEntry("HASH_INDEX", partition, b, name, len(pi.buckets[b])))
            if entries:
                out[partition] = entries
            pi.dirty.clear()
        return out
