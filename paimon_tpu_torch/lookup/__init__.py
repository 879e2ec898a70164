"""Point lookups on primary-key tables: lookup files, their cache and the
per-bucket level walk (port of paimon_tpu/lookup/__init__.py).

A lookup file is one data file's rows plus a sorted index of their key
hashes (table/bucket.py key_hashes): a probe is one searchsorted, then an
exact compare of the key. An optional bloom over the hashes
(lookup.cache.bloom.filter.*) answers most absent keys first, and a slot
table sized n / lookup.hash-load-factor narrows the search to one slot.
The memory cache is an LRU by resident bytes
(lookup.cache-max-memory-size).

With a local store directory, converted files persist so a restart or an
eviction reloads them instead of the remote data file. The JAX package
persists them as arrow IPC; the port has no pyarrow and writes its own
pair: `<file>.lookup`, the rows as an uncompressed parquet file
(format/parquet.py), and `<file>.lookup.hidx`, the sorted hashes (uint64)
then the row order (int32). The store is local to one process tree, so
neither package reads the other's. The sweep keeps it within
lookup.cache-max-disk-size and drops pairs older than
lookup.cache-file-retention, a pair at a time.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import replace
from typing import Sequence

import numpy as np

from ..core.datafile import DataFileMeta, KeyValueFileReaderFactory
from ..core.kv import SEQUENCE_FIELD_NAME, VALUE_KIND_FIELD_NAME, KVBatch, kv_disk_schema
from ..data.batch import ColumnBatch, concat_batches
from ..format.fileindex import BloomFilter
from ..format.parquet import read_parquet, write_parquet
from ..table.bucket import key_hashes
from ..types import RowKind

__all__ = ["LookupFile", "LookupFileCache", "LookupLevels"]


class LookupFile:
    """One data file indexed for point probes."""

    def __init__(
        self,
        kv: KVBatch,
        key_names: Sequence[str],
        bloom_fpp: float | None = None,
        hash_load_factor: float | None = None,
    ):
        self.kv = kv
        self.key_names = list(key_names)
        hashes = key_hashes(kv.data, key_names)
        self.order = np.argsort(hashes, kind="stable").astype(np.int32)
        self.sorted_hashes = hashes[self.order]
        self._build_accel(bloom_fpp, hash_load_factor)

    def _build_accel(self, bloom_fpp: float | None, hash_load_factor: float | None) -> None:
        """The bloom over the key hashes, and the slot table: slot s starts
        at the first sorted hash whose top bits reach s."""
        n = len(self.sorted_hashes)
        self.bloom = None
        if bloom_fpp is not None and n:
            self.bloom = BloomFilter.for_items(n, bloom_fpp)
            self.bloom.add_hashes(self.sorted_hashes)
        self.slot_shift = None
        if hash_load_factor is not None and n:
            slots = 1
            while slots < int(n / max(hash_load_factor, 0.1)):
                slots <<= 1
            self.slot_shift = max(64 - slots.bit_length() + 1, 0)
            prefixes = (self.sorted_hashes >> np.uint64(self.slot_shift)).astype(np.uint64)
            self.slot_starts = np.searchsorted(prefixes, np.arange(slots + 1, dtype=np.uint64))

    def save(self, file_io, path: str) -> None:
        """Persist the rows (`path`) and the hash index (`path`.hidx)."""
        file_io.write_bytes(path, write_parquet(self.kv.to_disk_batch(), "none"), overwrite=True)
        file_io.write_bytes(f"{path}.hidx", self.sorted_hashes.tobytes() + self.order.tobytes(), overwrite=True)

    @staticmethod
    def load(
        file_io,
        path: str,
        value_schema,
        key_names: Sequence[str],
        bloom_fpp: float | None = None,
        hash_load_factor: float | None = None,
    ) -> "LookupFile":
        disk_schema = kv_disk_schema(value_schema)
        parts = read_parquet(file_io.read_bytes(path), disk_schema, disk_schema.field_names)
        disk = concat_batches(parts) if parts else ColumnBatch.empty(disk_schema)
        data = ColumnBatch(value_schema, {n: disk.column(n) for n in value_schema.field_names})
        kv = KVBatch(
            data,
            disk.column(SEQUENCE_FIELD_NAME).values.astype(np.int64, copy=False),
            disk.column(VALUE_KIND_FIELD_NAME).values.astype(np.uint8),
        )
        lf = LookupFile.__new__(LookupFile)
        lf.kv = kv
        lf.key_names = list(key_names)
        raw = file_io.read_bytes(f"{path}.hidx")
        n = kv.num_rows
        lf.sorted_hashes = np.frombuffer(raw[: n * 8], dtype=np.uint64).copy()
        lf.order = np.frombuffer(raw[n * 8 : n * 8 + n * 4], dtype=np.int32).copy()
        lf._build_accel(bloom_fpp, hash_load_factor)
        return lf

    @property
    def num_bytes(self) -> int:
        total = 0
        for c in self.kv.data.columns.values():
            total += c.values.nbytes if c.values.dtype != np.dtype(object) else len(c.values) * 32
        return total + self.sorted_hashes.nbytes + self.order.nbytes

    def probe(self, key_tuple: tuple, key_hash: np.uint64):
        """The key's row in this file, or None. A file holds each key once;
        hash collisions are resolved by comparing the key."""
        if self.bloom is not None and not bool(
            self.bloom.might_contain_hashes(np.asarray([key_hash], dtype=np.uint64))[0]
        ):
            return None
        if self.slot_shift is not None:
            s = int(key_hash >> np.uint64(self.slot_shift))
            b_lo, b_hi = int(self.slot_starts[s]), int(self.slot_starts[s + 1])
            seg = self.sorted_hashes[b_lo:b_hi]
            lo = b_lo + int(np.searchsorted(seg, key_hash, side="left"))
            hi = b_lo + int(np.searchsorted(seg, key_hash, side="right"))
        else:
            lo = int(np.searchsorted(self.sorted_hashes, key_hash, side="left"))
            hi = int(np.searchsorted(self.sorted_hashes, key_hash, side="right"))
        for i in range(lo, hi):
            row = int(self.order[i])
            if all(self.kv.data.column(k).values[row] == v for k, v in zip(self.key_names, key_tuple)):
                return row
        return None


class LookupFileCache:
    """LRU of lookup files by resident bytes."""

    def __init__(self, max_bytes: int = 256 << 20):
        self.max_bytes = max_bytes
        self._cache: OrderedDict[str, LookupFile] = OrderedDict()
        self._bytes = 0

    def get(self, file_name: str, loader) -> LookupFile:
        if file_name in self._cache:
            self._cache.move_to_end(file_name)
            return self._cache[file_name]
        lf = loader()
        self._cache[file_name] = lf
        self._bytes += lf.num_bytes
        while self._bytes > self.max_bytes and len(self._cache) > 1:
            _, evicted = self._cache.popitem(last=False)
            self._bytes -= evicted.num_bytes
        return lf

    def invalidate(self, file_name: str) -> None:
        lf = self._cache.pop(file_name, None)
        if lf is not None:
            self._bytes -= lf.num_bytes


class LookupLevels:
    """A point lookup across one bucket's levels: level 0 newest first, then
    each level's sorted run at the file whose key range holds the key."""

    def __init__(
        self,
        files: list[DataFileMeta],
        reader_factory: KeyValueFileReaderFactory,
        key_names: Sequence[str],
        cache: LookupFileCache | None = None,
        deletion_vectors: dict | None = None,
        local_store_dir: str | None = None,
        file_io=None,
        bloom_fpp: float | None = None,
        hash_load_factor: float | None = None,
        max_disk_bytes: int | None = None,
        file_retention_millis: int | None = None,
    ):
        from ..core.levels import Levels

        self.levels = Levels(files, num_levels=max((f.level for f in files), default=0) + 1)
        self.reader_factory = reader_factory
        self.key_names = list(key_names)
        self.cache = cache or LookupFileCache()
        self.deletion_vectors = deletion_vectors or {}
        self.local_store_dir = local_store_dir
        self.file_io = file_io
        self.bloom_fpp = bloom_fpp
        self.hash_load_factor = hash_load_factor
        self.max_disk_bytes = max_disk_bytes
        self.file_retention_millis = file_retention_millis

    def _sweep_local_store(self) -> None:
        """Drop the persisted pairs past lookup.cache-file-retention, then
        the oldest while the store exceeds lookup.cache-max-disk-size. A
        pair goes whole: a .lookup without its .hidx cannot load."""
        if not (self.local_store_dir and self.file_io):
            return
        try:
            # paths rebuilt from the directory and the base name: a
            # wrapper's FileStatus may carry its inner path
            stats = [
                replace(s, path=f"{self.local_store_dir}/{s.path.rsplit('/', 1)[-1]}")
                for s in self.file_io.list_status(self.local_store_dir)
                if s.path.endswith(".lookup") or s.path.endswith(".hidx")
            ]
        except OSError:
            return
        now_ms = time.time() * 1000
        pairs: dict[str, list] = {}
        for s in stats:
            stem = s.path[: -len(".hidx")] if s.path.endswith(".hidx") else s.path
            pairs.setdefault(stem, []).append(s)
        keep = []
        for members in pairs.values():
            mtime = max(s.mtime_millis for s in members)
            if self.file_retention_millis is not None and mtime and now_ms - mtime > self.file_retention_millis:
                for s in members:
                    self.file_io.delete(s.path)
            else:
                keep.append((mtime, members))
        if self.max_disk_bytes is not None:
            total = sum(s.size for _, members in keep for s in members)
            for _, members in sorted(keep, key=lambda t: t[0]):  # the oldest pair first
                if total <= self.max_disk_bytes:
                    break
                for s in members:
                    self.file_io.delete(s.path)
                    total -= s.size

    def _load(self, meta: DataFileMeta) -> LookupFile:
        local = f"{self.local_store_dir}/{meta.file_name}.lookup" if self.local_store_dir and self.file_io else None
        has_dv = meta.file_name in self.deletion_vectors
        if local and not has_dv and self.file_io.exists(local):
            return LookupFile.load(
                self.file_io,
                local,
                self.reader_factory.read_schema,
                self.key_names,
                self.bloom_fpp,
                self.hash_load_factor,
            )
        kv = self.reader_factory.read(meta)
        dv = self.deletion_vectors.get(meta.file_name)
        if dv is not None:
            mask = ~dv.deleted_mask(kv.num_rows)
            if not mask.all():
                kv = kv.filter(mask)
        lf = LookupFile(kv, self.key_names, self.bloom_fpp, self.hash_load_factor)
        if local and not has_dv:  # a file with vectors changes between snapshots
            self._sweep_local_store()
            lf.save(self.file_io, local)
        return lf

    def _lookup_file(self, meta: DataFileMeta) -> LookupFile:
        return self.cache.get(meta.file_name, lambda: self._load(meta))

    def lookup(self, key_tuple: tuple):
        """The key's merged newest row as a one-row ColumnBatch, or None when
        it is absent or deleted."""
        key_schema = self.reader_factory.read_schema.project(self.key_names)
        probe = ColumnBatch.from_pydict(key_schema, {k: [v] for k, v in zip(self.key_names, key_tuple)})
        h = key_hashes(probe, self.key_names)[0]
        for meta in self.levels.level0:  # newest first
            if meta.min_key <= key_tuple <= meta.max_key:
                row = self._lookup_file(meta).probe(key_tuple, h)
                if row is not None:
                    return self._result(meta, row)
        for lv in sorted(self.levels.runs):
            meta = self._file_for_key(self.levels.runs[lv].files, key_tuple)
            if meta is not None:
                row = self._lookup_file(meta).probe(key_tuple, h)
                if row is not None:
                    return self._result(meta, row)
        return None

    def _result(self, meta: DataFileMeta, row: int):
        lf = self._lookup_file(meta)
        if RowKind(int(lf.kv.kind[row])) in (RowKind.DELETE, RowKind.UPDATE_BEFORE):
            return None
        return lf.kv.data.slice(row, row + 1)

    @staticmethod
    def _file_for_key(files: list[DataFileMeta], key_tuple: tuple) -> DataFileMeta | None:
        lo, hi = 0, len(files) - 1
        while lo <= hi:
            mid = (lo + hi) // 2
            f = files[mid]
            if key_tuple < f.min_key:
                hi = mid - 1
            elif key_tuple > f.max_key:
                lo = mid + 1
            else:
                return f
        return None
