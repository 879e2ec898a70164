"""Probe indexes for batched primary-key gets (port of
paimon_tpu/lookup/index.py).

The batched twin of LookupLevels: a probe batch encodes once through
JoinIndex (ops/join.py: key lanes, one lane plan, a <= 64-bit fold) and
pays one vectorised searchsorted per surviving file. Files are pruned
before any data IO by two tests that read nothing: the key range in the
manifest entry and the composite key bloom of the file's PTIX index
(format/fileindex.py, written under
file-index.bloom-filter.primary-key.enabled). The surviving files' batches
come through the reader factory, so from the data-file cache
(utils/cache.py) once decoded. Under merge.dict-domain a file's key
columns come back code-backed and JoinIndex ranks them through their
dictionary: the index's build side never expands a string.

The level resolution is the caller's (table/get.py): each match carries
its (sequence, kind); the highest sequence wins per key and a delete
winner masks the key.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import Sequence

import numpy as np
import torch

from ..core.datafile import DataFileMeta, KeyValueFileReaderFactory
from ..core.kv import KVBatch
from ..metrics import get_metrics

__all__ = ["FileProbeIndex", "BucketGetIndex", "GetResult"]


class GetResult:
    """A batched get's outcome, aligned with the probe keys: found[i] says
    key i resolved to a live row; `rows` holds the found rows in probe
    order and take[j] is the probe index of rows[j]."""

    def __init__(self, n: int, found: np.ndarray, rows, take: np.ndarray):
        self.n = n
        self.found = found
        self.rows = rows  # a ColumnBatch over the table's value schema
        self.take = take  # (found.sum(),) int64 probe indices, ascending

    def to_pylist(self) -> list:
        """list[tuple | None], one entry per probe key: the shape of a loop
        of scalar lookups."""
        out: list = [None] * self.n
        vals = self.rows.to_pylist()
        for j, i in enumerate(self.take):
            out[int(i)] = vals[j]
        return out

    def row(self, i: int):
        """The row for probe key i as a tuple, or None."""
        if not self.found[i]:
            return None
        j = int(np.searchsorted(self.take, i))
        return tuple(c.value_at(j) for c in self.rows.columns.values())


class FileProbeIndex:
    """One data file (or one memtable generation) indexed for batch probes:
    a JoinIndex over the key columns, and the row-aligned sequence numbers
    and kinds the resolution needs."""

    def __init__(self, kv: KVBatch, key_names: Sequence[str], device: "str | torch.device" = "cuda"):
        from ..ops.join import JoinIndex

        self.kv = kv
        self.key_names = list(key_names)
        self.index = JoinIndex(kv.data, self.key_names, device=device)

    def probe(self, probe_batch) -> tuple[np.ndarray, np.ndarray]:
        """(probe index, row) of every key match in this file."""
        if self.kv.num_rows == 0 or probe_batch.num_rows == 0:
            return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
        res = self.index.probe(probe_batch, self.key_names, how="inner")
        return np.asarray(res.left_take, dtype=np.int64), np.asarray(res.right_take, dtype=np.int64)


class BucketGetIndex:
    """One bucket's files served to batched gets: pruning with no data IO,
    per-file probe indexes built on first use, matches returned with what
    the resolution needs. An instance is a view of one snapshot's files;
    LocalTableQuery.refresh keeps it while the bucket's (files, deletion
    vectors) stay, and a new one takes over the warm indexes of the files
    that stay without vectors."""

    def __init__(
        self,
        files: list[DataFileMeta],
        reader_factory: KeyValueFileReaderFactory,
        key_names: Sequence[str],
        deletion_vectors: dict | None = None,
        bloom_prune: bool = True,
        warm_from: "BucketGetIndex | None" = None,
        device: "str | torch.device" = "cuda",
    ):
        self.files = list(files)
        self.reader_factory = reader_factory
        self.key_names = list(key_names)
        self.deletion_vectors = deletion_vectors or {}
        self.bloom_prune = bloom_prune
        self.device = device
        self._indexes: dict[str, FileProbeIndex] = {}
        self._payloads: dict[str, object] = {}  # file -> FileIndexPredicate | None
        if warm_from is not None:
            # a probe index has the vectors baked in: carried only where
            # neither side has one for the file; PTIX payloads carry always
            names = {f.file_name for f in self.files}
            for name, idx in warm_from._indexes.items():
                if name in names and name not in self.deletion_vectors and name not in warm_from.deletion_vectors:
                    self._indexes[name] = idx
            for name, pred in warm_from._payloads.items():
                if name in names:
                    self._payloads[name] = pred

    def prewarm(self) -> None:
        """Build every file's probe index now, off the serving path."""
        for meta in self.files:
            if meta.file_name not in self._indexes:
                self._file_index(meta)

    def _index_predicate(self, meta: DataFileMeta):
        """The file's PTIX index (embedded, or the sidecar read once), or
        None when it has none or it cannot be read: a missing or torn
        sidecar never fails a get."""
        name = meta.file_name
        if name not in self._payloads:
            from ..format.fileindex import FileIndexPredicate, index_path

            pred = None
            try:
                if meta.embedded_index is not None:
                    pred = FileIndexPredicate.from_bytes(meta.embedded_index)
                elif any(x.endswith(".index") for x in meta.extra_files):
                    data_path = f"{self.reader_factory.bucket_dir}/{name}"
                    pred = FileIndexPredicate(self.reader_factory.file_io, index_path(data_path))
            except (OSError, AssertionError, ValueError):
                pred = None
            self._payloads[name] = pred
        return self._payloads[name]

    def _pruned(self, meta: DataFileMeta, hashes: np.ndarray, sorted_keys: list | None) -> bool:
        if sorted_keys and meta.min_key and meta.max_key:
            i = bisect_left(sorted_keys, tuple(meta.min_key))
            if i == len(sorted_keys) or sorted_keys[i] > tuple(meta.max_key):
                return True  # no probe key in the file's key range
        if not self.bloom_prune:
            return False
        pred = self._index_predicate(meta)
        if pred is None:
            return False
        mask = pred.test_key_hashes(hashes)
        if mask is None:
            return False  # a file without a key bloom cannot be pruned by one
        get_metrics().counter("index_hits").inc()
        return not bool(mask.any())

    def _file_index(self, meta: DataFileMeta) -> FileProbeIndex:
        name = meta.file_name
        idx = self._indexes.get(name)
        if idx is None:
            kv = self.reader_factory.read(meta)
            dv = self.deletion_vectors.get(name)
            if dv is not None:
                keep = ~dv.deleted_mask(kv.num_rows)
                if not keep.all():
                    kv = kv.filter(keep)
            idx = self._indexes[name] = FileProbeIndex(kv, self.key_names, self.device)
        return idx

    def probe(self, probe_batch, hashes: np.ndarray, sorted_keys: list | None = None):
        """[(FileProbeIndex, probe indices, rows)] over the surviving files.
        `hashes`: the probe keys' key_hashes; `sorted_keys`: the probe key
        tuples in ascending order. Both are computed once per get."""
        g = get_metrics()
        out = []
        for meta in self.files:
            if self._pruned(meta, hashes, sorted_keys):
                g.counter("files_pruned").inc()
                continue
            fi = self._file_index(meta)
            g.counter("keys_probed").inc(probe_batch.num_rows)
            pi, rows = fi.probe(probe_batch)
            if len(pi):
                out.append((fi, pi, rows))
        return out
