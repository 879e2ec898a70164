"""Batched point gets: the serving path of LocalTableQuery (port of
paimon_tpu/table/get.py).

A get merges the read-optimised main (the committed levels) with the
writer's in-memory delta at query time:

  1. The probe keys become one ColumnBatch; their key hashes
     (table/bucket.py, the hash of the bucket router and the key blooms)
     and a sorted key list are computed once.
  2. Keys route to buckets: a fixed-bucket table hashes them; a
     dynamic-bucket table probes every bucket of the partition with the
     whole batch.
  3. Per bucket, BucketGetIndex (lookup/index.py) prunes files by key
     range and key bloom, then probes each surviving file once.
  4. With a TableWrite attached, each bucket's live memtable and its
     flushed but uncommitted level-0 files join the candidates
     (read-your-writes).
  5. One lexsort over (probe key, sequence, tier) picks each key's winner,
     the LookupLevels rule applied to the whole batch; a DELETE or
     UPDATE_BEFORE winner masks the key. Deletion vectors were applied when
     the per-file indexes were built.

The probes run on the host (numpy), as in the JAX package.
LocalTableQuery.lookup, the scalar walk, is the oracle the tests hold
batch_get to.
"""

from __future__ import annotations

import time
from typing import TYPE_CHECKING, Mapping

import numpy as np

from ..core.kv import KVBatch
from ..data.batch import ColumnBatch, concat_batches
from ..lookup.index import BucketGetIndex, FileProbeIndex, GetResult
from ..metrics import get_metrics
from ..types import RowKind
from .bucket import bucket_ids, key_hashes

if TYPE_CHECKING:
    from .query import LocalTableQuery

__all__ = ["batch_get", "probe_batch", "batch_from_rows", "GetResult"]

# resolution tiers: the higher wins a sequence tie (a memtable row and the
# level-0 file its flush is writing can carry one sequence number)
_TIER_MAIN, _TIER_DELTA_FILE, _TIER_MEMTABLE = 0, 1, 2


def batch_from_rows(schema, rows) -> ColumnBatch:
    """A ColumnBatch from row tuples aligned with the schema's fields."""
    cols = list(zip(*rows)) if rows else [() for _ in schema.fields]
    return ColumnBatch.from_pydict(schema, {f.name: list(c) for f, c in zip(schema.fields, cols)})


def probe_batch(query: "LocalTableQuery", keys) -> ColumnBatch:
    """The probe input as a ColumnBatch over the key columns: a ColumnBatch
    carrying them, a {column: sequence} mapping, or a sequence of key
    tuples (or scalars for a one-column key)."""
    key_names = query.store.key_names
    schema = query.store.value_schema.project(key_names)
    if hasattr(keys, "schema") and hasattr(keys, "columns"):
        return keys
    if isinstance(keys, Mapping):
        return ColumnBatch.from_pydict(schema, {k: keys[k] for k in key_names})
    return batch_from_rows(schema, [tuple(k) if isinstance(k, (tuple, list)) else (k,) for k in keys])


def _bucket_groups(query: "LocalTableQuery", probe: ColumnBatch, partition: tuple):
    """[(bucket, probe rows or None)]; None is the whole batch (a
    dynamic-bucket table probes every bucket of the partition)."""
    n = query._probe_buckets or query.store.options.bucket
    if n > 0:
        # the bucket count of the snapshot served, which a rescale changes
        ids = bucket_ids(probe, query.table.schema.bucket_keys, n)
        return [(int(b), np.flatnonzero(ids == b)) for b in np.unique(ids)]
    return [(b, None) for b in sorted({pb[1] for pb in query._get_indexes if pb[0] == partition})]


class _Candidates:
    """(probe index, sequence, kind, source row) matches over files,
    buckets and tiers, resolved to each key's highest sequence."""

    def __init__(self):
        self.sources: list[KVBatch] = []
        self.probe_idx: list[np.ndarray] = []
        self.seqs: list[np.ndarray] = []
        self.kinds: list[np.ndarray] = []
        self.src_ids: list[np.ndarray] = []
        self.rows: list[np.ndarray] = []
        self.tiers: list[np.ndarray] = []

    def add(self, kv: KVBatch, probe_idx: np.ndarray, rows: np.ndarray, tier: int) -> None:
        if len(probe_idx) == 0:
            return
        sid = len(self.sources)
        self.sources.append(kv)
        self.probe_idx.append(probe_idx)
        self.seqs.append(kv.seq[rows])
        self.kinds.append(kv.kind[rows])
        self.src_ids.append(np.full(len(rows), sid, dtype=np.int64))
        self.rows.append(rows)
        self.tiers.append(np.full(len(rows), tier, dtype=np.int8))

    def resolve(self, n: int, value_schema) -> GetResult:
        if not self.sources:
            return GetResult(n, np.zeros(n, dtype=np.bool_), ColumnBatch.empty(value_schema), np.empty(0, dtype=np.int64))
        pi = np.concatenate(self.probe_idx)
        seq = np.concatenate(self.seqs)
        kind = np.concatenate(self.kinds)
        src = np.concatenate(self.src_ids)
        row = np.concatenate(self.rows)
        tier = np.concatenate(self.tiers)
        # per probe key ascending by (seq, tier): each group's last entry wins
        order = np.lexsort((tier, seq, pi))
        ps = pi[order]
        last = np.ones(len(ps), dtype=np.bool_)
        last[:-1] = ps[1:] != ps[:-1]
        win = order[last]
        win_pi = pi[win]
        live = ~np.isin(kind[win], (int(RowKind.DELETE), int(RowKind.UPDATE_BEFORE)))
        get_metrics().counter("memtable_hits").inc(int((tier[win] > _TIER_MAIN)[live].sum()))
        win = win[live]
        win_pi = win_pi[live]
        found = np.zeros(n, dtype=np.bool_)
        found[win_pi] = True
        # `win` is in ascending probe order: gather source by source, then
        # permute back
        w_src, w_row = src[win], row[win]
        by_src = np.argsort(w_src, kind="stable")
        parts = [self.sources[s].data.take(w_row[by_src[w_src[by_src] == s]]) for s in np.unique(w_src)]
        if not parts:
            return GetResult(n, found, ColumnBatch.empty(value_schema), win_pi.astype(np.int64))
        combined = concat_batches(parts)
        inv = np.empty(len(by_src), dtype=np.int64)
        inv[by_src] = np.arange(len(by_src))
        return GetResult(n, found, combined.take(inv), win_pi.astype(np.int64))


def _delta_sources(query: "LocalTableQuery", partition: tuple, bucket: int):
    """(memtable probe index or None, (BucketGetIndex of the uncommitted
    level-0 files,) or ()) of one bucket's live delta."""
    tw = query._write
    if tw is None:
        return None, ()
    snap = tw.delta_snapshot().get((partition, bucket))
    if snap is None:
        return None, ()
    batches, new_files = snap
    mem = None
    if batches:
        kv = KVBatch.concat(batches)
        if kv.num_rows:
            mem = FileProbeIndex(kv, query.store.key_names, query.device)
    files = ()
    if new_files:
        names = tuple(f.file_name for f in new_files)
        cached = query._delta_indexes.get((partition, bucket))
        if cached is None or cached[0] != names:
            idx = BucketGetIndex(
                new_files,
                query.store.reader_factory(partition, bucket),
                query.store.key_names,
                bloom_prune=query._bloom_prune,
                device=query.device,
            )
            query._delta_indexes[(partition, bucket)] = cached = (names, idx)
        files = (cached[1],)
    return mem, files


def batch_get(query: "LocalTableQuery", keys, partition: tuple = ()) -> GetResult:
    """Batched primary-key get against the query's view (and the attached
    writer's delta); a GetResult aligned with `keys`."""
    g = get_metrics()
    t0 = time.perf_counter()
    probe = probe_batch(query, keys)
    n = probe.num_rows
    cand = _Candidates()
    if n:
        hashes = key_hashes(probe, query.store.key_names)
        sorted_keys = sorted(probe.to_pylist())
        for bucket, rows in _bucket_groups(query, probe, partition):
            if rows is None or len(rows) == n:
                sub, sub_hashes, sub_keys, back = probe, hashes, sorted_keys, None
            else:
                sub = probe.take(rows)
                sub_hashes = hashes[rows]
                sub_keys = sorted(sub.to_pylist())
                back = rows
            idx = query._get_indexes.get((partition, bucket))
            if idx is not None:
                for fi, pi, rr in idx.probe(sub, sub_hashes, sub_keys):
                    cand.add(fi.kv, pi if back is None else back[pi], rr, _TIER_MAIN)
            mem, delta_files = _delta_sources(query, partition, bucket)
            for didx in delta_files:
                for fi, pi, rr in didx.probe(sub, sub_hashes, sub_keys):
                    cand.add(fi.kv, pi if back is None else back[pi], rr, _TIER_DELTA_FILE)
            if mem is not None:
                g.counter("keys_probed").inc(sub.num_rows)
                pi, rr = mem.probe(sub)
                cand.add(mem.kv, pi if back is None else back[pi], rr, _TIER_MEMTABLE)
    res = cand.resolve(n, query.store.value_schema)
    g.counter("gets").inc(n)
    g.histogram("probe_ms").update((time.perf_counter() - t0) * 1000)
    return res
