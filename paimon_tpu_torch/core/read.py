"""Merge-on-read: sections -> device merge -> batches (port of
paimon_tpu/core/read.py). Files decode serially, with no thread pool.

A single-run section needs no merge. Under the deduplicate engine a
multi-run section takes the keys-only pipeline (`_pipelined_dedup`):
decode the key columns, dispatch the dedup kernel without waiting, decode
the value columns while the device sorts, then gather the winners on the
host. The other engines need every column to merge: they decode the
section whole and merge it in one MergeExecutor call. read_kv merges
whole sections into key-value rows, kinds and sequence numbers kept (the
lookup changelog producer reads a bucket's state with it).

A predicate is split as the JAX package splits it: the whole of it may
skip row groups of a single-run section (its keys are unique), only its
key-only conjuncts those of a merged section (a row failing a value
conjunct may still be a key's newest version, which hides the older
ones); the whole predicate then filters the merged rows. Deletion vectors
drop their rows from each file before any merge; a section that holds a
file with one leaves the keys-only pipeline for the full-decode merge.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..data.batch import Column, ColumnBatch, concat_batches
from ..data.predicate import Predicate, PredicateBuilder, and_
from .datafile import DataFileMeta, KeyValueFileReaderFactory
from .kv import KVBatch
from .levels import IntervalPartition
from .mergefn import MergeExecutor

__all__ = ["MergeFileSplitRead", "order_runs_for_merge", "read_live"]


def order_runs_for_merge(section) -> tuple[list, bool]:
    """Order a section's runs by ascending sequence range and report whether
    the ranges are pairwise disjoint; disjoint + ordered means equal keys
    appear in ascending seq order after concatenation, so sort stability
    replaces the sequence lanes."""
    runs = sorted(section, key=lambda r: min(f.min_sequence_number for f in r.files))
    disjoint = True
    prev_max = None
    for r in runs:
        lo = min(f.min_sequence_number for f in r.files)
        hi = max(f.max_sequence_number for f in r.files)
        if prev_max is not None and lo <= prev_max:
            disjoint = False
            break
        prev_max = hi
    return runs, disjoint


def read_live(reader_factory: KeyValueFileReaderFactory, f: DataFileMeta, dvs: dict, predicate=None) -> KVBatch:
    """One file's rows without those its deletion vector (in `dvs`, by file
    name) marks. A file with a vector is read whole: its positions count
    rows in file order, so no row group may be skipped; other files skip
    the row groups `predicate` rules out."""
    dv = dvs.get(f.file_name)
    if dv is None:
        return reader_factory.read(f, predicate=predicate)
    kv = reader_factory.read(f)
    keep = ~dv.deleted_mask(kv.num_rows)
    return kv if keep.all() else kv.filter(keep)


class MergeFileSplitRead:
    def __init__(self, reader_factory: KeyValueFileReaderFactory, merge_executor: MergeExecutor, key_names: Sequence[str]):
        self.reader_factory = reader_factory
        self.merge = merge_executor
        self.key_names = set(key_names)

    def read_split(
        self,
        files: list[DataFileMeta],
        predicate: Predicate | None = None,
        projection: Sequence[str] | None = None,
        drop_delete: bool = True,
        deletion_vectors: dict | None = None,
    ) -> ColumnBatch:
        """Merge-read one bucket's files: value rows, key-sorted within each
        section, that pass `predicate`, without the rows that
        `deletion_vectors` ({data file name: DeletionVector}) mark."""
        key_parts = PredicateBuilder.pick_by_fields(PredicateBuilder.split_and(predicate), self.key_names)
        key_filter = and_(*key_parts) if key_parts else None
        dvs = deletion_vectors or {}
        out: list[ColumnBatch] = []
        for section in IntervalPartition(files).partition():
            if len(section) == 1:
                # one sorted run: its keys are unique, so the whole predicate
                # may skip row groups
                kv = KVBatch.concat([self._read_file(f, predicate, dvs) for f in section[0].files])
            else:
                runs, seq_ascending = order_runs_for_merge(section)
                ordered = [f for run in runs for f in run.files]
                # a file with a deletion vector needs its rows in file order
                # and every column at once: the full-decode merge
                if self.merge.supports_keys_only_pipeline() and not any(f.file_name in dvs for f in ordered):
                    kv = self._pipelined_dedup(ordered, key_filter, seq_ascending)
                else:
                    kv = KVBatch.concat([self._read_file(f, key_filter, dvs) for f in ordered])
                    kv = self.merge.merge(kv, seq_ascending=seq_ascending)
            if drop_delete:
                kv = kv.drop_deletes()
            data = kv.data
            if predicate is not None and data.num_rows:
                mask = predicate.eval(data)
                if not mask.all():
                    data = data.filter(mask)
            out.append(data.select(projection) if projection is not None else data)
        if not out:
            schema = self.reader_factory.read_schema
            return ColumnBatch.empty(schema.project(projection) if projection is not None else schema)
        return concat_batches(out)

    def _read_file(self, f: DataFileMeta, predicate: Predicate | None, dvs: dict) -> KVBatch:
        return read_live(self.reader_factory, f, dvs, predicate)

    def _pipelined_dedup(self, ordered_files, key_filter: Predicate | None, seq_ascending: bool) -> KVBatch:
        schema = self.reader_factory.read_schema
        key_names = [n for n in schema.field_names if n in self.key_names]
        rest_names = [n for n in schema.field_names if n not in self.key_names]
        # with disjoint, ordered seq ranges only _VALUE_KIND is needed; both
        # passes skip the same row groups (one predicate), so they align
        sys_cols = "kind" if seq_ascending else True
        heads = [
            self.reader_factory.read(f, fields=key_names, system_columns=sys_cols, predicate=key_filter)
            for f in ordered_files
        ]
        kv_keys = KVBatch.concat(heads)
        if kv_keys.num_rows == 0:
            return KVBatch(ColumnBatch.empty(schema), np.empty(0, dtype=np.int64), np.empty(0, dtype=np.uint8))
        run_offsets = [0]
        for h in heads:
            run_offsets.append(run_offsets[-1] + h.num_rows)
        handle = self.merge.dedup_select_async(kv_keys, seq_ascending, run_offsets=run_offsets)
        if rest_names:
            tails = [
                self.reader_factory.read(f, fields=rest_names, system_columns=False, predicate=key_filter)
                for f in ordered_files
            ]
            cols = {
                name: kv_keys.data.column(name)
                if name in self.key_names
                else Column.concat([t.data.column(name) for t in tails])
                for name in schema.field_names
            }
            data = ColumnBatch(schema, cols)
        else:
            data = kv_keys.data
        return KVBatch(data, kv_keys.seq, kv_keys.kind).take(self.merge.dedup_resolve(handle))

    def read_kv(
        self, files: list[DataFileMeta], drop_delete: bool = False, deletion_vectors: dict | None = None
    ) -> KVBatch:
        """The files' merged key-value rows, each section key-sorted, in
        section order, without the rows `deletion_vectors` mark."""
        dvs = deletion_vectors or {}
        parts: list[KVBatch] = []
        for section in IntervalPartition(files).partition():
            runs, seq_ascending = order_runs_for_merge(section)
            kv = KVBatch.concat([self._read_file(f, None, dvs) for run in runs for f in run.files])
            if len(section) > 1:
                kv = self.merge.merge(kv, seq_ascending=seq_ascending)
            parts.append(kv.drop_deletes() if drop_delete else kv)
        if not parts:
            return KVBatch(
                ColumnBatch.empty(self.reader_factory.read_schema), np.empty(0, dtype=np.int64), np.empty(0, np.uint8)
            )
        return KVBatch.concat(parts)
