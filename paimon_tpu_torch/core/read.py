"""Merge-on-read: sections -> device merge -> batches (port of
paimon_tpu/core/read.py). Files decode serially, with no thread pool.

A single-run section needs no merge. Under the deduplicate engine a
multi-run section takes the keys-only pipeline (`_pipelined_dedup`):
decode the key columns, dispatch the dedup kernel without waiting, decode
the value columns while the device sorts, then gather the winners on the
host. The other engines need every column to merge: they decode the
section whole and merge it in one MergeExecutor call.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..data.batch import Column, ColumnBatch, concat_batches
from .datafile import DataFileMeta, KeyValueFileReaderFactory
from .kv import KVBatch
from .levels import IntervalPartition
from .mergefn import MergeExecutor

__all__ = ["MergeFileSplitRead", "order_runs_for_merge"]


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


class MergeFileSplitRead:
    def __init__(self, reader_factory: KeyValueFileReaderFactory, merge_executor: MergeExecutor, key_names: Sequence[str]):
        self.reader_factory = reader_factory
        self.merge = merge_executor
        self.key_names = set(key_names)

    def read_split(
        self, files: list[DataFileMeta], projection: Sequence[str] | None = None, drop_delete: bool = True
    ) -> ColumnBatch:
        """Merge-read one bucket's files: value rows, key-sorted within each
        section."""
        out: list[ColumnBatch] = []
        for section in IntervalPartition(files).partition():
            if len(section) == 1:
                kv = KVBatch.concat([self.reader_factory.read(f) for f in section[0].files])
            else:
                runs, seq_ascending = order_runs_for_merge(section)
                ordered = [f for run in runs for f in run.files]
                if self.merge.supports_keys_only_pipeline():
                    kv = self._pipelined_dedup(ordered, seq_ascending)
                else:
                    kv = KVBatch.concat([self.reader_factory.read(f) for f in ordered])
                    kv = self.merge.merge(kv, seq_ascending=seq_ascending)
            if drop_delete:
                kv = kv.drop_deletes()
            data = kv.data
            out.append(data.select(projection) if projection is not None else data)
        if not out:
            schema = self.reader_factory.read_schema
            return ColumnBatch.empty(schema.project(projection) if projection is not None else schema)
        return concat_batches(out)

    def _pipelined_dedup(self, ordered_files, seq_ascending: bool) -> KVBatch:
        schema = self.reader_factory.read_schema
        key_names = [n for n in schema.field_names if n in self.key_names]
        rest_names = [n for n in schema.field_names if n not in self.key_names]
        # with disjoint, ordered seq ranges only _VALUE_KIND is needed
        sys_cols = "kind" if seq_ascending else True
        heads = [self.reader_factory.read(f, fields=key_names, system_columns=sys_cols) for f in ordered_files]
        kv_keys = KVBatch.concat(heads)
        if kv_keys.num_rows == 0:
            return KVBatch(ColumnBatch.empty(schema), np.empty(0, dtype=np.int64), np.empty(0, dtype=np.uint8))
        run_offsets = [0]
        for h in heads:
            run_offsets.append(run_offsets[-1] + h.num_rows)
        handle = self.merge.dedup_select_async(kv_keys, seq_ascending, run_offsets=run_offsets)
        if rest_names:
            tails = [self.reader_factory.read(f, fields=rest_names, system_columns=False) for f in ordered_files]
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
