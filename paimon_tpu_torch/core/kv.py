"""KeyValue batches: rows + sequence numbers + row kinds (port of
paimon_tpu/core/kv.py).

On disk a key-value data file holds `_SEQUENCE_NUMBER BIGINT,
_VALUE_KIND TINYINT` and then the value fields; the primary key is a subset
of the value fields and is not duplicated.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..data.batch import Column, ColumnBatch, concat_batches
from ..types import BIGINT, TINYINT, DataField, RowKind, RowType

__all__ = ["KVBatch", "SEQUENCE_FIELD_NAME", "VALUE_KIND_FIELD_NAME", "kv_disk_schema"]

SEQUENCE_FIELD_NAME = "_SEQUENCE_NUMBER"
VALUE_KIND_FIELD_NAME = "_VALUE_KIND"
LEVEL_FIELD_ID_BASE = 2147480000


def kv_disk_schema(value_schema: RowType) -> RowType:
    return RowType(
        [
            DataField(LEVEL_FIELD_ID_BASE + 1, SEQUENCE_FIELD_NAME, BIGINT(False)),
            DataField(LEVEL_FIELD_ID_BASE + 2, VALUE_KIND_FIELD_NAME, TINYINT(False)),
            *value_schema.fields,
        ]
    )


@dataclass
class KVBatch:
    """data (value schema), seq (int64), kind (uint8)."""

    data: ColumnBatch
    seq: np.ndarray
    kind: np.ndarray

    def __post_init__(self):
        assert len(self.seq) == len(self.kind) == self.data.num_rows
        assert self.seq.dtype == np.int64 and self.kind.dtype == np.uint8

    @property
    def num_rows(self) -> int:
        return self.data.num_rows

    def byte_size(self) -> int:
        return self.data.byte_size() + self.seq.nbytes + self.kind.nbytes

    def take(self, indices: np.ndarray) -> "KVBatch":
        return KVBatch(self.data.take(indices), self.seq.take(indices), self.kind.take(indices))

    def filter(self, mask: np.ndarray) -> "KVBatch":
        return KVBatch(self.data.filter(mask), self.seq[mask], self.kind[mask])

    def slice(self, start: int, stop: int) -> "KVBatch":
        return KVBatch(self.data.slice(start, stop), self.seq[start:stop], self.kind[start:stop])

    @staticmethod
    def concat(batches: Sequence["KVBatch"]) -> "KVBatch":
        if len(batches) == 1:
            return batches[0]
        return KVBatch(
            concat_batches([b.data for b in batches]),
            np.concatenate([b.seq for b in batches]),
            np.concatenate([b.kind for b in batches]),
        )

    @staticmethod
    def from_rows(data: ColumnBatch, start_seq: int, kinds: np.ndarray | None = None) -> "KVBatch":
        n = data.num_rows
        seq = np.arange(start_seq, start_seq + n, dtype=np.int64)
        if kinds is None:
            kinds = np.full(n, int(RowKind.INSERT), dtype=np.uint8)
        return KVBatch(data, seq, kinds)

    def to_disk_batch(self) -> ColumnBatch:
        cols = {SEQUENCE_FIELD_NAME: Column(self.seq), VALUE_KIND_FIELD_NAME: Column(self.kind.astype(np.int8))}
        cols.update(self.data.columns)
        return ColumnBatch(kv_disk_schema(self.data.schema), cols)

    def drop_deletes(self) -> "KVBatch":
        """Batch reads strip -D/-U rows after merging."""
        keep = ~np.isin(self.kind, (int(RowKind.DELETE), int(RowKind.UPDATE_BEFORE)))
        return self if keep.all() else self.filter(keep)
