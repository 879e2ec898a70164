"""Batch write builder (port of paimon_tpu/table/write.py, fixed-bucket
primary-key tables with bucket=1).

A TableWrite buffers rows in a merge-tree writer per bucket; prepare_commit
drains them into CommitMessages; the BatchTableCommit turns those into one
APPEND snapshot. Hash routing over several buckets, dynamic buckets,
streaming commits and overwrite are not ported yet.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Sequence

import numpy as np

from ..core.commit import BATCH_COMMIT_IDENTIFIER
from ..core.manifest import CommitMessage, ManifestCommittable
from ..data.batch import ColumnBatch
from ..options import CoreOptions
from ..types import RowKind

if TYPE_CHECKING:
    from . import FileStoreTable

__all__ = ["BatchWriteBuilder", "TableWrite", "BatchTableCommit"]


class TableWrite:
    def __init__(self, table: "FileStoreTable"):
        self.table = table
        store = table.store
        if not store.options.write_only:
            raise NotImplementedError(
                "the torch port writes only write-only=true tables (compaction is not ported yet)"
            )
        if store.options.bucket != 1:
            raise NotImplementedError(
                f"bucket={store.options.bucket}: the torch port writes only bucket=1 tables yet"
            )
        if store.partition_keys:
            raise NotImplementedError("partitioned tables are not supported by the torch port yet")
        rowkind_field = store.options.options.get(CoreOptions.ROWKIND_FIELD)
        if rowkind_field:
            raise NotImplementedError(
                f"rowkind.field={rowkind_field}: the torch port takes row kinds only from write()'s kinds argument yet"
            )
        self._writer = None

    def write(self, data: "ColumnBatch | dict", kinds: "np.ndarray | Sequence[str] | None" = None) -> None:
        if isinstance(data, dict):
            data = ColumnBatch.from_pydict(self.table.row_type, data)
        if kinds is not None and not isinstance(kinds, np.ndarray):
            kinds = np.array([int(RowKind.from_short_string(k)) for k in kinds], dtype=np.uint8)
        if self._writer is None:
            self._writer = self.table.store.new_writer((), 0, 1)
        self._writer.write(data, kinds)

    def prepare_commit(self) -> list[CommitMessage]:
        if self._writer is None:
            return []
        msg = self._writer.prepare_commit()
        return [] if msg.is_empty() else [msg]


class BatchTableCommit:
    def __init__(self, table: "FileStoreTable"):
        self.table = table
        self._commit = table.store.new_commit()

    def commit(self, messages: list[CommitMessage]) -> list[int]:
        if not messages:
            return []  # batch commits ignore an empty write
        return self._commit.commit(ManifestCommittable(BatchWriteBuilder.COMMIT_IDENTIFIER, messages=messages))


class BatchWriteBuilder:
    """One-shot batch job: write() everything, then commit() once."""

    COMMIT_IDENTIFIER = BATCH_COMMIT_IDENTIFIER

    def __init__(self, table: "FileStoreTable"):
        self.table = table

    def new_write(self) -> TableWrite:
        return TableWrite(self.table)

    def new_commit(self) -> BatchTableCommit:
        return BatchTableCommit(self.table)
