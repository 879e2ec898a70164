"""Batch and streaming write builders (port of paimon_tpu/table/write.py,
fixed-bucket primary-key tables with bucket=1).

A TableWrite buffers rows in a merge-tree writer per bucket and keeps it
across commits; prepare_commit drains it into CommitMessages. A
TableCommit turns those into an APPEND snapshot, and a COMPACT snapshot
when the writer compacted. Streaming commits carry ascending identifiers
and go through the replay filter; a batch commit carries the one batch
identifier. Hash routing over several buckets, dynamic buckets, overwrite
and snapshot expiry are not ported yet.
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

__all__ = ["BatchWriteBuilder", "StreamWriteBuilder", "TableWrite", "TableCommit", "BatchTableCommit"]


def _check_writable(options: CoreOptions) -> None:
    """Raise, naming the option, for what the port's write path would get
    wrong: it writes no changelog files, drops no expired records and
    expires no snapshots. On a write-only table the JAX package writes a
    changelog only under changelog-producer=input (its flush writes the raw
    input; full-compaction produces its changelog in compactions, which a
    write-only writer never runs, and lookup it refuses there), and it
    expires snapshots after every commit once a retention option is set."""
    opts = options.options
    producer = str(opts.get(CoreOptions.CHANGELOG_PRODUCER)).lower()
    if producer != "none" and (not options.write_only or producer == "input"):
        raise NotImplementedError(f"changelog-producer={producer}: the torch port writes no changelog files yet")
    if not options.write_only:
        key = opts.set_key(CoreOptions.RECORD_LEVEL_EXPIRE_TIME)
        if key is not None:
            raise NotImplementedError(
                f"{key}: the torch port does not drop expired records in compaction yet"
            )
    for option in (CoreOptions.SNAPSHOT_NUM_RETAINED_MAX, CoreOptions.SNAPSHOT_TIME_RETAINED):
        key = opts.set_key(option)
        if key is not None:
            raise NotImplementedError(f"{key}: the torch port does not expire snapshots after a commit yet")


class TableWrite:
    def __init__(self, table: "FileStoreTable"):
        self.table = table
        store = table.store
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
        _check_writable(store.options)
        self._writer = None

    def write(self, data: "ColumnBatch | dict", kinds: "np.ndarray | Sequence[str] | None" = None) -> None:
        if isinstance(data, dict):
            data = ColumnBatch.from_pydict(self.table.row_type, data)
        if kinds is not None and not isinstance(kinds, np.ndarray):
            kinds = np.array([int(RowKind.from_short_string(k)) for k in kinds], dtype=np.uint8)
        self._open_writer().write(data, kinds)

    def _open_writer(self):
        if self._writer is None:
            self._writer = self.table.store.new_writer((), 0, 1)
        return self._writer

    def compact(self, full: bool = False) -> None:
        """Compact the table's one bucket, restored from the latest
        snapshot when no rows were written."""
        self._open_writer().compact(full=full)

    def prepare_commit(self) -> list[CommitMessage]:
        store = self.table.store
        if store.options.options.get(CoreOptions.COMMIT_FORCE_COMPACT) and not store.options.write_only:
            self.compact(full=True)
        if self._writer is None:
            return []
        msg = self._writer.prepare_commit()
        return [] if msg.is_empty() else [msg]


class TableCommit:
    def __init__(self, table: "FileStoreTable"):
        self.table = table
        self._commit = table.store.new_commit()

    def commit_messages(self, identifier: int, messages: list[CommitMessage], watermark: int | None = None) -> list[int]:
        """Commit under `identifier`; a streaming identifier this user
        already committed is filtered (replay safety). Returns the snapshot
        ids written."""
        c = ManifestCommittable(identifier, watermark=watermark, messages=messages)
        if identifier != BATCH_COMMIT_IDENTIFIER:
            remaining = self._commit.filter_committed([c])
            if not remaining:
                return []
            c = remaining[0]
        return self._commit.commit(c)

    def filter_and_commit(self, committables: list[ManifestCommittable]) -> int:
        """Replay-safe commit of several committables: identifiers already
        committed are skipped; returns how many were committed."""
        remaining = self._commit.filter_committed(committables)
        for c in sorted(remaining, key=lambda x: x.commit_identifier):
            self._commit.commit(c)
        return len(remaining)


class BatchTableCommit(TableCommit):
    def commit(self, messages: list[CommitMessage]) -> list[int]:
        if not messages:
            return []  # batch commits ignore an empty write
        return self.commit_messages(BATCH_COMMIT_IDENTIFIER, messages)


class BatchWriteBuilder:
    """One-shot batch job: write() everything, then commit() once."""

    COMMIT_IDENTIFIER = BATCH_COMMIT_IDENTIFIER

    def __init__(self, table: "FileStoreTable"):
        self.table = table

    def new_write(self) -> TableWrite:
        return TableWrite(self.table)

    def new_commit(self) -> BatchTableCommit:
        return BatchTableCommit(self.table)


class StreamWriteBuilder:
    """Continuous ingestion: one TableWrite for the whole stream (its
    writer and levels live across commits), and a commit per checkpoint
    with an ascending identifier."""

    def __init__(self, table: "FileStoreTable"):
        self.table = table

    def new_write(self) -> TableWrite:
        return TableWrite(self.table)

    def new_commit(self) -> TableCommit:
        return TableCommit(self.table)
