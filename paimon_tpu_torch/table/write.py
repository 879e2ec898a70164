"""Batch and streaming write builders (port of paimon_tpu/table/write.py,
primary-key tables: fixed buckets, dynamic buckets and partitions).

A TableWrite routes rows to a merge-tree writer per (partition, bucket)
and keeps the writers across commits; prepare_commit drains them into
CommitMessages, with the dynamic-bucket assigner's new hash index files.
A TableCommit turns those into an APPEND snapshot, and a COMPACT snapshot
when a writer compacted. Streaming commits carry ascending identifiers
and go through the replay filter; a batch commit carries the one batch
identifier. Buckets run one after another (the JAX package's mesh and
pipeline routes are not ported). Cross-partition upsert, the local merge
buffer, overwrite, snapshot and partition expiry, the other post-commit
work and bytes primary keys are not ported yet and raise.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Sequence

import numpy as np

from ..core.bucket_index import HashIndexFile, SimpleHashBucketAssigner
from ..core.commit import BATCH_COMMIT_IDENTIFIER
from ..core.manifest import CommitMessage, ManifestCommittable
from ..core.writer import MergeTreeWriter
from ..data.batch import ColumnBatch
from ..options import CoreOptions
from ..types import RowKind, TypeRoot
from .bucket import group_by_partition_bucket, key_hashes

if TYPE_CHECKING:
    from . import FileStoreTable

__all__ = ["BatchWriteBuilder", "StreamWriteBuilder", "TableWrite", "TableCommit", "BatchTableCommit"]


def _check_writable(options: CoreOptions, partition_keys: Sequence[str]) -> None:
    """Raise, naming the option, for what the port's write path would get
    wrong: it writes no changelog files, drops no expired records, expires
    no snapshots or partitions and does none of the JAX package's other
    post-commit work. On a write-only table the JAX package writes a
    changelog only under changelog-producer=input (its flush writes the raw
    input; full-compaction produces its changelog in compactions, which a
    write-only writer never runs, and lookup it refuses there), and it
    expires snapshots after every commit once a retention option is set
    and partitions once partition.expiration-time is set on a partitioned
    table."""
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
    key = opts.set_key(CoreOptions.PARTITION_EXPIRATION_TIME)
    if key is not None and partition_keys:
        raise NotImplementedError(f"{key}: the torch port does not expire partitions after a commit yet")
    post_commit = []
    if opts.get(CoreOptions.COMMIT_FORCE_CREATE_SNAPSHOT):
        post_commit.append(f"{CoreOptions.COMMIT_FORCE_CREATE_SNAPSHOT.key}=true")
    tag = opts.get(CoreOptions.TAG_AUTOMATIC_CREATION)
    if tag not in (None, "none"):
        post_commit.append(f"{CoreOptions.TAG_AUTOMATIC_CREATION.key}={tag}")
    callbacks = opts.get(CoreOptions.COMMIT_CALLBACKS)
    if callbacks:
        post_commit.append(f"{CoreOptions.COMMIT_CALLBACKS.key}={callbacks}")
    if post_commit:
        raise NotImplementedError(
            f"{', '.join(post_commit)}: the torch port creates no empty snapshots or tags and calls no commit "
            "callbacks yet"
        )


def _check_key_types(table: "FileStoreTable") -> None:
    """A bytes primary key is refused before any file is written: the JAX
    package fails to commit such a table (its data-file metadata keeps the
    raw key bytes as JSON min/max keys), so a table the port wrote could
    not be read or continued there."""
    for name in table.store.key_names:
        dtype = table.row_type.field(name).type
        if dtype.root in (TypeRoot.BINARY, TypeRoot.VARBINARY):
            raise NotImplementedError(
                f"primary key column {name!r} is {dtype.serialize()}: the JAX package cannot commit a table keyed "
                "by bytes, so the torch port does not write one"
            )


class TableWrite:
    """Routes rows to one merge-tree writer per (partition, bucket): by
    hash(bucket key) % bucket on a fixed-bucket table, and through the
    hash-index assigner on a dynamic-bucket one (bucket=-1, the default),
    where each key keeps the bucket it was first given."""

    def __init__(self, table: "FileStoreTable"):
        self.table = table
        store = table.store
        co = store.options
        rowkind_field = co.options.get(CoreOptions.ROWKIND_FIELD)
        if rowkind_field:
            raise NotImplementedError(
                f"rowkind.field={rowkind_field}: the torch port takes row kinds only from write()'s kinds argument yet"
            )
        if int(co.options.get(CoreOptions.LOCAL_MERGE_BUFFER_SIZE)) > 0:
            raise NotImplementedError("local-merge-buffer-size: the torch port has no local merge buffer yet")
        _check_writable(co, store.partition_keys)
        _check_key_types(table)
        self.partition_keys = store.partition_keys
        self.bucket_keys = table.schema.bucket_keys
        self.dynamic = co.bucket == -1
        self.num_buckets = max(co.bucket, 1)
        if self.dynamic and not set(self.partition_keys) <= set(table.schema.primary_keys):
            raise NotImplementedError(
                "cross-partition upsert (bucket=-1 with a primary key that omits a partition key) is not "
                "ported to the torch port yet"
            )
        self._writers: dict[tuple, MergeTreeWriter] = {}
        self._assigner = None
        if self.dynamic:
            self._assigner = SimpleHashBucketAssigner(
                HashIndexFile(store.file_io, table.path),
                co.options.get(CoreOptions.DYNAMIC_BUCKET_TARGET_ROW_NUM),
                initial_buckets=co.options.get(CoreOptions.DYNAMIC_BUCKET_INITIAL_BUCKETS),
                num_assigners=co.options.get(CoreOptions.DYNAMIC_BUCKET_ASSIGNER_PARALLELISM) or 1,
            )
            self._bootstrapped: set[tuple] = set()

    def write(self, data: "ColumnBatch | dict", kinds: "np.ndarray | Sequence[str] | None" = None) -> None:
        if isinstance(data, dict):
            data = ColumnBatch.from_pydict(self.table.row_type, data)
        if kinds is not None and not isinstance(kinds, np.ndarray):
            kinds = np.array([int(RowKind.from_short_string(k)) for k in kinds], dtype=np.uint8)
        if self.dynamic:
            self._write_dynamic(data, kinds)
            return
        for partition, bucket, rows in group_by_partition_bucket(
            data, self.partition_keys, self.bucket_keys, self.num_buckets
        ):
            self._writer(partition, bucket).write(*_take(data, kinds, rows))

    def _write_dynamic(self, data: ColumnBatch, kinds: "np.ndarray | None") -> None:
        for partition, _, rows in group_by_partition_bucket(data, self.partition_keys, [], 1):
            sub, sub_kinds = _take(data, kinds, rows)
            self._bootstrap_partition(partition)
            buckets = self._assigner.assign(partition, key_hashes(sub, self.table.store.key_names))
            for b in np.unique(buckets):
                mask = buckets == b
                self._writer(partition, int(b)).write(sub.filter(mask), sub_kinds[mask] if sub_kinds is not None else None)

    def _bootstrap_partition(self, partition: tuple) -> None:
        """Seed the assigner with the partition's hash index from the latest
        snapshot, so that a key written before keeps its bucket."""
        if partition in self._bootstrapped:
            return
        self._bootstrapped.add(partition)
        store = self.table.store
        plan = store.new_scan().with_partition_filter(lambda p: p == partition).plan()
        hif = HashIndexFile(store.file_io, self.table.path)
        indexes = {e.bucket: hif.read(e.file_name) for e in plan.index_entries if e.kind == "HASH_INDEX"}
        if indexes:
            self._assigner.bootstrap(partition, indexes)

    def _writer(self, partition: tuple, bucket: int) -> MergeTreeWriter:
        key = (partition, bucket)
        if key not in self._writers:
            total = -1 if self.dynamic else self.num_buckets
            self._writers[key] = self.table.store.new_writer(partition, bucket, total)
        return self._writers[key]

    def compact(self, full: bool = False) -> None:
        """Compact every bucket this write touched or, when no rows were
        written (a dedicated compaction job), every live bucket of the
        table, one after another."""
        if not self._writers:
            for partition, buckets in self.table.store.new_scan().plan().grouped().items():
                for bucket in buckets:
                    self._writer(partition, bucket)
        for w in self._writers.values():
            w.compact(full=full)

    def prepare_commit(self) -> list[CommitMessage]:
        store = self.table.store
        if store.options.options.get(CoreOptions.COMMIT_FORCE_COMPACT) and not store.options.write_only:
            self.compact(full=True)
        msgs = [m for m in (w.prepare_commit() for w in self._writers.values()) if not m.is_empty()]
        if self._assigner is not None:
            by_pb = {(m.partition, m.bucket): m for m in msgs}
            for partition, entries in self._assigner.prepare_commit().items():
                for e in entries:
                    msg = by_pb.get((partition, e.bucket))
                    if msg is None:
                        msg = by_pb[(partition, e.bucket)] = CommitMessage(partition, e.bucket, -1)
                        msgs.append(msg)
                    msg.new_index_files.append(e)
        return msgs


def _take(data: ColumnBatch, kinds: "np.ndarray | None", rows: np.ndarray) -> tuple:
    """The rows of one (partition, bucket), and their kinds."""
    if len(rows) == data.num_rows:
        return data, kinds
    return data.take(rows), None if kinds is None else kinds.take(rows)


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
