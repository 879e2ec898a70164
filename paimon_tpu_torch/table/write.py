"""Batch and streaming write builders (port of paimon_tpu/table/write.py).

A TableWrite routes rows to one writer per (partition, bucket) and keeps
the writers across commits; prepare_commit drains them into
CommitMessages, with the dynamic-bucket assigner's new hash index files.
Primary-key tables route by hash(bucket key) % bucket, by the hash-index
assigner (bucket=-1), or, when the primary key omits a partition key, by
the global index of table/crosspartition.py; append tables route by
hash(bucket key) % bucket, or every row to bucket 0 of its partition
(bucket=-1), to the append writers of core/append.py. Row kinds come from
write()'s kinds argument or, under rowkind.field, from that column.
Under local-merge-buffer-size the rows are buffered before routing and
each key's last row kept (the table's sort-engine selects).

A TableCommit turns messages into an APPEND snapshot, and a COMPACT
snapshot when a writer compacted. Streaming commits carry ascending
identifiers and go through the replay filter; a batch commit carries the
one batch identifier, and under with_overwrite is an OVERWRITE snapshot
of the partitions the filter selects (under dynamic-partition-overwrite,
with no filter, those the new rows touch). After each commit the table's
maintenance runs, in the JAX package's order: commit callbacks, automatic
tags, snapshot expiry and partition expiry; a failure there never fails
the commit, and is reported with warnings.warn. Buckets run one after
another (the JAX package's mesh and pipeline routes are not ported).
Bytes primary keys raise.
"""

from __future__ import annotations

import importlib
import warnings
from typing import TYPE_CHECKING, Callable, Sequence

import numpy as np

from ..core.bucket_index import HashIndexFile, SimpleHashBucketAssigner
from ..core.commit import BATCH_COMMIT_IDENTIFIER
from ..core.manifest import CommitMessage, ManifestCommittable
from ..data.batch import ColumnBatch, concat_batches
from ..data.keys import encode_key_lanes_with_pools
from ..options import ConfigOption, CoreOptions, MergeEngine
from ..types import RowKind, TypeRoot
from ..utils import now_millis
from .bucket import group_by_partition_bucket, key_hashes
from .crosspartition import CrossPartitionUpsertWrite
from .maintenance import expire_partitions
from .tags import TagAutoCreation

if TYPE_CHECKING:
    from . import FileStoreTable

__all__ = [
    "BatchWriteBuilder",
    "StreamWriteBuilder",
    "TableWrite",
    "TableCommit",
    "BatchTableCommit",
    "load_callbacks",
    "run_maintenance",
]


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
    """Routes rows to one writer per (partition, bucket): by hash(bucket
    key) % bucket on a fixed-bucket table, through the hash-index assigner
    on a dynamic-bucket one (bucket=-1, the default), where each key keeps
    the bucket it was first given, through the global index when the
    primary key omits a partition key, and to bucket 0 on an append table
    with bucket=-1."""

    def __init__(self, table: "FileStoreTable"):
        self.table = table
        store = table.store
        co = store.options
        _check_key_types(table)
        self.partition_keys = store.partition_keys
        self.bucket_keys = table.schema.bucket_keys
        self.dynamic = table.is_primary_key_table and co.bucket == -1
        self.num_buckets = max(co.bucket, 1)
        self._writers: dict[tuple, object] = {}
        self._assigner = None
        self._cross = None
        if self.dynamic and self.partition_keys and not set(self.partition_keys) <= set(table.primary_keys):
            self._init_local_merge()  # its checks hold here too
            if self._local_merge_cap:
                raise ValueError("local-merge-buffer-size is not supported with cross-partition upsert")
            self._cross = CrossPartitionUpsertWrite(table)
            return
        if self.dynamic:
            self._assigner = SimpleHashBucketAssigner(
                HashIndexFile(store.file_io, table.path),
                co.options.get(CoreOptions.DYNAMIC_BUCKET_TARGET_ROW_NUM),
                initial_buckets=co.options.get(CoreOptions.DYNAMIC_BUCKET_INITIAL_BUCKETS),
                num_assigners=co.options.get(CoreOptions.DYNAMIC_BUCKET_ASSIGNER_PARALLELISM) or 1,
            )
            self._bootstrapped: set[tuple] = set()
        self._init_local_merge()

    def _init_local_merge(self) -> None:
        """local-merge-buffer-size: rows wait in a buffer before routing,
        and each key keeps its last row there. The JAX package's checks, in
        its order and words."""
        co = self.table.store.options
        size = int(co.options.get(CoreOptions.LOCAL_MERGE_BUFFER_SIZE))
        self._local_merge_bytes = 0
        self._local_buffer: list[tuple[ColumnBatch, np.ndarray | None]] = []
        self._local_merge_cap = 0
        if size > 0:
            if co.merge_engine != MergeEngine.DEDUPLICATE:
                raise ValueError("local-merge-buffer-size requires merge-engine=deduplicate")
            if not self.table.is_primary_key_table:
                raise ValueError("local-merge-buffer-size requires a primary-key table")
            if co.sequence_field:
                # the buffer keeps the last arrival: a late row could evict
                # one with a higher sequence field
                raise ValueError("local-merge-buffer-size cannot combine with sequence.field")
            if co.ignore_delete:
                # a trailing -D would evict its insert here and then be
                # dropped downstream
                raise ValueError("local-merge-buffer-size cannot combine with ignore-delete")
            self._local_merge_cap = size

    def _local_merge_flush(self) -> None:
        """Keep each key's last buffered row, with its kind, and route
        those. The key is the full primary key, partition columns
        included: the buffer spans partitions."""
        if not self._local_buffer:
            return
        data = concat_batches([b for b, _ in self._local_buffer])
        kinds = np.concatenate([
            k if k is not None else np.full(b.num_rows, int(RowKind.INSERT), dtype=np.uint8)
            for b, k in self._local_buffer
        ])
        self._local_buffer = []
        self._local_merge_bytes = 0
        lanes = encode_key_lanes_with_pools(data, self.table.primary_keys)
        take = self.table.store.merge_executor().select_last(lanes)
        self._route(data.take(take), kinds.take(take))

    def write(self, data: "ColumnBatch | dict", kinds: "np.ndarray | Sequence[str] | None" = None) -> None:
        if isinstance(data, dict):
            data = ColumnBatch.from_pydict(self.table.row_type, data)
        if kinds is not None and not isinstance(kinds, np.ndarray):
            kinds = np.array([int(RowKind.from_short_string(k)) for k in kinds], dtype=np.uint8)
        if kinds is None:
            rowkind_field = self.table.options.options.get(CoreOptions.ROWKIND_FIELD)
            if rowkind_field:
                kinds = _kinds_from_column(data.column(rowkind_field).values)
        if self._cross is not None:
            self._cross.write(data, kinds)
            return
        if self._local_merge_cap:
            self._local_buffer.append((data, kinds))
            self._local_merge_bytes += data.byte_size()
            if self._local_merge_bytes >= self._local_merge_cap:
                self._local_merge_flush()
            return
        self._route(data, kinds)

    def _route(self, data: ColumnBatch, kinds: "np.ndarray | None") -> None:
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

    def _writer(self, partition: tuple, bucket: int):
        key = (partition, bucket)
        if key not in self._writers:
            total = -1 if self.dynamic else self.num_buckets
            self._writers[key] = self.table.store.new_writer(partition, bucket, total)
        return self._writers[key]

    def delta_snapshot(self) -> dict[tuple, tuple]:
        """{(partition, bucket): (buffered KVBatches, uncommitted level-0
        files)} of every merge-tree writer this write opened: the
        read-your-writes tier of LocalTableQuery.attach_write."""
        out: dict[tuple, tuple] = {}
        for pb, w in list(self._writers.items()):
            ds = getattr(w, "delta_snapshot", None)
            if ds is not None:
                out[pb] = ds()
        return out

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
        if self._cross is not None:
            return self._cross.prepare_commit()
        if self._local_merge_cap:
            self._local_merge_flush()
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


_SHORT_KINDS = ("+I", "-U", "+U", "-D")


def _kinds_from_column(values: np.ndarray) -> np.ndarray:
    """rowkind.field: each row's kind from its value's text ('+I', '-U',
    '+U', '-D'), as RowKind.from_short_string(str(value)) reads it; the
    first value in row order that is none of them raises its KeyError."""
    text = np.asarray(values).astype(str)
    short, inverse = np.unique(text, return_inverse=True)
    known = np.isin(short, _SHORT_KINDS)
    if not known.all():
        RowKind.from_short_string(str(values[int(np.argmax(~known[inverse]))]))
    lut = np.array([int(RowKind.from_short_string(k)) for k in short.tolist()], dtype=np.uint8)
    return lut[inverse.reshape(-1)]


def _take(data: ColumnBatch, kinds: "np.ndarray | None", rows: np.ndarray) -> tuple:
    """The rows of one (partition, bucket), and their kinds."""
    if len(rows) == data.num_rows:
        return data, kinds
    return data.take(rows), None if kinds is None else kinds.take(rows)


def load_callbacks(table: "FileStoreTable", option: ConfigOption) -> list[Callable]:
    """The callables a 'module:function,module:function' option names; one
    that does not resolve raises here, since a callback dropped silently is
    worse than a loud configuration error."""
    spec = table.options.options.get(option)
    if not spec:
        return []
    out = []
    for item in spec.split(","):
        mod, _, fn = item.strip().partition(":")
        out.append(getattr(importlib.import_module(mod), fn))
    return out


def run_maintenance(what: str, fn: Callable, *args) -> None:
    """Call fn(*args). Maintenance never fails a commit: an exception is
    reported with warnings.warn, naming `what` and the exception, and
    dropped."""
    try:
        fn(*args)
    except Exception as exc:  # noqa: BLE001 - the commit has landed already
        warnings.warn(f"{what} failed after a commit: {exc!r}", RuntimeWarning, stacklevel=2)


class TableCommit:
    def __init__(self, table: "FileStoreTable", expire_after_commit: bool = True):
        """expire_after_commit=False leaves snapshot and partition expiry to
        another job (callbacks and automatic tags still run)."""
        self.table = table
        self._commit = table.store.new_commit()
        self.expire_after_commit = expire_after_commit

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
        snapshot_ids = self._commit.commit(c)
        self._post_commit()
        return snapshot_ids

    def filter_and_commit(self, committables: list[ManifestCommittable]) -> int:
        """Replay-safe commit of several committables: identifiers already
        committed are skipped; returns how many were committed."""
        remaining = self._commit.filter_committed(committables)
        for c in sorted(remaining, key=lambda x: x.commit_identifier):
            self._commit.commit(c)
        if remaining:
            self._post_commit()
        return len(remaining)

    def overwrite(
        self, identifier: int, messages: list[CommitMessage], partition_filter: "Callable[[tuple], bool] | None" = None
    ) -> list[int]:
        """One OVERWRITE snapshot: the live files of the partitions
        `partition_filter` selects (all when None) replaced by the
        messages' new files; maintenance then runs as after any commit."""
        ids = self._commit.overwrite(ManifestCommittable(identifier, messages=messages), partition_filter)
        self._post_commit()
        return ids

    def _post_commit(self) -> None:
        """Commit callbacks with the latest snapshot, automatic tags, then
        (under expire_after_commit) snapshot and partition expiry."""
        table = self.table
        snap = table.store.snapshot_manager.latest_snapshot()
        for fn in load_callbacks(table, CoreOptions.COMMIT_CALLBACKS):
            run_maintenance(f"commit callback {fn.__name__}", fn, table, snap)
        run_maintenance("automatic tag creation", lambda: TagAutoCreation(table).run())
        if self.expire_after_commit:
            run_maintenance("snapshot expiry", table.expire_snapshots)
            self._maybe_expire_partitions()

    def _maybe_expire_partitions(self) -> None:
        """Sweep expired partitions (partition.expiration-time on a
        partitioned table) at most once per
        partition.expiration-check-interval."""
        table = self.table
        opts = table.options.options
        ttl = opts.get(CoreOptions.PARTITION_EXPIRATION_TIME)
        if ttl is None or not table.partition_keys:
            return
        now = now_millis()
        store = table.store
        if now - store.last_partition_expire_check < (opts.get(CoreOptions.PARTITION_EXPIRATION_CHECK_INTERVAL) or 0):
            return
        store.last_partition_expire_check = now
        # partition.timestamp-pattern names the column ('$dt');
        # partition.timestamp-formatter is a strptime pattern
        col_spec = opts.get(CoreOptions.PARTITION_TIMESTAMP_PATTERN)
        run_maintenance(
            "partition expiry",
            expire_partitions,
            table,
            ttl,
            col_spec.lstrip("$") if col_spec else None,
            opts.get(CoreOptions.PARTITION_TIMESTAMP_FORMATTER) or "%Y-%m-%d",
        )


class BatchTableCommit(TableCommit):
    def __init__(
        self, table: "FileStoreTable", overwrite: bool = False, partition_filter: "Callable[[tuple], bool] | None" = None
    ):
        super().__init__(table)
        self._overwrite = overwrite
        self._partition_filter = partition_filter

    def commit(self, messages: list[CommitMessage]) -> list[int]:
        """Commit under the batch identifier. An overwrite replaces the
        partitions its filter selects; with no filter, on a partitioned
        table under dynamic-partition-overwrite (the default), the
        partitions the messages touch, else the whole table. Otherwise an
        empty write commits nothing unless commit.force-create-snapshot is
        set."""
        opts = self.table.options.options
        if self._overwrite:
            pf = self._partition_filter
            if pf is None and self.table.partition_keys and opts.get(CoreOptions.DYNAMIC_PARTITION_OVERWRITE):
                touched = {m.partition for m in messages}
                pf = touched.__contains__
            return self.overwrite(BATCH_COMMIT_IDENTIFIER, messages, pf)
        if not messages and not opts.get(CoreOptions.COMMIT_FORCE_CREATE_SNAPSHOT):
            return []
        return self.commit_messages(BATCH_COMMIT_IDENTIFIER, messages)


class BatchWriteBuilder:
    """One-shot batch job: write() everything, then commit() once."""

    COMMIT_IDENTIFIER = BATCH_COMMIT_IDENTIFIER

    def __init__(self, table: "FileStoreTable"):
        self.table = table
        self._overwrite = False
        self._partition_filter = None

    def with_overwrite(self, partition_filter: "Callable[[tuple], bool] | None" = None) -> "BatchWriteBuilder":
        """INSERT OVERWRITE: the commit replaces the partitions
        `partition_filter` (partition tuple -> bool) selects."""
        self._overwrite = True
        self._partition_filter = partition_filter
        return self

    def new_write(self) -> TableWrite:
        return TableWrite(self.table)

    def new_commit(self) -> BatchTableCommit:
        return BatchTableCommit(self.table, self._overwrite, self._partition_filter)


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
