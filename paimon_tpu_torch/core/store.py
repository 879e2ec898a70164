"""The file stores: one table's components wired from its schema and
options (port of paimon_tpu/core/store.py). KeyValueFileStore serves
primary-key tables, AppendOnlyFileStore the tables without one.

A bucket's writer is restored from its live files and deletion vectors;
its compactions drop the vectors' rows and the rows that record-level TTL
expires, and every read ANDs the TTL into its predicate. A write-only
primary-key writer flushes through the adaptive compactor's debt gate
when compaction.adaptive.ingest-gate is on (table/compactor.py).

Layout, the JAX package's: table/[k1=v1/k2=v2/]bucket-B/data-*.parquet,
with the hash index of dynamic-bucket tables under table/index/.

The store hands its scans, commits and snapshot manager the process-wide
manifest cache and its reader factories the data-file cache
(utils/cache.py), each None where the table set its budget to '0 b'. Its
writer factories write the file indexes of file-index.*.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch

from ..data.batch import ColumnBatch, concat_batches
from ..data.predicate import Predicate, and_, greater_than, is_null, or_
from ..format.fileindex import resolve_key_bloom
from ..fs import FileIO
from ..options import ChangelogProducer, CoreOptions
from ..resilience.fileio import wrap_file_io
from ..types import RowType
from ..utils import now_millis, partition_path
from ..utils.cache import table_caches
from .append import AppendOnlyCompactManager, AppendOnlyWriter
from .commit import FileStoreCommit
from .compact import MergeTreeCompactManager, MergeTreeCompactRewriter, UniversalCompaction
from ..ops.dicts import resolve_dict_domain
from .datafile import WRITER_OPTION_KEYS, DataFileMeta, KeyValueFileReaderFactory, KeyValueFileWriterFactory
from .deletionvectors import DeletionVectorsIndexFile
from .expire import SnapshotExpire
from .kv import KVBatch
from .levels import Levels
from .mergefn import MergeExecutor
from .read import MergeFileSplitRead
from .scan import FileStoreScan
from .schema import SchemaManager, TableSchema
from .snapshot import SnapshotManager
from .writer import MergeTreeWriter

__all__ = ["KeyValueFileStore", "AppendOnlyFileStore"]


class KeyValueFileStore:
    keyed = True

    def __init__(
        self,
        file_io: FileIO,
        table_path: str,
        schema: TableSchema,
        commit_user: str = "anonymous",
        device: "str | torch.device" = "cuda",
    ):
        self.table_path = table_path
        self.schema = schema
        self.commit_user = commit_user
        self.device = torch.device(device)
        self.options = schema.core_options()
        # every store path (scan, merge read, commit, compaction, expiry)
        # does its IO through the retrying wrapper of fs.retry.*, or through
        # `file_io` itself when retries are off
        self.file_io = wrap_file_io(file_io, self.options)
        self.value_schema = RowType(schema.fields)
        self.key_names = schema.trimmed_primary_keys
        self.partition_keys = list(schema.partition_keys)
        self.schema_manager = SchemaManager(self.file_io, table_path)
        self.manifest_obj_cache, self.data_file_obj_cache = table_caches(self.options)
        self.snapshot_manager = SnapshotManager(self.file_io, table_path, cache=self.manifest_obj_cache)
        # when a commit last swept expired partitions (table/write.py): the
        # store lives as long as the table, a TableCommit only for a commit
        self.last_partition_expire_check = 0

    def bucket_dir(self, partition: tuple, bucket: int) -> str:
        pp = partition_path(
            self.partition_keys, partition, default_name=self.options.options.get(CoreOptions.PARTITION_DEFAULT_NAME)
        )
        base = f"{self.table_path}/{pp}" if pp else self.table_path
        return f"{base}/bucket-{bucket}"

    def schemas_by_id(self) -> dict[int, RowType]:
        out = {sid: RowType(ts.fields) for sid, ts in self.schema_manager.all_schemas().items()}
        out.setdefault(self.schema.id, self.value_schema)
        return out

    def merge_executor(self) -> MergeExecutor:
        return MergeExecutor(self.value_schema, self.key_names, self.options.merge_engine, self.options, self.device)

    def writer_factory(self, partition: tuple, bucket: int) -> KeyValueFileWriterFactory:
        co = self.options
        bloom_cols = co.options.get(CoreOptions.FILE_INDEX_BLOOM_COLUMNS)
        return KeyValueFileWriterFactory(
            self.file_io,
            self.bucket_dir(partition, bucket),
            self.value_schema,
            self.key_names,
            self.schema.id,
            file_format=co.file_format,
            compression=co.file_compression,
            per_level_compression=co.file_compression_per_level,
            per_level_format=co.file_format_per_level,
            include_key_columns=co.options.get(CoreOptions.DATA_FILE_INCLUDE_KEY_COLUMNS),
            target_file_size=co.target_file_size,
            keyed=self.keyed,
            bloom_columns=[c.strip() for c in bloom_cols.split(",")] if bloom_cols else (),
            bloom_fpp=co.options.get(CoreOptions.FILE_INDEX_BLOOM_FPP),
            key_bloom=resolve_key_bloom(co.options.get(CoreOptions.FILE_INDEX_BLOOM_KEY_ENABLED)),
            key_bloom_fpp=co.options.get(CoreOptions.FILE_INDEX_BLOOM_KEY_FPP),
            index_in_manifest_threshold=int(co.options.get(CoreOptions.FILE_INDEX_IN_MANIFEST_THRESHOLD)),
            format_options={k: co.options._data.get(k) for k in WRITER_OPTION_KEYS},
        )

    def reader_factory(self, partition: tuple, bucket: int) -> KeyValueFileReaderFactory:
        return KeyValueFileReaderFactory(
            self.file_io,
            self.bucket_dir(partition, bucket),
            self.value_schema,
            self.schemas_by_id(),
            self.keyed,
            cache=self.data_file_obj_cache,
            dict_domain=resolve_dict_domain(self.options.options.get(CoreOptions.MERGE_DICT_DOMAIN)),
            pool_limit=self.options.options.get(CoreOptions.MERGE_DICT_DOMAIN_POOL_LIMIT),
        )

    def new_scan(self) -> FileStoreScan:
        return FileStoreScan(
            self.file_io, self.table_path, self.options, self.value_schema, cache=self.manifest_obj_cache
        )

    def new_commit(self) -> FileStoreCommit:
        return FileStoreCommit(
            self.file_io, self.table_path, self.commit_user, self.schema.id, self.options, cache=self.manifest_obj_cache
        )

    def new_expire(self, protected_ids=None) -> SnapshotExpire:
        """Snapshot expiry under the table's options; protected_ids() gives
        the snapshot ids to keep (tags, consumers)."""
        return SnapshotExpire(
            self.file_io, self.table_path, self.options, protected_ids, partition_keys=self.partition_keys
        )

    def restore_files(self, partition: tuple, bucket: int) -> list[DataFileMeta]:
        plan = self.new_scan().with_bucket(bucket).with_partition_filter(lambda p: p == partition).plan()
        return [e.file for e in plan.entries]

    def restore_state(self, partition: tuple, bucket: int) -> tuple[list[DataFileMeta], dict]:
        """(live files, deletion vectors by data file name) of one bucket in
        the latest snapshot."""
        plan = self.new_scan().with_bucket(bucket).with_partition_filter(lambda p: p == partition).plan()
        dv_index = plan.dv_index_for(partition, bucket)
        dvs = DeletionVectorsIndexFile(self.file_io, self.table_path).read_all(dv_index) if dv_index else {}
        return [e.file for e in plan.entries], dvs

    def new_writer(
        self, partition: tuple, bucket: int, total_buckets: int | None = None, admission=None
    ) -> MergeTreeWriter:
        """A writer restored from the bucket's live files; it compacts unless
        the table is write-only, and reserves its buffer against
        `admission` (a WriteBufferController) when one is given."""
        co = self.options
        if co.write_only and co.changelog_producer == ChangelogProducer.LOOKUP:
            raise ValueError(
                "changelog-producer=lookup needs the writer's levels view and cannot run with "
                "write-only=true (produce the changelog in the writing job, not a dedicated compactor)"
            )
        existing, dvs = self.restore_state(partition, bucket)
        merge = self.merge_executor()
        wf = self.writer_factory(partition, bucket)
        compact_manager = None
        if not co.write_only:
            strategy = UniversalCompaction(
                co.max_size_amplification_percent,
                co.size_ratio,
                co.num_sorted_runs_compaction_trigger,
                co.options.get(CoreOptions.COMPACTION_OPTIMIZATION_INTERVAL),
                max_file_num=co.options.get(CoreOptions.COMPACTION_MAX_FILE_NUM),
            )
            # the full changelog comes from compactions under full-compaction,
            # and under lookup when the commit does not wait for the lookup
            producer = co.changelog_producer
            lookup_wait = co.options.get(CoreOptions.CHANGELOG_PRODUCER_LOOKUP_WAIT)
            rewriter = MergeTreeCompactRewriter(
                self.reader_factory(partition, bucket),
                wf,
                merge,
                deletion_vectors=dvs,
                expire_predicate=self.record_expire_predicate(),
                emit_full_changelog=producer == ChangelogProducer.FULL_COMPACTION
                or (producer == ChangelogProducer.LOOKUP and not lookup_wait),
                row_deduplicate=co.options.get(CoreOptions.CHANGELOG_PRODUCER_ROW_DEDUPLICATE),
            )
            compact_manager = MergeTreeCompactManager(Levels(existing, co.num_levels), strategy, rewriter, co)
        debt_gate = None
        if co.write_only and co.options.get(CoreOptions.COMPACTION_ADAPTIVE_INGEST_GATE):
            # resolved at each flush, so a service started after the writer
            # still bounds it
            from ..table.compactor import active_debt_gate

            debt_gate = functools.partial(active_debt_gate, self.table_path)
        return MergeTreeWriter(
            partition,
            bucket,
            total_buckets if total_buckets is not None else max(co.bucket, 1),
            wf,
            merge,
            co,
            restored_max_seq=max((f.max_sequence_number for f in existing), default=-1),
            compact_manager=compact_manager,
            debt_gate=debt_gate,
            admission=admission,
        )

    def read_raw(self, partition: tuple, bucket: int, files: list[DataFileMeta]) -> KVBatch:
        """The files' rows with their kinds and sequence numbers, unmerged,
        file after file by (min_sequence_number, file_name): the order a
        changelog split replays in."""
        rf = self.reader_factory(partition, bucket)
        ordered = sorted(files, key=lambda f: (f.min_sequence_number, f.file_name))
        return KVBatch.concat([rf.read(f) for f in ordered])

    def record_expire_predicate(self) -> Predicate | None:
        """Record-level TTL: the rows to keep, those whose
        record-level.time-field is later than now less
        record-level.expire-time (the field counts seconds, millis or
        micros by record-level.time-field-type), or NULL (a row without a
        time never expires); None when either option is unset. Every read
        ANDs it in, and compaction drops the rows it rejects."""
        ttl = self.options.options.get(CoreOptions.RECORD_LEVEL_EXPIRE_TIME)
        field = self.options.options.get(CoreOptions.RECORD_LEVEL_TIME_FIELD)
        if ttl is None or field is None:
            return None
        unit = self.options.options.get(CoreOptions.RECORD_LEVEL_TIME_FIELD_TYPE)
        cutoff_ms = now_millis() - ttl
        # the JAX package's scales: an unknown unit counts seconds
        cutoff = cutoff_ms * 1000 if unit == "micros" else cutoff_ms // {"millis": 1}.get(unit, 1000)
        return or_(greater_than(field, cutoff), is_null(field))

    def read_bucket(
        self,
        partition: tuple,
        bucket: int,
        files: list[DataFileMeta],
        predicate: Predicate | None = None,
        projection: Sequence[str] | None = None,
        drop_delete: bool = True,
        deletion_vectors: dict | None = None,
    ):
        """Merge-read one bucket's files under the predicate ANDed with the
        record TTL, without the deletion vectors' rows."""
        expire = self.record_expire_predicate()
        if expire is not None:
            predicate = expire if predicate is None else and_(predicate, expire)
        read = MergeFileSplitRead(self.reader_factory(partition, bucket), self.merge_executor(), self.key_names)
        return read.read_split(files, predicate, projection, drop_delete, deletion_vectors)


class AppendOnlyFileStore(KeyValueFileStore):
    """A table without a primary key: plain rows, concatenating reads,
    small-file compaction (core/append.py)."""

    keyed = False

    def new_writer(
        self, partition: tuple, bucket: int, total_buckets: int | None = None, admission=None
    ) -> AppendOnlyWriter:
        """A writer restored from the bucket's live files and deletion
        vectors; it compacts small files unless the table is write-only.
        `admission` is taken for the merge-tree writer's signature: as in
        the JAX package, an append writer reserves nothing (its buffer
        spills instead, under write-buffer-spillable)."""
        co = self.options
        existing, dvs = self.restore_state(partition, bucket)
        wf = self.writer_factory(partition, bucket)
        compact_manager = None
        if not co.write_only:
            compact_manager = AppendOnlyCompactManager(self.reader_factory(partition, bucket), wf, co, dvs)
        return AppendOnlyWriter(
            partition,
            bucket,
            total_buckets if total_buckets is not None else max(co.bucket, 1),
            wf,
            compact_manager,
            co,
            existing_files=existing,
            restored_max_seq=max((f.max_sequence_number for f in existing), default=-1),
        )

    def read_bucket(
        self,
        partition: tuple,
        bucket: int,
        files: list[DataFileMeta],
        predicate: Predicate | None = None,
        projection: Sequence[str] | None = None,
        drop_delete: bool = True,
        deletion_vectors: dict | None = None,
    ) -> ColumnBatch:
        """The files' rows in (min_sequence_number, file_name) order, less
        the deletion vectors' rows and those the predicate rejects, then
        projected. A file without a vector skips the row groups the
        predicate's stats exclude. Record-level TTL does not apply to
        append tables, as in the JAX package."""
        dvs = deletion_vectors or {}
        rf = self.reader_factory(partition, bucket)
        out = []
        for f in sorted(files, key=lambda f: (f.min_sequence_number, f.file_name)):
            dv = dvs.get(f.file_name)
            kv = rf.read(f, predicate=None if dv is not None else predicate)
            data = kv.data
            if dv is not None:
                alive = ~dv.deleted_mask(kv.num_rows)
                if not alive.all():
                    data = data.filter(alive)
            if predicate is not None and data.num_rows:
                mask = predicate.eval(data)
                if not mask.all():
                    data = data.filter(mask)
            out.append(data if projection is None else data.select(projection))
        if not out:
            schema = self.value_schema if projection is None else self.value_schema.project(projection)
            return ColumnBatch.empty(schema)
        return concat_batches(out)
