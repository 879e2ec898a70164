"""The snapshot-CAS commit protocol (port of paimon_tpu/core/commit.py:
append, compact and overwrite commits, manifest merging and the replay
filter).

A commit writes a delta manifest, a base manifest list (the previous
snapshot's base + delta) and a delta manifest list, then publishes
snapshot-(latest+1) with the atomic-rename CAS. A lost race cleans this
round's manifests and retries against the new latest, up to
commit.max-retries. One committable gives up to two snapshots: APPEND (the
writers' new level-0 files) then COMPACT (compaction's removed and written
files), so a crashed commit replayed after its APPEND snapshot applies only
the missing COMPACT half (filter_committed). A COMPACT commit whose removed
files are no longer live raises CommitConflictError (per partition and
bucket: the buckets whose inputs are gone are abandoned, the others
commit). The APPEND snapshot also carries the writers' new index files
(the dynamic-bucket hash index, a DELETE's deletion vectors): its index
manifest is the previous one with each (partition, bucket, kind) slot the
commit names replaced; a COMPACT snapshot that removes files drops the
deletion vectors of the files it removes for good (an upgrade removes and
adds one file name, and its vector stays) and rewrites the manifest, as
the JAX package does. An OVERWRITE snapshot deletes the live files of the
partitions a filter selects and keeps the index manifest as it was, hash
index entries of the dropped partitions included, so that a partition
written again gets the buckets the JAX package gives it. Before each
commit the base manifests are merged once manifest.merge-min-count of
them are small, or all of them once the small ones pass
manifest.full-compaction-threshold-size. Changelog files become ADD
entries of a snapshot's changelog manifest list: the flushes' (input and
lookup producers) on the APPEND snapshot, which is then made even when a
commit holds only changelog, and the compactions' on the COMPACT one.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable, Sequence

from ..fs import LocalFileIO
from ..options import CoreOptions
from ..utils import now_millis
from .deletionvectors import DeletionVectorsIndexFile, IndexFileEntry
from .indexmanifest import read_index_manifest, write_index_manifest
from .manifest import (
    FileKind,
    ManifestCommittable,
    ManifestEntry,
    ManifestFile,
    ManifestFileMeta,
    ManifestList,
    merge_entries,
    merge_entries_keep_deletes,
)
from .snapshot import CommitKind, Snapshot, SnapshotManager

# batch jobs commit once with this identifier (reference Long.MAX_VALUE)
BATCH_COMMIT_IDENTIFIER = (1 << 63) - 1

__all__ = ["FileStoreCommit", "CommitConflictError", "CommitGiveUpError", "BATCH_COMMIT_IDENTIFIER"]


class CommitConflictError(RuntimeError):
    """A compaction's input files were removed by a concurrent commit; its
    COMPACT snapshot is abandoned."""


class CommitGiveUpError(RuntimeError):
    """commit.max-retries lost snapshot races in a row; the table is
    untouched by this commit and the committable may be replayed."""


class FileStoreCommit:
    def __init__(
        self,
        file_io: LocalFileIO,
        table_path: str,
        commit_user: str,
        schema_id: int,
        options: CoreOptions,
        cache=None,
    ):
        self.file_io = file_io
        self.table_path = table_path
        self.commit_user = commit_user
        self.schema_id = schema_id
        self.options = options
        fmt = options.options.get(CoreOptions.MANIFEST_FORMAT)
        # every commit re-reads the latest snapshot's manifests: through the
        # manifest cache (utils/cache.py)
        self.snapshot_manager = SnapshotManager(file_io, table_path, cache=cache)
        self.manifest_file = ManifestFile(
            file_io, f"{table_path}/manifest", options.manifest_compression, fmt, cache=cache
        )
        self.manifest_list = ManifestList(
            file_io, f"{table_path}/manifest", options.manifest_compression, fmt, cache=cache
        )

    def filter_committed(self, committables: Sequence[ManifestCommittable]) -> list[ManifestCommittable]:
        """Drop the committables whose identifier this user already committed
        (crash replay). Only streaming identifiers come here; the user's
        latest snapshot with another identifier than the batch one marks
        what is done. A committable at that identifier whose COMPACT half
        is missing comes back flagged to skip its APPEND half."""
        done = next(
            (
                s.commit_identifier
                for s in self.snapshot_manager.snapshots_of_user(self.commit_user)
                if s.commit_identifier != BATCH_COMMIT_IDENTIFIER
            ),
            None,
        )
        if done is None:
            return list(committables)
        out: list[ManifestCommittable] = []
        for c in committables:
            if c.commit_identifier > done:
                out.append(c)
            elif c.commit_identifier == done and any(m.compact_before or m.compact_after for m in c.messages):
                kinds = {
                    s.commit_kind
                    for s in self.snapshot_manager.snapshots_of_user_with_identifier(self.commit_user, done)
                }
                if CommitKind.COMPACT not in kinds:
                    out.append(replace(c, skip_append=True))
        return out

    def commit(self, committable: ManifestCommittable) -> list[int]:
        """An APPEND snapshot for the new files (also for an empty
        committable), then a COMPACT snapshot when there are compacted
        files; returns the snapshot ids written (0, 1 or 2)."""
        append_entries: list[ManifestEntry] = []
        compact_entries: list[ManifestEntry] = []
        for msg in committable.messages:
            where = (msg.partition, msg.bucket, msg.total_buckets)
            append_entries += [ManifestEntry(FileKind.ADD, *where, f) for f in msg.new_files]
            compact_entries += [ManifestEntry(FileKind.DELETE, *where, f) for f in msg.compact_before]
            compact_entries += [ManifestEntry(FileKind.ADD, *where, f) for f in msg.compact_after]
        index_entries = [e for msg in committable.messages for e in msg.new_index_files]
        append_changelog = any(msg.changelog_files for msg in committable.messages)
        written: list[int] = []
        if not committable.skip_append and (
            append_entries or index_entries or append_changelog or not compact_entries
        ):
            written.append(self._try_commit(CommitKind.APPEND, append_entries, committable))
            # the APPEND snapshot is durable: a retry of this committable
            # must not apply it twice if the COMPACT half fails below
            committable.skip_append = True
        if compact_entries:
            written.append(self._try_commit(CommitKind.COMPACT, compact_entries, committable, check_conflicts=True))
        return written

    @staticmethod
    def _changelog_entries(kind: CommitKind, committable: ManifestCommittable) -> list[ManifestEntry]:
        """ADD entries of the changelog files a snapshot of `kind` carries:
        the flushes' on APPEND, the compactions' on COMPACT."""
        attr = {CommitKind.APPEND: "changelog_files", CommitKind.COMPACT: "compact_changelog_files"}.get(kind)
        if attr is None:
            return []
        return [
            ManifestEntry(FileKind.ADD, msg.partition, msg.bucket, msg.total_buckets, f)
            for msg in committable.messages
            for f in getattr(msg, attr)
        ]

    def overwrite(
        self, committable: ManifestCommittable, partition_filter: Callable[[tuple], bool] | None = None
    ) -> list[int]:
        """One OVERWRITE snapshot: DELETE entries for the live files of the
        partitions `partition_filter` selects (all when None), then the
        committable's new files."""
        latest = self.snapshot_manager.latest_snapshot()
        entries: list[ManifestEntry] = []
        if latest is not None:
            for e in self._live_entries(latest):
                if partition_filter is None or partition_filter(e.partition):
                    entries.append(ManifestEntry(FileKind.DELETE, e.partition, e.bucket, e.total_buckets, e.file))
        for msg in committable.messages:
            entries += [ManifestEntry(FileKind.ADD, msg.partition, msg.bucket, msg.total_buckets, f) for f in msg.new_files]
        return [self._try_commit(CommitKind.OVERWRITE, entries, committable)]

    def _live_entries(self, snapshot: Snapshot) -> list[ManifestEntry]:
        metas = self.manifest_list.read(snapshot.base_manifest_list) + self.manifest_list.read(
            snapshot.delta_manifest_list
        )
        return merge_entries(*(self.manifest_file.read(m.file_name) for m in metas))

    def _conflicted_buckets(self, latest: Snapshot, entries: list[ManifestEntry]) -> set[tuple]:
        """(partition, bucket) slots where a file this commit deletes is no
        longer live: a concurrent compaction removed it."""
        deletes = [e for e in entries if e.kind == FileKind.DELETE]
        if not deletes:
            return set()
        live = {(e.partition, e.bucket, e.file.file_name) for e in self._live_entries(latest)}
        return {(e.partition, e.bucket) for e in deletes if (e.partition, e.bucket, e.file.file_name) not in live}

    def _index_manifest(
        self, latest: Snapshot | None, index_entries: list[IndexFileEntry], removed: list[ManifestEntry]
    ) -> str | None:
        """The previous index manifest with this commit's (partition, bucket,
        kind) slots replaced by its entries (a writer always hands over the
        whole set of its bucket); the previous one when there are none and
        no file is `removed`. Where files are removed (a COMPACT commit),
        the deletion vectors of those files go: a container keeping none is
        dropped, one keeping some is written anew with those. The manifest
        is then written anew even when nothing in it changed, as the JAX
        package does."""
        dead: dict[tuple, set] = {}
        for e in removed:
            dead.setdefault((e.partition, e.bucket), set()).add(e.file.file_name)
        if not index_entries and not dead:
            return latest.index_manifest if latest else None
        prev = read_index_manifest(self.file_io, self.table_path, latest.index_manifest) if latest and latest.index_manifest else []
        replaced = {(e.partition, e.bucket, e.kind) for e in index_entries}
        dv_io = DeletionVectorsIndexFile(
            self.file_io, self.table_path, int(self.options.options.get(CoreOptions.DELETION_VECTOR_INDEX_FILE_TARGET_SIZE))
        )
        out = []
        for e in prev:
            if (e.partition, e.bucket, e.kind) in replaced:
                continue
            gone = dead.get((e.partition, e.bucket))
            if gone and e.kind == "DELETION_VECTORS":
                dvs = dv_io.read_all(e.file_name)
                live = {f: dv for f, dv in dvs.items() if f not in gone}
                if not live:
                    continue
                if len(live) != len(dvs):
                    e = IndexFileEntry(e.kind, e.partition, e.bucket, *dv_io.write(live))
            out.append(e)
        out += index_entries
        return write_index_manifest(self.file_io, self.table_path, out) if out else None

    def _maybe_merge_manifests(self, metas: list[ManifestFileMeta], tmp_files: list[str]) -> list[ManifestFileMeta]:
        """The base manifests, merged as the JAX package merges them: all of
        them (DELETE entries resolved) once the small ones pass
        manifest.full-compaction-threshold-size and there are more than
        twice as many as their bytes need; else the small ones (DELETE
        entries whose ADD lies outside them kept) once there are
        manifest.merge-min-count of them. Outputs are cut at
        manifest.target-file-size by an adaptive bytes-per-entry guess."""
        opts = self.options.options
        target = int(opts.get(CoreOptions.MANIFEST_TARGET_SIZE))
        full_threshold = int(opts.get(CoreOptions.MANIFEST_FULL_COMPACTION_THRESHOLD_SIZE))
        small = [m for m in metas if m.file_size < target]
        total_bytes = sum(m.file_size for m in metas)
        fragmented = len(metas) > 2 * max(1, -(-total_bytes // target))
        if small and fragmented and sum(m.file_size for m in small) >= full_threshold:
            entries = merge_entries(*(self.manifest_file.read(m.file_name) for m in metas))
            out: list[ManifestFileMeta] = []
        elif len(small) < opts.get(CoreOptions.MANIFEST_MERGE_MIN_COUNT):
            return metas
        else:
            entries = merge_entries_keep_deletes(*(self.manifest_file.read(m.file_name) for m in small))
            out = [m for m in metas if m.file_size >= target]
        per_entry = 400.0
        i = 0
        while i < len(entries):
            chunk = entries[i : i + max(1, int(target / per_entry))]
            meta = self.manifest_file.write(chunk, self.schema_id, track=tmp_files)
            out.append(meta)
            per_entry = max(1.0, meta.file_size / len(chunk))
            i += len(chunk)
        return out

    def _try_commit(
        self,
        kind: CommitKind,
        entries: list[ManifestEntry],
        committable: ManifestCommittable,
        check_conflicts: bool = False,
        statistics: str | None = None,
    ) -> int:
        """Publish one snapshot of `kind` over the latest one's (possibly
        merged) base manifests, with the committable's changelog files of
        that kind; an APPEND snapshot also carries its new index files, an
        ANALYZE snapshot the name of its statistics file."""
        changelog = self._changelog_entries(kind, committable)
        index_entries = (
            [e for msg in committable.messages for e in msg.new_index_files] if kind == CommitKind.APPEND else []
        )
        # files a COMPACT commit removes for good (an upgrade deletes and
        # adds the same file at another level)
        removed: list[ManifestEntry] = []
        if kind == CommitKind.COMPACT:
            added_names = {e.file.file_name for e in entries if e.kind == FileKind.ADD}
            removed = [e for e in entries if e.kind == FileKind.DELETE and e.file.file_name not in added_names]
        max_retries = self.options.options.get(CoreOptions.COMMIT_MAX_RETRIES)
        retries = 0
        while True:
            latest = self.snapshot_manager.latest_snapshot()
            if check_conflicts and latest is not None:
                conflicted = self._conflicted_buckets(latest, entries)
                if conflicted == {(e.partition, e.bucket) for e in entries}:
                    raise CommitConflictError(
                        f"files of bucket(s) {sorted(conflicted)} were removed by a concurrent commit; "
                        f"giving up this {kind.value} commit"
                    )
                # the buckets that lost their inputs are abandoned (their
                # rewritten files become orphans); the others commit
                entries = [e for e in entries if (e.partition, e.bucket) not in conflicted]
                index_entries = [e for e in index_entries if (e.partition, e.bucket) not in conflicted]
                removed = [e for e in removed if (e.partition, e.bucket) not in conflicted]
                changelog = [e for e in changelog if (e.partition, e.bucket) not in conflicted]
            tmp_files: list[str] = []
            try:
                snapshot_id = latest.id + 1 if latest else 1
                base_metas = (
                    self.manifest_list.read(latest.base_manifest_list) + self.manifest_list.read(latest.delta_manifest_list)
                    if latest
                    else []
                )
                base_metas = self._maybe_merge_manifests(base_metas, tmp_files)
                delta_meta = self.manifest_file.write(entries, self.schema_id, track=tmp_files)
                base_name = self.manifest_list.write(base_metas, track=tmp_files)
                delta_name = self.manifest_list.write([delta_meta], track=tmp_files)
                changelog_list = changelog_rows = None
                if changelog:
                    changelog_meta = self.manifest_file.write(changelog, self.schema_id, track=tmp_files)
                    changelog_list = self.manifest_list.write([changelog_meta], track=tmp_files)
                    changelog_rows = sum(e.file.row_count for e in changelog)
                index_manifest = self._index_manifest(latest, index_entries, removed)
                if index_manifest and index_manifest != (latest.index_manifest if latest else None):
                    tmp_files.append(index_manifest)
                added = sum(e.file.row_count for e in entries if e.kind == FileKind.ADD)
                deleted = sum(e.file.row_count for e in entries if e.kind == FileKind.DELETE)
                prev_total = (latest.total_record_count or 0) if latest else 0
                snapshot = Snapshot(
                    id=snapshot_id,
                    schema_id=self.schema_id,
                    base_manifest_list=base_name,
                    delta_manifest_list=delta_name,
                    changelog_manifest_list=changelog_list,
                    commit_user=self.commit_user,
                    commit_identifier=committable.commit_identifier,
                    commit_kind=kind,
                    time_millis=now_millis(),
                    index_manifest=index_manifest,
                    total_record_count=prev_total + added - deleted,
                    delta_record_count=added - deleted,
                    changelog_record_count=changelog_rows,
                    watermark=committable.watermark,
                    log_offsets=dict(committable.log_offsets),
                    statistics=statistics,
                )
                if self.file_io.try_atomic_write(self.snapshot_manager.snapshot_path(snapshot_id), snapshot.to_json().encode()):
                    tmp_files.clear()
                    self.snapshot_manager.commit_latest_hint(snapshot_id)
                    if snapshot_id == 1:
                        self.snapshot_manager.commit_earliest_hint(1)
                    return snapshot_id
            finally:
                # lost the CAS (or failed mid-round): this round's manifests
                # are referenced by no snapshot
                for name in tmp_files:
                    self.manifest_file.delete(name)
            retries += 1
            if retries > max_retries:
                raise CommitGiveUpError(
                    f"commit lost the snapshot race {retries} times (commit.max-retries={max_retries}); giving up"
                )
