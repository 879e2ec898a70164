"""The snapshot-CAS commit protocol (port of paimon_tpu/core/commit.py,
append commits).

A commit writes a delta manifest, a base manifest list (the previous
snapshot's base + delta) and a delta manifest list, then publishes
snapshot-(latest+1) with the atomic-rename CAS. A lost race cleans this
round's manifests and retries against the new latest, up to
commit.max-retries. Overwrite, compaction, changelog and index manifests
and manifest merging are not ported yet.
"""

from __future__ import annotations

from ..fs import LocalFileIO
from ..options import CoreOptions
from ..utils import now_millis
from .manifest import FileKind, ManifestCommittable, ManifestEntry, ManifestFile, ManifestList
from .snapshot import CommitKind, Snapshot, SnapshotManager

# batch jobs commit once with this identifier (reference Long.MAX_VALUE)
BATCH_COMMIT_IDENTIFIER = (1 << 63) - 1

__all__ = ["FileStoreCommit", "CommitGiveUpError", "BATCH_COMMIT_IDENTIFIER"]


class CommitGiveUpError(RuntimeError):
    """commit.max-retries lost snapshot races in a row; the table is
    untouched by this commit and the committable may be replayed."""


class FileStoreCommit:
    def __init__(
        self, file_io: LocalFileIO, table_path: str, commit_user: str, schema_id: int, options: CoreOptions
    ):
        self.file_io = file_io
        self.table_path = table_path
        self.commit_user = commit_user
        self.schema_id = schema_id
        self.options = options
        fmt = options.options.get(CoreOptions.MANIFEST_FORMAT)
        self.snapshot_manager = SnapshotManager(file_io, table_path)
        self.manifest_file = ManifestFile(file_io, f"{table_path}/manifest", options.manifest_compression, fmt)
        self.manifest_list = ManifestList(file_io, f"{table_path}/manifest", options.manifest_compression, fmt)

    def commit(self, committable: ManifestCommittable) -> list[int]:
        """One APPEND snapshot for the committable's new files; returns the
        snapshot ids written."""
        entries = [
            ManifestEntry(FileKind.ADD, msg.partition, msg.bucket, msg.total_buckets, f)
            for msg in committable.messages
            for f in msg.new_files
        ]
        return [self._try_commit(CommitKind.APPEND, entries, committable)]

    def _try_commit(self, kind: CommitKind, entries: list[ManifestEntry], committable: ManifestCommittable) -> int:
        max_retries = self.options.options.get(CoreOptions.COMMIT_MAX_RETRIES)
        retries = 0
        while True:
            latest = self.snapshot_manager.latest_snapshot()
            tmp_files: list[str] = []
            try:
                snapshot_id = latest.id + 1 if latest else 1
                base_metas = (
                    self.manifest_list.read(latest.base_manifest_list) + self.manifest_list.read(latest.delta_manifest_list)
                    if latest
                    else []
                )
                delta_meta = self.manifest_file.write(entries, self.schema_id, track=tmp_files)
                base_name = self.manifest_list.write(base_metas, track=tmp_files)
                delta_name = self.manifest_list.write([delta_meta], track=tmp_files)
                added = sum(e.file.row_count for e in entries if e.kind == FileKind.ADD)
                deleted = sum(e.file.row_count for e in entries if e.kind == FileKind.DELETE)
                prev_total = (latest.total_record_count or 0) if latest else 0
                snapshot = Snapshot(
                    id=snapshot_id,
                    schema_id=self.schema_id,
                    base_manifest_list=base_name,
                    delta_manifest_list=delta_name,
                    changelog_manifest_list=None,
                    commit_user=self.commit_user,
                    commit_identifier=committable.commit_identifier,
                    commit_kind=kind,
                    time_millis=now_millis(),
                    index_manifest=latest.index_manifest if latest else None,
                    total_record_count=prev_total + added - deleted,
                    delta_record_count=added - deleted,
                    watermark=committable.watermark,
                    log_offsets=dict(committable.log_offsets),
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
