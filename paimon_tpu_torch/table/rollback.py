"""Rollback: move a table back to an earlier snapshot or tag (port of
paimon_tpu/table/rollback.py).

A tag whose snapshot has expired is written back as a snapshot first. Then
the data files (with their extra files) and the manifests that only the
rolled-back snapshots reach are deleted, those snapshots after them, and
the LATEST hint names the target. As in the JAX package, the changelog
manifest lists, changelog files and index files of the rolled-back
snapshots stay on disk, and a tag of a rolled-back snapshot is kept: it may
then name deleted files.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from ..core.manifest import ManifestFile, ManifestList, merge_entries
from ..utils.cache import invalidate_data_file, invalidate_latest_pointer, invalidate_manifest_path, invalidate_snapshot
from .tags import TagManager

if TYPE_CHECKING:
    from . import FileStoreTable

__all__ = ["rollback_to"]


def rollback_to(table: "FileStoreTable", target: "int | str") -> None:
    """Roll `table` back to snapshot `target` (an id) or to the snapshot of
    tag `target` (a name); ValueError when the snapshot does not exist."""
    file_io = table.file_io
    sm = table.store.snapshot_manager
    if isinstance(target, str):
        snap = TagManager(file_io, table.path).get(target)
        target_id = snap.id
        if not sm.snapshot_exists(target_id):
            file_io.try_atomic_write(sm.snapshot_path(target_id), snap.to_json().encode())
    else:
        target_id = target
    latest = sm.latest_snapshot_id()
    if latest is None or latest <= target_id:
        return
    if not sm.snapshot_exists(target_id):
        raise ValueError(f"rollback target snapshot {target_id} does not exist")

    manifest_file = ManifestFile(file_io, f"{table.path}/manifest")
    manifest_list = ManifestList(file_io, f"{table.path}/manifest")

    def reached(snapshot_id: int) -> tuple[set, set]:
        """(data files as (partition, bucket, name, extra files), manifests)
        that the snapshot reaches."""
        snap = sm.snapshot(snapshot_id)
        metas = manifest_list.read(snap.base_manifest_list) + manifest_list.read(snap.delta_manifest_list)
        entries = merge_entries(*(manifest_file.read(m.file_name) for m in metas))
        files = {(e.partition, e.bucket, e.file.file_name, e.file.extra_files) for e in entries}
        return files, {m.file_name for m in metas} | {snap.base_manifest_list, snap.delta_manifest_list}

    keep_files, keep_manifests = reached(target_id)
    drop_files: set = set()
    drop_manifests: set = set()
    for sid in range(target_id + 1, latest + 1):
        if sm.snapshot_exists(sid):
            files, manifests = reached(sid)
            drop_files |= files - keep_files
            drop_manifests |= manifests - keep_manifests
    # the snapshots before the target share its history: what they reach stays
    for sid in range((sm.earliest_snapshot_id() or target_id), target_id):
        if sm.snapshot_exists(sid):
            files, manifests = reached(sid)
            drop_files -= files
            drop_manifests -= manifests

    for partition, bucket, name, extra in drop_files:
        bucket_dir = table.store.bucket_dir(partition, bucket)
        file_io.delete(f"{bucket_dir}/{name}")
        invalidate_data_file(name)
        for x in extra:
            file_io.delete(f"{bucket_dir}/{x}")
    for name in drop_manifests:
        file_io.delete(f"{table.path}/manifest/{name}")
        invalidate_manifest_path(f"{table.path}/manifest/{name}")
    for sid in range(target_id + 1, latest + 1):
        file_io.delete(sm.snapshot_path(sid))
        # later commits mint these ids again with other content: a cached
        # snapshot would bring the rolled-back history back
        invalidate_snapshot(table.path, sid)
    invalidate_latest_pointer(table.path)
    sm.commit_latest_hint(target_id)
