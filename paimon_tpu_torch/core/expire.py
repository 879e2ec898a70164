"""Snapshot expiration: retention windows and safe physical deletion (port
of paimon_tpu/core/expire.py).

Snapshots outside snapshot.num-retained.min/max and snapshot.time-retained
(at most snapshot.expire.limit per run) are expired, skipping the ids a
caller protects (tags, consumers); then the manifests and data files that
only the expired snapshots referenced are deleted. A snapshot's base
manifest list names every earlier manifest until manifests are merged
(core/commit.py), so before a merge the files left behind are the manifest
lists alone, as in the JAX package. With changelog retention set, an
expiring snapshot that carries changelog leaves a changelog-<id> copy, and
expire_changelogs applies the changelog options to those copies.
"""

from __future__ import annotations

from typing import Callable, Iterable

from ..fs import LocalFileIO
from ..options import CoreOptions
from ..utils import now_millis, partition_path
from ..utils.cache import invalidate_data_file, invalidate_manifest_path, invalidate_snapshot, table_caches
from .manifest import ManifestFile, ManifestList
from .snapshot import Snapshot, SnapshotManager

__all__ = ["SnapshotExpire"]


class SnapshotExpire:
    def __init__(
        self,
        file_io: LocalFileIO,
        table_path: str,
        options: CoreOptions,
        protected_ids: Callable[[], Iterable[int]] | None = None,
        partition_keys: Iterable[str] = (),
    ):
        self.file_io = file_io
        self.table_path = table_path
        self.options = options
        self._partition_keys = tuple(partition_keys)
        # reads go through the manifest cache (the scans filled most of it);
        # the deletes below invalidate through the module's helpers, so a
        # deleted file leaves the cache whoever cached it
        cache, _ = table_caches(options)
        self.snapshot_manager = SnapshotManager(file_io, table_path, cache=cache)
        self.manifest_file = ManifestFile(file_io, f"{table_path}/manifest", cache=cache)
        self.manifest_list = ManifestList(file_io, f"{table_path}/manifest", cache=cache)
        self.protected_ids = protected_ids or (lambda: ())
        # deletes that failed; each leaves an unreferenced file behind
        self.cleanup_failures = 0

    def _safe_delete(self, path: str) -> bool:
        """Deletion is best effort per file: one failed delete must not stop
        the run half-way. It is counted in cleanup_failures."""
        try:
            self.file_io.delete(path)
            return True
        except OSError:
            self.cleanup_failures += 1
            return False

    def _changelog_decoupled(self) -> bool:
        return any(
            self.options.options.get(o) is not None
            for o in (
                CoreOptions.CHANGELOG_NUM_RETAINED_MIN,
                CoreOptions.CHANGELOG_NUM_RETAINED_MAX,
                CoreOptions.CHANGELOG_TIME_RETAINED,
            )
        )

    def expire(self) -> int:
        """Expire snapshots, then (retention set) decoupled changelogs, which
        trim even in a run that expires no snapshot; returns the number of
        snapshots expired."""
        n = self._expire_snapshots()
        if self._changelog_decoupled():
            self.expire_changelogs()
        return n

    def _expire_snapshots(self) -> int:
        sm = self.snapshot_manager
        latest = sm.latest_snapshot_id()
        earliest = sm.earliest_snapshot_id()
        if latest is None or earliest is None:
            return 0
        co = self.options
        # exclusive end of the expired range: num-retained.max first, then
        # the time rule, which may go no further than num-retained.min
        end = max(earliest, latest - co.snapshot_num_retained_max + 1)
        time_bound = max(earliest, latest - co.snapshot_num_retained_min + 1)
        cutoff = now_millis() - co.snapshot_time_retained_ms
        for sid in range(end, time_bound):
            if sm.snapshot_exists(sid) and sm.snapshot(sid).time_millis < cutoff:
                end = sid + 1
            else:
                break
        limit = co.options.get(CoreOptions.SNAPSHOT_EXPIRE_LIMIT)
        if limit is not None and end - earliest > limit:
            end = earliest + limit
        protected = set(self.protected_ids())
        expire_ids = [i for i in range(earliest, end) if i not in protected and sm.snapshot_exists(i)]
        if not expire_ids:
            return 0
        expiring = set(expire_ids)
        retained_ids = [i for i in range(earliest, latest + 1) if i not in expiring and sm.snapshot_exists(i)]

        live_files: set[tuple] = set()
        live_manifests: set[str] = set()
        for sid in retained_ids:
            snap = sm.snapshot(sid)
            for name, entries in self._snapshot_manifests(snap):
                live_manifests.add(name)
                live_files.update((e.partition, e.bucket, e.file.file_name) for e in entries)
            live_manifests.add(snap.base_manifest_list)
            live_manifests.add(snap.delta_manifest_list)
            if snap.changelog_manifest_list:
                live_manifests.add(snap.changelog_manifest_list)

        # with changelog retention set, an expiring snapshot that carries
        # changelog leaves a changelog-<id> copy, and its changelog
        # manifests and files outlive the snapshot
        decoupled = self._changelog_decoupled()
        dead_manifests: set[str] = set()
        dead_files: set[tuple] = set()
        for sid in expire_ids:
            snap = sm.snapshot(sid)
            keep_changelog = bool(decoupled and snap.changelog_manifest_list)
            if keep_changelog:
                self.file_io.write_bytes(sm.changelog_path(sid), snap.to_json().encode(), overwrite=True)
            for name, entries in self._snapshot_manifests(snap, include_changelog=not keep_changelog):
                if name not in live_manifests:
                    dead_manifests.add(name)
                for e in entries:
                    key = (e.partition, e.bucket, e.file.file_name)
                    if key not in live_files:
                        dead_files.add((key, e.file.extra_files))
            lists = [snap.base_manifest_list, snap.delta_manifest_list]
            if not keep_changelog:
                lists.append(snap.changelog_manifest_list)
            dead_manifests.update(lst for lst in lists if lst and lst not in live_manifests)

        touched_dirs: set[str] = set()
        for (partition, bucket, file_name), extra in dead_files:
            d = self._bucket_dir(partition, bucket)
            touched_dirs.add(d)
            self._safe_delete(f"{d}/{file_name}")
            invalidate_data_file(file_name)
            for x in extra:
                self._safe_delete(f"{d}/{x}")
        for name in dead_manifests:
            self._safe_delete(f"{self.table_path}/manifest/{name}")
            invalidate_manifest_path(f"{self.table_path}/manifest/{name}")
        for sid in expire_ids:
            self._safe_delete(sm.snapshot_path(sid))
            invalidate_snapshot(self.table_path, sid)
        # the smallest SURVIVING id: a protected snapshot inside the expired
        # range stays on disk and must stay reachable through the hint
        sm.commit_earliest_hint(min(retained_ids))
        if co.options.get(CoreOptions.SNAPSHOT_EXPIRE_CLEAN_EMPTY_DIRS):
            # bucket directories this run emptied, then their partition
            # directories, after every metadata delete; a directory that
            # fills again meanwhile is left alone
            for d in sorted(touched_dirs, key=len, reverse=True):
                try:
                    if not self.file_io.list_status(d):
                        self.file_io.delete(d)
                        parent = d.rsplit("/", 1)[0]
                        while parent != self.table_path and not self.file_io.list_status(parent):
                            self.file_io.delete(parent)
                            parent = parent.rsplit("/", 1)[0]
                except OSError:
                    continue
        return len(expire_ids)

    def expire_changelogs(self) -> int:
        """Expire changelog-<id> copies by changelog.num-retained.min/max and
        changelog.time-retained; protected ids stay. A changelog's manifests
        and files belong to it alone and go with it."""
        sm = self.snapshot_manager
        ids = sm.changelog_ids()
        if not ids:
            return 0
        opts = self.options.options
        min_r = opts.get(CoreOptions.CHANGELOG_NUM_RETAINED_MIN) or 0
        max_r = opts.get(CoreOptions.CHANGELOG_NUM_RETAINED_MAX)
        ttl = opts.get(CoreOptions.CHANGELOG_TIME_RETAINED)
        protected = set(self.protected_ids())
        expire: list[int] = []
        if max_r is not None and len(ids) > max_r:
            expire.extend(ids[: len(ids) - max_r])
        rest = ids[len(expire) :]
        if ttl is not None:
            cutoff = now_millis() - ttl
            for cid in rest[: max(0, len(rest) - min_r)]:
                if sm.changelog(cid).time_millis < cutoff:
                    expire.append(cid)
                else:
                    break
        n = 0
        for cid in expire:
            if cid in protected:
                continue
            snap = sm.changelog(cid)
            if snap.changelog_manifest_list:
                for meta in self.manifest_list.read(snap.changelog_manifest_list):
                    for e in self.manifest_file.read(meta.file_name):
                        d = self._bucket_dir(e.partition, e.bucket)
                        self._safe_delete(f"{d}/{e.file.file_name}")
                        invalidate_data_file(e.file.file_name)
                        for x in e.file.extra_files:
                            self._safe_delete(f"{d}/{x}")
                    self._safe_delete(f"{self.table_path}/manifest/{meta.file_name}")
                    invalidate_manifest_path(f"{self.table_path}/manifest/{meta.file_name}")
                self._safe_delete(f"{self.table_path}/manifest/{snap.changelog_manifest_list}")
                invalidate_manifest_path(f"{self.table_path}/manifest/{snap.changelog_manifest_list}")
            self._safe_delete(sm.changelog_path(cid))
            n += 1
        return n

    def _snapshot_manifests(self, snap: Snapshot, include_changelog: bool = True):
        """(manifest name, entries) of the snapshot's base and delta lists
        and, unless kept for a decoupled changelog, its changelog list."""
        lists = [snap.base_manifest_list, snap.delta_manifest_list]
        if include_changelog:
            lists.append(snap.changelog_manifest_list)
        for lst in lists:
            if not lst:
                continue
            for meta in self.manifest_list.read(lst):
                yield meta.file_name, self.manifest_file.read(meta.file_name)

    def _bucket_dir(self, partition: tuple, bucket: int) -> str:
        pp = partition_path(
            self._partition_keys,
            partition,
            default_name=self.options.options.get(CoreOptions.PARTITION_DEFAULT_NAME),
        )
        base = f"{self.table_path}/{pp}" if pp else self.table_path
        return f"{base}/bucket-{bucket}"
