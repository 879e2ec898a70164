"""Snapshots: the versioned root of a table (port of
paimon_tpu/core/snapshot.py). A snapshot file is immutable JSON published
with the atomic-rename CAS; the LATEST/EARLIEST hints are an
optimization, listing is the truth. An expired snapshot whose changelog
is still retained reads from its decoupled copy under changelog/, so that
a streaming reader resuming at an old position keeps its history.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Iterator

from ..fs import LocalFileIO
from ..utils import dumps, loads

__all__ = ["CommitKind", "Snapshot", "SnapshotManager"]


class CommitKind(str, enum.Enum):
    APPEND = "APPEND"
    COMPACT = "COMPACT"
    OVERWRITE = "OVERWRITE"
    ANALYZE = "ANALYZE"


@dataclass
class Snapshot:
    id: int
    schema_id: int
    base_manifest_list: str
    delta_manifest_list: str
    changelog_manifest_list: str | None
    commit_user: str
    commit_identifier: int
    commit_kind: CommitKind
    time_millis: int
    index_manifest: str | None = None
    log_offsets: dict = field(default_factory=dict)
    total_record_count: int | None = None
    delta_record_count: int | None = None
    changelog_record_count: int | None = None
    watermark: int | None = None
    statistics: str | None = None

    def to_json(self) -> str:
        return dumps(
            {
                "version": 3,
                "id": self.id,
                "schemaId": self.schema_id,
                "baseManifestList": self.base_manifest_list,
                "deltaManifestList": self.delta_manifest_list,
                "changelogManifestList": self.changelog_manifest_list,
                "indexManifest": self.index_manifest,
                "commitUser": self.commit_user,
                "commitIdentifier": self.commit_identifier,
                "commitKind": self.commit_kind.value,
                "timeMillis": self.time_millis,
                "logOffsets": self.log_offsets,
                "totalRecordCount": self.total_record_count,
                "deltaRecordCount": self.delta_record_count,
                "changelogRecordCount": self.changelog_record_count,
                "watermark": self.watermark,
                "statistics": self.statistics,
            }
        )

    @staticmethod
    def from_json(s: str | bytes) -> "Snapshot":
        d = loads(s)
        return Snapshot(
            id=d["id"],
            schema_id=d["schemaId"],
            base_manifest_list=d["baseManifestList"],
            delta_manifest_list=d["deltaManifestList"],
            changelog_manifest_list=d.get("changelogManifestList"),
            commit_user=d["commitUser"],
            commit_identifier=d["commitIdentifier"],
            commit_kind=CommitKind(d["commitKind"]),
            time_millis=d["timeMillis"],
            index_manifest=d.get("indexManifest"),
            log_offsets={int(k): v for k, v in (d.get("logOffsets") or {}).items()},
            total_record_count=d.get("totalRecordCount"),
            delta_record_count=d.get("deltaRecordCount"),
            changelog_record_count=d.get("changelogRecordCount"),
            watermark=d.get("watermark"),
            statistics=d.get("statistics"),
        )


class SnapshotManager:
    LATEST = "LATEST"
    EARLIEST = "EARLIEST"

    def __init__(self, file_io: LocalFileIO, table_path: str, cache=None):
        self.file_io = file_io
        self.table_path = table_path
        self.snapshot_dir = f"{table_path}/snapshot"
        # the manifest cache (utils/cache.py): a snapshot file never changes
        # under its id until it is deleted, and the deleters invalidate it
        self.cache = cache if cache is not None and cache.enabled else None

    def snapshot_path(self, snapshot_id: int) -> str:
        return f"{self.snapshot_dir}/snapshot-{snapshot_id}"

    def snapshot(self, snapshot_id: int) -> Snapshot:
        """The snapshot, or its decoupled changelog copy once it expired
        (FileNotFoundError when neither is there)."""
        key = ("snapshot", self.table_path, snapshot_id)
        if self.cache is not None:
            cached = self.cache.get(key)
            if cached is not None:
                return cached
        try:
            raw = self.file_io.read_bytes(self.snapshot_path(snapshot_id))
        except FileNotFoundError:
            if self.changelog_exists(snapshot_id):
                return self.changelog(snapshot_id)
            raise
        snap = Snapshot.from_json(raw)
        if self.cache is not None:
            self.cache.put(key, snap, weight=len(raw) * 2, file_id=self.snapshot_path(snapshot_id))
        return snap

    def snapshot_exists(self, snapshot_id: int) -> bool:
        return self.file_io.exists(self.snapshot_path(snapshot_id))

    # decoupled changelogs: an expired snapshot's copy, kept while its
    # changelog files are retained (core/expire.py)
    @property
    def changelog_dir(self) -> str:
        return f"{self.table_path}/changelog"

    def changelog_path(self, snapshot_id: int) -> str:
        return f"{self.changelog_dir}/changelog-{snapshot_id}"

    def changelog(self, snapshot_id: int) -> Snapshot:
        return Snapshot.from_json(self.file_io.read_bytes(self.changelog_path(snapshot_id)))

    def changelog_exists(self, snapshot_id: int) -> bool:
        return self.file_io.exists(self.changelog_path(snapshot_id))

    def changelog_ids(self) -> list[int]:
        out = []
        for st in self.file_io.list_files(self.changelog_dir):
            base = st.path.rsplit("/", 1)[-1]
            if base.startswith("changelog-") and base[len("changelog-") :].isdigit():
                out.append(int(base[len("changelog-") :]))
        return sorted(out)

    def _listed_ids(self) -> list[int]:
        out = []
        for st in self.file_io.list_files(self.snapshot_dir):
            base = st.path.rsplit("/", 1)[-1]
            if base.startswith("snapshot-") and base[len("snapshot-") :].isdigit():
                out.append(int(base[len("snapshot-") :]))
        return sorted(out)

    def latest_snapshot_id(self) -> int | None:
        # a cached id L is still the latest while snapshot-L exists and
        # snapshot-(L+1) does not: two stat calls instead of the hint read
        # and the walk (a concurrent commit or a rollback fails the test)
        key = ("latest", self.table_path)
        if self.cache is not None:
            cached = self.cache.get(key)
            if cached is not None and self.snapshot_exists(cached) and not self.snapshot_exists(cached + 1):
                return cached
        latest = self._resolve_latest_id()
        if latest is not None and self.cache is not None:
            self.cache.put(key, latest, weight=64)
        return latest

    def _resolve_latest_id(self) -> int | None:
        try:
            hint = int(self.file_io.read_text(f"{self.snapshot_dir}/{self.LATEST}"))
        except (OSError, ValueError):
            hint = None
        if hint is not None:
            # the hint may lag: walk forward
            while self.snapshot_exists(hint + 1):
                hint += 1
            if self.snapshot_exists(hint):
                return hint
        ids = self._listed_ids()
        return ids[-1] if ids else None

    def earliest_snapshot_id(self) -> int | None:
        try:
            hint = int(self.file_io.read_text(f"{self.snapshot_dir}/{self.EARLIEST}"))
        except (OSError, ValueError):
            hint = None
        if hint is not None and self.snapshot_exists(hint):
            return hint
        ids = self._listed_ids()
        return ids[0] if ids else None

    def latest_snapshot(self) -> Snapshot | None:
        sid = self.latest_snapshot_id()
        return self.snapshot(sid) if sid is not None else None

    def snapshots(self) -> Iterator[Snapshot]:
        """The listed snapshots in id order."""
        for sid in self._listed_ids():
            yield self.snapshot(sid)

    def snapshot_count(self) -> int:
        return len(self._listed_ids())

    def earlier_or_equal_time_millis(self, millis: int) -> Snapshot | None:
        """The last snapshot, walking in id order, committed at or before
        `millis`; the walk stops at the first later one."""
        best = None
        for snap in self.snapshots():
            if snap.time_millis > millis:
                break
            best = snap
        return best

    def snapshots_of_user(self, user: str):
        """This user's snapshots, newest first (a lazy backward walk, so a
        caller that stops at the first it wants reads only the gap)."""
        latest = self.latest_snapshot_id()
        earliest = self.earliest_snapshot_id()
        if latest is None or earliest is None:
            return
        for sid in range(latest, earliest - 1, -1):
            if self.snapshot_exists(sid):
                snap = self.snapshot(sid)
                if snap.commit_user == user:
                    yield snap

    def snapshots_of_user_with_identifier(self, user: str, identifier: int) -> list[Snapshot]:
        """This user's snapshots carrying `identifier`; the walk stops once
        the user's identifiers fall below it (they ascend per user)."""
        out: list[Snapshot] = []
        for snap in self.snapshots_of_user(user):
            if snap.commit_identifier == identifier:
                out.append(snap)
            elif snap.commit_identifier < identifier:
                break
        return out

    def commit_latest_hint(self, snapshot_id: int) -> None:
        self.file_io.try_overwrite(f"{self.snapshot_dir}/{self.LATEST}", str(snapshot_id).encode())
        if self.cache is not None:
            self.cache.put(("latest", self.table_path), snapshot_id, weight=64)

    def commit_earliest_hint(self, snapshot_id: int) -> None:
        self.file_io.try_overwrite(f"{self.snapshot_dir}/{self.EARLIEST}", str(snapshot_id).encode())
