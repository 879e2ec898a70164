"""Snapshot scan planning: snapshot -> manifest lists -> live file entries
(port of paimon_tpu/core/scan.py; delta/changelog scans and stats/index
filters are not ported yet)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from ..fs import LocalFileIO
from .manifest import ManifestEntry, ManifestFile, ManifestList, merge_entries
from .snapshot import Snapshot, SnapshotManager

__all__ = ["ScanPlan", "FileStoreScan"]


@dataclass
class ScanPlan:
    snapshot: Snapshot | None
    entries: list[ManifestEntry] = field(default_factory=list)

    def grouped(self) -> dict[tuple, dict[int, list]]:
        """{partition: {bucket: [DataFileMeta...]}}"""
        out: dict[tuple, dict[int, list]] = {}
        for e in self.entries:
            out.setdefault(e.partition, {}).setdefault(e.bucket, []).append(e.file)
        return out


class FileStoreScan:
    def __init__(self, file_io: LocalFileIO, table_path: str, manifest_compression: str = "default"):
        self.file_io = file_io
        self.table_path = table_path
        self.snapshot_manager = SnapshotManager(file_io, table_path)
        self.manifest_file = ManifestFile(file_io, f"{table_path}/manifest", manifest_compression)
        self.manifest_list = ManifestList(file_io, f"{table_path}/manifest", manifest_compression)
        self._partition_filter: Callable[[tuple], bool] | None = None
        self._bucket: int | None = None

    def with_partition_filter(self, fn: Callable[[tuple], bool]) -> "FileStoreScan":
        self._partition_filter = fn
        return self

    def with_bucket(self, bucket: int) -> "FileStoreScan":
        self._bucket = bucket
        return self

    def plan(self) -> ScanPlan:
        snapshot = self.snapshot_manager.latest_snapshot()
        if snapshot is None:
            return ScanPlan(None, [])
        metas = self.manifest_list.read(snapshot.base_manifest_list) + self.manifest_list.read(
            snapshot.delta_manifest_list
        )
        entries = merge_entries(*(self.manifest_file.read(m.file_name) for m in metas))
        entries = [
            e
            for e in entries
            if (self._partition_filter is None or self._partition_filter(e.partition))
            and (self._bucket is None or e.bucket == self._bucket)
        ]
        return ScanPlan(snapshot, entries)
