"""Snapshot scan planning: snapshot -> manifest lists -> live file entries,
and the index manifest's entries (port of paimon_tpu/core/scan.py;
delta/changelog scans and stats/index filters are not ported yet).

The port plans the latest snapshot on main only, reads no deletion
vectors and drops no expired records: options that select another
snapshot, branch or set of rows, tables that hold deletion vectors, and
record-level TTL raise NotImplementedError naming the option instead of
returning other rows.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from ..fs import LocalFileIO
from ..options import ConfigOption, CoreOptions
from .deletionvectors import IndexFileEntry
from .indexmanifest import read_index_manifest
from .manifest import ManifestEntry, ManifestFile, ManifestList, merge_entries
from .snapshot import Snapshot, SnapshotManager

# batch-scan options of the JAX package (paimon_tpu/options.py:966-988 and
# its incremental-between pair) that read another snapshot or other rows
_TIME_TRAVEL_KEYS = (
    "scan.timestamp-millis",
    "log.scan.timestamp-millis",
    "scan.timestamp",
    "scan.tag-name",
    "scan.version",
    "scan.watermark",
    "scan.file-creation-time-millis",
    "incremental-between",
    "incremental-between-timestamp",
)
_LATEST_SCAN_MODES = ("default", "latest-full", "full", "latest")

__all__ = ["ScanPlan", "FileStoreScan"]


@dataclass
class ScanPlan:
    snapshot: Snapshot | None
    entries: list[ManifestEntry] = field(default_factory=list)
    index_entries: list[IndexFileEntry] = field(default_factory=list)

    def grouped(self) -> dict[tuple, dict[int, list]]:
        """{partition: {bucket: [DataFileMeta...]}}"""
        out: dict[tuple, dict[int, list]] = {}
        for e in self.entries:
            out.setdefault(e.partition, {}).setdefault(e.bucket, []).append(e.file)
        return out


class FileStoreScan:
    def __init__(self, file_io: LocalFileIO, table_path: str, options: CoreOptions):
        self.file_io = file_io
        self.table_path = table_path
        self.options = options
        self.snapshot_manager = SnapshotManager(file_io, table_path)
        self.manifest_file = ManifestFile(file_io, f"{table_path}/manifest", options.manifest_compression)
        self.manifest_list = ManifestList(file_io, f"{table_path}/manifest", options.manifest_compression)
        self._partition_filter: Callable[[tuple], bool] | None = None
        self._bucket: int | None = None

    def with_partition_filter(self, fn: Callable[[tuple], bool]) -> "FileStoreScan":
        self._partition_filter = fn
        return self

    def with_bucket(self, bucket: int) -> "FileStoreScan":
        self._bucket = bucket
        return self

    def _check_reads_latest_on_main(self, latest: Snapshot | None) -> None:
        opts = self.options.options
        chosen = [f"{k}={opts.get(ConfigOption.string(k))}" for k in _TIME_TRAVEL_KEYS if opts.contains(k)]
        snapshot_id = opts.get(CoreOptions.SCAN_SNAPSHOT_ID)
        if snapshot_id is not None and (latest is None or snapshot_id != latest.id):
            chosen.append(f"scan.snapshot-id={snapshot_id}")
        mode = opts.get(CoreOptions.SCAN_MODE)
        if str(mode).lower() not in _LATEST_SCAN_MODES:
            chosen.append(f"scan.mode={mode}")
        branch = opts.get(CoreOptions.BRANCH)
        if branch != "main":
            chosen.append(f"branch={branch}")
        if chosen:
            raise NotImplementedError(
                f"{', '.join(chosen)}: the torch port reads only the latest snapshot on main (time travel, "
                "branches and incremental scans are not ported yet)"
            )

    def _check_no_deletion_vectors(self, snapshot: Snapshot, index_entries: list[IndexFileEntry]) -> None:
        if self.options.options.get(CoreOptions.DELETION_VECTORS_ENABLED):
            raise NotImplementedError("deletion-vectors.enabled=true: deletion vectors are not ported to the torch port yet")
        if any(e.kind == "DELETION_VECTORS" for e in index_entries):
            raise NotImplementedError(
                f"snapshot {snapshot.id} holds deletion vectors (deletion-vectors.enabled), which the torch "
                "port cannot apply yet"
            )

    def _check_no_record_ttl(self) -> None:
        """The JAX package drops rows older than record-level.expire-time on
        every read once record-level.time-field names their time column."""
        opts = self.options.options
        key = opts.set_key(CoreOptions.RECORD_LEVEL_EXPIRE_TIME)
        if key is not None and opts.get(CoreOptions.RECORD_LEVEL_TIME_FIELD) is not None:
            raise NotImplementedError(
                f"{key}: the torch port does not drop expired records on read yet (record-level.time-field="
                f"{opts.get(CoreOptions.RECORD_LEVEL_TIME_FIELD)})"
            )

    def plan(self) -> ScanPlan:
        self._check_no_record_ttl()
        snapshot = self.snapshot_manager.latest_snapshot()
        self._check_reads_latest_on_main(snapshot)
        if snapshot is None:
            return ScanPlan(None, [])
        index_entries = (
            read_index_manifest(self.file_io, self.table_path, snapshot.index_manifest)
            if snapshot.index_manifest
            else []
        )
        self._check_no_deletion_vectors(snapshot, index_entries)
        metas = self.manifest_list.read(snapshot.base_manifest_list) + self.manifest_list.read(
            snapshot.delta_manifest_list
        )
        entries = merge_entries(*(self.manifest_file.read(m.file_name) for m in metas))
        return ScanPlan(snapshot, [e for e in entries if self._accept(e)], [e for e in index_entries if self._accept(e)])

    def _accept(self, e: "ManifestEntry | IndexFileEntry") -> bool:
        return (self._partition_filter is None or self._partition_filter(e.partition)) and (
            self._bucket is None or e.bucket == self._bucket
        )
