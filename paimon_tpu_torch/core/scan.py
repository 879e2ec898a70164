"""Snapshot scan planning: snapshot -> manifest lists -> live file entries,
and the index manifest's entries (port of paimon_tpu/core/scan.py;
delta/changelog scans and file-index filters are not ported yet).

Files are filtered by partition, bucket and the min/max/null-count stats
of their metadata. On a primary-key table only a key filter may skip a
file: a file whose values miss a predicate may still hold the newest
version of a key whose older version matches, and skipping it would bring
the older one back. Value filters are for tables whose every row is
final. The plan carries the index manifest's entries of the planned
buckets (hash index and deletion vectors; a key or value filter never
drops them).

The port plans the latest snapshot on main only: options that select
another snapshot, branch or set of rows raise NotImplementedError naming
the option instead of returning other rows.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from ..data.predicate import Predicate
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

    def dv_index_for(self, partition: tuple, bucket: int) -> str | None:
        """The bucket's deletion-vector container, if it has one."""
        return next(
            (
                e.file_name
                for e in self.index_entries
                if e.kind == "DELETION_VECTORS" and e.partition == partition and e.bucket == bucket
            ),
            None,
        )

    def dv_indexes(self) -> dict[tuple, str]:
        """{(partition, bucket): deletion-vector container} of every bucket
        that has one."""
        return {(e.partition, e.bucket): e.file_name for e in self.index_entries if e.kind == "DELETION_VECTORS"}


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
        self._key_filter: Predicate | None = None
        self._value_filter: Predicate | None = None

    def with_partition_filter(self, fn: Callable[[tuple], bool]) -> "FileStoreScan":
        self._partition_filter = fn
        return self

    def with_bucket(self, bucket: int) -> "FileStoreScan":
        self._bucket = bucket
        return self

    def with_key_filter(self, predicate: Predicate | None) -> "FileStoreScan":
        """Skip files whose key stats cannot match."""
        self._key_filter = predicate
        return self

    def with_value_filter(self, predicate: Predicate | None) -> "FileStoreScan":
        """Skip files whose value stats cannot match: sound only where every
        row is final, never on a primary-key table's merge input."""
        self._value_filter = predicate
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

    def plan(self) -> ScanPlan:
        snapshot = self.snapshot_manager.latest_snapshot()
        self._check_reads_latest_on_main(snapshot)
        if snapshot is None:
            return ScanPlan(None, [])
        index_entries = (
            read_index_manifest(self.file_io, self.table_path, snapshot.index_manifest)
            if snapshot.index_manifest
            else []
        )
        metas = self.manifest_list.read(snapshot.base_manifest_list) + self.manifest_list.read(
            snapshot.delta_manifest_list
        )
        entries = merge_entries(*(self.manifest_file.read(m.file_name) for m in metas))
        return ScanPlan(
            snapshot, [e for e in entries if self._accept(e)], [e for e in index_entries if self._accept_slot(e)]
        )

    def _accept_slot(self, e: "ManifestEntry | IndexFileEntry") -> bool:
        return (self._partition_filter is None or self._partition_filter(e.partition)) and (
            self._bucket is None or e.bucket == self._bucket
        )

    def _accept(self, e: ManifestEntry) -> bool:
        return (
            self._accept_slot(e)
            and (self._key_filter is None or self._key_filter.test_stats(e.file.key_stats))
            and (self._value_filter is None or self._value_filter.test_stats(e.file.value_stats))
        )
