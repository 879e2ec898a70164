"""Snapshot scan planning: snapshot -> manifest lists -> file entries,
and the index manifest's entries (port of paimon_tpu/core/scan.py;
file-index filters are not ported yet).

A scan plans the latest snapshot or the one with_snapshot names, of one of
three kinds: "all" (the live files of base + delta manifests), "delta"
(the ADD entries of the snapshot's delta manifest list: the files it
wrote) or "changelog" (the entries of its changelog manifest list). The
index entries come from the planned snapshot's index manifest, so a read
of an old snapshot takes that snapshot's deletion vectors.

Files are filtered by partition, bucket, level and the min/max/null-count
stats of their metadata. On a primary-key table only a key filter may skip
a file: a file whose values miss a predicate may still hold the newest
version of a key whose older version matches, and skipping it would bring
the older one back. Value filters are for tables whose every row is
final. A key or value filter never drops index entries. A file written
under an older schema is tested by the stats of its fields that keep
their id and whose type change keeps them comparable (data/casting.py
stats_comparable), under today's names; its other fields do not prune.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from ..data.casting import stats_comparable
from ..data.predicate import Predicate
from ..fs import LocalFileIO
from ..options import CoreOptions
from ..types import RowType
from .datafile import DataFileMeta
from .deletionvectors import IndexFileEntry
from .indexmanifest import read_index_manifest
from .manifest import FileKind, ManifestEntry, ManifestFile, ManifestList, merge_entries
from .schema import SchemaManager
from .snapshot import Snapshot, SnapshotManager

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
    def __init__(
        self,
        file_io: LocalFileIO,
        table_path: str,
        options: CoreOptions,
        value_schema: RowType | None = None,
        cache=None,
    ):
        self.file_io = file_io
        # the schema the filters name fields in; None takes every file's
        # stats as they are
        self.value_schema = value_schema
        self._stats_names: dict[int, dict[str, str] | None] = {}
        self.table_path = table_path
        self.options = options
        # the manifest cache (utils/cache.py): repeated plans decode each
        # snapshot, manifest list and manifest once
        self.snapshot_manager = SnapshotManager(file_io, table_path, cache=cache)
        self.manifest_file = ManifestFile(file_io, f"{table_path}/manifest", options.manifest_compression, cache=cache)
        self.manifest_list = ManifestList(file_io, f"{table_path}/manifest", options.manifest_compression, cache=cache)
        self._snapshot_id: int | None = None
        self._kind = "all"
        self._partition_filter: Callable[[tuple], bool] | None = None
        self._bucket: int | None = None
        self._level: int | None = None
        self._key_filter: Predicate | None = None
        self._value_filter: Predicate | None = None

    def with_snapshot(self, snapshot_id: int) -> "FileStoreScan":
        self._snapshot_id = snapshot_id
        return self

    def with_kind(self, kind: str) -> "FileStoreScan":
        """"all", "delta" or "changelog"."""
        if kind not in ("all", "delta", "changelog"):
            raise ValueError(f"unknown scan kind {kind!r}")
        self._kind = kind
        return self

    def with_level(self, level: int) -> "FileStoreScan":
        self._level = level
        return self

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

    def plan(self) -> ScanPlan:
        sm = self.snapshot_manager
        snapshot = sm.latest_snapshot() if self._snapshot_id is None else sm.snapshot(self._snapshot_id)
        if snapshot is None:
            return ScanPlan(None, [])
        if self._kind == "changelog":
            metas = self.manifest_list.read(snapshot.changelog_manifest_list) if snapshot.changelog_manifest_list else []
            entries = [e for m in metas for e in self.manifest_file.read(m.file_name)]
        elif self._kind == "delta":
            metas = self.manifest_list.read(snapshot.delta_manifest_list)
            entries = [e for m in metas for e in self.manifest_file.read(m.file_name) if e.kind == FileKind.ADD]
        else:
            metas = self.manifest_list.read(snapshot.base_manifest_list) + self.manifest_list.read(
                snapshot.delta_manifest_list
            )
            entries = merge_entries(*(self.manifest_file.read(m.file_name) for m in metas))
        index_entries = (
            read_index_manifest(self.file_io, self.table_path, snapshot.index_manifest)
            if snapshot.index_manifest
            else []
        )
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
            and (self._level is None or e.file.level == self._level)
            and (self._key_filter is None or self._key_filter.test_stats(self._stats(e.file, e.file.key_stats)))
            and (self._value_filter is None or self._value_filter.test_stats(self._stats(e.file, e.file.value_stats)))
        )

    def _stats(self, f: DataFileMeta, stats: dict) -> dict:
        """The file's stats under the scan schema's names, without those
        that cannot bound the values as read now."""
        if self.value_schema is None:
            return stats
        if f.schema_id not in self._stats_names:
            try:
                written = SchemaManager(self.file_io, self.table_path).schema(f.schema_id).fields
            except FileNotFoundError:  # a view whose schemas lie elsewhere: the stats as written
                written = self.value_schema.fields
            names = None
            if written != self.value_schema.fields:
                now = {g.id: g for g in self.value_schema.fields}
                names = {
                    g.name: now[g.id].name
                    for g in written
                    if g.id in now and stats_comparable(g.type, now[g.id].type)
                }
            self._stats_names[f.schema_id] = names
        names = self._stats_names[f.schema_id]
        return stats if names is None else {names[k]: v for k, v in stats.items() if k in names}
