"""The manifest metadata tree (port of paimon_tpu/core/manifest.py).

A manifest file holds ManifestEntry records (ADD/DELETE of a DataFileMeta
at a partition and bucket); a manifest list holds ManifestFileMeta
records. As in the JAX package, each file is one zstd frame of JSON lines
unless manifest.compression=none; under manifest.format=avro it is the
reference's Avro layout instead (interop/manifest_codec.py: the null codec
under manifest.compression=none, else deflate), whose positional stats
decode under the schema that wrote each file (read from the schema/
directory beside the manifest/ one, so a branch resolves its own). Every
read sniffs the magic bytes (zstd, Avro, else plain JSON lines), so a
table whose option changed mid-life reads both kinds.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Iterable, Sequence

from ..fs import FileIO
from ..interop.manifest_codec import (
    StatsContext,
    read_entries_avro,
    read_metas_avro,
    write_entries_avro,
    write_metas_avro,
)
from ..utils import dumps, loads, new_file_name
from ..utils.compression import ZSTD_MAGIC, zstd_compress, zstd_decompress
from .datafile import DataFileMeta

__all__ = [
    "FileKind",
    "ManifestEntry",
    "ManifestFileMeta",
    "ManifestFile",
    "ManifestList",
    "CommitMessage",
    "ManifestCommittable",
    "merge_entries",
    "merge_entries_keep_deletes",
]

_AVRO_MAGIC = b"Obj\x01"


class FileKind(int, enum.Enum):
    ADD = 0
    DELETE = 1


@dataclass(frozen=True)
class ManifestEntry:
    kind: FileKind
    partition: tuple
    bucket: int
    total_buckets: int
    file: DataFileMeta

    def identifier(self) -> tuple:
        return (self.partition, self.bucket, self.file.level, self.file.file_name)

    def to_dict(self) -> dict:
        return {
            "kind": int(self.kind),
            "partition": list(self.partition),
            "bucket": self.bucket,
            "totalBuckets": self.total_buckets,
            "file": self.file.to_dict(),
        }

    @staticmethod
    def from_dict(d: dict) -> "ManifestEntry":
        return ManifestEntry(
            FileKind(d["kind"]), tuple(d["partition"]), d["bucket"], d["totalBuckets"], DataFileMeta.from_dict(d["file"])
        )


@dataclass(frozen=True)
class ManifestFileMeta:
    file_name: str
    file_size: int
    num_added_files: int
    num_deleted_files: int
    schema_id: int

    def to_dict(self) -> dict:
        return {
            "fileName": self.file_name,
            "fileSize": self.file_size,
            "numAddedFiles": self.num_added_files,
            "numDeletedFiles": self.num_deleted_files,
            "schemaId": self.schema_id,
        }

    @staticmethod
    def from_dict(d: dict) -> "ManifestFileMeta":
        return ManifestFileMeta(d["fileName"], d["fileSize"], d["numAddedFiles"], d["numDeletedFiles"], d["schemaId"])


class _JsonLines:
    def __init__(
        self, file_io: FileIO, directory: str, compression: str = "default", fmt: str = "jsonl", cache=None
    ):
        self.file_io = file_io
        self.directory = directory
        self.compression = str(compression).lower()
        self.format = str(fmt).lower()
        # the manifest cache (utils/cache.py), keyed by (kind, full path)
        self.cache = cache if cache is not None and cache.enabled else None
        self._resolver_fn = None

    def _resolver(self):
        """schema id -> StatsContext of the table whose manifest/ directory
        this is, or None when it has no schema yet. A failed read is not
        kept, so a passing IO error never sticks."""
        if self._resolver_fn is None:
            from .schema import SchemaManager

            sm = SchemaManager(self.file_io, self.directory.rsplit("/", 1)[0])
            latest = sm.latest()
            if latest is None:
                return None
            contexts = {latest.id: StatsContext.from_table_schema(latest)}

            def resolve(schema_id: int) -> StatsContext:
                if schema_id not in contexts:
                    try:
                        contexts[schema_id] = StatsContext.from_table_schema(sm.schema(schema_id))
                    except Exception:  # noqa: BLE001 - a missing schema file: the JAX package's fallback
                        contexts[schema_id] = contexts[latest.id]
                return contexts[schema_id]

            self._resolver_fn = resolve
        return self._resolver_fn

    def _avro_codec(self) -> str:
        return "null" if self.compression == "none" else "deflate"

    def _cached_read(self, kind: str, name: str, decode):
        """Decode once: the cache keeps an immutable tuple and every caller
        gets a list of its own, so no caller can change what the cache
        holds."""
        if self.cache is None:
            return decode()
        path = f"{self.directory}/{name}"
        key = (kind, path)
        cached = self.cache.get(key)
        if cached is not None:
            return list(cached)
        out = decode()
        self.cache.put(key, tuple(out), weight=max(len(out) * 512, 256), file_id=path)
        return list(out)

    def _write_lines(self, name: str, dicts: Iterable[dict], track: list[str] | None) -> int:
        data = "\n".join(dumps(d) for d in dicts).encode()
        if self.compression != "none":  # every other value means zstd, as in the JAX package
            data = zstd_compress(data)
        return self._write_payload(name, data, track)

    def _write_payload(self, name: str, data: bytes, track: list[str] | None) -> int:
        if track is not None:
            track.append(name)
        if not self.file_io.try_atomic_write(f"{self.directory}/{name}", data):
            raise OSError(f"manifest {name} unexpectedly already exists")
        return len(data)

    def _avro_resolver(self):
        """The resolver when this accessor writes Avro, else None (JSON
        lines; also when the table has no schema, as in the JAX package)."""
        return self._resolver() if self.format == "avro" else None

    @staticmethod
    def _lines(data: bytes) -> list[dict]:
        if data[:4] == ZSTD_MAGIC:
            data = bytes(zstd_decompress(data))
        return [loads(line) for line in data.decode().splitlines() if line]

    def delete(self, name: str) -> None:
        self.file_io.delete(f"{self.directory}/{name}")
        if self.cache is not None:
            self.cache.invalidate_file(f"{self.directory}/{name}")


class ManifestFile(_JsonLines):
    def write(self, entries: Sequence[ManifestEntry], schema_id: int, track: list[str] | None = None) -> ManifestFileMeta:
        name = new_file_name("manifest")
        resolver = self._avro_resolver()
        if resolver is not None:
            size = self._write_payload(name, write_entries_avro(entries, resolver, self._avro_codec()), track)
        else:
            size = self._write_lines(name, (e.to_dict() for e in entries), track)
        added = sum(1 for e in entries if e.kind == FileKind.ADD)
        return ManifestFileMeta(name, size, added, len(entries) - added, schema_id)

    def read(self, name: str) -> list[ManifestEntry]:
        return self._cached_read("manifest", name, lambda: self._decode(name))

    def _decode(self, name: str) -> list[ManifestEntry]:
        data = self.file_io.read_bytes(f"{self.directory}/{name}")
        if data[:4] == _AVRO_MAGIC:
            resolver = self._resolver()
            if resolver is None:
                raise ValueError(f"avro manifest {name} needs the table schema for decoding")
            return read_entries_avro(data, resolver)
        return [ManifestEntry.from_dict(d) for d in self._lines(data)]


class ManifestList(_JsonLines):
    def write(self, metas: Sequence[ManifestFileMeta], track: list[str] | None = None) -> str:
        name = new_file_name("manifest-list")
        resolver = self._avro_resolver()
        if resolver is not None:
            self._write_payload(name, write_metas_avro(metas, resolver, self._avro_codec()), track)
        else:
            self._write_lines(name, (m.to_dict() for m in metas), track)
        return name

    def read(self, name: str) -> list[ManifestFileMeta]:
        return self._cached_read("manifest-list", name, lambda: self._decode(name))

    def _decode(self, name: str) -> list[ManifestFileMeta]:
        data = self.file_io.read_bytes(f"{self.directory}/{name}")
        if data[:4] == _AVRO_MAGIC:
            return read_metas_avro(data)
        return [ManifestFileMeta.from_dict(d) for d in self._lines(data)]


def merge_entries(*entry_lists: Iterable[ManifestEntry]) -> list[ManifestEntry]:
    """Apply DELETE entries against ADDs in order: the live set."""
    live: dict[tuple, ManifestEntry] = {}
    for entries in entry_lists:
        for e in entries:
            if e.kind == FileKind.ADD:
                live[e.identifier()] = e
            else:
                live.pop(e.identifier(), None)
    return list(live.values())


def merge_entries_keep_deletes(*entry_lists: Iterable[ManifestEntry]) -> list[ManifestEntry]:
    """merge_entries for a subset of the manifests: a DELETE whose ADD lies
    outside the subset is kept (first), or that ADD would come back."""
    live: dict[tuple, ManifestEntry] = {}
    deletes: dict[tuple, ManifestEntry] = {}
    for entries in entry_lists:
        for e in entries:
            key = e.identifier()
            if e.kind == FileKind.ADD:
                live[key] = e
            elif key in live:
                live.pop(key)
            else:
                deletes[key] = e
    return list(deletes.values()) + list(live.values())


@dataclass
class CommitMessage:
    """Per-(partition, bucket) new files from one writer, the files its
    compactions removed (compact_before) and wrote (compact_after), its
    changelog files (changelog_files from flushes under the input and
    lookup producers, compact_changelog_files from compactions), and the
    bucket's new index files (the dynamic-bucket hash index)."""

    partition: tuple
    bucket: int
    total_buckets: int
    new_files: list[DataFileMeta] = field(default_factory=list)
    compact_before: list[DataFileMeta] = field(default_factory=list)
    compact_after: list[DataFileMeta] = field(default_factory=list)
    new_index_files: list = field(default_factory=list)  # IndexFileEntry
    changelog_files: list[DataFileMeta] = field(default_factory=list)
    compact_changelog_files: list[DataFileMeta] = field(default_factory=list)

    def is_empty(self) -> bool:
        return not (
            self.new_files
            or self.compact_before
            or self.compact_after
            or self.new_index_files
            or self.changelog_files
            or self.compact_changelog_files
        )


@dataclass
class ManifestCommittable:
    commit_identifier: int
    watermark: int | None = None
    log_offsets: dict[int, int] = field(default_factory=dict)
    messages: list[CommitMessage] = field(default_factory=list)
    # the APPEND snapshot of this committable has landed: commit only its
    # COMPACT half (set by a commit and by filter_committed on replay)
    skip_append: bool = False
