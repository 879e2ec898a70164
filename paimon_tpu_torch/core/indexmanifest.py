"""Index manifest IO (port of paimon_tpu/core/indexmanifest.py): the index
manifest lists the hash-index and deletion-vector index files per
(partition, bucket) as plain JSON lines; a snapshot points at one."""

from __future__ import annotations

from ..fs import FileIO
from ..utils import dumps, loads, new_file_name
from .deletionvectors import IndexFileEntry

__all__ = ["read_index_manifest", "write_index_manifest"]


def read_index_manifest(file_io: FileIO, table_path: str, name: str) -> list[IndexFileEntry]:
    data = file_io.read_bytes(f"{table_path}/manifest/{name}")
    return [IndexFileEntry.from_dict(loads(line)) for line in data.decode().splitlines() if line]


def write_index_manifest(file_io: FileIO, table_path: str, entries: list[IndexFileEntry]) -> str:
    name = new_file_name("index-manifest")
    payload = "\n".join(dumps(e.to_dict()) for e in entries).encode()
    file_io.write_bytes(f"{table_path}/manifest/{name}", payload)
    return name
