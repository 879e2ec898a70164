"""Index file entries (port of the IndexFileEntry dataclass of
paimon_tpu/core/deletionvectors.py; deletion vectors themselves are not
ported, and the scan refuses tables that hold them)."""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["IndexFileEntry"]


@dataclass(frozen=True)
class IndexFileEntry:
    """One index file registered for a (partition, bucket)."""

    kind: str  # "DELETION_VECTORS" | "HASH_INDEX"
    partition: tuple
    bucket: int
    file_name: str
    row_count: int

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "partition": list(self.partition),
            "bucket": self.bucket,
            "fileName": self.file_name,
            "rowCount": self.row_count,
        }

    @staticmethod
    def from_dict(d: dict) -> "IndexFileEntry":
        return IndexFileEntry(d["kind"], tuple(d["partition"]), d["bucket"], d["fileName"], d["rowCount"])
