"""Table statistics: ANALYZE (port of paimon_tpu/table/statistics.py).

`analyze_table` reads the merged table, computes the row count and, with
columns, each column's min, max and null count (format.collect_stats),
writes them as a statistics file and registers it on a new ANALYZE
snapshot; `read_statistics` finds the newest one. The JSON keys are the
JAX package's, so each package reads the other's file.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING

from ..utils import dumps, loads, new_file_name

if TYPE_CHECKING:
    from . import FileStoreTable

__all__ = ["Statistics", "analyze_table", "read_statistics"]


@dataclass
class Statistics:
    snapshot_id: int
    schema_id: int
    merged_record_count: int
    merged_record_size: int
    col_stats: dict[str, dict] = field(default_factory=dict)

    def to_json(self) -> str:
        return dumps(
            {
                "snapshotId": self.snapshot_id,
                "schemaId": self.schema_id,
                "mergedRecordCount": self.merged_record_count,
                "mergedRecordSize": self.merged_record_size,
                "colStats": self.col_stats,
            }
        )

    @staticmethod
    def from_json(s: bytes | str) -> "Statistics":
        d = loads(s)
        return Statistics(d["snapshotId"], d["schemaId"], d["mergedRecordCount"], d["mergedRecordSize"], d["colStats"])


def analyze_table(table: "FileStoreTable", with_columns: bool = True) -> Statistics:
    """Scan the merged table, compute stats, persist them, and record the
    stats file on a new ANALYZE snapshot."""
    rb = table.new_read_builder()
    splits = rb.new_scan().plan()
    out = rb.new_read().read_all(splits)
    sm = table.store.snapshot_manager
    latest = sm.latest_snapshot()
    col_stats: dict[str, dict] = {}
    if with_columns and out.num_rows:
        from ..format import collect_stats

        for name, st in collect_stats(out).items():
            col_stats[name] = {
                "distinctCount": None,
                "min": st.min if not isinstance(st.min, bytes) else None,
                "max": st.max if not isinstance(st.max, bytes) else None,
                "nullCount": st.null_count,
            }
    stats = Statistics(
        snapshot_id=latest.id if latest else 0,
        schema_id=table.schema.id,
        merged_record_count=out.num_rows,
        merged_record_size=sum(f.file_size for s in splits for f in s.files),
        col_stats=col_stats,
    )
    name = new_file_name("stats")
    table.file_io.write_bytes(f"{table.path}/statistics/{name}", stats.to_json().encode())
    # register on a fresh ANALYZE snapshot
    from ..core.manifest import ManifestCommittable
    from ..core.snapshot import CommitKind

    commit = table.store.new_commit()
    commit._try_commit(
        CommitKind.ANALYZE, [], ManifestCommittable((1 << 63) - 5), check_conflicts=False, statistics=name
    )
    return stats


def read_statistics(table: "FileStoreTable") -> Statistics | None:
    sm = table.store.snapshot_manager
    for snap in list(sm.snapshots())[::-1]:
        if snap.statistics:
            return Statistics.from_json(table.file_io.read_bytes(f"{table.path}/statistics/{snap.statistics}"))
    return None
