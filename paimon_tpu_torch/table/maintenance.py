"""Partition expiry and drop (port of paimon_tpu/table/maintenance.py:
expire_partitions, drop_partition; remove_orphan_files and
mark_partition_done are not ported yet).

Both write one OVERWRITE snapshot that deletes the live files of the
chosen partitions, under the maintenance commit identifier. The files
stay on disk until snapshot expiry finds no retained snapshot that
references them.
"""

from __future__ import annotations

import datetime
from typing import TYPE_CHECKING

from ..core.manifest import ManifestCommittable
from ..utils import now_millis

if TYPE_CHECKING:
    from . import FileStoreTable

__all__ = ["expire_partitions", "drop_partition", "MAINTENANCE_COMMIT_IDENTIFIER"]

# the JAX package's identifier for maintenance commits, one of the batch
# sentinels near the batch identifier, outside any streaming sequence
MAINTENANCE_COMMIT_IDENTIFIER = (1 << 63) - 4


def expire_partitions(
    table: "FileStoreTable", expiration_millis: int, time_col: str | None = None, pattern: str = "%Y-%m-%d"
) -> list[tuple]:
    """Drop the partitions whose `time_col` value (the first partition key
    when None), parsed with the strptime `pattern`, is older than
    `expiration_millis`; values that do not parse are kept. Returns the
    dropped partitions."""
    keys = table.partition_keys
    if not keys:
        return []
    col = time_col or keys[0]
    if col not in keys:
        raise ValueError(f"time_col {col!r} is not a partition key (have {keys})")
    idx = keys.index(col)
    cutoff = now_millis() - expiration_millis
    expired: list[tuple] = []
    for partition in table.store.new_scan().plan().grouped():
        try:
            ts = datetime.datetime.strptime(str(partition[idx]), pattern).timestamp() * 1000
        except ValueError:
            continue
        if ts < cutoff:
            expired.append(partition)
    _commit_partition_drop(table, expired)
    return expired


def drop_partition(table: "FileStoreTable", *specs: dict[str, str]) -> list[tuple]:
    """Drop every partition that matches any of `specs` (each a non-empty,
    possibly partial {partition key: value} map) in one snapshot, so that
    no reader sees a partial drop. Returns the dropped partitions."""
    keys = table.partition_keys
    if not keys:
        raise ValueError("drop_partition requires a partitioned table")
    if not specs or any(not s for s in specs):
        raise ValueError("each partition spec must name at least one key=value")
    compiled = []
    for spec in specs:
        unknown = set(spec) - set(keys)
        if unknown:
            raise ValueError(f"not partition keys: {sorted(unknown)} (have {keys})")
        compiled.append([(keys.index(k), str(v)) for k, v in spec.items()])
    dead = [
        p
        for p in table.store.new_scan().plan().grouped()
        if any(all(str(p[i]) == v for i, v in positions) for positions in compiled)
    ]
    _commit_partition_drop(table, dead)
    return dead


def _commit_partition_drop(table: "FileStoreTable", partitions: list[tuple]) -> None:
    if not partitions:
        return
    dead = set(partitions)
    table.store.new_commit().overwrite(
        ManifestCommittable(MAINTENANCE_COMMIT_IDENTIFIER, messages=[]), partition_filter=lambda p: p in dead
    )
