"""Partition expiry, drop and done markers (port of
paimon_tpu/table/maintenance.py: expire_partitions, drop_partition and
mark_partition_done; remove_orphan_files needs resilience/orphan.py and is
not ported yet, ROADMAP Queue 1 item 15).

Expiry and drop write one OVERWRITE snapshot that deletes the live files of
the chosen partitions, under the maintenance commit identifier. The files
stay on disk until snapshot expiry finds no retained snapshot that
references them. mark_partition_done writes a _SUCCESS file in each named
partition's directory.
"""

from __future__ import annotations

import datetime
from typing import TYPE_CHECKING

from ..core.manifest import ManifestCommittable
from ..utils import dumps, loads, now_millis, partition_path

if TYPE_CHECKING:
    from . import FileStoreTable

__all__ = ["expire_partitions", "drop_partition", "mark_partition_done", "MAINTENANCE_COMMIT_IDENTIFIER"]

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


def mark_partition_done(table: "FileStoreTable", specs: list[dict[str, str]]) -> list[str]:
    """Write a _SUCCESS file in each partition directory of `specs` (each a
    full {partition key: value} map), for schedulers that poll it to learn
    that the partition takes no more data. The content is the JAX package's
    JSON {creationTime, modificationTime}; a second mark keeps the creation
    time. Returns the marker paths."""
    keys = table.partition_keys
    if not keys:
        raise ValueError("mark_partition_done requires a partitioned table")
    out = []
    for spec in specs:
        missing = [k for k in keys if k not in spec]
        if missing:
            raise ValueError(f"partition spec {spec} missing keys {missing}")
        path = f"{table.path}/{partition_path(keys, tuple(spec[k] for k in keys))}/_SUCCESS"
        now = now_millis()
        try:
            created = loads(table.file_io.read_bytes(path)).get("creationTime", now)
        except (FileNotFoundError, OSError, ValueError):
            created = now
        table.file_io.try_overwrite(path, dumps({"creationTime": created, "modificationTime": now}).encode())
        out.append(path)
    return out
