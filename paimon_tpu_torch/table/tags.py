"""Tags: named retained snapshots (port of paimon_tpu/table/tags.py).

A tag is a copy of a snapshot's JSON under table/tag/tag-<name>; snapshot
expiry keeps every tagged snapshot and its files. TagAutoCreation tags the
latest snapshot once a daily or hourly period has closed.
"""

from __future__ import annotations

import datetime
from typing import TYPE_CHECKING

from ..core.snapshot import Snapshot, SnapshotManager
from ..fs import FileIO
from ..options import CoreOptions
from ..utils import now_millis

if TYPE_CHECKING:
    from . import FileStoreTable

__all__ = ["TagManager", "TagAutoCreation"]


class TagManager:
    def __init__(self, file_io: FileIO, table_path: str):
        self.file_io = file_io
        self.table_path = table_path
        self.tag_dir = f"{table_path}/tag"
        self.snapshot_manager = SnapshotManager(file_io, table_path)

    def tag_path(self, name: str) -> str:
        return f"{self.tag_dir}/tag-{name}"

    def create(self, name: str, snapshot_id: int | None = None) -> None:
        """Tag `snapshot_id` (the latest when None); ValueError when the tag
        exists or the table has no snapshot."""
        if self.file_io.exists(self.tag_path(name)):
            raise ValueError(f"tag {name!r} already exists")
        if snapshot_id is None:
            snapshot_id = self.snapshot_manager.latest_snapshot_id()
            if snapshot_id is None:
                raise ValueError("cannot tag an empty table")
        snap = self.snapshot_manager.snapshot(snapshot_id)
        if not self.file_io.try_atomic_write(self.tag_path(name), snap.to_json().encode()):
            raise ValueError(f"tag {name!r} already exists")

    def delete(self, name: str) -> None:
        self.file_io.delete(self.tag_path(name))

    def get(self, name: str) -> Snapshot:
        return Snapshot.from_json(self.file_io.read_bytes(self.tag_path(name)))

    def snapshot_id(self, name: str) -> int:
        """The tagged snapshot's id (FileNotFoundError for no such tag)."""
        return self.get(name).id

    def list_tags(self) -> dict[str, int]:
        """Tag name -> tagged snapshot id."""
        out = {}
        for st in self.file_io.list_files(self.tag_dir):
            base = st.path.rsplit("/", 1)[-1]
            if base.startswith("tag-"):
                name = base[len("tag-") :]
                out[name] = self.get(name).id
        return out

    def tagged_snapshot_ids(self) -> set[int]:
        return set(self.list_tags().values())


class TagAutoCreation:
    """tag.automatic-creation: once a tag.creation-period (daily or hourly)
    has closed, plus tag.creation-delay, the latest snapshot is tagged with
    the period's name, formatted by tag.period-formatter (with_dashes:
    2024-01-02[ 03]; otherwise 20240102[03]). The clock is the process's
    (process-time) or the latest snapshot's watermark (watermark). Only
    tags whose names parse as the period's format are pruned, by
    tag.num-retained-max and tag.default-time-retained; tag.callbacks run
    for each new tag."""

    def __init__(self, table: "FileStoreTable"):
        self.table = table
        self.tm = TagManager(table.file_io, table.path)

    def run(self) -> list[str]:
        """The names of the tags created."""
        opts = self.table.options.options
        mode = opts.get(CoreOptions.TAG_AUTOMATIC_CREATION)
        if mode in (None, "none"):
            return []
        snap = self.tm.snapshot_manager.latest_snapshot()
        if snap is None:
            return []
        if mode == "watermark":
            if snap.watermark is None:
                return []
            t = snap.watermark
        else:  # process-time
            t = now_millis()
        delay = opts.get(CoreOptions.TAG_CREATION_DELAY) or 0
        with_dashes = opts.get(CoreOptions.TAG_PERIOD_FORMATTER) == "with_dashes"
        ref = datetime.datetime.fromtimestamp((t - delay) / 1000)
        if opts.get(CoreOptions.TAG_CREATION_PERIOD) == "hourly":
            closed = ref.replace(minute=0, second=0, microsecond=0) - datetime.timedelta(hours=1)
            fmt = "%Y-%m-%d %H" if with_dashes else "%Y%m%d%H"
        else:  # daily
            closed = ref.replace(hour=0, minute=0, second=0, microsecond=0) - datetime.timedelta(days=1)
            fmt = "%Y-%m-%d" if with_dashes else "%Y%m%d"
        name = closed.strftime(fmt)
        created = []
        if name not in self.tm.list_tags():
            self.tm.create(name, snap.id)
            created.append(name)
            self._callbacks(name, snap)
        self._prune(fmt)
        return created

    def _callbacks(self, name: str, snap: Snapshot) -> None:
        from .write import load_callbacks, run_maintenance

        for fn in load_callbacks(self.table, CoreOptions.TAG_CALLBACKS):
            run_maintenance(f"tag callback {fn.__name__}", fn, self.table, name, snap)

    def _prune(self, fmt: str) -> None:
        opts = self.table.options.options
        auto = []
        for name in self.tm.list_tags():
            try:
                datetime.datetime.strptime(name, fmt)
            except ValueError:
                continue
            auto.append(name)
        auto.sort()
        keep_n = opts.get(CoreOptions.TAG_NUM_RETAINED_MAX)
        if keep_n is not None and len(auto) > keep_n:
            for name in auto[: len(auto) - keep_n]:
                self.tm.delete(name)
            auto = auto[len(auto) - keep_n :]
        ttl = opts.get(CoreOptions.TAG_DEFAULT_TIME_RETAINED)
        if ttl is not None:
            cutoff = now_millis() - ttl
            for name in list(auto):
                if self.tm.get(name).time_millis < cutoff:
                    self.tm.delete(name)
