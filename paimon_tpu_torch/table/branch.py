"""Branches: snapshot lineages of their own that share the main tree's
data files (port of paimon_tpu/table/branch.py).

A branch lives under <table>/branch/branch-<name>/ with its own snapshot/,
schema/, manifest/ and index/ directories and a CREATED_FROM file; its
data files stay in the main tree, where branch_table's view resolves them
through an instance-level store.bucket_dir override. create copies the
schemas up to the source snapshot's and that snapshot's manifests and
index files; fast_forward copies the branch's snapshots that main lacks,
their metadata and the branch's schemas back into main and moves main's
LATEST hint.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from ..core.indexmanifest import read_index_manifest
from ..core.manifest import ManifestList
from ..core.schema import SchemaManager
from ..core.snapshot import Snapshot, SnapshotManager
from ..fs import LocalFileIO
from ..utils.cache import invalidate_table_path
from .tags import TagManager

if TYPE_CHECKING:
    from . import FileStoreTable

__all__ = ["BranchManager", "branch_table"]


class BranchManager:
    def __init__(self, file_io: LocalFileIO, table_path: str):
        self.file_io = file_io
        self.table_path = table_path
        self.branch_root = f"{table_path}/branch"

    def branch_path(self, name: str) -> str:
        return f"{self.branch_root}/branch-{name}"

    def create(self, name: str, from_snapshot: int | None = None, from_tag: str | None = None) -> None:
        """A branch from the tag's snapshot, else from `from_snapshot`, else
        from the latest snapshot (an empty branch when there is none)."""
        if self.file_io.exists(self.branch_path(name)):
            raise ValueError(f"branch {name!r} already exists")
        sm = SnapshotManager(self.file_io, self.table_path)
        if from_tag is not None:
            snap = TagManager(self.file_io, self.table_path).get(from_tag)
        else:
            sid = from_snapshot if from_snapshot is not None else sm.latest_snapshot_id()
            snap = None if sid is None else sm.snapshot(sid)
        bp = self.branch_path(name)
        for sid, ts in SchemaManager(self.file_io, self.table_path).all_schemas().items():
            if snap is None or sid <= snap.schema_id:
                self.file_io.write_bytes(f"{bp}/schema/schema-{sid}", ts.to_json().encode())
        if snap is not None:
            self._copy_metadata(snap, bp)
            self.file_io.write_bytes(f"{bp}/snapshot/snapshot-{snap.id}", snap.to_json().encode())
            bsm = SnapshotManager(self.file_io, bp)
            bsm.commit_latest_hint(snap.id)
            bsm.commit_earliest_hint(snap.id)
        self.file_io.write_bytes(f"{bp}/CREATED_FROM", str(snap.id if snap else -1).encode())

    def _copy_metadata(self, snap: Snapshot, dst: str, src: str | None = None) -> None:
        """Copy the snapshot's manifest lists, manifests, index manifest and
        index files from the metadata root `src` (main's by default) to
        `dst`, skipping those already there."""
        src = src or self.table_path
        ml = ManifestList(self.file_io, f"{src}/manifest")
        names: set[str] = set()
        for lst in (snap.base_manifest_list, snap.delta_manifest_list, snap.changelog_manifest_list):
            if lst:
                names.add(lst)
                names.update(meta.file_name for meta in ml.read(lst))
        if snap.index_manifest:
            names.add(snap.index_manifest)
            for e in read_index_manifest(self.file_io, src, snap.index_manifest):
                self._copy_file(f"{src}/index/{e.file_name}", f"{dst}/index/{e.file_name}")
        for n in names:
            self._copy_file(f"{src}/manifest/{n}", f"{dst}/manifest/{n}")

    def _copy_file(self, src: str, dst: str) -> None:
        if not self.file_io.exists(dst):
            self.file_io.write_bytes(dst, self.file_io.read_bytes(src))

    def delete(self, name: str) -> None:
        self.file_io.delete(self.branch_path(name), recursive=True)
        # a branch created again under the name mints its snapshot ids again
        invalidate_table_path(self.branch_path(name))

    def created_from(self, name: str) -> int | None:
        """The snapshot the branch was created from; None for an empty
        branch or no such branch."""
        try:
            v = int(self.file_io.read_text(f"{self.branch_path(name)}/CREATED_FROM"))
        except (OSError, ValueError):
            return None
        return None if v < 0 else v

    def list_branches(self) -> list[str]:
        return sorted(
            st.path.rsplit("/", 1)[-1][len("branch-") :]
            for st in self.file_io.list_status(self.branch_root)
            if st.is_dir and st.path.rsplit("/", 1)[-1].startswith("branch-")
        )

    def fast_forward(self, name: str) -> None:
        """Make the branch's head main's head: the branch's snapshots that
        main lacks, with their metadata, and the branch's schemas are copied
        into main, and main's LATEST hint moves to the later of the two
        heads."""
        bp = self.branch_path(name)
        bsm = SnapshotManager(self.file_io, bp)
        main_sm = SnapshotManager(self.file_io, self.table_path)
        b_latest = bsm.latest_snapshot_id()
        if b_latest is None:
            return
        main_latest = main_sm.latest_snapshot_id() or 0
        for sid in range(bsm.earliest_snapshot_id() or b_latest, b_latest + 1):
            if bsm.snapshot_exists(sid) and not main_sm.snapshot_exists(sid):
                snap = bsm.snapshot(sid)
                self._copy_metadata(snap, self.table_path, src=bp)
                self.file_io.try_atomic_write(main_sm.snapshot_path(sid), snap.to_json().encode())
        mschemas = SchemaManager(self.file_io, self.table_path)
        for sid, ts in SchemaManager(self.file_io, bp).all_schemas().items():
            if not self.file_io.exists(mschemas.schema_path(sid)):
                self.file_io.write_bytes(mschemas.schema_path(sid), ts.to_json().encode())
        main_sm.commit_latest_hint(max(b_latest, main_latest))


def branch_table(table: "FileStoreTable", name: str) -> "FileStoreTable":
    """The table's view rooted at the branch directory, on the table's
    device; its store resolves data files in the main tree."""
    from . import FileStoreTable

    bp = BranchManager(table.file_io, table.path).branch_path(name)
    if not table.file_io.exists(bp):
        raise ValueError(f"branch {name!r} does not exist")
    schema = SchemaManager(table.file_io, bp).latest() or table.schema
    bt = FileStoreTable(table.file_io, bp, schema, table.store.commit_user, table.device)
    bt.store.bucket_dir = table.store.bucket_dir  # type: ignore[method-assign]
    return bt
