"""Snapshot-consistent table clone (port of paimon_tpu/table/clone.py):
pick_files, clone_table, clone_database and clone_warehouse.

pick_files gives the closure of one snapshot, in the JAX package's order:
the manifest lists, the index manifest with its index files (a deletion
vector container with its whole chain), the statistics file, the base and
delta manifests, the changelog manifests, then the live data files (newest
first, each with its sidecars) and the changelog files, then every schema.
clone_table copies them on a thread pool through the source table's FileIO
and the target catalog's (both from the FileIO registry, fs
`get_file_io`), writes the snapshot file and its hints last, and refuses to
clone over a table that holds another snapshot. When a file vanishes under
a clone of the latest snapshot (expiry), it picks again from the new latest
snapshot, up to max_retries times; a pinned snapshot (a tag's) fails at
once.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import TYPE_CHECKING

from ..options import CoreOptions
from ..utils import partition_path

if TYPE_CHECKING:
    from ..catalog import FileSystemCatalog as Catalog
    from . import FileStoreTable

__all__ = ["pick_files", "clone_table", "clone_database", "clone_warehouse"]


def _stats_dir_files(table: "FileStoreTable", snap) -> list[str]:
    return [f"statistics/{snap.statistics}"] if snap.statistics else []


def pick_files(table: "FileStoreTable", snapshot_id: int | None = None):
    """(snapshot, [(source path, path relative to the target table), ...]):
    every file the snapshot references. Data paths come from
    store.bucket_dir, so a branch view (data in the main tree, metadata in
    the branch) clones into a standalone table. The snapshot file itself is
    not listed: clone_table writes its JSON, so a tag whose snapshot file
    expired clones from the tag's copy."""
    from ..core.manifest import FileKind, ManifestFile, ManifestList, merge_entries
    from ..core.schema import SchemaManager

    sm = table.store.snapshot_manager
    sid = snapshot_id if snapshot_id is not None else sm.latest_snapshot_id()
    if sid is None:
        raise ValueError(f"table {table.path} has no snapshot to clone")
    try:
        snap = sm.snapshot(sid)
    except FileNotFoundError:
        from .tags import TagManager

        tm = TagManager(table.file_io, table.path)
        pinned = [t for t, s in tm.list_tags().items() if s == sid]
        if not pinned:
            raise
        snap = tm.get(pinned[0])

    rel: list[str] = []
    for ml in (snap.base_manifest_list, snap.delta_manifest_list, snap.changelog_manifest_list):
        if ml:
            rel.append(f"manifest/{ml}")
    if snap.index_manifest:
        rel.append(f"manifest/{snap.index_manifest}")
        from ..core.deletionvectors import DeletionVectorsIndexFile
        from ..core.indexmanifest import read_index_manifest

        dv_io = DeletionVectorsIndexFile(table.file_io, table.path)
        for e in read_index_manifest(table.file_io, table.path, snap.index_manifest):
            if e.kind == "DELETION_VECTORS":
                rel += [f"index/{n}" for n in dv_io.chain_names(e.file_name)]
            else:
                rel.append(f"index/{e.file_name}")
    rel += _stats_dir_files(table, snap)

    manifest_dir = f"{table.path}/manifest"
    ml_reader = ManifestList(table.file_io, manifest_dir)
    mf = ManifestFile(table.file_io, manifest_dir)
    metas = ml_reader.read(snap.base_manifest_list) + ml_reader.read(snap.delta_manifest_list)
    rel += [f"manifest/{m.file_name}" for m in metas]

    # live data files via the merged manifest view
    entries = []
    per_manifest = [mf.read(m.file_name) for m in metas]
    for e in merge_entries(*per_manifest):
        if e.kind == FileKind.ADD:
            entries.append(e)
    # changelog manifests + the changelog files they reference (a changelog
    # scan on the clone must work; see core/scan.py kind=="changelog")
    if snap.changelog_manifest_list:
        cl_metas = ml_reader.read(snap.changelog_manifest_list)
        rel += [f"manifest/{m.file_name}" for m in cl_metas]
        for m in cl_metas:
            entries += [e for e in mf.read(m.file_name) if e.kind == FileKind.ADD]
    pairs = [(f"{table.path}/{r}", r) for r in rel]
    # newest first: latest-partition files are the ones expiry deletes first
    entries.sort(key=lambda e: e.file.creation_time_millis, reverse=True)
    for e in entries:
        pp = partition_path(table.partition_keys, e.partition,
                            default_name=table.options.options.get(CoreOptions.PARTITION_DEFAULT_NAME))
        rel_base = f"{pp}/bucket-{e.bucket}" if pp else f"bucket-{e.bucket}"
        src_base = table.store.bucket_dir(e.partition, e.bucket)
        for name in (e.file.file_name, *e.file.extra_files):
            pairs.append((f"{src_base}/{name}", f"{rel_base}/{name}"))

    for schema_id in SchemaManager(table.file_io, table.path)._listed_ids():
        r = f"schema/schema-{schema_id}"
        pairs.append((f"{table.path}/{r}", r))
    return snap, list(dict.fromkeys(pairs))  # dedupe, keep order


def _copy_one(src_io, dst_io, dst_root: str, pair: tuple[str, str]) -> bool:
    """Copy one file; False when the source vanished (snapshot expired)."""
    src, rel = pair
    try:
        data = src_io.read_bytes(src)
    except (FileNotFoundError, OSError):
        return False  # vanished (snapshot expired under the copy)
    # idempotent: a retry attempt re-copies over its own partial first pass
    dst_io.try_overwrite(f"{dst_root}/{rel}", data)
    return True


def clone_table(
    source: "FileStoreTable",
    target_catalog: "Catalog",
    target_identifier: str,
    snapshot_id: int | None = None,
    parallelism: int = 8,
    max_retries: int = 3,
) -> "FileStoreTable":
    """Clone `source`'s snapshot into `target_catalog` as `target_identifier`.

    snapshot_id=None clones the latest (reference CloneAction semantics); a
    pinned snapshot_id (e.g. a tag's) clones that exact snapshot — combine
    with `branch_table()`/`TagManager.snapshot_id()` to clone a branch or tag.
    Retries with a fresh latest snapshot when files vanish under the copy
    (only in latest mode; a pinned snapshot that expired is an error)."""
    from ..catalog import Identifier

    ident = Identifier.parse(target_identifier) if isinstance(target_identifier, str) else target_identifier
    target_catalog.create_database(ident.database, ignore_if_exists=True)
    dst_root = target_catalog.table_path(ident)
    dst_io = getattr(target_catalog, "file_io", source.file_io)

    pinned = snapshot_id is not None
    last_missing: str | None = None
    for _attempt in range(max_retries):
        snap, pairs = pick_files(source, snapshot_id)
        ok = True
        with cf.ThreadPoolExecutor(max_workers=max(1, parallelism)) as pool:
            for pair, copied in zip(
                pairs,
                pool.map(lambda p: _copy_one(source.file_io, dst_io, dst_root, p), pairs),
            ):
                if not copied:
                    ok, last_missing = False, pair[0]
                    break
        if ok:
            # snapshot file + hints last (reference SnapshotHintOperator): a
            # reader of the target only sees the table once the copy is done
            from ..core.snapshot import SnapshotManager

            tsm = SnapshotManager(dst_io, dst_root)
            existing = tsm.latest_snapshot_id()
            if existing is not None and existing != snap.id:
                # only a re-clone of the same snapshot is idempotent-safe;
                # anything else would intermix two tables' files/hints
                raise RuntimeError(
                    f"target {dst_root} already has snapshot {existing} != cloned "
                    f"{snap.id}; refusing to clone over an existing table"
                )
            dst_io.try_overwrite(tsm.snapshot_path(snap.id), snap.to_json().encode())
            tsm.commit_earliest_hint(snap.id)
            tsm.commit_latest_hint(snap.id)
            return target_catalog.get_table(ident)
        if pinned:
            break
    raise RuntimeError(
        f"clone of {source.path} failed after {max_retries} attempts: "
        f"{last_missing!r} vanished during copy (snapshot expired mid-clone?)"
    )


def clone_database(
    source_catalog: "Catalog",
    database: str,
    target_catalog: "Catalog",
    target_database: str | None = None,
    parallelism: int = 8,
) -> list[str]:
    """Clone every table of a database (reference CloneSourceBuilder.java:
    empty table name => whole database). Returns cloned identifiers."""
    target_database = target_database or database
    out = []
    for name in source_catalog.list_tables(database):
        t = source_catalog.get_table(f"{database}.{name}")
        if t.store.snapshot_manager.latest_snapshot_id() is None:
            continue  # empty table: nothing to clone (reference skips too)
        clone_table(t, target_catalog, f"{target_database}.{name}", parallelism=parallelism)
        out.append(f"{target_database}.{name}")
    return out


def clone_warehouse(
    source_catalog: "Catalog", target_catalog: "Catalog", parallelism: int = 8
) -> list[str]:
    """Clone every database (reference: empty database => whole warehouse)."""
    out = []
    for db in source_catalog.list_databases():
        out += clone_database(source_catalog, db, target_catalog, parallelism=parallelism)
    return out
