"""Orphan-file crash recovery: the reachability walk and the sweep (port
of paimon_tpu/resilience/orphan.py).

A crashed writer or commit leaks files at known places: data files whose
commit never landed, manifests written before a lost or aborted snapshot
CAS, torn `.tmp` siblings of atomic writes whose rename never ran, and the
index files an OVERWRITE leaves behind. No snapshot reaches them, so
readers never see them, but they cost storage for good.

`remove_orphan_files` builds the reachable closure from every live root
(the listed snapshots, the decoupled changelogs and the tags of the main
table and of every branch: branch manifests resolve their data files into
the main tree's bucket directories, so the walk spans the branches before
any bucket directory is swept), then deletes the unreferenced files and
the torn temp files older than the threshold (`orphan.clean.older-than`,
1 day, by default: an in-flight commit's fresh files must survive). Every
removed file leaves the manifest and data-file caches (utils/cache.py).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from ..utils import now_millis

if TYPE_CHECKING:
    from ..table import FileStoreTable

__all__ = ["remove_orphan_files", "reachable_files"]

# directories under the table root that are metadata planes, never data
_RESERVED_DIRS = frozenset(
    {"snapshot", "manifest", "schema", "index", "changelog", "branch", "tag", "consumer", "statistics"}
)


def _is_tmp_name(base: str) -> bool:
    """Torn-write residue: FileIO._temp_sibling (.name.hex.tmp) and the
    copy-fallback staging name of the JAX package's LocalFileIO
    (name.tmp-hex)."""
    return (base.startswith(".") and base.endswith(".tmp")) or ".tmp-" in base


def _root_snapshots(io, root: str):
    """Every snapshot-like object rooted at `root`: listed snapshots,
    decoupled changelogs, tags."""
    from ..core.snapshot import SnapshotManager
    from ..table.tags import TagManager

    sm = SnapshotManager(io, root)
    for snap in sm.snapshots():
        yield snap
    for cid in sm.changelog_ids():
        yield sm.changelog(cid)
    tags = TagManager(io, root)
    for name in tags.list_tags():
        yield tags.get(name)


def reachable_files(table: "FileStoreTable") -> dict:
    """The reachable closure of all live roots.

    Returns {"meta": {root: set(manifest-dir names)},
             "index": {root: set(index-dir names)},
             "data": set((bucket_dir, file_name))} — data is global because
    branch manifests reference the main table's bucket dirs."""
    from ..core.deletionvectors import DeletionVectorsIndexFile
    from ..core.indexmanifest import read_index_manifest
    from ..core.manifest import ManifestFile, ManifestList
    from ..table.branch import BranchManager

    io = table.file_io
    bm = BranchManager(io, table.path)
    roots = [table.path] + [bm.branch_path(b) for b in bm.list_branches()]

    meta: dict[str, set[str]] = {}
    index: dict[str, set[str]] = {}
    data: set[tuple[str, str]] = set()
    for root in roots:
        live_meta: set[str] = set()
        live_index: set[str] = set()
        manifest_file = ManifestFile(io, f"{root}/manifest")
        manifest_list = ManifestList(io, f"{root}/manifest")
        dv_io = DeletionVectorsIndexFile(io, root)
        for snap in _root_snapshots(io, root):
            for lst in (snap.base_manifest_list, snap.delta_manifest_list, snap.changelog_manifest_list):
                if not lst:
                    continue
                live_meta.add(lst)
                for m in manifest_list.read(lst):
                    live_meta.add(m.file_name)
                    for e in manifest_file.read(m.file_name):
                        # branch bucket dirs resolve into the MAIN tree
                        bucket_dir = table.store.bucket_dir(e.partition, e.bucket)
                        data.add((bucket_dir, e.file.file_name))
                        for x in e.file.extra_files:
                            data.add((bucket_dir, x))
            if snap.index_manifest:
                live_meta.add(snap.index_manifest)
                for ie in read_index_manifest(io, root, snap.index_manifest):
                    if ie.kind == "DELETION_VECTORS":
                        live_index.update(dv_io.chain_names(ie.file_name))
                    else:
                        live_index.add(ie.file_name)
        meta[root] = live_meta
        index[root] = live_index
    return {"meta": meta, "index": index, "data": data}


def remove_orphan_files(
    table: "FileStoreTable", older_than_millis: int | None = None, dry_run: bool = False
) -> list[str]:
    """Delete every file under the table tree that the reachable closure does
    not name and that is older than the threshold; afterwards the on-disk
    file set is exactly the closure plus table metadata (schemas, snapshot
    roots, hints, markers). Returns the removed (or would-remove) paths."""
    from ..metrics import io_metrics
    from ..options import CoreOptions
    from ..utils.cache import invalidate_data_file, invalidate_manifest_path

    io = table.file_io
    if older_than_millis is None:
        older_than_millis = table.options.options.get(CoreOptions.ORPHAN_CLEAN_OLDER_THAN)
    cutoff = now_millis() - older_than_millis
    live = reachable_files(table)
    removed: list[str] = []
    g = io_metrics()

    def rm(path: str, invalidate=None) -> None:
        removed.append(path)
        if dry_run:
            return
        try:
            io.delete(path)
        except Exception:
            # cleaner failures are never fatal: the file stays an orphan for
            # the next run (and the cache entry stays valid with it)
            g.counter("cleanup_failures").inc()
            removed.pop()
            return
        g.counter("orphans_removed").inc()
        if invalidate is not None:
            invalidate()

    # NOTE paths handed to io.delete are rebuilt as f"{directory}/{base}":
    # wrapper FileIOs (fail://, s3-like) list INNER paths in FileStatus, and
    # deleting those verbatim would silently miss the wrapped namespace
    def sweep(directory: str, keep: set[str], invalidator=None) -> None:
        """invalidator(path, base) -> zero-arg cache invalidation to run
        after a successful delete."""
        for st in io.list_files(directory):
            base = st.path.rsplit("/", 1)[-1]
            if base in keep or st.mtime_millis >= cutoff:
                continue
            path = f"{directory}/{base}"
            rm(path, None if invalidator is None else invalidator(path, base))

    def sweep_tmp_only(directory: str) -> None:
        """Snapshot/changelog dirs hold the commit roots themselves — only
        torn-write residue is ever garbage there."""
        for st in io.list_files(directory):
            base = st.path.rsplit("/", 1)[-1]
            if _is_tmp_name(base) and st.mtime_millis < cutoff:
                rm(f"{directory}/{base}")

    for root, keep in live["meta"].items():
        sweep(f"{root}/manifest", keep, lambda p, b: (lambda: invalidate_manifest_path(p)))
        sweep(f"{root}/index", live["index"][root])
        sweep_tmp_only(f"{root}/snapshot")
        sweep_tmp_only(f"{root}/changelog")

    # data planes: every bucket-* dir in the partition tree (including
    # partitions whose files are ALL orphaned — a crashed first commit into a
    # new partition leaves a bucket dir no live entry names)
    def walk_data(directory: str, at_root: bool) -> None:
        for st in io.list_status(directory):
            base = st.path.rsplit("/", 1)[-1]
            if not st.is_dir:
                continue
            if at_root and base in _RESERVED_DIRS:
                continue
            child = f"{directory}/{base}"
            if base.startswith("bucket-"):
                keep = {f for d, f in live["data"] if d == child}
                sweep(child, keep, lambda p, b: (lambda: invalidate_data_file(b)))
            else:
                walk_data(child, at_root=False)

    walk_data(table.path, at_root=True)
    return removed
