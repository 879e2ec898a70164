"""Rescale a fixed-bucket table to another bucket count (port of
paimon_tpu/table/rescale.py; the mesh's clustering permutation and the
crash points are not ported).

1. Pin a snapshot S (the latest, or the one asked for).
2. Merge-read each old bucket (deleted rows and the rows its deletion
   vectors mark dropped), route every row to hash(bucket key) % new and
   cluster the rows by their new bucket with a host stable argsort: the
   JAX package's route off the mesh, which by its contract gives the mesh's
   permutation.
3. Write the clustered rows through a TableWrite over a bucket=new,
   write-only copy of the table; their entries carry total_buckets=new.
4. Commit schema-(N+1) with bucket=new, then, through the table reloaded
   at that schema, one OVERWRITE snapshot that deletes every live entry
   and adds the rewritten files.

A reader pinned at S or earlier still reads the old files, which stay on
disk until snapshot expiry. The OVERWRITE passes no removed files, so the
old deletion vectors stay in the index manifest, naming files no later
snapshot lists, as in the JAX package. No rival writer may commit between
the steps: rescaling is an offline operation.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Iterable, Sequence

import numpy as np

from ..core.commit import BATCH_COMMIT_IDENTIFIER
from ..core.deletionvectors import DeletionVectorsIndexFile
from ..core.manifest import CommitMessage, ManifestCommittable
from ..core.schema import SchemaChange, SchemaManager
from ..utils import partition_sort_key
from .bucket import bucket_ids
from .write import TableWrite

if TYPE_CHECKING:
    from . import FileStoreTable

__all__ = ["rescale_messages", "commit_rescale", "rescale_table", "cluster_by_new_bucket"]


def cluster_by_new_bucket(table: "FileStoreTable", batch, new_buckets: int):
    """(the batch's rows stably clustered by their new bucket, the new
    bucket of each clustered row)."""
    ids = bucket_ids(batch, table.schema.bucket_keys, new_buckets)
    perm = np.argsort(ids, kind="stable")
    return batch.take(perm), ids[perm]


def rescale_messages(
    table: "FileStoreTable",
    new_buckets: int,
    buckets: "Iterable[int] | None" = None,
    snapshot_id: "int | None" = None,
) -> tuple["int | None", list[CommitMessage], int]:
    """Rewrite the merged rows of `buckets` (all by default) of the pinned
    snapshot at `new_buckets`: (pinned snapshot id, CommitMessages with
    total_buckets=new, rows rewritten). Nothing is committed."""
    if new_buckets < 1:
        raise ValueError(f"new bucket count must be >= 1, got {new_buckets}")
    store = table.store
    if store.options.bucket < 1:
        raise ValueError("cross-bucket rescale applies to fixed-bucket tables (dynamic tables assign per key)")
    scan = store.new_scan()
    if snapshot_id is not None:
        scan = scan.with_snapshot(snapshot_id)
    plan = scan.plan()
    sid = plan.snapshot.id if plan.snapshot else None
    want = None if buckets is None else {int(b) for b in buckets}
    dv_file = DeletionVectorsIndexFile(table.file_io, table.path)
    tw = TableWrite(table.copy({"bucket": str(new_buckets), "write-only": "true"}))
    rows = 0
    for partition, pbuckets in sorted(plan.grouped().items(), key=lambda kv: partition_sort_key(kv[0])):
        for bucket, files in sorted(pbuckets.items()):
            if want is not None and bucket not in want:
                continue
            dv_index = plan.dv_index_for(partition, bucket)
            dvs = dv_file.read_all(dv_index) if dv_index else None
            batch = store.read_bucket(partition, bucket, files, drop_delete=True, deletion_vectors=dvs)
            if batch.num_rows == 0:
                continue
            clustered, _ = cluster_by_new_bucket(table, batch, new_buckets)
            tw.write(clustered)
            rows += clustered.num_rows
    return sid, tw.prepare_commit(), rows


def commit_rescale(
    table: "FileStoreTable",
    new_buckets: int,
    messages: Sequence[CommitMessage],
    commit_identifier: "int | None" = None,
) -> "int | None":
    """The schema change to bucket=new, then one OVERWRITE snapshot of the
    rewritten files, committed through the table reloaded at the new
    schema so that the snapshot records it; returns the OVERWRITE
    snapshot's id."""
    from . import load_table

    SchemaManager(table.file_io, str(table.path)).commit_changes(SchemaChange.set_option("bucket", str(new_buckets)))
    fresh = load_table(str(table.path), commit_user=table.store.commit_user, device=table.device)
    ident = commit_identifier if commit_identifier is not None else BATCH_COMMIT_IDENTIFIER
    sids = fresh.store.new_commit().overwrite(ManifestCommittable(ident, messages=list(messages)))
    return sids[-1] if sids else None


def rescale_table(table: "FileStoreTable", new_buckets: int) -> "FileStoreTable":
    """Rewrite every bucket at `new_buckets`, commit, and return the table
    reloaded at the new bucket count."""
    from . import load_table

    _, msgs, _ = rescale_messages(table, new_buckets)
    commit_rescale(table, new_buckets, msgs)
    return load_table(str(table.path), commit_user=table.store.commit_user, device=table.device)
