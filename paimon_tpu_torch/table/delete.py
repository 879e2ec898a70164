"""DELETE FROM table WHERE <predicate> (port of paimon_tpu/table/delete.py).

Three strategies, as in the JAX package:

1. deletion-vectors.enabled: every matching stored row is marked in its
   file's deletion vector. On a primary-key table the predicate is first
   resolved against the merged view (a with_filter read), then every
   stored version of each matching key is marked, so that no older
   version comes back on merge; on an append table the predicate is
   evaluated on each file's rows. Each changed bucket's whole container is
   written anew and committed as one index entry, in one APPEND snapshot
   with the batch-delete identifier; no data file is rewritten.
2. a primary-key table otherwise: the matching merged rows are written
   back as -D rows, with an input changelog under
   delete.force-produce-changelog when the table has no changelog
   producer.
3. an append table otherwise: copy-on-write. Each file with a match is
   rewritten without the matching rows at its level (source "compact"),
   and one COMPACT snapshot under the batch-delete identifier swaps them.
   The bucket's existing deletion vectors are applied first, whether or
   not the option is still set (the JAX package reads them only while it
   is, and rows it marked come back; ROADMAP Queue 3). UPDATE on an
   append table (table/rowops.py) is the same rewrite with a transform.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from ..core.deletionvectors import DeletionVectorsIndexFile, DeletionVectorsMaintainer
from ..core.kv import KVBatch
from ..core.manifest import CommitMessage, ManifestCommittable
from ..data.predicate import Predicate
from ..options import ChangelogProducer, CoreOptions
from ..types import RowKind

if TYPE_CHECKING:
    from . import FileStoreTable

__all__ = ["delete_where", "copy_on_write_rewrite"]

# a DELETE commits under this identifier (the JAX package's
# Long.MAX_VALUE - 1)
DELETE_COMMIT_IDENTIFIER = (1 << 63) - 2


def delete_where(table: "FileStoreTable", predicate: Predicate) -> int:
    """Delete the rows the predicate matches; returns how many."""
    if table.options.options.get(CoreOptions.DELETION_VECTORS_ENABLED):
        return _delete_with_dvs(table, predicate)
    if table.is_primary_key_table:
        return _delete_with_retract(table, predicate)
    return copy_on_write_rewrite(table, predicate)


def _key_match_mask(batch, key_names, matching) -> np.ndarray:
    """Whether each row's key tuple is one of `matching`'s."""
    if len(key_names) == 1:
        k = key_names[0]
        return np.isin(batch.column(k).values, matching.column(k).values)
    keys = set(zip(*(matching.column(k).values.tolist() for k in key_names)))
    rows = zip(*(batch.column(k).values.tolist() for k in key_names))
    return np.fromiter((r in keys for r in rows), dtype=np.bool_, count=batch.num_rows)


def _delete_with_dvs(table: "FileStoreTable", predicate: Predicate) -> int:
    store = table.store
    idx = DeletionVectorsIndexFile(
        table.file_io, table.path, int(store.options.options.get(CoreOptions.DELETION_VECTOR_INDEX_FILE_TARGET_SIZE))
    )
    plan = store.new_scan().plan()
    matching = None
    deleted = 0
    if table.is_primary_key_table:
        rb = table.new_read_builder().with_filter(predicate)
        matching = rb.new_read().read_all(rb.new_scan().plan())
        deleted = matching.num_rows
        if deleted == 0:
            return 0
    messages: list[CommitMessage] = []
    for partition, buckets in plan.grouped().items():
        for bucket, files in buckets.items():
            dv_index = plan.dv_index_for(partition, bucket)
            restored = idx.read_all(dv_index) if dv_index else {}
            maintainer = DeletionVectorsMaintainer(idx, restored)
            reader = store.reader_factory(partition, bucket)
            changed = False
            for f in files:
                kv = reader.read(f)  # every row, in file order: positions count these
                if matching is not None:
                    mask = _key_match_mask(kv.data, store.key_names, matching)
                else:
                    mask = predicate.eval(kv.data)
                existing = restored.get(f.file_name)
                if existing is not None:
                    mask = mask & ~existing.deleted_mask(kv.num_rows)
                positions = np.flatnonzero(mask)
                if len(positions):
                    maintainer.notify_deletion(f.file_name, positions.astype(np.uint32))
                    if matching is None:
                        deleted += len(positions)
                    changed = True
            if changed:
                entry = maintainer.prepare_commit(partition, bucket)
                if entry:
                    messages.append(
                        CommitMessage(partition, bucket, max(store.options.bucket, 1), new_index_files=[entry])
                    )
    if messages:
        store.new_commit().commit(ManifestCommittable(DELETE_COMMIT_IDENTIFIER, messages=messages))
    return deleted


def _delete_with_retract(table: "FileStoreTable", predicate: Predicate) -> int:
    """Write the matching merged rows back as -D rows."""
    rb = table.new_read_builder().with_filter(predicate)
    matching = rb.new_read().read_all(rb.new_scan().plan())
    if matching.num_rows == 0:
        return 0
    if (
        table.options.options.get(CoreOptions.DELETE_FORCE_PRODUCE_CHANGELOG)
        and table.options.changelog_producer == ChangelogProducer.NONE
    ):
        # consumers see the retractions even on a table without changelog
        table = table.copy({"changelog-producer": "input"})
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.write(matching, np.full(matching.num_rows, int(RowKind.DELETE), dtype=np.uint8))
    wb.new_commit().commit(w.prepare_commit())
    return matching.num_rows


def copy_on_write_rewrite(table: "FileStoreTable", predicate: Predicate, transform=None) -> int:
    """Rewrite every file holding a row the predicate matches, after its
    deletion vector's rows: without the matching rows, or with them
    replaced by transform(matching KVBatch) (UPDATE). Returns the rows
    matched."""
    store = table.store
    plan = store.new_scan().plan()
    idx = DeletionVectorsIndexFile(table.file_io, table.path)
    messages: list[CommitMessage] = []
    affected = 0
    for partition, buckets in plan.grouped().items():
        for bucket, files in buckets.items():
            rf = store.reader_factory(partition, bucket)
            wf = store.writer_factory(partition, bucket)
            dv_index = plan.dv_index_for(partition, bucket)
            dvs = idx.read_all(dv_index) if dv_index else {}
            before, after = [], []
            for f in files:
                kv = rf.read(f)
                dv = dvs.get(f.file_name)
                if dv is not None:
                    alive = ~dv.deleted_mask(kv.num_rows)
                    if not alive.all():
                        kv = kv.filter(alive)
                mask = predicate.eval(kv.data)
                hits = int(mask.sum())
                if hits == 0:
                    continue
                affected += hits
                before.append(f)
                kept = kv.filter(~mask)
                if transform is not None:
                    changed = transform(kv.filter(mask))
                    kept = changed if kept.num_rows == 0 else KVBatch.concat([kept, changed])
                if kept.num_rows:
                    after.extend(wf.write(kept, level=f.level, file_source="compact"))
            if before:
                messages.append(
                    CommitMessage(partition, bucket, max(store.options.bucket, 1), compact_before=before, compact_after=after)
                )
    if messages:
        store.new_commit().commit(ManifestCommittable(DELETE_COMMIT_IDENTIFIER, messages=messages))
    return affected
