"""LocalTableQuery: point lookups against a table's latest snapshot (port of
paimon_tpu/table/query.py, the class LocalTableQuery).

Two probe paths share the per-bucket state:

  * `lookup(partition, key)`: the scalar walk (lookup/LookupLevels), level
    0 newest first, then each level's run by key range; the oracle the
    batched path is held to;
  * `get_batch(keys)`: the serving path (table/get.py), with
    `attach_write` adding the read-your-writes tier.

`refresh()` re-plans the latest snapshot and rebuilds only the buckets
whose (files, deletion vectors) changed; the others keep their built
lookup files and probe indexes. With a `swap_lock`, the new state is
built and warmed outside the lock and swapped in under it, so gets keep
serving the previous snapshot meanwhile. Deletion vectors are applied
when a bucket's files are indexed.

`follow()` refreshes on a subscription instead of per request: a
paimon-qryref-* thread polls a SubscriptionHub subscription
(service/subscription.py) and, on each new batch or a moved latest
snapshot id (a compaction carries no changelog), refreshes with a swap
lock. `unfollow()` (and `close()`) stops it and deletes its consumer.

Not ported: the SQL cluster's execute_scan_fragment and
partition_agg_partial.
"""

from __future__ import annotations

import contextlib
import threading
from typing import TYPE_CHECKING, Sequence

import torch

from ..core.deletionvectors import DeletionVectorsIndexFile
from ..core.schema import SchemaManager
from ..data.batch import ColumnBatch
from ..lookup import LookupFileCache, LookupLevels
from ..lookup.index import BucketGetIndex, GetResult
from ..options import CoreOptions
from ..utils import resolve_device
from .bucket import bucket_ids

if TYPE_CHECKING:
    from . import FileStoreTable
    from .write import TableWrite

__all__ = ["LocalTableQuery"]


class LocalTableQuery:
    def __init__(
        self,
        table: "FileStoreTable",
        cache_bytes: int | None = None,
        local_store_dir: str | None = None,
        device: "str | torch.device" = "cuda",
    ):
        if not table.is_primary_key_table:
            raise ValueError("point lookup requires a primary-key table")
        self.device = resolve_device(device)
        self.table = table
        self.store = table.store
        opts = self.store.options.options
        if cache_bytes is None:
            cache_bytes = int(opts.get(CoreOptions.LOOKUP_CACHE_MAX_MEMORY_SIZE))
        self.cache = LookupFileCache(cache_bytes)
        self._bloom_fpp = (
            opts.get(CoreOptions.LOOKUP_CACHE_BLOOM_FILTER_FPP)
            if opts.get(CoreOptions.LOOKUP_CACHE_BLOOM_FILTER_ENABLED)
            else None
        )
        self._hash_load_factor = opts.get(CoreOptions.LOOKUP_HASH_LOAD_FACTOR)
        self._max_disk_bytes = int(opts.get(CoreOptions.LOOKUP_CACHE_MAX_DISK_SIZE))
        self._file_retention_ms = opts.get(CoreOptions.LOOKUP_CACHE_FILE_RETENTION)
        self._bloom_prune = bool(opts.get(CoreOptions.LOOKUP_GET_BLOOM_PRUNE))
        self.local_store_dir = local_store_dir
        self._levels: dict[tuple, LookupLevels] = {}
        self._get_indexes: dict[tuple, BucketGetIndex] = {}
        self._bucket_sigs: dict[tuple, tuple] = {}
        self._delta_indexes: dict[tuple, tuple] = {}  # (partition, bucket) -> (file names, BucketGetIndex)
        self._write: "TableWrite | None" = None
        self._snapshot_id: int | None = None
        # the bucket count of the snapshot served (refresh reads it from the
        # snapshot's schema): after a rescale the files carry the new
        # layout while the table object still holds the old options
        self._probe_buckets: int = max(self.store.options.bucket, 0)
        self._schemas = SchemaManager(self.table.file_io, str(self.table.path))
        self._follow_thread: threading.Thread | None = None
        self._follow_stop: threading.Event | None = None
        self._follow_sub = None
        self.refresh()

    def attach_write(self, table_write: "TableWrite | None") -> "LocalTableQuery":
        """Read-your-writes: gets also consult `table_write`'s memtables and
        its flushed but uncommitted level-0 files."""
        self._write = table_write
        self._delta_indexes.clear()
        return self

    def refresh(self, swap_lock: "threading.Lock | None" = None) -> None:
        """Re-plan against the latest snapshot. A bucket whose files and
        deletion vectors are unchanged keeps its state; a changed one takes
        over the warm probe indexes of the files that stay. With
        `swap_lock`, the new state is built and warmed without the lock and
        only the swap holds it; without it nothing is warmed, so a
        non-serving query reads only the files it probes."""
        plan = self.store.new_scan().plan()
        sid = plan.snapshot.id if plan.snapshot else None
        if sid == self._snapshot_id:
            return
        probe_buckets = self._probe_buckets
        if plan.snapshot is not None and self.store.options.bucket > 0:
            try:
                sch = self._schemas.schema(plan.snapshot.schema_id)
                probe_buckets = int(sch.options.get("bucket", probe_buckets))
            except (OSError, ValueError):
                pass  # keep the last known count
        dv_io = DeletionVectorsIndexFile(self.table.file_io, self.table.path)
        seen: set[tuple] = set()
        staged: dict[tuple, tuple] = {}  # (partition, bucket) -> (levels, get index, signature)
        stale_cache: list[str] = []
        for partition, buckets in plan.grouped().items():
            for bucket, files in buckets.items():
                pb = (partition, bucket)
                seen.add(pb)
                dv_index = plan.dv_index_for(partition, bucket)
                sig = (tuple(sorted((f.file_name, f.level) for f in files)), dv_index)
                if self._bucket_sigs.get(pb) == sig:
                    continue
                dvs = dv_io.read_all(dv_index) if dv_index else {}
                stale_cache += list(dvs)  # new vectors: the cached rows are stale
                levels = LookupLevels(
                    files,
                    self.store.reader_factory(partition, bucket),
                    self.store.key_names,
                    cache=self.cache,
                    deletion_vectors=dvs,
                    local_store_dir=self.local_store_dir,
                    file_io=self.table.file_io,
                    bloom_fpp=self._bloom_fpp,
                    hash_load_factor=self._hash_load_factor,
                    max_disk_bytes=self._max_disk_bytes,
                    file_retention_millis=self._file_retention_ms,
                )
                get_index = BucketGetIndex(
                    files,
                    self.store.reader_factory(partition, bucket),
                    self.store.key_names,
                    deletion_vectors=dvs,
                    bloom_prune=self._bloom_prune,
                    warm_from=self._get_indexes.get(pb),
                    device=self.device,
                )
                if swap_lock is not None:
                    get_index.prewarm()
                staged[pb] = (levels, get_index, sig)
        with swap_lock if swap_lock is not None else contextlib.nullcontext():
            for name in stale_cache:
                self.cache.invalidate(name)
            for pb, (levels, get_index, sig) in staged.items():
                self._levels[pb] = levels
                self._get_indexes[pb] = get_index
                self._bucket_sigs[pb] = sig
            for pb in list(self._levels):
                if pb not in seen:
                    del self._levels[pb]
                    self._get_indexes.pop(pb, None)
                    self._bucket_sigs.pop(pb, None)
            self._snapshot_id = sid
            self._probe_buckets = probe_buckets

    def follow(self, hub=None, lock: "threading.Lock | None" = None) -> "LocalTableQuery":
        """Refresh on every new snapshot that `hub` (the table's shared hub
        by default) signals, and on every moved latest snapshot id; each
        refresh builds outside `lock` and swaps under it. Pass the lock the
        gets run under. Stop with unfollow()."""
        if self._follow_thread is not None:
            return self
        from ..service.subscription import SubscriptionHub
        from ..utils import new_file_name

        hub = hub if hub is not None else SubscriptionHub.for_table(self.table)
        flock = lock if lock is not None else threading.Lock()
        stop = self._follow_stop = threading.Event()
        # an ephemeral consumer, deleted on unfollow: a refresher must not
        # pin snapshot expiry once it is gone
        sub = self._follow_sub = hub.subscribe(consumer_id=f"qryref-{new_file_name('c')}")

        def loop():
            while not stop.is_set():
                advanced = False
                try:
                    advanced = sub.poll(timeout=0.2) is not None
                except Exception:  # noqa: BLE001 - shed or hub closed: poll snapshot ids instead
                    stop.wait(0.2)
                try:
                    if advanced or self.store.snapshot_manager.latest_snapshot_id() != self._snapshot_id:
                        self.refresh(swap_lock=flock)
                except Exception:  # noqa: BLE001 - a failed plan or read: the next poll tries again
                    pass

        self._follow_thread = threading.Thread(target=loop, name=f"paimon-qryref-{id(self) & 0xFFFF:x}",
                                               daemon=False)
        self._follow_thread.start()
        return self

    def unfollow(self) -> None:
        """Stop follow()'s refresher and delete its consumer; a no-op when
        it was never started."""
        t, self._follow_thread = self._follow_thread, None
        if self._follow_stop is not None:
            self._follow_stop.set()
        if t is not None:
            t.join(timeout=30.0)
        sub, self._follow_sub = self._follow_sub, None
        if sub is not None:
            try:
                sub.close(delete_consumer=True)
            except OSError:
                pass

    def close(self) -> None:
        """Stop following, release the attached writer and the built state."""
        self.unfollow()
        self._write = None
        self._levels.clear()
        self._get_indexes.clear()
        self._delta_indexes.clear()
        self._bucket_sigs.clear()
        self._snapshot_id = None

    def get_batch(self, keys, partition: tuple = ()) -> GetResult:
        """Vectorised primary-key gets: `keys` is a sequence of key tuples
        (scalars for a one-column key), a {column: values} mapping or a
        ColumnBatch of the key columns. The GetResult is aligned with the
        keys; its to_pylist() equals a loop of scalar lookups."""
        from .get import batch_get

        return batch_get(self, keys, partition)

    def lookup(self, partition: tuple, key: "tuple | object"):
        """The key's newest value row (a one-row ColumnBatch), or None when
        it is absent or deleted. `key`: a tuple over the trimmed primary key,
        or a scalar for a one-column key."""
        if not isinstance(key, tuple):
            key = (key,)
        # a fixed-bucket table hashes the key to its bucket; a dynamic one
        # may hold it in any bucket of the partition
        candidates: Sequence[tuple] = [pb for pb in self._levels if pb[0] == partition]
        if self._probe_buckets > 0:
            key_schema = self.store.value_schema.project(self.store.key_names)
            probe = ColumnBatch.from_pydict(key_schema, {k: [v] for k, v in zip(self.store.key_names, key)})
            b = int(bucket_ids(probe, self.table.schema.bucket_keys, self._probe_buckets)[0])
            candidates = [(partition, b)] if (partition, b) in self._levels else []
        for pb in candidates:
            out = self._levels[pb].lookup(key)
            if out is not None:
                return out
        return None
