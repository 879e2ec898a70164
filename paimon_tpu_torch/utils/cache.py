"""Process-wide byte-budget LRU caches for immutable decoded objects (port
of paimon_tpu/utils/cache.py).

Two caches, as in the JAX package:

  * the manifest cache holds decoded metadata: manifest entry lists,
    manifest-list metas, parsed snapshots and the validated
    latest-snapshot pointer;
  * the data-file cache holds the KVBatches of predicate-free
    `KeyValueFileReaderFactory.read` calls, keyed by (file name, system
    columns mode, read-field signature, whether the read was projected,
    decoder) and weighed by `KVBatch.byte_size()`. The port has one
    decoder, so its decoder field is constant.

Budgets come from the table options cache.manifest.max-memory-size (256
mb) and cache.data-file.max-memory-size (128 mb); '0 b' opts a table out,
and an explicitly set option resizes the process-wide budget. Each cache
reports under the metrics group cache{cache=<name>}: counters hits,
misses, evictions, invalidations; gauges bytes, entries, max_bytes.

Cached values are shared: no reader changes a batch it got from the cache
(readers filter, take and cast into new arrays). Deletions call the
invalidate_* helpers below, so a deleted file or snapshot never resolves
from the cache again.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import TYPE_CHECKING, Any, Callable

if TYPE_CHECKING:
    from ..options import CoreOptions

__all__ = [
    "ByteBudgetLRU",
    "manifest_cache",
    "data_file_cache",
    "table_caches",
    "configure",
    "clear_all",
    "invalidate_data_file",
    "invalidate_manifest_path",
    "invalidate_snapshot",
    "invalidate_latest_pointer",
    "invalidate_table_path",
]

DEFAULT_MANIFEST_BUDGET = 256 << 20
DEFAULT_DATA_FILE_BUDGET = 128 << 20


class ByteBudgetLRU:
    """Thread-safe LRU weighed in bytes. A put evicts from the cold end
    until the total fits max_bytes; a value heavier than the whole budget is
    not cached. An entry's optional file_id lets invalidate_file drop every
    variant derived from one physical file."""

    def __init__(self, name: str, max_bytes: int):
        self.name = name
        self.max_bytes = int(max_bytes)
        self._lock = threading.RLock()
        self._entries: "OrderedDict[Any, tuple[Any, int, str | None]]" = OrderedDict()
        self._by_file: dict[str, set] = {}
        self._bytes = 0
        self._metrics()

    def _metrics(self):
        """The cache's metric group, resolved per call (registry.reset()
        replaces it)."""
        from ..metrics import registry

        g = registry.group("cache", cache=self.name)
        if "bytes" not in g.metrics:
            g.gauge("bytes", lambda: self._bytes)
            g.gauge("entries", lambda: len(self._entries))
            g.gauge("max_bytes", lambda: self.max_bytes)
        return g

    @property
    def enabled(self) -> bool:
        return self.max_bytes > 0

    @property
    def total_bytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._entries

    def contains_file(self, file_id: str) -> bool:
        with self._lock:
            return file_id in self._by_file

    def get(self, key):
        """The cached value, or None on a miss (values are never None)."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self._metrics().counter("misses").inc()
                return None
            self._entries.move_to_end(key)
            self._metrics().counter("hits").inc()
            return entry[0]

    def _unindex(self, key, file_id: str | None) -> None:
        if file_id is None:
            return
        keys = self._by_file.get(file_id)
        if keys is not None:
            keys.discard(key)
            if not keys:
                del self._by_file[file_id]

    def _evict_to_budget(self) -> None:
        while self._bytes > self.max_bytes and self._entries:
            cold_key, (_, w, fid) = self._entries.popitem(last=False)
            self._bytes -= w
            self._unindex(cold_key, fid)
            self._metrics().counter("evictions").inc()

    def put(self, key, value, weight: int, file_id: str | None = None) -> None:
        if not self.enabled or value is None:
            return
        weight = max(int(weight), 64)  # the key and the bookkeeping
        if weight > self.max_bytes:
            return
        with self._lock:
            if key in self._entries:
                self._drop(key)
            self._entries[key] = (value, weight, file_id)
            self._bytes += weight
            if file_id is not None:
                self._by_file.setdefault(file_id, set()).add(key)
            self._evict_to_budget()

    def get_or_load(self, key, loader: Callable[[], Any], weigher: Callable[[Any], int], file_id: str | None = None):
        """The cached value or loader()'s, which runs outside the lock: two
        concurrent misses may both load, and the file is immutable, so both
        results are equal."""
        if not self.enabled:
            return loader()
        value = self.get(key)
        if value is not None:
            return value
        value = loader()
        self.put(key, value, weigher(value), file_id)
        return value

    def _drop(self, key) -> None:
        _, weight, file_id = self._entries.pop(key)
        self._bytes -= weight
        self._unindex(key, file_id)

    def invalidate(self, key) -> bool:
        with self._lock:
            if key not in self._entries:
                return False
            self._drop(key)
            self._metrics().counter("invalidations").inc()
            return True

    def invalidate_file(self, file_id: str) -> int:
        """Drop every entry derived from one physical file."""
        with self._lock:
            keys = self._by_file.pop(file_id, None)
            if not keys:
                return 0
            n = 0
            for key in list(keys):
                if key in self._entries:
                    _, weight, _ = self._entries.pop(key)
                    self._bytes -= weight
                    self._metrics().counter("invalidations").inc()
                    n += 1
            return n

    def invalidate_prefix(self, path_prefix: str) -> int:
        """Drop every entry whose file_id lies under path_prefix (a dropped
        table or branch: its file names can be minted again)."""
        with self._lock:
            victims = [fid for fid in self._by_file if fid.startswith(path_prefix)]
        return sum(self.invalidate_file(fid) for fid in victims)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._by_file.clear()
            self._bytes = 0

    def set_budget(self, max_bytes: int) -> None:
        with self._lock:
            self.max_bytes = int(max_bytes)
            self._evict_to_budget()


_caches: dict[str, ByteBudgetLRU] = {}
_caches_lock = threading.Lock()


def _reset_after_fork() -> None:
    """A forked child may inherit a lock another thread held at the fork,
    and a put torn half-way: new locks in place, and the child starts
    cold."""
    global _caches_lock
    _caches_lock = threading.Lock()
    for c in _caches.values():
        c._lock = threading.RLock()
        c._entries.clear()
        c._by_file.clear()
        c._bytes = 0


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reset_after_fork)


def _get(name: str, default_budget: int) -> ByteBudgetLRU:
    cache = _caches.get(name)
    if cache is None:
        with _caches_lock:
            cache = _caches.get(name)
            if cache is None:
                cache = _caches[name] = ByteBudgetLRU(name, default_budget)
    return cache


def manifest_cache() -> ByteBudgetLRU:
    """Decoded manifest entry lists, manifest-list metas, snapshots and the
    latest-snapshot pointer."""
    return _get("manifest", DEFAULT_MANIFEST_BUDGET)


def data_file_cache() -> ByteBudgetLRU:
    """Decoded KVBatches of predicate-free data-file reads."""
    return _get("data-file", DEFAULT_DATA_FILE_BUDGET)


def configure(manifest_bytes: int | None = None, data_file_bytes: int | None = None) -> None:
    if manifest_bytes is not None:
        manifest_cache().set_budget(manifest_bytes)
    if data_file_bytes is not None:
        data_file_cache().set_budget(data_file_bytes)


def table_caches(options: "CoreOptions") -> tuple[ByteBudgetLRU | None, ByteBudgetLRU | None]:
    """(manifest cache, data-file cache) for one table's options, each None
    where the table opted out with a 0 budget. An explicitly set option
    resizes the process-wide budget (the last table to set it wins)."""
    from ..options import CoreOptions

    m_opt, d_opt = CoreOptions.CACHE_MANIFEST_MAX_MEMORY, CoreOptions.CACHE_DATA_FILE_MAX_MEMORY
    m_budget = int(options.options.get(m_opt))
    d_budget = int(options.options.get(d_opt))
    m = manifest_cache() if m_budget > 0 else None
    d = data_file_cache() if d_budget > 0 else None
    if m is not None and options.options.contains(m_opt) and m.max_bytes != m_budget:
        m.set_budget(m_budget)
    if d is not None and options.options.contains(d_opt) and d.max_bytes != d_budget:
        d.set_budget(d_budget)
    return m, d


def clear_all() -> None:
    for cache in list(_caches.values()):
        cache.clear()


def invalidate_data_file(file_name: str) -> None:
    """A data file left the disk (expiry, rollback) or the live LSM view
    (compaction): every cached read of it goes."""
    data_file_cache().invalidate_file(file_name)


def invalidate_manifest_path(path: str) -> None:
    """`path`: the full path of a manifest, manifest list or snapshot."""
    manifest_cache().invalidate_file(path)


def invalidate_snapshot(table_path: str, snapshot_id: int) -> None:
    manifest_cache().invalidate_file(f"{table_path}/snapshot/snapshot-{snapshot_id}")


def invalidate_latest_pointer(table_path: str) -> None:
    manifest_cache().invalidate(("latest", table_path))


def invalidate_table_path(table_path: str) -> None:
    """A table or branch directory was deleted: its snapshot ids can be
    minted again with other content, so every metadata entry under it goes,
    with its latest pointer. Data-file entries are keyed by uuid names that
    are never minted again, and are left to the LRU."""
    manifest_cache().invalidate_prefix(table_path.rstrip("/") + "/")
    manifest_cache().invalidate(("latest", table_path))
