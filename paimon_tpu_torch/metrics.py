"""Metric primitives and the compaction, join, get, sql, decode, dict and
encode groups (port of paimon_tpu/metrics.py: Counter, Gauge, Histogram,
MetricGroup, MetricRegistry, the module's registry, compaction_metrics,
join_metrics, get_metrics, sql_metrics, decode_metrics, dict_metrics and
encode_metrics, with the JAX package's member names; the other groups are
not ported). The cache{cache=manifest|data-file} groups are filled by
utils/cache.py.
"""

from __future__ import annotations

import threading
from typing import Callable

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricGroup",
    "MetricRegistry",
    "registry",
    "compaction_metrics",
    "join_metrics",
    "get_metrics",
    "sql_metrics",
    "decode_metrics",
    "dict_metrics",
    "encode_metrics",
]


class Counter:
    def __init__(self):
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def count(self) -> int:
        return self._v


class Gauge:
    def __init__(self, fn: Callable[[], float] | None = None):
        self._fn = fn
        self._v: float = 0.0

    def set(self, v: float) -> None:
        self._v = v

    @property
    def value(self) -> float:
        return self._fn() if self._fn is not None else self._v


class Histogram:
    """Sliding-window histogram (reference uses a 100-sample window)."""

    def __init__(self, window: int = 100):
        self.window = window
        self._values: list[float] = []
        self._lock = threading.Lock()

    def update(self, v: float) -> None:
        with self._lock:
            self._values.append(v)
            if len(self._values) > self.window:
                self._values.pop(0)

    @property
    def count(self) -> int:
        return len(self._values)

    @property
    def mean(self) -> float:
        return sum(self._values) / len(self._values) if self._values else 0.0

    @property
    def max(self) -> float:
        return max(self._values) if self._values else 0.0

    @property
    def min(self) -> float:
        return min(self._values) if self._values else 0.0

    @property
    def last(self) -> float:
        """Most recent sample — per-operation readout for benches/tests."""
        return self._values[-1] if self._values else 0.0


class MetricGroup:
    def __init__(self, name: str, tags: dict[str, str] | None = None):
        self.name = name
        self.tags = tags or {}
        self.metrics: dict[str, object] = {}

    def counter(self, name: str) -> Counter:
        return self.metrics.setdefault(name, Counter())  # type: ignore[return-value]

    def gauge(self, name: str, fn: Callable[[], float] | None = None) -> Gauge:
        return self.metrics.setdefault(name, Gauge(fn))  # type: ignore[return-value]

    def histogram(self, name: str, window: int = 100) -> Histogram:
        return self.metrics.setdefault(name, Histogram(window))  # type: ignore[return-value]


class MetricRegistry:
    def __init__(self):
        self.groups: dict[tuple, MetricGroup] = {}
        self._lock = threading.Lock()

    def group(self, name: str, **tags: str) -> MetricGroup:
        key = (name, tuple(sorted(tags.items())))
        with self._lock:
            if key not in self.groups:
                self.groups[key] = MetricGroup(name, tags)
            return self.groups[key]

    def snapshot(self) -> dict:
        out: dict = {}
        for (name, tags), group in self.groups.items():
            entry = {}
            for mname, m in group.metrics.items():
                if isinstance(m, Counter):
                    entry[mname] = m.count
                elif isinstance(m, Gauge):
                    entry[mname] = m.value
                elif isinstance(m, Histogram):
                    entry[mname] = {"count": m.count, "mean": m.mean, "max": m.max}
            out[name if not tags else f"{name}{dict(tags)}"] = entry
        return out

    def reset(self) -> None:
        with self._lock:
            self.groups.clear()


registry = MetricRegistry()


def compaction_metrics() -> MetricGroup:
    """The compaction{...} group, filled by table/compactor.py's
    AdaptiveCompactorService. Counters: adaptive_runs (buckets it
    compacted), deferred_buckets (buckets with sorted runs the policy left
    for later), adaptive_conflicts (rounds abandoned to a rival commit),
    admission_waits (ingest flushes that blocked in its debt gate). Gauges:
    debt_files and debt_bytes (files and bytes outside each bucket's top
    run, summed), read_amplification_p99 (p99 of the buckets' sorted-run
    counts at the last observation). Resolved per call, so registry.reset()
    swaps the group out."""
    return registry.group("compaction")


def join_metrics() -> MetricGroup:
    """The join{...} group (ops/join.py). Counters: joins (join_batches
    calls), index_probes (JoinIndex.probe calls), rows_probed,
    rows_matched, hash_joins, sort_merge_joins, code_domain_joins (joins
    with at least one key column matched on dictionary codes), skew_keys
    and skew_split_rows; histograms: build_ms (key encode and lane planning)
    and probe_ms (kernel and pair expansion). Resolved per call."""
    return registry.group("join")


def get_metrics() -> MetricGroup:
    """The get{...} group (table/get.py, lookup/index.py). Counters: gets
    (probe keys served), keys_probed (keys times surviving files),
    files_pruned (files skipped with no data IO, by key range or key
    bloom), index_hits (files whose key bloom was consulted) and
    memtable_hits (keys won by the read-your-writes tier); histogram:
    probe_ms (one get_batch, wall millis). Resolved per call."""
    return registry.group("get")


def sql_metrics() -> MetricGroup:
    """The sql{...} group (the GROUP BY segment-reduce of sql/select.py and
    ops/aggregates.py). The JAX package's members; the port fills one of
    them: rows_reduced_device (input rows reduced by segment_reduce on the
    device or through its torch ops; the numpy twin does not count). The
    distributed SQL members (fragments, fragments_retried,
    partials_combined, code_domain_groups, rows_streamed,
    fragment_cache_hits, shuffle_rounds, parts_exchanged, exchange_bytes,
    shuffle_retried; scatter_ms, combine_ms, shuffle_ms) belong to the SQL
    cluster, which is not ported. Resolved per call."""
    return registry.group("sql")


def decode_metrics() -> MetricGroup:
    """The decode{...} group (decode/: the native page decoder). Counters:
    pages_decoded, pages_skipped (dead under the compressed-domain
    pushdown, never expanded), bytes_expanded (value bytes materialized),
    rows_pruned (rows the pushdown dropped), files_native (files decoded);
    histograms: file_ms (one file's decode, wall millis) and pushdown_ms
    (one row group's gate). Resolved per call."""
    return registry.group("decode")


def dict_metrics() -> MetricGroup:
    """The dict{...} group (ops/dicts.py and the code-domain reader of
    decode/). Counters: pools_unified (sorted pools merged into one
    domain), codes_remapped (rows whose codes went through a unify or sort
    gather), rows_code_domain (rows a reader delivered as dictionary codes),
    fallback_expanded (rows that left the code domain: a chunk with PLAIN
    pages, a pool past merge.dict-domain.pool-limit, or a consumer that
    needed the values); histogram: unify_ms. Resolved per call."""
    return registry.group("dict")


def encode_metrics() -> MetricGroup:
    """The encode{...} group (encode/: the page encoder). Counters:
    pages_written (data pages), dict_pages (dictionary pages),
    files_native and bytes_written; histograms: encode_ms (one file) and
    stats_ms (its chunk statistics). Resolved per call."""
    return registry.group("encode")
