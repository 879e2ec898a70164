"""Cross-partition upsert: a dynamic-bucket table whose primary key omits
a partition key (port of paimon_tpu/table/crosspartition.py).

A global index maps each key to its (partition, bucket). It is
bootstrapped from the key columns of every live file: in each bucket a
key's row of the largest sequence number is its last, and the key lives
in the bucket where that row is +I or +U (absent where it is -D or -U
everywhere). Sequence numbers count per bucket, so between buckets a live
row wins over a retracted one whatever their numbers; only among live
rows (which an index TTL can leave) does the larger number win. The JAX
package compares the numbers across buckets first, so after a restart it
loses a key whose retraction in the old bucket got a larger number than
its row in the new one, and the next write of that key duplicates it
(ROADMAP Queue 3). A row whose key lives in another partition is written
to its new partition, and a -D row retracts it at the old location; a -D
or -U row is sent to wherever the index has its key. New keys fill the
partition's buckets in order, dynamic-bucket.target-row-num keys each.
Entries older than cross-partition-upsert.index-ttl are dropped when
looked up.

Assignment runs row by row in input order, as in the JAX package, since
the buckets depend on that order; the columns are turned into Python
lists first, so the loop touches no numpy scalar. The writers are
merge-tree writers with total_buckets -1, and their flushes merge on the
device like any other.
"""

from __future__ import annotations

import concurrent.futures
from typing import TYPE_CHECKING

import numpy as np

from ..data.batch import ColumnBatch
from ..options import CoreOptions
from ..types import RowKind
from ..utils import now_millis

if TYPE_CHECKING:
    from . import FileStoreTable

__all__ = ["GlobalIndexAssigner", "CrossPartitionUpsertWrite"]

_RETRACT = (int(RowKind.DELETE), int(RowKind.UPDATE_BEFORE))


def _rows(batch: ColumnBatch, names) -> list[tuple]:
    """The named columns' values as one tuple per row."""
    return list(zip(*(batch.column(n).values.tolist() for n in names)))


class GlobalIndexAssigner:
    def __init__(
        self,
        table: "FileStoreTable",
        target_bucket_rows: int,
        bootstrap_parallelism: int = 10,
        index_ttl_millis: int | None = None,
    ):
        self.table = table
        self.key_names = table.store.key_names
        self.target = target_bucket_rows
        self.bootstrap_parallelism = max(1, bootstrap_parallelism)
        self.index_ttl_millis = index_ttl_millis
        self.index: dict[tuple, tuple] = {}  # key -> (partition, bucket, born millis)
        self._bucket_counts: dict[tuple, int] = {}  # (partition, bucket) -> rows

    def _now(self) -> int:
        return now_millis()

    def _get_live(self, key: tuple):
        e = self.index.get(key)
        if e is None:
            return None
        if self.index_ttl_millis is not None and self._now() - e[2] > self.index_ttl_millis:
            del self.index[key]
            return None
        return e[:2]

    def bootstrap(self) -> None:
        """Each key of the live files at the bucket where its last row is
        live (the larger sequence number among several); each bucket's
        count is its files' rows. Buckets are read on
        cross-partition-upsert.bootstrap-parallelism threads and folded in
        plan order."""
        store = self.table.store
        plan = store.new_scan().plan()
        jobs = [(p, b, files) for p, buckets in plan.grouped().items() for b, files in buckets.items()]

        def read_bucket(job):
            partition, bucket, files = job
            rf = store.reader_factory(partition, bucket)
            local: dict[tuple, tuple] = {}  # key -> (seq, alive)
            for f in files:
                kv = rf.read(f, fields=self.key_names)
                alive = (~np.isin(kv.kind, _RETRACT)).tolist()
                for key, seq, ok in zip(_rows(kv.data, self.key_names), kv.seq.tolist(), alive):
                    prev = local.get(key)
                    if prev is None or seq > prev[0]:
                        local[key] = (seq, ok)
            return partition, bucket, sum(f.row_count for f in files), local

        latest: dict[tuple, tuple] = {}  # key -> (seq, partition, bucket, alive)
        with concurrent.futures.ThreadPoolExecutor(max_workers=self.bootstrap_parallelism) as pool:
            for partition, bucket, count, local in pool.map(read_bucket, jobs):
                self._bucket_counts[(partition, bucket)] = count
                for key, (seq, ok) in local.items():
                    prev = latest.get(key)
                    if prev is None or (ok, seq) > (prev[3], prev[0]):
                        latest[key] = (seq, partition, bucket, ok)
        born = self._now()
        for key, (_, partition, bucket, ok) in latest.items():
            if ok:
                self.index[key] = (partition, bucket, born)

    def assign(self, key: tuple, partition: tuple) -> tuple[tuple, int, tuple | None]:
        """(partition, bucket, the old (partition, bucket) when the key
        moves, else None)."""
        existing = self._get_live(key)
        if existing is not None and existing[0] == partition:
            return partition, existing[1], None
        bucket = self._allocate(partition)
        self.index[key] = (partition, bucket, self._now())
        return partition, bucket, existing

    def _allocate(self, partition: tuple) -> int:
        b = 0
        while self._bucket_counts.get((partition, b), 0) >= self.target:
            b += 1
        self._bucket_counts[(partition, b)] = self._bucket_counts.get((partition, b), 0) + 1
        return b

    def delete(self, key: tuple) -> tuple | None:
        e = self.index.pop(key, None)
        return None if e is None else e[:2]


class CrossPartitionUpsertWrite:
    """The write path of a table whose primary key omits a partition key."""

    def __init__(self, table: "FileStoreTable"):
        if not table.is_primary_key_table:
            raise ValueError("cross-partition upsert needs a primary-key table")
        store = table.store
        opts = store.options.options
        self.table = table
        self.partition_keys = store.partition_keys
        self.key_names = store.key_names
        self.assigner = GlobalIndexAssigner(
            table,
            opts.get(CoreOptions.DYNAMIC_BUCKET_TARGET_ROW_NUM),
            bootstrap_parallelism=opts.get(CoreOptions.CROSS_PARTITION_UPSERT_BOOTSTRAP_PARALLELISM),
            index_ttl_millis=opts.get(CoreOptions.CROSS_PARTITION_UPSERT_INDEX_TTL),
        )
        self.assigner.bootstrap()
        self._writers: dict[tuple, object] = {}

    def _writer(self, partition: tuple, bucket: int):
        key = (partition, bucket)
        if key not in self._writers:
            self._writers[key] = self.table.store.new_writer(partition, bucket, -1)
        return self._writers[key]

    def write(self, data: "ColumnBatch | dict", kinds: "np.ndarray | list[str] | None" = None) -> None:
        """Route each row by the index; the rows of one location go to its
        writer as one batch, in input order, with their kinds (a moved
        key's retraction as -D at its old location)."""
        if isinstance(data, dict):
            data = ColumnBatch.from_pydict(self.table.row_type, data)
        if kinds is not None and not isinstance(kinds, np.ndarray):
            kinds = np.array([int(RowKind.from_short_string(k)) for k in kinds], dtype=np.uint8)
        n = data.num_rows
        kind_list = [int(RowKind.INSERT)] * n if kinds is None else kinds.tolist()
        ops: dict[tuple, list[tuple[int, int]]] = {}  # location -> [(row, kind)]
        assigner = self.assigner
        for i, (key, partition, kind) in enumerate(
            zip(_rows(data, self.key_names), _rows(data, self.partition_keys), kind_list)
        ):
            if kind in _RETRACT:
                old = assigner.delete(key)
                if old is not None:
                    ops.setdefault(old, []).append((i, kind))
                continue
            target, bucket, old = assigner.assign(key, partition)
            if old is not None:
                ops.setdefault(old, []).append((i, int(RowKind.DELETE)))
            ops.setdefault((target, bucket), []).append((i, kind))
        for loc, pairs in ops.items():
            rows = np.array([r for r, _ in pairs], dtype=np.int64)
            self._writer(*loc).write(data.take(rows), np.array([k for _, k in pairs], dtype=np.uint8))

    def prepare_commit(self):
        return [m for m in (w.prepare_commit() for w in self._writers.values()) if not m.is_empty()]
