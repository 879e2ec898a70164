"""Full-cache lookup tables for lookup joins (port of
paimon_tpu/lookup/tables.py).

FullCacheLookupTable caches a whole table on the host and answers probes
by join key, in one of three shapes chosen from the keys: "primary" (the
join key is the primary key: key -> row), "secondary" (another projection:
join key -> primary keys -> row) and "no-pk" (an append table: join key ->
rows). Bootstrap and refresh drain the table's stream scan
(table/stream.py): data splits are read at the key-value level through
MergeFileSplitRead.read_kv(drop_delete=False), so -D rows survive to
retract, and changelog splits through read_with_kinds; +I/+U rows apply,
-U/-D rows retract. Reads go through the data-file cache (utils/cache.py).
The bootstrap's merge of overlapping files runs on the table's device and
sort engine: K1 or K2 under sort-engine=pallas.

Probes are vectorised: the cached state becomes one ColumnBatch and a
JoinIndex (ops/join.py), rebuilt after any change, and a probe batch pays
one searchsorted. `get` is a thin wrapper over `get_batch`; `lookup_join`
left-joins a probe batch against the cache.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Mapping, Sequence

import numpy as np
import torch

from ..core.read import MergeFileSplitRead
from ..data.batch import ColumnBatch
from ..ops.join import JoinIndex, materialize_join
from ..table.get import batch_from_rows
from ..types import RowKind
from ..utils import resolve_device

if TYPE_CHECKING:
    from ..table import FileStoreTable

__all__ = ["FullCacheLookupTable", "lookup_join"]


class FullCacheLookupTable:
    """The whole table cached locally, refreshed incrementally, probed by
    join key on `device` (CUDA unless the caller asks for the CPU)."""

    def __init__(
        self,
        table: "FileStoreTable",
        join_keys: Sequence[str] | None = None,
        device: "str | torch.device" = "cuda",
    ):
        self.device = resolve_device(device)
        self.table = table
        pks = list(table.primary_keys)
        self.join_keys = list(join_keys) if join_keys else list(pks)
        unknown = [k for k in self.join_keys if k not in table.row_type]
        if unknown:
            raise ValueError(f"unknown join keys {unknown}")
        self.field_names = table.row_type.field_names
        if not pks:
            self.mode = "no-pk"
        elif self.join_keys == pks:
            self.mode = "primary"
        else:
            self.mode = "secondary"
        self._rows: dict[tuple, tuple] = {}  # pk -> row (primary, secondary)
        self._multi: dict[tuple, list[tuple]] = {}  # join key -> rows (no-pk)
        self._index: dict[tuple, set[tuple]] = {}  # join key -> pks (secondary)
        self._pk_idx = [self.field_names.index(k) for k in pks]
        self._jk_idx = [self.field_names.index(k) for k in self.join_keys]
        self._scan = table.new_read_builder().new_stream_scan()
        self._read = table.new_read_builder().new_read()
        self._join_idx: JoinIndex | None = None
        self._state: ColumnBatch | None = None
        self.refresh()

    def refresh(self) -> int:
        """Drain the snapshots the stream scan has not planned yet; returns
        the number of change rows applied."""
        applied = 0
        while True:
            splits = self._scan.plan()
            if not splits:
                return applied
            for split in splits:
                rows, kinds = self._read_changes(split)
                for row, kind in zip(rows, kinds):
                    self._apply(row, kind)
                    applied += 1

    def _read_changes(self, split):
        """Rows and kinds of one split at the key-value level: -D rows must
        survive the read so the cache can retract them."""
        if split.is_changelog:
            data, kinds = self._read.read_with_kinds(split)
            return data.to_pylist(), kinds.tolist()
        store = self.table.store
        read = MergeFileSplitRead(store.reader_factory(split.partition, split.bucket), store.merge_executor(), store.key_names)
        kv = read.read_kv(split.files, drop_delete=False)
        return kv.data.to_pylist(), kv.kind.tolist()

    def _apply(self, row: tuple, kind: int) -> None:
        self._join_idx = None  # any change invalidates the vectorised view
        self._state = None
        add = kind in (int(RowKind.INSERT), int(RowKind.UPDATE_AFTER))
        jk = tuple(row[i] for i in self._jk_idx)
        if self.mode == "no-pk":
            if add:
                self._multi.setdefault(jk, []).append(row)
            else:
                rows = self._multi.get(jk)
                if rows and row in rows:
                    rows.remove(row)
            return
        pk = tuple(row[i] for i in self._pk_idx)
        if self.mode == "secondary":
            old = self._rows.get(pk)
            if old is not None:
                s = self._index.get(tuple(old[i] for i in self._jk_idx))
                if s is not None:
                    s.discard(pk)
        if add:
            self._rows[pk] = row
            if self.mode == "secondary":
                self._index.setdefault(jk, set()).add(pk)
        else:
            self._rows.pop(pk, None)

    def state_batch(self) -> ColumnBatch:
        """The cached state as one ColumnBatch, in a fixed order: the pk
        map's insertion order, or for no-pk each key's rows in key insertion
        order. Rebuilt after a change."""
        if self._state is None:
            if self.mode == "no-pk":
                rows = [r for rs in self._multi.values() for r in rs]
            else:
                rows = list(self._rows.values())
            self._state = batch_from_rows(self.table.row_type, rows)
        return self._state

    def _join_index(self) -> JoinIndex:
        if self._join_idx is None:
            self._join_idx = JoinIndex(self.state_batch(), self.join_keys, device=self.device)
        return self._join_idx

    def _probe_batch(self, keys) -> ColumnBatch:
        """The probe input as a ColumnBatch: one carrying the join-key
        columns, a {column: sequence} mapping, or a sequence of key tuples."""
        if hasattr(keys, "schema") and hasattr(keys, "columns"):
            return keys
        schema = self.table.row_type.project(self.join_keys)
        if isinstance(keys, Mapping):
            return ColumnBatch.from_pydict(schema, {k: keys[k] for k in self.join_keys})
        return batch_from_rows(schema, [tuple(k) if isinstance(k, (tuple, list)) else (k,) for k in keys])

    def get_batch(self, keys, how: str = "inner"):
        """(matched rows over the table's row type, probe index of each):
        probe-major, each probe key's matches in state order. how='left'
        keeps an unmatched probe key as an all-null row."""
        probe = self._probe_batch(keys)
        res = self._join_index().probe(probe, self.join_keys, how=how)
        state = self.state_batch()
        if how == "left":
            pairs = [(n, n) for n in state.schema.field_names]
            return materialize_join(probe, state, res, [], pairs), res.left_take
        return state.take(np.asarray(res.right_take)), res.left_take

    def get(self, key: "tuple | Sequence") -> list[tuple]:
        """Rows whose join key equals `key`. A null key component never
        matches under join semantics, so such keys take the dict probe."""
        key = tuple(key)
        if any(k is None for k in key):
            return self._legacy_get(key)
        batch, _ = self.get_batch([key])
        rows = batch.to_pylist()
        if self.mode == "secondary":
            rows.sort(key=lambda r: tuple(r[i] for i in self._pk_idx))
        return rows

    def _legacy_get(self, key: tuple) -> list[tuple]:
        if self.mode == "no-pk":
            return list(self._multi.get(key, ()))
        if self.mode == "primary":
            row = self._rows.get(key)
            return [row] if row is not None else []
        return [self._rows[pk] for pk in sorted(self._index.get(key, ())) if pk in self._rows]

    def __len__(self) -> int:
        if self.mode == "no-pk":
            return sum(len(v) for v in self._multi.values())
        return len(self._rows)


def lookup_join(
    lookup: FullCacheLookupTable,
    probe: ColumnBatch,
    probe_keys: Sequence[str] | None = None,
    suffix: str = "_lookup",
) -> ColumnBatch:
    """LEFT-join `probe` against the cached table on its join keys,
    appending every table column (a name the probe already has gets
    `suffix`). An unmatched probe row keeps null table columns; a no-pk
    table may fan one probe row out to several."""
    keys = list(probe_keys) if probe_keys is not None else list(lookup.join_keys)
    res = lookup._join_index().probe(probe, keys, how="left")
    state = lookup.state_batch()
    left_pairs = [(n, n) for n in probe.schema.field_names]
    right_pairs = [(n, n if n not in probe.schema else f"{n}{suffix}") for n in state.schema.field_names]
    return materialize_join(probe, state, res, left_pairs, right_pairs)
