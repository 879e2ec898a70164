"""Merge-engine orchestration over the device kernels (port of
paimon_tpu/core/mergefn.py).

One MergeExecutor call feeds every same-key group through the table's
merge function at once: encode keys into lanes (string keys as ranks in a
pool over the whole merge input, taken from their dictionary codes when
the columns are code-backed under merge.dict-domain), sort and segment
them on the device (K1 or K2 under sort-engine=pallas), apply the engine
as segment selections or reductions, and gather on the host (a
code-backed column gathers its codes). Engines: deduplicate,
partial-update (with sequence groups), aggregation (every function; the
nested ones, collect, merge_map and nested_update, build their values on
the host from the plan, and take ARRAY, MAP and ARRAY columns only) and
first-row. A sequence.field
orders each key's rows before the system sequence number: its lanes go
ahead of the seqno lanes (a string field as ranks in a pool over the
merge's column). Partial-update without sequence groups and routable
aggregations take one fused device call; first-row, sequence groups (one
extra plan per group, ordered by the group's own sequence column), the
numpy engine and the host aggregates (product, listagg and the nested
ones) go through merge_plan. Under sort-engine=numpy every step runs on the host.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..data.batch import Column, ColumnBatch, gather_column
from ..data.keys import _encode_column, _pool_and_ranks, encode_key_lanes_with_pools, lexsort_rows, split_int64_lanes
from ..ops.aggregates import AggregateSpec, aggregate_merge, fused_aggregate, fused_routable
from ..options import CoreOptions, MergeEngine, SortEngine
from ..types import STRING_ROOTS, RowKind, RowType, TypeRoot
from .kv import KVBatch

__all__ = ["MergeExecutor"]

# the column type each nested aggregate takes, as upstream Paimon's
# FieldCollectAgg, FieldNestedUpdateAgg and FieldMergeMapAgg do (the JAX
# package also runs collect and nested_update over flat columns, storing
# lists in them, and fails merge_map on them: ROADMAP Queue 3 item 26)
_NESTED_INPUT = {"collect": TypeRoot.ARRAY, "nested_update": TypeRoot.ARRAY, "merge_map": TypeRoot.MAP}


def _numpy_dedup_select(lanes: np.ndarray, seq_lanes: np.ndarray | None, compress: bool | None = None) -> np.ndarray:
    """sort-engine=numpy: the host oracle the device engines are held
    against. Lane compression applies here too (no OVC lane)."""
    from ..ops.lanes import compress_key_lanes, scalar_dedup_winner

    n = lanes.shape[0]
    lanes, plan = compress_key_lanes(lanes, compress, enable_ovc=False)
    if plan is not None and lanes.shape[1] == 0:
        return scalar_dedup_winner(seq_lanes, n)
    tiebreakers = [] if seq_lanes is None else [seq_lanes[:, i] for i in range(seq_lanes.shape[1])]
    order = lexsort_rows(lanes, *tiebreakers)
    sorted_lanes = lanes[order]
    neq = (sorted_lanes[1:] != sorted_lanes[:-1]).any(axis=1)
    keep_last = np.concatenate([neq, np.ones(1, dtype=np.bool_)])
    return order[keep_last]


class MergeExecutor:
    def __init__(
        self,
        value_schema: RowType,
        key_names: Sequence[str],
        engine: MergeEngine = MergeEngine.DEDUPLICATE,
        options: CoreOptions | None = None,
        device: "str | torch.device" = "cuda",
    ):
        self.value_schema = value_schema
        self.key_names = list(key_names)
        self.engine = engine
        self.options = options or CoreOptions()
        self.device = torch.device(device)
        self._user_seq = self.options.sequence_field
        if engine == MergeEngine.AGGREGATE:
            for f in self._value_fields():
                fn = self._agg_spec(f.name).function
                want = _NESTED_INPUT.get(fn)
                if want is not None and f.type.root != want:
                    key = f"fields.{f.name}.aggregate-function"
                    if self.options.field_option(f.name, "aggregate-function") is None:
                        key = CoreOptions.AGGREGATE_DEFAULT_FUNC.key
                    raise ValueError(f"{key}={fn} aggregates {want.value} columns; column {f.name!r} is {f.type}")

    @property
    def _compress(self) -> bool:
        return self.options.lane_compression

    def effective_sort_engine(self) -> SortEngine:
        """The table's sort-engine (default xla-segmented = plain torch ops)."""
        return SortEngine(self.options.sort_engine)

    def _backend(self) -> str:
        return "pallas" if self.effective_sort_engine() == SortEngine.PALLAS else "xla"

    def _plan_device(self) -> torch.device:
        """sort-engine=numpy keeps the planned merge on the host."""
        return torch.device("cpu") if self.effective_sort_engine() == SortEngine.NUMPY else self.device

    def select_last(self, lanes: np.ndarray) -> np.ndarray:
        """The row indices of each key's last row in input order, in key
        order, under the table's sort-engine (pallas: K1, or the stock sort
        + K2 above K1's bound): the local merge buffer's selection."""
        if self.effective_sort_engine() == SortEngine.NUMPY:
            return _numpy_dedup_select(lanes, None, self._compress)
        from ..ops.merge import deduplicate_select

        return deduplicate_select(lanes, None, self._compress, self._backend(), self.device)

    def _value_fields(self):
        return [f for f in self.value_schema.fields if f.name not in self.key_names]

    def _key_lanes(self, kv: KVBatch) -> np.ndarray:
        """Key lanes; a string or bytes key ranks against a pool built over
        kv, which holds every run of the merge (merge-wide, as the JAX
        package builds it), from its codes where it carries them."""
        return encode_key_lanes_with_pools(kv.data, self.key_names)

    def _seq_lanes(self, kv: KVBatch, seq_ascending: bool) -> np.ndarray | None:
        """The sequence.field lanes (a null there raises the JAX package's
        ValueError), then the system sequence-number lanes, only when input
        order does not already encode them (stability of the sort covers
        that case)."""
        parts = []
        if self._user_seq:
            parts.append(encode_key_lanes_with_pools(kv.data, self._user_seq))
        if not seq_ascending:
            hi, lo = split_int64_lanes(kv.seq)
            parts.append(np.stack([hi, lo], axis=1))
        return np.concatenate(parts, axis=1) if parts else None

    @staticmethod
    def _strictly_increasing(lanes: np.ndarray) -> bool:
        """Are the key tuples strictly ascending (row i < row i+1)?"""
        if lanes.shape[0] <= 1:
            return True
        a, b = lanes[:-1], lanes[1:]
        lt = np.zeros(len(a), dtype=np.bool_)
        eq = np.ones(len(a), dtype=np.bool_)
        for i in range(lanes.shape[1]):
            lt |= eq & (a[:, i] < b[:, i])
            eq &= a[:, i] == b[:, i]
        return bool(lt.all())

    def merge(self, kv: KVBatch, seq_ascending: bool = False) -> KVBatch:
        """One output row per key, key-sorted. Deduplicate and first-row keep
        the winning row's RowKind; partial-update and aggregation emit +I
        (partial-update -D under remove-record-on-delete). seq_ascending=True
        asserts that equal keys appear in ascending sequence order in the
        input."""
        return self.merge_resolve(self.merge_async(kv, seq_ascending))

    def merge_async(self, kv: KVBatch, seq_ascending: bool = False):
        if kv.num_rows == 0:
            return ("sync", kv)
        if self.options.ignore_delete:
            keep = kv.kind != int(RowKind.DELETE)
            if not keep.all():
                kv = kv.filter(keep)
                if kv.num_rows == 0:
                    return ("sync", kv)
        lanes = self._key_lanes(kv)
        if self.engine == MergeEngine.DEDUPLICATE and self._strictly_increasing(lanes):
            # already key-sorted with unique keys: dedup is the identity (and
            # only dedup: aggregation and partial-update still rewrite a row)
            return ("sync", kv)
        seq_lanes = self._seq_lanes(kv, seq_ascending)
        engine = self.effective_sort_engine()
        if self.engine == MergeEngine.DEDUPLICATE:
            if engine == SortEngine.NUMPY:
                return ("sync", kv.take(_numpy_dedup_select(lanes, seq_lanes, self._compress)))
            from ..ops.merge import deduplicate_select_async

            handle = deduplicate_select_async(lanes, seq_lanes, self._backend(), self._compress, self.device)
            return ("dedup", handle, kv)
        if engine != SortEngine.NUMPY:
            # one device call: sort + segment + the engine's selection
            if self.engine == MergeEngine.PARTIAL_UPDATE and not self._sequence_groups():
                return ("sync", self._partial_update_fused(kv, lanes, seq_lanes))
            if self.engine == MergeEngine.AGGREGATE:
                fields = self._value_fields()
                specs = [self._agg_spec(f.name) for f in fields]
                cols = [kv.data.column(f.name) for f in fields]
                if fused_routable(specs, cols):
                    return ("sync", self._aggregate_fused(kv, lanes, seq_lanes, fields, specs, cols))
        from ..ops.merge import merge_plan

        plan = merge_plan(
            lanes, seq_lanes, compress=self._compress, engine=self._backend(), device=self._plan_device()
        )
        return ("sync", self._merge_with_plan(kv, plan))

    def merge_resolve(self, handle) -> KVBatch:
        if handle[0] == "sync":
            return handle[1]
        from ..ops.merge import deduplicate_resolve

        _, h, kv = handle
        return kv.take(deduplicate_resolve(h))

    def _merge_with_plan(self, kv: KVBatch, plan) -> KVBatch:
        from ..ops.merge import first_row_take

        if self.engine == MergeEngine.FIRST_ROW:
            if np.isin(kv.kind, (int(RowKind.UPDATE_BEFORE), int(RowKind.DELETE))).any():
                raise ValueError("first-row merge engine accepts only +I/+U records")
            return kv.take(first_row_take(plan))
        last_take = plan.perm[plan.keep_last & plan.valid_sorted]
        if self.engine == MergeEngine.PARTIAL_UPDATE:
            return self._partial_update(kv, plan, last_take)
        return self._aggregate(kv, plan, last_take)

    # ---- partial update -------------------------------------------------
    def _remove_on_delete(self, kv: KVBatch) -> bool:
        """partial-update.remove-record-on-delete; without it a -U/-D row
        raises."""
        remove_on_delete = self.options.options.get(CoreOptions.PARTIAL_UPDATE_REMOVE_RECORD_ON_DELETE)
        if not remove_on_delete and np.isin(kv.kind, (int(RowKind.DELETE), int(RowKind.UPDATE_BEFORE))).any():
            raise ValueError(
                "partial-update cannot handle -U/-D records; set "
                "'partial-update.remove-record-on-delete' or 'ignore-delete'"
            )
        return remove_on_delete

    def _sequence_groups(self) -> dict[str, list[str]]:
        """{sequence column: [the fields it governs]} from the
        fields.<column>.sequence-group options (partial-update only)."""
        if self.engine != MergeEngine.PARTIAL_UPDATE:
            return {}
        groups: dict[str, list[str]] = {}
        for key, value in self.options.options._data.items():
            if key.startswith("fields.") and key.endswith(".sequence-group"):
                groups[key[len("fields.") : -len(".sequence-group")]] = [s.strip() for s in str(value).split(",")]
        return groups

    def _default_fields(self):
        """The value fields outside every sequence group."""
        groups = self._sequence_groups()
        grouped = {f for fields in groups.values() for f in fields} | set(groups)
        return [f for f in self._value_fields() if f.name not in grouped]

    def _field_valid(self, kv: KVBatch) -> np.ndarray:
        """(F, n) non-null masks of the value fields outside the groups."""
        fields = self._default_fields()
        if not fields:
            return np.zeros((0, kv.num_rows), np.bool_)
        return np.stack([kv.data.column(f.name).valid_mask() for f in fields])

    def _partial_update_rows(self, kv: KVBatch, src, exists, last_take, extra=None) -> KVBatch:
        """The merged rows: keys from each key's last row, each field outside
        the groups from its source row (-1 = null), the groups' columns from
        `extra`; -D where remove-record-on-delete removed the key."""
        cols: dict[str, Column] = {k: kv.data.column(k).take(last_take) for k in self.key_names}
        for fi, f in enumerate(self._default_fields()):
            cols[f.name] = gather_column(kv.data.column(f.name), src[fi])
        cols.update(extra or {})
        kind = np.where(exists, int(RowKind.INSERT), int(RowKind.DELETE)).astype(np.uint8)
        return KVBatch(ColumnBatch(self.value_schema, cols), kv.seq.take(last_take), kind)

    def _partial_update_fused(self, kv: KVBatch, lanes, seq_lanes) -> KVBatch:
        from ..ops.merge import fused_partial_update

        remove_on_delete = self._remove_on_delete(kv)
        src, exists, last_take = fused_partial_update(
            lanes,
            seq_lanes,
            self._field_valid(kv),
            kv.kind,
            remove_record_on_delete=remove_on_delete,
            compress=self._compress,
            engine=self._backend(),
            device=self.device,
        )
        # without remove-on-delete every row is +I/+U (checked above), so
        # every key exists; with it, removed keys stay as -D rows
        return self._partial_update_rows(kv, src, exists, last_take)

    def _partial_update(self, kv: KVBatch, plan, last_take) -> KVBatch:
        from ..ops.merge import partial_update_takes

        remove_on_delete = self._remove_on_delete(kv)
        src, exists = partial_update_takes(
            plan, self._field_valid(kv), kv.kind, remove_on_delete, self._plan_device()
        )
        # each group's fields come together from the row with the highest
        # (group sequence, system sequence) whose group sequence is not null
        groups = {}
        for seq_col, fields in self._sequence_groups().items():
            groups.update(self._group_take(kv, seq_col, fields))
        out = self._partial_update_rows(kv, src, exists, last_take, groups)
        if not exists.all() and not remove_on_delete:
            out = out.filter(exists)
        return out

    def _group_take(self, kv: KVBatch, seq_col: str, fields) -> dict[str, Column]:
        """One sequence group's columns: a plan over (key, group sequence,
        system sequence) picks each key's last +I/+U row with a non-null
        group sequence; a field with an aggregate function (or
        fields.default-aggregate-function) aggregates over that plan, the
        rows without a group sequence left out."""
        from ..ops.aggregates import _padded, _Sorted
        from ..ops.merge import merge_plan

        dev = self._plan_device()
        gcol = kv.data.column(seq_col)
        g_valid = gcol.valid_mask()
        hi, lo = split_int64_lanes(kv.seq)
        seq_lanes = np.concatenate(
            [self._lanes_nullsafe(gcol, kv.data.schema.field(seq_col).type.root), np.stack([hi, lo], axis=1)], axis=1
        )
        plan = merge_plan(self._key_lanes(kv), seq_lanes, compress=self._compress, engine=self._backend(), device=dev)
        candidate = g_valid & np.isin(kv.kind, (int(RowKind.INSERT), int(RowKind.UPDATE_AFTER)))
        src = _Sorted.of_plan(plan, dev).pick(_padded(candidate, plan.m, False, dev), last=True)
        src = src[: plan.num_segments].cpu().numpy()
        out = {seq_col: gather_column(gcol, src)}
        default_fn = self.options.options.get(CoreOptions.AGGREGATE_DEFAULT_FUNC)
        for name in fields:
            col = kv.data.column(name)
            if (self.options.field_option(name, "aggregate-function") or default_fn) is None:
                out[name] = gather_column(col, src)
                continue
            if not g_valid.all():
                col = Column(col.values, col.valid_mask() & g_valid)
            out[name] = aggregate_merge(plan, col, self._agg_spec(name), kv.kind, dev)
        return out

    @staticmethod
    def _lanes_nullsafe(col: Column, root) -> np.ndarray:
        """Lanes of a sequence-group column that may hold nulls: a null is
        lane 0 and loses to every value; string ranks are offset by 1."""
        valid = col.valid_mask()
        if root in STRING_ROOTS:
            ranks = np.zeros(len(valid), dtype=np.uint32)
            if valid.any():
                ranks[valid] = _pool_and_ranks(col.values[valid])[1] + np.uint32(1)
            return ranks.reshape(-1, 1)
        filled = col.values.copy()
        filled[~valid] = 0
        lanes = np.stack(_encode_column(filled, root, None), axis=1)
        lanes[~valid] = 0
        return lanes

    # ---- aggregation ----------------------------------------------------
    def _agg_spec(self, field_name: str) -> AggregateSpec:
        fn = self.options.field_option(field_name, "aggregate-function")
        if fn is None:
            fn = self.options.options.get(CoreOptions.AGGREGATE_DEFAULT_FUNC) or "last_non_null_value"
        ignore_retract = (self.options.field_option(field_name, "ignore-retract") or "false").lower() == "true"
        delim = self.options.field_option(field_name, "list-agg-delimiter") or ","
        distinct = (self.options.field_option(field_name, "distinct") or "false").lower() == "true"
        nested_key = tuple(
            s.strip() for s in (self.options.field_option(field_name, "nested-key") or "").split(",") if s.strip()
        )
        return AggregateSpec(fn, ignore_retract, delim, distinct, nested_key)

    def _aggregate_rows(self, kv: KVBatch, agg_cols: dict, last_take) -> KVBatch:
        cols: dict[str, Column] = {k: kv.data.column(k).take(last_take) for k in self.key_names}
        cols.update(agg_cols)
        kind = np.full(len(last_take), int(RowKind.INSERT), dtype=np.uint8)
        return KVBatch(ColumnBatch(self.value_schema, cols), kv.seq.take(last_take), kind)

    def _aggregate_fused(self, kv: KVBatch, lanes, seq_lanes, fields, specs, cols_in) -> KVBatch:
        agg_cols, last_take = fused_aggregate(
            lanes, seq_lanes, cols_in, specs, kv.kind, compress=self._compress, engine=self._backend(),
            device=self.device,
        )
        return self._aggregate_rows(kv, {f.name: c for f, c in zip(fields, agg_cols)}, last_take)

    def _aggregate(self, kv: KVBatch, plan, last_take) -> KVBatch:
        dev = self._plan_device()
        agg_cols = {
            f.name: aggregate_merge(plan, kv.data.column(f.name), self._agg_spec(f.name), kv.kind, dev)
            for f in self._value_fields()
        }
        return self._aggregate_rows(kv, agg_cols, last_take)

    def supports_keys_only_pipeline(self) -> bool:
        """Merge needs only (key columns, seq, kind) to pick winners: the read
        path can dispatch the kernel before value columns decode. Only
        deduplicate picks whole rows so, and only when no sequence.field
        column needs decoding to order them."""
        return self.engine == MergeEngine.DEDUPLICATE and not self.options.ignore_delete and not self._user_seq

    def dedup_select_async(self, kv_keys: KVBatch, seq_ascending: bool, run_offsets=None):
        """kv_keys carries only the key columns. With run_offsets and no
        explicit seq lanes, dispatches key-range tiles."""
        lanes = self._key_lanes(kv_keys)
        seq_lanes = self._seq_lanes(kv_keys, seq_ascending)
        if self.effective_sort_engine() == SortEngine.NUMPY:
            return ("numpy", _numpy_dedup_select(lanes, seq_lanes, self._compress))
        from ..ops.merge import deduplicate_select_async, deduplicate_tiled_dispatch

        if seq_lanes is None and run_offsets is not None:
            tile_rows = self.options.options.get(CoreOptions.MERGE_READ_BATCH_ROWS)
            return (
                "tiled",
                deduplicate_tiled_dispatch(lanes, run_offsets, tile_rows, self._backend(), self._compress, self.device),
            )
        return ("single", deduplicate_select_async(lanes, seq_lanes, self._backend(), self._compress, self.device))

    @staticmethod
    def dedup_resolve(handle) -> np.ndarray:
        tag, h = handle
        if tag == "numpy":
            return h
        from ..ops.merge import deduplicate_resolve, deduplicate_resolve_tiled

        return deduplicate_resolve_tiled(h) if tag == "tiled" else deduplicate_resolve(h)
