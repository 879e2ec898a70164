"""Field aggregators of the aggregation merge engine, as segment reductions
over a merge's sorted order, and the SQL GROUP BY segment-reduce (port of
paimon_tpu/ops/aggregates.py).

sum, count, max, min, bool_and, bool_or and the first/last picks run on the
device as torch ops; product, listagg and the nested aggregates (collect,
merge_map, nested_update) run on the host over the plan's sorted order,
as in the JAX package. Integer reductions are scatter-reduces by segment id, exact in any
order. Float sums go through the `segment_sum` kernel (ops/hopper_kernels.py),
which adds each segment's rows in sorted order as XLA does on the CPU. Float
max and min reduce an order-preserving integer image of the values, so that
+0.0 beats -0.0 in max and loses in min, and a NaN anywhere in a segment
gives NaN, as XLA's segment_max and segment_min do.

`segment_reduce` is GROUP BY's reduce: group keys as uint32 lanes go
through the same sorted_segments preamble (K1 or the stock sort plus K2
under engine "pallas"), and each value column reduces over the segments as
above: integer sums and counts by index_add_, float sums through
`segment_sum`, min and max with the same NaN and signed-zero rules. Every
row contributes (no sequence lanes, no retraction); each group also gets
its minimum input position, so that SQL output keeps first-appearance
order.

Retract rows (-U/-D): sum and count subtract; collect removes the first
matching element of each retracted one, merge_map the retracted keys and
nested_update the retracted rows (by nested key when it has one);
ignore-retract drops them for a field; every other function raises
ValueError, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..data.batch import Column, gather_column
from ..types import RowKind
from ..metrics import sql_metrics
from ..utils import resolve_device
from . import hopper_kernels as hk
from .merge import MergePlan, pack_selected, prepare_lanes_planned, segment_extreme, sorted_segments, upload_lanes

__all__ = [
    "AGGREGATORS",
    "NESTED_AGGREGATORS",
    "AggregateSpec",
    "aggregate_merge",
    "fused_routable",
    "fused_aggregate",
    "segment_reduce",
    "segment_reduce_np",
]

AGGREGATORS = (
    "sum",
    "product",
    "count",
    "max",
    "min",
    "bool_and",
    "bool_or",
    "first_value",
    "first_non_null_value",
    "last_value",
    "last_non_null_value",
    "listagg",
    "collect",
    "merge_map",
    "nested_update",
    "primary-key",
)
NESTED_AGGREGATORS = ("collect", "merge_map", "nested_update")

_RETRACTABLE = {"sum", "count"}
_DEVICE_FNS = ("sum", "count", "max", "min", "bool_and", "bool_or")
_PICK_FNS = ("first_value", "first_non_null_value", "last_value", "last_non_null_value")


@dataclass(frozen=True)
class AggregateSpec:
    function: str
    ignore_retract: bool = False
    listagg_delimiter: str = ","
    collect_distinct: bool = False
    nested_key: tuple[str, ...] = ()  # nested_update: the upsert key of its ARRAY<ROW>


# ---------------------------------------------------------------------------
# device reductions over a sorted order
# ---------------------------------------------------------------------------


class _Sorted:
    """One merge's sorted order on the device: perm, segment starts and ids."""

    def __init__(self, perm: torch.Tensor, seg_start: torch.Tensor, seg_id: torch.Tensor):
        self.perm, self.seg_start, self.seg_id = perm, seg_start, seg_id
        self.m = perm.shape[0]
        self.p, self.idx = perm.long(), seg_id.long()
        self.pos = torch.arange(self.m, dtype=torch.int32, device=perm.device)

    @staticmethod
    def of_plan(plan: MergePlan, dev: torch.device) -> "_Sorted":
        return _Sorted(
            torch.from_numpy(plan.perm).to(dev),
            torch.from_numpy(plan.seg_start).to(dev),
            torch.from_numpy(plan.seg_id).to(dev),
        )

    def any_valid(self, ok: torch.Tensor) -> torch.Tensor:
        return segment_extreme(ok.to(torch.int32), self.idx) > 0

    def sum(self, values: torch.Tensor, valid: torch.Tensor, sign: torch.Tensor):
        """(total, any_valid) of valid rows times their sign, by segment id."""
        v, ok = values[self.p], valid[self.p]
        contrib = torch.where(ok, v * sign[self.p].to(v.dtype), torch.zeros((), dtype=v.dtype, device=v.device))
        if contrib.dtype.is_floating_point:
            total = hk.segment_sum(contrib, self.seg_start, self.seg_id)
        else:
            total = torch.zeros_like(contrib).index_add_(0, self.idx, contrib)
        return total, self.any_valid(ok)

    def extreme(self, values: torch.Tensor, valid: torch.Tensor, is_max: bool):
        """(max or min, any_valid) of valid rows by segment id; invalid rows
        count as the dtype's finite min (max), as in the JAX package."""
        v, ok = values[self.p], valid[self.p]
        if not v.dtype.is_floating_point:
            info = torch.iinfo(v.dtype)
            masked = torch.where(ok, v, info.min if is_max else info.max)
            return segment_extreme(masked, self.idx, is_max), self.any_valid(ok)
        info = torch.finfo(v.dtype)
        fill = torch.full((), info.min if is_max else info.max, dtype=v.dtype, device=v.device)
        key = segment_extreme(_float_key(torch.where(ok, v, fill)), self.idx, is_max)
        nan = segment_extreme((ok & torch.isnan(v)).to(torch.int32), self.idx) > 0
        nan_value = torch.full((), float("nan"), dtype=v.dtype, device=v.device)
        agg = torch.where(nan, nan_value, _float_of_key(key, v.dtype))
        return agg, self.any_valid(ok)

    def pick(self, candidate: torch.Tensor, last: bool) -> torch.Tensor:
        """Input row of each segment's last (first) candidate, -1 if none."""
        ok = candidate[self.p]
        if last:
            best = segment_extreme(torch.where(ok, self.pos, -1), self.idx)
        else:
            best = segment_extreme(torch.where(ok, self.pos, self.m), self.idx, largest=False)
            best = torch.where(best == self.m, -1, best)
        return torch.where(best >= 0, self.perm[best.clamp(0, self.m - 1).long()], -1)


_INT_OF_FLOAT = {torch.float32: (torch.int32, 0x7FFFFFFF), torch.float64: (torch.int64, 0x7FFFFFFFFFFFFFFF)}


def _float_key(v: torch.Tensor) -> torch.Tensor:
    """Order-preserving integer image of floats: negative values have their
    magnitude bits flipped, so -0.0 sorts just below +0.0. Its own inverse."""
    itype, mag = _INT_OF_FLOAT[v.dtype]
    bits = v.view(itype)
    return torch.where(bits < 0, bits ^ mag, bits)


def _float_of_key(key: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    _, mag = _INT_OF_FLOAT[dtype]
    return torch.where(key < 0, key ^ mag, key).view(dtype)


# ---------------------------------------------------------------------------
# host reductions over a plan
# ---------------------------------------------------------------------------


def _host_segments(plan: MergePlan, arrays):
    """The arrays in sorted order over the valid rows, and the first row of
    each segment there."""
    order = plan.perm[plan.valid_sorted]
    return [a.take(order) for a in arrays], np.flatnonzero(plan.seg_start[plan.valid_sorted])


def _product_host(plan: MergePlan, values: np.ndarray, eff_valid: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Exact segmented product by np.multiply.reduceat over the sorted order."""
    (v, ok), bounds = _host_segments(plan, (values, eff_valid))
    contrib = np.where(ok, v, np.ones((), values.dtype))
    return np.multiply.reduceat(contrib, bounds), np.maximum.reduceat(ok.astype(np.int8), bounds) > 0


def _host_reduce(plan: MergePlan, values: np.ndarray, eff_valid: np.ndarray, fn: str, sign=None):
    """Segmented sum/max/min on the host by np reduceat over the sorted
    order: the JAX package's float64 route on a TPU, which has no f64 ALUs."""
    (v, ok), bounds = _host_segments(plan, (values, eff_valid))
    if fn == "sum":
        s = sign.take(plan.perm[plan.valid_sorted]) if sign is not None else np.ones_like(v)
        total = np.add.reduceat(np.where(ok, v * s, np.zeros((), v.dtype)), bounds)
    elif fn == "max":
        total = np.maximum.reduceat(np.where(ok, v, np.full((), -np.inf, v.dtype)), bounds)
    else:
        total = np.minimum.reduceat(np.where(ok, v, np.full((), np.inf, v.dtype)), bounds)
    return total, np.maximum.reduceat(ok.astype(np.int8), bounds) > 0


def _f64_on_device_unsupported() -> bool:
    """The JAX package keeps float64 sums, maxima and minima on the host on a
    TPU (no f64 ALUs; `_host_reduce`). The H100 has f64 ALUs, so they stay on
    the device here, as on the JAX package's CPU route."""
    return False


def _host_aggregate(plan: MergePlan, values, valid, spec: AggregateSpec, row_kind) -> Column:
    """listagg, collect, merge_map and nested_update: a variable-length or
    structured value per segment, built on the host in (key, seq) order."""
    k = plan.num_segments
    retract = np.isin(row_kind, (int(RowKind.UPDATE_BEFORE), int(RowKind.DELETE)))
    (v_sorted, ok_sorted, retract), bounds = _host_segments(plan, (values, valid, retract))
    if spec.ignore_retract:
        ok_sorted = ok_sorted & ~retract
        retract = np.zeros_like(retract)
    elif retract.any() and spec.function == "listagg":
        raise ValueError("listagg cannot retract; configure ignore-retract")
    out = np.empty(k, dtype=object)
    validity = np.zeros(k, dtype=np.bool_)
    for s in range(k):
        lo, hi = bounds[s], bounds[s + 1] if s + 1 < k else len(v_sorted)
        if spec.function == "merge_map":
            out[s], validity[s] = _merge_map_segment(v_sorted, ok_sorted, retract, lo, hi)
        elif spec.function == "nested_update":
            out[s], validity[s] = _nested_update_segment(v_sorted, ok_sorted, retract, lo, hi, spec.nested_key)
        elif spec.function == "listagg":
            vals = [v_sorted[i] for i in range(lo, hi) if ok_sorted[i]]
            if vals:
                out[s] = spec.listagg_delimiter.join(str(x) for x in vals)
                validity[s] = True
        else:
            out[s], validity[s] = _collect_segment(v_sorted, ok_sorted, retract, lo, hi, spec.collect_distinct), True
    return Column(out, validity if not validity.all() else None)


def _collect_segment(v_sorted, ok_sorted, retract, lo, hi, distinct: bool) -> list:
    """The segment's elements in order; an input may be a scalar or an
    already collected list (a stored row merged again), which is
    flattened; a retracted element removes its first match."""
    vals = []
    for i in range(lo, hi):
        if not ok_sorted[i]:
            continue
        x = v_sorted[i]
        items = list(x) if isinstance(x, (list, tuple)) else [x]
        if retract[i]:
            for item in items:
                if item in vals:
                    vals.remove(item)
        else:
            vals.extend(items)
    if distinct:
        seen = []
        for x in vals:
            if x not in seen:
                seen.append(x)
        vals = seen
    return vals


def _merge_map_segment(v_sorted, ok_sorted, retract, lo, hi):
    """Dict union in (key, seq) order; a null input keeps the accumulator;
    a retracted map removes its keys."""
    acc = None
    for i in range(lo, hi):
        if not ok_sorted[i]:
            continue
        m = v_sorted[i]
        if retract[i]:
            if acc:
                for key in dict(m):
                    acc.pop(key, None)
            continue
        if acc is None:
            acc = dict(m)
        else:
            acc.update(m)
    return acc, acc is not None


def _row_key(row, nested_key):
    if isinstance(row, dict):
        return tuple(row.get(f) for f in nested_key)
    return tuple(row)  # the whole row when no key is configured


def _nested_update_segment(v_sorted, ok_sorted, retract, lo, hi, nested_key):
    """ARRAY<ROW> upsert: the rows concatenated in order; under a nested
    key a key keeps its first position and its last row; a retracted row
    removes its key's rows (or, without a key, its first equal row)."""
    acc = None
    for i in range(lo, hi):
        if not ok_sorted[i]:
            continue
        rows = v_sorted[i] or []
        if retract[i]:
            if acc:
                if nested_key:
                    dead = {_row_key(r, nested_key) for r in rows}
                    acc = [r for r in acc if _row_key(r, nested_key) not in dead]
                else:
                    for r in rows:
                        if r in acc:
                            acc.remove(r)
            continue
        if acc is None:
            acc = list(rows)
        else:
            acc.extend(rows)
    if acc is not None and nested_key:
        by_key = {}
        for r in acc:
            by_key[_row_key(r, nested_key)] = r  # the last row, at the key's first position
        acc = list(by_key.values())
    return acc, acc is not None


# ---------------------------------------------------------------------------
# the engine's entry points
# ---------------------------------------------------------------------------


def _signs(row_kind: np.ndarray, spec: AggregateSpec, dtype) -> tuple[np.ndarray, np.ndarray]:
    """(sign, include) per input row under the retract rules."""
    retract = np.isin(row_kind, (int(RowKind.UPDATE_BEFORE), int(RowKind.DELETE)))
    if spec.ignore_retract:
        return np.ones(len(row_kind), dtype=dtype), ~retract
    if spec.function in _RETRACTABLE:
        return np.where(retract, -1, 1).astype(dtype), np.ones(len(row_kind), dtype=np.bool_)
    if retract.any():
        raise ValueError(
            f"aggregate function {spec.function!r} cannot retract; "
            f"use ignore-retract or an input without -U/-D rows"
        )
    return np.ones(len(row_kind), dtype=dtype), np.ones(len(row_kind), dtype=np.bool_)


def _padded(arr: np.ndarray, m: int, fill, dev: torch.device) -> torch.Tensor:
    out = np.full(m, fill, dtype=arr.dtype)
    out[: len(arr)] = arr
    return torch.from_numpy(out).to(dev)


def _result(values: torch.Tensor, any_valid: torch.Tensor, k: int, dtype) -> Column:
    out = values[:k].cpu().numpy().astype(dtype, copy=False)
    av = any_valid[:k].cpu().numpy()
    return Column(out, av if not av.all() else None)


def aggregate_merge(
    plan: MergePlan,
    column: Column,
    spec: AggregateSpec,
    row_kind: np.ndarray,
    device: "str | torch.device" = "cuda",
) -> Column:
    """Aggregate one value column over the plan's segments. Returns a Column
    of plan.num_segments rows (key order)."""
    m, k = plan.m, plan.num_segments
    valid = column.valid_mask()
    fn = spec.function
    dev = resolve_device(device)

    if fn in ("listagg",) + NESTED_AGGREGATORS:
        return _host_aggregate(plan, column.values, valid, spec, row_kind)

    if fn == "primary-key":
        # always the latest arrival, null or not, retract rows included
        src = _Sorted.of_plan(plan, dev).pick(_padded(np.ones(len(column), np.bool_), m, False, dev), last=True)
        return gather_column(column, src[:k].cpu().numpy())

    sign, include = _signs(row_kind, spec, column.dtype if column.dtype != np.dtype(object) else np.int64)
    eff_valid = valid & include

    if fn in _PICK_FNS:
        # *_value picks may land on a null row; *_non_null_value needs a
        # valid one. Both leave retract rows out under ignore-retract. A
        # code-backed column's pick gathers its codes (gather_column).
        candidate = eff_valid if "non_null" in fn else include
        src = _Sorted.of_plan(plan, dev).pick(_padded(candidate, m, False, dev), last=fn.startswith("last"))
        return gather_column(column, src[:k].cpu().numpy())

    values = column.values
    if values.dtype == np.dtype(object):
        raise ValueError(f"aggregate {fn!r} unsupported for string/bytes columns")

    if fn in ("bool_and", "bool_or"):
        agg, any_valid = _Sorted.of_plan(plan, dev).extreme(
            _padded(values.astype(np.int8), m, 0, dev), _padded(eff_valid, m, False, dev), fn == "bool_or"
        )
        return _result(agg, any_valid, k, np.bool_)

    if fn in ("max", "min", "sum") and values.dtype == np.float64 and _f64_on_device_unsupported():
        out, av = _host_reduce(plan, values, eff_valid, fn, sign if fn == "sum" else None)
        return Column(out.astype(values.dtype, copy=False), av if not av.all() else None)
    if fn in ("max", "min"):
        agg, any_valid = _Sorted.of_plan(plan, dev).extreme(
            _padded(values, m, 0, dev), _padded(eff_valid, m, False, dev), fn == "max"
        )
    elif fn == "sum":
        agg, any_valid = _Sorted.of_plan(plan, dev).sum(
            _padded(values, m, 0, dev), _padded(eff_valid, m, False, dev), _padded(sign, m, 1, dev)
        )
    elif fn == "count":
        agg, _ = _Sorted.of_plan(plan, dev).sum(
            _padded(np.ones(len(values), np.int64), m, 0, dev),
            _padded(eff_valid, m, False, dev),
            _padded(sign.astype(np.int64), m, 1, dev),
        )
        return Column(agg[:k].cpu().numpy())  # count of nothing is 0, not null
    elif fn == "product":
        out, av = _product_host(plan, values, eff_valid)
        return Column(out.astype(values.dtype, copy=False), av if not av.all() else None)
    else:
        raise ValueError(f"unknown aggregate function {fn!r}; known: {AGGREGATORS}")
    return _result(agg, any_valid, k, values.dtype)


def fused_routable(specs: list[AggregateSpec], columns: list[Column]) -> bool:
    """True when every column can run inside the single fused call: numeric
    reductions and first/last picks. product and listagg stay on the host."""
    f64_off_device = _f64_on_device_unsupported()
    for spec, col in zip(specs, columns):
        if spec.function in _PICK_FNS:
            continue
        if spec.function not in _DEVICE_FNS:
            return False
        if col.dtype == np.dtype(object):
            return False
        if f64_off_device and col.dtype == np.float64 and spec.function != "count":
            return False
    return True


def fused_aggregate(
    key_lanes: np.ndarray,
    seq_lanes: np.ndarray | None,
    columns: list[Column],
    specs: list[AggregateSpec],
    row_kind: np.ndarray,
    compress: bool | None = None,
    engine: str = "xla",
    device: "str | torch.device" = "cuda",
) -> tuple[list[Column], np.ndarray]:
    """Aggregation in one device trip: lanes and value columns go up once,
    sort + segment (K1 or K2 under engine "pallas") and every column's
    reduction run on the device, and only the k results per column and the
    k winning rows come back. Returns (columns in key order, last_take)."""
    klp, slp, pad, n, k, s, m, _ = prepare_lanes_planned(key_lanes, seq_lanes, compress=compress)
    dev = resolve_device(device)
    klt, slt = upload_lanes(klp, dev), upload_lanes(slp, dev)
    padt = upload_lanes([pad], dev)[0]
    pad_sorted, perm, seg_start, keep_last, seg_id = sorted_segments(k, s, klt, slt, padt, engine=engine)
    order = _Sorted(perm, seg_start, seg_id)
    packed, count = pack_selected(keep_last & (pad_sorted == hk.FLIP_ZERO), perm)
    kk = int(count)
    result: list[Column] = []
    for spec, col in zip(specs, columns):
        fn = spec.function
        sign, include = _signs(row_kind, spec, col.dtype if col.dtype != np.dtype(object) else np.int64)
        valid = col.valid_mask()
        if fn in _PICK_FNS:
            candidate = (valid & include) if "non_null" in fn else include
            src = order.pick(_padded(candidate, m, False, dev), last=fn.startswith("last"))
            result.append(gather_column(col, src[:kk].cpu().numpy()))
        elif fn == "count":
            agg, _ = order.sum(
                _padded(np.ones(n, np.int64), m, 0, dev),
                _padded(valid & include, m, False, dev),
                _padded(sign.astype(np.int8), m, 1, dev),
            )
            result.append(Column(agg[:kk].cpu().numpy()))  # count of nothing is 0
        elif fn in ("bool_and", "bool_or"):
            agg, any_valid = order.extreme(
                _padded(col.values.astype(np.int8), m, 0, dev), _padded(valid & include, m, False, dev), fn == "bool_or"
            )
            result.append(_result(agg, any_valid, kk, np.bool_))
        elif fn == "sum":
            agg, any_valid = order.sum(
                _padded(col.values, m, 0, dev), _padded(valid & include, m, False, dev),
                _padded(sign.astype(np.int8), m, 1, dev),
            )
            result.append(_result(agg, any_valid, kk, col.values.dtype))
        else:
            agg, any_valid = order.extreme(
                _padded(col.values, m, 0, dev), _padded(valid & include, m, False, dev), fn == "max"
            )
            result.append(_result(agg, any_valid, kk, col.values.dtype))
    return result, packed[:kk].cpu().numpy()


# ---------------------------------------------------------------------------
# the SQL GROUP BY segment-reduce
# ---------------------------------------------------------------------------

_SEGMENT_REDUCE_FNS = ("sum", "count", "min", "max")


def segment_reduce(
    key_lanes: np.ndarray,
    columns: list[tuple[np.ndarray, np.ndarray | None]],
    fns: tuple[str, ...],
    pos: np.ndarray | None = None,
    engine: str = "xla",
    compress: bool | None = None,
    device: "str | torch.device" = "cuda",
):
    """Segment-reduce `columns` (each (values, valid or None)) over the
    groups keyed by the rows of `key_lanes` ((n, K) uint32), with fns[i] in
    sum|count|min|max for column i. Returns (rep, outs, anyv, first_pos),
    groups in key order: rep[g] one input row of group g, outs[i][g] column
    i's reduction over g (invalid rows contribute the identity), anyv[i][g]
    whether any row of g was valid for column i, first_pos[g] the minimum
    `pos` (default: the row index) over g.

    Engine "numpy", an empty input and a single group (no key lane left
    after compression) take the exact host twin, as in the JAX package; the
    other engines run on `device`, float64 included (the JAX package moves
    float64 to the host only on a TPU)."""
    n = int(key_lanes.shape[0])
    if pos is None:
        pos = np.arange(n, dtype=np.int64)
    vals = [(v, np.ones(n, np.bool_) if ok is None else ok) for v, ok in columns]
    if engine == "numpy" or n == 0:
        return segment_reduce_np(key_lanes, vals, fns, pos)
    klp, _, pad, _, k, _, m, _ = prepare_lanes_planned(key_lanes, None, compress=compress)
    if k == 0:
        return segment_reduce_np(key_lanes, vals, fns, pos)
    dev = resolve_device(device)
    sql_metrics().counter("rows_reduced_device").inc(n)
    klt = upload_lanes(klp, dev)
    padt = upload_lanes([pad], dev)[0]
    pad_sorted, perm, seg_start, _, seg_id = sorted_segments(k, 0, klt, [], padt, engine=engine)
    order = _Sorted(perm, seg_start, seg_id)
    outs, anyv = [], []
    for (v, ok), fn in zip(vals, fns):
        vt, okt = _padded(v, m, 0, dev), _padded(ok, m, False, dev)
        if fn in ("sum", "count"):
            agg, any_valid = order.sum(vt, okt, torch.ones(m, dtype=torch.int8, device=dev))
        elif fn in ("min", "max"):
            agg, any_valid = order.extreme(vt, okt, fn == "max")
        else:
            raise ValueError(f"unknown segment-reduce function {fn!r}; known: {_SEGMENT_REDUCE_FNS}")
        outs.append(agg)
        anyv.append(any_valid)
    first_pos = segment_extreme(_padded(pos.astype(np.int64, copy=False), m, np.iinfo(np.int64).max, dev)[order.p],
                                order.idx, largest=False)
    packed, count = pack_selected(seg_start & (pad_sorted == hk.FLIP_ZERO), perm)
    g = int(count)
    return (
        packed[:g].cpu().numpy(),
        [o[:g].cpu().numpy().astype(v.dtype, copy=False) for o, (v, _) in zip(outs, vals)],
        [a[:g].cpu().numpy() for a in anyv],
        first_pos[:g].cpu().numpy(),
    )


def segment_reduce_np(key_lanes: np.ndarray, columns: list[tuple[np.ndarray, np.ndarray]], fns: tuple[str, ...],
                      pos: np.ndarray):
    """The exact host twin of segment_reduce: lexsort and reduceat, the same
    output contract (groups in key order)."""
    n = int(key_lanes.shape[0])
    if n == 0:
        return (
            np.zeros(0, np.int64),
            [np.zeros(0, v.dtype) for v, _ in columns],
            [np.zeros(0, np.bool_) for _ in columns],
            np.zeros(0, np.int64),
        )
    kk = key_lanes.shape[1]
    order = np.lexsort(tuple(key_lanes[:, i] for i in range(kk - 1, -1, -1)))
    sk = key_lanes[order]
    neq = (sk[1:] != sk[:-1]).any(axis=1) if n > 1 else np.zeros(0, np.bool_)
    starts = np.flatnonzero(np.concatenate([[True], neq]))
    outs, anyv = [], []
    for (v, ok), fn in zip(columns, fns):
        vs, oks = v[order], ok[order]
        if fn in ("sum", "count"):
            outs.append(np.add.reduceat(np.where(oks, vs, np.zeros((), v.dtype)), starts))
        elif fn == "max":
            fill = np.finfo(v.dtype).min if v.dtype.kind == "f" else np.iinfo(v.dtype).min
            outs.append(np.maximum.reduceat(np.where(oks, vs, fill), starts))
        else:
            fill = np.finfo(v.dtype).max if v.dtype.kind == "f" else np.iinfo(v.dtype).max
            outs.append(np.minimum.reduceat(np.where(oks, vs, fill), starts))
        anyv.append(np.maximum.reduceat(oks.astype(np.int8), starts) > 0)
    return order[starts], outs, anyv, np.minimum.reduceat(pos[order], starts)
