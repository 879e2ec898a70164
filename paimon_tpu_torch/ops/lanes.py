"""Key-lane compression: truncation, packing and offset-value codes (port of
paimon_tpu/ops/lanes.py).

The planner is host numpy and identical to the JAX package's: constant
lanes drop, varying lanes min-shift to their exact bit width, adjacent
lanes whose widths sum to <= 32 fuse into one operand, and keys that still
span two or more operands gain a leading offset-value code (OVC) lane. The
code lane is computed on the device by `ovc_codes`, the torch form of
`ovc_codes_jax`; `ovc_codes_np` is the numpy oracle both are held against.

On the device, lanes are int32 tensors holding the order-preserving flip
of the uint32 lane (`u ^ 0x80000000` read as signed), see
ops/hopper_kernels.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "LanePlan",
    "plan_lanes",
    "lane_stats",
    "plan_lanes_from_stats",
    "plan_lanes_global",
    "apply_plan",
    "compress_key_lanes",
    "resolve_compress",
    "ovc_codes_np",
    "ovc_codes",
    "scalar_dedup_winner",
]

# an OVC lane only pays when the packed key is still wide
_OVC_MIN_GROUPS = 2


@dataclass(frozen=True)
class LanePlan:
    """The per-merge compression decision over one (n, K) uint32 matrix:
    kept lanes, their subtracted minimums and bit widths, the packed groups
    (positions into the kept sequence, most significant first) and the
    optional OVC lane coded against `base` with a vbits-wide value field."""

    lanes_in: int
    keep: tuple[int, ...]
    los: tuple[int, ...]
    bits: tuple[int, ...]
    groups: tuple[tuple[int, ...], ...]
    use_ovc: bool = False
    ovc_vbits: int = 0
    base: tuple[int, ...] = ()


def resolve_compress(compress: bool | None) -> bool:
    """merge.lane-compression: the caller's value, default on."""
    return True if compress is None else bool(compress)


def _truncate_and_group(k: int, los, his):
    keep: list[int] = []
    bits: list[int] = []
    lo_kept: list[int] = []
    for i in range(k):
        ptp = int(his[i]) - int(los[i])
        if ptp:
            keep.append(i)
            bits.append(ptp.bit_length())
            lo_kept.append(int(los[i]))
    groups: list[tuple[int, ...]] = []
    cur: list[int] = []
    cur_bits = 0
    for pos, b in enumerate(bits):
        if cur and cur_bits + b > 32:
            groups.append(tuple(cur))
            cur, cur_bits = [], 0
        cur.append(pos)
        cur_bits += b
    if cur:
        groups.append(tuple(cur))
    vbits = max((sum(bits[p] for p in grp) for grp in groups), default=0)
    return keep, bits, lo_kept, groups, vbits


def lane_stats(key_lanes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-lane (min, max); zero rows give the neutral element (max mins,
    zero maxes), which never widens a lane when reduced with others."""
    key_lanes = np.ascontiguousarray(key_lanes)
    n, k = key_lanes.shape
    if n == 0:
        return np.full(k, 0xFFFFFFFF, dtype=np.uint32), np.zeros(k, dtype=np.uint32)
    return key_lanes.min(axis=0), key_lanes.max(axis=0)


def plan_lanes_from_stats(lanes_in: int, los, his) -> LanePlan:
    """Truncation and packing from per-lane (min, max) alone, so several
    inputs planned from one reduction pack comparably. No OVC lane."""
    keep, bits, lo_kept, groups, _vbits = _truncate_and_group(lanes_in, los, his)
    if all(len(grp) == 1 for grp in groups):
        lo_kept = [0] * len(lo_kept)
    return LanePlan(lanes_in, tuple(keep), tuple(lo_kept), tuple(bits), tuple(groups))


def plan_lanes_global(parts) -> LanePlan:
    """One LanePlan over several inputs (both sides of a join): the lane
    stats reduced over all of them, so each input applies the same plan and
    the packed operands compare across inputs."""
    parts = [np.ascontiguousarray(p) for p in parts]
    k = parts[0].shape[1] if parts else 0
    if not parts or all(p.shape[0] == 0 for p in parts):
        return LanePlan(k, (), (), (), ())
    los = his = None
    for p in parts:
        lo, hi = lane_stats(p)
        los = lo if los is None else np.minimum(los, lo)
        his = hi if his is None else np.maximum(his, hi)
    return plan_lanes_from_stats(k, los, his)


def plan_lanes(key_lanes: np.ndarray, enable_ovc: bool = True) -> LanePlan:
    """Truncation, packing and OVC decided from one pass of lane stats."""
    key_lanes = np.ascontiguousarray(key_lanes)
    n, k = key_lanes.shape
    if n <= 1 or k == 0:
        return LanePlan(k, (), (), (), ())
    los, his = key_lanes.min(axis=0), key_lanes.max(axis=0)
    keep, bits, lo_kept, groups, vbits = _truncate_and_group(k, los, his)
    g = len(groups)
    use_ovc = enable_ovc and g >= _OVC_MIN_GROUPS and g.bit_length() + vbits <= 32
    if not use_ovc and all(len(grp) == 1 for grp in groups):
        # nothing fuses and no code needs a bounded value field: the shift
        # would be a pure copy, so apply_plan takes the column-select path
        lo_kept = [0] * len(lo_kept)
    base: tuple[int, ...] = ()
    if use_ovc:
        # the batch's lexicographically minimal row (over kept lanes): a row
        # every input compares >= to, which makes the code order-consistent
        mask = np.ones(n, dtype=np.bool_)
        min_vals: list[int] = []
        for i in keep:
            col = key_lanes[:, i]
            mval = int(col[mask].min())
            mask &= col == np.uint32(mval)
            min_vals.append(mval)
        packed_base = []
        for grp in groups:
            acc = 0
            for pos in grp:
                acc = (acc << bits[pos]) | (min_vals[pos] - lo_kept[pos])
            packed_base.append(acc)
        base = tuple(packed_base)
    return LanePlan(
        k, tuple(keep), tuple(lo_kept), tuple(bits), tuple(groups), use_ovc, vbits if use_ovc else 0, base
    )


def apply_plan(plan: LanePlan, key_lanes: np.ndarray) -> np.ndarray:
    """(n, K) uint32 -> (n, lanes_out) uint32: shift and fuse per the plan."""
    key_lanes = np.ascontiguousarray(key_lanes)
    n = key_lanes.shape[0]
    if all(len(g) == 1 for g in plan.groups) and not any(plan.los):
        if len(plan.groups) == plan.lanes_in:
            return key_lanes.astype(np.uint32, copy=False)
        sel = [plan.keep[g[0]] for g in plan.groups]
        return np.ascontiguousarray(key_lanes[:, sel].astype(np.uint32, copy=False))
    out = np.empty((n, len(plan.groups)), dtype=np.uint32)
    for gi, grp in enumerate(plan.groups):
        first = grp[0]
        acc = key_lanes[:, plan.keep[first]].astype(np.uint32) - np.uint32(plan.los[first])
        for pos in grp[1:]:
            lane = key_lanes[:, plan.keep[pos]].astype(np.uint32) - np.uint32(plan.los[pos])
            acc = (acc << np.uint32(plan.bits[pos])) | lane
        out[:, gi] = acc
    return out


def compress_key_lanes(
    key_lanes: np.ndarray, compress: bool | None = None, enable_ovc: bool = True
) -> tuple[np.ndarray, LanePlan | None]:
    """The seam every consumer calls: (compressed lanes, plan), or the
    input unchanged and None when the layer is off."""
    if not resolve_compress(compress):
        return key_lanes, None
    key_lanes = np.ascontiguousarray(key_lanes)
    plan = plan_lanes(key_lanes, enable_ovc=enable_ovc)
    return apply_plan(plan, key_lanes), plan


def ovc_codes_np(packed: np.ndarray, base, vbits: int) -> np.ndarray:
    """Numpy oracle: (n, G) packed uint32 operands against base (G,) ->
    (n,) uint32 codes ((G - offset) << vbits) | value."""
    packed = np.ascontiguousarray(packed, dtype=np.uint32)
    n, g = packed.shape
    base = np.asarray(base, dtype=np.uint32)
    eq = packed == base[None, :]
    prefix = np.cumprod(eq, axis=1).astype(bool)
    offset = prefix.sum(axis=1).astype(np.int64)
    first_diff = np.minimum(offset, g - 1)
    value = packed[np.arange(n), first_diff]
    value = np.where(offset < g, value, np.uint32(0)).astype(np.uint32)
    return ((np.uint32(g) - offset.astype(np.uint32)) << np.uint32(vbits)) | value


_HALF = 1 << 31


def ovc_codes(lanes, base, vbits: int) -> torch.Tensor:
    """Device form of ovc_codes_np. lanes: G flipped-int32 (m,) tensors;
    base: G unsigned ints. Returns the flipped-int32 code lane. The unsigned
    arithmetic runs in int64, where every uint32 value is exact. Pad rows
    get one shared code; the pad flag leads both sort and boundary test, so
    pad codes never order or split anything."""
    g = len(lanes)
    m = lanes[0].shape[0]
    dev = lanes[0].device
    eq_run = torch.ones(m, dtype=torch.bool, device=dev)
    offset = torch.zeros(m, dtype=torch.int64, device=dev)
    value = torch.zeros(m, dtype=torch.int64, device=dev)
    for j in range(g):
        u = lanes[j].to(torch.int64) + _HALF
        bj = int(base[j]) & 0xFFFFFFFF
        first_diff = eq_run & (u != bj)
        value = torch.where(first_diff, u, value)
        eq_run = eq_run & (u == bj)
        offset = offset + eq_run.to(torch.int64)
    code = (((g - offset) << vbits) | value) & 0xFFFFFFFF
    return (code - _HALF).to(torch.int32)


def scalar_dedup_winner(seq_lanes: np.ndarray | None, n: int) -> np.ndarray:
    """All keys equal: one winner, the last row in (sequence lanes, input
    order). No key sort and no device trip."""
    if n == 0:
        return np.empty(0, dtype=np.int32)
    if seq_lanes is None or seq_lanes.shape[1] == 0:
        return np.array([n - 1], dtype=np.int32)
    order = np.lexsort([seq_lanes[:, i] for i in range(seq_lanes.shape[1] - 1, -1, -1)])
    return order[-1:].astype(np.int32)
