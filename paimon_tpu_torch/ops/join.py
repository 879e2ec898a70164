"""Skew-aware equi-joins over uint32 key lanes: hash and sort-merge (port of
paimon_tpu/ops/join.py).

A join has the shape of a merge: the key columns of both sides become
order- and equality-preserving uint32 lanes (data/keys.py; string and
bytes keys rank against one pool built over both sides), one global
LanePlan over both sides truncates and packs them (ops/lanes.py), and the
pairs come from one of two cores:

  * hash, for a key packed into one operand: the build lane sorted once,
    every probe value binary-searched (`_hash_probe`, torch.sort(stable)
    and torch.searchsorted on the caller's device; the JAX package's XLA
    program `_hash_probe_fn`);
  * sort-merge, for wider keys: build and probe rows stacked with a side
    lane as the sequence lane, one stable sort through ops/merge.py
    `_merge_plan_padded`, so build rows lead each key's segment. Under
    engine "pallas" that sort is the hand Hopper kernels: K1 for padded
    sizes that pass `fusable` (up to 2^18 rows), else the stock stable sort
    and K2.

Engines: "numpy" (host lexsort and searchsorted), "xla" (plain torch ops)
and "pallas" (the hand kernels for the sort-merge core); all give the
same pairs. `resolve_join_engine` reads join.engine: below join.device-rows
the auto engine stays on the host, above it takes the table's sort-engine
flavour. The JAX package's environment overrides and its switch to the
host on a CPU platform are not copied: the device is the caller's.

Skew: when the probe side splits into partitions (join.chunk-rows, or
join.partitions), a key holding at least join.skew-factor of the fair
per-partition probe share is dealt round-robin over every partition with
its build rows copied to each (`join{skew_keys, skew_split_rows}`).

`JoinIndex` caches a build side for repeated probes (lookup tables and
point gets): build lanes encoded once, folded to <= 64-bit codes, sorted
once; each probe batch pays one searchsorted on the host. A probe value
absent from the build's pool or lane range is masked, never a false match.

Output pairs are probe-major, build rows ascending within a probe row, as
a host nested loop gives them. NULL keys never match: an inner join drops
them, a left join keeps the probe row unmatched.

The code domain (merge.dict-domain): a key column pair whose two sides
both carry dictionary codes matches on them, the two pools unified and
both code vectors remapped (ops/dicts.py), no value expanded; such a join
counts in `join{code_domain_joins}` and its result's `code_domain_cols`.
A pair past merge.dict-domain.pool-limit takes the expanded branch.
`materialize_join` keeps code-backed columns code-backed, and JoinIndex
ranks a coded build column and probes a coded probe column through their
pools. Not ported: the distributed partition executor of the SQL cluster.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np
import torch

from ..data.keys import _fixed_lanes, _pool_and_ranks, _ranks_from_cache, exact_string_pool, pool_positions
from ..ops.dicts import cache_usable, remap_codes, resolve_pool_limit, unify_pools
from ..metrics import join_metrics
from ..types import STRING_ROOTS, DataField, RowType, TypeRoot
from ..utils import resolve_device
from .lanes import apply_plan, lane_stats, plan_lanes_from_stats, plan_lanes_global, resolve_compress

__all__ = [
    "JoinError",
    "JoinResult",
    "JoinIndex",
    "join_batches",
    "materialize_join",
    "resolve_join_engine",
]


class JoinError(ValueError):
    pass


def _opt(options, key: str, default):
    """A join option from a CoreOptions, an Options, a plain str -> str
    mapping (hints) or None, parsed like `default`."""
    if options is None:
        return default
    data = getattr(options, "options", options)  # CoreOptions -> Options
    data = getattr(data, "_data", data)  # Options -> dict
    v = data.get(key)
    if v is None:
        return default
    if isinstance(default, bool):
        return str(v).strip().lower() in ("1", "on", "true")
    if isinstance(default, int):
        return int(v)
    if isinstance(default, float):
        return float(v)
    return str(v)


def resolve_join_engine(options=None, rows: int = 0) -> str:
    """'numpy' | 'xla' | 'pallas' from join.engine. Under 'auto' a join of
    fewer than join.device-rows rows (both sides) stays on the host; a
    larger one takes the device flavour of sort-engine ('pallas' for the
    hand kernels, else 'xla')."""
    choice = str(_opt(options, "join.engine", "auto")).strip().lower()
    if choice in ("xla", "xla-segmented"):
        return "xla"
    if choice in ("numpy", "pallas"):
        return choice
    if rows < _opt(options, "join.device-rows", 4096):
        return "numpy"
    return "pallas" if str(_opt(options, "sort-engine", "")).strip().lower() == "pallas" else "xla"


# ---------------------------------------------------------------------------
# key encoding: the key columns of both sides -> comparable uint32 lanes
# ---------------------------------------------------------------------------


@dataclass
class _EncodedKeys:
    left: np.ndarray  # (n_l, L) uint32
    right: np.ndarray  # (n_r, L) uint32
    left_live: np.ndarray  # bool: a non-null key, which may match
    right_live: np.ndarray
    code_domain_cols: int = 0  # key columns matched on dictionary codes


def _shared_ranks(cols) -> tuple[list[np.ndarray], np.ndarray]:
    """(one uint32 lane per column, pool) of string key columns: the present
    values of every column ranked in one sort against their sorted distinct
    values (join keys may be null, unlike merge keys). A null slot gets rank
    0, the rank of pool[0], the JAX package's null filler: the live masks
    keep it from matching."""
    valid = [c.valid_mask() for c in cols]
    pool, ranks = _pool_and_ranks(np.concatenate([c.values[v] for c, v in zip(cols, valid)]))
    lanes, at = [], 0
    for c, v in zip(cols, valid):
        lane = np.zeros(len(c), dtype=np.uint32)
        n = int(v.sum())
        lane[v] = ranks[at : at + n]
        lanes.append(lane)
        at += n
    return lanes, pool


def _pool_slots(pool: np.ndarray, col) -> tuple[np.ndarray, np.ndarray]:
    """(lane, found) of a probe string column against a build pool: each
    present value's index in the pool, and whether it is there at all. One
    sort of pool and values together instead of an object searchsorted; a
    row not found (or null) gets lane 0, and its mask keeps it from
    matching, so the pairs are the JAX package's. A probe column carrying
    codes locates its own pool's entries and gathers through the codes."""
    valid = col.valid_mask()
    if cache_usable(col):
        ppool, codes = col.dict_cache
        if len(ppool) == 0:
            return np.zeros(len(col), dtype=np.uint32), np.zeros(len(col), dtype=np.bool_)
        entry = pool_positions(pool, ppool)
        idx = entry.take(np.minimum(codes, len(ppool) - 1).astype(np.int64))
        return np.maximum(idx, 0).astype(np.uint32), valid & (idx >= 0)
    idx = pool_positions(pool, col.values[valid])
    lane = np.zeros(len(col), dtype=np.uint32)
    lane[valid] = np.maximum(idx, 0)
    found = np.zeros(len(col), dtype=np.bool_)
    found[valid] = idx >= 0
    return lane, found


def _try_code_domain(lc, rc, limit) -> tuple[np.ndarray, np.ndarray] | None:
    """One key column pair on its dictionary codes: both sides carry codes
    -> unify the two pools and remap both code vectors. (left lane, right
    lane) as uint32, or None for the expanded branch."""
    if not (cache_usable(lc) and cache_usable(rc)):
        return None
    lp, lcodes = lc.dict_cache
    rp, rcodes = rc.dict_cache
    cap = resolve_pool_limit(limit)
    if len(lp) + len(rp) > cap:
        return None
    unified, (lmap, rmap) = unify_pools([lp, rp])
    if len(unified) > cap:
        return None
    return remap_codes(lmap, lcodes), remap_codes(rmap, rcodes)


def _stack(lanes: list[np.ndarray], n: int) -> np.ndarray:
    if not lanes:
        return np.zeros((n, 0), dtype=np.uint32)
    return np.stack(lanes, axis=1).astype(np.uint32, copy=False)


def _encode_join_keys(left, right, left_keys, right_keys, pool_limit=None) -> _EncodedKeys:
    """Lanes for the key columns of both sides in one space: equal lane
    tuples are equal key tuples, string ranks taken against one pool over
    both sides (the JAX package's lanes, from one sort instead of three),
    or, where both sides carry dictionary codes, the codes remapped into
    their unified pool."""
    if len(left_keys) != len(right_keys) or not left_keys:
        raise JoinError(f"key arity mismatch: {list(left_keys)} vs {list(right_keys)}")
    n_l, n_r = left.num_rows, right.num_rows
    left_live = np.ones(n_l, dtype=np.bool_)
    right_live = np.ones(n_r, dtype=np.bool_)
    lanes_l: list[np.ndarray] = []
    lanes_r: list[np.ndarray] = []
    code_cols = 0
    for lname, rname in zip(left_keys, right_keys):
        lf, rf = left.schema.field(lname), right.schema.field(rname)
        if lf.type.root != rf.type.root:
            raise JoinError(f"join key type mismatch: {lname} is {lf.type.root}, {rname} is {rf.type.root}")
        lc, rc = left.column(lname), right.column(rname)
        if lc.validity is not None:
            left_live &= lc.validity
        if rc.validity is not None:
            right_live &= rc.validity
        coded = _try_code_domain(lc, rc, pool_limit)
        if coded is not None:
            lanes_l.append(coded[0])
            lanes_r.append(coded[1])
            code_cols += 1
            continue
        root = lf.type.root
        if root in STRING_ROOTS:
            (lane_l, lane_r), pool = _shared_ranks([lc, rc])
            if len(pool) == 0:  # every key null on both sides: nothing matches
                left_live &= False
                right_live &= False
            lanes_l.append(lane_l)
            lanes_r.append(lane_r)
        else:
            lanes_l.extend(_fixed_lanes(lc, root))
            lanes_r.extend(_fixed_lanes(rc, root))
    return _EncodedKeys(_stack(lanes_l, n_l), _stack(lanes_r, n_r), left_live, right_live, code_cols)


# ---------------------------------------------------------------------------
# cores: hash probe (one operand) and sort-merge (several)
# ---------------------------------------------------------------------------


def _hash_probe(build_lane: np.ndarray, probe_lane: np.ndarray, device: torch.device):
    """The torch form of `_hash_probe_fn`: stable-sort the padded build
    lane (pad rows hold 0xFFFFFFFF and sort last), binary-search every probe
    value, and clip the hit range to the n_r real rows so a real key equal
    to the pad value never counts a pad row. The sort key is one int64,
    (pad << 32) | lane, which orders uint32 on every device. Returns
    (order, lo, counts) on the host, int64."""
    from .merge import pad_size

    n_r, n_l = len(build_lane), len(probe_lane)
    m_r, m_l = pad_size(n_r), pad_size(n_l)
    blane = np.full(m_r, 0xFFFFFFFF, dtype=np.int64)
    blane[:n_r] = build_lane
    bkey = blane.copy()
    bkey[n_r:] |= np.int64(1) << np.int64(32)
    plane = np.zeros(m_l, dtype=np.int64)
    plane[:n_l] = probe_lane
    bkey_t = torch.from_numpy(bkey).to(device)
    blane_t = torch.from_numpy(blane).to(device)
    plane_t = torch.from_numpy(plane).to(device)
    order = torch.sort(bkey_t, stable=True).indices
    sl = blane_t[order]
    lo = torch.clamp(torch.searchsorted(sl, plane_t, side="left"), max=n_r)
    hi = torch.clamp(torch.searchsorted(sl, plane_t, side="right"), max=n_r)
    return order.cpu().numpy(), lo[:n_l].cpu().numpy(), (hi - lo)[:n_l].cpu().numpy()


def _hash_pairs(ll: np.ndarray, rl: np.ndarray, engine: str, device: torch.device):
    """One-operand core: (probe counts, probe starts, mapping), where
    mapping[sorted position] is a build row and a probe row's matches are
    mapping[start : start + count], build rows ascending."""
    n_l, n_r = ll.shape[0], rl.shape[0]
    lane_l, lane_r = ll[:, 0], rl[:, 0]
    if engine == "numpy" or n_r == 0 or n_l == 0:
        order = np.argsort(lane_r, kind="stable").astype(np.int64)
        dom = int(max(lane_r.max() if n_r else 0, lane_l.max() if n_l else 0)) + 1
        if 0 < dom <= max(1 << 20, 4 * (n_l + n_r)):
            # a dense domain: bincount and its exclusive cumsum address the
            # build rows directly, two gathers instead of two binary searches
            counts_k = np.bincount(lane_r, minlength=dom)
            starts_k = np.concatenate([[0], np.cumsum(counts_k)[:-1]])
            return counts_k[lane_l].astype(np.int64), starts_k[lane_l].astype(np.int64), order
        srt = lane_r[order]
        lo = np.searchsorted(srt, lane_l, side="left")
        hi = np.searchsorted(srt, lane_l, side="right")
        return (hi - lo).astype(np.int64), lo.astype(np.int64), order
    order, lo, counts = _hash_probe(lane_r, lane_l, device)
    return counts.astype(np.int64), lo.astype(np.int64), order.astype(np.int64)


def _sortmerge_pairs(ll: np.ndarray, rl: np.ndarray, engine: str, device: torch.device):
    """Several-operand core through the merge preamble: [build; probe] rows
    sorted by (key lanes, side, input order), segmented by key. Build rows
    lead each segment (side 0 < 1), so a probe row's matches are the first
    build-count slots of its segment. Same contract as _hash_pairs; the
    mapping is the sorted permutation, whose build slots hold build rows."""
    n_r, n_l = rl.shape[0], ll.shape[0]
    n = n_r + n_l
    k = ll.shape[1]
    joint = np.vstack([rl, ll])
    side = np.zeros(n, dtype=np.uint32)
    side[n_r:] = 1
    if engine == "numpy" or n == 0:
        perm = np.lexsort([side] + [joint[:, i] for i in range(k - 1, -1, -1)]).astype(np.int64)
        srt = joint[perm]
        neq = (srt[1:] != srt[:-1]).any(axis=1) if n > 1 else np.zeros(0, dtype=bool)
        seg = np.concatenate([[0], np.cumsum(neq)]).astype(np.int64) if n else np.zeros(0, np.int64)
    else:
        from .merge import _merge_plan_padded

        plan = _merge_plan_padded(joint, side[:, None], None, "pallas" if engine == "pallas" else "xla", device)
        perm = plan.perm[:n].astype(np.int64)  # int32 from the device
        seg = plan.seg_id[:n].astype(np.int64)
    is_left = perm >= n_r
    num_segs = int(seg[-1]) + 1 if n else 0
    seg_start = np.searchsorted(seg, np.arange(num_segs))
    right_count = np.bincount(seg[~is_left], minlength=num_segs) if n else np.zeros(0, np.int64)
    left_slots = np.flatnonzero(is_left)
    left_inputs = perm[left_slots] - n_r
    lsegs = seg[left_slots]
    counts = np.zeros(n_l, dtype=np.int64)
    starts = np.zeros(n_l, dtype=np.int64)
    counts[left_inputs] = right_count[lsegs]
    starts[left_inputs] = seg_start[lsegs]
    return counts, starts, perm


def _expand_pairs(counts: np.ndarray, starts: np.ndarray, mapping: np.ndarray):
    """(probe counts, probe starts into mapping) -> flat (left, right) pairs,
    probe-major, build rows ascending within a probe row."""
    n_l = counts.shape[0]
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    if total <= n_l and counts.max() <= 1:
        # unique build keys (a primary-key dimension): no fan-out
        lt = np.flatnonzero(counts).astype(np.int64)
        return lt, mapping[starts[lt]]
    lt = np.repeat(np.arange(n_l, dtype=np.int64), counts)
    cumex = np.concatenate([[0], np.cumsum(counts)[:-1]])
    offs = np.arange(total, dtype=np.int64) - np.repeat(cumex, counts) + np.repeat(starts, counts)
    return lt, mapping[offs]


def _join_part(ll: np.ndarray, rl: np.ndarray, algorithm: str, engine: str, device: torch.device):
    """Inner join of one partition of live rows: local (lt, rt) pairs."""
    n_l, n_r = ll.shape[0], rl.shape[0]
    if n_l == 0 or n_r == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    if ll.shape[1] == 0:
        # a zero-width key (constant on both sides): the cross product
        return np.repeat(np.arange(n_l, dtype=np.int64), n_r), np.tile(np.arange(n_r, dtype=np.int64), n_l)
    if algorithm == "hash" and ll.shape[1] == 1:
        counts, starts, mapping = _hash_pairs(ll, rl, engine, device)
    else:
        counts, starts, mapping = _sortmerge_pairs(ll, rl, engine, device)
    return _expand_pairs(counts, starts, mapping)


# ---------------------------------------------------------------------------
# skew-aware partitioning
# ---------------------------------------------------------------------------


def _key_ids(left_lanes: np.ndarray, right_lanes: np.ndarray):
    """Dense key ids over both sides: (left ids, right ids, number of keys)."""
    k = left_lanes.shape[1]
    joint = np.ascontiguousarray(np.vstack([left_lanes, right_lanes]))
    if k == 0:
        return np.zeros(left_lanes.shape[0], dtype=np.int64), np.zeros(right_lanes.shape[0], dtype=np.int64), 1
    if k == 1:
        _, inv = np.unique(joint[:, 0], return_inverse=True)
    else:
        _, inv = np.unique(joint.view([("", np.uint32)] * k).ravel(), return_inverse=True)
    inv = inv.astype(np.int64).ravel()
    return inv[: left_lanes.shape[0]], inv[left_lanes.shape[0] :], int(inv.max()) + 1 if len(inv) else 0


@dataclass
class _SkewPlan:
    parts: list[tuple[np.ndarray, np.ndarray]]  # per partition: (probe rows, build rows)
    skew_keys: int = 0
    skew_split_rows: int = 0


def _plan_partitions(left_lanes, right_lanes, live_l, live_r, num_parts: int, skew_factor: float) -> _SkewPlan:
    """Live probe and build rows in num_parts key-disjoint partitions, but
    for heavy keys (at least skew_factor times the fair per-partition probe
    share): their probe rows are dealt round-robin over every partition and
    their build rows copied to each. Build rows whose key has no live probe
    row are dropped: they match under no join type."""
    li = np.flatnonzero(live_l)
    ri = np.flatnonzero(live_r)
    lid, rid, nk = _key_ids(left_lanes[li], right_lanes[ri])
    probe_counts = np.bincount(lid, minlength=max(nk, 1))
    heavy_cut = max(skew_factor * len(li) / max(num_parts, 1), 2.0)
    heavy = probe_counts >= heavy_cut
    if num_parts <= 1:
        heavy[:] = False
    # key -> partition for light keys (Knuth's multiplicative spread)
    key_part = (np.arange(len(probe_counts), dtype=np.uint64) * np.uint64(2654435761)) % np.uint64(num_parts)
    l_heavy = heavy[lid]
    l_part = key_part[lid].astype(np.int64)
    if l_heavy.any():
        l_part[l_heavy] = np.arange(int(l_heavy.sum()), dtype=np.int64) % num_parts
    r_matched = probe_counts[rid] > 0 if len(rid) else np.zeros(0, dtype=bool)
    r_heavy = heavy[rid] & r_matched if len(rid) else np.zeros(0, dtype=bool)
    r_part = key_part[rid].astype(np.int64) if len(rid) else np.zeros(0, np.int64)
    heavy_build = ri[r_heavy]
    parts: list[tuple[np.ndarray, np.ndarray]] = []
    for p in range(num_parts):
        build_p = ri[r_matched & ~r_heavy & (r_part == p)]
        if len(heavy_build):
            build_p = np.sort(np.concatenate([build_p, heavy_build]))
        parts.append((li[l_part == p], build_p))
    return _SkewPlan(parts, skew_keys=int(heavy.sum()), skew_split_rows=int(l_heavy.sum()))


# ---------------------------------------------------------------------------
# the two-batch join
# ---------------------------------------------------------------------------


@dataclass
class JoinResult:
    """Matched pairs, probe-major: left_take ascending (stable), build rows
    ascending within a probe row; right_take -1 where a left join kept an
    unmatched probe row."""

    left_take: np.ndarray
    right_take: np.ndarray
    n_left: int
    n_right: int
    how: str = "inner"
    stats: dict = field(default_factory=dict)

    @property
    def matched(self) -> np.ndarray:
        return self.right_take >= 0

    @property
    def num_rows(self) -> int:
        return len(self.left_take)


def join_batches(
    left,
    right,
    left_keys: Sequence[str],
    right_keys: Sequence[str],
    how: str = "inner",
    options: "Mapping | None" = None,
    engine: str | None = None,
    device: "str | torch.device" = "cuda",
) -> JoinResult:
    """Equi-join two ColumnBatches (left probes, right builds) on aligned
    key lists. how='inner' keeps the matched pairs, how='left' also each
    unmatched probe row once with right_take -1. The device kernels run on
    `device` (CUDA unless the caller asks for the CPU)."""
    if how not in ("inner", "left"):
        raise JoinError(f"unsupported join type {how!r} (inner | left)")
    dev = resolve_device(device)
    g = join_metrics()
    t0 = time.perf_counter()
    pool_limit = _opt(options, "merge.dict-domain.pool-limit", 0) or None
    enc = _encode_join_keys(left, right, list(left_keys), list(right_keys), pool_limit)
    n_l, n_r = left.num_rows, right.num_rows
    engine = engine or resolve_join_engine(options, rows=n_l + n_r)
    comp_opt = _opt(options, "merge.lane-compression", True) if options is not None else None
    if resolve_compress(comp_opt):
        plan = plan_lanes_global([enc.left, enc.right])
        ll, rl = apply_plan(plan, enc.left), apply_plan(plan, enc.right)
    else:
        ll, rl = enc.left, enc.right
    algorithm = _opt(options, "join.algorithm", "auto")
    if algorithm == "auto":
        algorithm = "hash" if ll.shape[1] == 1 else "sort-merge"
    elif algorithm == "hash" and ll.shape[1] != 1:
        algorithm = "sort-merge"  # hash needs one operand
    chunk_rows = _opt(options, "join.chunk-rows", 1 << 20)
    num_parts = _opt(options, "join.partitions", 0)
    if num_parts <= 0:
        num_parts = max(1, -(-n_l // max(chunk_rows, 1)))
    skew_factor = _opt(options, "join.skew-factor", 0.5)
    t_build = time.perf_counter()

    if num_parts > 1:
        plan_p = _plan_partitions(ll, rl, enc.left_live, enc.right_live, num_parts, skew_factor)
        lt_all, rt_all = [], []
        for probe_idx, build_idx in plan_p.parts:
            lt, rt = _join_part(ll[probe_idx], rl[build_idx], algorithm, engine, dev)
            lt_all.append(probe_idx[lt])
            rt_all.append(build_idx[rt])
        lt_g = np.concatenate(lt_all) if lt_all else np.empty(0, np.int64)
        rt_g = np.concatenate(rt_all) if rt_all else np.empty(0, np.int64)
        skew_keys, skew_rows = plan_p.skew_keys, plan_p.skew_split_rows
    else:
        li = np.flatnonzero(enc.left_live)
        ri = np.flatnonzero(enc.right_live)
        if len(li) == n_l and len(ri) == n_r:
            lt_g, rt_g = _join_part(ll, rl, algorithm, engine, dev)
        else:
            lt, rt = _join_part(ll[li], rl[ri], algorithm, engine, dev)
            lt_g, rt_g = li[lt], ri[rt]
        skew_keys = skew_rows = 0

    sorted_already = num_parts == 1  # _expand_pairs gives probe-major order
    if how == "left":
        matched = np.zeros(n_l, dtype=bool)
        matched[lt_g] = True
        miss = np.flatnonzero(~matched)
        if len(miss):
            lt_g = np.concatenate([lt_g, miss])
            rt_g = np.concatenate([rt_g, np.full(len(miss), -1, dtype=np.int64)])
            sorted_already = False
    if not sorted_already:
        order = np.argsort(lt_g, kind="stable")
        lt_g, rt_g = lt_g[order], rt_g[order]
    res = JoinResult(
        left_take=lt_g,
        right_take=rt_g,
        n_left=n_l,
        n_right=n_r,
        how=how,
        stats={
            "algorithm": algorithm,
            "engine": engine,
            "partitions": num_parts,
            "skew_keys": skew_keys,
            "skew_split_rows": skew_rows,
            "code_domain_cols": enc.code_domain_cols,
            "lanes": ll.shape[1],
        },
    )
    g.counter("joins").inc()
    g.counter("rows_probed").inc(n_l)
    g.counter("rows_matched").inc(int(res.matched.sum()))
    g.counter("hash_joins" if algorithm == "hash" else "sort_merge_joins").inc()
    if enc.code_domain_cols:
        g.counter("code_domain_joins").inc()
    if skew_keys:
        g.counter("skew_keys").inc(skew_keys)
        g.counter("skew_split_rows").inc(skew_rows)
    g.histogram("build_ms").update((t_build - t0) * 1000)
    g.histogram("probe_ms").update((time.perf_counter() - t_build) * 1000)
    return res


# ---------------------------------------------------------------------------
# materialization
# ---------------------------------------------------------------------------


def _take_nullable(col, take: np.ndarray, matched: np.ndarray):
    """col.take(take) with the unmatched rows of a left join null; a
    code-backed column gathers its codes."""
    from ..data.batch import Column

    if matched.all():
        return col.take(take)
    if len(col) == 0:  # nothing to gather: every row is an unmatched one
        dt = col.dtype
        vals = np.full(len(take), None, dtype=object) if dt == np.dtype(object) else np.zeros(len(take), dtype=dt)
        return Column(vals, np.zeros(len(take), dtype=np.bool_))
    out = col.take(np.where(matched, take, 0))
    if out.is_code_backed:
        pool, codes = out.dict_cache
        return Column.from_codes(pool, codes, out.valid_mask() & matched)
    return Column(out.values, out.valid_mask() & matched)


def materialize_join(left, right, res: JoinResult, left_cols, right_cols):
    """The joined batch: left_cols / right_cols are (source column, output
    name) pairs; right columns of a left join are null at unmatched rows."""
    from ..data.batch import ColumnBatch

    fields = []
    cols = {}
    for src, out in left_cols:
        fields.append((out, left.schema.field(src).type))
        cols[out] = left.column(src).take(res.left_take)
    matched = res.matched
    for src, out in right_cols:
        fields.append((out, right.schema.field(src).type))
        cols[out] = _take_nullable(right.column(src), res.right_take, matched)
    return ColumnBatch(RowType(DataField(i, n, t) for i, (n, t) in enumerate(fields)), cols)


# ---------------------------------------------------------------------------
# JoinIndex: a cached build side for repeated probes
# ---------------------------------------------------------------------------


class JoinIndex:
    """Built once per refresh, probed many times. The build's key lanes
    encode against build-only pools, pack through the lane planner (no OVC:
    equality only), fold into <= 64-bit codes and sort once. A probe batch
    pays a per-column encode against the cached pools with an exact
    `present` mask, one searchsorted and one host expansion. Keys wider
    than two packed operands keep the batch and join through join_batches
    on `device` per probe."""

    def __init__(self, batch, key_names: Sequence[str], device: "str | torch.device" = "cuda"):
        self.device = resolve_device(device)
        self.batch = batch
        self.key_names = list(key_names)
        self.pools: dict[str, np.ndarray] = {}
        n = batch.num_rows
        live = np.ones(n, dtype=np.bool_)
        lanes: list[np.ndarray] = []
        self._col_lanes: list[tuple[str, TypeRoot, int]] = []  # (name, root, lane count)
        for name in self.key_names:
            col = batch.column(name)
            root = batch.schema.field(name).type.root
            if col.validity is not None:
                live &= col.validity
            if root in STRING_ROOTS:
                if cache_usable(col):
                    # the build's pool from its codes (pruned to the valid
                    # rows), its ranks through one gather
                    pool = exact_string_pool([col])
                    got = [_ranks_from_cache(pool, col.dict_cache, col.validity)]
                else:
                    got, pool = _shared_ranks([col])
                self.pools[name] = pool
                if len(pool) == 0:  # an all-null build column: nothing matches
                    live &= False
            else:
                got = _fixed_lanes(col, root)
            lanes.extend(got)
            self._col_lanes.append((name, root, len(got)))
        self.lanes = _stack(lanes, n)
        self.live = live
        if live.any():
            self.los, self.his = lane_stats(self.lanes if live.all() else self.lanes[live])
        else:  # an empty or all-null build: a plan no probe can match
            k = self.lanes.shape[1]
            self.los = np.zeros(k, dtype=np.uint32)
            self.his = np.zeros(k, dtype=np.uint32)
        self.plan = plan_lanes_from_stats(self.lanes.shape[1], self.los, self.his)
        packed = apply_plan(self.plan, self.lanes)
        self.wide = packed.shape[1] > 2
        if self.wide:
            return
        codes = _fold_codes(packed)
        vi = np.flatnonzero(live)
        order = np.argsort(codes[vi], kind="stable")
        self.row_of = vi[order].astype(np.int64)
        self.sorted_codes = codes[vi][order]

    def _probe_lanes(self, batch, keys: Sequence[str]):
        """(lanes, present): probe lanes in the build's lane space, and a
        mask of the rows that can match (a null key or a string absent from
        the build pool cannot)."""
        n = batch.num_rows
        present = np.ones(n, dtype=np.bool_)
        lanes: list[np.ndarray] = []
        for (bname, root, _cnt), pname in zip(self._col_lanes, keys):
            col = batch.column(pname)
            proot = batch.schema.field(pname).type.root
            if proot != root:
                raise JoinError(f"probe key {pname} is {proot}, index key {bname} is {root}")
            if col.validity is not None:
                present &= col.validity
            if root in STRING_ROOTS:
                pool = self.pools[bname]
                if len(pool) == 0:
                    present &= False
                    lanes.append(np.zeros(n, dtype=np.uint32))
                    continue
                lane, found = _pool_slots(pool, col)
                present &= found
                lanes.append(lane)
            else:
                lanes.extend(_fixed_lanes(col, root))
        return _stack(lanes, n), present

    def probe(self, batch, keys: Sequence[str] | None = None, how: str = "inner") -> JoinResult:
        """Join `batch` (the probe side) against the indexed build side."""
        keys = list(keys) if keys is not None else self.key_names
        if len(keys) != len(self._col_lanes):
            raise JoinError(f"probe key arity {len(keys)} != index arity {len(self._col_lanes)}")
        g = join_metrics()
        n = batch.num_rows
        if self.wide:
            res = join_batches(batch, self.batch, keys, self.key_names, how=how, device=self.device)
            g.counter("index_probes").inc()
            return res
        pl, present = self._probe_lanes(batch, keys)
        # a lane the plan dropped as constant still constrains equality, and
        # a kept lane must lie in the build's range or the shift would wrap:
        # both are provable non-matches
        kept = set(self.plan.keep)
        for i in range(pl.shape[1]):
            lane = pl[:, i]
            if i not in kept:
                present &= lane == self.los[i]
            else:
                present &= (lane >= self.los[i]) & (lane <= self.his[i])
        clipped = np.clip(pl, self.los[None, :], self.his[None, :]) if pl.shape[1] else pl
        codes = _fold_codes(apply_plan(self.plan, clipped))
        lo = np.searchsorted(self.sorted_codes, codes, side="left")
        hi = np.searchsorted(self.sorted_codes, codes, side="right")
        counts = np.where(present, hi - lo, 0).astype(np.int64)
        lt, rt = _expand_pairs(counts, lo.astype(np.int64), self.row_of)
        if how == "left":
            miss = np.flatnonzero(counts == 0)
            lt = np.concatenate([lt, miss])
            rt = np.concatenate([rt, np.full(len(miss), -1, dtype=np.int64)])
            order = np.argsort(lt, kind="stable")
            lt, rt = lt[order], rt[order]
        g.counter("index_probes").inc()
        g.counter("rows_probed").inc(n)
        g.counter("rows_matched").inc(int((rt >= 0).sum()))
        return JoinResult(lt, rt, n, self.batch.num_rows, how=how, stats={"algorithm": "index"})


def _fold_codes(packed: np.ndarray) -> np.ndarray:
    """(n, G <= 2) uint32 -> (n,) uint64 codes, equality kept. G == 0 folds to
    zeros: a constant key matched through the dropped-lane checks alone."""
    n, g = packed.shape
    if g == 0:
        return np.zeros(n, dtype=np.uint64)
    if g == 1:
        return packed[:, 0].astype(np.uint64)
    return (packed[:, 0].astype(np.uint64) << np.uint64(32)) | packed[:, 1].astype(np.uint64)
