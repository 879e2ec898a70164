"""Sort + segment + select: the merge on the device (port of
paimon_tpu/ops/merge.py: the deduplicate, first-row and partial-update
selections).

Coordinates: "input" = row index into the concatenated runs; "sorted" =
position after the sort; `perm` maps sorted -> input. Every device batch is
padded to a power-of-two size m; pad rows carry a set pad flag (the most
significant sort lane), so valid rows occupy sorted slots [0, n).

`sorted_segments` is the shared preamble and the sort-engine seam:
engine "pallas" runs the hand-written Hopper kernels (K1 for batches that
pass `fusable`, else the stock stable lexsort plus K2), engine "xla" runs
plain torch ops. On the device every lane is a flipped int32 tensor (see
ops/hopper_kernels.py); all engines give bit-identical results.

Segment reductions over integers (the partial-update and pick selections)
are torch scatter-reduces by segment id: exact in any order.

Not ported yet: the compact and delta link encodings and the batched tile
program of the JAX package. `deduplicate_tiled_dispatch` and
`fused_partial_update` here always take the plain index download; the
output is the same.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..types import RowKind
from ..utils import resolve_device
from . import hopper_kernels as hk
from .lanes import compress_key_lanes, ovc_codes, resolve_compress, scalar_dedup_winner

__all__ = [
    "MergePlan",
    "merge_plan",
    "pad_size",
    "pad_to",
    "sorted_segments",
    "pack_selected",
    "deduplicate_take",
    "deduplicate_select_async",
    "deduplicate_resolve",
    "deduplicate_select",
    "deduplicate_tiled_dispatch",
    "deduplicate_resolve_tiled",
    "segment_extreme",
    "segment_last_where",
    "first_row_take",
    "partial_update_takes",
    "fused_partial_update",
]

_MIN_PAD = 128


def pad_size(n: int) -> int:
    """Next power of two (>= 128)."""
    p = _MIN_PAD
    while p < n:
        p <<= 1
    return p


def pad_to(arr: np.ndarray, m: int, fill=0) -> np.ndarray:
    out = np.full((m,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


def upload_lanes(cols, device: torch.device) -> list[torch.Tensor]:
    """Host uint lanes -> flipped int32 tensors on the device."""
    return [torch.from_numpy(hk.flip_np(c)).to(device) for c in cols]


def sorted_segments(
    num_key_lanes: int, num_seq_lanes: int, key_lanes, seq_lanes, pad_flag, extra_keys=(), engine: str = "xla"
):
    """One stable lexicographic sort on (pad, extra keys, key lanes, seq
    lanes, input order), then segment detection over (pad, extra keys, key
    lanes) only: sequence lanes order rows within a segment but do not split
    it. Lanes are (m,) flipped int32 tensors (a (L, m) tensor works too).
    Returns (pad_sorted flipped, perm int32, seg_start, keep_last, seg_id).

    extra_keys: order-consistent leading keys (the OVC lane) tested first."""
    m = pad_flag.shape[0]
    boundary = [pad_flag] + list(extra_keys) + [key_lanes[i] for i in range(num_key_lanes)]
    order = [seq_lanes[i] for i in range(num_seq_lanes)]
    if engine == "pallas" and hk.fusable(m, len(boundary) + len(order)):
        return hk.fused_sort_segments(boundary, order)
    perm = hk.lexsort_lanes(boundary + order)
    sorted_boundary = [lane[perm] for lane in boundary]
    dev = pad_flag.device
    if engine == "pallas":
        # large tier: stock stable sort + the K2 boundary sweep (the lanes
        # are flipped, which equality ignores; mask_pad stays off)
        keep_last = hk.keep_last_mask(torch.stack(sorted_boundary), mask_pad=False) != 0
    else:
        neq = torch.zeros(m - 1, dtype=torch.bool, device=dev)
        for lane in sorted_boundary:
            neq |= lane[1:] != lane[:-1]
        keep_last = torch.cat([neq, torch.ones(1, dtype=torch.bool, device=dev)])
    seg_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), keep_last[:-1]])
    seg_id = (torch.cumsum(seg_start.to(torch.int32), 0) - 1).to(torch.int32)
    return sorted_boundary[0], perm.to(torch.int32), seg_start, keep_last, seg_id


def segment_extreme(values: torch.Tensor, seg_idx: torch.Tensor, largest: bool = True) -> torch.Tensor:
    """Per-segment max (or min) of an integer (m,) tensor, indexed by segment
    id; seg_idx is the int64 segment id of each row. An empty segment holds
    the dtype's min (max), as jax.ops.segment_max (segment_min) gives."""
    info = torch.iinfo(values.dtype)
    out = torch.full(values.shape, info.min if largest else info.max, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, seg_idx, values, "amax" if largest else "amin")


def segment_last_where(seg_id: torch.Tensor, masks: torch.Tensor, pos: torch.Tensor | None = None) -> torch.Tensor:
    """Per segment, the last sorted position where each mask row is True (-1
    = none). masks (F, m) bool in sorted coordinates; returns (F, m) int32
    indexed by segment id. The shared core of the partial-update
    selections."""
    m = seg_id.shape[0]
    if pos is None:
        pos = torch.arange(m, dtype=torch.int32, device=seg_id.device)
    idx = seg_id.long()
    out = torch.empty(masks.shape, dtype=torch.int32, device=seg_id.device)
    for f in range(masks.shape[0]):
        out[f] = segment_extreme(torch.where(masks[f], pos, -1), idx)
    return out


def _partial_update_select(perm: torch.Tensor, seg_id: torch.Tensor, field_valid, is_add, is_delete):
    """Per field, each segment's last valid add row after its last delete
    (src, (F, m) input rows by segment id, -1 = none), and whether the
    segment has an add after its last delete (exists, (m,)). field_valid
    (F, m), is_add and is_delete (m,) are bool in input coordinates, padded
    with False. The one core of both partial-update paths."""
    m = perm.shape[0]
    pos = torch.arange(m, dtype=torch.int32, device=perm.device)
    p, idx = perm.long(), seg_id.long()
    add_sorted = is_add[p]
    last_del = segment_extreme(torch.where(is_delete[p], pos, -1), idx)
    eligible = add_sorted & (pos > last_del[idx])
    last_per_field = segment_last_where(seg_id, field_valid[:, p] & eligible, pos)
    src = torch.where(last_per_field >= 0, perm[last_per_field.clamp(0, m - 1).long()], -1)
    last_add = segment_extreme(torch.where(add_sorted, pos, -1), idx)
    return src, last_add > last_del


def _add_delete_masks(row_kind: np.ndarray, remove_record_on_delete: bool) -> tuple[np.ndarray, np.ndarray]:
    """+I/+U rows add; -D rows delete only under remove-record-on-delete
    (-U rows do neither)."""
    is_add = np.isin(row_kind, (int(RowKind.INSERT), int(RowKind.UPDATE_AFTER)))
    if remove_record_on_delete:
        return is_add, row_kind == int(RowKind.DELETE)
    return is_add, np.zeros_like(is_add)


def _upload_mask(mask: np.ndarray, m: int, device: torch.device) -> torch.Tensor:
    """A bool mask (..., n) in input coordinates, padded with False to m."""
    out = np.zeros(mask.shape[:-1] + (m,), dtype=np.bool_)
    out[..., : mask.shape[-1]] = mask
    return torch.from_numpy(out).to(device)


def first_row_take(plan: MergePlan) -> np.ndarray:
    """Input rows of each key's first (key, seq) row, in key order."""
    return plan.perm[plan.seg_start & plan.valid_sorted]


def partial_update_takes(
    plan: MergePlan,
    field_valid: np.ndarray,
    row_kind: np.ndarray,
    remove_record_on_delete: bool = False,
    device: "str | torch.device" = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Partial-update over a plan: per field, its latest non-null value in
    (key, seq) order after the key's last -D. field_valid (F, n) bool. Returns
    src (F, num_segments) input rows (-1 = null) and exists (num_segments,),
    False where remove-record-on-delete removed the key."""
    dev = resolve_device(device)
    is_add, is_delete = _add_delete_masks(row_kind, remove_record_on_delete)
    m = plan.m
    src, exists = _partial_update_select(
        torch.from_numpy(plan.perm).to(dev),
        torch.from_numpy(plan.seg_id).to(dev),
        _upload_mask(field_valid, m, dev),
        _upload_mask(is_add, m, dev),
        _upload_mask(is_delete, m, dev),
    )
    k = plan.num_segments
    return src[:, :k].cpu().numpy(), exists[:k].cpu().numpy()


def fused_partial_update(
    key_lanes: np.ndarray,
    seq_lanes: np.ndarray | None,
    field_valid: np.ndarray,
    row_kind: np.ndarray,
    remove_record_on_delete: bool = False,
    compress: bool | None = None,
    engine: str = "xla",
    device: "str | torch.device" = "cuda",
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Partial-update in one device trip: sort + segment (K1 or K2 under
    engine "pallas") + the field selection, and only (F, k) sources, k
    existence flags and the k winning rows come back. Returns (src, exists,
    last_take) in key order, as merge_plan + partial_update_takes + the
    keep-last takes would. Key lanes go through the compression seam."""
    klp, slp, pad, n, k, s, m, _ = prepare_lanes_planned(key_lanes, seq_lanes, compress=compress)
    dev = resolve_device(device)
    is_add, is_delete = _add_delete_masks(row_kind, remove_record_on_delete)
    klt, slt = upload_lanes(klp, dev), upload_lanes(slp, dev)
    padt = upload_lanes([pad], dev)[0]
    pad_sorted, perm, _, keep_last, seg_id = sorted_segments(k, s, klt, slt, padt, engine=engine)
    src, exists = _partial_update_select(
        perm, seg_id, _upload_mask(field_valid, m, dev), _upload_mask(is_add, m, dev), _upload_mask(is_delete, m, dev)
    )
    packed, count = pack_selected(keep_last & (pad_sorted == hk.FLIP_ZERO), perm)
    kk = int(count)
    return src[:, :kk].cpu().numpy(), exists[:kk].cpu().numpy(), packed[:kk].cpu().numpy()


def pack_selected(sel: torch.Tensor, perm: torch.Tensor):
    """Pack the selected perms to the front (key order) and count them:
    the minimal device -> host transfer. Nothing here waits on the device."""
    order = torch.sort((~sel).to(torch.int32), stable=True).indices
    return perm[order], sel.sum()


def narrow_lane(col: np.ndarray) -> np.ndarray:
    """Min-shift one u32 lane and downcast to u16 when its range strictly
    fits (the dtype max is reserved for the pad sentinel)."""
    if col.size == 0:
        return col
    lo = col.min()
    if int(col.max()) - int(lo) < np.iinfo(np.uint16).max:
        return (col - lo).astype(np.uint16)
    return (col - lo).astype(np.uint32)


def drop_constant_lanes(lanes: np.ndarray) -> np.ndarray:
    """A lane equal everywhere affects neither order nor segmentation."""
    n, k = lanes.shape
    if n <= 1 or k == 0:
        return lanes
    keep = [i for i in range(k) if lanes[0, i] != lanes[-1, i] or (lanes[:, i] != lanes[0, i]).any()]
    if len(keep) == k:
        return lanes
    return lanes[:, keep] if keep else lanes[:, :0]


def prepare_lanes(key_lanes: np.ndarray, seq_lanes: np.ndarray | None, narrow: bool = True):
    """Drop constant lanes, range-narrow each lane, pad rows to the
    power-of-two size with max-sentinel keys and set pad flags. Returns
    (klp, slp, pad, n, num_key, num_seq, m); klp/slp are lists of (m,)
    uint lanes of possibly mixed widths."""
    kl = drop_constant_lanes(np.ascontiguousarray(key_lanes))
    sl = drop_constant_lanes(np.ascontiguousarray(seq_lanes)) if seq_lanes is not None else None
    n, k = kl.shape
    s = 0 if sl is None else sl.shape[1]
    m = pad_size(n)
    key_cols = [narrow_lane(kl[:, i]) if narrow else kl[:, i] for i in range(k)]
    klp = [np.full(m, np.iinfo(c.dtype).max, dtype=c.dtype) for c in key_cols]
    for buf, c in zip(klp, key_cols):
        buf[:n] = c
    seq_cols = [narrow_lane(sl[:, i]) if narrow else sl[:, i] for i in range(s)]
    slp = [np.zeros(m, dtype=c.dtype) for c in seq_cols]
    for buf, c in zip(slp, seq_cols):
        buf[:n] = c
    pad = np.zeros(m, dtype=np.uint8)
    pad[n:] = 1
    return klp, slp, pad, n, k, s, m


def prepare_lanes_planned(key_lanes: np.ndarray, seq_lanes: np.ndarray | None, compress: bool | None = None):
    """prepare_lanes behind the lane-compression seam. Returns
    (klp, slp, pad, n, k, s, m, plan); plan None when the layer is off."""
    import dataclasses

    kl, plan = compress_key_lanes(np.ascontiguousarray(key_lanes), compress)
    klp, slp, pad, n, k, s, m = prepare_lanes(kl, seq_lanes)
    if plan is not None and plan.use_ovc and kl.shape[0]:
        # narrow_lane min-shifts every column: the OVC base shifts with it
        mins = kl.min(axis=0)
        plan = dataclasses.replace(plan, base=tuple(int(b) - int(mn) for b, mn in zip(plan.base, mins)))
    return klp, slp, pad, n, k, s, m, plan


@dataclass
class MergePlan:
    """Sorted view of the concatenated inputs of one merge (numpy, padded
    length m; valid rows occupy sorted slots [0, n))."""

    perm: np.ndarray
    seg_start: np.ndarray
    keep_last: np.ndarray
    seg_id: np.ndarray
    n: int
    m: int

    @property
    def valid_sorted(self) -> np.ndarray:
        return np.arange(self.m) < self.n

    @property
    def num_segments(self) -> int:
        """Segments holding valid rows (pad segments sort after them)."""
        return int(self.seg_id[self.n - 1]) + 1 if self.n else 0


def merge_plan(
    key_lanes: np.ndarray,
    seq_lanes: np.ndarray | None = None,
    compress: bool | None = None,
    engine: str = "xla",
    device: "str | torch.device" = "cuda",
) -> MergePlan:
    """key_lanes (n, K) uint32, seq_lanes (n, S) uint32 ordering within a
    key group. Stable: remaining ties resolve to input order."""
    key_lanes = np.ascontiguousarray(key_lanes)
    seq_keep = drop_constant_lanes(np.ascontiguousarray(seq_lanes)) if seq_lanes is not None else None
    if resolve_compress(compress):
        kl_kept, plan = compress_key_lanes(key_lanes, True)
    else:
        kl_kept, plan = drop_constant_lanes(key_lanes), None
    if kl_kept.shape[1] == 0 and (seq_keep is None or seq_keep.shape[1] == 0):
        return _scalar_plan(key_lanes.shape[0])
    return _merge_plan_padded(kl_kept, seq_keep, plan, engine, resolve_device(device))


def _scalar_plan(n: int) -> MergePlan:
    """Zero-width key, no seq lanes: valid rows form one segment in input
    order and pads another, built on the host."""
    m = pad_size(n)
    perm = np.arange(m, dtype=np.int32)
    seg_start = np.zeros(m, dtype=np.bool_)
    seg_start[0] = True
    keep_last = np.zeros(m, dtype=np.bool_)
    keep_last[m - 1] = True
    if 0 < n < m:
        seg_start[n] = True
        keep_last[n - 1] = True
    seg_id = (np.cumsum(seg_start) - 1).astype(np.int32)
    return MergePlan(perm=perm, seg_start=seg_start, keep_last=keep_last, seg_id=seg_id, n=n, m=m)


def _merge_plan_padded(
    key_lanes: np.ndarray, seq_lanes: np.ndarray | None, plan, engine: str, device: torch.device
) -> MergePlan:
    n, k = key_lanes.shape
    if seq_lanes is None:
        seq_lanes = np.zeros((n, 0), dtype=np.uint32)
    s = seq_lanes.shape[1]
    m = pad_size(n)
    kl = np.full((k, m), 0xFFFFFFFF, dtype=np.uint32)
    kl[:, :n] = key_lanes.T
    sl = np.zeros((s, m), dtype=np.uint32)
    sl[:, :n] = seq_lanes.T
    pad = np.zeros(m, dtype=np.uint32)
    pad[n:] = 1
    klt = upload_lanes(list(kl), device)
    slt = upload_lanes(list(sl), device)
    padt = upload_lanes([pad], device)[0]
    extra = ()
    if plan is not None and plan.use_ovc:
        # unshifted u32 lanes here, so the packed-space base is unshifted too
        extra = (ovc_codes(klt, plan.base, plan.ovc_vbits),)
    _, perm, seg_start, keep_last, seg_id = sorted_segments(k, s, klt, slt, padt, extra, engine=engine)
    return MergePlan(
        perm=perm.cpu().numpy(),
        seg_start=seg_start.cpu().numpy(),
        keep_last=keep_last.cpu().numpy(),
        seg_id=seg_id.cpu().numpy(),
        n=n,
        m=m,
    )


def deduplicate_take(plan: MergePlan) -> np.ndarray:
    """Input rows of each key's last (key, seq) row, in key order."""
    return plan.perm[plan.keep_last & plan.valid_sorted]


def deduplicate_select_async(
    key_lanes: np.ndarray,
    seq_lanes: np.ndarray | None = None,
    backend: str = "xla",
    compress: bool | None = None,
    device: "str | torch.device" = "cuda",
):
    """Dispatch the dedup selection without waiting: returns a handle for
    deduplicate_resolve. The key matrix goes through the lane-compression
    seam; an all-constant key short-circuits to the host scalar winner."""
    klp, slp, pad, n, k, s, m, plan = prepare_lanes_planned(key_lanes, seq_lanes, compress=compress)
    if k == 0:
        return ("scalar", scalar_dedup_winner(seq_lanes, n))
    dev = resolve_device(device)
    klt = upload_lanes(klp, dev)
    slt = upload_lanes(slp, dev)
    padt = upload_lanes([pad], dev)[0]
    extra = ()
    if plan is not None and plan.use_ovc:
        extra = (ovc_codes(klt, plan.base, plan.ovc_vbits),)
    pad_sorted, perm, _, keep_last, _ = sorted_segments(k, s, klt, slt, padt, extra, engine=backend)
    return pack_selected(keep_last & (pad_sorted == hk.FLIP_ZERO), perm)


def deduplicate_resolve(handle) -> np.ndarray:
    if isinstance(handle, tuple) and handle[0] == "scalar":
        return handle[1]
    packed, count = handle
    return packed[: int(count)].cpu().numpy()


def deduplicate_select(
    key_lanes: np.ndarray,
    seq_lanes: np.ndarray | None = None,
    compress: bool | None = None,
    backend: str = "xla",
    device: "str | torch.device" = "cuda",
) -> np.ndarray:
    """Input lanes -> selected input-row indices (key order)."""
    return deduplicate_resolve(deduplicate_select_async(key_lanes, seq_lanes, backend, compress, device))


def _tile_boundaries(lane0_runs: list[np.ndarray], num_tiles: int) -> np.ndarray:
    """Approximate global quantiles of lane 0 from per-run subsamples (each
    run key-sorted); unique boundaries keep every duplicate in one tile."""
    total = sum(len(r) for r in lane0_runs)
    step = max(1, total // 65536)
    sample = np.sort(np.concatenate([r[::step] for r in lane0_runs]))
    cut_idx = np.linspace(0, len(sample) - 1, num_tiles + 1).astype(np.int64)[1:-1]
    return np.unique(sample[cut_idx])


def _gather_tiles(key_lanes, offsets, lane0_runs, boundaries):
    """Cut every run at the key boundaries and concatenate the run slices of
    each tile (run order kept: stability carries the sequence tie-break)."""
    per_run_cuts = [np.searchsorted(lr, boundaries, side="left") for lr in lane0_runs]
    tiles = []
    for t in range(len(boundaries) + 1):
        slices, rows = [], []
        for r, lr in enumerate(lane0_runs):
            lo = 0 if t == 0 else int(per_run_cuts[r][t - 1])
            hi = len(lr) if t == len(boundaries) else int(per_run_cuts[r][t])
            if hi > lo:
                base = offsets[r]
                slices.append(key_lanes[base + lo : base + hi])
                rows.append(np.arange(base + lo, base + hi, dtype=np.int32))
        if slices:
            tiles.append(
                (
                    np.concatenate(slices) if len(slices) > 1 else slices[0],
                    np.concatenate(rows) if len(rows) > 1 else rows[0],
                )
            )
    return tiles


def deduplicate_tiled_dispatch(
    key_lanes: np.ndarray,
    run_offsets: Sequence[int],
    tile_rows: int = 256 * 1024,
    backend: str = "xla",
    compress: bool | None = None,
    device: "str | torch.device" = "cuda",
):
    """Key-range tiled dedup for key-sorted runs concatenated in ascending
    sequence order (run r occupies rows [run_offsets[r], run_offsets[r+1])).
    Tiles cut the key space on lane 0, so every duplicate of a key lands in
    one tile; each tile is dispatched without waiting. One compression plan
    serves the whole merge. Resolve with deduplicate_resolve_tiled."""
    key_lanes = np.ascontiguousarray(key_lanes)
    n = key_lanes.shape[0]
    offsets = list(run_offsets)
    if n == 0:
        return []
    if resolve_compress(compress):
        key_lanes, _ = compress_key_lanes(key_lanes, True)
    else:
        key_lanes = drop_constant_lanes(key_lanes)
    if key_lanes.shape[1] == 0:
        return [(("scalar", scalar_dedup_winner(None, n)), np.arange(n, dtype=np.int32))]
    if n <= tile_rows or len(offsets) < 3:
        handle = deduplicate_select_async(key_lanes, None, backend, compress=False, device=device)
        return [(handle, np.arange(n, dtype=np.int32))]
    lane0_runs = [key_lanes[offsets[r] : offsets[r + 1], 0] for r in range(len(offsets) - 1)]
    num_tiles = max(2, (n + tile_rows - 1) // tile_rows)
    tiles = _gather_tiles(key_lanes, offsets, lane0_runs, _tile_boundaries(lane0_runs, num_tiles))
    return [
        (deduplicate_select_async(tile_lanes, None, backend, compress=False, device=device), tile_global)
        for tile_lanes, tile_global in tiles
    ]


def deduplicate_resolve_tiled(handles) -> np.ndarray:
    out = [rows[deduplicate_resolve(handle)] for handle, rows in handles]
    return np.concatenate(out) if out else np.empty(0, dtype=np.int32)
