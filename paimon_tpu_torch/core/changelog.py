"""Changelog production: the diff of two key-sorted states as -D, -U/+U and
+I rows (port of paimon_tpu/core/changelog.py).

The input producer needs nothing here: its flush writes the raw input as
changelog files (core/writer.py). The full-compaction producer diffs a
compaction's new top level against the previous one (core/compact.py), and
the lookup producer a bucket's state before a flush against the state after
it (core/writer.py); both call full_compaction_changelog, a vectorised
merge of the two sides by their key lanes.
"""

from __future__ import annotations

import numpy as np

from ..data.keys import encode_key_lanes_with_pools
from ..types import RowKind
from .kv import KVBatch

__all__ = ["full_compaction_changelog", "state_changelog"]


def state_changelog(before: KVBatch, after: KVBatch, key_names, row_deduplicate: bool = True) -> KVBatch:
    """full_compaction_changelog of two states, their key lanes encoded
    with one pool per string key over both sides."""
    lanes = encode_key_lanes_with_pools(KVBatch.concat([before, after]).data, key_names)
    return full_compaction_changelog(
        before, after, lanes[: before.num_rows], lanes[before.num_rows :], row_deduplicate=row_deduplicate
    )


def full_compaction_changelog(
    before: KVBatch,
    after: KVBatch,
    key_lanes_before: np.ndarray,
    key_lanes_after: np.ndarray,
    row_deduplicate: bool = True,
) -> KVBatch:
    """Diff two key-sorted sides with unique keys, whose key lanes rank
    against the same string pools: -D for the keys that vanished, a -U/+U
    pair for each key on both sides (under row_deduplicate only where the
    row changed), +I for the new keys, in that order."""
    vb = _lane_view(key_lanes_before)
    va = _lane_view(key_lanes_after)
    safe = np.minimum(np.searchsorted(vb, va), max(len(vb) - 1, 0))
    has_prev = vb[safe] == va if len(vb) else np.zeros(len(va), dtype=np.bool_)
    safe_a = np.minimum(np.searchsorted(va, vb), max(len(va) - 1, 0))
    still_there = va[safe_a] == vb if len(va) else np.zeros(len(vb), dtype=np.bool_)
    parts: list[KVBatch] = []
    if not still_there.all():
        parts.append(_with_kind(before.filter(~still_there), RowKind.DELETE))
    if has_prev.any():
        old_rows = before.take(safe[has_prev])
        new_rows = after.filter(has_prev)
        changed = _rows_differ(old_rows, new_rows) if row_deduplicate else np.ones(old_rows.num_rows, np.bool_)
        if changed.any():
            parts.append(_with_kind(old_rows.filter(changed), RowKind.UPDATE_BEFORE))
            parts.append(_with_kind(new_rows.filter(changed), RowKind.UPDATE_AFTER))
    if not has_prev.all():
        parts.append(_with_kind(after.filter(~has_prev), RowKind.INSERT))
    return KVBatch.concat(parts) if parts else after.slice(0, 0)


def _with_kind(kv: KVBatch, kind: RowKind) -> KVBatch:
    return KVBatch(kv.data, kv.seq, np.full(kv.num_rows, int(kind), dtype=np.uint8))


def _lane_view(lanes: np.ndarray) -> np.ndarray:
    """(n, K) uint32 lanes -> (n,) byte strings ordered as the lane tuples
    (big-endian lanes, compared bytewise)."""
    if lanes.shape[1] == 0:
        return np.zeros(len(lanes), dtype="V4")
    be = np.ascontiguousarray(lanes.astype(">u4"))
    return be.view(f"V{be.shape[1] * 4}").ravel()


def _rows_differ(a: KVBatch, b: KVBatch) -> np.ndarray:
    """A row changed where some field's validity differs or both values
    are valid and differ; the bytes of a null slot do not count. Where
    both sides carry dictionary codes and one is code-backed, the two
    pools unify once and the remapped codes compare."""
    from ..ops.dicts import cache_usable, remap_codes, unify_pools

    out = np.zeros(a.num_rows, dtype=np.bool_)
    for name in a.data.schema.field_names:
        ca, cb = a.data.column(name), b.data.column(name)
        ok_a, ok_b = ca.valid_mask(), cb.valid_mask()
        if cache_usable(ca) and cache_usable(cb) and (ca.is_code_backed or cb.is_code_backed):
            _, (ra, rb) = unify_pools([ca.dict_cache[0], cb.dict_cache[0]])
            neq = remap_codes(ra, ca.dict_cache[1]) != remap_codes(rb, cb.dict_cache[1])
            out |= (neq & ok_a & ok_b) | (ok_a != ok_b)
            continue
        va, vb = ca.values, cb.values
        if va.dtype == np.dtype(object):
            neq = np.fromiter((x != y for x, y in zip(va, vb)), dtype=np.bool_, count=len(va))
        else:
            neq = va != vb
        out |= (neq & ok_a & ok_b) | (ok_a != ok_b)
    return out
