"""Merge-engine orchestration over the device kernels (port of
paimon_tpu/core/mergefn.py, the deduplicate engine).

One MergeExecutor call feeds every same-key group through the deduplicate
merge function at once: encode keys into lanes, select each key's last
(key, seq) row on the device, gather on the host. The partial-update,
aggregation and first-row engines are not ported yet and raise
NotImplementedError.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..data.keys import encode_key_lanes, lexsort_rows, split_int64_lanes
from ..options import CoreOptions, MergeEngine, SortEngine
from ..types import RowKind, RowType
from .kv import KVBatch

__all__ = ["MergeExecutor"]


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
        if engine != MergeEngine.DEDUPLICATE:
            raise NotImplementedError(f"merge-engine={engine.value} is not supported by the torch port yet")
        self.value_schema = value_schema
        self.key_names = list(key_names)
        self.engine = engine
        self.options = options or CoreOptions()
        self.device = torch.device(device)
        if self.options.sequence_field:
            raise NotImplementedError("sequence.field is not supported by the torch port yet")

    @property
    def _compress(self) -> bool:
        return self.options.lane_compression

    def effective_sort_engine(self) -> SortEngine:
        """The table's sort-engine (default xla-segmented = plain torch ops)."""
        return SortEngine(self.options.sort_engine)

    def _backend(self) -> str:
        return "pallas" if self.effective_sort_engine() == SortEngine.PALLAS else "xla"

    def _key_lanes(self, kv: KVBatch) -> np.ndarray:
        return encode_key_lanes(kv.data, self.key_names)

    def _seq_lanes(self, kv: KVBatch, seq_ascending: bool) -> np.ndarray | None:
        """Explicit sequence-number lanes, only when input order does not
        already encode them (stability of the sort covers that case)."""
        if seq_ascending:
            return None
        hi, lo = split_int64_lanes(kv.seq)
        return np.stack([hi, lo], axis=1)

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
        """One output row per key, key-sorted; the winning row keeps its
        RowKind. seq_ascending=True asserts that equal keys appear in
        ascending sequence order in the input."""
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
        if self._strictly_increasing(lanes):
            # already key-sorted with unique keys: dedup is the identity
            return ("sync", kv)
        seq_lanes = self._seq_lanes(kv, seq_ascending)
        if self.effective_sort_engine() == SortEngine.NUMPY:
            return ("sync", kv.take(_numpy_dedup_select(lanes, seq_lanes, self._compress)))
        from ..ops.merge import deduplicate_select_async

        handle = deduplicate_select_async(lanes, seq_lanes, self._backend(), self._compress, self.device)
        return ("dedup", handle, kv)

    def merge_resolve(self, handle) -> KVBatch:
        if handle[0] == "sync":
            return handle[1]
        from ..ops.merge import deduplicate_resolve

        _, h, kv = handle
        return kv.take(deduplicate_resolve(h))

    def supports_keys_only_pipeline(self) -> bool:
        """Merge needs only (key columns, seq, kind) to pick winners: the read
        path can dispatch the kernel before value columns decode."""
        return not self.options.ignore_delete

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
