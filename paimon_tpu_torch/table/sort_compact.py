"""Sort-compaction: rewrite an append table clustered by a space-filling
curve (port of paimon_tpu/table/sort_compact.py; the mesh's range shuffle
is not ported).

Each bucket's rows, read in (min_sequence_number, file_name) order, are
encoded as key lanes over the named columns (a string column by its rank
in the bucket's pool, built from the codes when the column is code-backed
under merge.dict-domain: the same pool, so the same permutation), mapped
to z-order or Hilbert codes (ops/zorder.py) or kept as they are (order),
and stably sorted by those lanes: through merge_plan under the table's
sort-engine, so sort-engine=pallas takes K1 when the padded bucket passes
`fusable` and the library sort plus K2 otherwise, and sort-engine=numpy a host lexsort with the same permutation.
The sorted rows are written as level-0 files and committed as one COMPACT
snapshot under identifier (1 << 63) - 3. Unlike the JAX package, the rows
the bucket's deletion vectors mark are dropped: the COMPACT commit drops
the vectors of the files it rewrote, so the JAX package's rewrite brings
deleted rows back.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Sequence

import numpy as np

from ..core.deletionvectors import DeletionVectorsIndexFile
from ..core.kv import KVBatch
from ..core.manifest import CommitMessage, ManifestCommittable
from ..core.read import read_live
from ..data.keys import encode_key_lanes, exact_string_pool, lexsort_rows
from ..ops.merge import merge_plan
from ..ops.zorder import hilbert_lanes, z_order_lanes
from ..options import CoreOptions, SortEngine
from ..types import STRING_ROOTS

if TYPE_CHECKING:
    from . import FileStoreTable

__all__ = ["sort_compact", "SORT_COMPACT_IDENTIFIER"]

SORT_COMPACT_IDENTIFIER = (1 << 63) - 3


def _spread_var_length(lanes: np.ndarray, columns: Sequence[str], pools: dict, contrib: int, kv: KVBatch) -> None:
    """zorder.var-length-contribution under 4 bytes: a string column's dense
    ranks are spread over the 32-bit lane and cut to its top
    contribution * 8 bits, in place."""
    keep_bits = max(1, contrib * 8)
    for ci, c in enumerate(columns):
        if kv.data.schema.field(c).type.root in STRING_ROOTS and len(pools.get(c, ())):
            scale = np.uint64(0x100000000) // np.uint64(max(len(pools[c]), 1))
            spread = (lanes[:, ci].astype(np.uint64) * scale).astype(np.uint32)
            lanes[:, ci] = spread & np.uint32(~np.uint32((1 << (32 - keep_bits)) - 1))


def _measured_row_bytes(kv: KVBatch) -> float:
    """sort-compaction.range-strategy=size: bytes a row from the columns'
    own sizes, strings by the length of the first 4096 values."""
    n = kv.num_rows
    total = 0.0
    for col in kv.data.columns.values():
        if col.values.dtype == np.dtype(object):
            sample = col.values[: min(n, 4096)]
            total += sum(len(str(v)) for v in sample) * (n / max(len(sample), 1))
        else:
            total += col.values.nbytes
    return total / max(n, 1)


def sort_compact(
    table: "FileStoreTable",
    columns: Sequence[str],
    order: str = "zorder",
    commit_identifier: int | None = None,
) -> int:
    """Rewrite every bucket clustered by `columns` under `order` (zorder,
    hilbert or order); returns the rows rewritten. Append tables only: a
    primary-key table is already clustered by its key."""
    if table.is_primary_key_table:
        raise ValueError("sort-compact applies to append-only tables (PK tables are key-clustered)")
    if order not in ("zorder", "hilbert", "order"):
        raise ValueError(f"unknown sort order {order!r}")
    store = table.store
    opts = store.options
    plan = store.new_scan().plan()
    engine = store.merge_executor().effective_sort_engine()
    kernel_engine = "pallas" if engine == SortEngine.PALLAS else "xla"
    contrib = int(opts.options.get(CoreOptions.ZORDER_VAR_LENGTH_CONTRIBUTION))
    by_size = str(opts.options.get(CoreOptions.SORT_COMPACTION_RANGE_STRATEGY)).lower() == "size"
    dv_file = DeletionVectorsIndexFile(table.file_io, table.path)
    messages: list[CommitMessage] = []
    total = 0
    for partition, buckets in plan.grouped().items():
        for bucket, files in buckets.items():
            rf = store.reader_factory(partition, bucket)
            dvs = dv_file.read_all(plan.dv_index_for(partition, bucket))
            ordered = sorted(files, key=lambda f: (f.min_sequence_number, f.file_name))
            kv = KVBatch.concat([read_live(rf, f, dvs) for f in ordered])
            if kv.num_rows == 0:
                continue
            pools = {
                c: exact_string_pool([kv.data.column(c)])
                for c in columns
                if kv.data.schema.field(c).type.root in STRING_ROOTS
            }
            lanes = encode_key_lanes(kv.data, columns, pools)
            if order in ("zorder", "hilbert") and contrib < 4:
                _spread_var_length(lanes, columns, pools, contrib, kv)
            if order == "zorder":
                lanes = z_order_lanes(lanes)
            elif order == "hilbert":
                lanes = hilbert_lanes(lanes)
            if engine == SortEngine.NUMPY:
                perm = lexsort_rows(lanes)
            else:
                # stable: ties keep the order the rows were read in
                p = merge_plan(lanes, compress=opts.lane_compression, engine=kernel_engine, device=store.device)
                perm = p.perm[p.valid_sorted]
            sorted_kv = kv.take(perm)
            after = store.writer_factory(partition, bucket).write(
                sorted_kv,
                level=0,
                file_source="compact",
                measured_row_bytes=_measured_row_bytes(sorted_kv) if by_size else None,
            )
            messages.append(
                CommitMessage(partition, bucket, max(opts.bucket, 1), compact_before=list(files), compact_after=after)
            )
            total += kv.num_rows
    if messages:
        ident = commit_identifier if commit_identifier is not None else SORT_COMPACT_IDENTIFIER
        store.new_commit().commit(ManifestCommittable(ident, messages=messages))
    return total
