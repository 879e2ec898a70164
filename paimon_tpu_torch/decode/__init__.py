"""The native Parquet page-decode subsystem (port of
paimon_tpu/decode/__init__.py).

  container.py — footer, column chunks, pages, codecs, chunk statistics
  kernels.py   — bit-unpack, RLE/bit-packed hybrid, PLAIN, DELTA and the
                 dictionary gather (numpy engine, torch twins)
  pages.py     — page -> column assembly with page skipping; the code-
                 domain read of a dictionary-encoded chunk
  pushdown.py  — compressed-domain predicates: chunk statistics and
                 dictionary codes decide which pages ever expand

`read_native` decodes one file's bytes into one ColumnBatch per surviving
row group, rows in file order. Under `dict_domain` (the table option
merge.dict-domain) a dictionary-encoded STRING/BYTES chunk, or an
INT32/INT64 chunk of an INT, DATE, BIGINT or TIMESTAMP column, comes back
as a code-backed Column: a sorted pool and uint32 codes, no value per row.
A dictionary past `pool_limit`, or a chunk with a PLAIN page, expands as
before (counted in dict{fallback_expanded}).
"""

from __future__ import annotations

import time

from ..data.batch import Column, ColumnBatch
from ..metrics import decode_metrics, dict_metrics
from ..types import STRING_ROOTS, RowType, TypeRoot
from .container import T_BYTE_ARRAY, T_INT32, T_INT64, ParquetFormatError, parse_footer
from .pages import chunk_codes, decode_chunk
from .pushdown import row_group_keep_mask

__all__ = ["read_native", "ParquetFormatError"]

# fixed-width roots whose dictionary chunks read in the code domain, by
# the physical type their chunks must have
_FIXED_CODE_ROOTS = {
    TypeRoot.TINYINT: T_INT32,
    TypeRoot.SMALLINT: T_INT32,
    TypeRoot.INT: T_INT32,
    TypeRoot.DATE: T_INT32,
    TypeRoot.TIME: T_INT32,
    TypeRoot.BIGINT: T_INT64,
    TypeRoot.TIMESTAMP: T_INT64,
    TypeRoot.TIMESTAMP_LTZ: T_INT64,
}


def read_native(data: bytes, schema: RowType, projection, predicate=None, dict_domain: bool = False,
                pool_limit: int | None = None) -> list[ColumnBatch]:
    """The projected columns of one file: one ColumnBatch per row group the
    predicate leaves, rows in file order. Which rows are left depends on
    the predicate alone, never on the projection."""
    from ..ops.dicts import resolve_pool_limit

    metrics = decode_metrics()
    t0 = time.perf_counter()
    limit = resolve_pool_limit(pool_limit)
    read_schema = schema.project(projection)
    out = []
    for num_rows, cols in parse_footer(data):
        if num_rows == 0:
            continue
        for f in read_schema.fields:
            if f.name not in cols:
                raise ParquetFormatError(f"column {f.name!r} not in file")
        tp = time.perf_counter()
        code_cache = {} if dict_domain else None
        keep = row_group_keep_mask(data, cols, num_rows, predicate, schema, metrics, code_cache)
        metrics.histogram("pushdown_ms").update((time.perf_counter() - tp) * 1000)
        if keep is False:
            continue
        columns = {}
        for f in read_schema.fields:
            col = None
            if dict_domain:
                col = _code_domain_column(data, cols[f.name], f, num_rows, keep, limit, code_cache, metrics)
            if col is None:
                values, validity = decode_chunk(data, cols[f.name], f.type, num_rows, keep, metrics)
                if keep is not None:
                    values = values[keep]
                    validity = None if validity is None else validity[keep]
                col = Column(values, validity)
            columns[f.name] = col
        out.append(ColumnBatch(read_schema, columns))
    metrics.counter("files_native").inc()
    metrics.histogram("file_ms").update((time.perf_counter() - t0) * 1000)
    return out


def _code_domain_column(data, chunk, f, num_rows, keep, limit, code_cache, metrics):
    """One chunk as a code-backed Column, or None for the expanded path."""
    from ..ops.dicts import remap_codes, sort_dictionary

    root = f.type.root
    if root in STRING_ROOTS:
        if chunk.physical != T_BYTE_ARRAY:
            return None
    elif _FIXED_CODE_ROOTS.get(root) != chunk.physical:
        return None
    if not chunk.has_dictionary:
        return None
    g = dict_metrics()
    got = chunk_codes(data, chunk, f.type, num_rows, keep, metrics, reuse=code_cache.get(f.name))
    if got is None:
        g.counter("fallback_expanded").inc(num_rows)
        return None
    dictionary, codes, validity = got
    if root not in STRING_ROOTS:
        np_dtype = f.type.numpy_dtype()
        if dictionary.dtype != np_dtype:
            dictionary = dictionary.astype(np_dtype)
    if len(dictionary) > limit:
        g.counter("fallback_expanded").inc(num_rows)
        return None
    pool, remap = sort_dictionary(dictionary)
    codes = remap_codes(remap, codes)
    if keep is not None:
        codes = codes[keep]
        validity = None if validity is None else validity[keep]
    g.counter("rows_code_domain").inc(len(codes))
    return Column.from_codes(pool, codes, validity)
