"""The native Parquet page-encode subsystem, the write-side dual of decode/
(port of paimon_tpu/encode/__init__.py and encode/writer.py).

  kernels.py — bit-pack, RLE/bit-packed hybrid, PLAIN, DELTA (numpy
               engine, the torch twin pack_bits_torch)
  pages.py   — column -> dictionary page + data pages + chunk statistics;
               a column carrying dictionary codes writes them as they are

`encode_parquet_bytes` assembles the row groups and the footer. It honours
the writer options the JAX package's native encoder honours:
parquet.page-size (bytes of values per data page, default 1 MiB),
parquet.row-group.rows, file.block-size (bytes per row group, through the
batch's bytes per row; at least 1024 rows), parquet.enable.dictionary and
parquet.data-page-version (1.0 or 2.0). Every leaf is OPTIONAL; the footer
carries TYPE_DEFINED_ORDER for every column, so readers trust the
statistics.
"""

from __future__ import annotations

import struct
import time

from ..data.batch import ColumnBatch
from ..decode.container import CODEC_GZIP, CODEC_NONE, CODEC_SNAPPY, CODEC_ZSTD, MAGIC, physical_type
from ..format.thrift import build_struct
from ..metrics import encode_metrics
from ..types import TypeRoot
from .pages import encode_chunk

__all__ = ["encode_parquet_bytes", "WRITE_CODECS"]

# file.compression values the writer takes -> parquet codec
WRITE_CODECS = {
    "none": CODEC_NONE,
    "uncompressed": CODEC_NONE,
    "zstd": CODEC_ZSTD,
    "snappy": CODEC_SNAPPY,
    "gzip": CODEC_GZIP,
}

_BOOL, _I32, _I64, _BINARY, _LIST, _STRUCT = 1, 5, 6, 8, 9, 12
_CONVERTED_UTF8, _CONVERTED_INT8, _CONVERTED_INT16 = 0, 15, 16
_CREATED_BY = b"paimon_tpu_torch version 1.0.0"

_DEFAULT_PAGE_SIZE = 1 << 20
_DEFAULT_ROW_GROUP_ROWS = 1 << 20


def _converted_type(root: TypeRoot) -> int | None:
    if root in (TypeRoot.CHAR, TypeRoot.VARCHAR):
        return _CONVERTED_UTF8
    if root == TypeRoot.TINYINT:
        return _CONVERTED_INT8
    if root == TypeRoot.SMALLINT:
        return _CONVERTED_INT16
    return None


def _row_group_rows(batch: ColumnBatch, opts: dict) -> int:
    if opts.get("parquet.row-group.rows") is not None:
        return max(1, int(opts["parquet.row-group.rows"]))
    if opts.get("file.block-size") is not None and batch.num_rows:
        from ..options import MemorySize

        per_row = max(1, batch.byte_size() // batch.num_rows)
        return max(1024, int(MemorySize.parse(opts["file.block-size"])) // per_row)
    return _DEFAULT_ROW_GROUP_ROWS


def encode_parquet_bytes(batch: ColumnBatch, compression: str = "none", format_options: dict | None = None) -> bytes:
    """One ColumnBatch -> complete parquet file bytes, every page compressed
    by `compression` (a key of WRITE_CODECS)."""
    codec = WRITE_CODECS.get(str(compression).lower())
    if codec is None:
        raise NotImplementedError(
            f"file.compression={compression} cannot be written by the torch port; "
            f"it writes {', '.join(WRITE_CODECS)}"
        )
    metrics = encode_metrics()
    t0 = time.perf_counter()
    opts = {k: v for k, v in (format_options or {}).items() if v is not None}
    page_size = int(opts.get("parquet.page-size", _DEFAULT_PAGE_SIZE))
    page_v2 = str(opts.get("parquet.data-page-version", "1.0")).strip() in ("2.0", "2")
    enable_dict = str(opts.get("parquet.enable.dictionary", "true")).strip().lower() != "false"
    physicals = {f.name: physical_type(f.type) for f in batch.schema.fields}
    schema_elems = [build_struct([(4, _BINARY, b"schema"), (5, _I32, len(batch.schema.fields))])]
    for f in batch.schema.fields:
        schema_elems.append(
            build_struct(
                [(1, _I32, physicals[f.name]), (3, _I32, 1), (4, _BINARY, f.name), (6, _I32, _converted_type(f.type.root))]
            )
        )
    body = bytearray(MAGIC)
    row_groups = []
    n = batch.num_rows
    rg_rows = _row_group_rows(batch, opts)
    for rg_start in range(0, n, rg_rows):
        rg = batch if rg_rows >= n else batch.slice(rg_start, min(rg_start + rg_rows, n))
        chunks = []
        total = 0
        for f in rg.schema.fields:
            chunk = encode_chunk(
                rg.column(f.name), f.type, physicals[f.name], page_size=page_size, page_v2=page_v2,
                enable_dict=enable_dict, codec=codec, metrics=metrics,
            )
            start = len(body)
            for page in chunk.pages:
                body += page
            meta = build_struct(
                [
                    (1, _I32, physicals[f.name]),
                    (2, _LIST, (_I32, list(chunk.encodings))),
                    (3, _LIST, (_BINARY, [f.name])),
                    (4, _I32, codec),
                    (5, _I64, rg.num_rows),
                    (6, _I64, chunk.total_uncompressed),
                    (7, _I64, chunk.total_compressed),
                    (9, _I64, start + chunk.dict_page_len),
                    (11, _I64, start if chunk.dict_page_len else None),
                    (12, _STRUCT, chunk.stats),
                ]
            )
            chunks.append(build_struct([(2, _I64, start), (3, _STRUCT, meta)]))
            total += chunk.total_uncompressed
        row_groups.append(build_struct([(1, _LIST, (_STRUCT, chunks)), (2, _I64, total), (3, _I64, rg.num_rows)]))
    type_order = build_struct([(1, _STRUCT, build_struct([]))])
    footer = build_struct(
        [
            (1, _I32, 2 if page_v2 else 1),
            (2, _LIST, (_STRUCT, schema_elems)),
            (3, _I64, n),
            (4, _LIST, (_STRUCT, row_groups)),
            (6, _BINARY, _CREATED_BY),
            (7, _LIST, (_STRUCT, [type_order] * len(batch.schema.fields))),
        ]
    )
    body += footer
    body += struct.pack("<I", len(footer))
    body += MAGIC
    metrics.counter("files_native").inc()
    metrics.counter("bytes_written").inc(len(body))
    metrics.histogram("encode_ms").update((time.perf_counter() - t0) * 1000)
    return bytes(body)
