"""Parquet reader and writer on numpy alone (port of
paimon_tpu/format/parquet.py's native decoder and encoder routes).

`read_parquet` decodes one file through decode/ (`read_native`): the
chunk statistics and, on dictionary-encoded chunks, the dictionary codes
decide under a predicate which row groups and pages expand, and under
`dict_domain` (merge.dict-domain) dictionary-encoded chunks come back as
code-backed columns. `write_parquet` encodes one batch through encode/,
with the writer options parquet.page-size, parquet.row-group.rows,
file.block-size, parquet.enable.dictionary and parquet.data-page-version.

Envelope, both directions: flat columns, and ARRAY, MAP and ROW columns in
pyarrow's layout (three-level LIST, MAP key_value, plain groups), their
leaves' repetition and definition levels RLE-hybrid; a nested column's
leaves are never pruned on, and its records never split across pages or
row groups; physical types BOOLEAN, INT32, INT64, FLOAT, DOUBLE and
BYTE_ARRAY (UTF8 or raw); REQUIRED or OPTIONAL leaves; PLAIN, dictionary (PLAIN dictionary page + RLE/bit-packed codes)
and DELTA_BINARY_PACKED integer encodings; data pages v1 and v2; codecs
UNCOMPRESSED, SNAPPY, GZIP, ZSTD and LZ4_RAW (file.compression=lz4; the
port's own snappy, zstd and lz4 codecs and zlib, utils/compression.py). It
reads the files pyarrow and the JAX package write with those codecs, and
both read the files it writes. Any other codec (lzo, brotli), on read or
as file.compression on write, raises NotImplementedError naming
file.compression.
"""

from __future__ import annotations

from ..data.batch import ColumnBatch
from ..decode import read_native
from ..decode.container import ParquetFormatError
from ..encode import WRITE_CODECS, encode_parquet_bytes
from ..types import RowType

__all__ = ["read_parquet", "write_parquet", "ParquetFormatError", "WRITE_CODECS"]


def read_parquet(data: bytes, schema: RowType, projection, predicate=None, dict_domain: bool = False,
                 pool_limit: int | None = None) -> list[ColumnBatch]:
    """Decode the projected columns of one file: one ColumnBatch per row
    group, rows in file order. Under a predicate, row groups whose chunk
    statistics cannot match are skipped, and rows whose dictionary codes
    fail a value conjunct are dropped; which rows are left depends on the
    predicate alone, so two reads of one file under one predicate return
    the same rows whatever they project."""
    return read_native(data, schema, projection, predicate, dict_domain, pool_limit)


def write_parquet(batch: ColumnBatch, compression: str = "none", format_options: dict | None = None) -> bytes:
    """One ColumnBatch -> complete parquet file bytes, every page compressed
    by `compression` (a key of WRITE_CODECS). Every leaf is OPTIONAL but a
    map's key, as the JAX package's writers make them."""
    return encode_parquet_bytes(batch, compression, format_options)
