"""The Parquet container on numpy alone: footer, column chunks, pages,
codecs and chunk statistics (port of paimon_tpu/decode/container.py).

Envelope: flat columns and nested groups (the three-level LIST, MAP and
plain groups pyarrow writes; `read_footer` keeps each top-level group's
tree with every leaf's column path and maximum repetition and definition
levels, and a layout outside these, such as a two-level list, raises
ParquetFormatError naming it); physical types BOOLEAN, INT32, INT64,
FLOAT, DOUBLE and BYTE_ARRAY (UTF8 or raw); data pages v1 and v2; codecs UNCOMPRESSED, SNAPPY, GZIP, ZSTD and LZ4_RAW (the
port's own snappy, zstd and lz4 codecs and zlib, utils/compression.py).
Any other codec (lzo, brotli, the Hadoop-framed LZ4 that the JAX package
does not read either) raises NotImplementedError naming file.compression;
a malformed file or a feature outside the envelope raises
ParquetFormatError.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from ..format import FieldStats
from ..format.thrift import ThriftError, read_struct
from ..types import STRING_ROOTS, DataType, TypeRoot
from ..utils.compression import gzip_decompress, lz4_decompress, snappy_decompress, zstd_decompress

__all__ = [
    "ParquetFormatError",
    "ChunkInfo",
    "SchemaNode",
    "Footer",
    "read_footer",
    "parse_footer",
    "iter_pages",
    "decompress_page",
    "chunk_field_stats",
    "physical_type",
]

MAGIC = b"PAR1"

# parquet.thrift enums
T_BOOLEAN, T_INT32, T_INT64, T_INT96, T_FLOAT, T_DOUBLE, T_BYTE_ARRAY, T_FLBA = range(8)
ENC_PLAIN, ENC_PLAIN_DICTIONARY, ENC_RLE, ENC_DELTA_BINARY_PACKED, ENC_RLE_DICTIONARY = 0, 2, 3, 5, 8
PAGE_DATA, PAGE_INDEX, PAGE_DICTIONARY, PAGE_DATA_V2 = 0, 1, 2, 3
REQUIRED, OPTIONAL, REPEATED = 0, 1, 2
# ConvertedType and LogicalType (a union: the set field's id) of the nested groups
CONVERTED_MAP, CONVERTED_MAP_KEY_VALUE, CONVERTED_LIST = 1, 2, 3
LOGICAL_MAP, LOGICAL_LIST = 2, 3
CODEC_NONE, CODEC_SNAPPY, CODEC_GZIP, CODEC_ZSTD, CODEC_LZ4_RAW = 0, 1, 2, 6, 7
CODEC_NAMES = {1: "snappy", 2: "gzip", 3: "lzo", 4: "brotli", 5: "lz4", 6: "zstd", 7: "lz4_raw"}
# codec -> (bytes, expected size) -> decompressed bytes
DECOMPRESSORS = {CODEC_SNAPPY: snappy_decompress, CODEC_GZIP: gzip_decompress, CODEC_ZSTD: zstd_decompress,
                 CODEC_LZ4_RAW: lz4_decompress}

PLAIN_DTYPES = {T_INT32: np.dtype("<i4"), T_INT64: np.dtype("<i8"), T_FLOAT: np.dtype("<f4"), T_DOUBLE: np.dtype("<f8")}


class ParquetFormatError(ValueError):
    """Malformed file, or a feature outside the port's Parquet envelope."""


def codec_error(codec: int) -> NotImplementedError:
    name = CODEC_NAMES.get(codec, f"codec {codec}")
    return NotImplementedError(
        f"parquet {name} compression cannot be decoded by the torch port "
        f"(file.compression={name}); it reads file.compression=zstd, snappy, gzip, lz4 or none"
    )


def physical_type(dtype: DataType) -> int:
    root = dtype.root
    if root == TypeRoot.BOOLEAN:
        return T_BOOLEAN
    if root in (TypeRoot.TINYINT, TypeRoot.SMALLINT, TypeRoot.INT, TypeRoot.DATE, TypeRoot.TIME):
        return T_INT32
    if root in (TypeRoot.BIGINT, TypeRoot.TIMESTAMP, TypeRoot.TIMESTAMP_LTZ, TypeRoot.DECIMAL):
        return T_INT64
    if root == TypeRoot.FLOAT:
        return T_FLOAT
    if root == TypeRoot.DOUBLE:
        return T_DOUBLE
    if root in STRING_ROOTS:
        return T_BYTE_ARRAY
    raise NotImplementedError(f"type {root} has no parquet mapping in the torch port")


def is_utf8(dtype: DataType) -> bool:
    return dtype.root in (TypeRoot.CHAR, TypeRoot.VARCHAR)


@dataclass(frozen=True)
class ChunkInfo:
    name: str  # the column's name; a nested leaf's dotted column path
    physical: int
    codec: int
    num_values: int  # level entries: rows in a flat column
    max_def: int
    start: int
    size: int
    has_dictionary: bool
    stats: dict | None = None  # the chunk's Statistics struct, as thrift fields
    max_rep: int = 0


@dataclass
class SchemaNode:
    """One element of a nested column's schema tree. `def_level` is the
    definition level at which the element is present (the OPTIONAL and
    REPEATED elements from the column down to it), `rep_level` the
    repeated ones; a leaf's are its chunk's maxima."""

    name: str
    repetition: int
    path: str
    def_level: int
    rep_level: int
    physical: int | None = None
    annotation: str | None = None  # "LIST" or "MAP" on an annotated group
    children: list = field(default_factory=list)

    @property
    def is_leaf(self) -> bool:
        return self.physical is not None

    def leaves(self) -> list:
        return [self] if self.is_leaf else [leaf for c in self.children for leaf in c.leaves()]


@dataclass
class Footer:
    row_groups: list  # [(row count, {column name or leaf path: ChunkInfo})]
    nested: dict  # {top-level group name: SchemaNode}
    # the top-level columns in file order: (name, SchemaElement as thrift
    # fields), the element None for a group
    columns: list = field(default_factory=list)
    key_value_metadata: dict = field(default_factory=dict)  # {key: value bytes}


def _annotation(elem: dict) -> str | None:
    converted, logical = elem.get(6), elem.get(10) or {}
    if converted == CONVERTED_LIST or LOGICAL_LIST in logical:
        return "LIST"
    if converted in (CONVERTED_MAP, CONVERTED_MAP_KEY_VALUE) or LOGICAL_MAP in logical:
        return "MAP"
    return None


def _schema_node(elems: list, i: int, parent: SchemaNode | None) -> tuple[SchemaNode, int]:
    """The element at index i and its subtree (depth first), and the index
    after it."""
    elem = elems[i]
    rep = elem.get(3, REQUIRED)
    name = elem[4].decode("utf-8")
    d = (parent.def_level if parent else 0) + (rep != REQUIRED)
    r = (parent.rep_level if parent else 0) + (rep == REPEATED)
    node = SchemaNode(name, rep, f"{parent.path}.{name}" if parent else name, d, r, annotation=_annotation(elem))
    n_children = elem.get(5) or 0
    if not n_children:
        node.physical = elem.get(1)
        return node, i + 1
    i += 1
    for _ in range(n_children):
        if i >= len(elems):
            raise ParquetFormatError("schema elements end inside a group")
        child, i = _schema_node(elems, i, node)
        node.children.append(child)
    return node, i


def read_footer(data: bytes) -> Footer:
    """The row groups' column chunks and the trees of the nested columns."""
    if len(data) < 12 or data[:4] != MAGIC or data[-4:] != MAGIC:
        raise ParquetFormatError("not a parquet file (bad magic)")
    meta_len = struct.unpack_from("<I", data, len(data) - 8)[0]
    meta_start = len(data) - 8 - meta_len
    if meta_start < 4:
        raise ParquetFormatError("footer length exceeds file")
    try:
        fmd, _ = read_struct(data, meta_start)
    except ThriftError as e:
        raise ParquetFormatError(f"footer parse: {e}") from e
    elems = fmd.get(2) or []
    if not elems:
        raise ParquetFormatError("no schema elements")
    levels: dict[str, tuple[int, int]] = {}  # column name or leaf path -> (max def, max rep)
    nested: dict[str, SchemaNode] = {}
    columns: list[tuple[str, dict | None]] = []
    i = 1
    for _ in range(elems[0].get(5) or 0):
        if i >= len(elems):
            raise ParquetFormatError("schema elements end inside the root")
        elem = elems[i]
        node, i = _schema_node(elems, i, None)
        columns.append((node.name, elem if node.is_leaf else None))
        if node.is_leaf:
            if node.repetition == REPEATED:
                raise ParquetFormatError(f"column {node.name!r}: a repeated primitive (legacy list) layout")
            levels[node.name] = (node.def_level, 0)
        else:
            nested[node.name] = node
            levels.update({leaf.path: (leaf.def_level, leaf.rep_level) for leaf in node.leaves()})
    if i != len(elems):
        raise ParquetFormatError(f"{len(elems) - i} schema elements outside the root")
    groups = []
    for rg in fmd.get(4) or []:
        cols: dict[str, ChunkInfo] = {}
        for cc in rg.get(1) or []:
            md = cc[3]
            name = ".".join(p.decode("utf-8") for p in md[3])
            if name not in levels:
                raise ParquetFormatError(f"column chunk {name!r} has no schema element")
            data_off = md[9]
            dict_off = md.get(11)
            has_dict = dict_off is not None and 0 < dict_off < data_off
            start = dict_off if has_dict else data_off
            max_def, max_rep = levels[name]
            cols[name] = ChunkInfo(name, md[1], md.get(4, 0), md[5], max_def, start, md[7], has_dict, md.get(12),
                                   max_rep)
        groups.append((rg[3], cols))
    kv = {e[1].decode("utf-8", "replace"): e.get(2, b"") for e in fmd.get(5) or [] if 1 in e}
    return Footer(groups, nested, columns, kv)


def parse_footer(data: bytes) -> list[tuple[int, dict[str, ChunkInfo]]]:
    """[(row count, {column name: ChunkInfo})] per row group; a nested
    column's leaves are keyed by their dotted column paths."""
    return read_footer(data).row_groups


def decompress_page(chunk: ChunkInfo, kind: int, hdr: dict, payload: memoryview) -> memoryview:
    """A page's payload as the encodings see it. The codec compresses a v1
    data page or a dictionary page whole; a v2 data page keeps its level
    bytes raw and compresses the rest only when is_compressed (default
    true)."""
    if chunk.codec == CODEC_NONE:
        return payload
    size, levels = hdr[2], 0
    if kind == PAGE_DATA_V2:
        dh = hdr[8]
        if not dh.get(7, True):
            return payload
        levels = dh.get(5, 0) + dh.get(6, 0)
        if not 0 <= levels <= min(len(payload), size):
            raise ParquetFormatError(f"column {chunk.name}: v2 page levels of {levels} bytes")
    try:
        values = DECOMPRESSORS[chunk.codec](payload[levels:], size - levels)
    except ValueError as e:
        raise ParquetFormatError(f"column {chunk.name}: {CODEC_NAMES[chunk.codec]} page: {e}") from e
    if not levels:
        return values
    out = np.empty(size, dtype=np.uint8)
    out[:levels] = np.frombuffer(payload[:levels], dtype=np.uint8)
    out[levels:] = np.frombuffer(values, dtype=np.uint8)
    return memoryview(out)


def iter_pages(data: bytes, chunk: ChunkInfo):
    """(kind, header dict, raw payload) for each dictionary and data page
    of a chunk; the payload is decompressed by decompress_page only when
    the page is decoded, so a skipped page costs its header alone."""
    if chunk.codec != CODEC_NONE and chunk.codec not in DECOMPRESSORS:
        raise codec_error(chunk.codec)
    mv = memoryview(data)
    pos = chunk.start
    end = chunk.start + chunk.size
    seen = 0
    while pos < end and seen < chunk.num_values:
        try:
            hdr, pos = read_struct(data, pos)
        except ThriftError as e:
            raise ParquetFormatError(f"page header parse: {e}") from e
        comp = hdr[3]
        payload = mv[pos : pos + comp]
        pos += comp
        kind = hdr[1]
        if kind == PAGE_DATA:
            seen += hdr[5][1]
        elif kind == PAGE_DATA_V2:
            seen += hdr[8][1]
        elif kind == PAGE_INDEX:
            continue
        elif kind != PAGE_DICTIONARY:
            raise ParquetFormatError(f"page type {kind}")
        yield kind, hdr, payload


def _stat_value(raw: bytes | None, physical: int, dtype: DataType):
    """One min or max of a chunk's statistics, as the port's columns hold
    the value (an int, a float, a bool, a str or bytes)."""
    if raw is None:
        return None
    if physical == T_BYTE_ARRAY:
        return raw.decode("utf-8") if is_utf8(dtype) else bytes(raw)
    if physical == T_BOOLEAN:
        return bool(raw[0]) if raw else None
    np_dtype = PLAIN_DTYPES.get(physical)
    if np_dtype is None or len(raw) != np_dtype.itemsize:
        return None
    return np.frombuffer(raw, dtype=np_dtype)[0].item()


def chunk_field_stats(chunk: ChunkInfo, dtype: DataType, num_rows: int) -> FieldStats | None:
    """A chunk's min_value/max_value/null_count, or None when its writer
    recorded no min and max; an absent null count is unknown."""
    st = chunk.stats or {}
    lo, hi = _stat_value(st.get(6), chunk.physical, dtype), _stat_value(st.get(5), chunk.physical, dtype)
    if lo is None or hi is None:
        return None
    return FieldStats(lo, hi, st.get(3), num_rows)
