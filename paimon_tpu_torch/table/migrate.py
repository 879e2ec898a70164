"""In-place migration: adopt existing Parquet, ORC or Avro files as an
append table (port of paimon_tpu/table/migrate.py), and the schema
inference of the migrate procedures and actions.

migrate_files creates an append table (bucket 1) over a directory of data
files, flat or laid out as `<first partition key>=<value>` directories,
moves the files into the table's buckets under their own names and commits
them as one APPEND snapshot with their row counts and statistics. As in
the JAX package, a partition value is filed as the directory's string,
whatever the partition key's type. adopt_table_files copies the data files
of one append table into another with the same column types, under fresh
names, with their sidecars renamed to match and their sequence numbers
rebased above the target's.

infer_row_type gives the RowType that the JAX package's pyarrow route
(`ColumnBatch.row_type_from_arrow` over pyarrow's schema) gives, from the
Parquet footer (decode/container.py read_footer) or the ORC tail
(format/orc_meta.py read_tail) alone: signed 8-, 16- and 32-bit integers
become TINYINT, SMALLINT and INT, other integers (unsigned ones too)
BIGINT, float FLOAT, double and half floats DOUBLE, dates DATE, timestamps
of any unit TIMESTAMP(), binaries BYTES, decimals of precision 18 or less
DECIMAL(p, s), everything else STRING. In a Parquet file that pyarrow
wrote, the Arrow schema it stores (the ARROW:schema key) turns a duration,
a binary view and a dictionary of binaries into STRING, as pyarrow reports
them; the stored schema is read for those alone.
"""

from __future__ import annotations

import base64
import dataclasses
import struct

from ..catalog import FileSystemCatalog, Identifier
from ..core.datafile import DataFileMeta
from ..core.manifest import CommitMessage, ManifestCommittable
from ..data.batch import concat_batches
from ..format import collect_stats
from ..fs import get_file_io
from ..types import (BIGINT, BOOLEAN, BYTES, DATE, DECIMAL, DOUBLE, FLOAT, INT, SMALLINT, STRING, TIMESTAMP,
                     TINYINT, DataField, DataType, RowType)
from ..utils import new_file_name, now_millis

__all__ = ["migrate_files", "adopt_table_files", "infer_row_type", "FORMATS"]

FORMATS = ("parquet", "orc", "avro")


def adopt_table_files(
    catalog: FileSystemCatalog,
    source_identifier: "Identifier | str",
    target_identifier: "Identifier | str",
) -> int:
    """Adopt the data files of one append table into another existing
    append table with the same column types, in one APPEND commit, without
    rewriting them; returns the number of files adopted. The files are
    copied, so the source table stays intact until the caller drops it."""
    src = catalog.get_table(source_identifier)
    tgt = catalog.get_table(target_identifier)
    if src.primary_keys or tgt.primary_keys:
        raise ValueError("migrate_file supports append (no primary key) tables only")
    if [f.type for f in src.row_type.fields] != [f.type for f in tgt.row_type.fields]:
        raise ValueError("migrate_file requires identical schemas")
    plan = src.store.new_scan().plan()
    # adopted sequence numbers start above the target's highest
    base = 0
    for e in tgt.store.new_scan().plan().entries:
        base = max(base, e.file.max_sequence_number + 1)
    by_partition: dict[tuple, list[DataFileMeta]] = {}
    moved = 0
    for e in plan.entries:
        src_dir = src.store.bucket_dir(e.partition, e.bucket)
        tgt_dir = tgt.store.bucket_dir(e.partition, 0)
        tgt.file_io.mkdirs(tgt_dir)
        # a fresh name: two adopted tables may hold the same foreign name
        ext = e.file.file_name.rsplit(".", 1)[-1]
        name = new_file_name("data", ext)
        tgt.file_io.write_bytes(f"{tgt_dir}/{name}", src.file_io.read_bytes(f"{src_dir}/{e.file.file_name}"))
        # an index sidecar follows its data file, renamed to match
        new_extra = []
        for x in e.file.extra_files:
            if x == f"{e.file.file_name}.index":
                tgt.file_io.write_bytes(f"{tgt_dir}/{name}.index", src.file_io.read_bytes(f"{src_dir}/{x}"))
                new_extra.append(f"{name}.index")
            else:
                new_extra.append(x)
        span = e.file.max_sequence_number - e.file.min_sequence_number
        meta = dataclasses.replace(
            e.file, file_name=name, extra_files=tuple(new_extra),
            min_sequence_number=base, max_sequence_number=base + span,
        )
        base += span + 1
        by_partition.setdefault(e.partition, []).append(meta)
        moved += 1
    if by_partition:
        messages = [CommitMessage(part, 0, 1, new_files=files) for part, files in by_partition.items()]
        tgt.store.new_commit().commit(ManifestCommittable(now_millis(), messages=messages))
    return moved


def _read_file(data: bytes, file_format: str, row_type: RowType) -> list:
    """Every column of `row_type` from one data file, by column name."""
    names = row_type.field_names
    if file_format == "parquet":
        from ..format.parquet import read_parquet

        return read_parquet(data, row_type, names)
    if file_format == "orc":
        from ..format.orc import read_orc

        return read_orc(data, row_type, names)
    if file_format == "avro":
        from ..format.avro import read_avro

        return [read_avro(data, row_type, names)]
    raise ValueError(f"unknown file format {file_format!r}; known: {sorted(FORMATS)}")


def migrate_files(
    catalog: FileSystemCatalog,
    identifier: "Identifier | str",
    source_dir: str,
    row_type: RowType,
    file_format: str = "parquet",
    partition_keys: tuple = (),
    options: dict | None = None,
):
    """Create an append table whose data files are the existing files
    under source_dir (moved, not rewritten)."""
    if file_format not in FORMATS:
        raise ValueError(f"unknown file format {file_format!r}; known: {sorted(FORMATS)}")
    file_io = get_file_io(source_dir)
    opts = {"bucket": "1", "file.format": file_format}
    opts.update(options or {})
    table = catalog.create_table(
        identifier, row_type, partition_keys=partition_keys, options=opts, ignore_if_exists=False
    )
    messages = []
    seq = 0

    def adopt_dir(directory: str, partition: tuple):
        nonlocal seq
        files = []
        for st in sorted(file_io.list_files(directory), key=lambda s: s.path):
            if not st.path.endswith(f".{file_format}"):
                continue
            # one read gives the row count and the statistics
            batches = _read_file(file_io.read_bytes(st.path), file_format, row_type)
            rows = sum(b.num_rows for b in batches)
            if rows == 0:
                continue
            stats = collect_stats(concat_batches(batches))
            name = st.path.rsplit("/", 1)[-1]
            bucket_dir = table.store.bucket_dir(partition, 0)
            file_io.mkdirs(bucket_dir)
            if not file_io.rename(st.path, f"{bucket_dir}/{name}"):
                raise RuntimeError(f"cannot move {st.path} into the table (name collision)")
            files.append(
                DataFileMeta(
                    file_name=name,
                    file_size=st.size,
                    row_count=rows,
                    min_key=(),
                    max_key=(),
                    key_stats={},
                    value_stats=stats,
                    min_sequence_number=seq,
                    max_sequence_number=seq + rows - 1,
                    schema_id=table.schema.id,
                    level=0,
                    creation_time_millis=now_millis(),
                    file_source="append",
                )
            )
            seq += rows
        if files:
            messages.append(CommitMessage(partition, 0, 1, new_files=files))

    if partition_keys:
        for st in file_io.list_status(source_dir):
            if not st.is_dir:
                continue
            parts = st.path.rsplit("/", 1)[-1].split("=")
            if len(parts) == 2 and parts[0] == partition_keys[0]:
                adopt_dir(st.path, (parts[1],))
    else:
        adopt_dir(source_dir, ())
    if messages:
        table.store.new_commit().commit(ManifestCommittable(1, messages=messages))
    return table


# ---------------------------------------------------------------------------
# schema inference
# ---------------------------------------------------------------------------

# parquet.thrift: physical types, ConvertedType and the LogicalType union's fields
_P_BOOLEAN, _P_INT32, _P_INT64, _P_INT96, _P_FLOAT, _P_DOUBLE, _P_BYTE_ARRAY, _P_FLBA = range(8)
_C_UTF8, _C_ENUM, _C_DECIMAL, _C_DATE, _C_TIME_MILLIS, _C_TIME_MICROS = 0, 4, 5, 6, 7, 8
_C_TIMESTAMP = (9, 10)
_C_SIGNED = {15: TINYINT, 16: SMALLINT, 17: INT}  # INT_8, INT_16, INT_32
_C_JSON = 19
_L_STRING, _L_ENUM, _L_DECIMAL, _L_DATE, _L_TIME, _L_TIMESTAMP, _L_INTEGER = 1, 4, 5, 6, 7, 8, 10
_L_NULL, _L_JSON, _L_FLOAT16 = 11, 12, 15
_SIGNED_WIDTHS = {8: TINYINT, 16: SMALLINT, 32: INT}

# Arrow's Type union (Schema.fbs): the stored types that change what
# pyarrow reports for a column
_A_BINARY, _A_UTF8, _A_DURATION, _A_LARGE_BINARY, _A_LARGE_UTF8, _A_BINARY_VIEW = 4, 5, 18, 19, 20, 23

# ORC Type.Kind
_O_BOOLEAN, _O_BYTE, _O_SHORT, _O_INT, _O_LONG, _O_FLOAT, _O_DOUBLE = range(7)
_O_BINARY, _O_TIMESTAMP, _O_DECIMAL, _O_DATE, _O_TIMESTAMP_INSTANT = 8, 9, 14, 15, 18
_ORC_TYPES = {_O_BOOLEAN: BOOLEAN, _O_BYTE: TINYINT, _O_SHORT: SMALLINT, _O_INT: INT, _O_LONG: BIGINT,
              _O_FLOAT: FLOAT, _O_DOUBLE: DOUBLE, _O_BINARY: BYTES, _O_TIMESTAMP: TIMESTAMP,
              _O_TIMESTAMP_INSTANT: TIMESTAMP, _O_DATE: DATE}


def _decimal(precision: int, scale: int) -> DataType:
    return DECIMAL(precision, scale) if precision <= 18 else STRING()


def _parquet_type(elem: dict | None) -> DataType:
    """The type pyarrow's schema gives a top-level column, through
    row_type_from_arrow (a group: a nested column, STRING)."""
    if elem is None:
        return STRING()
    physical, converted, logical = elem.get(1), elem.get(6), elem.get(10) or {}
    if _L_DECIMAL in logical or converted == _C_DECIMAL:
        d = logical.get(_L_DECIMAL) or {}
        return _decimal(d.get(2, elem.get(8, 0)), d.get(1, elem.get(7, 0)))
    if physical == _P_BOOLEAN:
        return BOOLEAN()
    if physical == _P_INT32:
        if _L_INTEGER in logical:
            width, signed = logical[_L_INTEGER].get(1, 32), logical[_L_INTEGER].get(2, True)
            return _SIGNED_WIDTHS[width]() if signed and width in _SIGNED_WIDTHS else BIGINT()
        if converted in _C_SIGNED:
            return _C_SIGNED[converted]()
        if converted in (11, 12, 13):  # UINT_8, UINT_16, UINT_32
            return BIGINT()
        if _L_DATE in logical or converted == _C_DATE:
            return DATE()
        if _L_TIME in logical or _L_NULL in logical or converted == _C_TIME_MILLIS:
            return STRING()
        return INT()
    if physical == _P_INT64:
        if _L_TIMESTAMP in logical or converted in _C_TIMESTAMP:
            return TIMESTAMP()
        if _L_TIME in logical or _L_NULL in logical or converted == _C_TIME_MICROS:
            return STRING()
        return BIGINT()
    if physical == _P_INT96:
        return TIMESTAMP()
    if physical == _P_FLOAT:
        return FLOAT()
    if physical == _P_DOUBLE:
        return DOUBLE()
    if physical == _P_BYTE_ARRAY:
        if {_L_STRING, _L_ENUM, _L_JSON} & logical.keys() or converted in (_C_UTF8, _C_ENUM, _C_JSON):
            return STRING()
        return BYTES()
    if physical == _P_FLBA and _L_FLOAT16 in logical:
        return DOUBLE()
    return STRING()


class _FlatTable:
    """One table of a flatbuffer: its fields by slot."""

    def __init__(self, buf: bytes, pos: int):
        self.buf, self.pos = buf, pos
        self.vtable = pos - struct.unpack_from("<i", buf, pos)[0]
        self.vtable_len = struct.unpack_from("<H", buf, self.vtable)[0]

    def _at(self, slot: int) -> int:
        o = 4 + 2 * slot
        off = struct.unpack_from("<H", self.buf, self.vtable + o)[0] if o < self.vtable_len else 0
        return self.pos + off if off else 0

    def scalar(self, slot: int, fmt: str, default=0):
        at = self._at(slot)
        return struct.unpack_from(fmt, self.buf, at)[0] if at else default

    def _target(self, slot: int) -> int:
        at = self._at(slot)
        return at + struct.unpack_from("<I", self.buf, at)[0] if at else 0

    def table(self, slot: int) -> "_FlatTable | None":
        at = self._target(slot)
        return _FlatTable(self.buf, at) if at else None

    def string(self, slot: int) -> str:
        at = self._target(slot)
        n = struct.unpack_from("<I", self.buf, at)[0]
        return self.buf[at + 4 : at + 4 + n].decode("utf-8")

    def tables(self, slot: int) -> list:
        at = self._target(slot)
        if not at:
            return []
        n = struct.unpack_from("<I", self.buf, at)[0]
        items = (at + 4 + 4 * k for k in range(n))
        return [_FlatTable(self.buf, p + struct.unpack_from("<I", self.buf, p)[0]) for p in items]


def _stored_arrow_types(value: bytes) -> dict[str, tuple[int, bool]]:
    """{column: (Arrow type id, dictionary-encoded)} of the top-level
    fields of the Arrow schema pyarrow stores under ARROW:schema (a base64
    IPC Schema message); {} when it does not parse."""
    try:
        buf = base64.b64decode(value)
        if buf[:4] == b"\xff\xff\xff\xff":
            buf = buf[8 : 8 + struct.unpack_from("<i", buf, 4)[0]]
        else:
            buf = buf[4 : 4 + struct.unpack_from("<i", buf, 0)[0]]
        message = _FlatTable(buf, struct.unpack_from("<I", buf, 0)[0])
        if message.scalar(1, "<B") != 1:  # header_type: Schema
            return {}
        schema = message.table(2)
        return {f.string(0): (f.scalar(2, "<B"), f.table(4) is not None) for f in schema.tables(1)}
    except (ValueError, struct.error, UnicodeDecodeError, IndexError):
        return {}


def _parquet_row_type(data: bytes) -> RowType:
    from ..decode.container import read_footer

    footer = read_footer(data)
    stored = _stored_arrow_types(footer.key_value_metadata.get("ARROW:schema", b""))
    fields = []
    for i, (name, elem) in enumerate(footer.columns):
        dtype = _parquet_type(elem)
        type_id, dictionary = stored.get(name, (None, False))
        if type_id in (_A_DURATION, _A_BINARY_VIEW) or (
            dictionary and type_id in (_A_BINARY, _A_UTF8, _A_LARGE_BINARY, _A_LARGE_UTF8)
        ):
            dtype = STRING()
        fields.append(DataField(i, name, dtype))
    return RowType(tuple(fields))


def _orc_row_type(data: bytes) -> RowType:
    from ..format.orc_meta import read_tail

    tail = read_tail(data)
    fields = []
    for i, (name, cid) in enumerate(tail.field_columns.items()):
        t = tail.types[cid]
        if t.kind == _O_DECIMAL:
            dtype = _decimal(t.precision or 38, t.scale)
        else:
            dtype = _ORC_TYPES.get(t.kind, STRING)()
        fields.append(DataField(i, name, dtype))
    return RowType(tuple(fields))


def infer_row_type(path: str, file_format: str) -> RowType:
    """The RowType of one Parquet or ORC data file, as the JAX package
    infers it through pyarrow (see the module docstring)."""
    if file_format not in ("parquet", "orc"):
        raise ValueError(f"cannot infer schema from format {file_format!r}")
    data = get_file_io(path).read_bytes(path)
    return _parquet_row_type(data) if file_format == "parquet" else _orc_row_type(data)
