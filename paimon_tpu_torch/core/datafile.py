"""Data file metadata and the key-value file writer/reader factories (port
of paimon_tpu/core/datafile.py).

DataFileMeta serializes to the JAX package's JSON fields. Files are
parquet through format/parquet.py; the reader maps each read field to the
file's write schema by field id (a missing field reads as nulls, a field
whose type widened is cast by data/casting.py cast_column). Statistics of
an older file prune only where they compare as the cast values would
(stats_comparable): a renamed, dropped or re-added column, a scale change
or a cast to another kind of value prunes nothing.

The writer adds each file's PTIX index (format/fileindex.py) at flush and
at compaction alike: blooms of file-index.bloom-filter.columns and, under
file-index.bloom-filter.primary-key.enabled, the composite key bloom. A
payload up to file-index.in-manifest-threshold rides in the manifest
entry, a larger one goes to a `.index` sidecar named in extra_files.
Predicate-free reads go through the data-file cache (utils/cache.py); a
cached KVBatch is shared, so no reader may change its arrays.

The writer passes the table's parquet writer options (parquet.page-size,
parquet.row-group.rows, file.block-size, parquet.enable.dictionary,
parquet.data-page-version) to the encoder. Under merge.dict-domain the
reader asks the decoder for code-backed columns (dictionary-encoded chunks
as a sorted pool and uint32 codes); the flag is part of the data-file
cache's key, so a code-backed batch never stands in for an expanded one.
"""

from __future__ import annotations

import base64
from dataclasses import dataclass, replace
from typing import Sequence

import numpy as np

from ..data.batch import Column, ColumnBatch, concat_batches
from ..data.casting import cast_column, stats_comparable
from ..format import FieldStats, collect_stats, stats_from_json, stats_to_json
from ..format.parquet import WRITE_CODECS, read_parquet, write_parquet
from ..fs import LocalFileIO
from ..types import DataField, RowKind, RowType
from ..utils import new_file_name, now_millis
from .kv import SEQUENCE_FIELD_NAME, VALUE_KIND_FIELD_NAME, KVBatch, kv_disk_schema

__all__ = ["DataFileMeta", "KeyValueFileWriterFactory", "KeyValueFileReaderFactory"]

# the decoder field of the data-file cache's key: the port has one decoder,
# with or without the code domain
_DECODER_ID = "port"

# the table options the parquet writer honours
WRITER_OPTION_KEYS = (
    "parquet.page-size",
    "parquet.row-group.rows",
    "file.block-size",
    "parquet.enable.dictionary",
    "parquet.data-page-version",
)


@dataclass(frozen=True)
class DataFileMeta:
    file_name: str
    file_size: int
    row_count: int
    min_key: tuple
    max_key: tuple
    key_stats: dict[str, FieldStats]
    value_stats: dict[str, FieldStats]
    min_sequence_number: int
    max_sequence_number: int
    schema_id: int
    level: int
    delete_row_count: int = 0
    creation_time_millis: int = 0
    file_source: str = "append"
    extra_files: tuple[str, ...] = ()
    embedded_index: bytes | None = None

    def upgrade(self, level: int) -> "DataFileMeta":
        """The same file moved to another level (compaction upgrade)."""
        return replace(self, level=level)

    def to_dict(self) -> dict:
        return {
            "fileName": self.file_name,
            "fileSize": self.file_size,
            "rowCount": self.row_count,
            "minKey": list(self.min_key),
            "maxKey": list(self.max_key),
            "keyStats": stats_to_json(self.key_stats),
            "valueStats": stats_to_json(self.value_stats),
            "minSequenceNumber": self.min_sequence_number,
            "maxSequenceNumber": self.max_sequence_number,
            "schemaId": self.schema_id,
            "level": self.level,
            "deleteRowCount": self.delete_row_count,
            "creationTimeMillis": self.creation_time_millis,
            "fileSource": self.file_source,
            "extraFiles": list(self.extra_files),
            "embeddedIndex": None if self.embedded_index is None else base64.b64encode(self.embedded_index).decode(),
        }

    @staticmethod
    def from_dict(d: dict) -> "DataFileMeta":
        return DataFileMeta(
            d["fileName"],
            d["fileSize"],
            d["rowCount"],
            tuple(d["minKey"]),
            tuple(d["maxKey"]),
            stats_from_json(d["keyStats"]),
            stats_from_json(d["valueStats"]),
            d["minSequenceNumber"],
            d["maxSequenceNumber"],
            d["schemaId"],
            d["level"],
            d.get("deleteRowCount", 0),
            d.get("creationTimeMillis", 0),
            d.get("fileSource", "append"),
            tuple(d.get("extraFiles", ())),
            None if d.get("embeddedIndex") is None else base64.b64decode(d["embeddedIndex"]),
        )


def _py(x):
    return x.item() if hasattr(x, "item") else x


def _sort_key(col: Column) -> np.ndarray:
    if col.is_code_backed and col.validity is None:
        return col.dict_cache[1]
    return col.values


class KeyValueFileWriterFactory:
    """Writes key-sorted KVBatches as parquet data files with stats,
    rolling at the target file size."""

    def __init__(
        self,
        file_io: LocalFileIO,
        bucket_dir: str,
        value_schema: RowType,
        key_names: Sequence[str],
        schema_id: int,
        file_format: str = "parquet",
        compression: str = "zstd",
        per_level_compression: dict[int, str] | None = None,
        target_file_size: int = 128 << 20,
        keyed: bool = True,
        bloom_columns: Sequence[str] = (),
        bloom_fpp: float = 0.05,
        key_bloom: bool = False,
        key_bloom_fpp: float = 0.001,
        index_in_manifest_threshold: int = 500,
        format_options: dict | None = None,
    ):
        if file_format != "parquet":
            raise NotImplementedError(f"file.format={file_format} is not supported by the torch port yet")
        self.per_level_compression = dict(per_level_compression or {})
        lacking = {lv: c for lv, c in self.per_level_compression.items() if c.lower() not in WRITE_CODECS}
        if lacking:
            raise NotImplementedError(
                f"file.compression.per.level names {lacking}: the torch port writes {', '.join(WRITE_CODECS)}"
            )
        self.file_io = file_io
        self.bucket_dir = bucket_dir
        self.value_schema = value_schema
        self.key_names = list(key_names)
        self.schema_id = schema_id
        self.compression = compression
        self.target_file_size = target_file_size
        # keyed=False: an append table's files hold the plain rows, with no
        # _SEQUENCE_NUMBER / _VALUE_KIND columns and an empty key range
        self.keyed = keyed
        self.bloom_columns = list(bloom_columns)
        self.bloom_fpp = bloom_fpp
        self.key_bloom = bool(key_bloom) and keyed and bool(self.key_names)
        self.key_bloom_fpp = key_bloom_fpp
        self.index_in_manifest_threshold = index_in_manifest_threshold
        self.format_options = dict(format_options or {})

    def _estimate_row_bytes(self, batch: ColumnBatch) -> int:
        total = 0
        for f in batch.schema.fields:
            dt = f.type.numpy_dtype()
            total += 16 if dt == np.dtype(object) else dt.itemsize
        return max(total, 1)

    def write(
        self,
        kv: KVBatch,
        level: int,
        file_source: str = "append",
        prefix: str = "data",
        sorted_input: bool = True,
        measured_row_bytes: float | None = None,
    ) -> list[DataFileMeta]:
        """Rolls into several files at target size. Input must be key-sorted
        unless sorted_input=False (changelog files keep event order: their
        key range is then computed, not taken from the first and last row).
        measured_row_bytes replaces the schema's estimate of a row's width
        (sort-compaction.range-strategy=size)."""
        n = kv.num_rows
        if n == 0:
            return []
        row_bytes = measured_row_bytes or self._estimate_row_bytes(kv.data)
        rows_per_file = max(1, int(self.target_file_size / max(row_bytes, 1)))
        return [
            self._write_one(kv.slice(s, min(s + rows_per_file, n)), level, file_source, prefix, sorted_input)
            for s in range(0, n, rows_per_file)
        ]

    def _key_range(self, data: ColumnBatch, sorted_input: bool) -> tuple[tuple, tuple]:
        first = last = 0
        if self.key_names and not sorted_input:
            # codes are rank-preserving stand-ins for the values
            order = np.lexsort([_sort_key(data.column(k)) for k in reversed(self.key_names)])
            first, last = int(order[0]), int(order[-1])
        else:
            last = data.num_rows - 1
        return tuple(
            tuple(_py(data.column(k).value_at(i)) for k in self.key_names) for i in (first, last)
        )

    def _write_one(
        self, kv: KVBatch, level: int, file_source: str, prefix: str = "data", sorted_input: bool = True
    ) -> DataFileMeta:
        name = new_file_name(prefix, "parquet")
        path = f"{self.bucket_dir}/{name}"
        compression = self.per_level_compression.get(level, self.compression)
        disk = kv.to_disk_batch() if self.keyed else kv.data
        self.file_io.write_bytes(path, write_parquet(disk, compression, self.format_options))
        extra, embedded = self._write_index(kv, name, path)
        value_stats = collect_stats(kv.data)
        min_key, max_key = self._key_range(kv.data, sorted_input)
        return DataFileMeta(
            file_name=name,
            file_size=self.file_io.get_status(path).size,
            row_count=kv.num_rows,
            min_key=min_key,
            max_key=max_key,
            key_stats={k: value_stats[k] for k in self.key_names},
            value_stats=value_stats,
            min_sequence_number=int(kv.seq.min()),
            max_sequence_number=int(kv.seq.max()),
            schema_id=self.schema_id,
            level=level,
            delete_row_count=int((kv.kind == int(RowKind.DELETE)).sum()),
            creation_time_millis=now_millis(),
            file_source=file_source,
            extra_files=extra,
            embedded_index=embedded,
        )

    def _write_index(self, kv: KVBatch, name: str, path: str) -> tuple[tuple[str, ...], bytes | None]:
        """(extra files, embedded payload) of the file's PTIX index."""
        if not (self.bloom_columns or self.key_bloom):
            return (), None
        from ..format.fileindex import build_index_payload, index_path
        from ..table.bucket import key_hashes

        hashes = key_hashes(kv.data, self.key_names) if self.key_bloom else None
        payload = build_index_payload(
            kv.data, self.bloom_columns, self.bloom_fpp, key_hashes=hashes, key_fpp=self.key_bloom_fpp
        )
        if payload is None:
            return (), None
        if len(payload) <= self.index_in_manifest_threshold:
            return (), payload
        self.file_io.write_bytes(index_path(path), payload, overwrite=True)
        return (name + ".index",), None


class KeyValueFileReaderFactory:
    """Reads data files back into KVBatches, mapping each read field to the
    file's write schema by field id."""

    def __init__(
        self,
        file_io: LocalFileIO,
        bucket_dir: str,
        read_schema: RowType,
        schemas_by_id: dict[int, RowType],
        keyed: bool = True,
        cache=None,
        dict_domain: bool = False,
        pool_limit: int | None = None,
    ):
        self.file_io = file_io
        self.bucket_dir = bucket_dir
        self.read_schema = read_schema
        self.schemas_by_id = schemas_by_id
        self.keyed = keyed
        self.dict_domain = dict_domain
        self.pool_limit = pool_limit
        # the data-file cache (utils/cache.py), predicate-free reads only
        self.cache = cache if cache is not None and cache.enabled else None

    def read(
        self,
        meta: DataFileMeta,
        fields: Sequence[str] | None = None,
        system_columns: bool | str = True,
        predicate=None,
    ) -> KVBatch:
        """fields: subset of read-schema fields to decode. system_columns:
        True reads _SEQUENCE_NUMBER + _VALUE_KIND, "kind" only _VALUE_KIND
        (seq zeros), False neither (the caller holds them already).
        predicate: row groups whose statistics cannot match it are skipped,
        and rows whose dictionary codes fail one of its value conjuncts are
        dropped; the rows left depend on the predicate alone, so two reads
        of one file under one predicate are row-aligned whatever their
        fields. Rows it leaves may still fail it: the caller filters. An
        unkeyed (append) file has no system columns: its sequence numbers
        and kinds read as zeros."""
        ext = meta.file_name.rsplit(".", 1)[-1]
        if ext != "parquet":
            raise NotImplementedError(f"file.format={ext} is not supported by the torch port yet")
        if not self.keyed:
            system_columns = False
        if predicate is None and self.cache is not None:
            read_names = self.read_schema.field_names if fields is None else list(fields)
            # the read-field signature pins the projection and the schema
            # evolution; the key holds the file name, not its path, so a
            # branch view or a table copy reading the same file hits
            sig = tuple((f.id, f.name, repr(f.type)) for f in (self.read_schema.field(n) for n in read_names))
            decoder = _DECODER_ID + ("+dict" if self.dict_domain else "")
            key = ("data", meta.file_name, system_columns, sig, fields is None, decoder)
            return self.cache.get_or_load(
                key,
                lambda: self._decode(meta, fields, system_columns, None),
                lambda kv: kv.byte_size(),
                file_id=meta.file_name,
            )
        return self._decode(meta, fields, system_columns, predicate)

    def _decode(self, meta: DataFileMeta, fields, system_columns: bool | str, predicate) -> KVBatch:
        data_schema = self.schemas_by_id[meta.schema_id]
        read_fields = self.read_schema.fields if fields is None else tuple(self.read_schema.field(n) for n in fields)
        by_id = {f.id: f for f in data_schema.fields}
        wanted = {True: [SEQUENCE_FIELD_NAME, VALUE_KIND_FIELD_NAME], "kind": [VALUE_KIND_FIELD_NAME]}.get(
            system_columns, []
        )
        mapping: list[tuple[DataField, DataField | None]] = []
        for f in read_fields:
            src = by_id.get(f.id)
            mapping.append((f, src))
            if src is not None:
                wanted.append(src.name)
        disk_schema = kv_disk_schema(data_schema) if self.keyed else data_schema
        if predicate is not None:
            # the file's stats are found by name: prune only where each
            # named field is the file's column of the same name and id, and
            # its stats bound the cast values
            read_by_name = {f.name: f for f in self.read_schema.fields}
            for name in predicate.referenced_fields():
                f = read_by_name.get(name)
                src = by_id.get(f.id) if f is not None else None
                if src is None or src.name != name or not stats_comparable(src.type, f.type):
                    predicate = None
                    break
        raw = self.file_io.read_bytes(f"{self.bucket_dir}/{meta.file_name}")
        parts = read_parquet(raw, disk_schema, wanted, predicate, self.dict_domain, self.pool_limit)
        disk = concat_batches(parts) if parts else ColumnBatch.empty(disk_schema.project(wanted))
        n = disk.num_rows
        cols: dict[str, Column] = {}
        for f, src in mapping:
            if src is None:
                dt = f.type.numpy_dtype()
                vals = np.full(n, None, dtype=object) if dt == np.dtype(object) else np.zeros(n, dtype=dt)
                cols[f.name] = Column(vals, np.zeros(n, dtype=np.bool_))
            elif src.type == f.type:
                cols[f.name] = disk.column(src.name)
            else:
                try:
                    cols[f.name] = cast_column(disk.column(src.name), src.type, f.type)
                except ValueError as exc:
                    raise ValueError(f"field {f.name!r} of {meta.file_name}: {exc}") from None
        data = ColumnBatch(RowType(read_fields), cols)
        seq = np.zeros(n, dtype=np.int64)
        kind = np.zeros(n, dtype=np.uint8)
        if system_columns is True:
            seq = disk.column(SEQUENCE_FIELD_NAME).values.astype(np.int64, copy=False)
        if system_columns in (True, "kind"):
            kind = disk.column(VALUE_KIND_FIELD_NAME).values.astype(np.uint8)
        return KVBatch(data, seq, kind)
