"""Spilling to local disk for write buffers (port of paimon_tpu/core/disk.py).

An IOManager owns a temporary spill directory; a SpillableBuffer keeps
ColumnBatches in memory and, once more than `in_memory_rows` rows or
`in_memory_bytes` bytes (ColumnBatch.byte_size) are held, writes them
together as one spill segment, until `max_disk_bytes` of segments are on
disk (then `disk_full` is true and batches stay in memory, so that the
owner flushes). batches() replays every segment, then the batches in
memory, in insertion order; a segment comes back as one batch.

A segment is the port's own columnar dump, private to this module: an
8-byte little-endian length, a JSON header (rows, and per column its kind,
dtype and whether it has a validity mask), then each column's buffers as
(8-byte length, bytes): fixed-width values as they lie in memory; strings
and bytes as int64 lengths and their concatenated payload; the validity
mask bit-packed; an ARRAY, MAP or ROW column as a one-column parquet file
(format/parquet.py), its validity inside.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import tempfile
import uuid
from typing import Iterator

import numpy as np

from ..data.batch import Column, ColumnBatch, concat_batches
from ..encode.kernels import byte_array_parts
from ..format.avro import strings_from_offsets
from ..types import NESTED_ROOTS, RowType, TypeRoot

__all__ = ["IOManager", "SpillableBuffer"]

_LEN = struct.Struct("<Q")


class IOManager:
    """A spill directory, made at the first spill: under `base_dir` when
    given, else a fresh temporary directory."""

    def __init__(self, base_dir: str | None = None):
        self._given = base_dir
        self.base = base_dir

    def create_channel(self) -> str:
        if self.base is None:
            self.base = tempfile.mkdtemp(prefix="paimon_tpu_torch_spill_")
        os.makedirs(self.base, exist_ok=True)
        return os.path.join(self.base, f"spill-{uuid.uuid4().hex}.seg")

    def close(self) -> None:
        """Remove the directory and everything in it; a later spill makes
        it again."""
        if self.base is not None:
            shutil.rmtree(self.base, ignore_errors=True)
        self.base = self._given


def _write_segment(path: str, batch: ColumnBatch) -> None:
    columns, buffers = [], []
    for f in batch.schema.fields:
        col = batch.column(f.name)
        values = col.values
        valid = col.validity
        if f.type.root in NESTED_ROOTS:
            # a nested column travels as a one-column parquet file
            from ..format.parquet import write_parquet

            columns.append({"name": f.name, "kind": "nested", "valid": False})
            buffers.append(write_parquet(ColumnBatch(RowType([f]), {f.name: col}), "none"))
            continue
        if values.dtype == np.dtype(object):
            if valid is not None:
                values = values.copy()
                values[~valid] = b"" if f.type.root in (TypeRoot.BINARY, TypeRoot.VARBINARY) else ""
            lengths, payload = byte_array_parts(values)
            columns.append({"name": f.name, "kind": "strings", "valid": valid is not None})
            buffers += [lengths.astype("<i8").tobytes(), payload]
        else:
            columns.append({"name": f.name, "kind": "fixed", "dtype": values.dtype.str, "valid": valid is not None})
            buffers.append(np.ascontiguousarray(values).tobytes())
        if valid is not None:
            buffers.append(np.packbits(valid).tobytes())
    header = json.dumps({"rows": batch.num_rows, "columns": columns}).encode()
    with open(path, "wb") as out:
        out.write(_LEN.pack(len(header)))
        out.write(header)
        for buf in buffers:
            out.write(_LEN.pack(len(buf)))
            out.write(buf)


def _read_segment(path: str, schema) -> ColumnBatch:
    with open(path, "rb") as f:
        data = f.read()
    (hlen,) = _LEN.unpack_from(data, 0)
    header = json.loads(data[8 : 8 + hlen])
    pos = 8 + hlen
    n = header["rows"]

    def take() -> bytes:
        nonlocal pos
        (size,) = _LEN.unpack_from(data, pos)
        pos += 8 + size
        return data[pos - size : pos]

    cols = {}
    for c in header["columns"]:
        dtype = schema.field(c["name"]).type
        if c["kind"] == "nested":
            from ..format.parquet import read_parquet

            one = RowType([schema.field(c["name"])])
            cols[c["name"]] = concat_batches(read_parquet(take(), one, one.field_names)).column(c["name"])
            continue
        if c["kind"] == "strings":
            lengths = np.frombuffer(take(), dtype="<i8")
            payload = np.frombuffer(take(), dtype=np.uint8)
            offsets = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(lengths, out=offsets[1:])
            values = None
        else:
            values = np.frombuffer(take(), dtype=np.dtype(c["dtype"])).copy()
        valid = np.unpackbits(np.frombuffer(take(), dtype=np.uint8), count=n).astype(np.bool_) if c["valid"] else None
        if values is None:
            utf8 = dtype.root in (TypeRoot.CHAR, TypeRoot.VARCHAR)
            values = strings_from_offsets(offsets, payload, np.ones(n, dtype=np.bool_) if valid is None else valid, utf8)
        cols[c["name"]] = Column(values, valid)
    return ColumnBatch(schema, cols)


class SpillableBuffer:
    """Buffers ColumnBatches in memory and spills them past the row or
    byte cap; replays in insertion order."""

    def __init__(
        self,
        io_manager: IOManager,
        in_memory_rows: int = 1 << 20,
        in_memory_bytes: int = 64 << 20,
        max_disk_bytes: int | None = None,
    ):
        self.io_manager = io_manager
        self.in_memory_rows = in_memory_rows
        self.in_memory_bytes = in_memory_bytes
        # write-buffer-spill.max-disk-size: past it add() stops spilling
        # (disk_full) so that the owner flushes
        self.max_disk_bytes = max_disk_bytes
        self._memory: list[ColumnBatch] = []
        self._memory_rows = 0
        self._memory_bytes = 0
        self._spilled: list[str] = []
        self._spilled_rows = 0
        self._spilled_disk_bytes = 0
        self._schema = None
        # bytes of every segment this buffer has written, clears included
        self.spilled_bytes_total = 0

    @property
    def disk_full(self) -> bool:
        return self.max_disk_bytes is not None and self._spilled_disk_bytes >= self.max_disk_bytes

    @property
    def num_rows(self) -> int:
        return self._memory_rows + self._spilled_rows

    @property
    def spilled_bytes(self) -> int:
        return sum(os.path.getsize(p) for p in self._spilled if os.path.exists(p))

    def add(self, batch: ColumnBatch) -> None:
        if batch.num_rows == 0:
            return
        self._memory.append(batch)
        self._memory_rows += batch.num_rows
        self._memory_bytes += batch.byte_size()
        if (
            self._memory_rows > self.in_memory_rows or self._memory_bytes > self.in_memory_bytes
        ) and not self.disk_full:
            self._spill()

    def _spill(self) -> None:
        path = self.io_manager.create_channel()
        self._schema = self._memory[0].schema
        _write_segment(path, concat_batches(self._memory))
        self._spilled.append(path)
        self._spilled_rows += self._memory_rows
        size = os.path.getsize(path)
        self._spilled_disk_bytes += size
        self.spilled_bytes_total += size
        self._memory.clear()
        self._memory_bytes = 0
        self._memory_rows = 0

    def batches(self) -> Iterator[ColumnBatch]:
        for path in self._spilled:
            yield _read_segment(path, self._schema)
        yield from self._memory

    def clear(self) -> None:
        for p in self._spilled:
            try:
                os.remove(p)
            except OSError:
                pass
        self._spilled.clear()
        self._spilled_rows = 0
        self._spilled_disk_bytes = 0
        self._memory.clear()
        self._memory_rows = 0
        self._memory_bytes = 0
