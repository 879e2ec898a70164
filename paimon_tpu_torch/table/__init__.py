"""The Table API (port of paimon_tpu/table/__init__.py, primary-key
tables): new_read_builder / new_batch_write_builder /
new_stream_write_builder and copy."""

from __future__ import annotations

from dataclasses import replace

import torch

from ..core.schema import TableSchema
from ..core.store import KeyValueFileStore
from ..fs import LocalFileIO
from ..types import RowType
from .read import ReadBuilder
from .write import BatchWriteBuilder, StreamWriteBuilder

__all__ = ["FileStoreTable"]


class FileStoreTable:
    def __init__(
        self,
        file_io: LocalFileIO,
        path: str,
        schema: TableSchema,
        commit_user: str = "anonymous",
        device: "str | torch.device" = "cuda",
    ):
        if not schema.primary_keys:
            raise NotImplementedError("append-only tables are not supported by the torch port yet")
        self.file_io = file_io
        self.path = path
        self.schema = schema
        self.device = torch.device(device)
        self.store = KeyValueFileStore(file_io, path, schema, commit_user=commit_user, device=self.device)

    @property
    def row_type(self) -> RowType:
        return self.store.value_schema

    def copy(self, dynamic_options: dict[str, str]) -> "FileStoreTable":
        """The same table with option overrides."""
        merged = dict(self.schema.options)
        merged.update(dynamic_options)
        return FileStoreTable(
            self.file_io, self.path, replace(self.schema, options=merged), self.store.commit_user, self.device
        )

    def new_read_builder(self) -> ReadBuilder:
        return ReadBuilder(self)

    def new_batch_write_builder(self) -> BatchWriteBuilder:
        return BatchWriteBuilder(self)

    def new_stream_write_builder(self) -> StreamWriteBuilder:
        return StreamWriteBuilder(self)
