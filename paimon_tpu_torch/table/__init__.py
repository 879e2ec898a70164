"""The Table API (port of paimon_tpu/table/__init__.py, primary-key
tables): new_read_builder / new_batch_write_builder /
new_stream_write_builder, copy, delete_where, tags and snapshot
expiry."""

from __future__ import annotations

import concurrent.futures
import sys
from dataclasses import replace

import torch

from ..core.schema import TableSchema
from ..core.store import KeyValueFileStore
from ..fs import LocalFileIO
from ..options import CoreOptions
from ..types import RowType
from .consumer import ConsumerManager
from .read import ReadBuilder
from .tags import TagManager
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
        self._expire_executor: concurrent.futures.ThreadPoolExecutor | None = None
        self.expire_future: concurrent.futures.Future | None = None

    @property
    def row_type(self) -> RowType:
        return self.store.value_schema

    @property
    def options(self) -> CoreOptions:
        return self.store.options

    @property
    def partition_keys(self) -> list[str]:
        return self.store.partition_keys

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

    def delete_where(self, predicate) -> int:
        """DELETE FROM this table WHERE predicate (table/delete.py): through
        deletion vectors under deletion-vectors.enabled, else as -D rows;
        returns the number of rows deleted."""
        from .delete import delete_where

        return delete_where(self, predicate)

    def create_tag(self, name: str, snapshot_id: int | None = None) -> None:
        TagManager(self.file_io, self.path).create(name, snapshot_id)

    def delete_tag(self, name: str) -> None:
        TagManager(self.file_io, self.path).delete(name)

    def tags(self) -> dict[str, int]:
        return TagManager(self.file_io, self.path).list_tags()

    def expire_snapshots(self) -> int:
        """Expire snapshots by the table's retention options, keeping the
        tagged ones and those from the smallest consumer position to the
        latest (consumers older than consumer.expiration-time are dropped
        first); returns the number expired. Under
        snapshot.expire.execution-mode=async the run goes to one background
        thread, its future is kept as self.expire_future, a failure is
        written to stderr, and 0 is returned."""
        cm = ConsumerManager(self.file_io, self.path)
        ttl = self.options.options.get(CoreOptions.CONSUMER_EXPIRATION_TIME)
        if ttl is not None:
            cm.expire_stale(ttl)

        def protected() -> set[int]:
            ids = TagManager(self.file_io, self.path).tagged_snapshot_ids()
            nxt = cm.min_next_snapshot()
            if nxt is not None:
                latest = self.store.snapshot_manager.latest_snapshot_id() or 0
                ids |= set(range(nxt, latest + 1))
            return ids

        expire = self.store.new_expire(protected)
        if str(self.options.options.get(CoreOptions.SNAPSHOT_EXPIRE_EXECUTION_MODE)).lower() != "async":
            return expire.expire()
        if self._expire_executor is None:
            self._expire_executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="snapshot-expire"
            )
        self.expire_future = self._expire_executor.submit(expire.expire)
        self.expire_future.add_done_callback(_report_async_failure)
        return 0


def _report_async_failure(future: concurrent.futures.Future) -> None:
    exc = future.exception()
    if exc is not None:
        sys.stderr.write(f"[paimon_tpu_torch] async snapshot expire failed: {exc!r}\n")
