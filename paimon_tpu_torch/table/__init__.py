"""The Table API (port of paimon_tpu/table/__init__.py):
new_read_builder / new_batch_write_builder / new_stream_write_builder,
copy, with_user, delete_where, update_where, merge_into, tags, rollback_to,
snapshot expiry, and load_table.

A table with a primary key is served by the key-value store, one without
by the append-only store (core/append.py). bucket_mode is the JAX
package's: a primary-key table with bucket=-1 is "dynamic", an append
table with bucket=-1 "unaware" (every row to bucket 0 of its partition),
and any table with bucket=N "fixed".

A branch view (table/branch.py branch_table) resolves its data files in
the main tree through an instance-level store.bucket_dir; copy and
with_user carry it over. copy({"branch": x}) only merges the option and
still reads main, as in the JAX package: load_table pins a branch.
"""

from __future__ import annotations

import concurrent.futures
import sys
from dataclasses import replace

import torch

from ..core.schema import SchemaManager, TableSchema
from ..core.store import AppendOnlyFileStore, KeyValueFileStore
from ..fs import LocalFileIO
from ..options import CoreOptions
from ..types import RowType
from ..utils import resolve_device
from .consumer import ConsumerManager
from .read import ReadBuilder
from .tags import TagManager
from .write import BatchWriteBuilder, StreamWriteBuilder

__all__ = ["FileStoreTable", "load_table"]


class FileStoreTable:
    def __init__(
        self,
        file_io: LocalFileIO,
        path: str,
        schema: TableSchema,
        commit_user: str = "anonymous",
        device: "str | torch.device" = "cuda",
    ):
        self.file_io = file_io
        self.path = path
        self.name = path.rstrip("/").rsplit("/", 1)[-1]
        self.schema = schema
        self.device = torch.device(device)
        store_cls = KeyValueFileStore if schema.primary_keys else AppendOnlyFileStore
        self.store = store_cls(file_io, path, schema, commit_user=commit_user, device=self.device)
        self._expire_executor: concurrent.futures.ThreadPoolExecutor | None = None
        self.expire_future: concurrent.futures.Future | None = None

    @property
    def is_primary_key_table(self) -> bool:
        return bool(self.schema.primary_keys)

    @property
    def bucket_mode(self) -> str:
        if self.store.options.bucket != -1:
            return "fixed"
        return "dynamic" if self.is_primary_key_table else "unaware"

    @property
    def row_type(self) -> RowType:
        return self.store.value_schema

    @property
    def primary_keys(self) -> list[str]:
        return list(self.schema.primary_keys)

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
        schema = replace(self.schema, options=merged)
        return self._carry_store_overrides(
            FileStoreTable(self.file_io, self.path, schema, self.store.commit_user, self.device)
        )

    def with_user(self, commit_user: str) -> "FileStoreTable":
        """The same table committing as `commit_user`."""
        return self._carry_store_overrides(
            FileStoreTable(self.file_io, self.path, self.schema, commit_user, self.device)
        )

    def _carry_store_overrides(self, out: "FileStoreTable") -> "FileStoreTable":
        """A branch view's rebuilt store keeps resolving data files in the
        main tree, or every shared file would read as missing."""
        if "bucket_dir" in self.store.__dict__:
            out.store.bucket_dir = self.store.__dict__["bucket_dir"]
        return out

    def new_read_builder(self) -> ReadBuilder:
        return ReadBuilder(self)

    def new_batch_write_builder(self) -> BatchWriteBuilder:
        return BatchWriteBuilder(self)

    def new_stream_write_builder(self) -> StreamWriteBuilder:
        return StreamWriteBuilder(self)

    def delete_where(self, predicate) -> int:
        """DELETE FROM this table WHERE predicate (table/delete.py): through
        deletion vectors under deletion-vectors.enabled, else as -D rows on
        a primary-key table and by rewriting the files on an append table;
        returns the number of rows deleted."""
        from .delete import delete_where

        return delete_where(self, predicate)

    def update_where(self, predicate, assignments: dict) -> int:
        """UPDATE this table SET assignments WHERE predicate
        (table/rowops.py): +U rows on a primary-key table, a copy-on-write
        rewrite on an append table. Returns the rows updated."""
        from .rowops import update_where

        return update_where(self, predicate, assignments)

    def merge_into(self, source):
        """A MERGE INTO builder (table/rowops.py MergeInto):
        table.merge_into(source).when_matched_update(...)
        .when_not_matched_insert().execute()."""
        from .rowops import MergeInto

        return MergeInto(self, source)

    def create_tag(self, name: str, snapshot_id: int | None = None) -> None:
        TagManager(self.file_io, self.path).create(name, snapshot_id)

    def delete_tag(self, name: str) -> None:
        TagManager(self.file_io, self.path).delete(name)

    def tags(self) -> dict[str, int]:
        return TagManager(self.file_io, self.path).list_tags()

    def rollback_to(self, target: "int | str") -> None:
        """Roll back to a snapshot id or a tag's snapshot (table/rollback.py)."""
        from .rollback import rollback_to

        rollback_to(self, target)

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


def load_table(
    path: str,
    commit_user: str = "anonymous",
    dynamic_options: dict[str, str] | None = None,
    row_type: RowType | None = None,
    device: "str | torch.device" = "cuda",
) -> FileStoreTable:
    """Open the table at `path` on `device` ("cuda" unless the caller asks
    for the CPU). The branch option, in `dynamic_options` or in the table's
    options, pins the view to that branch; the other dynamic options apply
    to that view. With auto-create=true and a `row_type`, a missing table is
    created first: primary and partition keys from the 'primary-key' and
    'partition' options, the scan.*, consumer*, incremental-between* and
    streaming-read* options applied to the view and not persisted."""
    dev = resolve_device(device)
    file_io = LocalFileIO()
    schema = SchemaManager(file_io, path).latest()
    if schema is None:
        opts = dict(dynamic_options or {})
        if str(opts.get("auto-create", "")).lower() != "true" or row_type is None:
            raise FileNotFoundError(f"no table at {path}")
        opts.pop("auto-create")
        pk = [c.strip() for c in opts.pop("primary-key", "").split(",") if c.strip()]
        parts = [c.strip() for c in opts.pop("partition", "").split(",") if c.strip()]
        session_prefixes = ("scan.", "consumer", "incremental-between", "streaming-read")
        persisted = {k: v for k, v in opts.items() if not k.startswith(session_prefixes)}
        session = {k: v for k, v in opts.items() if k.startswith(session_prefixes)}
        schema = SchemaManager(file_io, path).create_table(row_type, parts, pk, persisted)
        table = FileStoreTable(file_io, path, schema, commit_user, dev)
        return table.copy(session) if session else table
    table = FileStoreTable(file_io, path, schema, commit_user, dev)
    # the branch first: its view has its own schema, and the other dynamic
    # options land on that view
    dynamic_options = dict(dynamic_options or {})
    branch = dynamic_options.pop("branch", None) or table.options.options.get(CoreOptions.BRANCH)
    if branch and branch != "main":
        from .branch import branch_table

        table = branch_table(table, branch)
    return table.copy(dynamic_options) if dynamic_options else table


def _report_async_failure(future: concurrent.futures.Future) -> None:
    exc = future.exception()
    if exc is not None:
        sys.stderr.write(f"[paimon_tpu_torch] async snapshot expire failed: {exc!r}\n")
