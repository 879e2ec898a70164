"""Catalog: databases and tables in a warehouse directory (port of
paimon_tpu/catalog/__init__.py, FileSystemCatalog create, get, alter,
list, drop and rename). Dropping or renaming drops the tree's metadata from
the manifest cache (utils/cache.py): a table created again at the path
mints its snapshot ids again.

`get_table("db.t$snapshots")` opens a system table of db.t
(table/system.py). The database name 'sys' is reserved for the
catalog-scope system tables: `get_table("sys.all_table_options")` opens
one of catalog/globals.py (all_table_options, catalog_options and the
four lineage tables over `lineage_meta()`).

`Catalog` is the interface FileSystemCatalog, catalog/jdbc.py's
JdbcCatalog and catalog/privilege.py's PrivilegedCatalog share.

Layout: warehouse/<db>.db/<table>/{schema,snapshot,manifest,bucket-N}, the
JAX package's. The catalog's `device` ("cuda" by default) threads through
every table it opens down to the merge kernels; without a CUDA device the
default raises RuntimeError, and device="cpu" runs the plain versions.

The warehouse's scheme picks the FileIO (fs `get_file_io`: a local path,
s3://, oss://, s3-legacy://, or a fault-injecting scheme of fs/testing.py).
Tables get that FileIO raw and wrap it by their own fs.retry.* options;
the catalog's own metadata probes (listings, schema reads) go through
`_meta_io`, the default retry budget, as in the JAX package
(paimon_tpu/catalog/__init__.py:65-79).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core.schema import SchemaManager, TableSchema
from ..fs import FileIO, get_file_io
from ..options import CoreOptions
from ..resilience.fileio import wrap_file_io
from ..table import FileStoreTable
from ..types import RowType
from ..utils import resolve_device
from ..utils.cache import invalidate_table_path

__all__ = ["Catalog", "FileSystemCatalog", "Identifier"]


class Identifier:
    def __init__(self, database: str, table: str):
        self.database = database
        self.table = table

    @staticmethod
    def parse(full: str) -> "Identifier":
        db, _, tbl = full.partition(".")
        if not tbl:
            raise ValueError(f"expected db.table, got {full!r}")
        return Identifier(db, tbl)

    def __repr__(self) -> str:
        return f"{self.database}.{self.table}"


class Catalog:
    def list_databases(self) -> list[str]:
        raise NotImplementedError

    def create_database(self, name: str, ignore_if_exists: bool = True) -> None:
        raise NotImplementedError

    def drop_database(self, name: str, cascade: bool = False) -> None:
        raise NotImplementedError

    def list_tables(self, database: str) -> list[str]:
        raise NotImplementedError

    def create_table(self, identifier, row_type, **kw) -> FileStoreTable:
        raise NotImplementedError

    def get_table(self, identifier):
        raise NotImplementedError

    def drop_table(self, identifier) -> None:
        raise NotImplementedError


class FileSystemCatalog(Catalog):
    DB_SUFFIX = ".db"
    SYSTEM_SEP = "$"

    def __init__(self, warehouse: str, commit_user: str = "anonymous", device: "str | torch.device" = "cuda"):
        self.device = resolve_device(device)
        self.warehouse = warehouse.rstrip("/")
        self.file_io: FileIO = get_file_io(self.warehouse)
        self.commit_user = commit_user
        # probes run before any table's store exists to give its retry
        # budget: they take the default one
        self._meta_io: FileIO = wrap_file_io(self.file_io, CoreOptions())

    def _db_path(self, name: str) -> str:
        return f"{self.warehouse}/{name}{self.DB_SUFFIX}"

    def list_databases(self) -> list[str]:
        return sorted(
            st.path.rsplit("/", 1)[-1][: -len(self.DB_SUFFIX)]
            for st in self._meta_io.list_status(self.warehouse)
            if st.is_dir and st.path.endswith(self.DB_SUFFIX)
        )

    def create_database(self, name: str, ignore_if_exists: bool = True) -> None:
        if name == "sys":
            raise ValueError("'sys' is reserved for catalog system tables")
        path = self._db_path(name)
        if self.file_io.exists(path):
            if not ignore_if_exists:
                raise ValueError(f"database {name} exists")
            return
        self.file_io.mkdirs(path)

    def drop_database(self, name: str, cascade: bool = False) -> None:
        if not cascade and self.list_tables(name):
            raise ValueError(f"database {name} is not empty")
        self.file_io.delete(self._db_path(name), recursive=True)
        invalidate_table_path(self._db_path(name))

    def list_tables(self, database: str) -> list[str]:
        # the path is rebuilt from the directory and the base name: a
        # wrapper's FileStatus may carry its inner path
        db = self._db_path(database)
        names = (st.path.rsplit("/", 1)[-1] for st in self._meta_io.list_status(db) if st.is_dir)
        return sorted(n for n in names if self._meta_io.exists(f"{db}/{n}/schema"))

    def drop_table(self, identifier: "Identifier | str") -> None:
        self.file_io.delete(self.table_path(identifier), recursive=True)
        invalidate_table_path(self.table_path(identifier))

    def rename_table(self, src: "Identifier | str", dst: "Identifier | str") -> None:
        if not self.file_io.rename(self.table_path(src), self.table_path(dst)):
            raise ValueError(f"cannot rename {src} -> {dst} (destination exists)")
        invalidate_table_path(self.table_path(src))

    def table_path(self, identifier: "Identifier | str") -> str:
        ident = Identifier.parse(identifier) if isinstance(identifier, str) else identifier
        return f"{self._db_path(ident.database)}/{ident.table}"

    def create_table(
        self,
        identifier: "Identifier | str",
        row_type: RowType,
        partition_keys: Sequence[str] = (),
        primary_keys: Sequence[str] = (),
        options: dict | None = None,
        ignore_if_exists: bool = False,
    ) -> FileStoreTable:
        ident = Identifier.parse(identifier) if isinstance(identifier, str) else identifier
        self.create_database(ident.database)
        path = self.table_path(ident)
        sm = SchemaManager(self.file_io, path)
        if sm.latest() is not None and not ignore_if_exists:
            raise ValueError(f"table {ident} exists")
        schema = sm.create_table(row_type, partition_keys, primary_keys, options)
        return FileStoreTable(self.file_io, path, schema, self.commit_user, self.device)

    def system_table(self, name: str):
        """A catalog-scope system table: all_table_options, catalog_options
        or one of the four lineage tables (catalog/globals.py)."""
        from .globals import global_system_table

        return global_system_table(self, name)

    def lineage_meta(self):
        """The catalog's lineage store (catalog/globals.py FsLineageMeta)."""
        from .globals import FsLineageMeta

        return FsLineageMeta(self)

    def get_table(self, identifier: "Identifier | str"):
        """The data table, for "db.t$name" the system table `name` of db.t
        (table/system.py), and for "sys.name" a catalog-scope one."""
        ident = Identifier.parse(identifier) if isinstance(identifier, str) else identifier
        if ident.database == "sys":
            return self.system_table(ident.table)
        if self.SYSTEM_SEP in ident.table:
            from ..table.system import system_table

            base, _, sys_name = ident.table.partition(self.SYSTEM_SEP)
            return system_table(self.get_table(Identifier(ident.database, base)), sys_name)
        path = self.table_path(identifier)
        schema = SchemaManager(self._meta_io, path).latest()
        if schema is None:
            raise FileNotFoundError(f"table {identifier} does not exist")
        return FileStoreTable(self.file_io, path, schema, self.commit_user, self.device)

    def alter_table(self, identifier: "Identifier | str", *changes: dict) -> TableSchema:
        """ALTER TABLE: commit SchemaChanges as the table's next schema
        (core/schema.py); a table opened afterwards reads its older files
        under it."""
        return SchemaManager(self.file_io, self.table_path(identifier)).commit_changes(*changes)
