"""A catalog whose metadata lives in a SQL database, and its lock (port of
paimon_tpu/catalog/jdbc.py).

JdbcCatalog keeps the databases and tables (name -> location) in sqlite
tables instead of listing the warehouse; the tables' data stays on the
warehouse's filesystem, as under FileSystemCatalog. The database schema
(`_SCHEMA`, `_LOCK_TABLE_DDL`) is the JAX package's, so both packages open
one database file and see the same databases, tables and lock rows.

JdbcCatalogLock is the lock dialect: acquiring inserts a row keyed by the
lock id (the database serialises racers), releasing deletes the holder's
own row, a heartbeat refreshes it, and a row older than the stale TTL is
taken to be a crashed holder's and swept. commit.catalog-lock.type=jdbc
(core/commit.py) runs each commit under one, keyed by the table path.

Each operation opens its own short-lived connection with a 30 s busy
timeout and closes it: one connection shared by a committer's threads and
the heartbeat would break sqlite3's same-thread check.

The catalog's `device` ("cuda" by default) reaches every table it opens or
creates, as in FileSystemCatalog.
"""

from __future__ import annotations

import sqlite3
import threading
import time
import uuid
from contextlib import contextmanager
from typing import Sequence

import torch

from ..core.schema import SchemaManager
from ..fs import FileIO, get_file_io
from ..table import FileStoreTable
from ..types import RowType
from ..utils import resolve_device
from ..utils.cache import invalidate_table_path
from . import Catalog, Identifier
from .lock import CatalogLock

__all__ = ["JdbcCatalog", "JdbcCatalogLock"]

_LOCK_TABLE_DDL = """
CREATE TABLE IF NOT EXISTS paimon_distributed_locks (
    lock_id TEXT PRIMARY KEY,
    holder TEXT NOT NULL,
    acquired_at REAL NOT NULL
);
"""

_SCHEMA = (
    """
CREATE TABLE IF NOT EXISTS paimon_databases (
    name TEXT PRIMARY KEY
);
CREATE TABLE IF NOT EXISTS paimon_tables (
    database_name TEXT NOT NULL,
    table_name TEXT NOT NULL,
    location TEXT NOT NULL,
    PRIMARY KEY (database_name, table_name)
);
"""
    + _LOCK_TABLE_DDL
)


@contextmanager
def _connect(db_path: str):
    """One connection for one operation, committed and closed at its end."""
    c = sqlite3.connect(db_path, timeout=30.0)
    c.execute("PRAGMA busy_timeout = 30000")
    try:
        with c:
            yield c
    finally:
        c.close()


def _ident(identifier: "Identifier | str") -> Identifier:
    return Identifier.parse(identifier) if isinstance(identifier, str) else identifier


class JdbcCatalog(Catalog):
    def __init__(self, db_path: str, warehouse: str, commit_user: str = "anonymous",
                 device: "str | torch.device" = "cuda"):
        self.device = resolve_device(device)
        self.db_path = db_path
        self.warehouse = warehouse.rstrip("/")
        self.file_io: FileIO = get_file_io(warehouse)
        self.commit_user = commit_user
        with self._conn() as c:
            c.executescript(_SCHEMA)

    def _conn(self):
        return _connect(self.db_path)

    def _table(self, location: str, schema) -> FileStoreTable:
        return FileStoreTable(self.file_io, location, schema, self.commit_user, self.device)

    # ---- databases -----------------------------------------------------
    def list_databases(self) -> list[str]:
        with self._conn() as c:
            return sorted(r[0] for r in c.execute("SELECT name FROM paimon_databases"))

    def create_database(self, name: str, ignore_if_exists: bool = True) -> None:
        if name == "sys":
            raise ValueError("'sys' is reserved for catalog system tables")
        with self._conn() as c:
            try:
                c.execute("INSERT INTO paimon_databases (name) VALUES (?)", (name,))
            except sqlite3.IntegrityError:
                if not ignore_if_exists:
                    raise ValueError(f"database {name} exists") from None

    def drop_database(self, name: str, cascade: bool = False) -> None:
        tables = self.list_tables(name)
        if not cascade and tables:
            raise ValueError(f"database {name} is not empty")
        # the data goes too: a table created again under the name starts
        # empty instead of reading the old schema and files
        for tbl in tables:
            self.drop_table(Identifier(name, tbl))
        with self._conn() as c:
            c.execute("DELETE FROM paimon_tables WHERE database_name = ?", (name,))
            c.execute("DELETE FROM paimon_databases WHERE name = ?", (name,))

    # ---- tables --------------------------------------------------------
    def list_tables(self, database: str) -> list[str]:
        with self._conn() as c:
            rows = c.execute("SELECT table_name FROM paimon_tables WHERE database_name = ?", (database,))
            return sorted(r[0] for r in rows)

    def _location(self, ident: Identifier) -> str | None:
        with self._conn() as c:
            row = c.execute(
                "SELECT location FROM paimon_tables WHERE database_name = ? AND table_name = ?",
                (ident.database, ident.table),
            ).fetchone()
        return row[0] if row else None

    def create_table(
        self,
        identifier: "Identifier | str",
        row_type: RowType,
        partition_keys: Sequence[str] = (),
        primary_keys: Sequence[str] = (),
        options: dict | None = None,
        ignore_if_exists: bool = False,
    ) -> FileStoreTable:
        ident = _ident(identifier)
        self.create_database(ident.database)
        location = f"{self.warehouse}/{ident.database}.db/{ident.table}"
        with self._conn() as c:
            try:
                c.execute(
                    "INSERT INTO paimon_tables (database_name, table_name, location) VALUES (?, ?, ?)",
                    (ident.database, ident.table, location),
                )
            except sqlite3.IntegrityError:
                if not ignore_if_exists:
                    raise ValueError(f"table {ident} exists") from None
        sm = SchemaManager(self.file_io, location)
        schema = sm.latest()
        if schema is None:
            schema = sm.create_table(row_type, partition_keys, primary_keys, options)
        return self._table(location, schema)

    def get_table(self, identifier: "Identifier | str"):
        """The data table, or for "db.t$name" the system table `name` of
        db.t (table/system.py)."""
        ident = _ident(identifier)
        base, sep, sys_name = ident.table.partition("$")
        location = self._location(Identifier(ident.database, base))
        if location is None:
            raise FileNotFoundError(f"table {ident.database}.{base} not in catalog")
        schema = SchemaManager(self.file_io, location).latest()
        if schema is None:
            raise FileNotFoundError(f"table {ident} has no schema at {location}")
        table = self._table(location, schema)
        if sep:
            from ..table.system import system_table

            return system_table(table, sys_name)
        return table

    def drop_table(self, identifier: "Identifier | str") -> None:
        ident = _ident(identifier)
        location = self._location(ident)
        with self._conn() as c:
            c.execute(
                "DELETE FROM paimon_tables WHERE database_name = ? AND table_name = ?",
                (ident.database, ident.table),
            )
        if location:
            self.file_io.delete(location, recursive=True)
            invalidate_table_path(location)

    def rename_table(self, src: "Identifier | str", dst: "Identifier | str") -> None:
        """Renames the catalog row only: the table keeps its location."""
        s, d = _ident(src), _ident(dst)
        if self._location(s) is None:
            raise FileNotFoundError(f"table {s} not in catalog")
        with self._conn() as c:
            if c.execute(
                "SELECT 1 FROM paimon_tables WHERE database_name = ? AND table_name = ?",
                (d.database, d.table),
            ).fetchone():
                raise ValueError(f"cannot rename {s} -> {d} (destination exists)")
            c.execute(
                "UPDATE paimon_tables SET database_name = ?, table_name = ? "
                "WHERE database_name = ? AND table_name = ?",
                (d.database, d.table, s.database, s.table),
            )

    def repair(self, identifier: str | None = None) -> dict:
        """Bring the catalog's rows in line with the warehouse. A table is
        identified by its stored location, not by its name (a renamed table
        keeps its path):
        - a row whose location holds no schema is removed;
        - a schema tree on disk that no row's location names is registered
          under its directory's name;
        - a database with neither a directory nor table rows is removed.
        `identifier` ('db' or 'db.t') limits the repair to that database or
        table. Returns {"registered", "removed", "removed_databases"}."""
        scope_db = scope_table = None
        if identifier:
            scope_db, _, scope_table = identifier.partition(".")
            scope_table = scope_table or None
        registered: list[str] = []
        removed: list[str] = []
        removed_dbs: list[str] = []
        on_disk: dict[str, dict[str, str]] = {}  # db -> {table: location}
        try:
            entries = self.file_io.list_status(self.warehouse)
        except OSError:
            entries = []
        for st in entries:
            base = st.path.rstrip("/").rsplit("/", 1)[-1]
            if not base.endswith(".db"):
                continue
            db = base[: -len(".db")]
            if scope_db and db != scope_db:
                continue
            tables: dict[str, str] = {}
            for ts in self.file_io.list_status(st.path):
                tname = ts.path.rstrip("/").rsplit("/", 1)[-1]
                if scope_table and tname != scope_table:
                    continue
                if SchemaManager(self.file_io, ts.path).latest() is not None:
                    tables[tname] = ts.path.rstrip("/")
            on_disk[db] = tables
        with self._conn() as c:
            live_locations: set[str] = set()
            for db, tname, location in list(
                c.execute("SELECT database_name, table_name, location FROM paimon_tables")
            ):
                if scope_db and (db != scope_db or (scope_table and tname != scope_table)):
                    continue
                if SchemaManager(self.file_io, location).latest() is None:
                    c.execute(
                        "DELETE FROM paimon_tables WHERE database_name = ? AND table_name = ?", (db, tname)
                    )
                    removed.append(f"{db}.{tname}")
                else:
                    live_locations.add(location.rstrip("/"))
            for db, tables in on_disk.items():
                c.execute("INSERT OR IGNORE INTO paimon_databases (name) VALUES (?)", (db,))
                for tname, location in tables.items():
                    if location in live_locations:
                        continue  # registered already, maybe under another name
                    cur = c.execute(
                        "INSERT OR IGNORE INTO paimon_tables (database_name, table_name, location) "
                        "VALUES (?, ?, ?)",
                        (db, tname, location),
                    )
                    if cur.rowcount:
                        registered.append(f"{db}.{tname}")
            for (db,) in list(c.execute("SELECT name FROM paimon_databases")):
                if db in on_disk or scope_table or (scope_db and db != scope_db):
                    continue  # a scoped repair drops no other database
                has_rows = c.execute(
                    "SELECT 1 FROM paimon_tables WHERE database_name = ? LIMIT 1", (db,)
                ).fetchone()
                if not has_rows:
                    c.execute("DELETE FROM paimon_databases WHERE name = ?", (db,))
                    removed_dbs.append(db)
        return {
            "registered": sorted(registered),
            "removed": sorted(removed),
            "removed_databases": sorted(removed_dbs),
        }

    def lock(self, identifier: "Identifier | str") -> "JdbcCatalogLock":
        ident = _ident(identifier)
        return JdbcCatalogLock(self.db_path, f"{ident.database}.{ident.table}")


class JdbcCatalogLock(CatalogLock):
    """Acquire inserts a unique lock row, a heartbeat refreshes it, release
    deletes this holder's row only; a row older than `stale_ttl` seconds is
    a crashed holder's and is swept by the next acquirer."""

    def __init__(self, db_path: str, lock_id: str, timeout: float = 60.0, stale_ttl: float = 300.0):
        self.db_path = db_path
        self.lock_id = lock_id
        self.timeout = timeout
        self.stale_ttl = stale_ttl
        self.holder = uuid.uuid4().hex
        # a lock without a JdbcCatalog needs the lock table first
        with self._conn() as c:
            c.executescript(_LOCK_TABLE_DDL)

    def _conn(self):
        return _connect(self.db_path)

    @contextmanager
    def lock(self, database: str = "", table: str = ""):
        deadline = time.monotonic() + self.timeout
        while True:
            with self._conn() as c:
                c.execute(
                    "DELETE FROM paimon_distributed_locks WHERE lock_id = ? AND acquired_at < ?",
                    (self.lock_id, time.time() - self.stale_ttl),
                )
                try:
                    c.execute(
                        "INSERT INTO paimon_distributed_locks (lock_id, holder, acquired_at) VALUES (?, ?, ?)",
                        (self.lock_id, self.holder, time.time()),
                    )
                    break
                except sqlite3.IntegrityError:
                    pass
            if time.monotonic() > deadline:
                raise TimeoutError(f"could not acquire jdbc lock {self.lock_id}")
            time.sleep(0.05)
        # the heartbeat keeps a long commit from reading as a crashed holder
        stop = threading.Event()

        def beat():
            interval = self.stale_ttl / 3
            while not stop.wait(interval):
                try:
                    with self._conn() as c:
                        cur = c.execute(
                            "UPDATE paimon_distributed_locks SET acquired_at = ? WHERE lock_id = ? AND holder = ?",
                            (time.time(), self.lock_id, self.holder),
                        )
                        if cur.rowcount == 0:
                            return  # the row was swept: the lock is lost
                    interval = self.stale_ttl / 3
                except sqlite3.Error:
                    # a busy or failing database: beat again sooner while
                    # the holder is still inside
                    interval = min(1.0, self.stale_ttl / 10)

        hb = threading.Thread(target=beat, name="paimon-jdbc-lock-heartbeat", daemon=True)
        hb.start()
        try:
            yield
        finally:
            stop.set()
            hb.join(timeout=1.0)
            with self._conn() as c:
                c.execute(
                    "DELETE FROM paimon_distributed_locks WHERE lock_id = ? AND holder = ?",
                    (self.lock_id, self.holder),
                )
