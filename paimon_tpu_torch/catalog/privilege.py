"""File-based privileges over a catalog (port of
paimon_tpu/catalog/privilege.py).

PrivilegeManager keeps users (SHA-256 password hashes) and grants in
<warehouse>/.privilege/meta.json, in the JAX package's layout:
{"users": {user: hash}, "grants": {user: {object: [privilege, ...]}}}, so
that each package enforces the grants the other made. An object is "*",
a database or "db.table"; a table's grant is inherited from its database's
and from "*", and ADMIN implies the others. root holds every privilege.

PrivilegedCatalog wraps a FileSystemCatalog: opening a table needs SELECT,
`writable_table` INSERT, creating or dropping ADMIN. Before
`PrivilegeManager.init` nothing is enforced.
"""

from __future__ import annotations

import hashlib

import torch

from ..fs import get_file_io
from ..utils import dumps, loads
from . import Catalog, FileSystemCatalog, Identifier

__all__ = ["PrivilegedCatalog", "PrivilegeManager", "AccessDeniedError"]

SELECT = "SELECT"
INSERT = "INSERT"
ADMIN = "ADMIN"


class AccessDeniedError(PermissionError):
    pass


class PrivilegeManager:
    ROOT = "root"

    def __init__(self, warehouse: str):
        self.file_io = get_file_io(warehouse)
        self.path = f"{warehouse}/.privilege/meta.json"

    def _load(self) -> dict:
        try:
            return loads(self.file_io.read_bytes(self.path))
        except (OSError, ValueError):
            return {"users": {}, "grants": {}}

    def _save(self, d: dict) -> None:
        self.file_io.try_overwrite(self.path, dumps(d).encode())

    @staticmethod
    def _hash(password: str) -> str:
        return hashlib.sha256(password.encode()).hexdigest()

    def initialized(self) -> bool:
        return self.file_io.exists(self.path)

    def init(self, root_password: str) -> None:
        if self.initialized():
            raise ValueError("privileges already initialized")
        self._save({"users": {self.ROOT: self._hash(root_password)}, "grants": {}})

    def create_user(self, user: str, password: str) -> None:
        d = self._load()
        if user in d["users"]:
            raise ValueError(f"user {user} exists")
        d["users"][user] = self._hash(password)
        self._save(d)

    def drop_user(self, user: str) -> None:
        d = self._load()
        d["users"].pop(user, None)
        d["grants"].pop(user, None)
        self._save(d)

    def authenticate(self, user: str, password: str) -> bool:
        return self._load()["users"].get(user) == self._hash(password)

    def grant(self, user: str, obj: str, privilege: str) -> None:
        d = self._load()
        if user not in d["users"]:
            raise ValueError(f"no user {user}")
        privs = d["grants"].setdefault(user, {}).setdefault(obj, [])
        if privilege not in privs:
            privs.append(privilege)
        self._save(d)

    def revoke(self, user: str, obj: str, privilege: str) -> None:
        d = self._load()
        privs = d["grants"].get(user, {}).get(obj, [])
        if privilege in privs:
            privs.remove(privilege)
        self._save(d)

    def has(self, user: str, obj: str, privilege: str) -> bool:
        if user == self.ROOT:
            return True
        grants = self._load()["grants"].get(user, {})
        for scope in (obj, obj.split(".")[0], "*"):
            privs = grants.get(scope, ())
            if privilege in privs or ADMIN in privs:
                return True
        return False


class PrivilegedCatalog(Catalog):
    """A FileSystemCatalog on `device` whose operations check the user's
    privileges; the password is checked when it is opened."""

    def __init__(self, warehouse: str, user: str, password: str, device: "str | torch.device" = "cuda"):
        self.manager = PrivilegeManager(warehouse)
        if self.manager.initialized() and not self.manager.authenticate(user, password):
            raise AccessDeniedError(f"authentication failed for {user!r}")
        self.user = user
        self._inner = FileSystemCatalog(warehouse, commit_user=user, device=device)
        self.device = self._inner.device

    def _check(self, obj: str, privilege: str) -> None:
        if self.manager.initialized() and not self.manager.has(self.user, obj, privilege):
            raise AccessDeniedError(f"user {self.user!r} lacks {privilege} on {obj!r}")

    # reads ---------------------------------------------------------------
    def list_databases(self):
        return self._inner.list_databases()

    def list_tables(self, database: str):
        return self._inner.list_tables(database)

    def get_table(self, identifier):
        ident = Identifier.parse(identifier) if isinstance(identifier, str) else identifier
        base = ident.table.split(self._inner.SYSTEM_SEP)[0]
        self._check(f"{ident.database}.{base}", SELECT)
        return self._inner.get_table(identifier)

    # writes --------------------------------------------------------------
    def create_database(self, name: str, ignore_if_exists: bool = True):
        self._check(name, ADMIN)
        return self._inner.create_database(name, ignore_if_exists)

    def drop_database(self, name: str, cascade: bool = False):
        self._check(name, ADMIN)
        return self._inner.drop_database(name, cascade)

    def create_table(self, identifier, row_type, **kw):
        ident = Identifier.parse(identifier) if isinstance(identifier, str) else identifier
        self._check(ident.database, ADMIN)
        return self._inner.create_table(identifier, row_type, **kw)

    def drop_table(self, identifier):
        ident = Identifier.parse(identifier) if isinstance(identifier, str) else identifier
        self._check(f"{ident.database}.{ident.table}", ADMIN)
        return self._inner.drop_table(identifier)

    def writable_table(self, identifier):
        """get_table after an INSERT check: writes go through this table."""
        ident = Identifier.parse(identifier) if isinstance(identifier, str) else identifier
        self._check(f"{ident.database}.{ident.table}", INSERT)
        return self._inner.get_table(identifier)
