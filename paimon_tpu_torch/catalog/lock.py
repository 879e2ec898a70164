"""Catalog locks: commit mutual exclusion where rename is not atomic (port
of paimon_tpu/catalog/lock.py).

On object stores without an atomic rename the snapshot CAS degrades, so
commits run under a lock. FileBasedCatalogLock claims an exclusively
created lock file in the table directory (holder id and timestamp inside,
a heartbeat refreshing it) and takes over a holder's lock once it is
older than the stale TTL. The jdbc lock is catalog/jdbc.py's
JdbcCatalogLock.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from contextlib import contextmanager

__all__ = ["CatalogLock", "FileBasedCatalogLock"]


class CatalogLock:
    """SPI: mutual exclusion for one table's commits."""

    @contextmanager
    def lock(self, database: str, table: str):  # pragma: no cover - interface
        raise NotImplementedError
        yield


class FileBasedCatalogLock(CatalogLock):
    """Lock file next to the table metadata: created O_EXCL (one winner),
    holder id + timestamp inside, stale locks (crashed holders) taken over
    after `stale_ttl` seconds."""

    def __init__(self, file_io, table_path: str, timeout: float = 60.0, stale_ttl: float = 300.0):
        self.file_io = file_io
        self.table_path = table_path
        self.timeout = timeout
        self.stale_ttl = stale_ttl
        self.holder = uuid.uuid4().hex

    def _path(self) -> str:
        return f"{self.table_path}/.catalog-lock"

    @contextmanager
    def lock(self, database: str = "", table: str = ""):
        path = self._path()
        deadline = time.monotonic() + self.timeout
        while True:
            try:
                payload = f"{self.holder} {time.time()}".encode()
                # write_bytes without overwrite is O_EXCL on LocalFileIO
                self.file_io.write_bytes(path, payload, overwrite=False)
                break
            except FileExistsError:
                try:
                    raw = self.file_io.read_bytes(path)
                    _, ts = raw.decode().split()
                    if time.time() - float(ts) > self.stale_ttl:
                        self._sweep_stale(path, raw)
                        continue
                except Exception:
                    pass
                if time.monotonic() > deadline:
                    raise TimeoutError(f"could not acquire catalog lock {path}")
                time.sleep(0.05)
        # heartbeat: refresh our timestamp so a long commit is never mistaken
        # for a crashed holder and stolen mid-flight
        stop = threading.Event()

        def beat():
            interval = self.stale_ttl / 3
            while not stop.wait(interval):
                try:
                    raw = self.file_io.read_bytes(path).decode()
                    if raw.split()[0] != self.holder:
                        return  # lost the lock (TTL takeover): stop touching it
                    self.file_io.write_bytes(path, f"{self.holder} {time.time()}".encode(), overwrite=True)
                    interval = self.stale_ttl / 3
                except Exception:
                    # transient IO hiccup: keep beating (retry sooner), else a
                    # waiter would sweep the "stale" lock while we still hold
                    # the critical section.  A real takeover is detected above
                    # by the holder mismatch once reads succeed again.
                    interval = min(1.0, self.stale_ttl / 10)

        hb = threading.Thread(target=beat, daemon=True)
        hb.start()
        try:
            yield
        finally:
            stop.set()
            hb.join(timeout=1.0)
            # release only OUR lock: after a stale-TTL takeover the file may
            # belong to another holder now
            try:
                raw = self.file_io.read_bytes(path).decode()
                if raw.split()[0] == self.holder:
                    self.file_io.delete(path)
            except Exception:
                pass

    def _sweep_stale(self, path: str, raw: bytes) -> None:
        """Remove a crashed holder's lock with exactly-one-deleter semantics.

        The sweep right is a CAS on a tombstone keyed by the stale lock's
        CONTENT (holder uuid + timestamp — unique per incarnation): whoever
        exclusively creates the tombstone is the only process allowed to
        delete that incarnation, and it re-checks the content first.  A racer
        can therefore never delete a FRESH lock another waiter just created.
        (The previous design renamed the lock away, but rename is
        copy+delete on object stores — the delete half could land on a fresh
        lock.)  A sweeper that crashes mid-sweep leaves its tombstone; other
        waiters clear tombstones older than stale_ttl."""
        import hashlib

        tomb = f"{path}.sweep-{hashlib.sha1(raw).hexdigest()[:16]}"
        if self.file_io.try_atomic_write(tomb, f"{time.time()}".encode()):
            try:
                if self.file_io.read_bytes(path) == raw:
                    self.file_io.delete(path)
            except Exception:
                pass
            finally:
                try:
                    self.file_io.delete(tomb)
                except Exception:
                    pass
        else:
            # another waiter owns this sweep; clear its tombstone if it
            # crashed mid-sweep so the takeover can eventually proceed
            try:
                t = float(self.file_io.read_bytes(tomb).decode())
                if time.time() - t > self.stale_ttl:
                    self.file_io.delete(tomb)
            except Exception:
                pass
