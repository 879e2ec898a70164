"""Fault-injecting and leak-tracking FileIO wrappers (port of
paimon_tpu/fs/testing.py), package code so that test suites, soaks and the
chip smoke run the whole store stack over them unchanged.

FailingFileIO fails operations of a named domain, probabilistically
(`reset(name, max_fails, possibility, seed)`) or by a scripted schedule of
FaultRules; LatencyFileIO adds a fixed sleep per operation;
TraceableFileIO tracks open streams. Importing this module registers the
schemes fail, latency, chaos, fail-s3, fail-s3-legacy and traceable.
PAIMON_TPU_CHAOS (`apply_chaos_env`) shapes the chaos store of a child
process, as in the JAX package; nothing happens when it is unset.
"""

from __future__ import annotations

import os
import random
import threading
from dataclasses import dataclass, field, replace

from . import FileIO, FileStatus, LocalFileIO, register_file_io, split_scheme


def _posix_backed(io: FileIO) -> bool:
    """Walk a wrapper chain's `_inner` links: does this stack bottom out on
    plain POSIX rename (LocalFileIO)? Wrappers are composable (chaos =
    faults over latency over local), so the decision "decompose
    try_atomic_write into write+rename with crash-realistic injection" vs
    "delegate to an overriding commit primitive (object-store conditional
    PUT)" must look through every layer, not just the immediate inner."""
    seen: set[int] = set()
    while not isinstance(io, LocalFileIO):
        if id(io) in seen:
            return False
        seen.add(id(io))
        nxt = getattr(io, "_inner", None)
        if nxt is None:
            return False
        io = nxt
    return True


class ArtificialException(IOError):
    """Deliberately injected failure. Carries the resilience layer's explicit
    `transient = True` marker (see resilience.retry.is_transient), so it
    classifies TRANSIENT exactly like a real object-store blip and retry
    behavior is provable with it."""

    transient = True


@dataclass
class FaultRule:
    """One deterministic scripted fault: fail ops whose kind matches `op`
    ('read' | 'write' | 'rename' | 'delete' | 'atomic' | '*') and whose
    LOGICAL path (scheme and domain stripped; for renames, the destination)
    contains `path`. Fires on the nth..nth+count-1 matching ops (1-based);
    count <= 0 keeps firing forever.

    The two canonical shapes: FaultRule(op, path, nth=N) = "fail the Nth op
    matching this pattern"; FaultRule(op, path) = fail-once-then-succeed.
    A rule on op='rename' against a path written with try_atomic_write is a
    TORN write: the tmp sibling is already on disk and stays there (crash
    semantics — see FailingFileIO.try_atomic_write)."""

    op: str = "*"
    path: str | None = None
    nth: int = 1
    count: int = 1
    _seen: int = 0

    def fire(self, op: str, path: str) -> bool:
        if self.op != "*" and self.op != op:
            return False
        if self.path is not None and self.path not in path:
            return False
        self._seen += 1
        if self._seen < self.nth:
            return False
        return self.count <= 0 or self._seen < self.nth + self.count


@dataclass
class _FailState:
    max_fails: int = 0
    possibility: int = 0  # fail with probability 1/possibility
    fails: int = 0
    rng: random.Random = field(default_factory=lambda: random.Random(0))
    lock: threading.Lock = field(default_factory=threading.Lock)
    rules: list[FaultRule] = field(default_factory=list)

    def check(self, op: str, path: str, probabilistic: bool = True) -> None:
        with self.lock:
            for rule in self.rules:
                if rule.fire(op, path):
                    self.fails += 1
                    raise ArtificialException(f"scheduled fault: {op} {path}")
            if probabilistic and self.possibility > 0 and self.fails < self.max_fails:
                if self.rng.randrange(self.possibility) == 0:
                    self.fails += 1
                    raise ArtificialException("artificial failure")

    def maybe_fail(self) -> None:
        self.check("*", "")


class FailingFileIO(FileIO):
    """Randomly throws ArtificialException on read/write, per named domain.

    Usage:
        FailingFileIO.reset("mytest", max_fails=100, possibility=10)
        path = f"fail://mytest{local_dir}"

    Any FileIO can be wrapped (scheme "fail-s3" injects over the
    object-store semantics, proving the commit protocol for that store the
    same way "fail" proves it for POSIX)."""

    _states: dict[str, _FailState] = {}

    def __init__(self, inner: FileIO | None = None):
        self._inner = inner or LocalFileIO()
        # capability flags must shine through the wrapper: a commit over
        # fail-s3 engages the catalog lock exactly like over s3
        self.atomic_write_supported = getattr(self._inner, "atomic_write_supported", True)
        self.exclusive_create_supported = getattr(self._inner, "exclusive_create_supported", True)

    @classmethod
    def reset(cls, name: str, max_fails: int, possibility: int, seed: int = 0) -> None:
        st = _FailState(max_fails, possibility)
        st.rng = random.Random(seed)
        cls._states[name] = st

    @classmethod
    def schedule(cls, name: str, *rules: FaultRule) -> None:
        """Install a DETERMINISTIC fault schedule for `name` (replaces any
        probabilistic state): each rule scripts exactly which ops fail."""
        st = _FailState()
        st.rules = list(rules)
        cls._states[name] = st

    @classmethod
    def fails_injected(cls, name: str) -> int:
        st = cls._states.get(name)
        return 0 if st is None else st.fails

    @classmethod
    def retry_until_success(cls, name: str, fn):
        """Disable injection for `name`, then run fn (for final verification)."""
        cls._states.pop(name, None)
        return fn()

    def _strip(self, path: str) -> tuple[_FailState | None, str]:
        if "://" not in path:
            # already a bare inner path (e.g. a FileStatus.path handed back
            # by a caller) — stripping would eat its first segment as a
            # phantom domain name
            return None, path
        scheme, rest = split_scheme(path)
        # path layout: fail://<name><abs-path>
        name, sep, tail = rest.lstrip("/").partition("/")
        local = "/" + tail
        return self._states.get(name), local

    def _wrap(self, path: str, op: str) -> str:
        st, local = self._strip(path)
        if st is not None:
            st.check(op, local)
        return local

    def read_bytes(self, path: str) -> bytes:
        return self._inner.read_bytes(self._wrap(path, "read"))

    def write_bytes(self, path: str, data: bytes, overwrite: bool = False) -> None:
        self._inner.write_bytes(self._wrap(path, "write"), data, overwrite)

    def exists(self, path: str) -> bool:
        _, local = self._strip(path)
        return self._inner.exists(local)

    def delete(self, path: str, recursive: bool = False) -> bool:
        # deterministic rules only: the probabilistic oracle never fails
        # deletes, but scheduled delete faults let tests prove cleanup
        # failures are non-fatal
        st, local = self._strip(path)
        if st is not None:
            st.check("delete", local, probabilistic=False)
        return self._inner.delete(local, recursive)

    def mkdirs(self, path: str) -> None:
        _, local = self._strip(path)
        self._inner.mkdirs(local)

    def rename(self, src: str, dst: str) -> bool:
        st, s = self._strip(src)
        _, d = self._strip(dst)
        if st is not None:
            st.check("rename", d)
        return self._inner.rename(s, d)

    def list_status(self, path: str) -> list[FileStatus]:
        _, local = self._strip(path)
        children = self._inner.list_status(local)
        if "://" not in path:
            return children
        # re-prefix children so round-trips (exists/get_table on a listed
        # path) keep the scheme + domain and stay under fault injection
        scheme, rest = split_scheme(path)
        name, _, _ = rest.lstrip("/").partition("/")
        return [replace(st, path=f"{scheme}://{name}{st.path}") for st in children]

    def get_status(self, path: str) -> FileStatus:
        _, local = self._strip(path)
        return self._inner.get_status(local)

    def open_input(self, path: str):
        return self._inner.open_input(self._wrap(path, "read"))

    def try_atomic_write(self, path: str, data: bytes) -> bool:
        st, local = self._strip(path)
        if not _posix_backed(self._inner):
            # inner overrides the commit primitive (object store: conditional
            # PUT, no rename) — delegate so the oracle exercises THAT protocol
            if st is not None:
                st.check("atomic", local)
            return self._inner.try_atomic_write(local, data)
        # POSIX temp+rename, decomposed with CRASH-realistic injection:
        # - a fault on the write phase fires before any bytes land;
        # - a fault on the rename phase fires AFTER the tmp write, and the
        #   torn tmp sibling STAYS on disk (a crashed process runs no
        #   cleanup) — reclaiming it is remove_orphan_files' job.
        if st is not None:
            st.check("write", local)
        tmp = self._temp_sibling(local)
        self._inner.write_bytes(tmp, data, overwrite=True)
        if st is not None:
            st.check("rename", local)
        ok = self._inner.rename(tmp, local)
        if not ok:
            # graceful CAS loser (no crash): clean our own staging file
            try:
                self._inner.delete(tmp)
            except Exception:
                pass
        return ok

    def try_overwrite(self, path: str, data: bytes) -> bool:
        if _posix_backed(self._inner):
            return super().try_overwrite(path, data)
        st, local = self._strip(path)
        if st is not None:
            st.check("atomic", local)
        return self._inner.try_overwrite(local, data)


class LatencyFileIO(FileIO):
    """Injects a fixed per-op sleep over LocalFileIO — object-store
    first-byte latency as a local, deterministic effect, so benchmarks and
    tests can measure how much of it the pipelined split scheduler hides
    (overlapped fetches pay the RTT concurrently; a serial scan pays it once
    per file). Paths: ``latency://<abs-path>``. Inherits the base
    local_path=None, so format readers take the stream path where the
    latency is injected — exactly the code path a remote store would use."""

    read_ms: float = 0.0
    write_ms: float = 0.0

    @classmethod
    def configure(cls, read_ms: float = 0.0, write_ms: float = 0.0) -> None:
        cls.read_ms = read_ms
        cls.write_ms = write_ms

    def __init__(self, inner: FileIO | None = None):
        self._inner = inner or LocalFileIO()
        # capability flags shine through, same contract as FailingFileIO —
        # latency over an object store must still engage that store's
        # commit protocol (conditional PUT / catalog lock)
        self.atomic_write_supported = getattr(self._inner, "atomic_write_supported", True)
        self.exclusive_create_supported = getattr(self._inner, "exclusive_create_supported", True)

    def _p(self, path: str) -> str:
        return split_scheme(path)[1]

    def try_atomic_write(self, path: str, data: bytes) -> bool:
        # POSIX bottom: the base temp+rename decomposition routes through
        # self.write_bytes/self.rename, so the write nap is paid exactly once
        # (rename is metadata-only — no first-byte latency on a real store
        # either). Non-POSIX bottom: delegate the overriding commit primitive.
        if _posix_backed(self._inner):
            return super().try_atomic_write(path, data)
        self._nap(LatencyFileIO.write_ms)
        return self._inner.try_atomic_write(self._p(path), data)

    def _nap(self, ms: float) -> None:
        if ms > 0:
            import time

            time.sleep(ms / 1000.0)

    def read_bytes(self, path: str) -> bytes:
        self._nap(LatencyFileIO.read_ms)
        return self._inner.read_bytes(self._p(path))

    def open_input(self, path: str):
        self._nap(LatencyFileIO.read_ms)
        return self._inner.open_input(self._p(path))

    def write_bytes(self, path: str, data: bytes, overwrite: bool = False) -> None:
        self._nap(LatencyFileIO.write_ms)
        self._inner.write_bytes(self._p(path), data, overwrite)

    def exists(self, path: str) -> bool:
        return self._inner.exists(self._p(path))

    def delete(self, path: str, recursive: bool = False) -> bool:
        return self._inner.delete(self._p(path), recursive)

    def mkdirs(self, path: str) -> None:
        self._inner.mkdirs(self._p(path))

    def rename(self, src: str, dst: str) -> bool:
        return self._inner.rename(self._p(src), self._p(dst))

    def list_status(self, path: str) -> list[FileStatus]:
        return self._inner.list_status(self._p(path))

    def get_status(self, path: str) -> FileStatus:
        return self._inner.get_status(self._p(path))


class TraceableFileIO(FileIO):
    """Tracks open streams so tests can assert no reader/writer leaks."""

    open_streams: list[str] = []
    _lock = threading.Lock()

    def __init__(self):
        self._inner = LocalFileIO()

    @classmethod
    def assert_no_leaks(cls) -> None:
        with cls._lock:
            assert not cls.open_streams, f"leaked streams: {cls.open_streams}"

    def _p(self, path: str) -> str:
        return split_scheme(path)[1]

    def open_input(self, path: str):
        f = self._inner.open_input(self._p(path))
        with TraceableFileIO._lock:
            TraceableFileIO.open_streams.append(path)
        orig_close = f.close

        def close():
            with TraceableFileIO._lock:
                if path in TraceableFileIO.open_streams:
                    TraceableFileIO.open_streams.remove(path)
            orig_close()

        f.close = close  # type: ignore[method-assign]
        return f

    # explicit delegation (base-class stubs would otherwise shadow __getattr__)
    def read_bytes(self, path: str) -> bytes:
        return self._inner.read_bytes(self._p(path))

    def write_bytes(self, path: str, data: bytes, overwrite: bool = False) -> None:
        self._inner.write_bytes(self._p(path), data, overwrite)

    def exists(self, path: str) -> bool:
        return self._inner.exists(self._p(path))

    def delete(self, path: str, recursive: bool = False) -> bool:
        return self._inner.delete(self._p(path), recursive)

    def mkdirs(self, path: str) -> None:
        self._inner.mkdirs(self._p(path))

    def rename(self, src: str, dst: str) -> bool:
        return self._inner.rename(self._p(src), self._p(dst))

    def list_status(self, path: str) -> list[FileStatus]:
        return self._inner.list_status(self._p(path))

    def get_status(self, path: str) -> FileStatus:
        return self._inner.get_status(self._p(path))


CHAOS_ENV = "PAIMON_TPU_CHAOS"


def apply_chaos_env(spec: str | None = None) -> None:
    """Parse a chaos spec — ``read_ms=40,write_ms=15,domain=mega0,
    possibility=150,max_fails=100000,seed=7`` — and shape this process's
    chaos stack: class-level latency plus a probabilistic fault domain.
    Reads PAIMON_TPU_CHAOS when `spec` is None, so OS-process children of a
    soak supervisor inherit the exact same store shape with no code
    handshake (the crash-point env idiom applied to IO). The fault domain
    is created only if absent: re-entering the factory mid-run must not
    reset injected-fault counters."""
    if spec is None:
        spec = os.environ.get(CHAOS_ENV, "")
    if not spec:
        return
    cfg = dict(kv.split("=", 1) for kv in spec.split(",") if kv)
    LatencyFileIO.configure(
        read_ms=float(cfg.get("read_ms", 0)), write_ms=float(cfg.get("write_ms", 0))
    )
    domain = cfg.get("domain")
    if domain and domain not in FailingFileIO._states:
        FailingFileIO.reset(
            domain,
            max_fails=int(cfg.get("max_fails", 1 << 30)),
            possibility=int(cfg.get("possibility", 0)),
            seed=int(cfg.get("seed", 0)),
        )


def chaos_spec(
    domain: str,
    read_ms: float = 0.0,
    write_ms: float = 0.0,
    possibility: int = 0,
    max_fails: int = 1 << 30,
    seed: int = 0,
) -> str:
    """Build the PAIMON_TPU_CHAOS value for `apply_chaos_env` — the
    supervisor composes this once, exports it to every child, and applies
    it locally; paths then use ``chaos://<domain><abs-path>``."""
    return (
        f"domain={domain},read_ms={read_ms},write_ms={write_ms},"
        f"possibility={possibility},max_fails={max_fails},seed={seed}"
    )


def _chaos() -> FailingFileIO:
    """The composed chaos store: scripted/probabilistic faults layered over
    latency shaping over local disk, in ONE FileIO stack. Faults are
    checked before the latency nap (a failed op never reaches the store, so
    it must not pay first-byte latency), and try_atomic_write keeps the
    decomposed POSIX crash semantics — a rename-phase fault leaves the torn
    tmp sibling on disk THROUGH the latency layer."""
    apply_chaos_env()
    return FailingFileIO(inner=LatencyFileIO())


def _fail_s3() -> FailingFileIO:
    from .object_store import ObjectStoreFileIO

    return FailingFileIO(inner=ObjectStoreFileIO(conditional_put=True))


def _fail_s3_legacy() -> FailingFileIO:
    from .object_store import ObjectStoreFileIO

    return FailingFileIO(inner=ObjectStoreFileIO(conditional_put=False))


register_file_io("fail", FailingFileIO)
register_file_io("latency", LatencyFileIO)
register_file_io("chaos", _chaos)
register_file_io("fail-s3", _fail_s3)
register_file_io("fail-s3-legacy", _fail_s3_legacy)
register_file_io("traceable", TraceableFileIO)
