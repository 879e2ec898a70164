"""RetryingFileIO: the FileIO wrapper every store-level path routes through
(port of paimon_tpu/resilience/fileio.py).

Installed by core/store.py (KeyValueFileStore wraps its FileIO on
construction), so scan, merge read, commit, compaction and expire all get the
same behavior: transient faults retried under fs.retry.* with decorrelated
jitter, per-op deadlines from fs.io.timeout, everything counted in the
io{retries, giveups, backoff_ms, timeouts} metric group.

Semantics preserved through the wrapper:
- capability flags (atomic_write_supported / exclusive_create_supported)
  shine through, so commits engage the catalog lock exactly as they would on
  the bare store;
- local_path delegates;
- try_atomic_write / try_overwrite delegate to the INNER implementation (an
  object store's conditional PUT must stay that store's protocol) and the
  whole primitive is the retry unit. A retried atomic write whose previous
  attempt tore (tmp written, rename never happened) simply stages a fresh
  uuid-named tmp; the torn sibling becomes an orphan that
  remove_orphan_files reclaims.

Retries of non-idempotent ops are safe against *our* failure modes: a
transient error is raised before the destination mutates (or the op is a
whole-primitive CAS whose loser is well-defined). The two residual races a
real store can produce — a rename that succeeded but whose ack was lost, and
an exclusive create whose first attempt half-landed — both surface as
permanent errors (False / FileExistsError) to the caller, and the commit
protocol resolves them by re-reading the snapshot chain (see
FileStoreCommit._find_own_commit).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from ..fs import FileIO, FileStatus
from ..metrics import io_metrics
from .retry import RetryPolicy

if TYPE_CHECKING:
    from ..options import CoreOptions

__all__ = ["RetryingFileIO", "wrap_file_io"]


class RetryingFileIO(FileIO):
    def __init__(self, inner: FileIO, policy: RetryPolicy | None = None):
        self._inner = inner
        self.policy = policy or RetryPolicy()
        self.atomic_write_supported = getattr(inner, "atomic_write_supported", True)
        self.exclusive_create_supported = getattr(inner, "exclusive_create_supported", True)

    def _run(self, op: str, fn):
        return self.policy.run(op, fn, metrics=io_metrics())

    # ---- primitives ----------------------------------------------------
    def read_bytes(self, path: str) -> bytes:
        return self._run("read_bytes", lambda: self._inner.read_bytes(path))

    def write_bytes(self, path: str, data: bytes, overwrite: bool = False) -> None:
        return self._run("write_bytes", lambda: self._inner.write_bytes(path, data, overwrite))

    def exists(self, path: str) -> bool:
        return self._run("exists", lambda: self._inner.exists(path))

    def delete(self, path: str, recursive: bool = False) -> bool:
        return self._run("delete", lambda: self._inner.delete(path, recursive))

    def mkdirs(self, path: str) -> None:
        return self._run("mkdirs", lambda: self._inner.mkdirs(path))

    def rename(self, src: str, dst: str) -> bool:
        return self._run("rename", lambda: self._inner.rename(src, dst))

    def list_status(self, path: str) -> list[FileStatus]:
        return self._run("list_status", lambda: self._inner.list_status(path))

    def get_status(self, path: str) -> FileStatus:
        return self._run("get_status", lambda: self._inner.get_status(path))

    # ---- composite primitives (the inner's protocol is the retry unit) --
    def try_atomic_write(self, path: str, data: bytes) -> bool:
        return self._run("try_atomic_write", lambda: self._inner.try_atomic_write(path, data))

    def try_overwrite(self, path: str, data: bytes) -> bool:
        return self._run("try_overwrite", lambda: self._inner.try_overwrite(path, data))

    # ---- pass-throughs -------------------------------------------------
    def open_input(self, path: str):
        # the open is retried; reads on the returned stream are the format
        # layer's (a stream that dies mid-read re-opens via its own caller)
        return self._run("open_input", lambda: self._inner.open_input(path))

    def local_path(self, path: str) -> str | None:
        return self._inner.local_path(path)


def wrap_file_io(file_io: FileIO, options: "CoreOptions | None") -> FileIO:
    """RetryingFileIO per fs.retry.* / fs.io.timeout, or `file_io` unchanged
    when retries are disabled (fs.retry.max-attempts <= 1 and no timeout) or
    it is already wrapped — the disabled path adds zero indirection."""
    if isinstance(file_io, RetryingFileIO) or options is None:
        return file_io
    from ..options import CoreOptions

    opts = options.options
    max_attempts = opts.get(CoreOptions.FS_RETRY_MAX_ATTEMPTS)
    timeout = opts.get(CoreOptions.FS_IO_TIMEOUT)
    policy = RetryPolicy(
        max_attempts=max(1, int(max_attempts)),
        initial_backoff_ms=float(opts.get(CoreOptions.FS_RETRY_INITIAL_BACKOFF)),
        max_backoff_ms=float(opts.get(CoreOptions.FS_RETRY_MAX_BACKOFF)),
        timeout_ms=None if timeout is None else float(timeout),
    )
    if not policy.enabled:
        return file_io
    return RetryingFileIO(file_io, policy)
