"""The filesystem abstraction (port of paimon_tpu/fs/__init__.py): the
FileIO base, split_scheme, the scheme registry and LocalFileIO.

The commit protocol needs one thing from the filesystem: publish a file at
a path only if nothing is there yet. `try_atomic_write` writes a hidden
temp sibling and renames it into place; LocalFileIO's rename hard-links
(link fails with EEXIST, so exactly one racing writer wins). Stores that
cannot do that say so with `atomic_write_supported` (commits then run
under the catalog lock) and `exclusive_create_supported` (the file lock
then cannot work).

`get_file_io(path)` picks the FileIO by the path's scheme: a bare path or
file:// is local; s3://, oss:// and s3-legacy:// load fs/object_store.py
on first use; fs/testing.py registers the fault-injecting schemes (fail,
fail-s3, fail-s3-legacy, latency, chaos, traceable) when it is imported.
"""

from __future__ import annotations

import io
import os
import shutil
import threading
import uuid
from dataclasses import dataclass
from typing import Callable
from urllib.parse import urlparse

__all__ = ["FileStatus", "FileIO", "LocalFileIO", "register_file_io", "get_file_io", "split_scheme"]


@dataclass(frozen=True)
class FileStatus:
    path: str
    size: int
    is_dir: bool
    mtime_millis: int = 0


def split_scheme(path: str) -> tuple[str, str]:
    """("file", "/a/b") from "file:///a/b" or a bare "/a/b"."""
    if "://" not in path:
        return "file", path
    p = urlparse(path)
    return p.scheme, (p.netloc + p.path if p.netloc else p.path)


class FileIO:
    """Abstract filesystem. Paths are absolute strings, optionally with a
    scheme, which implementations strip with split_scheme."""

    # False on stores without a no-clobber rename: commits then run under
    # the catalog lock
    atomic_write_supported: bool = True
    # False on stores without exclusive create (no conditional PUT): the
    # file-based catalog lock cannot work there
    exclusive_create_supported: bool = True

    # ---- primitives ----------------------------------------------------
    def read_bytes(self, path: str) -> bytes:
        raise NotImplementedError

    def write_bytes(self, path: str, data: bytes, overwrite: bool = False) -> None:
        """overwrite=False is an atomic exclusive create (FileExistsError
        for a loser): the catalog lock rests on it."""
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def delete(self, path: str, recursive: bool = False) -> bool:
        raise NotImplementedError

    def mkdirs(self, path: str) -> None:
        raise NotImplementedError

    def rename(self, src: str, dst: str) -> bool:
        """Move; False (and no partial state) if dst exists."""
        raise NotImplementedError

    def list_status(self, path: str) -> list[FileStatus]:
        raise NotImplementedError

    def get_status(self, path: str) -> FileStatus:
        raise NotImplementedError

    # ---- derived helpers -----------------------------------------------
    def try_atomic_write(self, path: str, data: bytes) -> bool:
        """The commit primitive: write a hidden temp sibling, then rename it
        into place. False if `path` already exists (lost the CAS race);
        never leaves a partial destination."""
        tmp = self._temp_sibling(path)
        self.write_bytes(tmp, data, overwrite=True)
        try:
            ok = self.rename(tmp, path)
        finally:
            if self.exists(tmp):
                try:
                    self.delete(tmp)
                except Exception:  # noqa: BLE001 - the rename's outcome wins
                    pass
        return ok

    def _temp_sibling(self, path: str) -> str:
        d, b = os.path.split(path)
        return os.path.join(d, f".{b}.{uuid.uuid4().hex}.tmp")

    def read_text(self, path: str) -> str:
        return self.read_bytes(path).decode("utf-8")

    def write_text(self, path: str, text: str, overwrite: bool = False) -> None:
        self.write_bytes(path, text.encode("utf-8"), overwrite)

    def try_overwrite(self, path: str, data: bytes) -> bool:
        """Replace a hint file through temp, delete and rename: readers may
        briefly miss it but never see a partial one. False if a concurrent
        writer re-created it first; the temp file never leaks."""
        tmp = self._temp_sibling(path)
        self.write_bytes(tmp, data, overwrite=True)
        try:
            self.delete(path)
            ok = self.rename(tmp, path)
        finally:
            if self.exists(tmp):
                try:
                    self.delete(tmp)
                except Exception:  # noqa: BLE001 - the rename's outcome wins
                    pass
        return ok

    def list_files(self, path: str) -> list[FileStatus]:
        return [s for s in self.list_status(path) if not s.is_dir]

    def open_input(self, path: str) -> io.BufferedIOBase:
        """A seekable stream over the file."""
        return io.BytesIO(self.read_bytes(path))

    def local_path(self, path: str) -> str | None:
        """The OS path of `path`, or None when the store is not the local
        filesystem (wrappers that intercept reads keep None)."""
        return None


class LocalFileIO(FileIO):
    """The local filesystem. rename hard-links and unlinks, so it never
    clobbers: exactly one of racing renames onto one path wins."""

    def _p(self, path: str) -> str:
        return split_scheme(path)[1]

    def read_bytes(self, path: str) -> bytes:
        with open(self._p(path), "rb") as f:
            return f.read()

    def write_bytes(self, path: str, data: bytes, overwrite: bool = False) -> None:
        p = self._p(path)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        if overwrite:
            with open(p, "wb") as f:
                f.write(data)
            return
        fd = os.open(p, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o666)
        with os.fdopen(fd, "wb") as f:
            f.write(data)

    def exists(self, path: str) -> bool:
        return os.path.exists(self._p(path))

    def delete(self, path: str, recursive: bool = False) -> bool:
        """Remove a file or an empty directory (OSError when it is not
        empty), or with `recursive` a directory and all it holds; False
        when nothing is there."""
        p = self._p(path)
        try:
            if os.path.isdir(p):
                if recursive:
                    shutil.rmtree(p)
                else:
                    os.rmdir(p)
            else:
                os.remove(p)
            return True
        except FileNotFoundError:
            return False

    def mkdirs(self, path: str) -> None:
        os.makedirs(self._p(path), exist_ok=True)

    def rename(self, src: str, dst: str) -> bool:
        """No-clobber move: False (and no partial state) if dst exists. A
        directory (a table renamed by the catalog) moves by os.rename."""
        s, d = self._p(src), self._p(dst)
        os.makedirs(os.path.dirname(d), exist_ok=True)
        if os.path.isdir(s):
            if os.path.exists(d):
                return False
            os.rename(s, d)
            return True
        try:
            os.link(s, d)
        except FileExistsError:
            return False
        os.unlink(s)
        return True

    def list_status(self, path: str) -> list[FileStatus]:
        p = self._p(path)
        if not os.path.isdir(p):
            return []
        out = []
        for name in sorted(os.listdir(p)):
            fp = os.path.join(p, name)
            try:
                st = os.stat(fp)
            except FileNotFoundError:
                continue
            out.append(FileStatus(fp, st.st_size, os.path.isdir(fp), int(st.st_mtime * 1000)))
        return out

    def get_status(self, path: str) -> FileStatus:
        p = self._p(path)
        st = os.stat(p)
        return FileStatus(p, st.st_size, os.path.isdir(p), int(st.st_mtime * 1000))

    def open_input(self, path: str) -> io.BufferedIOBase:
        return open(self._p(path), "rb")

    def local_path(self, path: str) -> str:
        return self._p(path)


_REGISTRY: dict[str, Callable[[], FileIO]] = {}
_LOCK = threading.Lock()


def register_file_io(scheme: str, factory: Callable[[], FileIO]) -> None:
    """Register the FileIO factory of a scheme."""
    with _LOCK:
        _REGISTRY[scheme] = factory


def get_file_io(path: str) -> FileIO:
    """A new FileIO for `path`'s scheme. An unknown scheme loads
    fs/object_store.py first (it registers s3, oss and s3-legacy); a bare
    or file:// path is local; anything else raises ValueError."""
    scheme, _ = split_scheme(path)
    with _LOCK:
        factory = _REGISTRY.get(scheme)
    if factory is None:
        from . import object_store  # noqa: F401  (registers its schemes)

        with _LOCK:
            factory = _REGISTRY.get(scheme)
    if factory is not None:
        return factory()
    if scheme == "file":
        return LocalFileIO()
    raise ValueError(f"no FileIO registered for scheme {scheme!r} ({path})")
