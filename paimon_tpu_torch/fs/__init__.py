"""Local filesystem access with the atomic-rename commit primitive (port
of paimon_tpu/fs/__init__.py, LocalFileIO only).

The commit protocol needs one thing from the filesystem: publish a file at
a path only if nothing is there yet. `try_atomic_write` writes a hidden
temp sibling and hard-links it into place (link fails with EEXIST, so
exactly one racing writer wins).
"""

from __future__ import annotations

import os
import shutil
import uuid
from dataclasses import dataclass

__all__ = ["FileStatus", "LocalFileIO"]


@dataclass(frozen=True)
class FileStatus:
    path: str
    size: int
    is_dir: bool
    mtime_millis: int = 0


def _strip_scheme(path: str) -> str:
    return path[len("file://") :] if path.startswith("file://") else path


class LocalFileIO:
    def read_bytes(self, path: str) -> bytes:
        with open(_strip_scheme(path), "rb") as f:
            return f.read()

    def write_bytes(self, path: str, data: bytes, overwrite: bool = False) -> None:
        p = _strip_scheme(path)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        if overwrite:
            with open(p, "wb") as f:
                f.write(data)
            return
        fd = os.open(p, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o666)
        with os.fdopen(fd, "wb") as f:
            f.write(data)

    def exists(self, path: str) -> bool:
        return os.path.exists(_strip_scheme(path))

    def delete(self, path: str, recursive: bool = False) -> bool:
        """Remove a file or an empty directory (OSError when it is not
        empty), or with `recursive` a directory and all it holds; False
        when nothing is there."""
        p = _strip_scheme(path)
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
        os.makedirs(_strip_scheme(path), exist_ok=True)

    def rename(self, src: str, dst: str) -> bool:
        """No-clobber move: False (and no partial state) if dst exists. A
        directory (a table renamed by the catalog) moves by os.rename."""
        s, d = _strip_scheme(src), _strip_scheme(dst)
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
        p = _strip_scheme(path)
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

    def list_files(self, path: str) -> list[FileStatus]:
        return [s for s in self.list_status(path) if not s.is_dir]

    def get_status(self, path: str) -> FileStatus:
        p = _strip_scheme(path)
        st = os.stat(p)
        return FileStatus(p, st.st_size, os.path.isdir(p), int(st.st_mtime * 1000))

    def read_text(self, path: str) -> str:
        return self.read_bytes(path).decode("utf-8")

    def try_atomic_write(self, path: str, data: bytes) -> bool:
        """The commit primitive: write a temp sibling, then rename into place.
        Returns False if `path` already exists (lost the CAS race)."""
        d, b = os.path.split(_strip_scheme(path))
        tmp = os.path.join(d, f".{b}.{uuid.uuid4().hex}.tmp")
        self.write_bytes(tmp, data, overwrite=True)
        try:
            return self.rename(tmp, path)
        finally:
            if self.exists(tmp):
                self.delete(tmp)

    def try_overwrite(self, path: str, data: bytes) -> bool:
        """Replace a hint file: readers may briefly miss it but never see a
        partial one."""
        d, b = os.path.split(_strip_scheme(path))
        tmp = os.path.join(d, f".{b}.{uuid.uuid4().hex}.tmp")
        self.write_bytes(tmp, data, overwrite=True)
        try:
            self.delete(path)
            return self.rename(tmp, path)
        finally:
            if self.exists(tmp):
                self.delete(tmp)
