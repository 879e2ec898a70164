"""Object-store FileIO (port of paimon_tpu/fs/object_store.py): S3
semantics emulated over a local directory, so the whole store stack (the
commit CAS, the catalog lock, the crash oracle) runs against them without
a network.

- **PUT is atomic and last-writer-wins**: an object appears whole or not
  at all.
- **Conditional PUT** (`If-None-Match: *`): exclusive create, exactly one
  of N racers succeeds. `conditional_put=False` models legacy stores
  without it: exclusive create degrades to check-then-put, which is no
  CAS, so such stores must commit under an external (jdbc) catalog lock.
- **No atomic rename**: rename is CopyObject + DeleteObject, neither atomic
  nor exclusive. `try_atomic_write` never uses it: with conditional PUT it
  is a conditional PUT, in legacy mode check-then-put (safe only under the
  catalog lock, which `atomic_write_supported=False` engages).
- **Flat namespace**: directories are prefixes. mkdirs only materialises
  the local directory, a "directory" exists while a key carries its
  prefix, and delete(recursive) deletes by prefix.

On disk keys are files under the path; `.os-staging/` holds in-flight PUTs
so that an object only ever becomes visible whole (os.replace or os.link of
a fully written staged file).
"""

from __future__ import annotations

import os
import shutil
import uuid

from . import FileIO, FileStatus, register_file_io, split_scheme

__all__ = ["ObjectStoreFileIO"]


class ObjectStoreFileIO(FileIO):
    """See module docstring.  Paths: ``s3://<abs-local-path>`` (the local
    path backs the "bucket"); ``s3-legacy://`` is the same store without
    conditional PUT."""

    # rename is copy+delete: commits must run under the catalog lock
    atomic_write_supported = False

    def __init__(self, conditional_put: bool = True):
        self.conditional_put = conditional_put
        self.exclusive_create_supported = conditional_put

    # ---- key mapping ---------------------------------------------------
    def _p(self, path: str) -> str:
        return split_scheme(path)[1]

    def _staging(self, p: str) -> str:
        # stage inside the bucket root so os.replace/os.link stay one-fs;
        # walk up to an existing ancestor to anchor the staging dir
        anc = os.path.dirname(p)
        while anc and anc != "/" and not os.path.isdir(anc):
            anc = os.path.dirname(anc)
        d = os.path.join(anc or "/", ".os-staging")
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, uuid.uuid4().hex)

    def _put(self, p: str, data: bytes) -> None:
        """Atomic-visibility overwrite PUT (last-writer-wins)."""
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = self._staging(p)
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, p)  # clobbers: last writer wins, content atomic

    def _put_if_absent(self, p: str, data: bytes) -> bool:
        """Conditional PUT (If-None-Match: *): True iff we created it."""
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = self._staging(p)
        with open(tmp, "wb") as f:
            f.write(data)
        try:
            os.link(tmp, p)  # emulates the store's server-side condition
            return True
        except FileExistsError:
            return False
        finally:
            os.unlink(tmp)

    # ---- FileIO surface ------------------------------------------------
    def read_bytes(self, path: str) -> bytes:
        with open(self._p(path), "rb") as f:
            return f.read()

    def write_bytes(self, path: str, data: bytes, overwrite: bool = False) -> None:
        p = self._p(path)
        if overwrite:
            self._put(p, data)
            return
        if self.conditional_put:
            if not self._put_if_absent(p, data):
                raise FileExistsError(p)
            return
        # legacy store: no exclusive create. Advisory check + PUT — callers
        # writing uniquely-named objects (data files, manifests) are safe;
        # anything needing mutual exclusion must hold the catalog lock.
        if os.path.exists(p):
            raise FileExistsError(p)
        self._put(p, data)

    def exists(self, path: str) -> bool:
        # an object, or a "directory" (= some key has this prefix)
        return os.path.exists(self._p(path))

    def delete(self, path: str, recursive: bool = False) -> bool:
        p = self._p(path)
        try:
            if os.path.isdir(p):
                if recursive:
                    shutil.rmtree(p)  # prefix delete (batch DeleteObjects)
                else:
                    # directories are virtual: deleting a bare prefix with
                    # children is a no-op; an empty prefix "exists" only as
                    # a local-dir artifact, drop it
                    try:
                        os.rmdir(p)
                    except OSError:
                        return False
            else:
                os.remove(p)
            return True
        except FileNotFoundError:
            return False

    def mkdirs(self, path: str) -> None:
        # prefixes need no creation; materialize the local dir only so the
        # emulation's listings behave (harmless, objects still define truth)
        os.makedirs(self._p(path), exist_ok=True)

    def rename(self, src: str, dst: str) -> bool:
        """CopyObject + DeleteObject.  NOT atomic, NOT exclusive: the
        destination check is advisory (TOCTOU) — two racers can both return
        True with last-copy-wins.  Commit protocols must not use this as a
        CAS; `try_atomic_write` here never does."""
        s, d = self._p(src), self._p(dst)
        if not os.path.exists(s):
            return False
        if os.path.isdir(s):
            # virtual-dir rename = per-object copy (reference object stores
            # do exactly this server-side, O(objects))
            if os.path.exists(d):
                return False
            shutil.copytree(s, d)
            shutil.rmtree(s)
            return True
        if os.path.exists(d):  # advisory only
            return False
        with open(s, "rb") as f:
            self._put(d, f.read())
        os.remove(s)
        return True

    def list_status(self, path: str) -> list[FileStatus]:
        p = self._p(path)
        if not os.path.isdir(p):
            return []
        out = []
        for name in sorted(os.listdir(p)):
            if name == ".os-staging":
                continue
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

    def open_input(self, path: str):
        return open(self._p(path), "rb")

    # ---- commit primitives (no rename!) --------------------------------
    def try_atomic_write(self, path: str, data: bytes) -> bool:
        """Reference FileIO#tryToWriteAtomic, object-store edition: PUT is
        already whole-object-atomic, so no temp+rename dance.  Conditional
        PUT makes this a true CAS; legacy mode is check-then-put and is only
        safe under the catalog lock (engaged automatically because
        atomic_write_supported is False)."""
        p = self._p(path)
        if self.conditional_put:
            return self._put_if_absent(p, data)
        if os.path.exists(p):
            return False
        self._put(p, data)
        return True

    def try_overwrite(self, path: str, data: bytes) -> bool:
        """Hints etc.: a plain overwrite PUT is atomic-visibility on an
        object store (reference S3 FileIO overwrites hint objects directly
        instead of delete+rename)."""
        self._put(self._p(path), data)
        return True


register_file_io("s3", lambda: ObjectStoreFileIO(conditional_put=True))
register_file_io("oss", lambda: ObjectStoreFileIO(conditional_put=True))
register_file_io("s3-legacy", lambda: ObjectStoreFileIO(conditional_put=False))
