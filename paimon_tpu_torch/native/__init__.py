"""Host C code of the port, built at first use and loaded via ctypes (the
counterpart of paimon_tpu/native/).

`zstd.c` is the port's Zstandard codec (RFC 8878). It is compiled with
`cc -O3 -shared -fPIC` into paimon_tpu_torch/_build/, under a name keyed
by the hash of the source and the flags, and loaded with ctypes.CDLL, which
releases the GIL during every call. Several processes may build at once
(tests run in parallel workers): the build holds an exclusive file lock,
writes to a private temporary name and renames it into place, so no process
ever loads a half-written library. There is no fallback: without a C
compiler, or when the build fails, loading raises RuntimeError with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["zstd_library", "build_zstd"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(_DIR, "zstd.c")
_BUILD = os.path.join(os.path.dirname(_DIR), "_build")
_FLAGS = ["-O3", "-shared", "-fPIC"]
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def _library_path() -> str:
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(_BUILD, f"libzstd_codec-{digest}.so")


def build_zstd() -> str:
    """Compile zstd.c unless its library exists; returns the library path."""
    path = _library_path()
    if os.path.exists(path):
        return path
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        raise RuntimeError("no C compiler ('cc' or 'gcc') on PATH: the port's zstd codec (native/zstd.c) cannot be built")
    os.makedirs(_BUILD, exist_ok=True)
    with open(os.path.join(_BUILD, "zstd_codec.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(path):  # another process may have built it while this one waited
            tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
            out = subprocess.run([cc, *_FLAGS, "-o", tmp, _SOURCE], capture_output=True, text=True)
            if out.returncode != 0:
                raise RuntimeError(f"building native/zstd.c failed (cc exited {out.returncode}):\n{out.stdout}{out.stderr}")
            os.replace(tmp, path)
    return path


def zstd_library() -> ctypes.CDLL:
    """The codec library, built and bound on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build_zstd())
            u8p, size, i64 = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int64
            lib.pz_frame_bound.argtypes = [u8p, size, ctypes.POINTER(i64)]
            lib.pz_decompress.argtypes = [u8p, size, u8p, size]
            lib.pz_compress_bound.argtypes = [size]
            lib.pz_compress.argtypes = [u8p, size, u8p, size]
            lib.pz_error.argtypes = [i64]
            for fn in (lib.pz_frame_bound, lib.pz_decompress, lib.pz_compress_bound, lib.pz_compress):
                fn.restype = i64
            lib.pz_error.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB
