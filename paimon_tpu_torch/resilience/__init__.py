"""Resilience layer (port of paimon_tpu/resilience/): retrying IO, named
crash points and orphan-file recovery.

- retry.py   transient-vs-permanent classification and decorrelated-jitter
             backoff with per-op deadlines (RetryPolicy)
- fileio.py  RetryingFileIO, the wrapper core/store.py installs
- faults.py  named crash points that tests arm to kill a commit or a flush
             at exact protocol steps (the scripted FileIO schedules live in
             fs/testing.py); PAIMON_TPU_CRASH_POINT arms a child process
- orphan.py  the reachability walk over every live snapshot, changelog,
             tag and branch, and the sweep of the files none of them reach
"""

from .faults import CrashError, arm_crash_point, crash_point, disarm_crash_points
from .fileio import RetryingFileIO, wrap_file_io
from .orphan import remove_orphan_files
from .retry import IODeadlineExceeded, RetryPolicy, is_transient

__all__ = [
    "RetryPolicy",
    "RetryingFileIO",
    "wrap_file_io",
    "is_transient",
    "IODeadlineExceeded",
    "CrashError",
    "crash_point",
    "arm_crash_point",
    "disarm_crash_points",
    "remove_orphan_files",
]
