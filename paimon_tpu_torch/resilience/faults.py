"""Named crash points: deterministic process-death simulation (port of
paimon_tpu/resilience/faults.py, every point name of the JAX package).

Instrumented code calls `crash_point("commit:manifests-written")` at exact
protocol steps; tests arm a point to kill the operation there (raise
CrashError, simulating the process dying with no cleanup running beyond what
an exception unwinds), to HARD-KILL the whole process (`kill=True` →
``os._exit(137)``, the process-grain death of a SIGKILLed worker —
no exception unwinding, no finally blocks, no atexit, torn `.tmp` files and
unflushed buffers left exactly where they were), or to run an arbitrary
action at the point — the hook that lets a test deterministically interleave
a competing commit between one committer's latest-snapshot read and its
snapshot CAS.

Env arming (the subprocess seam): ``PAIMON_TPU_CRASH_POINT`` is parsed when
this module imports (and re-parseable via `arm_from_env`), so a supervisor
can arm a crash in a child process it is about to spawn without any code
handshake:

    PAIMON_TPU_CRASH_POINT=<name>[:<nth>][:kill][,<spec>...]

`nth` (default 1) is the 1-based hit that fires; `:kill` selects the
hard-death mode (without it the point raises CrashError in-process). E.g.
``commit:manifests-written:2:kill`` lets the first commit land and kills the
process dead in the middle of the second.

Crash-point map of the commit protocol (FileStoreCommit._try_commit):

  commit:before-manifests    inside the (optional) catalog lock, after the
                             latest-snapshot read + conflict check, before
                             any manifest write. Crash leaves nothing.
  commit:manifests-written   all manifests / manifest lists / changelog and
                             index manifests durable, snapshot file NOT yet
                             renamed in. Crash leaves orphan manifests (and
                             possibly torn .tmp siblings) that no reader can
                             reach; remove_orphan_files reclaims them.
  commit:snapshot-committed  the snapshot CAS succeeded; hints not yet
                             written. Crash leaves a fully-visible commit —
                             replaying the committable must be filtered out
                             by filter_committed (idempotence contract), and
                             a journaling writer must resolve the lost ack
                             from the snapshot chain (find_landed_append).

Writer-side points (MergeTreeWriter, the flush/encode pipeline):

  flush:before-dispatch      the memtable is full but not yet drained; no
                             merge dispatched, no file written. Crash loses
                             only unacknowledged buffered rows.
  flush:files-written        the flushed level-0 data files are durable on
                             disk but referenced by no snapshot (the commit
                             that would reference them never ran). Crash
                             leaves orphan data files; remove_orphan_files
                             reclaims them.

Unarmed points are a dict lookup on a module-level map — zero cost in
production paths.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Callable

__all__ = [
    "CrashError",
    "crash_point",
    "arm_crash_point",
    "arm_from_env",
    "disarm_crash_points",
    "COMMIT_CRASH_POINTS",
    "WRITER_CRASH_POINTS",
    "CLUSTER_CRASH_POINTS",
    "SERVICE_CRASH_POINTS",
    "RESCALE_CRASH_POINTS",
    "HANDOFF_CRASH_POINTS",
    "ALL_CRASH_POINTS",
    "KILL_EXIT_CODE",
]

# the canonical points instrumented in core/commit.py (tests iterate this)
COMMIT_CRASH_POINTS = (
    "commit:before-manifests",
    "commit:manifests-written",
    "commit:snapshot-committed",
)

# the writer-side points instrumented in core/writer.py
WRITER_CRASH_POINTS = (
    "flush:before-dispatch",
    "flush:files-written",
)

# The points below are named as in the JAX package, where service/,
# table/rescale.py and the cluster instrument them; the port's modules that
# would call them (the services, the mesh, the cluster's rescale and
# handoff) are not ported, so nothing in the port reaches them yet.

# the cluster-worker points of service/cluster.py: a worker
# dying mid-compaction (rewrite executed, CommitMessage never shipped) and
# one dying between prepare_commit and shipping its ingest round
CLUSTER_CRASH_POINTS = (
    "cluster:compact-executing",
    "cluster:before-ship",
)

# the service-plane points: a gateway writer client dying between its put
# landing on the wire and journaling the ack (service/mega_soak.py), and a
# subscriber dying right after fsyncing a received batch into its journal
# (service/subscription.py) — both leave a landed-but-unacked protocol edge
# the respawned incarnation must resolve from durable state alone
SERVICE_CRASH_POINTS = (
    "gateway:put-sent",
    "subscriber:batch-journaled",
)

# the elastic-topology points (table/rescale.py + service/cluster.py): a
# worker dying with its rescale rewrite files durable but the shipment
# never prepared/sent (orphan files; the coordinator re-queues the buckets
# on whoever owns them next), and a retiring worker dying after draining
# but before its retire RPC (the planned handoff degrades to the
# missed-heartbeat death path — same reassignment, plus the timeout). The
# coordinator's commit half needs no points of its own: the schema bump is
# a CAS and the OVERWRITE snapshot runs through FileStoreCommit._try_commit,
# which the commit:* points already cover.
RESCALE_CRASH_POINTS = (
    "rescale:files-written",
    "rescale:before-ship",
)
HANDOFF_CRASH_POINTS = ("handoff:before-retire",)

ALL_CRASH_POINTS = (
    COMMIT_CRASH_POINTS
    + WRITER_CRASH_POINTS
    + CLUSTER_CRASH_POINTS
    + SERVICE_CRASH_POINTS
    + RESCALE_CRASH_POINTS
    + HANDOFF_CRASH_POINTS
)

# 128 + SIGKILL: a hard death at a crash point reports like a kill -9 victim
KILL_EXIT_CODE = 137

ENV_VAR = "PAIMON_TPU_CRASH_POINT"


class CrashError(BaseException):
    """Simulated process death at a named crash point.

    Deliberately NOT an Exception subclass: production code that swallows
    broad `except Exception` (cleanup paths, best-effort hints) must not
    accidentally survive a simulated crash — a real SIGKILL wouldn't."""

    def __init__(self, point: str):
        super().__init__(f"simulated crash at {point}")
        self.point = point


@dataclass
class _Armed:
    skip: int = 0  # let this many hits pass before acting
    count: int = 1  # act on this many hits after the skip (<=0 = forever)
    action: Callable[[], None] | None = None  # None = raise CrashError
    kill: bool = False  # hard death: os._exit, no unwinding at all
    hits: int = 0
    fired: int = 0


_armed: dict[str, _Armed] = {}
_lock = threading.Lock()


def arm_crash_point(
    name: str,
    skip: int = 0,
    count: int = 1,
    action: Callable[[], None] | None = None,
    kill: bool = False,
) -> None:
    """Arm `name`: after `skip` passes, the next `count` hits either raise
    CrashError (action=None), hard-kill the process (kill=True — use only in
    a subprocess you own!), or run `action()` at the point (the action may
    itself raise to crash, or just mutate the world — e.g. land a competing
    commit — and return to let the operation continue)."""
    with _lock:
        _armed[name] = _Armed(skip=skip, count=count, action=action, kill=kill)


def disarm_crash_points(*names: str) -> None:
    """Disarm the given points, or ALL points when called with none."""
    with _lock:
        if names:
            for n in names:
                _armed.pop(n, None)
        else:
            _armed.clear()


def _parse_spec(spec: str) -> tuple[str, int, bool]:
    """'<name>[:<nth>][:kill]' — name itself contains colons, so nth/kill
    are peeled off the right."""
    spec = spec.strip()
    kill = False
    if spec.endswith(":kill"):
        kill = True
        spec = spec[: -len(":kill")]
    name, _, nth = spec.rpartition(":")
    if name and nth.isdigit():
        return name, int(nth), kill
    return spec, 1, kill


def arm_from_env(value: str | None = None) -> list[str]:
    """Arm crash points from the PAIMON_TPU_CRASH_POINT spec (or an explicit
    `value`). Returns the armed point names. Called at module import so a
    freshly spawned subprocess is armed before any table code runs."""
    spec = os.environ.get(ENV_VAR) if value is None else value
    if not spec:
        return []
    armed = []
    for item in spec.split(","):
        if not item.strip():
            continue
        name, nth, kill = _parse_spec(item)
        arm_crash_point(name, skip=nth - 1, count=1, kill=kill)
        armed.append(name)
    return armed


def crash_point(name: str) -> None:
    """Called by instrumented code. No-op unless a test armed `name`."""
    if not _armed:  # fast path: nothing armed anywhere
        return
    with _lock:
        st = _armed.get(name)
        if st is None:
            return
        st.hits += 1
        if st.hits <= st.skip:
            return
        if st.count > 0 and st.fired >= st.count:
            return
        st.fired += 1
        action = st.action
        kill = st.kill
    if kill:
        # a real process death: no exception unwinding, no cleanup, no
        # atexit — buffered file contents and tmp siblings stay torn
        os._exit(KILL_EXIT_CODE)
    if action is None:
        raise CrashError(name)
    action()


# subprocess seam: a supervisor arms its children via the environment
arm_from_env()
