"""Retry policy: error classification + decorrelated-jitter backoff (port
of paimon_tpu/resilience/retry.py).

Transient faults are retried with exponential backoff and decorrelated
jitter; permanent faults (missing file, lost CAS, permission) propagate
immediately — retrying them only hides bugs and burns the op deadline.
Classification is an ALLOWLIST: connection/timeout exception types, OSErrors
whose errno denotes a moment-in-time fault (EIO, EAGAIN, ETIMEDOUT, …), and
exceptions carrying an explicit `transient = True` attribute — the marker
store adapters (and the fault harness's ArtificialException) set on
retryable blips that don't fit a stdlib type. Everything else, including
OSErrors without a recognized errno (wrapper-raised namespace collisions,
adapter bugs), is permanent and surfaces on the first attempt.

Backoff follows the decorrelated-jitter scheme (sleep_n = U(base, 3*prev)
capped at max): successive retries spread out AND desynchronize, so N writers
hammered by the same outage don't retry in lockstep against the store.
"""

from __future__ import annotations

import errno
import random
import threading
import time
from dataclasses import dataclass, field

__all__ = ["IODeadlineExceeded", "is_transient", "RetryPolicy"]


class IODeadlineExceeded(TimeoutError):
    """The per-op deadline (fs.io.timeout) elapsed across retries."""


# OSError errnos that denote a fault of the moment (store or network), not a
# property of the request — the only errnos worth a retry. Deliberately
# absent: ENOENT/EEXIST/EACCES (namespace/permission facts), ENOSPC/EDQUOT
# (a full disk does not drain on a 10ms backoff), EINVAL & friends (bugs).
_TRANSIENT_ERRNOS = frozenset(
    x
    for x in (
        errno.EIO,
        errno.EAGAIN,
        errno.EBUSY,
        errno.ETIMEDOUT,
        errno.ECONNRESET,
        errno.ECONNREFUSED,
        errno.ECONNABORTED,
        errno.EPIPE,
        errno.ENETDOWN,
        errno.ENETUNREACH,
        errno.ENETRESET,
        errno.EHOSTDOWN,
        errno.EHOSTUNREACH,
        errno.ESTALE,
        getattr(errno, "EREMOTEIO", None),
    )
    if x is not None
)

# Exception types that are permanent regardless of errno. NotImplementedError
# covers FileIO stubs; Value/TypeError are caller bugs surfacing through IO.
_PERMANENT_TYPES = (
    FileNotFoundError,
    FileExistsError,
    PermissionError,
    IsADirectoryError,
    NotADirectoryError,
    InterruptedError,
    NotImplementedError,
    ValueError,
    TypeError,
    KeyError,
    IODeadlineExceeded,
)

_TRANSIENT_TYPES = (ConnectionError, TimeoutError, BrokenPipeError)


def is_transient(exc: BaseException) -> bool:
    """True if retrying the op may plausibly succeed (see module docstring
    for the allowlist). An explicit `transient` attribute on the exception
    wins over every structural rule."""
    marker = getattr(exc, "transient", None)
    if marker is not None:
        return bool(marker)
    if isinstance(exc, _PERMANENT_TYPES):
        return False
    if isinstance(exc, _TRANSIENT_TYPES):
        return True
    if isinstance(exc, OSError):
        return exc.errno in _TRANSIENT_ERRNOS
    return False


@dataclass
class RetryPolicy:
    """max_attempts total tries per op; backoffs in millis; timeout_ms is a
    per-op wall-clock deadline spanning all attempts (None = unbounded)."""

    max_attempts: int = 3
    initial_backoff_ms: float = 10.0
    max_backoff_ms: float = 2000.0
    timeout_ms: float | None = None
    rng: random.Random = field(default_factory=random.Random)
    sleep: object = time.sleep  # injectable for tests
    _lock: threading.Lock = field(default_factory=threading.Lock)

    @property
    def enabled(self) -> bool:
        return self.max_attempts > 1 or self.timeout_ms is not None

    def next_backoff_ms(self, prev_ms: float | None) -> float:
        """Decorrelated jitter: U(base, 3*prev) capped at max_backoff_ms."""
        base = max(self.initial_backoff_ms, 0.0)
        if prev_ms is None:
            hi = base
        else:
            hi = min(self.max_backoff_ms, max(base, prev_ms * 3.0))
        with self._lock:  # random.Random is not thread-safe under mutation
            return self.rng.uniform(base, hi) if hi > base else base

    def run(self, op_name: str, fn, metrics=None):
        """Run fn() under the policy. Counts io{retries, giveups, timeouts}
        and records io{backoff_ms} on the given metric group."""
        t0 = time.monotonic()
        prev_backoff: float | None = None
        attempt = 1
        while True:
            try:
                return fn()
            except BaseException as exc:  # noqa: BLE001 — classified below
                if not is_transient(exc):
                    raise
                deadline_left = None
                if self.timeout_ms is not None:
                    deadline_left = self.timeout_ms - (time.monotonic() - t0) * 1000.0
                    if deadline_left <= 0:
                        if metrics is not None:
                            metrics.counter("timeouts").inc()
                            metrics.counter("giveups").inc()
                        raise IODeadlineExceeded(
                            f"fs.io.timeout ({self.timeout_ms:.0f} ms) exceeded after "
                            f"{attempt} attempt(s) of {op_name}"
                        ) from exc
                if attempt >= self.max_attempts:
                    if metrics is not None:
                        metrics.counter("giveups").inc()
                    raise
                prev_backoff = self.next_backoff_ms(prev_backoff)
                if deadline_left is not None and prev_backoff > deadline_left:
                    # sleeping past the deadline just to fail is pure waste
                    prev_backoff = max(deadline_left, 0.0)
                if metrics is not None:
                    metrics.counter("retries").inc()
                    metrics.histogram("backoff_ms").update(prev_backoff)
                if prev_backoff > 0:
                    self.sleep(prev_backoff / 1000.0)
                attempt += 1
