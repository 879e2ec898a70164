"""Writer admission control: a byte budget over buffered memtables (port
of paimon_tpu/core/admission.py).

A WriteBufferController is shared by the merge-tree writers of one
TableWrite (or, passed in, by many): every memtable byte a writer buffers,
and every byte an offloaded flush is still encoding, is host memory only
the flush can return.

  reserve(n)     admission for n incoming bytes. Below the stop trigger
                 (write.buffer.stop-trigger x write.buffer.max-memory) a
                 write is admitted at once. Above it the caller is
                 THROTTLED: it blocks up to write.buffer.block-timeout for
                 flushes to release budget, and is then REJECTED with a
                 WriterBackpressureError, having buffered nothing.
  release(n)     budget returned: a flush finished encoding, or a writer
                 was closed or abandoned with bytes still reserved. The
                 writer tracks what it holds, so each byte returns once.
  flush_begin()  at most write.buffer.max-pending-flushes memtables wait
                 behind the flush workers; at the cap (held for the block
                 timeout) the writer encodes inline, and the caller pays.

States: ok -> throttling (in use at or over the stop trigger) ->
rejecting (a block deadline passed and the pressure has not dropped below
the trigger since) -> ok. The soak metric group counts writes_throttled
and writes_rejected and records backpressure_ms.
"""

from __future__ import annotations

import threading
import time

__all__ = ["WriterBackpressureError", "WriteBufferController"]


class WriterBackpressureError(RuntimeError):
    """Write rejected: the write buffer stayed at or over the stop trigger
    for the whole write.buffer.block-timeout. Nothing was buffered: the
    caller may drop the write, or back off and replay it."""


class WriteBufferController:
    """Byte and flush-depth accountant shared by the merge-tree writers of
    one write, or, passed in explicitly, by several."""

    def __init__(
        self,
        max_memory: int,
        stop_trigger: float = 0.9,
        block_timeout_ms: int = 10_000,
        max_pending_flushes: int = 4,
    ):
        self.max_memory = int(max_memory)
        self.stop_trigger = float(stop_trigger)
        self.block_timeout_ms = int(block_timeout_ms)
        self.max_pending_flushes = int(max_pending_flushes)
        self._soft = int(self.max_memory * self.stop_trigger) if self.max_memory > 0 else 0
        self._cond = threading.Condition()
        self._in_use = 0
        self._pending_flushes = 0
        self._throttled = 0
        self._rejected = 0
        # millis writers spent blocked in this controller (the soak group's
        # histogram mixes every controller)
        self._backpressure_ms = 0.0
        # a deadline reject happened and the buffer has not dropped below
        # the stop trigger since
        self._rejecting = False

    # ---- construction ---------------------------------------------------
    @classmethod
    def from_options(cls, options) -> "WriteBufferController | None":
        """None when admission control is off (write.buffer.max-memory=0,
        the default)."""
        from ..options import CoreOptions

        max_memory = options.write_buffer_max_memory
        if max_memory <= 0:
            return None
        return cls(
            max_memory,
            stop_trigger=options.options.get(CoreOptions.WRITE_BUFFER_STOP_TRIGGER),
            block_timeout_ms=options.write_buffer_block_timeout_ms,
            max_pending_flushes=options.options.get(CoreOptions.WRITE_BUFFER_MAX_PENDING_FLUSHES),
        )

    # ---- byte budget ----------------------------------------------------
    def _admissible(self, nbytes: int) -> bool:
        # an empty buffer admits even a batch over the whole budget, which
        # would otherwise wait for itself forever
        return self._in_use == 0 or self._in_use + nbytes <= self._soft

    def try_reserve(self, nbytes: int) -> bool:
        """Admission without blocking. False: over the stop trigger; the
        caller drains its own memtable before the blocking reserve()."""
        with self._cond:
            if not self._admissible(nbytes):
                return False
            self._in_use += nbytes
            return True

    def reserve(self, nbytes: int) -> None:
        """Blocking admission: throttle (bounded block) then reject."""
        from ..metrics import soak_metrics

        with self._cond:
            if self._admissible(nbytes):
                self._in_use += nbytes
                return
            g = soak_metrics()
            g.counter("writes_throttled").inc()
            self._throttled += 1
            t0 = time.perf_counter()
            deadline = t0 + self.block_timeout_ms / 1000.0
            try:
                while not self._admissible(nbytes):
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        g.counter("writes_rejected").inc()
                        self._rejected += 1
                        self._rejecting = True
                        raise WriterBackpressureError(
                            f"write buffer full: {self._in_use}/{self.max_memory} bytes in "
                            f"use (stop trigger {self._soft}), {self._pending_flushes} "
                            f"flushes pending; blocked {self.block_timeout_ms} ms "
                            f"(write.buffer.block-timeout) without drain"
                        )
                    self._cond.wait(remaining)
                self._in_use += nbytes
            finally:
                blocked_ms = (time.perf_counter() - t0) * 1000
                self._backpressure_ms += blocked_ms
                g.histogram("backpressure_ms").update(blocked_ms)

    def release(self, nbytes: int) -> None:
        if nbytes <= 0:
            return
        with self._cond:
            self._in_use = max(0, self._in_use - nbytes)
            if self._in_use < self._soft or self._soft <= 0:
                self._rejecting = False
            self._cond.notify_all()

    # ---- pending-flush depth cap ---------------------------------------
    def flush_begin(self) -> bool:
        """Claim a pending-flush slot. False: the cap held for the whole
        block timeout, and the caller encodes inline instead."""
        from ..metrics import soak_metrics

        with self._cond:
            if self.max_pending_flushes <= 0 or self._pending_flushes < self.max_pending_flushes:
                self._pending_flushes += 1
                return True
            g = soak_metrics()
            g.counter("writes_throttled").inc()
            self._throttled += 1
            t0 = time.perf_counter()
            deadline = t0 + self.block_timeout_ms / 1000.0
            try:
                while self._pending_flushes >= self.max_pending_flushes:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        return False
                    self._cond.wait(remaining)
                self._pending_flushes += 1
                return True
            finally:
                blocked_ms = (time.perf_counter() - t0) * 1000
                self._backpressure_ms += blocked_ms
                g.histogram("backpressure_ms").update(blocked_ms)

    def flush_end(self) -> None:
        with self._cond:
            self._pending_flushes = max(0, self._pending_flushes - 1)
            self._cond.notify_all()

    # ---- introspection --------------------------------------------------
    @property
    def in_use(self) -> int:
        return self._in_use

    @property
    def pending_flushes(self) -> int:
        return self._pending_flushes

    def health_dict(self) -> dict:
        """The flow-control state, JSON-serialisable, in the JAX package's
        schema (TableWrite.health reports it): state ok, throttling or
        rejecting, and retry_after_ms, the backoff a caller should take."""
        with self._cond:
            state = "ok"
            if self._in_use >= self._soft > 0:
                state = "rejecting" if self._rejecting else "throttling"
            retry_after = 0
            if state == "throttling":
                # half the block budget: the pressure is draining
                retry_after = max(1, self.block_timeout_ms // 2)
            elif state == "rejecting":
                # a whole block budget has failed once already
                retry_after = self.block_timeout_ms
            return {
                "state": state,
                "buffered_bytes": self._in_use,
                "max_memory": self.max_memory,
                "stop_trigger_bytes": self._soft,
                "pending_flushes": self._pending_flushes,
                "max_pending_flushes": self.max_pending_flushes,
                "writes_throttled": self._throttled,
                "writes_rejected": self._rejected,
                "backpressure_ms": round(self._backpressure_ms, 3),
                "retry_after_ms": retry_after,
            }

    health = health_dict  # the JAX package's alias
