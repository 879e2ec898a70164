"""The typed shed: one wire shape for every BUSY answer (port of
paimon_tpu/service/shed.py).

ShedInfo is the record each typed refusal serialises: the KV server's
KvBusyError (service/__init__.py) and the subscription hub's
SubscriberShedError (service/subscription.py) here, the gateway's and the
Flight server's in the JAX package.

    kind            what was shed: put | get_batch | subscribe | sql | request
    state           why: "busy-reads", "queue-full", "buffer-exhausted",
                    "busy-subscribers", "shutting-down", ...
    tenant          whose request (gateway admission; None = untagged)
    retry_after_ms  the server's backoff hint
    restart_offset  where a shed subscriber resumes (its next snapshot);
                    None for the other kinds
    extras          any other payload fields, carried along

`to_payload()` gives the flat wire dict (busy, kind, state,
retry_after_ms, and next_snapshot beside restart_offset for the
subscription's readers); `from_payload` reads it back, so a payload made
by either package parses in the other to the same record.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["ShedInfo", "ShedError", "GatewayShedError"]

# payload keys owned by the canonical record (everything else is extras)
_CORE_KEYS = frozenset(
    {"busy", "kind", "state", "tenant", "retry_after_ms", "restart_offset", "next_snapshot"}
)


@dataclass
class ShedInfo:
    """One typed shed, serializable to the flat wire payload every legacy
    BUSY client already understands."""

    kind: str = "request"
    state: str | None = None
    tenant: str | None = None
    retry_after_ms: int = 0
    restart_offset: int | None = None
    extras: dict = field(default_factory=dict)

    def to_payload(self) -> dict:
        """Flat wire dict: the legacy BUSY shape plus the canonical fields.
        ``next_snapshot`` mirrors ``restart_offset`` for the subscription
        dialect's existing consumers."""
        out = dict(self.extras)
        out["busy"] = True
        out["kind"] = self.kind
        out["state"] = self.state
        out["retry_after_ms"] = int(self.retry_after_ms)
        if self.tenant is not None:
            out["tenant"] = self.tenant
        if self.restart_offset is not None:
            out["restart_offset"] = int(self.restart_offset)
            out.setdefault("next_snapshot", int(self.restart_offset))
        return out

    @classmethod
    def from_payload(cls, payload: dict, kind: str | None = None) -> "ShedInfo":
        """Parse any of the three legacy payload dialects (or a canonical
        one) back into the record. Unknown fields land in extras."""
        restart = payload.get("restart_offset")
        if restart is None:
            restart = payload.get("next_snapshot")
        return cls(
            kind=kind or payload.get("kind") or "request",
            state=payload.get("state"),
            tenant=payload.get("tenant"),
            retry_after_ms=int(payload.get("retry_after_ms") or 0),
            restart_offset=None if restart is None else int(restart),
            extras={k: v for k, v in payload.items() if k not in _CORE_KEYS},
        )


class ShedError(RuntimeError):
    """Base of every typed-shed exception: constructed from either a legacy
    payload dict or a ShedInfo, it exposes BOTH contracts — the canonical
    ``shed_info`` record and the legacy ``payload``/``retry_after_ms``
    attributes the existing clients and tests rely on."""

    default_kind = "request"

    def __init__(self, payload: "dict | ShedInfo", message: str | None = None):
        info = (
            payload
            if isinstance(payload, ShedInfo)
            # the payload's own kind wins; default_kind covers untyped
            # legacy payloads that never carried one
            else ShedInfo.from_payload(payload, kind=payload.get("kind") or self.default_kind)
        )
        self.shed_info = info
        self.payload = info.to_payload()
        self.retry_after_ms = info.retry_after_ms
        super().__init__(message or f"shed by server: {self.payload}")


class GatewayShedError(ShedError):
    """The gateway's per-tenant admission (or a downstream server whose shed
    it converted) refused this request. Carries the canonical ShedInfo; the
    legacy exception types are serializations of the same record, so a
    caller that only knows GatewayShedError still sees every shed kind."""

    default_kind = "request"
