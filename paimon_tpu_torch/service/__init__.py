"""The KV point-query service (port of paimon_tpu/service/__init__.py).

KvQueryServer serves a primary-key table's LocalTableQuery over TCP, one
handler thread per connection; KvQueryClient is its blocking client;
ServiceManager writes the server's address into <table>/service/
primary-key-lookup, so that `KvQueryClient.for_table` in either package
finds a server of either package.

Wire format, both directions: a 4-byte big-endian length, then UTF-8 JSON
(the JAX package's, byte for byte: values go through utils.dumps).
Request:  {"id": n, "method": "lookup", "partition": [...], "key": [...]}
          {"id": n, "method": "get_batch", "partition": [...], "keys": [[...], ...]}
          {"id": n, "method": "refresh" | "ping" | "health" | "slo"}
Response: {"id": n, "ok": true, "row": [...] | null}
          {"id": n, "ok": true, "rows": [[...] | null, ...]}
          {"id": n, "ok": false, "error": "..."}
          {"id": n, "ok": false, "busy": true, "kind": "get_batch", "state": "busy-reads", "retry_after_ms": m}

`get_batch` is the batched path (LocalTableQuery.get_batch on the table's
device: the handler threads run the merge kernels). At most
`lookup.get.max-inflight` get_batch requests run at once; the next one is
answered at once with the typed BUSY (KvBusyError on the client), never
queued. With an attached TableWrite, gets also see its buffered rows
(read-your-writes). `health` serves the colocated writer's flow-control
state (core/admission.py WriteBufferController.health_dict), or
{"state": "ok"} without one.

The JAX package's `gateway=` (per-tenant admission in front of the gets)
needs service/gateway.py, which is not ported: passing one raises
NotImplementedError. Without a gateway `slo` answers {} and a request's
`tenant` field is ignored, as in the JAX package.
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
from typing import TYPE_CHECKING

from ..fs import FileIO
from ..metrics import get_metrics, soak_metrics
from ..options import CoreOptions
from ..utils import dumps, loads
from .shed import ShedError, ShedInfo

if TYPE_CHECKING:
    from ..table import FileStoreTable

__all__ = ["KvQueryServer", "KvQueryClient", "KvBusyError", "ServiceManager"]


class KvBusyError(ShedError):
    """The server shed a get_batch with a typed BUSY: its
    lookup.get.max-inflight gate was full. Carries the payload, the
    retry-after hint and the ShedInfo (kind "get_batch")."""

    default_kind = "get_batch"

    def __init__(self, payload: "dict | ShedInfo"):
        super().__init__(payload, message=f"get shed by server: {payload}")


def _send(sock: socket.socket, obj: dict) -> None:
    payload = dumps(obj).encode()
    sock.sendall(struct.pack(">I", len(payload)) + payload)


def _recv(sock: socket.socket) -> dict | None:
    header = _recv_exact(sock, 4)
    if header is None:
        return None
    (length,) = struct.unpack(">I", header)
    body = _recv_exact(sock, length)
    return None if body is None else loads(body)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class ServiceManager:
    """Service address files in the table's directory."""

    PRIMARY_KEY_LOOKUP = "primary-key-lookup"

    def __init__(self, file_io: FileIO, table_path: str):
        self.file_io = file_io
        self.service_dir = f"{table_path}/service"

    def register(self, service: str, host: str, port: int) -> None:
        self.file_io.try_overwrite(f"{self.service_dir}/{service}", dumps({"host": host, "port": port}).encode())

    def address(self, service: str) -> tuple[str, int] | None:
        try:
            d = loads(self.file_io.read_bytes(f"{self.service_dir}/{service}"))
            return d["host"], d["port"]
        except (OSError, ValueError, KeyError):
            return None

    def unregister(self, service: str) -> None:
        self.file_io.delete(f"{self.service_dir}/{service}")


class KvQueryServer:
    def __init__(
        self,
        table: "FileStoreTable",
        host: str = "127.0.0.1",
        port: int = 0,
        health_provider=None,
        table_write=None,
        max_inflight_gets: int | None = None,
        gateway=None,
    ):
        """`health_provider`: a callable returning the flow-control dict
        the `health` method serves (TableWrite.health or
        WriteBufferController.health_dict of a colocated writer).
        `table_write`: a live TableWrite whose buffered rows get_batch also
        serves. `max_inflight_gets`: the get_batch admission depth
        (lookup.get.max-inflight by default). `gateway`: not ported."""
        from ..table.query import LocalTableQuery

        if gateway is not None:
            raise NotImplementedError(
                "KvQueryServer(gateway=...) needs service/gateway.py, which the torch port does not have yet "
                "(ROADMAP Queue 1 item 15 (d))"
            )
        self.table = table
        self.query = LocalTableQuery(table, device=table.device)
        if table_write is not None:
            self.query.attach_write(table_write)
        self.health_provider = health_provider
        if max_inflight_gets is None:
            max_inflight_gets = int(table.options.options.get(CoreOptions.LOOKUP_GET_MAX_INFLIGHT))
        self._get_gate = threading.BoundedSemaphore(max(int(max_inflight_gets), 1))
        # one query state: refresh swaps buckets that gets read
        self._lock = threading.Lock()
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                while True:
                    req = _recv(self.request)
                    if req is None:
                        return
                    rid = req.get("id")
                    try:
                        _send(self.request, {"id": rid, **outer._answer(req)})
                    except Exception as e:  # noqa: BLE001 - the client gets the error
                        _send(self.request, {"id": rid, "ok": False, "error": str(e)})

        self._server = socketserver.ThreadingTCPServer((host, port), Handler, bind_and_activate=True)
        self._server.daemon_threads = True
        self.host, self.port = self._server.server_address[0], self._server.server_address[1]
        self._thread: threading.Thread | None = None

    def _answer(self, req: dict) -> dict:
        method = req["method"]
        if method == "ping":
            return {"ok": True}
        if method == "health":
            return {"ok": True, "health": self.health_provider() if self.health_provider is not None else {"state": "ok"}}
        if method == "slo":
            return {"ok": True, "slo": {}}
        if method == "refresh":
            with self._lock:
                self.query.refresh()
            return {"ok": True}
        if method == "lookup":
            with self._lock:
                row = self.query.lookup(tuple(req.get("partition", ())), tuple(req["key"]))
            return {"ok": True, "row": None if row is None else list(row.to_pylist()[0])}
        if method == "get_batch":
            if not self._get_gate.acquire(blocking=False):
                # the admission depth is full: shed now, never queue
                get_metrics().counter("busy_rejected").inc()
                soak_metrics().counter("shed_requests").inc()
                return {"ok": False, **ShedInfo(kind="get_batch", state="busy-reads", retry_after_ms=25).to_payload()}
            try:
                keys = [tuple(k) if isinstance(k, list) else (k,) for k in req["keys"]]
                with self._lock:
                    res = self.query.get_batch(keys, tuple(req.get("partition", ())))
                rows = [None if r is None else list(r) for r in res.to_pylist()]
            finally:
                self._get_gate.release()
            return {"ok": True, "rows": rows}
        return {"ok": False, "error": f"unknown method {method}"}

    def start(self) -> tuple[str, int]:
        self._thread = threading.Thread(target=self._server.serve_forever, name="paimon-kv-server", daemon=True)
        self._thread.start()
        ServiceManager(self.table.file_io, self.table.path).register(
            ServiceManager.PRIMARY_KEY_LOOKUP, self.host, self.port
        )
        return self.host, self.port

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        ServiceManager(self.table.file_io, self.table.path).unregister(ServiceManager.PRIMARY_KEY_LOOKUP)


class KvQueryClient:
    """Blocking client: one connection, one request at a time."""

    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._id = 0
        self._lock = threading.Lock()

    @staticmethod
    def for_table(table: "FileStoreTable") -> "KvQueryClient":
        addr = ServiceManager(table.file_io, table.path).address(ServiceManager.PRIMARY_KEY_LOOKUP)
        if addr is None:
            raise ConnectionError("no primary-key-lookup service registered for this table")
        return KvQueryClient(*addr)

    def _call(self, method: str, **kw) -> dict:
        with self._lock:
            self._id += 1
            _send(self._sock, {"id": self._id, "method": method, **kw})
            resp = _recv(self._sock)
        if resp is None:
            raise ConnectionError("server closed the connection")
        if not resp.get("ok"):
            if resp.get("busy"):
                raise KvBusyError(resp)
            raise RuntimeError(resp.get("error", "unknown server error"))
        return resp

    def ping(self) -> bool:
        return self._call("ping")["ok"]

    def health(self) -> dict:
        """The server's writer flow-control state (health_dict's schema)."""
        return self._call("health")["health"]

    def refresh(self) -> None:
        self._call("refresh")

    def lookup(self, partition: tuple, key) -> tuple | None:
        if not isinstance(key, tuple):
            key = (key,)
        row = self._call("lookup", partition=list(partition), key=list(key)).get("row")
        return None if row is None else tuple(row)

    def get_batch(self, keys, partition: tuple = (), tenant: str | None = None) -> list:
        """list[tuple | None] aligned with `keys`; KvBusyError (with
        retry_after_ms) when the server shed the request. `tenant` tags the
        request for a gateway-fronted server."""
        ks = [list(k) if isinstance(k, (tuple, list)) else [k] for k in keys]
        kw = {"partition": list(partition), "keys": ks}
        if tenant is not None:
            kw["tenant"] = tenant
        rows = self._call("get_batch", **kw)["rows"]
        return [None if r is None else tuple(r) for r in rows]

    def slo(self) -> dict:
        """A gateway-fronted server's SLO surface; {} without a gateway."""
        return self._call("slo")["slo"]

    def close(self) -> None:
        self._sock.close()
