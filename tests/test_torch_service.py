"""The port's KV query service and typed shed (paimon_tpu_torch/service/
__init__.py and shed.py) against the JAX package's, on the CPU
(device="cpu").

The cases of tests/test_service.py and, of tests/test_point_get.py,
test_kv_server_get_batch_and_typed_busy and test_kv_server_read_your_writes,
each run through both packages on twin warehouses with the same answers.
Across packages: each package's client against the other's server (found
through the other's address file) over BIGINT, DOUBLE, STRING, DECIMAL,
DATE and TIMESTAMP columns with null values and absent keys, every answer
equal to the JAX package's in-process LocalTableQuery; ShedInfo payloads
read back by the other package to the same record; gets from several
threads against one server equal to the in-process get_batch. The port's
tables merge under sort-engine=pallas (the kernels' plain versions on the
CPU).

Tolerance: exact.
"""

import io
import json
import socket
import struct
import sys
import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import paimon_tpu as jt
import paimon_tpu.catalog as jcat_mod
import paimon_tpu.service as jsvc
import paimon_tpu.service.shed as jshed
import paimon_tpu_torch as tt
import paimon_tpu_torch.catalog as pcat_mod
import paimon_tpu_torch.service as psvc
import paimon_tpu_torch.service.shed as pshed
from paimon_tpu.table.query import LocalTableQuery as JaxQuery
from paimon_tpu_torch.table.query import LocalTableQuery as PortQuery

PKGS = ("jax", "port")
TYPES = {"jax": jt, "port": tt}
SVC = {"jax": jsvc, "port": psvc}
SHED = {"jax": jshed, "port": pshed}
ENGINE = {"jax": {"sort-engine": "numpy"}, "port": {"sort-engine": "pallas"}}


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


def catalog(pkg, warehouse, user="svc"):
    if pkg == "jax":
        return jcat_mod.FileSystemCatalog(str(warehouse), commit_user=user)
    return pcat_mod.FileSystemCatalog(str(warehouse), commit_user=user, device="cpu")


def schema(pkg):
    t = TYPES[pkg]
    return t.RowType.of(("id", t.BIGINT()), ("name", t.STRING()), ("v", t.DOUBLE()))


def write(t, data):
    wb = t.new_batch_write_builder()
    w = wb.new_write()
    w.write(data)
    wb.new_commit().commit(w.prepare_commit())


def test_kv_query_service_end_to_end(tmp_path):
    """tests/test_service.py::test_kv_query_service_end_to_end in each
    package: the address file, ping, lookups before and after a commit and
    a refresh, an unknown method's error on a connection that stays usable,
    and the address file gone after shutdown."""
    out = {}
    for pkg in PKGS:
        svc = SVC[pkg]
        t = catalog(pkg, tmp_path / pkg).create_table("db.kv", schema(pkg), primary_keys=["id"],
                                                      options={"bucket": "2", **ENGINE[pkg]})
        write(t, {"id": [1, 2, 3], "name": ["a", "b", "c"], "v": [1.0, 2.0, 3.0]})
        server = svc.KvQueryServer(t)
        host, port = server.start()
        steps = []
        try:
            steps.append(svc.ServiceManager(t.file_io, t.path).address(svc.ServiceManager.PRIMARY_KEY_LOOKUP) == (host, port))
            client = svc.KvQueryClient.for_table(t)
            steps += [client.ping(), client.lookup((), 2), client.lookup((), 404), client.health(), client.slo()]
            write(t, {"id": [2], "name": ["b2"], "v": [22.0]})
            steps.append(client.lookup((), 2))
            client.refresh()
            steps.append(client.lookup((), 2))
            with pytest.raises(RuntimeError) as e:
                client._call("nope")
            steps += [str(e.value), client.ping(), client.get_batch([3, 2, 9], tenant="ignored")]
            client.close()
        finally:
            server.shutdown()
        steps.append(svc.ServiceManager(t.file_io, t.path).address(svc.ServiceManager.PRIMARY_KEY_LOOKUP))
        out[pkg] = steps
    assert out["port"] == out["jax"]
    assert out["port"][2:4] == [(2, "b", 2.0), None] and out["port"][7] == (2, "b2", 22.0)


def test_two_clients_concurrently(tmp_path):
    """tests/test_service.py::test_two_clients_concurrently with the port's
    server and four port clients on threads, and then a JAX client per
    thread against the same server."""
    t = catalog("port", tmp_path).create_table("db.kv2", schema("port"), primary_keys=["id"],
                                               options={"bucket": "1", "sort-engine": "pallas"})
    n = 200
    write(t, {"id": list(range(n)), "name": [f"n{i}" for i in range(n)], "v": [float(i) for i in range(n)]})
    server = psvc.KvQueryServer(t)
    host, port = server.start()
    errors = []

    def worker(offset, client_cls):
        try:
            c = client_cls(host, port)
            for i in range(offset, n, 4):
                assert c.lookup((), i) == (i, f"n{i}", float(i))
            c.close()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    try:
        for client_cls in (psvc.KvQueryClient, jsvc.KvQueryClient):
            threads = [threading.Thread(target=worker, args=(o, client_cls)) for o in range(4)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
        assert not errors, errors
    finally:
        server.shutdown()


def test_kv_server_get_batch_and_typed_busy(tmp_path):
    """tests/test_point_get.py::test_kv_server_get_batch_and_typed_busy in
    each package: the same rows and the same typed BUSY payload while the
    admission gate is held."""
    out = {}
    for pkg in PKGS:
        svc = SVC[pkg]
        t = catalog(pkg, tmp_path / pkg).create_table("db.srv", schema(pkg), primary_keys=["id"],
                                                      options={"bucket": "2", **ENGINE[pkg]})
        write(t, {"id": [1, 2, 3], "name": ["a", "b", "c"], "v": [1.0, 2.0, 3.0]})
        srv = svc.KvQueryServer(t, max_inflight_gets=1)
        host, port = srv.start()
        try:
            c = svc.KvQueryClient(host, port)
            steps = [c.get_batch([1, 2, 99])]
            assert srv._get_gate.acquire(blocking=False)
            try:
                with pytest.raises(svc.KvBusyError) as ei:
                    c.get_batch([1])
            finally:
                srv._get_gate.release()
            e = ei.value
            steps += [e.payload, e.retry_after_ms, e.shed_info.kind, e.shed_info.state, str(e), c.get_batch([1])]
            c.close()
        finally:
            srv.shutdown()
        out[pkg] = steps
    assert out["port"] == out["jax"]
    assert out["port"][0] == [(1, "a", 1.0), (2, "b", 2.0), None]
    assert out["port"][1]["state"] == "busy-reads" and out["port"][2] > 0


def test_max_inflight_option_and_a_concurrent_get(tmp_path):
    """lookup.get.max-inflight 1 on the table: a get that meets another in
    flight is answered with the typed BUSY at once, and the admitted one
    returns its rows."""
    t = catalog("port", tmp_path).create_table(
        "db.one", schema("port"), primary_keys=["id"],
        options={"bucket": "1", "sort-engine": "pallas", "lookup.get.max-inflight": "1"})
    write(t, {"id": [1, 2], "name": ["a", "b"], "v": [1.0, 2.0]})
    srv = psvc.KvQueryServer(t)
    entered, release = threading.Event(), threading.Event()
    inner = srv.query.get_batch

    def held(keys, partition=()):
        entered.set()
        release.wait(30)
        return inner(keys, partition)

    srv.query.get_batch = held
    host, port = srv.start()
    first = {}
    a, b = psvc.KvQueryClient(host, port), jsvc.KvQueryClient(host, port)
    try:
        th = threading.Thread(target=lambda: first.setdefault("rows", a.get_batch([2, 5])))
        th.start()
        assert entered.wait(30)
        with pytest.raises(jsvc.KvBusyError) as e:
            b.get_batch([1])
        release.set()
        th.join(timeout=30)
        assert e.value.payload == {"id": 1, "ok": False, "busy": True, "kind": "get_batch", "state": "busy-reads",
                                   "retry_after_ms": 25}
        assert first["rows"] == [(2, "b", 2.0), None]
    finally:
        release.set()
        a.close()
        b.close()
        srv.shutdown()


def test_kv_server_read_your_writes(tmp_path):
    """tests/test_point_get.py::test_kv_server_read_your_writes in each
    package, with a JAX client on the port's server."""
    out = {}
    for pkg in PKGS:
        svc = SVC[pkg]
        t = catalog(pkg, tmp_path / pkg).create_table("db.srv2", schema(pkg), primary_keys=["id"],
                                                      options={"bucket": "1", **ENGINE[pkg]})
        write(t, {"id": [1], "name": ["a"], "v": [1.0]})
        tw = t.new_batch_write_builder().new_write()
        srv = svc.KvQueryServer(t, table_write=tw)
        host, port = srv.start()
        try:
            tw.write({"id": [9, 1], "name": ["buf", "a2"], "v": [9.0, 1.5]})
            c = jsvc.KvQueryClient(host, port)
            out[pkg] = [c.get_batch([1, 9, 4]), c.lookup((), 9)]
            c.close()
        finally:
            srv.shutdown()
            tw.close()
    assert out["port"] == out["jax"]
    assert out["port"][0] == [(1, "a2", 1.5), (9, "buf", 9.0), None]


def typed_rows(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    ids = rng.permutation(4 * n)[:n].astype(np.int64)

    def nulls(values):
        return [None if rng.random() < 0.2 else v for v in values]

    return {"id": ids.tolist(), "d": nulls(rng.standard_normal(n).tolist()),
            "s": nulls([f"s{int(x)}-é" for x in rng.integers(0, 50, n)]),
            "dec": nulls(rng.integers(-10**6, 10**6, n).tolist()), "dt": nulls(rng.integers(0, 30000, n).tolist()),
            "ts": nulls(rng.integers(0, 2 * 10**12, n).tolist())}


def typed_schema(pkg):
    t = TYPES[pkg]
    return t.RowType.of(("id", t.BIGINT(False)), ("d", t.DOUBLE()), ("s", t.STRING()), ("dec", t.DECIMAL(12, 2)),
                        ("dt", t.DATE()), ("ts", t.TIMESTAMP(3)))


@pytest.mark.parametrize("server_pkg, client_pkg", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_each_client_reads_each_server_over_the_type_matrix(tmp_path, server_pkg, client_pkg):
    """The JAX package writes one table (two commits over BIGINT, DOUBLE,
    STRING, DECIMAL, DATE and TIMESTAMP, 20% nulls, an upsert); a server of
    one package serves it, a client of the other finds it through the
    address file and gets batches (about half the keys absent) and scalar
    lookups, each equal to the JAX package's in-process LocalTableQuery."""
    jtable = catalog("jax", tmp_path).create_table("db.types", typed_schema("jax"), primary_keys=["id"],
                                                   options={"bucket": "2"})
    first, second = typed_rows(300, 1), typed_rows(100, 2)
    write(jtable, first)
    write(jtable, second)
    table = catalog(server_pkg, tmp_path).get_table("db.types")
    srv = SVC[server_pkg].KvQueryServer(table)
    srv.start()
    oracle = JaxQuery(jtable)
    keys = np.random.default_rng(3).integers(0, 1300, 400).tolist()
    try:
        client = SVC[client_pkg].KvQueryClient.for_table(catalog(client_pkg, tmp_path).get_table("db.types"))
        got = client.get_batch(keys)
        want = oracle.get_batch(keys).to_pylist()
        assert got == want
        assert sum(r is None for r in got) > 100 and sum(r is not None for r in got) > 100
        assert any(r is not None and None in r for r in got), "no null value crossed the wire"
        for k in keys[:40]:
            row = oracle.lookup((), k)
            assert client.lookup((), k) == (None if row is None else row.to_pylist()[0])
        client.close()
    finally:
        srv.shutdown()


def test_gets_from_several_threads_stay_exact(tmp_path):
    """Twelve client threads (more than this machine's cores), half of them
    the JAX package's, with a short thread switch interval, against one
    port server on a three-commit table: each thread's batches equal the
    in-process get_batch of the same keys (the handler threads run the
    merge through the kernels' plain versions here, the kernels on CUDA)."""
    t = catalog("port", tmp_path).create_table("db.many", schema("port"), primary_keys=["id"],
                                               options={"bucket": "1", "sort-engine": "pallas"})
    rng = np.random.default_rng(8)
    for r in range(3):
        ids = rng.choice(5000, 2000, replace=False).astype(np.int64)
        write(t, {"id": ids, "name": np.array([f"r{r}-{i}" for i in ids], dtype=object), "v": ids * 0.5 + r})
    tw = t.new_batch_write_builder().new_write()
    tw.write({"id": np.array([7, 5001], dtype=np.int64), "name": np.array(["w7", "w5001"], dtype=object),
              "v": np.array([0.25, 0.75])})
    srv = psvc.KvQueryServer(t, table_write=tw)
    host, port = srv.start()
    local = PortQuery(t, device="cpu").attach_write(tw)
    answers, errors = {}, []

    def worker(i):
        try:
            c = (jsvc if i % 2 else psvc).KvQueryClient(host, port)
            r = np.random.default_rng(100 + i)
            answers[i] = [(keys, c.get_batch(keys.tolist())) for keys in (r.integers(0, 6000, 500) for _ in range(4))]
            c.close()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # more thread switches inside the server's handlers
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
        assert not errors and len(answers) == 12, errors
        for batches in answers.values():
            for keys, got in batches:
                assert got == local.get_batch(keys).to_pylist()
    finally:
        sys.setswitchinterval(switch)
        srv.shutdown()
        tw.close()


def test_health_slo_and_the_wire_format(tmp_path):
    """health serves the colocated writer's WriteBufferController state
    (the JAX package's schema), slo answers {} without a gateway, and the
    frames are a 4-byte big-endian length and UTF-8 JSON."""
    from paimon_tpu.core.admission import WriteBufferController as JaxController
    from paimon_tpu_torch.core.admission import WriteBufferController as PortController

    out = {}
    for pkg, controller in (("jax", JaxController(1 << 20)), ("port", PortController(1 << 20))):
        t = catalog(pkg, tmp_path / pkg).create_table("db.h", schema(pkg), primary_keys=["id"], options={"bucket": "1"})
        write(t, {"id": [1], "name": ["a"], "v": [1.0]})
        controller.reserve(1000)
        srv = SVC[pkg].KvQueryServer(t, health_provider=controller.health_dict)
        host, port = srv.start()
        try:
            sock = socket.create_connection((host, port), timeout=30)
            replies = []
            for req in ({"id": 7, "method": "health"}, {"id": 8, "method": "slo"},
                        {"id": 9, "method": "get_batch", "keys": [[1], 2], "tenant": "t1"}):
                body = json.dumps(req).encode()
                sock.sendall(struct.pack(">I", len(body)) + body)
                (length,) = struct.unpack(">I", sock.recv(4, socket.MSG_WAITALL))
                replies.append(json.loads(sock.recv(length, socket.MSG_WAITALL)))
            sock.close()
        finally:
            srv.shutdown()
        out[pkg] = replies
    assert out["port"] == out["jax"]
    assert out["port"][1] == {"id": 8, "ok": True, "slo": {}}
    assert out["port"][2] == {"id": 9, "ok": True, "rows": [[1, "a", 1.0], None]}


def test_a_gateway_is_not_ported(tmp_path):
    t = catalog("port", tmp_path).create_table("db.g", schema("port"), primary_keys=["id"], options={"bucket": "1"})
    with pytest.raises(NotImplementedError, match=r"service/gateway.py.*ROADMAP Queue 1 item 15 \(d\)"):
        psvc.KvQueryServer(t, gateway=object())


@pytest.mark.parametrize("payload", [
    {"busy": True, "state": "busy-reads", "retry_after_ms": 25},
    {"state": "queue-full", "consumer_id": "c1", "next_snapshot": 7, "retry_after_ms": 250},
    {"busy": True, "kind": "put", "state": "throttling", "tenant": "acme", "retry_after_ms": 3, "extra": [1, 2]},
    {"state": "busy-subscribers", "consumer_id": None, "next_snapshot": None, "subscribers": 4},
], ids=["kv", "subscription", "tenant", "no-offset"])
def test_shed_info_round_trips_between_the_packages(payload):
    """A payload parsed by one package's ShedInfo and serialised again
    reads back in the other's to the same record and the same wire dict;
    the exception types carry the same attributes."""
    for a, b in (("jax", "port"), ("port", "jax")):
        info = SHED[a].ShedInfo.from_payload(payload)
        wire = info.to_payload()
        back = SHED[b].ShedInfo.from_payload(wire)
        assert back.to_payload() == wire
        assert vars(back) == vars(info)
    for kind, cls_name in (("get_batch", "KvBusyError"),):
        errors = {pkg: getattr(SVC[pkg], cls_name)(dict(payload)) for pkg in PKGS}
        assert errors["port"].payload == errors["jax"].payload
        assert errors["port"].retry_after_ms == errors["jax"].retry_after_ms
        assert str(errors["port"]) == str(errors["jax"])
        assert errors["port"].shed_info.kind == errors["jax"].shed_info.kind == (payload.get("kind") or kind)
    gw = {pkg: SHED[pkg].GatewayShedError(SHED[pkg].ShedInfo.from_payload(payload)) for pkg in PKGS}
    assert gw["port"].payload == gw["jax"].payload and str(gw["port"]) == str(gw["jax"])
