"""The port's catalogs (paimon_tpu_torch/catalog/: the JDBC catalog and its
lock, file-based privileges, the catalog-scope system tables and the
lineage store) against the JAX package's, on the CPU (device="cpu").

Each case runs one script through both packages, on a twin warehouse per
package or on one warehouse both open, and asserts the same listings,
rows, system tables, lineage, repair results, grants, lock rows and
errors: the cases of tests/test_jdbc_catalog.py; test_global_system_tables,
test_lineage_tables, test_catalog_lock_serializes_commits and
test_sys_database_reserved of tests/test_global_tables_lookup.py;
tests/test_formats_aux.py::test_privileged_catalog; the repair and
privilege cases of tests/test_sql_round5.py. Across packages: one sqlite
file opened by both packages' JdbcCatalogs, JAX and port committers on one
table under the jdbc lock read by both to the same rows, and the grants
each package makes enforced by the other. The port's tables merge under
sort-engine=pallas (the kernels' plain versions on the CPU), the JAX
package's under numpy.

Tolerance: exact.
"""

import io
import os
import sqlite3
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import paimon_tpu as jt
import paimon_tpu.catalog as jcat_mod
import paimon_tpu.catalog.jdbc as jjdbc
import paimon_tpu.catalog.privilege as jpriv
import paimon_tpu.sql as jsql
import paimon_tpu_torch as tt
import paimon_tpu_torch.catalog as pcat_mod
import paimon_tpu_torch.catalog.jdbc as pjdbc
import paimon_tpu_torch.catalog.privilege as ppriv
import paimon_tpu_torch.sql as psql

PKGS = ("jax", "port")
TYPES = {"jax": jt, "port": tt}
JDBC = {"jax": jjdbc, "port": pjdbc}
PRIV = {"jax": jpriv, "port": ppriv}
SQL = {"jax": jsql, "port": psql}
ENGINE = {"jax": {"sort-engine": "numpy"}, "port": {"sort-engine": "pallas"}}
DEVICE = {"jax": {}, "port": {"device": "cpu"}}


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


def schema(pkg):
    t = TYPES[pkg]
    return t.RowType.of(("id", t.BIGINT()), ("v", t.DOUBLE()))


def fs_catalog(pkg, warehouse, user="cat"):
    cls = jcat_mod.FileSystemCatalog if pkg == "jax" else pcat_mod.FileSystemCatalog
    return cls(str(warehouse), commit_user=user, **DEVICE[pkg])


def jdbc_catalog(pkg, db, warehouse, user="jdbc"):
    return JDBC[pkg].JdbcCatalog(str(db), str(warehouse), commit_user=user, **DEVICE[pkg])


def write(t, ids, values, kinds=None):
    wb = t.new_batch_write_builder()
    w = wb.new_write()
    w.write({"id": np.asarray(ids, dtype=np.int64), "v": np.asarray(values, dtype=np.float64)}, kinds)
    wb.new_commit().commit(w.prepare_commit())


def rows(t, pkg):
    rb = t.copy(ENGINE[pkg]).new_read_builder()
    return sorted(rb.new_read().read_all(rb.new_scan().plan()).to_pylist())


def outcome(fn):
    """The value, or the exception's type and message."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return (type(e).__name__, str(e))


def test_jdbc_catalog_crud_and_io(tmp_path):
    """tests/test_jdbc_catalog.py::test_jdbc_catalog_crud_and_io, one
    script through each package on its own warehouse and database."""
    out = {}
    for pkg in PKGS:
        wh = tmp_path / pkg
        cat = jdbc_catalog(pkg, tmp_path / f"{pkg}.db", wh)
        steps = []
        t = cat.create_table("db.orders", schema(pkg), primary_keys=["id"], options={"bucket": "1", **ENGINE[pkg]})
        steps += [cat.list_databases(), cat.list_tables("db")]
        write(t, [1, 2], [1.0, 2.0])
        steps.append(rows(cat.get_table("db.orders"), pkg))
        steps.append(len(cat.get_table("db.orders$snapshots").to_pylist()))
        cat.rename_table("db.orders", "db.orders2")
        steps += [cat.list_tables("db"), rows(cat.get_table("db.orders2"), pkg)]
        steps.append(outcome(lambda: cat.get_table("db.orders")))
        steps.append(outcome(lambda: cat.rename_table("db.nope", "db.x")))
        steps.append(outcome(lambda: cat.create_table("db.orders2", schema(pkg))))
        cat.create_table("db.other", schema(pkg), primary_keys=["id"], options={"bucket": "1"})
        steps.append(outcome(lambda: cat.rename_table("db.orders2", "db.other")))
        cat.drop_table("db.orders2")
        steps.append(cat.list_tables("db"))
        steps.append(outcome(lambda: cat.drop_database("db")))
        cat.drop_database("db", cascade=True)
        steps += [cat.list_databases(), os.path.exists(wh / "db.db" / "other")]
        steps.append(outcome(lambda: cat.create_database("sys", ignore_if_exists=False)))
        out[pkg] = steps
    assert out["port"] == out["jax"]
    assert out["port"][2] == [(1, 1.0), (2, 2.0)] and out["port"][-1] == (
        "ValueError", "'sys' is reserved for catalog system tables")


def test_jdbc_lock_dialect(tmp_path):
    """tests/test_jdbc_catalog.py::test_jdbc_lock_dialect with the port's
    lock, and the JAX package's and the port's locks contending for one row
    of one database: the holders alternate strictly, and a crashed holder's
    stale row is taken over."""
    db = str(tmp_path / "locks.db")
    pjdbc.JdbcCatalog(db, str(tmp_path / "wh"), device="cpu")  # creates the lock table
    order = []
    errors = []

    def worker(i, module):
        try:
            with module.JdbcCatalogLock(db, "db.t").lock():
                order.append(("in", i))
                time.sleep(0.005)
                order.append(("out", i))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i, pjdbc if i % 2 else jjdbc)) for i in range(6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors and len(order) == 12
    for j in range(0, len(order), 2):
        assert order[j][0] == "in" and order[j + 1][0] == "out" and order[j][1] == order[j + 1][1]
    with sqlite3.connect(db) as c:
        c.execute("INSERT INTO paimon_distributed_locks VALUES (?, ?, ?)", ("db.stale", "dead", time.time() - 10_000))
    with pjdbc.JdbcCatalogLock(db, "db.stale", timeout=5.0).lock():
        with sqlite3.connect(db) as c:
            held = c.execute("SELECT lock_id, holder FROM paimon_distributed_locks").fetchall()
        assert len(held) == 1 and held[0][0] == "db.stale" and held[0][1] != "dead"
    # a live holder of the JAX package's keeps the port's waiter out
    with jjdbc.JdbcCatalogLock(db, "db.busy").lock():
        with pytest.raises(TimeoutError, match="could not acquire jdbc lock db.busy"):
            with pjdbc.JdbcCatalogLock(db, "db.busy", timeout=0.2).lock():
                pass
    with sqlite3.connect(db) as c:
        assert c.execute("SELECT count(*) FROM paimon_distributed_locks").fetchone() == (0,)


def test_one_sqlite_file_shared_by_both_packages(tmp_path):
    """A JdbcCatalog of each package on one database and warehouse: each
    sees the other's databases and tables, reads its rows, and follows its
    renames and drops."""
    db, wh = tmp_path / "shared.db", tmp_path / "wh"
    cats = {pkg: jdbc_catalog(pkg, db, wh, user=pkg) for pkg in PKGS}
    ta = cats["jax"].create_table("db.a", schema("jax"), primary_keys=["id"], options={"bucket": "1"})
    write(ta, [1, 2, 3], [1.0, 2.0, 3.0])
    tb = cats["port"].create_table("db2.b", schema("port"), primary_keys=["id"], options={"bucket": "2"})
    write(tb, [5, 6], [5.0, 6.0])
    for pkg in PKGS:
        assert cats[pkg].list_databases() == ["db", "db2"]
        assert cats[pkg].list_tables("db") == ["a"] and cats[pkg].list_tables("db2") == ["b"]
        assert rows(cats[pkg].get_table("db.a"), pkg) == [(1, 1.0), (2, 2.0), (3, 3.0)]
        assert rows(cats[pkg].get_table("db2.b"), pkg) == [(5, 5.0), (6, 6.0)]
    cats["port"].rename_table("db.a", "db.a2")
    assert cats["jax"].list_tables("db") == ["a2"]
    assert rows(cats["jax"].get_table("db.a2"), "jax") == [(1, 1.0), (2, 2.0), (3, 3.0)]
    cats["jax"].drop_table("db2.b")
    assert cats["port"].list_tables("db2") == []
    assert outcome(lambda: cats["port"].get_table("db2.b")) == outcome(lambda: cats["jax"].get_table("db2.b"))


@pytest.mark.parametrize("lock_type", ["file", "jdbc"])
def test_catalog_lock_serializes_commits(tmp_path, lock_type):
    """tests/test_global_tables_lookup.py::test_catalog_lock_serializes_commits:
    six concurrent committers under commit.catalog-lock.enabled each land
    one snapshot, in each package; under the jdbc lock each commit's row is
    the table path's."""
    out = {}
    for pkg in PKGS:
        options = {"bucket": "1", "commit.catalog-lock.enabled": "true", "commit.catalog-lock.type": lock_type,
                   **ENGINE[pkg]}
        if lock_type == "jdbc":
            options["commit.catalog-lock.jdbc-path"] = str(tmp_path / f"{pkg}-locks.db")
        t = fs_catalog(pkg, tmp_path / pkg).create_table("db.lk", schema(pkg), primary_keys=["id"], options=options)
        errors = []

        def worker(i):
            try:
                write(t, [i], [float(i)])
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not errors, errors
        out[pkg] = (rows(t, pkg), t.store.snapshot_manager.latest_snapshot_id(), type(t.store.new_commit()._lock).__name__)
    assert out["port"] == out["jax"]
    assert out["port"][0] == [(i, float(i)) for i in range(6)] and out["port"][1] == 6


def test_jax_and_port_committers_under_one_jdbc_lock(tmp_path):
    """Committers of both packages on one table, under one jdbc lock row
    keyed by the table path: every commit lands once, and both packages
    read the same rows."""
    db = str(tmp_path / "locks.db")
    options = {"bucket": "1", "commit.catalog-lock.enabled": "true", "commit.catalog-lock.type": "jdbc",
               "commit.catalog-lock.jdbc-path": db}
    fs_catalog("jax", tmp_path / "wh").create_table("db.t", schema("jax"), primary_keys=["id"], options=options)
    tables = {pkg: fs_catalog(pkg, tmp_path / "wh", user=f"{pkg}-writer").get_table("db.t") for pkg in PKGS}
    assert tables["port"].store.new_commit()._lock.lock_id == tables["jax"].store.new_commit()._lock.lock_id
    rng = np.random.default_rng(29)
    keys = rng.permutation(60).astype(np.int64).reshape(6, 10)
    errors = []

    def worker(i):
        try:
            write(tables[PKGS[i % 2]], keys[i], keys[i] * 0.5 + i)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors, errors
    want = sorted((int(k), float(k) * 0.5 + i) for i in range(6) for k in keys[i])
    for pkg in PKGS:
        t = fs_catalog(pkg, tmp_path / "wh").get_table("db.t")
        assert rows(t, pkg) == want
        sm = t.store.snapshot_manager
        assert sm.latest_snapshot_id() == 6
        assert sorted(sm.snapshot(i).commit_user for i in range(1, 7)) == ["jax-writer"] * 3 + ["port-writer"] * 3
    with sqlite3.connect(db) as c:
        assert c.execute("SELECT count(*) FROM paimon_distributed_locks").fetchone() == (0,)


def test_global_system_tables(tmp_path):
    """tests/test_global_tables_lookup.py::test_global_system_tables: the
    same rows in sys.all_table_options and sys.catalog_options (the
    warehouse path aside), and each package's table over the other's
    warehouse equal to its own."""
    out = {}
    for pkg in PKGS:
        cat = fs_catalog(pkg, tmp_path / pkg)
        cat.create_table("db.a", schema(pkg), primary_keys=["id"], options={"bucket": "2"})
        cat.create_table("db2.b", schema(pkg), options={"write-only": "true"})
        cat.create_table("db2.c", schema(pkg), primary_keys=["id"], options={"bucket": "1", "changelog-producer": "input"})
        co = cat.get_table("sys.catalog_options").to_pylist()
        out[pkg] = (cat.get_table("sys.all_table_options").to_pylist(),
                    [(k, v.replace(str(tmp_path / pkg), "<wh>")) for k, v in co],
                    outcome(lambda: cat.get_table("sys.nope")))
    assert out["port"] == out["jax"]
    assert ("db", "a", "bucket", "2") in out["port"][0] and ("db2", "b", "write-only", "true") in out["port"][0]
    assert out["port"][1] == [("warehouse", "<wh>")]
    for pkg, other in (("jax", "port"), ("port", "jax")):
        assert fs_catalog(pkg, tmp_path / other).get_table("sys.all_table_options").to_pylist() == out[pkg][0]


def test_lineage_tables(tmp_path):
    """tests/test_global_tables_lookup.py::test_lineage_tables, with both
    packages saving lineage into one warehouse: the four lineage tables
    hold both packages' entries, in the same rows for each reader."""
    cats = {pkg: fs_catalog(pkg, tmp_path / "wh") for pkg in PKGS}
    for pkg, job in (("jax", "job1"), ("port", "job2")):
        lm = cats[pkg].lineage_meta()
        lm.save_source_table_lineage(job, "db.a")
        lm.save_sink_table_lineage(job, "db.b")
        lm.save_source_data_lineage(job, "db.a", barrier_id=7, snapshot_id=3)
        lm.save_sink_data_lineage(job, "db.b", barrier_id=7, snapshot_id=9)
        time.sleep(0.002)  # entries sort by create_time
    tables = ("source_table_lineage", "sink_table_lineage", "source_data_lineage", "sink_data_lineage")
    seen = {pkg: {n: cats[pkg].get_table(f"sys.{n}").to_pylist() for n in tables} for pkg in PKGS}
    assert seen["port"] == seen["jax"]
    src = seen["port"]["source_table_lineage"]
    assert [r[:3] for r in src] == [("db", "a", "job1"), ("db", "a", "job2")]
    assert [r[:5] for r in seen["port"]["sink_data_lineage"]] == [("db", "b", "job1", 7, 9), ("db", "b", "job2", 7, 9)]
    assert seen["port"]["source_data_lineage"][0][3] == 7
    assert [f.name for f in cats["port"].get_table("sys.sink_data_lineage").row_type.fields] == [
        f.name for f in cats["jax"].get_table("sys.sink_data_lineage").row_type.fields]


def test_sys_database_reserved(tmp_path):
    """tests/test_global_tables_lookup.py::test_sys_database_reserved, on
    the FileSystemCatalog and the JdbcCatalog of each package."""
    out = {}
    for pkg in PKGS:
        cats = (fs_catalog(pkg, tmp_path / pkg), jdbc_catalog(pkg, tmp_path / f"{pkg}.db", tmp_path / f"{pkg}-j"))
        out[pkg] = [outcome(lambda c=c: c.create_database("sys", ignore_if_exists=False)) for c in cats] + [
            outcome(lambda c=c: c.create_table("sys.t", schema(pkg))) for c in cats]
    assert out["port"] == out["jax"]
    assert all(o[0] == "ValueError" and "reserved" in o[1] for o in out["port"])


def test_privileged_catalog(tmp_path):
    """tests/test_formats_aux.py::test_privileged_catalog through each
    package on its own warehouse: the same outcomes step by step."""
    out = {}
    for pkg in PKGS:
        wh = str(tmp_path / pkg)
        priv = PRIV[pkg]
        steps = []
        pm = priv.PrivilegeManager(wh)
        pm.init("rootpw")
        root = priv.PrivilegedCatalog(wh, "root", "rootpw", **DEVICE[pkg])
        t = root.create_table("db.secure", schema(pkg), primary_keys=["id"], options={"bucket": "1"})
        write(t, [1, 2], [1.0, 2.0])
        pm.create_user("bob", "pw")
        bob = priv.PrivilegedCatalog(wh, "bob", "pw", **DEVICE[pkg])
        steps.append(outcome(lambda: bob.get_table("db.secure")))
        pm.grant("bob", "db.secure", "SELECT")
        steps.append(rows(bob.get_table("db.secure"), pkg))
        steps.append(outcome(lambda: bob.writable_table("db.secure")))
        steps.append(outcome(lambda: bob.drop_table("db.secure")))
        pm.grant("bob", "db", "ADMIN")
        steps.append(bob.writable_table("db.secure").name)
        steps.append(outcome(lambda: priv.PrivilegedCatalog(wh, "bob", "wrong", **DEVICE[pkg])))
        pm.revoke("bob", "db", "ADMIN")
        steps.append(outcome(lambda: bob.writable_table("db.secure")))
        steps.append(outcome(lambda: pm.init("again")))
        steps.append(outcome(lambda: pm.create_user("bob", "x")))
        steps.append(outcome(lambda: pm.grant("nobody", "db", "SELECT")))
        steps += [bob.list_databases(), bob.list_tables("db"), outcome(lambda: bob.create_database("db3"))]
        pm.drop_user("bob")
        steps.append(outcome(lambda: priv.PrivilegedCatalog(wh, "bob", "pw", **DEVICE[pkg])))
        out[pkg] = steps
    assert out["port"] == out["jax"]
    assert out["port"][0] == ("AccessDeniedError", "user 'bob' lacks SELECT on 'db.secure'")
    assert out["port"][1] == [(1, 1.0), (2, 2.0)] and out["port"][4] == "secure"


def test_grants_made_by_each_package_hold_in_the_other(tmp_path):
    """One warehouse: the JAX package's PrivilegeManager initialises it and
    grants, the port's PrivilegedCatalog enforces those grants; then the
    port's manager grants and revokes, the JAX package's catalog enforces
    them. The store file is the same bytes whoever wrote it last."""
    wh = str(tmp_path / "wh")
    jm = jpriv.PrivilegeManager(wh)
    jm.init("rootpw")
    jroot = jpriv.PrivilegedCatalog(wh, "root", "rootpw")
    write(jroot.create_table("db.t", schema("jax"), primary_keys=["id"], options={"bucket": "1"}), [1], [1.0])
    jm.create_user("carol", "pw")
    jm.grant("carol", "db.t", "SELECT")
    carol = ppriv.PrivilegedCatalog(wh, "carol", "pw", device="cpu")
    assert rows(carol.get_table("db.t"), "port") == [(1, 1.0)]
    with pytest.raises(ppriv.AccessDeniedError, match="lacks INSERT"):
        carol.writable_table("db.t")
    with pytest.raises(ppriv.AccessDeniedError, match="authentication failed"):
        ppriv.PrivilegedCatalog(wh, "carol", "wrong", device="cpu")
    pm = ppriv.PrivilegeManager(wh)
    pm.grant("carol", "*", "INSERT")
    jcarol = jpriv.PrivilegedCatalog(wh, "carol", "pw")
    write(jcarol.writable_table("db.t"), [2], [2.0])
    assert rows(carol.get_table("db.t"), "port") == [(1, 1.0), (2, 2.0)]
    pm.revoke("carol", "*", "INSERT")
    with pytest.raises(jpriv.AccessDeniedError, match="lacks INSERT"):
        jcarol.writable_table("db.t")
    before = open(os.path.join(wh, ".privilege", "meta.json"), "rb").read()
    jm.revoke("carol", "nowhere", "SELECT")  # a no-op rewrite by the JAX package
    assert open(os.path.join(wh, ".privilege", "meta.json"), "rb").read() == before


def test_repair_procedure(tmp_path):
    """tests/test_sql_round5.py::test_repair_procedure_requires_capable_catalog
    and JdbcCatalog.repair's cases, through CALL sys.repair in each package
    on its own warehouse: a table made behind the catalog's back is
    registered, a renamed table keeps its location, a row whose schema is
    gone is removed, a database with neither is removed, and a scoped
    repair touches nothing outside its scope."""
    out = {}
    for pkg in PKGS:
        wh = tmp_path / pkg
        fs = fs_catalog(pkg, wh)
        steps = [outcome(lambda: SQL[pkg].call(fs, "CALL sys.repair()"))]
        cat = jdbc_catalog(pkg, tmp_path / f"{pkg}-meta.db", wh)
        write(cat.create_table("jdb.jt", schema(pkg), primary_keys=["id"], options={"bucket": "1"}), [1], [1.0])
        steps.append(SQL[pkg].call(cat, "CALL sys.repair()"))
        fs.create_table("jdb.behind", schema(pkg), primary_keys=["id"], options={"bucket": "1"})
        fs.create_table("other.x", schema(pkg), primary_keys=["id"], options={"bucket": "1"})
        steps.append(SQL[pkg].call(cat, "CALL sys.repair('jdb')"))
        steps.append(cat.list_databases())
        cat.rename_table("jdb.jt", "jdb.renamed")
        steps.append(SQL[pkg].call(cat, "CALL sys.repair()"))
        cat.create_database("ghost")
        fs.drop_table("jdb.behind")
        steps.append(SQL[pkg].call(cat, "CALL sys.repair('jdb.behind')"))
        steps.append(SQL[pkg].call(cat, "CALL sys.repair()"))
        steps += [cat.list_databases(), {db: cat.list_tables(db) for db in cat.list_databases()}]
        steps.append(rows(cat.get_table("jdb.renamed"), pkg))
        out[pkg] = steps
    assert out["port"] == out["jax"]
    assert out["port"][0][0] == "ProcedureError" and "repair" in out["port"][0][1]
    assert out["port"][2] == {"registered": ["jdb.behind"], "removed": [], "removed_databases": []}
    assert out["port"][4] == {"registered": ["other.x"], "removed": [], "removed_databases": []}
    assert out["port"][6] == {"registered": [], "removed": [], "removed_databases": ["ghost"]}


def test_privilege_procedures(tmp_path):
    """tests/test_sql_round5.py::test_privilege_procedures through each
    package's CALL on its own warehouse: the same results, and the full
    procedure set of the JAX package reachable by name."""
    out = {}
    for pkg in PKGS:
        cat = PRIV[pkg].PrivilegedCatalog(str(tmp_path / pkg), "root", "rootpw", **DEVICE[pkg])
        call = SQL[pkg].call
        steps = [call(cat, "CALL sys.init_file_based_privilege('rootpw')"),
                 call(cat, "CALL sys.create_privileged_user('alice', 'pw1')"),
                 call(cat, "CALL sys.grant_privilege_to_user('alice', 'SELECT', 'db', 't')"),
                 cat.manager.has("alice", "db.t", "SELECT"),
                 call(cat, "CALL sys.grant_privilege_to_user('alice', 'ADMIN')"),
                 cat.manager.has("alice", "x.y", "INSERT"),
                 call(cat, "CALL sys.revoke_privilege_from_user('alice', 'ADMIN')"),
                 call(cat, "CALL sys.revoke_privilege_from_user('alice', 'SELECT', 'db', 't')"),
                 cat.manager.has("alice", "db.t", "SELECT"),
                 outcome(lambda: call(cat, "CALL sys.create_privileged_user('alice', 'pw2')")),
                 call(cat, "CALL sys.drop_privileged_user('alice')"),
                 cat.manager.authenticate("alice", "pw1"),
                 outcome(lambda: call(cat, "CALL sys.init_file_based_privilege('x')"))]
        out[pkg] = steps
    assert out["port"] == out["jax"]
    assert out["port"][2] == {"user": "alice", "granted": "SELECT", "on": "db.t"}
    assert out["port"][3] and out["port"][5] and not out["port"][8] and not out["port"][11]
    assert set(psql.procedures) == set(jsql.procedures)
