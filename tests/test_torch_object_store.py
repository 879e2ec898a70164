"""The port's object store (paimon_tpu_torch/fs/object_store.py), the catalog
lock (catalog/lock.py) and tables on object stores, against the JAX
package, on the CPU (device="cpu" for the port).

Held equal on the same inputs: the outcome of one scripted op sequence
(conditional PUT, exclusive create, the legacy store's check-then-put,
rename as copy and delete, the flat namespace) and the objects it leaves,
with no `.os-staging/` leak; which lock a commit engages on each store and
the error where none can work, the jdbc lock's row during a commit
included. Tables on s3://, oss:// and fail-s3:// are
written by one package and read by the other, row for row; a table
renamed on the store stays readable by both. The port's own lock is held
to mutual exclusion through a stale-lock takeover.

Tolerance: exact.
"""

import io
import os
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import paimon_tpu as jt
import paimon_tpu.fs as jfs
import paimon_tpu.fs.testing as jtesting
import paimon_tpu_torch as tt
import paimon_tpu_torch.fs as pfs
import paimon_tpu_torch.fs.testing as ptesting
import paimon_tpu_torch.resilience.faults as pfaults
from paimon_tpu.catalog import FileSystemCatalog as JaxCatalog
from paimon_tpu_torch.catalog import FileSystemCatalog as PortCatalog
from paimon_tpu_torch.catalog.lock import FileBasedCatalogLock
from paimon_tpu_torch.fs.object_store import ObjectStoreFileIO

FS = {"jax": jfs, "port": pfs}
TESTING = {"jax": jtesting, "port": ptesting}


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


@pytest.fixture(autouse=True)
def _disarm():
    yield
    pfaults.disarm_crash_points()


def _store_sequence(fs, scheme: str, root: str) -> tuple:
    fio = fs.get_file_io(f"{scheme}://x")
    b = f"{scheme}://{root}"
    out = []

    def run(fn):
        try:
            out.append(repr(fn()))
        except Exception as exc:  # noqa: BLE001 - the outcome is compared
            out.append(type(exc).__name__)

    run(lambda: (fio.atomic_write_supported, fio.exclusive_create_supported))
    run(lambda: fio.try_atomic_write(f"{b}/obj", b"first"))
    run(lambda: fio.try_atomic_write(f"{b}/obj", b"second"))  # a lost CAS
    run(lambda: fio.read_bytes(f"{b}/obj"))
    run(lambda: fio.write_bytes(f"{b}/obj", b"third"))  # exclusive create
    run(lambda: fio.write_bytes(f"{b}/obj", b"fourth", overwrite=True))  # a plain PUT clobbers
    run(lambda: fio.read_bytes(f"{b}/obj"))
    run(lambda: fio.write_bytes(f"{b}/a", b"payload"))
    run(lambda: fio.rename(f"{b}/a", f"{b}/moved"))  # copy + delete
    run(lambda: (fio.exists(f"{b}/a"), fio.read_bytes(f"{b}/moved")))
    run(lambda: fio.write_bytes(f"{b}/a", b"other"))
    run(lambda: fio.rename(f"{b}/a", f"{b}/moved"))  # the advisory check refuses
    run(lambda: fio.rename(f"{b}/missing", f"{b}/x"))
    run(lambda: fio.write_bytes(f"{b}/pfx/deep/key", b"v"))
    run(lambda: fio.exists(f"{b}/pfx"))  # a prefix exists through its objects
    run(lambda: fio.mkdirs(f"{b}/whatever"))
    run(lambda: [(os.path.relpath(s.path, root), s.is_dir) for s in fio.list_status(f"{b}/pfx")])
    run(lambda: fio.delete(f"{b}/pfx"))  # a bare prefix with children: no-op
    run(lambda: fio.delete(f"{b}/pfx", recursive=True))
    run(lambda: fio.exists(f"{b}/pfx/deep/key"))
    run(lambda: fio.write_bytes(f"{b}/d/dir/f1", b"1"))
    run(lambda: fio.rename(f"{b}/d", f"{b}/d2"))  # a prefix rename copies each object
    run(lambda: (fio.exists(f"{b}/d"), fio.read_bytes(f"{b}/d2/dir/f1")))
    run(lambda: fio.try_overwrite(f"{b}/hint", b"1"))
    run(lambda: fio.try_overwrite(f"{b}/hint", b"2"))
    run(lambda: fio.read_bytes(f"{b}/hint"))
    run(lambda: [os.path.relpath(s.path, root) for s in fio.list_files(root)])
    files = sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs_ in os.walk(root) for f in fs_)
    return out, files


@pytest.mark.parametrize("scheme", ["s3", "oss", "s3-legacy"])
def test_object_store_semantics_match_over_one_sequence(tmp_path, scheme):
    port = _store_sequence(pfs, scheme, str(tmp_path / "port"))
    assert port == _store_sequence(jfs, scheme, str(tmp_path / "jax"))
    outcomes, files = port
    assert outcomes[1:3] == ["True", "False"]
    assert outcomes[4] == "FileExistsError"
    assert not any(".os-staging" in f for f in files), files  # every PUT became visible whole


def test_conditional_put_many_racers_one_winner(tmp_path):
    fio = pfs.get_file_io("s3://x")
    p = f"s3://{tmp_path}/contested"
    wins = []
    barrier = threading.Barrier(8)

    def racer(i):
        barrier.wait()
        if fio.try_atomic_write(p, f"racer-{i}".encode()):
            wins.append(i)

    threads = [threading.Thread(target=racer, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(wins) == 1
    assert fio.read_bytes(p) == f"racer-{wins[0]}".encode()


def test_the_legacy_store_has_no_exclusive_create(tmp_path):
    fio = ObjectStoreFileIO(conditional_put=False)
    assert fio.try_atomic_write(f"{tmp_path}/obj", b"a") is True
    assert fio.try_atomic_write(f"{tmp_path}/obj", b"b") is False  # the check holds serially
    assert not fio.atomic_write_supported and not fio.exclusive_create_supported


# ---- tables on object stores ---------------------------------------------
def _catalog(pkg: str, warehouse: str, user: str = "s3user"):
    if pkg == "jax":
        return JaxCatalog(warehouse, commit_user=user)
    return PortCatalog(warehouse, commit_user=user, device="cpu")


def _schema(pkg: str):
    m = jt if pkg == "jax" else tt
    return m.RowType.of(("k", m.BIGINT()), ("v", m.DOUBLE()), ("s", m.STRING()))


def _write(t, ks, vs):
    wb = t.new_batch_write_builder()
    w = wb.new_write()
    ks = np.asarray(ks, dtype=np.int64)
    w.write({"k": ks, "v": np.asarray(vs, dtype=np.float64),
             "s": np.array([f"s{int(k) % 7}" for k in ks], dtype=object)})
    wb.new_commit().commit(w.prepare_commit())


def _read(t):
    rb = t.new_read_builder()
    return sorted(rb.new_read().read_all(rb.new_scan().plan()).to_pylist())


def _commits(t, rng):
    """Three commits over overlapping keys; returns the expected rows."""
    oracle = {}
    for r in range(3):
        ks = rng.choice(300, 120, replace=False)
        vs = rng.random(120)
        _write(t, ks, vs)
        oracle.update({int(k): float(v) for k, v in zip(ks, vs)})
    return sorted((k, v, f"s{k % 7}") for k, v in oracle.items())


@pytest.mark.parametrize("scheme", ["s3", "oss", "fail-s3"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_table_on_the_store_reads_the_same_in_both(tmp_path, scheme, writer):
    domain = f"os_{scheme}_{writer}".replace("-", "")
    for testing in TESTING.values():
        testing.FailingFileIO.reset(domain, 0, 0)
    warehouse = f"{scheme}://{domain if scheme.startswith('fail') else ''}{tmp_path}/wh"
    reader = "port" if writer == "jax" else "jax"
    t = _catalog(writer, warehouse).create_table(
        "db.t", _schema(writer), primary_keys=["k"],
        options={"bucket": "2", **({"sort-engine": "numpy"} if writer == "jax" else {})})
    expected = _commits(t, np.random.default_rng(5))
    assert _read(t) == expected
    other = _catalog(reader, warehouse).get_table("db.t")
    assert _read(other) == expected
    # the reader continues the table, the writer reads it back
    _write(other, [1000], [1.5])
    assert _read(_catalog(writer, warehouse).get_table("db.t")) == sorted(expected + [(1000, 1.5, "s6")])
    assert _catalog(reader, warehouse).list_tables("db") == ["t"]


def test_a_table_renamed_on_the_store_stays_readable_by_both(tmp_path):
    warehouse = f"s3://{tmp_path}/wh"
    t = _catalog("port", warehouse).create_table("db.t", _schema("port"), primary_keys=["k"],
                                                 options={"bucket": "1"})
    expected = _commits(t, np.random.default_rng(6))
    cat = _catalog("port", warehouse)
    cat.rename_table("db.t", "db.renamed")
    assert cat.list_tables("db") == ["renamed"]
    assert _read(cat.get_table("db.renamed")) == expected
    assert _read(_catalog("jax", warehouse).get_table("db.renamed")) == expected
    with pytest.raises(FileNotFoundError):
        cat.get_table("db.t")
    assert not any(".os-staging" in d for d, _, fs_ in os.walk(tmp_path) if fs_)


# ---- the catalog lock ----------------------------------------------------
def _lock_of(pkg: str, warehouse: str, options: dict):
    t = _catalog(pkg, warehouse).create_table("db.l", _schema(pkg), primary_keys=["k"],
                                              options={"bucket": "1", **options})
    try:
        lock = t.store.new_commit()._lock
    except (ValueError, NotImplementedError) as exc:
        return type(exc).__name__, str(exc)
    return type(lock).__name__ if lock is not None else None


@pytest.mark.parametrize("scheme, options", [
    ("s3", {}), ("oss", {}), ("fail-s3", {}), ("file", {}), ("file", {"commit.catalog-lock.enabled": "true"}),
    ("s3-legacy", {}), ("fail-s3-legacy", {}), ("s3", {"commit.catalog-lock.type": "bogus"}),
])
def test_the_same_lock_engages_on_each_store(tmp_path, scheme, options):
    out = {}
    for pkg in ("jax", "port"):
        root = f"{tmp_path}/{pkg}"
        warehouse = root if scheme == "file" else f"{scheme}://{'dom' if scheme.startswith('fail') else ''}{root}"
        TESTING[pkg].FailingFileIO.reset("dom", 0, 0)
        out[pkg] = _lock_of(pkg, warehouse, options)
    assert out["port"] == out["jax"]
    if scheme == "s3-legacy":
        assert out["port"][0] == "ValueError" and "no exclusive create" in out["port"][1]


def test_a_jdbc_lock_names_the_roadmap_item(tmp_path):
    """commit.catalog-lock.type=jdbc waited for catalog/jdbc.py (ROADMAP
    Queue 1 item 15 (c)). Now on each store (s3-legacy has no exclusive
    create, s3 has) the port engages what the JAX package engages: a
    JdbcCatalogLock on the same database, keyed by the table path, whose
    row exists while a commit publishes its snapshot and is gone after; a
    missing jdbc-path raises the JAX package's error."""
    import sqlite3

    import paimon_tpu.resilience.faults as jfaults

    faults = {"jax": jfaults, "port": pfaults}
    db = str(tmp_path / "locks.db")
    for scheme in ("s3-legacy", "s3"):
        out = {}
        for pkg in ("jax", "port"):
            path = f"{scheme}://{tmp_path}/{pkg}/{scheme}/db.db/l"
            t = _catalog(pkg, f"{scheme}://{tmp_path}/{pkg}/{scheme}").create_table(
                "db.l", _schema(pkg), primary_keys=["k"],
                options={"bucket": "1", "commit.catalog-lock.type": "jdbc", "commit.catalog-lock.jdbc-path": db})
            lock = t.store.new_commit()._lock
            seen = []

            def rows():
                with sqlite3.connect(db) as c:
                    return [r[0] for r in c.execute("SELECT lock_id FROM paimon_distributed_locks")]

            faults[pkg].arm_crash_point("commit:manifests-written", count=0, action=lambda: seen.append(rows()))
            try:
                _write(t, [1, 2], [1.0, 2.0])
            finally:
                faults[pkg].disarm_crash_points()
            held = [[lock_id.replace(f"/{pkg}/", "/<pkg>/") for lock_id in r] for r in seen]
            out[pkg] = (type(lock).__name__, lock.lock_id == path, lock.db_path, held, rows(), _read(t))
        assert out["port"] == out["jax"]
        assert out["port"][:5] == ("JdbcCatalogLock", True, db, [[f"{scheme}://{tmp_path}/<pkg>/{scheme}/db.db/l"]], [])
        errors = [_lock_of(pkg, f"{scheme}://{tmp_path}/{pkg}/{scheme}-nopath", {"commit.catalog-lock.type": "jdbc"})
                  for pkg in ("jax", "port")]
        assert errors[0] == errors[1] == ("ValueError", "commit.catalog-lock.type=jdbc needs commit.catalog-lock.jdbc-path")


def test_commits_on_the_store_hold_the_lock_file(tmp_path):
    """Each commit round runs under the lock: the lock file exists while the
    snapshot is published and is gone after."""
    warehouse = f"s3://{tmp_path}/wh"
    t = _catalog("port", warehouse).create_table("db.t", _schema("port"), primary_keys=["k"], options={"bucket": "1"})
    seen = []
    lock_path = f"{tmp_path}/wh/db.db/t/.catalog-lock"
    pfaults.arm_crash_point("commit:manifests-written", count=0, action=lambda: seen.append(os.path.exists(lock_path)))
    _write(t, [1, 2], [1.0, 2.0])
    _write(t, [2], [3.0])
    pfaults.disarm_crash_points()
    assert seen == [True, True] and not os.path.exists(lock_path)
    assert isinstance(t.store.new_commit()._lock, FileBasedCatalogLock)
    assert _read(t) == [(1, 1.0, "s1"), (2, 3.0, "s2")]


def test_a_held_lock_times_out(tmp_path):
    fio = pfs.get_file_io("s3://x")
    base = f"s3://{tmp_path}/tbl"
    first = FileBasedCatalogLock(fio, base, timeout=5.0, stale_ttl=300.0)
    second = FileBasedCatalogLock(fio, base, timeout=0.2, stale_ttl=300.0)
    with first.lock():
        with pytest.raises(TimeoutError, match="could not acquire catalog lock"):
            with second.lock():
                pass
    with second.lock():
        assert fio.read_bytes(f"{base}/.catalog-lock").split()[0].decode() == second.holder
    assert not fio.exists(f"{base}/.catalog-lock")


def test_a_stale_lock_is_taken_over_by_one_waiter_at_a_time(tmp_path):
    fio = pfs.get_file_io("s3://x")
    base = f"s3://{tmp_path}/tbl"
    fio.mkdirs(base)
    fio.write_bytes(f"{base}/.catalog-lock", f"deadbeef {time.time() - 999}".encode())  # a crashed holder's
    active, overlaps = [], []

    def waiter(i):
        with FileBasedCatalogLock(fio, base, timeout=30.0, stale_ttl=5.0).lock():
            active.append(i)
            if len(active) > 1:
                overlaps.append(list(active))
            time.sleep(0.05)
            active.remove(i)

    threads = [threading.Thread(target=waiter, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert overlaps == []
    assert [s.path for s in fio.list_status(base) if ".sweep-" in s.path] == []
