"""The port's filesystem layer (paimon_tpu_torch/fs/__init__.py and
fs/testing.py) against the JAX package's, on the CPU.

Held equal on the same inputs: split_scheme; the scheme registry (which
FileIO class each scheme gives, with its capability flags, and the error
for an unknown scheme); LocalFileIO's primitives over one op sequence (the
outcome of every op and the files left); FailingFileIO under scripted
FaultRule schedules (which ops fail, and the torn `.tmp` sibling a
rename-phase fault leaves); the chaos spec. Also held: a schemeless path
passes the fault domain by (FailingFileIO._strip), listings keep the
scheme and domain, LatencyFileIO and TraceableFileIO pass capability
flags and streams through.

Tolerance: exact.
"""

import io
import os

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import paimon_tpu.fs as jfs
import paimon_tpu.fs.testing as jtesting
import paimon_tpu_torch.fs as pfs
import paimon_tpu_torch.fs.testing as ptesting

PKGS = {"jax": (jfs, jtesting), "port": (pfs, ptesting)}


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


@pytest.mark.parametrize(
    "path",
    ["/a/b", "file:///a/b", "s3:///tmp/w", "s3://bucket/key/x", "oss:///x/y", "s3-legacy:///z",
     "fail://dom/tmp/x", "fail-s3://dom/abs/path", "chaos://d/p", "relative/path", "", "hdfs://nn:8020/w"],
)
def test_split_scheme_matches(path):
    assert pfs.split_scheme(path) == jfs.split_scheme(path)


SCHEMES = ["file", "s3", "oss", "s3-legacy", "fail", "fail-s3", "fail-s3-legacy", "latency", "chaos", "traceable"]


def _describe(fio) -> tuple:
    inner = getattr(fio, "_inner", None)
    return (type(fio).__name__, type(inner).__name__ if inner is not None else None,
            getattr(inner, "conditional_put", None), fio.atomic_write_supported, fio.exclusive_create_supported)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_registry_gives_the_same_store_per_scheme(scheme, tmp_path):
    path = str(tmp_path) if scheme == "file" else f"{scheme}://dom{tmp_path}"
    assert _describe(pfs.get_file_io(path)) == _describe(jfs.get_file_io(path))


def test_an_unknown_scheme_raises_in_both():
    for fs in (pfs, jfs):
        with pytest.raises(ValueError, match="no FileIO registered for scheme 'nope'"):
            fs.get_file_io("nope://x/y")


def test_register_file_io_adds_a_scheme():
    class Mine(pfs.LocalFileIO):
        pass

    pfs.register_file_io("mine-test", Mine)
    assert type(pfs.get_file_io("mine-test:///x")) is Mine


def _local_sequence(fs, root: str) -> list:
    """One op sequence over the package's LocalFileIO; every outcome."""
    fio = fs.LocalFileIO()
    out = []

    def run(fn):
        try:
            out.append(repr(fn()))
        except Exception as exc:  # noqa: BLE001 - the outcome is compared
            out.append(type(exc).__name__)

    run(lambda: fio.write_bytes(f"{root}/d/a", b"1"))
    run(lambda: fio.write_bytes(f"{root}/d/a", b"2"))  # exclusive create: a loser
    run(lambda: fio.write_bytes(f"{root}/d/a", b"3", overwrite=True))
    run(lambda: fio.read_bytes(f"file://{root}/d/a"))
    run(lambda: fio.try_atomic_write(f"{root}/snap/s-1", b"x"))
    run(lambda: fio.try_atomic_write(f"{root}/snap/s-1", b"y"))  # lost CAS
    run(lambda: fio.read_bytes(f"{root}/snap/s-1"))
    run(lambda: fio.try_overwrite(f"{root}/snap/LATEST", b"1"))
    run(lambda: fio.try_overwrite(f"{root}/snap/LATEST", b"2"))
    run(lambda: fio.read_text(f"{root}/snap/LATEST"))
    run(lambda: fio.rename(f"{root}/d/a", f"{root}/snap/s-1"))  # no clobber
    run(lambda: fio.rename(f"{root}/d/a", f"{root}/d/b"))
    run(lambda: fio.exists(f"{root}/d/a"))
    run(lambda: [os.path.basename(s.path) for s in fio.list_files(f"{root}/snap")])
    run(lambda: [(os.path.basename(s.path), s.is_dir) for s in fio.list_status(root)])
    run(lambda: fio.list_status(f"{root}/missing"))
    run(lambda: fio.get_status(f"{root}/d/b").size)
    run(lambda: fio.open_input(f"{root}/d/b").read())
    run(lambda: fio.local_path(f"file://{root}/d/b") == f"{root}/d/b")
    run(lambda: fio.delete(f"{root}/d"))  # not empty
    run(lambda: fio.rename(f"{root}/d", f"{root}/e"))  # a directory moves
    run(lambda: fio.delete(f"{root}/e", recursive=True))
    run(lambda: fio.delete(f"{root}/e"))
    run(lambda: fio.mkdirs(f"{root}/m/n"))
    run(lambda: fio.delete(f"{root}/m/n"))
    run(lambda: sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs_ in os.walk(root) for f in fs_))
    return out


def test_local_file_io_matches_over_one_sequence(tmp_path):
    port = _local_sequence(pfs, str(tmp_path / "port"))
    assert port == _local_sequence(jfs, str(tmp_path / "jax"))
    assert port[1] == "FileExistsError" and port[5] == "False" and port[10] == "False"


SCHEDULES = {
    "nth_write": [("write", "/data/", 2, 1)],
    "reads_forever": [("read", None, 1, 0)],
    "torn_rename": [("rename", "/snapshot/", 1, 1)],
    "write_phase_of_atomic": [("write", "/snapshot/", 1, 1)],
    "deletes": [("delete", "/data/", 1, 2)],
    "any_op_once": [("*", "/data/b", 1, 1)],
    "atomic": [("atomic", "/snapshot/", 2, 1)],
}


def _fault_sequence(pkg: str, tmp_path, schedule: str, scheme: str) -> tuple:
    fs, testing = PKGS[pkg]
    domain = f"fs_{schedule}_{scheme}_{pkg}"
    testing.FailingFileIO.schedule(domain, *[testing.FaultRule(o, p, n, c) for o, p, n, c in SCHEDULES[schedule]])
    fio = fs.get_file_io(f"{scheme}://{domain}/x")
    local = f"{tmp_path}/{pkg}"
    base = f"{scheme}://{domain}{local}"
    out = []
    for op in (
        lambda: fio.write_bytes(f"{base}/data/a", b"1"),
        lambda: fio.write_bytes(f"{base}/data/b", b"2"),
        lambda: fio.write_bytes(f"{base}/data/c", b"3"),
        lambda: fio.read_bytes(f"{base}/data/a"),
        lambda: fio.read_bytes(f"{base}/data/b"),
        lambda: fio.try_atomic_write(f"{base}/snapshot/snapshot-1", b"s1"),
        lambda: fio.try_atomic_write(f"{base}/snapshot/snapshot-1", b"s1'"),
        lambda: fio.try_atomic_write(f"{base}/snapshot/snapshot-2", b"s2"),
        lambda: fio.delete(f"{base}/data/a"),
        lambda: fio.delete(f"{base}/data/c"),
        lambda: fio.exists(f"{base}/data/a"),
        lambda: fio.rename(f"{base}/data/b", f"{base}/data/moved"),
    ):
        try:
            out.append(repr(op()))
        except Exception as exc:  # noqa: BLE001 - the outcome is compared
            out.append(type(exc).__name__)
    files = sorted(
        (os.path.relpath(d, local), "<tmp>" if f.startswith(".") and f.endswith(".tmp") else f)
        for d, _, fs_ in os.walk(local) for f in fs_
    )
    return out, files, testing.FailingFileIO.fails_injected(domain)


@pytest.mark.parametrize("scheme", ["fail", "fail-s3"])
@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_scripted_faults_fail_the_same_ops(tmp_path, schedule, scheme):
    port = _fault_sequence("port", tmp_path, schedule, scheme)
    assert port == _fault_sequence("jax", tmp_path, schedule, scheme)
    # the object store's commit primitive is one conditional PUT ('atomic'):
    # no write or rename phase to fail; a POSIX store's is write + rename
    phases = {"torn_rename": "fail", "write_phase_of_atomic": "fail", "atomic": "fail-s3"}
    assert (port[2] > 0) == (phases.get(schedule, scheme) == scheme)
    if schedule == "torn_rename":
        # the rename phase failed after the temp write: the torn sibling stays
        # on a POSIX store; the object store's conditional PUT has no rename
        torn = ("snapshot", "<tmp>") in port[1]
        assert torn == (scheme == "fail")


def test_a_schemeless_path_passes_the_fault_domain_by(tmp_path):
    """FailingFileIO._strip hands a bare path to the inner store unchecked:
    a caller that drops the scheme silently leaves the fault domain."""
    for fs, testing in PKGS.values():
        domain = f"fs_bare_{fs.__name__.replace('.', '_')}"
        testing.FailingFileIO.schedule(domain, testing.FaultRule("write", "/bare/", 1, 0))
        fio = fs.get_file_io(f"fail://{domain}/x")
        fio.write_bytes(f"{tmp_path}/{domain}/bare/x", b"1")  # no scheme: no fault
        with pytest.raises(testing.ArtificialException):
            fio.write_bytes(f"fail://{domain}{tmp_path}/{domain}/bare/y", b"1")
        assert testing.FailingFileIO.fails_injected(domain) == 1


@pytest.mark.parametrize("scheme", ["fail", "fail-s3"])
def test_listings_keep_the_scheme_and_the_domain(tmp_path, scheme):
    for name, (fs, testing) in PKGS.items():
        domain = f"fs_list_{scheme}_{name}"
        testing.FailingFileIO.reset(domain, 0, 0)
        fio = fs.get_file_io(f"{scheme}://{domain}/x")
        base = f"{scheme}://{domain}{tmp_path}/{name}"
        fio.write_bytes(f"{base}/d/f", b"1")
        fio.mkdirs(f"{base}/d/sub")
        got = [(s.path, s.is_dir) for s in fio.list_status(f"{base}/d")]
        assert got == [(f"{base}/d/f", False), (f"{base}/d/sub", True)]
        assert fio.get_status(f"{base}/d/f").path == f"{tmp_path}/{name}/d/f"  # the inner path


def test_latency_and_traceable_wrap_the_local_store(tmp_path):
    ptesting.LatencyFileIO.configure(read_ms=0.0, write_ms=0.0)
    lat = pfs.get_file_io("latency:///x")
    assert lat.local_path(str(tmp_path)) is None  # reads take the stream path
    assert lat.try_atomic_write(f"latency://{tmp_path}/s", b"1") and not lat.try_atomic_write(f"{tmp_path}/s", b"2")
    assert lat.read_bytes(f"{tmp_path}/s") == b"1"
    tr = pfs.get_file_io("traceable:///x")
    tr.write_bytes(f"{tmp_path}/t", b"abc")
    f = tr.open_input(f"traceable://{tmp_path}/t")
    with pytest.raises(AssertionError, match="leaked streams"):
        ptesting.TraceableFileIO.assert_no_leaks()
    assert f.read() == b"abc"
    f.close()
    ptesting.TraceableFileIO.assert_no_leaks()
    over_s3 = ptesting.LatencyFileIO(inner=pfs.get_file_io("s3:///x"))
    assert not over_s3.atomic_write_supported and over_s3.exclusive_create_supported


def test_chaos_spec_and_env_match(tmp_path, monkeypatch):
    spec = ptesting.chaos_spec("fs_chaos", read_ms=0.0, write_ms=0.0, possibility=3, max_fails=2, seed=5)
    assert spec == jtesting.chaos_spec("fs_chaos", read_ms=0.0, write_ms=0.0, possibility=3, max_fails=2, seed=5)
    monkeypatch.setenv(ptesting.CHAOS_ENV, spec)
    assert ptesting.CHAOS_ENV == jtesting.CHAOS_ENV == "PAIMON_TPU_CHAOS"
    ptesting.FailingFileIO._states.pop("fs_chaos", None)
    fio = pfs.get_file_io("chaos://fs_chaos/x")
    assert type(fio).__name__ == "FailingFileIO" and type(fio._inner).__name__ == "LatencyFileIO"
    st = ptesting.FailingFileIO._states["fs_chaos"]
    assert (st.max_fails, st.possibility) == (2, 3)
    fails = 0
    for i in range(12):
        try:
            fio.write_bytes(f"chaos://fs_chaos{tmp_path}/f{i}", b"1")
        except ptesting.ArtificialException:
            fails += 1
    assert fails == ptesting.FailingFileIO.fails_injected("fs_chaos") == 2  # max_fails caps them
    ptesting.apply_chaos_env()  # the domain exists: its counters stay
    assert ptesting.FailingFileIO.fails_injected("fs_chaos") == 2
    monkeypatch.delenv(ptesting.CHAOS_ENV)
    ptesting.apply_chaos_env()  # unset: nothing happens


def test_probabilistic_faults_follow_the_seed(tmp_path):
    """reset(domain, max_fails, possibility, seed) draws the same faults in
    both packages over the same op sequence."""
    out = {}
    for name, (fs, testing) in PKGS.items():
        domain = f"fs_prob_{name}"
        testing.FailingFileIO.reset(domain, max_fails=5, possibility=3, seed=9)
        fio = fs.get_file_io(f"fail://{domain}/x")
        got = []
        for i in range(20):
            try:
                fio.write_bytes(f"fail://{domain}{tmp_path}/{name}/f{i}", b"1", overwrite=True)
                got.append(True)
            except testing.ArtificialException:
                got.append(False)
        out[name] = (got, testing.FailingFileIO.fails_injected(domain))
    assert out["port"] == out["jax"] and out["port"][1] == 5
