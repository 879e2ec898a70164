"""The resilience layer of the port (paimon_tpu_torch/resilience/, the commit
and flush crash points, remove_orphan_files) against the JAX package, on
the CPU (device="cpu" for the port).

Held equal between the packages on the same inputs and seeds: is_transient
over one fixed list of exceptions; RetryPolicy.next_backoff_ms under
random.Random(seed); the crash-point spec grammar; the io{...} counters of
RetryingFileIO over one scripted fault schedule (sleep injected, so no
test waits); the crash matrix over the five commit and flush points on a
POSIX and an object-store table (snapshot chains as (id, kind,
identifier), rows, and the orphans each sweep removes per directory);
reachable_files on one on-disk table with tags, a branch and deletion
vectors; the dry-run orphan list after planted debris; the index files an
OVERWRITE leaves (ROADMAP Queue 3 item 14), reclaimed by both sweeps;
expiry whose deletes fault; CALL sys.remove_orphan_files. The port's own
recovery contract is held as the JAX package's tests hold it (torn
writes, cleanup, retries, adoption of a landed commit after a lost ack)
against an independent reachability oracle, and one port child process
is killed at a crash point armed through PAIMON_TPU_CRASH_POINT.

Tolerance: exact. Rows, ids, names, counts and counters are compared for
equality; file names are UUIDs, so files are compared by directory and
count across the packages and by path within one.
"""

import errno
import io
import json
import os
import random
import subprocess
import sys
import textwrap

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import paimon_tpu.core.manifest as jmanifest
import paimon_tpu.core.schema as jschema
import paimon_tpu.core.store as jstore
import paimon_tpu.data as jdata
import paimon_tpu.data.predicate as jpredicate
import paimon_tpu.fs as jfs
import paimon_tpu.fs.testing as jtesting
import paimon_tpu.metrics as jmetrics
import paimon_tpu.resilience as jres
import paimon_tpu.resilience.faults as jfaults
import paimon_tpu.resilience.orphan as jorphan
import paimon_tpu.table.branch as jbranch
import paimon_tpu.types as jtypes
import paimon_tpu_torch.core.manifest as pmanifest
import paimon_tpu_torch.core.schema as pschema
import paimon_tpu_torch.core.store as pstore
import paimon_tpu_torch.data.batch as pbatch
import paimon_tpu_torch.data.predicate as ppredicate
import paimon_tpu_torch.fs as pfs
import paimon_tpu_torch.fs.testing as ptesting
import paimon_tpu_torch.metrics as pmetrics
import paimon_tpu_torch.resilience as pres
import paimon_tpu_torch.resilience.faults as pfaults
import paimon_tpu_torch.resilience.orphan as porphan
import paimon_tpu_torch.table.branch as pbranch
import paimon_tpu_torch.types as ptypes
from paimon_tpu.core.commit import BATCH_COMMIT_IDENTIFIER as JAX_BATCH_ID
from paimon_tpu_torch.core.commit import BATCH_COMMIT_IDENTIFIER, CommitConflictError, CommitGiveUpError
from paimon_tpu_torch.core.snapshot import CommitKind

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("jax", "port")
CRASH_POINTS = pfaults.COMMIT_CRASH_POINTS + pfaults.WRITER_CRASH_POINTS
# the port's table merges through its kernels' plain versions; the JAX
# package's through its host oracle (the merge itself is not under test)
ENGINE = {"jax": {"sort-engine": "numpy"}, "port": {}}


class Pkg:
    """One package's modules under common names."""

    def __init__(self, name):
        self.name = name
        jax = name == "jax"
        self.fs = jfs if jax else pfs
        self.testing = jtesting if jax else ptesting
        self.metrics = jmetrics if jax else pmetrics
        self.res = jres if jax else pres
        self.faults = jfaults if jax else pfaults
        self.orphan = jorphan if jax else porphan
        self.manifest = jmanifest if jax else pmanifest
        self.types = jtypes if jax else ptypes
        self.schema_manager = (jschema if jax else pschema).SchemaManager
        self.batch = jdata.ColumnBatch if jax else pbatch.ColumnBatch
        self.predicate = jpredicate if jax else ppredicate
        self.branch = jbranch if jax else pbranch

    def io_counters(self) -> dict:
        return self.metrics.registry.snapshot().get("io", {})

    def make_store(self, path, options, user="res"):
        io_ = self.fs.get_file_io(path)
        row_type = self.types.RowType.of(("k", self.types.BIGINT()), ("v", self.types.DOUBLE()))
        ts = self.schema_manager(io_, path).create_table(
            row_type, primary_keys=["k"], options={"bucket": "1", **ENGINE[self.name], **options}
        )
        return self.store(io_, path, ts, user)

    def store(self, io_, path, ts, user):
        if self.name == "jax":
            return jstore.KeyValueFileStore(io_, path, ts, commit_user=user)
        return pstore.KeyValueFileStore(io_, path, ts, commit_user=user, device="cpu")

    def open_store(self, store, user):
        ts = self.schema_manager(store.file_io, store.table_path).latest()
        return self.store(store.file_io, store.table_path, ts, user)

    def table(self, store):
        if self.name == "jax":
            from paimon_tpu.table import FileStoreTable

            return FileStoreTable(store.file_io, store.table_path, store.schema, store.commit_user)
        from paimon_tpu_torch.table import FileStoreTable

        return FileStoreTable(store.file_io, store.table_path, store.schema, store.commit_user, device="cpu")


P = {name: Pkg(name) for name in PKGS}
PORT = P["port"]


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


@pytest.fixture(autouse=True)
def _disarm():
    yield
    jfaults.disarm_crash_points()
    pfaults.disarm_crash_points()


# ---------------------------------------------------------------- helpers
def writer_batch(pkg, store, data: dict):
    return pkg.batch.from_pydict(store.value_schema, {"k": list(data), "v": [float(v) for v in data.values()]})


def prepare(pkg, store, data: dict, bucket=0, compact_full=False):
    w = store.new_writer((), bucket)
    try:
        w.write(writer_batch(pkg, store, data))
        if compact_full:
            w.compact(full=True)
        return w.prepare_commit()
    finally:
        if hasattr(w, "close"):
            w.close()


def write_commit(pkg, store, ident, data: dict, bucket=0, compact_full=False):
    msg = prepare(pkg, store, data, bucket, compact_full)
    return store.new_commit().commit(pkg.manifest.ManifestCommittable(ident, messages=[msg]))


def read_kv(store, buckets=(0,)) -> dict:
    out = {}
    for b in buckets:
        batch = store.read_bucket((), b, store.restore_files((), b))
        out.update({r[0]: r[1] for r in batch.to_pylist()})
    return out


def chain(store) -> list:
    return [(s.id, s.commit_kind.value, s.commit_identifier) for s in store.snapshot_manager.snapshots()]


def file_set(root) -> set:
    return {os.path.join(d, f) for d, _, files in os.walk(root) for f in files}


def reachable_closure(root) -> set:
    """Independent reachability oracle: snapshot, changelog and tag JSON
    parsed directly and walked list -> manifest -> data and index files
    for the main root and every branch. What it names, plus the table
    metadata (schemas, consumers, snapshot and changelog roots, hints,
    branch markers), is the on-disk set after a clean sweep."""
    from paimon_tpu_torch.core.indexmanifest import read_index_manifest

    local = pfs.LocalFileIO()
    expected = set()

    def add_dir(d):
        expected.update(st.path for st in local.list_files(d))

    roots = [root] + [st.path for st in local.list_status(f"{root}/branch") if st.is_dir]
    for r in roots:
        add_dir(f"{r}/schema")
        add_dir(f"{r}/consumer")
        if r != root:
            add_dir(r)
        snaps = []
        for d, prefix in ((f"{r}/snapshot", "snapshot-"), (f"{r}/changelog", "changelog-")):
            for st in local.list_files(d):
                base = st.path.rsplit("/", 1)[-1]
                if base.startswith(prefix):
                    expected.add(st.path)
                    snaps.append(json.loads(local.read_bytes(st.path)))
                elif base in ("LATEST", "EARLIEST"):
                    expected.add(st.path)
        for st in local.list_files(f"{r}/tag"):
            expected.add(st.path)
            snaps.append(json.loads(local.read_bytes(st.path)))
        ml = pmanifest.ManifestList(local, f"{r}/manifest")
        mf = pmanifest.ManifestFile(local, f"{r}/manifest")
        for s in snaps:
            for lst in (s["baseManifestList"], s["deltaManifestList"], s.get("changelogManifestList")):
                if not lst:
                    continue
                expected.add(f"{r}/manifest/{lst}")
                for meta in ml.read(lst):
                    expected.add(f"{r}/manifest/{meta.file_name}")
                    for e in mf.read(meta.file_name):
                        expected.add(f"{root}/bucket-{e.bucket}/{e.file.file_name}")
                        expected.update(f"{root}/bucket-{e.bucket}/{x}" for x in e.file.extra_files)
            im = s.get("indexManifest")
            if im:
                expected.add(f"{r}/manifest/{im}")
                expected.update(f"{r}/index/{ie.file_name}" for ie in read_index_manifest(local, r, im))
    return expected


def local_of(path: str) -> str:
    """The local directory behind a scheme path: fail://<domain>/x or
    s3:///x -> /x."""
    if "://" not in path:
        return path
    scheme, rest = pfs.split_scheme(path)
    if scheme.startswith("fail") or scheme == "chaos":
        return "/" + rest.lstrip("/").partition("/")[2]
    return rest


def sweep(pkg, store, dry_run=False):
    return pkg.orphan.remove_orphan_files(pkg.table(store), older_than_millis=-3600_000, dry_run=dry_run)


def assert_clean_matches_closure(pkg, store):
    removed = sweep(pkg, store)
    root = local_of(store.table_path)
    assert file_set(root) == reachable_closure(root), f"removed={removed}"
    return removed


def by_dir(root: str, removed: list) -> dict:
    """Removed paths counted by their directory under the table root."""
    out: dict = {}
    for p in removed:
        d = local_of(p).rsplit("/", 1)[0]
        key = os.path.relpath(d, root)
        out[key] = out.get(key, 0) + 1
    return out


def port_store(tmp_path, domain, options=None, scheme="fail", user="res"):
    PORT.testing.FailingFileIO.reset(domain, 0, 0)
    return PORT.make_store(f"{scheme}://{domain}{tmp_path}/table", options or {}, user)


# ---------------------------------------------------------- retry policy
TRANSIENCE_CASES = {
    "artificial": lambda t: t.ArtificialException("blip"),
    "connection_reset": lambda t: ConnectionResetError(),
    "timeout": lambda t: TimeoutError(),
    "broken_pipe": lambda t: BrokenPipeError(),
    "eio": lambda t: OSError(errno.EIO, "io blip"),
    "etimedout": lambda t: OSError(errno.ETIMEDOUT, "store timed out"),
    "eagain": lambda t: OSError(errno.EAGAIN, "throttled"),
    "estale": lambda t: OSError(errno.ESTALE, "stale handle"),
    "no_errno": lambda t: OSError("manifest x unexpectedly already exists"),
    "not_found": lambda t: FileNotFoundError(),
    "exists": lambda t: FileExistsError(),
    "permission": lambda t: PermissionError(),
    "is_a_dir": lambda t: IsADirectoryError(),
    "value": lambda t: ValueError("bad arg"),
    "enospc": lambda t: OSError(errno.ENOSPC, "disk full"),
    "enoent": lambda t: OSError(errno.ENOENT, "gone"),
    "runtime": lambda t: RuntimeError("bug"),
    "marker_false": lambda t: _marked(OSError(errno.EIO, "looks transient"), False),
    "marker_true": lambda t: _marked(ValueError("store says retry"), True),
}


def _marked(exc, transient):
    exc.transient = transient
    return exc


@pytest.mark.parametrize("case", list(TRANSIENCE_CASES))
def test_is_transient_matches_the_jax_package(case):
    make = TRANSIENCE_CASES[case]
    assert pres.is_transient(make(ptesting)) == jres.is_transient(make(jtesting))


def test_deadline_errors_are_permanent_in_both():
    assert not pres.is_transient(pres.IODeadlineExceeded("deadline"))
    assert not jres.is_transient(jres.IODeadlineExceeded("deadline"))
    assert pres.is_transient(ptesting.ArtificialException("x")) and jres.is_transient(jtesting.ArtificialException("x"))


@pytest.mark.parametrize("seed", [0, 7, 2026])
def test_backoff_sequence_matches_the_jax_package(seed):
    def sequence(res):
        p = res.RetryPolicy(max_attempts=10, initial_backoff_ms=10, max_backoff_ms=200, rng=random.Random(seed))
        out, prev = [], None
        for _ in range(40):
            prev = p.next_backoff_ms(prev)
            out.append(prev)
        return out

    port, jax = sequence(pres), sequence(jres)
    assert port == jax
    assert all(10 <= b <= 200 for b in port)


@pytest.mark.parametrize(
    "spec",
    ["commit:manifests-written", "commit:manifests-written:2", "commit:manifests-written:2:kill",
     "flush:files-written:kill", "flush:before-dispatch:1", "  commit:snapshot-committed:3  ", "plain"],
)
def test_crash_point_spec_grammar_matches(spec):
    assert pfaults._parse_spec(spec) == jfaults._parse_spec(spec)


def test_arm_from_env_arms_each_point_of_the_spec():
    armed = pfaults.arm_from_env("commit:before-manifests:2,flush:files-written:kill,")
    assert armed == jfaults.arm_from_env("commit:before-manifests:2,flush:files-written:kill,")
    assert armed == ["commit:before-manifests", "flush:files-written"]
    pfaults.crash_point("commit:before-manifests")  # the first hit passes
    with pytest.raises(pfaults.CrashError):
        pfaults.crash_point("commit:before-manifests")
    pfaults.crash_point("commit:before-manifests")  # fired once, then passes
    assert pfaults.arm_from_env("") == []


def test_every_crash_point_name_is_the_jax_packages():
    assert pfaults.ALL_CRASH_POINTS == jfaults.ALL_CRASH_POINTS
    assert pfaults.KILL_EXIT_CODE == 137 and pfaults.ENV_VAR == jfaults.ENV_VAR == "PAIMON_TPU_CRASH_POINT"
    assert not issubclass(pfaults.CrashError, Exception)


def test_crash_point_action_runs_and_lets_the_operation_go_on():
    seen = []
    pfaults.arm_crash_point("commit:before-manifests", skip=1, count=2, action=lambda: seen.append(1))
    for _ in range(4):
        pfaults.crash_point("commit:before-manifests")
    assert seen == [1, 1]
    pfaults.disarm_crash_points("commit:before-manifests")
    pfaults.crash_point("commit:before-manifests")


IO_SCHEDULES = {
    "absorbed": [("read", None, 1, 2)],
    "giveup": [("read", None, 1, 0)],
    "write_then_read": [("write", "/data/", 2, 1), ("read", "/data/b", 1, 1)],
    "atomic": [("rename", "/snap", 1, 1)],
}


def _io_run(pkg, tmp_path, schedule_name):
    """One op sequence over RetryingFileIO(fail://) under a scripted
    schedule; returns each op's outcome and the io{...} counters."""
    domain = f"res_io_{schedule_name}_{pkg.name}"
    pkg.testing.FailingFileIO.schedule(
        domain, *[pkg.testing.FaultRule(op=o, path=p, nth=n, count=c) for o, p, n, c in IO_SCHEDULES[schedule_name]]
    )
    pkg.metrics.registry.reset()
    sleeps = []
    policy = pkg.res.RetryPolicy(max_attempts=3, initial_backoff_ms=5, max_backoff_ms=50, rng=random.Random(11),
                                 sleep=sleeps.append)
    fio = pkg.res.RetryingFileIO(pkg.fs.get_file_io(f"fail://{domain}/x"), policy)
    base = f"fail://{domain}{tmp_path}/{pkg.name}"
    outcomes = []
    for op in (
        lambda: fio.write_bytes(f"{base}/data/a", b"1"),
        lambda: fio.write_bytes(f"{base}/data/b", b"2"),
        lambda: fio.read_bytes(f"{base}/data/b"),
        lambda: fio.try_atomic_write(f"{base}/snap/s-1", b"s"),
        lambda: fio.try_atomic_write(f"{base}/snap/s-1", b"t"),
        lambda: fio.read_bytes(f"{base}/data/a"),
    ):
        try:
            outcomes.append(repr(op()))
        except Exception as exc:  # noqa: BLE001 - the outcome is compared
            outcomes.append(type(exc).__name__)
    counters = pkg.io_counters()
    return outcomes, counters, sleeps


@pytest.mark.parametrize("schedule", list(IO_SCHEDULES))
def test_io_counters_match_under_one_schedule(tmp_path, schedule):
    port = _io_run(PORT, tmp_path, schedule)
    jax = _io_run(P["jax"], tmp_path, schedule)
    assert port == jax
    if schedule == "absorbed":
        assert port[1]["retries"] == 2 and "giveups" not in port[1]
    if schedule == "giveup":
        assert port[1]["giveups"] >= 1


def test_io_deadline_exceeded(tmp_path):
    domain = "res_deadline"
    ptesting.FailingFileIO.schedule(domain, ptesting.FaultRule(op="read", count=0))
    pmetrics.registry.reset()
    fio = pres.RetryingFileIO(
        pfs.get_file_io(f"fail://{domain}/x"),
        pres.RetryPolicy(max_attempts=1000, initial_backoff_ms=5, max_backoff_ms=10, timeout_ms=30),
    )
    p = f"fail://{domain}{tmp_path}/f"
    fio.write_bytes(p, b"x")
    with pytest.raises(pres.IODeadlineExceeded):
        fio.read_bytes(p)
    assert pmetrics.io_metrics().counter("timeouts").count == 1


def test_permanent_error_is_not_retried(tmp_path):
    pmetrics.registry.reset()
    fio = pres.RetryingFileIO(pfs.LocalFileIO(), pres.RetryPolicy(max_attempts=5, initial_backoff_ms=0.1))
    with pytest.raises(FileNotFoundError):
        fio.read_bytes(f"{tmp_path}/does-not-exist")
    assert pmetrics.io_metrics().counter("retries").count == 0


def test_wrap_is_off_at_one_attempt_and_never_doubles():
    from paimon_tpu_torch.options import CoreOptions

    inner = pfs.LocalFileIO()
    assert pres.wrap_file_io(inner, CoreOptions({"fs.retry.max-attempts": "1"})) is inner
    assert pres.wrap_file_io(inner, None) is inner
    wrapped = pres.wrap_file_io(inner, CoreOptions({}))
    assert isinstance(wrapped, pres.RetryingFileIO) and wrapped.policy.max_attempts == 3
    assert pres.wrap_file_io(wrapped, CoreOptions({})) is wrapped
    assert wrapped.local_path("/a/b") == "/a/b"
    timed = pres.wrap_file_io(inner, CoreOptions({"fs.retry.max-attempts": "1", "fs.io.timeout": "5 s"}))
    assert isinstance(timed, pres.RetryingFileIO) and timed.policy.timeout_ms == 5000.0


def test_store_wraps_its_file_io_by_default(tmp_path):
    store = port_store(tmp_path, "res_wrap")
    assert isinstance(store.file_io, pres.RetryingFileIO)
    off = port_store(tmp_path / "off", "res_wrap_off", {"fs.retry.max-attempts": "1"})
    assert isinstance(off.file_io, ptesting.FailingFileIO)


# ----------------------------------------------------- torn atomic writes
def test_torn_write_leaves_tmp_and_the_sweep_reclaims_it(tmp_path):
    domain = "res_torn"
    store = port_store(tmp_path, domain, {"fs.retry.max-attempts": "1"})
    write_commit(PORT, store, 1, {1: 1.0, 2: 2.0})
    ptesting.FailingFileIO.schedule(domain, ptesting.FaultRule(op="rename", path="/snapshot/"))
    with pytest.raises(ptesting.ArtificialException):
        write_commit(PORT, store, 2, {3: 3.0})
    ptesting.FailingFileIO.reset(domain, 0, 0)
    root = f"{tmp_path}/table"
    torn = [f for f in file_set(f"{root}/snapshot") if f.rsplit("/", 1)[-1].startswith(".snapshot-2")]
    assert len(torn) == 1 and torn[0].endswith(".tmp")
    assert store.snapshot_manager.latest_snapshot_id() == 1
    assert read_kv(store) == {1: 1.0, 2: 2.0}
    removed = assert_clean_matches_closure(PORT, store)
    assert any(p.endswith(".tmp") for p in removed)
    write_commit(PORT, store, 2, {3: 3.0})
    assert read_kv(store) == {1: 1.0, 2: 2.0, 3: 3.0}


def test_an_aborted_commit_cleans_its_manifests_and_their_tmp_siblings(tmp_path):
    domain = "res_mtmp"
    store = port_store(tmp_path, domain, {"fs.retry.max-attempts": "1"})
    write_commit(PORT, store, 1, {1: 1.0})
    ptesting.FailingFileIO.schedule(domain, ptesting.FaultRule(op="rename", path="/manifest/manifest-"))
    with pytest.raises(ptesting.ArtificialException):
        write_commit(PORT, store, 2, {2: 2.0})
    ptesting.FailingFileIO.reset(domain, 0, 0)
    root = f"{tmp_path}/table"
    assert [f for f in file_set(f"{root}/manifest") if ".tmp" in f] == []
    assert_clean_matches_closure(PORT, store)
    assert read_kv(store) == {1: 1.0}


def test_cleanup_failures_are_not_fatal(tmp_path):
    domain = "res_cfail"
    store = port_store(tmp_path, domain, {"fs.retry.max-attempts": "1"})
    write_commit(PORT, store, 1, {1: 1.0})
    pmetrics.registry.reset()
    ptesting.FailingFileIO.schedule(
        domain,
        ptesting.FaultRule(op="rename", path="/manifest/manifest-"),
        ptesting.FaultRule(op="delete", path="/manifest/", count=0),
    )
    with pytest.raises(ptesting.ArtificialException):  # the first error wins
        write_commit(PORT, store, 2, {2: 2.0})
    ptesting.FailingFileIO.reset(domain, 0, 0)
    assert pmetrics.io_metrics().counter("cleanup_failures").count > 0
    assert_clean_matches_closure(PORT, store)
    assert read_kv(store) == {1: 1.0}


def test_cleanup_tolerates_a_missing_manifest_dir(tmp_path):
    from paimon_tpu_torch.core.commit import FileStoreCommit

    class NoDirIO(pfs.LocalFileIO):
        def list_status(self, path):
            raise FileNotFoundError(path)

    pmetrics.registry.reset()
    c = FileStoreCommit(NoDirIO(), f"{tmp_path}/t", "u", schema_id=0)
    names = ["manifest-deadbeef"]
    c._cleanup(names, sweep_torn=True)
    assert names == []
    assert pmetrics.io_metrics().counter("cleanup_failures").count == 0


# ------------------------------------------------------ the crash matrix
def crash_case(pkg, tmp_path, point, scheme):
    """Commit 1, then the upsert commit 2 with `point` armed (CrashError),
    then recovery as a restarted writer: a new writer replays the batch
    through filter_committed. Returns what both packages must agree on."""
    domain = f"res_cm_{scheme}_{point.replace(':', '_').replace('-', '')}_{pkg.name}"
    pkg.testing.FailingFileIO.reset(domain, 0, 0)
    path = f"{scheme}://{domain}{tmp_path}/{pkg.name}/table"
    store = pkg.make_store(path, {})
    write_commit(pkg, store, 1, {1: 1.0, 2: 2.0, 3: 3.0})
    upsert = {2: 20.0, 4: 4.0}
    flush_point = point.startswith("flush:")
    msg = None if flush_point else prepare(pkg, store, upsert)
    pkg.faults.arm_crash_point(point)
    with pytest.raises(pkg.faults.CrashError):
        if flush_point:
            prepare(pkg, store, upsert)
        else:
            store.new_commit().commit(pkg.manifest.ManifestCommittable(2, messages=[msg]))
    pkg.faults.disarm_crash_points()
    after_crash = chain(store)
    rows_after_crash = read_kv(store)
    # a restarted writer: a crashed commit's committable comes back from its
    # checkpoint; a crashed flush never made one, so the batch is written again
    restarted = pkg.open_store(store, "res")
    commit = restarted.new_commit()
    if flush_point:
        msg = prepare(pkg, restarted, upsert)
    remaining = commit.filter_committed([pkg.manifest.ManifestCommittable(2, messages=[msg])])
    for c in remaining:
        commit.commit(c)
    root = local_of(path)
    removed = sweep(pkg, restarted)
    return {
        "after_crash": after_crash,
        "rows_after_crash": rows_after_crash,
        "replayed": len(remaining),
        "chain": chain(restarted),
        "rows": read_kv(restarted),
        "removed_by_dir": by_dir(root, removed),
        "clean": file_set(root) == reachable_closure(root),
        "rows_after_sweep": read_kv(restarted),
    }


@pytest.mark.parametrize("scheme", ["fail", "fail-s3"])
@pytest.mark.parametrize("point", CRASH_POINTS)
def test_crash_matrix_matches_the_jax_package(tmp_path, point, scheme):
    port = crash_case(PORT, tmp_path, point, scheme)
    jax = crash_case(P["jax"], tmp_path, point, scheme)
    assert port == jax
    landed = point == "commit:snapshot-committed"
    assert port["after_crash"] == [(1, "APPEND", 1)] + ([(2, "APPEND", 2)] if landed else [])
    assert port["replayed"] == (0 if landed else 1)
    assert port["chain"] == [(1, "APPEND", 1), (2, "APPEND", 2)]
    assert port["rows"] == port["rows_after_sweep"] == {1: 1.0, 2: 20.0, 3: 3.0, 4: 4.0}
    assert port["clean"]
    # what each crash leaves: the manifests of a commit that never published
    # its snapshot, the data file of a flush that no commit names; nothing
    # elsewhere
    got = dict(port["removed_by_dir"])
    if point == "commit:manifests-written":
        assert set(got) == {"manifest"} and got["manifest"] >= 3
    else:
        assert got == ({"bucket-0": 1} if point == "flush:files-written" else {})


def test_a_crashed_commit_keeps_its_lock_free_on_the_object_store(tmp_path):
    """The lock of a commit that crashed in-process is released on the way
    out (the context manager unwinds), so the replay does not wait."""
    store = port_store(tmp_path, "res_lockfree", scheme="fail-s3")
    write_commit(PORT, store, 1, {1: 1.0})
    pfaults.arm_crash_point("commit:manifests-written")
    with pytest.raises(pfaults.CrashError):
        write_commit(PORT, store, 2, {2: 2.0})
    assert not os.path.exists(f"{tmp_path}/table/.catalog-lock")


# -------------------------------------------------- commit retries, adoption
def test_commit_retries_a_lost_cas_race(tmp_path):
    store = port_store(tmp_path, "res_race")
    write_commit(PORT, store, 1, {1: 1.0})
    rival = PORT.open_store(store, "rival")

    def rival_commits():
        write_commit(PORT, rival, 1, {100: 100.0})

    pmetrics.registry.reset()
    pfaults.arm_crash_point("commit:manifests-written", action=rival_commits, count=1)
    write_commit(PORT, store, 2, {2: 2.0})
    pfaults.disarm_crash_points()
    assert pmetrics.registry.group("commit").counter("retries").count >= 1
    assert read_kv(store) == {1: 1.0, 2: 2.0, 100: 100.0}
    assert_clean_matches_closure(PORT, store)


def test_commit_gives_up_after_max_retries(tmp_path):
    store = port_store(tmp_path, "res_giveup", {"commit.max-retries": "2", "commit.retry-backoff": "1 ms"})
    write_commit(PORT, store, 1, {1: 1.0})
    rival = PORT.open_store(store, "rival")
    state = {"n": 1, "busy": False}

    def rival_always_wins():
        if state["busy"]:
            return  # the rival's own commit passes the same point
        state["busy"] = True
        try:
            state["n"] += 1
            write_commit(PORT, rival, state["n"], {1000 + state["n"]: 0.0})
        finally:
            state["busy"] = False

    pfaults.arm_crash_point("commit:manifests-written", action=rival_always_wins, count=0)
    with pytest.raises(CommitGiveUpError):
        write_commit(PORT, store, 2, {2: 2.0})
    pfaults.disarm_crash_points()
    removed = sweep(PORT, store)
    assert removed and all("/bucket-0/" in p for p in removed)  # every round's manifests were cleaned
    assert file_set(f"{tmp_path}/table") == reachable_closure(f"{tmp_path}/table")


def test_own_commit_adopted_after_lost_rename_ack(tmp_path):
    """The commit's CAS landed (an earlier attempt of the same committable
    published it): the retry loop adopts it instead of committing twice."""
    store = port_store(tmp_path, "res_ack")
    write_commit(PORT, store, 1, {1: 1.0})
    msg = prepare(PORT, store, {2: 2.0})
    commit = store.new_commit()

    def land_our_snapshot_first():
        PORT.open_store(store, "res").new_commit().commit(pmanifest.ManifestCommittable(2, messages=[msg]))

    pfaults.arm_crash_point("commit:manifests-written", action=land_our_snapshot_first, count=1)
    ids = commit.commit(pmanifest.ManifestCommittable(2, messages=[msg]))
    pfaults.disarm_crash_points()
    assert ids == [2]
    assert store.snapshot_manager.latest_snapshot_id() == 2
    assert read_kv(store) == {1: 1.0, 2: 2.0}


def _lose_snapshot_ack_once(file_io):
    """The next snapshot CAS lands but reports False: what RetryingFileIO
    hands back when the retry of a landed write finds the path taken."""
    real = file_io.try_atomic_write
    state = {"fired": False}

    def lossy(path, data):
        ok = real(path, data)
        if ok and "/snapshot/" in path and not state["fired"]:
            state["fired"] = True
            return False
        return ok

    file_io.try_atomic_write = lossy
    return state


def test_own_bytes_adoption_keeps_the_manifests_it_references(tmp_path):
    store = port_store(tmp_path, "res_ack_own")
    write_commit(PORT, store, 1, {1: 1.0})
    state = _lose_snapshot_ack_once(store.file_io)
    try:
        ids = write_commit(PORT, store, 2, {2: 2.0})
    finally:
        del store.file_io.try_atomic_write
    assert state["fired"] and ids == [2]
    assert store.snapshot_manager.latest_snapshot_id() == 2
    assert read_kv(store) == {1: 1.0, 2: 2.0}
    assert_clean_matches_closure(PORT, store)


def test_batch_commit_adopts_its_own_landed_snapshot(tmp_path):
    assert BATCH_COMMIT_IDENTIFIER == JAX_BATCH_ID
    store = port_store(tmp_path, "res_ack_batch")
    write_commit(PORT, store, 1, {1: 1.0})
    state = _lose_snapshot_ack_once(store.file_io)
    try:
        ids = write_commit(PORT, store, BATCH_COMMIT_IDENTIFIER, {2: 2.0})
    finally:
        del store.file_io.try_atomic_write
    assert state["fired"] and ids == [2]
    assert store.snapshot_manager.latest_snapshot_id() == 2
    assert store.snapshot_manager.snapshot(2).total_record_count == 2  # the ADDs applied once
    assert read_kv(store) == {1: 1.0, 2: 2.0}
    assert_clean_matches_closure(PORT, store)


def test_a_lost_round_does_not_list_the_manifest_dir(tmp_path):
    store = port_store(tmp_path, "res_nolist", {"commit.retry-backoff": "1 ms"})
    write_commit(PORT, store, 1, {1: 1.0})
    rival = PORT.open_store(store, "rival")
    busy = {"on": False}

    def rival_wins_once():
        if busy["on"]:
            return
        busy["on"] = True
        try:
            write_commit(PORT, rival, 100, {50: 5.0})
        finally:
            busy["on"] = False

    lists = {"n": 0}
    real = store.file_io.list_status

    def counting(path):
        if path.rstrip("/").endswith("/manifest"):
            lists["n"] += 1
        return real(path)

    pfaults.arm_crash_point("commit:manifests-written", action=rival_wins_once, count=1)
    store.file_io.list_status = counting
    try:
        write_commit(PORT, store, 2, {2: 2.0})
    finally:
        del store.file_io.list_status
        pfaults.disarm_crash_points()
    assert lists["n"] == 0
    assert read_kv(store) == {1: 1.0, 2: 2.0, 50: 5.0}


def test_a_conflict_abandons_only_the_stolen_bucket(tmp_path):
    store = port_store(tmp_path, "res_replan", {"bucket": "2"})
    m0 = prepare(PORT, store, {1: 1.0, 2: 2.0}, bucket=0)
    m1 = prepare(PORT, store, {11: 11.0, 12: 12.0}, bucket=1)
    store.new_commit().commit(pmanifest.ManifestCommittable(1, messages=[m0, m1]))
    c0 = store.new_writer((), 0)
    c0.compact(full=True)
    c1 = store.new_writer((), 1)
    c1.compact(full=True)
    ours = pmanifest.ManifestCommittable(2, messages=[c0.prepare_commit(), c1.prepare_commit()])
    rival = PORT.open_store(store, "rival")
    r0 = rival.new_writer((), 0)
    r0.compact(full=True)
    rival.new_commit().commit(pmanifest.ManifestCommittable(1, messages=[r0.prepare_commit()]))
    pmetrics.registry.reset()
    assert len(store.new_commit().commit(ours)) == 1
    assert pmetrics.registry.group("commit").counter("buckets_abandoned").count == 1
    assert store.snapshot_manager.latest_snapshot().commit_kind == CommitKind.COMPACT
    oracle = {1: 1.0, 2: 2.0, 11: 11.0, 12: 12.0}
    assert read_kv(store, buckets=(0, 1)) == oracle
    assert_clean_matches_closure(PORT, store)
    # every bucket's inputs stolen: nothing left to re-plan
    write_commit(PORT, store, 3, {13: 13.0}, bucket=1)
    c1b = store.new_writer((), 1)
    c1b.compact(full=True)
    stale = pmanifest.ManifestCommittable(4, messages=[c1b.prepare_commit()])
    r1 = rival.new_writer((), 1)
    r1.compact(full=True)
    rival.new_commit().commit(pmanifest.ManifestCommittable(2, messages=[r1.prepare_commit()]))
    with pytest.raises(CommitConflictError):
        store.new_commit().commit(stale)
    assert read_kv(store, buckets=(0, 1)) == {**oracle, 13: 13.0}
    assert_clean_matches_closure(PORT, store)


@pytest.mark.parametrize("seed", [0, 1])
def test_a_transient_fault_rate_commits_every_round(tmp_path, seed):
    """write, commit, compact and expire at a 5% injected fault rate: with
    retries every commit lands, every read matches the oracle and the
    sweep restores exactly the reachable closure."""
    import numpy as np

    domain = f"res_matrix{seed}"
    store = port_store(tmp_path, domain, {
        "fs.retry.max-attempts": "5", "fs.retry.initial-backoff": "1 ms", "fs.retry.max-backoff": "20 ms",
        "commit.retry-backoff": "1 ms", "snapshot.num-retained.min": "2", "snapshot.num-retained.max": "3",
        "snapshot.time-retained": "0 ms",
    })
    rng = np.random.default_rng(seed)
    oracle = {}
    ptesting.FailingFileIO.reset(domain, max_fails=10**9, possibility=20, seed=seed)
    for round_ in range(1, 9):
        ks = rng.integers(0, 40, 12).tolist()
        vs = [float(x) for x in rng.random(12)]
        assert write_commit(PORT, store, round_, dict(zip(ks, vs)), compact_full=round_ % 3 == 0)
        oracle.update(zip(ks, vs))
        assert read_kv(store) == oracle
        store.new_expire().expire()
    faults = ptesting.FailingFileIO.fails_injected(domain)
    ptesting.FailingFileIO.reset(domain, 0, 0)
    assert faults > 0
    assert_clean_matches_closure(PORT, store)
    assert read_kv(store) == oracle


def test_without_retries_the_first_fault_aborts(tmp_path):
    domain = "res_noretry"
    store = port_store(tmp_path, domain, {"fs.retry.max-attempts": "1"})
    write_commit(PORT, store, 1, {1: 1.0})
    ptesting.FailingFileIO.schedule(domain, ptesting.FaultRule(op="write", path="/manifest/"))
    with pytest.raises(ptesting.ArtificialException):
        write_commit(PORT, store, 2, {2: 2.0})
    ptesting.FailingFileIO.reset(domain, 0, 0)
    assert store.snapshot_manager.latest_snapshot_id() == 1


# --------------------------------------------------- expiry and the sweep
EXPIRE_OPTIONS = {"fs.retry.max-attempts": "1", "snapshot.num-retained.min": "1", "snapshot.num-retained.max": "1",
                  "snapshot.time-retained": "0 ms"}


def expire_case(pkg, tmp_path):
    domain = f"res_expfail_{pkg.name}"
    pkg.testing.FailingFileIO.reset(domain, 0, 0)
    store = pkg.make_store(f"fail://{domain}{tmp_path}/{pkg.name}/table", EXPIRE_OPTIONS)
    for i in range(1, 4):
        write_commit(pkg, store, i, {i: float(i)})
    write_commit(pkg, store, 4, {4: 4.0}, compact_full=True)
    pkg.metrics.registry.reset()
    pkg.testing.FailingFileIO.schedule(domain, pkg.testing.FaultRule(op="delete", path="/manifest/", count=0))
    expired = store.new_expire().expire()
    failures = pkg.metrics.io_metrics().counter("cleanup_failures").count
    pkg.testing.FailingFileIO.reset(domain, 0, 0)
    rows = read_kv(store)
    removed = sweep(pkg, store)
    root = local_of(store.table_path)
    return {"expired": expired, "failed": failures > 0, "rows": rows, "removed": by_dir(root, removed),
            "clean": file_set(root) == reachable_closure(root), "rows_after": read_kv(store)}


def test_expiry_whose_deletes_fault_goes_on_and_counts(tmp_path):
    port = expire_case(PORT, tmp_path)
    assert port == expire_case(P["jax"], tmp_path)
    assert port["expired"] == 4 and port["failed"] and port["clean"]
    assert port["rows"] == port["rows_after"] == {1: 1.0, 2: 2.0, 3: 3.0, 4: 4.0}


def history_table(pkg, warehouse):
    """A table with deletion vectors, a tag and a branch whose data only
    the branch references, through the package's catalog."""
    if pkg.name == "jax":
        from paimon_tpu.catalog import FileSystemCatalog

        cat = FileSystemCatalog(warehouse, commit_user="res")
    else:
        from paimon_tpu_torch.catalog import FileSystemCatalog

        cat = FileSystemCatalog(warehouse, commit_user="res", device="cpu")
    row_type = pkg.types.RowType.of(("k", pkg.types.BIGINT()), ("v", pkg.types.DOUBLE()))
    t = cat.create_table("db.hist", row_type, primary_keys=["k"],
                         options={"bucket": "1", "deletion-vectors.enabled": "true", **ENGINE[pkg.name]})
    for r in range(3):
        wb = t.new_batch_write_builder()
        w = wb.new_write()
        w.write({"k": list(range(r * 4, r * 4 + 6)), "v": [float(r)] * 6})
        wb.new_commit().commit(w.prepare_commit())
    assert t.delete_where(pkg.predicate.less_than("k", 3)) > 0
    t.create_tag("keep", snapshot_id=2)
    pkg.branch.BranchManager(t.file_io, t.path).create("dev")
    bt = pkg.branch.branch_table(t, "dev")
    wb = bt.new_batch_write_builder()
    w = wb.new_write()
    w.write({"k": [100, 101], "v": [1.0, 2.0]})
    wb.new_commit().commit(w.prepare_commit())
    return cat, t


def _port_table_at(path):
    from paimon_tpu_torch.table import load_table

    return load_table(path, commit_user="res", device="cpu")


def _jax_table_at(path):
    from paimon_tpu.table import load_table

    return load_table(path, commit_user="res")


@pytest.mark.parametrize("writer", PKGS)
def test_reachable_files_match_on_one_table(tmp_path, writer):
    _, t = history_table(P[writer], str(tmp_path))
    port = porphan.reachable_files(_port_table_at(t.path))
    jax = jorphan.reachable_files(_jax_table_at(t.path))
    assert port == jax
    assert any(port["index"].values()), "no deletion-vector file in the closure"
    assert len(port["meta"]) == 2  # main and the branch


@pytest.mark.parametrize("writer", PKGS)
def test_dry_run_lists_match_after_planted_debris(tmp_path, writer):
    _, t = history_table(P[writer], str(tmp_path))
    local = pfs.LocalFileIO()
    debris = [f"{t.path}/bucket-0/data-orphan.parquet", f"{t.path}/manifest/manifest-orphan",
              f"{t.path}/snapshot/.snapshot-9.deadbeef.tmp", f"{t.path}/index/index-orphan",
              f"{t.path}/branch/branch-dev/manifest/manifest-list-orphan", f"{t.path}/bucket-7/data-lost.parquet"]
    for p in debris:
        local.write_bytes(p, b"junk")
    before = file_set(t.path)
    port = porphan.remove_orphan_files(_port_table_at(t.path), older_than_millis=-3600_000, dry_run=True)
    jax = jorphan.remove_orphan_files(_jax_table_at(t.path), older_than_millis=-3600_000, dry_run=True)
    assert sorted(port) == sorted(jax) == sorted(debris)
    assert file_set(t.path) == before
    # the young files survive the default threshold
    assert porphan.remove_orphan_files(_port_table_at(t.path)) == []
    removed = _port_table_at(t.path).remove_orphan_files(older_than_millis=-3600_000)
    assert sorted(removed) == sorted(debris)
    assert file_set(t.path) == reachable_closure(t.path)
    rb = _port_table_at(t.path).new_read_builder()
    assert sorted(rb.new_read().read_all(rb.new_scan().plan()).to_pylist()) == [
        (k, float(k // 4 if k < 8 else 2)) for k in range(3, 14)]


def overwrite_case(pkg, warehouse):
    """The index files an OVERWRITE leaves (ROADMAP Queue 3 item 14): a DV
    table deletes rows, is overwritten, deletes again (a new container for
    the bucket), and expires the older snapshots; the first container is
    then unreachable, and only the sweep deletes it."""
    cat, t = history_table(pkg, warehouse)
    t = t.copy({"snapshot.num-retained.min": "1", "snapshot.num-retained.max": "1"})
    t.delete_tag("keep")
    wb = t.new_batch_write_builder().with_overwrite()
    w = wb.new_write()
    w.write({"k": [1, 2, 3, 4], "v": [9.0] * 4})
    wb.new_commit().commit(w.prepare_commit())
    assert t.delete_where(pkg.predicate.equal("k", 2)) == 1
    t.expire_snapshots()
    index_before = sorted(os.listdir(f"{t.path}/index"))
    removed = t.remove_orphan_files(older_than_millis=-3600_000)
    rb = t.new_read_builder()
    rows = sorted(rb.new_read().read_all(rb.new_scan().plan()).to_pylist())
    return {"index_files_before": len(index_before), "removed": by_dir(t.path, removed), "rows": rows,
            "clean": file_set(t.path) == reachable_closure(t.path)}


def test_overwrite_index_files_are_reclaimed_by_both(tmp_path):
    port = overwrite_case(PORT, str(tmp_path / "port"))
    jax = overwrite_case(P["jax"], str(tmp_path / "jax"))
    assert port == jax
    assert port["removed"].get("index", 0) > 0 and port["clean"]
    assert port["rows"] == [(1, 9.0), (3, 9.0), (4, 9.0)]


def test_call_remove_orphan_files_returns_the_jax_shape(tmp_path):
    from paimon_tpu.sql import call as jax_call
    from paimon_tpu_torch.sql import call as port_call

    out = {}
    for name in PKGS:
        cat, t = history_table(P[name], str(tmp_path / name))
        pfs.LocalFileIO().write_bytes(f"{t.path}/manifest/manifest-orphan", b"junk")
        call = port_call if name == "port" else jax_call
        young = call(cat, "CALL sys.remove_orphan_files('db.hist')")
        dry = call(cat, "CALL sys.remove_orphan_files(`table` => 'db.hist', older_than_hours => -1, dry_run => true)")
        done = call(cat, "CALL sys.remove_orphan_files('db.hist', -1)")
        out[name] = [(sorted(r), [os.path.relpath(p, t.path) for p in r["orphans"]], r["dry_run"])
                     for r in (young, dry, done)]
    assert out["port"] == out["jax"]
    assert out["port"][1][1] == ["manifest/manifest-orphan"] and out["port"][2][1] == ["manifest/manifest-orphan"]


# --------------------------------------------------- a killed child process
CHILD = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    import paimon_tpu_torch as pt
    from paimon_tpu_torch.catalog import FileSystemCatalog

    cat = FileSystemCatalog({warehouse!r}, commit_user="child", device="cpu")
    t = cat.create_table("db.t", pt.RowType.of(("k", pt.BIGINT()), ("v", pt.DOUBLE())),
                         primary_keys=["k"], options={{"bucket": "1"}})
    for r in range(3):
        wb = t.new_batch_write_builder()
        w = wb.new_write()
        w.write({{"k": [r, r + 10], "v": [float(r), float(r)]}})
        wb.new_commit().commit(w.prepare_commit())
        print("committed", r + 1, flush=True)
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "paimon_tpu", "pyarrow"))
    print("forbidden", bad, flush=True)
""")


def test_a_child_killed_at_a_crash_point_leaves_what_the_sweep_reclaims(tmp_path):
    warehouse = str(tmp_path / "w")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["PAIMON_TPU_CRASH_POINT"] = "commit:manifests-written:2:kill"
    out = subprocess.run([sys.executable, "-c", CHILD.format(repo=REPO, warehouse=warehouse)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == pfaults.KILL_EXIT_CODE, out.stdout + out.stderr
    assert out.stdout.split() == ["committed", "1"]
    from paimon_tpu_torch.catalog import FileSystemCatalog

    t = FileSystemCatalog(warehouse, commit_user="parent", device="cpu").get_table("db.t")
    rb = t.new_read_builder()
    assert sorted(rb.new_read().read_all(rb.new_scan().plan()).to_pylist()) == [(0, 0.0), (10, 0.0)]
    assert [s.id for s in t.store.snapshot_manager.snapshots()] == [1]
    removed = t.remove_orphan_files(older_than_millis=-3600_000)
    counts = by_dir(t.path, removed)
    assert counts.pop("bucket-0") == 1 and counts.pop("manifest") >= 3 and counts == {}
    assert file_set(t.path) == reachable_closure(t.path)


def test_an_unset_crash_point_variable_arms_nothing_in_a_child(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA", "PAIMON_TPU_CRASH"))}
    code = f"import sys; sys.path.insert(0, {REPO!r}); import paimon_tpu_torch.resilience.faults as f; print(f._armed)"
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "{}", out.stderr
