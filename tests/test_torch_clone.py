"""Table clone in the port (paimon_tpu_torch/table/clone.py) against the
JAX package's (paimon_tpu/table/clone.py), on the CPU (device="cpu").

Held equal between the packages: pick_files on one on-disk table written
by either package (the snapshot id and the ordered list of source and
target paths, relative to the warehouse) at the latest snapshot, at a tag,
on a branch, with a changelog, with deletion vectors and statistics;
clone_table by each package of the same table into a warehouse of its own
(every copied file byte-identical to its source, the target file set and
the rows, which the other package reads too); the refusal over a table
holding another snapshot, the idempotent re-clone, the failure of a pinned
snapshot whose files expired; clone_database and clone_warehouse. The
clone under fail:// faults (each package's FailingFileIO domain reset
separately) retries from a fresh latest snapshot and lands complete. The
port's tables merge under sort-engine=pallas (the kernels' plain versions
on the CPU), the JAX package's under its numpy engine.

Tolerance: exact.
"""

import io
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import paimon_tpu.catalog as jcatalog
import paimon_tpu.fs.testing as jtesting
import paimon_tpu.table.branch as jbranch
import paimon_tpu.table.clone as jclone
import paimon_tpu.table.tags as jtags
import paimon_tpu.types as jtypes
import paimon_tpu_torch.catalog as pcatalog
import paimon_tpu_torch.fs.testing as ptesting
import paimon_tpu_torch.table.branch as pbranch
import paimon_tpu_torch.table.clone as pclone
import paimon_tpu_torch.table.tags as ptags
import paimon_tpu_torch.types as ptypes

PKGS = ("jax", "port")
ENGINE = {"jax": {"sort-engine": "numpy"}, "port": {"sort-engine": "pallas"}}
CLONE = {"jax": jclone, "port": pclone}
TAGS = {"jax": jtags, "port": ptags}
BRANCH = {"jax": jbranch, "port": pbranch}
TYPES = {"jax": jtypes, "port": ptypes}
TESTING = {"jax": jtesting, "port": ptesting}


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


@pytest.fixture(autouse=True)
def _plain_download(monkeypatch):
    monkeypatch.setenv("PAIMON_TPU_FORCE_COMPACT", "0")


def catalog(pkg, warehouse, user="setup"):
    if pkg == "jax":
        return jcatalog.FileSystemCatalog(str(warehouse), commit_user=user)
    return pcatalog.FileSystemCatalog(str(warehouse), commit_user=user, device="cpu")


def schema(pkg):
    t = TYPES[pkg]
    return t.RowType.of(("id", t.BIGINT()), ("v", t.DOUBLE()), ("s", t.STRING()))


def write(t, lo, hi, tag=None):
    wb = t.new_batch_write_builder()
    w = wb.new_write()
    ids = np.arange(lo, hi, dtype=np.int64)
    w.write({"id": ids, "v": ids * 0.5, "s": np.array([f"s{i}" for i in ids], dtype=object)})
    wb.new_commit().commit(w.prepare_commit())
    if tag:
        t.create_tag(tag)


def read(t, pkg):
    rb = t.copy(ENGINE[pkg]).new_read_builder()
    return sorted(rb.new_read().read_all(rb.new_scan().plan()).to_pylist())


def source_table(pkg, warehouse, name="db.t", options=None, runs=((0, 100, "v1"), (50, 150, None))):
    cat = catalog(pkg, warehouse)
    t = cat.create_table(name, schema(pkg), primary_keys=["id"],
                         options={"bucket": "2", **ENGINE[pkg], **(options or {})})
    for lo, hi, tag in runs:
        write(t, lo, hi, tag)
    return cat, t


def picked(pkg, table, warehouse, snapshot_id=None) -> tuple:
    snap, pairs = CLONE[pkg].pick_files(table, snapshot_id)
    return snap.id, [(os.path.relpath(src, str(warehouse)), rel) for src, rel in pairs]


def tree(root) -> dict:
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def view(pkg, t, how):
    """The table, a branch view of it, or itself pinned at a tag."""
    if how == "branch":
        BRANCH[pkg].BranchManager(t.file_io, t.path).create("b1", from_tag="v1")
        bt = BRANCH[pkg].branch_table(t, "b1")
        write(bt, 1000, 1010)
        return bt, None
    if how == "tag":
        return t, TAGS[pkg].TagManager(t.file_io, t.path).snapshot_id("v1")
    return t, None


LAYOUTS = {
    "latest": {},
    "changelog": {"changelog-producer": "input"},
    "deletion_vectors": {"deletion-vectors.enabled": "true"},
    "partitioned": None,
}


def layout_table(pkg, warehouse, layout):
    if layout == "partitioned":
        t_ = TYPES[pkg]
        cat = catalog(pkg, warehouse)
        row_type = t_.RowType.of(("dt", t_.STRING(False)), ("id", t_.BIGINT()), ("v", t_.DOUBLE()))
        t = cat.create_table("db.t", row_type, partition_keys=["dt"], primary_keys=["dt", "id"],
                             options={"bucket": "1", **ENGINE[pkg]})
        for r, dt in enumerate(("2024-01-01", "2024-01-02", "2024-01-01")):
            wb = t.new_batch_write_builder()
            w = wb.new_write()
            w.write({"dt": np.array([dt] * 5, dtype=object), "id": np.arange(5, dtype=np.int64) + r,
                     "v": np.full(5, float(r))})
            wb.new_commit().commit(w.prepare_commit())
        return cat, t
    cat, t = source_table(pkg, warehouse, options=LAYOUTS[layout])
    if layout == "deletion_vectors":
        pred = __import__(f"{'paimon_tpu' if pkg == 'jax' else 'paimon_tpu_torch'}.data.predicate",
                          fromlist=["less_than"])
        t.delete_where(pred.less_than("id", 20))
        from_stats = __import__(f"{'paimon_tpu' if pkg == 'jax' else 'paimon_tpu_torch'}.table.statistics",
                                fromlist=["analyze_table"])
        from_stats.analyze_table(t)
    return cat, t


@pytest.mark.parametrize("writer", PKGS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pick_files_equal_on_one_table(writer, layout, tmp_path):
    _, t = layout_table(writer, tmp_path, layout)
    got = {pkg: picked(pkg, catalog(pkg, tmp_path).get_table("db.t"), tmp_path) for pkg in PKGS}
    assert got["port"] == got["jax"]
    snap_id, pairs = got["port"]
    rels = [rel for _, rel in pairs]
    assert len(set(rels)) == len(rels) and all(os.path.exists(tmp_path / src) for src, _ in pairs)
    if layout == "changelog":
        assert any("changelog" in rel or rel.startswith("bucket-") for rel in rels)
    if layout == "deletion_vectors":
        assert any(rel.startswith("index/") for rel in rels) and any(rel.startswith("statistics/") for rel in rels)


@pytest.mark.parametrize("how", ["tag", "branch"])
def test_pick_files_at_a_tag_and_on_a_branch(how, tmp_path):
    _, t = source_table("jax", tmp_path)
    jt, sid = view("jax", t, how)
    pt = catalog("port", tmp_path).get_table("db.t")
    pt = pbranch.branch_table(pt, "b1") if how == "branch" else pt
    assert picked("port", pt, tmp_path, sid) == picked("jax", jt, tmp_path, sid)


@pytest.mark.parametrize("how", ["latest", "tag", "branch"])
@pytest.mark.parametrize("writer", PKGS)
def test_clone_by_each_package(how, writer, tmp_path):
    src_wh = tmp_path / "src"
    _, t = source_table(writer, src_wh)
    table, sid = view(writer, t, how)
    src_rows = read(table.copy({"scan.snapshot-id": str(sid)}) if sid else table, writer)
    out = {}
    for pkg in PKGS:
        src = catalog(pkg, src_wh).get_table("db.t")
        if how == "branch":
            src = BRANCH[pkg].branch_table(src, "b1")
        dst = catalog(pkg, tmp_path / f"dst_{pkg}", "clone")
        cloned = CLONE[pkg].clone_table(src, dst, "mirror.t2", snapshot_id=sid)
        _, pairs = CLONE[pkg].pick_files(src, sid)
        for s, rel in pairs:  # every copied file is byte-identical to its source
            with open(s, "rb") as a, open(f"{cloned.path}/{rel}", "rb") as b:
                assert a.read() == b.read(), rel
        out[pkg] = (read(cloned, pkg), sorted(tree(cloned.path)))
    assert out["port"] == out["jax"]
    assert out["port"][0] == src_rows
    expect = {"latest": list(range(150)), "tag": list(range(100)),
              "branch": list(range(100)) + list(range(1000, 1010))}[how]
    assert [r[0] for r in out["port"][0]] == expect
    # each package reads the other's clone, and writes on after it
    for reader, writer_ in (("jax", "port"), ("port", "jax")):
        c = catalog(reader, tmp_path / f"dst_{writer_}").get_table("mirror.t2")
        assert read(c, reader) == src_rows
    c = catalog("port", tmp_path / "dst_jax").get_table("mirror.t2").copy(ENGINE["port"])
    write(c, 200, 210)
    assert len(read(c, "port")) == len(src_rows) + 10 and read(t, writer) == read(t, writer)


def test_clone_preserves_changelog_and_reclones(tmp_path):
    """tests/test_clone_actions.py::test_clone_preserves_changelog in both:
    the changelog manifests and files ride along, and a second clone of
    the same snapshot succeeds."""
    out = {}
    for pkg in PKGS:
        _, t = source_table(pkg, tmp_path / f"src_{pkg}", "db.cl", {"bucket": "1", "changelog-producer": "input"},
                            runs=((0, 10, None), (5, 15, None)))
        dst = catalog(pkg, tmp_path / f"dst_{pkg}", "clone")
        cloned = CLONE[pkg].clone_table(t, dst, "mirror.cl")
        snap = cloned.store.snapshot_manager.latest_snapshot()
        assert snap.changelog_manifest_list
        files = sorted(tree(cloned.path))
        again = CLONE[pkg].clone_table(t, dst, "mirror.cl")
        out[pkg] = (read(cloned, pkg), len(files), sum("manifest/" in f for f in files), read(again, pkg))
    assert out["port"] == out["jax"]


def test_refuses_to_clone_over_another_table(tmp_path):
    out = {}
    for pkg in PKGS:
        _, t = source_table(pkg, tmp_path / f"src_{pkg}")
        dst = catalog(pkg, tmp_path / f"dst_{pkg}", "clone")
        other = dst.create_table("mirror.t2", schema(pkg), primary_keys=["id"], options={"bucket": "1"})
        write(other, 0, 1)
        write(other, 0, 1)
        write(other, 0, 1)
        try:
            CLONE[pkg].clone_table(t, dst, "mirror.t2")
            out[pkg] = "cloned"
        except RuntimeError as e:
            out[pkg] = str(e).replace(str(tmp_path / f"dst_{pkg}"), "<dst>")
    assert out["port"] == out["jax"]
    assert "refusing to clone over an existing table" in out["port"]


def test_a_pinned_snapshot_whose_files_expired_fails(tmp_path):
    out = {}
    for pkg in PKGS:
        _, t = source_table(pkg, tmp_path / f"src_{pkg}")
        snap_id, pairs = CLONE[pkg].pick_files(t, 1)
        data = [src for src, rel in pairs if rel.startswith("bucket-")]
        os.remove(data[0])
        dst = catalog(pkg, tmp_path / f"dst_{pkg}", "clone")
        try:
            CLONE[pkg].clone_table(t, dst, "mirror.t2", snapshot_id=1)
            out[pkg] = "cloned"
        except RuntimeError as e:
            # file names are UUIDs: the same file by its place in the list
            out[pkg] = str(e).replace(str(tmp_path / f"src_{pkg}"), "<src>").replace(
                os.path.basename(data[0]), "<first data file>")
    assert out["port"] == out["jax"]
    assert "failed after 3 attempts" in out["port"] and "<first data file>" in out["port"]


def test_clone_database_and_warehouse(tmp_path):
    src_wh = tmp_path / "src"
    cat, _ = source_table("jax", src_wh)
    u = cat.create_table("db.u", schema("jax"), primary_keys=["id"], options={"bucket": "1"})
    write(u, 0, 10)
    cat.create_table("db.empty", schema("jax"), primary_keys=["id"], options={"bucket": "1"})
    _, o = source_table("jax", src_wh, "other.x", runs=((0, 5, None),))
    out = {}
    for pkg in PKGS:
        src = catalog(pkg, src_wh)
        db = CLONE[pkg].clone_database(src, "db", catalog(pkg, tmp_path / f"db_{pkg}", "clone"), "copy")
        wh = CLONE[pkg].clone_warehouse(src, catalog(pkg, tmp_path / f"wh_{pkg}", "clone"))
        rows = read(catalog(pkg, tmp_path / f"wh_{pkg}").get_table("other.x"), pkg)
        out[pkg] = (db, wh, rows, read(catalog(pkg, tmp_path / f"db_{pkg}").get_table("copy.u"), pkg))
    assert out["port"] == out["jax"]
    assert out["port"][:2] == (["copy.t", "copy.u"], ["db.t", "db.u", "other.x"])


@pytest.mark.parametrize("writer", PKGS)
def test_clone_under_fault_injection(writer, tmp_path):
    """tests/test_clone_actions.py::test_clone_under_fault_injection in the
    port, on a table either package wrote: each failed attempt re-picks
    from the latest snapshot, and the copy lands complete."""
    src_wh = tmp_path / "src"
    source_table(writer, src_wh, "db.ft", runs=((0, 200, None), (100, 300, None)))
    domain = f"clonefault_{writer}"
    ptesting.FailingFileIO.reset(domain, max_fails=5, possibility=30, seed=3)
    try:
        faulty = pcatalog.FileSystemCatalog(f"fail://{domain}{src_wh}", commit_user="setup", device="cpu")
        ft = faulty.get_table("db.ft")
        dst = catalog("port", tmp_path / "dst", "clone")
        cloned = pclone.clone_table(ft, dst, "mirror.ft", parallelism=2, max_retries=10)
        assert ptesting.FailingFileIO.fails_injected(domain) > 0
    finally:
        ptesting.FailingFileIO.reset(domain, 0, 0)
    assert [r[0] for r in read(cloned, "port")] == list(range(300))
    # the JAX package's domain is its own: the port's faults never reach it
    jtesting.FailingFileIO.reset(domain, 0, 0)
    jt = jcatalog.FileSystemCatalog(f"fail://{domain}{src_wh}").get_table("db.ft")
    assert read(jt, "jax") == read(cloned, "port")
