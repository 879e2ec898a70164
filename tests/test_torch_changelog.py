"""The changelog producers of the port (paimon_tpu_torch) against the JAX
package's, on the CPU (device="cpu" for the port).

Each case runs the same commits through both packages, under
changelog-producer=input, lookup or full-compaction, with
changelog-producer.row-deduplicate true and false, lookup with
changelog-producer.lookup-wait=false (its changelog then comes from
compactions), and input on batch commits of a write-only table. The rows
hold +I, -U, +U and -D rows over overlapping ids. Compared:

- per snapshot: its kind, changelogRecordCount, and each changelog file
  in manifest order by (bucket, row count, key range, row kinds, sequence
  numbers, values);
- the final read, against the other package and an oracle;
- replaying every changelog row in snapshot order from an empty table
  gives the table's read (input and lookup after every commit,
  full-compaction after a final full compaction); the input producer's
  changelog rows are the input rows, kinds included;
- the JAX package's streaming reader (table/stream.py) gives the same
  splits and rows on the port's table as on its own;
- snapshot expiry, coupled and decoupled (changelog.num-retained.max),
  leaves the same changelog files on both disks, none missing and none
  orphaned.

Compacting tables set compaction.max-size-amplification-percent=0, so that
every pick is a full compaction once the runs pass the trigger: the two
packages' Parquet encoders write files of other sizes, and a size-based
pick could choose other runs in each.

Tolerance: exact. Row kinds, sequence numbers, ids, doubles and strings
are copied or diffed, never computed, so every value must be equal.
"""

import collections
import io
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import paimon_tpu as jt
import paimon_tpu_torch as tt
from paimon_tpu.catalog import FileSystemCatalog as JaxCatalog
from paimon_tpu.types import RowKind as JaxRowKind
from paimon_tpu_torch.catalog import FileSystemCatalog as PortCatalog
from paimon_tpu_torch.core.manifest import ManifestFile, ManifestList
from paimon_tpu_torch.core.snapshot import Snapshot
from paimon_tpu_torch.fs import LocalFileIO

COMPACTING = {"bucket": "1", "num-sorted-run.compaction-trigger": "3",
              "compaction.max-size-amplification-percent": "0"}
ENGINE = {"jax": {"sort-engine": "numpy"}, "port": {"sort-engine": "pallas"}}
KINDS = ("+I", "-U", "+U", "-D")
IDS = 60

# (options, commit mode)
CASES = {
    "input": ({**COMPACTING, "changelog-producer": "input"}, "stream"),
    "input-write-only-batch": ({"bucket": "1", "write-only": "true", "changelog-producer": "input"}, "batch"),
    "lookup": ({**COMPACTING, "changelog-producer": "lookup"}, "stream"),
    "lookup-no-row-deduplicate": (
        {**COMPACTING, "changelog-producer": "lookup", "changelog-producer.row-deduplicate": "false"}, "stream"),
    "lookup-wait-false": (
        {**COMPACTING, "changelog-producer": "lookup", "changelog-producer.lookup-wait": "false"}, "stream"),
    "lookup-batch": ({**COMPACTING, "changelog-producer": "lookup"}, "batch"),
    "full-compaction": ({**COMPACTING, "changelog-producer": "full-compaction"}, "stream"),
    "full-compaction-no-row-deduplicate": (
        {**COMPACTING, "changelog-producer": "full-compaction", "changelog-producer.row-deduplicate": "false"},
        "stream"),
}


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


@pytest.fixture
def warehouse(tmp_path):
    return str(tmp_path)


def _catalog(name, warehouse):
    if name == "jax":
        return JaxCatalog(warehouse, commit_user=name)
    return PortCatalog(warehouse, commit_user=name, device="cpu")


def _schema(pkg):
    return pkg.RowType.of(("id", pkg.BIGINT(False)), ("v", pkg.DOUBLE()), ("tag", pkg.STRING()))


def _create(name, warehouse, ident, options):
    pkg = jt if name == "jax" else tt
    return _catalog(name, warehouse).create_table(f"{ident}_{name}", _schema(pkg), primary_keys=["id"],
                                                  options={**options, **ENGINE[name]})


def _commits(seed=5, n=10, rows=30):
    """(rows, kinds) of each commit: ids drawn with repeats, values that
    repeat across commits (so some updates change nothing), and -U/+U/-D
    rows among the +I."""
    rng = np.random.default_rng(seed)
    out = []
    for c in range(n):
        ids = rng.integers(0, IDS, rows).astype(np.int64)
        v = (ids % 7) * 0.5 + rng.integers(0, 2, rows)
        tag = np.array([f"t{x}" for x in rng.integers(0, 3, rows)], dtype=object)
        kinds = [KINDS[k] for k in rng.choice(4, rows, p=[0.7, 0.05, 0.15, 0.1])] if c else ["+I"] * rows
        out.append(({"id": ids, "v": v, "tag": tag}, kinds))
    return out


def _run(table, commits, mode, compact_full=False):
    """One commit per batch (stream: one write, ascending identifiers;
    batch: a builder per commit); then, with compact_full, a full
    compaction in one batch commit."""
    if mode == "stream":
        wb = table.new_stream_write_builder()
        w, c = wb.new_write(), wb.new_commit()
        for i, (rows, kinds) in enumerate(commits):
            w.write(rows, kinds)
            c.commit_messages(i + 1, w.prepare_commit())
    else:
        for rows, kinds in commits:
            wb = table.new_batch_write_builder()
            w = wb.new_write()
            w.write(rows, kinds)
            wb.new_commit().commit(w.prepare_commit())
    if compact_full:
        wb = table.new_batch_write_builder()
        w = wb.new_write()
        w.compact(full=True)
        wb.new_commit().commit(w.prepare_commit())


def _py(v):
    return v.item() if hasattr(v, "item") else v


def _read(table) -> list[tuple]:
    rb = table.new_read_builder()
    return [tuple(_py(v) for v in row) for row in rb.new_read().read_all(rb.new_scan().plan()).to_pylist()]


def _oracle(commits) -> list[tuple]:
    """Each id's last row, unless that row is -U or -D."""
    last = {}
    for rows, kinds in commits:
        for i, k in enumerate(kinds):
            row = (int(rows["id"][i]), float(rows["v"][i]), rows["tag"][i])
            if k in ("+I", "+U"):
                last[row[0]] = row
            else:
                last.pop(row[0], None)
    return [last[k] for k in sorted(last)]


_IO = LocalFileIO()


def _snapshot(path, sid):
    return Snapshot.from_json(_IO.read_bytes(f"{path}/snapshot/snapshot-{sid}"))


def _snapshot_ids(path):
    d = f"{path}/snapshot"
    return sorted(int(n[len("snapshot-"):]) for n in os.listdir(d) if n.startswith("snapshot-"))


def _changelog_rows(path, bucket, name) -> tuple:
    t = pq.read_table(f"{path}/bucket-{bucket}/{name}")
    kinds = tuple(JaxRowKind(k).short_string for k in t.column("_VALUE_KIND").to_pylist())
    rows = tuple(zip(*(t.column(c).to_pylist() for c in ("id", "v", "tag"))))
    return kinds, tuple(t.column("_SEQUENCE_NUMBER").to_pylist()), rows


def _changelog_view(path, snapshot_ids=None) -> list:
    """Per snapshot: (id, kind, changelogRecordCount, changelog files in
    manifest order by (bucket, rows, key range, kinds, seqs, rows))."""
    ml, mf = ManifestList(_IO, f"{path}/manifest"), ManifestFile(_IO, f"{path}/manifest")
    out = []
    for sid in snapshot_ids or _snapshot_ids(path):
        snap = _snapshot(path, sid)
        files = []
        if snap.changelog_manifest_list:
            for meta in ml.read(snap.changelog_manifest_list):
                for e in mf.read(meta.file_name):
                    assert e.file.file_name.startswith("changelog-")
                    files.append((e.bucket, e.file.row_count, tuple(e.file.min_key), tuple(e.file.max_key),
                                  *_changelog_rows(path, e.bucket, e.file.file_name)))
        out.append((sid, snap.commit_kind.value, snap.changelog_record_count, files))
    return out


def _replay(view, upto=None) -> list[tuple]:
    """The state that applying every changelog row, in snapshot order up to
    snapshot `upto`, to an empty table gives."""
    state = {}
    for sid, _, _, files in view:
        if upto is not None and sid > upto:
            break
        for _, _, _, _, kinds, _, rows in files:
            for k, row in zip(kinds, rows):
                if k in ("+I", "+U"):
                    state[row[0]] = row
                else:
                    state.pop(row[0], None)
    return [state[k] for k in sorted(state)]


def _stream_read(table) -> list:
    """Every plan of the JAX package's streaming reader over `table` (opened
    as a JAX table), from before the first snapshot: per plan its splits'
    (bucket, files, is_changelog) and the rows with their kinds."""
    scan = table.new_read_builder().new_stream_scan()
    read = table.new_read_builder().new_read()
    scan.restore(1)
    out = []
    while True:
        splits = scan.plan()
        if splits is None:
            return out
        plan = []
        for s in splits:
            data, kinds = read.read_with_kinds(s)
            rows = [(JaxRowKind(int(k)).short_string, *map(_py, r)) for r, k in zip(data.to_pylist(), kinds)]
            plan.append((s.bucket, len(s.files), s.is_changelog, rows))
        out.append(plan)


def _port_stream_read(path) -> list:
    """_stream_read with the port's own streaming reader (table/stream.py)."""
    from paimon_tpu_torch.table import load_table

    table = load_table(path, device="cpu")
    scan = table.new_read_builder().new_stream_scan()
    read = table.new_read_builder().new_read()
    scan.restore(1)
    out = []
    while True:
        splits = scan.plan()
        if splits is None:
            return out
        plan = []
        for s in splits:
            data, kinds = read.read_with_kinds(s)
            rows = [(JaxRowKind(int(k)).short_string, *map(_py, r)) for r, k in zip(data.to_pylist(), kinds)]
            plan.append((s.bucket, len(s.files), s.is_changelog, rows))
        out.append(plan)


def _both(warehouse, ident, options, commits, mode, compact_full=False):
    tables = {}
    for name in ("jax", "port"):
        tables[name] = _create(name, warehouse, ident, options)
        _run(tables[name], commits, mode, compact_full)
    return tables


# ---------------------------------------------------------------------------
# the producers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_changelog_files_match_the_reference(warehouse, case):
    options, mode = CASES[case]
    producer = options["changelog-producer"]
    commits = _commits()
    full = producer == "full-compaction" or options.get("changelog-producer.lookup-wait") == "false"
    tables = _both(warehouse, f"db.cl_{case.replace('-', '_')}", options, commits, mode, compact_full=full)
    views = {name: _changelog_view(t.path) for name, t in tables.items()}
    assert views["port"] == views["jax"]
    view = views["port"]
    want = _oracle(commits)
    assert _read(tables["port"]) == _read(tables["jax"]) == want
    with_changelog = [kind for _, kind, count, files in view if files]
    assert with_changelog, "no changelog written"
    for _, _, count, files in view:
        assert count == (sum(f[1] for f in files) if files else None)
    if producer == "input":
        assert set(with_changelog) == {"APPEND"}
        rows = [r for _, _, _, files in view for f in files for r in zip(f[4], f[6])]
        assert rows == [(k, (int(i), float(v), t)) for c, kinds in commits
                        for k, i, v, t in zip(kinds, c["id"], c["v"], c["tag"])]
    elif full:
        assert set(with_changelog) == {"COMPACT"}
    else:
        assert set(with_changelog) == {"APPEND"}
    assert _replay(view) == want
    if producer != "input":
        # a diff's -U rows and its +U rows pair up in order; without
        # row-deduplicate a key whose row did not change gives a pair too
        unchanged = 0
        for _, _, _, files in view:
            for f in files:
                old = [r for k, r in zip(f[4], f[6]) if k == "-U"]
                new = [r for k, r in zip(f[4], f[6]) if k == "+U"]
                assert len(old) == len(new)
                unchanged += sum(a == b for a, b in zip(old, new))
        assert (unchanged > 0) == (options.get("changelog-producer.row-deduplicate") == "false")


@pytest.mark.parametrize("case", ["lookup", "full-compaction"])
def test_replay_holds_after_every_commit(warehouse, case):
    """lookup: after each commit the replayed changelog is the table's state;
    full-compaction: after each full compaction."""
    options, _ = CASES[case]
    commits = _commits(seed=11, n=8)
    table = _create("port", warehouse, f"db.replay_{case.replace('-', '_')}", options)
    for i in range(len(commits)):
        _run(table, commits[i:i + 1], "batch", compact_full=case == "full-compaction")
        assert _replay(_changelog_view(table.path)) == _oracle(commits[: i + 1]) == _read(table)


@pytest.mark.parametrize("case", ["input", "lookup", "full-compaction"])
def test_jax_stream_reader_reads_the_ports_changelog(warehouse, case):
    options, mode = CASES[case]
    ident = f"db.stream_{case.replace('-', '_')}"
    _both(warehouse, ident, options, _commits(seed=3, n=8), mode, compact_full=case == "full-compaction")
    plans = {name: _stream_read(JaxCatalog(warehouse).get_table(f"{ident}_{name}")) for name in ("jax", "port")}
    assert plans["port"] == plans["jax"]
    assert any(split[2] and split[3] for plan in plans["port"] for split in plan)


@pytest.mark.parametrize("case", ["input", "lookup", "full-compaction"])
def test_port_stream_reader_replays_as_the_jax_one(warehouse, case):
    """The port's streaming reader gives the JAX package's plans and rows on
    both packages' tables of each producer."""
    options, mode = CASES[case]
    ident = f"db.pstream_{case.replace('-', '_')}"
    _both(warehouse, ident, options, _commits(seed=3, n=8), mode, compact_full=case == "full-compaction")
    for name in ("jax", "port"):
        path = JaxCatalog(warehouse).get_table(f"{ident}_{name}").path
        assert _port_stream_read(path) == _stream_read(JaxCatalog(warehouse).get_table(f"{ident}_{name}"))


def test_full_compaction_rewrites_files_it_could_upgrade(warehouse):
    """Level-0 files at least target-file-size, key-disjoint from the top
    level, would be upgraded by a full compaction; under the full-compaction
    producer they are rewritten, so that their rows reach the changelog."""
    options = {**COMPACTING, "changelog-producer": "full-compaction", "target-file-size": "1 kb"}
    first = ({"id": np.arange(40, dtype=np.int64), "v": np.arange(40) * 1.0,
              "tag": np.array(["a"] * 40, dtype=object)}, ["+I"] * 40)
    # random 48-character tags keep each 32-row file above 1 kb in both
    # packages' encoders
    tags = np.random.default_rng(1).integers(0, 1 << 62, (60, 3)).astype(np.uint64)
    later = ({"id": np.arange(200, 260, dtype=np.int64), "v": np.arange(60) * 2.0,
              "tag": np.array([f"{a:016x}{b:016x}{c:016x}" for a, b, c in tags], dtype=object)}, ["+I"] * 60)
    tables = {}
    for name in ("jax", "port"):
        tables[name] = _create(name, warehouse, "db.upgrade", options)
        _run(tables[name], [first], "batch", compact_full=True)
        _run(tables[name], [later], "batch")
        level0 = [f for f in tables[name].store.new_scan().plan().entries if f.file.level == 0]
        assert len(level0) > 1 and all(e.file.file_size >= 1024 for e in level0)
        _run(tables[name], [], "batch", compact_full=True)
    view = _changelog_view(tables["port"].path)
    assert view == _changelog_view(tables["jax"].path)
    assert [(sid, kind) for sid, kind, _, files in view if files] == [(2, "COMPACT"), (4, "COMPACT")]
    assert _replay(view) == _oracle([first, later]) == _read(tables["port"])


def test_input_changelog_is_written_with_sequence_field(warehouse):
    """The input producer writes the raw rows even when a sequence.field
    makes a late row lose the merge."""
    options = {**COMPACTING, "changelog-producer": "input", "sequence.field": "v"}
    commits = [({"id": np.array([1, 2, 1], dtype=np.int64), "v": np.array([5.0, 1.0, 3.0]),
                 "tag": np.array(["x", "y", "z"], dtype=object)}, ["+I"] * 3)]
    tables = _both(warehouse, "db.input_seq", options, commits, "stream")
    view = _changelog_view(tables["port"].path)
    assert view == _changelog_view(tables["jax"].path)
    assert [r for _, _, _, fs in view for f in fs for r in f[6]] == [(1, 5.0, "x"), (2, 1.0, "y"), (1, 3.0, "z")]
    assert _read(tables["port"]) == _read(tables["jax"]) == [(1, 5.0, "x"), (2, 1.0, "y")]


# ---------------------------------------------------------------------------
# expiry
# ---------------------------------------------------------------------------


def _disk(path) -> dict:
    """Snapshots, EARLIEST, changelog copies and every changelog and data
    file on disk by content; asserts that every file a retained snapshot or
    changelog copy references is there and every file is referenced."""
    ml, mf = ManifestList(_IO, f"{path}/manifest"), ManifestFile(_IO, f"{path}/manifest")
    roots = [(_snapshot(path, sid), True) for sid in _snapshot_ids(path)]
    cdir = f"{path}/changelog"
    copies = sorted(n for n in os.listdir(cdir) if n.startswith("changelog-")) if os.path.isdir(cdir) else []
    roots += [(Snapshot.from_json(_IO.read_bytes(f"{cdir}/{n}")), False) for n in copies]
    referenced = set()
    for snap, whole in roots:
        lists = [snap.base_manifest_list, snap.delta_manifest_list] if whole else []
        for lst in lists + [snap.changelog_manifest_list]:
            for meta in ml.read(lst) if lst else []:
                referenced.update(e.file.file_name for e in mf.read(meta.file_name))
    on_disk = sorted(n for n in os.listdir(f"{path}/bucket-0") if not n.startswith("."))
    assert sorted(referenced) == on_disk
    changelog = collections.Counter(_changelog_rows(path, 0, n) for n in on_disk if n.startswith("changelog-"))
    data = collections.Counter(pq.read_table(f"{path}/bucket-0/{n}").num_rows for n in on_disk if n.startswith("data-"))
    return {"snapshots": _snapshot_ids(path), "earliest": int(_IO.read_text(f"{path}/snapshot/EARLIEST")),
            "copies": copies, "changelog": changelog, "data": data}


@pytest.mark.parametrize("retention", [
    {"snapshot.num-retained.max": "3"},
    {"snapshot.num-retained.max": "3", "changelog.num-retained.max": "5"},
], ids=["coupled", "decoupled"])
@pytest.mark.parametrize("producer", ["input", "lookup", "full-compaction"])
def test_expiry_leaves_the_same_changelog_files(warehouse, producer, retention):
    options = {**COMPACTING, "changelog-producer": producer, **retention}
    tables = _both(warehouse, f"db.expire_{producer.replace('-', '_')}_{len(retention)}", options,
                   _commits(seed=7, n=9), "stream")
    disk = _disk(tables["port"].path)
    assert disk == _disk(tables["jax"].path)
    assert disk["changelog"], "every changelog file expired"
    assert len(disk["snapshots"]) == 3 and disk["earliest"] == disk["snapshots"][0] > 1
    assert bool(disk["copies"]) == ("changelog.num-retained.max" in retention)
