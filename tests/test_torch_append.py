"""Append-only tables in the port (paimon_tpu_torch) against the JAX
package, on the CPU (device="cpu" for the port).

A table without a primary key, at bucket=1, at bucket=N with a
bucket-key, at bucket=N hashing every field, and at bucket=-1 (unaware:
every row to bucket 0 of its partition), partitioned or not, is written by
each package from the same seeded rows (streaming commits that flush
several small files, with the small-file compaction of a non-write-only
table, then a full compaction) and read by both. Compared: the rows in
order; every snapshot (kind, identifier, record counts) with its delta
manifest entries field for field (kind, partition, bucket, total buckets,
row count, key range, sequence range, level, file source, -D rows) and
its index entries; the splits each package plans for the same table
(partition, bucket, files, raw_convertible), also under a value filter
that prunes files by their stats. Then DELETE: copy-on-write and through
deletion vectors; the stream reader over an append table; overwrite. The
JAX package's tests/test_append_only.py (all six tests) and
tests/test_table.py::test_append_table_split_packing each have a
counterpart here, run against both packages.

Where the packages differ on purpose: the JAX package's append rewrites
(the writer's small-file compaction, and the copy-on-write DELETE once
deletion-vectors.enabled is off) ignore the bucket's deletion vectors, so
deleted rows come back; the port applies them (ROADMAP Queue 3). The tests
show both.

Tolerance: exact. Every value is copied, never computed.
"""

import io

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import paimon_tpu as jt
import paimon_tpu_torch as tt
from paimon_tpu.catalog import FileSystemCatalog as JaxCatalog
from paimon_tpu.data import predicate as jp
from paimon_tpu.table import load_table as jax_load_table
from paimon_tpu.types import RowKind as JaxRowKind
from paimon_tpu_torch.catalog import FileSystemCatalog as PortCatalog
from paimon_tpu_torch.data import predicate as tp
from paimon_tpu_torch.table import load_table as port_load_table

PKGS = ("jax", "port")
DAYS = np.array(["2024-05-01", "2024-05-02", "2024-05-03"], dtype=object)
LAYOUTS = {
    "bucket_1": ({"bucket": "1"}, False),
    "bucket_4_bucket_key": ({"bucket": "4", "bucket-key": "id"}, False),
    "bucket_3_all_fields": ({"bucket": "3"}, False),
    "unaware": ({"bucket": "-1"}, False),
    "unaware_partitioned": ({"bucket": "-1"}, True),
    "bucket_2_partitioned": ({"bucket": "2", "bucket-key": "id"}, True),
}
# small files: two flushes a commit; three small files in a row compact
SMALL = {"write-buffer-rows": "20", "compaction.min.file-num": "3"}
COMMITS = 6


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


def _mod(pkg):
    return jt if pkg == "jax" else tt


def _preds(pkg):
    return jp if pkg == "jax" else tp


def _catalog(pkg, warehouse):
    if pkg == "jax":
        return JaxCatalog(warehouse, commit_user=pkg)
    return PortCatalog(warehouse, commit_user=pkg, device="cpu")


def _open(pkg, path, options=None):
    if pkg == "jax":
        return jax_load_table(path, commit_user=pkg, dynamic_options=options)
    return port_load_table(path, commit_user=pkg, dynamic_options=options, device="cpu")


def _schema(pkg):
    m = _mod(pkg)
    return m.RowType.of(("dt", m.STRING(False)), ("id", m.BIGINT()), ("v", m.DOUBLE()), ("s", m.STRING()))


def _create(pkg, warehouse, ident, options, partitioned=False):
    return _catalog(pkg, warehouse).create_table(ident, _schema(pkg), partition_keys=["dt"] if partitioned else [],
                                                 options=options)


def _py(v):
    return v.item() if hasattr(v, "item") else v


def _rows(batch) -> list[tuple]:
    return [tuple(_py(v) for v in row) for row in batch.to_pylist()]


def _read(table, predicate=None, projection=None) -> list[tuple]:
    rb = table.new_read_builder()
    if predicate is not None:
        rb = rb.with_filter(predicate)
    if projection is not None:
        rb = rb.with_projection(projection)
    return _rows(rb.new_read().read_all(rb.new_scan().plan()))


def _batch(seed, n=30) -> dict:
    """n rows with repeated ids, nulls in id, v and s, over three days."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 40, n)
    return {"dt": DAYS[rng.integers(0, 3, n)],
            "id": [None if i % 11 == 0 else int(i) for i in ids],
            "v": [None if i % 7 == 3 else float(i) * 0.5 + 10 * seed for i in ids],
            "s": np.array([None if (i + seed) % 5 == 0 else f"s{i}-{seed}" for i in ids], dtype=object)}


def _as_rows(data: dict) -> list[tuple]:
    return list(zip(*(list(data[c]) for c in ("dt", "id", "v", "s"))))


def _commit(table, data, kinds=None, overwrite=None):
    wb = table.new_batch_write_builder()
    if overwrite is not None:
        wb = wb.with_overwrite(*overwrite)
    w = wb.new_write()
    w.write(data, kinds)
    return wb.new_commit().commit(w.prepare_commit())


def _stream(table, batches, first=1):
    wb = table.new_stream_write_builder()
    w, c = wb.new_write(), wb.new_commit()
    for i, data in enumerate(batches, start=first):
        w.write(data)
        c.commit_messages(i, w.prepare_commit())
    return w, c


def _history(path) -> list:
    """Per snapshot: kind, identifier, record counts, the delta manifest
    entries (sorted) and the index entries, as the port reads them."""
    store = port_load_table(path, device="cpu").store
    sm = store.snapshot_manager
    scan = store.new_scan()
    out = []
    for sid in range(sm.earliest_snapshot_id(), sm.latest_snapshot_id() + 1):
        snap = sm.snapshot(sid)
        entries = sorted(
            (int(e.kind), e.partition, e.bucket, e.total_buckets, e.file.row_count, tuple(e.file.min_key),
             tuple(e.file.max_key), e.file.min_sequence_number, e.file.max_sequence_number, e.file.level,
             e.file.file_source, e.file.delete_row_count, tuple(e.file.key_stats))
            for m in scan.manifest_list.read(snap.delta_manifest_list) for e in scan.manifest_file.read(m.file_name))
        index = sorted((e.kind, e.partition, e.bucket, e.row_count)
                       for e in store.new_scan().with_snapshot(sid).plan().index_entries)
        out.append((sid, snap.commit_kind.value, snap.commit_identifier, snap.total_record_count,
                    snap.delta_record_count, entries, index))
    return out


def _parity(paths: dict, ordered: bool = True) -> list[tuple]:
    """The same history from either writer, and the same rows from either
    reader of each table; across writers the same rows in the same order,
    or (ordered=False) the same multiset."""
    assert _history(paths["port"]) == _history(paths["jax"])
    reads = {(w, r): _read(_open(r, p)) for w, p in paths.items() for r in PKGS}
    for w in PKGS:
        assert reads[(w, "port")] == reads[(w, "jax")]
    first = reads[("jax", "jax")]
    if ordered:
        assert reads[("port", "port")] == first
    else:
        assert sorted(reads[("port", "port")], key=repr) == sorted(first, key=repr)
    return first


def _write_both(warehouse, name, scenario, options, partitioned=False) -> dict:
    paths = {}
    for pkg in PKGS:
        table = _create(pkg, warehouse, f"db.{name}_{pkg}", options, partitioned)
        scenario(pkg, table)
        paths[pkg] = table.path
    return paths


def _splits(table, predicate=None) -> list:
    rb = table.new_read_builder()
    if predicate is not None:
        rb = rb.with_filter(predicate)
    return [(tuple(s.partition), s.bucket, [f.file_name for f in s.files], s.raw_convertible)
            for s in rb.new_scan().plan()]


def _build(warehouse, layout):
    """The layout's table written by each package: COMMITS streaming commits
    of small flushes, then a full compaction."""
    options, partitioned = LAYOUTS[layout]

    def scenario(pkg, table):
        w, c = _stream(table, [_batch(s) for s in range(COMMITS)])
        w.compact(full=True)
        c.commit_messages(COMMITS + 1, w.prepare_commit())

    return _write_both(warehouse, f"ao_{layout}", scenario, {**options, **SMALL}, partitioned)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_append_parity(tmp_path, layout):
    """The same snapshots, entries and rows from either writer; every row
    written is read back once (duplicates kept), and at one bucket of one
    partition in the order written."""
    paths = _build(str(tmp_path), layout)
    rows = _parity(paths)
    written = [r for s in range(COMMITS) for r in _as_rows(_batch(s))]
    assert sorted(rows, key=repr) == sorted(written, key=repr)
    if layout in ("bucket_1", "unaware"):
        assert rows == written
    history = _history(paths["port"])
    assert {h[1] for h in history} == {"APPEND", "COMPACT"}
    assert all(e[5] == () == e[6] and e[12] == () for h in history for e in h[5])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_append_splits_and_value_filter(tmp_path, layout):
    """Each package plans the same splits for each table, at the default and
    at a tiny split target (one file a split, raw), and under a value filter
    (v < 10) that drops files by their stats; the filtered rows are the
    same and pass the filter."""
    options, partitioned = LAYOUTS[{"unaware": "unaware"}.get(layout, layout)]

    def scenario(pkg, table):
        for s in range(COMMITS):
            _commit(table, _batch(s))

    paths = _write_both(str(tmp_path), f"ao_split_{layout}", scenario, {**options, "write-only": "true"}, partitioned)
    tiny = {"source.split.target-size": "1 kb", "source.split.open-file-cost": "1 b"}
    for path in paths.values():
        assert _splits(_open("port", path)) == _splits(_open("jax", path))
        small = _splits(_open("port", path, tiny))
        assert small == _splits(_open("jax", path, tiny))
        assert all(len(s[2]) == 1 and s[3] for s in small)
        pruned = {pkg: _splits(_open(pkg, path), _preds(pkg).less_than("v", 10.0)) for pkg in PKGS}
        assert pruned["port"] == pruned["jax"]
        got = {pkg: _read(_open(pkg, path), _preds(pkg).less_than("v", 10.0)) for pkg in PKGS}
        assert got["port"] == got["jax"] and got["port"] and all(r[2] is not None and r[2] < 10 for r in got["port"])
    files = sum(len(s[2]) for s in _splits(_open("port", paths["port"])))
    assert sum(len(s[2]) for s in pruned["port"]) < files


@pytest.mark.parametrize("layout", ["bucket_1", "bucket_4_bucket_key", "unaware_partitioned"])
def test_append_delete_copy_on_write(tmp_path, layout):
    """DELETE on an append table without deletion vectors rewrites each
    file with a match, at its level, in one COMPACT snapshot under the
    batch-delete identifier: the same snapshots, entries, count and rows
    from either package (ROADMAP Queue 3: the rewritten files' sequence
    numbers are 0 in both)."""
    options, partitioned = LAYOUTS[layout]
    counts = {}

    def scenario(pkg, table):
        for s in range(3):
            _commit(table, _batch(s))
        counts[pkg] = table.delete_where(_preds(pkg).or_(_preds(pkg).equal("s", "s3-1"),
                                                           _preds(pkg).greater_than("id", 30)))
        _commit(table, _batch(9))

    paths = _write_both(str(tmp_path), f"ao_cow_{layout}", scenario, {**options, "write-only": "true"}, partitioned)
    # the rewritten files carry sequence numbers 0, as in the JAX package, so
    # a read orders them by file name, which differs between the writers
    rows = _parity(paths, ordered=False)
    assert counts["port"] == counts["jax"] > 0
    written = [r for s in (0, 1, 2) for r in _as_rows(_batch(s))]
    kept = [r for r in written if not (r[3] == "s3-1" or (r[1] is not None and r[1] > 30))]
    assert counts["port"] == len(written) - len(kept)
    assert sorted(rows, key=repr) == sorted(kept + _as_rows(_batch(9)), key=repr)
    delete = _history(paths["port"])[3]
    assert delete[1:3] == ("COMPACT", (1 << 63) - 2)
    assert all(e[10] == "compact" for e in delete[5] if e[0] == 0)


@pytest.mark.parametrize("layout", ["bucket_1", "unaware_partitioned"])
def test_append_delete_with_deletion_vectors(tmp_path, layout):
    """Under deletion-vectors.enabled a DELETE on an append table marks the
    matching rows in the files' vectors (no rewrite), twice: the same
    snapshots, index entries, counts and rows from either package."""
    options, partitioned = LAYOUTS[layout]
    counts = {}

    def scenario(pkg, table):
        for s in range(3):
            _commit(table, _batch(s))
        p = _preds(pkg)
        counts[pkg] = (table.delete_where(p.less_than("v", 8.0)), table.delete_where(p.is_null("s")))

    paths = _write_both(str(tmp_path), f"ao_dv_{layout}", scenario,
                        {**options, "write-only": "true", "deletion-vectors.enabled": "true"}, partitioned)
    rows = _parity(paths)
    assert counts["port"] == counts["jax"] and min(counts["port"]) > 0
    history = _history(paths["port"])
    assert [h[1] for h in history[3:]] == ["APPEND", "APPEND"]
    assert any(e[0] == "DELETION_VECTORS" for e in history[-1][6])
    written = [r for s in range(3) for r in _as_rows(_batch(s))]
    assert sorted(rows, key=repr) == sorted(
        [r for r in written if not (r[2] is not None and r[2] < 8.0) and r[3] is not None], key=repr)


def test_append_rewrites_keep_deletion_vectors(tmp_path):
    """A row a DELETE marked in a vector stays deleted in the port when the
    writer's small-file compaction concatenates its file, and when a
    copy-on-write DELETE (deletion-vectors.enabled switched off) rewrites
    it. The JAX package's rewrites ignore the vectors and the COMPACT commit
    then drops them: the row comes back (ROADMAP Queue 3)."""
    reads = {}
    for pkg in PKGS:
        t = _create(pkg, str(tmp_path), f"db.ao_dv_rewrite_{pkg}",
                    {"bucket": "1", "deletion-vectors.enabled": "true", "compaction.min.file-num": "2"})
        p = _preds(pkg)
        _commit(t, {"dt": DAYS[[0, 0, 0]], "id": [1, 2, 3], "v": [1.0, 2.0, 3.0], "s": ["a", "b", "c"]})
        assert t.delete_where(p.equal("id", 2)) == 1
        steps = [_read(t)]
        _commit(t, {"dt": DAYS[[0]], "id": [4], "v": [4.0], "s": ["d"]})  # compacts both files
        steps.append(_read(t))
        off = t.copy({"deletion-vectors.enabled": "false"})
        _commit(off, {"dt": DAYS[[0]], "id": [5], "v": [5.0], "s": ["e"]})
        assert off.delete_where(p.equal("id", 4)) == 1
        steps.append(_read(off))
        kinds = [t.store.snapshot_manager.snapshot(i).commit_kind.value for i in range(1, 8)]
        reads[pkg] = steps, kinds
    assert reads["port"][1] == reads["jax"][1] == ["APPEND", "APPEND", "APPEND", "COMPACT", "APPEND", "COMPACT",
                                                   "COMPACT"]
    ids = {pkg: [[r[1] for r in step] for step in steps] for pkg, (steps, _) in reads.items()}
    assert ids["port"] == [[1, 3], [1, 3, 4], [1, 3, 5]]
    assert ids["jax"] == [[1, 3], [1, 2, 3, 4], [1, 2, 3, 5]]


@pytest.mark.parametrize("writer", PKGS)
def test_append_stream(tmp_path, writer):
    """A stream reader with a consumer over an append table written by
    `writer`: both packages plan the same splits after each commit (none
    for COMPACT snapshots) and read the same +I rows, which are each
    commit's rows; the consumers' checkpoints land on the same snapshot."""
    table = _create(writer, str(tmp_path), "db.ao_stream", {"bucket": "-1", **SMALL}, partitioned=True)
    readers = {pkg: _open(pkg, table.path, {"consumer-id": f"c_{pkg}"}) for pkg in PKGS}
    scans = {pkg: r.new_read_builder().new_stream_scan() for pkg, r in readers.items()}
    reads = {pkg: r.new_read_builder().new_read() for pkg, r in readers.items()}
    wb = table.new_stream_write_builder()
    w, c = wb.new_write(), wb.new_commit()
    seen = {pkg: [] for pkg in PKGS}
    for i in range(COMMITS):
        w.write(_batch(i))
        c.commit_messages(i + 1, w.prepare_commit())
        for pkg in PKGS:
            while (splits := scans[pkg].plan()) is not None:
                plan = []
                for s in splits:
                    data, kinds = reads[pkg].read_with_kinds(s)
                    assert not np.asarray(kinds).any()
                    plan.append(((tuple(s.partition), s.bucket, [f.file_name for f in s.files]), _rows(data)))
                seen[pkg].append(plan)
        if i == 3:
            for pkg in PKGS:
                scans[pkg].checkpoint()
                scans[pkg].notify_checkpoint_complete()
    assert seen["port"] == seen["jax"]
    got = [r for plan in seen["port"] for _, rows in plan for r in rows]
    assert sorted(got, key=repr) == sorted([r for i in range(COMMITS) for r in _as_rows(_batch(i))], key=repr)
    assert any(plan == [] for plan in seen["port"]), "no COMPACT snapshot was planned"
    positions = {pkg: readers[pkg].store.snapshot_manager.latest_snapshot_id() for pkg in PKGS}
    assert positions["port"] == positions["jax"]


@pytest.mark.parametrize("mode", ["static", "dynamic", "whole"])
def test_append_overwrite(tmp_path, mode):
    """INSERT OVERWRITE of one day on an unaware-bucket table partitioned by
    day: the same history and rows from either writer."""
    options = {"bucket": "-1", "write-only": "true", **({"dynamic-partition-overwrite": "false"} if mode == "whole" else {})}
    new = {"dt": DAYS[[1, 1]], "id": [100, 101], "v": [1.0, 2.0], "s": ["n", "m"]}

    def scenario(pkg, table):
        for s in range(2):
            _commit(table, _batch(s))
        _commit(table, new, overwrite=(lambda p: p == (DAYS[1],),) if mode == "static" else ())

    rows = _parity(_write_both(str(tmp_path), f"ao_ow_{mode}", scenario, options, partitioned=True))
    old = [r for s in range(2) for r in _as_rows(_batch(s))]
    kept = [] if mode == "whole" else [r for r in old if r[0] != DAYS[1]]
    assert sorted(rows, key=repr) == sorted(kept + _as_rows(new), key=repr)


@pytest.mark.parametrize("pkg", PKGS)
def test_bucket_mode_and_reopen(tmp_path, pkg):
    """bucket_mode of each table kind, and an append table reopened by the
    catalog and by load_table."""
    cat = _catalog(pkg, str(tmp_path))
    m = _mod(pkg)
    keyed = m.RowType.of(("id", m.BIGINT(False)), ("v", m.DOUBLE()))
    modes = {
        "append_unaware": cat.create_table("db.m1", keyed, options={"bucket": "-1"}).bucket_mode,
        "append_fixed": cat.create_table("db.m2", keyed, options={"bucket": "3"}).bucket_mode,
        "pk_dynamic": cat.create_table("db.m3", keyed, primary_keys=["id"], options={}).bucket_mode,
        "pk_fixed": cat.create_table("db.m4", keyed, primary_keys=["id"], options={"bucket": "2"}).bucket_mode,
    }
    assert modes == {"append_unaware": "unaware", "append_fixed": "fixed", "pk_dynamic": "dynamic",
                     "pk_fixed": "fixed"}
    t = cat.get_table("db.m1")
    assert not t.is_primary_key_table and t.primary_keys == []
    _commit(t, {"id": [3, 1, 3], "v": [1.0, 2.0, 3.0]})
    assert _read(_open(pkg, t.path)) == _read(cat.get_table("db.m1")) == [(3, 1.0), (1, 2.0), (3, 3.0)]


@pytest.mark.parametrize("option", ["write-buffer-spillable", "write-buffer-for-append"])
def test_spill_options_raise_naming_them(tmp_path, option):
    """The spilling append buffer (core/disk.py) under either option: both
    packages write five 30-row batches through a 40-row spill cap, and
    write the same files (rows per file, in order) and read the same rows
    in the same order."""
    files, rows = {}, {}
    for pkg in PKGS:
        t = _create(pkg, str(tmp_path), f"db.spill_{pkg}", {"bucket": "1", option: "true", "write-buffer-spill.rows": "40"})
        wb = t.new_batch_write_builder()
        w = wb.new_write()
        for seed in range(1, 6):
            w.write(_batch(seed))
        wb.new_commit().commit(w.prepare_commit())
        files[pkg] = [f.row_count for f in sorted(t.store.restore_files((), 0), key=lambda f: f.min_sequence_number)]
        rows[pkg] = _read(t)
    assert files["port"] == files["jax"] == [60, 60, 30]
    assert rows["port"] == rows["jax"] and len(rows["port"]) == 150


def test_null_partition_value_on_an_append_table_raises(tmp_path):
    """A null partition value: the JAX package fails (np.unique orders no
    None among strings); the port writes the row to the
    partition.default-name directory and reads it back under a None
    partition."""
    rows = {"dt": np.array(["2024-05-01", None], dtype=object), "id": [1, 2], "v": [1.0, 2.0], "s": ["a", "b"]}
    m = jt
    jax = _catalog("jax", str(tmp_path)).create_table(
        "db.null_jax", m.RowType.of(("dt", m.STRING()), ("id", m.BIGINT()), ("v", m.DOUBLE()), ("s", m.STRING())),
        partition_keys=["dt"], options={"bucket": "-1"})
    with pytest.raises(TypeError):
        _commit(jax, rows)
    m = tt
    port = _catalog("port", str(tmp_path)).create_table(
        "db.null_port", m.RowType.of(("dt", m.STRING()), ("id", m.BIGINT()), ("v", m.DOUBLE()), ("s", m.STRING())),
        partition_keys=["dt"], options={"bucket": "-1"})
    _commit(port, rows)
    assert sorted(_read(port), key=lambda r: r[1]) == [("2024-05-01", 1, 1.0, "a"), (None, 2, 2.0, "b")]
    assert sorted(port.store.new_scan().plan().grouped(), key=str) == [("2024-05-01",), (None,)]
    assert (tmp_path / "db.db" / "null_port" / "dt=__DEFAULT_PARTITION__" / "bucket-0").is_dir()


# ---------------------------------------------------------------------------
# tests/test_append_only.py and tests/test_table.py, in both packages
# ---------------------------------------------------------------------------


def _log_schema(pkg):
    m = _mod(pkg)
    return m.RowType.of(("id", m.BIGINT()), ("payload", m.STRING()), ("v", m.DOUBLE()))


def _log(pkg, tmp_path, name, options):
    return _catalog(pkg, str(tmp_path)).create_table(f"db.{name}", _log_schema(pkg), options=options)


@pytest.mark.parametrize("pkg", PKGS)
def test_append_only_keeps_duplicates(tmp_path, pkg):
    t = _log(pkg, tmp_path, "log", {"bucket": "1"})
    assert not t.is_primary_key_table
    _commit(t, {"id": [1, 1, 2], "payload": ["a", "a", "b"], "v": [1.0, 1.0, 2.0]})
    _commit(t, {"id": [1], "payload": ["a"], "v": [1.0]})
    out = _read(t)
    assert len(out) == 4 and sorted(r[0] for r in out) == [1, 1, 1, 2]


@pytest.mark.parametrize("pkg", PKGS)
def test_append_only_rejects_deletes(tmp_path, pkg):
    t = _log(pkg, tmp_path, "log2", {"bucket": "1"})
    w = t.new_batch_write_builder().new_write()
    with pytest.raises(ValueError, match="only \\+I"):
        w.write({"id": [1], "payload": ["x"], "v": [1.0]}, kinds=["-D"])


@pytest.mark.parametrize("pkg", PKGS)
def test_append_only_value_filter_prunes_files(tmp_path, pkg):
    t = _log(pkg, tmp_path, "log3", {"bucket": "1"})
    _commit(t, {"id": [1, 2], "payload": ["a", "b"], "v": [1.0, 2.0]})
    _commit(t, {"id": [100, 200], "payload": ["c", "d"], "v": [3.0, 4.0]})
    rb = t.new_read_builder().with_filter(_preds(pkg).greater_than("id", 50))
    splits = rb.new_scan().plan()
    assert sum(len(s.files) for s in splits) == 1
    assert sorted(r[0] for r in _rows(rb.new_read().read_all(splits))) == [100, 200]


@pytest.mark.parametrize("pkg", PKGS)
def test_append_only_small_file_compaction(tmp_path, pkg):
    t = _log(pkg, tmp_path, "log4", {"bucket": "1", "compaction.min.file-num": "3"})
    wb = t.new_batch_write_builder()
    w = wb.new_write()
    for i in range(5):
        w.write({"id": [i], "payload": [f"p{i}"], "v": [float(i)]})
        for writer in w._writers.values():
            writer.flush()
    wb.new_commit().commit(w.prepare_commit())
    assert len(t.store.restore_files((), 0)) < 5
    assert sorted(r[0] for r in _read(t)) == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("pkg", PKGS)
def test_append_only_multi_bucket_with_bucket_key(tmp_path, pkg):
    t = _log(pkg, tmp_path, "log5", {"bucket": "4", "bucket-key": "id"})
    n = 100
    _commit(t, {"id": list(range(n)), "payload": ["x"] * n, "v": [float(i) for i in range(n)]})
    assert len(t.new_read_builder().new_scan().plan()) > 1
    assert len(_read(t)) == n


@pytest.mark.parametrize("pkg", PKGS)
def test_append_only_projection_and_order(tmp_path, pkg):
    t = _log(pkg, tmp_path, "log6", {"bucket": "1"})
    _commit(t, {"id": [3, 1], "payload": ["c", "a"], "v": [3.0, 1.0]})
    _commit(t, {"id": [2], "payload": ["b"], "v": [2.0]})
    assert [r[0] for r in _read(t, projection=["payload"])] == ["c", "a", "b"]


@pytest.mark.parametrize("pkg", PKGS)
def test_append_table_split_packing(tmp_path, pkg):
    """tests/test_table.py::test_append_table_split_packing: one split per
    file under a target below every file's size (the port's files of this
    data, with RLE runs in their pages, are about 440 bytes; pyarrow's
    about 1.3 kb)."""
    m = _mod(pkg)
    schema = m.RowType.of(("id", m.BIGINT()), ("region", m.STRING()), ("amount", m.DOUBLE()))
    t = _catalog(pkg, str(tmp_path)).create_table("db.packapp", schema, options={"bucket": "1", "write-only": "true"})
    for r in range(5):
        _commit(t, {"id": list(range(100)), "region": ["x"] * 100, "amount": [float(r)] * 100})
    small = t.copy({"source.split.target-size": "256 b", "source.split.open-file-cost": "1 b"})
    splits = small.new_read_builder().new_scan().plan()
    assert all(f.file_size > 256 for s in splits for f in s.files)
    assert len(splits) == 5
    assert small.new_read_builder().new_read().read_all(splits).num_rows == 500


def test_append_rows_keep_their_kind_in_the_jax_reader(tmp_path):
    """An append file written by the port has no system columns; the JAX
    package's raw read of it gives +I rows with the file's values."""
    t = _create("port", str(tmp_path), "db.raw", {"bucket": "1"})
    _commit(t, _batch(3))
    jax = _open("jax", t.path)
    f = jax.store.new_scan().plan().entries[0].file
    kv = jax.store.reader_factory((), 0).read(f)
    assert (np.asarray(kv.kind) == int(JaxRowKind.INSERT)).all()
    assert _rows(kv.data) == _as_rows(_batch(3))
