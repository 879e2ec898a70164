"""Whole-slice parity: primary-key tables written and merge-read through the
Table API, across packages, on the CPU (device="cpu" for the port).

The table is the bench.py shape cut to 20,000 rows: 4 key-overlapping
sorted runs of a seed-7 permutation, then a fifth commit upserting 2,000
ids (unsorted, so the flush merge dedups) with new values and nulls; reads
use merge.read-batch-rows=4096 so the merge cuts several key-range tiles.
Directions: the JAX package writes and the port reads; the port writes and
the JAX package reads; the port writes and reads. Every read is compared
row for row, in order, with an oracle computed here in numpy and with the
other package's read. The same three directions at the JAX package's
default codecs (zstd pages, written by either of its Parquet encoders, and
zstd manifests). Also: the Parquet container against pyarrow in both
directions, with and without zstd, and the guards for what the port does
not support (those on read, each on a table the JAX package built).

Tolerance: exact. Rows hold integers, booleans, strings and doubles copied
untouched from the written values, so equality is bit for bit.
"""

import io
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import paimon_tpu as jt
import paimon_tpu_torch as tt
from paimon_tpu.catalog import FileSystemCatalog as JaxCatalog
from paimon_tpu_torch.catalog import FileSystemCatalog as PortCatalog
from paimon_tpu_torch.format.parquet import read_parquet, write_parquet

N, RUNS, N_UP, TILE = 20_000, 4, 2_000, 4096
OPTIONS = {
    "bucket": "1",
    "file.format": "parquet",
    "write-only": "true",
    "file.compression": "none",
    "manifest.compression": "none",
    "sort-engine": "pallas",
    "merge.read-batch-rows": str(TILE),
}
ENGINES = ["pallas", "xla-segmented", "numpy"]


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


def _values(ids: np.ndarray, upsert: bool) -> dict:
    salt = 1 if upsert else 0
    return {
        "id": ids,
        "c1": ids * 3 + salt,
        "c2": [None if x % (3 if upsert else 11) == 0 else int(x % 97 + 1000 * salt) for x in ids],
        "d1": ids.astype(np.float64) * 0.5 + 0.125 * salt,
        "b": (ids % 2 == salt),
        "s1": np.array([f"val-{int(x) % 100:03d}-{salt}" for x in ids], dtype=object),
        "s2": np.array([None if x % 13 == 0 else f"row-{int(x)}-{salt}" for x in ids], dtype=object),
    }


def _row_type(pkg):
    return pkg.RowType.of(
        ("id", pkg.BIGINT(False)),
        ("c1", pkg.BIGINT()),
        ("c2", pkg.INT()),
        ("d1", pkg.DOUBLE()),
        ("b", pkg.BOOLEAN()),
        ("s1", pkg.STRING()),
        ("s2", pkg.STRING()),
    )


def _upsert_ids() -> np.ndarray:
    return np.random.default_rng(8).choice(N, N_UP, replace=False).astype(np.int64)


def _build(pkg, catalog, ident: str, extra_options=None):
    """extra_options override OPTIONS; a None value drops the key."""
    options = {k: v for k, v in {**OPTIONS, **(extra_options or {})}.items() if v is not None}
    table = catalog.create_table(ident, _row_type(pkg), primary_keys=["id"], options=options)
    ids = np.random.default_rng(7).permutation(N).astype(np.int64)
    per = N // RUNS
    batches = [_values(np.sort(ids[r * per : (r + 1) * per]), False) for r in range(RUNS)]
    batches.append(_values(_upsert_ids(), True))
    for batch in batches:
        wb = table.new_batch_write_builder()
        w = wb.new_write()
        w.write(batch)
        wb.new_commit().commit(w.prepare_commit())
    return table


def _expected() -> list[tuple]:
    cols = _values(np.arange(N, dtype=np.int64), False)
    up = np.sort(_upsert_ids())
    new = _values(up, True)
    out = {}
    for name, base in cols.items():
        base = list(base)
        for i, v in zip(up.tolist(), list(new[name])):
            base[i] = v
        out[name] = base
    return [tuple(_py(out[n][i]) for n in cols) for i in range(N)]


def _py(v):
    return v.item() if hasattr(v, "item") else v


def _rows(batch) -> list[tuple]:
    return [tuple(_py(v) for v in row) for row in batch.to_pylist()]


def _read(table) -> list[tuple]:
    rb = table.new_read_builder()
    return _rows(rb.new_read().read_all(rb.new_scan().plan()))


def _jax_read(table) -> list[tuple]:
    # the JAX package's plain index download (what the port mirrors); its
    # compact link encoding misorders pallas tiles cut from several runs
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PAIMON_TPU_FORCE_COMPACT", "0")
        return _read(table)


@pytest.fixture(scope="module")
def warehouse(tmp_path_factory):
    return str(tmp_path_factory.mktemp("torch_port_warehouse"))


@pytest.fixture(scope="module")
def expected():
    return _expected()


@pytest.fixture(scope="module")
def jax_table(warehouse):
    return _build(jt, JaxCatalog(warehouse, commit_user="jax"), "db.jax_written")


@pytest.fixture(scope="module")
def port_table(warehouse):
    return _build(tt, PortCatalog(warehouse, commit_user="port", device="cpu"), "db.port_written")


@pytest.mark.parametrize("engine", ENGINES)
def test_jax_writes_port_reads(warehouse, jax_table, expected, engine):
    port_view = PortCatalog(warehouse, device="cpu").get_table("db.jax_written").copy({"sort-engine": engine})
    got = _read(port_view)
    assert len(got) == N
    assert got == expected
    assert got == _jax_read(jax_table.copy({"sort-engine": engine}))


@pytest.mark.parametrize("engine", ENGINES)
def test_port_writes_jax_reads(warehouse, port_table, expected, engine):
    jax_view = JaxCatalog(warehouse).get_table("db.port_written").copy({"sort-engine": engine})
    assert _jax_read(jax_view) == expected


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("tile", [TILE, 8 << 20])
def test_port_writes_port_reads(port_table, expected, engine, tile):
    got = _read(port_table.copy({"sort-engine": engine, "merge.read-batch-rows": str(tile)}))
    assert got == expected


def _metadata(store):
    """Per-snapshot, per-file metadata that must not depend on which
    package wrote the table (file names and times aside)."""
    plan = store.new_scan().plan()
    out = []
    for e in sorted(plan.entries, key=lambda e: e.file.min_sequence_number):
        f = e.file
        out.append((e.kind, e.partition, e.bucket, e.total_buckets, f.row_count, f.min_key, f.max_key,
                    f.min_sequence_number, f.max_sequence_number, f.level, f.schema_id, f.delete_row_count,
                    {k: (s.min, s.max, s.null_count, s.row_count) for k, s in f.key_stats.items()},
                    {k: (s.min, s.max, s.null_count, s.row_count) for k, s in f.value_stats.items()}))
    snap = plan.snapshot
    return snap.id, snap.total_record_count, snap.commit_kind.value, out


def test_metadata_matches_across_packages(warehouse, jax_table, port_table):
    """Snapshots, manifests and DataFileMeta (keys, stats, sequence ranges)
    of the two tables are the same, read back by either package."""
    j = _metadata(JaxCatalog(warehouse).get_table("db.port_written").store)
    p = _metadata(PortCatalog(warehouse, device="cpu").get_table("db.jax_written").store)
    jj = _metadata(jax_table.store)
    assert [int(x[0]) for x in j[3]] == [int(x[0]) for x in jj[3]]
    assert j[:3] == jj[:3] == p[:3] == (RUNS + 1, N + N_UP, "APPEND")
    strip = lambda rows: [tuple(r[1:]) for r in rows]  # noqa: E731 - FileKind enums differ per package
    assert strip(j[3]) == strip(jj[3]) == strip(p[3])


# ---------------------------------------------------------------------------
# parquet container against pyarrow
# ---------------------------------------------------------------------------


def _port_batch(n: int, seed: int):
    rng = np.random.default_rng(seed)
    schema = tt.RowType.of(
        ("i8", tt.TINYINT()),
        ("i32", tt.INT()),
        ("i64", tt.BIGINT()),
        ("f64", tt.DOUBLE()),
        ("flag", tt.BOOLEAN()),
        ("low", tt.STRING()),
        ("high", tt.STRING()),
    )
    data = {
        "i8": [None if i % 7 == 0 else int(v) for i, v in enumerate(rng.integers(-128, 128, n))],
        "i32": rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(np.int32),
        "i64": [None if i % 5 == 0 else int(v) for i, v in enumerate(rng.integers(-(1 << 62), 1 << 62, n))],
        "f64": rng.standard_normal(n),
        "flag": [None if i % 4 == 0 else bool(v) for i, v in enumerate(rng.integers(0, 2, n))],
        "low": np.array([f"k{int(v)}" for v in rng.integers(0, 9, n)], dtype=object),
        "high": np.array([None if i % 6 == 0 else f"v-{i}-é" for i in range(n)], dtype=object),
    }
    return tt.ColumnBatch.from_pydict(schema, data), schema


@pytest.mark.parametrize("n", [1, 1000, 70_000])
def test_pyarrow_reads_port_parquet(n):
    batch, _ = _port_batch(n, n)
    table = pq.read_table(io.BytesIO(write_parquet(batch, "none")))
    assert table.schema.field("i8").type == pa.int8()
    assert table.schema.field("low").type == pa.string()
    for name in batch.schema.field_names:
        assert table.column(name).to_pylist() == batch.column(name).to_pylist(), name


@pytest.mark.parametrize("use_dictionary", [True, False])
@pytest.mark.parametrize("page_version", ["1.0", "2.0"])
@pytest.mark.parametrize("page_size", [1 << 20, 4096])
def test_port_reads_pyarrow_parquet(use_dictionary, page_version, page_size):
    batch, schema = _port_batch(30_000, 5)
    arrow = pa.table(
        {
            "i8": pa.array(batch.column("i8").to_pylist(), pa.int8()),
            "i32": pa.array(batch.column("i32").to_pylist(), pa.int32()),
            "i64": pa.array(batch.column("i64").to_pylist(), pa.int64()),
            "f64": pa.array(batch.column("f64").to_pylist(), pa.float64()),
            "flag": pa.array(batch.column("flag").to_pylist(), pa.bool_()),
            "low": pa.array(batch.column("low").to_pylist(), pa.string()),
            "high": pa.array(batch.column("high").to_pylist(), pa.string()),
        }
    )
    buf = io.BytesIO()
    # the small page size also caps the dictionary page, so dictionary
    # chunks fall back to PLAIN pages part way through
    pq.write_table(arrow, buf, compression="none", use_dictionary=use_dictionary,
                   data_page_version=page_version, data_page_size=page_size, row_group_size=12_000,
                   dictionary_pagesize_limit=max(page_size, 8192))
    parts = read_parquet(buf.getvalue(), schema, schema.field_names)
    assert [p.num_rows for p in parts] == [12_000, 12_000, 6_000]
    for name in schema.field_names:
        got = [v for p in parts for v in p.column(name).to_pylist()]
        assert got == batch.column(name).to_pylist(), name


@pytest.mark.parametrize("use_dictionary", [True, False])
@pytest.mark.parametrize("page_version", ["1.0", "2.0"])
def test_port_reads_pyarrow_zstd_parquet(use_dictionary, page_version):
    """zstd pages at the JAX package's level 1: v1 pages and dictionary
    pages compressed whole, v2 pages after their raw level bytes."""
    batch, schema = _port_batch(30_000, 6)
    arrow = pa.table({name: batch.column(name).to_pylist() for name in ("i32", "i64", "f64", "low", "high")})
    buf = io.BytesIO()
    pq.write_table(arrow, buf, compression="zstd", compression_level=1, use_dictionary=use_dictionary,
                   data_page_version=page_version, data_page_size=8192, row_group_size=12_000)
    names = ["i32", "i64", "f64", "low", "high"]
    parts = read_parquet(buf.getvalue(), schema, names)
    for name in names:
        assert [v for p in parts for v in p.column(name).to_pylist()] == batch.column(name).to_pylist(), name


@pytest.mark.parametrize("n", [1, 70_000])
def test_pyarrow_reads_port_zstd_parquet(n):
    batch, _ = _port_batch(n, n + 1)
    data = write_parquet(batch, "zstd")
    meta = pq.ParquetFile(io.BytesIO(data)).metadata
    assert {meta.row_group(0).column(c).compression for c in range(meta.num_columns)} == {"ZSTD"}
    table = pq.read_table(io.BytesIO(data))
    for name in batch.schema.field_names:
        assert table.column(name).to_pylist() == batch.column(name).to_pylist(), name
    assert len(data) < len(write_parquet(batch, "none")) or n == 1


def test_corrupt_zstd_page_raises_parquet_format_error():
    from paimon_tpu_torch.format.parquet import ParquetFormatError

    batch, schema = _port_batch(5000, 9)
    data = bytearray(write_parquet(batch, "zstd"))
    data[data.index(b"\x28\xb5\x2f\xfd")] ^= 0xFF  # the first page's frame magic
    with pytest.raises(ParquetFormatError, match="zstd page"):
        read_parquet(bytes(data), schema, schema.field_names)


# ---------------------------------------------------------------------------
# what the port refuses, loudly
# ---------------------------------------------------------------------------


def _small_jax_table(warehouse, ident, **opts):
    return _build_small(jt, JaxCatalog(warehouse), ident, opts)


def _build_small(pkg, catalog, ident, opts):
    options = {k: v for k, v in OPTIONS.items()}
    options.update(opts)
    options = {k: v for k, v in options.items() if v is not None}
    table = catalog.create_table(ident, _row_type(pkg), primary_keys=["id"], options=options)
    for ids in (np.arange(0, 100, dtype=np.int64), np.arange(50, 150, dtype=np.int64)):
        wb = table.new_batch_write_builder()
        w = wb.new_write()
        w.write(_values(ids, False))
        wb.new_commit().commit(w.prepare_commit())
    return table


@pytest.mark.parametrize("option", ["file.compression", "manifest.compression"])
def test_compressed_tables_raise_naming_the_option(warehouse, option):
    """A table the JAX package writes with `option` at its default (zstd)
    and the other codec off: the port reads the same rows as the JAX
    package does."""
    ident = f"db.zstd_{option.split('.')[0]}"
    jax_table = _small_jax_table(warehouse, ident, **{option: None})
    want = [tuple(_py(v) for v in row) for row in zip(*[list(c) for c in _values(np.arange(150), False).values()])]
    assert _read(PortCatalog(warehouse, device="cpu").get_table(ident)) == want == _jax_read(jax_table)


@pytest.mark.parametrize(
    "option, value", [("file.compression", "snappy"), ("file.compression", "lz4"), ("manifest.format", "avro")]
)
def test_unported_codecs_raise_naming_the_option(warehouse, option, value):
    """A table the JAX package writes under `option`: snappy pages and Avro
    manifests are ported, and the port reads the JAX package's rows; lz4 is
    not, and its read raises naming the option."""
    ident = f"db.unported_{value}"
    jax_table = _small_jax_table(warehouse, ident, **{option: value, "manifest.compression": None})
    port_table = PortCatalog(warehouse, device="cpu").get_table(ident)
    if value == "lz4":
        with pytest.raises(NotImplementedError, match=option.replace(".", r"\.")):
            _read(port_table)
        return
    want = [tuple(_py(v) for v in row) for row in zip(*[list(c) for c in _values(np.arange(150), False).values()])]
    assert _read(port_table) == want == _jax_read(jax_table)


def test_write_requires_write_only(warehouse):
    """write-only=false (the default) no longer raises: the port writes,
    compacts once the sorted runs pass the trigger, commits that commit as
    APPEND + COMPACT, and both packages read the oracle's rows."""
    from paimon_tpu_torch.core.snapshot import SnapshotManager

    cat = PortCatalog(warehouse, device="cpu")
    table = cat.create_table("db.compacting", _row_type(tt), primary_keys=["id"],
                             options={**OPTIONS, "write-only": "false", "num-sorted-run.compaction-trigger": "2"})
    kinds = []
    for ids in (np.arange(0, 100), np.arange(50, 150), np.arange(140, 200)):
        wb = table.new_batch_write_builder()
        w = wb.new_write()
        w.write(_values(ids.astype(np.int64), False))
        sids = wb.new_commit().commit(w.prepare_commit())
        kinds.append([SnapshotManager(table.file_io, table.path).snapshot(i).commit_kind.value for i in sids])
    assert kinds == [["APPEND"], ["APPEND"], ["APPEND", "COMPACT"]]
    assert {f.level for f in table.store.restore_files((), 0)} == {table.store.options.num_levels - 1}
    want = [tuple(_py(v) for v in row) for row in zip(*[list(c) for c in _values(np.arange(200), False).values()])]
    assert _read(cat.get_table("db.compacting")) == want == _jax_read(JaxCatalog(warehouse).get_table("db.compacting"))


def test_compressed_write_option_raises(warehouse):
    cat = PortCatalog(warehouse, device="cpu")
    table = cat.create_table("db.lz4_write", _row_type(tt), primary_keys=["id"],
                             options={**OPTIONS, "file.compression": "lz4"})
    w = table.new_batch_write_builder().new_write()
    w.write(_values(np.arange(10, dtype=np.int64), False))
    with pytest.raises(NotImplementedError, match=r"file\.compression"):
        w.prepare_commit()


def test_per_level_codec_the_port_lacks_raises(warehouse):
    cat = PortCatalog(warehouse, device="cpu")
    table = cat.create_table("db.per_level_lz4", _row_type(tt), primary_keys=["id"],
                             options={**OPTIONS, "file.compression.per.level": "0:lz4"})
    w = table.new_batch_write_builder().new_write()
    with pytest.raises(NotImplementedError, match=r"file\.compression\.per\.level"):
        w.write(_values(np.arange(10, dtype=np.int64), False))


# ---------------------------------------------------------------------------
# tables at the JAX package's default options: zstd pages, zstd manifests
# ---------------------------------------------------------------------------

DEFAULTS = {k: v for k, v in OPTIONS.items() if k not in ("file.compression", "manifest.compression")}
DEFAULT_WRITERS = ["jax-arrow", "jax-native", "port"]


@pytest.fixture(scope="module")
def default_tables(warehouse):
    """The 20,000-row table at default codec options, written by each
    package (the JAX package with each of its Parquet encoders)."""
    out = {}
    for writer in DEFAULT_WRITERS:
        ident = f"db.defaults_{writer.replace('-', '_')}"
        if writer == "port":
            _build(tt, PortCatalog(warehouse, commit_user="port", device="cpu"), ident, _defaults())
        else:
            _build(jt, JaxCatalog(warehouse, commit_user="jax"), ident,
                   _defaults(**{"format.parquet.encoder": writer.split("-")[1]}))
        out[writer] = ident
    return out


def _defaults(**extra):
    return {k: None for k in ("file.compression", "manifest.compression")} | extra


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("writer", DEFAULT_WRITERS)
def test_default_options_read_the_same_rows(warehouse, default_tables, expected, writer, engine):
    """zstd tables, written by either package, read the same rows in both."""
    ident = default_tables[writer]
    got = _read(PortCatalog(warehouse, device="cpu").get_table(ident).copy({"sort-engine": engine}))
    assert got == expected
    assert _jax_read(JaxCatalog(warehouse).get_table(ident).copy({"sort-engine": engine})) == expected


@pytest.mark.parametrize("writer", DEFAULT_WRITERS)
def test_default_options_files_are_zstd(warehouse, default_tables, writer):
    """Every manifest and manifest list is one zstd frame, and every data
    file's column chunks are ZSTD, whichever package wrote them."""
    path = PortCatalog(warehouse, device="cpu").get_table(default_tables[writer]).path
    manifests = [n for n in os.listdir(f"{path}/manifest") if n.startswith("manifest")]
    assert manifests
    for name in manifests:
        with open(f"{path}/manifest/{name}", "rb") as f:
            assert f.read(4) == b"\x28\xb5\x2f\xfd", name
    data_files = [n for n in os.listdir(f"{path}/bucket-0") if n.endswith(".parquet")]
    assert len(data_files) == RUNS + 1
    for name in data_files:
        meta = pq.ParquetFile(f"{path}/bucket-0/{name}").metadata
        codecs = {meta.row_group(g).column(c).compression for g in range(meta.num_row_groups)
                  for c in range(meta.num_columns)}
        assert codecs == {"ZSTD"}, name


def test_default_options_metadata_matches_across_packages(warehouse, default_tables):
    """At default options, too, snapshots, manifests and DataFileMeta are
    the same across packages, read back by either package."""
    port_written = _metadata(JaxCatalog(warehouse).get_table(default_tables["port"]).store)
    jax_written = _metadata(PortCatalog(warehouse, device="cpu").get_table(default_tables["jax-arrow"]).store)
    jax_own = _metadata(JaxCatalog(warehouse).get_table(default_tables["jax-arrow"]).store)
    assert port_written[:3] == jax_written[:3] == jax_own[:3] == (RUNS + 1, N + N_UP, "APPEND")
    strip = lambda rows: [tuple(r[1:]) for r in rows]  # noqa: E731 - FileKind enums differ per package
    assert strip(port_written[3]) == strip(jax_written[3]) == strip(jax_own[3])


def test_port_zstd_files_are_smaller_than_uncompressed(warehouse, default_tables, port_table):
    """The same rows written by the port take fewer bytes under zstd."""
    def data_bytes(ident):
        path = PortCatalog(warehouse, device="cpu").get_table(ident).path
        return sum(os.path.getsize(f"{path}/bucket-0/{n}") for n in os.listdir(f"{path}/bucket-0"))

    assert data_bytes(default_tables["port"]) < data_bytes("db.port_written")


# ---------------------------------------------------------------------------
# tables the port would read wrongly: guarded until ported
# ---------------------------------------------------------------------------


def test_deletion_vectors_raise_naming_the_option(warehouse):
    """The JAX package deletes id 1 through a deletion vector. The port,
    which once refused such a table, now applies the vector: it reads the
    JAX package's rows, with deletion-vectors.enabled and, as the JAX
    package does, with the option off (the snapshot's index manifest holds
    the vectors either way)."""
    from paimon_tpu.data.predicate import equal

    ident = "db.deletion_vectors"
    table = JaxCatalog(warehouse).create_table(ident, _row_type(jt), primary_keys=["id"],
                                               options={"bucket": "1", "deletion-vectors.enabled": "true"})
    for ids, upsert in ((np.array([1, 2, 3]), False), (np.array([2]), True)):
        wb = table.new_batch_write_builder()
        w = wb.new_write()
        w.write(_values(ids.astype(np.int64), upsert))
        wb.new_commit().commit(w.prepare_commit())
    assert table.delete_where(equal("id", 1)) == 1
    assert [r[0] for r in _jax_read(table)] == [2, 3]
    port_table = PortCatalog(warehouse, device="cpu").get_table(ident)
    assert _read(port_table) == _jax_read(table)
    off = {"deletion-vectors.enabled": "false"}
    assert _read(port_table.copy(off)) == _jax_read(table.copy(off)) == _jax_read(table)


@pytest.fixture(scope="module")
def travel_table(warehouse):
    """Two commits by the JAX package, 50 ms apart; tag t1 and branch b1 at
    snapshot 1."""
    import time

    from paimon_tpu.table.branch import BranchManager

    table = JaxCatalog(warehouse).create_table("db.travel", _row_type(jt), primary_keys=["id"], options=dict(DEFAULTS))
    for ids, upsert in ((np.arange(0, 100), False), (np.arange(50, 150), True)):
        wb = table.new_batch_write_builder()
        w = wb.new_write()
        w.write(_values(ids.astype(np.int64), upsert))
        wb.new_commit().commit(w.prepare_commit())
        time.sleep(0.05)
    table.create_tag("t1", 1)
    BranchManager(table.file_io, table.path).create("b1", from_snapshot=1)
    return table


def _travel_options(table) -> dict:
    import datetime

    t1 = table.store.snapshot_manager.snapshot(1).time_millis + 10
    return {
        "scan.snapshot-id": "1",
        "scan.timestamp-millis": str(t1),
        "scan.timestamp": datetime.datetime.fromtimestamp(t1 / 1000).isoformat(sep=" "),
        "scan.tag-name": "t1",
        "scan.version": "t1",
        "scan.watermark": "0",
        "scan.file-creation-time-millis": str(t1),
        "scan.mode": "from-snapshot",
        "branch": "b1",
    }


# the JAX package reads snapshot 1 (or only its later files) under these;
# scan.watermark (no snapshot has one here) and scan.mode do not move a
# batch read of the JAX package, and the port's reads follow it
_TRAVELS = {"scan.snapshot-id", "scan.timestamp-millis", "scan.timestamp", "scan.tag-name", "scan.version",
            "scan.file-creation-time-millis", "branch"}


@pytest.mark.parametrize("key", ["scan.snapshot-id", "scan.timestamp-millis", "scan.timestamp", "scan.tag-name",
                                 "scan.version", "scan.watermark", "scan.file-creation-time-millis", "scan.mode",
                                 "branch"])
def test_time_travel_options_raise_naming_the_option(warehouse, travel_table, key):
    """Each option that selects another snapshot, branch or file set reads
    the JAX package's rows through the same entry point: copy({key: value})
    for the scan options; branch_table and load_table for a branch, whose
    copy({"branch": ...}) reads main in both packages."""
    from paimon_tpu.table import load_table as jax_load_table
    from paimon_tpu.table.branch import branch_table as jax_branch_table
    from paimon_tpu_torch.table import load_table
    from paimon_tpu_torch.table.branch import branch_table

    value = _travel_options(travel_table)[key]
    latest = _jax_read(travel_table)
    port_table = PortCatalog(warehouse, device="cpu").get_table("db.travel")
    if key == "branch":
        want = _jax_read(jax_branch_table(travel_table, value))
        assert _read(branch_table(port_table, value)) == want
        path = travel_table.path
        assert _read(load_table(path, dynamic_options={key: value}, device="cpu")) == want
        assert _jax_read(jax_load_table(path, dynamic_options={key: value})) == want
        # copy only merges the option: both packages still read main
        assert _read(port_table.copy({key: value})) == _jax_read(travel_table.copy({key: value})) == latest
    else:
        want = _jax_read(travel_table.copy({key: value}))
        assert _read(port_table.copy({key: value})) == want
    assert (want != latest) == (key in _TRAVELS)


def test_scan_snapshot_id_of_the_latest_snapshot_reads(warehouse, travel_table):
    port_view = PortCatalog(warehouse, device="cpu").get_table("db.travel").copy({"scan.snapshot-id": "2"})
    assert _read(port_view) == _jax_read(travel_table)


def test_rowkind_field_raises_naming_the_option(warehouse):
    """With rowkind.field each row's kind comes from a column: a table the
    JAX package wrote that way reads the same in the port, and the port,
    which once refused rowkind.field, continues it with the same rule (a -D
    in the op column deletes its key) and writes what the JAX package
    reads."""
    ident = "db.rowkind"
    row_type = jt.RowType.of(("id", jt.BIGINT(False)), ("v", jt.BIGINT()), ("op", jt.STRING()))
    table = JaxCatalog(warehouse).create_table(ident, row_type, primary_keys=["id"],
                                               options={**DEFAULTS, "rowkind.field": "op"})
    for data in ({"id": [1, 2], "v": [10, 20], "op": ["+I", "+I"]}, {"id": [1], "v": [10], "op": ["-D"]}):
        wb = table.new_batch_write_builder()
        w = wb.new_write()
        w.write(data)
        wb.new_commit().commit(w.prepare_commit())
    assert [r[0] for r in _jax_read(table)] == [2]
    port_table = PortCatalog(warehouse, device="cpu").get_table(ident)
    assert _read(port_table) == _jax_read(table) == [(2, 20, "+I")]
    for data in ({"id": [3, 2], "v": [30, 21], "op": ["+I", "+U"]}, {"id": [2, 1], "v": [21, 11], "op": ["-D", "+I"]}):
        wb = port_table.new_batch_write_builder()
        w = wb.new_write()
        w.write(data)
        wb.new_commit().commit(w.prepare_commit())
    assert _read(port_table) == _jax_read(JaxCatalog(warehouse).get_table(ident)) == [(1, 11, "+I"), (3, 30, "+I")]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_deletes_cross_packages(warehouse, writer):
    """-D rows win the dedup and vanish from reads, whichever package wrote
    them and whichever reads."""
    ident = f"db.deletes_{writer}"
    pkg, cat = (tt, PortCatalog(warehouse, device="cpu")) if writer == "port" else (jt, JaxCatalog(warehouse))
    table = cat.create_table(ident, _row_type(pkg), primary_keys=["id"], options=dict(OPTIONS))
    gone = np.arange(10, 20, dtype=np.int64)
    for ids, kinds in ((np.arange(100, dtype=np.int64), None), (gone, ["-D"] * len(gone))):
        wb = table.new_batch_write_builder()
        w = wb.new_write()
        w.write(_values(ids, False), kinds)
        wb.new_commit().commit(w.prepare_commit())
    keep = np.setdiff1d(np.arange(100), gone)
    want = [tuple(_py(v) for v in row) for row in zip(*[list(c) for c in _values(keep, False).values()])]
    for engine in ENGINES:
        assert _read(PortCatalog(warehouse, device="cpu").get_table(ident).copy({"sort-engine": engine})) == want
        assert _jax_read(JaxCatalog(warehouse).get_table(ident).copy({"sort-engine": engine})) == want


def test_commit_retries_after_losing_the_snapshot_race(warehouse, monkeypatch):
    """Two committers race for snapshot-1: the loser cleans its round's
    manifests and lands as snapshot-2; both packages then read both rows."""
    from paimon_tpu_torch.core import manifest as port_manifest

    cat = PortCatalog(warehouse, device="cpu")
    table = cat.create_table("db.race", _row_type(tt), primary_keys=["id"], options=dict(OPTIONS))

    def prepared(ids):
        wb = table.new_batch_write_builder()
        w = wb.new_write()
        w.write(_values(np.asarray(ids, dtype=np.int64), False))
        return wb.new_commit(), w.prepare_commit()

    loser_commit, loser_msgs = prepared([1])
    rival_commit, rival_msgs = prepared([2])
    real_write = port_manifest.ManifestList.write
    raced = []

    def write_then_let_the_rival_win(self, metas, track=None):
        name = real_write(self, metas, track)
        if not raced:
            raced.append(name)
            assert rival_commit.commit(rival_msgs) == [1]
        return name

    monkeypatch.setattr(port_manifest.ManifestList, "write", write_then_let_the_rival_win)
    assert loser_commit.commit(loser_msgs) == [2]
    monkeypatch.undo()
    assert not os.path.exists(f"{table.path}/manifest/{raced[0]}")  # the lost round's list is gone
    want = [tuple(_py(v) for v in row) for row in zip(*[list(c) for c in _values(np.array([1, 2]), False).values()])]
    assert _read(cat.get_table("db.race")) == want
    assert _jax_read(JaxCatalog(warehouse).get_table("db.race")) == want


@pytest.mark.parametrize("nulls", [False, True])
def test_port_reads_delta_binary_packed(nulls):
    rng = np.random.default_rng(11)
    n = 5000
    i64 = np.cumsum(rng.integers(-(1 << 40), 1 << 40, n))
    i32 = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(np.int32)
    mask = (np.arange(n) % 9 == 0) if nulls else None
    arrow = pa.table({"i64": pa.array(i64, mask=mask), "i32": pa.array(i32, mask=mask)})
    buf = io.BytesIO()
    pq.write_table(arrow, buf, compression="none", use_dictionary=False,
                   column_encoding={"i64": "DELTA_BINARY_PACKED", "i32": "DELTA_BINARY_PACKED"})
    schema = tt.RowType.of(("i64", tt.BIGINT()), ("i32", tt.INT()))
    (part,) = read_parquet(buf.getvalue(), schema, ["i64", "i32"])
    for name in ("i64", "i32"):
        assert part.column(name).to_pylist() == arrow.column(name).to_pylist()


def test_port_reads_jax_native_encoder_table(warehouse, expected):
    """The JAX package's own parquet encoder (DELTA for sorted integers,
    dictionary pages from its merge pools) is readable by the port."""
    jax_table = _build(jt, JaxCatalog(warehouse), "db.jax_native_encoder", {"format.parquet.encoder": "native"})
    got = _read(PortCatalog(warehouse, device="cpu").get_table("db.jax_native_encoder"))
    assert got == expected == _jax_read(jax_table)
