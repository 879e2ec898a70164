"""The reference's Avro files in the port (paimon_tpu_torch) against the JAX
package, on the CPU (device="cpu" for the port).

Covered, each way (one package writes, the other reads):
- BinaryRow bytes (interop/binary_row.py), equal to the JAX package's;
- Avro object-container records (interop/avro_io.py) under the manifest
  schemas, both codecs;
- Avro data files (format/avro.py: file.format=avro and
  file.format.per.level), at the format level and as tables, with a
  primary-key table merged through the port's xla-segmented and numpy
  engines;
- Avro manifests (manifest.format=avro): every manifest and manifest list
  decoded by both packages to the same entries, field for field, across a
  partitioned table, a compaction, schema evolution and a branch;
- `_KEY_` data files (data-file.include-key-columns).
They mirror tests/test_interop.py and tests/test_formats_aux.py.

Tolerance: exact. Every value is copied, never computed.
"""

import glob
import io
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import paimon_tpu as jt
import paimon_tpu_torch as tt
from paimon_tpu.catalog import FileSystemCatalog as JaxCatalog
from paimon_tpu.core.manifest import ManifestFile as JaxManifestFile
from paimon_tpu.core.manifest import ManifestList as JaxManifestList
from paimon_tpu.format import get_format
from paimon_tpu.fs import LocalFileIO as JaxIO
from paimon_tpu.interop import avro_io as javro_io
from paimon_tpu.interop import binary_row as jbr
from paimon_tpu.interop.golden import manifest_entry_schema as jax_entry_schema
from paimon_tpu_torch.catalog import FileSystemCatalog as PortCatalog
from paimon_tpu_torch.core.manifest import ManifestFile as PortManifestFile
from paimon_tpu_torch.core.manifest import ManifestList as PortManifestList
from paimon_tpu_torch.format.avro import read_avro, write_avro
from paimon_tpu_torch.fs import LocalFileIO as PortIO
from paimon_tpu_torch.interop import avro_io as pavro_io
from paimon_tpu_torch.interop import binary_row as pbr
from paimon_tpu_torch.interop.golden import manifest_entry_schema, manifest_meta_schema

PKGS = ("jax", "port")


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


def _mod(pkg):
    return jt if pkg == "jax" else tt


def _catalog(pkg, warehouse):
    if pkg == "jax":
        return JaxCatalog(warehouse, commit_user=pkg)
    return PortCatalog(warehouse, commit_user=pkg, device="cpu")


def _other(pkg):
    return "port" if pkg == "jax" else "jax"


def _py(v):
    return v.item() if hasattr(v, "item") else v


def _read(table, predicate=None) -> list[tuple]:
    rb = table.new_read_builder()
    if predicate is not None:
        rb = rb.with_filter(predicate)
    return sorted(tuple(_py(v) for v in row) for row in rb.new_read().read_all(rb.new_scan().plan()).to_pylist())


def _write(table, data) -> None:
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.write(data)
    wb.new_commit().commit(w.prepare_commit())


def _stats(stats: dict) -> dict:
    return {k: (v.min, v.max, v.null_count, v.row_count) for k, v in stats.items()}


def _entry(e) -> tuple:
    f = e.file
    return (int(e.kind), e.partition, e.bucket, e.total_buckets, f.file_name, f.file_size, f.row_count, f.min_key,
            f.max_key, _stats(f.key_stats), _stats(f.value_stats), f.min_sequence_number, f.max_sequence_number,
            f.schema_id, f.level, f.delete_row_count, f.creation_time_millis, f.file_source, tuple(f.extra_files),
            f.embedded_index)


def _meta(m) -> tuple:
    return (m.file_name, m.file_size, m.num_added_files, m.num_deleted_files, m.schema_id)


def _same_manifests(root: str) -> int:
    """Every manifest and manifest list under `root`/manifest is Avro and
    decodes to the same entries in both packages; returns how many."""
    directory = f"{root}/manifest"
    names = sorted(os.path.basename(p) for p in glob.glob(f"{directory}/manifest-*"))
    assert names
    for name in names:
        with open(f"{directory}/{name}", "rb") as f:
            assert f.read(4) == b"Obj\x01", name
        if name.startswith("manifest-list-"):
            got = [_meta(m) for m in PortManifestList(PortIO(), directory).read(name)]
            want = [_meta(m) for m in JaxManifestList(JaxIO(), directory).read(name)]
        else:
            got = [_entry(e) for e in PortManifestFile(PortIO(), directory).read(name)]
            want = [_entry(e) for e in JaxManifestFile(JaxIO(), directory).read(name)]
        assert got == want, name
    return len(names)


# ---------------------------------------------------------------------------
# BinaryRow and the OCF record codec (tests/test_interop.py:20, :50)
# ---------------------------------------------------------------------------

ROW_CASES = [
    [1, 2, 3.5, "abc", "a-long-string-beyond-seven-bytes", True],
    [None, -7, None, "", "1234567", False],  # exactly 7 bytes: inline
    [2**62, -(2**31), -0.0, "12345678", None, None],  # exactly 8: the var part
    [-1, 0, float("inf"), "東京", "Zürich-and-more", True],
]


def _row_types(pkg):
    m = _mod(pkg)
    return [m.BIGINT(), m.INT(), m.DOUBLE(), m.STRING(), m.STRING(), m.BOOLEAN()]


@pytest.mark.parametrize("case", range(len(ROW_CASES)))
def test_binary_row_bytes_equal_the_jax_package(case):
    values = ROW_CASES[case]
    enc = pbr.encode_binary_row(values, _row_types("port"))
    assert enc == jbr.encode_binary_row(values, _row_types("jax"))
    ser = pbr.serialize_binary_row(values, _row_types("port"))
    assert ser == jbr.serialize_binary_row(values, _row_types("jax"))
    assert pbr.deserialize_binary_row(jbr.serialize_binary_row(values, _row_types("jax")), _row_types("port")) == values
    assert jbr.deserialize_binary_row(ser, _row_types("jax")) == values


def test_binary_row_layout_invariants():
    enc = pbr.encode_binary_row([5], [tt.BIGINT()])
    assert len(enc) == 16 and enc[8:16] == (5).to_bytes(8, "little")
    assert pbr.encode_binary_row([None], [tt.BIGINT()])[1] & 1  # field 0's null bit is bit 8
    enc_s = pbr.encode_binary_row(["hi"], [tt.STRING()])
    assert enc_s[8:10] == b"hi" and enc_s[15] == 0x80 | 2
    assert pbr.encode_binary_row([], []) == b"\x00" * 8


def _entry_record():
    return {
        "_VERSION": 2,
        "_KIND": 0,
        "_PARTITION": pbr.serialize_binary_row([], []),
        "_BUCKET": 3,
        "_TOTAL_BUCKETS": 8,
        "_FILE": {
            "_FILE_NAME": "data-x-0.parquet",
            "_FILE_SIZE": 12345,
            "_ROW_COUNT": 100,
            "_MIN_KEY": pbr.serialize_binary_row([1], [tt.BIGINT()]),
            "_MAX_KEY": pbr.serialize_binary_row([99], [tt.BIGINT()]),
            "_KEY_STATS": {"_MIN_VALUES": b"\x00" * 12, "_MAX_VALUES": b"\x01" * 12, "_NULL_COUNTS": [0, None, 5]},
            "_VALUE_STATS": {"_MIN_VALUES": b"", "_MAX_VALUES": b"", "_NULL_COUNTS": None},
            "_MIN_SEQUENCE_NUMBER": 0,
            "_MAX_SEQUENCE_NUMBER": 99,
            "_SCHEMA_ID": 0,
            "_LEVEL": 5,
            "_EXTRA_FILES": ["a.index"],
            "_CREATION_TIME": 1700000000000,
            "_DELETE_ROW_COUNT": None,
            "_EMBEDDED_FILE_INDEX": None,
            "_FILE_SOURCE": 1,
        },
    }


@pytest.mark.parametrize("codec", ["deflate", "null"])
@pytest.mark.parametrize("writer", PKGS)
def test_ocf_records_decode_each_way(codec, writer):
    assert manifest_entry_schema() == jax_entry_schema()
    entry = _entry_record()
    write_ocf = (javro_io if writer == "jax" else pavro_io).write_ocf
    read_ocf = (pavro_io if writer == "jax" else javro_io).read_ocf
    data = write_ocf(manifest_entry_schema(), [entry, entry], codec=codec)
    schema, records = read_ocf(data)
    assert schema == manifest_entry_schema() and records == [entry, entry]
    meta = {"_VERSION": 2, "_FILE_NAME": "manifest-1", "_FILE_SIZE": 10, "_NUM_ADDED_FILES": 1,
            "_NUM_DELETED_FILES": 0, "_PARTITION_STATS": {"_MIN_VALUES": b"", "_MAX_VALUES": b"", "_NULL_COUNTS": []},
            "_SCHEMA_ID": 0}
    assert read_ocf(write_ocf(manifest_meta_schema(), [meta], codec=codec))[1] == [meta]


# ---------------------------------------------------------------------------
# Avro data files (tests/test_formats_aux.py:17, :40, :119, :139)
# ---------------------------------------------------------------------------


def _format_schema(pkg):
    m = _mod(pkg)
    return m.RowType.of(("id", m.BIGINT(False)), ("name", m.STRING()), ("v", m.DOUBLE()), ("ok", m.BOOLEAN()),
                        ("i", m.INT()), ("f", m.FLOAT()), ("b", m.BYTES()))


def _format_rows(n=200, seed=3) -> dict:
    rng = np.random.default_rng(seed)
    ids = np.arange(n, dtype=np.int64)
    return {
        "id": ids,
        "name": [None if i % 7 == 0 else f"n{int(x)}" + "é" * int(i % 3 == 1) for i, x in enumerate(rng.integers(0, 50, n))],
        "v": [None if i % 5 == 0 else float(x) for i, x in enumerate(rng.normal(size=n))],
        "ok": [None if i % 4 == 0 else bool(i % 3) for i in range(n)],
        "i": [None if i % 6 == 0 else int(x) for i, x in enumerate(rng.integers(-1000, 1000, n))],
        "f": [None if i % 9 == 0 else float(np.float32(x)) for i, x in enumerate(rng.normal(size=n))],
        "b": [None if i % 8 == 0 else bytes([i % 256, 0, 7]) for i in range(n)],
    }


@pytest.mark.parametrize("compression", ["zstd", "none"])
@pytest.mark.parametrize("writer", PKGS)
def test_avro_file_roundtrip_each_way(tmp_path, writer, compression):
    rows = _format_rows()
    path = str(tmp_path / "f.avro")
    if writer == "jax":
        batch = jt.data.ColumnBatch.from_pydict(_format_schema("jax"), rows)
        get_format("avro").write(JaxIO(), path, batch, compression)
        out = read_avro(open(path, "rb").read(), _format_schema("port"))
        proj = read_avro(open(path, "rb").read(), _format_schema("port"), ["name", "id"])
    else:
        batch = tt.data.ColumnBatch.from_pydict(_format_schema("port"), rows)
        with open(path, "wb") as f:
            f.write(write_avro(batch, compression))
        (out,) = get_format("avro").read(JaxIO(), path, _format_schema("jax"))
        (proj,) = get_format("avro").read(JaxIO(), path, _format_schema("jax"), projection=["name", "id"])
    with open(path, "rb") as f:
        head = f.read()
    assert (b"deflate" in head[:400]) == (compression == "zstd")
    assert [tuple(_py(v) for v in r) for r in out.to_pylist()] == list(zip(*rows.values()))
    assert proj.schema.field_names == ["name", "id"]
    assert [tuple(r) for r in proj.to_pylist()] == list(zip(rows["name"], rows["id"].tolist()))


def test_avro_non_string_value_in_a_string_column(tmp_path):
    """A non-string value in a VARCHAR column is written as its str(), as
    the JAX package's writer writes it."""
    from paimon_tpu_torch.data.batch import Column, ColumnBatch

    schema = tt.RowType.of(("k", tt.BIGINT(False)), ("s", tt.STRING()))
    vals = np.empty(2, dtype=object)
    vals[0], vals[1] = "ok", 12345
    batch = ColumnBatch(schema, {"k": Column(np.array([1, 2], dtype=np.int64)), "s": Column(vals)})
    path = str(tmp_path / "weird.avro")
    with open(path, "wb") as f:
        f.write(write_avro(batch))
    (out,) = get_format("avro").read(JaxIO(), path, jt.RowType.of(("k", jt.BIGINT(False)), ("s", jt.STRING())))
    assert out.to_pylist() == [(1, "ok"), (2, "12345")]
    assert read_avro(open(path, "rb").read(), schema).to_pylist() == [(1, "ok"), (2, "12345")]


@pytest.mark.parametrize("writer", PKGS)
def test_avro_skewed_string_field(tmp_path, writer):
    """One string field owning nearly all of a block's bytes takes the C
    decoder's one capacity retry."""
    rows = {"a": ["x" * 50_000, "y" * 50_000], "b": ["t", "u"], "c": ["v", "w"]}
    path = str(tmp_path / "skew.avro")
    m = _mod(writer)
    schema = m.RowType.of(("a", m.STRING()), ("b", m.STRING()), ("c", m.STRING()))
    if writer == "jax":
        get_format("avro").write(JaxIO(), path, jt.data.ColumnBatch.from_pydict(schema, rows), compression="null")
    else:
        with open(path, "wb") as f:
            f.write(write_avro(tt.data.ColumnBatch.from_pydict(schema, rows), "null"))
    port_schema = tt.RowType.of(("a", tt.STRING()), ("b", tt.STRING()), ("c", tt.STRING()))
    assert read_avro(open(path, "rb").read(), port_schema).to_pylist() == list(zip(*rows.values()))


def _multi_block_ocf(schema: dict, chunks: list) -> bytes:
    """An OCF of one block per chunk of records, as other writers make
    them."""
    out = bytearray(javro_io.write_ocf(schema, [], codec="null"))  # header and sync, no block
    sync = bytes(out[-16:])
    for recs in chunks:
        body = bytearray()
        for r in recs:
            javro_io._encode(body, schema, r)
        javro_io._write_long(out, len(recs))
        javro_io._write_long(out, len(body))
        out += body + sync
    return bytes(out)


def test_avro_multi_block_file_and_nested_fields_take_the_python_loop():
    """A container of several blocks reads block after block; a file with a
    field outside the flat envelope takes the Python loop, which refuses
    the nested field."""
    schema = {"type": "record", "name": "record", "fields": [{"name": "k", "type": "long"},
                                                               {"name": "s", "type": ["null", "string"]}]}
    recs = [{"k": i, "s": None if i % 3 == 0 else f"s{i}"} for i in range(10)]
    data = _multi_block_ocf(schema, [recs[:4], recs[4:7], recs[7:]])
    out = read_avro(data, tt.RowType.of(("k", tt.BIGINT(False)), ("s", tt.STRING())))
    assert out.to_pylist() == [(r["k"], r["s"]) for r in recs]
    nested = {"type": "record", "name": "record", "fields": [{"name": "k", "type": "long"},
                                                             {"name": "xs", "type": {"type": "array", "items": "long"}}]}
    bad = javro_io.write_ocf(nested, [{"k": 1, "xs": [1, 2]}], codec="null")
    with pytest.raises(ValueError, match="envelope"):
        read_avro(bad, tt.RowType.of(("k", tt.BIGINT(False)), ("xs", tt.BIGINT())))


def _kv_schema(pkg):
    m = _mod(pkg)
    return m.RowType.of(("k", m.BIGINT(False)), ("s", m.STRING()), ("d", m.DOUBLE()))


@pytest.mark.parametrize("writer", PKGS)
def test_avro_table_end_to_end(tmp_path, writer):
    """A primary-key table in Avro data files (and per-level: Avro at level
    0, parquet below), written by one package over four overlapping
    commits and a full compaction, merged by the other (the port at its
    xla-segmented and numpy engines) to the writer's rows."""
    wh = str(tmp_path)
    for fmt, opts in (("avro", {"file.format": "avro"}), ("per_level", {"file.format.per.level": "0:avro"})):
        ident = f"db.av_{fmt}"
        t = _catalog(writer, wh).create_table(ident, _kv_schema(writer), primary_keys=["k"],
                                              options={"bucket": "1", "num-sorted-run.compaction-trigger": "3", **opts})
        rng = np.random.default_rng(11)
        last = {}
        for r in range(4):
            ks = rng.permutation(60)[:40].astype(np.int64)
            rows = {"k": ks, "s": [None if k % 7 == 0 else f"v{r}-{k}" for k in ks], "d": ks * 0.5 + r}
            _write(t, rows)
            last.update({int(k): (int(k), s, float(d)) for k, s, d in zip(*rows.values())})
        exts = {os.path.basename(p).rsplit(".", 1)[-1] for p in glob.glob(f"{t.path}/bucket-0/data-*")}
        assert exts == ({"avro"} if fmt == "avro" else {"avro", "parquet"})
        want = sorted(last.values())
        assert _read(t) == want
        other = _catalog(_other(writer), wh).get_table(ident)
        assert _read(other) == want
        port = _catalog("port", wh).get_table(ident)
        for engine in ("xla-segmented", "numpy"):
            assert _read(port.copy({"sort-engine": engine})) == want


# ---------------------------------------------------------------------------
# Avro manifests (tests/test_interop.py:181, :237, :317)
# ---------------------------------------------------------------------------


def _part_schema(pkg):
    m = _mod(pkg)
    return m.RowType.of(("pt", m.STRING()), ("id", m.BIGINT(False)), ("v", m.DOUBLE()))


@pytest.mark.parametrize("compression", ["default", "none"])
@pytest.mark.parametrize("writer", PKGS)
def test_avro_manifests_each_way(tmp_path, writer, compression):
    """manifest.format=avro on a partitioned 2-bucket table: every manifest
    and list is an Avro OCF under the reference's record name, both
    packages decode each to the same entries, partition and key pruning
    work over the Avro stats, and a compaction traverses them."""
    from paimon_tpu.data.predicate import equal as jequal
    from paimon_tpu_torch.data.predicate import equal as pequal

    wh = str(tmp_path)
    t = _catalog(writer, wh).create_table(
        "db.av", _part_schema(writer), primary_keys=["pt", "id"], partition_keys=["pt"],
        options={"bucket": "2", "manifest.format": "avro", "manifest.compression": compression})
    _write(t, {"pt": ["a", "a", "b"], "id": [1, 2, 3], "v": [1.0, 2.0, 3.0]})
    _write(t, {"pt": ["a", "b"], "id": [1, 9], "v": [10.0, 9.0]})
    with open(sorted(glob.glob(f"{t.path}/manifest/manifest-list-*"))[0], "rb") as f:
        blob = f.read()
    assert (b"deflate" in blob[:2000]) == (compression == "default")
    schema, _ = pavro_io.read_ocf(blob)
    assert schema["name"] == "org.apache.paimon.avro.generated.record"
    assert _same_manifests(t.path) >= 4
    want = [("a", 1, 10.0), ("a", 2, 2.0), ("b", 3, 3.0), ("b", 9, 9.0)]
    for pkg in PKGS:
        table = _catalog(pkg, wh).get_table("db.av")
        assert _read(table) == want
        eq = (jequal if pkg == "jax" else pequal)("pt", "b")
        assert _read(table, eq) == want[2:]
        assert {s.partition for s in table.new_read_builder().with_filter(eq).new_scan().plan()} == {("b",)}
    compactor = (jt if writer == "jax" else tt).DedicatedCompactor
    assert compactor(_catalog(writer, wh).get_table("db.av")).run_once(full=True)
    assert _same_manifests(t.path) >= 6
    for pkg in PKGS:
        assert _read(_catalog(pkg, wh).get_table("db.av")) == want


@pytest.mark.parametrize("writer", PKGS)
def test_avro_manifests_survive_schema_evolution(tmp_path, writer):
    """Positional stats decode under the schema that wrote them: after
    add_column, the schema-0 file keeps its v stats in both packages."""
    wh = str(tmp_path)
    m = _mod(writer)
    cat = _catalog(writer, wh)
    t = cat.create_table("db.evo", m.RowType.of(("id", m.BIGINT(False)), ("v", m.DOUBLE())), primary_keys=["id"],
                         options={"bucket": "1", "manifest.format": "avro"})
    _write(t, {"id": [1, 2], "v": [1.0, 2.0]})
    if writer == "jax":
        from paimon_tpu.core.schema import SchemaChange
    else:
        from paimon_tpu_torch.core.schema import SchemaChange
    cat.alter_table("db.evo", SchemaChange.add_column("extra", m.DOUBLE()))
    _write(cat.get_table("db.evo"), {"id": [3], "v": [3.0], "extra": [30.0]})
    assert _same_manifests(t.path) >= 4
    for pkg in PKGS:
        t2 = _catalog(pkg, wh).get_table("db.evo")
        assert _read(t2) == [(1, 1.0, None), (2, 2.0, None), (3, 3.0, 30.0)]
        old = [e for e in t2.store.new_scan().plan().entries if e.file.schema_id == 0]
        assert old and (old[0].file.value_stats["v"].min, old[0].file.value_stats["v"].max) == (1.0, 2.0)


@pytest.mark.parametrize("writer", PKGS)
def test_avro_manifests_with_branches(tmp_path, writer):
    """A branch resolves its own schemas for its Avro manifests: the branch
    reads and writes them, main is untouched, fast-forward brings them
    back, and both packages decode the branch's manifests alike."""
    wh = str(tmp_path)
    m = _mod(writer)
    if writer == "jax":
        from paimon_tpu.table.branch import BranchManager, branch_table
    else:
        from paimon_tpu_torch.table.branch import BranchManager, branch_table
    cat = _catalog(writer, wh)
    t = cat.create_table("db.b", m.RowType.of(("id", m.BIGINT(False)), ("v", m.DOUBLE())), primary_keys=["id"],
                         options={"bucket": "1", "manifest.format": "avro"})
    _write(t, {"id": [1, 2], "v": [1.0, 2.0]})
    bm = BranchManager(t.file_io, t.path)
    bm.create("dev")
    bt = branch_table(t, "dev")
    assert _read(bt) == [(1, 1.0), (2, 2.0)]
    _write(bt, {"id": [3], "v": [3.0]})
    assert _same_manifests(bm.branch_path("dev")) >= 4
    assert _read(bt) == [(1, 1.0), (2, 2.0), (3, 3.0)]
    assert _read(t) == [(1, 1.0), (2, 2.0)]
    bm.fast_forward("dev")
    for pkg in PKGS:
        assert _read(_catalog(pkg, wh).get_table("db.b")) == [(1, 1.0), (2, 2.0), (3, 3.0)]


# ---------------------------------------------------------------------------
# _KEY_ data files (tests/test_interop.py:272)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["parquet", "avro"])
@pytest.mark.parametrize("writer", PKGS)
def test_key_columns_each_way(tmp_path, writer, fmt):
    """data-file.include-key-columns: the writer's files lead with the
    trimmed primary key as _KEY_ columns (field ids offset by 10^9), the
    other package reads the same rows, stats and entries, and the key
    stats are those of the value columns."""
    wh = str(tmp_path)
    m = _mod(writer)
    t = _catalog(writer, wh).create_table(
        "db.ref", m.RowType.of(("pt", m.STRING()), ("id", m.BIGINT(False)), ("name", m.STRING()), ("score", m.DOUBLE())),
        primary_keys=["pt", "id"], partition_keys=["pt"],
        options={"bucket": "1", "manifest.format": "avro", "data-file.include-key-columns": "true", "file.format": fmt})
    _write(t, {"pt": ["x", "x"], "id": [1, 2], "name": ["a", "b"], "score": [1.0, 2.0]})
    _write(t, {"pt": ["x", "x"], "id": [1, 3], "name": ["a2", None], "score": [10.0, 3.0]})
    files = glob.glob(f"{t.path}/pt=x/bucket-0/data-*.{fmt}")
    assert len(files) == 2
    if fmt == "parquet":
        names = pq.ParquetFile(files[0]).schema_arrow.names
    else:
        with open(files[0], "rb") as f:
            names = [fd["name"] for fd in javro_io.read_ocf(f.read())[0]["fields"]]
    assert names == ["_KEY_id", "_SEQUENCE_NUMBER", "_VALUE_KIND", "pt", "id", "name", "score"]
    assert _same_manifests(t.path) >= 4
    want = [("x", 1, "a2", 10.0), ("x", 2, "b", 2.0), ("x", 3, None, 3.0)]
    for pkg in PKGS:
        table = _catalog(pkg, wh).get_table("db.ref")
        assert _read(table) == want
        (e,) = [e for e in table.store.new_scan().plan().entries if e.file.min_sequence_number == 0]
        assert _stats(e.file.key_stats) == {"id": (1, 2, 0, 2)}
