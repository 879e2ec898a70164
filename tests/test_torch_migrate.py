"""Migration in the port (paimon_tpu_torch/table/migrate.py and the
migrate_table, migrate_database and migrate_file procedures) against the
JAX package's, on the CPU (device="cpu" for the port).

infer_row_type reads the Parquet footer or the ORC tail where the JAX
package asks pyarrow; it is held to `ColumnBatch.row_type_from_arrow`
over pyarrow's schema for a matrix of column types written by pyarrow
(Parquet with and without the stored Arrow schema, format versions 2.6
and 1.0; ORC). Flat and `k=v` directories of Parquet and ORC files
written by pyarrow with its defaults (snappy Parquet pages, dictionary
pages with a plain fallback, several row groups; uncompressed ORC) are
migrated by each package from a copy of its own and compared manifest for
manifest (each DataFileMeta but its creation time) and row for row, and
each package reads the other's table. A partition value is filed as the
directory's string under a STRING and under an INT partition key, as the
JAX package files it. adopt_table_files, the three procedures (the cases
of tests/test_sql_round5.py, tests/test_formats_aux.py and their errors)
and the orphan sweep, which must keep every migrated file, complete it;
the primary-key tables that migrate_file refuses are read merged, under
sort-engine=pallas in the port (the kernels' plain versions on the CPU)
and the numpy engine in the JAX package.

Tolerance: exact.
"""

import datetime
import decimal
import io
import os
import shutil

import pyarrow as pa
import pyarrow.orc as po
import pyarrow.parquet as pq
import pytest

import paimon_tpu.catalog as jcatalog
import paimon_tpu.sql as jsql
import paimon_tpu.table.maintenance as jmaint
import paimon_tpu.table.migrate as jmigrate
import paimon_tpu.types as jtypes
import paimon_tpu_torch.catalog as pcatalog
import paimon_tpu_torch.sql as psql
import paimon_tpu_torch.table.maintenance as pmaint
import paimon_tpu_torch.table.migrate as pmigrate
import paimon_tpu_torch.types as ptypes
from paimon_tpu.data.batch import ColumnBatch as JaxBatch
from paimon_tpu.table import FileStoreTable as JaxTable

PKGS = ("jax", "port")
ENGINE = {"jax": {"sort-engine": "numpy"}, "port": {"sort-engine": "pallas"}}
MIGRATE = {"jax": jmigrate, "port": pmigrate}
SQL = {"jax": jsql, "port": psql}
MAINT = {"jax": jmaint, "port": pmaint}
TYPES = {"jax": jtypes, "port": ptypes}


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


def catalog(pkg, warehouse, user="mig"):
    if pkg == "jax":
        return jcatalog.FileSystemCatalog(str(warehouse), commit_user=user)
    return pcatalog.FileSystemCatalog(str(warehouse), commit_user=user, device="cpu")


def read(t):
    """The table's rows. The JAX package's data-file cache keys by file
    name, so it misreads a migrated table that repeats a foreign name
    (ROADMAP Queue 3 item 28): its reads here opt out of that cache."""
    if isinstance(t, JaxTable):
        t = t.copy({"cache.data-file.max-memory-size": "0 b"})
    return rows_of(t)


def rows_of(t):
    rb = t.new_read_builder()
    return sorted(rb.new_read().read_all(rb.new_scan().plan()).to_pylist(), key=repr)


def outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 - the exception is the result compared
        return ("raises", type(e).__name__, str(e))


def row_type_key(rt) -> list:
    return [(f.id, f.name, repr(f.type)) for f in rt.fields]


def manifests(t) -> list:
    """Each live file's (partition, bucket, DataFileMeta without its
    creation time), in plan order."""
    out = []
    for e in t.store.new_scan().plan().entries:
        d = e.file.to_dict()
        d.pop("creationTimeMillis")
        out.append((tuple(e.partition), e.bucket, d))
    return out


# ------------------------------------------------------------ inference
def type_matrix() -> dict:
    dec = [decimal.Decimal("1.25"), None]
    return {
        "b": pa.array([True, None]), "i8": pa.array([1, None], pa.int8()), "i16": pa.array([1, 2], pa.int16()),
        "i32": pa.array([1, 2], pa.int32()), "i64": pa.array([1, 2], pa.int64()),
        "u8": pa.array([1, 2], pa.uint8()), "u16": pa.array([1, 2], pa.uint16()),
        "u32": pa.array([1, 2], pa.uint32()), "u64": pa.array([1, 2], pa.uint64()),
        "f16": pa.array([1.0, 2.0], pa.float32()).cast(pa.float16()),
        "f32": pa.array([1.0, 2.0], pa.float32()), "f64": pa.array([1.0, None]),
        "d32": pa.array([datetime.date(2024, 1, 1), None]),
        "d64": pa.array([datetime.date(2024, 1, 1)] * 2).cast(pa.date64()),
        "ts_s": pa.array([1, 2], pa.timestamp("s")), "ts_ms": pa.array([1, 2], pa.timestamp("ms")),
        "ts_us": pa.array([1, 2], pa.timestamp("us")), "ts_ns": pa.array([1000, 2000], pa.timestamp("ns")),
        "ts_tz": pa.array([1, 2], pa.timestamp("us", tz="UTC")),
        "t32": pa.array([1, 2], pa.time32("ms")), "t64": pa.array([1, 2], pa.time64("us")),
        "dur": pa.array([1, 2], pa.duration("us")),
        "s": pa.array(["a", None]), "ls": pa.array(["a", "b"], pa.large_string()),
        "sv": pa.array(["a", "b"], pa.string_view()),
        "bin": pa.array([b"a", b"b"]), "lbin": pa.array([b"a", b"b"], pa.large_binary()),
        "bv": pa.array([b"a", b"b"], pa.binary_view()), "fsb": pa.array([b"ab", b"cd"], pa.binary(2)),
        "dec9": pa.array(dec, pa.decimal128(9, 2)), "dec18": pa.array(dec, pa.decimal128(18, 2)),
        "dec20": pa.array(dec, pa.decimal128(20, 2)), "dec256": pa.array(dec, pa.decimal256(10, 2)),
        "dict_s": pa.array(["a", "b"]).dictionary_encode(), "dict_i": pa.array([1, 2]).dictionary_encode(),
        "dict_b": pa.array([b"a", b"b"]).dictionary_encode(), "dict_f": pa.array([1.5, 2.5]).dictionary_encode(),
        "null": pa.array([None, None]), "lst": pa.array([[1], [2]]), "st": pa.array([{"x": 1}, {"x": 2}]),
        "mp": pa.array([[("k", 1)], [("k", 2)]], pa.map_(pa.string(), pa.int64())),
        "llst": pa.array([[1], [2]], pa.large_list(pa.int32())),
    }


@pytest.mark.parametrize("store_schema", [True, False], ids=["arrow_schema", "footer_only"])
@pytest.mark.parametrize("version", ["2.6", "1.0"])
def test_infer_row_type_parquet_matrix(store_schema, version, tmp_path):
    path = str(tmp_path / "m.parquet")
    pq.write_table(pa.table(type_matrix()), path, store_schema=store_schema, version=version,
                   coerce_timestamps="us" if version == "1.0" else None, allow_truncated_timestamps=True)
    want = JaxBatch.row_type_from_arrow(pq.read_schema(path))
    assert row_type_key(pmigrate.infer_row_type(path, "parquet")) == row_type_key(want)


def test_infer_row_type_orc_matrix(tmp_path):
    names = ("b", "i8", "i16", "i32", "i64", "f32", "f64", "d32", "ts_us", "ts_ns", "s", "ls", "bin", "lbin",
             "dec9", "dec18", "dec20", "lst", "st", "mp")
    m = type_matrix()
    path = str(tmp_path / "m.orc")
    po.write_table(pa.table({n: m[n] for n in names}), path)
    with open(path, "rb") as fh:
        want = JaxBatch.row_type_from_arrow(po.ORCFile(fh).schema)
    assert row_type_key(pmigrate.infer_row_type(path, "orc")) == row_type_key(want)


def test_infer_row_type_refuses_other_formats(tmp_path):
    with pytest.raises(ValueError, match="cannot infer schema from format 'avro'"):
        pmigrate.infer_row_type(str(tmp_path / "x.avro"), "avro")


# ------------------------------------------------------- migrated tables
def foreign_table(n: int, offset: int = 0, dt=None) -> pa.Table:
    ids = list(range(offset, offset + n))
    cols = {"id": pa.array(ids, pa.int64()), "qty": pa.array([i % 7 if i % 5 else None for i in ids], pa.int32()),
            "price": pa.array([i * 0.25 for i in ids], pa.float64()),
            "cat": pa.array([f"c{i % 4}" for i in ids], pa.string()),
            "note": pa.array([None if i % 3 == 0 else f"note-{i}" for i in ids], pa.string()),
            "ok": pa.array([i % 2 == 0 for i in ids], pa.bool_())}
    if dt is not None:
        cols = {"dt": pa.array([dt] * n, type=dt_type(dt)), **cols}
    return pa.table(cols)


def dt_type(dt):
    return pa.int32() if isinstance(dt, int) else pa.string()


def write_foreign(path: str, table: pa.Table, fmt: str) -> None:
    if fmt == "parquet":
        pq.write_table(table, path, row_group_size=150)  # pyarrow's defaults, several row groups
    else:
        po.write_table(table, path, stripe_size=64 * 1024)


def lay_out(root, fmt: str, partitioned: "str | None") -> None:
    """Three files flat, or two `dt=` directories of two files each (one of
    them empty of rows in the flat case)."""
    os.makedirs(root)
    if partitioned is None:
        write_foreign(f"{root}/part-0.{fmt}", foreign_table(400), fmt)
        write_foreign(f"{root}/part-1.{fmt}", foreign_table(250, 400), fmt)
        write_foreign(f"{root}/part-2.{fmt}", foreign_table(0), fmt)
        with open(f"{root}/_SUCCESS", "w") as f:
            f.write("")
        return
    values = ("2024-01-01", "2024-01-02") if partitioned == "string" else (1, 20)
    for k, value in enumerate(values):
        os.makedirs(f"{root}/dt={value}")
        for j in range(2):
            write_foreign(f"{root}/dt={value}/part-{j}.{fmt}", foreign_table(300, 1000 * k + 300 * j, value), fmt)
    os.makedirs(f"{root}/other=1")
    write_foreign(f"{root}/other=1/part-0.{fmt}", foreign_table(10, 5000, values[0]), fmt)


@pytest.mark.parametrize("partitioned", [None, "string", "int"], ids=["flat", "string_key", "int_key"])
@pytest.mark.parametrize("fmt", ["parquet", "orc"])
def test_migrate_files_by_each_package(fmt, partitioned, tmp_path):
    lay_out(str(tmp_path / "src_jax"), fmt, partitioned)
    shutil.copytree(tmp_path / "src_jax", tmp_path / "src_port")
    first = sorted(p for p in (tmp_path / "src_jax").rglob(f"*.{fmt}"))[0]
    with open(first, "rb") as fh:
        arrow_schema = pq.read_schema(fh) if fmt == "parquet" else po.ORCFile(fh).schema
    jax_rt = JaxBatch.row_type_from_arrow(arrow_schema)
    port_rt = pmigrate.infer_row_type(str(first), fmt)
    assert row_type_key(port_rt) == row_type_key(jax_rt)
    keys = ("dt",) if partitioned else ()
    tables = {}
    for pkg, rt in (("jax", jax_rt), ("port", port_rt)):
        cat = catalog(pkg, tmp_path / f"wh_{pkg}")
        tables[pkg] = MIGRATE[pkg].migrate_files(cat, "db.legacy", str(tmp_path / f"src_{pkg}"), rt,
                                                 file_format=fmt, partition_keys=keys)
    assert manifests(tables["port"]) == manifests(tables["jax"])
    rows = read(tables["jax"])
    assert read(tables["port"]) == rows and len(rows) == (650 if partitioned is None else 1200)
    # files moved, not copied; the directories' other files stay
    assert not list((tmp_path / "src_port").rglob(f"part-[01].{fmt}")) or partitioned
    for reader, writer in (("jax", "port"), ("port", "jax")):
        assert read(catalog(reader, tmp_path / f"wh_{writer}").get_table("db.legacy")) == rows
    if partitioned:
        parts = {e[0] for e in manifests(tables["port"])}
        assert parts == ({("2024-01-01",), ("2024-01-02",)} if partitioned == "string" else {("1",), ("20",)})


@pytest.mark.parametrize("key", ["string", "int"])
def test_filtered_reads_of_a_migrated_partitioned_table(key, tmp_path):
    """The partition values filed as strings: a read filtered on the key
    returns the same rows in both packages (under an INT key the value
    stays a string in the manifest, as the JAX package writes it)."""
    lay_out(str(tmp_path / "src"), "parquet", key)
    rt = pmigrate.infer_row_type(str(sorted((tmp_path / "src").rglob("*.parquet"))[0]), "parquet")
    t = pmigrate.migrate_files(catalog("port", tmp_path / "wh"), "db.p", str(tmp_path / "src"), rt,
                               partition_keys=("dt",))
    value = "2024-01-02" if key == "string" else 20
    got = {}
    for pkg in PKGS:
        pred = __import__(f"{'paimon_tpu' if pkg == 'jax' else 'paimon_tpu_torch'}.data.predicate",
                          fromlist=["equal"])
        table = catalog(pkg, tmp_path / "wh").get_table("db.p")
        rb = table.new_read_builder().with_filter(pred.equal("dt", value))
        got[pkg] = outcome(lambda: sorted(rb.new_read().read_all(rb.new_scan().plan()).to_pylist()))
    assert got["port"] == got["jax"]
    assert got["port"][0] == "ok" and len(got["port"][1]) == 600 and {r[0] for r in got["port"][1]} == {value}
    assert t.row_type.field("dt").type.root.name == ("VARCHAR" if key == "string" else "INT")


def test_adopt_table_files_by_each_package(tmp_path):
    out = {}
    for pkg in PKGS:
        src = tmp_path / f"raw_{pkg}"
        for n, rows in (("a", 120), ("b", 80)):
            os.makedirs(src / n)
            write_foreign(str(src / n / "f.parquet"), foreign_table(rows, 1000 if n == "b" else 0), "parquet")
        cat = catalog(pkg, tmp_path / f"wh_{pkg}")
        rt = JaxBatch.row_type_from_arrow(pq.read_schema(str(src / "a" / "f.parquet"))) if pkg == "jax" else \
            pmigrate.infer_row_type(str(src / "a" / "f.parquet"), "parquet")
        MIGRATE[pkg].migrate_files(cat, "db.ma", str(src / "a"), rt)
        MIGRATE[pkg].migrate_files(cat, "db.mb", str(src / "b"), rt)
        moved = MIGRATE[pkg].adopt_table_files(cat, "db.ma", "db.mb")
        tgt = cat.get_table("db.mb")
        metas = [(p, b, {k: v for k, v in d.items() if k != "fileName"}) for p, b, d in manifests(tgt)]
        out[pkg] = (moved, read(tgt), metas, read(cat.get_table("db.ma")))
    assert out["port"] == out["jax"]
    assert out["port"][0] == 1 and len(out["port"][1]) == 200
    # the foreign name is replaced by a fresh one in the target
    names = [d["fileName"] for _, _, d in manifests(catalog("port", tmp_path / "wh_port").get_table("db.mb"))]
    assert "f.parquet" in names and any(n.startswith("data-") for n in names)


# ------------------------------------------------------------ procedures
def test_migrate_table_and_database_procedures(tmp_path):
    """tests/test_sql_round5.py::test_migrate_table_and_database_procedures
    in both packages."""
    out = {}
    for pkg in PKGS:
        for tname in ("t1", "t2"):
            d = tmp_path / pkg / "ext" / tname
            d.mkdir(parents=True)
            pq.write_table(pa.table({"a": list(range(10)), "b": [f"r{i}" for i in range(10)]}), d / "part-0.parquet")
        cat = catalog(pkg, tmp_path / f"wh_{pkg}")
        got = [SQL[pkg].call(cat, f"CALL sys.migrate_table('db.m1', '{tmp_path / pkg}/ext/t1', 'parquet')"),
               read(cat.get_table("db.m1")),
               SQL[pkg].call(cat, f"CALL sys.migrate_database('mdb', '{tmp_path / pkg}/ext', 'parquet')"),
               read(cat.get_table("mdb.t2")), row_type_key(cat.get_table("mdb.t2").row_type)]
        out[pkg] = got
    assert out["port"] == out["jax"]
    assert out["port"][2] == {"migrated": ["mdb.t2"]} and len(out["port"][3]) == 10


def test_migrate_file_procedure(tmp_path):
    """tests/test_sql_round5.py::test_migrate_file_adopts_and_drops_origin
    in both packages, with its refusals."""
    out = {}
    for pkg in PKGS:
        for n in ("a", "b"):
            d = tmp_path / pkg / "raw" / n
            d.mkdir(parents=True)
            pq.write_table(pa.table({"a": [1, 2, 3], "b": ["x", "y", "z"]}), d / "f.parquet")
        cat = catalog(pkg, tmp_path / f"wh_{pkg}")
        call = SQL[pkg].call
        call(cat, f"CALL sys.migrate_table('db.ma', '{tmp_path / pkg}/raw/a', 'parquet')")
        call(cat, f"CALL sys.migrate_table('db.mb', '{tmp_path / pkg}/raw/b', 'parquet')")
        got = [call(cat, "CALL sys.migrate_file('db.ma', 'db.mb', true)"), read(cat.get_table("db.mb")),
               outcome(cat.get_table, "db.ma")[:2]]
        t_ = TYPES[pkg]
        for name in ("db.pk1", "db.pk2"):
            pk = cat.create_table(name, t_.RowType.of(("a", t_.BIGINT(False)), ("b", t_.STRING())),
                                  primary_keys=["a"], options={"bucket": "1", **ENGINE[pkg]})
            for rows in ({"a": [1, 2, 3], "b": ["x", "y", "z"]}, {"a": [2, 4], "b": ["y2", "w"]}):
                wb = pk.new_batch_write_builder()
                w = wb.new_write()
                w.write(rows)
                wb.new_commit().commit(w.prepare_commit())
        # the primary-key tables' merged reads (sort-engine pallas in the port)
        got.append(read(cat.get_table("db.pk1")))
        other = t_.RowType.of(("a", t_.BIGINT()), ("b", t_.BIGINT()))
        cat.create_table("db.other", other)
        got += [outcome(call, cat, "CALL sys.migrate_file('db.pk1', 'db.pk2', false)"),
                outcome(call, cat, "CALL sys.migrate_file('db.mb', 'db.other', false)")]
        out[pkg] = got
    assert out["port"] == out["jax"]
    assert out["port"][0] == {"migrated_into": "db.mb", "files": 1, "origin_deleted": True}
    assert out["port"][3] == [(1, "x"), (2, "y2"), (3, "z"), (4, "w")]
    assert out["port"][4][:2] == ("raises", "ProcedureError") and "append" in out["port"][4][2]


@pytest.mark.parametrize("case", ["empty_dir", "avro", "no_dir", "orc"])
def test_migrate_table_procedure_errors_and_formats(case, tmp_path):
    out = {}
    for pkg in PKGS:
        d = tmp_path / pkg / "src"
        d.mkdir(parents=True)
        fmt = {"empty_dir": "parquet", "avro": "avro", "no_dir": "parquet", "orc": "orc"}[case]
        if case == "avro":
            (d / "f.avro").write_bytes(b"Obj\x01")
        if case == "orc":
            write_foreign(str(d / "f.orc"), foreign_table(50), "orc")
        src = str(d) if case != "no_dir" else str(tmp_path / pkg / "missing")
        cat = catalog(pkg, tmp_path / f"wh_{pkg}")
        got = outcome(SQL[pkg].call, cat, f"CALL sys.migrate_table('db.x', '{src}', '{fmt}')")
        if got[0] == "raises":
            got = (*got[:2], got[2].replace(str(tmp_path / pkg), "<root>"))
        out[pkg] = (got, read(cat.get_table("db.x")) if got[0] == "ok" else None)
    assert out["port"] == out["jax"]


def test_migrate_parquet_dir(tmp_path):
    """tests/test_formats_aux.py::test_migrate_parquet_dir on the port."""
    src = tmp_path / "legacy"
    src.mkdir()
    pq.write_table(pa.table({"x": [1, 2], "y": ["a", "b"]}), str(src / "part-0.parquet"))
    pq.write_table(pa.table({"x": [3], "y": ["c"]}), str(src / "part-1.parquet"))
    rt = ptypes.RowType.of(("x", ptypes.BIGINT()), ("y", ptypes.STRING()))
    t = pmigrate.migrate_files(catalog("port", tmp_path / "wh"), "db.legacy", str(src), rt)
    assert read(t) == [(1, "a"), (2, "b"), (3, "c")]
    assert not list(src.glob("*.parquet"))


@pytest.mark.parametrize("fmt", ["parquet", "orc"])
def test_the_orphan_sweep_keeps_migrated_files(fmt, tmp_path):
    out = {}
    for pkg in PKGS:
        lay_out(str(tmp_path / f"src_{pkg}"), fmt, "string")
        rt = pmigrate.infer_row_type(str(sorted((tmp_path / f"src_{pkg}").rglob(f"*.{fmt}"))[0]), fmt)
        if pkg == "jax":
            with open(sorted((tmp_path / f"src_{pkg}").rglob(f"*.{fmt}"))[0], "rb") as fh:
                rt = JaxBatch.row_type_from_arrow(pq.read_schema(fh) if fmt == "parquet" else po.ORCFile(fh).schema)
        cat = catalog(pkg, tmp_path / f"wh_{pkg}")
        t = MIGRATE[pkg].migrate_files(cat, "db.s", str(tmp_path / f"src_{pkg}"), rt, file_format=fmt,
                                       partition_keys=("dt",))
        before = read(t)
        removed = MAINT[pkg].remove_orphan_files(t, older_than_millis=-1)
        out[pkg] = (removed, read(cat.get_table("db.s")) == before, len(before))
    assert out["port"] == out["jax"] == ([], True, 1200)


def test_a_foreign_name_in_two_partitions_reads_right(tmp_path):
    """ROADMAP Queue 3 item 28: part-0.parquet sits in both dt= partitions
    of a migrated table. The port's data-file cache keys by the file's
    path, so every read, cached or not, returns each file's own rows; the
    JAX package's keys by name, and a read with its cache on returns one
    partition's rows for the other."""
    lay_out(str(tmp_path / "src"), "parquet", "string")
    rt = pmigrate.infer_row_type(str(sorted((tmp_path / "src").rglob("*.parquet"))[0]), "parquet")
    pmigrate.migrate_files(catalog("port", tmp_path / "wh"), "db.p", str(tmp_path / "src"), rt,
                           partition_keys=("dt",))
    port = catalog("port", tmp_path / "wh").get_table("db.p")
    oracle = rows_of(port.copy({"cache.data-file.max-memory-size": "0 b"}))
    assert len(set(oracle)) == 1200
    assert rows_of(port) == rows_of(port) == rows_of(catalog("port", tmp_path / "wh").get_table("db.p")) == oracle
    jax = [rows_of(catalog("jax", tmp_path / "wh").get_table("db.p")) for _ in range(2)]
    assert read(catalog("jax", tmp_path / "wh").get_table("db.p")) == oracle
    assert any(len(set(rows)) < 1200 for rows in jax)


def test_a_table_migrated_again_at_the_same_path_reads_its_own_files(tmp_path):
    """Dropping a table drops its data-file cache entries: the same foreign
    name migrated again at the same path is read anew."""
    cat = catalog("port", tmp_path / "wh")
    for rows, d in ((100, "a"), (70, "b")):
        (tmp_path / d).mkdir()
        write_foreign(str(tmp_path / d / "part-0.parquet"), foreign_table(rows, 1000 * rows), "parquet")
    rt = pmigrate.infer_row_type(str(tmp_path / "a" / "part-0.parquet"), "parquet")
    first = rows_of(pmigrate.migrate_files(cat, "db.x", str(tmp_path / "a"), rt))
    cat.drop_table("db.x")
    second = rows_of(pmigrate.migrate_files(cat, "db.x", str(tmp_path / "b"), rt))
    assert (len(first), len(second)) == (100, 70) and second[0][0] == 70_000
