"""Schema evolution in the port (paimon_tpu_torch) against the JAX package,
on the CPU (device="cpu" for the port): the cast module, SchemaChange and
SchemaManager.commit_changes, FileSystemCatalog.alter_table, and reads,
writes and compactions of tables whose files span schemas.

The JAX package's tests/test_store.py::test_schema_evolution_add_column and
::test_schema_evolution_rename_and_widen,
tests/test_review_regressions.py::test_narrowing_cast_rejected and the four
cast-matrix tests of tests/test_aggregators_full.py each have a
counterpart here, run against both packages. Cross-package: every explicit
and evolution cast over seeded columns with nulls (values, null masks and
dtypes); schema files written by one package load in the other; an ALTER
committed by one package and written, compacted and read by the other,
both ways, under three merge engines; predicates over evolved files.

Where the packages differ on purpose (ROADMAP Queue 3 item 21): the JAX
package takes any change within one type root as a widening and keeps the
stored values, so a DECIMAL whose scale grew reads its old unscaled values
at the new scale, and a VARCHAR cut shorter keeps its longer values. The
port rescales a DECIMAL whose scale grew, refuses to commit a narrowing,
and raises, naming the field, where it reads one the JAX package
committed. It also refuses a key column's type change under which stored
keys would order otherwise (DATE to TIMESTAMP, a number to a string). The
tests state the port's results outright.

Tolerance: exact. Float sums are compared bit for bit, as the earlier
test_torch_* files compare them.
"""

import io

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import paimon_tpu as jt
import paimon_tpu_torch as tt
from paimon_tpu.catalog import FileSystemCatalog as JaxCatalog
from paimon_tpu.core.manifest import ManifestCommittable as JaxCommittable
from paimon_tpu.core.schema import SchemaChange as JaxChange
from paimon_tpu.core.schema import SchemaManager as JaxSchemaManager
from paimon_tpu.core.store import KeyValueFileStore as JaxStore
from paimon_tpu.data import casting as jcast
from paimon_tpu.data import predicate as jp
from paimon_tpu.data.batch import Column as JaxColumn
from paimon_tpu.data.batch import ColumnBatch as JaxBatch
from paimon_tpu.fs import LocalFileIO as JaxIO
from paimon_tpu.table import load_table as jax_load_table
from paimon_tpu.table.compactor import DedicatedCompactor as JaxCompactor
from paimon_tpu.types import parse_type as jax_parse_type
from paimon_tpu_torch.catalog import FileSystemCatalog as PortCatalog
from paimon_tpu_torch.core.manifest import ManifestCommittable as PortCommittable
from paimon_tpu_torch.core.schema import SchemaChange as PortChange
from paimon_tpu_torch.core.schema import SchemaManager as PortSchemaManager
from paimon_tpu_torch.core.store import KeyValueFileStore as PortStore
from paimon_tpu_torch.data import casting as tcast
from paimon_tpu_torch.data import predicate as tp
from paimon_tpu_torch.data.batch import Column as PortColumn
from paimon_tpu_torch.data.batch import ColumnBatch as PortBatch
from paimon_tpu_torch.fs import LocalFileIO as PortIO
from paimon_tpu_torch.table import load_table as port_load_table
from paimon_tpu_torch.table.compactor import DedicatedCompactor as PortCompactor
from paimon_tpu_torch.types import parse_type as port_parse_type

PKGS = ("jax", "port")


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


def _mod(pkg):
    return jt if pkg == "jax" else tt


def _change(pkg):
    return JaxChange if pkg == "jax" else PortChange


def _cast(pkg):
    return jcast if pkg == "jax" else tcast


def _catalog(pkg, warehouse, user=None):
    if pkg == "jax":
        return JaxCatalog(warehouse, commit_user=user or pkg)
    return PortCatalog(warehouse, commit_user=user or pkg, device="cpu")


def _open(pkg, path, options=None):
    if pkg == "jax":
        return jax_load_table(path, commit_user=pkg, dynamic_options=options)
    return port_load_table(path, commit_user=pkg, dynamic_options=options, device="cpu")


def _py(v):
    return v.item() if hasattr(v, "item") else v


def _rows(batch) -> list[tuple]:
    return [tuple(_py(v) for v in row) for row in batch.to_pylist()]


def _read(table, predicate=None) -> list[tuple]:
    rb = table.new_read_builder()
    if predicate is not None:
        rb = rb.with_filter(predicate)
    return _rows(rb.new_read().read_all(rb.new_scan().plan()))


def _write(table, data, kinds=None):
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.write(data, kinds) if kinds is not None else w.write(data)
    wb.new_commit().commit(w.prepare_commit())


def _type(pkg, s):
    return (jax_parse_type if pkg == "jax" else port_parse_type)(s)


# ---------------------------------------------------------------------------
# casts (tests/test_aggregators_full.py, tests/test_review_regressions.py)
# ---------------------------------------------------------------------------


def _cast1(pkg, value, src, dst):
    m = _mod(pkg)
    col_cls = JaxColumn if pkg == "jax" else PortColumn
    src_t, dst_t = _type(pkg, src), _type(pkg, dst)
    out = _cast(pkg).cast_explicit(col_cls.from_pylist([value], src_t), src_t, dst_t)
    assert m is not None
    return out.to_pylist()[0]


@pytest.mark.parametrize("pkg", PKGS)
def test_cast_matrix_numeric_and_boolean(pkg):
    assert _cast1(pkg, 300, "INT", "TINYINT") == 44
    assert _cast1(pkg, 3.9, "DOUBLE", "BIGINT") == 3
    assert _cast1(pkg, True, "BOOLEAN", "INT") == 1
    assert _cast1(pkg, 0, "INT", "BOOLEAN") is False
    assert _cast1(pkg, 2, "SMALLINT", "BOOLEAN") is True
    assert _cast1(pkg, "true", "STRING", "BOOLEAN") is True
    assert _cast1(pkg, "nope", "STRING", "BOOLEAN") is None
    assert _cast1(pkg, False, "BOOLEAN", "STRING") == "false"


@pytest.mark.parametrize("pkg", PKGS)
def test_cast_matrix_temporal_and_decimal(pkg):
    day = _cast1(pkg, "2020-03-01", "STRING", "DATE")
    assert day == (np.datetime64("2020-03-01") - np.datetime64("1970-01-01")).astype(int)
    assert _cast1(pkg, day, "DATE", "STRING") == "2020-03-01"
    micros = _cast1(pkg, "2020-03-01 12:30:00", "STRING", "TIMESTAMP(6)")
    assert micros == day * 86_400_000_000 + (12 * 3600 + 30 * 60) * 1_000_000
    assert _cast1(pkg, micros, "TIMESTAMP(6)", "DATE") == day
    assert _cast1(pkg, day, "DATE", "TIMESTAMP(6)") == day * 86_400_000_000
    assert "2020-03-01 12:30:00" in _cast1(pkg, micros, "TIMESTAMP(6)", "STRING")
    assert _cast1(pkg, "12.345", "STRING", "DECIMAL(10,2)") == 1235
    assert _cast1(pkg, 1235, "DECIMAL(10,2)", "STRING") == "12.35"
    assert _cast1(pkg, 1235, "DECIMAL(10,2)", "DECIMAL(10,1)") == 124
    assert _cast1(pkg, 1235, "DECIMAL(10,2)", "BIGINT") == 12
    assert _cast1(pkg, 7, "INT", "DECIMAL(10,2)") == 700


@pytest.mark.parametrize("pkg", PKGS)
def test_cast_matrix_strings_and_bytes(pkg):
    assert _cast1(pkg, "abc", "STRING", "BYTES") == b"abc"
    assert _cast1(pkg, b"xyz", "BYTES", "STRING") == "xyz"
    assert _cast1(pkg, "toolong", "STRING", "CHAR(3)") == "too"
    assert _cast1(pkg, "12.5", "STRING", "DOUBLE") == 12.5
    assert _cast1(pkg, 42, "BIGINT", "STRING") == "42"
    assert not _cast(pkg).can_cast_explicit(_type(pkg, "BYTES"), _type(pkg, "BIGINT"))


@pytest.mark.parametrize("pkg", PKGS)
def test_cast_review_regressions(pkg):
    assert _cast1(pkg, -15, "DECIMAL(10,1)", "INT") == -1
    assert _cast1(pkg, 0.25, "DOUBLE", "DECIMAL(10,1)") == 3
    assert _cast1(pkg, -0.25, "DOUBLE", "DECIMAL(10,1)") == -3
    assert _cast1(pkg, "1e30", "STRING", "DECIMAL(10,0)") is None
    assert _cast1(pkg, "99999999999999999999", "STRING", "BIGINT") is None
    assert _cast1(pkg, "9223372036854775807", "STRING", "BIGINT") == 9223372036854775807
    assert _cast1(pkg, "abcdef", "STRING", "VARCHAR(2)") == "ab"


@pytest.mark.parametrize("pkg", PKGS)
def test_narrowing_cast_rejected(pkg):
    can_cast = _cast(pkg).can_cast
    assert can_cast(_type(pkg, "INT"), _type(pkg, "BIGINT"))
    assert can_cast(_type(pkg, "INT"), _type(pkg, "DOUBLE"))
    assert not can_cast(_type(pkg, "BIGINT"), _type(pkg, "TINYINT"))
    assert not can_cast(_type(pkg, "DOUBLE"), _type(pkg, "INT"))


TYPES = ["TINYINT", "SMALLINT", "INT", "BIGINT", "FLOAT", "DOUBLE", "BOOLEAN", "DECIMAL(10,2)", "DECIMAL(12,4)",
         "DECIMAL(10,1)", "DECIMAL(18,2)", "STRING", "VARCHAR(5)", "CHAR(3)", "VARCHAR(40)", "BYTES", "DATE",
         "TIMESTAMP(6)"]
STRINGS = np.array(["12", "-3.5", "true", "no", "2020-03-01", "2021-01-02 03:04:05", "abc", " 42 ", "1e3", "",
                    "0", "T", "9223372036854775807", "1970-01-01T00:00:01", "y", "-0.25", "12.345"], dtype=object)


def _values(t: str, rng, n: int) -> np.ndarray:
    root = t.split("(")[0]
    if root in ("TINYINT", "SMALLINT", "INT", "BIGINT"):
        dt = {"TINYINT": np.int8, "SMALLINT": np.int16, "INT": np.int32, "BIGINT": np.int64}[root]
        info = np.iinfo(dt)
        wide = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
        return np.where(rng.random(n) < 0.5, wide, rng.integers(-300, 300, n).astype(dt)).astype(dt)
    if root in ("FLOAT", "DOUBLE"):
        v = np.round(rng.normal(0, 1000, n) * 4) / 4
        return v.astype(np.float32 if root == "FLOAT" else np.float64)
    if root == "BOOLEAN":
        return rng.random(n) < 0.5
    if root == "DECIMAL":
        return rng.integers(-10**7, 10**7, n).astype(np.int64)
    if root in ("STRING", "VARCHAR", "CHAR"):
        return STRINGS[rng.integers(0, len(STRINGS), n)].copy()
    if root == "BYTES":
        return np.array([s.encode() for s in STRINGS[rng.integers(0, len(STRINGS), n)]], dtype=object)
    if root == "DATE":
        return rng.integers(-20000, 20000, n).astype(np.int32)
    return rng.integers(-(10**15), 10**15, n).astype(np.int64)


def _column_pair(t: str, seed: int, n: int = 200):
    rng = np.random.default_rng(seed)
    values = _values(t, rng, n)
    valid = rng.random(n) >= 0.2
    if values.dtype == np.dtype(object):
        values = np.where(valid, values, None)
    return JaxColumn(values.copy(), valid.copy()), PortColumn(values.copy(), valid.copy())


def _same_column(a, b) -> None:
    assert a.values.dtype == b.values.dtype
    va, vb = a.valid_mask(), b.valid_mask()
    assert np.array_equal(va, vb)
    assert a.values[va].tolist() == b.values[vb].tolist()


@pytest.mark.parametrize("src", TYPES)
def test_explicit_casts_equal_the_reference(src):
    """Every destination the explicit matrix allows from `src`: the same
    values, null masks and dtypes."""
    done = 0
    for i, dst in enumerate(TYPES):
        js, jd = jax_parse_type(src), jax_parse_type(dst)
        ps, pd = port_parse_type(src), port_parse_type(dst)
        assert tcast.can_cast_explicit(ps, pd) == jcast.can_cast_explicit(js, jd), (src, dst)
        if not jcast.can_cast_explicit(js, jd):
            with pytest.raises(ValueError):
                tcast.cast_explicit(_column_pair(src, i)[1], ps, pd)
            continue
        jcol, pcol = _column_pair(src, i)
        _same_column(jcast.cast_explicit(jcol, js, jd), tcast.cast_explicit(pcol, ps, pd))
        done += 1
    assert done >= 3


def _narrowing_within_root(src: str, dst: str) -> bool:
    """Fault 1's pairs: the JAX package's evolution gate passes them, the
    port's refuses them."""
    ps, pd = port_parse_type(src), port_parse_type(dst)
    strings = ("CHAR", "VARCHAR")
    if ps.root.value == pd.root.value == "DECIMAL":
        return pd.scale < ps.scale or pd.precision - pd.scale < ps.precision - ps.scale
    if ps.root.value in strings and pd.root.value in strings:
        return (pd.length or 0) < (ps.length or 0)
    return False


@pytest.mark.parametrize("src", TYPES)
def test_evolution_casts_equal_the_reference(src):
    """can_cast agrees with the JAX package's but on the narrowings within a
    root (refused here); cast_column agrees on every widening to another
    root, and on a change within a root keeps the values (a DECIMAL at a
    larger scale is rescaled, below)."""
    for i, dst in enumerate(TYPES):
        js, jd = jax_parse_type(src), jax_parse_type(dst)
        ps, pd = port_parse_type(src), port_parse_type(dst)
        want = jcast.can_cast(js, jd) and not _narrowing_within_root(src, dst)
        assert tcast.can_cast(ps, pd) == want, (src, dst)
        if not want:
            with pytest.raises(ValueError, match="not a widening"):
                tcast.cast_column(_column_pair(src, i)[1], ps, pd)
            continue
        jcol, pcol = _column_pair(src, 50 + i)
        got = tcast.cast_column(pcol, ps, pd)
        if ps.root == pd.root and ps.root.value == "DECIMAL" and ps.scale != pd.scale:
            assert got.values.tolist() == (pcol.values * 10 ** (pd.scale - ps.scale)).tolist()
            assert np.array_equal(got.valid_mask(), pcol.valid_mask())
            continue
        _same_column(jcast.cast_column(jcol, js, jd), got)


# ---------------------------------------------------------------------------
# the store's evolved read (tests/test_store.py)
# ---------------------------------------------------------------------------


def _store_parts(pkg):
    if pkg == "jax":
        return JaxIO, JaxSchemaManager, JaxStore, JaxBatch, JaxCommittable
    return PortIO, PortSchemaManager, PortStore, PortBatch, PortCommittable


def _store(pkg, path, schema, **kw):
    io_cls, _, store_cls, _, _ = _store_parts(pkg)
    if pkg == "port":
        kw["device"] = "cpu"
    return store_cls(io_cls(), path, schema, **kw)


def _store_write(pkg, store, data, identifier):
    _, _, _, batch_cls, committable = _store_parts(pkg)
    w = store.new_writer((), 0)
    w.write(batch_cls.from_pydict(store.value_schema, data))
    store.new_commit().commit(committable(identifier, messages=[w.prepare_commit()]))


def _store_read(store):
    return store.read_bucket((), 0, store.restore_files((), 0))


@pytest.mark.parametrize("pkg", PKGS)
def test_schema_evolution_add_column(pkg, tmp_warehouse):
    m = _mod(pkg)
    io_cls, sm_cls, _, _, _ = _store_parts(pkg)
    path = f"{tmp_warehouse}/t10"
    sm = sm_cls(io_cls(), path)
    ts = sm.create_table(m.RowType.of(("k", m.BIGINT()), ("v", m.DOUBLE()), ("name", m.STRING())), primary_keys=["k"],
                         options={"bucket": "1", "file.format": "parquet"})
    _store_write(pkg, _store(pkg, path, ts, commit_user="u1"), {"k": [1], "v": [1.0], "name": ["a"]}, 1)
    new_schema = sm.commit_changes(_change(pkg).add_column("extra", m.INT()))
    store2 = _store(pkg, path, new_schema, commit_user="u1")
    _store_write(pkg, store2, {"k": [2], "v": [2.0], "name": ["b"], "extra": [7]}, 2)
    assert _rows(_store_read(store2)) == [(1, 1.0, "a", None), (2, 2.0, "b", 7)]


@pytest.mark.parametrize("pkg", PKGS)
def test_schema_evolution_rename_and_widen(pkg, tmp_warehouse):
    m = _mod(pkg)
    io_cls, sm_cls, _, _, _ = _store_parts(pkg)
    path = f"{tmp_warehouse}/t11"
    sm = sm_cls(io_cls(), path)
    ts = sm.create_table(m.RowType.of(("k", m.BIGINT()), ("small", m.INT())), primary_keys=["k"],
                         options={"bucket": "1"})
    _store_write(pkg, _store(pkg, path, ts), {"k": [1], "small": [5]}, 1)
    ch = _change(pkg)
    s2 = sm.commit_changes(ch.rename_column("small", "wide"), ch.update_column_type("wide", m.BIGINT()))
    out = _store_read(_store(pkg, path, s2))
    assert _rows(out) == [(1, 5)]
    assert out.schema.field("wide").type.root.value == "BIGINT"
    assert out.column("wide").values.dtype == np.int64


# ---------------------------------------------------------------------------
# SchemaManager and alter_table against the JAX package
# ---------------------------------------------------------------------------


def _changes(pkg, m):
    ch = _change(pkg)
    return [ch.add_column("src", m.STRING(), "where the row came from"), ch.drop_column("gone"),
            ch.rename_column("tag", "label"), ch.update_column_type("n", m.BIGINT()),
            ch.update_column_type("f", m.DOUBLE()), ch.update_column_type("k", m.BIGINT(False)),
            ch.set_option("snapshot.num-retained.min", "3"), ch.remove_option("write-buffer-rows")]


def _base_schema(pkg):
    m = _mod(pkg)
    return m.RowType.of(("k", m.INT(False)), ("n", m.INT()), ("f", m.FLOAT()), ("tag", m.STRING()),
                        ("gone", m.BIGINT()))


def _schema_json(schema) -> dict:
    import json

    d = json.loads(schema.to_json())
    d.pop("timeMillis")
    return d


@pytest.mark.parametrize("alter_by", PKGS)
def test_schema_files_load_in_both(tmp_warehouse, alter_by):
    """Created by one package, altered twice by `alter_by`: every schema
    file loads in both packages to the same JSON (field ids, types, the
    highest field id, options)."""
    other = "port" if alter_by == "jax" else "jax"
    m = _mod(other)
    cat = _catalog(other, tmp_warehouse)
    cat.create_table("db.s", _base_schema(other), primary_keys=["k"], options={"bucket": "2", "write-buffer-rows": "9"})
    acat = _catalog(alter_by, tmp_warehouse)
    am = _mod(alter_by)
    acat.alter_table("db.s", *_changes(alter_by, am))
    acat.alter_table("db.s", _change(alter_by).add_column("gone", am.DOUBLE()),
                     _change(alter_by).rename_column("src", "origin"))
    path = cat.table_path("db.s")
    schemas = {pkg: sm(_mod(pkg) and (JaxIO() if pkg == "jax" else PortIO()), path).all_schemas()
               for pkg, sm in (("jax", JaxSchemaManager), ("port", PortSchemaManager))}
    assert sorted(schemas["jax"]) == sorted(schemas["port"]) == [0, 1, 2]
    for sid in (0, 1, 2):
        assert _schema_json(schemas["jax"][sid]) == _schema_json(schemas["port"][sid])
    latest = schemas["port"][2]
    assert [(f.id, f.name) for f in latest.fields] == [(0, "k"), (1, "n"), (2, "f"), (3, "label"), (5, "origin"),
                                                       (6, "gone")]
    assert latest.highest_field_id == 6
    assert latest.options == {"bucket": "2", "snapshot.num-retained.min": "3"}
    assert m is not None


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("change,match", [
    (lambda ch, m: ch.drop_column("k"), "key column"),
    (lambda ch, m: ch.rename_column("p", "q"), "key column"),
    (lambda ch, m: ch.add_column("n", m.INT()), "exists"),
    (lambda ch, m: ch.rename_column("n", "f"), "exists"),
    (lambda ch, m: ch.update_column_type("n", m.SMALLINT()), "INT"),
    (lambda ch, m: {"op": "bogus"}, "unknown schema change"),
])
def test_refused_changes(pkg, tmp_warehouse, change, match):
    """Both packages refuse these, and commit nothing."""
    m = _mod(pkg)
    cat = _catalog(pkg, tmp_warehouse)
    cat.create_table("db.r", m.RowType.of(("p", m.STRING(False)), ("k", m.INT(False)), ("n", m.INT()),
                                          ("f", m.FLOAT())), partition_keys=["p"], primary_keys=["p", "k"])
    with pytest.raises(ValueError, match=match):
        cat.alter_table("db.r", change(_change(pkg), m))
    assert cat.get_table("db.r").schema.id == 0


def test_commit_changes_retries_against_the_new_latest(tmp_warehouse):
    """Two managers on one table: the second's change lands on top of the
    first's, as schema-2."""
    cat = _catalog("port", tmp_warehouse)
    cat.create_table("db.cas", _base_schema("port"), primary_keys=["k"])
    path = cat.table_path("db.cas")
    a, b = PortSchemaManager(PortIO(), path), PortSchemaManager(PortIO(), path)
    assert a.latest().id == b.latest().id == 0
    a.commit_changes(PortChange.add_column("x", tt.INT()))
    out = b.commit_changes(PortChange.add_column("y", tt.INT()))
    assert out.id == 2 and [f.name for f in out.fields][-2:] == ["x", "y"]
    with pytest.raises(RuntimeError, match="no table schema"):
        PortSchemaManager(PortIO(), f"{tmp_warehouse}/nowhere").commit_changes(PortChange.set_option("a", "b"))


def test_cross_partition_clause_on_create(tmp_warehouse):
    cat = _catalog("port", tmp_warehouse)
    schema = tt.RowType.of(("dt", tt.STRING(False)), ("id", tt.BIGINT(False)))
    with pytest.raises(ValueError, match="cross-partition"):
        cat.create_table("db.x", schema, partition_keys=["dt"], primary_keys=["id"], options={"bucket": "2"})
    assert cat.create_table("db.x", schema, partition_keys=["dt"], primary_keys=["id"]).schema.id == 0


ENGINES = {
    "deduplicate": {},
    "partial-update": {"merge-engine": "partial-update"},
    "aggregation": {"merge-engine": "aggregation", "fields.n.aggregate-function": "sum",
                    "fields.f.aggregate-function": "max", "fields.tag.aggregate-function": "last_non_null_value"},
}


def _evolving_batches(seed, before: bool):
    rng = np.random.default_rng(seed)
    n = 300
    ks = rng.integers(0, 150, n)
    out = {"k": ks.astype(np.int32 if before else np.int64), "n": rng.integers(-1000, 1000, n),
           "f": (np.round(rng.normal(0, 100, n) * 8) / 8).astype(np.float32 if before else np.float64)}
    if before:
        out["tag"] = np.array([None if i % 9 == 0 else f"t{i % 5}" for i in range(n)], dtype=object)
        out["gone"] = rng.integers(0, 5, n)
    else:
        out["label"] = np.array([None if i % 7 == 0 else f"l{i % 4}" for i in range(n)], dtype=object)
        out["src"] = np.array([None if i % 3 == 0 else f"s{i % 2}" for i in range(n)], dtype=object)
    return out


def _evolve_run(tmp_warehouse, ident, create_by, alter_by, then_by, engine):
    """Created and written (3 commits) by `create_by`, altered by
    `alter_by`, written (3 commits) and fully compacted by `then_by`;
    returns the table's path."""
    opts = {"bucket": "2", "write-only": "true", **ENGINES[engine]}
    t = _catalog(create_by, tmp_warehouse).create_table(ident, _base_schema(create_by), primary_keys=["k"],
                                                        options=opts)
    for c in range(3):
        _write(t, _evolving_batches(c, True))
    _catalog(alter_by, tmp_warehouse).alter_table(ident, *_changes(alter_by, _mod(alter_by)))
    t2 = _open(then_by, t.path)
    for c in range(3, 6):
        _write(t2, _evolving_batches(c, False))
    compactor = JaxCompactor if then_by == "jax" else PortCompactor
    assert compactor(t2).run_once(full=True)
    return t.path


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("create_by,alter_by,then_by", [("jax", "jax", "port"), ("port", "port", "jax"),
                                                        ("jax", "port", "jax"), ("port", "jax", "port"),
                                                        ("port", "port", "port")])
def test_alter_by_one_package_continued_by_the_other(tmp_warehouse, create_by, alter_by, then_by, engine):
    """Add, drop, rename, widen (a key INT to BIGINT, INT to BIGINT, FLOAT to
    DOUBLE) and option changes, across a full compaction that merges files
    of both schemas: the rows equal those of the same run made by the JAX
    package alone, read by either package."""
    path = _evolve_run(tmp_warehouse, "db.ev", create_by, alter_by, then_by, engine)
    ref = _evolve_run(tmp_warehouse, "db.ref", "jax", "jax", "jax", engine)
    want = _read(_open("jax", ref))
    assert want and any(r[-1] is None for r in want) and any(r[-1] is not None for r in want)
    for reader in PKGS:
        assert _read(_open(reader, path)) == want, reader
    live = {pkg: sorted((e.bucket, e.file.level, e.file.row_count, e.file.schema_id)
                        for e in _open(pkg, p).store.new_scan().plan().entries) for pkg, p in (("x", path), ("r", ref))}
    assert live["x"] == live["r"]


@pytest.mark.parametrize("tile", [None, "64"])
@pytest.mark.parametrize("engine", ["numpy", "xla-segmented", "pallas"])
def test_widened_key_merges_as_one_column(tmp_warehouse, engine, tile):
    """A key widened from INT to BIGINT: old files are cast before the key
    lanes, so old and new rows of one key merge, before and after a
    compaction; at both tiles and under each sort engine."""
    out = {}
    for pkg in PKGS:
        m = _mod(pkg)
        cat = _catalog(pkg, tmp_warehouse)
        opts = {"bucket": "1", "write-only": "true", "sort-engine": engine}
        t = cat.create_table(f"db.wk_{pkg}", m.RowType.of(("k", m.INT(False)), ("v", m.BIGINT())), primary_keys=["k"],
                             options=opts)
        _write(t, {"k": np.arange(-100, 100, dtype=np.int32), "v": np.arange(200)})
        cat.alter_table(f"db.wk_{pkg}", _change(pkg).update_column_type("k", m.BIGINT(False)))
        t = cat.get_table(f"db.wk_{pkg}")
        _write(t, {"k": np.array([-100, 5, 99, 1 << 40], dtype=np.int64), "v": [-1, -2, -3, -4]})
        read_opts = {"merge.read-batch-rows": tile} if tile else {}
        if pkg == "jax" and engine == "pallas":
            # the JAX package's tiled pallas read returns its winners in
            # input order under the test suite's compact download (ROADMAP
            # Queue 3 item 4): its plain path is the reference
            read_opts["sort-engine"] = "xla-segmented"
        before = _read(_open(pkg, t.path, read_opts))
        assert (JaxCompactor if pkg == "jax" else PortCompactor)(t).run_once(full=True)
        out[pkg] = (before, _read(_open(pkg, t.path, read_opts)))
    assert out["port"] == out["jax"]
    before, after = out["port"]
    assert before == after and len(before) == 201
    assert dict(before)[5] == -2 and dict(before)[1 << 40] == -4


def _engine_table(pkg, warehouse, ident, schema_spec, opts):
    m = _mod(pkg)
    schema = m.RowType.of(*[(n, _type(pkg, t)) for n, t in schema_spec])
    return _catalog(pkg, warehouse).create_table(ident, schema, primary_keys=["k"], options={"bucket": "1", **opts})


def _both(tmp_warehouse, ident, schema_spec, opts, steps):
    """Run `steps(pkg, table) -> result` on a table of each package."""
    out = {}
    for pkg in PKGS:
        out[pkg] = steps(pkg, _engine_table(pkg, tmp_warehouse, f"{ident}_{pkg}", schema_spec, opts))
    return out


def test_per_field_options_after_a_rename(tmp_warehouse):
    """fields.<name>.* keys name a column; a rename leaves them on the old
    name in both packages, so the renamed column takes the default
    aggregate from then on."""
    spec = [("k", "BIGINT NOT NULL"), ("v", "BIGINT"), ("w", "BIGINT")]
    opts = {"merge-engine": "aggregation", "fields.v.aggregate-function": "max", "fields.w.aggregate-function": "sum"}

    def steps(pkg, t):
        _write(t, {"k": [1, 1, 2], "v": [5, 3, 7], "w": [1, 2, 3]})
        cat = _catalog(pkg, t.path.rsplit("/", 2)[0])
        ident = "db." + t.path.rsplit("/", 1)[1]
        cat.alter_table(ident, _change(pkg).rename_column("v", "v2"))
        t2 = cat.get_table(ident)
        _write(t2, {"k": [1, 2], "v2": [4, 9], "w": [10, 20]})
        first = _read(t2)
        (JaxCompactor if pkg == "jax" else PortCompactor)(t2).run_once(full=True)
        return first, _read(cat.get_table(ident))

    out = _both(tmp_warehouse, "db.pfo", spec, opts, steps)
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("renamed", ["c", "a", "g"])
def test_sequence_group_naming_a_renamed_column(tmp_warehouse, renamed):
    """A sequence group names columns, and a rename leaves the option on the
    old names: renaming a column outside the group reads alike in both
    packages; renaming a field of the group, or its sequence field, makes
    the next write fail with KeyError on the old name in both."""
    spec = [("k", "BIGINT NOT NULL"), ("a", "BIGINT"), ("b", "BIGINT"), ("g", "BIGINT"), ("c", "STRING")]
    opts = {"merge-engine": "partial-update", "fields.g.sequence-group": "a,b"}

    def steps(pkg, t):
        _write(t, {"k": [1, 2], "a": [1, 2], "b": [3, 4], "g": [5, 5], "c": ["x", "y"]})
        cat = _catalog(pkg, t.path.rsplit("/", 2)[0])
        ident = "db." + t.path.rsplit("/", 1)[1]
        cat.alter_table(ident, _change(pkg).rename_column(renamed, renamed + "2"))
        t2 = cat.get_table(ident)
        data = {"k": [1, 2], "a": [10, None], "b": [None, 40], "g": [6, 4], "c": [None, "z"]}
        data[renamed + "2"] = data.pop(renamed)
        try:
            _write(t2, data)
        except KeyError as exc:
            return ("KeyError", exc.args)
        return _read(t2)

    out = _both(tmp_warehouse, "db.sg", spec, opts, steps)
    assert out["port"] == out["jax"]
    if renamed == "c":
        assert out["port"] == [(1, 10, None, 6, "x"), (2, 2, 4, 5, "z")]
    else:
        assert out["port"] == ("KeyError", (renamed,))


def test_partial_update_over_an_added_column(tmp_warehouse):
    spec = [("k", "BIGINT NOT NULL"), ("a", "BIGINT"), ("b", "STRING")]

    def steps(pkg, t):
        m = _mod(pkg)
        _write(t, {"k": [1, 2, 3], "a": [1, None, 3], "b": ["x", "y", None]})
        cat = _catalog(pkg, t.path.rsplit("/", 2)[0])
        ident = "db." + t.path.rsplit("/", 1)[1]
        cat.alter_table(ident, _change(pkg).add_column("c", m.DOUBLE()))
        t2 = cat.get_table(ident)
        _write(t2, {"k": [1, 3, 4], "a": [None, 30, 4], "b": [None, "z", None], "c": [0.5, None, 2.5]})
        _write(t2, {"k": [2], "a": [None], "b": [None], "c": [7.0]})
        first = _read(t2)
        (JaxCompactor if pkg == "jax" else PortCompactor)(t2).run_once(full=True)
        return first, _read(cat.get_table(ident))

    out = _both(tmp_warehouse, "db.pua", spec, {"merge-engine": "partial-update"}, steps)
    assert out["port"] == out["jax"]
    assert out["port"][1] == [(1, 1, "x", 0.5), (2, None, "y", 7.0), (3, 30, "z", None), (4, 4, None, 2.5)]


@pytest.mark.parametrize("sort_engine", ["xla-segmented", "pallas"])
def test_aggregation_over_widened_columns(tmp_warehouse, sort_engine):
    """A FLOAT sum widened to DOUBLE sums the cast values (segment_sum on the
    card), an INT max widened to BIGINT compares across files, before and
    after a full compaction; bit for bit the JAX package's."""
    spec = [("k", "BIGINT NOT NULL"), ("f_sum", "FLOAT"), ("c_max", "INT")]
    opts = {"merge-engine": "aggregation", "fields.f_sum.aggregate-function": "sum",
            "fields.c_max.aggregate-function": "max", "sort-engine": sort_engine, "write-only": "true"}

    def steps(pkg, t):
        m = _mod(pkg)
        rng = np.random.default_rng(31)
        for c in range(3):
            ks = rng.integers(0, 40, 200)
            _write(t, {"k": ks, "f_sum": rng.normal(0, 10, 200).astype(np.float32),
                       "c_max": rng.integers(-10**6, 10**6, 200).astype(np.int32)})
        cat = _catalog(pkg, t.path.rsplit("/", 2)[0])
        ident = "db." + t.path.rsplit("/", 1)[1]
        ch = _change(pkg)
        cat.alter_table(ident, ch.update_column_type("f_sum", m.DOUBLE()), ch.update_column_type("c_max", m.BIGINT()))
        t2 = cat.get_table(ident)
        for c in range(3):
            ks = rng.integers(0, 40, 200)
            _write(t2, {"k": ks, "f_sum": rng.normal(0, 10, 200), "c_max": rng.integers(-10**12, 10**12, 200)})
        first = _read(t2)
        (JaxCompactor if pkg == "jax" else PortCompactor)(t2).run_once(full=True)
        return first, _read(cat.get_table(ident))

    out = _both(tmp_warehouse, "db.agw", spec, opts, steps)
    assert out["port"][0] == out["jax"][0]
    assert [(k, np.float64(f).tobytes(), c) for k, f, c in out["port"][1]] == [
        (k, np.float64(f).tobytes(), c) for k, f, c in out["jax"][1]]
    assert max(r[2] for r in out["port"][1]) > (1 << 31)


# ---------------------------------------------------------------------------
# predicates over evolved files
# ---------------------------------------------------------------------------


def _append_evolved(pkg, warehouse):
    """An append table: 3 files under (id INT, x INT, s STRING, old BIGINT),
    then x widened to BIGINT, s renamed to label, old dropped and an `old`
    of type STRING added, and 2 files under the new schema."""
    m = _mod(pkg)
    cat = _catalog(pkg, warehouse)
    t = cat.create_table(f"db.pe_{pkg}", m.RowType.of(("id", m.INT()), ("x", m.INT()), ("s", m.STRING()),
                                                      ("old", m.BIGINT())), options={"bucket": "1", "write-only": "true"})
    for c in range(3):
        ids = np.arange(c * 100, (c + 1) * 100, dtype=np.int32)
        _write(t, {"id": ids, "x": ids * 2, "s": np.array([f"s{i % 10}" for i in ids], dtype=object),
                   "old": ids.astype(np.int64) * 1000})
    ch = _change(pkg)
    cat.alter_table(f"db.pe_{pkg}", ch.update_column_type("x", m.BIGINT()), ch.rename_column("s", "label"),
                    ch.drop_column("old"), ch.add_column("old", m.STRING()))
    t = cat.get_table(f"db.pe_{pkg}")
    for c in range(3, 5):
        ids = np.arange(c * 100, (c + 1) * 100, dtype=np.int32)
        _write(t, {"id": ids, "x": ids.astype(np.int64) * 2 + (1 << 33), "label": np.array([f"l{i % 10}" for i in ids],
                                                                                       dtype=object),
                   "old": np.array([f"o{i}" for i in ids], dtype=object)})
    return t


PREDICATES = {
    "widened x >= 150": (lambda p: p.greater_or_equal("x", 150), lambda r: r[1] >= 150),
    "widened x between": (lambda p: p.between("x", 100, 300), lambda r: 100 <= r[1] <= 300),
    "renamed label = s3": (lambda p: p.equal("label", "s3"), lambda r: r[2] == "s3"),
    "label = l4": (lambda p: p.equal("label", "l4"), lambda r: r[2] == "l4"),
    "re-added old is null": (lambda p: p.is_null("old"), lambda r: r[3] is None),
    "re-added old = o321": (lambda p: p.equal("old", "o321"), lambda r: r[3] == "o321"),
    "id < 50 or x > 2^33": (lambda p: p.or_(p.less_than("id", 50), p.greater_than("x", 1 << 33)),
                            lambda r: r[0] < 50 or r[1] > (1 << 33)),
}


@pytest.mark.parametrize("name", list(PREDICATES))
def test_predicates_over_evolved_files(tmp_warehouse, name):
    """The rows that match, by an oracle over the unfiltered read, from the
    port, which prunes an old file only by the stats of the same field id
    whose values compare as cast. The JAX package's pruning matches names
    only: the same rows, but for a column dropped and re-added under its
    name."""
    make, keep = PREDICATES[name]
    t = _append_evolved("port", tmp_warehouse)
    jax_t = _append_evolved("jax", tmp_warehouse)
    full = _read(t)
    assert full == _read(jax_t) and len(full) == 500
    want = [r for r in full if keep(r)]
    assert want and _read(t, make(tp)) == want
    if not name.startswith("re-added"):
        assert _read(jax_t, make(jp)) == want
        return
    # the JAX package tests the old files by the stats of the dropped
    # column, another field under the same name: it prunes files that match
    # or fails comparing a number with a string
    try:
        got = _read(jax_t, make(jp))
    except TypeError:
        return
    assert got != want


def test_pruning_skips_only_comparable_stats(tmp_warehouse):
    """The scan prunes the old files by the widened column's stats, and
    never by the stats of a column dropped and re-added under its name."""
    t = _append_evolved("port", tmp_warehouse)
    rb = t.new_read_builder().with_filter(tp.greater_or_equal("x", 600))
    files = [f for s in rb.new_scan().plan() for f in s.files]
    assert len(files) == 2 and all(f.schema_id == 1 for f in files)
    rb = t.new_read_builder().with_filter(tp.greater_or_equal("x", 500))
    assert len([f for s in rb.new_scan().plan() for f in s.files]) == 3
    # the three old files have no stats for the new `old`; of the new ones,
    # the file of ids 400-499 is pruned by its own
    rb = t.new_read_builder().with_filter(tp.equal("old", "o321"))
    assert len([f for s in rb.new_scan().plan() for f in s.files]) == 4


# ---------------------------------------------------------------------------
# where the port differs on purpose (ROADMAP Queue 3 item 21)
# ---------------------------------------------------------------------------


def _decimal_table(pkg, warehouse, spec="DECIMAL(10,2)"):
    m = _mod(pkg)
    t = _catalog(pkg, warehouse).create_table(
        f"db.dec_{pkg}", m.RowType.of(("k", m.BIGINT(False)), ("d", _type(pkg, spec)), ("s", m.VARCHAR(10))),
        primary_keys=["k"], options={"bucket": "1"})
    _write(t, {"k": [1, 2, 3], "d": [12345, -5, None], "s": ["abcdefghij", "ab", None]})
    return t


def test_decimal_scale_growth_rescales(tmp_warehouse):
    """DECIMAL(10,2) 123.45 (unscaled 12345) altered to DECIMAL(12,4): the
    port reads 1234500, which is 123.4500; the JAX package keeps 12345,
    which now means 1.2345 (its fault), also after its compaction."""
    out = {}
    for pkg in PKGS:
        m = _mod(pkg)
        t = _decimal_table(pkg, tmp_warehouse)
        _catalog(pkg, tmp_warehouse).alter_table(f"db.dec_{pkg}", _change(pkg).update_column_type("d", m.DECIMAL(12, 4)))
        t = _open(pkg, t.path)
        _write(t, {"k": [4], "d": [10000], "s": ["x"]})
        out[pkg] = _read(t)
    assert out["port"] == [(1, 1234500, "abcdefghij"), (2, -500, "ab"), (3, None, None), (4, 10000, "x")]
    assert out["jax"] == [(1, 12345, "abcdefghij"), (2, -5, "ab"), (3, None, None), (4, 10000, "x")]
    path = _catalog("port", tmp_warehouse).table_path("db.dec_port")
    PortCompactor(_open("port", path)).run_once(full=True)
    assert _read(_open("port", path)) == out["port"] == _read(_open("jax", path))


@pytest.mark.parametrize("column,new_type", [("d", "DECIMAL(10,1)"), ("d", "DECIMAL(9,2)"), ("s", "VARCHAR(3)"),
                                             ("s", "CHAR(5)")])
def test_narrowing_is_refused_and_a_committed_one_raises(tmp_warehouse, column, new_type):
    """The port refuses to commit a narrowing; where the JAX package
    committed one, the port's read raises ValueError naming the field
    instead of returning values whose meaning changed."""
    t = _decimal_table("port", tmp_warehouse)
    with pytest.raises(ValueError, match="not a widening"):
        _catalog("port", tmp_warehouse).alter_table("db.dec_port", PortChange.update_column_type(
            column, port_parse_type(new_type)))
    assert _open("port", t.path).schema.id == 0
    JaxCatalog(tmp_warehouse, commit_user="jax").alter_table(
        "db.dec_port", JaxChange.update_column_type(column, jax_parse_type(new_type)))
    jax_rows = _read(_open("jax", t.path))
    assert len(jax_rows) == 3  # the JAX package reads the old values unchanged
    with pytest.raises(ValueError, match=f"field '{column}'"):
        _read(_open("port", t.path))


@pytest.mark.parametrize("key_type,new_type,ok", [
    ("INT NOT NULL", "BIGINT NOT NULL", True), ("SMALLINT NOT NULL", "INT NOT NULL", True),
    ("FLOAT NOT NULL", "DOUBLE NOT NULL", True), ("VARCHAR(4) NOT NULL", "VARCHAR(9) NOT NULL", True),
    ("DATE NOT NULL", "TIMESTAMP(6) NOT NULL", False), ("INT NOT NULL", "STRING NOT NULL", False),
    ("INT NOT NULL", "DOUBLE NOT NULL", False), ("VARCHAR(4) NOT NULL", "CHAR(9) NOT NULL", False),
])
def test_key_type_changes_keep_the_key_order(tmp_warehouse, key_type, new_type, ok):
    """A key column may change type only where stored keys keep their order
    as stored (files' key ranges compare them so); the JAX package commits
    every widening."""
    m = tt
    cat = _catalog("port", tmp_warehouse)
    cat.create_table("db.kt", m.RowType.of(("k", port_parse_type(key_type)), ("v", m.BIGINT())), primary_keys=["k"])
    change = PortChange.update_column_type("k", port_parse_type(new_type))
    if ok:
        assert cat.alter_table("db.kt", change).id == 1
    else:
        with pytest.raises(ValueError, match="key column 'k'"):
            cat.alter_table("db.kt", change)
        assert JaxCatalog(tmp_warehouse).alter_table(
            "db.kt", JaxChange.update_column_type("k", jax_parse_type(new_type))).id == 1
