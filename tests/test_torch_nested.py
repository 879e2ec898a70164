"""Nested column types in the port (paimon_tpu_torch) against the JAX
package, on the CPU (device="cpu").

Types and SQL: the schema JSON of every nested shape round-trips between
the packages, nested field ids included; each DDL statement gives both the
same schema, the same SHOW CREATE TABLE and the same DdlError; SELECTs
over nested columns give the same rows or the same error.

Format, both directions: the port reads every Parquet file the JAX package
writes (through pyarrow) into the values the JAX package reads, and the JAX
package and pyarrow read every file the port writes into the values
written. The shapes: ARRAY<STRING>, MAP<STRING, BIGINT>, ARRAY<ARRAY<INT>>,
ARRAY<ROW<...>>, ARRAY<MAP<STRING, BIGINT>>, MAP<STRING, ARRAY<INT>> and a
top-level ROW holding a list and a row, each with null, empty and
null-element values, at one and at several pages and row groups, v1 and v2
data pages, under every codec the port writes, and projected with and
without the nested columns. A map compares with its entries' order. A
predicate on a flat column prunes row groups and dictionary pages of a
file with nested columns, which keep the surviving rows' values (held to
the seeded values).

Tables: for each engine (deduplicate, partial-update, first-row, and
aggregation with collect, merge_map and nested_update, each with and
without distinct, nested-key and ignore-retract), commits alternate
between the packages on one table, with -U/-D rows where the engine takes
them; the port reads under its pallas (plain versions on the CPU),
xla-segmented and numpy engines, fully compacts, and the JAX package reads
the result. IS NULL on a nested column, the manifests' null-count
statistics, nested keys, partitions and casts, and the leaf predicates
other than IS NULL, each against the JAX package; a spilled append buffer
with nested columns.

Guards: a nested column under file.format=avro, or a per-level format
naming it, raises NotImplementedError naming the format and the column;
under orc (or a per-level orc) it is written and read equal to the JAX
package's read, and a JAX-written ORC file with a LIST column reads as the
JAX package reads it (tests/test_torch_orc_nested.py holds nested ORC
against the JAX package in full).

Tolerance: exact. Values compare as Python objects, floats bit for bit
(the test values are sums of eighths, exact in float32 and float64).
"""

import io
import json

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import paimon_tpu as jt
import paimon_tpu_torch as tt
from paimon_tpu.catalog import FileSystemCatalog as JaxCatalog
from paimon_tpu.data import predicate as jpred
from paimon_tpu.data.batch import ColumnBatch as JaxBatch
from paimon_tpu.format import collect_stats as jax_collect_stats
from paimon_tpu.format import get_format as jax_format
from paimon_tpu.format import stats_to_json as jax_stats_json
from paimon_tpu.fs import LocalFileIO as JaxIO
from paimon_tpu.sql.ddl import ddl as jax_ddl
from paimon_tpu_torch.catalog import FileSystemCatalog as PortCatalog
from paimon_tpu_torch.data import predicate as tpred
from paimon_tpu_torch.data.batch import ColumnBatch as PortBatch
from paimon_tpu_torch.decode.container import ParquetFormatError
from paimon_tpu_torch.encode import WRITE_CODECS
from paimon_tpu_torch.format import collect_stats as port_collect_stats
from paimon_tpu_torch.format import stats_to_json as port_stats_json
from paimon_tpu_torch.format.orc import read_orc
from paimon_tpu_torch.format.parquet import read_parquet, write_parquet
from paimon_tpu_torch.sql.ddl import DdlError
from paimon_tpu_torch.sql.ddl import ddl as port_ddl

INSERT, UPDATE_BEFORE, UPDATE_AFTER, DELETE = 0, 1, 2, 3
PKGS = {"jax": jt, "port": tt}


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


def canon(x):
    """A value with each dict's entry order made part of it."""
    if isinstance(x, dict):
        return ("dict", [(k, canon(v)) for k, v in x.items()])
    if isinstance(x, (list, tuple)):
        return [canon(v) for v in x]
    if isinstance(x, float):
        return ("float", x.hex())
    return x


# ---------------------------------------------------------------------------
# shapes and seeded values
# ---------------------------------------------------------------------------

# name -> type spec, as the schema JSON writes it
SHAPES = {
    "tags": {"type": "ARRAY", "element": "STRING"},
    "attrs": {"type": "MAP", "key": "STRING", "value": "BIGINT"},
    "grid": {"type": "ARRAY", "element": {"type": "ARRAY", "element": "INT"}},
    "items": {"type": "ARRAY", "element": {"type": "ROW", "fields": [
        {"id": 100, "name": "sku", "type": "BIGINT"}, {"id": 101, "name": "note", "type": "STRING"}]}},
    "maps": {"type": "ARRAY", "element": {"type": "MAP", "key": "STRING", "value": "BIGINT"}},
    "lists": {"type": "MAP", "key": "STRING", "value": {"type": "ARRAY", "element": "INT"}},
    "rec": {"type": "ROW", "fields": [
        {"id": 102, "name": "x", "type": "DOUBLE"},
        {"id": 103, "name": "ys", "type": {"type": "ARRAY", "element": "STRING"}},
        {"id": 104, "name": "inner", "type": {"type": "ROW", "fields": [
            {"id": 105, "name": "f", "type": "FLOAT"}, {"id": 106, "name": "b", "type": "BOOLEAN"},
            {"id": 107, "name": "by", "type": "BYTES"}, {"id": 108, "name": "t", "type": "TINYINT"}]}}]},
}
NOT_NULL_SHAPES = {
    "tags_nn": {"type": "ARRAY NOT NULL", "element": "STRING NOT NULL"},
    "attrs_nn": {"type": "MAP NOT NULL", "key": "STRING NOT NULL", "value": "BIGINT"},
    "rec_nn": {"type": "ROW NOT NULL", "fields": [{"id": 109, "name": "a", "type": "INT NOT NULL"}]},
}


def _pick(rng, null_share: float = 0.05, empty_share: float = 0.05) -> str:
    r = rng.random()
    return "null" if r < null_share else "empty" if r < null_share + empty_share else "value"


def _scalar(rng, spec, null_share=0.1):
    if rng.random() < null_share:
        return None
    base = spec.replace(" NOT NULL", "")
    if base == "STRING":
        return f"s{int(rng.integers(0, 12))}"
    if base in ("BIGINT", "INT", "TINYINT"):
        return int(rng.integers(-100, 100))
    if base in ("DOUBLE", "FLOAT"):
        return float(rng.integers(-64, 64)) / 8
    if base == "BOOLEAN":
        return bool(rng.random() < 0.5)
    if base == "BYTES":
        return bytes(rng.integers(0, 256, int(rng.integers(0, 4))).astype(np.uint8))
    raise AssertionError(spec)


def _value(rng, spec, top: bool = True):
    """One seeded value of the type `spec`: 5% null and 5% empty at the top
    (10% null inside), 0-4 elements."""
    if isinstance(spec, str):
        return _scalar(rng, spec)
    kind = _pick(rng, 0.05 if top else 0.1, 0.05 if top else 0.1)
    if kind == "null" and "NOT NULL" not in spec["type"]:
        return None
    base = spec["type"].replace(" NOT NULL", "")
    n = 0 if kind == "empty" else int(rng.integers(1, 5))
    if base == "ARRAY":
        return [_value(rng, spec["element"], False) for _ in range(n)]
    if base == "MAP":
        keys = [f"k{int(k)}" for k in rng.choice(8, n, replace=False)]
        return {k: _value(rng, spec["value"], False) for k in keys}
    return {f["name"]: _value(rng, f["type"], False) for f in spec["fields"]}


def _row_type(pkg, shapes: dict, key: bool = True):
    fields = [pkg.DataField(0, "id", pkg.BIGINT(not key))] if key else []
    fields += [pkg.DataField(i + 1, name, pkg.types.parse_type(spec)) for i, (name, spec) in enumerate(shapes.items())]
    return pkg.RowType(fields)


def _data(shapes: dict, n: int, seed: int, ids=None) -> dict:
    rng = np.random.default_rng(seed)
    out = {"id": np.arange(n, dtype=np.int64) if ids is None else ids}
    for name, spec in shapes.items():
        out[name] = [_value(rng, spec) for _ in range(n)]
    return out


def _columns(batches, names) -> dict:
    out = {n: [] for n in names}
    for b in batches:
        for n in names:
            out[n] += b.column(n).to_pylist()
    return {n: canon([x.item() if hasattr(x, "item") else x for x in v]) for n, v in out.items()}


# ---------------------------------------------------------------------------
# types and DDL
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(SHAPES) + list(NOT_NULL_SHAPES))
def test_schema_json_round_trips_between_the_packages(name):
    spec = {**SHAPES, **NOT_NULL_SHAPES}[name]
    field = {"id": 7, "name": name, "type": spec, "description": "d"}
    port, jax = tt.DataField.from_dict(field), jt.DataField.from_dict(field)
    assert port.to_dict() == jax.to_dict() == field
    assert str(port.type) == str(jax.type) and repr(port.type.numpy_dtype()) == repr(jax.type.numpy_dtype())
    assert tt.DataField.from_dict(jax.to_dict()) == port
    assert port.type.nullable == jax.type.nullable
    schema = _row_type(tt, {name: spec})
    assert json.loads(json.dumps(schema.serialize())) == _row_type(jt, {name: spec}).serialize()


DDL = [
    "CREATE TABLE db.n (k INT NOT NULL, tags ARRAY<STRING>, PRIMARY KEY (k) NOT ENFORCED)",
    "CREATE TABLE db.n (k INT NOT NULL, attrs MAP<STRING, INT>)",
    "CREATE TABLE db.n (k INT, grid ARRAY<ARRAY<INT NOT NULL>> NOT NULL, m MAP<STRING, ARRAY<BIGINT>> COMMENT 'x')",
    "CREATE TABLE db.n (k INT, am ARRAY<MAP<STRING, BIGINT>>, d ARRAY<DECIMAL(10, 2)>)",
    "CREATE TABLE db.n (k INT, bad MAP<STRING>)",
    "CREATE TABLE db.n (k INT, bad MAP<STRING, INT, INT>)",
    "CREATE TABLE db.n (k INT, bad ARRAY<FROB>)",
]


@pytest.mark.parametrize("statement", DDL, ids=range(len(DDL)))
def test_ddl_gives_the_jax_schema(tmp_path, statement):
    got = {}
    for name, cat, run in (("jax", JaxCatalog(str(tmp_path / "j")), jax_ddl),
                           ("port", PortCatalog(str(tmp_path / "p"), device="cpu"), port_ddl)):
        try:
            created = run(cat, statement)
            shown = run(cat, "SHOW CREATE TABLE db.n")
            described = run(cat, "DESCRIBE db.n").to_pylist()
            fields = [f.to_dict() for f in cat.get_table("db.n").row_type.fields]
            got[name] = (created, shown, described, fields)
        except Exception as e:  # noqa: BLE001 - the error itself is compared
            got[name] = (type(e).__name__, str(e))
    assert got["port"] == got["jax"]
    if "bad" not in statement:
        shown = got["port"][1]
        assert "ARRAY<" in shown or "MAP<" in shown
        # the rendered statement creates the same table again
        for name, cat, run in (("jax", JaxCatalog(str(tmp_path / "j")), jax_ddl),
                               ("port", PortCatalog(str(tmp_path / "p"), device="cpu"), port_ddl)):
            run(cat, shown.replace("db.n", "db.again"))
            assert [f.to_dict() for f in cat.get_table("db.again").row_type.fields] == got[name][3]
    else:
        assert got["port"][0] == "DdlError"


QUERIES = ["SELECT * FROM db.s", "SELECT id, tags FROM db.s WHERE tags IS NULL",
           "SELECT id FROM db.s WHERE attrs IS NOT NULL ORDER BY id DESC LIMIT 3",
           "SELECT count(*) FROM db.s WHERE items IS NULL", "SELECT tags, count(*) FROM db.s GROUP BY tags"]


@pytest.mark.parametrize("query", QUERIES, ids=range(len(QUERIES)))
def test_select_over_nested_columns_as_in_the_jax_package(tmp_path, query):
    from paimon_tpu.sql import execute as jax_execute
    from paimon_tpu_torch.sql import execute as port_execute

    shapes = {k: SHAPES[k] for k in ("tags", "attrs", "items")}
    jcat, pcat = JaxCatalog(str(tmp_path)), PortCatalog(str(tmp_path), device="cpu")
    _write(jcat.create_table("db.s", _row_type(jt, shapes), primary_keys=["id"], options={"bucket": "1"}),
           _data(shapes, 40, seed=3))
    got = {name: _outcome(lambda: canon(run(cat, query).to_pylist()))
           for name, cat, run in (("jax", jcat, jax_execute), ("port", pcat, port_execute))}
    assert got["port"] == got["jax"]


def test_a_row_column_has_no_ddl_text(tmp_path):
    for pkg, cat, run, err in ((jt, JaxCatalog(str(tmp_path)), jax_ddl, Exception),
                               (tt, PortCatalog(str(tmp_path), device="cpu"), port_ddl, DdlError)):
        name = f"db.r_{pkg.__name__}"
        cat.create_table(name, _row_type(pkg, {"rec": SHAPES["rec"]}), primary_keys=["id"])
        with pytest.raises(err, match="ROW column types are not expressible in DDL text"):
            run(cat, f"SHOW CREATE TABLE {name}")


# ---------------------------------------------------------------------------
# the format, both directions
# ---------------------------------------------------------------------------

LAYOUTS = {
    "one_page": {},
    "pages_and_groups": {"parquet.page-size": "64", "parquet.row-group.rows": "70"},
    "v2_pages": {"parquet.data-page-version": "2.0", "parquet.page-size": "128"},
    "no_dictionary": {"parquet.enable.dictionary": "false", "parquet.row-group.rows": "100"},
}
ROWS = 200


def _jax_write(path: str, shapes: dict, data: dict, compression: str, options: dict) -> None:
    batch = JaxBatch.from_pydict(_row_type(jt, shapes), data)
    jax_format("parquet").write(JaxIO(), path, batch, compression, options)


def _jax_read(path: str, shapes: dict, projection=None) -> dict:
    schema = _row_type(jt, shapes)
    names = projection or schema.field_names
    return _columns(jax_format("parquet").read(JaxIO(), path, schema, names), names)


def _port_read(raw: bytes, shapes: dict, projection=None) -> dict:
    schema = _row_type(tt, shapes)
    names = projection or schema.field_names
    return _columns(read_parquet(raw, schema, names), names)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("direction", ["jax_writes", "port_writes"])
def test_every_shape_both_directions(tmp_path, layout, direction):
    data = _data(SHAPES, ROWS, seed=list(LAYOUTS).index(layout))
    path = str(tmp_path / "f.parquet")
    if direction == "jax_writes":
        _jax_write(path, SHAPES, data, "zstd", LAYOUTS[layout])
        raw = open(path, "rb").read()
    else:
        raw = write_parquet(PortBatch.from_pydict(_row_type(tt, SHAPES), data), "zstd", LAYOUTS[layout])
        open(path, "wb").write(raw)
    want = {n: canon(v if n != "id" else v.tolist()) for n, v in data.items()}
    assert _port_read(raw, SHAPES) == want
    assert _jax_read(path, SHAPES) == want
    groups = pq.ParquetFile(io.BytesIO(raw)).metadata.num_row_groups
    assert (groups > 1) == ("parquet.row-group.rows" in LAYOUTS[layout])
    if direction == "port_writes":
        table = pq.read_table(io.BytesIO(raw))
        assert canon(table.column("tags").to_pylist()) == want["tags"]
        assert canon(table.column("rec").to_pylist()) == want["rec"]
        assert canon([None if x is None else dict(x) for x in table.column("attrs").to_pylist()]) == want["attrs"]


@pytest.mark.parametrize("codec", sorted(set(WRITE_CODECS) - {"uncompressed"}))
def test_every_codec_both_directions(tmp_path, codec):
    data = _data(SHAPES, 80, seed=11)
    want = {n: canon(v if n != "id" else v.tolist()) for n, v in data.items()}
    options = {"parquet.page-size": "256"}
    port_raw = write_parquet(PortBatch.from_pydict(_row_type(tt, SHAPES), data), codec, options)
    path = str(tmp_path / "port.parquet")
    open(path, "wb").write(port_raw)
    assert _jax_read(path, SHAPES) == want
    jax_path = str(tmp_path / "jax.parquet")
    _jax_write(jax_path, SHAPES, data, codec, options)
    assert _port_read(open(jax_path, "rb").read(), SHAPES) == want


@pytest.mark.parametrize("projection", [["id"], ["id", "items"], ["rec", "id"], ["lists"]])
def test_projection_with_and_without_the_nested_columns(tmp_path, projection):
    data = _data(SHAPES, 90, seed=3)
    path = str(tmp_path / "f.parquet")
    _jax_write(path, SHAPES, data, "zstd", {"parquet.row-group.rows": "40"})
    raw = open(path, "rb").read()
    assert _port_read(raw, SHAPES, projection) == _jax_read(path, SHAPES, projection)
    port_raw = write_parquet(PortBatch.from_pydict(_row_type(tt, SHAPES), data), "zstd")
    assert _port_read(port_raw, SHAPES, projection) == _port_read(raw, SHAPES, projection)


def test_a_flat_predicate_drops_the_same_rows_of_the_nested_columns():
    """The pushdown prunes on flat columns only (row-group statistics and
    dictionary codes); the rows it keeps keep their nested values."""
    shapes = {"cat": "STRING", **{k: SHAPES[k] for k in ("tags", "items", "rec")}}
    data = _data(shapes, 300, seed=12)
    data["cat"] = [f"c{i % 3}" for i in range(300)]
    schema = _row_type(tt, shapes)
    raw = write_parquet(PortBatch.from_pydict(schema, data), "zstd", {"parquet.row-group.rows": "100"})
    for predicate, keep in ((tpred.equal("cat", "c1"), [i % 3 == 1 for i in range(300)]),
                            (tpred.less_than("id", 120), [i < 120 for i in range(300)]),
                            (tpred.is_null("tags"), [v is None for v in data["tags"]])):
        parts = read_parquet(raw, schema, schema.field_names, predicate)
        got = [b.filter(predicate.eval(b)) for b in parts]
        want = {n: canon([x.item() if hasattr(x, "item") else x for x, k in zip(v, keep) if k])
                for n, v in data.items()}
        assert _columns(got, schema.field_names) == want
        assert sum(b.num_rows for b in parts) < 300 or predicate.function == "isNull"


def test_a_projection_without_the_nested_column_decodes_none_of_its_leaves(monkeypatch):
    from paimon_tpu_torch import decode

    raw = write_parquet(PortBatch.from_pydict(_row_type(tt, SHAPES), _data(SHAPES, 30, seed=4)), "zstd")
    seen = []
    real = decode.decode_leaf
    monkeypatch.setattr(decode, "decode_leaf", lambda data, chunk, *a: seen.append(chunk.name) or real(data, chunk, *a))
    read_parquet(raw, _row_type(tt, SHAPES), ["id", "attrs"])
    assert sorted(seen) == ["attrs.key_value.key", "attrs.key_value.value"]


def test_row_fields_the_type_or_the_file_lacks_read_as_the_jax_package_reads_them(tmp_path):
    struct = pa.struct([("a", pa.int64()), ("extra", pa.list_(pa.string())), ("b", pa.string())])
    values = [{"a": 1, "extra": ["x"], "b": "p"}, None, {"a": None, "extra": None, "b": "q"}]
    path = str(tmp_path / "f.parquet")
    pq.write_table(pa.table({"id": [1, 2, 3], "r": pa.array(values, struct)}), path)
    spec = {"type": "ROW", "fields": [{"id": 10, "name": "b", "type": "STRING"},
                                      {"id": 11, "name": "c", "type": "INT"}, {"id": 12, "name": "a", "type": "BIGINT"}]}
    want = _jax_read(path, {"r": spec})
    assert want["r"] == canon([{"b": "p", "c": None, "a": 1}, None, {"b": "q", "c": None, "a": None}])
    assert _port_read(open(path, "rb").read(), {"r": spec}) == want


def test_layouts_the_jax_writer_never_makes_raise_naming_them():
    legacy = pa.schema([pa.field("k", pa.int64()), pa.field("tags", pa.list_(pa.string()))])
    buf = io.BytesIO()
    pq.write_table(pa.table({"k": [1], "tags": [["a"]]}, schema=legacy), buf, use_compliant_nested_type=False)
    schema = tt.RowType.of(("k", tt.BIGINT()), ("tags", tt.types.ArrayType(tt.STRING())))
    # pyarrow's non-compliant form is still three levels ("item"): it reads
    assert read_parquet(buf.getvalue(), schema, ["k", "tags"])[0].column("tags").to_pylist() == [["a"]]
    wrong = tt.RowType.of(("k", tt.BIGINT()), ("tags", tt.types.MapType(tt.STRING(), tt.STRING())))
    with pytest.raises(ParquetFormatError, match="LIST"):
        read_parquet(buf.getvalue(), wrong, ["tags"])
    flat = tt.RowType.of(("k", tt.types.ArrayType(tt.BIGINT())), ("tags", tt.STRING()))
    with pytest.raises(ParquetFormatError, match="nested group"):
        read_parquet(buf.getvalue(), flat, ["k"])
    with pytest.raises(ParquetFormatError, match="nested group"):
        read_parquet(buf.getvalue(), flat, ["tags"])
    from paimon_tpu_torch.decode.nested import check_layout
    from paimon_tpu_torch.decode.container import REPEATED, SchemaNode

    two_level = SchemaNode("tags", 1, "tags", 1, 0, annotation="LIST",
                           children=[SchemaNode("array", REPEATED, "tags.array", 2, 1, physical=6)])
    with pytest.raises(ParquetFormatError, match="LIST group without one repeated group|two-level"):
        check_layout(two_level, tt.types.ArrayType(tt.STRING()))


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

AGG_SHAPES = {
    "tags": SHAPES["tags"], "tags_all": SHAPES["tags"], "attrs": SHAPES["attrs"],
    "items": {"type": "ARRAY", "element": {"type": "ROW", "fields": [
        {"id": 100, "name": "sku", "type": "BIGINT"}, {"id": 101, "name": "qty", "type": "INT"}]}},
    "items_all": {"type": "ARRAY", "element": {"type": "ROW", "fields": [
        {"id": 102, "name": "sku", "type": "BIGINT"}, {"id": 103, "name": "qty", "type": "INT"}]}},
    "spend": "DOUBLE",
}
VALUE_SHAPES = {"tags": SHAPES["tags"], "attrs": SHAPES["attrs"], "items": AGG_SHAPES["items"], "a": "BIGINT"}
AGG = {"merge-engine": "aggregation", "fields.tags.aggregate-function": "collect", "fields.tags.distinct": "true",
       "fields.tags_all.aggregate-function": "collect", "fields.attrs.aggregate-function": "merge_map",
       "fields.items.aggregate-function": "nested_update", "fields.items.nested-key": "sku",
       "fields.items_all.aggregate-function": "nested_update", "fields.spend.aggregate-function": "sum"}
IGNORE = {f"fields.{f}.ignore-retract": "true" for f in ("tags", "tags_all", "attrs", "items", "items_all")}
TABLES = {
    "deduplicate": ({}, VALUE_SHAPES, (0.85, 0.0, 0.1, 0.05)),
    "partial-update": ({"merge-engine": "partial-update"}, VALUE_SHAPES, (0.85, 0.0, 0.15, 0.0)),
    "first-row": ({"merge-engine": "first-row", "first-row.ignore-delete": "true"}, VALUE_SHAPES,
                  (0.8, 0.0, 0.15, 0.05)),
    "aggregation": (AGG, AGG_SHAPES, (0.7, 0.1, 0.1, 0.1)),
    "aggregation-ignore-retract": ({**AGG, **IGNORE}, AGG_SHAPES, (0.7, 0.1, 0.1, 0.1)),
    "aggregation-inserts": (AGG, AGG_SHAPES, (1.0, 0.0, 0.0, 0.0)),
}
COMMITS, TABLE_ROWS, TABLE_IDS = 4, 60, 30


def _items(rng, nullable=True):
    """0-3 rows over 6 skus, each row a dict in the field order."""
    if nullable and rng.random() < 0.05:
        return None
    return [{"sku": int(rng.integers(0, 6)), "qty": None if rng.random() < 0.1 else int(rng.integers(1, 9))}
            for _ in range(int(rng.integers(0, 4)))]


def _table_commits(name: str):
    """Seeded commits: ids with repeats, kinds by the table's shares."""
    _, shapes, shares = TABLES[name]
    rng = np.random.default_rng(list(TABLES).index(name) + 40)
    out = []
    for c in range(COMMITS):
        ids = rng.integers(0, TABLE_IDS, TABLE_ROWS).astype(np.int64)
        data = _data({k: v for k, v in shapes.items() if k not in ("items", "items_all")}, TABLE_ROWS, 100 + c, ids)
        for k in ("items", "items_all"):
            if k in shapes:
                data[k] = [_items(rng) for _ in range(TABLE_ROWS)]
        kinds = rng.choice(4, TABLE_ROWS, p=shares).astype(np.uint8)
        out.append((data, kinds))
    return out


def _write(table, data, kinds=None):
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.write(data, kinds)
    wb.new_commit().commit(w.prepare_commit())


def _read(table, predicate=None) -> list:
    rb = table.new_read_builder()
    if predicate is not None:
        rb = rb.with_filter(predicate)
    rows = rb.new_read().read_all(rb.new_scan().plan()).to_pylist()
    return canon([[x.item() if hasattr(x, "item") else x for x in r] for r in rows])


@pytest.mark.parametrize("name", list(TABLES))
def test_tables_written_by_both_packages(tmp_path, name):
    options, shapes, _ = TABLES[name]
    opts = {"bucket": "1", "sort-engine": "pallas", "write-only": "true", **options}
    jcat, pcat = JaxCatalog(str(tmp_path)), PortCatalog(str(tmp_path), device="cpu")
    jcat.create_table("db.t", _row_type(jt, shapes), primary_keys=["id"], options=opts)
    jtable, ptable = jcat.get_table("db.t"), pcat.get_table("db.t")
    for c, (data, kinds) in enumerate(_table_commits(name)):
        _write(jtable if c % 2 == 0 else ptable, data, kinds)
    want = _read(jtable)
    assert len(want) > 10
    for engine in ("pallas", "xla-segmented", "numpy"):
        assert _read(ptable.copy({"sort-engine": engine})) == want, engine
    null_field = "tags"
    assert _read(ptable, tpred.is_null(null_field)) == _read(jtable, jpred.is_null(null_field))
    assert _read(ptable, tpred.is_not_null("attrs")) == _read(jtable, jpred.is_not_null("attrs"))
    wb = ptable.copy({"write-only": "false"}).new_batch_write_builder()
    w = wb.new_write()
    w.compact(full=True)
    wb.new_commit().commit(w.prepare_commit())
    assert _read(jcat.get_table("db.t")) == want
    assert _read(ptable) == want
    entries = ptable.store.new_scan().plan().entries
    assert len(entries) == 1
    stats = entries[0].file.value_stats
    for f in shapes:
        if isinstance(shapes[f], dict):
            assert stats[f].min is None and stats[f].max is None and stats[f].null_count is not None


def test_a_spilled_append_buffer_keeps_nested_columns(tmp_path):
    """An append table under write-buffer-spillable spills its nested
    columns to local disk and back; the JAX package reads the same rows."""
    shapes = {k: SHAPES[k] for k in ("tags", "items", "rec")}
    options = {"bucket": "1", "write-buffer-spillable": "true", "write-buffer-spill.rows": "16"}
    table = PortCatalog(str(tmp_path), device="cpu").create_table("db.log", _row_type(tt, shapes, key=False),
                                                                   options=options)
    data = _data(shapes, 100, seed=9)
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    for s in range(0, 100, 10):
        w.write({k: v[s : s + 10] for k, v in data.items()})
    (writer,) = w._writers.values()
    assert writer.spilled_bytes_total > 0
    wb.new_commit().commit(w.prepare_commit())
    w.close()
    want = canon([[data[k][i] for k in shapes] for i in range(100)])
    assert _read(table) == want
    assert _read(JaxCatalog(str(tmp_path)).get_table("db.log")) == want


def test_aggregates_keep_the_reference_rules(tmp_path):
    """collect's retraction removes the first match, distinct keeps first
    appearances, nested_update keeps a key's first position and its last
    row, merge_map drops retracted keys."""
    rows = [
        ({"tags": ["a", "b", "a"], "attrs": {"x": 1, "y": 2}, "items": [{"sku": 1, "qty": 1}, {"sku": 2, "qty": 1}]},
         INSERT),
        ({"tags": ["c", "a"], "attrs": {"y": 5, "z": 3}, "items": [{"sku": 3, "qty": 1}, {"sku": 1, "qty": 7}]},
         INSERT),
        ({"tags": ["a"], "attrs": {"x": 0}, "items": [{"sku": 2, "qty": 0}]}, UPDATE_BEFORE),
    ]
    got = {}
    for pkg, cat in (("jax", JaxCatalog(str(tmp_path / "j"))), ("port", PortCatalog(str(tmp_path / "p"), device="cpu"))):
        shapes = {k: AGG_SHAPES[k] for k in ("tags", "tags_all", "attrs", "items", "items_all")}
        table = cat.create_table("db.t", _row_type(PKGS[pkg], shapes), primary_keys=["id"],
                                 options={"bucket": "1", "write-only": "true",
                                          **{k: v for k, v in AGG.items() if "spend" not in k}})
        # one commit: its flush merges the three rows in order
        data = {"id": [1] * len(rows), "tags": [v["tags"] for v, _ in rows], "tags_all": [v["tags"] for v, _ in rows],
                "attrs": [v["attrs"] for v, _ in rows], "items": [v["items"] for v, _ in rows],
                "items_all": [v["items"] for v, _ in rows]}
        _write(table, data, np.array([k for _, k in rows], np.uint8))
        got[pkg] = _read(table)
    assert got["port"] == got["jax"]
    (_, tags, tags_all, attrs, items, items_all), = got["port"]
    assert tags == ["b", "a", "c"] and tags_all == ["b", "a", "c", "a"]
    assert attrs == canon({"y": 5, "z": 3})
    assert items == canon([{"sku": 1, "qty": 7}, {"sku": 3, "qty": 1}])
    # without a nested key a retracted row removes an equal row only
    assert items_all == canon([{"sku": 1, "qty": 1}, {"sku": 2, "qty": 1}, {"sku": 3, "qty": 1}, {"sku": 1, "qty": 7}])


def test_null_count_statistics_match_the_jax_package():
    data = _data(SHAPES, 50, seed=8)
    want = jax_stats_json(jax_collect_stats(JaxBatch.from_pydict(_row_type(jt, SHAPES), data)))
    got = port_stats_json(port_collect_stats(PortBatch.from_pydict(_row_type(tt, SHAPES), data)))
    assert got == want
    assert all(got[n]["min"] is None and got[n]["nullCount"] > 0 for n in SHAPES)


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the error itself is compared
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("key", ["tags", "tags_nn", "attrs_nn", "rec_nn"])
def test_a_nested_primary_key_fails_as_in_the_jax_package(tmp_path, key):
    spec = {**SHAPES, **NOT_NULL_SHAPES}[key]
    got = {}
    for name, cat in (("jax", JaxCatalog(str(tmp_path / "j"))), ("port", PortCatalog(str(tmp_path / "p"), device="cpu"))):
        def run(name=name, cat=cat):
            table = cat.create_table("db.k", _row_type(PKGS[name], {key: spec}, key=False), primary_keys=[key],
                                     options={"bucket": "1"})
            data = _data({key: spec}, 6, seed=1)
            _write(table, data)
            _write(table, data)
            return _read(table)
        got[name] = _outcome(run)
    assert got["port"] == got["jax"]


def test_a_nested_partition_key_behaves_as_in_the_jax_package(tmp_path):
    got = {}
    for name, cat in (("jax", JaxCatalog(str(tmp_path / "j"))), ("port", PortCatalog(str(tmp_path / "p"), device="cpu"))):
        def run(name=name, cat=cat):
            table = cat.create_table("db.p", _row_type(PKGS[name], {"tags": SHAPES["tags"]}, key=False),
                                     partition_keys=["tags"], options={"bucket": "1"})
            _write(table, {"id": [1, 2], "tags": [["a"], ["a"]]})
            return _read(table)
        got[name] = _outcome(run)
    assert got["port"] == got["jax"]


CASTS = [("tags", "STRING"), ("tags", "BIGINT"), ("attrs", "STRING"), ("id", {"type": "ARRAY", "element": "BIGINT"}),
         ("grid", {"type": "ARRAY", "element": {"type": "ARRAY", "element": "BIGINT"}})]


@pytest.mark.parametrize("field, to", CASTS, ids=[f"{f}->{json.dumps(t)}" for f, t in CASTS])
def test_casts_to_and_from_nested_types_as_in_the_jax_package(field, to):
    from paimon_tpu.data.casting import cast_explicit as jax_cast
    from paimon_tpu_torch.data.casting import cast_explicit as port_cast

    shapes = {k: SHAPES[k] for k in ("tags", "attrs", "grid")}
    data = _data(shapes, 20, seed=5)
    got = {}
    for name, pkg, cast in (("jax", jt, jax_cast), ("port", tt, port_cast)):
        schema = _row_type(pkg, shapes)
        batch = (JaxBatch if name == "jax" else PortBatch).from_pydict(schema, data)
        src = schema.field(field).type
        got[name] = _outcome(lambda: canon(cast(batch.column(field), src, pkg.types.parse_type(to)).to_pylist()))
    assert got["port"] == got["jax"]


LEAVES = [("equal", ("tags", ["s1"])), ("in_", ("attrs", [{"k1": 1}])), ("is_null", ("items",)),
          ("is_not_null", ("rec",)), ("greater_than", ("grid", 1)), ("starts_with", ("tags", "s")),
          ("between", ("lists", 0, 1))]


@pytest.mark.parametrize("fn, args", LEAVES, ids=[f for f, _ in LEAVES])
def test_leaf_predicates_on_a_nested_column_as_in_the_jax_package(fn, args):
    data = _data(SHAPES, 40, seed=6)
    got = {}
    for name, pred, batch_cls, pkg in (("jax", jpred, JaxBatch, jt), ("port", tpred, PortBatch, tt)):
        batch = batch_cls.from_pydict(_row_type(pkg, SHAPES), data)
        got[name] = _outcome(lambda: np.asarray(getattr(pred, fn)(*args).eval(batch)).tolist())
    assert got["port"] == got["jax"]


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

GUARDS = [("file.format", {"file.format": "orc"}), ("file.format", {"file.format": "avro"}),
          ("file.format.per.level", {"file.format.per.level": "0:avro"}),
          ("file.format.per.level", {"file.format.per.level": "1:orc"})]


@pytest.mark.parametrize("key, options", GUARDS, ids=[json.dumps(o) for _, o in GUARDS])
def test_nested_columns_in_orc_or_avro_raise_naming_the_format(tmp_path, key, options):
    """Avro: a nested column raises NotImplementedError naming the format
    and the column. ORC: the port writes the nested column (num-levels 2,
    so the full compaction writes level 1) and reads it equal to the JAX
    package's read of the same table."""
    cat = PortCatalog(str(tmp_path), device="cpu")
    fmt = list(options.values())[0].split(":")[-1]
    levels = {"num-levels": "2"} if fmt == "orc" else {}
    table = cat.create_table("db.g", _row_type(tt, {"tags": SHAPES["tags"]}), primary_keys=["id"],
                             options={"bucket": "1", **levels, **options})
    if fmt == "avro":
        with pytest.raises(NotImplementedError, match=rf"{key.replace('.', '[.]')}={fmt}: column 'tags' is nested"):
            _write(table, {"id": [1], "tags": [["a"]]})
        return
    data = _data({"tags": SHAPES["tags"]}, 30, seed=2)
    _write(table, data)
    wb = table.copy({"write-only": "false"}).new_batch_write_builder()
    w = wb.new_write()
    w.compact(full=True)
    wb.new_commit().commit(w.prepare_commit())
    assert [e.file.file_name.rsplit(".", 1)[1] for e in table.store.new_scan().plan().entries] == ["orc"]
    want = canon([[i, v] for i, v in zip(data["id"].tolist(), data["tags"])])
    assert _read(table) == want
    assert _read(JaxCatalog(str(tmp_path)).get_table("db.g")) == want


def test_a_jax_written_orc_list_column_raises_as_before(tmp_path):
    """A JAX-written ORC file with a LIST column: the port reads it as the
    JAX package does."""
    shapes = {"tags": SHAPES["tags"]}
    path = str(tmp_path / "f.orc")
    data = _data(shapes, 10, seed=2)
    jax_format("orc").write(JaxIO(), path, JaxBatch.from_pydict(_row_type(jt, shapes), data), "zstd", {})
    with open(path, "rb") as f:
        got = _columns(read_orc(f.read(), _row_type(tt, shapes), ["id", "tags"]), ["id", "tags"])
    want = _columns(jax_format("orc").read(JaxIO(), path, _row_type(jt, shapes), ["id", "tags"]), ["id", "tags"])
    assert got == want == {"id": data["id"].tolist(), "tags": canon(data["tags"])}
