"""Nested columns in ORC data files: the port's reader and writer
(paimon_tpu_torch/format/orc.py, orc_meta.py) against the JAX package
(paimon_tpu/format/orc.py, which goes through pyarrow.orc and
`ColumnBatch.to_arrow` / `from_arrow`), on the CPU (device="cpu").

Format level, both directions: one package writes ARRAY, MAP and ROW
columns (the shapes of tests/test_torch_nested.py and a MAP<STRING,
ARRAY<BIGINT>>, with null, empty and null-element values) under each
codec the port's ORC writer takes, and the other package, pyarrow and the
writer itself read the values written; a batch split into several stripes
by a small orc.stripe.size; leaves of every flat type inside lists, maps
and rows (their ORC kinds follow the leaf's numpy dtype, as pyarrow writes
them for the JAX package); columns all null, all empty and of null
elements only, whose children hold no entries; the port's files carry
pyarrow's type kinds, column ids, field names, encodings and streams (but
the row index and the reference writer's string dictionaries); the tail
and stripe statistics against the JAX package's `read_tail` (a nested
column gives its null count alone); a predicate on a flat column that
stands after nested ones skips the same stripes in both packages; UNION
raises NotImplementedError naming the column.

Tables: primary-key tables under file.format=orc and under a
file.format.per.level naming orc for the fully compacted level, with
commits alternating between the packages, read by both before and after
the port's full compaction and after a parquet commit on top (an ORC run
merged with a parquet run); the deduplicate, partial-update and
aggregation engines (collect, merge_map and nested_update over the values
read from ORC); merge.dict-domain over parquet flushes compacted into an
ORC level, with nested columns beside the code-backed strings.

Data is made from numpy seeds at a small size. Tolerance: exact; values
compare as Python objects, a map with its entries' order, floats bit for
bit.
"""

import io

import numpy as np
import pyarrow as pa
import pyarrow.orc as po
import pytest
from test_torch_nested import SHAPES, TABLES, _columns, _data, _read, _row_type, _table_commits, _write, canon

import paimon_tpu as jt
import paimon_tpu_torch as tt
from paimon_tpu.catalog import FileSystemCatalog as JaxCatalog
from paimon_tpu.data import predicate as jpred
from paimon_tpu.data.batch import ColumnBatch as JaxBatch
from paimon_tpu.format.orc import OrcFormat
from paimon_tpu.format.orc_meta import read_tail as jax_read_tail
from paimon_tpu.fs import LocalFileIO as JaxIO
from paimon_tpu.metrics import registry as jax_registry
from paimon_tpu_torch.catalog import FileSystemCatalog as PortCatalog
from paimon_tpu_torch.data import predicate as tpred
from paimon_tpu_torch.data.batch import ColumnBatch as PortBatch
from paimon_tpu_torch.format import orc as port_orc
from paimon_tpu_torch.format.orc import decompress_column_streams, read_orc, write_orc
from paimon_tpu_torch.format.orc_meta import read_tail
from paimon_tpu_torch.metrics import registry as port_registry

CODECS = ("zstd", "zlib", "snappy", "lz4", "uncompressed")
WRITERS = ("jax", "port")
PKGS = {"jax": jt, "port": tt}
NESTED = {**SHAPES, "lists_of_longs": {"type": "MAP", "key": "STRING", "value": {"type": "ARRAY", "element": "BIGINT"}}}


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """pyarrow's lazy first-use initialisation on the main thread (the JAX
    writer encodes on a flush thread)."""
    po.write_table(pa.table({"x": [0]}), io.BytesIO())


def _write_file(path: str, writer: str, shapes: dict, data: dict, codec: str = "zstd", options=None) -> bytes:
    """One package's ORC file of `data` at `path`; its bytes."""
    options = options or {}
    if writer == "jax":
        OrcFormat().write(JaxIO(), path, JaxBatch.from_pydict(_row_type(jt, shapes), data), codec, options)
        with open(path, "rb") as f:
            return f.read()
    raw = write_orc(PortBatch.from_pydict(_row_type(tt, shapes), data), codec, options)
    with open(path, "wb") as f:
        f.write(raw)
    return raw


def _jax_read(path: str, shapes: dict, predicate=None) -> dict:
    schema = _row_type(jt, shapes)
    return _columns(OrcFormat().read(JaxIO(), path, schema, None, predicate), schema.field_names)


def _port_read(raw: bytes, shapes: dict, predicate=None) -> dict:
    schema = _row_type(tt, shapes)
    return _columns(read_orc(raw, schema, None, predicate), schema.field_names)


def _want(data: dict) -> dict:
    return {n: canon(v.tolist() if isinstance(v, np.ndarray) else v) for n, v in data.items()}


# ---------------------------------------------------------------------------
# format level
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("writer", WRITERS)
def test_files_each_way(tmp_path, writer, codec):
    """One package writes every nested shape under `codec`; the other
    package, pyarrow and the writer itself read the values written."""
    data = _data(NESTED, 300, seed=CODECS.index(codec))
    path = str(tmp_path / "f.orc")
    raw = _write_file(path, writer, NESTED, data, codec)
    want = _want(data)
    assert _port_read(raw, NESTED) == want
    assert _jax_read(path, NESTED) == want
    table = po.ORCFile(io.BytesIO(raw)).read()
    assert canon(table.column("tags").to_pylist()) == want["tags"]
    assert canon(table.column("rec").to_pylist()) == want["rec"]
    assert canon([None if x is None else dict(x) for x in table.column("attrs").to_pylist()]) == want["attrs"]


@pytest.mark.parametrize("writer", WRITERS)
def test_a_batch_split_into_stripes(tmp_path, writer):
    """A small orc.stripe.size splits the batch: each stripe carries its
    own PRESENT, LENGTH and child streams, and both packages read the rows
    back in order, also through a projection that skips nested columns."""
    data = _data(NESTED, 5000, seed=21)
    path = str(tmp_path / "f.orc")
    raw = _write_file(path, writer, NESTED, data, "uncompressed", {"orc.stripe.size": "32768"})
    tail = read_tail(raw)
    assert tail.nstripes > 1
    want = _want(data)
    assert _port_read(raw, NESTED) == want
    assert _jax_read(path, NESTED) == want
    names = ["id", "items", "lists_of_longs"]
    assert _columns(read_orc(raw, _row_type(tt, NESTED), names), names) == {n: want[n] for n in names}
    for s in range(tail.nstripes):
        footer = port_orc._stripe_footer(raw, tail, s)
        for name in ("tags", "attrs", "grid"):
            assert (tail.field_columns[name], port_orc.S_LENGTH) in footer.streams


def _flat(rng, spec: str):
    """One seeded value of a flat type, 10% null."""
    if rng.random() < 0.1:
        return None
    base = spec.split("(")[0]
    if base == "BOOLEAN":
        return bool(rng.random() < 0.5)
    if base in ("TINYINT", "SMALLINT", "INT", "DATE"):
        return int(rng.integers(-100, 100))
    if base in ("BIGINT", "TIMESTAMP", "DECIMAL"):
        return int(rng.integers(-(2**40), 2**40))
    if base in ("FLOAT", "DOUBLE"):
        return float(rng.integers(-64, 64)) / 8
    if base == "BYTES":
        return bytes(rng.integers(0, 256, int(rng.integers(0, 4))).astype(np.uint8))
    return f"c{int(rng.integers(0, 99))}"


LEAVES = ("BOOLEAN", "TINYINT", "SMALLINT", "INT", "BIGINT", "FLOAT", "DOUBLE", "STRING", "CHAR(4)", "BYTES", "DATE",
          "TIMESTAMP(6)", "DECIMAL(10, 2)")
KINDS = {f"a{i}": {"type": "ARRAY", "element": leaf} for i, leaf in enumerate(LEAVES)}
KINDS["m"] = {"type": "MAP", "key": "INT", "value": "DATE"}
KINDS["r"] = {"type": "ROW", "fields": [{"id": 200, "name": "ts", "type": "TIMESTAMP(6)"},
                                        {"id": 201, "name": "dec", "type": "DECIMAL(10, 2)"},
                                        {"id": 202, "name": "flag", "type": "BOOLEAN"}]}


def _kinds_data(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {"id": np.arange(n, dtype=np.int64)}
    for name, spec in KINDS.items():
        col = []
        for _ in range(n):
            r = rng.random()
            if r < 0.05:
                col.append(None)
            elif spec["type"] == "ARRAY":
                col.append([_flat(rng, spec["element"]) for _ in range(int(rng.integers(0, 4)))])
            elif spec["type"] == "MAP":
                col.append({int(k): _flat(rng, "DATE") for k in rng.choice(50, int(rng.integers(0, 4)), replace=False)})
            else:
                col.append({f["name"]: _flat(rng, f["type"]) for f in spec["fields"]})
        out[name] = col
    return out


@pytest.mark.parametrize("writer", WRITERS)
def test_every_leaf_kind_inside_lists_maps_and_rows(tmp_path, writer):
    """Leaves of every flat type: the port's file carries the kinds pyarrow
    writes for the JAX package (a DATE element an INT, a TIMESTAMP and a
    DECIMAL a LONG, a CHAR a STRING), and each package reads the other's."""
    data = _kinds_data(200, seed=4)
    path = str(tmp_path / "f.orc")
    raw = _write_file(path, writer, KINDS, data)
    want = _want(data)
    assert _port_read(raw, KINDS) == want
    assert _jax_read(path, KINDS) == want
    other = _write_file(str(tmp_path / "g.orc"), "port" if writer == "jax" else "jax", KINDS, data)
    mine, theirs = read_tail(raw), read_tail(other)
    assert [(t.kind, t.subtypes, t.names) for t in mine.types] == [(t.kind, t.subtypes, t.names) for t in theirs.types]
    assert mine.types[mine.field_columns["a10"] + 1].kind == port_orc.K_INT
    assert mine.types[mine.field_columns["a11"] + 1].kind == port_orc.K_LONG


def test_port_files_carry_the_kinds_pyarrow_writes(tmp_path):
    """The port's nested file has pyarrow's type tree (kinds, pre-order
    column ids, STRUCT field names), field columns, encodings (DIRECT_V2
    for a LIST or MAP, DIRECT for a STRUCT) and streams (PRESENT only
    where a column holds nulls, LENGTH for a LIST or MAP), less the row
    index; the one difference is the reference (Java) writer's dictionary
    for a STRING leaf of few distinct values."""
    data = _data(NESTED, 400, seed=5)
    jdata = _write_file(str(tmp_path / "j.orc"), "jax", NESTED, data)
    pdata = _write_file(str(tmp_path / "p.orc"), "port", NESTED, data)
    jt_, pt_ = read_tail(jdata), read_tail(pdata)
    assert [(t.kind, t.subtypes, t.names) for t in pt_.types] == [(t.kind, t.subtypes, t.names) for t in jt_.types]
    assert pt_.field_columns == jt_.field_columns
    assert pt_.field_columns["attrs"] == 4  # tags (2) and its element (3) come first
    js, ps = port_orc._stripe_footer(jdata, jt_, 0), port_orc._stripe_footer(pdata, pt_, 0)
    dictionary = {c for c, e in enumerate(ps.encodings) if e[0] == port_orc.E_DICTIONARY_V2}
    assert dictionary and all(pt_.types[c].kind == port_orc.K_STRING for c in dictionary)
    assert [e[0] for c, e in enumerate(ps.encodings) if c not in dictionary] == [
        e[0] for c, e in enumerate(js.encodings) if c not in dictionary]
    for c, t in enumerate(pt_.types):
        if t.kind in (port_orc.K_LIST, port_orc.K_MAP):
            assert ps.encodings[c][0] == port_orc.E_DIRECT_V2
        elif t.kind == port_orc.K_STRUCT:
            assert ps.encodings[c][0] == port_orc.E_DIRECT
    assert set(ps.streams) == {k for k in js.streams if k[1] != port_orc.S_ROW_INDEX} | {
        (c, port_orc.S_DICTIONARY_DATA) for c in dictionary}


def _stats_rows(tail) -> list:
    return [{k: (v.min, v.max, v.null_count, v.row_count) for k, v in tail.stripe_stats(i).items()}
            for i in range(tail.nstripes)]


@pytest.mark.parametrize("writer", ["pyarrow", "port"])
def test_read_tail_matches_the_jax_package(tmp_path, writer):
    """Multi-stripe bytes with nested columns before and after flat ones:
    the port's read_tail gives the JAX package's compression, stripe rows,
    field columns and stripe stats; a nested column's are its null count
    alone, which agrees with each stripe's contents."""
    shapes = {"tags": NESTED["tags"], "id2": "BIGINT", "attrs": NESTED["attrs"], "rec": NESTED["rec"], "s": "STRING"}
    data = _data({k: v for k, v in shapes.items() if isinstance(v, dict)}, 6000, seed=7)
    data["id2"] = [None if i % 7 == 0 else i for i in range(6000)]
    data["s"] = [f"k{i % 500:03d}" for i in range(6000)]
    path = str(tmp_path / "f.orc")
    if writer == "pyarrow":
        # pyarrow's stripe size bounds compressed bytes: uncompressed splits
        _write_file(path, "jax", shapes, data, "uncompressed", {"orc.stripe.size": "16384"})
        with open(path, "rb") as f:
            raw = f.read()
    else:
        raw = _write_file(path, "port", shapes, data, "zstd", {"orc.stripe.size": "65536"})
    mine, theirs = read_tail(raw), jax_read_tail(raw)
    assert mine.nstripes == theirs.nstripes > 1
    assert (mine.compression, mine.stripe_rows, mine.field_columns) == (
        theirs.compression, theirs.stripe_rows, theirs.field_columns)
    assert _stats_rows(mine) == _stats_rows(theirs)
    arrow = po.ORCFile(io.BytesIO(raw))
    for i in range(mine.nstripes):
        st, chunk = mine.stripe_stats(i), arrow.read_stripe(i)
        for name in ("tags", "attrs", "rec"):
            assert (st[name].min, st[name].max, st[name].null_count) == (None, None, chunk[name].null_count)
        ids = [x for x in chunk["id2"].to_pylist() if x is not None]
        assert (st["id2"].min, st["id2"].max, st["id2"].null_count) == (min(ids), max(ids), chunk["id2"].null_count)


@pytest.mark.parametrize("writer", WRITERS)
def test_a_flat_predicate_beside_nested_columns_skips_the_same_stripes(tmp_path, writer):
    """Sorted ids after three nested columns (so the id column's ORC id is
    not its field index): an equality on it skips the same stripes in both
    packages, and the rows kept hold their nested values."""
    shapes = {k: NESTED[k] for k in ("tags", "attrs", "items")}
    data = _data(shapes, 6000, seed=9)
    shapes["key"] = "BIGINT"
    data["key"] = np.arange(6000, dtype=np.int64)
    path = str(tmp_path / "f.orc")
    raw = _write_file(path, writer, shapes, data, "uncompressed", {"orc.stripe.size": "16384"})
    tail = read_tail(raw)
    assert tail.nstripes > 2 and tail.field_columns["key"] > len(shapes)
    skipped, got = {}, {}
    for pkg, registry, P, read in (("jax", jax_registry, jpred, lambda p: _jax_read(path, shapes, p)),
                                   ("port", port_registry, tpred, lambda p: _port_read(raw, shapes, p))):
        counter = registry.group("scan").counter("orc_stripes_skipped")
        before = counter.count
        got[pkg] = read(P.equal("key", 4500))
        skipped[pkg] = counter.count - before
    assert skipped["jax"] == skipped["port"] > 0
    assert got["jax"] == got["port"]
    row = got["port"]["key"].index(4500)
    assert got["port"]["items"][row] == canon(data["items"][4500])


@pytest.mark.parametrize("writer", WRITERS)
def test_columns_whose_children_hold_no_entries(tmp_path, writer):
    """A column all null, one of empty lists and maps only, and one whose
    elements are all null: the children have no entries, or no present
    ones, and their streams may be absent; each package reads the other's."""
    n = 1500
    shapes = {"nulls": NESTED["tags"], "empty": NESTED["grid"], "no_keys": NESTED["attrs"],
              "null_elems": NESTED["items"], "null_rows": NESTED["rec"]}
    data = {"id": np.arange(n, dtype=np.int64), "nulls": [None] * n, "empty": [[] if i % 3 else None for i in range(n)],
            "no_keys": [{} for _ in range(n)], "null_elems": [[None, None] if i % 2 else [] for i in range(n)],
            "null_rows": [None if i % 2 else {"x": None, "ys": None, "inner": None} for i in range(n)]}
    path = str(tmp_path / "f.orc")
    raw = _write_file(path, writer, shapes, data, "zstd", {"orc.stripe.size": "4096"})
    want = _want(data)
    assert _port_read(raw, shapes) == want
    assert _jax_read(path, shapes) == want


def test_rows_match_struct_fields_by_name(tmp_path):
    """A ROW read by a type whose fields differ from the file's STRUCT: a
    field the file lacks reads as None, one the type lacks is not read,
    and fields come in the type's order."""
    data = _data({"rec": NESTED["rec"]}, 100, seed=12)
    raw = _write_file(str(tmp_path / "f.orc"), "port", {"rec": NESTED["rec"]}, data)
    read_spec = {"type": "ROW", "fields": [{"id": 103, "name": "ys", "type": {"type": "ARRAY", "element": "STRING"}},
                                           {"id": 110, "name": "gone", "type": "INT"},
                                           {"id": 102, "name": "x", "type": "DOUBLE"}]}
    got = _port_read(raw, {"rec": read_spec})["rec"]
    want = canon([None if r is None else {"ys": r["ys"], "gone": None, "x": r["x"]} for r in data["rec"]])
    assert got == want


def test_decompress_column_streams_counts_a_nested_subtree(tmp_path):
    """The staged read's stream count covers a nested column's children."""
    data = _data(NESTED, 300, seed=13)
    raw = _write_file(str(tmp_path / "f.orc"), "port", NESTED, data)
    tail = read_tail(raw)
    footer = port_orc._stripe_footer(raw, tail, 0)
    own = sum(ln for (c, _), (_, ln) in footer.streams.items() if c == tail.field_columns["items"])
    assert tail.subtree(tail.field_columns["items"]) == list(range(tail.field_columns["items"], tail.field_columns["maps"]))
    assert decompress_column_streams(raw, ["items"]) > own > 0


def test_a_union_column_raises_naming_it():
    u = pa.UnionArray.from_sparse(pa.array([0, 1, 0], pa.int8()), [pa.array([1, 2, 3]), pa.array(["a", "b", "c"])])
    buf = io.BytesIO()
    po.write_table(pa.table({"u": u}), buf)
    schema = tt.RowType.of(("u", tt.STRING()))
    with pytest.raises(NotImplementedError, match=r"\(UNION\) of column 'u' is not supported by the torch port"):
        read_orc(buf.getvalue(), schema)


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

LAYOUTS = {"orc": {"file.format": "orc"}, "orc_top_level": {"file.format.per.level": "5:orc"}}
ENGINES = ("deduplicate", "partial-update", "aggregation")


def _full_compaction(table) -> None:
    wb = table.copy({"write-only": "false"}).new_batch_write_builder()
    w = wb.new_write()
    w.compact(full=True)
    wb.new_commit().commit(w.prepare_commit())


def _data_files(table) -> list[str]:
    return sorted(e.file.file_name for e in table.store.new_scan().plan().entries)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tables_in_orc(tmp_path, layout, engine):
    """Commits alternate between the packages on one nested table; both
    read it equal before and after the port's full compaction (into ORC),
    and after a parquet or ORC commit on top, which the read merges with
    the compacted ORC run."""
    options, shapes, _ = TABLES[engine]
    opts = {"bucket": "1", "sort-engine": "pallas", "write-only": "true", **options, **LAYOUTS[layout]}
    jcat, pcat = JaxCatalog(str(tmp_path)), PortCatalog(str(tmp_path), device="cpu")
    jcat.create_table("db.t", _row_type(jt, shapes), primary_keys=["id"], options=opts)
    jtable, ptable = jcat.get_table("db.t"), pcat.get_table("db.t")
    commits = _table_commits(engine)
    for c, (data, kinds) in enumerate(commits[:-1]):
        _write(jtable if c % 2 == 0 else ptable, data, kinds)
    want = _read(jtable)
    assert len(want) > 10
    assert _read(ptable) == want
    first = "orc" if layout == "orc" else "parquet"
    assert {f.rsplit(".", 1)[1] for f in _data_files(ptable)} == {first}
    _full_compaction(ptable)
    assert [f.rsplit(".", 1)[1] for f in _data_files(ptable)] == ["orc"]
    assert _read(jcat.get_table("db.t")) == want
    assert _read(ptable) == want
    data, kinds = commits[-1]
    _write(ptable, data, kinds)
    assert {f.rsplit(".", 1)[1] for f in _data_files(ptable)} == {"orc", first}
    want = _read(jcat.get_table("db.t"))
    for engine_name in ("pallas", "xla-segmented", "numpy"):
        assert _read(ptable.copy({"sort-engine": engine_name})) == want, engine_name


def test_dict_domain_compaction_into_orc_with_nested_columns(tmp_path):
    """merge.dict-domain over parquet flushes (file.format.per.level
    0:parquet) compacted into ORC: the compaction reads code-backed strings
    beside nested columns and writes the strings plainly (the JAX
    package's write refuses the DictionaryArray it makes; ROADMAP Queue 3
    item 25); both packages read the port's table as the JAX package read
    it before the compaction."""
    shapes = {"s": "STRING", "tags": NESTED["tags"], "attrs": NESTED["attrs"], "rec": NESTED["rec"]}
    options = {"bucket": "1", "file.format": "orc", "file.format.per.level": "0:parquet", "merge.dict-domain": "true",
               "write-only": "true"}
    wh = str(tmp_path)
    jcat, pcat = JaxCatalog(wh), PortCatalog(wh, device="cpu")
    jcat.create_table("db.d", _row_type(jt, shapes), primary_keys=["id"], options=options)
    ptable = pcat.get_table("db.d")
    for r in range(3):
        ids = np.arange(r * 10, r * 10 + 50, dtype=np.int64)
        data = _data({k: v for k, v in shapes.items() if k != "s"}, 50, seed=30 + r, ids=ids)
        data["s"] = [None if i % 9 == 0 else f"k{(i + r) % 7}" for i in ids]
        _write(ptable, data)
    want = _read(jcat.get_table("db.d"))
    _full_compaction(ptable)
    assert [f.rsplit(".", 1)[1] for f in _data_files(ptable)] == ["orc"]
    assert _read(ptable) == want
    assert _read(jcat.get_table("db.d")) == want
