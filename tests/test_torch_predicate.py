"""Predicates in the port (paimon_tpu_torch/data/predicate.py) against the
JAX package's (paimon_tpu/data/predicate.py), and the reads they filter.

- Eval: every leaf function and and/or trees over every type the port
  writes, a fifth of each column null, one seed-11 batch built in both
  packages from the same numpy vectors; masks must be equal.
- Stats: test_stats on min/max/null-count stats collected by each
  package's collect_stats over ten slices of that batch (one all null);
  the verdicts must be equal.
- Reads: tables written by either package (bucket 2, four overlapping
  commits with -D rows; a partitioned one; a file of many row groups)
  read by the port with with_filter under the numpy, xla-segmented and
  pallas sort engines, against the JAX package's read of the same table
  (Pallas in interpret mode, its plain index download): the same rows in
  the same order, and the same splits and files planned.

Tolerance: exact; the rows hold integers, booleans, strings and doubles
copied from the written values.
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
from paimon_tpu.data.batch import Column as JaxColumn
from paimon_tpu.data.batch import ColumnBatch as JaxBatch
from paimon_tpu.format import collect_stats as jax_collect_stats
from paimon_tpu.types import parse_type as jax_parse_type
from paimon_tpu_torch.catalog import FileSystemCatalog as PortCatalog
from paimon_tpu_torch.data import predicate as tp
from paimon_tpu_torch.data.batch import Column as PortColumn
from paimon_tpu_torch.data.batch import ColumnBatch as PortBatch
from paimon_tpu_torch.format import collect_stats as port_collect_stats
from paimon_tpu_torch.format.parquet import read_parquet
from paimon_tpu_torch.types import parse_type as port_parse_type

ENGINES = ["numpy", "xla-segmented", "pallas"]
N = 240


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


@pytest.fixture(scope="module")
def warehouse(tmp_path_factory):
    return str(tmp_path_factory.mktemp("torch_predicate_warehouse"))


# ---------------------------------------------------------------------------
# eval and stats on one batch
# ---------------------------------------------------------------------------

COLUMNS = {
    "tiny": "TINYINT",
    "small": "SMALLINT",
    "i": "INT",
    "big": "BIGINT",
    "f": "FLOAT",
    "d": "DOUBLE",
    "b": "BOOLEAN",
    "day": "DATE",
    "ts": "TIMESTAMP(6)",
    "dec": "DECIMAL(18, 2)",
    "s": "STRING",
    "vc": "VARCHAR(10)",
    "by": "BYTES",
}
STRINGS = ("s", "vc")


def _vectors() -> dict:
    rng = np.random.default_rng(11)
    words = np.array(["", "a", "ab", "abc", "b", "ba", "zeta", "Zürich", "東京", "a\x00"], dtype=object)
    out = {
        "tiny": rng.integers(-128, 128, N).astype(np.int8),
        "small": rng.integers(-500, 500, N).astype(np.int16),
        "i": rng.integers(-1000, 1000, N).astype(np.int32),
        "big": rng.integers(-(1 << 40), 1 << 40, N).astype(np.int64),
        "f": rng.normal(size=N).astype(np.float32),
        "d": rng.normal(size=N),
        "b": rng.random(N) < 0.5,
        "day": rng.integers(18000, 20000, N).astype(np.int32),
        "ts": rng.integers(0, 1 << 50, N).astype(np.int64),
        "dec": rng.integers(-10**6, 10**6, N).astype(np.int64),
        "s": words[rng.integers(0, len(words), N)],
        "vc": np.array([f"v{x:03d}" for x in rng.integers(0, 60, N)], dtype=object),
        "by": np.array([bytes([x % 7, x % 3]) for x in rng.integers(0, 50, N)], dtype=object),
    }
    valid = {name: rng.random(N) >= 0.2 for name in COLUMNS}
    for name, v in out.items():
        if v.dtype == object:
            v[~valid[name]] = None
    return out, valid


def _batches():
    values, valid = _vectors()
    jtype = jt.RowType.of(*((n, jax_parse_type(t)) for n, t in COLUMNS.items()))
    ptype = tt.RowType.of(*((n, port_parse_type(t)) for n, t in COLUMNS.items()))
    jb = JaxBatch(jtype, {n: JaxColumn(values[n].copy(), valid[n].copy()) for n in COLUMNS})
    pb = PortBatch(ptype, {n: PortColumn(values[n].copy(), valid[n].copy()) for n in COLUMNS})
    return values, valid, jb, pb


def _literal(values, valid, name, i):
    v = values[name][valid[name]][i]
    return v.item() if hasattr(v, "item") else v


def _leaves(values, valid) -> list[tuple]:
    """(function, field, literals) of every leaf function on every column."""
    out = []
    for name in COLUMNS:
        lo, mid, hi = sorted(_literal(values, valid, name, i) for i in (0, 1, 2))
        out += [("equal", name, mid), ("notEqual", name, mid), ("isNull", name, None), ("isNotNull", name, None)]
        if name == "b":
            continue
        out += [("lessThan", name, mid), ("lessOrEqual", name, mid), ("greaterThan", name, mid),
                ("greaterOrEqual", name, mid), ("in", name, [lo, hi, mid]), ("notIn", name, [lo, hi]),
                ("between", name, [lo, hi])]
        if name in STRINGS:
            for f in ("startsWith", "endsWith", "contains", "notStartsWith", "notEndsWith", "notContains"):
                out.append((f, name, mid[:2]))
    return out


def _trees(leaves) -> list:
    """Twenty and/or trees of depth two over the leaves, drawn with seed 5."""
    rng = np.random.default_rng(5)
    out = []
    for _ in range(20):
        kids = []
        for _ in range(2):
            picked = [leaves[i] for i in rng.choice(len(leaves), 3, replace=False)]
            kids.append(("or" if rng.random() < 0.5 else "and", picked))
        out.append(("and" if rng.random() < 0.5 else "or", kids))
    return out


def _build(pkg, node):
    if node[0] in ("and", "or"):
        return (pkg.and_ if node[0] == "and" else pkg.or_)(*(_build(pkg, k) for k in node[1]))
    return pkg.LeafPredicate(*node)


def test_leaf_eval_matches_the_reference_on_every_type():
    values, valid, jb, pb = _batches()
    leaves = _leaves(values, valid)
    assert len(leaves) > 100
    for leaf in leaves:
        want = jp.LeafPredicate(*leaf).eval(jb)
        got = tp.LeafPredicate(*leaf).eval(pb)
        assert got.dtype == np.bool_ and np.array_equal(got, want), leaf
        neg_j, neg_p = jp.LeafPredicate(*leaf).negate(), tp.LeafPredicate(*leaf).negate()
        assert (neg_j is None) == (neg_p is None), leaf
        if neg_p is not None:
            assert neg_p.to_dict() == neg_j.to_dict()
            assert np.array_equal(neg_p.eval(pb), neg_j.eval(jb)), leaf
    # null rows match no value function, and not* functions exclude them too
    for name in COLUMNS:
        if name != "b":
            mask = tp.not_in(name, [_literal(values, valid, name, 0)]).eval(pb)
            assert not mask[~valid[name]].any()


def test_compound_eval_and_serialisation_match_the_reference():
    values, valid, jb, pb = _batches()
    leaves = _leaves(values, valid)
    for tree in _trees(leaves):
        want, got = _build(jp, tree), _build(tp, tree)
        assert got.to_dict() == want.to_dict()
        assert np.array_equal(got.eval(pb), want.eval(jb))
        # either package rebuilds the other's serialised tree
        assert np.array_equal(tp.Predicate.from_dict(want.to_dict()).eval(pb), want.eval(jb))
        assert got.referenced_fields() == want.referenced_fields()
        nj, np_ = want.negate(), got.negate()
        assert (nj is None) == (np_ is None)
        if np_ is not None:
            assert np.array_equal(np_.eval(pb), nj.eval(jb))
    a, b = tp.greater_than("i", 0), tp.less_than("i", 500)
    assert (a & b).to_dict() == (jp.greater_than("i", 0) & jp.less_than("i", 500)).to_dict()
    assert (a | b).function == "or" and len((a & b & a).children) == 3


def test_builder_split_and_pick_match_the_reference():
    ptype = tt.RowType.of(("k", tt.BIGINT(False)), ("v", tt.STRING()))
    jtype = jt.RowType.of(("k", jt.BIGINT(False)), ("v", jt.STRING()))
    pb, jb = tp.PredicateBuilder(ptype), jp.PredicateBuilder(jtype)
    for name, args in (("equal", ("k", 1)), ("not_equal", ("k", 1)), ("less_than", ("k", 2)),
                       ("less_or_equal", ("k", 2)), ("greater_than", ("k", 2)), ("greater_or_equal", ("k", 2)),
                       ("is_null", ("v",)), ("is_not_null", ("v",)), ("in_", ("k", [1, 2])),
                       ("between", ("k", 1, 5)), ("starts_with", ("v", "x"))):
        assert getattr(pb, name)(*args).to_dict() == getattr(jb, name)(*args).to_dict()
    with pytest.raises(KeyError):
        pb.equal("nope", 1)
    pred = tp.and_(tp.equal("k", 1), tp.or_(tp.equal("v", "a"), tp.equal("k", 2)), tp.is_null("v"))
    jpred = jp.and_(jp.equal("k", 1), jp.or_(jp.equal("v", "a"), jp.equal("k", 2)), jp.is_null("v"))
    parts, jparts = tp.PredicateBuilder.split_and(pred), jp.PredicateBuilder.split_and(jpred)
    assert [p.to_dict() for p in parts] == [p.to_dict() for p in jparts]
    for fields in ({"k"}, {"v"}, {"k", "v"}, set()):
        assert [p.to_dict() for p in tp.PredicateBuilder.pick_by_fields(parts, fields)] == [
            p.to_dict() for p in jp.PredicateBuilder.pick_by_fields(jparts, fields)]
    assert tp.PredicateBuilder.split_and(None) == []


def test_stats_verdicts_match_the_reference():
    """Ten slices of the batch (the last all null): each package's own
    collect_stats, each package's predicates; also the JAX package's
    stats read by the port's predicates, and an unknown null count."""
    values, valid, jb, pb = _batches()
    leaves = _leaves(values, valid)
    trees = _trees(leaves)
    bounds = np.linspace(0, N, 11).astype(int)
    verdicts = 0
    for s in range(10):
        rows = np.arange(bounds[s], bounds[s + 1])
        jslice, pslice = jb.take(rows), pb.take(rows)
        if s == 9:
            jslice = JaxBatch(jb.schema, {n: JaxColumn(jslice.column(n).values, np.zeros(len(rows), np.bool_))
                                          for n in COLUMNS})
            pslice = PortBatch(pb.schema, {n: PortColumn(pslice.column(n).values, np.zeros(len(rows), np.bool_))
                                           for n in COLUMNS})
        jstats, pstats = jax_collect_stats(jslice), port_collect_stats(pslice)
        assert {n: tuple(vars(st).values()) for n, st in pstats.items()} == {
            n: (st.min, st.max, st.null_count, st.row_count) for n, st in jstats.items()}
        # the JAX package's FieldStats read by the port's predicates
        crossed = {n: tp.FieldStats(st.min, st.max, st.null_count, st.row_count) for n, st in jstats.items()}
        unknown = {n: tp.FieldStats(st.min, st.max, None, st.row_count) for n, st in pstats.items()}
        junknown = {n: jp.FieldStats(st.min, st.max, None, st.row_count) for n, st in jstats.items()}
        for leaf in leaves:
            want = jp.LeafPredicate(*leaf).test_stats(jstats)
            assert tp.LeafPredicate(*leaf).test_stats(pstats) == want, (s, leaf)
            assert tp.LeafPredicate(*leaf).test_stats(crossed) == want, (s, leaf)
            assert tp.LeafPredicate(*leaf).test_stats(unknown) == jp.LeafPredicate(*leaf).test_stats(junknown)
            # sound: a slice with a matching row is never pruned
            if tp.LeafPredicate(*leaf).eval(pslice).any():
                assert tp.LeafPredicate(*leaf).test_stats(pstats), (s, leaf)
            verdicts += 1
        for tree in trees:
            assert _build(tp, tree).test_stats(pstats) == _build(jp, tree).test_stats(jstats)
    assert verdicts > 1000
    assert tp.equal("nope", 1).test_stats({}) and jp.equal("nope", 1).test_stats({})


# ---------------------------------------------------------------------------
# filtered reads of tables written by either package
# ---------------------------------------------------------------------------


def _row_type(pkg):
    return pkg.RowType.of(("id", pkg.BIGINT(False)), ("c", pkg.INT()), ("d", pkg.DOUBLE()), ("s", pkg.STRING()))


def _rows(ids: np.ndarray, r: int) -> dict:
    return {
        "id": ids.astype(np.int64),
        "c": [None if x % 9 == r else int(x % 50 + 100 * r) for x in ids],
        "d": ids * 0.25 + r,
        "s": np.array([None if x % 11 == 0 else f"s{int(x) % 40:02d}-{r}" for x in ids], dtype=object),
    }


def _read(table, predicate=None, engine=None, projection=None) -> list:
    if engine is not None:
        table = table.copy({"sort-engine": engine})
    rb = table.new_read_builder()
    if predicate is not None:
        rb = rb.with_filter(predicate)
    if projection is not None:
        rb = rb.with_projection(projection)
    out = rb.new_read().read_all(rb.new_scan().plan())
    return [tuple(v.item() if hasattr(v, "item") else v for v in row) for row in out.to_pylist()]


def _jax_read(table, predicate=None, engine=None, projection=None) -> list:
    # the JAX package's plain index download (what the port mirrors)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PAIMON_TPU_FORCE_COMPACT", "0")
        return _read(table, predicate, engine, projection)


def _commit(table, rows: dict, kinds=None) -> None:
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.write(rows, kinds) if kinds is not None else w.write(rows)
    wb.new_commit().commit(w.prepare_commit())


def _predicates(pkg) -> dict:
    """Key-only, value-only, mixed and null predicates."""
    return {
        "key_between": pkg.between("id", 300, 520),
        "key_in": pkg.in_("id", [3, 17, 450, 451, 999, 5000]),
        "value_gt": pkg.greater_than("d", 150.0),
        "value_null": pkg.is_null("c"),
        "mixed_and": pkg.and_(pkg.greater_or_equal("id", 200), pkg.starts_with("s", "s1")),
        "mixed_or": pkg.or_(pkg.less_than("id", 50), pkg.equal("c", 105)),
        # matches only the version of id 301 that the second commit replaced
        "stale_value": pkg.and_(pkg.equal("id", 301), pkg.equal("c", 1)),
    }


@pytest.fixture(scope="module")
def tables(warehouse):
    """One bucket-2 table per writer: four commits of overlapping sorted id
    ranges (the later ones upserting), then -D rows for a tenth of the ids."""
    made = {}
    for writer, pkg, catalog in (("jax", jt, JaxCatalog(warehouse)), ("port", tt, PortCatalog(warehouse, device="cpu"))):
        table = catalog.create_table(f"db.filtered_{writer}", _row_type(pkg), primary_keys=["id"],
                                     options={"bucket": "2", "write-only": "true", "sort-engine": "numpy"})
        for r in range(4):
            _commit(table, _rows(np.arange(r * 200, r * 200 + 400), r))
        dead = np.arange(0, 1000, 10)
        _commit(table, _rows(dead, 9), np.full(len(dead), int(jt.RowKind.DELETE), dtype=np.uint8))
        made[writer] = table.path
    return made


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_filtered_reads_match_the_reference(warehouse, tables, writer, engine):
    ident = f"db.filtered_{writer}"
    port = PortCatalog(warehouse, device="cpu").get_table(ident)
    jax = JaxCatalog(warehouse).get_table(ident)
    everything = _read(port, engine=engine)
    assert len(everything) == 1000 - 100
    for name, pred in _predicates(tp).items():
        got = _read(port, pred, engine)
        assert got == _jax_read(jax, _predicates(jp)[name], engine), name
        # the predicate filters the merged rows: the same as filtering them here
        mask = pred.eval(PortBatch.from_pydict(port.row_type, {
            f: [row[i] for row in everything] for i, f in enumerate(port.row_type.field_names)}))
        assert got == [row for row, keep in zip(everything, mask) if keep], name
    assert _read(port, _predicates(tp)["stale_value"], engine) == []
    got = _read(port, tp.between("id", 300, 520), engine, projection=["s", "id"])
    assert got == _jax_read(jax, jp.between("id", 300, 520), engine, projection=["s", "id"])


def _planned(table, predicate) -> list:
    rb = table.new_read_builder()
    if predicate is not None:
        rb = rb.with_filter(predicate)
    return [(s.partition, s.bucket, sorted(f.file_name for f in s.files)) for s in rb.new_scan().plan()]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_key_stats_pruning_plans_the_reference_files(warehouse, writer):
    """Disjoint sorted runs: a key range plans only the files that may hold
    it; a value predicate never prunes a primary-key table's files at the
    table scan."""
    pkg = jt if writer == "jax" else tt
    catalog = JaxCatalog(warehouse) if writer == "jax" else PortCatalog(warehouse, device="cpu")
    table = catalog.create_table(f"db.pruned_{writer}", _row_type(pkg), primary_keys=["id"],
                                 options={"bucket": "1", "write-only": "true"})
    for r in range(4):
        _commit(table, _rows(np.arange(r * 1000, r * 1000 + 1000), r))
    port = PortCatalog(warehouse, device="cpu").get_table(f"db.pruned_{writer}")
    jax = JaxCatalog(warehouse).get_table(f"db.pruned_{writer}")
    for jpred, ppred, files in ((None, None, 4), (jp.between("id", 1500, 2500), tp.between("id", 1500, 2500), 2),
                                (jp.equal("id", 3999), tp.equal("id", 3999), 1),
                                (jp.greater_than("d", 900.0), tp.greater_than("d", 900.0), 4)):
        planned = _planned(port, ppred)
        assert planned == _planned(jax, jpred)
        assert sum(len(f) for _, _, f in planned) == files
        assert _read(port, ppred) == _jax_read(jax, jpred)
    # the store scan's value filter (for tables whose every row is final)
    # prunes by value stats as the JAX package's does: d > 900 only in the
    # last commit's file
    pv = port.store.new_scan().with_value_filter(tp.greater_than("d", 900.0)).plan()
    jv = jax.store.new_scan().with_value_filter(jp.greater_than("d", 900.0)).plan()
    assert sorted(e.file.file_name for e in pv.entries) == sorted(e.file.file_name for e in jv.entries)
    assert len(pv.entries) == 1


def _partition_type(pkg):
    return pkg.RowType.of(("dt", pkg.STRING(False)), ("id", pkg.BIGINT(False)), ("v", pkg.BIGINT()))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_partition_pruning_plans_the_reference_splits(warehouse, writer):
    pkg = jt if writer == "jax" else tt
    catalog = JaxCatalog(warehouse) if writer == "jax" else PortCatalog(warehouse, device="cpu")
    ident = f"db.parts_{writer}"
    table = catalog.create_table(ident, _partition_type(pkg), partition_keys=["dt"], primary_keys=["dt", "id"],
                                 options={"bucket": "2", "write-only": "true"})
    days = np.array(["2024-01-01", "2024-01-02", "2024-01-03", "2024-01-04"], dtype=object)
    for r in range(2):
        ids = np.arange(r * 100, r * 100 + 400)
        _commit(table, {"dt": days[ids % 4], "id": ids, "v": ids * 10 + r})
    port, jax = PortCatalog(warehouse, device="cpu").get_table(ident), JaxCatalog(warehouse).get_table(ident)
    everything = _planned(port, None)
    assert everything == _planned(jax, None) and len(everything) == 8
    for make in (lambda p: p.equal("dt", "2024-01-02"), lambda p: p.in_("dt", ["2024-01-01", "2024-01-04"]),
                 lambda p: p.and_(p.greater_than("dt", "2024-01-02"), p.less_than("id", 50)),
                 lambda p: p.or_(p.equal("dt", "2024-01-03"), p.equal("id", 7))):
        planned = _planned(port, make(tp))
        assert planned == _planned(jax, make(jp))
        assert _read(port, make(tp)) == _jax_read(jax, make(jp))
    assert len(_planned(port, tp.equal("dt", "2024-01-02"))) == 2
    assert len(_read(port, tp.equal("dt", "2024-01-02"))) == len(_read(port)) // 4


def test_row_group_skipping_keeps_the_rows(warehouse):
    """A file of 16 row groups written by the JAX package: under a key
    predicate the port decodes only the row groups that may match, and in
    them drops the rows whose dictionary codes fail it (the JAX package's
    native decoder drops the same rows); two projections of one read stay
    row-aligned, and the table reads equal the JAX package's."""
    from paimon_tpu.decode import read_native as jax_read_native
    ident = "db.row_groups"
    table = JaxCatalog(warehouse).create_table(ident, _row_type(jt), primary_keys=["id"],
                                               options={"bucket": "1", "write-only": "true",
                                                        "parquet.row-group.rows": "64"})
    _commit(table, _rows(np.arange(1024), 0))
    _commit(table, _rows(np.arange(500, 600), 1))
    port = PortCatalog(warehouse, device="cpu").get_table(ident)
    files = port.store.restore_files((), 0)
    big = max(files, key=lambda f: f.row_count)
    reader = port.store.reader_factory((), 0)
    whole = reader.read(big)
    pred = tp.between("id", 130, 200)
    keys = reader.read(big, fields=["id"], predicate=pred)
    values = reader.read(big, fields=["s", "d"], system_columns=False, predicate=pred)
    # row groups 2 and 3 of 16 open; their dictionary pages keep ids 130-200
    assert keys.num_rows == values.num_rows == 71
    alive = np.flatnonzero((whole.data.column("id").values >= 130) & (whole.data.column("id").values <= 200))
    assert keys.data.column("id").to_pylist() == whole.data.column("id").values[alive].tolist()
    for name in ("s", "d"):
        assert values.data.column(name).to_pylist() == whole.data.column(name).take(alive).to_pylist()
    raw = open(f"{port.store.bucket_dir((), 0)}/{big.file_name}", "rb").read()
    disk = port.store.reader_factory((), 0)
    assert len(read_parquet(raw, disk.read_schema, ["id"], pred)) == 2
    from paimon_tpu.core.kv import kv_disk_schema as jax_disk_schema

    want = jax_read_native(table.file_io, f"{port.store.bucket_dir((), 0)}/{big.file_name}",
                           jax_disk_schema(_row_type(jt)), projection=["id"], predicate=jp.between("id", 130, 200))
    assert [b.column("id").to_pylist() for b in want] == [
        b.column("id").to_pylist() for b in read_parquet(raw, disk.read_schema, ["id"], pred)]
    assert len(read_parquet(raw, disk.read_schema, ["id"])) == 16
    jax = JaxCatalog(warehouse).get_table(ident)
    for jpred, ppred in ((jp.between("id", 130, 200), pred), (jp.in_("id", [5, 550, 1000]), tp.in_("id", [5, 550, 1000])),
                         (jp.greater_than("d", 240.0), tp.greater_than("d", 240.0))):
        for engine in ENGINES:
            assert _read(port, ppred, engine) == _jax_read(jax, jpred, engine)
