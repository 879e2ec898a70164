"""The dictionary-code domain (merge.dict-domain) in the port against the JAX
package, on the CPU (device="cpu" for the port).

Units: code-backed Columns (take/slice/filter on the codes, the lazy
expansion's null fill, value_at, concat through unify_columns and its
fallback past the pool limit, gather_column), exact_string_pool and the key
lanes of code-backed string and BIGINT keys (the JAX package's lanes, no
expansion), encode_column's code branch, value leaves evaluated over the
pool, key hashes through the pool, and the join on codes (pairs, counters,
code-backed output, the pool-limit fallback, JoinIndex build and probe).

Tables (the counterpart of tests/test_dict_domain.py): for each engine
(deduplicate, partial-update, aggregation, full-compaction changelog) x
dictionary shape (disjoint, overlapping, identical pools across commits) x
the JAX package's decoder (native, arrow), a table begun by the JAX package
(native encoder, merge.dict-domain=true) and continued by the port reads
the same in both packages with the option on and off, the port's read runs
in the code domain, and the port's full compaction through the code domain
re-reads the same with the option off in both packages. The full-compaction
changelog the port produces on codes equals the one it produces on values
and the JAX package's; sort-compact gives one layout with the option on and
off, the JAX package's; the pool-limit option and a table without
dictionaries fall back per file; the pushdown reuses the code verdicts and
expands fewer bytes; slices of a cached code-backed batch stay consistent;
a table begun by the port is continued by the JAX package; a code-domain
GROUP BY, star join and point lookups equal the JAX package's. The counter
dict{rows_code_domain} is > 0 on those tables, and 0 with the option off
and on a numeric-only table.

Tolerance: exact (sums are of integers).
"""

import io

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import paimon_tpu as jt
import paimon_tpu_torch as tt
from paimon_tpu.catalog import FileSystemCatalog as JaxCatalog
from paimon_tpu.data import keys as jkeys
from paimon_tpu.data import predicate as jp
from paimon_tpu.data.batch import Column as JaxColumn
from paimon_tpu.data.batch import ColumnBatch as JaxBatch
from paimon_tpu.ops import dicts as jdicts
from paimon_tpu.ops import join as jjoin
from paimon_tpu.ops.aggregates import _gather_column as jax_gather_column
from paimon_tpu.sql import execute as jax_execute
from paimon_tpu.table.bucket import key_hashes as jax_key_hashes
from paimon_tpu_torch.catalog import FileSystemCatalog as PortCatalog
from paimon_tpu_torch.data import keys as tkeys
from paimon_tpu_torch.data import predicate as tp
from paimon_tpu_torch.data.batch import Column, ColumnBatch, gather_column
from paimon_tpu_torch.metrics import decode_metrics, dict_metrics, join_metrics, registry
from paimon_tpu_torch.ops import dicts as tdicts
from paimon_tpu_torch.ops import join as tjoin
from paimon_tpu_torch.sql import execute as port_execute
from paimon_tpu_torch.table.bucket import key_hashes


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


@pytest.fixture(autouse=True)
def _jax_env_neutral(monkeypatch):
    """The JAX package's env overrides would force both of its sides onto
    one path; its compact download reorders pallas winners (ROADMAP Queue 3
    item 4)."""
    for name in ("PAIMON_TPU_DICT_DOMAIN", "PAIMON_TPU_DICT_POOL_LIMIT", "PAIMON_TPU_PARQUET_ENCODER"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("PAIMON_TPU_FORCE_COMPACT", "0")


def _count(name: str) -> int:
    return dict_metrics().counter(name).count


def _coded(values, pkg_column=Column, validity=None):
    values = np.asarray(values, dtype=object) if not isinstance(values, np.ndarray) else values
    pool = np.unique(values)
    codes = np.searchsorted(pool, values).astype(np.uint32)
    return pkg_column.from_codes(pool, codes, validity)


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["object", "int32", "int64"])
def test_code_backed_structural_ops_match_jax(kind):
    rng = np.random.default_rng(1)
    if kind == "object":
        pool = np.array(["a", "b", "c", "d"], dtype=object)
    else:
        pool = np.array([-7, 0, 3, 90], dtype=kind)
    codes = rng.integers(0, 4, 40).astype(np.uint32)
    validity = rng.random(40) > 0.3
    got, want = Column.from_codes(pool, codes, validity), JaxColumn.from_codes(pool, codes, validity)
    assert got.is_code_backed and got.null_count == want.null_count
    assert got.value_at(3) == want.value_at(3) and got.dtype == pool.dtype
    idx, mask = rng.integers(0, 40, 25), rng.random(40) > 0.5
    for g, w in ((got.take(idx), want.take(idx)), (got.slice(5, 30), want.slice(5, 30)),
                 (got.filter(mask), want.filter(mask))):
        assert g.is_code_backed and np.array_equal(g.dict_cache[1], w.dict_cache[1])
        assert g.to_pylist() == w.to_pylist()
    registry.reset()
    # the expansion fills nulls as the expanded decode does: None or 0
    v = got.values
    assert v.dtype == want.values.dtype and v.tolist() == want.values.tolist()
    assert _count("fallback_expanded") == 40
    src = np.array([3, -1, 0, 39, 12])
    g, w = gather_column(Column.from_codes(pool, codes, validity), src), jax_gather_column(want, src)
    assert g.is_code_backed and g.to_pylist() == w.to_pylist()


def test_concat_unifies_in_the_code_domain():
    registry.reset()
    a = Column.from_codes(np.array(["a", "c"], dtype=object), np.array([1, 0], np.uint32))
    b = Column.from_codes(np.array(["b", "c"], dtype=object), np.array([0, 1], np.uint32), np.array([True, False]))
    out = Column.concat([a, b])
    want = JaxColumn.concat([JaxColumn.from_codes(np.array(["a", "c"], dtype=object), np.array([1, 0], np.uint32)),
                             JaxColumn.from_codes(np.array(["b", "c"], dtype=object), np.array([0, 1], np.uint32),
                                                  np.array([True, False]))])
    assert out.is_code_backed and _count("pools_unified") >= 2 and _count("fallback_expanded") == 0
    assert out.dict_cache[0].tolist() == want.dict_cache[0].tolist()
    assert out.to_pylist() == want.to_pylist() == ["c", "a", "b", None]


def test_concat_past_the_pool_limit_expands(monkeypatch):
    monkeypatch.setattr(tdicts, "DEFAULT_POOL_LIMIT", 2)
    registry.reset()
    a = Column.from_codes(np.array(["a", "c"], dtype=object), np.array([1, 0], np.uint32))
    b = Column.from_codes(np.array(["b", "d"], dtype=object), np.array([0, 1], np.uint32))
    out = Column.concat([a, b])
    assert not out.is_code_backed and out.to_pylist() == ["c", "a", "b", "d"]
    assert _count("fallback_expanded") > 0


def test_exact_string_pool_and_lanes_from_codes():
    rng = np.random.default_rng(3)
    vals_a = np.array([f"v{int(x):03d}" for x in rng.integers(0, 40, 200)], dtype=object)
    vals_b = np.array([f"v{int(x):03d}" for x in rng.integers(20, 60, 100)], dtype=object)

    def with_strays(pkg_column, vals, extra):
        pool = np.unique(np.concatenate([vals, np.array(extra, dtype=object)]))
        return pkg_column.from_codes(pool, np.searchsorted(pool, vals).astype(np.uint32))

    got = tkeys.exact_string_pool([with_strays(Column, vals_a, ["zzz"]), with_strays(Column, vals_b, ["aaa"])])
    want = jkeys.exact_string_pool([with_strays(JaxColumn, vals_a, ["zzz"]), with_strays(JaxColumn, vals_b, ["aaa"])])
    assert got.tolist() == want.tolist() == tkeys.build_string_pool([vals_a, vals_b]).tolist()
    schema = tt.RowType.of(("k", tt.STRING(False)), ("n", tt.BIGINT(False)))
    jschema = jt.RowType.of(("k", jt.STRING(False)), ("n", jt.BIGINT(False)))
    nums = rng.integers(-5, 5, 200).astype(np.int64)
    kcol = with_strays(Column, vals_a, ["zzz"])
    ncol = _coded(nums, Column)
    lanes = tkeys.encode_key_lanes_with_pools(ColumnBatch(schema, {"k": kcol, "n": ncol}), ["k", "n"])
    jlanes = jkeys.encode_key_lanes_with_pools(
        JaxBatch(jschema, {"k": JaxColumn(vals_a.copy()), "n": JaxColumn(nums)}), ["k", "n"])
    assert np.array_equal(lanes, jlanes)
    assert kcol.is_code_backed and ncol.is_code_backed and kcol._values is None and ncol._values is None
    # the key column now carries the merge pool and its ranks
    assert kcol.dict_cache[0].tolist() == sorted(set(vals_a.tolist()))


def test_encode_column_code_branch_matches_jax():
    rng = np.random.default_rng(4)
    pool = np.array([f"g{i:02d}" for i in range(30)], dtype=object)
    codes = rng.choice(np.arange(0, 30, 3), 300).astype(np.uint32)
    validity = rng.random(300) > 0.2
    col = Column.from_codes(pool, codes, validity)
    assert tdicts.cache_usable(col)
    gp, gc = tdicts.encode_column(col)
    wp, wc = jdicts.encode_column(JaxColumn.from_codes(pool, codes, validity))
    assert gp.tolist() == wp.tolist() and np.array_equal(gc, wc) and gc.dtype == np.uint32
    assert col._values is None
    # the expanded column encodes the same
    ep, ec = tdicts.encode_column(Column(col.values, validity))
    assert ep.tolist() == gp.tolist() and np.array_equal(ec, gc)


@pytest.mark.parametrize("leaf", ["equal", "in", "between", "starts", "not_equal", "is_null"])
def test_value_leaves_over_the_pool(leaf):
    rng = np.random.default_rng(5)
    vals = np.array([f"w{int(x):02d}" for x in rng.integers(0, 20, 200)], dtype=object)
    validity = rng.random(200) > 0.25
    make = {
        "equal": lambda p: p.equal("s", "w03"),
        "in": lambda p: p.in_("s", ["w01", "w11", "zz"]),
        "between": lambda p: p.between("s", "w05", "w09"),
        "starts": lambda p: p.starts_with("s", "w1"),
        "not_equal": lambda p: p.not_equal("s", "w04"),
        "is_null": lambda p: p.is_null("s"),
    }[leaf]
    batch = ColumnBatch(tt.RowType.of(("s", tt.STRING())), {"s": _coded(vals, Column, validity)})
    jbatch = JaxBatch(jt.RowType.of(("s", jt.STRING())), {"s": _coded(vals, JaxColumn, validity)})
    got = make(tp).eval(batch)
    assert np.array_equal(got, make(jp).eval(jbatch))
    assert batch.column("s")._values is None
    expanded = ColumnBatch(tt.RowType.of(("s", tt.STRING())), {"s": Column(batch.column("s").values, validity)})
    assert np.array_equal(got, make(tp).eval(expanded))


def test_key_hashes_through_the_pool():
    pool = np.array(["aa", "bb", "cc"], dtype=object)
    codes = np.array([2, 0, 1, 1, 2], dtype=np.uint32)
    schema = tt.RowType.of(("s", tt.STRING()))
    got = key_hashes(ColumnBatch(schema, {"s": Column.from_codes(pool, codes)}), ["s"])
    assert np.array_equal(got, key_hashes(ColumnBatch(schema, {"s": Column(pool.take(codes))}), ["s"]))
    assert np.array_equal(got, jax_key_hashes(
        JaxBatch(jt.RowType.of(("s", jt.STRING())), {"s": JaxColumn.from_codes(pool, codes)}), ["s"]))


def _join_sides(pkg_column, pkg_batch, pkg, seed=23):
    rng = np.random.default_rng(seed)
    lvals = np.array([f"d{int(x):04d}" for x in rng.integers(0, 300, 4000)], dtype=object)
    rvals = np.array([f"d{int(x):04d}" for x in rng.integers(0, 450, 700)], dtype=object)
    lval = rng.random(4000) > 0.1
    left = pkg_batch(pkg.RowType.of(("s", pkg.STRING()), ("v", pkg.DOUBLE())),
                     {"s": _coded(lvals, pkg_column, lval), "v": pkg_column(np.ones(4000))})
    right = pkg_batch(pkg.RowType.of(("s", pkg.STRING()), ("w", pkg.DOUBLE())),
                      {"s": _coded(rvals, pkg_column), "w": pkg_column(np.arange(700.0))})
    return left, right


@pytest.mark.parametrize("how", ["inner", "left"])
@pytest.mark.parametrize("engine", ["numpy", "xla", "pallas"])
def test_join_on_codes_matches_jax(how, engine):
    left, right = _join_sides(Column, ColumnBatch, tt)
    jleft, jright = _join_sides(JaxColumn, JaxBatch, jt)
    registry.reset()
    res = tjoin.join_batches(left, right, ["s"], ["s"], how=how, engine=engine, device="cpu")
    want = jjoin.join_batches(jleft, jright, ["s"], ["s"], how=how, engine="numpy")
    assert np.array_equal(res.left_take, want.left_take) and np.array_equal(res.right_take, want.right_take)
    assert res.stats["code_domain_cols"] == want.stats["code_domain_cols"] == 1
    assert join_metrics().counter("code_domain_joins").count == 1
    out = tjoin.materialize_join(left, right, res, [("s", "s"), ("v", "v")], [("s", "rs"), ("w", "w")])
    assert out.column("s").is_code_backed and out.column("rs").is_code_backed
    assert _count("fallback_expanded") == 0
    jout = jjoin.materialize_join(jleft, jright, want, [("s", "s"), ("v", "v")], [("s", "rs"), ("w", "w")])
    assert out.to_pylist() == jout.to_pylist()


def test_join_past_the_pool_limit_takes_the_values():
    left, right = _join_sides(Column, ColumnBatch, tt)
    res = tjoin.join_batches(left, right, ["s"], ["s"], options={"merge.dict-domain.pool-limit": "8"}, device="cpu")
    full = tjoin.join_batches(left, right, ["s"], ["s"], device="cpu")
    assert res.stats["code_domain_cols"] == 0 and full.stats["code_domain_cols"] == 1
    assert np.array_equal(res.left_take, full.left_take) and np.array_equal(res.right_take, full.right_take)


@pytest.mark.parametrize("probe", ["coded", "values"])
def test_join_index_on_codes_matches_jax(probe):
    left, right = _join_sides(Column, ColumnBatch, tt, seed=31)
    jleft, jright = _join_sides(JaxColumn, JaxBatch, jt, seed=31)
    if probe == "values":
        left = ColumnBatch(left.schema, {"s": Column(left.column("s").values, left.column("s").validity),
                                         "v": left.column("v")})
    index = tjoin.JoinIndex(right, ["s"], device="cpu")
    assert right.column("s")._values is None
    for how in ("inner", "left"):
        got = index.probe(left, ["s"], how=how)
        want = jjoin.JoinIndex(jright, ["s"]).probe(jleft, ["s"], how=how)
        assert np.array_equal(got.left_take, want.left_take) and np.array_equal(got.right_take, want.right_take)


# ---------------------------------------------------------------------------
# tables: the counterpart of tests/test_dict_domain.py
# ---------------------------------------------------------------------------

ENGINE_OPTS = {
    "dedup": {},
    "partial_update": {"merge-engine": "partial-update", "partial-update.remove-record-on-delete": "true"},
    "aggregation": {"merge-engine": "aggregation", "fields.v.aggregate-function": "sum",
                    "fields.s2.aggregate-function": "last_non_null_value"},
    "changelog": {"changelog-producer": "full-compaction"},
}
NO_CACHE = {"cache.data-file.max-memory-size": "0 b", "cache.manifest.max-memory-size": "0 b"}


def _schema(pkg):
    return pkg.RowType.of(("k", pkg.BIGINT(False)), ("s1", pkg.STRING(False)), ("s2", pkg.STRING()), ("v", pkg.BIGINT()))


def _round(rng, step: int, null_rate: float, shape: str, n: int = 80, deletes: bool = False):
    lo, hi = {"disjoint": (step * 1000, step * 1000 + 30), "overlapping": (0, 40), "identical": (0, 12)}[shape]
    s2 = np.empty(n, dtype=object)
    s2[:] = [None if rng.random() < null_rate else f"tag-{int(x):02d}" for x in rng.integers(0, 20, n)]
    data = {"k": rng.integers(0, 150, n).astype(np.int64),
            "s1": np.array([f"dict-{int(x):05d}" for x in rng.integers(lo, hi, n)], dtype=object),
            "s2": s2, "v": rng.integers(0, 100, n).astype(np.int64)}
    kinds = ["-D" if rng.random() < 0.15 else "+I" for _ in range(n)] if deletes else None
    return data, kinds


def _commit(t, data, kinds=None):
    wb = t.new_batch_write_builder()
    w = wb.new_write()
    w.write(data, kinds=kinds)
    wb.new_commit().commit(w.prepare_commit())


def _compact(t):
    wb = t.new_batch_write_builder()
    w = wb.new_write()
    w.compact(full=True)
    wb.new_commit().commit(w.prepare_commit())


def _rows(t, predicate=None) -> list:
    rb = t.new_read_builder()
    if predicate is not None:
        rb = rb.with_filter(predicate)
    return rb.new_read().read_all(rb.new_scan().plan()).to_pylist()


def _views(t, **extra):
    return t.copy({"merge.dict-domain": "true", **extra}), t.copy({"merge.dict-domain": "false", **extra})


@pytest.mark.parametrize("decoder", ["native", "arrow"])
@pytest.mark.parametrize("shape", ["disjoint", "overlapping", "identical"])
@pytest.mark.parametrize("engine", ["dedup", "partial_update", "aggregation", "changelog"])
def test_tables_match_jax(tmp_path, engine, shape, decoder):
    seed = {"dedup": 1, "partial_update": 2, "aggregation": 3, "changelog": 4}[engine] * 10 + len(shape)
    rng = np.random.default_rng(seed)
    warehouse = str(tmp_path)
    opts = {"bucket": "1", "format.parquet.encoder": "native", "merge.dict-domain": "true",
            "num-sorted-run.compaction-trigger": "3", **NO_CACHE, **ENGINE_OPTS[engine]}
    JaxCatalog(warehouse).create_table("db.t", _schema(jt), primary_keys=["k"], options=opts)
    null_rate = {"disjoint": 0.0, "overlapping": 0.3, "identical": 0.05}[shape]
    deletes = engine in ("dedup", "partial_update", "changelog")
    for step in range(4):
        data, kinds = _round(rng, step, null_rate, shape, deletes=deletes and step > 0)
        cat = JaxCatalog(warehouse) if step < 2 else PortCatalog(warehouse, device="cpu")
        _commit(cat.get_table("db.t"), data, kinds)
    port_on, port_off = _views(PortCatalog(warehouse, device="cpu").get_table("db.t"))
    jax_on, jax_off = _views(JaxCatalog(warehouse).get_table("db.t"), **{"format.parquet.decoder": decoder})
    registry.reset()
    got = _rows(port_on)
    assert _count("rows_code_domain") > 0
    assert got == _rows(port_off) == _rows(jax_on) == _rows(jax_off)
    registry.reset()
    _rows(port_off)
    assert _count("rows_code_domain") == 0
    # the port's full compaction through the code domain, re-read off
    _compact(port_on)
    assert _rows(port_off) == _rows(_views(JaxCatalog(warehouse).get_table("db.t"))[1]) == got


def test_changelog_production_matches_jax(tmp_path):
    """The full-compaction changelog the port produces on codes equals the
    one it produces on values and the JAX package's."""
    from paimon_tpu.types import RowKind as JaxKind

    streams = {}
    for who, dd in (("port", "true"), ("port", "false"), ("jax", "true")):
        cat = PortCatalog(str(tmp_path), device="cpu") if who == "port" else JaxCatalog(str(tmp_path))
        pkg = tt if who == "port" else jt
        opts = {"bucket": "1", "changelog-producer": "full-compaction", "format.parquet.encoder": "native",
                "format.parquet.decoder": "native", "merge.dict-domain": dd, **NO_CACHE}
        t = cat.create_table(f"db.cl_{who}_{dd}", _schema(pkg), primary_keys=["k"], options=opts)
        rng = np.random.default_rng(29)
        scan = t.new_read_builder().new_stream_scan()
        read = t.new_read_builder().new_read()
        events = []
        for step in range(3):
            data, kinds = _round(rng, step, 0.25, "overlapping", deletes=step > 0)
            _commit(t, data, kinds)
            _compact(t)
            for s in scan.plan() or []:
                rows, ks = read.read_with_kinds(s)
                events += [(JaxKind(int(k)).short_string, *r) for r, k in zip(rows.to_pylist(), np.asarray(ks).tolist())]
        streams[(who, dd)] = (events, _rows(t))
    assert streams[("port", "true")] == streams[("port", "false")] == streams[("jax", "true")]


@pytest.mark.parametrize("order", ["zorder", "order"])
def test_sort_compact_matches_jax(tmp_path, order):
    from paimon_tpu.table.sort_compact import sort_compact as jax_sort_compact
    from paimon_tpu_torch.table.sort_compact import sort_compact

    views = {}
    for who, dd in (("port", "true"), ("port", "false"), ("jax", "true")):
        pkg = tt if who == "port" else jt
        cat = PortCatalog(str(tmp_path), device="cpu") if who == "port" else JaxCatalog(str(tmp_path))
        t = cat.create_table(f"db.sc_{who}_{dd}", pkg.RowType.of(("cat", pkg.STRING(False)), ("slot", pkg.INT(False)),
                                                                 ("v", pkg.DOUBLE())),
                             options={"bucket": "1", "merge.dict-domain": dd, **NO_CACHE})
        r = np.random.default_rng(5)
        for _ in range(2):
            _commit(t, {"cat": np.array([f"c-{int(x):03d}" for x in r.integers(0, 50, 400)], dtype=object),
                        "slot": r.integers(0, 100, 400).astype(np.int32), "v": r.random(400)})
        (sort_compact if who == "port" else jax_sort_compact)(t, ["cat", "slot"], order=order)
        views[(who, dd)] = _rows(t)
    assert views[("port", "true")] == views[("port", "false")] == views[("jax", "true")]


def test_pool_limit_option_falls_back_per_file(tmp_path):
    from paimon_tpu_torch.format.parquet import read_parquet

    t = PortCatalog(str(tmp_path), device="cpu").create_table(
        "db.lim", _schema(tt), primary_keys=["k"],
        options={"bucket": "1", "merge.dict-domain": "true", "merge.dict-domain.pool-limit": "4", **NO_CACHE})
    rng = np.random.default_rng(9)
    for step in range(2):
        _commit(t, *_round(rng, step, 0.1, "overlapping"))
    registry.reset()
    rows = _rows(t)
    assert _count("fallback_expanded") > 0
    disk = t.store.reader_factory((), 0)
    for f in t.store.restore_files((), 0):
        raw = t.file_io.read_bytes(f"{disk.bucket_dir}/{f.file_name}")
        for b in read_parquet(raw, _schema(tt), ["s1", "s2"], dict_domain=True, pool_limit=4):
            assert not b.column("s1").is_code_backed and not b.column("s2").is_code_backed
    assert _rows(t.copy({"merge.dict-domain.pool-limit": str(1 << 20)})) == rows
    assert rows == _rows(JaxCatalog(str(tmp_path)).get_table("db.lim"))


def test_tables_without_codes_count_none(tmp_path):
    """parquet.enable.dictionary=false writes PLAIN pages: the code-domain
    reader takes the expanded path per chunk; a numeric-only table never
    engages the code domain."""
    cat = PortCatalog(str(tmp_path), device="cpu")
    t = cat.create_table("db.plain", _schema(tt), primary_keys=["k"],
                         options={"bucket": "1", "parquet.enable.dictionary": "false", **NO_CACHE})
    rng = np.random.default_rng(13)
    for step in range(2):
        _commit(t, *_round(rng, step, 0.2, "overlapping"))
    on, off = _views(t)
    registry.reset()
    assert _rows(on) == _rows(off) == _rows(JaxCatalog(str(tmp_path)).get_table("db.plain"))
    assert _count("rows_code_domain") == 0
    num = cat.create_table("db.num", tt.RowType.of(("k", tt.BIGINT(False)), ("v1", tt.BIGINT()), ("v2", tt.DOUBLE())),
                           primary_keys=["k"], options={"bucket": "1", "merge.dict-domain": "true", **NO_CACHE})
    for step in range(2):
        _commit(num, {"k": rng.integers(0, 4000, 2000).astype(np.int64),
                      "v1": rng.integers(0, 1 << 40, 2000).astype(np.int64), "v2": rng.random(2000)})
    registry.reset()
    assert _rows(num) == _rows(num.copy({"merge.dict-domain": "false"}))
    assert _count("rows_code_domain") == 0


def test_pushdown_reuses_the_code_verdicts(tmp_path):
    t = PortCatalog(str(tmp_path), device="cpu").create_table(
        "db.push", _schema(tt), primary_keys=["k"], options={"bucket": "1", "parquet.page-size": "2048", **NO_CACHE})
    rng = np.random.default_rng(21)
    for step in range(3):
        _commit(t, *_round(rng, step, 0.0, "overlapping", n=600))
    on, off = _views(t)
    registry.reset()
    rows_on = _rows(on, tp.equal("s1", "dict-00003"))
    expanded_on = decode_metrics().counter("bytes_expanded").count
    coded = _count("rows_code_domain")
    registry.reset()
    rows_off = _rows(off, tp.equal("s1", "dict-00003"))
    assert rows_on == rows_off and rows_on and coded > 0
    assert expanded_on < decode_metrics().counter("bytes_expanded").count
    jax = JaxCatalog(str(tmp_path)).get_table("db.push").copy({"merge.dict-domain": "true",
                                                               "format.parquet.decoder": "native"})
    assert rows_on == _rows(jax, jp.equal("s1", "dict-00003"))


def test_cached_code_backed_batches_slice_consistently(tmp_path):
    t = PortCatalog(str(tmp_path), device="cpu").create_table(
        "db.slice", _schema(tt), primary_keys=["k"],
        options={"bucket": "1", "merge.dict-domain": "true", "cache.data-file.max-memory-size": "64 mb"})
    _commit(t, *_round(np.random.default_rng(17), 0, 0.2, "overlapping", n=200))
    rb = t.new_read_builder()
    out = rb.new_read().read_all(rb.new_scan().plan())
    col = out.column("s1")
    assert col.is_code_backed
    head, tail = col.slice(0, 50), col.slice(50, len(col))
    taken = col.take(np.arange(0, len(col), 3))
    _ = head.values  # expand one slice
    assert tail.is_code_backed and col.is_code_backed
    every = col.to_pylist()
    assert head.to_pylist() == every[:50] and tail.to_pylist() == every[50:]
    assert taken.to_pylist() == every[::3]
    again = rb.new_read().read_all(rb.new_scan().plan())
    assert again.to_pylist() == out.to_pylist()


def test_port_table_continued_by_jax(tmp_path):
    warehouse = str(tmp_path)
    opts = {"bucket": "1", "merge.dict-domain": "true", "format.parquet.encoder": "native",
            "format.parquet.decoder": "native", "num-sorted-run.compaction-trigger": "3", **NO_CACHE}
    PortCatalog(warehouse, device="cpu").create_table("db.x", _schema(tt), primary_keys=["k"], options=opts)
    rng = np.random.default_rng(41)
    for step in range(5):
        cat = PortCatalog(warehouse, device="cpu") if step < 3 else JaxCatalog(warehouse)
        _commit(cat.get_table("db.x"), *_round(rng, step, 0.2, "overlapping", deletes=step > 0))
        registry.reset()
        got = _rows(PortCatalog(warehouse, device="cpu").get_table("db.x"))
        assert _count("rows_code_domain") > 0
        assert got == _rows(JaxCatalog(warehouse).get_table("db.x"))


# ---------------------------------------------------------------------------
# SQL and lookups over code-domain tables
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def star(tmp_path_factory):
    warehouse = str(tmp_path_factory.mktemp("dict-star"))
    opts = {"bucket": "1", "merge.dict-domain": "true", **NO_CACHE}
    pcat = PortCatalog(warehouse, commit_user="sql", device="cpu")
    fact = pcat.create_table("db.fact", tt.RowType.of(("id", tt.BIGINT(False)), ("cust", tt.STRING()),
                                                      ("item", tt.STRING()), ("qty", tt.BIGINT())),
                             primary_keys=["id"], options=opts)
    dim = pcat.create_table("db.dim", tt.RowType.of(("cust", tt.STRING(False)), ("region", tt.STRING()),
                                                    ("tier", tt.INT())), primary_keys=["cust"], options=opts)
    rng = np.random.default_rng(7)
    custs = np.array([f"cust-{i:04d}" for i in range(300)], dtype=object)
    _commit(dim, {"cust": custs, "region": np.array([f"r{i % 7}" for i in range(300)], dtype=object),
                  "tier": (np.arange(300) % 4).astype(np.int32)})
    for step in range(2):
        n = 3000
        cust = custs[rng.integers(0, 340, n) % 300]
        cust[rng.random(n) < 0.05] = None
        _commit(fact, {"id": rng.integers(0, 5000, n).astype(np.int64), "cust": cust,
                       "item": np.array([f"item-{int(x):02d}" for x in rng.integers(0, 60, n)], dtype=object),
                       "qty": rng.integers(1, 10, n).astype(np.int64)})
    return JaxCatalog(warehouse, commit_user="sql"), pcat


STATEMENTS = [
    "SELECT item, count(*), sum(qty) FROM db.fact GROUP BY item",
    "SELECT cust, item, sum(qty) FROM db.fact WHERE qty > 3 GROUP BY cust, item",
    "SELECT d.region, count(*), sum(f.qty) FROM db.fact f JOIN db.dim d ON f.cust = d.cust GROUP BY d.region",
    "SELECT f.id, f.item, d.region FROM db.fact f JOIN db.dim d ON f.cust = d.cust WHERE d.tier = 2 ORDER BY f.id",
    "SELECT f.id, d.region FROM db.fact f LEFT JOIN db.dim d ON f.cust = d.cust ORDER BY f.id LIMIT 200",
    "SELECT item, min(cust), max(cust) FROM db.fact WHERE item LIKE 'item-1%' GROUP BY item",
]


@pytest.mark.parametrize("statement", STATEMENTS)
def test_sql_over_code_domain_matches_jax(star, statement):
    jcat, pcat = star
    registry.reset()
    got = port_execute(pcat, statement)
    assert _count("rows_code_domain") > 0
    want = jax_execute(jcat, statement)
    assert got.schema.field_names == want.schema.field_names
    assert got.to_pylist() == want.to_pylist()


def test_group_by_keeps_the_codes(star):
    """The grouped star join groups on the code domain: encode_column's
    code branch, no np.unique over the rows."""
    _, pcat = star
    import paimon_tpu_torch.ops.dicts as d

    calls = []
    orig = d.encode_column

    def spy(col):
        calls.append(col.is_code_backed)
        return orig(col)

    d.encode_column = spy
    try:
        port_execute(pcat, STATEMENTS[2])
    finally:
        d.encode_column = orig
    assert calls and all(calls)


def test_lookups_over_code_domain_match_jax(star):
    from paimon_tpu.table.query import LocalTableQuery as JaxQuery
    from paimon_tpu_torch.table.query import LocalTableQuery

    jcat, pcat = star
    keys = np.array([f"cust-{i:04d}" for i in range(0, 400, 7)], dtype=object)
    q = LocalTableQuery(pcat.get_table("db.dim"), device="cpu")
    jq = JaxQuery(jcat.get_table("db.dim"))
    assert q.get_batch(list(keys)).to_pylist() == jq.get_batch(list(keys)).to_pylist()
