"""SELECT through the port's SQL surface (paimon_tpu_torch/sql/select.py,
sql/expr.py, the system tables of table/system.py) against the JAX
package's, on the CPU (device="cpu").

Every case runs one statement through paimon_tpu.sql.execute and
paimon_tpu_torch.sql.execute on the same warehouse, written by either
package, and asserts the same column names, types, rows and row order (or
the same error class and message). The cases are the counterparts of
tests/test_sql_select.py (star over merged runs, projection, WHERE, ORDER
BY, LIMIT, scalar aggregates, GROUP BY with composite keys, NULL keys and a
hidden ORDER BY column, DISTINCT, HAVING, time travel by version, tag and
timestamp, OPTIONS hints, system tables, EXPLAIN and the errors) and of
tests/test_sql_randomized.py (seeded WHERE / GROUP BY / ORDER BY queries);
GROUP BY runs under each sort-engine (the table's default, which is plain
torch ops in the port, and pallas and numpy by hint) over float columns
holding NaN, -0.0 and +0.0; JOIN covers inner and LEFT star joins, pushed
and residual WHERE conjuncts, key pruning by IN list and by BETWEEN, HAVING
and ORDER BY over joined names, and the join errors.

The JAX package's Pallas kernels run in interpret mode; the port's
wrappers take the plain versions of K1, K2 and segment_sum. The JAX writer
needs pyarrow warmed on the main thread first (ROADMAP Queue 3 item 7).
Left out: cluster_query (sql/cluster.py is not ported). SELECT, GROUP BY
and joins over the code-domain tables of merge.dict-domain are in
tests/test_torch_dict_domain.py.

Tolerance: exact. Integers and strings equal; floats bit for bit, any NaN
equal to any NaN (the packages may produce other NaN payloads for one sum).
"""

import io

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import paimon_tpu as jt
import paimon_tpu_torch as tt
from paimon_tpu.catalog import FileSystemCatalog as JaxCatalog
from paimon_tpu.sql import execute as jax_execute
from paimon_tpu_torch.catalog import FileSystemCatalog as PortCatalog
from paimon_tpu_torch.sql import execute as port_execute


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


@pytest.fixture(autouse=True)
def _plain_download(monkeypatch):
    """The JAX package's pallas reads with its index download: its compact
    link encoding returns winners in input order (ROADMAP Queue 3 item 4)."""
    monkeypatch.setenv("PAIMON_TPU_FORCE_COMPACT", "0")


def same_values(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return False
    if a.dtype.kind == "f" and b.dtype.kind == "f":
        if a.dtype != b.dtype:
            return False
        i = f"i{a.itemsize}"
        return bool(((a.view(i) == b.view(i)) | (np.isnan(a) & np.isnan(b))).all())
    return a.tolist() == b.tolist()


def assert_same(want, got, what: str) -> None:
    """The JAX package's result `want` equals the port's `got`."""
    if not hasattr(want, "schema"):
        assert type(got) is type(want) and got == want, f"{what}: {got!r} != {want!r}"
        return
    assert got.schema.field_names == want.schema.field_names, f"{what}: {got.schema} != {want.schema}"
    assert [f.type.serialize() for f in got.schema.fields] == [f.type.serialize() for f in want.schema.fields], what
    assert got.num_rows == want.num_rows, f"{what}: {got.num_rows} != {want.num_rows} rows"
    for name in want.schema.field_names:
        w, g = want.column(name), got.column(name)
        ok = np.asarray(w.valid_mask())
        assert same_values(g.valid_mask(), ok), f"{what}: nulls of {name}"
        assert same_values(np.asarray(g.values)[ok], np.asarray(w.values)[ok]), f"{what}: column {name}"


def run_both(jcat, pcat, statement: str):
    """The statement through both packages: the same result, or the same
    error class and message. Returns the port's result (None on error)."""
    try:
        want = jax_execute(jcat, statement)
    except Exception as e:  # noqa: BLE001 - the port must raise the same
        with pytest.raises(Exception) as info:
            port_execute(pcat, statement)
        assert type(info.value).__name__ == type(e).__name__, f"{statement}: {info.value!r} vs {e!r}"
        assert str(info.value) == str(e), statement
        return None
    got = port_execute(pcat, statement)
    assert_same(want, got, statement)
    return got


def catalogs(warehouse: str):
    return JaxCatalog(warehouse, commit_user="sql"), PortCatalog(warehouse, commit_user="sql", device="cpu")


def write(t, data, kinds=None):
    wb = t.new_batch_write_builder()
    w = wb.new_write()
    w.write(data) if kinds is None else w.write(data, kinds)
    wb.new_commit().commit(w.prepare_commit())


def _pkg(writer):
    return jt if writer == "jax" else tt


# ---------------------------------------------------------------------------
# the counterpart of tests/test_sql_select.py's table: two overlapping runs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["jax", "port"], ids=["jax-written", "port-written"])
def merged(request, tmp_path_factory):
    writer = request.param
    warehouse = str(tmp_path_factory.mktemp(f"select-{writer}"))
    jcat, pcat = catalogs(warehouse)
    m = _pkg(writer)
    cat = jcat if writer == "jax" else pcat
    t = cat.create_table(
        "db.t",
        m.RowType.of(("k", m.BIGINT(False)), ("v", m.BIGINT()), ("x", m.DOUBLE()), ("s", m.STRING())),
        primary_keys=["k"], options={"bucket": "1", "write-only": "true"},
    )
    for r in range(2):
        ids = np.arange(r * 50, 100 + r * 50, dtype=np.int64)
        write(t, {"k": ids, "v": ids * (r + 1), "x": ids * 0.5, "s": [f"g{int(i) % 3}" for i in ids]})
    t.create_tag("after-first", snapshot_id=1)
    nulls = cat.create_table(
        "db.nulls", m.RowType.of(("k", m.BIGINT(False)), ("g", m.STRING()), ("v", m.BIGINT())),
        primary_keys=["k"], options={"bucket": "1"},
    )
    write(nulls, {"k": [1, 2, 3, 4, 5], "g": ["a", None, "a", None, "b"], "v": [10, 20, None, 40, None]})
    return jcat, pcat


SELECTS = [
    "SELECT * FROM db.t",
    "SELECT k, v FROM db.t WHERE k >= 140 ORDER BY k DESC LIMIT 3",
    "SELECT s, k FROM db.t WHERE s LIKE 'g1' AND k < 10 ORDER BY k",
    "SELECT k FROM db.t LIMIT 7",
    "SELECT count(*), min(k), max(k), avg(v) FROM db.t WHERE k < 50",
    "SELECT sum(v) FROM db.t",
    "SELECT sum(x), min(s), max(s), count(s) FROM db.t WHERE k > 1000",
    "SELECT k, v FROM db.t WHERE k BETWEEN 40 AND 60 AND NOT v > 80 ORDER BY v DESC, k",
    "SELECT k, s FROM db.t WHERE s IN ('g0', 'g2') AND k <> 3 AND k < 12 ORDER BY s DESC, k",
    "SELECT * FROM db.t$snapshots",
    "SELECT snapshot_id, commit_kind, total_record_count FROM db.t$snapshots WHERE snapshot_id > 1",
    "SELECT count(*) FROM db.t",
    "SELECT * FROM db.t$files",
    "SELECT bucket, level, sum(record_count), max(file_size_in_bytes) FROM db.t$files GROUP BY bucket, level",
    "SELECT * FROM db.t$manifests",
    "SELECT * FROM db.t$schemas",
    "SELECT * FROM db.t$options",
    "SELECT * FROM db.t$tags",
    "SELECT * FROM db.t$branches",
    "SELECT * FROM db.t$consumers",
    "SELECT * FROM db.t$partitions",
    "SELECT * FROM db.t$buckets",
    "SELECT * FROM db.t$statistics",
    "SELECT * FROM db.t$aggregation_fields",
    "SELECT * FROM db.t$file_monitor",
    "SELECT rowkind, count(*) FROM db.t$audit_log GROUP BY rowkind",
    "SELECT * FROM db.t$audit_log WHERE k >= 95 AND k < 105",
    "SELECT k, v FROM db.t$read_optimized WHERE k < 3",
    "SELECT * FROM db.t$nope",
    "SELECT s, count(*), sum(v), avg(x) FROM db.t GROUP BY s ORDER BY s",
    "SELECT s, count(*), sum(v), avg(x) FROM db.t GROUP BY s",
    "SELECT s FROM db.t GROUP BY s ORDER BY s",
    "SELECT s, k, max(v) FROM db.t WHERE k < 6 GROUP BY s, k ORDER BY k",
    "SELECT s, v FROM db.t GROUP BY s",
    "SELECT count(*) FROM db.t GROUP BY nope",
    "SELECT g, count(*), count(v), sum(v), min(v), avg(v) FROM db.nulls GROUP BY g",
    "SELECT count(*) FROM db.nulls WHERE g IS NOT NULL GROUP BY g ORDER BY g",
    "SELECT g, max(v) FROM db.nulls WHERE g IS NULL GROUP BY g",
    "SELECT count(*), max(v) FROM db.t FOR VERSION AS OF 1;",
    "SELECT count(*) FROM db.t FOR VERSION AS OF 'after-first'",
    "SELECT count(*) FROM db.t FOR TAG AS OF 'after-first'",
    "SELECT * FROM db.t FOR TAG AS OF ''",
    "SELECT * FROM db.t FOR TIMESTAMP AS OF 'not-a-date'",
    "SELECT count(*) FROM db.t FOR TIMESTAMP AS OF '2999-01-01 00:00:00'",
    "SELECT count(*) FROM db.t /*+ OPTIONS('scan.snapshot-id' = '1') */",
    "SELECT count(*) FROM db.t /*+ OPTIONS('merge-read-batch-rows' = '64') */",
    "SELECT k FROM db.t /*+ OPTIONS('scan.snapshot-id' = '1') */ WHERE k < 5 ORDER BY k",
    "SELECT * FROM db.t /*+ OPTIONS(bad) */",
    "SELECT * FROM db.t$snapshots /*+ OPTIONS('scan.snapshot-id' = '1') */",
    "SELECT DISTINCT s FROM db.t ORDER BY s",
    "SELECT DISTINCT s, k FROM db.t WHERE k < 3 ORDER BY k",
    "SELECT DISTINCT count(*) FROM db.t",
    "SELECT DISTINCT * FROM db.t",
    "SELECT s, count(*) FROM db.t GROUP BY s HAVING count(*) >= 50 ORDER BY s",
    "SELECT s, min(k) FROM db.t GROUP BY s HAVING min(k) < 2 ORDER BY s",
    "SELECT s FROM db.t GROUP BY s HAVING max(k) = 149",
    "SELECT s, count(*) FROM db.t GROUP BY s HAVING s <> 'g1' AND count(*) > 0 ORDER BY s",
    "SELECT s, sum(v) FROM db.t GROUP BY s HAVING sum(v) > 0 ORDER BY sum(v) DESC LIMIT 1",
    "SELECT count(*) FROM db.t HAVING count(*) > 1",
    "SELECT s, count(*) FROM db.t GROUP BY s HAVING v > 3",
    "SELECT nope FROM db.t",
    "SELECT k, count(*) FROM db.t",
    "SELECT k FROM db.t ORDER BY k sideways",
    "SELECT avg(*) FROM db.t GROUP BY s",
    "DELETE FROM db.t",
    "EXPLAIN SELECT k, v FROM db.t WHERE k >= 140 ORDER BY k LIMIT 3",
    "EXPLAIN SELECT k FROM db.t WHERE k >= 140 LIMIT 3",
    "EXPLAIN SELECT s, count(*) FROM db.t GROUP BY s HAVING count(*) > 1 ORDER BY s",
    "EXPLAIN SELECT count(*) FROM db.t /*+ OPTIONS('sort-engine' = 'pallas') */",
    "EXPLAIN SELECT * FROM db.t$snapshots",
    "EXPLAIN SELECT nope FROM db.t",
]


@pytest.mark.parametrize("statement", SELECTS)
def test_select_matches_jax(merged, statement):
    run_both(*merged, statement)


def test_select_sees_merged_rows(merged):
    out = run_both(*merged, "SELECT k, v FROM db.t ORDER BY k")
    rows = dict(out.to_pylist())
    assert out.num_rows == 150 and rows[75] == 150 and rows[25] == 25


# ---------------------------------------------------------------------------
# GROUP BY under every sort engine, over NaN, -0.0 and NULL keys
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["jax", "port"], ids=["jax-written", "port-written"])
def specials(request, tmp_path_factory):
    writer = request.param
    warehouse = str(tmp_path_factory.mktemp(f"specials-{writer}"))
    jcat, pcat = catalogs(warehouse)
    m = _pkg(writer)
    cat = jcat if writer == "jax" else pcat
    t = cat.create_table(
        "db.f",
        m.RowType.of(("k", m.BIGINT(False)), ("g", m.STRING()), ("h", m.INT()), ("d", m.DOUBLE()),
                     ("f", m.FLOAT()), ("i", m.INT()), ("b", m.BOOLEAN())),
        primary_keys=["k"], options={"bucket": "1", "write-only": "true"},
    )
    rng = np.random.default_rng(17)
    n = 1200
    specials_ = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf])
    for r in range(2):
        ids = rng.choice(2 * n, n, replace=False).astype(np.int64)
        d = np.round(rng.normal(size=n) * 10, 2)
        d = np.where(rng.random(n) < 0.1, specials_[rng.integers(0, 5, n)], d)
        g = np.array([f"g{int(x) % 7}" for x in rng.integers(0, 100, n)], dtype=object)
        write(t, {
            "k": ids,
            "g": [None if x else v for x, v in zip(rng.random(n) < 0.08, g)],
            "h": [None if x else int(v) for x, v in zip(rng.random(n) < 0.05, rng.integers(-3, 3, n))],
            "d": [None if x else float(v) for x, v in zip(rng.random(n) < 0.1, d)],
            "f": d.astype(np.float32),
            "i": [None if x else int(v) for x, v in zip(rng.random(n) < 0.1, rng.integers(-1000, 1000, n))],
            "b": rng.random(n) < 0.5,
        })
    # a group whose d and i are all NULL
    write(t, {"k": [10_000, 10_001], "g": ["lonely", "lonely"], "h": [9, 9], "d": [None, None],
              "f": [np.float32(-0.0), np.float32(0.0)], "i": [None, None], "b": [True, False]})
    return jcat, pcat


GROUP_QUERIES = [
    "SELECT g, count(*), count(d), sum(d), min(d), max(d), avg(d) FROM db.f{hint} GROUP BY g",
    "SELECT g, h, sum(i), min(i), max(i), avg(i), sum(f), min(f), max(f) FROM db.f{hint} GROUP BY g, h",
    "SELECT h, count(*), sum(d) FROM db.f{hint} WHERE d IS NOT NULL GROUP BY h ORDER BY h DESC",
    "SELECT g, count(*) FROM db.f{hint} GROUP BY g HAVING count(*) > 300",
    "SELECT DISTINCT h FROM db.f{hint}",
    "SELECT g, count(*), count(b) FROM db.f{hint} GROUP BY g",
    "SELECT g, min(b), max(b) FROM db.f{hint} GROUP BY g",
    "SELECT h, max(k), min(k) FROM db.f{hint} WHERE k < 0 GROUP BY h",
    "SELECT g, sum(d) FROM db.f{hint} WHERE g = 'lonely' GROUP BY g",
    "SELECT count(*), sum(d), min(f), max(f), avg(i) FROM db.f{hint}",
]
HINTS = {"default": "", "pallas": " /*+ OPTIONS('sort-engine' = 'pallas') */",
         "numpy": " /*+ OPTIONS('sort-engine' = 'numpy') */"}


@pytest.mark.parametrize("engine", list(HINTS))
@pytest.mark.parametrize("query", GROUP_QUERIES, ids=[f"q{i}" for i in range(len(GROUP_QUERIES))])
def test_group_by_matches_jax_at_each_engine(specials, engine, query):
    run_both(*specials, query.format(hint=HINTS[engine]))


def test_group_by_engines_agree_in_the_port(specials):
    """The plain torch ops and the kernels give one result, first-appearance
    order included. The numpy twin adds float32 pairwise and takes either
    zero for min(-0.0, +0.0), in the JAX package too, so only its order and
    integer columns are held to the others."""
    _, pcat = specials
    q = GROUP_QUERIES[1]
    plain, kernels, host = (port_execute(pcat, q.format(hint=HINTS[e])) for e in ("default", "pallas", "numpy"))
    assert_same(plain, kernels, "kernels")
    exact = [n for n in plain.schema.field_names if plain.column(n).values.dtype.kind != "f"]
    assert_same(plain.select(exact), host.select(exact), "numpy twin")


# ---------------------------------------------------------------------------
# JOIN: a small retail star schema
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["jax", "port"], ids=["jax-written", "port-written"])
def star(request, tmp_path_factory):
    writer = request.param
    warehouse = str(tmp_path_factory.mktemp(f"star-{writer}"))
    jcat, pcat = catalogs(warehouse)
    m = _pkg(writer)
    cat = jcat if writer == "jax" else pcat
    rng = np.random.default_rng(23)
    n_dim, n_fact = 300, 3000
    dim = cat.create_table("shop.dim", m.RowType.of(("cid", m.STRING(False)), ("name", m.STRING()),
                                                    ("rate", m.DOUBLE()), ("region", m.STRING())),
                           primary_keys=["cid"], options={"bucket": "1"})
    cids = np.array([f"C{i:05d}" for i in range(n_dim)], dtype=object)
    write(dim, {"cid": cids, "name": [f"customer-{i % 120}" for i in range(n_dim)],
                "rate": np.round(rng.random(n_dim), 3), "region": [("eu", "us", "apac")[i % 3] for i in range(n_dim)]})
    fact = cat.create_table("shop.fact", m.RowType.of(("id", m.BIGINT(False)), ("cust", m.STRING(False)),
                                                      ("amount", m.DOUBLE()), ("qty", m.BIGINT()),
                                                      ("name", m.STRING())),
                            primary_keys=["id"], options={"bucket": "1"})
    keys = np.minimum((rng.pareto(1.1, n_fact) * n_dim / 20).astype(np.int64), n_dim + 20)
    cust = np.array([f"C{int(k):05d}" for k in keys], dtype=object)  # some beyond the dimension
    for r in range(2):
        sl = slice(r * n_fact // 2, (r + 1) * n_fact // 2)
        write(fact, {"id": np.arange(sl.start, sl.stop, dtype=np.int64), "cust": cust[sl],
                     "amount": np.round(rng.random(n_fact // 2) * 100, 2), "qty": rng.integers(1, 9, n_fact // 2),
                     "name": [f"order-{i}" for i in range(sl.start, sl.stop)]})
    return jcat, pcat


JOINS = [
    "SELECT d.name, count(*), sum(f.amount), max(f.qty) FROM shop.fact f JOIN shop.dim d "
    "ON f.cust = d.cid GROUP BY d.name ORDER BY d.name LIMIT 50",
    "SELECT d.name, count(*), sum(f.amount), max(f.qty) FROM shop.fact f JOIN shop.dim d "
    "ON f.cust = d.cid GROUP BY d.name",
    "SELECT f.id, d.cid, d.rate FROM shop.fact f LEFT JOIN shop.dim d ON f.cust = d.cid "
    "WHERE d.rate > 0.5 ORDER BY f.id LIMIT 40",
    "SELECT f.id, d.cid, d.rate FROM shop.fact f LEFT OUTER JOIN shop.dim d ON f.cust = d.cid "
    "WHERE f.id < 30 ORDER BY f.id",
    "SELECT f.id, region FROM shop.fact f INNER JOIN shop.dim d ON f.cust = d.cid "
    "WHERE region = 'eu' AND f.qty >= 5 AND f.amount < d.rate * 100 ORDER BY f.id LIMIT 25",
    "SELECT * FROM shop.fact f JOIN shop.dim d ON f.cust = d.cid WHERE f.id < 20 ORDER BY f.id",
    "SELECT region, count(*), avg(amount) FROM shop.fact f JOIN shop.dim d ON f.cust = d.cid "
    "GROUP BY region HAVING count(*) > 10 ORDER BY region",
    "SELECT region, sum(f.qty) FROM shop.fact f JOIN shop.dim d ON f.cust = d.cid "
    "GROUP BY region HAVING max(d.rate) > 0.9 ORDER BY region",
    "SELECT count(*), sum(qty), min(rate) FROM shop.fact JOIN shop.dim ON cust = cid",
    "SELECT f.cust, d.name FROM shop.fact /*+ OPTIONS('join.pushdown-in-limit' = '2') */ f "
    "JOIN shop.dim d ON f.cust = d.cid WHERE d.cid IN ('C00003', 'C00005', 'C00007') ORDER BY f.id",
    "SELECT f.cust, d.name FROM shop.fact f JOIN shop.dim d ON f.cust = d.cid "
    "WHERE d.cid IN ('C00003', 'C00005', 'C00007') ORDER BY f.id",
    "SELECT f.id, d.name FROM shop.fact f JOIN shop.dim d /*+ OPTIONS('sort-engine' = 'pallas') */ "
    "ON f.cust = d.cid WHERE f.id >= 2990 ORDER BY f.id",
    "SELECT name FROM shop.fact f JOIN shop.dim d ON f.cust = d.cid",
    "SELECT f.id FROM shop.fact f JOIN shop.dim f ON f.cust = f.cid",
    "SELECT f.id FROM shop.fact f JOIN shop.dim d ON f.cust < d.cid",
    "SELECT f.id FROM shop.fact f JOIN shop.dim d ON f.cust = f.name",
    "SELECT f.id FROM shop.fact f JOIN shop.dim d ON f.cust = d.cid WHERE q.x = 1",
    "SELECT f.id FROM shop.fact f JOIN shop.dim$snapshots d ON f.cust = d.cid",
    "EXPLAIN SELECT f.id FROM shop.fact f JOIN shop.dim d ON f.cust = d.cid",
]


@pytest.mark.parametrize("statement", JOINS, ids=[f"j{i}" for i in range(len(JOINS))])
def test_join_matches_jax(star, statement):
    run_both(*star, statement)


# ---------------------------------------------------------------------------
# the counterpart of tests/test_sql_randomized.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def randomized(tmp_path_factory):
    rng = np.random.default_rng(99)
    warehouse = str(tmp_path_factory.mktemp("sqlrand"))
    jcat, pcat = catalogs(warehouse)
    t = pcat.create_table(
        "db.r", tt.RowType.of(("k", tt.BIGINT(False)), ("a", tt.BIGINT()), ("b", tt.DOUBLE()), ("g", tt.STRING())),
        primary_keys=["k"], options={"bucket": "1", "write-only": "true"},
    )
    n = 1500
    for r in range(3):
        ks = rng.choice(2 * n, size=n, replace=False)
        write(t, {"k": ks, "a": ks * (r + 1) % 1000, "b": ks * 0.25 + r, "g": [f"g{int(x) % 5}" for x in ks]})
    return jcat, pcat, rng


WHERES = ["k >= {v}", "a < {v} AND k < 1500", "a BETWEEN {v} AND {v2}", "g = 'g1' OR g = 'g3'",
          "g LIKE 'g%' AND NOT a > {v}", "k IN ({v}, {v2}, 999999)", "NOT (a <= {v} OR g LIKE '%4')"]


def test_random_queries_match_jax(randomized):
    jcat, pcat, rng = randomized
    for i in range(14):
        v, v2 = sorted(int(x) for x in rng.integers(0, 1000, size=2))
        where = WHERES[i % len(WHERES)].format(v=v, v2=v2)
        run_both(jcat, pcat, f"SELECT k FROM db.r WHERE {where}")
        run_both(jcat, pcat, f"SELECT g, count(*), sum(a), min(b), max(b), avg(a) FROM db.r "
                             f"WHERE {where} GROUP BY g ORDER BY g")
        lim = int(rng.integers(1, 50))
        run_both(jcat, pcat, f"SELECT k, b FROM db.r ORDER BY b DESC, k LIMIT {lim}")
