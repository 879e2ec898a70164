"""String primary keys in the port (paimon_tpu_torch) against the JAX
package, on the CPU (device="cpu" for the port), and the guards that came
with them.

Modules: the pools (build_string_pool, exact_string_pool) and the key lanes
(encode_key_lanes with given pools, encode_key_lanes_with_pools,
lane_count) over string, bytes and composite (string, int) keys at 1,000
and 70,000 rows, on both sides of the JAX package's 65,536-row switch to
pyarrow. The values hold the empty string, prefix-equal strings, non-ASCII
text, a supplementary-plane character, trailing U+0000, and bytes with 0x00
and 0xff. A value missing from its pool, an empty pool and no pool raise
the JAX package's ValueError. The MergeExecutor of each package merges the
same string-keyed batches under every engine.

Tables: deduplicate, partial-update, aggregation and first-row tables keyed
by a string (and by (string, int)), at bucket 1, bucket 2, dynamic buckets
and partitioned by dt with key (dt, name), written by each package and read
by both: the same rows in the same order, equal to an oracle built here,
with the same file metadata (key ranges and key stats, truncated to 16
characters). Each package continues the other's table in streaming commits
with compaction, where both plan the same sections. A merge past 65,536
rows, and a table written under merge.dict-domain=true, read the same in
both packages (the port's reads of it in the code domain).

Guards: a BYTES primary key (the JAX package fails to commit such a table)
and record-level TTL on read raise NotImplementedError naming what is
missing; each test first shows what the JAX package does. Partition
expiration and the post-commit options (empty snapshots, automatic tags,
commit callbacks), once guarded here, give the JAX package's results.

Tolerance: exact. Pools, ranks, lanes, keys and row values are compared for
equality.
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
from paimon_tpu.core.kv import KVBatch as JaxKV
from paimon_tpu.core.levels import IntervalPartition as JaxPartition
from paimon_tpu.core.mergefn import MergeExecutor as JaxMerge
from paimon_tpu.data import keys as jk
from paimon_tpu.data.batch import ColumnBatch as JaxBatch
from paimon_tpu.options import CoreOptions as JaxOptions
from paimon_tpu_torch.catalog import FileSystemCatalog as PortCatalog
from paimon_tpu_torch.core.kv import KVBatch as PortKV
from paimon_tpu_torch.core.levels import IntervalPartition as PortPartition
from paimon_tpu_torch.core.mergefn import MergeExecutor as PortMerge
from paimon_tpu_torch.data import keys as pk
from paimon_tpu_torch.data.batch import ColumnBatch as PortBatch
from paimon_tpu_torch.options import CoreOptions as PortOptions


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


# ---------------------------------------------------------------------------
# pools and lanes
# ---------------------------------------------------------------------------

EDGE_STRINGS = ["", "a", "ab", "abc", "a\x00", "a\x00\x00", "\x00", "ab\x00c", "aé", "é", "b", "zz",
                "\U0001F600", "\U0001F600a", "\U00010000", "￿", "퟿", "日本", "x" * 40, "x" * 40 + "\x00"]
EDGE_BYTES = [b"", b"\x00", b"\x00\x00", b"\xff", b"\x00\xff", b"\xff\x00", b"\xff\xff", b"a", b"a\x00", b"ab",
              b"\x7f", b"\x80"]
ALPHABET = np.array(list("abAB0\x00é日\U0001F600-"), dtype=object)


def _distinct(kind: str, count: int, rng) -> list:
    """The edge values plus random ones, all distinct."""
    out = dict.fromkeys(EDGE_BYTES if kind == "bytes" else EDGE_STRINGS)
    while len(out) < count:
        if kind == "bytes":
            v = bytes(rng.integers(0, 256, int(rng.integers(0, 12)), dtype=np.uint8))
        else:
            v = "".join(ALPHABET[rng.integers(0, len(ALPHABET), int(rng.integers(0, 12)))])
        out.setdefault(v)
    return list(out)


def _column_values(kind: str, n: int, seed: int) -> np.ndarray:
    """n rows drawn with repeats from about n/3 distinct values; every edge
    value appears."""
    rng = np.random.default_rng(seed)
    distinct = np.empty(max(n // 3, 40), dtype=object)
    distinct[:] = _distinct(kind, len(distinct), rng)
    values = distinct[rng.integers(0, len(distinct), n)]
    values[: len(EDGE_STRINGS)] = distinct[: len(EDGE_STRINGS)]
    return values


def _same_pool(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == want.dtype == np.dtype(object)
    assert len(got) == len(want)
    assert all(type(a) is type(b) and a == b for a, b in zip(got.tolist(), want.tolist()))


def _batches(columns: dict, types: dict):
    return (JaxBatch.from_pydict(jt.RowType.of(*((k, t(jt)) for k, t in types.items())), columns),
            PortBatch.from_pydict(tt.RowType.of(*((k, t(tt)) for k, t in types.items())), columns))


KEY_TYPES = {"string": lambda p: p.STRING(False), "bytes": lambda p: p.BYTES(False), "int": lambda p: p.INT(False)}


@pytest.mark.parametrize("route", ["image", "objects"])
@pytest.mark.parametrize("n", [1000, 70_000])
@pytest.mark.parametrize("kind", ["string", "bytes"])
def test_pools_and_lanes_match(kind, n, route, monkeypatch):
    """Pools element for element and lanes bit for bit, one column or two
    runs of one merge (the pool covers both); through the fixed-width image
    and through the Python objects the port falls back to when the image
    would be too large."""
    if route == "objects":
        monkeypatch.setattr(pk, "_IMAGE_BYTES_MAX", 0)
    values = _column_values(kind, n, seed=n + len(kind))
    runs = [values[: n // 3], values[n // 3 :]]
    _same_pool(pk.build_string_pool(runs), jk.build_string_pool(runs))
    jb, tb = _batches({"k": values}, {"k": KEY_TYPES[kind]})
    jpool, ppool = jk.exact_string_pool([jb.column("k")]), pk.exact_string_pool([tb.column("k")])
    _same_pool(ppool, jpool)
    want = jk.encode_key_lanes(jb, ["k"], {"k": jpool})
    got = pk.encode_key_lanes(tb, ["k"], {"k": ppool})
    assert got.dtype == want.dtype == np.uint32 and np.array_equal(got, want)
    assert np.array_equal(pk.encode_key_lanes_with_pools(tb, ["k"]), want)
    # a pool wider than the column (a merge of other runs): the same ranks
    wide = jk.build_string_pool([values, np.array(_distinct(kind, 60, np.random.default_rng(1)), dtype=object)])
    assert np.array_equal(pk.encode_key_lanes(tb, ["k"], {"k": wide}), jk.encode_key_lanes(jb, ["k"], {"k": wide}))


def test_order_pins():
    """Code-point order is UTF-8 byte order (a supplementary-plane character
    after U+FFFF), and a trailing U+0000 or 0x00 makes a longer, larger
    value of its own, not the value without it."""
    strings = np.array(["\U0001F600", "￿", "a\x00", "a", "", "a\x00\x00", "é"], dtype=object)
    pool = pk.build_string_pool([strings])
    assert pool.tolist() == ["", "a", "a\x00", "a\x00\x00", "é", "￿", "\U0001F600"]
    assert pool.tolist() == sorted(strings.tolist(), key=lambda s: s.encode("utf-8"))
    raw = np.array([b"a", b"a\x00", b"\xff", b"", b"\x00"], dtype=object)
    assert pk.build_string_pool([raw]).tolist() == [b"", b"\x00", b"a", b"a\x00", b"\xff"]
    _, tb = _batches({"k": strings}, {"k": KEY_TYPES["string"]})
    ranks = pk.encode_key_lanes_with_pools(tb, ["k"])[:, 0]
    assert sorted(set(ranks.tolist())) == list(range(len(strings)))


@pytest.mark.parametrize("n", [1000, 70_000])
def test_composite_key_lanes_match(n):
    """A (string, int, bytes) key: one rank lane per string or bytes column
    between the int's lane, as the JAX package lays them out."""
    rng = np.random.default_rng(n)
    columns = {"s": _column_values("string", n, 5), "i": rng.integers(-3, 3, n).astype(np.int32),
               "b": _column_values("bytes", n, 6)}
    types = {"s": KEY_TYPES["string"], "i": KEY_TYPES["int"], "b": KEY_TYPES["bytes"]}
    jb, tb = _batches(columns, types)
    names = ["s", "i", "b"]
    assert pk.lane_count(tb.schema, names) == jk.lane_count(jb.schema, names) == 3
    want = jk.encode_key_lanes_with_pools(jb, names)
    assert np.array_equal(pk.encode_key_lanes_with_pools(tb, names), want)
    order = pk.lexsort_rows(want)
    keys = list(zip(columns["s"].tolist(), columns["i"].tolist(), columns["b"].tolist()))
    assert [keys[i] for i in order] == sorted(keys)


@pytest.mark.parametrize("n", [1000, 70_000])
@pytest.mark.parametrize("pool_case", ["missing_value", "empty_pool", "no_pool"])
def test_missing_pool_values_raise_the_same_error(pool_case, n):
    values = _column_values("string", n, 9)
    jb, tb = _batches({"k": values}, {"k": KEY_TYPES["string"]})
    pool = jk.build_string_pool([values])
    pools = {"missing_value": {"k": np.delete(pool, len(pool) // 2)},
             "empty_pool": {"k": np.empty(0, dtype=object)}, "no_pool": {}}[pool_case]
    with pytest.raises(ValueError) as want:
        jk.encode_key_lanes(jb, ["k"], pools)
    with pytest.raises(ValueError) as got:
        pk.encode_key_lanes(tb, ["k"], pools)
    assert str(got.value) == str(want.value)


MERGE_ENGINES = {
    "deduplicate": {},
    "partial-update": {"merge-engine": "partial-update"},
    "aggregation": {"merge-engine": "aggregation", "fields.a.aggregate-function": "sum",
                    "fields.d.aggregate-function": "max"},
    "first-row": {"merge-engine": "first-row"},
}


@pytest.mark.parametrize("sorted_unique", [False, True], ids=["repeated", "sorted-unique"])
@pytest.mark.parametrize("sort_engine", ["pallas", "xla-segmented", "numpy"])
@pytest.mark.parametrize("engine", list(MERGE_ENGINES))
def test_merge_executor_matches_with_string_keys(engine, sort_engine, sorted_unique):
    """One merge of string-keyed rows (key (k, i)) in each package; sorted
    unique keys take the deduplicate shortcut, which reads the ranks."""
    rng = np.random.default_rng(31)
    n = 600
    k = _column_values("string", n, 12)
    i = rng.integers(0, 2, n).astype(np.int32)
    if sorted_unique:
        pairs = sorted(set(zip(k.tolist(), i.tolist())))
        k = np.array([p[0] for p in pairs], dtype=object)
        i = np.array([p[1] for p in pairs], dtype=np.int32)
        n = len(k)
    a = rng.integers(0, 100, n)
    d = rng.standard_normal(n)
    columns = {"k": k, "i": i, "a": [None if x % 5 == 0 else int(x) for x in a], "d": d.tolist()}
    types = {"k": KEY_TYPES["string"], "i": KEY_TYPES["int"], "a": lambda p: p.BIGINT(), "d": lambda p: p.DOUBLE()}
    jb, tb = _batches(columns, types)
    seq = np.arange(n, dtype=np.int64)[::-1].copy()
    kind = np.zeros(n, dtype=np.uint8)
    opts = {**MERGE_ENGINES[engine], "sort-engine": sort_engine}
    jo, to = JaxOptions(opts), PortOptions(opts)
    want = JaxMerge(jb.schema, ["k", "i"], jo.merge_engine, JaxOptions({**opts, "sort-engine": "numpy"})).merge(
        JaxKV(jb, seq, kind))
    got = PortMerge(tb.schema, ["k", "i"], to.merge_engine, to, device="cpu").merge(PortKV(tb, seq, kind))
    assert np.array_equal(got.seq, want.seq) and np.array_equal(got.kind, want.kind)
    assert got.data.to_pylist() == want.data.to_pylist()


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

DTS = np.array(["2024-01-01", "2024-01-02", "2024-01-03"], dtype=object)
NAMES = np.array([*EDGE_STRINGS, *(f"customer-{i:07d}-{'é' if i % 3 else 'e'}" for i in range(140))], dtype=object)
N_ROWS, COMMITS = 300, 4
ENGINE_OPTIONS = {
    "deduplicate": {},
    "partial-update": {"merge-engine": "partial-update"},
    "aggregation": {"merge-engine": "aggregation", "fields.a.aggregate-function": "sum",
                    "fields.d.aggregate-function": "max", "fields.s.aggregate-function": "last_non_null_value"},
    "first-row": {"merge-engine": "first-row"},
}
# name: (options, primary key, partition key)
LAYOUTS = {
    "bucket_1": ({"bucket": "1"}, ("name",), ()),
    "bucket_2": ({"bucket": "2"}, ("name",), ()),
    "dynamic": ({"dynamic-bucket.target-row-num": "60"}, ("name",), ()),
    "bucket_2_composite": ({"bucket": "2"}, ("name", "n"), ()),
    "partitioned_bucket_2": ({"bucket": "2"}, ("dt", "name"), ("dt",)),
    "partitioned_dynamic": ({"dynamic-bucket.target-row-num": "40"}, ("dt", "name"), ("dt",)),
}
FIELDS = ("dt", "name", "n", "a", "d", "s")


def _table_type(pkg):
    return pkg.RowType.of(("dt", pkg.STRING(False)), ("name", pkg.STRING(False)), ("n", pkg.INT(False)),
                          ("a", pkg.BIGINT()), ("d", pkg.DOUBLE()), ("s", pkg.STRING()))


def _commit_rows(c: int, n: int = N_ROWS) -> dict:
    rng = np.random.default_rng(200 + c)
    name_idx = rng.integers(0, len(NAMES), n)
    return {
        "dt": DTS[rng.integers(0, len(DTS), n)],
        "name": NAMES[name_idx],
        "n": rng.integers(0, 3, n).astype(np.int32),
        "a": [None if x % 5 == c % 5 else int(x * 10 + c) for x in name_idx],
        "d": [None if x % 7 == c else float(x) * 0.5 - c for x in name_idx],
        "s": np.array([None if (x + c) % 4 == 0 else f"s{int(x)}-{c}" for x in name_idx], dtype=object),
    }


def _oracle(engine: str, commits: list, key: tuple) -> list:
    """Sorted rows: per key the last row (deduplicate), the first row
    (first-row), the last non-null value of each field (partial-update), or
    sum(a), max(d) and the last non-null value of the rest (aggregation)."""
    positions = [FIELDS.index(k) for k in key]
    state: dict = {}
    for rows in commits:
        for row in zip(*(rows[f] for f in FIELDS)):
            row = [v.item() if hasattr(v, "item") else v for v in row]
            k = tuple(row[p] for p in positions)
            old = state.get(k)
            if old is None or engine == "deduplicate":
                state[k] = row
            elif engine == "partial-update":
                state[k] = [v if v is not None else o for v, o in zip(row, old)]
            elif engine == "aggregation":
                merged = [v if v is not None else o for v, o in zip(row, old)]
                merged[3] = old[3] if row[3] is None else row[3] if old[3] is None else old[3] + row[3]
                merged[4] = old[4] if row[4] is None else row[4] if old[4] is None else max(old[4], row[4])
                state[k] = merged
    return sorted(tuple(v) for v in state.values())


def _read(table, engine=None) -> list:
    if engine is not None:
        table = table.copy({"sort-engine": engine})
    rb = table.new_read_builder()
    return [tuple(v.item() if hasattr(v, "item") else v for v in row)
            for row in rb.new_read().read_all(rb.new_scan().plan()).to_pylist()]


def _catalogs(warehouse):
    return {"jax": JaxCatalog(warehouse), "port": PortCatalog(warehouse, device="cpu")}


def _create(writer: str, catalog, ident: str, layout: str, options: dict):
    pkg = jt if writer == "jax" else tt
    layout_options, key, partition = LAYOUTS[layout]
    return catalog.create_table(ident, _table_type(pkg), partition_keys=list(partition), primary_keys=list(key),
                                options={**layout_options, **options})


def _batch_commit(table, rows: dict) -> None:
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.write(rows)
    wb.new_commit().commit(w.prepare_commit())


def _stream_commit(table, rows: dict, identifier: int) -> None:
    wb = table.new_stream_write_builder()
    w = wb.new_write()
    w.write(rows)
    wb.new_commit().commit_messages(identifier, w.prepare_commit())


def _metadata(store) -> list:
    """Every live file's placement, key range and key stats."""
    out = []
    for e in store.new_scan().plan().entries:
        f = e.file
        stats = {k: (s.min, s.max, s.null_count, s.row_count) for k, s in sorted(f.key_stats.items())}
        out.append((e.partition, e.bucket, e.total_buckets, f.level, f.row_count, tuple(f.min_key),
                    tuple(f.max_key), stats))
    return sorted(out, key=repr)


def _sections(files, partition_cls) -> list:
    return [[[f.file_name for f in run.files] for run in section] for section in partition_cls(files).partition()]


TABLE_CASES = [(layout, engine) for layout in LAYOUTS for engine in ENGINE_OPTIONS]


@pytest.fixture(scope="module")
def warehouse(tmp_path_factory):
    return str(tmp_path_factory.mktemp("torch_string_keys"))


@pytest.mark.parametrize("layout, engine", TABLE_CASES, ids=[f"{lo}-{en}" for lo, en in TABLE_CASES])
def test_tables_match_across_packages(warehouse, layout, engine):
    """Each package writes the same 4 batch commits (write-only); each table
    is read by the port at its three sort engines and by the JAX package at
    two: the reads are equal, in order, and hold the oracle's rows; the file
    metadata is the same for both writers."""
    commits = [_commit_rows(c) for c in range(COMMITS)]
    tables = {}
    for writer, catalog in _catalogs(warehouse).items():
        ident = f"db.{layout}_{engine.replace('-', '_')}_{writer}"
        tables[writer] = _create(writer, catalog, ident, layout,
                                 {"write-only": "true", **ENGINE_OPTIONS[engine],
                                  "sort-engine": "numpy" if writer == "jax" else "pallas"})
        for rows in commits:
            _batch_commit(tables[writer], rows)
        port, jax_table = (c.get_table(ident) for c in _catalogs(warehouse).values())
        got = [_read(port, e) for e in ("pallas", "xla-segmented", "numpy")]
        want = _read(jax_table, "numpy")
        assert got[0] == got[1] == got[2] == want == _read(jax_table, "xla-segmented"), writer
        tables[writer + "_read"] = want
    assert tables["jax_read"] == tables["port_read"]
    assert sorted(tables["port_read"]) == _oracle(engine, commits, LAYOUTS[layout][1])
    assert _metadata(tables["port"].store) == _metadata(tables["jax"].store)


CONTINUE_CASES = [(layout, first) for layout in ("bucket_1", "bucket_2_composite", "dynamic", "partitioned_bucket_2")
                  for first in ("jax", "port")]


@pytest.mark.parametrize("layout, first", CONTINUE_CASES, ids=[f"{lo}-{fi}-first" for lo, fi in CONTINUE_CASES])
def test_each_package_continues_the_others_table(warehouse, layout, first):
    """Streaming commits with compaction (trigger 3, write-only=false)
    alternate between the packages, then a full compaction: after each
    commit both packages read the same rows, equal to the oracle, and plan
    the same sections of sorted runs from the same files."""
    commits = [_commit_rows(20 + c) for c in range(6)]
    other = "port" if first == "jax" else "jax"
    order = [first, first, other, other, first, other]
    ident = f"db.continue_{layout}_{first}"
    catalogs = _catalogs(warehouse)
    _create(first, catalogs[first], ident, layout,
            {"num-sorted-run.compaction-trigger": "3", "sort-engine": "xla-segmented"})
    for c, writer in enumerate(order):
        _stream_commit(catalogs[writer].get_table(ident), commits[c], c + 1)
        port, jax_table = catalogs["port"].get_table(ident), catalogs["jax"].get_table(ident)
        got = _read(port)
        assert got == _read(jax_table) == _read(port, "numpy"), (c, writer)
        assert sorted(got) == _oracle("deduplicate", commits[: c + 1], LAYOUTS[layout][1])
        for split in jax_table.new_read_builder().new_scan().plan():
            files = port.store.restore_files(split.partition, split.bucket)
            jfiles = jax_table.store.new_scan().with_bucket(split.bucket).with_partition_filter(
                lambda p, want=split.partition: p == want).plan().entries
            assert _sections(files, PortPartition) == _sections([e.file for e in jfiles], JaxPartition)
    wb = catalogs[other].get_table(ident).new_batch_write_builder()
    w = wb.new_write()
    w.compact(full=True)
    wb.new_commit().commit(w.prepare_commit())
    assert _read(catalogs["port"].get_table(ident)) == _read(catalogs["jax"].get_table(ident)) == got


def test_merge_past_the_pool_switch(warehouse):
    """Two runs of 40,000 rows over 50,000 names: each package's read
    builds one pool over 80,000 rows (the JAX package through pyarrow)."""
    names = np.array([f"{'é' if i % 2 else ''}n{i:06d}\x00"[: 8 + i % 3] for i in range(50_000)], dtype=object)
    reads = {}
    for writer, catalog in _catalogs(warehouse).items():
        table = _create(writer, catalog, f"db.switch_{writer}", "bucket_1", {"write-only": "true"})
        for c in range(2):
            rng = np.random.default_rng(40 + c)
            rows = {**{k: v[:40_000] for k, v in _commit_rows(c, 40_000).items()},
                    "name": names[rng.permutation(50_000)[:40_000]]}
            _batch_commit(table, rows)
        reads[writer] = _read(PortCatalog(warehouse, device="cpu").get_table(f"db.switch_{writer}"))
        assert reads[writer] == _read(JaxCatalog(warehouse).get_table(f"db.switch_{writer}"), "numpy")
    assert reads["jax"] == reads["port"]
    assert len(reads["port"]) == len({r[1] for r in reads["port"]})


def test_dict_domain_table_reads_the_same(warehouse):
    """merge.dict-domain=true changes how both packages carry string keys
    through their merges (as dictionary codes), not the rows: the port
    reads and continues that table the same way, and its reads run in the
    code domain."""
    from paimon_tpu_torch.metrics import dict_metrics, registry

    ident = "db.dict_domain"
    catalogs = _catalogs(warehouse)
    _create("jax", catalogs["jax"], ident, "bucket_1",
            {"merge.dict-domain": "true", "num-sorted-run.compaction-trigger": "3", "sort-engine": "xla-segmented"})
    commits = [_commit_rows(60 + c) for c in range(5)]
    for c, rows in enumerate(commits):
        writer = "jax" if c < 4 else "port"
        _stream_commit(catalogs[writer].get_table(ident), rows, c + 1)
        registry.reset()
        got = _read(catalogs["port"].get_table(ident))
        assert dict_metrics().counter("rows_code_domain").count > 0, c
        assert got == _read(catalogs["jax"].get_table(ident)), c
        assert sorted(got) == _oracle("deduplicate", commits[: c + 1], ("name",))


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------


def test_bytes_primary_key_is_refused(warehouse):
    """The JAX package fails to commit a BYTES-keyed table (its data-file
    metadata keeps raw bytes as JSON min/max keys); the port refuses the
    write before any file is written."""
    rows = {"k": np.array([b"", b"\x00\xff", b"a"], dtype=object), "v": np.arange(3)}
    jax_table = JaxCatalog(warehouse).create_table(
        "db.bytes_jax", jt.RowType.of(("k", jt.BYTES(False)), ("v", jt.BIGINT())), primary_keys=["k"],
        options={"bucket": "1"})
    with pytest.raises(TypeError, match="not JSON serializable"):
        _batch_commit(jax_table, rows)
    port = PortCatalog(warehouse, device="cpu").create_table(
        "db.bytes_port", tt.RowType.of(("k", tt.BYTES(False)), ("v", tt.BIGINT())), primary_keys=["k"],
        options={"bucket": "1"})
    with pytest.raises(NotImplementedError, match="primary key column 'k' is BYTES NOT NULL"):
        _batch_commit(port, rows)
    assert not os.path.exists(os.path.join(port.path, "bucket-0"))
    assert _read(port) == []


def _ttl_type(pkg):
    return pkg.RowType.of(("id", pkg.BIGINT(False)), ("ts", pkg.BIGINT()), ("v", pkg.BIGINT()))


@pytest.mark.parametrize("key", ["record-level.expire-time", "record-level.expire-time.ms"])
def test_record_ttl_on_read_raises(warehouse, key):
    """record-level TTL on a write-only table, once refused by the port: the
    row 10^6 s old is dropped on read, by the JAX package and the port, on
    the table either package wrote, under each spelling of the option."""
    import time

    now = int(time.time())
    rows = {"id": np.array([1, 2, 3]), "ts": np.array([now - 10**6, now, now]), "v": np.array([10, 20, 30])}
    options = {"bucket": "1", "write-only": "true", key: "1 h" if key.endswith("time") else "3600000",
               "record-level.time-field": "ts"}
    ident = f"db.ttl_{key.replace('.', '_').replace('-', '_')}"
    jax_table = JaxCatalog(warehouse).create_table(ident, _ttl_type(jt), primary_keys=["id"], options=options)
    _batch_commit(jax_table, rows)
    assert [r[0] for r in _read(jax_table, "numpy")] == [2, 3]
    port = PortCatalog(warehouse, device="cpu").get_table(ident)
    assert _read(port) == _read(jax_table, "numpy")
    fresh = PortCatalog(warehouse, device="cpu").create_table(ident + "_port", _ttl_type(tt), primary_keys=["id"],
                                                              options=options)
    _batch_commit(fresh, rows)
    assert _read(fresh) == _read(JaxCatalog(warehouse).get_table(ident + "_port"), "numpy") == _read(port)
    # without a time field neither package drops anything
    untimed = {k: v for k, v in options.items() if k != "record-level.time-field"}
    for writer, catalog in _catalogs(warehouse).items():
        table = catalog.create_table(f"{ident}_untimed_{writer}", _ttl_type(jt if writer == "jax" else tt),
                                     primary_keys=["id"], options=untimed)
        _batch_commit(table, rows)
        assert [r[0] for r in _read(table)] == [1, 2, 3]


def _partition_type(pkg):
    return pkg.RowType.of(("dt", pkg.STRING(False)), ("id", pkg.BIGINT(False)), ("v", pkg.BIGINT()))


def test_partition_expiration_drops_the_old_partition(warehouse):
    """partition.expiration-time on a partitioned table: the commit drops
    the partition of 2020, leaving 1 row of 3, in the JAX package and in
    the port. An unpartitioned table with the option has nothing to
    expire."""
    options = {"bucket": "2", "write-only": "true", "partition.expiration-time": "1 d",
               "partition.expiration-check-interval": "0 ms"}
    commits = [{"dt": np.array(["2020-01-01", "2020-01-01"], dtype=object), "id": np.array([1, 2]),
                "v": np.array([1, 2])},
               {"dt": np.array(["2999-01-01"], dtype=object), "id": np.array([3]), "v": np.array([3])}]
    jax_table = JaxCatalog(warehouse).create_table("db.part_expire_jax", _partition_type(jt), partition_keys=["dt"],
                                                   primary_keys=["dt", "id"], options=options)
    port = PortCatalog(warehouse, device="cpu").create_table(
        "db.part_expire_port", _partition_type(tt), partition_keys=["dt"], primary_keys=["dt", "id"], options=options)
    for table in (jax_table, port):
        for rows in commits:
            _batch_commit(table, rows)
    assert _read(port) == _read(jax_table, "numpy") == [("2999-01-01", 3, 3)]
    flat = PortCatalog(warehouse, device="cpu").create_table(
        "db.part_expire_flat", _partition_type(tt), primary_keys=["id"], options=options)
    for rows in commits:
        _batch_commit(flat, rows)
    assert len(_read(flat)) == 3


CALLS = []


def record_commit(table, snapshot):
    CALLS.append(snapshot.id)


POST_COMMIT = {
    "commit.force-create-snapshot": "true",
    "tag.automatic-creation": "process-time",
    "commit.callbacks": f"{__name__}:record_commit",
}


@pytest.mark.parametrize("key", list(POST_COMMIT))
def test_post_commit_options_match_the_reference(warehouse, key):
    """Post-commit metadata: after 3 commits and an empty batch commit the
    JAX package and the port each hold 4 snapshots
    (force-create-snapshot), a tag (automatic creation) or have called the
    callback with snapshots 1, 2 and 3; a streaming write continues the
    port's table."""
    options = {"bucket": "1", "write-only": "true", key: POST_COMMIT[key]}
    ident = f"db.post_commit_{key.replace('.', '_').replace('-', '_')}"
    results = []
    for catalog in (JaxCatalog(warehouse), PortCatalog(warehouse, device="cpu")):
        pkg = jt if isinstance(catalog, JaxCatalog) else tt
        table = catalog.create_table(f"{ident}_{pkg.__name__}", _ttl_type(pkg), primary_keys=["id"], options=options)
        CALLS.clear()
        for c in range(3):
            _batch_commit(table, {"id": np.array([c]), "ts": np.array([0]), "v": np.array([c])})
        wb = table.new_batch_write_builder()
        wb.new_commit().commit(wb.new_write().prepare_commit())
        snapshots = sorted(int(n[len("snapshot-"):]) for n in os.listdir(os.path.join(table.path, "snapshot"))
                           if n.startswith("snapshot-"))
        results.append((snapshots, len(table.tags()), list(CALLS)))
    assert results[1] == results[0]
    snapshots, tags, calls = results[1]
    if key == "commit.force-create-snapshot":
        assert snapshots == [1, 2, 3, 4]
    elif key == "tag.automatic-creation":
        assert snapshots == [1, 2, 3] and tags == 1
    else:
        assert snapshots == [1, 2, 3] and calls == [1, 2, 3]
    port = PortCatalog(warehouse, device="cpu").get_table(f"{ident}_{tt.__name__}")
    wb = port.new_stream_write_builder()
    w = wb.new_write()
    w.write({"id": np.array([3]), "ts": np.array([0]), "v": np.array([3])})
    wb.new_commit().commit_messages(1, w.prepare_commit())
    assert [r[0] for r in _read(port)] == [0, 1, 2, 3]