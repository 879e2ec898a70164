"""Buckets and partitions in the port (paimon_tpu_torch) against the JAX
package, on the CPU (device="cpu" for the port).

Modules: the column hash (_hash64) bit for bit over every physical key
type; bucket_ids and group_by_partition_bucket at 1, 2, 8 and 16 buckets,
with and without bucket-key and partition columns; partition_path; the
dynamic-bucket assigner's assignments under initial-buckets,
assigner-parallelism and a bootstrap from the other package's hash index
files; the index manifest and the hash index files read by the other
package.

Tables: a small primary-key table (4 batch commits of 300 rows over 400
ids, a string partition column with 3 values where partitioned) at bucket
2, 8 and -1 (dynamic, the default), partitioned and not, under the
deduplicate, partial-update and aggregation engines, written by each
package and read by both: same rows in the same order, equal to an oracle
built here, and the same (partition, bucket, totalBuckets, row count, key
range) metadata and hash index. Then each package continues the other's
table (batch, write-only; and streaming with compaction), so that a key
routed to another bucket, or an assigner seeded wrongly, would show as a
key read twice. The JAX package writes with its numpy engine and reads
with numpy and xla-segmented; the port runs its kernels' plain versions
(sort-engine=pallas).

Guards: cross-partition upsert raises NotImplementedError naming what is
missing (the JAX package is first shown to write it), predicates and the
local merge buffer raise naming them. Null partition values, on which the
JAX package fails (STRING) or files under 0 (INT), are written by the port
to the partition.default-name directory and read back as None.

Tolerance: exact. Keys, hashes, bucket numbers and row values (integers,
doubles and strings copied or summed in the same order) are compared for
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
from paimon_tpu.core import bucket_index as jbi
from paimon_tpu.core import indexmanifest as jim
from paimon_tpu.core.deletionvectors import IndexFileEntry as JaxEntry
from paimon_tpu.data.batch import ColumnBatch as JaxBatch
from paimon_tpu.format.fileindex import _hash64 as jax_hash64
from paimon_tpu.fs import LocalFileIO as JaxIO
from paimon_tpu.table import bucket as jbucket
from paimon_tpu.utils import partition_path as jax_partition_path
from paimon_tpu_torch.catalog import FileSystemCatalog as PortCatalog
from paimon_tpu_torch.core import bucket_index as pbi
from paimon_tpu_torch.core import indexmanifest as pim
from paimon_tpu_torch.core.deletionvectors import IndexFileEntry as PortEntry
from paimon_tpu_torch.data.batch import ColumnBatch as PortBatch
from paimon_tpu_torch.format.fileindex import _hash64 as port_hash64
from paimon_tpu_torch.fs import LocalFileIO as PortIO
from paimon_tpu_torch.table import bucket as pbucket
from paimon_tpu_torch.utils import partition_path as port_partition_path


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


# ---------------------------------------------------------------------------
# hash, routing, partition paths
# ---------------------------------------------------------------------------


def _hash_inputs() -> dict:
    rng = np.random.default_rng(10)
    ints = {f"int{b}": rng.integers(np.iinfo(f"int{b}").min, np.iinfo(f"int{b}").max, 500, dtype=f"int{b}",
                                    endpoint=True) for b in (8, 16, 32, 64)}
    specials = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1e-300, -1.5, 3.25]
    floats = {f"float{b}": np.concatenate([np.array(specials, f"float{b}"),
                                           rng.standard_normal(300).astype(f"float{b}")]) for b in (32, 64)}
    strings = np.array(["", "a", "dt=2024-01-01", "ünïcødé", "x" * 300, None] +
                       [f"s{i}" for i in rng.integers(0, 10**9, 200)], dtype=object)
    return {
        **ints, **floats,
        "int64_extremes": np.array([np.iinfo(np.int64).min, -1, 0, 1, np.iinfo(np.int64).max], np.int64),
        "bool": rng.random(100) < 0.5,
        "date_days": rng.integers(-20000, 40000, 200).astype(np.int32),
        "timestamp_micros": rng.integers(0, 2**62, 200).astype(np.int64),
        "string": strings,
        "bytes": np.array([b"", b"\x00\xff", b"abc"] + [bytes(rng.integers(0, 256, 9, dtype=np.uint8))
                                                      for _ in range(50)], dtype=object),
    }


HASH_INPUTS = _hash_inputs()


@pytest.mark.parametrize("kind", list(HASH_INPUTS))
def test_hash64_is_bit_identical(kind):
    values = HASH_INPUTS[kind]
    got, want = port_hash64(values), jax_hash64(values)
    assert got.dtype == want.dtype == np.uint64
    assert np.array_equal(got, want)
    if kind.startswith("float"):
        assert got[0] == got[1]  # -0.0 hashes as 0.0


def _route_rows(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "dt": np.array([f"2024-01-{d:02d}" for d in rng.integers(1, 5, n)], dtype=object),
        "hr": rng.integers(0, 3, n).astype(np.int32),
        "id": rng.integers(0, 10**6, n).astype(np.int64),
        "k": rng.integers(-50, 50, n).astype(np.int32),
        "v": rng.standard_normal(n),
    }


def _route_type(pkg):
    return pkg.RowType.of(("dt", pkg.STRING(False)), ("hr", pkg.INT(False)), ("id", pkg.BIGINT(False)),
                          ("k", pkg.INT(False)), ("v", pkg.DOUBLE()))


def _batches(rows: dict):
    return JaxBatch.from_pydict(_route_type(jt), rows), PortBatch.from_pydict(_route_type(tt), rows)


ROUTES = [
    ("unpartitioned", (), ("id",)),
    ("unpartitioned_composite_key", (), ("id", "k")),
    ("bucket_key_k", (), ("k",)),
    ("partition_dt", ("dt",), ("id",)),
    ("partition_dt_hr", ("dt", "hr"), ("id", "k")),
]


@pytest.mark.parametrize("num_buckets", [1, 2, 8, 16])
@pytest.mark.parametrize("name, partition_keys, bucket_keys", ROUTES, ids=[r[0] for r in ROUTES])
def test_routing_matches(name, partition_keys, bucket_keys, num_buckets):
    jb, pb = _batches(_route_rows(3000, num_buckets))
    assert np.array_equal(pbucket.key_hashes(pb, bucket_keys), jbucket.key_hashes(jb, bucket_keys))
    assert np.array_equal(pbucket.bucket_ids(pb, bucket_keys, num_buckets),
                          jbucket.bucket_ids(jb, bucket_keys, num_buckets))
    got = pbucket.group_by_partition_bucket(pb, partition_keys, bucket_keys, num_buckets)
    want = jbucket.group_by_partition_bucket(jb, partition_keys, bucket_keys, num_buckets)
    assert [(p, b) for p, b, _ in got] == [(p, b) for p, b, _ in want]
    assert all(np.array_equal(g, w) for (_, _, g), (_, _, w) in zip(got, want))
    assert {b for _, b, _ in got} == set(range(num_buckets))


PATHS = [
    ((), (), None),
    (("dt",), ("2024-01-01",), None),
    (("dt", "hr"), ("2024-01-01", 7), None),
    (("dt", "hr"), ("", 0), None),
    (("dt",), (None,), None),
    (("dt", "hr"), (None, 3), "nullpart"),
    (("f",), (1.5,), None),
]


@pytest.mark.parametrize("keys, values, default", PATHS)
def test_partition_path_matches(keys, values, default):
    extra = {} if default is None else {"default_name": default}
    assert port_partition_path(keys, values, **extra) == jax_partition_path(keys, values, **extra)


# ---------------------------------------------------------------------------
# the dynamic-bucket assigner and the index files
# ---------------------------------------------------------------------------


ASSIGNERS = [
    ("target_50", 50, None, 0, 1),
    ("target_1", 1, None, 0, 1),
    ("initial_4", 60, 4, 0, 1),
    ("parallelism_3_id_1", 40, None, 1, 3),
    ("initial_5_parallelism_2", 30, 5, 1, 2),
]


def _assign_batches():
    rng = np.random.default_rng(11)
    return [(p, rng.integers(0, 400, n).astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15))
            for p, n in ((("a",), 120), (("b",), 70), (("a",), 150), ((), 90), (("b",), 200), (("a",), 10))]


@pytest.mark.parametrize("name, target, initial, assign_id, parallel", ASSIGNERS, ids=[a[0] for a in ASSIGNERS])
def test_assigner_sequences_match(tmp_path, name, target, initial, assign_id, parallel):
    """The same hashes through both assigners, commit by commit; then a
    fresh assigner of each package bootstraps from the other package's
    index files, and the two fresh ones continue alike."""
    args = dict(initial_buckets=initial, assign_id=assign_id, num_assigners=parallel)
    jax_path, port_path = str(tmp_path / "jax"), str(tmp_path / "port")
    ja = jbi.SimpleHashBucketAssigner(jbi.HashIndexFile(JaxIO(), jax_path), target, **args)
    pa_ = pbi.SimpleHashBucketAssigner(pbi.HashIndexFile(PortIO(), port_path), target, **args)
    batches = _assign_batches()
    entries = {}
    for i, (partition, hashes) in enumerate(batches[:4]):
        assert np.array_equal(pa_.assign(partition, hashes), ja.assign(partition, hashes))
        if i % 2:
            je, pe = ja.prepare_commit(), pa_.prepare_commit()
            assert {p: [(e.kind, e.bucket, e.row_count) for e in es] for p, es in pe.items()} == \
                   {p: [(e.kind, e.bucket, e.row_count) for e in es] for p, es in je.items()}
            for p in je:
                entries[p] = {"jax": {e.bucket: e.file_name for e in je[p]} | entries.get(p, {}).get("jax", {}),
                              "port": {e.bucket: e.file_name for e in pe[p]} | entries.get(p, {}).get("port", {})}
    # continue from the other package's index files
    ja2 = jbi.SimpleHashBucketAssigner(jbi.HashIndexFile(JaxIO(), port_path), target, **args)
    pa2 = pbi.SimpleHashBucketAssigner(pbi.HashIndexFile(PortIO(), jax_path), target, **args)
    for p, names in entries.items():
        ja2.bootstrap(p, {b: ja2.index_file.read(n) for b, n in names["port"].items()})
        pa2.bootstrap(p, {b: pa2.index_file.read(n) for b, n in names["jax"].items()})
    # (a bootstrapped assigner restarts its round-robin cursor, so the pair
    # is held to each other, not to the assigners that went on)
    for partition, hashes in batches[4:]:
        assert np.array_equal(pa2.assign(partition, hashes), ja2.assign(partition, hashes))


def test_index_files_read_by_the_other_package(tmp_path):
    path = str(tmp_path)
    hashes = np.random.default_rng(12).integers(0, 2**63, 1000).astype(np.uint64) * np.uint64(3)
    port_name = pbi.HashIndexFile(PortIO(), path).write(hashes)
    jax_name = jbi.HashIndexFile(JaxIO(), path).write(hashes)
    want = np.sort(hashes)
    for name in (port_name, jax_name):
        assert np.array_equal(jbi.HashIndexFile(JaxIO(), path).read(name), want)
        assert np.array_equal(pbi.HashIndexFile(PortIO(), path).read(name), want)
    rows = [("HASH_INDEX", ("2024-01-01", 3), 0, port_name, 1000), ("HASH_INDEX", (), 7, jax_name, 5),
            ("DELETION_VECTORS", ("x",), 1, "dv-1", 2)]
    os.makedirs(f"{path}/manifest")
    port_manifest = pim.write_index_manifest(PortIO(), path, [PortEntry(*r) for r in rows])
    jax_manifest = jim.write_index_manifest(JaxIO(), path, [JaxEntry(*r) for r in rows])
    for name in (port_manifest, jax_manifest):
        assert [tuple(vars(e).values()) for e in jim.read_index_manifest(JaxIO(), path, name)] == rows
        assert [tuple(vars(e).values()) for e in pim.read_index_manifest(PortIO(), path, name)] == rows


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

N_KEYS, N_ROWS, COMMITS = 400, 300, 4
DTS = np.array(["2024-01-01", "2024-01-02", "2024-01-03"], dtype=object)
ENGINE_OPTIONS = {
    "deduplicate": {},
    "partial-update": {"merge-engine": "partial-update"},
    "aggregation": {"merge-engine": "aggregation", "fields.a.aggregate-function": "sum",
                    "fields.d.aggregate-function": "max", "fields.s.aggregate-function": "last_non_null_value"},
}
LAYOUTS = {"bucket_2": {"bucket": "2"}, "bucket_8": {"bucket": "8"},
           "dynamic": {"dynamic-bucket.target-row-num": "60"}}


def _table_type(pkg):
    return pkg.RowType.of(("dt", pkg.STRING(False)), ("id", pkg.BIGINT(False)), ("a", pkg.BIGINT()),
                          ("d", pkg.DOUBLE()), ("s", pkg.STRING()))


def _commit_rows(c: int) -> dict:
    rng = np.random.default_rng(100 + c)
    ids = rng.integers(0, N_KEYS, N_ROWS).astype(np.int64)
    return {
        "dt": DTS[rng.integers(0, len(DTS), N_ROWS)],
        "id": ids,
        "a": [None if x % 5 == c % 5 else int(x * 10 + c) for x in ids],
        "d": [None if x % 7 == c else float(x) * 0.5 - c for x in ids],
        "s": np.array([None if (x + c) % 4 == 0 else f"s{int(x)}-{c}" for x in ids], dtype=object),
    }


def _oracle(engine: str, commits: list[dict], partitioned: bool) -> list[tuple]:
    """Sorted rows: per key, the last row (deduplicate), the last non-null
    value of each field (partial-update), or sum(a), max(d) and the last
    non-null s (aggregation). Unpartitioned tables key by id alone."""
    state: dict[tuple, list] = {}
    for rows in commits:
        for row in zip(*rows.values()):
            key = (row[0], row[1]) if partitioned else (row[1],)
            old = state.get(key)
            if old is None or engine == "deduplicate":
                state[key] = list(row)
                continue
            old[0] = row[0]
            if engine == "partial-update":
                state[key] = [v if v is not None else o for v, o in zip(row, old)]
            else:
                old[2] = row[2] if old[2] is None else old[2] + (row[2] or 0)
                old[3] = row[3] if old[3] is None else (old[3] if row[3] is None else max(old[3], row[3]))
                old[4] = row[4] if row[4] is not None else old[4]
    return sorted(tuple(v) for v in state.values())


def _py(v):
    return v.item() if hasattr(v, "item") else v


def _read(table, engine=None) -> list[tuple]:
    if engine is not None:
        table = table.copy({"sort-engine": engine})
    rb = table.new_read_builder()
    return [tuple(_py(v) for v in row) for row in rb.new_read().read_all(rb.new_scan().plan()).to_pylist()]


def _options(layout: str, engine: str, writer: str, **extra) -> dict:
    return {"write-only": "true", "sort-engine": "numpy" if writer == "jax" else "pallas",
            **LAYOUTS[layout], **ENGINE_OPTIONS[engine], **extra}


def _create(writer: str, catalog, ident: str, partitioned: bool, options: dict):
    pkg = jt if writer == "jax" else tt
    return catalog.create_table(ident, _table_type(pkg), partition_keys=["dt"] if partitioned else [],
                                primary_keys=["dt", "id"] if partitioned else ["id"], options=options)


def _batch_commit(table, rows: dict) -> None:
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.write(rows)
    wb.new_commit().commit(w.prepare_commit())


def _catalogs(warehouse):
    return {"jax": JaxCatalog(warehouse), "port": PortCatalog(warehouse, device="cpu")}


def _metadata(store) -> list[tuple]:
    plan = store.new_scan().plan()
    files = sorted((e.partition, e.bucket, e.total_buckets, e.file.level, e.file.row_count,
                    tuple(e.file.min_key), tuple(e.file.max_key)) for e in plan.entries)
    index = sorted((e.kind, e.partition, e.bucket, e.row_count) for e in plan.index_entries)
    return files, index


def _hash_index(warehouse: str, ident: str) -> dict:
    """{(partition, bucket): sorted key hashes} of the latest snapshot, read
    by the port."""
    table = PortCatalog(warehouse, device="cpu").get_table(ident)
    hif = pbi.HashIndexFile(PortIO(), table.path)
    entries = table.store.new_scan().plan().index_entries
    return {(e.partition, e.bucket): hif.read(e.file_name) for e in entries if e.kind == "HASH_INDEX"}


TABLE_CASES = [(layout, partitioned, engine) for layout in LAYOUTS for partitioned in (False, True)
               for engine in ENGINE_OPTIONS]


def _case_id(layout, partitioned, engine):
    return f"{layout}-{'partitioned' if partitioned else 'unpartitioned'}-{engine}"


@pytest.fixture(scope="module")
def warehouse(tmp_path_factory):
    return str(tmp_path_factory.mktemp("torch_buckets"))


@pytest.mark.parametrize("layout, partitioned, engine", TABLE_CASES, ids=[_case_id(*c) for c in TABLE_CASES])
def test_tables_match_across_packages(warehouse, layout, partitioned, engine):
    """Each package writes the same commits; each table is read by both:
    the four reads are equal, in order, and hold the oracle's rows; the
    file metadata and the hash index are the same for both writers."""
    commits = [_commit_rows(c) for c in range(COMMITS)]
    name = _case_id(layout, partitioned, engine).replace("-", "_")
    tables = {}
    for writer, catalog in _catalogs(warehouse).items():
        tables[writer] = _create(writer, catalog, f"db.{name}_{writer}", partitioned, _options(layout, engine, writer))
        for rows in commits:
            _batch_commit(tables[writer], rows)
    want = _oracle(engine, commits, partitioned)
    reads = []
    for writer in tables:
        ident = f"db.{name}_{writer}"
        jax_table = JaxCatalog(warehouse).get_table(ident)
        port_read = _read(PortCatalog(warehouse, device="cpu").get_table(ident))
        assert port_read == _read(jax_table, "numpy") == _read(jax_table, "xla-segmented"), writer
        reads.append(port_read)
    assert reads[0] == reads[1]
    assert sorted(reads[0]) == want
    assert _metadata(tables["jax"].store) == _metadata(tables["port"].store)
    jax_index, port_index = (_hash_index(warehouse, f"db.{name}_{w}") for w in ("jax", "port"))
    assert jax_index.keys() == port_index.keys()
    assert all(np.array_equal(jax_index[k], port_index[k]) for k in jax_index)
    if layout == "dynamic":
        buckets = {(p, b) for p, b in jax_index}
        assert len(buckets) > (len(DTS) if partitioned else 1)  # the target of 60 keys splits partitions
        assert os.path.isdir(f"{tables['port'].path}/dt={DTS[0]}/bucket-1" if partitioned
                             else f"{tables['port'].path}/bucket-1")
    else:
        assert not jax_index


def _stream_commits(table, batches, first_identifier: int) -> None:
    wb = table.new_stream_write_builder()
    w = wb.new_write()
    c = wb.new_commit()
    for i, rows in enumerate(batches):
        w.write(rows)
        c.commit_messages(first_identifier + i, w.prepare_commit())


CONTINUE_CASES = [
    ("bucket_2", False, "batch"), ("bucket_8", True, "batch"), ("dynamic", False, "batch"), ("dynamic", True, "batch"),
    ("bucket_2", True, "stream"), ("dynamic", False, "stream"), ("dynamic", True, "stream"),
]


@pytest.mark.parametrize("layout, partitioned, mode", CONTINUE_CASES,
                         ids=[f"{c[0]}-{'partitioned' if c[1] else 'unpartitioned'}-{c[2]}" for c in CONTINUE_CASES])
@pytest.mark.parametrize("first", ["jax", "port"])
def test_each_package_continues_the_others_table(warehouse, layout, partitioned, mode, first):
    """Commits alternate between the packages (two each, then one each), in
    batch commits of a write-only table or in streams with compaction
    (trigger 3) and a closing full compaction. After each hand-over both
    packages read the same rows, in order, with every key once, equal to
    the oracle; in dynamic mode each key's hash sits in exactly one
    bucket's index, the bucket its row is in."""
    commits = [_commit_rows(10 + c) for c in range(6)]
    order = [first, first, *(["port", "jax"] if first == "jax" else ["jax", "port"]), first,
             "port" if first == "jax" else "jax"]
    extra = {"num-sorted-run.compaction-trigger": "3", "write-only": "false"} if mode == "stream" else {}
    ident = f"db.continue_{layout}_{int(partitioned)}_{mode}_{first}"
    catalogs = _catalogs(warehouse)
    _create(first, catalogs[first], ident, partitioned,
            {**_options(layout, "deduplicate", first, **extra), "sort-engine": "xla-segmented"})
    identifier = 1
    for c, writer in enumerate(order):
        table = catalogs[writer].get_table(ident)
        if mode == "batch":
            _batch_commit(table, commits[c])
        else:
            _stream_commits(table, [commits[c]], identifier)
            identifier += 1
        port_read = _read(catalogs["port"].get_table(ident))
        assert port_read == _read(catalogs["jax"].get_table(ident)), (c, writer)
        keys = [r[:2] if partitioned else r[1] for r in port_read]
        assert len(keys) == len(set(keys)), f"a key read twice after commit {c} by {writer}"
        assert sorted(port_read) == _oracle("deduplicate", commits[: c + 1], partitioned)
    if mode == "stream":
        table = catalogs[first].get_table(ident)
        wb = table.new_batch_write_builder()
        w = wb.new_write()
        w.compact(full=True)
        wb.new_commit().commit(w.prepare_commit())
        assert _read(catalogs["port"].get_table(ident)) == _read(catalogs["jax"].get_table(ident)) == port_read
    if layout == "dynamic":
        table = catalogs["port"].get_table(ident)
        index = _hash_index(warehouse, ident)
        owner = {}
        for (p, b), hashes in index.items():
            for h in hashes.tolist():
                assert (p, h) not in owner, "a key hash in two buckets' indexes"
                owner[(p, h)] = b
        plan = table.new_read_builder().new_scan().plan()
        for split in plan:
            batch = table.store.read_bucket(split.partition, split.bucket, split.files)
            hashes = pbucket.key_hashes(batch, table.store.key_names)
            assert all(owner[(split.partition, h)] == split.bucket for h in hashes.tolist())


@pytest.mark.parametrize("sort_partition", ["false", "true"])
def test_split_order_matches(warehouse, sort_partition):
    """Splits of a partitioned 2-bucket table the JAX package wrote, with
    small split targets so each bucket gives several: the port plans the
    same (partition, bucket, files) list in the same order, round-robin
    across partitions or partition-major."""
    ident = f"db.split_order_{sort_partition}"
    table = _create("jax", JaxCatalog(warehouse), ident, True, _options("bucket_2", "deduplicate", "jax"))
    for c in range(COMMITS):
        rows = _commit_rows(20 + c)
        keep = rows["id"] // (N_KEYS // COMMITS) == c  # key ranges apart: each run a section of its own
        _batch_commit(table, {k: np.asarray(v, dtype=object)[keep] if k in ("a", "d", "s") else v[keep]
                              for k, v in rows.items()})
    opts = {"source.split.target-size": "1 b", "scan.plan-sort-partition": sort_partition}

    def splits(t):
        return [(s.partition, s.bucket, [f.file_name for f in s.files]) for s in t.new_read_builder().new_scan().plan()]

    want = splits(JaxCatalog(warehouse).get_table(ident).copy(opts))
    got = splits(PortCatalog(warehouse, device="cpu").get_table(ident).copy(opts))
    assert got == want
    assert len({s[0] for s in want}) == len(DTS) and len(want) > 2 * len(DTS)
    partitions = [s[0] for s in want]
    assert (partitions == sorted(partitions)) == (sort_partition == "true")


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------


def test_cross_partition_upsert_raises(warehouse):
    """A dynamic-bucket table whose primary key omits the partition key:
    the JAX package writes it through its global index, and so does the
    port, which once raised here (tests/test_torch_write_surface.py holds
    the rest). The same rows, read by either package; at a fixed bucket
    count such a table is still refused."""
    rows = {"dt": DTS[[0, 1]], "id": np.array([1, 1]), "a": [1, 2], "d": [0.5, 1.5], "s": ["x", "y"]}
    table = JaxCatalog(warehouse).create_table("db.cross_jax", _table_type(jt), partition_keys=["dt"],
                                               primary_keys=["id"], options={})
    _batch_commit(table, rows)
    assert [r[:2] for r in _read(table)] == [(DTS[1], 1)]  # the key moved partitions
    port = PortCatalog(warehouse, device="cpu").create_table("db.cross_port", _table_type(tt),
                                                             partition_keys=["dt"], primary_keys=["id"], options={})
    _batch_commit(port, rows)
    assert _read(port) == _read(JaxCatalog(warehouse).get_table("db.cross_port")) == _read(table)
    with pytest.raises(ValueError, match="primary key must contain all partition keys"):
        PortCatalog(warehouse, device="cpu").create_table("db.cross_fixed", _table_type(tt), partition_keys=["dt"],
                                                          primary_keys=["id"], options={"bucket": "2"})


@pytest.mark.parametrize("layout", ["bucket_2", "dynamic"])
def test_null_partition_value_raises(warehouse, layout):
    """The JAX package fails on a null partition value (np.unique cannot
    order None among strings). The port files the row under a None
    partition in the partition.default-name directory; a second commit
    upserts it there (the dynamic layout bootstraps that partition's hash
    index), and reads, partition predicates and sys.partitions see the
    partition as None."""
    from paimon_tpu_torch.data import predicate as tp

    rows = {"dt": np.array(["2024-01-01", None], dtype=object), "id": np.array([1, 2]), "a": [1, 2],
            "d": [0.5, 1.5], "s": ["x", "y"]}
    jax_table = _create("jax", JaxCatalog(warehouse), f"db.null_part_jax_{layout}", True,
                        _options(layout, "deduplicate", "jax"))
    with pytest.raises(TypeError):
        _batch_commit(jax_table, rows)
    cat = PortCatalog(warehouse, device="cpu")
    table = _create("port", cat, f"db.null_part_port_{layout}", True, _options(layout, "deduplicate", "port"))
    _batch_commit(table, rows)
    _batch_commit(table, {"dt": np.array([None], dtype=object), "id": np.array([2]), "a": [20], "d": [2.5], "s": ["z"]})
    want = [("2024-01-01", 1, 1, 0.5, "x"), (None, 2, 20, 2.5, "z")]
    assert sorted(_read(table), key=lambda r: r[1]) == want
    assert os.path.isdir(f"{table.path}/dt=__DEFAULT_PARTITION__")
    assert sorted({e.partition for e in table.store.new_scan().plan().entries}, key=str) == [("2024-01-01",), (None,)]
    for pred, rows_in in ((tp.is_null("dt"), want[1:]), (tp.equal("dt", "2024-01-01"), want[:1])):
        rb = table.new_read_builder().with_filter(pred)
        splits = rb.new_scan().plan()
        assert {s.partition for s in splits} == {rows_in[0][:1]}
        assert [tuple(_py(v) for v in r) for r in rb.new_read().read_all(splits).to_pylist()] == rows_in
    parts = sorted(r[0] for r in cat.get_table(f"db.null_part_port_{layout}$partitions").to_pylist())
    assert parts == ["['2024-01-01']", "[None]"]


def test_null_numeric_partition_value_raises(warehouse):
    """A null in an INT partition column: the JAX package files the row
    under the partition of value 0; the port files it under None, in the
    partition.default-name directory, and both read the row with a null
    p."""
    rows = {"p": [None, 1], "id": np.array([1, 2]), "v": np.array([5, 6])}
    made = {}
    for writer, catalog in _catalogs(warehouse).items():
        pkg = jt if writer == "jax" else tt
        made[writer] = catalog.create_table(
            f"db.null_int_part_{writer}", pkg.RowType.of(("p", pkg.INT()), ("id", pkg.BIGINT(False)), ("v", pkg.BIGINT())),
            partition_keys=["p"], primary_keys=["p", "id"], options={"bucket": "2", "write-only": "true"})
        _batch_commit(made[writer], rows)
    assert sorted(e.partition for e in made["jax"].store.new_scan().plan().entries) == [(0,), (1,)]
    assert sorted((e.partition for e in made["port"].store.new_scan().plan().entries), key=str) == [(1,), (None,)]
    assert os.path.isdir(f"{made['port'].path}/p=__DEFAULT_PARTITION__")
    assert sorted(_read(made["port"]), key=lambda r: r[1]) == [(None, 1, 5), (1, 2, 6)]


def test_predicates_and_local_merge_raise(warehouse):
    """with_filter and the local merge buffer, both once refused, are
    ported: on a partitioned dynamic-bucket table written by the port, a
    partition, a key and a value predicate plan the JAX package's splits
    and read its rows, in its order; a commit through a 1 mb local merge
    buffer then reads the same in both packages, each key at its last
    row."""
    from paimon_tpu.data import predicate as jp
    from paimon_tpu_torch.data import predicate as tp

    ident = "db.unported_read"
    table = _create("port", PortCatalog(warehouse, device="cpu"), ident, True,
                    _options("dynamic", "deduplicate", "port"))
    for c in range(3):
        _batch_commit(table, _commit_rows(c))
    jax = JaxCatalog(warehouse).get_table(ident)
    for make in (lambda p: p.equal("dt", DTS[0]), lambda p: p.between("id", 10, 40),
                 lambda p: p.and_(p.in_("dt", list(DTS[1:3])), p.greater_than("d", 5.0))):
        rb, jrb = table.new_read_builder().with_filter(make(tp)), jax.new_read_builder().with_filter(make(jp))
        splits, jsplits = rb.new_scan().plan(), jrb.new_scan().plan()
        assert [(s.partition, s.bucket, [f.file_name for f in s.files]) for s in splits] == [
            (s.partition, s.bucket, [f.file_name for f in s.files]) for s in jsplits]
        got = [tuple(_py(v) for v in row) for row in rb.new_read().read_all(splits).to_pylist()]
        assert got and got == [tuple(_py(v) for v in row) for row in jrb.new_read().read_all(jsplits).to_pylist()]
    merged = table.copy({"local-merge-buffer-size": "1 mb"})
    w = merged.new_batch_write_builder().new_write()
    assert w._local_merge_cap == 1 << 20
    rows = _commit_rows(3)
    w.write(rows)
    merged.new_batch_write_builder().new_commit().commit(w.prepare_commit())
    got = _read(table)
    assert got == _read(JaxCatalog(warehouse).get_table(ident))
    last = {(r[0], r[1]): r for r in zip(*(list(rows[c]) for c in ("dt", "id", "a", "d", "s")))}
    assert {(r[0], r[1]): r for r in got if (r[0], r[1]) in last} == last
