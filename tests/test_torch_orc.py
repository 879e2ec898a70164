"""ORC data files in the port (paimon_tpu_torch/format/orc.py, orc_meta.py,
native/orcdec.c) against the JAX package (paimon_tpu/format/orc.py, which
goes through pyarrow.orc), on the CPU (device="cpu" for the port).

Format level: every flat type with nulls (NaN in place in the doubles),
under each compression kind, written by one package and read by the
other; files holding each RLE v2 sub-encoding (checked from the run
headers), RLE v1 and DICTIONARY_V2 files from pyarrow's own writer; the
compression names the JAX package's write refuses; TIMESTAMP and DECIMAL
columns as pyarrow writes them (the port reads micros, the JAX package
nanos: a fault of the reference, pinned here); the tail and stripe
statistics against the JAX package's `read_tail` (mirroring
tests/test_formats_aux.py:158-254). Table level: a config-3-shaped
aggregation table with commits alternating between the packages and a
full compaction by the port; file.format.per.level; _KEY_ columns; a
partitioned table; stripe pruning, whose scan.orc_stripes_skipped counts
agree between the packages; merge.dict-domain over a parquet level
compacted into ORC, which the JAX package's write refuses and the port's
does not.

Data is made from numpy seeds at a small size. Tolerance: exact (NaN
equal to NaN).
"""

import io
import math
import os

import numpy as np
import pyarrow as pa
import pyarrow.orc as po
import pytest

import paimon_tpu as jt
import paimon_tpu_torch as tt
from paimon_tpu.catalog import FileSystemCatalog as JaxCatalog
from paimon_tpu.data.batch import ColumnBatch as JaxBatch
from paimon_tpu.format.orc import OrcFormat
from paimon_tpu.format.orc_meta import read_tail as jax_read_tail
from paimon_tpu.fs import LocalFileIO as JaxIO
from paimon_tpu_torch.catalog import FileSystemCatalog as PortCatalog
from paimon_tpu_torch.data.batch import ColumnBatch, concat_batches
from paimon_tpu_torch.format import orc as port_orc
from paimon_tpu_torch.format.orc import read_orc, write_orc
from paimon_tpu_torch.format.orc_meta import read_tail

PKGS = ("jax", "port")
CODECS = ("zstd", "zlib", "snappy", "lz4", "uncompressed")


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """pyarrow's lazy first-use initialisation on the main thread (the JAX
    writer encodes on a flush thread)."""
    po.write_table(pa.table({"x": [0]}), io.BytesIO())


def _py(v):
    return v.item() if hasattr(v, "item") else v


def _same(a, b) -> bool:
    """Exact equality of two row lists, NaN equal to NaN."""
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            x, y = _py(x), _py(y)
            if isinstance(x, float) and isinstance(y, float) and math.isnan(x) and math.isnan(y):
                continue
            if x != y or type(x) is not type(y):
                return False
    return True


# ---------------------------------------------------------------------------
# format level
# ---------------------------------------------------------------------------


def _schema(pkg):
    m = jt if pkg == "jax" else tt
    return m.RowType.of(("b", m.BOOLEAN()), ("t", m.TINYINT()), ("sm", m.SMALLINT()), ("i", m.INT()),
                        ("l", m.BIGINT()), ("f", m.FLOAT()), ("d", m.DOUBLE()), ("s", m.STRING()),
                        ("c", m.CHAR(4)), ("v", m.VARCHAR(12)), ("y", m.BYTES()), ("dt", m.DATE()),
                        ("ts", m.TIMESTAMP()), ("dec", m.DECIMAL(12, 3)))


def _rows(n=3000, seed=11) -> dict:
    rng = np.random.default_rng(seed)

    def nulls(values, every):
        return [None if i % every == 0 else v for i, v in enumerate(values)]

    d = [float(x) for x in rng.normal(size=n)]
    d[5] = d[77] = float("nan")
    return {
        "b": nulls([bool(x) for x in rng.integers(0, 2, n)], 11),
        "t": nulls([int(x) for x in rng.integers(-128, 128, n)], 7),
        "sm": nulls([int(x) for x in rng.integers(-(2**15), 2**15, n)], 13),
        "i": nulls([int(x) for x in rng.integers(-(2**31), 2**31, n)], 5),
        "l": nulls([int(x) for x in rng.integers(-(2**62), 2**62, n)], 9),
        "f": nulls([float(np.float32(x)) for x in rng.normal(size=n)], 4),
        "d": nulls(d, 6),
        "s": nulls([f"s-{int(x)}" + "é" * (int(x) % 3) for x in rng.integers(0, 10**6, n)], 8),
        "c": nulls([f"c{int(x):03d}" for x in rng.integers(0, 1000, n)], 10),
        "v": nulls([f"tag-{int(x)}" for x in rng.integers(0, 12, n)], 3),
        "y": nulls([bytes(rng.integers(0, 256, i % 7, dtype=np.uint8)) for i in range(n)], 12),
        "dt": nulls([int(x) for x in rng.integers(-30000, 30000, n)], 14),
        "ts": nulls([int(x) for x in rng.integers(-(2**52), 2**52, n)], 15),
        "dec": nulls([int(x) for x in rng.integers(-(10**11), 10**11, n)], 16),
    }


def _jax_write(path, rows, schema, compression, opts=None):
    OrcFormat().write(JaxIO(), path, JaxBatch.from_pydict(schema, rows), compression, opts)


def _jax_rows(path, schema, projection=None, predicate=None) -> list[tuple]:
    return [tuple(r) for b in OrcFormat().read(JaxIO(), path, schema, projection, predicate) for r in b.to_pylist()]


def _port_rows(data, schema, projection=None, predicate=None) -> list[tuple]:
    parts = read_orc(data, schema, projection, predicate)
    return [tuple(_py(v) for v in r) for r in concat_batches(parts).to_pylist()] if parts else []


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("writer", PKGS)
def test_files_each_way(tmp_path, writer, codec):
    """One package writes every flat type with nulls under `codec` (two
    stripes or more); the other package, pyarrow and the writer itself read
    the rows written."""
    rows = _rows(10_000)
    want = list(zip(*rows.values()))
    path = str(tmp_path / "f.orc")
    opts = {"orc.stripe.size": "65536"}
    if writer == "jax":
        _jax_write(path, rows, _schema("jax"), codec, opts)
        with open(path, "rb") as f:
            data = f.read()
    else:
        data = write_orc(ColumnBatch.from_pydict(_schema("port"), rows), codec, opts)
        with open(path, "wb") as f:
            f.write(data)
    tail = read_tail(data)
    assert tail.compression == {"uncompressed": "none"}.get(codec, codec)
    assert tail.nstripes > 1
    assert _same(_port_rows(data, _schema("port")), want)
    assert _same(_jax_rows(path, _schema("jax")), want)
    assert _same(_port_rows(data, _schema("port"), ["s", "l"]), [(r[7], r[4]) for r in want])
    arrow = po.ORCFile(io.BytesIO(data)).read()
    assert arrow.column("s").to_pylist() == rows["s"] and arrow.column("y").to_pylist() == rows["y"]


def test_port_files_carry_the_kinds_pyarrow_writes(tmp_path):
    """The port's file has the types, encodings, streams and writer
    timezone that pyarrow writes for the JAX package's to_arrow of the same
    batch, less the row index; PRESENT only where a column holds nulls. The
    one difference is the reference's (Java) writer's: a STRING column of
    few distinct values (v: 12 in 500 rows) is DICTIONARY_V2, with its
    dictionary streams."""
    rows = _rows(500)
    rows["l"] = list(range(500))  # no nulls
    jpath = str(tmp_path / "j.orc")
    _jax_write(jpath, rows, _schema("jax"), "zstd")
    with open(jpath, "rb") as f:
        jdata = f.read()
    pdata = write_orc(ColumnBatch.from_pydict(_schema("port"), rows), "zstd")
    jt_, pt_ = read_tail(jdata), read_tail(pdata)
    assert [t.kind for t in pt_.types] == [t.kind for t in jt_.types]
    assert pt_.field_columns == jt_.field_columns
    js, ps = port_orc._stripe_footer(jdata, jt_, 0), port_orc._stripe_footer(pdata, pt_, 0)
    v = pt_.field_columns["v"]
    assert ps.encodings[v] == (port_orc.E_DICTIONARY_V2, 12) and js.encodings[v][0] == port_orc.E_DIRECT_V2
    assert [e[0] for c, e in enumerate(ps.encodings) if c != v] == [e[0] for c, e in enumerate(js.encodings) if c != v]
    assert ps.timezone == js.timezone == "GMT"
    assert {k for k in ps.streams} == {k for k in js.streams if k[1] != port_orc.S_ROW_INDEX} | {
        (v, port_orc.S_DICTIONARY_DATA)}
    assert (pt_.field_columns["l"], port_orc.S_PRESENT) not in ps.streams
    assert (pt_.field_columns["i"], port_orc.S_PRESENT) in ps.streams


RLE_CASES = ("short_repeat", "direct", "patched_base", "delta")


def _shaped(kind: str, n: int, rng) -> np.ndarray:
    if kind == "short_repeat":  # runs of five equal values
        return np.repeat(rng.integers(0, 1000, n // 5 + 1), 5)[:n]
    if kind == "direct":
        return rng.integers(-(2**40), 2**40, n)
    if kind == "patched_base":  # small values, 5% huge outliers
        return np.where(rng.random(n) < 0.05, rng.integers(10**12, 10**13, n), rng.integers(0, 100, n))
    return np.arange(n) * 3 + 7  # monotone keys


def _run_counts(data, column: str, stream: int, signed: bool) -> list:
    tail = read_tail(data)
    runs = np.zeros(4, dtype=np.int64)
    for s in range(tail.nstripes):
        stripe = port_orc._stripe_footer(data, tail, s)
        raw = port_orc._Streams(data, tail, stripe, tail.field_columns[column]).get(stream)
        port_orc.decode_ints(raw, stripe.rows, 2, signed, runs)
    return runs.tolist()


@pytest.mark.parametrize("signed", [True, False], ids=["signed", "unsigned"])
@pytest.mark.parametrize("kind", RLE_CASES)
def test_rle_v2_sub_encodings(tmp_path, kind, signed):
    """Data shaped to provoke each RLE v2 sub-encoding, written by the JAX
    package: a BIGINT column's DATA (signed) or a string column's LENGTH
    (unsigned). The run headers show the file holds that sub-encoding, and
    the port reads the rows the JAX package reads."""
    rng = np.random.default_rng(RLE_CASES.index(kind))
    n = 4096
    values = _shaped(kind, n, rng)
    if signed:
        rows, column, stream = {"x": [int(v) for v in values]}, "x", port_orc.S_DATA
        schemas = {m.__name__: m.RowType.of(("x", m.BIGINT())) for m in (jt, tt)}
    else:
        lengths = np.where(values > 1000, 3000, values % 50) if kind == "patched_base" else values % 50
        if kind == "delta":
            lengths = np.arange(n) // 16 + 1
        rows, column, stream = {"x": ["a" * int(v) for v in lengths]}, "x", port_orc.S_LENGTH
        schemas = {m.__name__: m.RowType.of(("x", m.STRING())) for m in (jt, tt)}
    path = str(tmp_path / "r.orc")
    _jax_write(path, rows, schemas["paimon_tpu"], "zstd")
    with open(path, "rb") as f:
        data = f.read()
    runs = _run_counts(data, column, stream, signed)
    assert runs[RLE_CASES.index(kind)] > 0, runs
    got = _port_rows(data, schemas["paimon_tpu_torch"])
    assert got == _jax_rows(path, schemas["paimon_tpu"]) == [(v,) for v in rows["x"]]


def test_port_rle_v2_round_trips_corner_runs():
    """The port's encoder on runs at the corners (repeats of 3 and 10, 11
    and 512, deltas of width 1, +-2^63 spans, runs of 1-513 values) writes
    SHORT_REPEAT, DIRECT and DELTA runs that read back in pyarrow and in the
    port."""
    rng = np.random.default_rng(3)
    parts = [np.full(3, 5), np.full(10, -7), np.full(11, 9), np.full(512, 2**40), np.full(600, -1),
             np.array([-(2**63), 2**63 - 1, 0, -(2**63)]), np.arange(0, 700) // 2, np.arange(1000, 0, -1),
             np.cumsum(rng.integers(0, 3, 513)), np.cumsum(rng.integers(0, 2, 300)),
             rng.integers(-(2**63), 2**63 - 1, 513, dtype=np.int64),
             np.array([1]), np.array([4, 4])]
    values = np.concatenate([p.astype(np.int64) for p in parts])
    for signed in (True, False):
        v = values if signed else np.abs(values % (2**62))
        raw = port_orc.encode_ints(v, signed)
        runs = np.zeros(4, dtype=np.int64)
        assert np.array_equal(port_orc.decode_ints(raw, len(v), 2, signed, runs), v)
        assert runs[0] > 0 and runs[1] > 0 and runs[3] > 0, runs
    batch = ColumnBatch.from_pydict(tt.RowType.of(("x", tt.BIGINT())), {"x": values})
    arrow = po.ORCFile(io.BytesIO(write_orc(batch, "zstd"))).read()
    assert np.array_equal(arrow.column("x").to_numpy(), values)


@pytest.mark.parametrize("codec", ["bytes", "bools", "varints"])
def test_byte_boolean_and_varint_codes_round_trip(codec):
    """Byte RLE (runs of 3-130 and literal runs of 1-128), boolean RLE
    (counts off a byte boundary) and DECIMAL's zigzag varints (up to
    +-(10^18 - 1)) read back what the port's encoders wrote."""
    rng = np.random.default_rng(9)
    if codec == "bytes":
        v = np.concatenate([np.full(3, 7), np.full(130, -1), np.full(131, 5), rng.integers(-128, 128, 1000),
                            np.full(2, 3)]).astype(np.int8)
        assert np.array_equal(port_orc.decode_bytes(port_orc.encode_bytes(v), len(v)).view(np.int8), v)
    elif codec == "bools":
        for n in (1, 7, 8, 9, 1000, 1003):
            v = rng.integers(0, 2, n).astype(bool)
            v[: n // 3] = True
            assert np.array_equal(port_orc.decode_bools(port_orc.encode_bools(v), n), v)
    else:
        v = np.concatenate([np.array([0, -1, 1, 10**18 - 1, -(10**18) + 1]), rng.integers(-(10**17), 10**17, 500)])
        assert np.array_equal(port_orc.decode_varints(port_orc.encode_varints(v), len(v)), v)


@pytest.mark.parametrize("variant", ["rle_v1", "dictionary_v2", "dictionary_v1"])
def test_rle_v1_and_dictionary_files(variant):
    """pyarrow's writer at file_version 0.11 (integer RLE v1: DIRECT and
    DICTIONARY encodings) and with dictionary_key_size_threshold=1
    (DICTIONARY_V2 strings): the port reads what the JAX package reads."""
    rows = _rows(2500, seed=4)
    batch = JaxBatch.from_pydict(_schema("jax"), rows)
    kwargs = {"rle_v1": {"file_version": "0.11"}, "dictionary_v2": {"dictionary_key_size_threshold": 1},
              "dictionary_v1": {"file_version": "0.11", "dictionary_key_size_threshold": 1}}[variant]
    buf = io.BytesIO()
    po.write_table(batch.to_arrow(), buf, compression="zlib", **kwargs)
    data = buf.getvalue()
    tail = read_tail(data)
    encodings = port_orc._stripe_footer(data, tail, 0).encodings
    want_int = port_orc.E_DIRECT if "v1" in variant else port_orc.E_DIRECT_V2
    want_str = {"rle_v1": port_orc.E_DIRECT, "dictionary_v2": port_orc.E_DICTIONARY_V2,
                "dictionary_v1": port_orc.E_DICTIONARY}[variant]
    assert encodings[tail.field_columns["l"]][0] == want_int
    assert encodings[tail.field_columns["v"]][0] == want_str
    jax_rows = [tuple(r) for r in JaxBatch.from_arrow(po.ORCFile(io.BytesIO(data)).read(), _schema("jax")).to_pylist()]
    assert _same(_port_rows(data, _schema("port")), jax_rows)
    assert _same(jax_rows, list(zip(*rows.values())))


@pytest.mark.parametrize("name", ["none", "gzip", "brotli", "ZSTD", "Lz4", "UNCOMPRESSED"])
def test_compression_names(tmp_path, name):
    """The names the JAX package's write refuses raise the same class in
    the port's; the ones it takes (in any case) write the same kind."""
    rows = {"x": [1, 2, None]}
    batch = ColumnBatch.from_pydict(tt.RowType.of(("x", tt.BIGINT())), rows)
    path = str(tmp_path / "c.orc")
    if name.lower() in ("none", "gzip", "brotli"):
        with pytest.raises(ValueError) as jax_err:
            _jax_write(path, rows, jt.RowType.of(("x", jt.BIGINT())), name)
        with pytest.raises(type(jax_err.value), match="CompressionKind"):
            write_orc(batch, name)
        return
    _jax_write(path, rows, jt.RowType.of(("x", jt.BIGINT())), name)
    with open(path, "rb") as f:
        assert read_tail(write_orc(batch, name)).compression == read_tail(f.read()).compression


def test_timestamps_before_1970_and_2015():
    """A TIMESTAMP column as pyarrow writes it (seconds from 2015-01-01 GMT
    and trailing-zero nanos): pre-1970 and pre-2015 values with fractional
    seconds read back as written, in micros. The JAX package reads the same
    file into nanoseconds, 1,000 times the micros of its TIMESTAMP(6)
    columns: a fault of the reference (its ORC read casts pyarrow's
    timestamp[ns] to int64), pinned here."""
    micros = [-500_000, -1_500_000, -1, -999_999, 0, 1_000_000, -86_400_000_001, 1_420_070_399_999_999,
              1_420_070_400_000_000, 1_420_070_400_000_001, -2_208_988_800_000_001, 4_102_444_800_123_456, None]
    table = pa.table({"ts": pa.array(micros, pa.timestamp("us"))})
    buf = io.BytesIO()
    po.write_table(table, buf)
    data = buf.getvalue()
    assert _port_rows(data, tt.RowType.of(("ts", tt.TIMESTAMP()))) == [(v,) for v in micros]
    jax = JaxBatch.from_arrow(po.ORCFile(io.BytesIO(data)).read(), jt.RowType.of(("ts", jt.TIMESTAMP())))
    assert [r[0] for r in jax.to_pylist()] == [None if v is None else v * 1000 for v in micros]


@pytest.mark.parametrize("precision, scale", [(5, 0), (10, 2), (12, 3), (18, 6), (18, 18)])
def test_decimal_scales(precision, scale):
    """DECIMAL columns as pyarrow writes them (unscaled varints in DATA,
    the scale in SECONDARY): the port reads the unscaled values the JAX
    package reads."""
    rng = np.random.default_rng(precision * 31 + scale)
    import decimal

    bound = 10 ** min(precision, 15)
    values = [None if i % 7 == 0 else decimal.Decimal(int(x)).scaleb(-scale) for i, x in
              enumerate(rng.integers(-bound + 1, bound, 400))]
    buf = io.BytesIO()
    po.write_table(pa.table({"d": pa.array(values, pa.decimal128(precision, scale))}), buf)
    data = buf.getvalue()
    jax = JaxBatch.from_arrow(po.ORCFile(io.BytesIO(data)).read(), jt.RowType.of(("d", jt.DECIMAL(precision, scale))))
    want = [tuple(r) for r in jax.to_pylist()]
    assert want == [(None if v is None else int(v.scaleb(scale)),) for v in values]
    assert _port_rows(data, tt.RowType.of(("d", tt.DECIMAL(precision, scale)))) == want


# ---------------------------------------------------------------------------
# orc_meta parity (tests/test_formats_aux.py:158-254)
# ---------------------------------------------------------------------------


def _stats_rows(tail) -> list:
    return [{k: (v.min, v.max, v.null_count, v.row_count) for k, v in tail.stripe_stats(i).items()}
            for i in range(tail.nstripes)]


@pytest.mark.parametrize("writer", ["pyarrow", "port"])
def test_read_tail_matches_the_jax_package(writer):
    """Multi-stripe bytes with ints, doubles, strings, booleans (mixed and
    all-true stripes) and nulls: the port's read_tail gives the JAX
    package's compression, stripe rows, field columns and stripe stats,
    which agree with each stripe's contents."""
    n = 60_000
    rng = np.random.default_rng(5)
    ids = rng.permutation(n).astype(np.int64)
    flag = np.ones(n, dtype=bool)
    flag[n // 2 :] = rng.integers(0, 2, n - n // 2).astype(bool)
    cols = {"id": ids, "d": ids.astype(np.float64) * 0.5, "s": [f"k{int(x) % 1000:03d}" for x in ids],
            "flag": flag, "n": [None if x % 3 == 0 else int(x) for x in ids]}
    if writer == "pyarrow":
        buf = io.BytesIO()
        po.write_table(pa.table(cols), buf, compression="zstd", stripe_size=64 * 1024)
        data = buf.getvalue()
    else:
        schema = tt.RowType.of(("id", tt.BIGINT()), ("d", tt.DOUBLE()), ("s", tt.STRING()), ("flag", tt.BOOLEAN()),
                               ("n", tt.BIGINT()))
        data = write_orc(ColumnBatch.from_pydict(schema, cols), "zstd", {"orc.stripe.size": str(400 * 1024)})
    mine, theirs = read_tail(data), jax_read_tail(data)
    assert mine.nstripes == theirs.nstripes > 1
    assert (mine.compression, mine.stripe_rows, mine.field_columns) == (
        theirs.compression, theirs.stripe_rows, theirs.field_columns)
    assert _stats_rows(mine) == _stats_rows(theirs)
    arrow = po.ORCFile(io.BytesIO(data))
    for i in range(mine.nstripes):
        st = mine.stripe_stats(i)
        chunk = arrow.read_stripe(i)
        got = np.asarray(chunk["id"])
        assert (st["id"].min, st["id"].max, st["id"].null_count) == (got.min(), got.max(), 0)
        assert st["d"].min == float(np.asarray(chunk["d"]).min())
        vals = chunk["s"].to_pylist()
        assert (st["s"].min, st["s"].max) == (min(vals), max(vals))
        flags = chunk["flag"].to_pylist()
        assert (st["flag"].min, st["flag"].max) == (all(flags), any(flags))
        assert st["n"].null_count == chunk["n"].null_count


# ---------------------------------------------------------------------------
# table level
# ---------------------------------------------------------------------------


def _catalog(pkg, warehouse):
    if pkg == "jax":
        return JaxCatalog(warehouse, commit_user=pkg)
    return PortCatalog(warehouse, commit_user=pkg, device="cpu")


def _read(table, predicate=None) -> list[tuple]:
    rb = table.new_read_builder()
    if predicate is not None:
        rb = rb.with_filter(predicate)
    return sorted(tuple(_py(v) for v in r) for r in rb.new_read().read_all(rb.new_scan().plan()).to_pylist())


def _commit(table, rows: dict) -> None:
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.write(rows)
    wb.new_commit().commit(w.prepare_commit())


def _full_compaction(table) -> None:
    wb = table.copy({"write-only": "false"}).new_batch_write_builder()
    w = wb.new_write()
    w.compact(full=True)
    wb.new_commit().commit(w.prepare_commit())


def _c3_schema(m):
    return m.RowType.of(("id", m.BIGINT(False)), ("sum_col", m.BIGINT()), ("max_col", m.DOUBLE()))


C3 = {"bucket": "1", "file.format": "orc", "merge-engine": "aggregation", "write-only": "true",
      "fields.sum_col.aggregate-function": "sum", "fields.max_col.aggregate-function": "max"}


def _data_files(table) -> list[str]:
    out = []
    for root, _, names in os.walk(table.path):
        out += [os.path.join(root, n) for n in names if n.startswith("data-")]
    return sorted(out)


@pytest.mark.parametrize("extra", [{}, {"file.format.per.level": "0:parquet"}, {"file.compression": "lz4"}],
                         ids=["orc", "per_level", "lz4"])
def test_config3_alternating_commits_then_port_compaction(tmp_path, extra):
    """BASELINE config 3's shape cut to 4 x 3,000 rows: an aggregation
    table in ORC, commits alternating between the packages, then a full
    compaction by the port; both packages read the oracle's sums and
    maxima before and after. Under file.format.per.level=0:parquet the
    flushes are parquet and the compacted file ORC."""
    wh = str(tmp_path)
    options = {**C3, **extra}
    _catalog("jax", wh).create_table("db.c3", _c3_schema(jt), primary_keys=["id"], options=options)
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, 1500, 3000) for _ in range(4)]
    for r, ids in enumerate(batches):
        _commit(_catalog(PKGS[r % 2], wh).get_table("db.c3"), {"id": ids, "sum_col": ids % 7, "max_col": ids * 0.25})
    ids_in = np.concatenate(batches)
    keys = np.unique(ids_in)
    total = np.zeros(1500, np.int64)
    np.add.at(total, ids_in, ids_in % 7)
    want = [(int(k), int(total[k]), float(k) * 0.25) for k in keys]
    port = _catalog("port", wh).get_table("db.c3")
    level0 = {p.rsplit(".", 1)[1] for p in _data_files(port)}
    assert level0 == ({"parquet"} if extra.get("file.format.per.level") else {"orc"})
    for pkg in PKGS:
        assert _read(_catalog(pkg, wh).get_table("db.c3")) == want
    _full_compaction(port)
    formats = {os.path.basename(p).rsplit(".", 1)[1] for p in _data_files(port)}
    assert "orc" in formats
    for pkg in PKGS:
        assert _read(_catalog(pkg, wh).get_table("db.c3")) == want


@pytest.mark.parametrize("writer", PKGS)
def test_key_columns_keep_their_names(tmp_path, writer):
    """data-file.include-key-columns on an ORC table: the footer's root
    struct leads with _KEY_id, _SEQUENCE_NUMBER and _VALUE_KIND, and both
    packages read the rows."""
    wh = str(tmp_path)
    m = jt if writer == "jax" else tt
    t = _catalog(writer, wh).create_table(
        "db.k", m.RowType.of(("id", m.BIGINT(False)), ("s", m.STRING())), primary_keys=["id"],
        options={"bucket": "1", "file.format": "orc", "data-file.include-key-columns": "true"})
    _commit(t, {"id": np.arange(50), "s": [None if i % 4 == 0 else f"v{i}" for i in range(50)]})
    (path,) = _data_files(t)
    with open(path, "rb") as f:
        names = list(read_tail(f.read()).field_columns)
    assert names[:3] == ["_KEY_id", "_SEQUENCE_NUMBER", "_VALUE_KIND"]
    for pkg in PKGS:
        assert _read(_catalog(pkg, wh).get_table("db.k")) == [(i, None if i % 4 == 0 else f"v{i}") for i in range(50)]


@pytest.mark.parametrize("writer", PKGS)
def test_partitioned_table(tmp_path, writer):
    """A partitioned ORC table at two buckets, written by one package over
    two commits and read by both."""
    wh = str(tmp_path)
    m = jt if writer == "jax" else tt
    t = _catalog(writer, wh).create_table(
        "db.p", m.RowType.of(("dt", m.STRING(False)), ("id", m.BIGINT(False)), ("v", m.DOUBLE())),
        primary_keys=["dt", "id"], partition_keys=["dt"], options={"bucket": "2", "file.format": "orc"})
    last = {}
    for r in range(2):
        ids = np.arange(r * 40, r * 40 + 100)
        dts = np.array(["2024-01-01", "2024-01-02"], dtype=object)[ids % 2]
        _commit(t, {"dt": dts, "id": ids, "v": ids * 0.5 + r})
        last.update({(d, int(i)): (d, int(i), float(i) * 0.5 + r) for d, i in zip(dts, ids)})
    assert all(p.endswith(".orc") for p in _data_files(t))
    for pkg in PKGS:
        assert _read(_catalog(pkg, wh).get_table("db.p")) == sorted(last.values())


@pytest.mark.parametrize("writer", PKGS)
def test_stripe_pruning_counts_agree(tmp_path, writer):
    """Sorted ids in many stripes (orc.stripe.size 64 KiB): an equality on
    the key skips stripes, and scan.orc_stripes_skipped moves by the same
    count in both packages for the same predicate on the same table."""
    from paimon_tpu.data import predicate as jp
    from paimon_tpu.metrics import registry as jax_registry
    from paimon_tpu_torch.data import predicate as pp
    from paimon_tpu_torch.metrics import registry as port_registry

    wh = str(tmp_path)
    m = jt if writer == "jax" else tt
    t = _catalog(writer, wh).create_table(
        "db.s", m.RowType.of(("id", m.BIGINT(False)), ("v", m.DOUBLE())), primary_keys=["id"],
        options={"bucket": "1", "file.format": "orc", "orc.stripe.size": "65536"})
    n = 120_000
    _commit(t, {"id": np.arange(n, dtype=np.int64), "v": np.arange(n, dtype=np.float64)})
    (path,) = _data_files(t)
    with open(path, "rb") as f:
        assert read_tail(f.read()).nstripes > 1
    skipped = {}
    for pkg, registry, P in (("jax", jax_registry, jp), ("port", port_registry, pp)):
        counter = registry.group("scan").counter("orc_stripes_skipped")
        before = counter.count
        assert _read(_catalog(pkg, wh).get_table("db.s"), P.equal("id", 5)) == [(5, 5.0)]
        skipped[pkg] = counter.count - before
    assert skipped["jax"] == skipped["port"] > 0


def test_dict_domain_compaction_into_orc(tmp_path):
    """merge.dict-domain over parquet flushes (file.format.per.level
    0:parquet) compacted into ORC: the compaction reads code-backed
    strings. The JAX package hands them to pyarrow.orc as a DictionaryArray,
    which it refuses (a fault of the reference, pinned here); the port
    writes the strings plainly, and both packages read its table."""
    wh = str(tmp_path)
    options = {"bucket": "1", "file.format": "orc", "file.format.per.level": "0:parquet",
               "merge.dict-domain": "true", "write-only": "true"}
    want = {}
    for pkg in PKGS:
        m = jt if pkg == "jax" else tt
        t = _catalog(pkg, wh).create_table(f"db.d_{pkg}", m.RowType.of(("id", m.BIGINT(False)), ("s", m.STRING())),
                                           primary_keys=["id"], options=options)
        for r in range(3):
            ids = np.arange(r * 10, r * 10 + 50)
            _commit(t, {"id": ids, "s": [None if i % 9 == 0 else f"k{(i + r) % 7}" for i in ids]})
            want.update({int(i): (int(i), None if i % 9 == 0 else f"k{(i + r) % 7}") for i in ids})
    with pytest.raises(pa.ArrowNotImplementedError, match="dictionary"):
        _full_compaction(_catalog("jax", wh).get_table("db.d_jax"))
    port = _catalog("port", wh).get_table("db.d_port")
    _full_compaction(port)
    assert [p.rsplit(".", 1)[1] for p in _data_files(port)].count("orc") == 1
    for pkg in PKGS:
        assert _read(_catalog(pkg, wh).get_table("db.d_port")) == sorted(want.values())


@pytest.mark.parametrize("writer", PKGS)
def test_sql_ddl_bloom_index_and_files_table(tmp_path, writer):
    """CREATE TABLE ... WITH ('file.format' = 'orc') with a bloom file index
    on s, through each package's SQL: the files are ORC, the files system
    table lists them, and a filtered SELECT returns the same rows in both
    packages."""
    from paimon_tpu.sql import execute as jax_sql
    from paimon_tpu_torch.sql import execute as port_sql

    wh = str(tmp_path)
    run = {"jax": lambda q: jax_sql(_catalog("jax", wh), q), "port": lambda q: port_sql(_catalog("port", wh), q)}
    run[writer]("CREATE TABLE db.q (k BIGINT NOT NULL, s STRING, v DOUBLE, PRIMARY KEY (k) NOT ENFORCED) WITH "
                "('bucket' = '1', 'file.format' = 'orc', 'file-index.bloom-filter.columns' = 's')")
    values = ", ".join(f"({i}, {'NULL' if i % 5 == 0 else repr(f's{i % 17}')}, {i * 0.5})" for i in range(200))
    run[writer](f"INSERT INTO db.q VALUES {values}")
    t = _catalog(writer, wh).get_table("db.q")
    assert _data_files(t) and all(p.endswith(".orc") for p in _data_files(t))
    want = sorted((i, f"s{i % 17}", i * 0.5) for i in range(200) if i % 5 and i % 17 == 3)
    for pkg in PKGS:
        got = run[pkg]("SELECT k, s, v FROM db.q WHERE s = 's3'")
        assert sorted(tuple(_py(x) for x in r) for r in got.to_pylist()) == want
        files = run[pkg]("SELECT file_path FROM db.q$files")
        assert [p for (p,) in files.to_pylist()] and all(p.endswith(".orc") for (p,) in files.to_pylist())


def test_sort_compact_an_orc_append_table(tmp_path):
    """sort_compact by zorder of an ORC append table in the port: the
    rewritten files are ORC, and both packages read the rows."""
    from paimon_tpu_torch.table.sort_compact import sort_compact

    wh = str(tmp_path)
    t = _catalog("port", wh).create_table(
        "db.a", tt.RowType.of(("x", tt.INT()), ("y", tt.INT()), ("v", tt.BIGINT())),
        options={"bucket": "1", "file.format": "orc"})
    rng = np.random.default_rng(3)
    rows = {"x": rng.integers(0, 100, 2000).tolist(), "y": rng.integers(0, 100, 2000).tolist(), "v": list(range(2000))}
    _commit(t, rows)
    assert sort_compact(t, ["x", "y"], order="zorder") == 2000
    assert all(p.endswith(".orc") for p in _data_files(t))
    want = sorted(zip(rows["x"], rows["y"], rows["v"]))
    for pkg in PKGS:
        assert _read(_catalog(pkg, wh).get_table("db.a")) == want
