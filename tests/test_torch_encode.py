"""The port's page encoder (paimon_tpu_torch/encode/) against the JAX
package's (paimon_tpu/encode/), on the CPU.

Kernels: `pack_bits` and its torch twin `pack_bits_torch` against the JAX
package's `pack_bits` and `pack_bits_jax` at every width 1-32, byte for
byte; the RLE/bit-packed hybrid, DELTA_BINARY_PACKED and PLAIN byte-array
streams equal the JAX encoder's; the torch encode engine (on the CPU here)
writes the numpy engine's bytes, and asks for a card by default.

Writer: each of parquet.page-size, parquet.row-group.rows,
file.block-size, parquet.enable.dictionary and parquet.data-page-version
changes the file as it does the JAX package's native encoder's (pages,
row groups, dictionary pages, page version), and the JAX package reads
every such file to the rows written under both of its decoders and
pyarrow. A code-backed column writes its pool pruned to the codes in use
as the dictionary page, its statistics from the pool's edges, never
expanding; a string key column's dict_cache from the key-lane encoder does
the same; a low-cardinality INT/BIGINT column takes the numeric dictionary
route and a sorted one DELTA, as in the JAX package.

Tolerance: exact.
"""

import io

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import paimon_tpu as jt
import paimon_tpu_torch as tt
from paimon_tpu.data.batch import ColumnBatch as JaxBatch
from paimon_tpu.decode import read_native as jax_read_native
from paimon_tpu.decode.container import parse_footer as jax_parse_footer
from paimon_tpu.encode import encode_parquet_bytes as jax_encode
from paimon_tpu.encode import kernels as jek
from paimon_tpu.format.parquet import ParquetFormat as JaxParquet
from paimon_tpu.fs import LocalFileIO as JaxIO
from paimon_tpu_torch.data import keys as tkeys
from paimon_tpu_torch.data.batch import Column, ColumnBatch
from paimon_tpu_torch.decode.container import (
    ENC_DELTA_BINARY_PACKED,
    ENC_RLE_DICTIONARY,
    PAGE_DATA,
    PAGE_DATA_V2,
    iter_pages,
    parse_footer,
)
from paimon_tpu_torch.encode import kernels as tek
from paimon_tpu_torch.format.parquet import read_parquet, write_parquet
from paimon_tpu_torch.metrics import dict_metrics, encode_metrics, registry


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """pyarrow's lazy first-use initialisation on the main thread."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


@pytest.fixture(autouse=True)
def _numpy_engines():
    yield
    tek.set_encode_engine("numpy")


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", range(1, 33))
def test_pack_bits_matches_jax(width):
    rng = np.random.default_rng(width)
    vals = rng.integers(0, 1 << width, 211, dtype=np.uint64)
    assert tek.pack_bits(vals, width) == jek.pack_bits(vals, width)
    small = vals % np.uint64(1 << min(width, 31))  # pack_bits_jax takes uint32 values
    twin = tek.pack_bits_torch(torch.from_numpy(small.astype(np.int64)), width)
    assert twin.dtype == torch.uint8 and twin.device.type == "cpu"
    assert twin.numpy().tobytes() == np.asarray(jek.pack_bits_jax(small, width)).tobytes()
    assert tek.pack_bits_torch(torch.from_numpy(vals.astype(np.int64)), width).numpy().tobytes() == jek.pack_bits(
        vals, width
    )


@pytest.mark.parametrize("shape", ["random", "constant", "long_runs", "mixed"])
@pytest.mark.parametrize("width", [1, 3, 8, 13])
def test_rle_hybrid_matches_jax(shape, width):
    rng = np.random.default_rng(7)
    n, top = 1000, 1 << width
    values = {
        "random": lambda: rng.integers(0, top, n),
        "constant": lambda: np.full(n, top - 1),
        "long_runs": lambda: np.repeat(rng.integers(0, top, n // 9 + 1), 9)[:n],
        "mixed": lambda: np.concatenate([np.repeat(rng.integers(0, top, 1), 20), rng.integers(0, top, n)]),
    }[shape]()
    assert tek.encode_rle_hybrid(values, width) == jek.encode_rle_hybrid(values, width)


@pytest.mark.parametrize("physical", ["int32", "int64"])
@pytest.mark.parametrize("n", [1, 2, 64, 1025, 5000])
def test_delta_matches_jax(physical, n):
    from paimon_tpu_torch.decode.container import T_INT32, T_INT64

    rng = np.random.default_rng(n)
    v = np.cumsum(rng.integers(-3, 50, n)).astype(physical)
    p = T_INT32 if physical == "int32" else T_INT64
    assert tek.encode_delta_binary_packed(v, p) == jek.encode_delta_binary_packed(v, p)


@pytest.mark.parametrize("values", [["a", "bc", "", "déf"], ["x" * 5] * 4, [b"\x00", b"", b"\xff\xfe"], ["a\x00", "b"]])
def test_byte_array_stream_matches_jax(values):
    arr = np.empty(len(values), dtype=object)
    arr[:] = values
    lens, payload = tek.byte_array_parts(arr)
    jl, jpay = jek.byte_array_parts(arr)
    assert np.array_equal(lens, jl) and payload == jpay
    assert tek.encode_plain_byte_array(lens, payload) == jek.encode_plain_byte_array(jl, jpay)


def test_torch_encode_engine_writes_the_same_bytes():
    batch = _batch(tt, _rows(np.random.default_rng(2), 3000))
    want = write_parquet(batch, "none", {"parquet.page-size": "512"})
    tek.set_encode_engine("torch", device="cpu")
    got = write_parquet(batch, "none", {"parquet.page-size": "512"})
    tek.set_encode_engine("numpy")
    assert got == want
    with pytest.raises(ValueError, match="encode engine"):
        tek.set_encode_engine("jax")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tek.set_encode_engine("torch")
        assert tek.encode_engine() == "numpy"


# ---------------------------------------------------------------------------
# the writer's options
# ---------------------------------------------------------------------------


def _schema(pkg):
    return pkg.RowType.of(("k", pkg.BIGINT()), ("s", pkg.STRING()), ("i", pkg.INT()), ("v", pkg.DOUBLE()),
                          ("flag", pkg.BOOLEAN()), ("y", pkg.BYTES()))


def _rows(rng, n: int) -> dict:
    s = np.empty(n, dtype=object)
    s[:] = [f"name-{int(x):03d}" for x in rng.integers(0, 60, n)]
    s[rng.random(n) < 0.1] = None
    y = np.empty(n, dtype=object)
    y[:] = [bytes([int(x)]) * 3 for x in rng.integers(0, 200, n)]
    return {"k": np.arange(n, dtype=np.int64) * 3, "s": s, "i": rng.integers(0, 9, n).astype(np.int32),
            "v": rng.random(n), "flag": rng.integers(0, 2, n).astype(bool), "y": y}


def _batch(pkg, rows):
    return (ColumnBatch if pkg is tt else JaxBatch).from_pydict(_schema(pkg), rows)


def _layout(data: bytes) -> dict:
    """Row groups, data pages per column, dictionary chunks and page kinds."""
    groups = parse_footer(data)
    pages: dict[str, int] = {}
    kinds = set()
    for _, cols in groups:
        for name, chunk in cols.items():
            for kind, _, _ in iter_pages(data, chunk):
                if kind in (PAGE_DATA, PAGE_DATA_V2):
                    pages[name] = pages.get(name, 0) + 1
                    kinds.add(kind)
    dicts = sorted({n for _, cols in groups for n, c in cols.items() if c.has_dictionary})
    return {"row_groups": len(groups), "pages": pages, "dicts": dicts, "kinds": kinds}


OPTION_CASES = {
    "defaults": {},
    "page_size": {"parquet.page-size": "256"},
    "row_group_rows": {"parquet.row-group.rows": "1000"},
    "block_size": {"file.block-size": "40000"},
    "no_dictionary": {"parquet.enable.dictionary": "false"},
    "page_v2": {"parquet.data-page-version": "2.0"},
    "all": {"parquet.page-size": "512", "parquet.row-group.rows": "1500", "parquet.data-page-version": "2.0"},
}


@pytest.mark.parametrize("compression", ["zstd", "none"])
@pytest.mark.parametrize("case", list(OPTION_CASES))
def test_writer_options_like_jax(tmp_path, case, compression):
    rows = _rows(np.random.default_rng(11), 4000)
    opts = OPTION_CASES[case]
    data = write_parquet(_batch(tt, rows), compression, opts)
    want = jax_encode(_batch(jt, rows), compression, opts)
    got_layout, want_layout = _layout(data), _layout(want)
    assert got_layout == want_layout, (got_layout, want_layout)
    if case == "page_size":
        assert got_layout["pages"]["k"] > _layout(write_parquet(_batch(tt, rows), compression))["pages"]["k"]
    if case in ("row_group_rows", "block_size"):
        assert got_layout["row_groups"] > 1
    if case == "no_dictionary":
        assert got_layout["dicts"] == []
    if case == "page_v2":
        assert got_layout["kinds"] == {PAGE_DATA_V2}
    # the JAX package reads the port's file through both of its decoders
    path = str(tmp_path / "port.parquet")
    open(path, "wb").write(data)
    expect = _batch(jt, rows).to_pylist()
    native = jax_read_native(JaxIO(), path, _schema(jt))
    assert [r for b in native for r in b.to_pylist()] == expect
    arrow = list(JaxParquet().read(JaxIO(), path, _schema(jt)))
    assert [r for b in arrow for r in b.to_pylist()] == expect
    assert pq.read_table(path).num_rows == len(expect)
    back = read_parquet(data, _schema(tt), _schema(tt).field_names)
    assert [r for b in back for r in b.to_pylist()] == expect


def test_numeric_dictionary_and_delta_routes():
    n = 3000
    rng = np.random.default_rng(3)
    rows = _rows(rng, n)
    data = write_parquet(_batch(tt, rows), "none")
    footer = jax_parse_footer(data)
    encodings = {name: set(c.encodings) for name, c in footer.row_groups[0].columns.items()}
    jencodings = {name: set(c.encodings) for name, c in jax_parse_footer(
        jax_encode(_batch(jt, rows), "none", {})).row_groups[0].columns.items()}
    assert ENC_DELTA_BINARY_PACKED in encodings["k"]  # sorted BIGINT
    assert ENC_RLE_DICTIONARY in encodings["i"]  # nine values in 3000 rows
    assert ENC_RLE_DICTIONARY not in encodings["v"]
    assert {k: encodings[k] for k in ("k", "i", "v", "flag")} == {k: jencodings[k] for k in ("k", "i", "v", "flag")}


# ---------------------------------------------------------------------------
# dictionary pages straight from codes
# ---------------------------------------------------------------------------


def _stats(data: bytes, name: str):
    from paimon_tpu_torch.decode.container import chunk_field_stats

    num_rows, cols = parse_footer(data)[0]
    return chunk_field_stats(cols[name], tt.STRING(), num_rows)


@pytest.mark.parametrize("nulls", [False, True])
def test_code_backed_column_writes_its_pruned_pool(nulls):
    """Stray pool entries (merge losers, unified strays) never reach the
    file: the dictionary page is the pool of the codes in use, and the
    column never expands."""
    rng = np.random.default_rng(5)
    pool = np.array([f"p-{i:03d}" for i in range(50)], dtype=object)
    codes = rng.choice(np.arange(10, 40, 2), 2000).astype(np.uint32)
    validity = (rng.random(2000) > 0.2) if nulls else None
    col = Column.from_codes(pool, codes, validity)
    batch = ColumnBatch(tt.RowType.of(("s", tt.STRING())), {"s": col})
    registry.reset()
    data = write_parquet(batch, "zstd")
    assert col.is_code_backed and dict_metrics().counter("fallback_expanded").count == 0
    assert encode_metrics().counter("dict_pages").count == 1
    used = np.unique(codes if validity is None else codes[validity])
    dictionary, _, _ = __import__("paimon_tpu_torch.decode.pages", fromlist=["x"]).chunk_codes(
        data, parse_footer(data)[0][1]["s"], tt.STRING(), 2000)
    assert dictionary.tolist() == pool[used].tolist()
    st = _stats(data, "s")
    assert (st.min, st.max, st.null_count) == (pool[used[0]], pool[used[-1]], 0 if validity is None else int((~validity).sum()))
    want = [None if validity is not None and not validity[i] else pool[c] for i, c in enumerate(codes)]
    assert pq.read_table(io.BytesIO(data)).column("s").to_pylist() == want


def test_key_lane_cache_becomes_the_dictionary_page():
    """encode_key_lanes_with_pools leaves (pool, ranks) on a string key
    column; the writer takes them as the dictionary page and codes."""
    keys = np.array([f"key-{i % 700:05d}" for i in range(2000)], dtype=object)
    batch = ColumnBatch.from_pydict(tt.RowType.of(("k", tt.STRING(False)), ("v", tt.BIGINT())),
                                    {"k": keys, "v": np.arange(2000, dtype=np.int64)})
    tkeys.encode_key_lanes_with_pools(batch, ["k"])
    pool, ranks = batch.column("k").dict_cache
    assert pool.tolist() == sorted(set(keys.tolist())) and np.array_equal(pool[ranks], keys)
    data = write_parquet(batch, "none")
    assert parse_footer(data)[0][1]["k"].has_dictionary
    assert pq.read_table(io.BytesIO(data)).column("k").to_pylist() == keys.tolist()
    taken = batch.column("k").take(np.array([5, 9]))
    assert taken.dict_cache[0] is pool and taken.dict_cache[1].tolist() == ranks[[5, 9]].tolist()
    assert Column.concat([taken, taken]).dict_cache is None
