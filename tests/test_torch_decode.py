"""The port's page decoder (paimon_tpu_torch/decode/) against the JAX
package's (paimon_tpu/decode/), on the CPU.

Kernels: `unpack_bits` and its torch twin `unpack_bits_torch` against the
JAX package's `unpack_bits` and `unpack_bits_jax` at every width 1-32;
`gather_torch` against `gather_jax`; `decode_rle_hybrid` on streams with
RLE and bit-packed runs; PLAIN byte arrays of uniform and mixed lengths; the torch decode engine (on the CPU here) reads a
file to the same columns as the numpy engine, and asks for a card by
default. Files written by pyarrow, by the JAX package's native encoder
and by the port, with dictionaries on and off, nulls, small pages and
several row groups: `chunk_codes` gives the JAX package's (dictionary,
codes, validity) per chunk, `row_group_keep_mask` its masks and the same
pages left unexpanded, and `read_parquet` its batches with the code domain
on and off (the same columns code-backed). A smaller parquet.page-size
leaves more pages unexpanded under a selective predicate. A filtered read
over a file whose sidecar or embedded index has a bad magic keeps every
matching row in the port; the JAX package raises AssertionError there.

Tolerance: exact.
"""

import base64
import io
import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import paimon_tpu as jt
import paimon_tpu_torch as tt
from paimon_tpu.catalog import FileSystemCatalog as JaxCatalog
from paimon_tpu.data import predicate as jp
from paimon_tpu.data.batch import ColumnBatch as JaxBatch
from paimon_tpu.decode import kernels as jdk
from paimon_tpu.decode import read_native as jax_read_native
from paimon_tpu.decode.container import parse_footer as jax_parse_footer
from paimon_tpu.decode.pages import chunk_codes as jax_chunk_codes
from paimon_tpu.decode.pushdown import row_group_keep_mask as jax_keep_mask
from paimon_tpu.encode import encode_parquet_bytes as jax_encode
from paimon_tpu.encode import kernels as jek
from paimon_tpu.fs import LocalFileIO as JaxIO
from paimon_tpu.metrics import decode_metrics as jax_decode_metrics
from paimon_tpu_torch.catalog import FileSystemCatalog as PortCatalog
from paimon_tpu_torch.data import predicate as tp
from paimon_tpu_torch.data.batch import ColumnBatch as PortBatch
from paimon_tpu_torch.decode import kernels as tdk
from paimon_tpu_torch.decode.container import parse_footer
from paimon_tpu_torch.decode.pages import chunk_codes
from paimon_tpu_torch.decode.pushdown import row_group_keep_mask
from paimon_tpu_torch.format.parquet import read_parquet, write_parquet
from paimon_tpu_torch.metrics import decode_metrics, registry


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """pyarrow's lazy first-use initialisation on the main thread."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


@pytest.fixture(autouse=True)
def _numpy_engines():
    yield
    tdk.set_decode_engine("numpy")


def _packed(rng, width: int, count: int) -> tuple[np.ndarray, np.ndarray]:
    vals = rng.integers(0, 1 << width, count, dtype=np.uint64)
    return vals, np.frombuffer(jek.pack_bits(vals, width), dtype=np.uint8)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", range(1, 33))
def test_unpack_bits_matches_jax(width):
    rng = np.random.default_rng(width)
    vals, data = _packed(rng, width, 203)
    got = tdk.unpack_bits(data, width, 203)
    assert np.array_equal(got, jdk.unpack_bits(data, width, 203).astype(np.int64))
    assert np.array_equal(got, vals.astype(np.int64))
    twin = tdk.unpack_bits_torch(torch.from_numpy(data.copy()), width, 203)
    assert twin.device.type == "cpu" and twin.dtype == torch.int64
    assert np.array_equal(twin.numpy(), np.asarray(jdk.unpack_bits_jax(data, width, 203)).astype(np.int64))


def test_unpack_bits_edges():
    assert len(tdk.unpack_bits(np.zeros(0, np.uint8), 5, 0)) == 0
    assert np.array_equal(tdk.unpack_bits(np.zeros(0, np.uint8), 0, 4), np.zeros(4))
    assert tdk.unpack_bits_torch(torch.zeros(0, dtype=torch.uint8), 0, 3).tolist() == [0, 0, 0]
    with pytest.raises(ValueError, match="too short"):
        tdk.unpack_bits(np.zeros(1, np.uint8), 3, 8)
    with pytest.raises(ValueError, match="too short"):
        tdk.unpack_bits_torch(torch.zeros(1, dtype=torch.uint8), 3, 8)


@pytest.mark.parametrize("dtype", ["int32", "int64", "float64", "uint8"])
def test_gather_torch_matches_jax(dtype):
    rng = np.random.default_rng(3)
    dictionary = rng.integers(0, 100, 37).astype(dtype)
    codes = rng.integers(0, 37, 500).astype(np.int32)
    got = tdk.gather_torch(torch.from_numpy(dictionary), torch.from_numpy(codes))
    assert np.array_equal(got.numpy(), np.asarray(jdk.gather_jax(dictionary, codes)))
    assert np.array_equal(tdk.gather(dictionary, codes), jdk.gather(dictionary, codes))


@pytest.mark.parametrize("width", [1, 3, 8, 13, 20, 32])
def test_rle_hybrid_matches_jax(width):
    rng = np.random.default_rng(width)
    # the JAX package's stream decoder returns int32 (dictionary indices)
    runs = [np.full(int(rng.integers(1, 40)), int(rng.integers(0, 1 << min(width, 31)))) for _ in range(60)]
    values = np.concatenate(runs).astype(np.int64)
    stream = jek.encode_rle_hybrid(values, width)
    got = tdk.decode_rle_hybrid(stream, 0, len(stream), width, len(values))
    assert np.array_equal(got, jdk.decode_rle_hybrid(stream, 0, len(stream), width, len(values)))
    assert np.array_equal(got, values)


@pytest.mark.parametrize("values", [["abcd", "efgh", "ijkl"], ["ab\x00c", "abcd"], ["abc\x00", "abcd"],
                                    ["日本", "éé"], ["a", "bb"], ["", ""], ["x" * 5] * 4, ["\x7f\x01", "ab"]])
@pytest.mark.parametrize("utf8", [True, False])
def test_byte_array_stream_matches_jax(values, utf8):
    """PLAIN byte arrays, the uniform-length reshape and the per-value walk
    alike (trailing NUL, non-ASCII, empty values)."""
    arr = np.empty(len(values), dtype=object)
    arr[:] = values if utf8 else [v.encode() for v in values]
    lens, payload = jek.byte_array_parts(arr)
    stream = jek.encode_plain_byte_array(lens, payload)
    got, sizes = tdk.decode_byte_array(stream, 0, len(arr), utf8)
    want = jdk.decode_plain(stream, 0, 6, len(arr), utf8=utf8)
    assert got.tolist() == want.tolist() == arr.tolist()
    assert all(type(a) is type(b) for a, b in zip(got.tolist(), arr.tolist()))
    assert sizes.tolist() == lens.tolist()


def test_torch_decode_engine_reads_the_same(tmp_path):
    data = write_parquet(_port_batch(_rows(np.random.default_rng(8), 3000)), "zstd", {"parquet.page-size": "1024"})
    want = read_parquet(data, _schema(tt), _schema(tt).field_names)
    tdk.set_decode_engine("torch", device="cpu")
    assert tdk.decode_engine() == "torch"
    got = read_parquet(data, _schema(tt), _schema(tt).field_names)
    tdk.set_decode_engine("numpy")
    assert [b.to_pylist() for b in got] == [b.to_pylist() for b in want]
    with pytest.raises(ValueError, match="decode engine"):
        tdk.set_decode_engine("jax")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdk.set_decode_engine("torch")
        assert tdk.decode_engine() == "numpy"


# ---------------------------------------------------------------------------
# files from three writers
# ---------------------------------------------------------------------------


def _schema(pkg):
    return pkg.RowType.of(("k", pkg.BIGINT()), ("s", pkg.STRING()), ("b", pkg.BYTES()), ("i", pkg.INT()),
                          ("d", pkg.DATE()), ("f", pkg.DOUBLE()), ("flag", pkg.BOOLEAN()), ("t", pkg.TIMESTAMP()))


def _rows(rng, n: int, null_rate: float = 0.2) -> dict:
    def nulls(vals):
        mask = rng.random(n) < null_rate
        out = np.empty(n, dtype=object)
        out[:] = list(vals)
        out[mask] = None
        return out

    return {
        "k": np.sort(rng.integers(0, 10 * n, n)).astype(np.int64),
        "s": nulls(f"v-{int(x):03d}" for x in rng.integers(0, 40, n)),
        "b": nulls(bytes([int(x)]) * int(x % 5) for x in rng.integers(0, 30, n)),
        "i": rng.integers(-5, 20, n).astype(np.int32),
        "d": rng.integers(18000, 18030, n).astype(np.int32),
        "f": rng.random(n),
        "flag": rng.integers(0, 2, n).astype(bool),
        "t": rng.integers(0, 12, n).astype(np.int64) * 1_000_000,
    }


def _port_batch(rows):
    return PortBatch.from_pydict(_schema(tt), rows)


def _jax_batch(rows):
    return JaxBatch.from_pydict(_schema(jt), rows)


def _file(writer: str, rows: dict, dictionary: bool = True, page_size: int = 1024) -> bytes:
    opts = {"parquet.page-size": str(page_size), "parquet.row-group.rows": "1500",
            "parquet.enable.dictionary": str(dictionary).lower()}
    if writer == "pyarrow":
        buf = io.BytesIO()
        pq.write_table(_jax_batch(rows).to_arrow(), buf, compression="zstd", use_dictionary=dictionary,
                       data_page_size=page_size, row_group_size=1500)
        return buf.getvalue()
    if writer == "jax":
        return jax_encode(_jax_batch(rows), "zstd", opts)
    return write_parquet(_port_batch(rows), "zstd", opts)


WRITERS = ["pyarrow", "jax", "port"]


def _same(got, want) -> bool:
    return len(got) == len(want) and all(a == b for a, b in zip(list(got), list(want)))


@pytest.mark.parametrize("writer", WRITERS)
def test_chunk_codes_match_jax(writer):
    rows = _rows(np.random.default_rng(1), 4000)
    data = _file(writer, rows)
    jfooter = jax_parse_footer(data)
    coded = 0
    for (num_rows, cols), jrg in zip(parse_footer(data), jfooter.row_groups):
        assert num_rows == jrg.num_rows
        for f in _schema(tt).fields:
            jf = _schema(jt).field(f.name)
            got = chunk_codes(data, cols[f.name], f.type, num_rows)
            want = jax_chunk_codes(data, jrg.columns[f.name], jf.type, num_rows)
            assert (got is None) == (want is None), (writer, f.name)
            if got is None:
                continue
            coded += 1
            assert _same(got[0], want[0]) and np.array_equal(got[1], want[1])
            assert (got[2] is None) == (want[2] is None)
            if got[2] is not None:
                assert np.array_equal(got[2], want[2])
    assert coded > 0


@pytest.mark.parametrize("writer", WRITERS)
@pytest.mark.parametrize("case", ["string_eq", "string_in", "int_range", "and", "bytes", "miss"])
def test_keep_mask_matches_jax(writer, case):
    rows = _rows(np.random.default_rng(2), 4000)
    data = _file(writer, rows, page_size=256)
    make = {
        "string_eq": lambda p: p.equal("s", "v-007"),
        "string_in": lambda p: p.in_("s", ["v-001", "v-033"]),
        "int_range": lambda p: p.between("i", 3, 4),
        "and": lambda p: p.and_(p.equal("s", "v-002"), p.greater_than("d", 18010)),
        "bytes": lambda p: p.equal("b", b"\x03\x03\x03"),
        "miss": lambda p: p.equal("s", "absent"),
    }[case]
    jfooter = jax_parse_footer(data)
    for (num_rows, cols), jrg in zip(parse_footer(data), jfooter.row_groups):
        got = row_group_keep_mask(data, cols, num_rows, make(tp), _schema(tt))
        want = jax_keep_mask(data, jfooter, jrg, make(jp), _schema(jt))
        if isinstance(want, np.ndarray):
            assert isinstance(got, np.ndarray) and np.array_equal(got, want)
        else:
            assert got is want
    # the same pages left unexpanded, the same rows returned
    registry.reset()
    jax_decode_metrics().counter("pages_skipped")
    d0 = jax_decode_metrics().counter("pages_skipped").count
    path = _tmp_file(data)
    want_b = jax_read_native(JaxIO(), path, _schema(jt), predicate=make(jp))
    jax_skipped = jax_decode_metrics().counter("pages_skipped").count - d0
    got_b = read_parquet(data, _schema(tt), _schema(tt).field_names, make(tp))
    assert decode_metrics().counter("pages_skipped").count == jax_skipped
    assert [b.to_pylist() for b in got_b] == [b.to_pylist() for b in want_b]


def _tmp_file(data: bytes) -> str:
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".parquet")
    with os.fdopen(fd, "wb") as fh:
        fh.write(data)
    return path


@pytest.mark.parametrize("writer", WRITERS)
@pytest.mark.parametrize("dictionary", [True, False])
@pytest.mark.parametrize("dict_domain", [True, False])
def test_read_matches_jax(writer, dictionary, dict_domain):
    rows = _rows(np.random.default_rng(4), 3500)
    data = _file(writer, rows, dictionary=dictionary)
    path = _tmp_file(data)
    want = jax_read_native(JaxIO(), path, _schema(jt), dict_domain=dict_domain)
    got = read_parquet(data, _schema(tt), _schema(tt).field_names, dict_domain=dict_domain)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for name in g.schema.field_names:
            assert g.column(name).is_code_backed == w.column(name).is_code_backed, name
            if g.column(name).is_code_backed:
                assert _same(g.column(name).dict_cache[0], w.column(name).dict_cache[0])
                assert np.array_equal(g.column(name).dict_cache[1], w.column(name).dict_cache[1])
        assert g.to_pylist() == w.to_pylist()
    os.remove(path)


def test_pool_limit_expands_past_the_limit():
    rows = _rows(np.random.default_rng(5), 2000)
    data = _file("port", rows)
    small = read_parquet(data, _schema(tt), ["s", "i"], dict_domain=True, pool_limit=30)
    large = read_parquet(data, _schema(tt), ["s", "i"], dict_domain=True)
    assert not small[0].column("s").is_code_backed and small[0].column("i").is_code_backed
    assert large[0].column("s").is_code_backed
    assert [b.to_pylist() for b in small] == [b.to_pylist() for b in large]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_smaller_pages_leave_more_pages_unexpanded(writer):
    """parquet.page-size sets the pushdown's grain: a clustered column under
    a selective predicate leaves more of its pages unexpanded in a file of
    small pages."""
    n = 6000
    rows = _rows(np.random.default_rng(6), n, null_rate=0.0)
    rows["s"] = np.array([f"v-{i * 40 // n:03d}" for i in range(n)], dtype=object)
    skipped = {}
    for page_size in (64, 4096):
        data = _file(writer, rows, page_size=page_size)
        registry.reset()
        got = read_parquet(data, _schema(tt), _schema(tt).field_names, tp.equal("s", "v-020"))
        skipped[page_size] = decode_metrics().counter("pages_skipped").count
        assert sum(b.num_rows for b in got) == int((rows["s"] == "v-020").sum())
    assert skipped[64] > skipped[4096] >= 0


# ---------------------------------------------------------------------------
# filtered reads over unreadable file indexes (ROADMAP Queue 3 item 23)
# ---------------------------------------------------------------------------


def _index_table(warehouse: str, ident: str, embedded: bool):
    opts = {"bucket": "1", "write-only": "true", "file-index.bloom-filter.columns": "s",
            "file-index.in-manifest-threshold": "1 mb" if embedded else "0 b",
            "cache.manifest.max-memory-size": "0 b", "cache.data-file.max-memory-size": "0 b"}
    t = PortCatalog(warehouse, device="cpu").create_table(ident, _schema(tt), options=opts)
    rng = np.random.default_rng(9)
    for _ in range(2):
        wb = t.new_batch_write_builder()
        w = wb.new_write()
        w.write(_rows(rng, 300))
        wb.new_commit().commit(w.prepare_commit())
    return t


def _break_sidecars(t) -> int:
    n = 0
    for e in t.store.new_scan().plan().entries:
        for x in e.file.extra_files:
            path = f"{t.path}/bucket-0/{x}"
            raw = open(path, "rb").read()
            open(path, "wb").write(b"XXXX" + raw[4:])
            n += 1
    return n


def _break_embedded(t) -> int:
    """Rewrite every manifest's embedded index payloads with a bad magic."""
    from paimon_tpu_torch.utils.compression import ZSTD_MAGIC, zstd_compress, zstd_decompress

    n = 0
    mdir = f"{t.path}/manifest"
    for name in os.listdir(mdir):
        if not name.startswith("manifest-") or name.startswith("manifest-list"):
            continue
        raw = open(f"{mdir}/{name}", "rb").read()
        zipped = raw[:4] == ZSTD_MAGIC
        text = bytes(zstd_decompress(raw)).decode() if zipped else raw.decode()
        lines = []
        for line in text.splitlines():
            entry = json.loads(line)
            f = entry.get("file", {})
            if f.get("embeddedIndex"):
                payload = base64.b64decode(f["embeddedIndex"])
                f["embeddedIndex"] = base64.b64encode(b"XXXX" + payload[4:]).decode()
                n += 1
            lines.append(json.dumps(entry))
        out = ("\n".join(lines) + "\n").encode()
        open(f"{mdir}/{name}", "wb").write(zstd_compress(out) if zipped else out)
    return n


@pytest.mark.parametrize("where", ["sidecar", "embedded"])
def test_bad_index_magic_keeps_every_matching_row(tmp_path, where):
    t = _index_table(str(tmp_path), f"db.bad_{where}", embedded=where == "embedded")
    rb = t.new_read_builder().with_filter(tp.equal("s", "v-005"))
    want = rb.new_read().read_all(rb.new_scan().plan()).to_pylist()
    assert want and all(r[1] == "v-005" for r in want)
    broken = _break_sidecars(t) if where == "sidecar" else _break_embedded(t)
    assert broken == 2
    fresh = PortCatalog(str(tmp_path), device="cpu").get_table(f"db.bad_{where}")
    rb = fresh.new_read_builder().with_filter(tp.equal("s", "v-005"))
    assert rb.new_read().read_all(rb.new_scan().plan()).to_pylist() == want
    # the JAX package asserts the magic and fails the read
    jax = JaxCatalog(str(tmp_path)).get_table(f"db.bad_{where}")
    jrb = jax.new_read_builder().with_filter(jp.equal("s", "v-005"))
    with pytest.raises(AssertionError):
        jrb.new_read().read_all(jrb.new_scan().plan())
