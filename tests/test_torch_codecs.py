"""Parquet's SNAPPY, GZIP and LZ4_RAW pages in the port (paimon_tpu_torch)
against the JAX package and pyarrow, on the CPU (device="cpu" for the port).

The snappy and lz4 codecs are the port's own (native/snappy.c,
native/lz4.c), held to pyarrow's on edge cases: empty input, one byte,
incompressible bytes, copies whose offset is shorter than their length
(offset 1 among them), literals past 60 (snappy) and 15 + 255 (lz4) bytes
and inputs past one 64 KiB fragment; malformed blocks raise. gzip goes
through zlib and reads pyarrow's members. Files: the JAX package's native
encoder and pyarrow write snappy, gzip and lz4 files the port reads, and
the port writes files both of them read, at page versions 1.0 and 2.0,
with dictionaries on and off; tables written by one package under
file.compression snappy, gzip or lz4 (and file.compression.per.level)
read the same in the other. brotli still raises, naming the option. They
mirror tests/test_decode.py:219 and tests/test_encode.py:204, :475.

Tolerance: exact.
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
from paimon_tpu.data.batch import ColumnBatch as JaxBatch
from paimon_tpu.decode import read_native as jax_read_native
from paimon_tpu.encode import encode_parquet_bytes as jax_encode
from paimon_tpu.fs import LocalFileIO as JaxIO
from paimon_tpu_torch.catalog import FileSystemCatalog as PortCatalog
from paimon_tpu_torch.data.batch import ColumnBatch, concat_batches
from paimon_tpu_torch.decode.container import CODEC_GZIP, CODEC_LZ4_RAW, CODEC_SNAPPY, parse_footer
from paimon_tpu_torch.format.parquet import read_parquet, write_parquet
from paimon_tpu_torch.utils.compression import (
    gzip_compress,
    gzip_decompress,
    lz4_compress,
    lz4_decompress,
    snappy_compress,
    snappy_decompress,
)

PKGS = ("jax", "port")
CODECS = {"snappy": CODEC_SNAPPY, "gzip": CODEC_GZIP, "lz4": CODEC_LZ4_RAW}


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """pyarrow's lazy first-use initialisation on the main thread."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


def _py(v):
    return v.item() if hasattr(v, "item") else v


# ---------------------------------------------------------------------------
# the codecs
# ---------------------------------------------------------------------------


def _edge_inputs() -> dict:
    rng = np.random.default_rng(5)
    return {
        "empty": b"",
        "one_byte": b"\x07",
        "incompressible": rng.integers(0, 256, 100_000, dtype=np.uint8).tobytes(),
        "overlap_offset_1": b"a" * 70_000,
        "overlap_offset_3": b"xyz" * 5000,
        "long_literal_then_repeat": bytes(range(200)) + bytes(range(200)) * 3,
        "literal_run_past_270": rng.integers(0, 256, 600, dtype=np.uint8).tobytes() + b"q" * 40,
        "tail_under_13": b"abcdabcdabcda",
        "fragments": (b"paimon-" * 40_000)[:200_001],
        "text": " ".join(f"key-{i % 977:05d}" for i in range(30_000)).encode(),
    }


@pytest.mark.parametrize("case", list(_edge_inputs()))
def test_snappy_edge_cases_against_pyarrow(case):
    data = _edge_inputs()[case]
    ours = snappy_compress(data)
    assert bytes(snappy_decompress(ours, len(data))) == data
    assert pa.Codec("snappy").decompress(ours, decompressed_size=len(data), asbytes=True) == data
    theirs = pa.Codec("snappy").compress(data, asbytes=True)
    assert bytes(snappy_decompress(theirs, len(data))) == data
    assert len(ours) <= len(data) + len(data) // 6 + 32


def test_snappy_malformed_blocks_raise():
    block = snappy_compress(b"abcabcabcabcabcabc" * 10)
    with pytest.raises(ValueError):
        snappy_decompress(block, 7)  # another declared size
    with pytest.raises(ValueError):
        snappy_decompress(block[:-3])  # cut short
    with pytest.raises(ValueError):
        snappy_decompress(b"\x05\x02\x10\x00")  # a copy before any output
    with pytest.raises(ValueError):
        snappy_decompress(b"\xff\xff\xff\xff\xff\xff\xff\xff\xff\xff\xff")  # no length


@pytest.mark.parametrize("case", list(_edge_inputs()))
def test_lz4_edge_cases_against_pyarrow(case):
    """The port's LZ4 raw blocks decode in pyarrow (lz4_raw) and pyarrow's
    in the port, with the size given and without it."""
    data = _edge_inputs()[case]
    ours = lz4_compress(data)
    assert bytes(lz4_decompress(ours, len(data))) == data
    assert pa.Codec("lz4_raw").decompress(ours, decompressed_size=len(data), asbytes=True) == data
    theirs = pa.Codec("lz4_raw").compress(data, asbytes=True)
    assert bytes(lz4_decompress(theirs, len(data))) == data
    assert bytes(lz4_decompress(theirs)) == data
    assert len(ours) <= len(data) + len(data) // 255 + 16
    # the end rules: the last 5 bytes are literals, the last sequence has no match
    if len(data) >= 5:
        assert ours[-5:] == data[-5:]


def test_lz4_overlapping_matches_and_long_lengths():
    """A hand-built block: an offset-1 match of 1,000 bytes (15 + 255 + 255 +
    255 + 216 + 4), an offset-3 match, then a final literal run."""
    block = bytes([0x1F]) + b"a" + b"\x01\x00" + bytes([255, 255, 255, 216])  # "a" then 1,000 more
    block += bytes([0x32]) + b"xyz" + b"\x03\x00"  # 'xyz' then 6 more at offset 3
    block += bytes([0x80]) + b"the-tail"  # the format's end rules: 12 bytes after the last match starts
    want = b"a" * 1001 + b"xyz" * 3 + b"the-tail"
    assert bytes(lz4_decompress(block, len(want))) == want
    assert pa.Codec("lz4_raw").decompress(block, decompressed_size=len(want), asbytes=True) == want


def test_lz4_malformed_blocks_raise():
    block = lz4_compress(b"abcabcabcabcabcabc" * 10)
    with pytest.raises(ValueError):
        lz4_decompress(block, 7)  # another size
    with pytest.raises(ValueError):
        lz4_decompress(block[:-3], 180)  # cut short
    with pytest.raises(ValueError):
        lz4_decompress(b"\x10a\x05\x00")  # an offset past the output
    with pytest.raises(ValueError):
        lz4_decompress(b"\x10a\x00\x00")  # offset 0


@pytest.mark.parametrize("case", ["empty", "one_byte", "text", "incompressible"])
def test_gzip_against_pyarrow(case):
    data = _edge_inputs()[case]
    ours = gzip_compress(data)
    assert ours[:2] == b"\x1f\x8b"
    assert pa.Codec("gzip").decompress(ours, decompressed_size=len(data), asbytes=True) == data
    assert bytes(gzip_decompress(pa.Codec("gzip").compress(data, asbytes=True), len(data))) == data
    with pytest.raises(ValueError):
        gzip_decompress(ours[:-9])  # cut short


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------


def _schema(pkg):
    m = jt if pkg == "jax" else tt
    return m.RowType.of(("b", m.BOOLEAN()), ("i", m.INT()), ("l", m.BIGINT()), ("f", m.FLOAT()), ("d", m.DOUBLE()),
                        ("s", m.STRING()), ("y", m.BYTES()), ("lo", m.STRING()))


def _rows(n=1500, seed=9) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "b": [None if i % 11 == 0 else bool(x) for i, x in enumerate(rng.integers(0, 2, n))],
        "i": [None if i % 13 == 0 else int(x) for i, x in enumerate(rng.integers(-5000, 5000, n))],
        "l": [None if i % 7 == 0 else int(x) for i, x in enumerate(rng.integers(-(2**40), 2**40, n))],
        "f": [None if i % 5 == 0 else float(np.float32(x)) for i, x in enumerate(rng.normal(size=n))],
        "d": [None if i % 9 == 0 else float(x) for i, x in enumerate(rng.normal(size=n))],
        "s": [None if i % 6 == 0 else f"str-{int(x)}" + "é" * (i % 4 == 1) for i, x in enumerate(rng.integers(0, 10**6, n))],
        "y": [None if i % 8 == 0 else bytes(rng.integers(0, 256, i % 9, dtype=np.uint8)) for i in range(n)],
        "lo": [None if i % 10 == 0 else f"tag-{int(x)}" for i, x in enumerate(rng.integers(0, 12, n))],
    }


def _want(rows: dict) -> list[tuple]:
    return list(zip(*rows.values()))


def _port_rows(data: bytes) -> list[tuple]:
    parts = read_parquet(data, _schema("port"), _schema("port").field_names)
    return [tuple(_py(v) for v in r) for r in concat_batches(parts).to_pylist()]


@pytest.mark.parametrize("dictionary", ["true", "false"])
@pytest.mark.parametrize("page_version", ["1.0", "2.0"])
@pytest.mark.parametrize("codec", list(CODECS))
@pytest.mark.parametrize("writer", PKGS)
def test_files_each_way(tmp_path, writer, codec, page_version, dictionary):
    """One package's encoder writes every page under `codec`; the other
    package, pyarrow and the writer itself read the rows written."""
    rows = _rows()
    opts = {"parquet.page-size": "4096", "parquet.data-page-version": page_version,
            "parquet.enable.dictionary": dictionary}
    if writer == "jax":
        data = jax_encode(JaxBatch.from_pydict(_schema("jax"), rows), codec, opts)
    else:
        data = write_parquet(ColumnBatch.from_pydict(_schema("port"), rows), codec, opts)
    groups = parse_footer(data)
    assert {c.codec for _, cols in groups for c in cols.values()} == {CODECS[codec]}
    assert _port_rows(data) == _want(rows)
    path = str(tmp_path / "f.parquet")
    with open(path, "wb") as f:
        f.write(data)
    jax_rows = [tuple(r) for b in jax_read_native(JaxIO(), path, _schema("jax")) for r in b.to_pylist()]
    assert jax_rows == _want(rows)
    arrow = pq.read_table(path)
    assert [tuple(r.values()) for r in arrow.to_pylist()] == _want(rows)


@pytest.mark.parametrize("codec", list(CODECS))
def test_pyarrow_files_read(codec):
    """pyarrow's own writer (its snappy and gzip, dictionary pages, v2
    pages) read by the port."""
    rows = _rows(900, seed=4)
    table = pa.table({k: v for k, v in rows.items()}, schema=pa.schema([
        ("b", pa.bool_()), ("i", pa.int32()), ("l", pa.int64()), ("f", pa.float32()), ("d", pa.float64()),
        ("s", pa.string()), ("y", pa.binary()), ("lo", pa.string())]))
    for version in ("1.0", "2.0"):
        buf = io.BytesIO()
        pq.write_table(table, buf, compression=codec, data_page_version=version, data_page_size=2048)
        assert _port_rows(buf.getvalue()) == _want(rows)


def _kv_schema(pkg):
    m = jt if pkg == "jax" else tt
    return m.RowType.of(("k", m.BIGINT(False)), ("s", m.STRING()), ("d", m.DOUBLE()))


def _catalog(pkg, warehouse):
    if pkg == "jax":
        return JaxCatalog(warehouse, commit_user=pkg)
    return PortCatalog(warehouse, commit_user=pkg, device="cpu")


def _read(table) -> list[tuple]:
    rb = table.new_read_builder()
    return sorted(tuple(_py(v) for v in r) for r in rb.new_read().read_all(rb.new_scan().plan()).to_pylist())


@pytest.mark.parametrize(
    "opts",
    [{"file.compression": "snappy"}, {"file.compression": "gzip"},
     {"file.compression": "snappy", "file.compression.per.level": "0:gzip"}, {"file.compression": "lz4"},
     {"file.compression": "lz4", "file.compression.per.level": "0:gzip"}],
    ids=["snappy", "gzip", "per_level", "lz4", "lz4_per_level"],
)
@pytest.mark.parametrize("writer", PKGS)
def test_tables_each_way(tmp_path, writer, opts):
    """A primary-key table written by one package over four overlapping
    commits and a compaction, read by the other to the writer's rows; the
    files carry the codecs the options name."""
    wh = str(tmp_path)
    t = _catalog(writer, wh).create_table("db.c", _kv_schema(writer), primary_keys=["k"],
                                          options={"bucket": "1", "num-sorted-run.compaction-trigger": "3", **opts})
    rng = np.random.default_rng(21)
    last = {}
    for r in range(4):
        ks = rng.permutation(80)[:50].astype(np.int64)
        rows = {"k": ks, "s": [None if k % 6 == 0 else f"v{r}-{k}" for k in ks], "d": ks * 0.25 + r}
        wb = t.new_batch_write_builder()
        w = wb.new_write()
        w.write(rows)
        wb.new_commit().commit(w.prepare_commit())
        last.update({int(k): (int(k), s, float(d)) for k, s, d in zip(*rows.values())})
    codecs = set()
    for name in os.listdir(f"{t.path}/bucket-0"):
        with open(f"{t.path}/bucket-0/{name}", "rb") as f:
            codecs |= {c.codec for _, cols in parse_footer(f.read()) for c in cols.values()}
    want = {CODECS[opts["file.compression"]]}
    if "file.compression.per.level" in opts:  # level 0 gzip, the compacted levels file.compression
        want.add(CODEC_GZIP)
    assert codecs == want
    for pkg in PKGS:
        assert _read(_catalog(pkg, wh).get_table("db.c")) == sorted(last.values())


@pytest.mark.parametrize("codec", ["lz4", "brotli"])
def test_other_codecs_still_raise_naming_the_option(tmp_path, codec):
    """A JAX table under lz4 or brotli pages. lz4 is ported: the port reads
    the JAX package's rows, and a port table under lz4 writes LZ4_RAW pages
    the JAX package reads. brotli still raises naming file.compression: on
    the port's read of the JAX table, and at the first write of a port
    table."""
    wh = str(tmp_path)
    t = _catalog("jax", wh).create_table("db.j", _kv_schema("jax"), primary_keys=["k"],
                                         options={"bucket": "1", "file.compression": codec})
    wb = t.new_batch_write_builder()
    w = wb.new_write()
    w.write({"k": [1, 2], "s": ["a", None], "d": [0.5, 1.5]})
    wb.new_commit().commit(w.prepare_commit())
    if codec == "lz4":
        assert _read(_catalog("port", wh).get_table("db.j")) == [(1, "a", 0.5), (2, None, 1.5)]
    else:
        with pytest.raises(NotImplementedError, match=r"file\.compression"):
            _read(_catalog("port", wh).get_table("db.j"))
    port = _catalog("port", wh).create_table("db.p", _kv_schema("port"), primary_keys=["k"],
                                             options={"bucket": "1", "file.compression": codec})
    wb = port.new_batch_write_builder()
    w = wb.new_write()
    w.write({"k": [1], "s": ["a"], "d": [0.5]})
    if codec == "lz4":
        wb.new_commit().commit(w.prepare_commit())
        (name,) = os.listdir(f"{port.path}/bucket-0")
        with open(f"{port.path}/bucket-0/{name}", "rb") as f:
            assert {c.codec for _, cols in parse_footer(f.read()) for c in cols.values()} == {CODEC_LZ4_RAW}
        assert _read(_catalog("jax", wh).get_table("db.p")) == [(1, "a", 0.5)]
        return
    with pytest.raises(NotImplementedError, match=r"file\.compression"):
        w.prepare_commit()
