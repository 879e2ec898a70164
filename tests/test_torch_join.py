"""Equi-joins in the port (paimon_tpu_torch/ops/join.py) against the JAX
package's ops/join.py, on the CPU (device="cpu" for the port).

- join_batches: inner and left pairs at every engine. The JAX package runs
  "numpy", "xla" and "pallas" (its Pallas kernels in interpret mode, as its
  own tests run them); the port runs the same engine names on
  device="cpu", where "xla" is plain torch ops and "pallas" the plain
  versions of K1 and K2 behind the kernel wrappers. Cases: one BIGINT key
  under uniform, zipf-like and hot-key skew; string and composite
  (string, int) keys with nulls; the hash and the sort-merge algorithm; a
  zero-width key (a key constant on both sides); an INT key whose lane is
  0xFFFFFFFF (2^31 - 1 flipped) with lane compression off, so it equals
  the hash probe's pad value; a skewed probe under a small join.chunk-rows
  (partitions with the skew split); empty sides; lane compression on and
  off. Each result is also held to a host nested-loop oracle.
- JoinIndex.probe (the lookup tables' and gets' index) on one-column,
  string and composite keys, wide keys (the join_batches fallback), null
  and empty builds.
- materialize_join's columns, engine resolution, the join{...} metrics,
  and the CUDA default raising without a GPU.

Tolerance: exact. Pairs are integer indices.
"""

import numpy as np
import pytest
import torch

import paimon_tpu.data.batch as jbatch
import paimon_tpu.types as jtypes
import paimon_tpu_torch.data.batch as tbatch
import paimon_tpu_torch.types as ttypes
from paimon_tpu.ops import join as jjoin
from paimon_tpu_torch.metrics import join_metrics, registry
from paimon_tpu_torch.ops import hopper_kernels as hk
from paimon_tpu_torch.ops import join as tjoin

ENGINES = ("numpy", "xla", "pallas")
SKEWS = {
    "uniform": lambda rng, n, dom: rng.integers(0, dom, n),
    "zipfish": lambda rng, n, dom: np.minimum((rng.pareto(1.2, n) * dom / 8).astype(np.int64), dom - 1),
    "hot50": lambda rng, n, dom: np.where(rng.random(n) < 0.5, 7, rng.integers(0, dom, n)),
}


def _batch(pkg, spec, data):
    """One ColumnBatch of `pkg` ("jax" or "port") from column lists;
    spec: [(name, type name)]."""
    types, batch = (jtypes, jbatch) if pkg == "jax" else (ttypes, tbatch)
    schema = types.RowType.of(*[(n, getattr(types, t)()) for n, t in spec])
    return batch.ColumnBatch.from_pydict(schema, data)


def _both(spec, data):
    return _batch("jax", spec, data), _batch("port", spec, data)


def oracle_pairs(left_keys, right_keys, how="inner"):
    """Nested-probe oracle: probe-major pairs, build rows ascending; a key
    with a None never matches."""
    pos: dict = {}
    for j, k in enumerate(right_keys):
        if None not in k:
            pos.setdefault(k, []).append(j)
    lt, rt = [], []
    for i, k in enumerate(left_keys):
        matches = pos.get(k, []) if None not in k else []
        for j in matches:
            lt.append(i)
            rt.append(j)
        if not matches and how == "left":
            lt.append(i)
            rt.append(-1)
    return np.asarray(lt, dtype=np.int64), np.asarray(rt, dtype=np.int64)


def _keys_of(data, names):
    return list(zip(*[data[n] for n in names]))


def _join_both(left, right, keys, how, engine, options=None):
    """(JAX result, port result) of one join, asserted equal pair for pair."""
    (jl, tl), (jr, tr) = left, right
    jres = jjoin.join_batches(jl, jr, keys, keys, how=how, engine=engine, options=options)
    tres = tjoin.join_batches(tl, tr, keys, keys, how=how, engine=engine, options=options, device="cpu")
    np.testing.assert_array_equal(tres.left_take, jres.left_take)
    np.testing.assert_array_equal(tres.right_take, jres.right_take)
    for k in ("algorithm", "engine", "partitions", "skew_keys", "skew_split_rows", "lanes"):
        assert tres.stats[k] == jres.stats[k], k
    return jres, tres


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("how", ["inner", "left"])
@pytest.mark.parametrize("skew", sorted(SKEWS))
def test_single_bigint_key_parity(engine, how, skew):
    rng = np.random.default_rng(11)
    ld = {"k": SKEWS[skew](rng, 3000, 700).tolist()}
    rd = {"k": rng.integers(0, 700, 900).tolist()}
    spec = [("k", "BIGINT")]
    _, tres = _join_both(_both(spec, ld), _both(spec, rd), ["k"], how, engine)
    olt, ort = oracle_pairs(_keys_of(ld, ["k"]), _keys_of(rd, ["k"]), how)
    np.testing.assert_array_equal(tres.left_take, olt)
    np.testing.assert_array_equal(tres.right_take, ort)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("algorithm", ["hash", "sort-merge"])
@pytest.mark.parametrize("keys", [["s"], ["s", "k"]])
@pytest.mark.parametrize("null_rate", [0.0, 0.25])
def test_string_and_composite_key_parity(engine, algorithm, keys, null_rate):
    rng = np.random.default_rng(13)

    def side(n):
        k = rng.integers(0, 300, n)
        return {
            "s": [None if rng.random() < null_rate else f"c{int(v) % 41}" for v in k],
            "k": [None if rng.random() < null_rate else int(v) for v in k],
            "x": rng.random(n).tolist(),
        }

    ld, rd = side(2500), side(800)
    spec = [("s", "STRING"), ("k", "BIGINT"), ("x", "DOUBLE")]
    for how in ("inner", "left"):
        _, tres = _join_both(
            _both(spec, ld), _both(spec, rd), keys, how, engine, options={"join.algorithm": algorithm}
        )
        olt, ort = oracle_pairs(_keys_of(ld, keys), _keys_of(rd, keys), how)
        np.testing.assert_array_equal(tres.left_take, olt)
        np.testing.assert_array_equal(tres.right_take, ort)


@pytest.mark.parametrize("engine", ENGINES)
def test_zero_width_key_is_the_cross_product(engine):
    ld, rd = {"k": [5] * 40}, {"k": [5] * 30}
    spec = [("k", "BIGINT")]
    jres, _ = _join_both(_both(spec, ld), _both(spec, rd), ["k"], "inner", engine)
    assert jres.num_rows == 1200 and jres.stats["lanes"] == 0


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("algorithm", ["hash", "sort-merge"])
def test_lane_equal_to_the_pad_value(engine, algorithm):
    """INT 2^31 - 1 encodes to lane 0xFFFFFFFF, the hash probe's pad value:
    with compression off the lane reaches the probe as it is, and the
    clip to the build's real rows must keep pads out of its range."""
    big = 2**31 - 1
    ld = {"k": [big, 3, big, 9, -5, big]}
    rd = {"k": [3, big, 4, big]}
    spec = [("k", "INT")]
    opts = {"merge.lane-compression": "false", "join.algorithm": algorithm}
    for how in ("inner", "left"):
        _, tres = _join_both(_both(spec, ld), _both(spec, rd), ["k"], how, engine, options=opts)
        olt, ort = oracle_pairs(_keys_of(ld, ["k"]), _keys_of(rd, ["k"]), how)
        np.testing.assert_array_equal(tres.left_take, olt)
        np.testing.assert_array_equal(tres.right_take, ort)
    assert tres.stats["lanes"] == 1


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("algorithm", ["hash", "sort-merge"])
def test_skewed_probe_under_small_chunk_rows(engine, algorithm):
    rng = np.random.default_rng(17)
    ld = {"k": SKEWS["hot50"](rng, 4000, 500).tolist()}
    rd = {"k": np.concatenate([rng.integers(0, 500, 600), [7, 7, 7]]).tolist()}
    spec = [("k", "BIGINT")]
    opts = {"join.chunk-rows": "512", "join.algorithm": algorithm}
    for how in ("inner", "left"):
        _, tres = _join_both(_both(spec, ld), _both(spec, rd), ["k"], how, engine, options=opts)
        assert tres.stats["partitions"] == 8 and tres.stats["skew_keys"] >= 1
        olt, ort = oracle_pairs(_keys_of(ld, ["k"]), _keys_of(rd, ["k"]), how)
        np.testing.assert_array_equal(tres.left_take, olt)
        np.testing.assert_array_equal(tres.right_take, ort)


@pytest.mark.parametrize("compress", ["true", "false"])
def test_lane_compression_on_and_off(compress):
    rng = np.random.default_rng(19)
    ld = {"a": rng.integers(0, 50, 1500).tolist(), "b": rng.integers(-(1 << 40), 1 << 40, 1500).tolist()}
    rd = {"a": ld["a"][:400], "b": ld["b"][:400]}
    spec = [("a", "INT"), ("b", "BIGINT")]
    for engine in ENGINES:
        _join_both(_both(spec, ld), _both(spec, rd), ["a", "b"], "left", engine, {"merge.lane-compression": compress})


@pytest.mark.parametrize("engine", ENGINES)
def test_empty_sides_and_null_keys(engine):
    spec = [("k", "BIGINT")]
    for ld, rd in (({"k": []}, {"k": [1, 2]}), ({"k": [1, 2]}, {"k": []}), ({"k": [None, 1]}, {"k": [None, 1]})):
        for how in ("inner", "left"):
            _, tres = _join_both(_both(spec, ld), _both(spec, rd), ["k"], how, engine)
            olt, ort = oracle_pairs(_keys_of(ld, ["k"]), _keys_of(rd, ["k"]), how)
            np.testing.assert_array_equal(tres.left_take, olt)
            np.testing.assert_array_equal(tres.right_take, ort)


def test_key_type_mismatch_raises():
    tl = _batch("port", [("k", "BIGINT")], {"k": [1]})
    tr = _batch("port", [("k", "STRING")], {"k": ["1"]})
    with pytest.raises(tjoin.JoinError, match="type mismatch"):
        tjoin.join_batches(tl, tr, ["k"], ["k"], device="cpu")
    with pytest.raises(tjoin.JoinError, match="unsupported join type"):
        tjoin.join_batches(tl, tl, ["k"], ["k"], how="outer", device="cpu")


def test_pallas_sort_merge_goes_through_k1_and_k2(monkeypatch):
    """Under engine "pallas" the sort-merge core takes K1 for a padded size
    that passes `fusable` and the stock sort plus K2 above it (the plain
    versions on the CPU, counted where the wrapper would launch)."""
    calls = {"k1": 0, "k2": 0}
    real_k1, real_k2 = hk.sort_segments_plain, hk.keep_last_mask_plain

    def k1(*a, **kw):
        calls["k1"] += 1
        return real_k1(*a, **kw)

    def k2(*a, **kw):
        calls["k2"] += 1
        return real_k2(*a, **kw)

    monkeypatch.setattr(hk, "sort_segments_plain", k1)
    monkeypatch.setattr(hk, "keep_last_mask_plain", k2)
    rng = np.random.default_rng(23)
    ld = {"k": rng.integers(0, 900, 3000).tolist()}
    rd = {"k": rng.integers(0, 900, 1000).tolist()}
    spec = [("k", "BIGINT")]
    opts = {"join.algorithm": "sort-merge"}
    _join_both(_both(spec, ld), _both(spec, rd), ["k"], "inner", "pallas", opts)
    assert calls == {"k1": 1, "k2": 0}
    monkeypatch.setattr(hk, "_FUSE_MAX_ROWS", 2048)  # 4,000 rows pad to 4,096
    _join_both(_both(spec, ld), _both(spec, rd), ["k"], "inner", "pallas", opts)
    assert calls == {"k1": 1, "k2": 1}


@pytest.mark.parametrize("keys", [["id"], ["s"], ["s", "id"]])
def test_join_index_probe_parity(keys):
    rng = np.random.default_rng(37)
    bd = {
        "id": rng.integers(0, 200, 600).tolist(),
        "s": [f"g{int(x)}" for x in rng.integers(0, 30, 600)],
        "v": [1.0] * 600,
    }
    # half the probe values lie outside the build's domain
    pd_ = {"id": rng.integers(0, 400, 2500).tolist(), "s": [f"g{int(x)}" for x in rng.integers(0, 60, 2500)]}
    jb, tb = _both([("id", "BIGINT"), ("s", "STRING"), ("v", "DOUBLE")], bd)
    jp, tp = _both([("id", "BIGINT"), ("s", "STRING")], pd_)
    jidx, tidx = jjoin.JoinIndex(jb, keys), tjoin.JoinIndex(tb, keys, device="cpu")
    for how in ("inner", "left"):
        jres, tres = jidx.probe(jp, keys, how=how), tidx.probe(tp, keys, how=how)
        np.testing.assert_array_equal(tres.left_take, jres.left_take)
        np.testing.assert_array_equal(tres.right_take, jres.right_take)
        olt, ort = oracle_pairs(_keys_of(pd_, keys), _keys_of(bd, keys), how)
        np.testing.assert_array_equal(tres.left_take, olt)
        np.testing.assert_array_equal(tres.right_take, ort)


def test_join_index_wide_key_falls_back():
    rng = np.random.default_rng(41)
    data = {
        "a": rng.integers(0, 1 << 40, 300).tolist(),
        "b": rng.integers(0, 1 << 40, 300).tolist(),
        "c": rng.integers(0, 1 << 40, 300).tolist(),
        "s": [f"x{int(v)}" for v in rng.integers(0, 50, 300)],
    }
    spec = [("a", "BIGINT"), ("b", "BIGINT"), ("c", "BIGINT"), ("s", "STRING")]
    jb, tb = _both(spec, data)
    keys = ["a", "b", "c", "s"]
    jidx, tidx = jjoin.JoinIndex(jb, keys), tjoin.JoinIndex(tb, keys, device="cpu")
    assert tidx.wide and jidx.wide
    for how in ("inner", "left"):
        jres, tres = jidx.probe(jb.slice(0, 50), keys, how=how), tidx.probe(tb.slice(0, 50), keys, how=how)
        np.testing.assert_array_equal(tres.left_take, jres.left_take)
        np.testing.assert_array_equal(tres.right_take, jres.right_take)


def test_join_index_null_and_empty_build():
    spec = [("s", "STRING")]
    for build in ({"s": [None, None]}, {"s": []}):
        jb, tb = _both(spec, build)
        jp, tp = _both(spec, {"s": ["a", None]})
        for how in ("inner", "left"):
            jres = jjoin.JoinIndex(jb, ["s"]).probe(jp, ["s"], how=how)
            tres = tjoin.JoinIndex(tb, ["s"], device="cpu").probe(tp, ["s"], how=how)
            np.testing.assert_array_equal(tres.left_take, jres.left_take)
            np.testing.assert_array_equal(tres.right_take, jres.right_take)


def test_materialize_join_left_matches_jax():
    rng = np.random.default_rng(43)
    ld = {"id": rng.integers(0, 60, 200).tolist(), "x": rng.random(200).tolist()}
    rd = {"id": list(range(40)), "name": [f"n{i}" if i % 5 else None for i in range(40)], "r": [float(i) for i in range(40)]}
    jl, tl = _both([("id", "BIGINT"), ("x", "DOUBLE")], ld)
    jr, tr = _both([("id", "BIGINT"), ("name", "STRING"), ("r", "DOUBLE")], rd)
    jres, tres = _join_both((jl, tl), (jr, tr), ["id"], "left", "numpy")
    lcols = [("id", "id"), ("x", "x")]
    rcols = [("id", "id_r"), ("name", "name"), ("r", "r")]
    jout = jjoin.materialize_join(jl, jr, jres, lcols, rcols)
    tout = tjoin.materialize_join(tl, tr, tres, lcols, rcols)
    assert tout.schema.field_names == jout.schema.field_names
    assert tout.to_pylist() == jout.to_pylist()


def test_engine_resolution_metrics_and_device():
    assert tjoin.resolve_join_engine(None, rows=10) == "numpy"
    assert tjoin.resolve_join_engine({"join.engine": "xla-segmented"}) == "xla"
    assert tjoin.resolve_join_engine({"join.engine": "numpy"}, rows=1 << 30) == "numpy"
    assert tjoin.resolve_join_engine(None, rows=5000) == "xla"
    assert tjoin.resolve_join_engine({"sort-engine": "pallas"}, rows=5000) == "pallas"
    assert tjoin.resolve_join_engine({"sort-engine": "pallas", "join.device-rows": "10000"}, rows=5000) == "numpy"
    registry.reset()
    tl = _batch("port", [("k", "BIGINT")], {"k": [1, 2, 2, 3]})
    tr = _batch("port", [("k", "BIGINT")], {"k": [2, 3, 4]})
    tjoin.join_batches(tl, tr, ["k"], ["k"], device="cpu")
    g = join_metrics()
    assert (g.counter("joins").count, g.counter("rows_probed").count, g.counter("rows_matched").count) == (1, 4, 3)
    assert g.counter("hash_joins").count == 1 and g.counter("code_domain_joins").count == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tjoin.join_batches(tl, tr, ["k"], ["k"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tjoin.JoinIndex(tr, ["k"])
