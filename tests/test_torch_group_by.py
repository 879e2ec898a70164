"""The GROUP BY reduce and the value-domain dictionary helpers of the port
(paimon_tpu_torch/ops/aggregates.py segment_reduce and segment_reduce_np,
paimon_tpu_torch/ops/dicts.py) against the JAX package's, on the CPU
(device="cpu").

- segment_reduce at the three engines: the JAX package runs "numpy", "xla"
  and "pallas" (its Pallas kernels in interpret mode, as its own tests run
  them); the port runs the same engine names on device="cpu", where "xla"
  is plain torch ops and "pallas" the plain versions of K1, K2 and
  segment_sum behind their wrappers. The pallas engine is run at both
  tiers: K1, and the stock sort + K2 reached by lowering the admission cap
  in both packages. Inputs: one, two and three key lanes (one of them
  holding the NULL sentinel), int64, int32 and int8 sums and counts,
  float64 and float32 sums, minima and maxima with NaN, -0.0, +0.0 and the
  infinities, invalid rows and groups with no valid row, custom positions,
  an empty input, one row, a single group (no key lane left after lane
  compression) and lane compression off.
- segment_reduce_np directly; the sql{rows_reduced_device} counter; the
  CUDA default raising without a GPU.
- sort_dictionary, unify_pools, remap_codes (host and torch gather),
  unify_columns, encode_column (numbers, strings, nulls, an unsortable
  mixed column, all-null and empty columns) and prune_pool.

Tolerance: exact. Indices, masks and integers must be equal; floats bit
for bit (so -0.0 differs from +0.0). The one allowance: a NaN equals any
NaN, since the two packages may produce other NaN payloads for one sum.
"""

import zlib

import numpy as np
import pytest
import torch

import paimon_tpu.data.batch as jbatch
import paimon_tpu.ops.pallas_kernels as pk
import paimon_tpu_torch.data.batch as tbatch
from paimon_tpu.ops import aggregates as jagg
from paimon_tpu.ops import dicts as jdicts
from paimon_tpu_torch.metrics import registry, sql_metrics
from paimon_tpu_torch.ops import aggregates as tagg
from paimon_tpu_torch.ops import dicts as tdicts
from paimon_tpu_torch.ops import hopper_kernels as hk

ENGINES = ("numpy", "xla", "pallas")
SPECIALS = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5, -2.25])


def same(a, b) -> bool:
    """Equal; floats bit for bit, any NaN equal to any NaN."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return False
    if a.dtype.kind != "f":
        return a.tolist() == b.tolist()
    if a.dtype != b.dtype:
        return False
    i = f"i{a.itemsize}"
    return bool(((a.view(i) == b.view(i)) | (np.isnan(a) & np.isnan(b))).all())


@pytest.fixture
def sweep_tier(monkeypatch):
    """Lower the fused-kernel row cap in both packages so test-size batches
    take the stock sort + K2 tier."""
    monkeypatch.setattr(pk, "_FUSE_MAX_ROWS", 1)
    monkeypatch.setattr(hk, "_FUSE_MAX_ROWS", 1)


@pytest.fixture
def kernel_calls(monkeypatch):
    """Calls of each plain kernel version: the CPU stand-in for a launch."""
    calls = dict.fromkeys(hk.KERNEL_SOURCES, 0)
    for name in calls:
        real = getattr(hk, f"{name}_plain")

        def counted(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)

        monkeypatch.setattr(hk, f"{name}_plain", counted)
    return calls


def _lanes(rng, case: str, n: int) -> np.ndarray:
    if case == "single_group":
        return np.full((n, 2), 9, np.uint32)
    if case == "one_lane":
        return rng.integers(0, max(2, n // 5), (n, 1)).astype(np.uint32)
    if case == "three_lanes":
        lanes = np.stack([rng.integers(0, 3, n), rng.integers(0, 4, n), rng.integers(0, 5, n)], axis=1)
        lanes[rng.random(n) < 0.1, 1] = 4  # the NULL sentinel of a 4-value pool
        return lanes.astype(np.uint32)
    return np.stack([rng.integers(0, 4, n), rng.integers(0, max(2, n // 6), n)], axis=1).astype(np.uint32)


def _columns(rng, n: int):
    """(columns, fns): every dtype and function the SQL plan sends."""
    f64 = rng.normal(size=n) * 100
    f64 = np.where(rng.random(n) < 0.15, SPECIALS[rng.integers(0, len(SPECIALS), n)], f64)
    f32 = f64.astype(np.float32)
    i64 = rng.integers(-(1 << 40), 1 << 40, n)
    i64[: min(n, 2)] = [np.iinfo(np.int64).max, np.iinfo(np.int64).min][: min(n, 2)]
    i32 = rng.integers(-1000, 1000, n).astype(np.int32)
    i8 = rng.integers(-100, 100, n).astype(np.int8)
    sparse = rng.random(n) < 0.5
    invalid_group = rng.random(n) < 0.97  # most groups of this column have no valid row
    cols = [
        (np.ones(n, np.int64), None, "sum"),  # count(*)
        (np.ones(n, np.int64), sparse, "sum"),  # count(col)
        (i64, sparse, "sum"),
        (i32, None, "sum"),
        (i8, sparse, "sum"),
        (f64, sparse, "sum"),
        (f32, None, "sum"),
        (f64, sparse, "min"),
        (f64, None, "max"),
        (f32, sparse, "max"),
        (f32, ~invalid_group, "min"),
        (i64, sparse, "min"),
        (i32, ~invalid_group, "max"),
        (i8, None, "min"),
    ]
    return [(v, ok) for v, ok, _ in cols], tuple(fn for _, _, fn in cols)


def _assert_same_reduce(got, want, what: str) -> None:
    rep, outs, anyv, first = got
    jrep, jouts, janyv, jfirst = want
    assert same(rep, jrep), f"{what}: rep"
    assert same(first, jfirst), f"{what}: first_pos"
    assert len(outs) == len(jouts)
    for i, (o, jo, a, ja) in enumerate(zip(outs, jouts, anyv, janyv)):
        assert o.dtype == np.asarray(jo).dtype, f"{what}: column {i} dtype {o.dtype} != {np.asarray(jo).dtype}"
        assert same(a, ja), f"{what}: anyv of column {i}"
        assert same(o, jo), f"{what}: column {i}"


CASES = ("random", "one_lane", "three_lanes", "single_group", "one_row", "empty")
TIERS = [("numpy", "fused"), ("xla", "fused"), ("pallas", "fused"), ("pallas", "sweep")]


@pytest.mark.parametrize("engine,tier", TIERS, ids=["numpy", "xla", "pallas-fused", "pallas-sweep"])
@pytest.mark.parametrize("case", CASES)
def test_segment_reduce_matches_jax(request, engine, tier, case):
    if tier == "sweep":
        request.getfixturevalue("sweep_tier")
    rng = np.random.default_rng(zlib.crc32(f"{engine}/{case}".encode()))
    n = {"one_row": 1, "empty": 0}.get(case, 700)
    lanes = _lanes(rng, "random" if case in ("one_row", "empty") else case, n)
    cols, fns = _columns(rng, n)
    want = jagg.segment_reduce(lanes, cols, fns, engine=engine)
    got = tagg.segment_reduce(lanes, cols, fns, engine=engine, device="cpu")
    _assert_same_reduce(got, want, f"{engine}/{tier}/{case}")
    if case in ("random", "three_lanes"):
        assert len(got[0]) > 1


@pytest.mark.parametrize("engine", ENGINES)
def test_segment_reduce_positions_and_no_compression(engine):
    rng = np.random.default_rng(31)
    n = 300
    lanes = _lanes(rng, "random", n)
    cols, fns = _columns(rng, n)
    pos = rng.permutation(10 * n)[:n].astype(np.int64)
    for compress in (False, True):
        want = jagg.segment_reduce(lanes, cols, fns, pos=pos, engine=engine, compress=compress)
        got = tagg.segment_reduce(lanes, cols, fns, pos=pos, engine=engine, compress=compress, device="cpu")
        _assert_same_reduce(got, want, f"{engine}/compress={compress}")


def test_segment_reduce_np_matches_jax():
    rng = np.random.default_rng(5)
    lanes = _lanes(rng, "three_lanes", 500)
    cols, fns = _columns(rng, 500)
    filled = [(v, np.ones(500, np.bool_) if ok is None else ok) for v, ok in cols]
    pos = np.arange(500, dtype=np.int64)
    _assert_same_reduce(tagg.segment_reduce_np(lanes, filled, fns, pos),
                        jagg.segment_reduce_np(lanes, filled, fns, pos), "numpy twin")


@pytest.mark.parametrize("tier", ["fused", "sweep"])
def test_segment_reduce_pallas_runs_the_kernels(request, tier, kernel_calls):
    """Engine pallas goes through K1 (fused tier) or K2 (sweep tier), engine
    xla through neither; at both, float sums go through segment_sum (the
    port's _Sorted.sum, shared with the aggregation engine)."""
    if tier == "sweep":
        request.getfixturevalue("sweep_tier")
    rng = np.random.default_rng(8)
    lanes = _lanes(rng, "random", 400)
    cols, fns = _columns(rng, 400)
    float_sums = sum(1 for (v, _), fn in zip(cols, fns) if fn == "sum" and v.dtype.kind == "f")
    tagg.segment_reduce(lanes, cols, fns, engine="xla", device="cpu")
    assert kernel_calls == {"sort_segments": 0, "keep_last_mask": 0, "segment_sum": float_sums}
    tagg.segment_reduce(lanes, cols, fns, engine="pallas", device="cpu")
    assert kernel_calls["sort_segments" if tier == "fused" else "keep_last_mask"] == 1
    assert kernel_calls["keep_last_mask" if tier == "fused" else "sort_segments"] == 0
    assert kernel_calls["segment_sum"] == 2 * float_sums


def test_segment_reduce_counts_device_rows():
    registry.reset()
    rng = np.random.default_rng(2)
    lanes = _lanes(rng, "random", 250)
    cols, fns = _columns(rng, 250)
    tagg.segment_reduce(lanes, cols, fns, engine="numpy", device="cpu")
    assert sql_metrics().counter("rows_reduced_device").count == 0
    tagg.segment_reduce(lanes, cols, fns, engine="xla", device="cpu")
    assert sql_metrics().counter("rows_reduced_device").count == 250


def test_segment_reduce_cuda_default_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    lanes = np.stack([np.arange(10), np.arange(10) % 3], axis=1).astype(np.uint32)
    with pytest.raises(RuntimeError):
        tagg.segment_reduce(lanes, [(np.ones(10, np.int64), None)], ("sum",))


# ---------------------------------------------------------------------------
# ops/dicts.py
# ---------------------------------------------------------------------------


def _pools(rng):
    words = np.array([f"w{i:03d}" for i in rng.integers(0, 400, 300)], dtype=object)
    return {
        "strings": [np.unique(words[:120]).astype(object), np.unique(words[100:250]).astype(object),
                    np.unique(words[240:]).astype(object)],
        "ints": [np.unique(rng.integers(0, 500, 80)), np.unique(rng.integers(200, 900, 90))],
        "same": [np.array(["a", "b", "c"], dtype=object), np.array(["a", "b", "c"], dtype=object)],
        "with_empty": [np.array([], dtype=object), np.array(["x", "y"], dtype=object)],
    }


@pytest.mark.parametrize("kind", ["strings", "ints", "same", "with_empty"])
def test_unify_pools_and_remap_match_jax(kind):
    rng = np.random.default_rng(11)
    pools = _pools(rng)[kind]
    got_pool, got_maps = tdicts.unify_pools(pools)
    want_pool, want_maps = jdicts.unify_pools(pools)
    assert same(got_pool, want_pool) and got_pool.dtype == want_pool.dtype
    for g, w, p in zip(got_maps, want_maps, pools):
        assert (g is None) == (w is None)
        codes = rng.integers(0, max(len(p), 1), 50).astype(np.uint32) if len(p) else np.zeros(0, np.uint32)
        want = jdicts.remap_codes(w, codes)
        assert same(tdicts.remap_codes(g, codes), want)
        if g is not None and len(codes):
            t = tdicts.remap_codes(g, torch.from_numpy(codes.astype(np.int64)))
            assert isinstance(t, torch.Tensor) and same(t.numpy(), want)
    # unify_columns: the concatenation of every input's remapped codes
    pairs = [(p, rng.integers(0, max(len(p), 1), 20).astype(np.uint32) if len(p) else np.zeros(0, np.uint32))
             for p in pools]
    pool, codes = tdicts.unify_columns(pairs)
    assert same(pool, want_pool)
    assert same(codes, np.concatenate([jdicts.remap_codes(w, c) for w, (_, c) in zip(want_maps, pairs)]))


def test_unify_columns_refuses_past_the_limit():
    pools = [np.array(["a", "b"], dtype=object), np.array(["c", "d"], dtype=object)]
    pairs = [(p, np.array([0, 1], np.uint32)) for p in pools]
    assert tdicts.unify_columns(pairs, limit=3) is None
    assert tdicts.unify_columns(pairs, limit=4) is not None


@pytest.mark.parametrize("kind", ["strings", "ints", "dates", "empty"])
def test_sort_dictionary_matches_jax(kind):
    rng = np.random.default_rng(3)
    data = {
        "strings": np.array([f"s{i}" for i in rng.integers(0, 40, 60)], dtype=object),
        "ints": rng.integers(-50, 50, 60),
        "dates": rng.integers(0, 20000, 60).astype(np.int32),
        "empty": np.array([], dtype=object),
    }[kind]
    gp, gr = tdicts.sort_dictionary(data)
    wp, wr = jdicts.sort_dictionary(data)
    assert same(gp, wp) and gp.dtype == wp.dtype and same(gr, wr) and gr.dtype == wr.dtype


def _column_cases(rng):
    n = 200
    strings = np.array([f"k{i}" for i in rng.integers(0, 30, n)], dtype=object)
    nulls = rng.random(n) < 0.2
    return {
        "int64": (rng.integers(-5, 5, n), None, "BIGINT"),
        "int64_nulls": (rng.integers(-5, 5, n), ~nulls, "BIGINT"),
        "double_nulls": (np.round(rng.normal(size=n), 1), ~nulls, "DOUBLE"),
        "strings": (strings, None, "STRING"),
        "strings_nulls": (strings, ~nulls, "STRING"),
        "all_null": (np.zeros(n, np.int64), np.zeros(n, np.bool_), "BIGINT"),
        "empty": (np.zeros(0, dtype=object), None, "STRING"),
        "mixed_objects": (np.array([1, "a", 2.5, "a", 1, None] * 5, dtype=object), None, "STRING"),
    }


@pytest.mark.parametrize("case", ["int64", "int64_nulls", "double_nulls", "strings", "strings_nulls", "all_null",
                                  "empty", "mixed_objects"])
def test_encode_column_matches_jax(case):
    values, validity, _ = _column_cases(np.random.default_rng(4))[case]
    if case == "mixed_objects":
        validity = np.array([v is not None for v in values])
    gp, gc = tdicts.encode_column(tbatch.Column(values, validity))
    wp, wc = jdicts.encode_column(jbatch.Column(values, None if validity is None or validity.all() else validity))
    assert same(gp, wp) and gp.dtype == wp.dtype
    assert same(gc, wc) and gc.dtype == wc.dtype == np.uint32
    assert tdicts.cache_usable(tbatch.Column(values, validity)) is False


@pytest.mark.parametrize("validity", [None, "some"])
def test_prune_pool_matches_jax(validity):
    rng = np.random.default_rng(6)
    pool = np.array([f"p{i:02d}" for i in range(40)], dtype=object)
    codes = rng.choice(np.arange(0, 40, 3), 100).astype(np.uint32)
    valid = None if validity is None else rng.random(100) < 0.7
    gp, gc = tdicts.prune_pool(pool, codes, valid)
    wp, wc = jdicts.prune_pool(pool, codes, valid)
    assert same(gp, wp) and same(gc, wc)
    full = np.arange(40, dtype=np.uint32)
    gp, gc = tdicts.prune_pool(pool, full)
    assert gp is pool and same(gc, full)
    assert same(tdicts.prune_pool(np.array([], dtype=object), np.zeros(0, np.uint32))[1], np.zeros(0, np.uint32))
