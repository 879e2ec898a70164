"""The port's merge ops (paimon_tpu_torch/ops) against the JAX package's on
the same numpy inputs: sorted_segments, merge_plan, the dedup selection
(single and key-range tiled) across sort engines numpy / xla / pallas, lane
compression on and off, with and without sequence lanes, and both pallas
tiers (the fused K1 tier, and the stock sort + K2 sweep tier reached by
lowering the admission cap in both packages). Also the OVC lane and the
lane planner.

Tolerance: exact. Every output is an integer index, mask or lane value.
"""

import jax
import numpy as np
import pytest
import torch

import paimon_tpu.ops.pallas_kernels as pk
import paimon_tpu_torch.ops.hopper_kernels as hk
from paimon_tpu.core.mergefn import _numpy_dedup_select as jax_numpy_dedup
from paimon_tpu.ops import lanes as JL
from paimon_tpu.ops import merge as JM
from paimon_tpu_torch.core.mergefn import _numpy_dedup_select as port_numpy_dedup
from paimon_tpu_torch.ops import lanes as TL
from paimon_tpu_torch.ops import merge as TM


def _rand_lanes(rng, n, shape):
    """Key-lane matrices the planner narrows/packs differently."""
    if shape == "one":
        return rng.integers(0, max(2, n // 2), (n, 1)).astype(np.uint32)
    if shape == "two":
        a = rng.integers(0, 50, n).astype(np.uint32)
        b = rng.integers(0, 1 << 20, n).astype(np.uint32)
        return np.stack([a, b], axis=1)
    a = rng.integers(0, 9, n).astype(np.uint32)
    b = rng.integers(0, 3, n).astype(np.uint32)
    c = rng.integers(0, 1 << 30, n).astype(np.uint32)
    d = rng.integers(0, 100, n).astype(np.uint32)
    return np.stack([a, b, c, d], axis=1)


@pytest.fixture
def sweep_tier(monkeypatch):
    """Lower the fused-kernel row cap in both packages so test-size batches
    take the stock sort + boundary-sweep tier."""
    monkeypatch.setattr(pk, "_FUSE_MAX_ROWS", 1)
    monkeypatch.setattr(hk, "_FUSE_MAX_ROWS", 1)


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts calls of each plain kernel version (the CPU stand-in for a
    launch), so a test can show which tier served it."""
    calls = {"sort_segments": 0, "keep_last_mask": 0}
    real_k1, real_k2 = hk.sort_segments_plain, hk.keep_last_mask_plain

    def k1(*a):
        calls["sort_segments"] += 1
        return real_k1(*a)

    def k2(*a):
        calls["keep_last_mask"] += 1
        return real_k2(*a)

    monkeypatch.setattr(hk, "sort_segments_plain", k1)
    monkeypatch.setattr(hk, "keep_last_mask_plain", k2)
    return calls


def _jax_sorted_segments(k, s, kl, sl, pad, engine):
    @jax.jit
    def f(kl, sl, pad):
        return JM.sorted_segments(k, s, kl, sl, pad, engine=engine)

    return [np.asarray(x) for x in f(kl, sl, pad)]


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("tier", ["fused", "sweep"])
@pytest.mark.parametrize("num_seq", [0, 1])
def test_sorted_segments_matches_jax(request, kernel_calls, seed, tier, num_seq):
    if tier == "sweep":
        request.getfixturevalue("sweep_tier")
    rng = np.random.default_rng(10 * seed + num_seq)
    n = int(rng.integers(5, 1500))
    lanes = _rand_lanes(rng, n, "two")
    m = TM.pad_size(n)
    kl = np.full((2, m), 0xFFFFFFFF, dtype=np.uint32)
    kl[:, :n] = lanes.T
    sl = np.zeros((num_seq, m), dtype=np.uint32)
    sl[:, :n] = rng.permutation(n)
    pad = np.zeros(m, dtype=np.uint32)
    pad[n:] = 1
    for engine in ("xla", "pallas"):
        want = _jax_sorted_segments(2, num_seq, kl, sl, pad, engine)
        got = TM.sorted_segments(
            2, num_seq, TM.upload_lanes(list(kl), "cpu"), TM.upload_lanes(list(sl), "cpu"),
            TM.upload_lanes([pad], "cpu")[0], engine=engine,
        )
        assert (got[0].numpy().view(np.uint32) ^ np.uint32(0x80000000) == want[0]).all()
        for g, w in zip(got[1:], want[1:]):
            assert (g.numpy() == w).all()
    assert kernel_calls["sort_segments" if tier == "fused" else "keep_last_mask"] == 1
    assert kernel_calls["keep_last_mask" if tier == "fused" else "sort_segments"] == 0


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("shape", ["one", "four"])
@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("with_seq", [False, True])
def test_merge_plan_matches_jax(seed, shape, compress, with_seq):
    rng = np.random.default_rng(300 + seed)
    n = int(rng.integers(10, 1500))
    lanes = _rand_lanes(rng, n, shape)
    seq = rng.permutation(n).astype(np.uint32).reshape(-1, 1) if with_seq else None
    for engine in ("xla", "pallas"):
        want = JM.merge_plan(lanes, seq, compress=compress, engine=engine)
        got = TM.merge_plan(lanes, seq, compress=compress, engine=engine, device="cpu")
        assert (got.n, got.m) == (want.n, want.m)
        for f in ("perm", "seg_start", "keep_last", "seg_id"):
            assert (getattr(got, f) == np.asarray(getattr(want, f))).all(), (engine, f)
        assert (TM.deduplicate_take(got) == JM.deduplicate_take(want)).all()


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("shape", ["one", "two", "four"])
@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("with_seq", [False, True])
@pytest.mark.parametrize("tier", ["fused", "sweep"])
def test_dedup_select_matches_jax_all_engines(request, seed, shape, compress, with_seq, tier):
    if tier == "sweep":
        request.getfixturevalue("sweep_tier")
    rng = np.random.default_rng(100 * seed + len(shape))
    n = int(rng.integers(3, 2000))
    lanes = _rand_lanes(rng, n, shape)
    seq = rng.permutation(n).astype(np.uint32).reshape(-1, 1) if with_seq else None
    oracle = np.asarray(jax_numpy_dedup(lanes, seq, compress=compress))
    assert port_numpy_dedup(lanes, seq, compress).tolist() == oracle.tolist()
    for backend in ("xla", "pallas"):
        want = JM.deduplicate_resolve(JM.deduplicate_select_async(lanes, seq, backend=backend, compress=compress))
        got = TM.deduplicate_resolve(TM.deduplicate_select_async(lanes, seq, backend, compress, "cpu"))
        assert got.tolist() == np.asarray(want).tolist() == oracle.tolist(), backend


def _runs(rng, n_runs, per_run, key_space):
    """Key-sorted runs with unique keys per run, overlapping across runs."""
    runs = [np.sort(rng.choice(key_space, per_run, replace=False)).astype(np.int64) for _ in range(n_runs)]
    keys = np.concatenate(runs)
    hi = (keys >> 32).astype(np.uint32)
    lo = (keys & 0xFFFFFFFF).astype(np.uint32)
    offsets = np.cumsum([0] + [len(r) for r in runs]).tolist()
    return np.stack([hi, lo], axis=1), offsets


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("tier", ["fused", "sweep"])
def test_tiled_dispatch_matches_jax(request, monkeypatch, kernel_calls, seed, compress, tier):
    """Key-range tiles (several per merge) through the tiled dispatcher. The
    JAX side takes the plain index download, the path the port mirrors: its
    compact encoding treats a tile as one key-sorted run, which a tile cut
    from several runs is not, and then returns the winners in input order
    under sort-engine=pallas."""
    monkeypatch.setenv("PAIMON_TPU_FORCE_COMPACT", "0")
    if tier == "sweep":
        request.getfixturevalue("sweep_tier")
    rng = np.random.default_rng(500 + seed)
    lanes, offsets = _runs(rng, 4, 700, 5000)
    for backend in ("xla", "pallas"):
        want = JM.deduplicate_select_tiled(lanes, offsets, tile_rows=512, backend=backend, compress=compress)
        handles = TM.deduplicate_tiled_dispatch(lanes, offsets, 512, backend, compress, "cpu")
        assert len(handles) > 2
        got = TM.deduplicate_resolve_tiled(handles)
        assert got.tolist() == np.asarray(want).tolist(), backend
    oracle = jax_numpy_dedup(lanes, None, compress=compress)
    assert got.tolist() == np.asarray(oracle).tolist()
    assert kernel_calls["sort_segments" if tier == "fused" else "keep_last_mask"] >= 3


@pytest.mark.parametrize("seed", range(4))
def test_ovc_codes_match_jax_and_numpy(seed):
    rng = np.random.default_rng(700 + seed)
    n = int(rng.integers(500, 3000))
    lanes = _rand_lanes(rng, n, "four")
    plan = TL.plan_lanes(lanes)
    packed = TL.apply_plan(plan, lanes)
    assert plan.use_ovc  # three packed operands: the planner adds the code lane
    want_np = JL.ovc_codes_np(packed, plan.base, plan.ovc_vbits)
    want_jax = np.asarray(
        JL.ovc_codes_jax([jax.numpy.asarray(packed[:, g]) for g in range(packed.shape[1])],
                         jax.numpy.asarray(np.asarray(plan.base, dtype=np.uint32)), plan.ovc_vbits)
    )
    got = TL.ovc_codes([torch.from_numpy(hk.flip_np(packed[:, g])) for g in range(packed.shape[1])],
                       plan.base, plan.ovc_vbits)
    got_u = got.numpy().view(np.uint32) ^ np.uint32(0x80000000)
    assert (TL.ovc_codes_np(packed, plan.base, plan.ovc_vbits) == want_np).all()
    assert (got_u == want_np).all() and (got_u == want_jax).all()


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("shape", ["one", "two", "four"])
@pytest.mark.parametrize("enable_ovc", [False, True])
def test_compress_key_lanes_matches_jax(seed, shape, enable_ovc):
    rng = np.random.default_rng(900 + seed)
    lanes = _rand_lanes(rng, int(rng.integers(1, 2000)), shape)
    want, wplan = JL.compress_key_lanes(lanes, True, enable_ovc=enable_ovc)
    got, gplan = TL.compress_key_lanes(lanes, True, enable_ovc=enable_ovc)
    assert got.dtype == want.dtype and (got == want).all()
    for f in ("lanes_in", "keep", "los", "bits", "groups", "use_ovc", "ovc_vbits", "base"):
        assert getattr(gplan, f) == getattr(wplan, f), f
    assert TL.compress_key_lanes(lanes, False)[1] is None


def test_scalar_winner_matches_jax():
    lanes = np.full((50, 2), 7, dtype=np.uint32)
    seq = np.random.default_rng(3).permutation(50).astype(np.uint32).reshape(-1, 1)
    for s in (None, seq):
        want = JM.deduplicate_resolve(JM.deduplicate_select_async(lanes, s, backend="xla", compress=True))
        got = TM.deduplicate_select(lanes, s, True, "pallas", "cpu")
        assert got.tolist() == np.asarray(want).tolist()
