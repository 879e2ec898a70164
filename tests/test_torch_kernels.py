"""The port's two Hopper kernels, through their plain PyTorch versions on the
CPU, against the JAX package's Pallas kernels run in interpret mode.

Tolerance: exact. Every output is an integer (permutation, 0/1 masks,
sorted lane values), so equality is bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

import paimon_tpu.ops.pallas_kernels as pk
import paimon_tpu_torch.ops.hopper_kernels as hk

_WIDTHS = (1 << 2, 1 << 8, 1 << 16, 1 << 32)  # heavy ties through full u32 range


def _uint_lanes(rng, m: int, num_lanes: int):
    """Pad flag (pad rows last) plus num_lanes - 1 lanes of mixed u8/u16/u32
    dtypes and ranges."""
    pad = np.zeros(m, dtype=np.uint8)
    pad[m - max(1, m // 8) :] = 1
    lanes = [pad]
    for i in range(num_lanes - 1):
        hi = _WIDTHS[int(rng.integers(0, len(_WIDTHS)))]
        dt = np.uint8 if hi <= 256 else (np.uint16 if hi <= 1 << 16 else np.uint32)
        lanes.append(rng.integers(0, hi, m, dtype=np.uint64).astype(dt))
    return lanes


def _unflip(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32) ^ np.uint32(0x80000000)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("m", [128, 1024])
@pytest.mark.parametrize("num_lanes", [2, 3, 4, 5, 6, 7])
def test_sort_segments_plain_matches_pallas_fused(seed, m, num_lanes):
    """K1's plain version == JAX fused_sort_segments (interpret): perm,
    seg_start, keep_last, seg_id and the sorted pad lane, exactly."""
    rng = np.random.default_rng(1000 * seed + 10 * num_lanes + m)
    lanes = _uint_lanes(rng, m, num_lanes)
    num_order = int(rng.integers(0, num_lanes))  # trailing lanes order only
    nb = num_lanes - num_order
    assert pk.fusable(m, num_lanes) and hk.fusable(m, num_lanes)
    want = [np.asarray(x) for x in pk.fused_sort_segments([jax.numpy.asarray(x) for x in lanes[:nb]],
                                                          [jax.numpy.asarray(x) for x in lanes[nb:]])]
    tl = [torch.from_numpy(hk.flip_np(x)) for x in lanes]
    pad_sorted, perm, seg_start, keep_last, seg_id = hk.fused_sort_segments(tl[:nb], tl[nb:])
    assert (_unflip(pad_sorted) == want[0]).all()
    assert (perm.numpy() == want[1]).all()
    assert (seg_start.numpy() == want[2]).all()
    assert (keep_last.numpy() == want[3]).all()
    assert (seg_id.numpy() == want[4]).all()


@pytest.mark.parametrize("m", [1, 3, 127, 129, 200, 2047, 2049, 5000])
@pytest.mark.parametrize("mask_pad", [True, False])
def test_keep_last_mask_plain_matches_pallas(m, mask_pad):
    """K2's plain version == JAX keep_last_mask(interpret=True) at every m,
    including the synthetic-pad and last-row rules, in both modes."""
    rng = np.random.default_rng(m)
    keys = np.sort(rng.integers(0, max(2, m // 3), m)).astype(np.uint32)
    pad = np.zeros(m, dtype=np.uint32)
    pad[m - m // 5 :] = 1
    stacked = np.stack([pad, keys, rng.integers(0, 2, m).astype(np.uint32)])
    want = np.asarray(pk.keep_last_mask(stacked, interpret=True, mask_pad=mask_pad))
    got = hk.keep_last_mask(torch.from_numpy(stacked.view(np.int32)), mask_pad=mask_pad)
    assert got.dtype == torch.int32
    assert (got.numpy().astype(np.uint32) == want).all()


def _k2_lanes(rng, num_lanes: int, m: int, pattern: str) -> np.ndarray:
    """(num_lanes, m) uint32 sorted lanes, lane 0 the pad flag.
    `ends_every_4`: a segment ends at every 4th column (the edge of the
    CUDA kernel's 4-column groups), each step changing one lane, cycling
    over the key lanes. `pad_tail`: m // 5 pad rows last, key lanes of
    heavy ties, sorted."""
    if pattern == "ends_every_4":
        seg = np.arange(m) // 4
        stepping = list(range(1, num_lanes)) or [0]
        rows = np.zeros((num_lanes, m), dtype=np.uint32)
        for i, lane in enumerate(stepping):
            rows[lane] = (seg + len(stepping) - 1 - i) // len(stepping)
        return rows
    pad = (np.arange(m) >= m - m // 5).astype(np.uint32)
    keys = [rng.integers(0, 2, m).astype(np.uint32) for _ in range(num_lanes - 1)]
    order = np.lexsort(keys[::-1] + [pad])
    return np.stack([pad[order]] + [k[order] for k in keys])


@pytest.mark.parametrize("pattern", ["ends_every_4", "pad_tail"])
@pytest.mark.parametrize("m", [4, 5, 132, 4099])
@pytest.mark.parametrize("num_lanes", [1, 9])
def test_keep_last_mask_plain_matches_pallas_at_group_edges(num_lanes, m, pattern):
    """K2's plain version == JAX keep_last_mask(interpret=True) at one lane
    and at more lanes than the fused tier admits, at m around the CUDA
    kernel's 4-column groups, in both modes."""
    stacked = _k2_lanes(np.random.default_rng(m + num_lanes), num_lanes, m, pattern)
    for mask_pad in (True, False):
        want = np.asarray(pk.keep_last_mask(stacked, interpret=True, mask_pad=mask_pad))
        got = hk.keep_last_mask(torch.from_numpy(stacked.view(np.int32)), mask_pad=mask_pad)
        assert (got.numpy().astype(np.uint32) == want).all()


@pytest.mark.parametrize("shape", [(2, 4096), (3, 129)])
def test_keep_last_mask_misaligned_view_matches_aligned_copy(shape):
    """A contiguous view one column past a buffer's start (rows not 16-byte
    aligned, the CUDA kernel's scalar path) gives the aligned copy's mask."""
    x = torch.from_numpy(_k2_lanes(np.random.default_rng(7), shape[0], shape[1], "pad_tail").view(np.int32))
    buf = torch.empty(x.numel() + 1, dtype=torch.int32)
    view = buf[1:].view(shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    for mask_pad in (True, False):
        assert torch.equal(hk.keep_last_mask(view, mask_pad), hk.keep_last_mask(x.clone(), mask_pad))


def test_keep_last_mask_pad_contract():
    keys = np.array([1, 1, 2, 0, 0], dtype=np.uint32)
    pad = np.array([0, 0, 0, 1, 1], dtype=np.uint32)
    x = torch.from_numpy(np.stack([pad, keys]).view(np.int32))
    assert hk.keep_last_mask(x, mask_pad=True).tolist() == [0, 1, 1, 0, 0]
    assert hk.keep_last_mask(x, mask_pad=False).tolist() == [0, 1, 1, 0, 1]


@pytest.mark.parametrize("m", [2, 128, 4096, 1 << 18, 1 << 19, 4097])
@pytest.mark.parametrize("num_lanes", [1, 3, 7, 8])
def test_fusable_admission_matches_jax(m, num_lanes):
    """Both packages pick the same tier for the same batch."""
    assert hk.fusable(m, num_lanes) == pk.fusable(m, num_lanes)


def test_plain_versions_do_not_count_launches():
    hk.reset_launches()
    x = torch.from_numpy(np.stack([hk.flip_np(np.zeros(128, np.uint32)), np.arange(128, dtype=np.int32)]))
    hk.sort_segments(x, 1)
    hk.keep_last_mask(x, mask_pad=False)
    assert hk.launches == {"sort_segments": 0, "keep_last_mask": 0}


class _CudaTensorStandIn:
    """Duck-types a contiguous int32 CUDA tensor, so the wrappers' device
    routing is exercised on a machine without a GPU."""

    dtype = torch.int32
    device = torch.device("cuda", 0)

    def __init__(self, shape):
        self.shape = shape

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True


@pytest.mark.parametrize("kernel", ["sort_segments", "keep_last_mask"])
def test_cuda_tensor_without_gpu_raises_instead_of_falling_back(monkeypatch, kernel):
    """A CUDA tensor never reaches a plain version: without the toolkit or a
    card the wrapper raises."""
    monkeypatch.setattr(hk, "_KERNELS", {})
    monkeypatch.setattr(hk, "_BUILD", "/nonexistent-paimon-build-dir")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda-home")
    monkeypatch.setattr(hk.shutil, "which", lambda name: None)
    monkeypatch.setattr(hk, "sort_segments_plain", lambda *a: pytest.fail("fell back to the plain version"))
    monkeypatch.setattr(hk, "keep_last_mask_plain", lambda *a: pytest.fail("fell back to the plain version"))
    x = _CudaTensorStandIn((3, 128))
    before = dict(hk.launches)
    with pytest.raises(RuntimeError):
        if kernel == "sort_segments":
            hk.sort_segments(x, 2)
        else:
            hk.keep_last_mask(x, mask_pad=False)
    assert hk.launches == before  # a refused launch never counts


@pytest.mark.parametrize("bad", [torch.zeros((2, 8), dtype=torch.int64), torch.zeros(8, dtype=torch.int32)])
def test_wrappers_reject_bad_inputs(bad):
    with pytest.raises(ValueError):
        hk.keep_last_mask(bad)
    with pytest.raises(ValueError):
        hk.sort_segments(bad, 1)


# ---------------------------------------------------------------------------
# K1: the sizes and key patterns its block sort and merge rounds treat apart,
# and its tile
# ---------------------------------------------------------------------------

_K1_PATTERNS = ("mixed", "equal", "sorted", "reverse")


def _pattern_lanes(rng, m: int, num_lanes: int, pattern: str):
    """Pad flag (pad rows last) plus num_lanes - 1 uint32 lanes: mixed
    widths with heavy ties, all equal (only pad and iota differ), sorted or
    reverse-sorted (ties grow with the lane)."""
    if pattern == "mixed":
        return _uint_lanes(rng, m, num_lanes)
    pad = np.zeros(m, dtype=np.uint32)
    pad[m - max(1, m // 8) :] = 1
    lanes = [pad]
    for i in range(num_lanes - 1):
        ramp = np.arange(m, dtype=np.uint32) >> np.uint32(i)
        lanes.append({"equal": np.full(m, 7, np.uint32), "sorted": ramp, "reverse": ramp[::-1].copy()}[pattern])
    return lanes


@pytest.mark.parametrize("pattern", _K1_PATTERNS)
@pytest.mark.parametrize("m, num_boundary", [(2, 1), (4, 3), (32, 1), (32, 3)])
def test_sort_segments_plain_matches_pallas_patterns(pattern, m, num_boundary):
    """K1's plain version == JAX fused_sort_segments (interpret) at the
    sizes the block sort treats apart (m under one thread's columns, m one
    warp's shuffle span), for each key pattern, with one boundary lane and
    with every lane but the iota one (nl - 1) splitting segments."""
    num_lanes = 3
    lanes = _pattern_lanes(np.random.default_rng(m), m, num_lanes, pattern)
    nb = num_boundary
    want = [np.asarray(x) for x in pk.fused_sort_segments([jax.numpy.asarray(x) for x in lanes[:nb]],
                                                          [jax.numpy.asarray(x) for x in lanes[nb:]])]
    tl = [torch.from_numpy(hk.flip_np(x)) for x in lanes]
    got = hk.fused_sort_segments(tl[:nb], tl[nb:])
    assert (_unflip(got[0]) == want[0]).all()
    for g, w in zip(got[1:], want[1:]):
        assert (g.numpy() == w).all()


def test_k1_tile_matches_the_cuda_source():
    """The wrapper sizes K1's scratch from the same tile the kernel sorts."""
    import re

    with open(hk.os.path.join(hk._CSRC, hk.KERNEL_SOURCES["sort_segments"])) as f:
        src = f.read()
    assert int(re.search(r"constexpr int TILE = (\d+);", src).group(1)) == hk.K1_TILE


def test_k1_tile_fills_the_card_at_the_read_shape():
    """At the read-tile shape (3, 2^17) the block sort puts at least one
    block on each of the H100's 132 SMs."""
    assert (1 << 17) // hk.K1_TILE >= 132


@pytest.mark.parametrize("shape", [(3, 1 << 19), (9, 128), (3, 96)])
def test_sort_segments_refuses_unadmitted_cuda_shapes(monkeypatch, shape):
    """A CUDA tensor outside K1's contract (m over 2^18, more than 8 lanes,
    m not a power of two) is refused before any build or launch."""
    monkeypatch.setattr(hk, "_kernel", lambda name: pytest.fail("reached the kernel"))
    before = dict(hk.launches)
    with pytest.raises(ValueError):
        hk.sort_segments(_CudaTensorStandIn(shape), 2)
    assert hk.launches == before
