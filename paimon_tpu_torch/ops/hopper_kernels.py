"""The merge hot path's kernels, hand-written in CUDA for Hopper (port of
paimon_tpu/ops/pallas_kernels.py, and one XLA program of the aggregation
engine).

K1 `sort_segments` (csrc/sort_segments.cu) replaces the Pallas kernel of
`fused_sort_segments`: a stable lexicographic sort of the stacked
(pad, [OVC], key, seq, iota) lanes plus the keep-last boundary mask, for
batches that pass the `fusable` admission test. It runs as one block sort
(registers and warp shuffles, K1_TILE columns per block) and log2(m/K1_TILE)
merge-path rounds, the last of which writes the output. K2 `keep_last_mask`
(csrc/keep_last.cu) replaces the Pallas boundary sweep that runs after the
stock stable sort on larger batches: 16-byte loads of four columns a thread,
the next column by warp shuffle, a grid the size of what the card holds.

A third kernel, `segment_sum` (csrc/segment_sum.cu), replaces no Pallas
kernel: it is the float case of the JAX package's jax.ops.segment_sum in the
aggregation engine, an XLA program, written by hand because XLA on the CPU
adds each segment's rows in sorted order and torch's atomic scatter-adds do
not (their float sums change from run to run).

Beside each kernel sits its plain PyTorch version. A wrapper takes the
plain version only for a tensor on the CPU; for a CUDA tensor it launches
the kernel or raises, never falls back. `launches` counts kernel launches
per kernel (plain versions do not count).

Lanes on the device are int32 tensors holding the order-preserving flip of
each uint32 lane, u ^ 0x80000000 read as signed (`flip_np`), because torch
has no ordered compare on uint32: signed order of the flipped values is the
unsigned order of the lanes, and equality is unchanged.

The kernels build at first use with nvcc for sm_90a into
paimon_tpu_torch/_build/ (one shared library per source, all sources
compiled in parallel, rebuilt when a source's hash changes) and load via
ctypes with a plain C interface, each entry bound once; one lock guards
the build and the binding, so threads that first launch at once (the
adaptive compactor's and a writer's) build once. A launch makes the
tensor's device current only when it is not, and takes the current stream
as a raw pointer, so a call costs the host little more than the launch.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

__all__ = [
    "fusable",
    "flip_np",
    "lexsort_lanes",
    "sort_segments",
    "sort_segments_plain",
    "fused_sort_segments",
    "keep_last_mask",
    "keep_last_mask_plain",
    "segment_sum",
    "segment_sum_plain",
    "K1_TILE",
    "build_kernels",
    "build_log",
    "launches",
    "reset_launches",
    "KERNEL_SOURCES",
]

# fused-kernel admission, the JAX package's thresholds (pallas_kernels.py:63)
# so both packages pick the same tier for the same batch
_FUSE_MAX_ROWS = 1 << 18
_FUSE_MAX_LANES = 8
_FUSE_VMEM_BUDGET = 12 * 1024 * 1024

FLIP_ZERO = -(1 << 31)  # flip of the uint lane value 0

# columns per K1 block-sort tile (TILE in csrc/sort_segments.cu): sets the
# number of merge rounds, and so of scratch lane matrices, for a given m
K1_TILE = 512

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
_BUILD = os.path.join(_PKG_DIR, "_build")
KERNEL_SOURCES = {
    "sort_segments": "sort_segments.cu",
    "keep_last_mask": "keep_last.cu",
    "segment_sum": "segment_sum.cu",
}
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
               "-Xcompiler", "-fPIC"]

launches = {name: 0 for name in KERNEL_SOURCES}
last_shape: dict[str, tuple] = {}
_KERNELS: dict[str, ctypes._CFuncPtr] = {}  # kernel -> its bound C entry
_BUILD_LOCK = threading.RLock()  # the build and the binding, one thread at a time


_LAUNCH_LOCK = threading.Lock()  # launches may come from several threads


def _count(name: str) -> None:
    with _LAUNCH_LOCK:
        launches[name] += 1


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    last_shape.clear()


def fusable(m: int, num_lanes: int) -> bool:
    """Admission test for K1: m a power of two within the row cap, and a
    bounded lane count (the JAX package's VMEM budget formula)."""
    if m < 2 or m & (m - 1):
        return False
    if m > _FUSE_MAX_ROWS or num_lanes + 1 > _FUSE_MAX_LANES:
        return False
    return (num_lanes + 1) * m * 4 * 3 <= _FUSE_VMEM_BUDGET


def flip_np(lane: np.ndarray) -> np.ndarray:
    """uint{8,16,32} lane -> order-preserving int32 image."""
    return (lane.astype(np.uint32) ^ np.uint32(0x80000000)).view(np.int32)


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the port's kernels")


def _lib_path(src: str) -> str:
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(_BUILD, f"lib{name}-{digest}.so")


def build_kernels() -> dict[str, str]:
    """Compile every kernel source whose library is missing, one nvcc per
    source, all started together; returns {kernel: library path}."""
    with _BUILD_LOCK:
        return _build_missing()


def _build_missing() -> dict[str, str]:
    paths = {name: _lib_path(os.path.join(_CSRC, src)) for name, src in KERNEL_SOURCES.items()}
    missing = [name for name in KERNEL_SOURCES if not os.path.exists(paths[name])]
    if not missing:
        return paths
    nvcc = _nvcc()
    os.makedirs(_BUILD, exist_ok=True)
    procs = []
    for name in missing:
        out = paths[name]
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *_NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, KERNEL_SOURCES[name])]
        procs.append((name, out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, out, tmp, proc in procs:
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            with open(f"{out}.log", "w") as f:
                f.write(log)
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return paths


def build_log(name: str) -> str:
    """nvcc's output (with `-Xptxas -v`: registers, shared memory and spills
    of every kernel) from the build of `name`'s library."""
    with open(f"{build_kernels()[name]}.log") as f:
        return f.read()


def _kernel(name: str):
    """The C entry of `name`'s library, built, loaded and bound on first use."""
    fn = _KERNELS.get(name)
    if fn is not None:
        return fn
    with _BUILD_LOCK:
        fn = _KERNELS.get(name)
        if fn is not None:
            return fn
        lib = ctypes.CDLL(build_kernels()[name])
        if name == "sort_segments":
            fn = lib.paimon_sort_segments
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        elif name == "keep_last_mask":
            fn = lib.paimon_keep_last
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        else:
            fn = lib.paimon_segment_sum
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _KERNELS[name] = fn
    return fn


def _check(x: torch.Tensor, what: str) -> None:
    if x.dtype != torch.int32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous 2-D int32 tensor, got {x.dtype} {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


def _on_device(dev: torch.device):
    """The CUDA runtime launches on the calling thread's current device:
    make dev current for the launch, unless it already is."""
    return contextlib.nullcontext() if dev.index == torch.cuda.current_device() else torch.cuda.device(dev)


def _stream(dev: torch.device) -> int:
    """The current stream on dev as a raw pointer, without building a
    torch.cuda.Stream."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


# ---------------------------------------------------------------------------
# K1: stable multi-lane sort + keep-last
# ---------------------------------------------------------------------------


def lexsort_lanes(lanes) -> torch.Tensor:
    """Stable lexicographic argsort of equal-length lanes, most significant
    first: stable sorts from the last lane to the first, carrying the
    permutation (ties keep input order). Returns int64 indices."""
    perm = torch.sort(lanes[-1], stable=True).indices
    for lane in reversed(lanes[:-1]):
        perm = perm[torch.sort(lane[perm], stable=True).indices]
    return perm


def sort_segments_plain(stacked: torch.Tensor, num_boundary: int) -> torch.Tensor:
    """Plain version of K1: sort the columns of stacked (nl, m) by all nl
    lanes, then (3, m) int32 = perm (sorted last lane), keep_last, sorted
    lane 0."""
    nl, m = stacked.shape
    s = stacked[:, lexsort_lanes(list(stacked))]
    keep = torch.ones(m, dtype=torch.bool, device=stacked.device)
    if m > 1:
        keep[:-1] = (s[:num_boundary, 1:] != s[:num_boundary, :-1]).any(0)
    return torch.stack([s[-1], keep.to(torch.int32), s[0]])


def sort_segments(stacked: torch.Tensor, num_boundary: int) -> torch.Tensor:
    """K1 wrapper. stacked: (nl, m) int32, flipped lanes with the boundary
    lanes first and a distinct (iota) lane last; m a power of two in
    [2, 2^18], nl <= 8."""
    _check(stacked, "sort_segments")
    nl, m = stacked.shape
    if not 1 <= num_boundary < nl:
        raise ValueError(f"sort_segments: num_boundary {num_boundary} outside [1, {nl})")
    if stacked.device.type == "cpu":
        return sort_segments_plain(stacked, num_boundary)
    if m < 2 or m & (m - 1) or m > _FUSE_MAX_ROWS or nl > _FUSE_MAX_LANES:
        raise ValueError(
            f"sort_segments: needs m a power of two in [2, 2^18] and <= 8 lanes, got {tuple(stacked.shape)}"
        )
    rounds = (m // K1_TILE).bit_length() - 1 if m > K1_TILE else 0  # merge rounds after the block sort
    fn = _kernel("sort_segments")
    dev = stacked.device
    out = torch.empty((3, m), dtype=torch.int32, device=dev)
    scratch = torch.empty((min(rounds, 2), nl, m), dtype=torch.int32, device=dev)  # the rounds' ping-pong
    with _on_device(dev):
        rc = fn(stacked.data_ptr(), out.data_ptr(), scratch.data_ptr(), m, nl, num_boundary, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"sort_segments kernel launch failed with CUDA error {rc}")
    _count("sort_segments")
    last_shape["sort_segments"] = (nl, m, num_boundary)
    return out


def fused_sort_segments(boundary_lanes, order_lanes):
    """The fused inner merge: stable sort + run-boundary detection +
    keep-last through K1. boundary_lanes: pad flag first, then OVC/extra
    keys, then key lanes (they order rows and split segments); order_lanes:
    sequence lanes (order within a segment only). All (m,) flipped int32.
    Returns (pad_sorted, perm, seg_start, keep_last, seg_id), the
    sorted_segments contract, with pad_sorted still flipped."""
    m = boundary_lanes[0].shape[0]
    dev = boundary_lanes[0].device
    rows = list(boundary_lanes) + list(order_lanes) + [torch.arange(m, dtype=torch.int32, device=dev)]
    out = sort_segments(torch.stack(rows).contiguous(), len(boundary_lanes))
    keep_last = out[1] != 0
    seg_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), keep_last[:-1]])
    seg_id = (torch.cumsum(seg_start.to(torch.int32), 0) - 1).to(torch.int32)
    return out[2], out[0], seg_start, keep_last, seg_id


# ---------------------------------------------------------------------------
# K2: boundary sweep after the stock stable sort
# ---------------------------------------------------------------------------


def keep_last_mask_plain(stacked: torch.Tensor, mask_pad: bool = True) -> torch.Tensor:
    """Plain version of K2: (m,) int32, 1 where a sorted row's lanes differ
    from the next row's; the last row closes; mask_pad zeroes rows whose
    lane 0 (the pad flag) is not 0."""
    _, m = stacked.shape
    keep = torch.ones(m, dtype=torch.bool, device=stacked.device)
    if m > 1:
        keep[:-1] = (stacked[:, 1:] != stacked[:, :-1]).any(0)
    if mask_pad:
        keep &= stacked[0] == 0
    return keep.to(torch.int32)


def keep_last_mask(stacked: torch.Tensor, mask_pad: bool = True) -> torch.Tensor:
    """K2 wrapper. stacked: (L, m) int32 bit patterns of sorted uint32
    lanes, lane 0 the pad flag; any L >= 1, any m >= 1. The kernel takes
    its vector path where the rows are 16-byte aligned (m % 4 == 0 and an
    aligned start) and its scalar path otherwise."""
    _check(stacked, "keep_last_mask")
    lanes, m = stacked.shape
    if lanes < 1 or m < 1:
        raise ValueError(f"keep_last_mask: empty input {tuple(stacked.shape)}")
    if stacked.device.type == "cpu":
        return keep_last_mask_plain(stacked, mask_pad)
    fn = _kernel("keep_last_mask")
    dev = stacked.device
    out = torch.empty(m, dtype=torch.int32, device=dev)
    with _on_device(dev):
        rc = fn(stacked.data_ptr(), out.data_ptr(), lanes, m, 1 if mask_pad else 0, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"keep_last_mask kernel launch failed with CUDA error {rc}")
    _count("keep_last_mask")
    last_shape["keep_last_mask"] = (lanes, m)
    return out


# ---------------------------------------------------------------------------
# segment_sum: float sums over contiguous segments, in sorted order
# ---------------------------------------------------------------------------


def segment_sum_plain(values: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """Plain version of segment_sum: (m,) sums by segment id, 0 past the
    last segment. torch.segment_reduce on the CPU adds each segment's rows
    in order from `initial`, so it runs there whatever values' device."""
    m = values.shape[0]
    heads = torch.nonzero(seg_start.cpu()).flatten()
    lengths = torch.diff(heads, append=torch.tensor([m]))
    sums = torch.segment_reduce(values.cpu(), "sum", lengths=lengths, initial=0.0)
    out = torch.zeros(m, dtype=values.dtype)
    out[: sums.shape[0]] = sums
    return out.to(values.device)


def segment_sum(values: torch.Tensor, seg_start: torch.Tensor, seg_id: torch.Tensor) -> torch.Tensor:
    """segment_sum wrapper. values: (m,) float32 or float64 in sorted order;
    seg_start: (m,) bool, set at each segment's first row (row 0 always);
    seg_id: (m,) int32, the segment of each row. Returns (m,) of values'
    type: each segment's rows added in order from 0, by segment id."""
    if values.dtype not in (torch.float32, torch.float64) or values.dim() != 1 or not values.is_contiguous():
        raise ValueError(
            f"segment_sum: expected a contiguous 1-D float tensor, got {values.dtype} {tuple(values.shape)}"
        )
    m = values.shape[0]
    if seg_start.dtype != torch.bool or seg_id.dtype != torch.int32 or seg_start.shape != (m,) or seg_id.shape != (m,):
        raise ValueError("segment_sum: seg_start must be (m,) bool and seg_id (m,) int32")
    if not (seg_start.is_contiguous() and seg_id.is_contiguous()):
        raise ValueError("segment_sum: seg_start and seg_id must be contiguous")
    if m == 0:
        raise ValueError("segment_sum: empty input")
    if values.device.type == "cpu":
        return segment_sum_plain(values, seg_start)
    if values.device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {values.device}")
    fn = _kernel("segment_sum")
    dev = values.device
    out = torch.zeros(m, dtype=values.dtype, device=dev)
    with _on_device(dev):
        rc = fn(values.data_ptr(), seg_start.data_ptr(), seg_id.data_ptr(), out.data_ptr(), m,
                1 if values.dtype == torch.float64 else 0, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"segment_sum kernel launch failed with CUDA error {rc}")
    _count("segment_sum")
    last_shape["segment_sum"] = (m, str(values.dtype).removeprefix("torch."))
    return out
