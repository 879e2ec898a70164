#!/usr/bin/env python3
"""Time K2's launch configurations on one NVIDIA GPU (the measurement that
chose BLOCK and UNROLL in paimon_tpu_torch/csrc/keep_last.cu).

    python3 scripts/k2_candidates.py          # from the repository root

For each (BLOCK, UNROLL) candidate it compiles a copy of keep_last.cu with
those two constants replaced (all nvcc processes started together, into
paimon_tpu_torch/_build/k2_candidates/), checks the build exactly against
the plain version at a few shapes (both kernel paths), and times it at the
main path's shape (2, 2^21): torch.profiler kernel time per call, with the
input warm in L2 and cold (cycling over copies that exceed the L2), and
CUDA events over back-to-back calls, in `rounds` rounds that alternate the
order.
Prints one JSON line per candidate, then the card line. The repository's
own build compiles only the configuration in the source.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANDIDATES = [(block, unroll) for block in (128, 256, 512) for unroll in (1, 2, 4)]
CHECK_SHAPES = ((2, 1 << 21), (3, 1025), (12, 4096), (1, (1 << 21) + 3))


def build(hk) -> dict:
    """{(block, unroll): (bound C entry, ptxas usage)}"""
    import chip_smoke

    with open(os.path.join(hk._CSRC, hk.KERNEL_SOURCES["keep_last_mask"])) as f:
        src = f.read()
    out_dir = os.path.join(hk._BUILD, "k2_candidates")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for block, unroll in CANDIDATES:
        text, n = re.subn(r"constexpr int BLOCK = \d+;", f"constexpr int BLOCK = {block};", src)
        text, k = re.subn(r"constexpr int UNROLL = \d+;", f"constexpr int UNROLL = {unroll};", text)
        assert n == k == 1, "keep_last.cu no longer defines BLOCK and UNROLL as constexpr ints"
        cu = os.path.join(out_dir, f"keep_last_b{block}_u{unroll}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = cu[:-3] + ".so"
        procs[(block, unroll)] = (so, subprocess.Popen([hk._nvcc(), *hk._NVCC_FLAGS, "-o", so, cu],
                                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    built = {}
    for key, (so, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for BLOCK, UNROLL = {key}:\n{log}")
        fn = ctypes.CDLL(so).paimon_keep_last
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        built[key] = (fn, chip_smoke.ptxas_usage(log))
    return built


def launch(fn, x: torch.Tensor, mask_pad: int) -> torch.Tensor:
    out = torch.empty(x.shape[1], dtype=torch.int32, device=x.device)
    rc = fn(x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], mask_pad, torch._C._cuda_getCurrentRawStream(0))
    if rc != 0:
        raise RuntimeError(f"keep_last launch failed with CUDA error {rc}")
    return out


def main(rounds: int = 3) -> int:
    if not torch.cuda.is_available():
        print("k2_candidates: torch.cuda.is_available() is false; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from paimon_tpu_torch.ops import hopper_kernels as hk

    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    built = build(hk)
    for key, (fn, _) in built.items():
        for lanes, m in CHECK_SHAPES:
            for pattern in ("pad_tail", "ends_every_128"):
                x = chip_smoke.k2_input(hk, lanes, m, dev, pattern)
                for mask_pad in (0, 1):
                    got = launch(fn, x, mask_pad)
                    torch.cuda.synchronize()
                    assert torch.equal(got, hk.keep_last_mask_plain(x, bool(mask_pad))), (key, lanes, m, pattern)
    y = chip_smoke.k2_input(hk, 2, 1 << 21, dev)
    ys = chip_smoke.l2_evicting_copies(y)
    times = {key: {"device_ms": [], "device_ms_cold": [], "events_ms": []} for key in built}
    for r in range(rounds):
        for key in built if r % 2 == 0 else reversed(list(built)):
            fn = built[key][0]
            cold = chip_smoke.rotating(lambda t: launch(fn, t, 0), ys)
            times[key]["device_ms"].append(chip_smoke.device_ms(lambda: launch(fn, y, 0), {"ms": "keep_last"})["ms"])
            times[key]["device_ms_cold"].append(chip_smoke.device_ms(cold, {"ms": "keep_last"})["ms"])
            times[key]["events_ms"].append(round(chip_smoke.cuda_ms(lambda: launch(fn, y, 0)), 5))
    for (block, unroll), t in times.items():
        usage = built[(block, unroll)][1]
        print(json.dumps({"block": block, "unroll": unroll, "shape": [2, 1 << 21], **t,
                          "ptxas": usage}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
