#!/usr/bin/env python3
"""Time one chip_smoke.py phase alone, with one copy of the repository, on
one GPU, so that two copies (say a parent commit and a change) can be
compared in alternating processes on the same card.

    python3 scripts/phase_ab.py --root DIR --label NAME --phase {nested,dict_domain,serving}

DIR holds the copy to measure: its `paimon_tpu_torch` package and its
`chip_smoke.py`, whose phase function runs as that copy defines it. The
phase's inputs from earlier phases are made first, outside the clock:
dict_domain gets the lookups phase's star schema (`star_tables`; the
value-path join times it reports beside its own are then absent), serving
the lookups phase's point-get table (`point_get_part`). The kernels and the
native codecs are built before the clock starts. It prints one JSON line:
the phase's wall seconds, its parts' seconds where it reports them, and its
kernel launches.

A comparison:

    for t in parent change change parent; do
        python3 scripts/phase_ab.py --root trees/$t --label $t --phase nested; done
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="directory holding the copy to measure")
    ap.add_argument("--label", required=True)
    ap.add_argument("--phase", required=True, choices=["nested", "dict_domain", "serving"])
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("phase_ab: torch.cuda.is_available() is false; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import paimon_tpu_torch as pt
    from paimon_tpu_torch.catalog import FileSystemCatalog
    from paimon_tpu_torch.native import build_native
    from paimon_tpu_torch.ops import hopper_kernels as hk

    assert os.path.dirname(pt.__file__).startswith(root), pt.__file__
    hk.build_kernels()
    build_native()
    with tempfile.TemporaryDirectory(prefix="paimon_tpu_torch_phase_ab_") as warehouse:
        cat = FileSystemCatalog(warehouse, commit_user="chip_smoke", device=cs.DEVICE)
        t0 = time.perf_counter()
        if args.phase == "dict_domain":
            cs.star_tables(pt, cat)
            run = lambda: cs.dict_domain_phase(pt, hk, warehouse, {}, ((), ()))  # noqa: E731
        elif args.phase == "serving":
            cs.point_get_part(pt, hk, cat)
            run = lambda: cs.serving_phase(pt, hk, warehouse, ((), ()))  # noqa: E731
        else:
            run = lambda: cs.nested_phase(pt, hk, warehouse, ((), ()))  # noqa: E731
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = run()
        seconds = time.perf_counter() - t0
    parts = out.get("seconds_by_part") or out.get("seconds")
    print(json.dumps({"label": args.label, "phase": args.phase, "setup_s": round(setup_s, 3),
                      "seconds": round(seconds, 3), "parts_s": parts, "launches": out["launches"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
