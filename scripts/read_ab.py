#!/usr/bin/env python3
"""Time the bench table's write and read with one copy of the port on one
GPU, so that two copies (say a parent commit and a change) can be compared
in alternating processes on the same card.

    python3 scripts/read_ab.py --root DIR --label NAME [--reads 7] [--set KEY=VALUE ...]
                               [--batch-rows N] [--profile OUTDIR]

DIR holds the `paimon_tpu_torch` package to measure; the table and its
reads are chip_smoke.py's (`build_table`, `read_all`: 1M rows in 4 runs
and a 100,000-row upsert, zstd, one bucket, sort-engine=pallas), taken
from the chip_smoke.py beside this script; --set adds a table option
(say scan.prefetch-splits=0), and --batch-rows N writes each commit's
rows in N-row write() calls instead of one, so that a small
write-buffer-size makes the writer flush while it ingests. It prints one JSON line: the
write seconds, each read's seconds, the median read in output rows/s,
and the table's data files and bytes. With --profile it then profiles
one more read twice: under torch.profiler (the device time it traced)
and under cProfile, whose top functions by own and by cumulative time go
to OUTDIR/NAME.prof.txt.

A comparison:

    for t in parent change change parent; do
        python3 scripts/read_ab.py --root trees/$t --label $t; done
"""

from __future__ import annotations

import argparse
import cProfile
import importlib.util
import io
import json
import os
import pstats
import sys
import tempfile
import time


def build_batched(cs, pt, warehouse: str, extra: dict, batch_rows: int):
    """chip_smoke.build_table's rows and commits, each commit's rows
    written batch_rows at a time; (table, write seconds)."""
    import numpy as np
    from paimon_tpu_torch.catalog import FileSystemCatalog

    cat = FileSystemCatalog(warehouse, commit_user="read_ab", device=cs.DEVICE)
    table = cat.create_table("bench.t", cs.build_schema(pt), primary_keys=["id"], options={**cs.BENCH_OPTIONS, **extra})
    ids = np.random.default_rng(7).permutation(cs.N_ROWS).astype(np.int64)
    per = cs.N_ROWS // cs.N_RUNS
    up = np.random.default_rng(8).choice(cs.N_ROWS, cs.N_UPSERT, replace=False).astype(np.int64)
    commits = [(np.sort(ids[r * per : (r + 1) * per]), False) for r in range(cs.N_RUNS)] + [(up, True)]
    t0 = time.perf_counter()
    for rows, upsert in commits:
        wb = table.new_batch_write_builder()
        w = wb.new_write()
        for lo in range(0, len(rows), batch_rows):
            w.write(cs.table_values(rows[lo : lo + batch_rows], upsert=upsert))
        wb.new_commit().commit(w.prepare_commit())
    return table, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="directory holding the paimon_tpu_torch package to measure")
    ap.add_argument("--label", required=True)
    ap.add_argument("--reads", type=int, default=7)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE", help="an extra table option")
    ap.add_argument("--batch-rows", type=int, default=None, help="rows a write() call, else a commit's rows")
    ap.add_argument("--profile", default=None, help="directory for the cProfile listing")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("read_ab: torch.cuda.is_available() is false; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import paimon_tpu_torch as pt
    from paimon_tpu_torch.native import zstd_library
    from paimon_tpu_torch.ops import hopper_kernels as hk

    assert os.path.dirname(pt.__file__).startswith(os.path.abspath(args.root)), pt.__file__
    hk.build_kernels()
    zstd_library()  # the table's page codec, built before the clock starts
    with tempfile.TemporaryDirectory(prefix="paimon_tpu_torch_read_ab_") as warehouse:
        extra = dict(kv.split("=", 1) for kv in args.set)
        if args.batch_rows is None:
            table, _, write_s = cs.build_table(pt, warehouse, "t", extra)
        else:
            table, write_s = build_batched(cs, pt, warehouse, extra, args.batch_rows)
        out, samples = cs.timed_reads(table, args.reads)
        assert out.num_rows == cs.N_ROWS, out.num_rows
        assert np.array_equal(out.column("id").values, np.arange(cs.N_ROWS)), "ids are not the sorted key range"
        files = cs.live_files(table)
        result = {"label": args.label, "options": extra, "write_s": round(write_s, 4), "samples_s": [round(s, 4) for s in samples],
                  "median_rows_per_s": round(cs.N_ROWS / float(np.median(samples)), 1),
                  "files": len(files), "file_bytes": sum(f.file_size for f in files)}
        if args.profile:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                cs.read_all(table)
            device_us = sum(e.self_device_time_total for e in prof.key_averages()
                            if e.device_type == torch.autograd.DeviceType.CUDA)
            result["profiled_read_device_ms"] = round(device_us / 1000, 3)
            pr = cProfile.Profile()
            t0 = time.perf_counter()
            pr.enable()
            cs.read_all(table)
            pr.disable()
            result["profiled_read_host_s"] = round(time.perf_counter() - t0, 4)
            text = io.StringIO()
            st = pstats.Stats(pr, stream=text)
            st.sort_stats("tottime").print_stats(30)
            st.sort_stats("cumulative").print_stats(40)
            os.makedirs(args.profile, exist_ok=True)
            with open(os.path.join(args.profile, f"{args.label}.prof.txt"), "w") as f:
                f.write(text.getvalue())
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
