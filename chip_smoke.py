#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (paimon_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root

Phases, one JSON line each on stdout:

1. card     - `nvidia-smi --query-gpu=name,power.limit` (also printed raw).
2. build    - nvcc builds both kernels from paimon_tpu_torch/csrc (seconds),
              and each kernel's registers, shared memory and spills as
              `-Xptxas -v` reports them (no spills allowed); cc builds the
              zstd codec from paimon_tpu_torch/native/zstd.c (seconds).
3. kernels  - K1 (sort_segments) and K2 (keep_last_mask) against their plain
              PyTorch versions on the card, exact integer equality. K1: m in
              {2, 4, 64, T/2, T, 2T, 4096, 2^17, 2^18} (T its block-sort
              tile) x 2..8 lanes x 1 and nl-1 boundary lanes x four key
              patterns (mixed u8/u16/u32 widths with heavy ties, all keys
              equal, keys sorted, keys reverse-sorted). K2: L in
              {1, 2, 3, 8, 9, 12} lanes x m in {1..8 ragged, 127..129,
              1023..1025, 2^21, 2^21 + 3} x both pad modes x five patterns
              (all columns equal, all distinct, segments ending at every
              4th and every 128th column, sorted pad-tail lanes), plus
              contiguous views one column off a flat buffer's start.
4. main     - the bench.py table at bench.py's own options (bucket 1,
              parquet, write-only; no codec keys, so zstd data pages and
              zstd manifests), 1M rows, id BIGINT NOT NULL + 7 value
              columns, 4 key-overlapping sorted runs of a seed-7
              permutation, plus a fifth commit upserting 100k ids with new
              values, written and merge-read through the port's Table API
              with sort-engine=pallas at the default merge.read-batch-rows
              (K2 tier) and at 131072 (K1 tier). Every read must return
              1,000,000 rows equal row for row to a sort-engine=numpy read,
              with the upserted values; each kernel's launch count must rise.
              Launch counts are zeroed just before the writes and read just
              after the last pallas read. Then the same table with
              file.compression=none and manifest.compression=none (what
              earlier runs measured), its own launch counts zeroed before
              its writes, read at the default tile only.
5. layers   - the keys-only merge-read pipeline timed stage by stage, for
              both tables; `decompress_pages` times the zstd decompression
              of every page those reads decode (a part of the two decode
              stages) and gives its output MB/s; and the bytes of each table
              on disk. Then one read of each tier under torch.profiler
              (device busy time against wall time).
6. compact  - BASELINE config 4 at full size (1M rows in 20 streaming commits
              of 50,000, trigger 4, not write-only, default codecs) through
              the port's StreamWriteBuilder with identifiers 1..20, then one
              batch commit of compact(full=True). Commits, snapshots by kind,
              compactions, files rewritten and upgraded, the level layout
              after each step, K1 and K2 launches (zeroed before the writes,
              read after the last read; split between flushes, compactions
              and reads), write seconds and ingest rows/s, and compaction
              seconds split into input decode, merge and encode + write. The
              read after each step must equal a sort-engine=numpy read and a
              numpy oracle (each id's last value).
7. timing   - each kernel at its main-path shape against its plain version,
              one PyTorch library computation of the same function, and its
              bound, all with CUDA events, and the wrapper's host time per
              call. K1 also at the write-flush shape and at (8, 2^18), and
              its device time at the read-tile and widest shapes split
              between the block sort and the merge rounds (torch.profiler).
              K2's device time and the library call's, by torch.profiler,
              with the input warm in L2 (as the main path hands it over)
              and cold (cycling over copies that exceed the L2).

Then one JSON line with every kernel's numbers (its launches summed over
the main and compact paths, and by path), the card line, and last
`{"ok": true, "device": {...}}`. Any failed check raises, so the exit code
is not 0 and no result line is printed; without a CUDA device the script
exits 2 before doing anything.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_ROWS = 1_000_000
N_RUNS = 4
N_UPSERT = 100_000
K1_TILE_ROWS = 131072
# BASELINE config 4 (benchmarks/baseline_configs.py config4, scale 1): a
# Flink CDC upsert stream, 20 streaming commits of 50,000 rows over ids
# 0..499,999, universal compaction at trigger 4, default codecs
C4_ROWS = 1_000_000
C4_COMMITS = 20
C4_OPTIONS = {"bucket": "1", "num-sorted-run.compaction-trigger": "4", "sort-engine": "pallas"}
READ_REPEATS = 5
DEVICE = "cuda:0"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
L2_BYTES = 50 << 20  # H100 SXM L2 cache
SCALAR32_OPS_PER_S = 67e12  # H100 SXM 32-bit rate outside the tensor cores, NVIDIA data sheet


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# kernel inputs
# ---------------------------------------------------------------------------


def _lane(rng, n: int, width: str) -> np.ndarray:
    """Random lane values with heavy ties in a u8/u16/u32 range."""
    hi = {"u8": 4, "u8w": 256, "u16": 1 << 16, "u32": 1 << 32}[width]
    return rng.integers(0, hi, n, dtype=np.uint64).astype(np.uint32)


K1_PATTERNS = ("mixed", "equal", "sorted", "reverse")


def _k1_lane(rng, m: int, i: int, pattern: str) -> np.ndarray:
    if pattern == "mixed":
        return _lane(rng, m, ["u8", "u16", "u32", "u8w", "u8", "u16"][i % 6])
    if pattern == "equal":
        return np.full(m, 7, dtype=np.uint32)
    ramp = np.arange(m, dtype=np.uint32) >> np.uint32(i)  # ties grow with the lane
    return ramp if pattern == "sorted" else ramp[::-1].copy()


def k1_input(hk, rng, m: int, nl: int, dev, pattern: str = "mixed"):
    """(nl, m) flipped int32: pad flag (pad rows last), nl - 2 key/seq lanes
    of the pattern, iota. Also returns the main path's boundary count."""
    pad = np.zeros(m, dtype=np.uint32)
    pad[m - max(1, m // 10) :] = 1
    rows = [hk.flip_np(pad)] + [hk.flip_np(_k1_lane(rng, m, i, pattern)) for i in range(nl - 2)]
    rows.append(np.arange(m, dtype=np.int32))
    num_boundary = nl - 1 - (1 if nl > 3 else 0)  # one sequence lane once there is room
    return torch.from_numpy(np.stack(rows)).to(dev).contiguous(), num_boundary


def ptxas_usage(log: str) -> dict:
    """{kernel<template args>: [registers, static shared bytes, spill stores,
    spill loads]} from nvcc's `-Xptxas -v` output."""
    rows, cur = {}, None
    for line in log.splitlines():
        mt = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if mt:
            mangled = mt.group(1)
            name, pos = mangled, 3 if mangled.startswith("_ZN") else 2
            while (num := re.match(r"\d+", mangled[pos:])) is not None:  # the nested name's last part
                start = pos + num.end()
                name, pos = mangled[start : start + int(num.group())], start + int(num.group())
            args = ",".join(re.findall(r"Li(\d+)E", mangled))
            cur = rows.setdefault(f"{name}<{args}>" if args else name, [0, 0, 0, 0])
            continue
        mt = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if mt and cur is not None:
            cur[2], cur[3] = int(mt.group(1)), int(mt.group(2))
        mt = re.search(r"Used (\d+) registers", line)
        if mt and cur is not None:
            cur[0] = int(mt.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur[1] = int(sm.group(1)) if sm else 0
    return rows


K2_LANES = (1, 2, 3, 8, 9, 12)
K2_COLUMNS = (1, 2, 3, 4, 5, 7, 8, 127, 128, 129, 1023, 1024, 1025, 1 << 21, (1 << 21) + 3)
K2_PATTERNS = ("equal", "distinct", "ends_every_4", "ends_every_128", "pad_tail")
K2_MISALIGNED = ((2, 1 << 21), (3, 129))
_K2_WIDTHS = (256, 1 << 32, 4, 1 << 16)  # key-lane value ranges, cycled


def k2_input(hk, lanes: int, m: int, dev, pattern: str = "pad_tail", seed: int = 0):
    """(lanes, m) int32 bit patterns of sorted lanes, lane 0 the pad flag,
    made on the device. `equal`: every column the same, so only the last
    closes. `distinct`, `ends_every_4`, `ends_every_128`: segment c, c // 4
    or c // 128 at column c, each step between segments changing exactly
    one lane, cycling over the key lanes (over lane 0 when it is the only
    lane). `pad_tail`: the main path's shape, m // 20 pad rows last and key
    lanes of heavy ties, sorted."""
    col = torch.arange(m, device=dev, dtype=torch.int64)
    if pattern == "pad_tail":
        gen = torch.Generator(device=dev).manual_seed(seed)
        rows = [(col >= m - m // 20).to(torch.int32)]
        for i in range(lanes - 1):
            hi = _K2_WIDTHS[i % len(_K2_WIDTHS)]
            rows.append(torch.randint(0, hi, (m,), generator=gen, device=dev, dtype=torch.int64).to(torch.int32))
        perm = hk.lexsort_lanes(rows)
        return torch.stack([r[perm] for r in rows]).contiguous()
    seg = {"equal": col * 0, "distinct": col, "ends_every_4": col // 4, "ends_every_128": col // 128}[pattern]
    stepping = list(range(1, lanes)) or [0]
    rows = [torch.zeros(m, device=dev, dtype=torch.int64) for _ in range(lanes)]
    for i, lane in enumerate(stepping):  # lane i changes at the steps s -> s + 1 with s % n == i
        rows[lane] = (seg + len(stepping) - 1 - i) // len(stepping)
    return torch.stack(rows).to(torch.int32).contiguous()


def misaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x that starts one int32 past a fresh buffer's
    start, so its rows are not 16-byte aligned."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


def k2_checks(hk, dev) -> tuple[int, int]:
    """K2 against its plain version, exactly, over the K2 grid; returns
    (aligned checks, misaligned-view checks)."""
    aligned = unaligned = 0
    for lanes in K2_LANES:
        for m in K2_COLUMNS:
            for pattern in K2_PATTERNS:
                x = k2_input(hk, lanes, m, dev, pattern, seed=m + lanes)
                views = [x] + ([misaligned(x)] if (lanes, m) in K2_MISALIGNED else [])
                for v in views:
                    for mask_pad in (True, False):
                        got = hk.keep_last_mask(v, mask_pad)
                        torch.cuda.synchronize()
                        want = hk.keep_last_mask_plain(x, mask_pad)
                        assert torch.equal(got, want), (
                            f"K2 differs from its plain version at L={lanes}, m={m}, {pattern}, "
                            f"mask_pad={mask_pad}, data_ptr % 16 = {v.data_ptr() % 16}")
                        if v is x:
                            aligned += 1
                        else:
                            unaligned += 1
    return aligned, unaligned


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


def table_values(ids: np.ndarray, upsert: bool) -> dict:
    if not upsert:  # bench.py:74-94
        return {
            "id": ids,
            "c1": ids * 3,
            "c2": ids % 97,
            "c3": ids // 7,
            "d1": ids.astype(np.float64) * 0.5,
            "d2": ids.astype(np.float64) + 0.25,
            "s1": np.array([f"val-{int(x) % 1000:04d}" for x in ids], dtype=object),
            "s2": np.array([f"tag-{int(x) % 10}" for x in ids], dtype=object),
        }
    return {
        "id": ids,
        "c1": ids * 3 + 1,
        "c2": ids % 97 + 1000,
        "c3": -(ids // 7),
        "d1": ids.astype(np.float64) * 0.5 + 0.125,
        "d2": -(ids.astype(np.float64) + 0.25),
        "s1": np.array([f"upd-{int(x) % 1000:04d}" for x in ids], dtype=object),
        "s2": np.array(["tag-upd"] * len(ids), dtype=object),
    }


BENCH_OPTIONS = {"bucket": "1", "file.format": "parquet", "write-only": "true", "sort-engine": "pallas"}
UNCOMPRESSED = {"file.compression": "none", "manifest.compression": "none"}


def build_table(pt, warehouse: str, name: str, extra_options: dict):
    """bench.py's table (bench.py:54-96) with bench.py's options plus
    sort-engine=pallas and extra_options, and the upsert commit."""
    from paimon_tpu_torch.catalog import FileSystemCatalog

    cat = FileSystemCatalog(warehouse, commit_user="chip_smoke", device=DEVICE)
    schema = pt.RowType.of(
        ("id", pt.BIGINT(False)),
        ("c1", pt.BIGINT()),
        ("c2", pt.BIGINT()),
        ("c3", pt.BIGINT()),
        ("d1", pt.DOUBLE()),
        ("d2", pt.DOUBLE()),
        ("s1", pt.STRING()),
        ("s2", pt.STRING()),
    )
    table = cat.create_table(f"bench.{name}", schema, primary_keys=["id"], options={**BENCH_OPTIONS, **extra_options})
    rng = np.random.default_rng(7)
    ids = rng.permutation(N_ROWS).astype(np.int64)
    per = N_ROWS // N_RUNS
    t0 = time.perf_counter()
    for r in range(N_RUNS):
        wb = table.new_batch_write_builder()
        w = wb.new_write()
        w.write(table_values(np.sort(ids[r * per : (r + 1) * per]), upsert=False))
        wb.new_commit().commit(w.prepare_commit())
    # the upsert batch arrives unsorted: its flush dedups on the device too
    up = np.random.default_rng(8).choice(N_ROWS, N_UPSERT, replace=False).astype(np.int64)
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.write(table_values(up, upsert=True))
    wb.new_commit().commit(w.prepare_commit())
    return table, up, time.perf_counter() - t0


def read_all(table):
    rb = table.new_read_builder()
    out = rb.new_read().read_all(rb.new_scan().plan())
    torch.cuda.synchronize()
    return out


def timed_reads(table, repeats: int):
    samples, out = [], None
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = read_all(table)
        samples.append(time.perf_counter() - t0)
    return out, samples


def read_stats(samples: list, launches: dict | None = None) -> dict:
    median = float(np.median(samples))
    out = {"samples_s": [round(s, 4) for s in samples], "median_s": round(median, 4),
           "output_rows_per_s_median": round(N_ROWS / median, 1),
           "input_rows_per_s_median": round((N_ROWS + N_UPSERT) / median, 1)}
    return out if launches is None else {**out, "launches": launches}


def check_output(out, reference, up: np.ndarray, what: str) -> None:
    assert out.num_rows == N_ROWS, f"{what}: {out.num_rows} rows"
    for name in out.schema.field_names:
        a, b = out.column(name), reference.column(name)
        assert np.array_equal(a.values, b.values), f"{what}: column {name} differs from the numpy engine"
        assert np.array_equal(a.valid_mask(), b.valid_mask()), f"{what}: validity of {name} differs"
    ids = out.column("id").values
    assert np.array_equal(ids, np.arange(N_ROWS)), f"{what}: ids are not the sorted key range"
    new = table_values(np.sort(up), upsert=True)
    old_ids = np.setdiff1d(np.arange(N_ROWS), up)
    old = table_values(old_ids, upsert=False)
    for name in ("c1", "c2", "c3", "d1", "d2", "s1", "s2"):
        vals = out.column(name).values
        assert np.array_equal(vals[np.sort(up)], new[name]), f"{what}: upserted {name} lost"
        assert np.array_equal(vals[old_ids], old[name]), f"{what}: untouched {name} changed"


def layer_breakdown(table, tile_rows: int) -> dict:
    """One keys-only merge read, timed stage by stage (host clock, device
    synchronised at each boundary), and the zstd decompression of every page
    its two decode stages decode, timed apart."""
    from paimon_tpu_torch.core.kv import VALUE_KIND_FIELD_NAME, KVBatch
    from paimon_tpu_torch.core.levels import IntervalPartition
    from paimon_tpu_torch.core.read import order_runs_for_merge
    from paimon_tpu_torch.data.keys import encode_key_lanes
    from paimon_tpu_torch.ops.merge import deduplicate_resolve_tiled, deduplicate_tiled_dispatch

    t = table.copy({"merge.read-batch-rows": str(tile_rows)})
    store = t.store
    (split,) = t.new_read_builder().new_scan().plan()
    rf = store.reader_factory(split.partition, split.bucket)
    (section,) = IntervalPartition(split.files).partition()
    runs, seq_ascending = order_runs_for_merge(section)
    files = [f for run in runs for f in run.files]
    ms = {}
    t0 = time.perf_counter()
    heads = [rf.read(f, fields=["id"], system_columns="kind") for f in files]
    kv_keys = KVBatch.concat(heads)
    ms["decode_keys"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    lanes = encode_key_lanes(kv_keys.data, ["id"])
    ms["encode_lanes"] = (time.perf_counter() - t0) * 1e3
    offsets = np.cumsum([0] + [h.num_rows for h in heads]).tolist()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    take = deduplicate_resolve_tiled(deduplicate_tiled_dispatch(lanes, offsets, tile_rows, "pallas", True, DEVICE))
    ms["plan_upload_kernel_download"] = (time.perf_counter() - t0) * 1e3
    rest = [n for n in rf.read_schema.field_names if n != "id"]
    t0 = time.perf_counter()
    tails = [rf.read(f, fields=rest, system_columns=False) for f in files]
    ms["decode_values"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    tail = KVBatch.concat(tails).take(take)
    kv_keys.take(take)
    ms["gather"] = (time.perf_counter() - t0) * 1e3
    assert tail.num_rows == N_ROWS
    raws = [store.file_io.read_bytes(f"{rf.bucket_dir}/{f.file_name}") for f in files]
    decompress = {"keys": decompress_pages(raws, ["id", VALUE_KIND_FIELD_NAME]), "values": decompress_pages(raws, rest)}
    return {"tile_rows": tile_rows, "seq_ascending": seq_ascending, "ms": {k: round(v, 3) for k, v in ms.items()},
            "decompress_pages": decompress}


def decompress_pages(raws: list, columns: list) -> dict:
    """Every page of `columns` in the data files `raws`, taken apart and
    decompressed as the reader does it, without decoding the values."""
    from paimon_tpu_torch.format import parquet

    out_bytes = 0
    t0 = time.perf_counter()
    for raw in raws:
        for _, chunks in parquet._parse_footer(raw):
            for name in columns:
                out_bytes += sum(len(page) for _, _, page in parquet._iter_pages(raw, chunks[name]))
    s = time.perf_counter() - t0
    return {"ms": round(s * 1e3, 3), "out_mb": round(out_bytes / 1e6, 3), "out_mb_per_s": round(out_bytes / 1e6 / s, 1)}


def table_bytes(table) -> dict:
    """Bytes on disk of a table's data files and of its manifests."""
    def total(directory, prefix):
        return sum(os.path.getsize(os.path.join(directory, n)) for n in os.listdir(directory) if n.startswith(prefix))

    return {"data_bytes": total(f"{table.path}/bucket-0", "data-"),
            "manifest_bytes": total(f"{table.path}/manifest", "manifest")}


def device_busy(table) -> dict:
    """One read under torch.profiler: device time summed over the CUDA
    events it recorded, against the read's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        read_all(table)
    wall_s = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_us = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) for e in events)
    top = sorted(events, key=lambda e: -getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)))
    return {
        "wall_s_traced": round(wall_s, 4),
        "device_busy_s": round(device_us / 1e6, 6),
        "device_idle_share": round(1 - device_us / 1e6 / wall_s, 4) if device_us else "not measured",
        "top_device_kernels": [[e.key[:60], round(getattr(e, "self_device_time_total", 0) / 1e3, 3)] for e in top[:6]],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paimon_tpu_torch as pt
    from paimon_tpu_torch.native import build_zstd
    from paimon_tpu_torch.ops import hopper_kernels as hk

    dev = torch.device(DEVICE)

    # 1. card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    # 2. build
    t0 = time.perf_counter()
    hk.build_kernels()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    build_zstd()
    codec_build_s = time.perf_counter() - t0
    k1_usage = ptxas_usage(hk.build_log("sort_segments"))
    k2_usage = ptxas_usage(hk.build_log("keep_last_mask"))
    tile = hk.K1_TILE
    instances = [f"{kernel}<{nl}>" for kernel in ("block_sort", "merge_round") for nl in range(2, 9)]
    missing = [k for k in instances if k not in k1_usage]
    assert not missing, f"ptxas reported no usage for {missing}"
    assert k2_usage, "ptxas reported no usage for K2"
    usage = {**{k: k1_usage[k] for k in instances}, **k2_usage}
    spilled = {k: v for k, v in usage.items() if v[2] or v[3]}
    columns = ["registers", "static_smem_bytes", "spill_store_bytes", "spill_load_bytes"]
    emit({"phase": "build", "seconds": round(build_s, 3), "kernels": list(hk.KERNEL_SOURCES),
          "zstd_codec_seconds": round(codec_build_s, 3), "k1_tile": tile,
          "k1_ptxas": {"columns": columns, **k1_usage}, "k2_ptxas": {"columns": columns, **k2_usage}})
    assert not spilled, f"kernels spill: {spilled}"

    # 3. kernel vs plain, exact
    rng = np.random.default_rng(2026)
    checks = k1_checks = 0
    for m in sorted({2, 4, 64, tile // 2, tile, 2 * tile, 4096, 1 << 17, 1 << 18}):
        for nl in range(2, 9):
            for pattern in K1_PATTERNS:
                x, _ = k1_input(hk, rng, m, nl, dev, pattern)
                for nb in sorted({1, nl - 1}):
                    got = hk.sort_segments(x, nb)
                    torch.cuda.synchronize()
                    want = hk.sort_segments_plain(x, nb)
                    assert torch.equal(got, want), f"K1 differs from its plain version at {(nl, m, nb)}, {pattern}"
                    k1_checks += 1
    checks += k1_checks
    t0 = time.perf_counter()
    k2_aligned, k2_misaligned = k2_checks(hk, dev)
    checks += k2_aligned + k2_misaligned
    emit({"phase": "kernels", "exact_checks": checks, "k1_exact_checks": k1_checks,
          "k2_exact_checks": k2_aligned + k2_misaligned, "k2_misaligned_view_checks": k2_misaligned,
          "k2_seconds": round(time.perf_counter() - t0, 3), "max_abs_err": 0})

    # 4. main path
    with tempfile.TemporaryDirectory(prefix="paimon_tpu_torch_smoke_") as warehouse:
        hk.reset_launches()
        table, up, write_s = build_table(pt, warehouse, "t", {})
        write_launches = dict(hk.launches)
        write_shape = hk.last_shape.get("sort_segments")
        assert write_launches["sort_segments"] > 0 and write_shape is not None, "the write flushes never launched K1"
        emit({"phase": "write", "rows": N_ROWS + N_UPSERT, "commits": N_RUNS + 1, "seconds": round(write_s, 3),
              "launches": write_launches, "k1_shape": list(write_shape)})
        reference, numpy_s = timed_reads(table.copy({"sort-engine": "numpy"}), 1)
        reads = {}
        for label, opts in (
            ("pallas_default_tile", {}),
            (f"pallas_tile_{K1_TILE_ROWS}", {"merge.read-batch-rows": str(K1_TILE_ROWS)}),
        ):
            before = dict(hk.launches)
            out, samples = timed_reads(table.copy(opts), READ_REPEATS)
            check_output(out, reference, up, label)
            reads[label] = read_stats(samples, {k: hk.launches[k] - before[k] for k in hk.launches})
        main_launches = dict(hk.launches)
        assert reads["pallas_default_tile"]["launches"]["keep_last_mask"] > 0, "K2 never launched on the default tile"
        assert reads[f"pallas_tile_{K1_TILE_ROWS}"]["launches"]["sort_segments"] > 0, "K1 never launched on small tiles"
        assert all(v > 0 for v in main_launches.values()), main_launches
        main_shapes = dict(hk.last_shape)
        plain_out, plain_samples = timed_reads(table.copy({"sort-engine": "xla-segmented"}), READ_REPEATS)
        check_output(plain_out, reference, up, "xla-segmented")
        reads["xla_segmented_plain_torch"] = read_stats(plain_samples)
        reads["numpy_host_oracle"] = {"samples_s": [round(s, 4) for s in numpy_s]}

        # the uncompressed variant, at the default tile
        hk.reset_launches()
        plain_table, plain_up, plain_write_s = build_table(pt, warehouse, "t_uncompressed", UNCOMPRESSED)
        out, samples = timed_reads(plain_table, READ_REPEATS)
        uncompressed_launches = dict(hk.launches)
        assert uncompressed_launches["keep_last_mask"] > 0, "K2 never launched on the uncompressed table"
        check_output(out, timed_reads(plain_table.copy({"sort-engine": "numpy"}), 1)[0], plain_up, "uncompressed")
        reads["uncompressed_pallas_default_tile"] = read_stats(samples, uncompressed_launches)
        emit({"phase": "main", "output_rows": N_ROWS, "input_rows": N_ROWS + N_UPSERT,
              "options": BENCH_OPTIONS, "reads": reads, "launches": main_launches,
              "kernel_shapes": {k: list(v) for k, v in main_shapes.items()},
              "uncompressed_write_seconds": round(plain_write_s, 3), "equal_to_numpy_engine": True,
              "upserts_visible": True})

        # 5. layers, and the device's busy share under the profiler
        emit({"phase": "layers", "default_tile": layer_breakdown(table, 8 << 20),
              f"tile_{K1_TILE_ROWS}": layer_breakdown(table, K1_TILE_ROWS),
              "uncompressed_default_tile": layer_breakdown(plain_table, 8 << 20),
              "on_disk": {"zstd": table_bytes(table), "uncompressed": table_bytes(plain_table)}})
        device_busy(table)  # the profiler's first use initialises its tracer: not counted
        emit({"phase": "trace", "default_tile": device_busy(table),
              f"tile_{K1_TILE_ROWS}": device_busy(table.copy({"merge.read-batch-rows": str(K1_TILE_ROWS)}))})

        # 6. the compaction path
        compact = compact_phase(pt, hk, warehouse)
        emit({"phase": "compact", **compact})

    # 7. timing at the main path's shapes, after 0.2 s of K1 calls so that
    # the card leaves the idle clocks of the host-bound phases before it
    kernels = []
    read_shape = main_shapes["sort_segments"]
    x, _ = k1_input(hk, rng, read_shape[1], read_shape[0], dev)
    warm_until = time.perf_counter() + 0.2
    while time.perf_counter() < warm_until:
        hk.sort_segments(x, read_shape[2])
    torch.cuda.synchronize()
    widest = (8, 1 << 18, 6)
    by_path = {name: {"main": main_launches[name], "compact": compact["launches"]["phase"][name]} for name in hk.launches}
    k1_rows = [k1_timing(hk, rng, dev, sum(by_path["sort_segments"].values()), shape)
               for shape in (read_shape, write_shape, widest)]
    at_keys = ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err", "host_ms_per_call")
    kernels.append({**k1_rows[0], "launches_by_path": by_path["sort_segments"], "at_shapes": [
        {"at": at, **{k: row[k] for k in at_keys}} for at, row in zip(("write flush", "widest admitted"), k1_rows[1:])]})
    split = {}
    for nl, m, nb in (read_shape, widest):
        x = k1_input(hk, rng, m, nl, dev)[0]
        split[str([nl, m, nb])] = device_ms(lambda: hk.sort_segments(x, nb),
                                            {"block_sort_ms": "block_sort", "merge_rounds_ms": "merge_round"})
    lanes, m2 = main_shapes["keep_last_mask"]
    y = k2_input(hk, lanes, m2, dev)
    err2 = (hk.keep_last_mask(y, False) - hk.keep_last_mask_plain(y, False)).abs().max().item()

    def k2_library():
        return (y[:, 1:] != y[:, :-1]).any(0)

    k2_row = kernel_row(
        "keep_last_mask (K2)", "paimon_tpu_torch/csrc/keep_last.cu", "paimon_tpu/ops/pallas_kernels.py:265",
        sum(by_path["keep_last_mask"].values()), err2,
        cuda_ms(lambda: hk.keep_last_mask(y, False)), cuda_ms(lambda: hk.keep_last_mask_plain(y, False)),
        lanes * m2 * 4 + m2 * 4, lanes * m2, cuda_ms(k2_library), [lanes, m2],
    )
    k2_row["launches_by_path"] = by_path["keep_last_mask"]
    k2_row["host_ms_per_call"] = host_ms(lambda: hk.keep_last_mask(y, False))
    # warm: the input is in L2, as the main path hands it over right after
    # writing it; cold: it comes from device memory, as the bound assumes
    ys = l2_evicting_copies(y)
    k2_row["device_ms"] = device_ms(lambda: hk.keep_last_mask(y, False), {"ms": "keep_last"})["ms"]
    k2_row["device_ms_cold"] = device_ms(rotating(lambda t: hk.keep_last_mask(t, False), ys), {"ms": "keep_last"})["ms"]
    k2_row["library_device_ms"] = device_ms(k2_library, {"ms": ""})["ms"]
    k2_row["library_device_ms_cold"] = device_ms(rotating(lambda t: (t[:, 1:] != t[:, :-1]).any(0), ys), {"ms": ""})["ms"]
    del ys
    kernels.append(k2_row)
    assert err2 == 0 and all(r["max_abs_err"] == 0 for r in k1_rows)
    emit({"phase": "timing", "card": card,
          "note": "ms: CUDA events, 10 warm-up + 100 timed calls; host_ms_per_call: host clock over 100 calls "
                  "without a synchronise; device_ms: torch.profiler kernel time per call over 20 calls on one "
                  "input (warm in L2); device_ms_cold: the same, cycling over copies that exceed the L2",
          "k1_device_split": split,
          "k2": {k: k2_row[k] for k in ("ms", "device_ms", "device_ms_cold", "host_ms_per_call", "bound_ms",
                                        "plain_ms", "library_ms", "library_device_ms", "library_device_ms_cold")}})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def c4_batch(rng, b: int) -> dict:
    """Commit b of config 4 (baseline_configs.py:160-164): ids drawn with
    repeats from one generator, so each flush dedups too."""
    per = C4_ROWS // C4_COMMITS
    ids = rng.integers(0, C4_ROWS // 2, per)
    return {"id": ids, "v": ids * 0.5 + b, "tag": np.array([f"t{b}"] * per, dtype=object)}


def check_c4_read(table, last_commit: np.ndarray, what: str) -> dict:
    """The table's read (sort-engine=pallas) against a sort-engine=numpy read
    and the oracle: each written id with the value of its last commit."""
    t0 = time.perf_counter()
    out = read_all(table)
    read_s = time.perf_counter() - t0
    reference = read_all(table.copy({"sort-engine": "numpy"}))
    ids = np.flatnonzero(last_commit >= 0)
    assert out.num_rows == len(ids), f"{what}: {out.num_rows} rows, the oracle has {len(ids)}"
    for name in out.schema.field_names:
        a, b = out.column(name), reference.column(name)
        assert np.array_equal(a.values, b.values), f"{what}: column {name} differs from the numpy engine"
        assert np.array_equal(a.valid_mask(), b.valid_mask()), f"{what}: validity of {name} differs"
    assert np.array_equal(out.column("id").values, ids), f"{what}: ids differ from the oracle"
    assert np.array_equal(out.column("v").values, ids * 0.5 + last_commit[ids]), f"{what}: v differs from the oracle"
    tags = np.array([f"t{b}" for b in last_commit[ids]], dtype=object)
    assert np.array_equal(out.column("tag").values, tags), f"{what}: tag differs from the oracle"
    return {"rows": out.num_rows, "read_s": round(read_s, 4), "equal_to_numpy_engine": True, "equal_to_oracle": True}


def level_layout(table) -> dict:
    """{level: [files, rows]} of the table's live files."""
    out: dict = {}
    for f in table.store.restore_files((), 0):
        files, rows = out.get(f.level, (0, 0))
        out[f.level] = (files + 1, rows + f.row_count)
    return {str(lv): list(v) for lv, v in sorted(out.items())}


class CompactionProbe:
    """Times the compaction manager and its rewriter's three stages and
    counts compactions, rewritten and upgraded files and the kernel launches
    made inside compactions, by wrapping their methods while installed."""

    def __init__(self, hk):
        from paimon_tpu_torch.core.compact import MergeTreeCompactManager, MergeTreeCompactRewriter

        self.hk = hk
        self.targets = [(MergeTreeCompactManager, "trigger_compaction", "compaction"),
                        (MergeTreeCompactRewriter, "_read_section", "decode"),
                        (MergeTreeCompactRewriter, "_merge_section", "merge"),
                        (MergeTreeCompactRewriter, "_write_section", "encode_write")]
        self.seconds = dict.fromkeys([t[2] for t in self.targets], 0.0)
        self.compactions = self.rewritten = self.upgraded = 0
        self.merge_rows: list = []
        self.launches = dict.fromkeys(hk.launches, 0)
        self._saved: list = []

    def __enter__(self):
        for cls, name, stage in self.targets:
            fn = getattr(cls, name)
            self._saved.append((cls, name, fn))
            setattr(cls, name, self._wrap(fn, stage))
        return self

    def __exit__(self, *exc):
        for cls, name, fn in self._saved:
            setattr(cls, name, fn)
        self._saved.clear()

    def _wrap(self, fn, stage):
        def timed(obj, *args, **kwargs):
            if stage == "merge":
                self.merge_rows.append(args[0].num_rows)
            before = dict(self.hk.launches)
            t0 = time.perf_counter()
            out = fn(obj, *args, **kwargs)
            torch.cuda.synchronize()
            self.seconds[stage] += time.perf_counter() - t0
            if stage == "compaction" and out is not None and not out.is_empty():
                after_names = {f.file_name for f in out.after}
                self.compactions += 1
                self.upgraded += sum(f.file_name in after_names for f in out.before)
                self.rewritten += sum(f.file_name not in after_names for f in out.before)
                for k in self.launches:
                    self.launches[k] += self.hk.launches[k] - before[k]
            return out

        return timed

    def report(self) -> dict:
        return {"compactions": self.compactions, "files_rewritten": self.rewritten, "files_upgraded": self.upgraded,
                "seconds": {k: round(v, 4) for k, v in self.seconds.items()},
                "merge_input_rows": self.merge_rows, "launches_in_compactions": dict(self.launches)}


def compact_phase(pt, hk, warehouse: str) -> dict:
    """Config 4 at full size through StreamWriteBuilder, then a full
    compaction in one batch commit; each step's read checked."""
    from paimon_tpu_torch.catalog import FileSystemCatalog
    from paimon_tpu_torch.core.snapshot import SnapshotManager

    cat = FileSystemCatalog(warehouse, commit_user="chip_smoke", device=DEVICE)
    schema = pt.RowType.of(("id", pt.BIGINT(False)), ("v", pt.DOUBLE()), ("tag", pt.STRING()))
    table = cat.create_table("c4.stream", schema, primary_keys=["id"], options=dict(C4_OPTIONS))
    snapshots = SnapshotManager(table.file_io, table.path)
    rng = np.random.default_rng(2)
    last_commit = np.full(C4_ROWS // 2, -1, dtype=np.int64)
    batches = []
    for b in range(C4_COMMITS):
        batches.append(c4_batch(rng, b))
        last_commit[batches[-1]["id"]] = b
    out: dict = {"config": "BASELINE config 4 (benchmarks/baseline_configs.py:148), scale 1",
                 "options": C4_OPTIONS, "rows_written": C4_ROWS, "k1_max_rows": hk._FUSE_MAX_ROWS}
    hk.reset_launches()
    with CompactionProbe(hk) as stream_probe:
        wb = table.new_stream_write_builder()
        w, c = wb.new_write(), wb.new_commit()
        kinds = []
        t0 = time.perf_counter()
        for b, batch in enumerate(batches):
            w.write(batch)
            kinds += [snapshots.snapshot(i).commit_kind.value for i in c.commit_messages(b + 1, w.prepare_commit())]
        torch.cuda.synchronize()
        write_s = time.perf_counter() - t0
    write_launches = dict(hk.launches)
    out["stream"] = {"commits": C4_COMMITS, "snapshots": {k: kinds.count(k) for k in sorted(set(kinds))},
                     "write_s": round(write_s, 4), "ingest_rows_per_s": round(C4_ROWS / write_s, 1),
                     **stream_probe.report(), "launches": write_launches,
                     "levels_after": level_layout(table)}
    assert kinds.count("COMPACT") >= 1, f"no COMPACT snapshot in {C4_COMMITS} commits: {kinds}"
    out["stream"]["read"] = check_c4_read(table, last_commit, "after 20 commits")

    with CompactionProbe(hk) as full_probe:
        t0 = time.perf_counter()
        wb = table.new_batch_write_builder()
        w = wb.new_write()
        w.compact(full=True)
        full_kinds = [snapshots.snapshot(i).commit_kind.value for i in wb.new_commit().commit(w.prepare_commit())]
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t0
    layout = level_layout(table)
    out["full"] = {"snapshots": full_kinds, "step_s": round(full_s, 4), **full_probe.report(),
                   "levels_after": layout}
    assert full_kinds == ["COMPACT"], full_kinds
    assert list(layout) == [str(table.store.options.num_levels - 1)], f"not all at the max level: {layout}"
    out["full"]["read"] = check_c4_read(table, last_commit, "after the full compaction")
    phase = dict(hk.launches)
    full = {k: full_probe.launches[k] for k in phase}
    out["launches"] = {"phase": phase, "streaming_writes": write_launches, "full_compaction": full,
                       "reads": {k: phase[k] - write_launches[k] - full[k] for k in phase}}
    assert phase["sort_segments"] > 0, f"K1 never launched on the compaction path: {out['launches']}"
    assert phase["keep_last_mask"] > 0, (
        f"K2 never launched on the compaction path (largest merge {max(stream_probe.merge_rows, default=0)} rows, "
        f"K1 admits up to {out['k1_max_rows']}): {out['launches']}")
    return out


def k1_timing(hk, rng, dev, launches: int, shape) -> dict:
    """K1's row at one (nl, m, nb) shape: kernel, plain and library times,
    bound, and the error against the plain version."""
    nl, m, nb = shape
    x, _ = k1_input(hk, rng, m, nl, dev)
    err = (hk.sort_segments(x, nb) - hk.sort_segments_plain(x, nb)).abs().max().item()

    def k1_library():
        s = x[:, hk.lexsort_lanes(list(x[: nl - 1]))]
        return (s[:nb, 1:] != s[:nb, :-1]).any(0)

    k1_bytes = nl * m * 4 + 3 * m * 4
    k1_ops = nl * m * max(1, m.bit_length() - 1)  # comparison-sort lower bound, lane compares
    row = kernel_row(
        "sort_segments (K1)", "paimon_tpu_torch/csrc/sort_segments.cu", "paimon_tpu/ops/pallas_kernels.py:198",
        launches, err, cuda_ms(lambda: hk.sort_segments(x, nb)), cuda_ms(lambda: hk.sort_segments_plain(x, nb)),
        k1_bytes, k1_ops, cuda_ms(k1_library), [nl, m, nb],
    )
    row["host_ms_per_call"] = host_ms(lambda: hk.sort_segments(x, nb))
    return row


def host_ms(fn, calls: int = 100) -> float:
    """The host's time per call of fn, without a synchronise: where it
    exceeds the device time, back-to-back calls (and so `ms`) are bound by
    the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return round(ms, 5)


def l2_evicting_copies(x: torch.Tensor) -> list:
    """Copies of x that together exceed the L2 cache twice over: cycling
    through them, each call finds its input evicted by the calls between."""
    return [x.clone() for _ in range(max(3, -(-2 * L2_BYTES // (x.numel() * 4)) + 1))]


def rotating(fn, inputs: list):
    """A callable that applies fn to the next of inputs, in turn."""
    it = itertools.cycle(inputs)
    return lambda: fn(next(it))


def device_ms(fn, labels: dict, calls: int = 20, tries: int = 3) -> dict:
    """Device ms per call of fn, from torch.profiler over `calls` calls: for
    each label, the kernels whose name holds its substring ("" takes every
    kernel). A session that records none of them (the tracer now and then
    returns no kernel) is repeated, up to `tries`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        split = dict.fromkeys(labels, 0.0)
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
            for label, part in labels.items():
                if part in e.key:
                    split[label] += us / 1e3 / calls
                    break
        if all(split.values()):
            break
    return {k: round(v, 5) if v else "not measured" for k, v in split.items()}


def kernel_row(name, source, replaces, launches, err, ms, plain_ms, nbytes, ops, library_ms, shape) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR32_OPS_PER_S * 1e3
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": err,
        "ms": round(ms, 5),
        "plain_ms": round(plain_ms, 5),
        "bound_ms": round(max(t_bytes, t_ops), 5),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": round(library_ms, 5),
        "shape": shape,
    }


if __name__ == "__main__":
    sys.exit(main())
