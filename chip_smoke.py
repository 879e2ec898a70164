#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (paimon_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root

Phases, one JSON line each on stdout:

1. card     - `nvidia-smi --query-gpu=name,power.limit` (also printed raw).
2. build    - nvcc builds the three kernels from paimon_tpu_torch/csrc
              (seconds), and each kernel's registers, shared memory and
              spills as `-Xptxas -v` reports them (no spills allowed); cc
              builds the zstd, snappy, Avro, lz4 and ORC codecs from
              paimon_tpu_torch/native/ (zstd.c, snappy.c, avrodec.c, lz4.c,
              orcdec.c).
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
              segment_sum (the sorted-order float sum of the aggregation
              engine) against its plain version bit for bit (any NaN equal
              to any NaN), twice a case: float64 and float32 x 7 sizes x 5
              segment patterns (lengths 1-8, all 1, one segment, up to 3000,
              and -0.0/+0.0/NaN/+-inf values); whether torch's own
              segment_reduce and index_add_ give the same bits is reported.
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
7. engines  - the partial-update, aggregation and first-row merge engines,
              one line per part. BASELINE config 2 at 10M rows (4 commits
              of 2.5M, partial-update, write-only, default codecs,
              sort-engine=pallas): write seconds, 5 read samples with input
              rows/s, one read under the benchmark's predicate (a >= 100
              AND b < 500) held to the oracle, a staged read (decode, lane
              encode, merge, gather) and one read under torch.profiler;
              every read equal to the numpy and xla-segmented engines and
              to the oracle. BASELINE config 3
              at scale 1 (4M rows, sum/max, ORC, bucket 1): write, read,
              then a full compaction in one batch commit (seconds, input
              bytes, GB/s), each read equal to the numpy engine and the
              oracle; before and after the compaction the ORC files'
              stripes, bytes on disk and the decode ms of reading them
              whole. Then one small table per engine (partial-update with
              remove-record-on-delete and -D rows; aggregation with every
              fused function and retractions; aggregation with product,
              listagg and primary-key; first-row), 5 commits of 20,000 rows
              so every merge takes K1, each read at all three sort engines
              and equal. The cuts are listed in the lines. Launches of each
              kernel per part, zeroed before it.
8. buckets  - buckets and partitions, one line per part. BASELINE config 3
              at scale 1 at its own 8 buckets beside the bucket-1 control
              (write, read, a traced read, then a full compaction on a
              write-only=false handle: seconds, input bytes, GB/s, files per
              bucket). BASELINE config 5 at its 16 buckets, scale 5: 10M
              rows in 4 batch commits (id, x, y, v; write-only), a checked
              and a traced read, then DedicatedCompactor(table).run_once(
              full=True) (seconds, input bytes, GB/s, rows/s); then its
              z-order half: the append clone db.c5z (bucket 1) with one
              commit of 500,000 rows drawn after the four batches,
              sort_compact by zorder, and by hilbert and order on copies,
              each held to the rows' multiset, to a sort-engine=numpy
              sort-compact of another copy row for row, and to curve codes
              that do not decrease in file order (rows/s each). The bench
              table with a dt partition column (4
              values) at default options, so dynamic buckets of at most
              100,000 keys: 4 runs and the 100k upsert (write seconds with the
              assigner's host seconds apart, buckets per partition; the upsert
              must leave the hash index as it was and every row must sit in
              the bucket whose index holds its key), 5 reads and a traced one,
              and one read filtered to the first partition (dt = its value),
              which must plan only that partition's splits and return its
              rows of the unfiltered read.
              Every read equals a sort-engine=numpy read and an oracle built
              from the generator. K1 and K2 launches per part, split between
              the writes' flushes, compactions and reads; the cuts are listed.
9. strings  - string primary keys, one line per part. The bench table with
              id STRING NOT NULL: the seed-7 ids in TPC-DS's business-key
              form (16 characters over A-P, one per 4-bit digit, least
              significant first, as dsdgen writes c_customer_id), the same
              runs, upsert and options; write seconds, 5 reads at each tier
              (the default tile, stock sort + K2; 131072, K1), each equal to
              a sort-engine=numpy read and to the generator's rows in
              business-key order, with the BIGINT table's rows/s of the main
              phase beside them; a staged read per tier with the pool and
              ranks a stage of their own and their share; one traced read.
              BASELINE config 4 as in the compact phase, its ids in the same
              business-key form. The partial-update, fused aggregation
              (float sums: segment_sum) and first-row small tables keyed by
              (tenant STRING, id BIGINT), the tenants holding '', prefix-
              equal strings, non-ASCII text, a supplementary-plane character
              and a trailing U+0000, each read at all three sort engines.
              K1, K2 and segment_sum must each launch on this path.
10. maintenance - commit-time maintenance, one line per part. BASELINE
              config 4 at scale 1 (as in the compact phase) three times:
              at default options (a control: nothing is an hour old), then
              with snapshot.num-retained.max=10 (standing in for an hour of
              snapshot.time-retained, the cut) expiring after every commit,
              synchronously and under snapshot.expire.execution-mode=async
              (joined after each commit); a tag on snapshot 3 after the third
              commit and a consumer at the latest snapshot after the tenth.
              Write seconds, post-commit seconds with expiry apart,
              snapshots, manifest and data files left, and checks: the read
              equals the numpy engine and the oracle, every file a retained
              snapshot or tag references is there, no data file is left
              that none references. The partitioned dynamic-bucket table of
              `buckets` with dt the four days up to today and
              partition.expiration-time=2 d checked at every commit: the two
              oldest days go (OVERWRITE snapshots), the read equals the
              oracle over the two kept; drop_partition on yesterday, then two
              commits that merge every manifest and keep one snapshot, with
              snapshot.expire.clean-empty-directories: the dropped days'
              directories must be gone. A small table with
              commit.force-create-snapshot, automatic tags (keeping 1) and a
              commit callback of this script: 3 commits and an empty one
              give 4 snapshots, 1 tag and 4 calls. K1 and K2 must launch on
              the expiring config 4 run.
11. cdc     - CDC sink tables, one line per part. BASELINE config 4 at
              scale 1 with ts BIGINT NOT NULL (an update time in epoch
              millis) as sequence.field, a tenth of each commit's rows of
              ids already written carrying a ts up to an hour older than
              their id's newest (late events, which must lose), three times:
              under changelog-producer=input, lookup and full-compaction
              (then a full compaction), beside the compact phase's run as the
              control. Write seconds with compaction and lookup seconds
              apart, snapshots by kind, changelog files and rows, K1 and K2
              launches split into flushes, lookups, compactions, replay
              checks and reads. Each read equals the numpy engine and the
              oracle (per id the largest (ts, arrival)); the input
              changelog is the input rows; the lookup changelog replayed
              from an empty table gives the final read; the full-compaction
              changelog replays to the max level at each compaction that
              wrote changelog and to the read after the full compaction.
              Then the sequence-group table of Apache Paimon's partial-update
              docs (k, a, b, g_1, c, d, g_2; g_1 governs a, b and g_2 c, d;
              c summed) at config 2's size: 10M rows in 4 commits of 2.5M,
              two streams alternating, each filling one group, 5% of a
              stream's second commit with an older group sequence and 1%
              with none; write seconds, 5 reads with input rows/s, each equal
              to the numpy and xla-segmented engines and the oracle, and a
              staged read with the group plans a stage of their own. K1 and
              K2 are then held exactly to their plain versions at every
              shape the path called them at that the kernels phase skips.
12. deletes - row-level deletes, one line per part. The bench table (as in
              main) with deletion-vectors.enabled: DELETE of 50,000 ids drawn
              with seed 9 (an erasure by key), then DELETE WHERE c2 = 13
              (upserted keys whose older version has c2 = 13 must stay, with
              their newest values); seconds, rows deleted, vector positions,
              containers and bytes. 5 reads at each tier and two filtered
              reads (id BETWEEN 400,000 AND 449,999; d1 > 250,000), each equal
              to the numpy engine and to an oracle kept from the ids written,
              upserted and deleted, with rows/s and splits and files pruned;
              one traced read; then compact(full=True) on a write-only=false
              handle: every file with a vector rewritten, no DELETION_VECTORS
              entry left, the rows unchanged. Then BASELINE config 4 at scale
              1 with ts BIGINT (epoch millis from the run's clock, two hours
              old for a tenth of the ids) under record-level.expire-time=1 h:
              20 streaming commits, the read without the expired ids, a full
              compaction that leaves only the live rows on disk. K1 and K2
              launches split into writes, deletes, reads and compaction; K1
              and K2 then held exactly to their plain versions at the path's
              shapes that the kernels and cdc phases did not check.
13. history - table history, one line per part, on a copy of the main
              phase's bench table (snapshots 1-4 the four runs, 5 the
              upsert; tag t2 on snapshot 2), so no later phase sees it:
              reads under scan.snapshot-id=2, scan.tag-name=t2,
              scan.version=t2, scan.timestamp-millis (snapshot 2's time)
              and scan.snapshot-id=4, each at both tiles; the delta reads
              incremental-between=4,5 (the upsert, all +I) and t2,5
              (600,000 rows, compared as a multiset of rows with kinds);
              branch b from t2 with the upsert written to it through
              branch_table, the branch and main read, rollback_to("t2") on
              main (the data files only snapshots 3-5 listed must be
              deleted, the branch's kept), main read, fast_forward("b"),
              main read (the branch's rows), and every file main's or the
              branch's latest snapshot lists must exist. Every read equals a
              sort-engine=numpy read under the same options and an oracle
              from the generator. Then BASELINE config 4 at scale 1 with
              snapshot.num-retained.max=10 under a stream reader with
              consumer-id set, planning until nothing is new after each
              commit: COMPACT snapshots give no split, the deltas applied
              to a key -> row map equal the oracle (and the batch read,
              held to it) after commits 5, 10 and 20, the reader's
              checkpoint completes after commits 10 and 20, and expiry
              keeps every snapshot from the consumer's position on; then a
              full compaction and a compacted-full starting plan equal to
              the batch read. Seconds per part, rows, splits and files per
              read and per plan, files rollback deleted, K1 and K2 launches
              per part; K1 and K2 then held exactly to their plain versions
              at the path's shapes no earlier check covered.
14. writes  - the write surface, one line per part (each run with
              sort-engine=pallas where the table is keyed, every read held
              to a sort-engine=numpy read and an oracle). overwrite: copies
              of the buckets phase's partitioned table (a dynamic-partition
              overwrite of one day with 275,000 rows, then a static one of
              another day under dynamic-partition-overwrite=false; the
              untouched days unchanged, each overwritten day exactly its new
              rows) and of the bench table (a whole-table overwrite with its
              100,000-row upsert batch, then a full refresh with all
              1,100,000 rows in one batch), each an OVERWRITE snapshot, read
              at both tiles. rowkind: config 4 with op STRING as
              rowkind.field, 5% of each later commit -D rows of ids written
              before. local_merge: config 4 under local-merge-buffer-size=64
              mb (one drain a commit) and 1 mb (several), each commit in 10
              writes, beside the compact phase's run. cross_partition: the
              partitioned bench schema keyed by id alone at default options,
              the four runs and the upsert moving about 75% of its ids to
              another day on one write, then a new write that bootstraps the
              global index from the files and 50,000 more upserts; every id
              once, in its last day. append: config 5's append clone (4
              commits, a full compaction), and an unaware-bucket log table
              partitioned by dt (20 commits of 50,000 events under a
              consumer's stream reader, value-filtered reads, a DELETE by
              copy-on-write), rows in the order written; no kernel may
              launch there. Seconds, rows, files and launches per part; K1
              and K2 then held exactly to their plain versions at the path's
              shapes no earlier check covered.
15. services - the compaction services and schema evolution, one line per
              part, every read held to a sort-engine=numpy read and an
              oracle. rescale: a copy of the bench table (bucket 1) through
              rescale_table to 4 buckets; the read after equals the read
              before, a read pinned at the snapshot before the rescale too,
              and every row sits in hash(id) % 4. adaptive: config 4 written
              write-only while an AdaptiveCompactorService at its default
              options (ingest gate on) compacts on its own thread; rounds,
              compactions, the compaction metric group, the largest
              sorted-run count against the read-amp ceiling; then a
              DedicatedCompactor round. coordinator: a copy of the writes
              phase's event log given deletion-vectors.enabled by ALTER TABLE
              and a DELETE through vectors, then compacted by
              AppendCompactionCoordinator and execute_compaction_task; the
              deleted rows stay deleted, no kernel launches. evolution:
              config 4 with ALTER TABLE ADD src STRING, RENAME tag TO label
              after commit 10 (compactions merge files of both schemas;
              reads at both tiles, old rows with src null); the
              aggregation_fused small table with c_max widened from INT to
              BIGINT and f_sum from FLOAT to DOUBLE after half its commits,
              then a full compaction, each read equal across sort engines
              and to a control table written wide from the start
              (segment_sum must launch). Seconds, rows, files and launches
              per part; K1 and K2 then held exactly to their plain versions
              at the path's shapes no earlier check covered.
16. lookups - point lookups and lookup joins, one line per part. gets: the
              table of benchmarks/point_get_bench.py (1M rows of id BIGINT
              NOT NULL, c1, s1, d1; even ids only, 4 sorted runs, bucket 1,
              write-only, file-index.bloom-filter.primary-key.enabled,
              sort-engine=pallas): 5 batches of 10,000 keys (about half
              absent) through LocalTableQuery.get_batch, each held to the
              generator, the last also to the scalar lookup walk (gets/s of
              each); 64 absent odd keys on a cold data-file cache with
              lookup.get.bloom-prune.enabled true and false (files pruned
              and decoded); a get with 10,000 rows buffered in an attached
              TableWrite (5,000 updates, 5,000 new ids). star_join: the
              tables of benchmarks/join_bench.py (a dimension of 100,000
              customers, cid STRING NOT NULL key, then a commit updating
              10,000 of them; a fact table of 1M rows in 4 commits with
              uniform, zipf and hot50 customer keys, read on the value path;
              the dict_domain phase reads them again under
              merge.dict-domain), and per skew join_batches
              under auto (the hash probe on the card), sort-merge with
              sort-engine=pallas (K2 at m = 2^21), xla-segmented and numpy,
              hot50 also at join.chunk-rows=131072 (K1 per partition), every
              engine's pairs equal to a host dict loop's. lookup_join:
              FullCacheLookupTable over the dimension (its bootstrap merges
              the two commits), lookup_join of the 1M fact rows held to the
              materialised LEFT join_batches, then 1,000 dimension changes
              (700 updates, 200 -D rows, 100 new customers), a refresh, and
              the checks again. Seconds, launches and cache counters per
              part; K1 and K2 must launch on the join path, and are then
              held exactly to their plain versions at the path's shapes no
              earlier check covered.
17. sql     - the SQL surface through paimon_tpu_torch.sql.execute, one
              line per part, every statement timed (seconds, rows, launches,
              and the scan / join / GROUP BY split) and its result held,
              outside the timing, to a numpy oracle and to the same
              statement under the numpy sort engine (float sums of the
              star join within 1e-12 of it, since numpy adds pairwise).
              select, on the main phase's bench table: SELECT * beside the
              Table-API read; SELECT id, c1 WHERE id < 100,000 and its
              EXPLAIN; count, sum(c1), min(d1), max(d2) and avg(d1) GROUP BY
              s2 over 1M rows (the stock sort + K2 at 2^20; the float sum
              through segment_sum), the same WHERE id < 200,000 GROUP BY s1
              HAVING count(*) > 150 (2^18 padded rows: K1), and GROUP BY c3
              (217,480 groups: id // 7, and -(id // 7) for the upserted
              ids) ORDER BY c3 LIMIT 20. join, on the
              lookups phase's star schema: the grouped inner join by name
              per skew (zipf, uniform) ORDER BY name LIMIT 50, and a LEFT
              join WHERE d.rate > 0.5. dml: CREATE TABLE with config 4's
              options and the bench columns, INSERT ... SELECT of the bench
              table, UPDATE of 50,000 ids, DELETE WHERE c2 = 0, CALL
              sys.merge_into of 10,000 source rows (5,000 matched, 5,000
              new), CALL sys.compact (full), ANALYZE, $snapshots and $files,
              TRUNCATE, each followed by a read equal to the oracle. K1, K2
              and segment_sum must each launch in the phase, and K1 and K2
              are then held exactly to their plain versions at its shapes
              no earlier check covered.
18. dict_domain - merge.dict-domain, one line per part, with the schemas
              and workloads of benchmarks/dict_domain_bench.py:37-101 and
              :161-260 at sort-engine=pallas, write-only, no data-file
              cache: dict_heavy (1M rows in 4 commits; key (k BIGINT, cat
              STRING of 200 values), STRING payloads of 800, 12, 300 and
              40 values), mixed and non_dict (400,000 rows each; non_dict
              never engages the code domain). Per schema, with the option
              on and off: the merge read of one physical table flipped with
              table.copy at the default tile (stock sort + K2) and at
              131072 (K1), 3 reads each, and a staged read split into key
              decode, key lanes, plan/upload/kernel/download, value decode
              and gather; the full-compaction rewrite of a copy of the
              table; sort_compact(order="order") of a copy of an append
              table at n / 2 rows in 2 commits. Every result equals the
              option-off result and a sort-engine=numpy read (outside the
              timed region); the rewritten files re-read with the option
              off. Seconds, rows/s, the dict counters (rows_code_domain > 0
              on dict_heavy and mixed, 0 on non_dict and off) and K1/K2
              launches per workload. star_join: the lookups phase's tables
              read with the option on, one auto join per skew beside the
              value path's ms, pairs equal to a host dict loop's, with
              code_domain_joins and the columns that came back coded.
              torch_ops: unpack_bits_torch, pack_bits_torch and
              gather_torch held exactly to their numpy twins at widths 1-32
              and 1 MiB page sizes, device and host ms per call; dict_heavy
              read once under set_decode_engine("torch") and its rows
              written once under set_encode_engine("torch"), equal to the
              numpy engines (the file bytes identical). K1 and K2 then held
              exactly to their plain versions at the phase's shapes no
              earlier check covered.
19. buffers_formats - the write-buffer surface and the reference's other
              files, one line per part, at the bench table's width (1M
              rows, 4 overlapping runs and the 100k upsert, bucket 1,
              sort-engine=pallas, write-only). throttled: the ingest in
              50,000-row writes under write.buffer.max-memory at a quarter
              of its buffered bytes (writes_throttled > 0, none rejected,
              nothing left reserved after each commit), rows equal to the
              main table's. parquet_snappy, parquet_gzip, avro, orc_zstd,
              orc_lz4, parquet_lz4: the table in those pages, Avro data
              files or ORC files, all with Avro manifests (each file's
              codec or container checked; ORC stripes counted), read twice
              with pallas at the default tile (K2), once at 131072 (K1)
              and once with numpy, plus a staged read (decode, lanes,
              merge, gather; page or stream decompression apart for
              parquet and ORC, with its output MB/s).
              key_columns: data-file.include-key-columns=true (_KEY_id
              leads every file). spill: a 1M-row append table in one
              commit of 50,000-row writes under write-buffer-spillable
              with write-buffer-spill.rows 262,144 (bytes spilled, files'
              rows, every row in written order, no launch).
              null_partitions: the table partitioned by dt STRING and h
              INT, each null for 5% of the ids, bucket 2 (the
              default-name directories, a dt IS NULL read, the partitions
              system table). Every read equals the numpy engine and the
              oracle. K1 must launch in every part but spill; then K1 and
              K2 are held exactly to their plain versions at the phase's
              shapes no earlier check covered.
20. nested  - ARRAY, MAP and ROW columns in Parquet zstd (bucket 1,
              sort-engine=pallas, write-only), one line per part.
              aggregation: a profile table of the kind the reference's
              nested aggregators serve, 250,000 BIGINT keys in 4 commits of
              250,000 rows (every key once per commit: 1M rows in 4
              overlapping sorted runs): tags ARRAY<STRING> collect with
              distinct (0-4 of 1,000 strings), attrs MAP<STRING, BIGINT>
              merge_map (0-4 of 64 keys), items ARRAY<ROW<sku BIGINT, qty
              INT>> nested_update keyed by sku (0-3 of 10,000 skus), spend
              DOUBLE sum (segment_sum); 5% of the nested values null and 5%
              empty. dedup: the bench table's rows (4 runs and the 100k
              upsert) with tags and attrs added. Each table written (s,
              bytes on disk), read at the default tile (K2) and at 131072,
              fully compacted and read again; every read equal row for row
              to the numpy engine's. A staged read per table: the leaves'
              levels, the assembly, the merge (plan, upload, kernel,
              download) and, for the aggregation, the host aggregate per
              column. K1, K2 and segment_sum must launch in the phase; then
              K1 and K2 are held exactly to their plain versions at the
              phase's shapes no earlier check covered.
21. timing  - each kernel at its main-path shape against its plain version,
              one PyTorch library computation of the same function, and its
              bound, all with CUDA events, and the wrapper's host time per
              call. K1 also at the write-flush shape and at (8, 2^18), and
              its device time at the read-tile and widest shapes split
              between the block sort and the merge rounds (torch.profiler).
              K2's device time and the library call's, by torch.profiler,
              with the input warm in L2 (as the main path hands it over)
              and cold (cycling over copies that exceed the L2).
              segment_sum at the engines path's float64 shape.

Then a summary line (each phase's wall seconds, its launches of each kernel
and the first rate it reports), one JSON line with every kernel's numbers
(its launches summed over the main, compact, engines, buckets, strings,
maintenance, cdc, deletes, history, writes, services, lookups, sql,
dict_domain, buffers_formats and nested paths, and by path), the card line, and last
`{"ok": true, "device": {...}}`. Any failed check raises, so the exit code
is not 0 and no result line is printed; without a CUDA device the script
exits 2 before doing anything.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
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
# BASELINE config 2 (benchmarks/baseline_configs.py:66) at scale 5, the 10M
# rows BASELINE.json names: a partial-update table, 4 commits of 2.5M rows
# over the same ids with alternating null columns
C2_ROWS = 10_000_000
C2_OPTIONS = {"bucket": "1", "merge-engine": "partial-update", "write-only": "true", "sort-engine": "pallas"}
# BASELINE config 3 (:107) at scale 1: an aggregation table, 4 commits of 1M
# rows over ids in [0, 500,000) from default_rng(1)
C3_ROWS = 4_000_000
C3_OPTIONS = {"bucket": "1", "file.format": "orc", "merge-engine": "aggregation",
              "fields.sum_col.aggregate-function": "sum", "fields.max_col.aggregate-function": "max",
              "write-only": "true", "sort-engine": "pallas"}
# BASELINE config 5 (:177) at scale 5: 4 batch commits of 2.5M rows over ids
# in [0, 10M) from default_rng(3), 16 buckets, write-only
C5_ROWS = 10_000_000
C5_OPTIONS = {"bucket": "16", "write-only": "true", "sort-engine": "pallas"}
# the partitioned table at default options: dynamic buckets of at most
# P_TARGET keys, so each of the 4 partitions (250,000 keys) takes 3
P_DTS = np.array(["2024-01-01", "2024-01-02", "2024-01-03", "2024-01-04"], dtype=object)
P_TARGET = 100_000
P_OPTIONS = {"sort-engine": "pallas", "dynamic-bucket.target-row-num": str(P_TARGET)}
# the small per-engine tables: commits of this many rows over 1.5x as many
# ids, so that every flush and read merges fewer than 2^18 rows (K1)
SMALL_ROWS, SMALL_COMMITS = 20_000, 5
READ_REPEATS = 5
BIG_READ_REPEATS = 3  # timed reads of the 10M-row tables (config 2, the sequence groups)
DEVICE = "cuda:0"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
L2_BYTES = 50 << 20  # H100 SXM L2 cache
SCALAR32_OPS_PER_S = 67e12  # H100 SXM 32-bit rate outside the tensor cores, NVIDIA data sheet
FP64_OPS_PER_S = 34e12  # H100 SXM float64 rate outside the tensor cores, NVIDIA data sheet
K1_K2 = ("sort_segments", "keep_last_mask")


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
            if (ty := re.match(r"I([df])E", mangled[pos:])) is not None:  # a float-type template argument
                args = {"d": "double", "f": "float"}[ty.group(1)]
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


def build_schema(pt, id_type=None):
    return pt.RowType.of(
        ("id", id_type or pt.BIGINT(False)),
        ("c1", pt.BIGINT()),
        ("c2", pt.BIGINT()),
        ("c3", pt.BIGINT()),
        ("d1", pt.DOUBLE()),
        ("d2", pt.DOUBLE()),
        ("s1", pt.STRING()),
        ("s2", pt.STRING()),
    )


def build_table(pt, warehouse: str, name: str, extra_options: dict, values=table_values, id_type=None):
    """bench.py's table (bench.py:54-96) with bench.py's options plus
    sort-engine=pallas and extra_options, and the upsert commit; `values`
    makes the rows of given ids (and `id_type` types their key)."""
    from paimon_tpu_torch.catalog import FileSystemCatalog

    cat = FileSystemCatalog(warehouse, commit_user="chip_smoke", device=DEVICE)
    table = cat.create_table(f"bench.{name}", build_schema(pt, id_type), primary_keys=["id"],
                             options={**BENCH_OPTIONS, **extra_options})
    rng = np.random.default_rng(7)
    ids = rng.permutation(N_ROWS).astype(np.int64)
    per = N_ROWS // N_RUNS
    t0 = time.perf_counter()
    for r in range(N_RUNS):
        wb = table.new_batch_write_builder()
        w = wb.new_write()
        w.write(values(np.sort(ids[r * per : (r + 1) * per]), upsert=False))
        wb.new_commit().commit(w.prepare_commit())
    # the upsert batch arrives unsorted: its flush dedups on the device too
    up = np.random.default_rng(8).choice(N_ROWS, N_UPSERT, replace=False).astype(np.int64)
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.write(values(up, upsert=True))
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


def read_stats(samples: list, launches: dict | None = None, rows: int = N_ROWS, input_rows: int | None = None) -> dict:
    median = float(np.median(samples))
    out = {"samples_s": [round(s, 4) for s in samples], "median_s": round(median, 4),
           "output_rows_per_s_median": round(rows / median, 1),
           "input_rows_per_s_median": round((N_ROWS + N_UPSERT if input_rows is None else input_rows) / median, 1)}
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


def layer_breakdown(table, tile_rows: int, keys: tuple = ("id",), rows: int | None = N_ROWS) -> dict:
    """One keys-only merge read, timed stage by stage (host clock, device
    synchronised at each boundary), and, for parquet files, the
    decompression of every page its two decode stages decode, timed apart.
    A string key's stage is its pool and ranks."""
    from paimon_tpu_torch.core.kv import VALUE_KIND_FIELD_NAME, KVBatch
    from paimon_tpu_torch.core.levels import IntervalPartition
    from paimon_tpu_torch.core.read import order_runs_for_merge
    from paimon_tpu_torch.data.keys import encode_key_lanes_with_pools
    from paimon_tpu_torch.ops.merge import deduplicate_resolve_tiled, deduplicate_tiled_dispatch
    from paimon_tpu_torch.types import STRING_ROOTS

    keys = list(keys)
    t = table.copy({"merge.read-batch-rows": str(tile_rows)})
    store = t.store
    (split,) = t.new_read_builder().new_scan().plan()
    rf = store.reader_factory(split.partition, split.bucket)
    (section,) = IntervalPartition(split.files).partition()
    runs, seq_ascending = order_runs_for_merge(section)
    files = [f for run in runs for f in run.files]
    ms = {}
    t0 = time.perf_counter()
    heads = [rf.read(f, fields=keys, system_columns="kind" if seq_ascending else True) for f in files]
    kv_keys = KVBatch.concat(heads)
    ms["decode_keys"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    lanes = encode_key_lanes_with_pools(kv_keys.data, keys)
    string_key = any(rf.read_schema.field(k).type.root in STRING_ROOTS for k in keys)
    ms["pool_and_ranks" if string_key else "encode_lanes"] = (time.perf_counter() - t0) * 1e3
    offsets = np.cumsum([0] + [h.num_rows for h in heads]).tolist()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    take = deduplicate_resolve_tiled(deduplicate_tiled_dispatch(lanes, offsets, tile_rows, "pallas", True, DEVICE))
    ms["plan_upload_kernel_download"] = (time.perf_counter() - t0) * 1e3
    rest = [n for n in rf.read_schema.field_names if n not in keys]
    t0 = time.perf_counter()
    tails = [rf.read(f, fields=rest, system_columns=False) for f in files]
    ms["decode_values"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    tail = KVBatch.concat(tails).take(take)
    kv_keys.take(take)
    ms["gather"] = (time.perf_counter() - t0) * 1e3
    assert rows is None or tail.num_rows == rows
    decompress = "not parquet or ORC"  # an Avro block is one deflate stream, inside decode
    for ext, fn in ((".parquet", decompress_pages), (".orc", decompress_orc_streams)):
        if all(f.file_name.endswith(ext) for f in files):
            raws = [store.file_io.read_bytes(f"{rf.bucket_dir}/{f.file_name}") for f in files]
            decompress = {"keys": fn(raws, keys + [VALUE_KIND_FIELD_NAME]), "values": fn(raws, rest)}
    return {"tile_rows": tile_rows, "seq_ascending": seq_ascending, "ms": {k: round(v, 3) for k, v in ms.items()},
            "decompress_pages": decompress}


def decompress_pages(raws: list, columns: list) -> dict:
    """Every page of `columns` in the data files `raws`, taken apart and
    decompressed as the reader does it, without decoding the values."""
    from paimon_tpu_torch.decode.container import decompress_page, iter_pages, parse_footer

    out_bytes = 0
    t0 = time.perf_counter()
    for raw in raws:
        for _, chunks in parse_footer(raw):
            # a nested column's chunks are its leaves, keyed by column path
            for chunk in (c for path, c in chunks.items() if path.split(".")[0] in columns):
                out_bytes += sum(len(decompress_page(chunk, kind, hdr, page)) for kind, hdr, page in iter_pages(raw, chunk))
    s = time.perf_counter() - t0
    return {"ms": round(s * 1e3, 3), "out_mb": round(out_bytes / 1e6, 3), "out_mb_per_s": round(out_bytes / 1e6 / s, 1)}


def decompress_orc_streams(raws: list, columns: list) -> dict:
    """Every stream of `columns` in the ORC files `raws`, located and
    decompressed as the reader does it, without decoding the values."""
    from paimon_tpu_torch.format.orc import decompress_column_streams

    t0 = time.perf_counter()
    out_bytes = sum(decompress_column_streams(raw, columns) for raw in raws)
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
    from paimon_tpu_torch.native import build_native
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
    native_libraries = build_native()
    codec_build_s = time.perf_counter() - t0
    k1_usage = ptxas_usage(hk.build_log("sort_segments"))
    k2_usage = ptxas_usage(hk.build_log("keep_last_mask"))
    sum_usage = ptxas_usage(hk.build_log("segment_sum"))
    tile = hk.K1_TILE
    instances = [f"{kernel}<{nl}>" for kernel in ("block_sort", "merge_round") for nl in range(2, 9)]
    missing = [k for k in instances if k not in k1_usage]
    assert not missing, f"ptxas reported no usage for {missing}"
    assert k2_usage, "ptxas reported no usage for K2"
    assert {"segment_sum_kernel<double>", "segment_sum_kernel<float>"} <= set(sum_usage), sum_usage
    usage = {**{k: k1_usage[k] for k in instances}, **k2_usage, **sum_usage}
    spilled = {k: v for k, v in usage.items() if v[2] or v[3]}
    columns = ["registers", "static_smem_bytes", "spill_store_bytes", "spill_load_bytes"]
    emit({"phase": "build", "seconds": round(build_s, 3), "kernels": list(hk.KERNEL_SOURCES),
          "native_codecs_seconds": round(codec_build_s, 3),
          "native_codecs": [os.path.basename(p) for p in native_libraries], "k1_tile": tile,
          "k1_ptxas": {"columns": columns, **k1_usage}, "k2_ptxas": {"columns": columns, **k2_usage},
          "segment_sum_ptxas": {"columns": columns, **sum_usage}})
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
    k2_s = time.perf_counter() - t0
    sum_checks = segment_sum_checks(hk, dev)
    checks += sum_checks["exact_checks"]
    emit({"phase": "kernels", "exact_checks": checks, "k1_exact_checks": k1_checks,
          "k2_exact_checks": k2_aligned + k2_misaligned, "k2_misaligned_view_checks": k2_misaligned,
          "k2_seconds": round(k2_s, 3), "segment_sum": sum_checks, "max_abs_err": 0})

    # 4. main path
    walls, results = {}, {}
    mark = [time.perf_counter()]

    def lap(name: str, result: dict) -> None:
        """The wall seconds since the previous phase ended, and its result."""
        now = time.perf_counter()
        walls[name], results[name] = now - mark[0], result
        mark[0] = now

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
        assert all(main_launches[k] > 0 for k in K1_K2), main_launches
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
        lap("main", reads)

        # 5. layers, and the device's busy share under the profiler
        emit({"phase": "layers", "default_tile": layer_breakdown(table, 8 << 20),
              f"tile_{K1_TILE_ROWS}": layer_breakdown(table, K1_TILE_ROWS),
              "uncompressed_default_tile": layer_breakdown(plain_table, 8 << 20),
              "on_disk": {"zstd": table_bytes(table), "uncompressed": table_bytes(plain_table)}})
        device_busy(table)  # the profiler's first use initialises its tracer: not counted
        emit({"phase": "trace", "default_tile": device_busy(table),
              f"tile_{K1_TILE_ROWS}": device_busy(table.copy({"merge.read-batch-rows": str(K1_TILE_ROWS)}))})
        lap("layers", {})

        # 6. the compaction path
        compact = compact_phase(pt, hk, warehouse)
        emit({"phase": "compact", **compact})
        lap("compact", compact)

        # 7. the merge engines
        engines = engines_phase(pt, hk, warehouse)
        emit({"phase": "engines", "part": "summary", **engines})
        lap("engines", engines)

        # 8. buckets and partitions
        buckets = buckets_phase(pt, hk, warehouse)
        emit({"phase": "buckets", "part": "summary", **buckets})
        lap("buckets", buckets)

        # 9. string keys
        strings = strings_phase(pt, hk, warehouse, reads)
        emit({"phase": "strings", "part": "summary", **strings})
        lap("strings", strings)

        # 10. commit-time maintenance
        maintenance = maintenance_phase(pt, hk, warehouse)
        maintenance["sync_write_launches_equal_compact_phase"] = (
            maintenance["sync_write_launches"] == compact["launches"]["streaming_writes"])
        emit({"phase": "maintenance", "part": "summary", **maintenance})
        lap("maintenance", maintenance)

        # 11. CDC sink tables
        cdc = cdc_phase(pt, hk, warehouse, compact)
        checks += cdc["shape_checks"]["exact_checks"]
        emit({"phase": "cdc", "part": "summary", **cdc, "exact_checks_all_phases": checks})
        lap("cdc", cdc)

        # 12. row-level deletes
        deletes = deletes_phase(pt, hk, warehouse, cdc["shape_checks"])
        checks += deletes["shape_checks"]["exact_checks"]
        emit({"phase": "deletes", "part": "summary", **deletes, "exact_checks_all_phases": checks})
        lap("deletes", deletes)

        # 13. table history
        checked = tuple([tuple(s) for p in (cdc, deletes) for s in p["shape_checks"][key]]
                        for key in ("k1_new_shapes", "k2_new_shapes"))
        history = history_phase(pt, hk, warehouse, table.path, checked)
        checks += history["shape_checks"]["exact_checks"]
        emit({"phase": "history", "part": "summary", **history, "exact_checks_all_phases": checks})
        lap("history", history)

        # 14. the write surface
        checked = tuple(list(checked[i]) + [tuple(s) for s in history["shape_checks"][key]]
                        for i, key in enumerate(("k1_new_shapes", "k2_new_shapes")))
        writes = writes_phase(pt, hk, warehouse, table.path, compact, checked)
        checks += writes["shape_checks"]["exact_checks"]
        emit({"phase": "writes", "part": "summary", **writes, "exact_checks_all_phases": checks})
        lap("writes", writes)

        # 15. the compaction services and schema evolution
        checked = tuple(list(checked[i]) + [tuple(s) for s in writes["shape_checks"][key]]
                        for i, key in enumerate(("k1_new_shapes", "k2_new_shapes")))
        services = services_phase(pt, hk, warehouse, table.path, checked)
        checks += services["shape_checks"]["exact_checks"]
        emit({"phase": "services", "part": "summary", **services, "exact_checks_all_phases": checks})
        lap("services", services)

        # 16. point lookups and lookup joins
        checked = tuple(list(checked[i]) + [tuple(s) for s in services["shape_checks"][key]]
                        for i, key in enumerate(("k1_new_shapes", "k2_new_shapes")))
        lookups = lookups_phase(pt, hk, warehouse, checked)
        checks += lookups["shape_checks"]["exact_checks"]
        emit({"phase": "lookups", "part": "summary", **lookups, "exact_checks_all_phases": checks})
        lap("lookups", lookups)

        # 17. the SQL surface
        checked = tuple(list(checked[i]) + [tuple(s) for s in lookups["shape_checks"][key]]
                        for i, key in enumerate(("k1_new_shapes", "k2_new_shapes")))
        sql = sql_phase(pt, hk, warehouse, table, up, checked)
        checks += sql["shape_checks"]["exact_checks"]
        emit({"phase": "sql", "part": "summary", **sql, "exact_checks_all_phases": checks})
        lap("sql", sql)

        # 18. the dictionary-code domain
        checked = tuple(list(checked[i]) + [tuple(s) for s in sql["shape_checks"][key]]
                        for i, key in enumerate(("k1_new_shapes", "k2_new_shapes")))
        dict_domain = dict_domain_phase(pt, hk, warehouse, lookups["star_join_auto_ms"], checked)
        checks += dict_domain["shape_checks"]["exact_checks"]
        emit({"phase": "dict_domain", "part": "summary", **dict_domain, "exact_checks_all_phases": checks})
        lap("dict_domain", dict_domain)

        # 19. the write-buffer surface and the reference's Avro, snappy and gzip files
        checked = tuple(list(checked[i]) + [tuple(s) for s in dict_domain["shape_checks"][key]]
                        for i, key in enumerate(("k1_new_shapes", "k2_new_shapes")))
        buffers = buffers_formats_phase(pt, hk, warehouse, reference, checked)
        checks += buffers["shape_checks"]["exact_checks"]
        emit({"phase": "buffers_formats", "part": "summary", **buffers, "exact_checks_all_phases": checks})
        lap("buffers_formats", buffers)

        # 20. nested columns and the nested aggregates
        checked = tuple(list(checked[i]) + [tuple(s) for s in buffers["shape_checks"][key]]
                        for i, key in enumerate(("k1_new_shapes", "k2_new_shapes")))
        nested = nested_phase(pt, hk, warehouse, checked)
        checks += nested["shape_checks"]["exact_checks"]
        emit({"phase": "nested", "part": "summary", **nested, "exact_checks_all_phases": checks})
        lap("nested", nested)

    # 21. timing at the main path's shapes, after 0.2 s of K1 calls so that
    # the card leaves the idle clocks of the host-bound phases before it
    kernels = []
    read_shape = main_shapes["sort_segments"]
    x, _ = k1_input(hk, rng, read_shape[1], read_shape[0], dev)
    warm_until = time.perf_counter() + 0.2
    while time.perf_counter() < warm_until:
        hk.sort_segments(x, read_shape[2])
    torch.cuda.synchronize()
    widest = (8, 1 << 18, 6)
    by_path = {name: {"main": main_launches[name], "compact": compact["launches"]["phase"][name],
                      "engines": engines["launches"][name], "buckets": buckets["launches"][name],
                      "strings": strings["launches"][name], "maintenance": maintenance["launches"][name],
                      "cdc": cdc["launches"][name], "deletes": deletes["launches"][name],
                      "history": history["launches"][name], "writes": writes["launches"][name],
                      "services": services["launches"][name], "lookups": lookups["launches"][name],
                      "sql": sql["launches"][name], "dict_domain": dict_domain["launches"][name],
                      "buffers_formats": buffers["launches"][name], "nested": nested["launches"][name]}
              for name in hk.launches}
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
    sum_m = engines["kernel_shapes"]["segment_sum"][0]
    sum_row = segment_sum_timing(hk, rng, dev, sum(by_path["segment_sum"].values()), sum_m)
    sum_row["launches_by_path"] = by_path["segment_sum"]
    kernels.append(sum_row)
    assert err2 == 0 and all(r["max_abs_err"] == 0 for r in k1_rows) and sum_row["max_abs_err"] == 0
    emit({"phase": "timing", "card": card,
          "note": "ms: CUDA events, 10 warm-up + 100 timed calls; host_ms_per_call: host clock over 100 calls "
                  "without a synchronise; device_ms: torch.profiler kernel time per call over 20 calls on one "
                  "input (warm in L2); device_ms_cold: the same, cycling over copies that exceed the L2",
          "k1_device_split": split,
          "k2": {k: k2_row[k] for k in ("ms", "device_ms", "device_ms_cold", "host_ms_per_call", "bound_ms",
                                        "plain_ms", "library_ms", "library_device_ms", "library_device_ms_cold")},
          "segment_sum": {k: sum_row[k] for k in ("shape", "ms", "device_ms", "host_ms_per_call", "bound_ms",
                                                  "plain_ms", "library_ms")}})
    lap("timing", {})
    emit({"phase": "summary", "card": card, "phases": {
        name: {"s": round(walls[name], 1), "launches": [by_path[k].get(name) for k in hk.launches],
               "headline": headline_rate(results[name])} for name in walls},
        "launch_order": list(hk.launches)})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def headline_rate(result, path: str = ""):
    """The first rate (a key ending in per_s or per_s_median) in a phase's
    result, depth first, as [path, value]; None if it has none."""
    if isinstance(result, dict):
        for key, value in result.items():
            if isinstance(key, str) and key.endswith(("per_s", "per_s_median")) and isinstance(value, (int, float)):
                return [f"{path}{key}", value]
            found = headline_rate(value, f"{path}{key}.")
            if found is not None:
                return found
    return None


def c4_batch(rng, b: int) -> dict:
    """Commit b of config 4 (baseline_configs.py:160-164): ids drawn with
    repeats from one generator, so each flush dedups too."""
    per = C4_ROWS // C4_COMMITS
    ids = rng.integers(0, C4_ROWS // 2, per)
    return {"id": ids, "v": ids * 0.5 + b, "tag": np.array([f"t{b}"] * per, dtype=object)}


def check_c4_read(table, last_commit: np.ndarray, what: str, string_key: bool = False,
                  keep: np.ndarray | None = None) -> dict:
    """The table's read (sort-engine=pallas) against a sort-engine=numpy read
    and the oracle: each written id (that `keep` keeps) with the value of its
    last commit, in the order of the ids or, with string_key, of their
    business keys."""
    t0 = time.perf_counter()
    out = read_all(table)
    read_s = time.perf_counter() - t0
    reference = read_all(table.copy({"sort-engine": "numpy"}))
    ids = np.flatnonzero((last_commit >= 0) if keep is None else (last_commit >= 0) & keep)
    if string_key:
        ids = ids[np.argsort(business_key_bytes(ids), kind="stable")]
    assert out.num_rows == len(ids), f"{what}: {out.num_rows} rows, the oracle has {len(ids)}"
    for name in out.schema.field_names:
        a, b = out.column(name), reference.column(name)
        assert np.array_equal(a.values, b.values), f"{what}: column {name} differs from the numpy engine"
        assert np.array_equal(a.valid_mask(), b.valid_mask()), f"{what}: validity of {name} differs"
    want_ids = business_keys(ids) if string_key else ids
    assert np.array_equal(out.column("id").values, want_ids), f"{what}: ids differ from the oracle"
    assert np.array_equal(out.column("v").values, ids * 0.5 + last_commit[ids]), f"{what}: v differs from the oracle"
    tags = np.array([f"t{b}" for b in last_commit[ids]], dtype=object)
    assert np.array_equal(out.column("tag").values, tags), f"{what}: tag differs from the oracle"
    return {"rows": out.num_rows, "read_s": round(read_s, 4), "equal_to_numpy_engine": True, "equal_to_oracle": True}


def live_files(table) -> list:
    """The table's live data files, over every partition and bucket."""
    return [e.file for e in table.store.new_scan().plan().entries]


def files_per_bucket(table) -> dict:
    """{"partition/bucket": live files} (partition values joined by ",")."""
    return {f"{','.join(map(str, p))}/{b}": len(files)
            for p, buckets in sorted(table.store.new_scan().plan().grouped().items()) for b, files in sorted(buckets.items())}


def level_layout(table) -> dict:
    """{level: [files, rows]} of the table's live files."""
    out: dict = {}
    for f in live_files(table):
        files, rows = out.get(f.level, (0, 0))
        out[f.level] = (files + 1, rows + f.row_count)
    return {str(lv): list(v) for lv, v in sorted(out.items())}


class Probe:
    """Wraps the (owner, attribute name, stage) targets while installed:
    each call's host seconds, the device synchronised after it, and its
    count go to its stage. A subclass adds its bookkeeping in _before,
    whose result is handed to _after with the call's arguments and
    result."""

    def __init__(self, targets: list):
        self.targets = targets
        self.seconds = dict.fromkeys([t[2] for t in targets], 0.0)
        self.calls = dict.fromkeys(self.seconds, 0)
        self._saved: list = []

    def __enter__(self):
        for owner, name, stage in self.targets:
            fn = getattr(owner, name)
            self._saved.append((owner, name, fn))
            setattr(owner, name, self._wrap(fn, stage))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)
        self._saved.clear()

    def _wrap(self, fn, stage):
        def timed(*args, **kwargs):
            token = self._before(stage, args)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds[stage] += time.perf_counter() - t0
            self.calls[stage] += 1
            self._after(stage, args, out, token)
            return out

        return timed

    def _before(self, stage: str, args: tuple):
        return None

    def _after(self, stage: str, args: tuple, out, token) -> None:
        pass


class CompactionProbe(Probe):
    """Times the compaction manager and its rewriter's three stages and
    counts compactions, rewritten and upgraded files and the kernel launches
    made inside compactions."""

    def __init__(self, hk):
        from paimon_tpu_torch.core.compact import MergeTreeCompactManager, MergeTreeCompactRewriter

        super().__init__([(MergeTreeCompactManager, "trigger_compaction", "compaction"),
                          (MergeTreeCompactRewriter, "_read_section", "decode"),
                          (MergeTreeCompactRewriter, "_merge_section", "merge"),
                          (MergeTreeCompactRewriter, "_write_section", "encode_write")])
        self.hk = hk
        self.compactions = self.rewritten = self.upgraded = 0
        self.merge_rows: list = []
        self.launches = dict.fromkeys(hk.launches, 0)

    def _before(self, stage: str, args: tuple):
        if stage == "merge":
            self.merge_rows.append(args[1].num_rows)
        return dict(self.hk.launches)

    def _after(self, stage: str, args: tuple, out, before) -> None:
        if stage == "compaction" and out is not None and not out.is_empty():
            after_names = {f.file_name for f in out.after}
            self.compactions += 1
            self.upgraded += sum(f.file_name in after_names for f in out.before)
            self.rewritten += sum(f.file_name not in after_names for f in out.before)
            for k in self.launches:
                self.launches[k] += self.hk.launches[k] - before[k]

    def report(self) -> dict:
        return {"compactions": self.compactions, "files_rewritten": self.rewritten, "files_upgraded": self.upgraded,
                "seconds": {k: round(v, 4) for k, v in self.seconds.items()},
                "merge_input_rows": self.merge_rows, "launches_in_compactions": dict(self.launches)}


def compact_phase(pt, hk, warehouse: str, string_key: bool = False) -> dict:
    """Config 4 at full size through StreamWriteBuilder, then a full
    compaction in one batch commit; each step's read checked. With
    string_key the ids are written as their business keys (id STRING)."""
    from paimon_tpu_torch.catalog import FileSystemCatalog
    from paimon_tpu_torch.core.snapshot import SnapshotManager

    cat = FileSystemCatalog(warehouse, commit_user="chip_smoke", device=DEVICE)
    schema = pt.RowType.of(("id", pt.STRING(False) if string_key else pt.BIGINT(False)), ("v", pt.DOUBLE()),
                           ("tag", pt.STRING()))
    table = cat.create_table("strings.c4" if string_key else "c4.stream", schema, primary_keys=["id"],
                             options=dict(C4_OPTIONS))
    snapshots = SnapshotManager(table.file_io, table.path)
    rng = np.random.default_rng(2)
    last_commit = np.full(C4_ROWS // 2, -1, dtype=np.int64)
    batches = []
    for b in range(C4_COMMITS):
        batches.append(c4_batch(rng, b))
        last_commit[batches[-1]["id"]] = b
        if string_key:
            batches[-1]["id"] = business_keys(batches[-1]["id"])
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
    out["stream"]["read"] = check_c4_read(table, last_commit, "after 20 commits", string_key)

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
    out["full"]["read"] = check_c4_read(table, last_commit, "after the full compaction", string_key)
    phase = dict(hk.launches)
    full = {k: full_probe.launches[k] for k in phase}
    out["launches"] = {"phase": phase, "streaming_writes": write_launches, "full_compaction": full,
                       "reads": {k: phase[k] - write_launches[k] - full[k] for k in phase}}
    assert phase["sort_segments"] > 0, f"K1 never launched on the compaction path: {out['launches']}"
    assert phase["keep_last_mask"] > 0, (
        f"K2 never launched on the compaction path (largest merge {max(stream_probe.merge_rows, default=0)} rows, "
        f"K1 admits up to {out['k1_max_rows']}): {out['launches']}")
    return out


# ---------------------------------------------------------------------------
# the merge engines: BASELINE configs 2 and 3, and one small table per engine
# ---------------------------------------------------------------------------

S0_POOL = np.array([f"v{i}" for i in range(97)], dtype=object)


def same_values(x: np.ndarray, y: np.ndarray) -> bool:
    """Equal; floats bit for bit (so -0.0 is not +0.0), any NaN equal to any
    NaN (the card and the host write other NaN payloads)."""
    if x.dtype.kind != "f":
        return np.array_equal(x, y)
    i = f"i{x.itemsize}"
    return x.shape == y.shape and bool(((x.view(i) == y.view(i)) | (np.isnan(x) & np.isnan(y))).all())


def same_rows(a, b, what: str) -> None:
    """Equal row for row: validity, and the values of valid slots."""
    assert a.num_rows == b.num_rows, f"{what}: {a.num_rows} rows against {b.num_rows}"
    for name in a.schema.field_names:
        x, y = a.column(name), b.column(name)
        ok = x.valid_mask()
        assert np.array_equal(ok, y.valid_mask()), f"{what}: validity of {name} differs"
        assert same_values(x.values[ok], y.values[ok]), f"{what}: column {name} differs"


def engine_reads(table, what: str) -> dict:
    """The table read at sort-engine pallas, xla-segmented and numpy: equal
    row for row. Returns the pallas read."""
    out = read_all(table)
    for engine in ("xla-segmented", "numpy"):
        same_rows(out, read_all(table.copy({"sort-engine": engine})), f"{what}, pallas against {engine}")
    return out


def c2_batch(schema, ids: np.ndarray, r: int):
    """Commit r of config 2 (baseline_configs.py:81-88)."""
    from paimon_tpu_torch.data.batch import Column, ColumnBatch

    def null(dtype):
        return Column(np.zeros(len(ids), dtype), np.zeros(len(ids), np.bool_))

    return ColumnBatch(schema, {
        "id": Column(ids),
        "a": Column(ids % 1000) if r % 2 == 0 else null(np.int64),
        "b": null(np.int64) if r % 2 == 0 else Column(ids % 777),
        "d0": Column(ids * 0.5 + r),
        "d1": null(np.float64) if r < 2 else Column(ids * 1.5),
        "s0": Column(S0_POOL[ids % 97]),
    })


def pu_read_stages(table) -> dict:
    """One partial-update merge read, stage by stage and summed over its
    sections (host clock, device synchronised at each boundary): decode
    every column, lane encode, the fused merge (sort + segment + field
    selection, download), gather."""
    from paimon_tpu_torch.core.kv import KVBatch
    from paimon_tpu_torch.core.levels import IntervalPartition
    from paimon_tpu_torch.core.read import order_runs_for_merge
    from paimon_tpu_torch.ops.merge import fused_partial_update

    store = table.store
    (split,) = table.new_read_builder().new_scan().plan()
    rf = store.reader_factory(split.partition, split.bucket)
    merge = store.merge_executor()
    ms = dict.fromkeys(("decode", "encode_lanes", "merge", "gather"), 0.0)
    sections = IntervalPartition(split.files).partition()
    rows_in = rows_out = 0
    for section in sections:
        runs, seq_ascending = order_runs_for_merge(section)
        t0 = time.perf_counter()
        kv = KVBatch.concat([rf.read(f) for run in runs for f in run.files])
        ms["decode"] += time.perf_counter() - t0
        rows_in += kv.num_rows
        if len(runs) == 1:
            rows_out += kv.num_rows
            continue
        t0 = time.perf_counter()
        lanes, seq_lanes = merge._key_lanes(kv), merge._seq_lanes(kv, seq_ascending)
        ms["encode_lanes"] += time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        src, exists, last_take = fused_partial_update(
            lanes, seq_lanes, merge._field_valid(kv), kv.kind, False, True, "pallas", DEVICE)
        torch.cuda.synchronize()
        ms["merge"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        rows_out += merge._partial_update_rows(kv, src, exists, last_take).drop_deletes().num_rows
        ms["gather"] += time.perf_counter() - t0
    return {"sections": len(sections), "input_rows": rows_in, "output_rows": rows_out,
            "ms": {k: round(v * 1e3, 3) for k, v in ms.items()}}


def config2_phase(pt, hk, cat) -> dict:
    """BASELINE config 2 at C2_ROWS: write, 3 timed reads checked against
    the numpy and xla-segmented engines and the oracle, a staged read, and
    one read under the profiler."""
    schema = pt.RowType.of(("id", pt.BIGINT(False)), ("a", pt.BIGINT()), ("b", pt.BIGINT()),
                           ("d0", pt.DOUBLE()), ("d1", pt.DOUBLE()), ("s0", pt.STRING()))
    table = cat.create_table("engines.c2", schema, primary_keys=["id"], options=dict(C2_OPTIONS))
    per = C2_ROWS // 4
    ids = np.arange(per, dtype=np.int64)
    batches = [c2_batch(schema, ids, r) for r in range(4)]
    hk.reset_launches()
    t0 = time.perf_counter()
    for batch in batches:
        wb = table.new_batch_write_builder()
        w = wb.new_write()
        w.write(batch)
        wb.new_commit().commit(w.prepare_commit())
    torch.cuda.synchronize()
    write_s = time.perf_counter() - t0
    write_launches = dict(hk.launches)
    del batches
    out, samples = timed_reads(table, BIG_READ_REPEATS)
    read_launches = {k: hk.launches[k] - write_launches[k] for k in hk.launches}
    assert out.num_rows == per, f"config 2: {out.num_rows} rows, the oracle has {per}"
    oracle = {"id": ids, "a": ids % 1000, "b": ids % 777, "d0": ids * 0.5 + 3, "d1": ids * 1.5, "s0": S0_POOL[ids % 97]}
    for name, want in oracle.items():
        col = out.column(name)
        assert col.validity is None, f"config 2: nulls left in {name}"
        assert np.array_equal(col.values, want), f"config 2: {name} differs from the oracle"
    for engine in ("numpy", "xla-segmented"):
        same_rows(out, read_all(table.copy({"sort-engine": engine})), f"config 2, pallas against {engine}")
    # the benchmark's own predicate (baseline_configs.py:92), on the merged rows
    from paimon_tpu_torch.data.predicate import and_, greater_or_equal, less_than

    t0 = time.perf_counter()
    filtered, _ = read_filtered(table, and_(greater_or_equal("a", 100), less_than("b", 500)))
    filtered_s = time.perf_counter() - t0
    want_ids = ids[(oracle["a"] >= 100) & (oracle["b"] < 500)]
    assert np.array_equal(filtered.column("id").values, want_ids), "config 2: the filtered read differs from the oracle"
    launches = dict(hk.launches)
    stages = pu_read_stages(table)
    return {
        "config": "BASELINE config 2 (benchmarks/baseline_configs.py:66), scale 5",
        "options": C2_OPTIONS, "rows_written": C2_ROWS, "commits": 4, "keys": per,
        "write_s": round(write_s, 4),
        "filtered_read": {"predicate": "a >= 100 AND b < 500", "seconds": round(filtered_s, 4),
                          "matched": filtered.num_rows, "input_rows_per_s": round(C2_ROWS / filtered_s, 1)},
        "reads": {"samples_s": [round(x, 4) for x in samples],
                  "rows_per_s": [round(C2_ROWS / x, 1) for x in samples],
                  "median_rows_per_s": round(C2_ROWS / float(np.median(samples)), 1)},
        "launches": {"write": write_launches, "reads": read_launches, "phase": launches},
        "equal_to_numpy_engine": True, "equal_to_xla_segmented": True, "equal_to_oracle": True,
        "read_stages": stages, "trace": device_busy(table),
    }


def check_c3_read(table, ids_in: np.ndarray, what: str) -> dict:
    """The read against a numpy-engine read and the oracle: per key, the sum
    of sum_col and the max of max_col over every written row."""
    t0 = time.perf_counter()
    out = read_all(table)
    read_s = time.perf_counter() - t0
    same_rows(out, read_all(table.copy({"sort-engine": "numpy"})), f"{what}, pallas against numpy")
    keys = np.unique(ids_in)
    total = np.zeros(C3_ROWS // 8, np.int64)
    np.add.at(total, ids_in, ids_in % 7)
    top = np.full(C3_ROWS // 8, -np.inf)
    np.maximum.at(top, ids_in, ids_in * 0.25)
    ids = out.column("id").values
    if table.store.options.bucket == 1:
        assert np.array_equal(ids, keys), f"{what}: keys differ from the oracle"
    order = np.argsort(ids, kind="stable")  # buckets come one after another
    assert np.array_equal(ids[order], keys), f"{what}: keys differ from the oracle"
    assert np.array_equal(out.column("sum_col").values[order], total[keys]), f"{what}: sum_col differs from the oracle"
    assert np.array_equal(out.column("max_col").values[order], top[keys]), f"{what}: max_col differs from the oracle"
    return {"rows": out.num_rows, "read_s": round(read_s, 4), "equal_to_numpy_engine": True, "equal_to_oracle": True}


C3_CUTS = ["no mesh (ROADMAP Queue 1 item 13)",
           "the compaction runs on a copy of the table with write-only=false, as a dedicated compaction job would"]


def orc_files(table) -> dict:
    """The live data files' format, ORC stripes and bytes on disk, and the
    staged read's decode: every file read whole (system columns too) through
    reader factories without the data-file cache, file read + decompress +
    decode on the host clock."""
    from paimon_tpu_torch.format.orc_meta import read_tail

    stripes = nbytes = 0
    formats, decode_s = set(), 0.0
    for split in table.new_read_builder().new_scan().plan():
        rf = table.store.reader_factory(split.partition, split.bucket)
        rf.cache = None
        for f in split.files:
            formats.add(f.file_name.rsplit(".", 1)[1])
            raw = table.store.file_io.read_bytes(f"{rf.bucket_dir}/{f.file_name}")
            nbytes += len(raw)
            stripes += read_tail(raw).nstripes
            t0 = time.perf_counter()
            rf.read(f)
            decode_s += time.perf_counter() - t0
    assert formats == {"orc"}, f"data files in {formats}, not ORC"
    return {"stripes": stripes, "bytes_on_disk": nbytes, "decode_ms": round(decode_s * 1e3, 3)}


def config3_phase(pt, hk, cat, ident: str = "engines.c3", options: dict = C3_OPTIONS,
                  cuts: tuple = ("bucket=1, not 8: the buckets phase runs 8 buckets beside a bucket-1 control",),
                  trace: bool = False) -> dict:
    """BASELINE config 3 at scale 1, then a full compaction in one batch
    commit, each step's read checked; launches split into the writes'
    flushes, the reads and the compaction. trace: one more read, before the
    compaction, under the profiler (counted with the reads)."""
    from paimon_tpu_torch.core.snapshot import SnapshotManager

    schema = pt.RowType.of(("id", pt.BIGINT(False)), ("sum_col", pt.BIGINT()), ("max_col", pt.DOUBLE()))
    table = cat.create_table(ident, schema, primary_keys=["id"], options=dict(options))
    per = C3_ROWS // 4
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, C3_ROWS // 8, per) for _ in range(4)]
    hk.reset_launches()
    with WriteProbe() as stages:
        t0 = time.perf_counter()
        for ids in batches:
            wb = table.new_batch_write_builder()
            w = wb.new_write()
            w.write({"id": ids, "sum_col": ids % 7, "max_col": ids * 0.25})
            wb.new_commit().commit(w.prepare_commit())
        torch.cuda.synchronize()
        write_s = time.perf_counter() - t0
    write_launches = dict(hk.launches)
    ids_in = np.concatenate(batches)
    what = f"config 3 at bucket={options['bucket']}"
    out = {"config": "BASELINE config 3 (benchmarks/baseline_configs.py:107), scale 1",
           "options": options, "rows_written": C3_ROWS, "commits": 4, "cuts": [*cuts, *C3_CUTS],
           "write_s": round(write_s, 4), "write_stages": stages.report(), "files_per_bucket": files_per_bucket(table)}
    out["orc"] = orc_files(table)
    before = dict(hk.launches)
    out["read"] = check_c3_read(table, ids_in, what)
    if trace:
        out["trace"] = device_busy(table)
    read_launches = {k: hk.launches[k] - before[k] for k in hk.launches}
    files = live_files(table)
    input_bytes = sum(f.file_size for f in files)
    before = dict(hk.launches)
    compacting = table.copy({"write-only": "false"})
    with CompactionProbe(hk) as probe:
        t0 = time.perf_counter()
        wb = compacting.new_batch_write_builder()
        w = wb.new_write()
        w.compact(full=True)
        kinds = [SnapshotManager(table.file_io, table.path).snapshot(i).commit_kind.value
                 for i in wb.new_commit().commit(w.prepare_commit())]
        torch.cuda.synchronize()
        compact_s = time.perf_counter() - t0
    assert kinds == ["COMPACT"], kinds
    compact_launches = {k: hk.launches[k] - before[k] for k in hk.launches}
    out["full_compaction"] = {
        "seconds": round(compact_s, 4), "input_files": len(files), "input_bytes": input_bytes,
        "gb_per_s": round(input_bytes / compact_s / 1e9, 4), "snapshots": kinds,
        "levels_after": level_layout(table), "launches": compact_launches, "stages": probe.report()}
    out["full_compaction"]["orc"] = orc_files(table)
    before = dict(hk.launches)
    out["full_compaction"]["read"] = check_c3_read(table, ids_in, f"{what} after the full compaction")
    for k in hk.launches:
        read_launches[k] += hk.launches[k] - before[k]
    out["launches"] = {"write": write_launches, "reads": read_launches, "compaction": compact_launches,
                       "phase": dict(hk.launches)}
    return out


RETRACTS = (0.75, 0.05, 0.1, 0.1)  # shares of +I, -U, +U, -D rows
NO_UPDATE_BEFORE = (0.75, 0.0, 0.15, 0.1)


def nullable(rng, values: np.ndarray, share: float = 0.2):
    from paimon_tpu_torch.data.batch import Column

    return Column(values, rng.random(len(values)) >= share)


SMALL_TABLES = {
    # partial-update with -D rows that remove keys (and -U rows, ignored)
    "partial_update": ({"merge-engine": "partial-update", "partial-update.remove-record-on-delete": "true"},
                       (("a", "BIGINT"), ("d", "DOUBLE"), ("s", "STRING")), RETRACTS),
    # every aggregate the fused call runs, with retractions
    "aggregation_fused": (
        {"merge-engine": "aggregation",
         **{f"fields.{f}.aggregate-function": fn for f, fn in (
             ("c_sum", "sum"), ("d_sum", "sum"), ("f_sum", "sum"), ("i_sum", "sum"), ("c_cnt", "count"),
             ("c_max", "max"), ("d_min", "min"), ("b_and", "bool_and"), ("b_or", "bool_or"),
             ("fv", "first_value"), ("fnn", "first_non_null_value"), ("lv", "last_value"),
             ("lnn", "last_non_null_value"))},
         **{f"fields.{f}.ignore-retract": "true" for f in ("i_sum", "c_max", "d_min", "b_and", "b_or", "fv", "fnn",
                                                            "lv", "lnn")}},
        (("c_sum", "BIGINT"), ("d_sum", "DOUBLE"), ("f_sum", "FLOAT"), ("i_sum", "BIGINT"), ("c_cnt", "BIGINT"),
         ("c_max", "INT"), ("d_min", "DOUBLE"), ("b_and", "BOOLEAN"), ("b_or", "BOOLEAN"), ("fv", "BIGINT"),
         ("fnn", "STRING"), ("lv", "DOUBLE"), ("lnn", "STRING")), RETRACTS),
    # the host aggregates and primary-key: the planned path (merge_plan)
    "aggregation_planned": (
        {"merge-engine": "aggregation", "fields.p.aggregate-function": "product",
         "fields.l.aggregate-function": "listagg", "fields.l.list-agg-delimiter": "|",
         "fields.pk.aggregate-function": "primary-key", "fields.d_sum.aggregate-function": "sum",
         "fields.p.ignore-retract": "true", "fields.l.ignore-retract": "true"},
        (("p", "BIGINT"), ("l", "STRING"), ("pk", "BIGINT"), ("d_sum", "DOUBLE")), RETRACTS),
    # first-row, -D rows dropped by the engine's own ignore-delete key
    "first_row": ({"merge-engine": "first-row", "first-row.ignore-delete": "true"},
                  (("v", "BIGINT"), ("s", "STRING")), NO_UPDATE_BEFORE),
}


def small_column(rng, name: str, type_name: str, ids: np.ndarray, b: int):
    from paimon_tpu_torch.data.batch import Column

    n = len(ids)
    if type_name == "STRING":
        return nullable(rng, np.array([f"{name}{b}-{int(x) % 13}" for x in ids], dtype=object))
    if type_name == "BOOLEAN":
        return nullable(rng, rng.random(n) < 0.5)
    if type_name == "DOUBLE":
        return nullable(rng, rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n))
    if type_name == "FLOAT":
        return nullable(rng, rng.standard_normal(n).astype(np.float32))
    dtype = np.int32 if type_name == "INT" else np.int64
    if name == "p":  # the product's factors: small, never null
        return Column(rng.integers(1, 4, n).astype(dtype))
    return nullable(rng, rng.integers(-1000, 1000, n).astype(dtype))


def small_tables_phase(pt, hk, cat, tables: dict = SMALL_TABLES, tenants: np.ndarray | None = None,
                       db: str = "engines") -> dict:
    """One small table per engine, SMALL_COMMITS commits each, read at
    every sort engine. With tenants the key is (tenant STRING, id BIGINT),
    each row's tenant drawn from them. Returns ({table: its numbers and
    launches}, the kernels' last shapes)."""
    from paimon_tpu_torch.data.batch import Column, ColumnBatch

    types = {"BIGINT": pt.BIGINT(), "INT": pt.INT(), "DOUBLE": pt.DOUBLE(), "FLOAT": pt.FLOAT(),
             "BOOLEAN": pt.BOOLEAN(), "STRING": pt.STRING()}
    out, shapes = {}, {}
    key = [] if tenants is None else [("tenant", pt.STRING(False))]
    for name, (options, fields, kinds) in tables.items():
        schema = pt.RowType.of(*key, ("id", pt.BIGINT(False)), *[(f, types[t]) for f, t in fields])
        opts = {"bucket": "1", "write-only": "true", "sort-engine": "pallas", **options}
        table = cat.create_table(f"{db}.{name}", schema, primary_keys=[k for k, _ in key] + ["id"], options=opts)
        rng = np.random.default_rng(len(out) + 31)
        hk.reset_launches()
        for b in range(SMALL_COMMITS):
            ids = rng.integers(0, SMALL_ROWS * 3 // 2, SMALL_ROWS)
            cols = {"id": Column(ids), **{f: small_column(rng, f, t, ids, b) for f, t in fields}}
            if tenants is not None:
                cols["tenant"] = Column(tenants[rng.integers(0, len(tenants), SMALL_ROWS)])
            wb = table.new_batch_write_builder()
            w = wb.new_write()
            w.write(ColumnBatch(schema, cols), rng.choice(4, SMALL_ROWS, p=kinds).astype(np.uint8))
            wb.new_commit().commit(w.prepare_commit())
        write_launches = dict(hk.launches)
        rows = engine_reads(table, name).num_rows
        out[name] = {"options": options, "rows_written": SMALL_ROWS * SMALL_COMMITS, "rows_read": rows,
                     "equal_across_sort_engines": True,
                     "launches": {"write": write_launches, "phase": dict(hk.launches)}}
        assert hk.launches["sort_segments"] > 0, f"{name}: K1 never launched"
        shapes.update(hk.last_shape)
    return out, shapes


def engines_phase(pt, hk, warehouse: str) -> dict:
    """The merge engines: configs 2 and 3 and the small per-engine tables,
    one JSON line each with its launches; returns the phase's launches
    summed over its parts."""
    from paimon_tpu_torch.catalog import FileSystemCatalog

    cat = FileSystemCatalog(warehouse, commit_user="chip_smoke", device=DEVICE)
    out = {"config2": config2_phase(pt, hk, cat)}
    emit({"phase": "engines", "part": "config2", **out["config2"]})
    out["config3"] = config3_phase(pt, hk, cat)
    emit({"phase": "engines", "part": "config3", **out["config3"]})
    out["small_tables"], shapes = small_tables_phase(pt, hk, cat)
    emit({"phase": "engines", "part": "small_tables", **out["small_tables"]})
    parts = [out["config2"]["launches"]["phase"], out["config3"]["launches"]["phase"],
             *[t["launches"]["phase"] for t in out["small_tables"].values()]]
    launches = {k: sum(p[k] for p in parts) for k in hk.launches}
    for k in hk.launches:
        assert launches[k] > 0, f"{k} never launched on the engines path: {launches}"
    return {"launches": launches, "kernel_shapes": shapes}


# ---------------------------------------------------------------------------
# buckets and partitions: BASELINE configs 3 (8 buckets) and 5 (16 buckets),
# and a partitioned table at the default (dynamic) bucket mode
# ---------------------------------------------------------------------------


class WriteProbe(Probe):
    """Host seconds of a write's stages (the device synchronised after each
    call): routing (bucket hashes and the partition/bucket group-by), the
    dynamic-bucket assigner (its allocation loop is Python per new key),
    memtable flushes, and inside them the encoding and writing of files (a
    flush less that is its merge on a write-only table)."""

    def __init__(self):
        import paimon_tpu_torch.table.write as table_write
        from paimon_tpu_torch.core.bucket_index import SimpleHashBucketAssigner
        from paimon_tpu_torch.core.datafile import KeyValueFileWriterFactory
        from paimon_tpu_torch.core.writer import MergeTreeWriter

        super().__init__([(table_write, "group_by_partition_bucket", "routing"), (table_write, "key_hashes", "routing"),
                          (SimpleHashBucketAssigner, "assign", "assigner"), (MergeTreeWriter, "flush", "flush"),
                          (KeyValueFileWriterFactory, "write", "encode_write")])

    def report(self) -> dict:
        return {k: round(v, 4) for k, v in self.seconds.items()}


def launch_diff(hk, before: dict) -> dict:
    return {k: hk.launches[k] - before[k] for k in hk.launches}


def config3_buckets_part(pt, hk, cat) -> dict:
    """Config 3 at its own 8 buckets beside the bucket-1 control."""
    control = config3_phase(pt, hk, cat, "buckets.c3_bucket_1", C3_OPTIONS,
                            ("bucket=1, not 8: the control for the 8-bucket run",))
    eight = config3_phase(pt, hk, cat, "buckets.c3_bucket_8", {**C3_OPTIONS, "bucket": "8"}, (), trace=True)
    return {"bucket_1": control, "bucket_8": eight,
            "launches": {"phase": {k: control["launches"]["phase"][k] + eight["launches"]["phase"][k]
                                   for k in hk.launches}}}


def check_c5_read(table, ids_in: np.ndarray, what: str) -> dict:
    """The read against a numpy-engine read and the oracle: each written id
    once, with x, y and v computed from it."""
    t0 = time.perf_counter()
    out = read_all(table)
    read_s = time.perf_counter() - t0
    same_rows(out, read_all(table.copy({"sort-engine": "numpy"})), f"{what}, pallas against numpy")
    ids = out.column("id").values
    assert np.array_equal(np.sort(ids), np.unique(ids_in)), f"{what}: ids differ from the oracle"
    for name, want in (("x", ids % 4096), ("y", (ids * 7) % 4096), ("v", ids * 1.0)):
        assert np.array_equal(out.column(name).values, want), f"{what}: {name} differs from the oracle"
    return {"rows": out.num_rows, "read_s": round(read_s, 4), "equal_to_numpy_engine": True, "equal_to_oracle": True}


def config5_part(pt, hk, cat) -> dict:
    """BASELINE config 5 at its 16 buckets: C5_ROWS rows in 4 batch commits
    (write-only), a checked and a traced read, then
    DedicatedCompactor(table).run_once(full=True) (every live bucket, one
    after another) and the read after it; then its z-order half
    (zorder_part)."""
    from paimon_tpu_torch.table.compactor import DedicatedCompactor

    schema = pt.RowType.of(("id", pt.BIGINT(False)), ("x", pt.BIGINT()), ("y", pt.BIGINT()), ("v", pt.DOUBLE()))
    table = cat.create_table("buckets.c5", schema, primary_keys=["id"], options=dict(C5_OPTIONS))
    rng = np.random.default_rng(3)
    per = C5_ROWS // 4
    batches = [rng.integers(0, C5_ROWS, per) for _ in range(4)]
    hk.reset_launches()
    with WriteProbe() as stages:
        t0 = time.perf_counter()
        for ids in batches:
            wb = table.new_batch_write_builder()
            w = wb.new_write()
            w.write({"id": ids, "x": ids % 4096, "y": (ids * 7) % 4096, "v": ids * 1.0})
            wb.new_commit().commit(w.prepare_commit())
        torch.cuda.synchronize()
        write_s = time.perf_counter() - t0
    write_launches = dict(hk.launches)
    ids_in = np.concatenate(batches)
    del batches
    out = {"config": "BASELINE config 5 (benchmarks/baseline_configs.py:177), scale 5", "options": C5_OPTIONS,
           "rows_written": C5_ROWS, "commits": 4,
           "cuts": ["1B rows and 64 buckets cut to 10M rows and 16 buckets (the config's own at scale 5)", "no mesh"],
           "write_s": round(write_s, 4), "write_stages": stages.report(), "files_per_bucket": files_per_bucket(table)}
    before = dict(hk.launches)
    out["read_before"] = check_c5_read(table, ids_in, "config 5 before the compaction")
    out["trace_before"] = device_busy(table)
    read_launches = launch_diff(hk, before)
    files = live_files(table)
    input_bytes = sum(f.file_size for f in files)
    before = dict(hk.launches)
    snapshots = table.store.snapshot_manager
    last = snapshots.latest_snapshot_id()
    with CompactionProbe(hk) as probe:
        t0 = time.perf_counter()
        assert DedicatedCompactor(table).run_once(full=True), "config 5: the dedicated compactor committed nothing"
        torch.cuda.synchronize()
        compact_s = time.perf_counter() - t0
    kinds = [snapshots.snapshot(i).commit_kind.value for i in range(last + 1, snapshots.latest_snapshot_id() + 1)]
    assert kinds == ["COMPACT"], kinds
    compact_launches = launch_diff(hk, before)
    out["full_compaction"] = {
        "seconds": round(compact_s, 4), "input_files": len(files), "input_bytes": input_bytes,
        "gb_per_s": round(input_bytes / compact_s / 1e9, 4), "input_rows_per_s": round(C5_ROWS / compact_s, 1),
        "snapshots": kinds, "files_per_bucket_after": files_per_bucket(table), "levels_after": level_layout(table),
        "launches": compact_launches, "stages": probe.report()}
    assert compact_launches["keep_last_mask"] > 0, f"config 5: K2 never launched in the compaction: {compact_launches}"
    before = dict(hk.launches)
    out["read_after"] = check_c5_read(table, ids_in, "config 5 after the full compaction")
    for k in hk.launches:
        read_launches[k] += hk.launches[k] - before[k]
    before = dict(hk.launches)
    out["zorder"] = zorder_part(hk, cat, rng, schema)
    out["launches"] = {"write": write_launches, "reads": read_launches, "compaction": compact_launches,
                       "sort_compact": launch_diff(hk, before), "phase": dict(hk.launches)}
    return out


C5Z_ROWS = 500_000  # baseline_configs.py:218: min(rows, 500_000) ids into the append clone
CURVES = ("zorder", "hilbert", "order")


def curve_lanes(out, order: str) -> np.ndarray:
    """The sort lanes sort_compact orders the rows by: x and y as key lanes,
    under the curve."""
    from paimon_tpu_torch.data.keys import encode_key_lanes
    from paimon_tpu_torch.ops.zorder import hilbert_lanes, z_order_lanes

    lanes = encode_key_lanes(out, ["x", "y"])
    return {"zorder": z_order_lanes, "hilbert": hilbert_lanes}.get(order, lambda x: x)(lanes)


def non_decreasing(lanes: np.ndarray) -> bool:
    """Rows in lexicographic order of their lanes (ties allowed)."""
    if len(lanes) < 2:
        return True
    gt, lt = lanes[1:] > lanes[:-1], lanes[1:] < lanes[:-1]
    differ = gt | lt
    first = np.argmax(differ, axis=1)
    rows = np.arange(len(first))
    return bool((~differ.any(axis=1) | gt[rows, first]).all())


def zorder_part(hk, cat, rng, schema) -> dict:
    """Config 5's z-order half (baseline_configs.py:213-226): its append
    clone db.c5z (bucket 1) with one commit of C5Z_ROWS rows drawn from the
    same generator after the four batches, then sort_compact by zorder, and
    by hilbert and order on copies. Each is checked three ways: the rows'
    multiset is unchanged; their order equals a sort-engine=numpy
    sort-compact of another copy; the curve's codes do not decrease in
    file order."""
    from paimon_tpu_torch.table.sort_compact import sort_compact

    ta = cat.create_table("buckets.c5z", schema, options={"bucket": "1", "sort-engine": "pallas"})
    ids = rng.integers(0, C5_ROWS, min(C5_ROWS, C5Z_ROWS))
    t0 = time.perf_counter()
    wb = ta.new_batch_write_builder()
    w = wb.new_write()
    w.write({"id": ids, "x": ids % 4096, "y": (ids * 7) % 4096, "v": ids * 1.0})
    wb.new_commit().commit(w.prepare_commit())
    write_s = time.perf_counter() - t0
    copies = {("zorder", "pallas"): ta}
    for order in CURVES:
        for engine in ("pallas", "numpy"):
            if (order, engine) not in copies:
                name = f"buckets.c5z_{order}_{engine}"
                shutil.copytree(ta.path, cat.table_path(name))
                copies[(order, engine)] = cat.get_table(name).copy({"sort-engine": engine})
    want_ids = np.sort(ids)
    out = {"config": "BASELINE config 5's z-order half (benchmarks/baseline_configs.py:213-226)",
           "rows": len(ids), "write_s": round(write_s, 4), "k1_max_rows": hk._FUSE_MAX_ROWS}
    for order in CURVES:
        before = dict(hk.launches)
        t0 = time.perf_counter()
        n = sort_compact(copies[(order, "pallas")], ["x", "y"], order=order)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_diff(hk, before)
        assert n == len(ids), f"{order}: sort_compact rewrote {n} rows"
        got = read_all(copies[(order, "pallas")])
        got_ids = got.column("id").values
        assert np.array_equal(np.sort(got_ids), want_ids), f"{order}: the rows' multiset changed"
        for name, want in (("x", got_ids % 4096), ("y", (got_ids * 7) % 4096), ("v", got_ids * 1.0)):
            assert np.array_equal(got.column(name).values, want), f"{order}: {name} no longer matches its id"
        t1 = time.perf_counter()
        sort_compact(copies[(order, "numpy")], ["x", "y"], order=order)
        numpy_s = time.perf_counter() - t1
        same_rows(got, read_all(copies[(order, "numpy")]), f"{order}: against the numpy engine's sort-compact")
        assert non_decreasing(curve_lanes(got, order)), f"{order}: the curve codes decrease in file order"
        table = copies[(order, "pallas")]
        snap = table.store.snapshot_manager.latest_snapshot()
        assert snap.commit_kind.value == "COMPACT" and snap.commit_identifier == (1 << 63) - 3, snap
        out[order] = {"seconds": round(seconds, 4), "rows_per_s": round(n / seconds, 1), "numpy_engine_s": round(numpy_s, 4),
                      "files_per_bucket": files_per_bucket(table), "launches": launches,
                      "multiset_unchanged": True, "order_equal_to_numpy_engine": True, "curve_non_decreasing": True}
        assert launches["keep_last_mask"] > 0 or launches["sort_segments"] > 0, f"{order}: no kernel launched"
    return out


def partitioned_values(ids: np.ndarray, upsert: bool) -> dict:
    return {"dt": P_DTS[ids % len(P_DTS)], **table_values(ids, upsert)}


def check_partitioned_read(out, up: np.ndarray, what: str) -> None:
    """Every id once, in its partition, with the upserted values where it
    was upserted and the first values elsewhere."""
    assert out.num_rows == N_ROWS, f"{what}: {out.num_rows} rows"
    ids = out.column("id").values
    order = np.argsort(ids, kind="stable")
    assert np.array_equal(ids[order], np.arange(N_ROWS)), f"{what}: ids differ from the oracle (a key twice?)"
    assert np.array_equal(out.column("dt").values, P_DTS[ids % len(P_DTS)]), f"{what}: a row in another partition"
    upserted = np.zeros(N_ROWS, np.bool_)
    upserted[up] = True
    new, old = table_values(np.arange(N_ROWS), True), table_values(np.arange(N_ROWS), False)
    for name in ("c1", "c2", "c3", "d1", "d2", "s1", "s2"):
        want = np.where(upserted, new[name], old[name])
        assert np.array_equal(out.column(name).values[order], want), f"{what}: {name} differs from the oracle"


def pruned_partition_read(table, full) -> dict:
    """One read filtered to the first partition (dt = P_DTS[0]): it must
    plan only that partition's splits and return, in order, the rows of
    the unfiltered read `full` (already held to the oracle) in it."""
    from paimon_tpu_torch.data.predicate import equal

    rb = table.new_read_builder().with_filter(equal("dt", P_DTS[0]))
    t0 = time.perf_counter()
    splits = rb.new_scan().plan()
    out = rb.new_read().read_all(splits)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    every = table.new_read_builder().new_scan().plan()
    assert {s.partition for s in splits} == {(P_DTS[0],)}, "the pruned read planned another partition"
    assert len(splits) == sum(s.partition == (P_DTS[0],) for s in every), "the pruned read lost a split"
    assert out.num_rows == N_ROWS // len(P_DTS), f"the pruned read returned {out.num_rows} rows"
    same_rows(out, full.filter(full.column("dt").values == P_DTS[0]), "the pruned read against the full read")
    return {"predicate": f"dt = '{P_DTS[0]}'", "seconds": round(seconds, 4), "rows": out.num_rows,
            "output_rows_per_s": round(out.num_rows / seconds, 1), "splits": len(splits), "splits_unfiltered": len(every),
            "files": sum(len(s.files) for s in splits), "files_unfiltered": sum(len(s.files) for s in every)}


def partitioned_part(pt, hk, cat) -> dict:
    """The bench table plus a dt partition column (4 values), primary key
    (dt, id), no bucket option (dynamic buckets, the default) and otherwise
    default options but dynamic-bucket.target-row-num: 4 sorted runs and
    the upsert commit, each a batch commit; the upsert's keys must keep
    their buckets (the index manifest is unchanged by it, and every row
    read sits in the bucket whose hash index holds its key)."""
    from paimon_tpu_torch.core.bucket_index import HashIndexFile
    from paimon_tpu_torch.table.bucket import key_hashes

    schema = pt.RowType.of(("dt", pt.STRING()), *[(f.name, f.type) for f in build_schema(pt).fields])
    table = cat.create_table("buckets.partitioned", schema, partition_keys=["dt"], primary_keys=["dt", "id"],
                             options=dict(P_OPTIONS))
    rng = np.random.default_rng(7)
    ids = rng.permutation(N_ROWS).astype(np.int64)
    per = N_ROWS // N_RUNS
    up = np.random.default_rng(8).choice(N_ROWS, N_UPSERT, replace=False).astype(np.int64)
    batches = [partitioned_values(np.sort(ids[r * per : (r + 1) * per]), False) for r in range(N_RUNS)]
    batches.append(partitioned_values(up, True))
    hk.reset_launches()
    index_before_upsert = None
    with WriteProbe() as stages, CompactionProbe(hk) as probe:
        t0 = time.perf_counter()
        for r, batch in enumerate(batches):
            if r == N_RUNS:
                index_before_upsert = table.store.new_scan().plan().snapshot.index_manifest
            wb = table.new_batch_write_builder()
            w = wb.new_write()
            w.write(batch)
            wb.new_commit().commit(w.prepare_commit())
        torch.cuda.synchronize()
        write_s = time.perf_counter() - t0
    del batches
    write_launches = dict(hk.launches)
    plan = table.store.new_scan().plan()
    assert plan.snapshot.index_manifest == index_before_upsert, "the upsert commit changed the hash index"
    hif = HashIndexFile(table.file_io, table.path)
    index = {(e.partition, e.bucket): hif.read(e.file_name) for e in plan.index_entries if e.kind == "HASH_INDEX"}
    buckets = {p: sorted(b) for p, b in plan.grouped().items()}
    assert sorted(index) == sorted((p, b) for p, bs in buckets.items() for b in bs), "index and data buckets differ"
    assert all(len(h) <= P_TARGET for h in index.values()), "a bucket holds more keys than the target"
    for split in table.new_read_builder().new_scan().plan():
        batch = table.store.read_bucket(split.partition, split.bucket, split.files, projection=["dt", "id"])
        assert np.isin(key_hashes(batch, ["id"]), index[(split.partition, split.bucket)]).all(), (
            f"a row of {split.partition}/{split.bucket} whose key the bucket's hash index lacks")
    out_read, samples = timed_reads(table, READ_REPEATS)
    read_launches = launch_diff(hk, write_launches)
    check_partitioned_read(out_read, up, "partitioned")
    same_rows(out_read, read_all(table.copy({"sort-engine": "numpy"})), "partitioned, pallas against numpy")
    pruned = pruned_partition_read(table, out_read)
    median = float(np.median(samples))
    compaction_launches = dict(probe.launches)
    return {
        "table": "bench.py's table (bench.py:54-96) plus dt STRING (4 values, dt = id % 4) as partition key, "
                 "primary key (dt, id), no bucket option: dynamic buckets, default codecs, write-only=false",
        "options": P_OPTIONS, "rows_written": N_ROWS + N_UPSERT, "commits": N_RUNS + 1,
        "write_s": round(write_s, 4), "assigner_host_s": round(stages.seconds["assigner"], 4),
        "write_stages": stages.report(), "compaction": probe.report(),
        "buckets_per_partition": {",".join(p): len(b) for p, b in sorted(buckets.items())},
        "keys_per_bucket": {f"{','.join(p)}/{b}": len(h) for (p, b), h in sorted(index.items())},
        "files_per_bucket": files_per_bucket(table),
        "upsert_kept_buckets": True,
        "reads": {"samples_s": [round(x, 4) for x in samples], "median_s": round(median, 4),
                  "output_rows_per_s_median": round(N_ROWS / median, 1),
                  "input_rows_per_s_median": round((N_ROWS + N_UPSERT) / median, 1)},
        "equal_to_numpy_engine": True, "equal_to_oracle": True, "pruned_read": pruned, "trace": device_busy(table),
        "launches": {"write_flushes": {k: write_launches[k] - compaction_launches[k] for k in hk.launches},
                     "compactions": compaction_launches, "reads": read_launches, "phase": dict(hk.launches)},
    }


def buckets_phase(pt, hk, warehouse: str) -> dict:
    """Buckets and partitions, one JSON line per part with its launches;
    returns the phase's launches summed over its parts."""
    from paimon_tpu_torch.catalog import FileSystemCatalog

    cat = FileSystemCatalog(warehouse, commit_user="chip_smoke", device=DEVICE)
    parts = {}
    for name, fn in (("config3", config3_buckets_part), ("config5", config5_part),
                     ("partitioned_dynamic", partitioned_part)):
        hk.last_shape.clear()
        parts[name] = fn(pt, hk, cat)
        parts[name]["last_kernel_shapes"] = {k: list(v) for k, v in hk.last_shape.items()}
        emit({"phase": "buckets", "part": name, **parts[name]})
    launches = {k: sum(p["launches"]["phase"][k] for p in parts.values()) for k in hk.launches}
    for k in K1_K2:
        assert launches[k] > 0, f"{k} never launched on the buckets path: {launches}"
    return {"launches": launches}


# ---------------------------------------------------------------------------
# string keys: the bench table and config 4 keyed by TPC-DS business keys,
# and small engine tables keyed by (tenant STRING, id BIGINT)
# ---------------------------------------------------------------------------

BUSINESS_KEY_LETTERS = np.frombuffer(b"ABCDEFGHIJKLMNOP", dtype=np.uint8)
# the small tables' tenants: the empty string, prefix-equal strings,
# non-ASCII text, a supplementary-plane character and a trailing U+0000
TENANTS = np.array(["", "a", "ab", "acme", "acme\x00", "acme-eu", "Zurich", "Z\u00fcrich", "\u6771\u4eac",
                    "\U0001F600", "\U0001F600x", "tenant-0000000000000001"], dtype=object)
STRING_SMALL_TABLES = {k: SMALL_TABLES[k] for k in ("partial_update", "aggregation_fused", "first_row")}


def business_key_bytes(ids: np.ndarray) -> np.ndarray:
    """The ids' business keys as fixed-width bytes, which sort as the
    strings do."""
    digits = (ids.astype(np.int64)[:, None] >> (4 * np.arange(16))) & 15
    return BUSINESS_KEY_LETTERS[digits].view("S16").ravel()


def business_keys(ids: np.ndarray) -> np.ndarray:
    """The ids in TPC-DS's business-key form, as dsdgen writes c_customer_id
    CHAR(16): 16 characters over A-P, one per 4-bit digit, least
    significant first, so that string order is not numeric order."""
    return business_key_bytes(ids).astype("U16").astype(object)


def string_values(ids: np.ndarray, upsert: bool) -> dict:
    return {**table_values(ids, upsert), "id": business_keys(ids)}


def check_string_output(out, reference, up: np.ndarray, what: str) -> None:
    """The string-key bench table's read: equal to the numpy engine's read,
    and to the generator's rows in business-key order, with the upserted
    values."""
    assert out.num_rows == N_ROWS, f"{what}: {out.num_rows} rows"
    same_rows(out, reference, f"{what} against the numpy engine")
    ids = np.argsort(business_key_bytes(np.arange(N_ROWS)), kind="stable")
    assert np.array_equal(out.column("id").values, business_keys(ids)), f"{what}: keys not in business-key order"
    upserted = np.isin(ids, up)
    old, new = table_values(ids, upsert=False), table_values(ids, upsert=True)
    for name in ("c1", "c2", "c3", "d1", "d2", "s1", "s2"):
        want = np.where(upserted, new[name], old[name])
        assert np.array_equal(out.column(name).values, want), f"{what}: {name} differs from the generator"


def string_bench_part(pt, hk, warehouse: str, bigint_reads: dict) -> dict:
    """The bench table keyed by business keys (id STRING): write, 5 reads at
    each tier, each checked; then a staged read per tier (the pool and ranks
    a stage of their own) and one traced read."""
    hk.reset_launches()
    table, up, write_s = build_table(pt, warehouse, "t_string_key", {}, string_values, pt.STRING(False))
    write_launches = dict(hk.launches)
    reference = read_all(table.copy({"sort-engine": "numpy"}))
    reads = {}
    for label, tile in (("pallas_default_tile", None), (f"pallas_tile_{K1_TILE_ROWS}", K1_TILE_ROWS)):
        before = dict(hk.launches)
        out, samples = timed_reads(table if tile is None else table.copy({"merge.read-batch-rows": str(tile)}),
                                   READ_REPEATS)
        check_string_output(out, reference, up, f"string key, {label}")
        reads[label] = read_stats(samples, launch_diff(hk, before))
    launches = dict(hk.launches)
    assert reads["pallas_default_tile"]["launches"]["keep_last_mask"] > 0, "K2 never launched on string keys"
    assert reads[f"pallas_tile_{K1_TILE_ROWS}"]["launches"]["sort_segments"] > 0, "K1 never launched on string keys"
    staged = {}
    for label, tile in (("default_tile", 8 << 20), (f"tile_{K1_TILE_ROWS}", K1_TILE_ROWS)):
        staged[label] = layer_breakdown(table, tile)
        ms = staged[label]["ms"]
        staged[label]["pool_share"] = round(ms["pool_and_ranks"] / sum(ms.values()), 4)
    bigint = {label: bigint_reads[label]["output_rows_per_s_median"] for label in reads}
    return {"table": "bench.py's table, id STRING NOT NULL (TPC-DS business keys of the seed-7 ids)",
            "options": BENCH_OPTIONS, "write_s": round(write_s, 4), "reads": reads,
            "bigint_key_output_rows_per_s_median": bigint, "staged": staged, "trace": device_busy(table),
            "launches": {"write": write_launches, "reads": {k: launches[k] - write_launches[k] for k in launches},
                         "phase": launches}}


def strings_phase(pt, hk, warehouse: str, bigint_reads: dict) -> dict:
    """String primary keys, one JSON line per part with its launches: the
    bench table and config 4 keyed by business keys, and the small engine
    tables keyed by (tenant, id). Returns the phase's launches summed over
    its parts."""
    from paimon_tpu_torch.catalog import FileSystemCatalog

    cat = FileSystemCatalog(warehouse, commit_user="chip_smoke", device=DEVICE)
    parts = {"bench": string_bench_part(pt, hk, warehouse, bigint_reads)}
    emit({"phase": "strings", "part": "bench", **parts["bench"]})
    parts["config4"] = compact_phase(pt, hk, warehouse, string_key=True)
    emit({"phase": "strings", "part": "config4", **parts["config4"]})
    small, _ = small_tables_phase(pt, hk, cat, STRING_SMALL_TABLES, TENANTS, "strings")
    emit({"phase": "strings", "part": "small_tables", "tenants": TENANTS.tolist(), **small})
    assert small["aggregation_fused"]["launches"]["phase"]["segment_sum"] > 0, "segment_sum never launched"
    phases = [parts["bench"]["launches"]["phase"], parts["config4"]["launches"]["phase"],
              *[t["launches"]["phase"] for t in small.values()]]
    launches = {k: sum(p[k] for p in phases) for k in hk.launches}
    for k in hk.launches:
        assert launches[k] > 0, f"{k} never launched on the strings path: {launches}"
    return {"launches": launches}


# ---------------------------------------------------------------------------
# commit-time maintenance: config 4 expiring after every commit, partition
# expiry and drop, automatic tags, commit callbacks and forced snapshots
# ---------------------------------------------------------------------------

# snapshot.num-retained.max=10 stands in for an hour of the default
# snapshot.time-retained, which a run cannot wait for (the cut); min and
# limit stay at their defaults, 10 and 50
M_OPTIONS = {**C4_OPTIONS, "snapshot.num-retained.max": "10"}
M_TAG_AFTER = 3  # the tag is made on snapshot 3 after the third commit
M_PIN_AFTER = 10  # the consumer is written after the tenth commit
M_EXPIRATION = {"partition.expiration-time": "2 d", "partition.expiration-check-interval": "0 ms"}
M_DROP = {"snapshot.expire.clean-empty-directories": "true", "snapshot.num-retained.max": "1",
          "manifest.full-compaction-threshold-size": "1 b"}
M_POST_COMMIT = {"bucket": "1", "sort-engine": "pallas", "commit.force-create-snapshot": "true",
                 "tag.automatic-creation": "process-time", "tag.num-retained-max": "1",
                 "commit.callbacks": f"{__name__}:record_commit"}
COMMIT_CALLS: list = []


def record_commit(table, snapshot) -> None:
    """The post-commit part's commit callback: (snapshot id, kind)."""
    COMMIT_CALLS.append((snapshot.id, snapshot.commit_kind.value))


class MaintenanceProbe(Probe):
    """Host seconds of TableCommit._post_commit and, inside it, of the
    table's expire_snapshots (under async mode: handing the run over)."""

    def __init__(self):
        from paimon_tpu_torch.table import FileStoreTable
        from paimon_tpu_torch.table.write import TableCommit

        super().__init__([(TableCommit, "_post_commit", "post_commit"), (FileStoreTable, "expire_snapshots", "expiry")])
        self.expired = 0

    def _after(self, stage: str, args: tuple, out, token) -> None:
        if stage == "expiry":
            self.expired += out

    def report(self) -> dict:
        return {"post_commit_s": round(self.seconds["post_commit"], 4),
                "post_commit_without_expiry_s": round(self.seconds["post_commit"] - self.seconds["expiry"], 4),
                "expiry_s": round(self.seconds["expiry"], 4), "post_commits": self.calls["post_commit"],
                "expiry_runs": self.calls["expiry"], "snapshots_expired_sync": self.expired}


def table_files(table) -> dict:
    """Files on disk: snapshots, manifest files (data manifests, lists and
    index manifests together) and data files under bucket-*."""
    from paimon_tpu_torch.core.snapshot import SnapshotManager

    manifests = [n for n in os.listdir(f"{table.path}/manifest") if not n.startswith(".")]
    data = sum(len([n for n in names if not n.startswith(".")]) for root, _, names in os.walk(table.path)
               if os.path.basename(root).startswith("bucket-"))
    ids = SnapshotManager(table.file_io, table.path)._listed_ids()
    return {"snapshots": len(ids), "first_snapshot": ids[0] if ids else None, "latest_snapshot": ids[-1] if ids else None,
            "manifest_files": len(manifests), "data_files": data}


def referenced_files(table, snapshots: list) -> dict:
    """{data file name: bucket directory} of every file the snapshots'
    manifests name (ADD or DELETE entries); raises if a manifest list or
    manifest is missing."""
    from paimon_tpu_torch.core.manifest import ManifestFile, ManifestList

    ml = ManifestList(table.file_io, f"{table.path}/manifest")
    mf = ManifestFile(table.file_io, f"{table.path}/manifest")
    out = {}
    for snap in snapshots:
        for lst in (snap.base_manifest_list, snap.delta_manifest_list):
            for meta in ml.read(lst):
                for e in mf.read(meta.file_name):
                    out[e.file.file_name] = table.store.bucket_dir(e.partition, e.bucket)
    return out


def check_retained_files(table) -> dict:
    """Every file a retained snapshot or a tag references is on disk, and
    every data file on disk is referenced by one of them (consumer-pinned
    snapshots are retained snapshots)."""
    from paimon_tpu_torch.core.snapshot import SnapshotManager
    from paimon_tpu_torch.table.tags import TagManager

    sm = SnapshotManager(table.file_io, table.path)
    tm = TagManager(table.file_io, table.path)
    roots = [sm.snapshot(i) for i in sm._listed_ids()] + [tm.get(name) for name in tm.list_tags()]
    referenced = referenced_files(table, roots)
    missing = [name for name, d in referenced.items() if not os.path.exists(f"{d}/{name}")]
    assert not missing, f"{len(missing)} files that a retained snapshot or tag references are missing: {missing[:3]}"
    on_disk = [name for root, _, names in os.walk(table.path) if os.path.basename(root).startswith("bucket-")
               for name in names if not name.startswith(".")]
    orphans = [name for name in on_disk if name not in referenced]
    assert not orphans, f"{len(orphans)} data files no retained snapshot, tag or pin references: {orphans[:3]}"
    return {"referenced_files": len(referenced), "data_files_on_disk": len(on_disk), "missing": 0, "orphaned": 0}


def config4_expiry_part(pt, hk, cat, batches: list, last_commit: np.ndarray, mode: str) -> dict:
    """Config 4's 20 streaming commits expiring after each one: a tag on
    snapshot 3 after the third commit, a consumer at the latest snapshot
    after the tenth. mode "control" runs the default options (nothing is
    old enough to expire), "sync" and "async" the expiring table."""
    from paimon_tpu_torch.core.snapshot import SnapshotManager
    from paimon_tpu_torch.table.consumer import ConsumerManager

    options = dict(C4_OPTIONS) if mode == "control" else {
        **M_OPTIONS, **({"snapshot.expire.execution-mode": "async"} if mode == "async" else {})}
    table = cat.create_table(f"maintenance.c4_{mode}", pt.RowType.of(
        ("id", pt.BIGINT(False)), ("v", pt.DOUBLE()), ("tag", pt.STRING())), primary_keys=["id"], options=options)
    snapshots = SnapshotManager(table.file_io, table.path)
    hk.reset_launches()
    pinned = None
    with MaintenanceProbe() as probe:
        wb = table.new_stream_write_builder()
        w, c = wb.new_write(), wb.new_commit()
        kinds = []
        t0 = time.perf_counter()
        for b, batch in enumerate(batches):
            w.write(batch)
            kinds += [snapshots.snapshot(i).commit_kind.value for i in c.commit_messages(b + 1, w.prepare_commit())]
            if b + 1 == M_TAG_AFTER:
                table.create_tag("after-commit-3", 3)
            if b + 1 == M_PIN_AFTER:
                pinned = snapshots.latest_snapshot_id()
                ConsumerManager(table.file_io, table.path).record("reader", pinned)
        torch.cuda.synchronize()
        write_s = time.perf_counter() - t0
    # async: the expiry runs overlap the commits above; the one join comes
    # here, before the checks (its single worker runs them in order)
    t0 = time.perf_counter()
    if mode == "async":
        table.expire_future.result()
    join_s = time.perf_counter() - t0
    write_launches = dict(hk.launches)
    out = {"mode": mode, "options": options, "commits": len(batches),
           "snapshots_written": {k: kinds.count(k) for k in sorted(set(kinds))}, "write_s": round(write_s, 4),
           "async_join_s": round(join_s, 4), **probe.report(), "after": table_files(table), "tags": table.tags(),
           "consumer_next_snapshot": pinned}
    out["read"] = check_c4_read(table, last_commit, f"config 4, {mode}")
    out["files"] = check_retained_files(table)
    if mode != "control":
        ids = snapshots._listed_ids()
        latest = ids[-1]
        assert table.tags() == {"after-commit-3": 3}, table.tags()
        assert 3 in ids and all(i in ids for i in range(pinned, latest + 1)), (ids, pinned)
        assert snapshots.earliest_snapshot_id() == ids[0] == 3, ids
        out["snapshots_left"] = ids
    out["launches"] = {"writes": write_launches, "reads": launch_diff(hk, write_launches), "phase": dict(hk.launches)}
    return out


def partition_dates(now: float) -> np.ndarray:
    """The four days up to today, by the local clock, newest first."""
    import datetime

    today = datetime.datetime.fromtimestamp(now).date()
    return np.array([(today - datetime.timedelta(days=d)).isoformat() for d in range(4)], dtype=object)


def partition_expiry_part(pt, hk, cat) -> dict:
    """The buckets phase's partitioned dynamic-bucket table at default
    options, its dt values the four days up to today, under
    partition.expiration-time=2 d checked at every commit: each commit's
    sweep drops the two oldest days in an OVERWRITE snapshot, and the read
    equals the oracle over the two days kept. Then drop_partition on
    yesterday, and two commits under a retention that expires the dropped
    files (manifests merged in full at every commit past two, so that the
    second resolves the drop's DELETE entries, and num-retained.max=1)
    with snapshot.expire.clean-empty-directories: the dropped days'
    directories must be gone."""
    from paimon_tpu_torch.core.snapshot import SnapshotManager
    from paimon_tpu_torch.table.maintenance import drop_partition

    dts = partition_dates(time.time())
    schema = pt.RowType.of(("dt", pt.STRING()), *[(f.name, f.type) for f in build_schema(pt).fields])
    table = cat.create_table("maintenance.partitioned", schema, partition_keys=["dt"], primary_keys=["dt", "id"],
                             options={**P_OPTIONS, **M_EXPIRATION})
    sm = SnapshotManager(table.file_io, table.path)
    rng = np.random.default_rng(7)
    ids = rng.permutation(N_ROWS).astype(np.int64)
    per = N_ROWS // N_RUNS
    up = np.random.default_rng(8).choice(N_ROWS, N_UPSERT, replace=False).astype(np.int64)
    batches = [{"dt": dts[i % 4], **table_values(i, False)} for i in
               (np.sort(ids[r * per : (r + 1) * per]) for r in range(N_RUNS))]
    batches.append({"dt": dts[up % 4], **table_values(up, True)})
    hk.reset_launches()
    with MaintenanceProbe() as probe:
        t0 = time.perf_counter()
        for batch in batches:
            wb = table.new_batch_write_builder()
            w = wb.new_write()
            w.write(batch)
            wb.new_commit().commit(w.prepare_commit())
        torch.cuda.synchronize()
        write_s = time.perf_counter() - t0
    del batches
    kinds = [sm.snapshot(i).commit_kind.value for i in sm._listed_ids()]
    kept = {d for (d,) in table.store.new_scan().plan().grouped()}
    assert kept == set(dts[:2]), f"partitions left: {sorted(kept)}, want {sorted(dts[:2])}"
    assert "OVERWRITE" in kinds, kinds
    out = read_all(table)
    keep_ids = np.flatnonzero(np.arange(N_ROWS) % 4 < 2)
    got = out.column("id").values
    order = np.argsort(got, kind="stable")
    assert np.array_equal(got[order], keep_ids), "the read's ids differ from the oracle over the kept days"
    assert np.array_equal(out.column("dt").values[order], dts[keep_ids % 4]), "a row in another partition"
    upserted = np.zeros(N_ROWS, np.bool_)
    upserted[up] = True
    new, old = table_values(keep_ids, True), table_values(keep_ids, False)
    for name in ("c1", "c2", "c3", "d1", "d2", "s1", "s2"):
        want = np.where(upserted[keep_ids], new[name], old[name])
        assert np.array_equal(out.column(name).values[order], want), f"{name} differs from the oracle"
    same_rows(out, read_all(table.copy({"sort-engine": "numpy"})), "partition expiry, pallas against numpy")
    expiry = {"dates": dts.tolist(), "write_s": round(write_s, 4), **probe.report(), "snapshot_kinds": kinds,
              "partitions_kept": sorted(kept), "partitions_expired": sorted(set(dts) - kept),
              "read_rows": out.num_rows, "equal_to_oracle_over_kept_days": True, "equal_to_numpy_engine": True}
    write_launches = dict(hk.launches)
    # drop yesterday, then two commits (today only): the second merges the
    # drop's DELETE entries away and expires every older snapshot
    dropping = table.copy(M_DROP)
    dropped = drop_partition(dropping, {"dt": dts[1]})
    assert dropped == [(dts[1],)], dropped
    drop_kind = sm.latest_snapshot().commit_kind.value
    before = table_files(dropping)
    for c in range(2):  # the drop snapshot merged the manifests before its DELETEs; the second commit merges them
        wb = dropping.new_batch_write_builder()
        w = wb.new_write()
        w.write({"dt": dts[np.zeros(4, np.int64)], **table_values(np.arange(4, dtype=np.int64) * 4 + c, True)})
        wb.new_commit().commit(w.prepare_commit())
    gone = [d for d in dts[1:] if not os.path.exists(f"{table.path}/dt={d}")]
    assert gone == list(dts[1:]), f"partition directories left: {sorted(set(dts[1:]) - set(gone))}"
    left = {d for (d,) in dropping.store.new_scan().plan().grouped()}
    assert left == {dts[0]}, left
    return {"table": "bench.py's table plus dt STRING as partition key (dt = the day id % 4 days before today), "
                     "primary key (dt, id), dynamic buckets, default codecs, write-only=false",
            "options": {**P_OPTIONS, **M_EXPIRATION}, "expiry": expiry,
            "drop": {"options": M_DROP, "dropped": [list(p) for p in dropped], "snapshot_kind": drop_kind,
                     "files_before_expiry": before, "files_after": table_files(dropping),
                     "directories_gone": gone, "files": check_retained_files(dropping)},
            "launches": {"writes": write_launches, "drop": launch_diff(hk, write_launches), "phase": dict(hk.launches)}}


def post_commit_part(pt, hk, cat) -> dict:
    """A small table with commit.force-create-snapshot, automatic daily
    tags by process time keeping 1, and a commit callback in this script:
    3 batch commits and an empty one."""
    table = cat.create_table("maintenance.post_commit", pt.RowType.of(
        ("id", pt.BIGINT(False)), ("v", pt.DOUBLE()), ("tag", pt.STRING())), primary_keys=["id"],
        options=M_POST_COMMIT)
    calls = sys.modules[record_commit.__module__].COMMIT_CALLS
    calls.clear()
    hk.reset_launches()
    rng = np.random.default_rng(12)
    for b in range(3):
        ids = rng.integers(0, 3000, 2000)
        wb = table.new_batch_write_builder()
        w = wb.new_write()
        w.write({"id": ids, "v": ids * 0.5 + b, "tag": np.array([f"t{b}"] * len(ids), dtype=object)})
        wb.new_commit().commit(w.prepare_commit())
    wb = table.new_batch_write_builder()
    empty = wb.new_commit().commit(wb.new_write().prepare_commit())
    files = table_files(table)
    assert empty == [4] and files["snapshots"] == 4, (empty, files)
    assert [c[0] for c in calls] == [1, 2, 3, 4], calls
    assert len(table.tags()) == 1, table.tags()
    return {"options": M_POST_COMMIT, "commits": 4, "empty_commit_snapshot": empty, "files": files,
            "tags": table.tags(), "callback_calls": [list(c) for c in calls], "launches": {"phase": dict(hk.launches)}}


def maintenance_phase(pt, hk, warehouse: str) -> dict:
    """Commit-time maintenance, one JSON line per part; returns the
    launches of the expiring config 4 run (sync), the phase's main path."""
    from paimon_tpu_torch.catalog import FileSystemCatalog

    cat = FileSystemCatalog(warehouse, commit_user="chip_smoke", device=DEVICE)
    rng = np.random.default_rng(2)
    last_commit = np.full(C4_ROWS // 2, -1, dtype=np.int64)
    batches = []
    for b in range(C4_COMMITS):
        batches.append(c4_batch(rng, b))
        last_commit[batches[-1]["id"]] = b
    parts = {}
    for mode in ("control", "sync", "async"):
        parts[f"config4_{mode}"] = config4_expiry_part(pt, hk, cat, batches, last_commit, mode)
        emit({"phase": "maintenance", "part": f"config4_{mode}",
              "config": "BASELINE config 4 (benchmarks/baseline_configs.py:148), scale 1",
              "cuts": [] if mode == "control" else [
                  "snapshot.num-retained.max=10 stands in for an hour of snapshot.time-retained"],
              **parts[f"config4_{mode}"]})
    sync, overlapped = parts["config4_sync"], parts["config4_async"]
    assert (overlapped["snapshots_left"], overlapped["after"]) == (sync["snapshots_left"], sync["after"]), \
        "expiry overlapping the commits left other files than expiry after each commit"
    parts["partition_expiry"] = partition_expiry_part(pt, hk, cat)
    emit({"phase": "maintenance", "part": "partition_expiry", **parts["partition_expiry"]})
    parts["post_commit"] = post_commit_part(pt, hk, cat)
    emit({"phase": "maintenance", "part": "post_commit", **parts["post_commit"]})
    launches = parts["config4_sync"]["launches"]["phase"]
    for k in K1_K2:
        assert launches[k] > 0, f"{k} never launched on the maintenance path: {launches}"
    return {"launches": launches, "sync_write_launches": parts["config4_sync"]["launches"]["writes"],
            "launches_other_parts": {k: sum(p["launches"]["phase"][k] for n, p in parts.items() if n != "config4_sync")
                                     for k in hk.launches}}


# ---------------------------------------------------------------------------
# CDC sink tables: sequence.field, the changelog producers, sequence groups
# ---------------------------------------------------------------------------

CDC_PRODUCERS = ("input", "lookup", "full-compaction")
CDC_T0 = 1_760_000_000_000  # epoch millis of the first commit; commits a minute apart
CDC_LATE_SHARE = 0.1
CDC_LATE_MAX_MS = 3_600_000
SG_ROWS = 10_000_000  # config 2's size, scale 5
SG_OPTIONS = {"bucket": "1", "merge-engine": "partial-update", "write-only": "true", "sort-engine": "pallas",
              "fields.g_1.sequence-group": "a,b", "fields.g_2.sequence-group": "c,d",
              "fields.c.aggregate-function": "sum"}
SG_OLDER_SHARE = 0.05
SG_NULL_SHARE = 0.01
INSERT, UPDATE_AFTER = 0, 2


def cdc_batches(rng) -> list:
    """Config 4's 20 commits with ts BIGINT NOT NULL, an update time in
    epoch millis a minute later each commit; from the second commit on a
    tenth of the rows of ids already written carry a ts up to an hour
    older than their id's newest (late CDC events, which must lose)."""
    newest = np.full(C4_ROWS // 2, -1, dtype=np.int64)
    batches = []
    for b in range(C4_COMMITS):
        batch = c4_batch(rng, b)
        ids = batch["id"]
        ts = CDC_T0 + b * 60_000 + rng.integers(0, 60_000, len(ids))
        seen = np.flatnonzero(newest[ids] >= 0)
        late = rng.choice(seen, min(len(seen), int(len(ids) * CDC_LATE_SHARE)), replace=False)
        ts[late] = newest[ids[late]] - rng.integers(1, CDC_LATE_MAX_MS, len(late))
        np.maximum.at(newest, ids, ts)
        batches.append({**batch, "ts": ts})
    return batches


def cdc_oracle(batches) -> dict:
    """Per id, the row with the largest (ts, arrival): id, ts and commit."""
    ids = np.concatenate([b["id"] for b in batches])
    ts = np.concatenate([b["ts"] for b in batches])
    commit = np.repeat(np.arange(len(batches)), [len(b["id"]) for b in batches])
    order = np.lexsort((np.arange(len(ids)), ts, ids))
    last = np.ones(len(ids), dtype=np.bool_)
    last[:-1] = ids[order][1:] != ids[order][:-1]
    win = order[last]
    late = sum(int((b["ts"] < CDC_T0 + i * 60_000).sum()) for i, b in enumerate(batches))
    return {"id": ids[win], "ts": ts[win], "commit": commit[win], "late_rows": late}


def check_cdc_rows(out, oracle: dict, what: str) -> None:
    assert np.array_equal(out.column("id").values, oracle["id"]), f"{what}: ids differ from the oracle"
    assert np.array_equal(out.column("ts").values, oracle["ts"]), f"{what}: ts differs from the oracle"
    assert np.array_equal(out.column("v").values, oracle["id"] * 0.5 + oracle["commit"]), f"{what}: v differs"
    tags = np.array([f"t{b}" for b in oracle["commit"]], dtype=object)
    assert np.array_equal(out.column("tag").values, tags), f"{what}: tag differs from the oracle"


def check_cdc_read(table, oracle: dict, what: str) -> dict:
    """The read (sort-engine=pallas) against a sort-engine=numpy read and
    the oracle."""
    t0 = time.perf_counter()
    out = read_all(table)
    read_s = time.perf_counter() - t0
    same_rows(out, read_all(table.copy({"sort-engine": "numpy"})), f"{what}, pallas against numpy")
    check_cdc_rows(out, oracle, what)
    return {"rows": out.num_rows, "read_s": round(read_s, 4), "equal_to_numpy_engine": True, "equal_to_oracle": True}


def changelog_of(table, snapshot_ids) -> tuple:
    """The changelog rows of the snapshots, in snapshot order and in each
    one's manifest order (a KVBatch), and per snapshot kind: snapshots,
    those with changelog, changelog files and rows."""
    from paimon_tpu_torch.core.kv import KVBatch
    from paimon_tpu_torch.core.manifest import ManifestFile, ManifestList
    from paimon_tpu_torch.core.snapshot import SnapshotManager
    from paimon_tpu_torch.data.batch import ColumnBatch

    sm = SnapshotManager(table.file_io, table.path)
    ml = ManifestList(table.file_io, f"{table.path}/manifest")
    mf = ManifestFile(table.file_io, f"{table.path}/manifest")
    rf = table.store.reader_factory((), 0)
    parts, kinds = [], {}
    for sid in snapshot_ids:
        snap = sm.snapshot(sid)
        k = kinds.setdefault(snap.commit_kind.value, {"snapshots": 0, "with_changelog": 0, "files": 0, "rows": 0})
        k["snapshots"] += 1
        if not snap.changelog_manifest_list:
            continue
        files = [e.file for meta in ml.read(snap.changelog_manifest_list) for e in mf.read(meta.file_name)]
        parts += [rf.read(f) for f in files]
        rows = sum(f.row_count for f in files)
        assert snap.changelog_record_count == rows, f"snapshot {sid}: changelogRecordCount is not its files' rows"
        k["with_changelog"] += 1
        k["files"] += len(files)
        k["rows"] += rows
    if not parts:
        return KVBatch(ColumnBatch.empty(table.store.value_schema), np.empty(0, np.int64), np.empty(0, np.uint8)), kinds
    return KVBatch.concat(parts), kinds


def replay(changelog) -> dict:
    """The state that applying the changelog rows in order to an empty
    table gives: per id its last row, kept when that row is +I or +U."""
    ids = changelog.data.column("id").values
    _, first_from_end = np.unique(ids[::-1], return_index=True)
    last = len(ids) - 1 - first_from_end
    last = last[np.isin(changelog.kind[last], (INSERT, UPDATE_AFTER))]
    rows = changelog.take(last)
    return {n: rows.data.column(n).values for n in rows.data.schema.field_names}


def check_replay(state: dict, out, what: str) -> None:
    assert len(state["id"]) == out.num_rows, f"{what}: the replay holds {len(state['id'])} ids, the table {out.num_rows}"
    for name, values in state.items():
        assert np.array_equal(values, out.column(name).values), f"{what}: the replay's {name} differs"


class CdcProbe(Probe):
    """Host seconds and kernel launches of the writers' lookups and of the
    compactions."""

    def __init__(self, hk):
        from paimon_tpu_torch.core.compact import MergeTreeCompactManager
        from paimon_tpu_torch.core.writer import MergeTreeWriter

        super().__init__([(MergeTreeCompactManager, "trigger_compaction", "compaction"),
                          (MergeTreeWriter, "_lookup_changelog", "lookup")])
        self.hk = hk
        self.launches = {stage: dict.fromkeys(hk.launches, 0) for stage in self.seconds}

    def _before(self, stage: str, args: tuple):
        return dict(self.hk.launches)

    def _after(self, stage: str, args: tuple, out, before) -> None:
        for k in self.launches[stage]:
            self.launches[stage][k] += self.hk.launches[k] - before[k]


class ShapeRecorder:
    """Records the shapes K1 and K2 are called at while installed, without
    touching their launch counts."""

    def __init__(self, hk):
        self.hk = hk
        self.k1: set = set()
        self.k2: set = set()

    def __enter__(self):
        self.saved = (self.hk.sort_segments, self.hk.keep_last_mask)
        k1, k2 = self.saved

        def sort_segments(stacked, num_boundary):
            self.k1.add((*stacked.shape, num_boundary))
            return k1(stacked, num_boundary)

        def keep_last_mask(stacked, mask_pad=True):
            self.k2.add(tuple(stacked.shape))
            return k2(stacked, mask_pad)

        self.hk.sort_segments, self.hk.keep_last_mask = sort_segments, keep_last_mask
        return self

    def __exit__(self, *exc):
        self.hk.sort_segments, self.hk.keep_last_mask = self.saved


def cdc_config4_part(pt, hk, cat, batches: list, oracle: dict, producer: str) -> dict:
    """Config 4 with ts as sequence.field under one changelog producer: the
    20 streaming commits (full-compaction: then a full compaction), the read
    against the numpy engine and the oracle, and the changelog checks."""
    from paimon_tpu_torch.core.snapshot import SnapshotManager

    options = {**C4_OPTIONS, "sequence.field": "ts", "changelog-producer": producer}
    table = cat.create_table(f"cdc.c4_{producer.replace('-', '_')}", pt.RowType.of(
        ("id", pt.BIGINT(False)), ("v", pt.DOUBLE()), ("tag", pt.STRING()), ("ts", pt.BIGINT(False))),
        primary_keys=["id"], options=options)
    snapshots = SnapshotManager(table.file_io, table.path)
    max_level = table.store.options.num_levels - 1
    hk.reset_launches()
    checks = {"full_compaction_replays": 0}
    replay_launches = dict.fromkeys(hk.launches, 0)  # the checks' reads, inside the write loop
    write_s = 0.0
    ids_written = []
    with CdcProbe(hk) as probe:
        wb = table.new_stream_write_builder()
        w, c = wb.new_write(), wb.new_commit()
        for b, batch in enumerate(batches):
            t0 = time.perf_counter()
            w.write(batch)
            written = c.commit_messages(b + 1, w.prepare_commit())
            torch.cuda.synchronize()
            write_s += time.perf_counter() - t0
            ids_written += written
            if producer != "full-compaction":
                continue
            compacted = [i for i in written if snapshots.snapshot(i).commit_kind.value == "COMPACT"
                         and snapshots.snapshot(i).changelog_manifest_list]
            if compacted:
                # the changelog so far replays to the rows at the max level
                before = dict(hk.launches)
                top = [e.file for e in table.store.new_scan().plan().entries if e.file.level == max_level]
                check_replay(replay(changelog_of(table, ids_written)[0]), table.store.read_bucket((), 0, top),
                             f"{producer}: after commit {b + 1}")
                checks["full_compaction_replays"] += 1
                for k in hk.launches:
                    replay_launches[k] += hk.launches[k] - before[k]
        if producer == "full-compaction":
            t0 = time.perf_counter()
            wbf = table.new_batch_write_builder()
            wf = wbf.new_write()
            wf.compact(full=True)
            ids_written += wbf.new_commit().commit(wf.prepare_commit())
            torch.cuda.synchronize()
            write_s += time.perf_counter() - t0
    write_launches = dict(hk.launches)
    read = check_cdc_read(table, oracle, f"cdc {producer}")
    changelog, by_kind = changelog_of(table, ids_written)
    out_rows = read_all(table)
    if producer == "input":
        for name in ("id", "v", "tag", "ts"):
            assert np.array_equal(changelog.data.column(name).values,
                                  np.concatenate([b[name] for b in batches])), f"input: changelog {name} is not the input"
        assert (changelog.kind == INSERT).all(), "input: the changelog's kinds are not the input's"
        checks["changelog_is_the_input"] = True
    else:
        check_replay(replay(changelog), out_rows, f"{producer}: the replay against the final read")
        checks["replay_equals_final_read"] = True
    phase = dict(hk.launches)
    lookups, compactions = probe.launches["lookup"], probe.launches["compaction"]
    return {
        "options": options, "rows_written": C4_ROWS, "late_rows": oracle["late_rows"],
        "write_s": round(write_s, 4), "ingest_rows_per_s": round(C4_ROWS / write_s, 1),
        "compaction_s": round(probe.seconds["compaction"], 4), "lookup_s": round(probe.seconds["lookup"], 4),
        "lookups": probe.calls["lookup"], "compaction_calls": probe.calls["compaction"],
        "snapshots": by_kind, "changelog_rows": changelog.num_rows,
        "changelog_files": sum(k["files"] for k in by_kind.values()),
        "levels_after": level_layout(table), "read": read, "checks": checks,
        "launches": {"phase": phase,
                     "flushes": {k: write_launches[k] - lookups[k] - compactions[k] - replay_launches[k] for k in phase},
                     "lookups": lookups, "compactions": compactions, "replay_checks": replay_launches,
                     "reads": {k: phase[k] - write_launches[k] for k in phase}},
    }


def sg_batch(schema, keys: np.ndarray, r: int, rng):
    """Commit r of the sequence-group table: even commits are the stream
    that fills group 1 (a, b, g_1), odd ones the stream that fills group 2
    (c, d, g_2); a group's sequence rises with its stream's commits, but
    5% of the rows of a stream's second commit carry an older one, and 1%
    of every commit's rows a null one."""
    from paimon_tpu_torch.data.batch import Column, ColumnBatch

    n = len(keys)
    g = (r // 2 + 1) * 1000 + rng.integers(0, 1000, n)
    if r >= 2:
        older = rng.random(n) < SG_OLDER_SHARE
        g[older] = rng.integers(0, 1000, int(older.sum()))
    g_valid = rng.random(n) >= SG_NULL_SHARE

    def null(dtype):
        return Column(np.zeros(n, dtype), np.zeros(n, np.bool_))

    filled = {"a": Column((keys % 1000 + r).astype(np.int32)), "b": Column(((keys * 7 + r) % 977).astype(np.int32)),
              "g_1": Column(g, g_valid)} if r % 2 == 0 else {
        "c": Column((keys % 13 + r).astype(np.int32)), "d": Column((keys % 11 + r).astype(np.int32)),
        "g_2": Column(g, g_valid)}
    cols = {"k": Column(keys)}
    for name in ("a", "b", "g_1", "c", "d", "g_2"):
        cols[name] = filled.get(name) or null(np.int64 if name.startswith("g") else np.int32)
    return ColumnBatch(schema, cols)


def sg_oracle(batches, keys: np.ndarray) -> dict:
    """Per key and group: the fields of the row with the largest (group
    sequence, arrival) among the rows whose group sequence is set, c
    summed over those rows; null where there is none."""
    out = {"k": (keys, np.ones(len(keys), np.bool_))}
    for group, fields, commits in (("g_1", ("a", "b"), (0, 2)), ("g_2", ("c", "d"), (1, 3))):
        first, second = (batches[i] for i in commits)
        ok0, ok1 = first.column(group).valid_mask(), second.column(group).valid_mask()
        g0, g1 = first.column(group).values, second.column(group).values
        take_second = ok1 & (~ok0 | (g1 >= g0))
        any_ok = ok0 | ok1
        for name in (*fields, group):
            values = np.where(take_second, second.column(name).values, first.column(name).values)
            out[name] = (values, any_ok)
        if group == "g_2":
            c0, c1 = first.column("c").values, second.column("c").values
            out["c"] = (np.where(ok0, c0, 0) + np.where(ok1, c1, 0), any_ok)
    return out


def check_sg_read(out, oracle: dict, what: str) -> None:
    assert out.num_rows == len(oracle["k"][0]), f"{what}: {out.num_rows} rows"
    for name, (values, valid) in oracle.items():
        col = out.column(name)
        assert np.array_equal(col.valid_mask(), valid), f"{what}: validity of {name} differs from the oracle"
        assert np.array_equal(col.values[valid], values[valid]), f"{what}: {name} differs from the oracle"


def sg_read_stages(table) -> dict:
    """One read of the sequence-group table, stage by stage over its
    sections (host clock, device synchronised at each boundary): decode
    every column, the key plan (lanes, sort and segments, existence), the
    group plans (each group's lanes, plan, pick and aggregates), gather."""
    from paimon_tpu_torch.core.kv import KVBatch
    from paimon_tpu_torch.core.levels import IntervalPartition
    from paimon_tpu_torch.core.read import order_runs_for_merge
    from paimon_tpu_torch.ops.merge import merge_plan, partial_update_takes

    store = table.store
    (split,) = table.new_read_builder().new_scan().plan()
    rf = store.reader_factory(split.partition, split.bucket)
    merge = store.merge_executor()
    ms = dict.fromkeys(("decode", "key_plan", "group_plans", "gather"), 0.0)
    sections = IntervalPartition(split.files).partition()
    rows_in = rows_out = 0
    for section in sections:
        runs, seq_ascending = order_runs_for_merge(section)
        t0 = time.perf_counter()
        kv = KVBatch.concat([rf.read(f) for run in runs for f in run.files])
        ms["decode"] += time.perf_counter() - t0
        rows_in += kv.num_rows
        if len(runs) == 1:
            rows_out += kv.num_rows
            continue
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = merge_plan(merge._key_lanes(kv), merge._seq_lanes(kv, seq_ascending), True, "pallas", DEVICE)
        last_take = plan.perm[plan.keep_last & plan.valid_sorted]
        src, exists = partial_update_takes(plan, merge._field_valid(kv), kv.kind, False, DEVICE)
        torch.cuda.synchronize()
        ms["key_plan"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        groups = {}
        for seq_col, fields in merge._sequence_groups().items():
            groups.update(merge._group_take(kv, seq_col, fields))
        torch.cuda.synchronize()
        ms["group_plans"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        rows_out += merge._partial_update_rows(kv, src, exists, last_take, groups).drop_deletes().num_rows
        ms["gather"] += time.perf_counter() - t0
    total = sum(ms.values())
    return {"sections": len(sections), "input_rows": rows_in, "output_rows": rows_out,
            "ms": {k: round(v * 1e3, 3) for k, v in ms.items()},
            "group_plans_share": round(ms["group_plans"] / total, 4) if total else None}


def sequence_group_part(pt, hk, cat) -> dict:
    """The sequence-group table of Apache Paimon's partial-update docs at
    config 2's size: write, 3 timed reads, each checked against the numpy
    and xla-segmented engines and the oracle, and a staged read."""
    schema = pt.RowType.of(("k", pt.BIGINT(False)), ("a", pt.INT()), ("b", pt.INT()), ("g_1", pt.BIGINT()),
                           ("c", pt.INT()), ("d", pt.INT()), ("g_2", pt.BIGINT()))
    table = cat.create_table("cdc.sequence_groups", schema, primary_keys=["k"], options=dict(SG_OPTIONS))
    per = SG_ROWS // 4
    keys = np.arange(per, dtype=np.int64)
    rng = np.random.default_rng(13)
    batches = [sg_batch(schema, keys, r, rng) for r in range(4)]
    oracle = sg_oracle(batches, keys)
    hk.reset_launches()
    t0 = time.perf_counter()
    for batch in batches:
        wb = table.new_batch_write_builder()
        w = wb.new_write()
        w.write(batch)
        wb.new_commit().commit(w.prepare_commit())
    torch.cuda.synchronize()
    write_s = time.perf_counter() - t0
    write_launches = dict(hk.launches)
    del batches
    out, samples = timed_reads(table, BIG_READ_REPEATS)
    read_launches = {k: hk.launches[k] - write_launches[k] for k in hk.launches}
    check_sg_read(out, oracle, "sequence groups")
    for engine in ("numpy", "xla-segmented"):
        same_rows(out, read_all(table.copy({"sort-engine": engine})), f"sequence groups, pallas against {engine}")
    launches = dict(hk.launches)
    return {
        "config": "Apache Paimon docs, primary-key table, merge engine partial-update, section 'Sequence Group' "
                  "(k, a, b, g_1, c, d, g_2), at BASELINE config 2's size (scale 5)",
        "options": SG_OPTIONS, "rows_written": SG_ROWS, "commits": 4, "keys": per,
        "older_group_sequence_share": SG_OLDER_SHARE, "null_group_sequence_share": SG_NULL_SHARE,
        "write_s": round(write_s, 4),
        "reads": {"samples_s": [round(x, 4) for x in samples],
                  "rows_per_s": [round(SG_ROWS / x, 1) for x in samples],
                  "median_rows_per_s": round(SG_ROWS / float(np.median(samples)), 1)},
        "launches": {"write": write_launches, "reads": read_launches, "phase": launches},
        "equal_to_numpy_engine": True, "equal_to_xla_segmented": True, "equal_to_oracle": True,
        "read_stages": sg_read_stages(table),
    }


def path_shape_checks(hk, recorder: ShapeRecorder, dev, seed: int, checked: tuple = ((), ())) -> dict:
    """K1 and K2 held exactly to their plain versions at the shapes a path
    called them at that neither the kernels phase nor `checked` (K1 shapes,
    K2 shapes an earlier path's checks held) covers."""
    rng = np.random.default_rng(seed)
    tile = hk.K1_TILE
    k1_checked = {2, 4, 64, tile // 2, tile, 2 * tile, 4096, 1 << 17, 1 << 18}
    k1_new = sorted(s for s in recorder.k1 if (s[1] not in k1_checked or s[2] not in (1, s[0] - 1))
                    and s not in set(checked[0]))
    k2_new = sorted(s for s in recorder.k2 if (s[0] not in K2_LANES or s[1] not in K2_COLUMNS)
                    and s not in set(checked[1]))
    checks = 0
    for nl, m, nb in k1_new:
        for pattern in K1_PATTERNS:
            x, _ = k1_input(hk, rng, m, nl, dev, pattern)
            got = hk.sort_segments(x, nb)
            torch.cuda.synchronize()
            assert torch.equal(got, hk.sort_segments_plain(x, nb)), f"K1 differs at {(nl, m, nb)}, {pattern}"
            checks += 1
    for lanes, m in k2_new:
        for pattern in K2_PATTERNS:
            y = k2_input(hk, lanes, m, dev, pattern)
            for mask_pad in (False, True):
                got = hk.keep_last_mask(y, mask_pad)
                torch.cuda.synchronize()
                assert torch.equal(got, hk.keep_last_mask_plain(y, mask_pad)), f"K2 differs at {(lanes, m)}, {pattern}"
                checks += 1
            del y
    return {"k1_shapes": sorted(recorder.k1), "k2_shapes": sorted(recorder.k2),
            "k1_new_shapes": k1_new, "k2_new_shapes": k2_new, "exact_checks": checks}


def cdc_phase(pt, hk, warehouse: str, control: dict) -> dict:
    """CDC sink tables, one JSON line per part: config 4 with a ts
    sequence.field under each changelog producer, beside the compact
    phase's run (control); the sequence-group table; then K1 and K2 at the
    path's shapes the kernels phase missed. Launch counts are zeroed before
    each part and summed over the parts."""
    from paimon_tpu_torch.catalog import FileSystemCatalog

    cat = FileSystemCatalog(warehouse, commit_user="chip_smoke", device=DEVICE)
    batches = cdc_batches(np.random.default_rng(2))
    oracle = cdc_oracle(batches)
    launches = dict.fromkeys(hk.launches, 0)
    parts = {}
    with ShapeRecorder(hk) as recorder:
        for producer in CDC_PRODUCERS:
            part = cdc_config4_part(pt, hk, cat, batches, oracle, producer)
            parts[producer] = part
            emit({"phase": "cdc", "part": f"config4_{producer}",
                  "config": "BASELINE config 4 (benchmarks/baseline_configs.py:148), scale 1, with ts BIGINT NOT NULL "
                            "as sequence.field",
                  "control_write_s": control["stream"]["write_s"], **part})
        del batches
        parts["sequence_groups"] = sequence_group_part(pt, hk, cat)
        emit({"phase": "cdc", "part": "sequence_groups", **parts["sequence_groups"]})
    for part in parts.values():
        for k in launches:
            launches[k] += part["launches"]["phase"][k]
    for k in K1_K2:
        assert launches[k] > 0, f"{k} never launched on the cdc path: {launches}"
    shape_checks = path_shape_checks(hk, recorder, torch.device(DEVICE), 2027)
    return {"launches": launches,
            "launches_by_part": {name: part["launches"]["phase"] for name, part in parts.items()},
            "shape_checks": shape_checks}


# ---------------------------------------------------------------------------
# row-level deletes: DELETE through deletion vectors on the bench table,
# filtered reads, the full compaction that purges the vectors, and
# record-level TTL on config 4
# ---------------------------------------------------------------------------

DV_OPTIONS = {"deletion-vectors.enabled": "true"}
DV_ERASED = 50_000  # ids erased by key, drawn with seed 9
DV_C2 = 13  # the value predicate c2 = 13
# config 4 with an epoch-millis ts column; ids divisible by TTL_EVERY carry a
# ts two hours old in every version, so a tenth of the ids expire
TTL_OPTIONS = {**C4_OPTIONS, "record-level.expire-time": "1 h", "record-level.time-field": "ts",
               "record-level.time-field-type": "millis"}
TTL_EVERY = 10


def dv_stats(table) -> dict:
    """The latest snapshot's deletion vectors: containers (chains counted
    file by file), their bytes, files with a vector, positions."""
    from paimon_tpu_torch.core.deletionvectors import DeletionVectorsIndexFile

    plan = table.store.new_scan().plan()
    idx = DeletionVectorsIndexFile(table.file_io, table.path)
    heads = plan.dv_indexes().values()
    containers = [n for head in heads for n in idx.chain_names(head)]
    dvs = {f: dv for head in heads for f, dv in idx.read_all(head).items()}
    return {"containers": len(containers),
            "container_bytes": sum(os.path.getsize(f"{idx.index_dir}/{n}") for n in containers),
            "files_with_vectors": len(dvs), "positions": sum(dv.cardinality for dv in dvs.values()),
            "data_files": len(plan.entries)}


def check_dv_rows(out, reference, keep: np.ndarray, current: dict, what: str) -> None:
    """`out` equals the numpy engine's `reference` row for row and the
    oracle: the ids `keep` marks, in order, with their current values."""
    same_rows(out, reference, f"{what}: against the numpy engine")
    ids = np.flatnonzero(keep)
    assert np.array_equal(out.column("id").values, ids), f"{what}: ids differ from the oracle"
    for name, values in current.items():
        assert np.array_equal(out.column(name).values, values[ids]), f"{what}: {name} differs from the oracle"


def read_filtered(table, predicate):
    rb = table.new_read_builder().with_filter(predicate)
    splits = rb.new_scan().plan()
    out = rb.new_read().read_all(splits)
    torch.cuda.synchronize()
    return out, splits


def dv_bench_part(pt, hk, warehouse: str) -> dict:
    """The bench table with deletion-vectors.enabled: two DELETEs, reads at
    both tiles, two filtered reads, a traced read, then compact(full=True)
    on a write-only=false handle. Every read equals the numpy engine and
    the oracle kept here (the ids written, upserted and deleted)."""
    from paimon_tpu_torch.data.predicate import between, equal, greater_than, in_

    hk.reset_launches()
    table, up, write_s = build_table(pt, warehouse, "dv", DV_OPTIONS)
    launches = {"writes": dict(hk.launches)}
    ids = np.arange(N_ROWS)
    upserted = np.zeros(N_ROWS, np.bool_)
    upserted[up] = True
    new, old = table_values(ids, True), table_values(ids, False)
    current = {name: np.where(upserted, new[name], old[name]) for name in new}
    alive = np.ones(N_ROWS, np.bool_)
    erased = np.random.default_rng(9).choice(N_ROWS, DV_ERASED, replace=False)

    before = dict(hk.launches)
    deletes = {}
    t0 = time.perf_counter()
    n = table.delete_where(in_("id", erased.tolist()))
    torch.cuda.synchronize()
    deletes["erase_by_key"] = {"predicate": f"id IN ({DV_ERASED} ids drawn with seed 9)",
                               "seconds": round(time.perf_counter() - t0, 4), "rows_deleted": n, **dv_stats(table)}
    assert n == DV_ERASED, f"the erasure deleted {n} rows"
    alive[erased] = False
    matched = alive & (current["c2"] == DV_C2)
    # upserted keys whose older version has c2 = 13: they must stay, with
    # their newest values (the resurrection check)
    older_matched = alive & upserted & (old["c2"] == DV_C2)
    t0 = time.perf_counter()
    n = table.delete_where(equal("c2", DV_C2))
    torch.cuda.synchronize()
    deletes["by_value"] = {"predicate": f"c2 = {DV_C2}", "seconds": round(time.perf_counter() - t0, 4),
                           "rows_deleted": n, "upserted_keys_whose_older_version_matched": int(older_matched.sum()),
                           **dv_stats(table)}
    assert n == int(matched.sum()) and older_matched.any(), (n, int(matched.sum()), int(older_matched.sum()))
    alive &= ~matched
    launches["deletes"] = launch_diff(hk, before)

    before = dict(hk.launches)
    reference = read_all(table.copy({"sort-engine": "numpy"}))
    check_dv_rows(reference, reference, alive, current, "numpy engine")
    reads = {}
    for label, opts in (("pallas_default_tile", {}),
                        (f"pallas_tile_{K1_TILE_ROWS}", {"merge.read-batch-rows": str(K1_TILE_ROWS)})):
        b = dict(hk.launches)
        out, samples = timed_reads(table.copy(opts), READ_REPEATS)
        check_dv_rows(out, reference, alive, current, label)
        median = float(np.median(samples))
        reads[label] = {"samples_s": [round(x, 4) for x in samples], "median_s": round(median, 4),
                        "output_rows": out.num_rows, "output_rows_per_s_median": round(out.num_rows / median, 1),
                        "input_rows_per_s_median": round((N_ROWS + N_UPSERT) / median, 1),
                        "launches": launch_diff(hk, b)}
    every = table.new_read_builder().new_scan().plan()
    lo, hi = int(0.4 * N_ROWS), int(0.45 * N_ROWS) - 1
    filtered = {}
    for label, pred, keep in (
        (f"id BETWEEN {lo} AND {hi}", between("id", lo, hi), alive & (ids >= lo) & (ids <= hi)),
        (f"d1 > {N_ROWS / 4}", greater_than("d1", N_ROWS / 4), alive & (current["d1"] > N_ROWS / 4)),
    ):
        ref, _ = read_filtered(table.copy({"sort-engine": "numpy"}), pred)
        t0 = time.perf_counter()
        out, splits = read_filtered(table, pred)
        seconds = time.perf_counter() - t0
        check_dv_rows(out, ref, keep, current, label)
        filtered[label] = {"seconds": round(seconds, 4), "rows": out.num_rows,
                           "output_rows_per_s": round(out.num_rows / seconds, 1),
                           "splits_pruned": len(every) - len(splits),
                           "files_pruned": sum(len(s.files) for s in every) - sum(len(s.files) for s in splits)}
    launches["reads"] = launch_diff(hk, before)
    trace = device_busy(table)

    vectors = dv_stats(table)
    from paimon_tpu_torch.core.deletionvectors import DeletionVectorsIndexFile

    plan = table.store.new_scan().plan()
    dv_files = {f for head in plan.dv_indexes().values()
                for f in DeletionVectorsIndexFile(table.file_io, table.path).read_all(head)}
    before = dict(hk.launches)
    with CompactionProbe(hk) as probe:
        t0 = time.perf_counter()
        wb = table.copy({"write-only": "false"}).new_batch_write_builder()
        w = wb.new_write()
        w.compact(full=True)
        wb.new_commit().commit(w.prepare_commit())
        torch.cuda.synchronize()
        compact_s = time.perf_counter() - t0
    launches["compaction"] = launch_diff(hk, before)
    plan = table.store.new_scan().plan()
    assert not dv_files & {e.file.file_name for e in plan.entries}, "a file with a vector survived the compaction"
    assert not [e for e in plan.index_entries if e.kind == "DELETION_VECTORS"], "vectors left in the index manifest"
    assert sum(e.file.row_count for e in plan.entries) == int(alive.sum()), "deleted rows left on disk"
    check_dv_rows(read_all(table), read_all(table.copy({"sort-engine": "numpy"})), alive, current,
                  "after the full compaction")
    launches["phase"] = dict(hk.launches)
    return {"table": "bench.py's table (bench.py:54-96), its options, deletion-vectors.enabled=true",
            "rows_written": N_ROWS + N_UPSERT, "write_s": round(write_s, 4), "deletes": deletes,
            "rows_left": int(alive.sum()), "reads": reads, "filtered_reads": filtered, "vectors": vectors,
            "trace": trace, "compaction": {"seconds": round(compact_s, 4), "files_with_vectors_rewritten": len(dv_files),
                                           **probe.report(), "vectors_left": 0},
            "equal_to_numpy_engine": True, "equal_to_oracle": True, "launches": launches}


def ttl_part(pt, hk, cat) -> dict:
    """Config 4 at scale 1 with an epoch-millis ts (the run's clock; two
    hours old for ids divisible by TTL_EVERY) under record-level.expire-time
    = 1 h: 20 streaming commits with compactions, the read, then a full
    compaction that must leave only the live rows on disk."""
    schema = pt.RowType.of(("id", pt.BIGINT(False)), ("v", pt.DOUBLE()), ("tag", pt.STRING()), ("ts", pt.BIGINT()))
    table = cat.create_table("deletes.c4_ttl", schema, primary_keys=["id"], options=dict(TTL_OPTIONS))
    rng = np.random.default_rng(2)
    last_commit = np.full(C4_ROWS // 2, -1, dtype=np.int64)
    now_ms = int(time.time() * 1000)
    batches = []
    for b in range(C4_COMMITS):
        batch = c4_batch(rng, b)
        batch["ts"] = np.where(batch["id"] % TTL_EVERY == 0, now_ms - 7_200_000, now_ms)
        last_commit[batch["id"]] = b
        batches.append(batch)
    keep = np.arange(C4_ROWS // 2) % TTL_EVERY != 0
    hk.reset_launches()
    with CompactionProbe(hk) as probe:
        wb = table.new_stream_write_builder()
        w, c = wb.new_write(), wb.new_commit()
        t0 = time.perf_counter()
        for b, batch in enumerate(batches):
            w.write(batch)
            c.commit_messages(b + 1, w.prepare_commit())
        torch.cuda.synchronize()
        write_s = time.perf_counter() - t0
    write_launches = dict(hk.launches)
    read = check_c4_read(table, last_commit, "ttl: after 20 commits", keep=keep)
    t0 = time.perf_counter()
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.compact(full=True)
    wb.new_commit().commit(w.prepare_commit())
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    live = int(((last_commit >= 0) & keep).sum())
    on_disk = sum(f.row_count for f in live_files(table))
    assert on_disk == live, f"ttl: {on_disk} rows on disk after the full compaction, {live} live"
    full_read = check_c4_read(table, last_commit, "ttl: after the full compaction", keep=keep)
    phase = dict(hk.launches)
    return {"config": "BASELINE config 4 (benchmarks/baseline_configs.py:148), scale 1, with ts BIGINT epoch millis",
            "options": TTL_OPTIONS, "rows_written": C4_ROWS, "ids_written": int((last_commit >= 0).sum()),
            "ids_expired": int(((last_commit >= 0) & ~keep).sum()), "write_s": round(write_s, 4),
            "ingest_rows_per_s": round(C4_ROWS / write_s, 1), "compaction": probe.report(), "read": read,
            "full_compaction_s": round(full_s, 4), "rows_on_disk_after": on_disk, "read_after": full_read,
            "launches": {"phase": phase, "streaming_writes": write_launches,
                         "reads_and_full_compaction": {k: phase[k] - write_launches[k] for k in phase}}}


def deletes_phase(pt, hk, warehouse: str, cdc_checked: dict) -> dict:
    """Row-level deletes, one JSON line per part: the deletion-vector bench
    table and config 4 under record TTL; then K1 and K2 at the path's
    shapes that the kernels and cdc phases did not check."""
    from paimon_tpu_torch.catalog import FileSystemCatalog

    cat = FileSystemCatalog(warehouse, commit_user="chip_smoke", device=DEVICE)
    parts = {}
    with ShapeRecorder(hk) as recorder:
        t0 = time.perf_counter()
        parts["deletion_vectors"] = dv_bench_part(pt, hk, warehouse)
        parts["deletion_vectors"]["part_s"] = round(time.perf_counter() - t0, 3)
        emit({"phase": "deletes", "part": "deletion_vectors", **parts["deletion_vectors"]})
        t0 = time.perf_counter()
        parts["record_ttl"] = ttl_part(pt, hk, cat)
        parts["record_ttl"]["part_s"] = round(time.perf_counter() - t0, 3)
        emit({"phase": "deletes", "part": "record_ttl", **parts["record_ttl"]})
    launches = {k: sum(p["launches"]["phase"][k] for p in parts.values()) for k in hk.launches}
    for k in K1_K2:
        assert launches[k] > 0, f"{k} never launched on the deletes path: {launches}"
    checked = ([tuple(s) for s in cdc_checked["k1_new_shapes"]], [tuple(s) for s in cdc_checked["k2_new_shapes"]])
    return {"launches": launches, "launches_by_part": {name: p["launches"]["phase"] for name, p in parts.items()},
            "shape_checks": path_shape_checks(hk, recorder, torch.device(DEVICE), 2028, checked)}


# ---------------------------------------------------------------------------
# table history: time travel, incremental reads, a branch, rollback and
# fast-forward on a copy of the bench table, and a stream reader with a
# consumer over config 4
# ---------------------------------------------------------------------------

# config 4 with a consumer's stream reader and at most 10 snapshots kept
C4_HISTORY_OPTIONS = {**C4_OPTIONS, "snapshot.num-retained.max": "10"}
HISTORY_ACKS = (10, 20)  # commits after which the reader's checkpoint completes
HISTORY_CHECKS = (5, 10, 20)  # commits after which the replayed deltas are checked
NO_IDS = np.empty(0, np.int64)


def bench_runs() -> tuple[list, np.ndarray]:
    """The bench table's four runs (sorted ids) and its upserted ids, drawn
    as build_table draws them."""
    ids = np.random.default_rng(7).permutation(N_ROWS).astype(np.int64)
    per = N_ROWS // N_RUNS
    runs = [np.sort(ids[r * per:(r + 1) * per]) for r in range(N_RUNS)]
    return runs, np.random.default_rng(8).choice(N_ROWS, N_UPSERT, replace=False).astype(np.int64)


def check_history_rows(out, reference, ids: np.ndarray, upserted: np.ndarray, what: str) -> None:
    """`out` equals the numpy engine's `reference` row for row and the
    oracle: `ids` in order, those in `upserted` with the upsert's values,
    the others with their first values."""
    same_rows(out, reference, f"{what}: against the numpy engine")
    assert np.array_equal(out.column("id").values, ids), f"{what}: ids differ from the oracle"
    new, old, is_up = table_values(ids, True), table_values(ids, False), np.isin(ids, upserted)
    for name in new:
        assert np.array_equal(out.column(name).values, np.where(is_up, new[name], old[name])), (
            f"{what}: {name} differs from the oracle")


def history_read(hk, table, options: dict, ids: np.ndarray, upserted: np.ndarray, what: str) -> dict:
    """The table read under `options` at both tiles, each held to a
    sort-engine=numpy read under the same options and to the oracle; per
    tile seconds, rows, splits, files and launches."""
    reference = read_all(table.copy({**options, "sort-engine": "numpy"}))
    out = {}
    for label, tile in (("default_tile", {}), (f"tile_{K1_TILE_ROWS}", {"merge.read-batch-rows": str(K1_TILE_ROWS)})):
        before = dict(hk.launches)
        rb = table.copy({**options, **tile}).new_read_builder()
        t0 = time.perf_counter()
        splits = rb.new_scan().plan()
        rows = rb.new_read().read_all(splits)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check_history_rows(rows, reference, ids, upserted, f"{what}, {label}")
        out[label] = {"seconds": round(seconds, 4), "rows": rows.num_rows, "splits": len(splits),
                      "files": sum(len(x.files) for x in splits), "launches": launch_diff(hk, before)}
    return out


def time_travel_part(hk, table, runs: list) -> dict:
    """Reads of snapshots 2 and 4 of the bench table's copy by id, tag,
    version and time."""
    sm = table.store.snapshot_manager
    t2, t3 = sm.snapshot(2).time_millis, sm.snapshot(3).time_millis
    assert t2 < t3, f"snapshots 2 and 3 share the time {t2}"
    table.create_tag("t2", 2)
    at = {k: np.sort(np.concatenate(runs[:k])) for k in (2, 4)}
    travels = {"scan.snapshot-id=2": ({"scan.snapshot-id": "2"}, 2), "scan.tag-name=t2": ({"scan.tag-name": "t2"}, 2),
               "scan.version=t2": ({"scan.version": "t2"}, 2),
               f"scan.timestamp-millis={t2}": ({"scan.timestamp-millis": str(t2)}, 2),
               "scan.snapshot-id=4": ({"scan.snapshot-id": "4"}, 4)}
    before = dict(hk.launches)
    reads = {label: history_read(hk, table, opts, at[k], NO_IDS, label) for label, (opts, k) in travels.items()}
    return {"reads": reads, "oracle_rows": {"snapshot 2": len(at[2]), "snapshot 4": len(at[4])},
            "launches": launch_diff(hk, before)}


def change_read(table, options: dict) -> tuple:
    """(rows, kinds, splits) of an incremental read."""
    rb = table.copy(options).new_read_builder()
    splits = rb.new_scan().plan()
    read = rb.new_read()
    parts = [read.read_with_kinds(s) for s in splits]
    torch.cuda.synchronize()
    from paimon_tpu_torch.data.batch import concat_batches

    return concat_batches([p[0] for p in parts]), np.concatenate([p[1] for p in parts]), splits


def incremental_part(hk, table, runs: list, up: np.ndarray) -> dict:
    """incremental-between=4,5 and t2,5 in delta mode, held to the numpy
    engine and, as multisets of rows with their kinds, to the oracle."""
    before = dict(hk.launches)
    out = {}
    for spec, changes in (("4,5", [(up, True)]), ("t2,5", [(runs[2], False), (runs[3], False), (up, True)])):
        t0 = time.perf_counter()
        data, kinds, splits = change_read(table, {"incremental-between": spec})
        seconds = time.perf_counter() - t0
        ref, ref_kinds, _ = change_read(table, {"incremental-between": spec, "sort-engine": "numpy"})
        same_rows(data, ref, f"incremental-between={spec}: against the numpy engine")
        assert np.array_equal(kinds, ref_kinds) and not kinds.any(), f"incremental-between={spec}: kinds not all +I"
        want = {name: np.concatenate([table_values(ids, upsert)[name] for ids, upsert in changes])
                for name in data.schema.field_names}
        got_order = np.lexsort((data.column("c1").values, data.column("id").values))
        want_order = np.lexsort((want["c1"], want["id"]))
        for name, values in want.items():
            assert np.array_equal(data.column(name).values[got_order], values[want_order]), (
                f"incremental-between={spec}: {name} differs from the oracle")
        out[f"incremental-between={spec}"] = {
            "seconds": round(seconds, 4), "rows": data.num_rows, "splits": len(splits),
            "files": sum(len(s.files) for s in splits), "snapshots": sorted({s.snapshot_id for s in splits})}
    return {"reads": out, "launches": launch_diff(hk, before)}


def snapshot_files(table, snapshot_id: int | None = None) -> set:
    """The data files a snapshot of the table (the latest by default) lists."""
    scan = table.store.new_scan()
    if snapshot_id is not None:
        scan = scan.with_snapshot(snapshot_id)
    return {e.file.file_name for e in scan.plan().entries}


def branch_part(hk, table, runs: list, up: np.ndarray) -> dict:
    """Branch b from t2 with the upsert written to it; rollback of main to
    t2; fast-forward of main to b. Each read at both tiles."""
    from paimon_tpu_torch.table.branch import BranchManager, branch_table

    before = dict(hk.launches)
    bm = BranchManager(table.file_io, table.path)
    bm.create("b", from_tag="t2")
    branch = branch_table(table, "b")
    t0 = time.perf_counter()
    wb = branch.new_batch_write_builder()
    w = wb.new_write()
    w.write(table_values(up, upsert=True))
    wb.new_commit().commit(w.prepare_commit())
    torch.cuda.synchronize()
    branch_write_s = time.perf_counter() - t0
    write_launches = launch_diff(hk, before)
    at2 = np.sort(np.concatenate(runs[:2]))
    branch_ids = np.union1d(at2, up)
    reads = {"branch": history_read(hk, branch, {}, branch_ids, up, "branch b"),
             "main": history_read(hk, table, {}, np.arange(N_ROWS), up, "main beside the branch")}
    sm = table.store.snapshot_manager
    only_later = set().union(*(snapshot_files(table, k) for k in (3, 4, 5))) - snapshot_files(table, 2)
    only_later -= snapshot_files(table, 1)
    bucket_dir = table.store.bucket_dir((), 0)
    on_disk = set(os.listdir(bucket_dir))
    manifests = set(os.listdir(f"{table.path}/manifest"))
    t0 = time.perf_counter()
    table.rollback_to("t2")
    rollback_s = time.perf_counter() - t0
    assert sm.latest_snapshot_id() == 2, f"rollback left snapshot {sm.latest_snapshot_id()} the latest"
    deleted = on_disk - set(os.listdir(bucket_dir))
    assert deleted == only_later and deleted, f"rollback deleted {sorted(deleted)}, only 3-5 reached {only_later}"
    branch_files = snapshot_files(branch)
    assert all(os.path.exists(f"{bucket_dir}/{n}") for n in branch_files), "rollback deleted a file of the branch"
    reads["main_after_rollback"] = history_read(hk, table, {}, at2, NO_IDS, "main after the rollback")
    t0 = time.perf_counter()
    bm.fast_forward("b")
    fast_forward_s = time.perf_counter() - t0
    assert sm.latest_snapshot_id() == branch.store.snapshot_manager.latest_snapshot_id()
    reads["main_after_fast_forward"] = history_read(hk, table, {}, branch_ids, up, "main after the fast-forward")
    listed = snapshot_files(table) | snapshot_files(branch)
    missing = sorted(n for n in listed if not os.path.exists(f"{bucket_dir}/{n}"))
    assert not missing, f"files listed by main or the branch are missing: {missing}"
    return {"branch_write_s": round(branch_write_s, 4), "rollback_s": round(rollback_s, 4),
            "fast_forward_s": round(fast_forward_s, 4), "reads": reads,
            "rollback_deleted": {"data_files": len(deleted),
                                 "manifest_files": len(manifests - set(os.listdir(f"{table.path}/manifest")))},
            "files_listed_by_main_and_branch": len(listed), "branch_write_launches": write_launches,
            "launches": launch_diff(hk, before)}


def stream_part(pt, hk, cat) -> dict:
    """Config 4's 20 commits under a consumer's stream reader that plans
    until nothing is new after each commit and applies every delta to a
    key -> row map; the reader's checkpoint completes after commits 10 and
    20, and expiry keeps 10 snapshots unless the consumer needs more. Then a
    full compaction and a compacted-full starting plan."""
    from paimon_tpu_torch.core.snapshot import CommitKind
    from paimon_tpu_torch.table.consumer import ConsumerManager

    schema = pt.RowType.of(("id", pt.BIGINT(False)), ("v", pt.DOUBLE()), ("tag", pt.STRING()))
    table = cat.create_table("history.c4_stream", schema, primary_keys=["id"], options=dict(C4_HISTORY_OPTIONS))
    reader = table.copy({"consumer-id": "history"})
    scan = reader.new_read_builder().new_stream_scan()
    read = reader.new_read_builder().new_read()
    consumers = ConsumerManager(table.file_io, table.path)
    sm = table.store.snapshot_manager
    assert scan.plan() is None  # an empty table: the stream starts at snapshot 1
    rng = np.random.default_rng(2)
    last_commit = np.full(C4_ROWS // 2, -1, dtype=np.int64)
    seen_v = np.full(C4_ROWS // 2, np.nan)
    seen_tag = np.full(C4_ROWS // 2, None, dtype=object)
    next_sid, plans, checks = 1, [], {}
    wb = table.new_stream_write_builder()
    w, c = wb.new_write(), wb.new_commit()
    write_s = plan_s = 0.0
    before = dict(hk.launches)
    write_launches = dict.fromkeys(hk.launches, 0)
    for b in range(C4_COMMITS):
        batch = c4_batch(rng, b)
        last_commit[batch["id"]] = b
        launches_at = dict(hk.launches)
        t0 = time.perf_counter()
        w.write(batch)
        c.commit_messages(b + 1, w.prepare_commit())
        torch.cuda.synchronize()
        write_s += time.perf_counter() - t0
        for k, v in launch_diff(hk, launches_at).items():
            write_launches[k] += v
        t0 = time.perf_counter()
        while (splits := scan.plan()) is not None:
            kind = sm.snapshot(next_sid).commit_kind
            assert kind == CommitKind.APPEND or not splits, f"COMPACT snapshot {next_sid} gave {len(splits)} splits"
            rows = 0
            for s in splits:
                data, kinds = read.read_with_kinds(s)
                assert not kinds.any(), f"snapshot {next_sid}: a delta row is not +I"
                ids = data.column("id").values
                seen_v[ids] = data.column("v").values
                seen_tag[ids] = data.column("tag").values
                rows += data.num_rows
            plans.append([next_sid, kind.value, len(splits), sum(len(s.files) for s in splits), rows])
            next_sid += 1
        torch.cuda.synchronize()
        plan_s += time.perf_counter() - t0
        latest = sm.latest_snapshot_id()
        if b + 1 in HISTORY_ACKS:
            token = scan.checkpoint()
            scan.notify_checkpoint_complete()
            assert consumers.consumer("history") == token == latest + 1, (token, latest)
        position = consumers.consumer("history")
        if position is not None:
            kept = [i for i in range(position, latest + 1) if not sm.snapshot_exists(i)]
            assert not kept, f"expiry deleted snapshots {kept} past the consumer's position {position}"
        if b + 1 in HISTORY_CHECKS:
            written = np.flatnonzero(last_commit >= 0)
            assert np.array_equal(np.flatnonzero(~np.isnan(seen_v)), written), f"commit {b + 1}: replayed ids differ"
            assert np.array_equal(seen_v[written], written * 0.5 + last_commit[written]), f"commit {b + 1}: v differs"
            assert np.array_equal(seen_tag[written], np.array([f"t{x}" for x in last_commit[written]], dtype=object))
            # the batch read equals the oracle, so it equals the replayed map
            checks[f"after_commit_{b + 1}"] = {
                **check_c4_read(table, last_commit, f"stream: after commit {b + 1}"),
                "snapshots_kept": sm.snapshot_count(), "earliest": sm.earliest_snapshot_id(),
                "consumer_next_snapshot": position}
    stream_launches = launch_diff(hk, before)
    t0 = time.perf_counter()
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.compact(full=True)
    wb.new_commit().commit(w.prepare_commit())
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    batch_read = check_c4_read(table, last_commit, "stream: after the full compaction")
    compacted = table.copy({"scan.mode": "compacted-full"})
    t0 = time.perf_counter()
    splits = compacted.new_read_builder().new_stream_scan().plan()
    out = compacted.new_read_builder().new_read().read_all(splits)
    torch.cuda.synchronize()
    compacted_s = time.perf_counter() - t0
    same_rows(out, read_all(table), "compacted-full starting plan against the batch read")
    kinds = [p[1] for p in plans]
    return {"config": "BASELINE config 4 (benchmarks/baseline_configs.py:148), scale 1, read by a stream",
            "options": C4_HISTORY_OPTIONS, "rows_written": C4_ROWS, "write_s": round(write_s, 4),
            "plan_and_read_s": round(plan_s, 4), "plans": len(plans),
            "append_plans": kinds.count("APPEND"), "compact_plans": kinds.count("COMPACT"),
            "splits_files_rows_per_plan": {"columns": ["snapshot", "kind", "splits", "files", "rows"], "plans": plans},
            "checks": checks, "full_compaction_s": round(full_s, 4), "read_after_full_compaction": batch_read,
            "compacted_full": {"seconds": round(compacted_s, 4), "rows": out.num_rows, "splits": len(splits),
                               "files": sum(len(s.files) for s in splits), "equal_to_batch_read": True},
            "launches": {"phase": launch_diff(hk, before), "streaming_writes": write_launches,
                         "stream": stream_launches}}


def history_phase(pt, hk, warehouse: str, bench_path: str, checked: tuple) -> dict:
    """Table history, one JSON line per part, on a copy of the main phase's
    bench table (so no later phase sees its changes): time travel,
    incremental reads, branch, rollback and fast-forward; then config 4
    under a consumer's stream reader. K1 and K2 are then held exactly to
    their plain versions at the path's shapes that no earlier check
    covered. Launch counts are zeroed before the phase."""
    from paimon_tpu_torch.catalog import FileSystemCatalog

    cat = FileSystemCatalog(warehouse, commit_user="chip_smoke", device=DEVICE)
    hk.reset_launches()
    parts = {}
    seconds = {}
    with ShapeRecorder(hk) as recorder:
        t0 = time.perf_counter()
        shutil.copytree(bench_path, cat.table_path("bench.t_history"))
        table = cat.get_table("bench.t_history")
        runs, up = bench_runs()
        seconds["copy"] = round(time.perf_counter() - t0, 3)
        for name, run in (("time_travel", lambda: time_travel_part(hk, table, runs)),
                          ("incremental", lambda: incremental_part(hk, table, runs, up)),
                          ("branch_rollback_fast_forward", lambda: branch_part(hk, table, runs, up)),
                          ("stream", lambda: stream_part(pt, hk, cat))):
            t0 = time.perf_counter()
            parts[name] = run()
            seconds[name] = parts[name]["part_s"] = round(time.perf_counter() - t0, 3)
            emit({"phase": "history", "part": name, **parts[name]})
    launches = dict(hk.launches)
    for k in K1_K2:
        assert launches[k] > 0, f"{k} never launched on the history path: {launches}"
    by_part = {name: p["launches"]["phase"] if "phase" in p["launches"] else p["launches"] for name, p in parts.items()}
    return {"launches": launches, "launches_by_part": by_part, "seconds_by_part": seconds,
            "shape_checks": path_shape_checks(hk, recorder, torch.device(DEVICE), 2029, checked)}


# ---------------------------------------------------------------------------
# the write surface: table and dynamic-partition overwrite, rowkind.field,
# the local merge buffer, cross-partition upsert and append-only tables
# ---------------------------------------------------------------------------

OW_ROWS = 275_000  # an overwritten day: its 250,000 keys and 25,000 new ones
RK_DELETE_SHARE = 0.05  # rowkind: the share of -D rows in each commit after the first
LM_CHUNKS = 10  # local merge: each commit's 50,000 rows in this many writes
LM_CAPS = ("64 mb", "1 mb")  # local-merge-buffer-size: a commit's rows (~3.7 MB) fit the first, not the second
XP_UPSERT_2 = 50_000  # cross partition: the upserts after the restart
C5_APPEND_ROWS = 500_000  # BASELINE config 5's append clone (db.c5z)


def overwrite_values(ids: np.ndarray, tag: int) -> dict:
    """The rows of overwrite `tag`: the upsert values, c2 moved by 1000 * tag."""
    out = partitioned_values(ids, True)
    out["c2"] = out["c2"] + 1000 * tag
    return out


def check_overwritten(table, before, new_days: dict, what: str) -> dict:
    """The table read at both tiles equals a sort-engine=numpy read; each
    day in `new_days` (day -> (ids, tag)) holds exactly its overwrite's
    rows, and every other day the rows it had in `before`."""
    reads = {}
    reference = read_all(table.copy({"sort-engine": "numpy"}))
    for label, opts in (("default_tile", {}), (f"tile_{K1_TILE_ROWS}", {"merge.read-batch-rows": str(K1_TILE_ROWS)})):
        t0 = time.perf_counter()
        out = read_all(table.copy(opts))
        reads[label] = {"read_s": round(time.perf_counter() - t0, 4), "rows": out.num_rows}
        same_rows(out, reference, f"{what}, {label}: pallas against numpy")
    dts = reference.column("dt").values
    for day in P_DTS:
        part = reference.filter(dts == day)
        if day in new_days:
            ids, tag = new_days[day]
            got = part.take(np.argsort(part.column("id").values, kind="stable"))
            want = overwrite_values(np.sort(ids), tag)
            assert got.num_rows == len(ids), f"{what}: day {day} holds {got.num_rows} rows, its overwrite {len(ids)}"
            for name in got.schema.field_names:
                assert same_values(got.column(name).values, want[name]), f"{what}: day {day}, {name} differs"
        else:
            same_rows(part, before.filter(before.column("dt").values == day), f"{what}: untouched day {day}")
    return {"reads": reads, "rows": reference.num_rows, "equal_to_numpy_engine": True, "equal_to_oracle": True}


def overwrite_part(pt, hk, cat, bench_path: str) -> dict:
    """Copies of the partitioned table of the buckets phase and of the bench
    table: (i) a dynamic-partition overwrite (the default) of one day with
    275,000 rows, (ii) a static overwrite of another day under
    dynamic-partition-overwrite=false, (iii) a whole-table overwrite of the
    bench copy with its 100,000-row upsert batch, then (iv) a full refresh of
    it with all 1,100,000 rows (the runs, then the upsert) in one batch."""
    from paimon_tpu_torch.core.snapshot import CommitKind

    shutil.copytree(cat.table_path("buckets.partitioned"), cat.table_path("writes.overwrite_partitioned"))
    shutil.copytree(bench_path, cat.table_path("writes.overwrite_bench"))
    table = cat.get_table("writes.overwrite_partitioned")
    sm = table.store.snapshot_manager
    before = read_all(table.copy({"sort-engine": "numpy"}))
    rng = np.random.default_rng(14)
    out: dict = {"table": "the partitioned table of the buckets phase (copied): dt STRING (4 days), key (dt, id), "
                          "dynamic buckets of at most 100,000 keys; and a copy of the main phase's bench table",
                 "who": "a daily batch job that recomputes one day's partition (INSERT OVERWRITE, "
                        "dynamic-partition-overwrite), and a daily full refresh"}
    new_days, steps = {}, {}
    for step, day, tag, view in (("dynamic_partition", 1, 1, table),
                                 ("static_partition", 2, 2, table.copy({"dynamic-partition-overwrite": "false"}))):
        ids = rng.permutation(day + 4 * np.arange(OW_ROWS)).astype(np.int64)
        before_step = dict(hk.launches)
        t0 = time.perf_counter()
        wb = view.new_batch_write_builder()
        wb = wb.with_overwrite() if step == "dynamic_partition" else wb.with_overwrite(lambda p, d=P_DTS[day]: p == (d,))
        w = wb.new_write()
        w.write(overwrite_values(ids, tag))
        sids = wb.new_commit().commit(w.prepare_commit())
        torch.cuda.synchronize()
        write_s = time.perf_counter() - t0
        write_launches = launch_diff(hk, before_step)
        assert [sm.snapshot(i).commit_kind for i in sids] == [CommitKind.OVERWRITE], sids
        new_days[P_DTS[day]] = (ids, tag)
        steps[step] = {"day": P_DTS[day], "rows": OW_ROWS, "write_s": round(write_s, 4),
                       "files_per_bucket": files_per_bucket(table), "launches_write": write_launches,
                       **check_overwritten(table, before, new_days, step)}
        steps[step]["launches"] = launch_diff(hk, before_step)
        emit({"phase": "writes", "part": "overwrite", "step": step, **steps[step]})
    bench = cat.get_table("writes.overwrite_bench")
    runs, up = bench_runs()
    for step, values in (("whole_table_upsert_batch", [table_values(up, True)]),
                         ("whole_table_full_refresh",
                          [table_values(np.concatenate(runs)[rng.permutation(N_ROWS)], False),
                           table_values(up[rng.permutation(N_UPSERT)], True)])):
        before_step = dict(hk.launches)
        t0 = time.perf_counter()
        wb = bench.new_batch_write_builder().with_overwrite()
        w = wb.new_write()
        for v in values:
            w.write(v)
        sids = wb.new_commit().commit(w.prepare_commit())
        torch.cuda.synchronize()
        write_s = time.perf_counter() - t0
        write_launches = launch_diff(hk, before_step)
        assert [bench.store.snapshot_manager.snapshot(i).commit_kind for i in sids] == [CommitKind.OVERWRITE], sids
        reference = read_all(bench.copy({"sort-engine": "numpy"}))
        reads = {}
        for label, opts in (("default_tile", {}), (f"tile_{K1_TILE_ROWS}", {"merge.read-batch-rows": str(K1_TILE_ROWS)})):
            t0 = time.perf_counter()
            got = read_all(bench.copy(opts))
            reads[label] = {"read_s": round(time.perf_counter() - t0, 4), "rows": got.num_rows}
            if step == "whole_table_full_refresh":
                check_output(got, reference, up, f"{step}, {label}")
            else:
                same_rows(got, reference, f"{step}, {label}: pallas against numpy")
                want = table_values(np.sort(up), True)
                for name in got.schema.field_names:
                    assert same_values(got.column(name).values, want[name]), f"{step}: {name} differs from the batch"
        steps[step] = {"rows_written": sum(len(v["id"]) for v in values), "rows": reference.num_rows,
                       "write_s": round(write_s, 4), "launches_write": write_launches, "reads": reads,
                       "files": len(live_files(bench)), "equal_to_numpy_engine": True, "equal_to_oracle": True,
                       "launches": launch_diff(hk, before_step)}
        emit({"phase": "writes", "part": "overwrite", "step": step, **steps[step]})
    return {**out, "steps": steps}


def rowkind_part(pt, hk, cat) -> dict:
    """Config 4 with an op STRING column as rowkind.field: 20 streaming
    commits, 5% of each commit after the first -D rows of ids an earlier
    commit wrote; the read is each id's last row unless that is -D."""
    schema = pt.RowType.of(("id", pt.BIGINT(False)), ("v", pt.DOUBLE()), ("tag", pt.STRING()), ("op", pt.STRING()))
    options = {**C4_OPTIONS, "rowkind.field": "op"}
    table = cat.create_table("writes.rowkind", schema, primary_keys=["id"], options=options)
    rng, del_rng = np.random.default_rng(2), np.random.default_rng(12)
    per = C4_ROWS // C4_COMMITS
    last_commit = np.full(C4_ROWS // 2, -1, dtype=np.int64)
    deleted = np.zeros(C4_ROWS // 2, dtype=np.bool_)
    before = dict(hk.launches)
    wb = table.new_stream_write_builder()
    w, c = wb.new_write(), wb.new_commit()
    write_s, deletes = 0.0, 0
    for b in range(C4_COMMITS):
        batch = c4_batch(rng, b)
        op = np.full(per, "+I", dtype=object)
        if b:
            k = int(per * RK_DELETE_SHARE)
            rows = del_rng.choice(per, k, replace=False)
            batch["id"][rows] = del_rng.choice(np.flatnonzero(last_commit >= 0), k)
            batch["v"] = batch["id"] * 0.5 + b
            op[rows] = "-D"
            deletes += k
        batch["op"] = op
        ids = batch["id"]
        last_ids, first_rev = np.unique(ids[::-1], return_index=True)
        last_commit[last_ids] = b
        deleted[last_ids] = op[len(ids) - 1 - first_rev] == "-D"
        t0 = time.perf_counter()
        w.write(batch)
        c.commit_messages(b + 1, w.prepare_commit())
        torch.cuda.synchronize()
        write_s += time.perf_counter() - t0
    write_launches = launch_diff(hk, before)
    read = check_c4_read(table, last_commit, "rowkind: after 20 commits", keep=~deleted)
    tiled = check_c4_read(table.copy({"merge.read-batch-rows": str(K1_TILE_ROWS)}), last_commit,
                          "rowkind: after 20 commits, K1 tile", keep=~deleted)
    return {"config": "BASELINE config 4 (benchmarks/baseline_configs.py:148), scale 1, plus op STRING as "
                      "rowkind.field", "who": "a CDC feed with Debezium's op code in a column",
            "options": options, "rows_written": C4_ROWS, "delete_rows": deletes,
            "ids_deleted_at_the_end": int((deleted & (last_commit >= 0)).sum()), "write_s": round(write_s, 4),
            "read": read, f"read_tile_{K1_TILE_ROWS}": tiled, "levels_after": level_layout(table),
            "launches": {"writes": write_launches, "phase": launch_diff(hk, before)}}


class LocalMergeProbe(Probe):
    """Counts the local merge buffer's drains that held rows, with their
    rows, host seconds and kernel launches."""

    def __init__(self, hk):
        import paimon_tpu_torch.table.write as table_write

        super().__init__([(table_write.TableWrite, "_local_merge_flush", "drain")])
        self.hk = hk
        self.rows: list = []
        self.launches = dict.fromkeys(hk.launches, 0)

    def _before(self, stage: str, args: tuple):
        self.rows.append(sum(b.num_rows for b, _ in args[0]._local_buffer))
        return dict(self.hk.launches)

    def _after(self, stage: str, args: tuple, out, before) -> None:
        for k in self.launches:
            self.launches[k] += self.hk.launches[k] - before[k]

    def report(self) -> dict:
        rows = [r for r in self.rows if r]
        return {"drains": len(rows), "drain_rows_min_max": [min(rows), max(rows)] if rows else None,
                "drain_s": round(self.seconds["drain"], 4), "launches_in_drains": dict(self.launches)}


def local_merge_part(pt, hk, cat, control: dict) -> dict:
    """Config 4 as in the compact phase under local-merge-buffer-size, each
    commit written in 10 writes of 5,000 rows: at 64 mb the buffer drains
    once a commit (at prepare_commit), at 1 mb several times."""
    schema = pt.RowType.of(("id", pt.BIGINT(False)), ("v", pt.DOUBLE()), ("tag", pt.STRING()))
    out = {"config": "BASELINE config 4 (benchmarks/baseline_configs.py:148), scale 1, each commit in "
                     f"{LM_CHUNKS} writes", "who": "a pre-shuffle merge of hot keys (local-merge-buffer-size)",
           "control": {"write_s": control["stream"]["write_s"], "launches": control["launches"]["streaming_writes"]}}
    for cap in LM_CAPS:
        options = {**C4_OPTIONS, "local-merge-buffer-size": cap}
        table = cat.create_table(f"writes.local_merge_{cap.replace(' ', '')}", schema, primary_keys=["id"],
                                 options=options)
        rng = np.random.default_rng(2)
        last_commit = np.full(C4_ROWS // 2, -1, dtype=np.int64)
        before = dict(hk.launches)
        wb = table.new_stream_write_builder()
        w, c = wb.new_write(), wb.new_commit()
        write_s = 0.0
        with LocalMergeProbe(hk) as probe, CompactionProbe(hk) as compactions:
            for b in range(C4_COMMITS):
                batch = c4_batch(rng, b)
                last_commit[batch["id"]] = b
                chunk = len(batch["id"]) // LM_CHUNKS
                t0 = time.perf_counter()
                for i in range(LM_CHUNKS):
                    w.write({k: v[i * chunk:(i + 1) * chunk] for k, v in batch.items()})
                c.commit_messages(b + 1, w.prepare_commit())
                torch.cuda.synchronize()
                write_s += time.perf_counter() - t0
        write_launches = launch_diff(hk, before)
        part = {"options": options, "write_s": round(write_s, 4), **probe.report(),
                "compaction": compactions.report(), "levels_after": level_layout(table),
                "read": check_c4_read(table, last_commit, f"local merge {cap}: after 20 commits")}
        part["launches"] = {"writes": write_launches, "phase": launch_diff(hk, before)}
        out[cap.replace(" ", "")] = part
    large, small = (out[cap.replace(" ", "")] for cap in LM_CAPS)
    assert small["drains"] > large["drains"] == C4_COMMITS, f"drains: {large['drains']} and {small['drains']}"
    return out


def cross_values(ids: np.ndarray, dts: np.ndarray, variant: int) -> dict:
    """Bench rows of the given days: the first values (variant 0), the
    upsert's (1) or the second upsert's (2: c2 moved by 2000)."""
    out = {"dt": dts, **table_values(ids, variant > 0)}
    if variant == 2:
        out["c2"] = out["c2"] + 2000
    return out


def cross_partition_part(pt, hk, cat) -> dict:
    """The partitioned bench schema keyed by id alone (dynamic buckets at
    default options): the four runs (id in day P_DTS[id % 4]) and the
    100,000-row upsert, each upserted id moved to day P_DTS[(id + s) % 4]
    with s from the seed, on one streaming write; then a new write that
    bootstraps the global index from the files and 50,000 more upserts."""
    from paimon_tpu_torch.table.crosspartition import CrossPartitionUpsertWrite, GlobalIndexAssigner

    schema = pt.RowType.of(("dt", pt.STRING()), *[(f.name, f.type) for f in build_schema(pt).fields])
    options = {"sort-engine": "pallas"}
    table = cat.create_table("writes.cross_partition", schema, partition_keys=["dt"], primary_keys=["id"],
                             options=options)
    runs, up = bench_runs()
    rng = np.random.default_rng(10)
    up_dts = P_DTS[(up + rng.integers(0, 4, N_UPSERT)) % 4]
    up2 = np.random.default_rng(11).choice(N_ROWS, XP_UPSERT_2, replace=False).astype(np.int64)
    up2_dts = P_DTS[(up2 + rng.integers(0, 4, XP_UPSERT_2)) % 4]
    final_dt = P_DTS[np.arange(N_ROWS) % 4].copy()
    variant = np.zeros(N_ROWS, dtype=np.int64)
    before = dict(hk.launches)
    probe = Probe([(CrossPartitionUpsertWrite, "write", "assign_and_route"), (GlobalIndexAssigner, "bootstrap", "bootstrap")])
    with probe, CompactionProbe(hk) as compactions:
        t0 = time.perf_counter()
        wb = table.new_stream_write_builder()
        w, c = wb.new_write(), wb.new_commit()
        for i, run in enumerate(runs, start=1):
            w.write(cross_values(run, P_DTS[run % 4], 0))
            c.commit_messages(i, w.prepare_commit())
        w.write(cross_values(up, up_dts, 1))
        c.commit_messages(N_RUNS + 1, w.prepare_commit())
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        final_dt[up], variant[up] = up_dts, 1
        moved_1 = int((up_dts != P_DTS[up % 4]).sum())
        first_launches = launch_diff(hk, before)
        bootstrap_rows = sum(f.row_count for f in live_files(table))
        t0 = time.perf_counter()
        wb = table.new_batch_write_builder()
        w = wb.new_write()
        bootstrap_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        w.write(cross_values(up2, up2_dts, 2))
        wb.new_commit().commit(w.prepare_commit())
        torch.cuda.synchronize()
        second_s = time.perf_counter() - t0
        moved_2 = int((up2_dts != final_dt[up2]).sum())
        final_dt[up2], variant[up2] = up2_dts, 2
    write_launches = launch_diff(hk, before)
    reference = read_all(table.copy({"sort-engine": "numpy"}))
    ids = reference.column("id").values
    order = np.argsort(ids, kind="stable")
    assert np.array_equal(ids[order], np.arange(N_ROWS)), "cross partition: an id is missing or read twice"
    assert np.array_equal(reference.column("dt").values[order], final_dt), "cross partition: an id is not in its last day"
    for v in (0, 1, 2):
        sel = np.flatnonzero(variant == v)
        want = cross_values(sel, final_dt[sel], v)
        for name in ("c1", "c2", "c3", "d1", "d2", "s1", "s2"):
            assert same_values(reference.column(name).values[order][sel], want[name]), f"cross partition: {name}"
    reads = {}
    for label, opts in (("default_tile", {}), (f"tile_{K1_TILE_ROWS}", {"merge.read-batch-rows": str(K1_TILE_ROWS)})):
        t0 = time.perf_counter()
        got = read_all(table.copy(opts))
        reads[label] = {"read_s": round(time.perf_counter() - t0, 4), "rows": got.num_rows}
        same_rows(got, reference, f"cross partition, {label}: pallas against numpy")
    return {"table": "bench.py's table plus dt STRING (4 days) as partition key, primary key id alone (cross-partition "
                     "upsert), dynamic buckets at default options",
            "who": "an orders table partitioned by order date whose CDC updates change the date "
                   "(Paimon's cross-partitions upsert dynamic bucket mode)",
            "options": options, "rows_written": N_ROWS + N_UPSERT + XP_UPSERT_2,
            "moved_by_upsert": moved_1, "moved_after_restart": moved_2, "write_s_runs_and_upsert": round(first_s, 4),
            "bootstrap_s": round(bootstrap_s, 4), "bootstrap_rows": bootstrap_rows,
            "bootstrap_probe_s": round(probe.seconds["bootstrap"], 4), "write_s_after_restart": round(second_s, 4),
            "assign_and_route_s": round(probe.seconds["assign_and_route"], 4),
            "buckets_per_partition": {p[0]: len(b) for p, b in sorted(table.store.new_scan().plan().grouped().items())},
            "files_per_bucket": files_per_bucket(table), "compaction": compactions.report(), "reads": reads,
            "every_id_once_in_its_last_day": True, "equal_to_numpy_engine": True, "equal_to_oracle": True,
            "launches": {"runs_and_upsert": first_launches, "writes": write_launches,
                         "phase": launch_diff(hk, before)}}


def append_part(pt, hk, cat) -> dict:
    """(i) BASELINE config 5's append clone (bucket 1, no primary key):
    500,000 rows in 4 commits, then a full compaction; (ii) an
    unaware-bucket log table (the bench schema with dt, no primary key,
    bucket=-1, partitioned by dt): 20 streaming commits of 50,000 events
    under a consumer's stream reader, a value-filtered read, a DELETE by
    copy-on-write. No merge runs, so no kernel may launch."""
    from paimon_tpu_torch.data.predicate import equal, less_than

    before = dict(hk.launches)
    out: dict = {"who": "an append-only event log (Paimon's append table, unaware bucket)"}
    schema5 = pt.RowType.of(("id", pt.BIGINT(False)), ("x", pt.BIGINT()), ("y", pt.BIGINT()), ("v", pt.DOUBLE()))
    c5 = cat.create_table("writes.c5_append", schema5, options={"bucket": "1"})
    rng = np.random.default_rng(3)
    per = C5_APPEND_ROWS // 4
    written = []
    t0 = time.perf_counter()
    for _ in range(4):
        ids = rng.integers(0, C5_ROWS, per)
        written.append(ids)
        wb = c5.new_batch_write_builder()
        w = wb.new_write()
        w.write({"id": ids, "x": ids % 4096, "y": (ids * 7) % 4096, "v": ids * 1.0})
        wb.new_commit().commit(w.prepare_commit())
    torch.cuda.synchronize()
    write_s = time.perf_counter() - t0
    files_before = len(live_files(c5))
    t0 = time.perf_counter()
    wb = c5.new_batch_write_builder()
    w = wb.new_write()
    w.compact(full=True)
    kinds = [c5.store.snapshot_manager.snapshot(i).commit_kind.value for i in wb.new_commit().commit(w.prepare_commit())]
    compact_s = time.perf_counter() - t0
    got = read_all(c5)
    assert kinds == ["COMPACT"] and len(live_files(c5)) == 1, (kinds, live_files(c5))
    assert np.array_equal(got.column("id").values, np.concatenate(written)), "config 5 append: rows out of order"
    assert np.array_equal(got.column("y").values, (np.concatenate(written) * 7) % 4096), "config 5 append: y differs"
    out["config5_append"] = {
        "config": "BASELINE config 5's append clone (benchmarks/baseline_configs.py:209-219: db.c5z, bucket 1, no "
                  "primary key), 500,000 rows in 4 commits (the reference writes 1), then compact(full=True)",
        "write_s": round(write_s, 4), "files_before_full_compaction": files_before, "full_compaction_s": round(compact_s, 4),
        "rows": got.num_rows, "rows_in_written_order": True}

    schema = pt.RowType.of(("dt", pt.STRING()), *[(f.name, f.type) for f in build_schema(pt).fields])
    log = cat.create_table("writes.log", schema, partition_keys=["dt"], options={"bucket": "-1"})
    reader = log.copy({"consumer-id": "writes"})
    scan = reader.new_read_builder().new_stream_scan()
    read = reader.new_read_builder().new_read()
    assert scan.plan() is None
    per = C4_ROWS // C4_COMMITS
    wb = log.new_stream_write_builder()
    w, c = wb.new_write(), wb.new_commit()
    write_s = plan_s = 0.0
    seen, plans = [], []
    for b in range(C4_COMMITS):
        ids = np.arange(b * per, (b + 1) * per, dtype=np.int64)
        t0 = time.perf_counter()
        w.write(partitioned_values(ids, False))
        c.commit_messages(b + 1, w.prepare_commit())
        torch.cuda.synchronize()
        write_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        while (splits := scan.plan()) is not None:
            rows = 0
            for s in splits:
                data, kinds_ = read.read_with_kinds(s)
                assert not kinds_.any(), "a delta row of the log is not +I"
                seen.append(data.column("id").values)
                rows += data.num_rows
            plans.append([len(splits), sum(len(s.files) for s in splits), rows])
        plan_s += time.perf_counter() - t0
        if b + 1 in HISTORY_ACKS:
            scan.checkpoint()
            scan.notify_checkpoint_complete()
    all_ids = np.arange(C4_ROWS, dtype=np.int64)
    assert np.array_equal(np.sort(np.concatenate(seen)), all_ids), "the stream did not read every event once"
    full = read_all(log)
    same_rows(full, read_all(log.copy({"sort-engine": "numpy"})), "log against the numpy engine")

    def check_in_order(batch, keep: np.ndarray, what: str, ordered: bool = True) -> None:
        """Per day, the rows `keep` selects, in the order written (or, not
        ordered, as a set)."""
        assert batch.num_rows == int(keep.sum()), f"{what}: {batch.num_rows} rows, the oracle has {int(keep.sum())}"
        for d, day in enumerate(P_DTS):
            ids = batch.column("id").values[batch.column("dt").values == day]
            ids = ids if ordered else np.sort(ids)
            assert np.array_equal(ids, all_ids[keep & (all_ids % 4 == d)]), f"{what}: day {day} differs"

    check_in_order(full, np.ones(C4_ROWS, np.bool_), "log")
    filtered = {}
    for label, pred, keep in (("c2 < 10", less_than("c2", 10), all_ids % 97 < 10),
                              ("id < 100000", less_than("id", 100_000), all_ids < 100_000)):
        rb = log.new_read_builder().with_filter(pred)
        t0 = time.perf_counter()
        splits = rb.new_scan().plan()
        got = rb.new_read().read_all(splits)
        seconds = time.perf_counter() - t0
        check_in_order(got, keep, f"log where {label}")
        filtered[label] = {"seconds": round(seconds, 4), "rows": got.num_rows,
                           "files": sum(len(s.files) for s in splits), "files_unfiltered": len(live_files(log))}
        filtered[label]["files_pruned_by_stats"] = filtered[label]["files_unfiltered"] - filtered[label]["files"]
    files_before = {f.file_name for f in live_files(log)}
    t0 = time.perf_counter()
    deleted = log.delete_where(equal("c2", 3))
    delete_s = time.perf_counter() - t0
    files_after = {f.file_name for f in live_files(log)}
    keep = all_ids % 97 != 3
    assert deleted == int((~keep).sum()), f"DELETE removed {deleted} rows, the oracle {int((~keep).sum())}"
    # the rewritten files carry sequence numbers 0 (as in the JAX package),
    # so a read orders them by file name: compare each day as a set
    check_in_order(read_all(log), keep, "log after the DELETE", ordered=False)
    out["log"] = {
        "table": "bench.py's table plus dt STRING (4 days) as partition key, no primary key, bucket=-1 (unaware)",
        "commits": C4_COMMITS, "rows_written": C4_ROWS, "write_s": round(write_s, 4), "stream_plan_and_read_s": round(plan_s, 4),
        "plans": len(plans), "plans_with_splits": sum(1 for p in plans if p[0]),
        "files_per_bucket": files_per_bucket(log), "filtered_reads": filtered,
        "delete": {"predicate": "c2 = 3", "seconds": round(delete_s, 4), "rows_deleted": deleted,
                   "files_rewritten": len(files_before - files_after), "files_written": len(files_after - files_before)},
        "rows_in_written_order_before_the_delete": True, "equal_to_numpy_engine": True}
    launches = launch_diff(hk, before)
    assert not any(launches.values()), f"the append path launched a kernel: {launches}"
    out["launches"] = {"phase": launches}
    return out


def writes_phase(pt, hk, warehouse: str, bench_path: str, control: dict, checked: tuple) -> dict:
    """The write surface, one JSON line per part: overwrite, rowkind.field,
    the local merge buffer, cross-partition upsert and append tables. K1 and
    K2 must launch in every part but the append one, which launches
    nothing; then K1 and K2 are held exactly to their plain versions at the
    path's shapes no earlier check covered. Launch counts are zeroed before
    the phase."""
    from paimon_tpu_torch.catalog import FileSystemCatalog

    cat = FileSystemCatalog(warehouse, commit_user="chip_smoke", device=DEVICE)
    hk.reset_launches()
    parts, seconds = {}, {}
    with ShapeRecorder(hk) as recorder:
        for name, run in (("overwrite", lambda: overwrite_part(pt, hk, cat, bench_path)),
                          ("rowkind", lambda: rowkind_part(pt, hk, cat)),
                          ("local_merge", lambda: local_merge_part(pt, hk, cat, control)),
                          ("cross_partition", lambda: cross_partition_part(pt, hk, cat)),
                          ("append", lambda: append_part(pt, hk, cat))):
            before = dict(hk.launches)
            t0 = time.perf_counter()
            parts[name] = run()
            seconds[name] = parts[name]["part_s"] = round(time.perf_counter() - t0, 3)
            parts[name]["part_launches"] = launch_diff(hk, before)
            emit({"phase": "writes", "part": name, **parts[name]})
    by_part = {name: p["part_launches"] for name, p in parts.items()}
    for name in ("overwrite", "rowkind", "local_merge", "cross_partition"):
        for k in K1_K2:
            assert by_part[name][k] > 0, f"{k} never launched in the {name} part: {by_part[name]}"
    return {"launches": dict(hk.launches), "launches_by_part": by_part, "seconds_by_part": seconds,
            "shape_checks": path_shape_checks(hk, recorder, torch.device(DEVICE), 2030, checked)}


# ---------------------------------------------------------------------------
# the compaction services and schema evolution: rescale, the adaptive and
# dedicated compactors under ingest, the append coordinator, ALTER TABLE
# ---------------------------------------------------------------------------

RS_BUCKETS = 4  # the bench table's copy goes from bucket 1 to this
EV_ALTER_AFTER = 10  # config 4's ALTER comes after this commit


def rescale_part(pt, hk, cat, bench_path: str) -> dict:
    """A copy of the bench table (1,000,000 rows in 4 sorted runs plus the
    upsert, bucket 1) rescaled to RS_BUCKETS buckets: the read after equals
    the read before (and the numpy engine and the oracle), a read pinned at
    the snapshot before the rescale too, and every row of bucket b hashes to
    b."""
    from paimon_tpu_torch.table import load_table
    from paimon_tpu_torch.table.bucket import bucket_ids
    from paimon_tpu_torch.table.rescale import rescale_table

    shutil.copytree(bench_path, cat.table_path("services.rescale"))
    table = cat.get_table("services.rescale")
    _, up = bench_runs()
    reference = read_all(table.copy({"sort-engine": "numpy"}))
    before = read_all(table)
    check_output(before, reference, up, "rescale: the read before")
    pinned = table.store.snapshot_manager.latest_snapshot_id()
    files_before = files_per_bucket(table)
    launches = dict(hk.launches)
    t0 = time.perf_counter()
    rescaled = rescale_table(table, RS_BUCKETS)
    torch.cuda.synchronize()
    rescale_s = time.perf_counter() - t0
    launches = launch_diff(hk, launches)
    t0 = time.perf_counter()
    after = read_all(rescaled)
    read_s = time.perf_counter() - t0
    same_rows(after, read_all(rescaled.copy({"sort-engine": "numpy"})), "rescale: after, against the numpy engine")
    by_id = after.take(np.argsort(after.column("id").values, kind="stable"))
    check_output(by_id, reference, up, "rescale: the read after, by id")
    pinned_table = load_table(table.path, dynamic_options={"scan.snapshot-id": str(pinned)}, device=DEVICE)
    same_rows(read_all(pinned_table), before, "rescale: the read pinned before the rescale")
    rb = rescaled.new_read_builder()
    splits = rb.new_scan().plan()
    assert sorted({sp.bucket for sp in splits}) == list(range(RS_BUCKETS)), [sp.bucket for sp in splits]
    for sp in splits:
        rows = rb.new_read().read(sp)
        assert (bucket_ids(rows, ["id"], RS_BUCKETS) == sp.bucket).all(), f"rescale: a row of bucket {sp.bucket} hashes elsewhere"
    snap = rescaled.store.snapshot_manager.latest_snapshot()
    assert snap.commit_kind.value == "OVERWRITE" and rescaled.options.bucket == RS_BUCKETS, snap
    return {"who": "a table that outgrew one bucket (Paimon's Rescale Bucket)", "rows": after.num_rows,
            "input_rows": N_ROWS + N_UPSERT, "buckets": [1, RS_BUCKETS], "seconds": round(rescale_s, 4),
            "read_after_s": round(read_s, 4), "files_per_bucket_before": files_before,
            "files_per_bucket_after": files_per_bucket(rescaled), "launches": launches,
            "equal_before_and_after": True, "pinned_read_equal": True, "rows_in_their_hash_bucket": True,
            "equal_to_numpy_engine": True, "equal_to_oracle": True}


def c4_table(pt, cat, name: str, options: dict):
    schema = pt.RowType.of(("id", pt.BIGINT(False)), ("v", pt.DOUBLE()), ("tag", pt.STRING()))
    return cat.create_table(name, schema, primary_keys=["id"], options=options)


def adaptive_part(pt, hk, cat) -> dict:
    """Config 4 written write-only (20 streaming commits) while an
    AdaptiveCompactorService at its default options, with the ingest gate,
    compacts on its own thread; then a DedicatedCompactor round. The launch
    counts are read after the service's thread has stopped."""
    from paimon_tpu_torch.metrics import registry
    from paimon_tpu_torch.options import CoreOptions
    from paimon_tpu_torch.table.compactor import AdaptiveCompactorService, DedicatedCompactor

    table = c4_table(pt, cat, "services.c4_adaptive", {**C4_OPTIONS, "write-only": "true"})
    rng = np.random.default_rng(2)
    last_commit = np.full(C4_ROWS // 2, -1, dtype=np.int64)
    registry.reset()
    svc = AdaptiveCompactorService(table)
    svc.start()
    try:
        wb = table.new_stream_write_builder()
        w, c = wb.new_write(), wb.new_commit()
        t0 = time.perf_counter()
        for b in range(C4_COMMITS):
            batch = c4_batch(rng, b)
            last_commit[batch["id"]] = b
            w.write(batch)
            c.commit_messages(b + 1, w.prepare_commit())
        torch.cuda.synchronize()
        write_s = time.perf_counter() - t0
    finally:
        svc.close()
    assert not [th.name for th in threading.enumerate() if th.name.startswith("paimon-compactor") and th.is_alive()]
    snapshots = table.store.snapshot_manager
    kinds = [snapshots.snapshot(i).commit_kind.value for i in range(1, snapshots.latest_snapshot_id() + 1)]
    shapes = svc.observe()
    ceiling = table.options.options.get(CoreOptions.COMPACTION_ADAPTIVE_READ_AMP_CEILING)
    out = {"who": "ingest writers that never compact, with a compaction service beside them",
           "config": "BASELINE config 4 (benchmarks/baseline_configs.py:148), write-only",
           "rows_written": C4_ROWS, "write_s": round(write_s, 4), "rounds": svc.rounds, "compactions": svc.compactions,
           "errors": len(svc._errors), "snapshots": {k: kinds.count(k) for k in sorted(set(kinds))},
           "metrics": registry.snapshot().get("compaction", {}),
           "max_sorted_runs_at_end": max(s.runs for s in shapes), "read_amp_ceiling": ceiling,
           "files_per_bucket": files_per_bucket(table), "levels": level_layout(table)}
    assert not svc._errors, svc._errors[-1]
    assert svc.compactions > 0 and out["max_sorted_runs_at_end"] < ceiling, out
    out["read"] = check_c4_read(table, last_commit, "adaptive: after 20 commits")
    t0 = time.perf_counter()
    done = DedicatedCompactor(table).run_once(full=True)
    torch.cuda.synchronize()
    out["dedicated"] = {"committed": done, "seconds": round(time.perf_counter() - t0, 4),
                        "levels_after": level_layout(table)}
    assert list(out["dedicated"]["levels_after"]) == [str(table.store.options.num_levels - 1)], out["dedicated"]
    out["dedicated"]["read"] = check_c4_read(table, last_commit, "adaptive: after the dedicated compaction")
    return out


def coordinator_part(pt, hk, cat) -> dict:
    """The writes phase's unaware-bucket event log, copied, given
    deletion-vectors.enabled by ALTER TABLE and a DELETE through vectors;
    then AppendCompactionCoordinator plans, execute_compaction_task rewrites
    and the coordinator commits. The rows deleted (by this DELETE and the
    writes phase's copy-on-write one) stay deleted. No merge: 0 launches."""
    from paimon_tpu_torch.core.schema import SchemaChange
    from paimon_tpu_torch.data.predicate import equal
    from paimon_tpu_torch.table.compactor import AppendCompactionCoordinator, execute_compaction_task

    shutil.copytree(cat.table_path("writes.log"), cat.table_path("services.log"))
    cat.alter_table("services.log", SchemaChange.set_option("deletion-vectors.enabled", "true"))
    log = cat.get_table("services.log")
    all_ids = np.arange(C4_ROWS, dtype=np.int64)
    t0 = time.perf_counter()
    deleted = log.delete_where(equal("c2", 5))
    delete_s = time.perf_counter() - t0
    keep = (all_ids % 97 != 3) & (all_ids % 97 != 5)
    assert deleted == int((all_ids % 97 == 5).sum()), deleted
    plan = log.store.new_scan().plan()
    vectors = len(plan.dv_indexes())
    files_before = len(plan.entries)
    assert vectors > 0, "the DELETE wrote no deletion vector"

    def check(what: str) -> int:
        out = read_all(log)
        same_rows(out, read_all(log.copy({"sort-engine": "numpy"})), f"{what}, against the numpy engine")
        assert out.num_rows == int(keep.sum()), f"{what}: {out.num_rows} rows, the oracle has {int(keep.sum())}"
        for d, day in enumerate(P_DTS):
            ids = np.sort(out.column("id").values[out.column("dt").values == day])
            assert np.array_equal(ids, all_ids[keep & (all_ids % 4 == d)]), f"{what}: day {day} differs"
        return out.num_rows

    rows = check("log before the coordinator")
    coord = AppendCompactionCoordinator(log)
    t0 = time.perf_counter()
    tasks = coord.plan()
    coord.commit([execute_compaction_task(log, task) for task in tasks])
    compact_s = time.perf_counter() - t0
    assert tasks and log.store.snapshot_manager.latest_snapshot().commit_kind.value == "COMPACT"
    assert check("log after the coordinator") == rows
    return {"who": "an append-only event log compacted by a separate job", "rows": rows,
            "delete": {"predicate": "c2 = 5", "rows_deleted": deleted, "seconds": round(delete_s, 4),
                       "buckets_with_vectors": vectors},
            "tasks": len(tasks), "files_in_tasks": sum(len(t.files) for t in tasks), "seconds": round(compact_s, 4),
            "files_before": files_before, "files_per_bucket_after": files_per_bucket(log),
            "deleted_rows_stay_deleted": True, "equal_to_numpy_engine": True, "equal_to_oracle": True}


def check_evolved_read(table, last_commit: np.ndarray, what: str) -> dict:
    """Config 4 after its ALTER against a numpy-engine read and the oracle:
    each id with its last commit's v and label, and src null where that
    commit came before the ALTER."""
    t0 = time.perf_counter()
    out = read_all(table)
    read_s = time.perf_counter() - t0
    same_rows(out, read_all(table.copy({"sort-engine": "numpy"})), f"{what}, against the numpy engine")
    ids = np.flatnonzero(last_commit >= 0)
    b = last_commit[ids]
    assert np.array_equal(out.column("id").values, ids), f"{what}: ids differ from the oracle"
    assert np.array_equal(out.column("v").values, ids * 0.5 + b), f"{what}: v differs from the oracle"
    assert out.column("label").to_pylist() == [f"t{x}" for x in b], f"{what}: label differs from the oracle"
    want_src = [f"s{x}" if x >= EV_ALTER_AFTER else None for x in b]
    assert out.column("src").to_pylist() == want_src, f"{what}: src differs from the oracle"
    return {"rows": out.num_rows, "read_s": round(read_s, 4), "rows_before_the_alter": int((b < EV_ALTER_AFTER).sum()),
            "equal_to_numpy_engine": True, "equal_to_oracle": True}


def evolution_part(pt, hk, cat) -> dict:
    """(i) Config 4 with an ALTER after commit EV_ALTER_AFTER: add src
    STRING, rename tag to label; the later commits write the new schema and
    the compactions merge files of both; reads at both tiles. (ii) The
    aggregation_fused small table with c_max widened from INT to BIGINT and
    f_sum from FLOAT to DOUBLE after half its commits, then a full
    compaction: each read equal across sort engines and to a control table
    written under the wide types from the start (segment_sum sums the cast
    floats)."""
    from paimon_tpu_torch.core.schema import SchemaChange
    from paimon_tpu_torch.data.batch import Column, ColumnBatch
    from paimon_tpu_torch.table.compactor import DedicatedCompactor

    out: dict = {}
    table = c4_table(pt, cat, "services.c4_evolve", dict(C4_OPTIONS))
    rng = np.random.default_rng(2)
    last_commit = np.full(C4_ROWS // 2, -1, dtype=np.int64)
    before = dict(hk.launches)
    t0 = time.perf_counter()
    wb = table.new_stream_write_builder()
    w, c = wb.new_write(), wb.new_commit()
    for b in range(C4_COMMITS):
        batch = c4_batch(rng, b)
        last_commit[batch["id"]] = b
        if b == EV_ALTER_AFTER:
            cat.alter_table("services.c4_evolve", SchemaChange.add_column("src", pt.STRING()),
                            SchemaChange.rename_column("tag", "label"))
            table = cat.get_table("services.c4_evolve")
            wb = table.new_stream_write_builder()
            w, c = wb.new_write(), wb.new_commit()
        if b >= EV_ALTER_AFTER:
            batch["label"] = batch.pop("tag")
            batch["src"] = np.array([f"s{b}"] * len(batch["id"]), dtype=object)
        w.write(batch)
        c.commit_messages(b + 1, w.prepare_commit())
    torch.cuda.synchronize()
    write_s = time.perf_counter() - t0
    schema_ids = sorted({f.schema_id for f in live_files(table)})
    out["config4"] = {"config": "BASELINE config 4 with ALTER TABLE ADD src STRING, RENAME tag TO label after "
                                f"commit {EV_ALTER_AFTER}", "write_s": round(write_s, 4),
                      "live_file_schema_ids": schema_ids, "levels": level_layout(table),
                      "files_per_bucket": files_per_bucket(table),
                      "read_default_tile": check_evolved_read(table, last_commit, "evolved config 4"),
                      f"read_tile_{K1_TILE_ROWS}": check_evolved_read(
                          table.copy({"merge.read-batch-rows": str(K1_TILE_ROWS)}), last_commit,
                          f"evolved config 4 at tile {K1_TILE_ROWS}"),
                      "launches": launch_diff(hk, before)}
    snaps = table.store.snapshot_manager
    compacts = [snaps.snapshot(i) for i in range(1, snaps.latest_snapshot_id() + 1)
                if snaps.snapshot(i).commit_kind.value == "COMPACT"]
    assert any(s.schema_id == 1 for s in compacts), "no compaction ran under the new schema"

    options, fields, kinds = SMALL_TABLES["aggregation_fused"]
    wide = {"c_max": "BIGINT", "f_sum": "DOUBLE"}
    types = {"BIGINT": pt.BIGINT(), "INT": pt.INT(), "DOUBLE": pt.DOUBLE(), "FLOAT": pt.FLOAT(),
             "BOOLEAN": pt.BOOLEAN(), "STRING": pt.STRING()}
    opts = {"bucket": "1", "write-only": "true", "sort-engine": "pallas", **options}
    tables = {}
    for name, spec in (("widened", fields), ("control", [(f, wide.get(f, t)) for f, t in fields])):
        schema = pt.RowType.of(("id", pt.BIGINT(False)), *[(f, types[t]) for f, t in spec])
        tables[name] = cat.create_table(f"services.agg_{name}", schema, primary_keys=["id"], options=opts)
    rng = np.random.default_rng(77)
    before = dict(hk.launches)
    t0 = time.perf_counter()
    for b in range(SMALL_COMMITS):
        if b == SMALL_COMMITS // 2:
            cat.alter_table("services.agg_widened", SchemaChange.update_column_type("c_max", pt.BIGINT()),
                            SchemaChange.update_column_type("f_sum", pt.DOUBLE()))
            tables["widened"] = cat.get_table("services.agg_widened")
        # ids distinct within a commit: no flush sums at the narrow type, so
        # the control's float64 sums add the same values in the same order
        ids = rng.choice(SMALL_ROWS * 3 // 2, SMALL_ROWS, replace=False)
        cols = {"id": Column(ids), **{f: small_column(rng, f, t, ids, b) for f, t in fields}}
        if b >= SMALL_COMMITS // 2:  # values only the wide types hold
            cols["c_max"] = nullable(rng, rng.integers(-(10**12), 10**12, SMALL_ROWS))
            cols["f_sum"] = nullable(rng, rng.standard_normal(SMALL_ROWS) * 10.0 ** rng.integers(-3, 4, SMALL_ROWS))
        row_kinds = rng.choice(4, SMALL_ROWS, p=kinds).astype(np.uint8)
        for name, t in tables.items():
            data = {f: Column(col.values.astype(t.row_type.field(f).type.numpy_dtype()), col.validity)
                    for f, col in cols.items()}
            wb = t.new_batch_write_builder()
            w = wb.new_write()
            w.write(ColumnBatch(t.row_type, data), row_kinds)
            wb.new_commit().commit(w.prepare_commit())
    write_s = time.perf_counter() - t0
    reads = {}
    for step in ("before", "after"):
        if step == "after":
            for t in tables.values():
                assert DedicatedCompactor(t).run_once(full=True)
        got = engine_reads(tables["widened"], f"widened aggregation {step} the full compaction")
        same_rows(got, engine_reads(tables["control"], f"control aggregation {step} the full compaction"),
                  f"widened aggregation {step} the full compaction, against the control")
        reads[step] = got.num_rows
    launches = launch_diff(hk, before)
    out["aggregation_widened"] = {
        "table": "the aggregation_fused small table, c_max INT to BIGINT and f_sum FLOAT to DOUBLE after "
                 f"{SMALL_COMMITS // 2} of {SMALL_COMMITS} commits", "write_s": round(write_s, 4),
        "rows_written": SMALL_ROWS * SMALL_COMMITS, "rows_read": reads,
        "files_per_bucket": files_per_bucket(tables["widened"]), "equal_across_sort_engines": True,
        "equal_to_control": True, "launches": launches}
    assert launches["segment_sum"] > 0, f"segment_sum never launched on the widened sums: {launches}"
    return out


def services_phase(pt, hk, warehouse: str, bench_path: str, checked: tuple) -> dict:
    """The compaction services and schema evolution, one JSON line per part:
    rescale, the adaptive and dedicated compactors under ingest, the append
    coordinator, ALTER TABLE. K1 and K2 must launch in the phase, and
    segment_sum in the widened aggregation; then K1 and K2 are held exactly
    to their plain versions at the path's shapes no earlier check covered.
    Launch counts are zeroed before the phase."""
    from paimon_tpu_torch.catalog import FileSystemCatalog

    cat = FileSystemCatalog(warehouse, commit_user="chip_smoke", device=DEVICE)
    hk.reset_launches()
    parts, seconds = {}, {}
    with ShapeRecorder(hk) as recorder:
        for name, run in (("rescale", lambda: rescale_part(pt, hk, cat, bench_path)),
                          ("adaptive", lambda: adaptive_part(pt, hk, cat)),
                          ("coordinator", lambda: coordinator_part(pt, hk, cat)),
                          ("evolution", lambda: evolution_part(pt, hk, cat))):
            before = dict(hk.launches)
            t0 = time.perf_counter()
            parts[name] = run()
            seconds[name] = parts[name]["part_s"] = round(time.perf_counter() - t0, 3)
            parts[name]["part_launches"] = launch_diff(hk, before)
            emit({"phase": "services", "part": name, **parts[name]})
    by_part = {name: p["part_launches"] for name, p in parts.items()}
    launches = dict(hk.launches)
    for k in K1_K2:
        assert launches[k] > 0, f"{k} never launched on the services path: {by_part}"
    assert not any(by_part["coordinator"].values()), f"the append coordinator launched a kernel: {by_part}"
    return {"launches": launches, "launches_by_part": by_part, "seconds_by_part": seconds,
            "shape_checks": path_shape_checks(hk, recorder, torch.device(DEVICE), 2031, checked)}


# the point-get table of benchmarks/point_get_bench.py:41-60 and the star
# join of benchmarks/join_bench.py:60-100
LK_ROWS = 1_000_000
LK_RUNS = 4
LK_BATCH = 10_000  # keys per get batch, about half of them absent
LK_BATCHES = 5
LK_SPARSE = 64  # absent keys of the cold bloom-pruning batch (point_get_bench.py:128)
LK_RYW_ROWS = 10_000
LK_OPTIONS = {"bucket": "1", "write-only": "true", "file-index.bloom-filter.primary-key.enabled": "true",
              "sort-engine": "pallas"}
J_FACT = 1_000_000
J_DIM = 100_000
J_DAILY = 10_000  # customers the daily dimension commit updates
J_CHANGES = (700, 200, 100)  # the later dimension commit: updates, -D rows, new customers
J_SKEWS = ("uniform", "zipf", "hot50")
J_HOT = 4242  # hot50's customer
J_OPTIONS = {"bucket": "1", "write-only": "true", "sort-engine": "pallas"}
# 8 partitions of about 137,500 rows pad to 2^18, where K1 still admits the
# three lanes (pad, key, side); the unpartitioned 1.1M rows pad to 2^21: K2
J_CHUNK_ROWS = 131_072


def lk_values(ids: np.ndarray, tag: str = "") -> dict:
    return {"id": ids, "c1": ids * 3, "s1": np.array([f"val-{int(x) % 1000:04d}{tag}" for x in ids], dtype=object),
            "d1": ids.astype(np.float64) * 0.5}


def check_gets(res, keys: np.ndarray, what: str) -> int:
    """A GetResult against the generator: the even ids below 2 * LK_ROWS are
    there, with their values; every other key is absent."""
    present = (keys % 2 == 0) & (keys >= 0) & (keys < 2 * LK_ROWS)
    assert np.array_equal(res.found, present), f"{what}: found differs from the table's ids"
    assert np.array_equal(res.take, np.flatnonzero(present)), what
    want = lk_values(keys[present])
    for name, values in want.items():
        col = res.rows.column(name)
        assert col.validity is None and same_values(col.values, values), f"{what}: column {name} differs"
    return int(present.sum())


def point_get_part(pt, hk, cat) -> dict:
    """The point-get table: 10,000-key batches through get_batch against the
    generator, one batch against the scalar lookup walk, a sparse batch of
    absent keys on a cold data-file cache with bloom pruning on and off, and
    a get with 10,000 rows buffered in an attached TableWrite."""
    from paimon_tpu_torch.metrics import get_metrics, registry
    from paimon_tpu_torch.table.query import LocalTableQuery
    from paimon_tpu_torch.utils.cache import data_file_cache

    table = cat.create_table("lookups.kv", pt.RowType.of(
        ("id", pt.BIGINT(False)), ("c1", pt.BIGINT()), ("s1", pt.STRING()), ("d1", pt.DOUBLE())),
        primary_keys=["id"], options=LK_OPTIONS)
    rng = np.random.default_rng(11)
    # even ids only: an odd id in the range is absent, and only the key
    # bloom (never the key range) can prune a file for it
    ids = rng.permutation(LK_ROWS).astype(np.int64) * 2
    per = LK_ROWS // LK_RUNS
    t0 = time.perf_counter()
    for r in range(LK_RUNS):
        wb = table.new_batch_write_builder()
        w = wb.new_write()
        w.write(lk_values(np.sort(ids[r * per:(r + 1) * per])))
        wb.new_commit().commit(w.prepare_commit())
    write_s = time.perf_counter() - t0
    files = [e.file for e in table.store.new_scan().plan().entries]
    assert all(f.embedded_index is not None or f.extra_files for f in files), "a file has no key bloom"
    g = get_metrics()
    dcache = registry.group("cache", cache="data-file")
    h0, m0 = dcache.counter("hits").count, dcache.counter("misses").count
    t0 = time.perf_counter()
    q = LocalTableQuery(table, device=DEVICE)
    open_s = time.perf_counter() - t0
    rng = np.random.default_rng(7)
    batch_s, found = [], 0
    for b in range(LK_BATCHES):
        keys = rng.integers(0, 2 * LK_ROWS, LK_BATCH).astype(np.int64)
        t0 = time.perf_counter()
        res = q.get_batch(keys)
        batch_s.append(time.perf_counter() - t0)
        found += check_gets(res, keys, f"get batch {b}")
    t0 = time.perf_counter()
    scalar = [q.lookup((), int(k)) for k in keys]
    scalar_s = time.perf_counter() - t0
    assert [None if r is None else r.to_pylist()[0] for r in scalar] == res.to_pylist(), "get_batch != scalar lookups"
    warm = batch_s[1:]
    sparse = np.random.default_rng(13).integers(0, LK_ROWS - 1, LK_SPARSE).astype(np.int64) * 2 + 1
    bloom = {}
    for mode, opt in (("pruned", "true"), ("unpruned", "false")):
        data_file_cache().clear()
        qb = LocalTableQuery(table.copy({"lookup.get.bloom-prune.enabled": opt}), device=DEVICE)
        p0, miss0 = g.counter("files_pruned").count, dcache.counter("misses").count
        t0 = time.perf_counter()
        res = qb.get_batch(sparse)
        bloom[mode] = {"ms": round((time.perf_counter() - t0) * 1000, 3),
                       "files_pruned": g.counter("files_pruned").count - p0,
                       "files_decoded": dcache.counter("misses").count - miss0}
        assert not res.found.any(), f"an absent key was found ({mode})"
    assert bloom["pruned"]["files_pruned"] > 0, f"the key blooms pruned no file: {bloom}"
    assert bloom["unpruned"]["files_decoded"] == len(files), bloom
    # read-your-writes: 5,000 updated ids and 5,000 new (odd) ids buffered,
    # never committed
    tw = table.new_batch_write_builder().new_write()
    upd = np.sort(ids[:LK_RYW_ROWS // 2])
    new = np.sort(rng.choice(LK_ROWS, LK_RYW_ROWS // 2, replace=False).astype(np.int64) * 2 + 1)
    tw.write(lk_values(np.concatenate([upd, new]), tag="-ryw"))
    q.attach_write(tw)
    mem0 = g.counter("memtable_hits").count
    probe = np.concatenate([upd, new, ids[-2000:], [-1]])
    t0 = time.perf_counter()
    res = q.get_batch(probe)
    ryw_ms = (time.perf_counter() - t0) * 1000
    buffered = np.concatenate([upd, new])
    assert res.found.sum() == len(probe) - 1 and not res.found[-1], "read-your-writes lost a row"
    rows = res.rows
    n = len(buffered)
    assert same_values(rows.column("id").values[:n], buffered)
    assert same_values(rows.column("s1").values[:n], lk_values(buffered, tag="-ryw")["s1"]), "a buffered value lost"
    assert same_values(rows.column("s1").values[n:], lk_values(ids[-2000:])["s1"]), "a committed value lost"
    memtable_hits = g.counter("memtable_hits").count - mem0
    assert memtable_hits == n, memtable_hits
    q.attach_write(None)
    q.close()
    return {"rows": LK_ROWS, "runs": LK_RUNS, "options": LK_OPTIONS, "write_s": round(write_s, 3),
            "files": len(files), "query_open_s": round(open_s, 4),
            "batch_keys": LK_BATCH, "batches": LK_BATCHES, "keys_found": found,
            "first_batch_ms": round(batch_s[0] * 1000, 3),
            "warm_batch_ms": [round(s * 1000, 3) for s in warm],
            "warm_gets_per_s_median": round(LK_BATCH / float(np.median(warm)), 1),
            "scalar_lookups_s": round(scalar_s, 3), "scalar_gets_per_s": round(LK_BATCH / scalar_s, 1),
            "equal_to_scalar_lookups": True, "bloom_cold_cache": {"keys": LK_SPARSE, **bloom},
            "read_your_writes": {"buffered_rows": n, "probe_keys": len(probe), "ms": round(ryw_ms, 3),
                                 "memtable_hits": memtable_hits},
            "data_file_cache": {"hits": dcache.counter("hits").count - h0,
                                "misses": dcache.counter("misses").count - m0},
            "get_metrics": {k: g.counter(k).count for k in ("gets", "keys_probed", "files_pruned", "index_hits",
                                                           "memtable_hits")}}


def star_tables(pt, cat):
    """The dimension (one commit of 100,000 customers, then a daily commit
    updating 10,000 of them) and the fact table (1,000,000 rows in 4 commits,
    three customer-key columns by skew)."""
    rng = np.random.default_rng(12)
    dim = cat.create_table("lookups.dim", pt.RowType.of(
        ("cid", pt.STRING(False)), ("name", pt.STRING()), ("rate", pt.DOUBLE())),
        primary_keys=["cid"], options=J_OPTIONS)
    cids = np.array([f"C{i:06d}" for i in range(J_DIM)], dtype=object)
    t0 = time.perf_counter()
    names = np.array([f"customer-{i}" for i in range(J_DIM)], dtype=object)
    rates = rng.random(J_DIM)
    for rows, tag in ((np.arange(J_DIM), ""), (np.sort(rng.choice(J_DIM, J_DAILY, replace=False)), "-d2")):
        rates[rows] = rng.random(len(rows))
        names[rows] = [f"customer-{i}{tag}" for i in rows]
        wb = dim.new_batch_write_builder()
        w = wb.new_write()
        w.write({"cid": cids[rows], "name": names[rows], "rate": rates[rows]})
        wb.new_commit().commit(w.prepare_commit())
    dim_write_s = time.perf_counter() - t0
    fields = [("id", pt.BIGINT(False))] + [(f"cust_{s}", pt.STRING(False)) for s in J_SKEWS]
    fact = cat.create_table("lookups.fact", pt.RowType.of(*fields, ("amount", pt.DOUBLE()), ("qty", pt.BIGINT())),
                            primary_keys=["id"], options=J_OPTIONS)
    keys = {"uniform": rng.integers(0, J_DIM, J_FACT),
            "zipf": np.minimum((rng.pareto(1.1, J_FACT) * J_DIM / 20).astype(np.int64), J_DIM - 1),
            "hot50": np.where(rng.random(J_FACT) < 0.5, J_HOT, rng.integers(0, J_DIM, J_FACT))}
    per = J_FACT // 4
    t0 = time.perf_counter()
    for r in range(4):
        sl = slice(r * per, (r + 1) * per)
        data = {"id": np.arange(sl.start, sl.stop, dtype=np.int64), "amount": rng.random(per).round(4),
                "qty": rng.integers(1, 9, per)}
        for s, k in keys.items():
            data[f"cust_{s}"] = cids[k[sl]]
        wb = fact.new_batch_write_builder()
        w = wb.new_write()
        w.write(data)
        wb.new_commit().commit(w.prepare_commit())
    fact_write_s = time.perf_counter() - t0
    return dim, fact, {"cid": cids, "name": names, "rate": rates}, keys, dim_write_s, fact_write_s


def star_part(pt, hk, cat) -> tuple[dict, dict]:
    """The star join per skew: join_batches under auto (the hash probe on the
    card), under sort-merge with sort-engine=pallas (the stock sort and K2 at
    m = 2^21), under xla-segmented (plain torch sort-merge) and numpy; hot50
    also partitioned by join.chunk-rows (K1 per partition). Every engine's
    pairs equal numpy's and a host dict loop's."""
    from paimon_tpu_torch.ops.join import join_batches

    dim, fact, dim_rows, keys, dim_write_s, fact_write_s = star_tables(pt, cat)
    t0 = time.perf_counter()
    dim_batch = read_all(dim)
    dim_read_s = time.perf_counter() - t0
    for name, values in dim_rows.items():
        assert same_values(dim_batch.column(name).values, values), f"dimension read: {name} differs"
    t0 = time.perf_counter()
    fact_batch = read_all(fact)
    fact_read_s = time.perf_counter() - t0
    assert fact_batch.num_rows == J_FACT
    pos = {c: j for j, c in enumerate(dim_batch.column("cid").values.tolist())}
    engines = {
        "auto": {"sort-engine": "pallas"},
        "sort_merge_pallas": {"sort-engine": "pallas", "join.algorithm": "sort-merge"},
        "xla_segmented": {"join.engine": "xla-segmented", "join.algorithm": "sort-merge"},
        "numpy": {"join.engine": "numpy"},
    }
    joins = {}
    for skew in J_SKEWS:
        col = f"cust_{skew}"
        t0 = time.perf_counter()
        rt = np.fromiter((pos.get(c, -1) for c in fact_batch.column(col).values.tolist()), np.int64, J_FACT)
        loop_s = time.perf_counter() - t0
        lt = np.flatnonzero(rt >= 0)
        rt = rt[lt]
        runs = dict(engines)
        if skew == "hot50":
            runs["sort_merge_pallas_chunked"] = {**engines["sort_merge_pallas"], "join.chunk-rows": str(J_CHUNK_ROWS)}
        out = {"host_dict_loop_s": round(loop_s, 3), "pairs": int(len(lt))}
        for label, options in runs.items():
            before = dict(hk.launches)
            t0 = time.perf_counter()
            res = join_batches(fact_batch, dim_batch, [col], ["cid"], options=options, device=DEVICE)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            assert np.array_equal(res.left_take, lt) and np.array_equal(res.right_take, rt), \
                f"{skew}/{label}: pairs differ from the host dict loop"
            out[label] = {"ms": round(wall * 1000, 3), "launches": launch_diff(hk, before),
                          **{k: res.stats[k] for k in ("algorithm", "engine", "partitions", "skew_keys", "lanes")}}
        assert out["sort_merge_pallas"]["launches"]["keep_last_mask"] > 0, f"{skew}: K2 never launched"
        joins[skew] = out
    assert joins["hot50"]["sort_merge_pallas_chunked"]["launches"]["sort_segments"] > 0, "K1 never launched"
    assert joins["hot50"]["sort_merge_pallas_chunked"]["skew_keys"] >= 1
    part = {"dimension_rows": J_DIM, "dimension_daily_updates": J_DAILY, "fact_rows": J_FACT,
            "write_s": {"dimension": round(dim_write_s, 3), "fact": round(fact_write_s, 3)},
            "read_s": {"dimension": round(dim_read_s, 3), "fact": round(fact_read_s, 3)},
            "chunk_rows": J_CHUNK_ROWS, "joins": joins, "equal_to_numpy_and_dict_loop": True}
    return part, {"dim": dim, "fact_batch": fact_batch}


def same_batch(a, b, what: str) -> None:
    assert a.schema.field_names == b.schema.field_names, f"{what}: {a.schema.field_names} != {b.schema.field_names}"
    assert a.num_rows == b.num_rows, f"{what}: {a.num_rows} != {b.num_rows} rows"
    for name in a.schema.field_names:
        x, y = a.column(name), b.column(name)
        ok = x.valid_mask()
        assert np.array_equal(ok, y.valid_mask()), f"{what}: validity of {name} differs"
        assert same_values(x.values[ok], y.values[ok]), f"{what}: column {name} differs"


def check_lookup_join(lt, fact_batch, what: str) -> dict:
    """lookup_join of the fact rows against the cached dimension, held to
    the materialised LEFT join_batches of the same rows."""
    from paimon_tpu_torch.lookup.tables import lookup_join
    from paimon_tpu_torch.ops.join import join_batches, materialize_join

    t0 = time.perf_counter()
    out = lookup_join(lt, fact_batch, probe_keys=["cust_uniform"])
    join_s = time.perf_counter() - t0
    state = lt.state_batch()
    res = join_batches(fact_batch, state, ["cust_uniform"], ["cid"], how="left", options={"sort-engine": "pallas"},
                       device=DEVICE)
    ref = materialize_join(fact_batch, state, res, [(n, n) for n in fact_batch.schema.field_names],
                           [(n, n) for n in state.schema.field_names])
    same_batch(out, ref, what)
    return {"lookup_join_s": round(join_s, 3), "rows": out.num_rows,
            "unmatched": int((~out.column("cid").valid_mask()).sum())}


def lookup_join_part(pt, hk, cat, star: dict) -> dict:
    """FullCacheLookupTable over the dimension (its bootstrap merges the two
    commits on the card) and lookup_join of the 1M fact rows; then 1,000
    dimension changes with -D rows, a refresh, and the checks again."""
    from paimon_tpu_torch.lookup.tables import FullCacheLookupTable

    dim, fact_batch = star["dim"], star["fact_batch"]
    t0 = time.perf_counter()
    lt = FullCacheLookupTable(dim, device=DEVICE)
    bootstrap_s = time.perf_counter() - t0
    dim_batch = read_all(dim)
    same_batch(lt.state_batch(), dim_batch, "bootstrap state")
    before = check_lookup_join(lt, fact_batch, "lookup join")
    rng = np.random.default_rng(14)
    n_up, n_del, n_new = J_CHANGES
    pick = rng.choice(J_DIM, n_up + n_del, replace=False)
    up, gone = pick[:n_up], pick[n_up:]
    cid = lambda ids: np.array([f"C{int(i):06d}" for i in ids], dtype=object)  # noqa: E731
    changes = {"cid": np.concatenate([cid(up), cid(gone), cid(J_DIM + np.arange(n_new))]),
               "name": np.array([f"changed-{i}" for i in range(n_up + n_del + n_new)], dtype=object),
               "rate": rng.random(n_up + n_del + n_new)}
    kinds = ["+I"] * n_up + ["-D"] * n_del + ["+I"] * n_new
    wb = dim.new_batch_write_builder()
    w = wb.new_write()
    w.write(changes, kinds)
    wb.new_commit().commit(w.prepare_commit())
    t0 = time.perf_counter()
    applied = lt.refresh()
    refresh_s = time.perf_counter() - t0
    assert applied == sum(J_CHANGES) and len(lt) == J_DIM - n_del + n_new, (applied, len(lt))
    state = lt.state_batch()
    order = np.argsort(state.column("cid").values.astype(str), kind="stable")
    same_batch(state.take(order), read_all(dim), "refreshed state")
    after = check_lookup_join(lt, fact_batch, "lookup join after refresh")
    assert after["unmatched"] > before["unmatched"], "the deleted customers still match"
    return {"bootstrap_s": round(bootstrap_s, 3), "cached_rows": J_DIM, "before_refresh": before,
            "changes": {"updates": n_up, "deletes": n_del, "new": n_new}, "refresh_s": round(refresh_s, 4),
            "refresh_rows_applied": applied, "after_refresh": after, "equal_to_left_join_batches": True}


def lookups_phase(pt, hk, warehouse: str, checked: tuple) -> dict:
    """Point lookups and lookup joins, one JSON line per part. K1 and K2
    must launch on the join path; then both are held exactly to their plain
    versions at the path's shapes no earlier check covered. Launch counts
    are zeroed before the phase."""
    from paimon_tpu_torch.catalog import FileSystemCatalog
    from paimon_tpu_torch.metrics import registry

    cat = FileSystemCatalog(warehouse, commit_user="chip_smoke", device=DEVICE)
    counters = ("hits", "misses", "evictions", "invalidations")

    def cache_counts():
        return {name: {m: registry.group("cache", cache=name).counter(m).count for m in counters}
                for name in ("manifest", "data-file")}

    caches0 = cache_counts()
    hk.reset_launches()
    parts, seconds, star = {}, {}, {}

    def star_run():
        part, tables = star_part(pt, hk, cat)
        star.update(tables)
        return part

    with ShapeRecorder(hk) as recorder:
        for name, run in (("gets", lambda: point_get_part(pt, hk, cat)),
                          ("star_join", star_run),
                          ("lookup_join", lambda: lookup_join_part(pt, hk, cat, star))):
            before = dict(hk.launches)
            t0 = time.perf_counter()
            parts[name] = run()
            seconds[name] = parts[name]["part_s"] = round(time.perf_counter() - t0, 3)
            parts[name]["part_launches"] = launch_diff(hk, before)
            emit({"phase": "lookups", "part": name, **parts[name]})
    by_part = {name: p["part_launches"] for name, p in parts.items()}
    launches = dict(hk.launches)
    for k in K1_K2:
        assert by_part["star_join"][k] > 0, f"{k} never launched on the join path: {by_part}"
    caches = {name: {m: v - caches0[name][m] for m, v in c.items()} for name, c in cache_counts().items()}
    return {"launches": launches, "launches_by_part": by_part, "seconds_by_part": seconds, "caches": caches,
            "star_join_auto_ms": {skew: parts["star_join"]["joins"][skew]["auto"]["ms"] for skew in J_SKEWS},
            "shape_checks": path_shape_checks(hk, recorder, torch.device(DEVICE), 2032, checked)}


SQL_WHERE_BELOW = 100_000  # the pushdown query's id bound
SQL_GROUP_BELOW = 200_000  # the filtered GROUP BY's id bound: 2^18 padded rows, K1
SQL_HAVING = 150  # its HAVING count(*) bound
SQL_UPDATE_BELOW = 50_000  # the UPDATE's id bound
SQL_MERGE_ROWS = 10_000  # merge_into's source rows: half matched, half new
SQL_C4_OPTIONS = {**C4_OPTIONS}  # config 4's table options (bucket 1, trigger 4, pallas), not write-only
NUMPY_HINT = "/*+ OPTIONS('sort-engine' = 'numpy') */"


class StageClock:
    """Wall seconds spent in the scan (TableRead.read_all), the join
    (ops.join.join_batches) and the GROUP BY (sql.select._group_aggregate)
    while installed; the device is synchronised at the end of each."""

    def __init__(self):
        import paimon_tpu_torch.ops.join as join_mod
        import paimon_tpu_torch.sql.select as select_mod
        import paimon_tpu_torch.table.read as read_mod

        self.targets = ((read_mod.TableRead, "read_all", "scan"), (join_mod, "join_batches", "join"),
                        (select_mod, "_group_aggregate", "group_by"))
        self.seconds = dict.fromkeys(("scan", "join", "group_by"), 0.0)

    def __enter__(self):
        self.saved = [getattr(owner, name) for owner, name, _ in self.targets]
        for (owner, name, stage), real in zip(self.targets, self.saved):
            def timed_call(*args, _real=real, _stage=stage, **kwargs):
                t0 = time.perf_counter()
                try:
                    return _real(*args, **kwargs)
                finally:
                    torch.cuda.synchronize()
                    self.seconds[_stage] += time.perf_counter() - t0
            setattr(owner, name, timed_call)
        return self

    def __exit__(self, *exc):
        for (owner, name, _), real in zip(self.targets, self.saved):
            setattr(owner, name, real)

    def split(self) -> dict:
        return {k: round(v, 4) for k, v in self.seconds.items()}


def sql_run(hk, cat, statement: str):
    """One statement through paimon_tpu_torch.sql.execute, timed, with its
    launches and its scan / join / GROUP BY split."""
    from paimon_tpu_torch.sql import execute

    before = dict(hk.launches)
    with StageClock() as clock:
        t0 = time.perf_counter()
        out = execute(cat, statement)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    stats = {"seconds": round(seconds, 4), "launches": launch_diff(hk, before), "split_s": clock.split()}
    if hasattr(out, "num_rows"):
        stats["rows"] = out.num_rows
    return out, stats


def numpy_engine(hk, cat, statement: str, table: str):
    """The statement with the numpy sort engine hinted on `table`; its
    launches are not counted."""
    from paimon_tpu_torch.sql import execute

    saved = dict(hk.launches)
    out = execute(cat, statement.replace(table, f"{table} {NUMPY_HINT}", 1))
    hk.launches.update(saved)
    return out


def same_result(a, b, what: str, float_rtol: dict | None = None) -> None:
    """Column names, types, rows and order; floats bit for bit, except the
    columns of float_rtol, held to that relative tolerance."""
    assert a.schema.field_names == b.schema.field_names, f"{what}: {a.schema.field_names} != {b.schema.field_names}"
    assert [f.type.serialize() for f in a.schema.fields] == [f.type.serialize() for f in b.schema.fields], what
    assert a.num_rows == b.num_rows, f"{what}: {a.num_rows} != {b.num_rows} rows"
    for name in a.schema.field_names:
        x, y = a.column(name), b.column(name)
        ok = x.valid_mask()
        assert np.array_equal(ok, y.valid_mask()), f"{what}: validity of {name} differs"
        xv, yv = x.values[ok], y.values[ok]
        if float_rtol and name in float_rtol:
            assert np.allclose(xv, yv, rtol=float_rtol[name], atol=0), f"{what}: column {name} differs"
        else:
            assert same_values(xv, yv), f"{what}: column {name} differs"


def check_rows(out, columns: dict, what: str) -> None:
    """A result against oracle columns {name: values}, none of them NULL;
    floats bit for bit."""
    assert out.schema.field_names == list(columns), f"{what}: {out.schema.field_names}"
    for name, want in columns.items():
        col = out.column(name)
        want = np.asarray(want)
        assert col.null_count == 0 and len(col) == len(want), f"{what}: {name} has nulls or {len(col)} rows"
        if want.dtype.kind == "f":
            assert same_values(col.values.astype(np.float64), want.astype(np.float64)), f"{what}: {name} differs"
        else:
            assert col.values.tolist() == want.tolist(), f"{what}: column {name} differs from the oracle"


def bench_oracle(up: np.ndarray) -> dict:
    """The bench table's rows by id: the four runs, then the upsert."""
    vals = table_values(np.arange(N_ROWS, dtype=np.int64), upsert=False)
    ups = np.sort(up)
    new = table_values(ups, upsert=True)
    for name in vals:
        vals[name][ups] = new[name]
    return vals


def group_oracle(keys: np.ndarray, cols: dict, order: str = "first"):
    """GROUP BY keys: per group count(*), sum(c1), min(d1), max(d2), avg(d1)
    (float sums of these exact binary fractions are exact in any order);
    groups in first-appearance order or key order."""
    uniq, first, inv = np.unique(keys, return_index=True, return_inverse=True)
    g = len(uniq)
    count = np.bincount(inv, minlength=g)
    c1 = np.zeros(g, np.int64)
    np.add.at(c1, inv, cols["c1"])
    d1_sum = np.bincount(inv, weights=cols["d1"], minlength=g)
    d1_min = np.full(g, np.inf)
    np.minimum.at(d1_min, inv, cols["d1"])
    d2_max = np.full(g, -np.inf)
    np.maximum.at(d2_max, inv, cols["d2"])
    rank = np.argsort(first, kind="stable") if order == "first" else np.arange(g)
    return uniq[rank], count[rank], c1[rank], d1_min[rank], d2_max[rank], (d1_sum / count)[rank]


def sql_select_part(pt, hk, cat, table, up) -> dict:
    """SELECT on the main phase's bench table: the queries of
    benchmarks/sql_overhead.py:54-60 (the star beside the Table-API read, the
    pushdown query, GROUP BY s2) with more aggregates, two more GROUP BY
    shapes and EXPLAIN. Each result
    is held, outside the timing, to a numpy oracle and to the same statement
    under the numpy sort engine."""
    oracle = bench_oracle(up)
    ids = np.arange(N_ROWS, dtype=np.int64)
    out_stats = {}
    t0 = time.perf_counter()
    direct = read_all(table)
    api_s = time.perf_counter() - t0
    star, stats = sql_run(hk, cat, "SELECT * FROM bench.t")
    check_output(star, direct, up, "SELECT *")
    stats["table_api_read_s"] = round(api_s, 4)
    stats["output_rows_per_s"] = round(N_ROWS / stats["seconds"], 1)
    out_stats["star"] = stats

    q = f"SELECT id, c1 FROM bench.t WHERE id < {SQL_WHERE_BELOW}"
    out, stats = sql_run(hk, cat, q)
    check_rows(out, {"id": ids[:SQL_WHERE_BELOW], "c1": oracle["c1"][:SQL_WHERE_BELOW]}, q)
    same_result(out, numpy_engine(hk, cat, q, "bench.t"), q)
    plan, _ = sql_run(hk, cat, "EXPLAIN " + q)
    lines = plan.column("plan").to_pylist()
    assert f"where (pushed): id < {SQL_WHERE_BELOW}" in lines and "projection (pushed): [id, c1]" in lines, lines
    stats["plan"] = lines
    out_stats["pushdown"] = stats

    aggs = "count(*), sum(c1), min(d1), max(d2), avg(d1)"
    q = f"SELECT s2, {aggs} FROM bench.t GROUP BY s2 ORDER BY s2"
    out, stats = sql_run(hk, cat, q)
    keys, count, c1, d1_min, d2_max, d1_avg = group_oracle(oracle["s2"].astype(str), oracle, order="key")
    check_rows(out, {"s2": keys.tolist(), "count(*)": count, "sum(c1)": c1, "min(d1)": d1_min,
                     "max(d2)": d2_max, "avg(d1)": d1_avg}, q)
    same_result(out, numpy_engine(hk, cat, q, "bench.t"), q)
    stats["groups"] = out.num_rows
    out_stats["group_by_s2"] = stats

    q = (f"SELECT s1, {aggs} FROM bench.t WHERE id < {SQL_GROUP_BELOW} GROUP BY s1 "
         f"HAVING count(*) > {SQL_HAVING}")
    out, stats = sql_run(hk, cat, q)
    sub = {k: v[:SQL_GROUP_BELOW] for k, v in oracle.items()}
    keys, count, c1, d1_min, d2_max, d1_avg = group_oracle(sub["s1"].astype(str), sub)
    keep = count > SQL_HAVING
    check_rows(out, {"s1": keys[keep].tolist(), "count(*)": count[keep], "sum(c1)": c1[keep],
                     "min(d1)": d1_min[keep], "max(d2)": d2_max[keep], "avg(d1)": d1_avg[keep]}, q)
    same_result(out, numpy_engine(hk, cat, q, "bench.t"), q)
    stats["groups_kept"] = out.num_rows
    stats["groups"] = len(keys)
    out_stats["group_by_s1_having"] = stats

    q = "SELECT c3, count(*), sum(c1) FROM bench.t GROUP BY c3 ORDER BY c3 LIMIT 20"
    out, stats = sql_run(hk, cat, q)
    uniq, inv = np.unique(oracle["c3"], return_inverse=True)
    c1 = np.zeros(len(uniq), np.int64)
    np.add.at(c1, inv, oracle["c1"])
    check_rows(out, {"c3": uniq[:20], "count(*)": np.bincount(inv)[:20], "sum(c1)": c1[:20]}, q)
    same_result(out, numpy_engine(hk, cat, q, "bench.t"), q)
    stats["groups"] = len(uniq)
    out_stats["group_by_c3_limit"] = stats
    return out_stats


def star_oracle(fact, dim, key: str):
    """The fact rows joined to the dimension by `key` (fact rows in the
    read's order): (fact row, dimension row) pairs."""
    pos = {c: j for j, c in enumerate(dim.column("cid").values.tolist())}
    right = np.fromiter((pos.get(c, -1) for c in fact.column(key).values.tolist()), np.int64, fact.num_rows)
    left = np.flatnonzero(right >= 0)
    return left, right[left]


def star_group_oracle(fact, dim, left, right, limit: int):
    """name, count(*), sum(amount), max(qty) over the joined rows, names in
    order, the first `limit`; each sum adds its group's rows in the joined
    order from +0.0, as the kernel does."""
    names = dim.column("name").values[right]
    uniq, inv = np.unique(names.astype(str), return_inverse=True)
    amount, qty = fact.column("amount").values[left], fact.column("qty").values[left]
    sums = [0.0] * len(uniq)
    for g, a in zip(inv.tolist(), amount.tolist()):
        sums[g] += a
    maxq = np.full(len(uniq), np.iinfo(np.int64).min)
    np.maximum.at(maxq, inv, qty)
    return {"name": uniq[:limit].tolist(), "count(*)": np.bincount(inv)[:limit], "sum(amount)": sums[:limit],
            "max(qty)": maxq[:limit]}


def sql_join_part(pt, hk, cat) -> dict:
    """The retail star join of the lookups phase's tables as a SQL user
    writes it: per skew the grouped inner join, then a LEFT join filtered on
    the dimension; each held to a host oracle and to the numpy sort engine
    (float sums within 1e-12, since numpy adds pairwise)."""
    fact, dim = read_all(cat.get_table("lookups.fact")), read_all(cat.get_table("lookups.dim"))
    out_stats = {}
    for skew in ("zipf", "uniform"):
        key = f"cust_{skew}"
        q = (f"SELECT d.name, count(*), sum(f.amount), max(f.qty) FROM lookups.fact f JOIN lookups.dim d "
             f"ON f.{key} = d.cid GROUP BY d.name ORDER BY d.name LIMIT 50")
        out, stats = sql_run(hk, cat, q)
        left, right = star_oracle(fact, dim, key)
        check_rows(out, star_group_oracle(fact, dim, left, right, 50), q)
        same_result(out, numpy_engine(hk, cat, q, "lookups.fact"), q, {"sum(amount)": 1e-12})
        stats["joined_rows"] = int(len(left))
        out_stats[f"group_by_name_{skew}"] = stats
    q = ("SELECT f.id, d.rate FROM lookups.fact f LEFT JOIN lookups.dim d ON f.cust_uniform = d.cid "
         "WHERE d.rate > 0.5")
    out, stats = sql_run(hk, cat, q)
    left, right = star_oracle(fact, dim, "cust_uniform")
    rate = dim.column("rate").values[right]
    keep = rate > 0.5
    check_rows(out, {"id": fact.column("id").values[left][keep], "rate": rate[keep]}, q)
    same_result(out, numpy_engine(hk, cat, q, "lookups.fact"), q)
    plan, _ = sql_run(hk, cat, "EXPLAIN " + q)
    stats["plan"] = plan.column("plan").to_pylist()
    stats["where_pushed_to_dimension"] = False  # a LEFT join keeps its right-side conjuncts as a residual
    out_stats["left_join_rate"] = stats
    return out_stats


def sql_dml_part(pt, hk, cat, up) -> dict:
    """DDL and DML on a table of config 4's options with the bench table's
    columns (the UPDATE and DELETE name c1 and c2): CREATE TABLE, INSERT ...
    SELECT of the bench table, UPDATE, DELETE, CALL sys.merge_into, CALL
    sys.compact, ANALYZE, $snapshots and $files, TRUNCATE; after each step
    the table read equals the oracle."""
    cols = ("id", "c1", "c2", "c3", "d1", "d2", "s1", "s2")
    state = {k: v.copy() for k, v in bench_oracle(up).items()}
    state["id"] = np.arange(N_ROWS, dtype=np.int64)
    alive = np.ones(N_ROWS, np.bool_)

    def check(what: str) -> dict:
        t0 = time.perf_counter()
        out = read_all(cat.get_table("sql.c4"))
        read_s = time.perf_counter() - t0
        live = np.flatnonzero(alive)
        order = np.argsort(state["id"][live], kind="stable")
        check_rows(out, {k: state[k][live][order] for k in cols}, what)
        return {"rows_after": out.num_rows, "read_s": round(read_s, 4)}

    steps = {}
    opts = ", ".join(f"'{k}' = '{v}'" for k, v in SQL_C4_OPTIONS.items())
    ddl = ("CREATE TABLE sql.c4 (id BIGINT NOT NULL, c1 BIGINT, c2 BIGINT, c3 BIGINT, d1 DOUBLE, d2 DOUBLE, "
           f"s1 STRING, s2 STRING, PRIMARY KEY (id) NOT ENFORCED) WITH ({opts})")
    res, steps["create"] = sql_run(hk, cat, ddl)
    assert res == {"created": "sql.c4"}, res
    res, steps["insert_select"] = sql_run(hk, cat, "INSERT INTO sql.c4 SELECT * FROM bench.t")
    assert res["inserted"] == N_ROWS, res
    steps["insert_select"].update(check("insert select"))

    res, steps["update"] = sql_run(hk, cat, f"UPDATE sql.c4 SET c1 = c1 + 1 WHERE id < {SQL_UPDATE_BELOW}")
    assert res["rows_updated"] == SQL_UPDATE_BELOW, res
    state["c1"][:SQL_UPDATE_BELOW] += 1
    steps["update"].update(check("update"))

    res, steps["delete"] = sql_run(hk, cat, "DELETE FROM sql.c4 WHERE c2 = 0")
    dead = alive & (state["c2"] == 0)
    assert res["rows_deleted"] == int(dead.sum()), res
    alive &= ~dead
    steps["delete"].update(check("delete"))

    # merge_into: half the source rows update live ids, half are new ids
    rng = np.random.default_rng(19)
    half = SQL_MERGE_ROWS // 2
    matched = np.sort(rng.choice(np.flatnonzero(alive), half, replace=False))
    new_ids = N_ROWS + np.arange(half, dtype=np.int64)
    src_ids = np.concatenate([matched, new_ids])
    src = table_values(src_ids, upsert=True)
    src["s1"] = np.array([f"merged-{i}" for i in range(SQL_MERGE_ROWS)], dtype=object)
    schema = build_schema(pt)
    src_table = cat.create_table("sql.src", schema, primary_keys=["id"], options=dict(BENCH_OPTIONS))
    wb = src_table.new_batch_write_builder()
    w = wb.new_write()
    w.write(src)
    wb.new_commit().commit(w.prepare_commit())
    res, steps["merge_into"] = sql_run(hk, cat, (
        "CALL sys.merge_into(target_table => 'sql.c4', source_table => 'sql.src', "
        "merge_condition => 'c4.id = src.id', matched_upsert_setting => '*', not_matched_insert_values => '*')"))
    assert res == {"rows_updated": half, "rows_deleted": 0, "rows_inserted": half}, res
    for k in cols:
        state[k] = np.concatenate([state[k], src[k][half:]])
        state[k][matched] = src[k][:half]
    alive = np.concatenate([alive, np.ones(half, np.bool_)])
    steps["merge_into"].update(check("merge_into"))

    res, steps["compact"] = sql_run(hk, cat, "CALL sys.compact(`table` => 'sql.c4', `full` => true)")
    assert res == {"compacted": True, "full": True}, res
    steps["compact"].update(check("compact"))
    res, steps["analyze"] = sql_run(hk, cat, "ANALYZE TABLE sql.c4 COMPUTE STATISTICS FOR ALL COLUMNS")
    assert res["rows"] == int(alive.sum()) and res["columns"] == sorted(cols), res
    snaps, steps["snapshots"] = sql_run(hk, cat, "SELECT snapshot_id, commit_kind, total_record_count "
                                                 "FROM sql.c4$snapshots")
    kinds = snaps.column("commit_kind").to_pylist()
    assert kinds[-2:] == ["COMPACT", "ANALYZE"] and snaps.column("snapshot_id").to_pylist() == \
        list(range(1, len(kinds) + 1)), kinds
    steps["snapshots"]["commit_kinds"] = kinds
    files, steps["files"] = sql_run(hk, cat, "SELECT level, count(*), sum(record_count) FROM sql.c4$files "
                                             "GROUP BY level")
    assert files.column("sum(record_count)").to_pylist() == [int(alive.sum())], files.to_pylist()
    steps["files"]["levels"] = files.to_pylist()
    res, steps["truncate"] = sql_run(hk, cat, "TRUNCATE TABLE sql.c4")
    alive[:] = False
    steps["truncate"].update(check("truncate"))
    return steps


def sql_phase(pt, hk, warehouse: str, table, up, checked: tuple) -> dict:
    """The SQL surface through paimon_tpu_torch.sql.execute on the card, one
    line per part: select (the bench table), join (the lookups phase's star
    schema) and dml. K1, K2 and segment_sum must each launch in the phase;
    K1 and K2 are then held exactly to their plain versions at the phase's
    shapes no earlier check covered. Launch counts are zeroed before it."""
    from paimon_tpu_torch.catalog import FileSystemCatalog
    from paimon_tpu_torch.metrics import sql_metrics

    cat = FileSystemCatalog(warehouse, commit_user="chip_smoke", device=DEVICE)
    hk.reset_launches()
    rows0 = sql_metrics().counter("rows_reduced_device").count
    parts, seconds = {}, {}
    with ShapeRecorder(hk) as recorder:
        for name, run in (("select", lambda: sql_select_part(pt, hk, cat, table, up)),
                          ("join", lambda: sql_join_part(pt, hk, cat)),
                          ("dml", lambda: sql_dml_part(pt, hk, cat, up))):
            before = dict(hk.launches)
            t0 = time.perf_counter()
            parts[name] = {"statements": run()}
            seconds[name] = parts[name]["part_s"] = round(time.perf_counter() - t0, 3)
            parts[name]["part_launches"] = launch_diff(hk, before)
            emit({"phase": "sql", "part": name, **parts[name]})
    launches = dict(hk.launches)
    assert all(launches[k] > 0 for k in hk.launches), f"a kernel never launched in the sql phase: {launches}"
    return {"select_star_output_rows_per_s": parts["select"]["statements"]["star"]["output_rows_per_s"],
            "launches": launches, "launches_by_part": {n: p["part_launches"] for n, p in parts.items()},
            "seconds_by_part": seconds, "rows_reduced_device": sql_metrics().counter("rows_reduced_device").count
            - rows0, "shape_checks": path_shape_checks(hk, recorder, torch.device(DEVICE), 2033, checked)}


# ---------------------------------------------------------------------------
# the dictionary-code domain (merge.dict-domain): the schemas and workloads
# of benchmarks/dict_domain_bench.py:37-101 and :161-260 on the card
# ---------------------------------------------------------------------------

DD_HEAVY_ROWS = 1_000_000  # dict_heavy at the bench table's size
DD_ROWS = 400_000  # mixed and non_dict at the bench's own N_ROWS
DD_RUNS = 4
DD_REPEATS = 3
DD_BASE = {"bucket": "1", "write-only": "true", "sort-engine": "pallas", "cache.data-file.max-memory-size": "0 b"}
DD_COUNTERS = ("pools_unified", "codes_remapped", "rows_code_domain", "fallback_expanded")
DD_WIDTHS = range(1, 33)


def dd_schemas(pt) -> dict:
    """(schema, primary keys, sort-compact columns) per kind, as the bench
    defines them."""
    return {
        "dict_heavy": (pt.RowType.of(("k", pt.BIGINT(False)), ("cat", pt.STRING(False)), ("s1", pt.STRING()),
                                     ("s2", pt.STRING()), ("s3", pt.STRING()), ("s4", pt.STRING())),
                       ["k", "cat"], ["cat", "s1"]),
        "mixed": (pt.RowType.of(("k", pt.BIGINT(False)), ("s1", pt.STRING()), ("s2", pt.STRING()),
                                ("v1", pt.BIGINT()), ("v2", pt.DOUBLE())), ["k"], ["s1", "v1"]),
        "non_dict": (pt.RowType.of(("k", pt.BIGINT(False)), ("v1", pt.BIGINT()), ("v2", pt.DOUBLE())),
                     ["k"], ["v1"]),
    }


def dd_rows(kind: str, n: int, rng) -> dict:
    """One commit's rows of the bench's generator (k drawn from [0, 2n))."""
    def labels(prefix: str, width: int, count: int):
        return np.array([f"{prefix}-{int(x):0{width}d}" for x in rng.integers(0, count, n)], dtype=object)

    k = rng.integers(0, n * 2, n).astype(np.int64)
    if kind == "dict_heavy":
        return {"k": k, "cat": labels("category", 3, 200), "s1": labels("city", 4, 800),
                "s2": labels("status", 2, 12), "s3": labels("device", 3, 300), "s4": labels("plan", 2, 40)}
    if kind == "mixed":
        return {"k": k, "s1": labels("region", 3, 100), "s2": labels("tag", 2, 30),
                "v1": rng.integers(0, 1 << 40, n).astype(np.int64), "v2": rng.random(n)}
    return {"k": k, "v1": rng.integers(0, 1 << 40, n).astype(np.int64), "v2": rng.random(n)}


def dd_write(table, kind: str, n: int, runs: int) -> float:
    rng = np.random.default_rng(7)
    t0 = time.perf_counter()
    for _ in range(runs):
        wb = table.new_batch_write_builder()
        w = wb.new_write()
        w.write(dd_rows(kind, n // runs, rng))
        wb.new_commit().commit(w.prepare_commit())
    return time.perf_counter() - t0


def dd_counters() -> dict:
    from paimon_tpu_torch.metrics import dict_metrics

    return {k: dict_metrics().counter(k).count for k in DD_COUNTERS}


def dd_same(a, b, what: str) -> None:
    """Two batches equal column by column (validity, then the valid values);
    a code-backed column expands here, outside every timed region."""
    assert a.schema.field_names == b.schema.field_names and a.num_rows == b.num_rows, what
    for name in a.schema.field_names:
        x, y = a.column(name), b.column(name)
        ok = x.valid_mask()
        assert np.array_equal(ok, y.valid_mask()), f"{what}: validity of {name} differs"
        assert np.array_equal(x.values[ok], y.values[ok]), f"{what}: column {name} differs"


def dd_coded(batch) -> list:
    return [n for n in batch.schema.field_names if batch.column(n).is_code_backed]


def dd_stages(table, keys: list, tile_rows: int) -> dict:
    """One keys-only merge read split as the strings phase splits it, with
    the key lanes' and the decode stages' shares."""
    out = layer_breakdown(table, tile_rows, tuple(keys), None)
    ms = out["ms"]
    lanes = ms.get("pool_and_ranks", ms.get("encode_lanes"))
    return {**out, "key_lane_share": round(lanes / sum(ms.values()), 4),
            "decode_share": round((ms["decode_keys"] + ms["decode_values"]) / sum(ms.values()), 4)}


def dd_workload(hk, run, rows: int) -> dict:
    """One timed run: seconds, rows/s, the dict counters and the kernels'
    launches it made."""
    c0, l0 = dd_counters(), dict(hk.launches)
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    return {"s": round(s, 4), "rows_per_s": round(rows / s, 1),
            "dict": {k: v - c0[k] for k, v in dd_counters().items()}, "launches": launch_diff(hk, l0)}, out


def dd_schema_part(pt, hk, cat, kind: str) -> dict:
    """One schema: the merge read at both tiles, the full-compaction rewrite
    and the sort-compact of an append table, each with merge.dict-domain on
    and off, each result held to the option-off result and a
    sort-engine=numpy read; the rewritten files re-read with the option
    off."""
    schema, keys, sort_cols = dd_schemas(pt)[kind]
    n = DD_HEAVY_ROWS if kind == "dict_heavy" else DD_ROWS
    base = cat.create_table(f"dd.{kind}", schema, primary_keys=keys, options=DD_BASE)
    write_s = dd_write(base, kind, n, DD_RUNS)
    reference = read_all(base.copy({"sort-engine": "numpy"}))
    rows = reference.num_rows
    reads = {}
    for tier, opts in (("default_tile", {}), (f"tile_{K1_TILE_ROWS}", {"merge.read-batch-rows": str(K1_TILE_ROWS)})):
        for dd in ("on", "off"):
            view = base.copy({**opts, "merge.dict-domain": "true" if dd == "on" else "false"})
            samples, stats = [], None
            for _ in range(DD_REPEATS):
                stats, out = dd_workload(hk, lambda: read_all(view), rows)
                samples.append(stats["s"])
            coded = dd_coded(out)
            dd_same(out, reference, f"{kind} {tier} {dd}")
            reads[f"{tier}_{dd}"] = {"samples_s": samples, "rows_per_s_median": round(rows / float(np.median(samples)), 1),
                                     "dict_last_read": stats["dict"], "launches_last_read": stats["launches"],
                                     "coded_columns": coded}
    kernel = {"default_tile": "keep_last_mask", f"tile_{K1_TILE_ROWS}": "sort_segments"}
    for tier, name in kernel.items():
        assert reads[f"{tier}_on"]["launches_last_read"][name] > 0, f"{kind}: {name} never launched at {tier}"
    for tier in kernel:
        got = reads[f"{tier}_on"]["dict_last_read"]["rows_code_domain"]
        assert (got > 0) == (kind != "non_dict"), f"{kind} {tier}: rows_code_domain {got}"
        assert reads[f"{tier}_off"]["dict_last_read"]["rows_code_domain"] == 0, f"{kind} {tier}: off read coded rows"
    stages = {f"{tier}_{dd}": dd_stages(base.copy({"merge.dict-domain": "true" if dd == "on" else "false"}), keys, t)
              for tier, t in (("default_tile", 8 << 20), (f"tile_{K1_TILE_ROWS}", K1_TILE_ROWS)) for dd in ("on", "off")}
    # the full-compaction rewrite, one copy of the table per option
    compaction = {}
    for dd in ("on", "off"):
        name = f"dd.{kind}_compact_{dd}"
        shutil.copytree(base.path, cat.table_path(name))
        t = cat.get_table(name).copy({"write-only": "false", "merge.dict-domain": "true" if dd == "on" else "false"})

        def rewrite():
            wb = t.new_batch_write_builder()
            w = wb.new_write()
            w.compact(full=True)
            wb.new_commit().commit(w.prepare_commit())

        compaction[dd], _ = dd_workload(hk, rewrite, rows)
        after = cat.get_table(name).copy({"merge.dict-domain": "false"})
        assert len(after.store.restore_files((), 0)) >= 1
        dd_same(read_all(after), reference, f"{kind} compaction {dd}, re-read off")
        dd_same(read_all(after.copy({"sort-engine": "numpy"})), reference, f"{kind} compaction {dd}, numpy")
    # sort-compact of an append table at n / 2 rows in 2 commits
    append = cat.create_table(f"dd.{kind}_append", schema, options=DD_BASE)
    dd_write(append, kind, n // 2, 2)
    sorted_views, sort_compact_rows = {}, {}
    for dd in ("on", "off"):
        from paimon_tpu_torch.table.sort_compact import sort_compact

        name = f"dd.{kind}_append_{dd}"
        shutil.copytree(append.path, cat.table_path(name))
        t = cat.get_table(name).copy({"merge.dict-domain": "true" if dd == "on" else "false"})
        sort_compact_rows[dd], total = dd_workload(hk, lambda: sort_compact(t, sort_cols, order="order"), n // 2)
        assert total == n // 2, total
        sorted_views[dd] = read_all(cat.get_table(name).copy({"merge.dict-domain": "false"}))
    dd_same(sorted_views["on"], sorted_views["off"], f"{kind} sort-compact on vs off")
    dd_same(read_all(cat.get_table(f"dd.{kind}_append_on").copy({"sort-engine": "numpy"})), sorted_views["off"],
            f"{kind} sort-compact numpy read")
    speed = {w: round(r["on"]["rows_per_s"] / r["off"]["rows_per_s"], 3)
             for w, r in (("compaction", compaction), ("sort_compact", sort_compact_rows))}
    for tier in kernel:
        speed[f"read_{tier}"] = round(reads[f"{tier}_on"]["rows_per_s_median"] / reads[f"{tier}_off"]["rows_per_s_median"], 3)
    return {"rows": n, "runs": DD_RUNS, "keys": keys, "sort_columns": sort_cols, "options": DD_BASE,
            "write_s": round(write_s, 3), "merge_read": reads, "stages": stages, "compaction": compaction,
            "sort_compact": sort_compact_rows, "on_over_off": speed, "equal_to_off_and_numpy": True}


def dd_star_part(hk, cat, value_path_ms: dict) -> dict:
    """The lookups phase's star schema read with merge.dict-domain=true: one
    auto join per skew beside the value path's, pairs equal to a host dict
    loop's."""
    from paimon_tpu_torch.metrics import join_metrics
    from paimon_tpu_torch.ops.join import join_batches

    on = {"merge.dict-domain": "true", "cache.data-file.max-memory-size": "0 b"}
    t0 = time.perf_counter()
    dim = read_all(cat.get_table("lookups.dim").copy(on))
    fact = read_all(cat.get_table("lookups.fact").copy(on))
    read_s = time.perf_counter() - t0
    coded = {"dim": dd_coded(dim), "fact": dd_coded(fact)}

    def plain(col) -> list:
        """A column's values without expanding it in place."""
        if col.is_code_backed:
            pool, codes = col.dict_cache
            return pool.take(codes).tolist()
        return col.values.tolist()

    pos = {c: j for j, c in enumerate(plain(dim.column("cid")))}
    joins = {}
    for skew in J_SKEWS:
        col = f"cust_{skew}"
        rt = np.fromiter((pos.get(c, -1) for c in plain(fact.column(col))), np.int64, fact.num_rows)
        lt = np.flatnonzero(rt >= 0)
        j0, l0 = join_metrics().counter("code_domain_joins").count, dict(hk.launches)
        t0 = time.perf_counter()
        res = join_batches(fact, dim, [col], ["cid"], options={"sort-engine": "pallas", **on}, device=DEVICE)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        assert np.array_equal(res.left_take, lt) and np.array_equal(res.right_take, rt[lt]), \
            f"{skew}: code-domain pairs differ from the host dict loop"
        joins[skew] = {"ms": round(ms, 3), "value_path_ms": value_path_ms.get(skew), "pairs": int(len(lt)),
                       "code_domain_joins": join_metrics().counter("code_domain_joins").count - j0,
                       "code_domain_cols": res.stats["code_domain_cols"], "algorithm": res.stats["algorithm"],
                       "engine": res.stats["engine"], "launches": launch_diff(hk, l0)}
    return {"read_s_on": round(read_s, 3), "coded_columns": coded, "joins": joins,
            "dimension_rows": dim.num_rows, "fact_rows": fact.num_rows, "equal_to_dict_loop": True,
            "note": "value_path_ms: the lookups phase's auto join, before its 1,000 dimension changes"}


def dd_torch_ops_part(pt, hk, cat) -> dict:
    """The torch twins of the JAX package's XLA programs on the card, held
    exactly to their numpy twins at bit widths 1-32 and the page sizes of
    this phase's files; dict_heavy read once under the torch decode engine
    and its merged rows written once under the torch encode engine, each
    equal to the numpy engine's."""
    from paimon_tpu_torch.decode import kernels as dk
    from paimon_tpu_torch.encode import kernels as ek
    from paimon_tpu_torch.format.parquet import write_parquet

    rng = np.random.default_rng(2035)
    dev = torch.device(DEVICE)
    checks = 0
    for w in DD_WIDTHS:
        # values a 1 MiB page holds at this width, as the writer sizes pages
        per_page = min((int((1 << 20) / (max(w, 1) / 8 + 0.125)) // 8) * 8, DD_HEAVY_ROWS)
        for count in (8, 1000, per_page):
            vals = rng.integers(0, 1 << w, count, dtype=np.uint64)
            packed = ek.pack_bits(vals, w)
            twin = ek.pack_bits_torch(torch.from_numpy(vals.astype(np.int64)).to(dev), w)
            assert twin.cpu().numpy().tobytes() == packed, f"pack_bits_torch differs at width {w}, {count} values"
            raw = np.frombuffer(packed, dtype=np.uint8)
            got = dk.unpack_bits_torch(torch.from_numpy(raw.copy()).to(dev), w, count).cpu().numpy()
            assert np.array_equal(got, dk.unpack_bits(raw, w, count)), f"unpack_bits_torch differs at width {w}"
            checks += 2
    for size in (1, 12, 40, 200, 800, 1 << 16):
        for dtype in (np.int32, np.int64):
            dictionary = rng.integers(-(1 << 30), 1 << 30, size).astype(dtype)
            codes = rng.integers(0, size, DD_HEAVY_ROWS // 4)
            got = dk.gather_torch(torch.from_numpy(dictionary).to(dev), torch.from_numpy(codes).to(dev))
            assert np.array_equal(got.cpu().numpy(), dictionary.take(codes)), f"gather_torch differs at {size}"
            checks += 1
    # each op's device and host ms per call at a page of 10-bit codes
    w, count = 10, (int((1 << 20) / (10 / 8 + 0.125)) // 8) * 8
    vals = torch.from_numpy(rng.integers(0, 1 << w, count).astype(np.int64)).to(dev)
    raw = ek.pack_bits_torch(vals, w)
    dictionary = torch.from_numpy(rng.integers(0, 1 << 30, 1 << w).astype(np.int64)).to(dev)
    ops = {"pack_bits_torch": lambda: ek.pack_bits_torch(vals, w),
           "unpack_bits_torch": lambda: dk.unpack_bits_torch(raw, w, count),
           "gather_torch": lambda: dk.gather_torch(dictionary, vals)}
    timing = {name: {"shape": [w, count], "device_ms": device_ms(fn, {"ms": ""})["ms"], "host_ms_per_call": host_ms(fn),
                     "events_ms": round(cuda_ms(fn, iters=20, warmup=3), 5)} for name, fn in ops.items()}
    # dict_heavy through the torch engines
    table = cat.get_table("dd.dict_heavy").copy({"merge.dict-domain": "true"})
    want = read_all(table)
    dk.set_decode_engine("torch", DEVICE)
    try:
        t0 = time.perf_counter()
        got = read_all(table)
        torch_read_s = time.perf_counter() - t0
    finally:
        dk.set_decode_engine("numpy")
    t0 = time.perf_counter()
    numpy_bytes = write_parquet(want, "zstd")
    numpy_write_s = time.perf_counter() - t0
    ek.set_encode_engine("torch", DEVICE)
    try:
        t0 = time.perf_counter()
        torch_bytes = write_parquet(want, "zstd")
        torch_write_s = time.perf_counter() - t0
    finally:
        ek.set_encode_engine("numpy")
    assert torch_bytes == numpy_bytes, "the torch encode engine wrote other bytes"
    dd_same(got, want, "dict_heavy read under the torch decode engine")
    return {"exact_checks": checks, "widths": [1, 32], "ops": timing,
            "dict_heavy_read_s": {"torch_engine": round(torch_read_s, 3)},
            "dict_heavy_write_s": {"numpy_engine": round(numpy_write_s, 3), "torch_engine": round(torch_write_s, 3)},
            "file_bytes": len(numpy_bytes), "equal_to_numpy_engines": True}


def dict_domain_phase(pt, hk, warehouse: str, value_path_ms: dict, checked: tuple) -> dict:
    """merge.dict-domain on the card, one line per part: dict_heavy, mixed
    and non_dict (the merge read at both tiles, the compaction rewrite, the
    sort-compact; on and off), the star join read with the option on, and
    the torch twins. K1 and K2 must launch on the code lanes; both are then
    held exactly to their plain versions at the phase's shapes no earlier
    check covered. Launch counts are zeroed before it."""
    from paimon_tpu_torch.catalog import FileSystemCatalog

    cat = FileSystemCatalog(warehouse, commit_user="chip_smoke", device=DEVICE)
    hk.reset_launches()
    parts, seconds = {}, {}
    with ShapeRecorder(hk) as recorder:
        for name, run in (("dict_heavy", lambda: dd_schema_part(pt, hk, cat, "dict_heavy")),
                          ("mixed", lambda: dd_schema_part(pt, hk, cat, "mixed")),
                          ("non_dict", lambda: dd_schema_part(pt, hk, cat, "non_dict")),
                          ("star_join", lambda: dd_star_part(hk, cat, value_path_ms)),
                          ("torch_ops", lambda: dd_torch_ops_part(pt, hk, cat))):
            before = dict(hk.launches)
            t0 = time.perf_counter()
            parts[name] = run()
            seconds[name] = parts[name]["part_s"] = round(time.perf_counter() - t0, 3)
            parts[name]["part_launches"] = launch_diff(hk, before)
            emit({"phase": "dict_domain", "part": name, **parts[name]})
    launches = dict(hk.launches)
    for k in K1_K2:
        assert launches[k] > 0, f"{k} never launched in the dict_domain phase: {launches}"
    heavy = parts["dict_heavy"]["merge_read"]
    return {"dict_heavy_read_rows_per_s": {k: v["rows_per_s_median"] for k, v in heavy.items()},
            "launches": launches, "launches_by_part": {n: p["part_launches"] for n, p in parts.items()},
            "seconds_by_part": seconds, "cuts": [],
            "shape_checks": path_shape_checks(hk, recorder, torch.device(DEVICE), 2034, checked)}


# ---------------------------------------------------------------------------
# the write-buffer surface and the reference's other files: admission
# control over the offloaded flush, Avro data files and manifests, snappy
# and gzip pages, _KEY_ columns, the spilling append buffer, null partitions
# ---------------------------------------------------------------------------

BF_BATCH_ROWS = 50_000  # rows per write of the throttled ingest and the spilled log
BF_SPILL_ROWS = 262_144  # write-buffer-spill.rows of the spilled append table
BF_NULL_SHARE = 0.05  # null dt and null h partition values
BF_FORMATS = {
    "parquet_snappy": {"file.compression": "snappy", "manifest.format": "avro"},
    "parquet_gzip": {"file.compression": "gzip", "manifest.format": "avro"},
    "avro": {"file.format": "avro", "manifest.format": "avro"},
    "orc_zstd": {"file.format": "orc", "manifest.format": "avro"},
    "orc_lz4": {"file.format": "orc", "file.compression": "lz4", "manifest.format": "avro"},
    "parquet_lz4": {"file.compression": "lz4", "manifest.format": "avro"},
}


def bench_runs_and_upsert() -> tuple[list, np.ndarray]:
    """build_table's four sorted runs of the seed-7 permutation and its
    seed-8 upsert ids."""
    ids = np.random.default_rng(7).permutation(N_ROWS).astype(np.int64)
    per = N_ROWS // N_RUNS
    up = np.random.default_rng(8).choice(N_ROWS, N_UPSERT, replace=False).astype(np.int64)
    return [np.sort(ids[r * per : (r + 1) * per]) for r in range(N_RUNS)], up


def throttled_part(pt, hk, cat, control) -> dict:
    """The bench table's ingest (the same runs and upsert) in 50,000-row
    writes under write.buffer.max-memory at a quarter of the ingest's
    buffered bytes: writes throttle while the paimon-flush worker encodes,
    none is rejected, every reserved byte comes back, and the rows equal
    the unthrottled table's."""
    from paimon_tpu_torch.core.kv import KVBatch
    from paimon_tpu_torch.data.batch import ColumnBatch
    from paimon_tpu_torch.metrics import soak_metrics

    runs, up = bench_runs_and_upsert()
    schema = build_schema(pt)
    first = KVBatch.from_rows(ColumnBatch.from_pydict(schema, table_values(runs[0][:BF_BATCH_ROWS], False)), 0)
    ingest = first.byte_size() * (N_ROWS + N_UPSERT) // BF_BATCH_ROWS
    cap = ingest // 4
    opts = {"write.buffer.max-memory": f"{cap} b", "write.buffer.block-timeout": "60 s"}
    table = cat.create_table("buffers.throttled", schema, primary_keys=["id"], options={**BENCH_OPTIONS, **opts})
    g = soak_metrics()
    throttled0, rejected0 = g.counter("writes_throttled").count, g.counter("writes_rejected").count
    blocked0 = g.histogram("backpressure_ms").count
    health = []
    t0 = time.perf_counter()
    for r, run_ids in enumerate(runs + [up]):
        wb = table.new_batch_write_builder()
        w = wb.new_write()
        for s in range(0, len(run_ids), BF_BATCH_ROWS):
            w.write(table_values(run_ids[s : s + BF_BATCH_ROWS], upsert=r == N_RUNS))
        wb.new_commit().commit(w.prepare_commit())
        health.append(w.health())
        assert w.admission.in_use == 0, f"commit {r + 1} left {w.admission.in_use} bytes reserved"
        w.close()
    torch.cuda.synchronize()
    write_s = time.perf_counter() - t0
    throttled = g.counter("writes_throttled").count - throttled0
    rejected = g.counter("writes_rejected").count - rejected0
    assert throttled > 0 and rejected == 0, (throttled, rejected)
    out, samples = timed_reads(table, 2)
    check_output(out, control, up, "throttled ingest")
    check_output(read_all(table.copy({"sort-engine": "numpy"})), control, up, "throttled ingest, numpy engine")
    return {
        "options": opts, "ingest_bytes_estimate": int(ingest), "max_memory": int(cap),
        "stop_trigger_bytes": health[0]["stop_trigger_bytes"], "batch_rows": BF_BATCH_ROWS,
        "write_s": round(write_s, 4), "writes_throttled": throttled, "writes_rejected": rejected,
        "backpressure_blocks": g.histogram("backpressure_ms").count - blocked0,
        "backpressure_ms_per_commit": [h["backpressure_ms"] for h in health],
        "files": len(live_files(table)), "read": read_stats(samples), "equal_to_unthrottled_table": True,
        "equal_to_numpy_engine": True}


def is_avro(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(4) == b"Obj\x01"


def format_part(pt, hk, cat, warehouse: str, control, label: str, options: dict) -> dict:
    """The bench table under `options` (build_table: four runs and the
    upsert), its files and manifests checked to be what the options name,
    read twice with sort-engine=pallas at the default tile (K2) and once at
    131072 (K1), and once with numpy, each equal to the oracle and to the
    zstd table's rows, and one staged read (decode, lanes, merge, gather;
    the decompression apart, for parquet and ORC)."""
    from paimon_tpu_torch.decode.container import CODEC_NAMES, parse_footer
    from paimon_tpu_torch.format.orc_meta import read_tail

    table, up, write_s = build_table(pt, warehouse, f"bf_{label}", options)
    torch.cuda.synchronize()
    files = [f"{table.path}/bucket-0/{f.file_name}" for f in live_files(table)]
    manifests = [os.path.join(table.path, "manifest", n) for n in os.listdir(f"{table.path}/manifest")]
    assert manifests and all(is_avro(m) for m in manifests), "a manifest is not Avro"
    fmt = options.get("file.format", "parquet")
    codecs, stripes = set(), 0
    for path in files:
        assert path.endswith(f".{fmt}"), path
        if fmt == "avro":
            assert is_avro(path), path
            continue
        with open(path, "rb") as f:
            raw = f.read()
        if fmt == "orc":
            tail = read_tail(raw)
            codecs.add(tail.compression)
            stripes += tail.nstripes
        else:
            codecs |= {CODEC_NAMES.get(c.codec, "none") for _, cols in parse_footer(raw) for c in cols.values()}
    if fmt != "avro":
        want = options.get("file.compression", "zstd")
        assert codecs == {{"lz4": "lz4_raw"}.get(want, want) if fmt == "parquet" else want}, codecs
    out, samples = timed_reads(table, 2)
    check_output(out, control, up, label)
    k1_out, k1_samples = timed_reads(table.copy({"merge.read-batch-rows": str(K1_TILE_ROWS)}), 1)
    check_output(k1_out, control, up, f"{label} at tile {K1_TILE_ROWS}")
    numpy_out, numpy_s = timed_reads(table.copy({"sort-engine": "numpy"}), 1)
    check_output(numpy_out, control, up, f"{label}, numpy engine")
    result = {"options": options, "write_s": round(write_s, 4), "files": len(files), "manifests": len(manifests),
              "page_codecs": sorted(codecs), "bytes_on_disk": sum(os.path.getsize(p) for p in files),
              "read": read_stats(samples), "k1_tile_read": read_stats(k1_samples),
              "numpy_read_s": round(numpy_s[0], 4),
              # without the data-file cache, which holds what the reads above decoded
              "stages": layer_breakdown(table.copy({"cache.data-file.max-memory-size": "0 b"}), 8 << 20, rows=N_ROWS),
              "equal_to_numpy_engine": True, "equal_to_oracle": True}
    if fmt == "orc":
        result["orc_stripes"] = stripes
    return result


def key_columns_part(pt, hk, cat, warehouse: str, control) -> dict:
    """data-file.include-key-columns=true on the bench table: every data
    file leads with _KEY_id, the reads (pallas twice, numpy once) equal the
    oracle, and the key stats are the id column's."""
    from paimon_tpu_torch.decode.container import parse_footer

    table, up, write_s = build_table(pt, warehouse, "bf_key_columns", {"data-file.include-key-columns": "true"})
    entries = table.store.new_scan().plan().entries
    for e in entries:
        with open(f"{table.path}/bucket-0/{e.file.file_name}", "rb") as f:
            names = list(parse_footer(f.read())[0][1])
        assert names[:3] == ["_KEY_id", "_SEQUENCE_NUMBER", "_VALUE_KIND"], names
        assert list(e.file.key_stats) == ["id"] and e.file.key_stats["id"].min == e.file.min_key[0]
    out, samples = timed_reads(table, 2)
    check_output(out, control, up, "key columns")
    check_output(read_all(table.copy({"sort-engine": "numpy"})), control, up, "key columns, numpy engine")
    return {"write_s": round(write_s, 4), "files": len(entries), "leading_columns": names[:3],
            "read": read_stats(samples), "equal_to_numpy_engine": True, "equal_to_oracle": True}


def spill_part(pt, hk, cat) -> dict:
    """A 1M-row append table (the bench schema, no primary key, bucket 1)
    written in one commit of 50,000-row writes under write-buffer-spillable
    with write-buffer-spill.rows 262,144: the writer spills segments to
    local disk and, when the buffer reaches write-buffer-rows (1M, the last
    write), streams them to files. Bytes spilled, the files' rows, and
    every row read back in written order. No merge runs, so no kernel may
    launch."""
    before = dict(hk.launches)
    opts = {"bucket": "1", "write-only": "true", "write-buffer-spillable": "true",
            "write-buffer-spill.rows": str(BF_SPILL_ROWS)}
    table = cat.create_table("buffers.spill_log", build_schema(pt), options=opts)
    ids = np.random.default_rng(7).permutation(N_ROWS).astype(np.int64)
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    t0 = time.perf_counter()
    for s in range(0, N_ROWS, BF_BATCH_ROWS):
        w.write(table_values(ids[s : s + BF_BATCH_ROWS], False))
    write_s = time.perf_counter() - t0
    (writer,) = w._writers.values()
    spilled = writer.spilled_bytes_total
    t0 = time.perf_counter()
    wb.new_commit().commit(w.prepare_commit())
    commit_s = time.perf_counter() - t0
    w.close()
    assert spilled > 0, "the append buffer never spilled"
    got = read_all(table)
    assert np.array_equal(got.column("id").values, ids), "spilled log: rows out of written order"
    want = table_values(ids, False)
    for name in ("c1", "c2", "c3", "d1", "d2", "s1", "s2"):
        assert np.array_equal(got.column(name).values, want[name]), f"spilled log: {name} differs"
    launches = launch_diff(hk, before)
    assert not any(launches.values()), f"the append path launched a kernel: {launches}"
    return {"options": opts, "rows": int(got.num_rows), "bytes_spilled": int(spilled),
            "files_rows": [f.row_count for f in sorted(live_files(table), key=lambda f: f.min_sequence_number)],
            "write_s": round(write_s, 4), "commit_s": round(commit_s, 4), "rows_in_written_order": True}


def null_partition_values(ids: np.ndarray, upsert: bool, null_dt: np.ndarray, null_h: np.ndarray) -> dict:
    dt = P_DTS[ids % len(P_DTS)].copy()
    dt[null_dt[ids]] = None
    h = [None if n else int(v) for v, n in zip(ids % 3, null_h[ids])]
    return {"dt": dt, "h": h, **table_values(ids, upsert)}


def null_partitions_part(pt, hk, cat) -> dict:
    """The bench table partitioned by dt STRING (4 days) and h INT (3
    values), each null for a seeded 5% of the ids, bucket 2: 1M rows and
    the 100k upsert, read (pallas and numpy) against the oracle row by row;
    the null values land in partition.default-name directories, and a
    partition filter on dt IS NULL plans only those partitions."""
    from paimon_tpu_torch.data.predicate import is_null

    rng = np.random.default_rng(13)
    null_dt, null_h = rng.random(N_ROWS) < BF_NULL_SHARE, rng.random(N_ROWS) < BF_NULL_SHARE
    schema = pt.RowType.of(("dt", pt.STRING()), ("h", pt.INT()), *[(f.name, f.type) for f in build_schema(pt).fields])
    table = cat.create_table("buffers.null_parts", schema, partition_keys=["dt", "h"], primary_keys=["dt", "h", "id"],
                             options={**BENCH_OPTIONS, "bucket": "2"})
    ids = np.random.default_rng(7).permutation(N_ROWS).astype(np.int64)
    up = np.random.default_rng(8).choice(N_ROWS, N_UPSERT, replace=False).astype(np.int64)
    t0 = time.perf_counter()
    for batch_ids, upsert in ((ids, False), (up, True)):
        wb = table.new_batch_write_builder()
        w = wb.new_write()
        w.write(null_partition_values(batch_ids, upsert, null_dt, null_h))
        wb.new_commit().commit(w.prepare_commit())
    torch.cuda.synchronize()
    write_s = time.perf_counter() - t0
    out, samples = timed_reads(table, 2)
    same_rows(out, read_all(table.copy({"sort-engine": "numpy"})), "null partitions against the numpy engine")
    order = np.argsort(out.column("id").values, kind="stable")
    got = out.take(order)
    all_ids = np.arange(N_ROWS, dtype=np.int64)
    assert np.array_equal(got.column("id").values, all_ids), "null partitions: ids are not the key range"
    want_old, want_new = null_partition_values(all_ids, False, null_dt, null_h), table_values(all_ids, True)
    is_up = np.zeros(N_ROWS, np.bool_)
    is_up[up] = True
    assert np.array_equal(got.column("dt").valid_mask(), ~null_dt), "null partitions: dt nulls differ"
    assert np.array_equal(got.column("h").valid_mask(), ~null_h), "null partitions: h nulls differ"
    for name in ("c1", "c2", "c3", "d1", "d2", "s1", "s2"):
        want = np.where(is_up, want_new[name], want_old[name])
        assert np.array_equal(got.column(name).values, want), f"null partitions: {name} differs"
    partitions = set(table.store.new_scan().plan().grouped())
    assert (None, None) in partitions and len(partitions) == (len(P_DTS) + 1) * 4, sorted(partitions, key=str)
    assert os.path.isdir(f"{table.path}/dt=__DEFAULT_PARTITION__/h=__DEFAULT_PARTITION__"), "no default-name directory"
    rb = table.new_read_builder().with_filter(is_null("dt"))
    splits = rb.new_scan().plan()
    assert {s.partition[0] for s in splits} == {None}
    assert rb.new_read().read_all(splits).num_rows == int(null_dt.sum())
    sys_rows = cat.get_table("buffers.null_parts$partitions").to_pylist()
    assert len(sys_rows) == len(partitions) and sum(r[1] for r in sys_rows) > N_ROWS
    return {"partitions": len(partitions), "null_dt_rows": int(null_dt.sum()), "null_h_rows": int(null_h.sum()),
            "write_s": round(write_s, 4), "read": read_stats(samples), "files": len(live_files(table)),
            "equal_to_numpy_engine": True, "equal_to_oracle": True}


def buffers_formats_phase(pt, hk, warehouse: str, control, checked: tuple) -> dict:
    """The write-buffer surface and the reference's Avro, snappy and gzip
    files, one line per part: throttled, parquet_snappy, parquet_gzip,
    avro, key_columns, spill, null_partitions. K1 and K2 must launch in
    the merge parts (the spill part launches nothing); then they are held
    exactly to their plain versions at the phase's shapes no earlier check
    covered. Launch counts are zeroed before it."""
    from paimon_tpu_torch.catalog import FileSystemCatalog

    cat = FileSystemCatalog(warehouse, commit_user="chip_smoke", device=DEVICE)
    hk.reset_launches()
    parts, seconds = {}, {}
    runs = [("throttled", lambda: throttled_part(pt, hk, cat, control))]
    runs += [(label, lambda label=label, o=o: format_part(pt, hk, cat, warehouse, control, label, o))
             for label, o in BF_FORMATS.items()]
    runs += [("key_columns", lambda: key_columns_part(pt, hk, cat, warehouse, control)),
             ("spill", lambda: spill_part(pt, hk, cat)),
             ("null_partitions", lambda: null_partitions_part(pt, hk, cat))]
    with ShapeRecorder(hk) as recorder:
        for name, run in runs:
            before = dict(hk.launches)
            t0 = time.perf_counter()
            parts[name] = run()
            seconds[name] = parts[name]["part_s"] = round(time.perf_counter() - t0, 3)
            parts[name]["part_launches"] = launch_diff(hk, before)
            emit({"phase": "buffers_formats", "part": name, **parts[name]})
    by_part = {name: p["part_launches"] for name, p in parts.items()}
    for name in by_part:
        if name != "spill":  # every flush merges through K1
            assert by_part[name]["sort_segments"] > 0, f"K1 never launched in the {name} part: {by_part[name]}"
    for k in K1_K2:
        assert sum(p[k] for p in by_part.values()) > 0, f"{k} never launched in the buffers_formats phase"
    return {"launches": dict(hk.launches), "launches_by_part": by_part, "seconds_by_part": seconds,
            "reads_rows_per_s": {n: p["read"]["output_rows_per_s_median"] for n, p in parts.items() if "read" in p},
            "stages_ms": {n: parts[n]["stages"]["ms"] for n in BF_FORMATS},
            "shape_checks": path_shape_checks(hk, recorder, torch.device(DEVICE), 2035, checked)}


NS_KEYS = 250_000  # the aggregation table's keys: each commit writes every key once
NS_COMMITS = 4
NS_TAGS, NS_ATTR_KEYS, NS_SKUS = 1_000, 64, 10_000
NS_NULL_SHARE, NS_EMPTY_SHARE = 0.05, 0.05
NS_AGG_OPTIONS = {"bucket": "1", "write-only": "true", "sort-engine": "pallas", "merge-engine": "aggregation",
                  "fields.tags.aggregate-function": "collect", "fields.tags.distinct": "true",
                  "fields.attrs.aggregate-function": "merge_map",
                  "fields.items.aggregate-function": "nested_update", "fields.items.nested-key": "sku",
                  "fields.spend.aggregate-function": "sum"}


def ns_lengths(rng, n: int, most: int) -> tuple:
    """Lengths of n nested values, 1..most, with NS_NULL_SHARE of them null
    and NS_EMPTY_SHARE empty (length 0); and the null mask."""
    r = rng.random(n)
    null = r < NS_NULL_SHARE
    lens = rng.integers(1, most + 1, n)
    lens[r < NS_NULL_SHARE + NS_EMPTY_SHARE] = 0
    return lens, null


def ns_split(flat: list, lens: np.ndarray, null: np.ndarray, make=list) -> np.ndarray:
    """The values of `flat` cut into runs of `lens` (each made by `make`),
    None where null, as an object vector."""
    offs = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    bounds = zip(offs[:-1].tolist(), offs[1:].tolist())
    out = np.fromiter((make(flat[a:b]) for a, b in bounds), dtype=object, count=len(lens))
    out[null] = None
    return out


def ns_tags(rng, n: int) -> np.ndarray:
    lens, null = ns_lengths(rng, n, 4)
    pool = [f"tag-{i:04d}" for i in range(NS_TAGS)]
    return ns_split([pool[i] for i in rng.integers(0, NS_TAGS, int(lens.sum())).tolist()], lens, null)


def ns_attrs(rng, n: int) -> np.ndarray:
    """0-4 distinct keys of NS_ATTR_KEYS per map: a start and an odd
    stride per map walk the keys without repeating."""
    lens, null = ns_lengths(rng, n, 4)
    owner = np.repeat(np.arange(n), lens)
    pos = np.arange(len(owner)) - np.repeat(np.cumsum(lens) - lens, lens)
    start, stride = rng.integers(0, NS_ATTR_KEYS, n), rng.integers(0, NS_ATTR_KEYS // 2, n) * 2 + 1
    keys = (start[owner] + pos * stride[owner]) % NS_ATTR_KEYS
    names = [f"attr-{i:02d}" for i in range(NS_ATTR_KEYS)]
    pairs = list(zip([names[k] for k in keys.tolist()], rng.integers(-1000, 1000, len(owner)).tolist()))
    return ns_split(pairs, lens, null, dict)


def ns_items(rng, n: int) -> np.ndarray:
    lens, null = ns_lengths(rng, n, 3)
    m = int(lens.sum())
    rows = [{"sku": s, "qty": q} for s, q in zip(rng.integers(0, NS_SKUS, m).tolist(), rng.integers(1, 10, m).tolist())]
    return ns_split(rows, lens, null)


def ns_schema(pt, agg: bool):
    from paimon_tpu_torch.types import ArrayType, MapType

    nested = [("tags", ArrayType(pt.STRING())), ("attrs", MapType(pt.STRING(), pt.BIGINT()))]
    if not agg:
        return pt.RowType.of(*[(f.name, f.type) for f in build_schema(pt).fields], *nested)
    item = pt.RowType.of(("sku", pt.BIGINT()), ("qty", pt.INT()))
    return pt.RowType.of(("id", pt.BIGINT(False)), *nested, ("items", ArrayType(item)), ("spend", pt.DOUBLE()))


def ns_write(table, batches: list) -> float:
    t0 = time.perf_counter()
    for data in batches:
        wb = table.new_batch_write_builder()
        w = wb.new_write()
        w.write(data)
        wb.new_commit().commit(w.prepare_commit())
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def ns_agg_batches() -> list:
    """NS_COMMITS commits, each every key once in key order, from seed 21."""
    rng = np.random.default_rng(21)
    ids = np.arange(NS_KEYS, dtype=np.int64)
    return [{"id": ids, "tags": ns_tags(rng, NS_KEYS), "attrs": ns_attrs(rng, NS_KEYS), "items": ns_items(rng, NS_KEYS),
             "spend": rng.integers(0, 4000, NS_KEYS) / 4.0} for _ in range(NS_COMMITS)]


def ns_dedup_options() -> dict:
    """BENCH_OPTIONS (a copy: other phases share the dict) with ORC for the
    level the full compaction writes, num-levels - 1."""
    from paimon_tpu_torch.options import CoreOptions

    return {**BENCH_OPTIONS, "file.format.per.level": f"{CoreOptions(BENCH_OPTIONS).num_levels - 1}:orc"}


def ns_dedup_batches() -> list:
    """build_table's four runs and upsert, with tags and attrs from seed 22."""
    rng = np.random.default_rng(22)
    runs, up = bench_runs_and_upsert()
    return [{**table_values(ids, r == N_RUNS), "tags": ns_tags(rng, len(ids)), "attrs": ns_attrs(rng, len(ids))}
            for r, ids in enumerate(runs + [up])]


def ns_stages(table, agg: bool) -> dict:
    """One merge read of the table's single section, stage by stage (host
    clock, device synchronised at each boundary), without the data-file
    cache: file decode with its nested part split into the leaves' levels
    and the assembly, lane encode, merge (plan, upload, kernel, download),
    then the aggregates column by column (agg) or the winners' gather."""
    from paimon_tpu_torch.core.kv import KVBatch
    from paimon_tpu_torch.core.levels import IntervalPartition
    from paimon_tpu_torch.core.read import order_runs_for_merge
    from paimon_tpu_torch.metrics import decode_metrics
    from paimon_tpu_torch.ops.aggregates import aggregate_merge
    from paimon_tpu_torch.ops.merge import merge_plan

    t = table.copy({"cache.data-file.max-memory-size": "0 b"})
    store = t.store
    (split,) = t.new_read_builder().new_scan().plan()
    rf = store.reader_factory(split.partition, split.bucket)
    (section,) = IntervalPartition(split.files).partition()
    runs, seq_ascending = order_runs_for_merge(section)
    files = [f for run in runs for f in run.files]
    g = decode_metrics()
    levels0, assembly0 = g.counter("levels_us").count, g.counter("assembly_us").count
    ms = {}
    t0 = time.perf_counter()
    kv = KVBatch.concat([rf.read(f, system_columns="kind" if seq_ascending else True) for f in files])
    ms["decode"] = (time.perf_counter() - t0) * 1e3
    ms["decode_nested_levels"] = (g.counter("levels_us").count - levels0) / 1e3
    ms["decode_nested_assembly"] = (g.counter("assembly_us").count - assembly0) / 1e3
    mx = store.merge_executor()
    t0 = time.perf_counter()
    lanes, seq = mx._key_lanes(kv), mx._seq_lanes(kv, seq_ascending)
    ms["encode_lanes"] = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = merge_plan(lanes, seq, compress=mx._compress, engine="pallas", device=DEVICE)
    torch.cuda.synchronize()
    ms["plan_upload_kernel_download"] = (time.perf_counter() - t0) * 1e3
    if agg:
        for f in mx._value_fields():
            t0 = time.perf_counter()
            aggregate_merge(plan, kv.data.column(f.name), mx._agg_spec(f.name), kv.kind, DEVICE)
            torch.cuda.synchronize()
            ms[f"aggregate_{f.name}"] = (time.perf_counter() - t0) * 1e3
        host = sum(ms[f"aggregate_{n}"] for n in ("tags", "attrs", "items"))
        ms["host_aggregate_share_of_read"] = host / sum(v for k, v in ms.items() if not k.startswith("decode_nested"))
    else:
        t0 = time.perf_counter()
        kv.take(plan.perm[plan.keep_last & plan.valid_sorted])
        ms["gather"] = (time.perf_counter() - t0) * 1e3
    return {"files": len(files), "input_rows": kv.num_rows, "m": plan.m,
            "ms": {k: round(v, 3) for k, v in ms.items()}}


def ns_mixed_reads(hk, table, upsert: dict, reference, rows: int) -> dict:
    """The dedup table after its full compaction into ORC: the bench upsert
    committed again (parquet, level 0), then read at the default tile (K2)
    and at K1_TILE_ROWS (K1). Each read merges the ORC run with the parquet
    run and must equal the numpy engine's read of the same table, which
    equals `reference` (the same upsert again changes no row)."""
    orc_bytes = sum(f.file_size for f in live_files(table) if f.file_name.endswith(".orc"))
    write_s = ns_write(table, [upsert])
    formats = sorted(f.file_name.rsplit(".", 1)[1] for f in live_files(table))
    assert formats == ["orc", "parquet"], f"the mixed read's runs: {formats}"
    numpy_out, numpy_s = timed_reads(table.copy({"sort-engine": "numpy"}), 1)
    same_rows(numpy_out, reference, "nested dedup, ORC + parquet runs by the numpy engine, against the first read")
    reads = {}
    for label, opts in (("pallas_default_tile", {}), (f"pallas_tile_{K1_TILE_ROWS}",
                                                      {"merge.read-batch-rows": str(K1_TILE_ROWS)})):
        before = dict(hk.launches)
        out, samples = timed_reads(table.copy(opts), 1)
        same_rows(out, numpy_out, f"nested dedup, ORC + parquet runs, {label} against the numpy engine")
        reads[label] = read_stats(samples, launch_diff(hk, before), rows, rows + len(upsert["id"]))
    assert reads["pallas_default_tile"]["launches"]["keep_last_mask"] > 0, "K2 never launched in the mixed read"
    assert reads[f"pallas_tile_{K1_TILE_ROWS}"]["launches"]["sort_segments"] > 0, "K1 never launched in the mixed read"
    return {"orc_bytes": orc_bytes, "runs": formats, "upsert_write_s": round(write_s, 3),
            "numpy_read_s": round(numpy_s[0], 4), "reads": reads, "equal_to_numpy_engine": True}


def ns_part(pt, hk, cat, warehouse: str, name: str, agg: bool) -> dict:
    """One nested table: written, read at both tiles, staged, compacted and
    read again, every read against the numpy engine's. The dedup table's
    full compaction writes ORC; its upsert is then committed again and the
    ORC and parquet runs read merged (ns_mixed_reads)."""
    batches = ns_agg_batches() if agg else ns_dedup_batches()
    options = NS_AGG_OPTIONS if agg else ns_dedup_options()
    table = cat.create_table(f"nested.{name}", ns_schema(pt, agg), primary_keys=["id"], options=options)
    write_s = ns_write(table, batches)
    upsert = None if agg else batches[-1]
    del batches
    rows, input_rows = (NS_KEYS, NS_KEYS * NS_COMMITS) if agg else (N_ROWS, N_ROWS + N_UPSERT)
    reference, numpy_s = timed_reads(table.copy({"sort-engine": "numpy"}), 1)
    assert reference.num_rows == rows, reference.num_rows
    reads = {}
    for label, opts in (("pallas_default_tile", {}), (f"pallas_tile_{K1_TILE_ROWS}",
                                                      {"merge.read-batch-rows": str(K1_TILE_ROWS)})):
        before = dict(hk.launches)
        # one sample a tile: the phase runs near the end of the call's time
        out, samples = timed_reads(table.copy(opts), 1)
        same_rows(out, reference, f"nested {name}, {label} against the numpy engine")
        reads[label] = read_stats(samples, launch_diff(hk, before), rows, input_rows)
    stages = ns_stages(table, agg)
    nulls = {n: int(reference.column(n).null_count) for n in ("tags", "attrs")}
    empties = {n: int(sum(1 for v in reference.column(n).values if v is not None and len(v) == 0))
               for n in ("tags", "attrs")}
    bytes_before = table_bytes(table)["data_bytes"]
    t0 = time.perf_counter()
    wb = table.copy({"write-only": "false"}).new_batch_write_builder()
    w = wb.new_write()
    w.compact(full=True)
    wb.new_commit().commit(w.prepare_commit())
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t0
    after, after_samples = timed_reads(table, 1)
    same_rows(after, reference, f"nested {name} after the full compaction, against the numpy engine before it")
    same_rows(after, read_all(table.copy({"sort-engine": "numpy"})),
              f"nested {name} after the full compaction, against the numpy engine")
    formats = sorted({f.file_name.rsplit(".", 1)[1] for f in live_files(table)})
    assert formats == (["parquet"] if agg else ["orc"]), f"nested {name} compacted into {formats}"
    mixed = None if agg else ns_mixed_reads(hk, table, upsert, reference, rows)
    return {"options": options, "rows_written": input_rows, "output_rows": rows,
            "commits": NS_COMMITS if agg else N_RUNS + 1, "write_s": round(write_s, 3),
            "bytes_on_disk": bytes_before, "null_values": nulls, "empty_values": empties,
            "numpy_read_s": round(numpy_s[0], 4), "reads": reads, "stages": stages,
            "compact_s": round(compact_s, 3), "files_after_compaction": len(live_files(table)),
            "bytes_after_compaction": table_bytes(table)["data_bytes"],
            "read_after_compaction": read_stats(after_samples, rows=rows, input_rows=rows),
            "format_after_compaction": formats[0], "orc_and_parquet_runs": mixed, "equal_to_numpy_engine": True}


def nested_phase(pt, hk, warehouse: str, checked: tuple) -> dict:
    """ARRAY, MAP and ROW columns and the nested aggregates: the aggregation
    table and the dedup table, one line each; the dedup table compacts into
    ORC and is read merged with a parquet run. K1 (the flushes, the 131072
    tile), K2 (the default tile, the compactions) and segment_sum (the
    spend sum) must launch; then K1 and K2 are held exactly to their plain
    versions at the phase's shapes no earlier check covered. Launch counts
    are zeroed before it."""
    from paimon_tpu_torch.catalog import FileSystemCatalog

    cat = FileSystemCatalog(warehouse, commit_user="chip_smoke", device=DEVICE)
    hk.reset_launches()
    parts, seconds = {}, {}
    with ShapeRecorder(hk) as recorder:
        for name, agg in (("aggregation", True), ("dedup", False)):
            before = dict(hk.launches)
            t0 = time.perf_counter()
            parts[name] = ns_part(pt, hk, cat, warehouse, name, agg)
            seconds[name] = parts[name]["part_s"] = round(time.perf_counter() - t0, 3)
            parts[name]["part_launches"] = launch_diff(hk, before)
            emit({"phase": "nested", "part": name, **parts[name]})
    launches = dict(hk.launches)
    for k in K1_K2 + ("segment_sum",):
        assert launches[k] > 0, f"{k} never launched in the nested phase: {launches}"
    assert parts["aggregation"]["part_launches"]["segment_sum"] > 0, "the spend sum never launched segment_sum"
    dedup = parts["dedup"]
    mixed = dedup["orc_and_parquet_runs"]
    orc = {"orc_bytes": mixed["orc_bytes"], "compact_s": dedup["compact_s"],
           "mixed_read_s": {label: r["median_s"] for label, r in mixed["reads"].items()},
           "mixed_read_launches": {label: r["launches"] for label, r in mixed["reads"].items()}}
    return {"launches": launches, "launches_by_part": {n: p["part_launches"] for n, p in parts.items()},
            "dedup_orc": orc,
            "seconds_by_part": seconds, "stages_ms": {n: p["stages"]["ms"] for n, p in parts.items()},
            "shape_checks": path_shape_checks(hk, recorder, torch.device(DEVICE), 2036, checked)}


SEG_SUM_SIZES = (1, 2, 127, 128, 4096, 1 << 17, 1 << 20)
SEG_SUM_PATTERNS = ("short", "singletons", "one_segment", "long", "specials")


def seg_sum_input(rng, m: int, pattern: str, dtype, dev):
    """Values in sorted order and their segment starts and ids, on the card."""
    v = rng.standard_normal(m) * 10.0 ** rng.integers(-6, 7, m)
    if pattern == "specials":
        pick = rng.integers(0, 6, m)
        v = np.where(pick == 0, -0.0, np.where(pick == 1, 0.0, np.where(pick == 2, np.nan, np.where(
            pick == 3, np.inf, np.where(pick == 4, -np.inf, v)))))
    lengths = {"short": rng.integers(1, 9, m), "singletons": np.ones(m, np.int64), "one_segment": np.array([m]),
               "long": rng.integers(1, 3000, m), "specials": rng.integers(1, 5, m)}[pattern]
    starts = np.zeros(m, np.bool_)
    heads = np.cumsum(np.concatenate([[0], lengths]))
    starts[heads[heads < m]] = True
    seg_id = (np.cumsum(starts) - 1).astype(np.int32)
    t = torch.from_numpy(v.astype(dtype)).to(dev)
    return t, torch.from_numpy(starts).to(dev), torch.from_numpy(seg_id).to(dev)




def segment_sum_checks(hk, dev) -> dict:
    """The segment_sum kernel against its plain version, bit for bit, twice
    a case; and whether torch's own segment_reduce and index_add_ on the
    card give the same bits (they are not used by the port)."""
    rng = np.random.default_rng(99)
    checks, others = 0, {"torch_segment_reduce": True, "index_add": True}
    for dtype in (np.float64, np.float32):
        for m in SEG_SUM_SIZES:
            for pattern in SEG_SUM_PATTERNS:
                v, starts, seg_id = seg_sum_input(rng, m, pattern, dtype, dev)
                want = hk.segment_sum_plain(v, starts).cpu().numpy()
                for _ in range(2):
                    got = hk.segment_sum(v, starts, seg_id)
                    torch.cuda.synchronize()
                    assert same_values(got.cpu().numpy(), want), (
                        f"segment_sum differs from its plain version at {m}, {pattern}, {dtype}")
                    checks += 1
                k = int(seg_id[-1]) + 1
                lengths = torch.bincount(seg_id.long(), minlength=k)
                sr = torch.segment_reduce(v, "sum", lengths=lengths, initial=0.0)
                others["torch_segment_reduce"] &= same_values(sr.cpu().numpy(), want[:k])
                ia = torch.zeros_like(v).index_add_(0, seg_id.long(), v)
                others["index_add"] &= same_values(ia.cpu().numpy(), want)
    return {"exact_checks": checks, "bit_identical_on_the_card": others}


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


def segment_sum_timing(hk, rng, dev, launches: int, m: int) -> dict:
    """segment_sum's row at the engines path's float64 shape (m rows, a few
    rows a segment, as a merge gives): kernel, plain version (on the host,
    where it adds in order) and index_add_ (the same sums in another order),
    and the bound."""
    v, starts, seg_id = seg_sum_input(rng, m, "short", np.float64, dev)
    idx = seg_id.long()
    err = (hk.segment_sum(v, starts, seg_id).cpu() - hk.segment_sum_plain(v, starts).cpu()).abs().max().item()
    k = int(seg_id[-1]) + 1
    nbytes = m * 8 + m + m * 4 + m * 8  # values, starts and ids read; the (m,) sums written
    row = kernel_row(
        "segment_sum (sorted-order float sum)", "paimon_tpu_torch/csrc/segment_sum.cu",
        "paimon_tpu/ops/aggregates.py:72 _sum_fn (jax.ops.segment_sum, an XLA program; no Pallas kernel)",
        launches, err, cuda_ms(lambda: hk.segment_sum(v, starts, seg_id)),
        cuda_ms(lambda: hk.segment_sum_plain(v, starts), iters=10, warmup=2), nbytes, 0,
        cuda_ms(lambda: torch.zeros_like(v).index_add_(0, idx, v)), [m, "float64"],
    )
    t_ops = m / FP64_OPS_PER_S * 1e3  # m float64 adds
    if t_ops > row["bound_ms"]:
        row["bound_ms"], row["bound_by"] = round(t_ops, 5), "operations"
    row["segments"] = k
    row["host_ms_per_call"] = host_ms(lambda: hk.segment_sum(v, starts, seg_id))
    row["device_ms"] = device_ms(lambda: hk.segment_sum(v, starts, seg_id), {"ms": "segment_sum"})["ms"]
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
