#!/usr/bin/env python3
"""Bytes on disk of the bench.py table as each package writes it.

    JAX_PLATFORMS=cpu python3 scripts/table_sizes.py      # from the repository root

Writes bench.py's table (1M rows in 4 key-overlapping sorted runs of a
seed-7 permutation, bench.py:54-96) plus chip_smoke.py's 100k-row upsert
commit into a temporary warehouse, once per writer:

- the JAX package at bench.py's own options (file.compression=zstd at
  level 1, zstd manifests), with each of its Parquet encoders (pyarrow's,
  format.parquet.encoder=native);
- the port, on the CPU, at the same options, and with
  file.compression=none and manifest.compression=none.

Prints one JSON line per writer with the bytes of its data files and of its
manifests. Sizes depend on the data and the codecs only, not on the
machine; both packages run here, so this needs jax and pyarrow besides the
port.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402 - the table's values and upsert, as the chip run writes them

N_ROWS, N_RUNS, N_UPSERT = chip_smoke.N_ROWS, chip_smoke.N_RUNS, chip_smoke.N_UPSERT


def write_table(pkg, catalog, name: str, options: dict):
    schema = pkg.RowType.of(
        ("id", pkg.BIGINT(False)),
        ("c1", pkg.BIGINT()),
        ("c2", pkg.BIGINT()),
        ("c3", pkg.BIGINT()),
        ("d1", pkg.DOUBLE()),
        ("d2", pkg.DOUBLE()),
        ("s1", pkg.STRING()),
        ("s2", pkg.STRING()),
    )
    table = catalog.create_table(f"bench.{name}", schema, primary_keys=["id"], options=options)
    ids = np.random.default_rng(7).permutation(N_ROWS).astype(np.int64)
    per = N_ROWS // N_RUNS
    batches = [chip_smoke.table_values(np.sort(ids[r * per : (r + 1) * per]), upsert=False) for r in range(N_RUNS)]
    up = np.random.default_rng(8).choice(N_ROWS, N_UPSERT, replace=False).astype(np.int64)
    batches.append(chip_smoke.table_values(up, upsert=True))
    for batch in batches:
        wb = table.new_batch_write_builder()
        w = wb.new_write()
        w.write(batch)
        wb.new_commit().commit(w.prepare_commit())
    return chip_smoke.table_bytes(table)


def main() -> int:
    import io

    import pyarrow as pa
    import pyarrow.parquet as pq

    # the JAX package encodes on a flush thread; pyarrow's lazy first-use
    # initialisation must happen on the main thread first
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())
    import paimon_tpu as jt
    import paimon_tpu_torch as tt
    from paimon_tpu.catalog import FileSystemCatalog as JaxCatalog
    from paimon_tpu_torch.catalog import FileSystemCatalog as PortCatalog

    bench = {"bucket": "1", "file.format": "parquet", "write-only": "true"}
    uncompressed = {"file.compression": "none", "manifest.compression": "none"}
    with tempfile.TemporaryDirectory(prefix="paimon_table_sizes_") as warehouse:
        jax_cat, port_cat = JaxCatalog(warehouse), PortCatalog(warehouse, device="cpu")
        for name, pkg, cat, options in (
            ("jax_pyarrow_zstd", jt, jax_cat, bench),
            ("jax_native_encoder_zstd", jt, jax_cat, {**bench, "format.parquet.encoder": "native"}),
            ("port_zstd", tt, port_cat, bench),
            ("port_uncompressed", tt, port_cat, {**bench, **uncompressed}),
        ):
            print(json.dumps({"writer": name, "rows_written": N_ROWS + N_UPSERT, **write_table(pkg, cat, name, options)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
