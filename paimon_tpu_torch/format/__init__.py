"""Data file formats and per-file statistics (port of
paimon_tpu/format/__init__.py: stats collection and their JSON form).

Per-field min/max/null-count stats ride in every DataFileMeta; the JSON
form is the JAX package's, so each package reads the other's manifests.
Parquet itself lives in format/parquet.py (numpy only).
"""

from __future__ import annotations

import base64
from dataclasses import dataclass
from typing import Any

import numpy as np

from ..data.batch import ColumnBatch

__all__ = ["FieldStats", "collect_stats", "stats_to_json", "stats_from_json"]

_TRUNCATE_LEN = 16


@dataclass(frozen=True)
class FieldStats:
    """Per-file, per-field statistics (null_count None = unknown)."""

    min: Any
    max: Any
    null_count: int | None
    row_count: int


def _to_py(x):
    return x.item() if hasattr(x, "item") else x


def _truncate_min(x, limit: int):
    if isinstance(x, (str, bytes)) and len(x) > limit:
        return x[:limit]
    return x


def _truncate_max(x, limit: int):
    """Truncated max bumped so it stays an upper bound."""
    if isinstance(x, str) and len(x) > limit:
        t = x[:limit]
        for i in range(len(t) - 1, -1, -1):
            if ord(t[i]) < 0x10FFFF:
                return t[:i] + chr(ord(t[i]) + 1)
        return x
    if isinstance(x, bytes) and len(x) > limit:
        t = bytearray(x[:limit])
        for i in range(len(t) - 1, -1, -1):
            if t[i] < 0xFF:
                t[i] += 1
                return bytes(t[: i + 1])
        return x
    return x


def _coded(col) -> bool:
    from ..ops.dicts import cache_usable

    return cache_usable(col)


def collect_stats(batch: ColumnBatch, truncate: int = _TRUNCATE_LEN) -> dict[str, FieldStats]:
    """Vectorized per-field min/max/null-count; strings truncated to
    `truncate` chars (metadata.stats-mode truncate(16)). A column carrying
    dictionary codes reads min and max off its sorted pool."""
    out: dict[str, FieldStats] = {}
    n = batch.num_rows
    for f in batch.schema.fields:
        col = batch.column(f.name)
        nulls = col.null_count
        if nulls >= n or n == 0:
            out[f.name] = FieldStats(None, None, nulls, n)
            continue
        if col.dtype.kind != "f" and _coded(col):
            # a sorted pool: min/max are a reduction over the valid codes,
            # no value expanded
            pool, codes = col.dict_cache
            if nulls:
                codes = codes[col.validity]
            lo, hi = pool[int(codes.min())], pool[int(codes.max())]
            if pool.dtype == np.dtype(object):
                lo, hi = _truncate_min(lo, truncate), _truncate_max(hi, truncate)
            out[f.name] = FieldStats(_to_py(lo), _to_py(hi), nulls, n)
            continue
        v = col.values[col.valid_mask()] if nulls else col.values
        if v.dtype == np.dtype(object):
            lo, hi = _truncate_min(min(v), truncate), _truncate_max(max(v), truncate)
        elif v.dtype.kind == "f":
            with np.errstate(invalid="ignore"):
                lo, hi = np.nanmin(v), np.nanmax(v)
            if np.isnan(lo) or np.isnan(hi):
                out[f.name] = FieldStats(None, None, nulls, n)
                continue
            lo, hi = _to_py(lo), _to_py(hi)
        else:
            lo, hi = _to_py(v.min()), _to_py(v.max())
        out[f.name] = FieldStats(lo, hi, nulls, n)
    return out


def stats_to_json(stats: dict[str, FieldStats]) -> dict:
    def enc(v):
        if isinstance(v, bytes):
            return {"b64": base64.b64encode(v).decode()}
        if isinstance(v, (bool, int, float, str)) or v is None:
            return v
        return str(v)

    return {
        name: {"min": enc(s.min), "max": enc(s.max), "nullCount": s.null_count, "rowCount": s.row_count}
        for name, s in stats.items()
    }


def stats_from_json(d: dict) -> dict[str, FieldStats]:
    def dec(v):
        if isinstance(v, dict) and "b64" in v:
            return base64.b64decode(v["b64"])
        return v

    return {name: FieldStats(dec(s["min"]), dec(s["max"]), s["nullCount"], s["rowCount"]) for name, s in d.items()}
