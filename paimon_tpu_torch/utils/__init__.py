"""Small shared utilities: naming, JSON, time and the device resolver
(port of paimon_tpu/utils/__init__.py; the device resolver is the port's
own, replacing the JAX package's backend probing)."""

from __future__ import annotations

import json
import time
import uuid
from typing import Any, Sequence

import torch

__all__ = ["new_file_name", "partition_path", "partition_sort_key", "now_millis", "dumps", "loads", "resolve_device"]


def new_file_name(prefix: str, ext: str | None = None) -> str:
    n = f"{prefix}-{uuid.uuid4().hex}"
    return f"{n}.{ext}" if ext else n


def partition_path(
    partition_keys: Sequence[str],
    partition: Sequence[Any],
    default_name: str = "__DEFAULT_PARTITION__",
) -> str:
    """Hive-style partition directory: k1=v1/k2=v2 ('' for unpartitioned).
    Null and empty values take partition.default-name."""
    if not partition_keys:
        return ""
    return "/".join(
        f"{k}={default_name if v is None or v == '' else v}"
        for k, v in zip(partition_keys, partition)
    )


def partition_sort_key(partition: Sequence[Any]) -> tuple:
    """Sort key of a partition tuple: each value's own order, a null value
    after every other value of its field."""
    return tuple((v is None, v) for v in partition)


def now_millis() -> int:
    return int(time.time() * 1000)


def dumps(obj: Any) -> str:
    return json.dumps(obj, separators=(",", ":"), default=_default)


def loads(s: str | bytes) -> Any:
    return json.loads(s)


def _default(o):
    import numpy as np

    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.bool_):
        return bool(o)
    raise TypeError(f"not JSON serializable: {type(o)}")


def resolve_device(device: "str | torch.device") -> torch.device:
    """The device the merge kernels run on. "cuda" (the default everywhere)
    requires a visible CUDA device and raises RuntimeError otherwise: the
    port never carries on silently on the CPU. Pass "cpu" to ask for the
    plain PyTorch versions of the kernels."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paimon_tpu_torch: no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (expected 'cuda' or 'cpu')")
    return dev
