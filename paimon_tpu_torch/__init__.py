"""paimon_tpu_torch: the PyTorch/CUDA port of paimon_tpu for one NVIDIA
H100 (Hopper, sm_90a).

It writes (compacting the LSM levels), commits (batch or streaming) and
merge-reads primary-key tables under every merge engine, and writes and
reads append tables, through the Table API. With sort-engine=pallas the
merge runs on hand-written CUDA kernels (ops/hopper_kernels.py).
The warehouse layout, schema, snapshot, manifest and data-file formats are
the JAX package's, so each package reads the other's tables. The package
imports torch and numpy and nothing of JAX, pyarrow or paimon_tpu.

    from paimon_tpu_torch.catalog import FileSystemCatalog
    cat = FileSystemCatalog(warehouse)            # device="cuda" by default
    cat = FileSystemCatalog(warehouse, device="cpu")  # plain torch kernels
"""

from .data.batch import Column, ColumnBatch
from .options import CoreOptions, SortEngine
from .types import (
    BIGINT,
    BOOLEAN,
    BYTES,
    CHAR,
    DATE,
    DECIMAL,
    DOUBLE,
    FLOAT,
    INT,
    SMALLINT,
    STRING,
    TIMESTAMP,
    TINYINT,
    VARCHAR,
    DataField,
    RowKind,
    RowType,
)

__all__ = [
    "Column",
    "ColumnBatch",
    "CoreOptions",
    "SortEngine",
    "RowType",
    "DataField",
    "RowKind",
    "TINYINT",
    "SMALLINT",
    "INT",
    "BIGINT",
    "FLOAT",
    "DOUBLE",
    "BOOLEAN",
    "STRING",
    "BYTES",
    "CHAR",
    "VARCHAR",
    "DATE",
    "TIMESTAMP",
    "DECIMAL",
    "DedicatedCompactor",
]


def __getattr__(name):
    """DedicatedCompactor loads table/compactor.py (and torch) on first
    access, as the JAX package exports it lazily."""
    if name == "DedicatedCompactor":
        from .table.compactor import DedicatedCompactor

        return DedicatedCompactor
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
