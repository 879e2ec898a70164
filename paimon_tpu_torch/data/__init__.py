"""Columnar batches and key-lane encoding (port of paimon_tpu/data)."""

from .batch import Column, ColumnBatch, concat_batches

__all__ = ["Column", "ColumnBatch", "concat_batches"]
