"""Compressed-domain predicate pushdown (port of
paimon_tpu/decode/pushdown.py).

Before a page expands, each AND-conjunct of the read predicate meets the
compressed domain of its column:

  1. row-group gate: the chunks' min/max/null-count statistics through
     `Predicate.test_stats`; a group that cannot match opens no page;
  2. dictionary gate: on a dictionary-encoded chunk a value leaf
     evaluates once over the dictionary, and `surviving[codes]` marks the
     live rows of each page from its index run alone. A page whose codes
     all miss is never expanded.

The conjuncts' masks AND into one keep mask per row group. It depends on
the file bytes and the predicate only, never on the projection, so the
key pass and the value pass of the pipelined merge read stay row-aligned.
A row it drops fails the conjunction, so it is a row the caller's later
`predicate.eval` drops too; the readers push predicates only where that
holds (core/read.py: the whole predicate on single runs and append files,
key conjuncts alone before a merge).
"""

from __future__ import annotations

import numpy as np

from ..data.predicate import LeafPredicate, Predicate, PredicateBuilder
from ..types import RowType
from .container import chunk_field_stats
from .pages import chunk_code_pages

__all__ = ["row_group_keep_mask", "dict_surviving_codes"]

# value-determined leaves: a NULL row fails them all, so their verdict on
# the dictionary transfers to the rows through the codes
_VALUE_FUNCS = frozenset(
    {
        "equal",
        "notEqual",
        "lessThan",
        "lessOrEqual",
        "greaterThan",
        "greaterOrEqual",
        "in",
        "notIn",
        "between",
        "startsWith",
        "endsWith",
        "contains",
    }
)


def dict_surviving_codes(leaf: LeafPredicate, dictionary: np.ndarray) -> np.ndarray:
    """Bool per dictionary entry: can that value satisfy the leaf?"""
    return leaf._eval_values(dictionary, np.ones(len(dictionary), dtype=np.bool_))


def row_group_keep_mask(data: bytes, cols: dict, num_rows: int, predicate: Predicate | None, schema: RowType,
                        metrics=None, code_cache: dict | None = None):
    """False: skip the row group; None: keep every row; a bool vector: the
    rows to keep. `code_cache` (the caller's, one per row group) collects
    the (dictionary, pages) pairs the gate decodes, by field name, for the
    code-domain reader to reuse."""
    if predicate is None:
        return None
    stats = {}
    for name in predicate.referenced_fields():
        chunk = cols.get(name)
        if chunk is not None and name in schema:
            st = chunk_field_stats(chunk, schema.field(name).type, num_rows)
            if st is not None:
                stats[name] = st
    if stats and not predicate.test_stats(stats):
        return False
    mask = None
    for part in PredicateBuilder.split_and(predicate):
        if not isinstance(part, LeafPredicate) or part.function not in _VALUE_FUNCS:
            continue
        chunk = cols.get(part.field)
        if chunk is None or not chunk.has_dictionary or part.field not in schema:
            continue
        dictionary, pages = chunk_code_pages(data, chunk, schema.field(part.field).type)
        if code_cache is not None:
            code_cache[part.field] = (dictionary, pages)
        if dictionary is None:
            continue
        surviving = dict_surviving_codes(part, dictionary)
        if surviving.all():
            continue  # this conjunct prunes nothing in the group
        part_mask = np.zeros(num_rows, dtype=np.bool_)
        for row_start, n, codes, page_valid in pages:
            if codes is None:  # a PLAIN page: alive, to be safe
                part_mask[row_start : row_start + n] = True
            elif page_valid is None:
                part_mask[row_start : row_start + n] = surviving[codes]
            else:  # NULL rows carry no code and fail every value leaf
                part_mask[row_start : row_start + n][page_valid] = surviving[codes]
        mask = part_mask if mask is None else (mask & part_mask)
        if not mask.any():
            break
    if mask is None:
        return None
    if not mask.any():
        if metrics is not None:
            metrics.counter("rows_pruned").inc(num_rows)
        return False
    if mask.all():
        return None
    if metrics is not None:
        metrics.counter("rows_pruned").inc(int((~mask).sum()))
    return mask
