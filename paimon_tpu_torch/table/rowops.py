"""Row-level SQL commands: UPDATE and MERGE INTO (port of
paimon_tpu/table/rowops.py).

Each resolves the affected rows against the merged view and pushes the
changed rows through the normal write path: +U rows (or -D rows) on a
primary-key table under merge-engine=deduplicate, a copy-on-write rewrite of
the affected files on an append table (table/delete.py, which applies the
bucket's deletion vectors first). Assignments and conditions are constants,
"src.col" / "tgt.col" references, or callables over the aligned source and
target ColumnBatches; sql/dml.py and the merge_into procedure lower their
SQL expressions onto these.

WHEN MATCHED clauses apply in declaration order, the first that matches a
row wins.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Callable, Mapping, Sequence

import numpy as np

from ..core.kv import KVBatch
from ..data.batch import Column, ColumnBatch
from ..data.predicate import Predicate, and_, in_
from ..options import MergeEngine
from ..types import RowKind

if TYPE_CHECKING:
    from . import FileStoreTable

__all__ = ["update_where", "MergeInto", "MergeResult"]

builtins_set = set  # `set` is shadowed by the when_matched_update SQL-ish parameter name


def _require_deduplicate(table: "FileStoreTable", op: str) -> None:
    """Upsert-style row commands are only sound under last-write-wins: on an
    aggregation table a SET would become an ADD, on first-row it would be
    silently ignored."""
    if table.options.merge_engine != MergeEngine.DEDUPLICATE:
        raise ValueError(
            f"{op} requires merge-engine=deduplicate; "
            f"table uses {table.options.merge_engine.value!r}"
        )


# ---------------------------------------------------------------------------
# UPDATE table SET ... WHERE ...
# ---------------------------------------------------------------------------


def _assign(batch: ColumnBatch, assignments: Mapping[str, Any]) -> ColumnBatch:
    """Apply SET assignments to a batch of matching rows."""
    cols = dict(batch.columns)
    n = batch.num_rows
    for name, value in assignments.items():
        field = batch.schema.field(name)  # raises on unknown column
        if callable(value):
            out = value(batch)
            cols[name] = out if isinstance(out, Column) else Column.from_pylist(list(out), field.type)
        else:
            cols[name] = Column.from_pylist([value] * n, field.type)
    return ColumnBatch(batch.schema, cols)


def update_where(table: "FileStoreTable", predicate: Predicate, assignments: Mapping[str, Any]) -> int:
    """UPDATE ... SET assignments WHERE predicate. Returns #rows updated.
    PK tables upsert the changed rows (+U); append tables copy-on-write
    rewrite the affected files."""
    pks = set(table.primary_keys)
    if pks & set(assignments):
        raise ValueError(f"cannot UPDATE primary key columns {sorted(pks & set(assignments))}")
    if table.is_primary_key_table:
        _require_deduplicate(table, "UPDATE")
        rb = table.new_read_builder().with_filter(predicate)
        matching = rb.new_read().read_all(rb.new_scan().plan())
        if matching.num_rows == 0:
            return 0
        updated = _assign(matching, assignments)
        wb = table.new_batch_write_builder()
        w = wb.new_write()
        w.write(updated, np.full(updated.num_rows, int(RowKind.UPDATE_AFTER), dtype=np.uint8))
        wb.new_commit().commit(w.prepare_commit())
        return updated.num_rows
    from .delete import copy_on_write_rewrite

    def transform(kv_match: KVBatch) -> KVBatch:
        return KVBatch(_assign(kv_match.data, assignments), kv_match.seq, kv_match.kind)

    return copy_on_write_rewrite(table, predicate, transform)


# ---------------------------------------------------------------------------
# MERGE INTO
# ---------------------------------------------------------------------------


@dataclass
class MergeResult:
    rows_updated: int = 0
    rows_deleted: int = 0
    rows_inserted: int = 0


def _resolve(value, src: ColumnBatch, tgt: ColumnBatch | None, field_type, n: int) -> Column:
    """An action value: "src.col" / "tgt.col" reference, callable(src, tgt),
    or a constant."""
    if callable(value):
        out = value(src, tgt)
        return out if isinstance(out, Column) else Column.from_pylist(list(out), field_type)
    if isinstance(value, str) and value.startswith(("src.", "tgt.")):
        side, _, col = value.partition(".")
        if side == "tgt":
            if tgt is None:
                raise ValueError("WHEN NOT MATCHED INSERT has no target row; 'tgt.*' is invalid")
            return tgt.column(col)
        return src.column(col)
    return Column.from_pylist([value] * n, field_type)


def _cond_mask(condition, src: ColumnBatch, tgt: ColumnBatch | None, n: int) -> np.ndarray:
    if condition is None:
        return np.ones(n, dtype=np.bool_)
    out = condition(src, tgt) if tgt is not None else condition(src)
    return np.asarray(out, dtype=np.bool_)


class MergeInto:
    """MERGE INTO target USING source ON <pk join> WHEN MATCHED ... WHEN NOT
    MATCHED .... The join is on the target's primary key (the merge
    condition must cover it)."""

    def __init__(self, table: "FileStoreTable", source: ColumnBatch | Mapping[str, Sequence]):
        if not table.is_primary_key_table:
            raise ValueError("MERGE INTO requires a primary-key target table")
        _require_deduplicate(table, "MERGE INTO")
        self.table = table
        if isinstance(source, Mapping):
            names = set(source)
            schema = table.row_type.project([f.name for f in table.row_type.fields if f.name in names])
            source = ColumnBatch.from_pydict(schema, source)
        self.source = source
        missing = [k for k in table.primary_keys if k not in source.schema.field_names]
        if missing:
            raise ValueError(f"source must carry the target primary key columns; missing {missing}")
        # WHEN MATCHED clauses in declaration order: ("update", set, cond) or
        # ("delete", cond); first matching clause wins per row
        self._matched_clauses: list[tuple] = []
        self._not_matched_insert: tuple[Mapping[str, Any] | None, Callable | None] | None = None

    def when_matched_update(self, set: Mapping[str, Any], condition: Callable | None = None) -> "MergeInto":
        bad = set.keys() & builtins_set(self.table.primary_keys)
        if bad:
            raise ValueError(f"cannot UPDATE primary key columns {sorted(bad)}")
        self._matched_clauses.append(("update", set, condition))
        return self

    def when_matched_delete(self, condition: Callable | None = None) -> "MergeInto":
        self._matched_clauses.append(("delete", condition))
        return self

    def when_not_matched_insert(
        self, values: Mapping[str, Any] | None = None, condition: Callable | None = None
    ) -> "MergeInto":
        self._not_matched_insert = (values, condition)
        return self

    def execute(self) -> MergeResult:
        table = self.table
        pks = list(table.primary_keys)
        src = self.source
        src_keys = list(zip(*(src.column(k).to_pylist() for k in pks))) if src.num_rows else []
        seen: set = set()
        dup = [k for k in src_keys if k in seen or seen.add(k)]
        if dup:
            # several source rows matching one target row: a cardinality
            # violation
            raise ValueError(f"MERGE source has duplicate keys: {dup[:3]}")

        # prune the target read with the source's key set (the join is on the
        # PK, so a per-column IN superset is a safe prefilter)
        rb = table.new_read_builder()
        if src.num_rows:
            prefilter = and_(*(in_(k, sorted(builtins_set(src.column(k).to_pylist()))) for k in pks))
            rb = rb.with_filter(prefilter)
        tgt_all = rb.new_read().read_all(rb.new_scan().plan())
        tgt_keys = list(zip(*(tgt_all.column(k).to_pylist() for k in pks))) if tgt_all.num_rows else []
        tgt_index = {key: i for i, key in enumerate(tgt_keys)}
        matched_rows = [i for i, key in enumerate(src_keys) if key in tgt_index]
        not_matched_rows = [i for i, key in enumerate(src_keys) if key not in tgt_index]

        result = MergeResult()
        wb = table.new_batch_write_builder()
        w = wb.new_write()
        wrote = False

        if matched_rows and self._matched_clauses:
            s_idx = np.array(matched_rows, dtype=np.int64)
            t_idx = np.array([tgt_index[src_keys[i]] for i in matched_rows], dtype=np.int64)
            src_m = src.take(s_idx)
            tgt_m = tgt_all.take(t_idx)
            n = len(s_idx)
            remaining = np.ones(n, dtype=np.bool_)
            for clause in self._matched_clauses:
                if not remaining.any():
                    break
                if clause[0] == "delete":
                    mask = _cond_mask(clause[1], src_m, tgt_m, n) & remaining
                    if mask.any():
                        dead = tgt_m.filter(mask)
                        w.write(dead, np.full(dead.num_rows, int(RowKind.DELETE), dtype=np.uint8))
                        wrote = True
                        result.rows_deleted += int(mask.sum())
                        remaining &= ~mask
                else:
                    _, set_map, cond = clause
                    mask = _cond_mask(cond, src_m, tgt_m, n) & remaining
                    if mask.any():
                        src_u, tgt_u = src_m.filter(mask), tgt_m.filter(mask)
                        cols = dict(tgt_u.columns)
                        for name, value in set_map.items():
                            cols[name] = _resolve(
                                value, src_u, tgt_u, table.row_type.field(name).type, tgt_u.num_rows
                            )
                        updated = ColumnBatch(table.row_type, cols)
                        w.write(
                            updated,
                            np.full(updated.num_rows, int(RowKind.UPDATE_AFTER), dtype=np.uint8),
                        )
                        wrote = True
                        result.rows_updated += int(mask.sum())
                        remaining &= ~mask

        if not_matched_rows and self._not_matched_insert is not None:
            values, cond = self._not_matched_insert
            s_idx = np.array(not_matched_rows, dtype=np.int64)
            src_n = src.take(s_idx)
            ins_mask = _cond_mask(cond, src_n, None, len(s_idx))
            if ins_mask.any():
                src_i = src_n.filter(ins_mask)
                cols = {}
                for f in table.row_type.fields:
                    if values is not None and f.name in values:
                        cols[f.name] = _resolve(values[f.name], src_i, None, f.type, src_i.num_rows)
                    elif f.name in src_i.schema.field_names:
                        cols[f.name] = src_i.column(f.name)
                    else:
                        cols[f.name] = Column.from_pylist([None] * src_i.num_rows, f.type)
                w.write(ColumnBatch(table.row_type, cols))
                wrote = True
                result.rows_inserted = src_i.num_rows

        if wrote:
            wb.new_commit().commit(w.prepare_commit())
        else:
            w.close()
        return result
