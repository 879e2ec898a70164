"""DML statements: the write half of the SQL surface (port of
paimon_tpu/sql/dml.py).

    INSERT INTO db.t VALUES (1, 'x', 2.5), (2, 'y', NULL)
    INSERT INTO db.t (k, s) VALUES (3, 'z')          -- missing columns -> NULL
    INSERT INTO db.t SELECT ... FROM db.src WHERE ...
    INSERT OVERWRITE db.t VALUES (...) / SELECT ...  -- overwrite commit
    UPDATE db.t SET v = v + 1, s = 'x' WHERE k < 10
    DELETE FROM db.t WHERE k >= 100
    TRUNCATE TABLE db.t

Each lowers onto the table API: the batch write builder (upsert on a
primary-key table, append otherwise; OVERWRITE and TRUNCATE through the
overwrite commit), table.update_where (table/rowops.py) and
table.delete_where (table/delete.py). The writes and the reads they plan
run on the catalog's device.
"""

from __future__ import annotations

import re
from typing import TYPE_CHECKING, Any

from .expr import (
    ExprError,
    _NOT_CONST,
    _Parser,
    _const_fold,
    _tokenize,
    batch_resolver,
    eval_value,
    parse_assignments,
    parse_where,
)

if TYPE_CHECKING:
    from ..catalog import FileSystemCatalog as Catalog

__all__ = ["insert", "update", "delete", "truncate", "DmlError"]


class DmlError(ValueError):
    pass


_INSERT_RE = re.compile(
    r"^\s*INSERT\s+(?P<mode>INTO|OVERWRITE)\s+`?(?P<name>[\w.]+)`?\s*"
    r"(?:\((?P<cols>[^)]*)\)\s*)?"
    r"(?P<body>VALUES\s*.*|SELECT\s+.*?)\s*;?\s*$",
    re.I | re.S,
)


def _parse_rows(values_text: str, n_cols: int, src: str) -> list[list[Any]]:
    """VALUES (lit, ...), (lit, ...) -> row lists (literals const-folded).
    Every parse failure (tokenizer AND grammar) surfaces as DmlError."""
    try:
        p = _Parser(_tokenize(values_text), src)
        rows: list[list[Any]] = []
        while True:
            p.expect("op", "(")
            row = []
            while True:
                node = p.parse_operand()
                v = _const_fold(node)
                if v is _NOT_CONST:
                    raise DmlError(f"VALUES entries must be literals in {src!r}")
                row.append(v)
                if p.peek() == ("op", ","):
                    p.next()
                    continue
                break
            p.expect("op", ")")
            if len(row) != n_cols:
                raise DmlError(f"row has {len(row)} values, expected {n_cols} in {src!r}")
            rows.append(row)
            if p.peek() == ("op", ","):
                p.next()
                continue
            if p.peek()[0] == "eof":
                return rows
            raise DmlError(f"trailing tokens after VALUES in {src!r}")
    except ExprError as e:
        raise DmlError(str(e)) from e


def insert(catalog: "Catalog", statement: str) -> dict:
    m = _INSERT_RE.match(statement)
    if not m:
        raise DmlError(f"not an INSERT statement: {statement!r}")
    t = _table(catalog, m.group("name"))
    overwrite = m.group("mode").upper() == "OVERWRITE"
    cols = (
        [c.strip().strip("`") for c in m.group("cols").split(",") if c.strip()]
        if m.group("cols")
        else t.row_type.field_names
    )
    for c in cols:
        if c not in t.row_type:
            raise DmlError(f"unknown column {c!r} in {m.group('name')}")

    body = m.group("body")
    if re.match(r"^SELECT\b", body, re.I):
        from .select import QueryError, query

        try:
            result = query(catalog, body)
        except QueryError as e:
            raise DmlError(str(e)) from e
        if len(result.schema.field_names) != len(cols):
            raise DmlError(
                f"SELECT produces {len(result.schema.field_names)} columns, "
                f"INSERT target has {len(cols)}"
            )
        data = {}
        for c, src_name in zip(cols, result.schema.field_names):
            col = result.column(src_name)
            if col.validity is not None and not col.validity.all():
                data[c] = col.to_pylist()  # nulls must survive as None
            else:
                data[c] = col.values  # numpy passthrough, no python round trip
        n = result.num_rows
    else:
        rows = _parse_rows(body[len("VALUES"):], len(cols), statement)
        data = {c: [r[i] for r in rows] for i, c in enumerate(cols)}
        n = len(rows)

    missing = [f.name for f in t.row_type.fields if f.name not in cols]
    for name in missing:
        if not t.row_type.field(name).type.nullable:
            raise DmlError(f"column {name!r} is NOT NULL and has no value")
        data[name] = [None] * n
    # explicit NULLs against NOT NULL columns are rejected the same way
    for name in cols:
        if not t.row_type.field(name).type.nullable:
            vals = data[name]
            it = vals.tolist() if hasattr(vals, "tolist") else vals
            if any(v is None for v in it):
                raise DmlError(f"column {name!r} is NOT NULL; NULL value in row")

    wb = t.new_batch_write_builder()
    if overwrite:
        wb = wb.with_overwrite()
    w = wb.new_write()
    w.write({name: data[name] for name in t.row_type.field_names})
    wb.new_commit().commit(w.prepare_commit())
    return {"inserted": n, "table": m.group("name"), "overwrite": overwrite}

_UPDATE_HEAD_RE = re.compile(
    r"^\s*UPDATE\s+`?(?P<name>[\w.]+)`?\s+SET\s+(?P<rest>.*?)\s*;?\s*$", re.I | re.S
)


def _split_on_where(text: str) -> tuple[str, str | None]:
    """Split 'SET-list [WHERE expr]' at the top-level WHERE keyword — quote-
    aware, so a string literal containing the word WHERE never splits."""
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "'":
            j = text.find("'", i + 1)
            while j != -1 and text[j : j + 2] == "''":
                j = text.find("'", j + 2)
            if j == -1:
                break  # unterminated: let the expression parser report it
            i = j + 1
            continue
        if text[i : i + 5].upper() == "WHERE" and (i == 0 or not text[i - 1].isalnum()) and (
            i + 5 >= n or not text[i + 5].isalnum()
        ):
            return text[:i].strip(), text[i + 5 :].strip()
        i += 1
    return text.strip(), None
_DELETE_RE = re.compile(
    r"^\s*DELETE\s+FROM\s+`?(?P<name>[\w.]+)`?(?:\s+WHERE\s+(?P<where>.*?))?\s*;?\s*$",
    re.I | re.S,
)
_TRUNCATE_RE = re.compile(r"^\s*TRUNCATE\s+TABLE\s+`?(?P<name>[\w.]+)`?\s*;?\s*$", re.I)


def _table(catalog: "Catalog", name: str):
    try:
        return catalog.get_table(name)
    except FileNotFoundError:
        raise DmlError(f"table {name} does not exist") from None


def update(catalog: "Catalog", statement: str) -> dict:
    """UPDATE t SET a = expr, ... [WHERE ...] -> Table.update_where.
    SET expressions may reference the row's own columns (v = v + 1),
    optionally qualified with the table name."""
    m = _UPDATE_HEAD_RE.match(statement)
    if not m:
        raise DmlError(f"not an UPDATE statement: {statement!r}")
    name = m.group("name")
    t = _table(catalog, name)
    sets_text, where_text = _split_on_where(m.group("rest"))
    try:
        assigns = parse_assignments(sets_text)
        pred = parse_where(where_text) if where_text else None
    except ExprError as e:
        raise DmlError(str(e)) from e
    if assigns and assigns[0][0] == "*":
        raise DmlError("UPDATE SET requires explicit column assignments")
    if pred is None:
        from ..data.predicate import is_not_null, is_null, or_

        # unconditional UPDATE: an always-true predicate (null-safe)
        c = t.row_type.field_names[0]
        pred = or_(is_null(c), is_not_null(c))

    # accept the table's short name, full identifier, and 't' as aliases
    aliases = {a for a in (name, name.split(".")[-1], "t") if a}

    def make_value(ast):
        def fn(batch):
            return eval_value(ast, batch_resolver({a: batch for a in aliases}), batch.num_rows)

        return fn

    assignments = {col: make_value(ast) for col, ast in assigns}
    try:
        n = t.update_where(pred, assignments)
    except (ValueError, KeyError) as e:
        raise DmlError(str(e)) from e
    return {"rows_updated": n, "table": name}


def delete(catalog: "Catalog", statement: str) -> dict:
    """DELETE FROM t WHERE ... -> table.delete_where (an explicit WHERE is
    required; TRUNCATE TABLE is the wipe-everything statement)."""
    m = _DELETE_RE.match(statement)
    if not m:
        raise DmlError(f"not a DELETE statement: {statement!r}")
    t = _table(catalog, m.group("name"))
    if not m.group("where"):
        raise DmlError("DELETE without WHERE: use TRUNCATE TABLE to wipe a table")
    try:
        pred = parse_where(m.group("where"))
    except ExprError as e:
        raise DmlError(str(e)) from e
    if pred is None:
        raise DmlError("DELETE without an effective filter: use TRUNCATE TABLE")
    return {"rows_deleted": t.delete_where(pred), "table": m.group("name")}


def truncate(catalog: "Catalog", statement: str) -> dict:
    """TRUNCATE TABLE t: one overwrite commit with no rows (time travel to
    the pre-truncate snapshot still works, as in Apache Paimon). The
    explicit match-all partition filter overrides dynamic-partition-
    overwrite, which would otherwise clear only the (zero) touched
    partitions and silently keep every row of a partitioned table."""
    m = _TRUNCATE_RE.match(statement)
    if not m:
        raise DmlError(f"not a TRUNCATE statement: {statement!r}")
    t = _table(catalog, m.group("name"))
    wb = t.new_batch_write_builder().with_overwrite(lambda p: True)
    w = wb.new_write()
    wb.new_commit().commit(w.prepare_commit())
    return {"truncated": m.group("name")}
