"""SQL DDL: CREATE/DROP TABLE and DATABASE, SHOW, SHOW CREATE TABLE,
DESCRIBE, ALTER TABLE and ANALYZE (port of paimon_tpu/sql/ddl.py).

    CREATE TABLE db.t (k BIGINT NOT NULL, v STRING, dt STRING,
                       PRIMARY KEY (k, dt) NOT ENFORCED)
        PARTITIONED BY (dt) WITH ('bucket' = '2')
    CREATE TABLE IF NOT EXISTS db.t (...)
    DROP TABLE [IF EXISTS] db.t
    CREATE DATABASE [IF NOT EXISTS] db   /  DROP DATABASE db
    SHOW DATABASES / SHOW TABLES [IN db] / SHOW CREATE TABLE db.t
    DESCRIBE db.t
    ALTER TABLE db.t ADD COLUMN c INT | DROP COLUMN c | RENAME COLUMN a TO b
        | MODIFY c BIGINT | SET ('k' = 'v') | RESET ('k')
    ANALYZE TABLE db.t COMPUTE STATISTICS [FOR ALL COLUMNS]

Types take the SQL names of types.parse_type. ARRAY and MAP columns raise
NotImplementedError, as the port's types do (ROADMAP Queue 1 item 11).
ALTER lowers onto core/schema.py SchemaChange and the catalog's
alter_table; ANALYZE onto table/statistics.py.
"""

from __future__ import annotations

import re
from typing import TYPE_CHECKING, Any

from ..types import DataField, RowType, parse_type

if TYPE_CHECKING:
    from ..catalog import FileSystemCatalog as Catalog

__all__ = ["ddl", "DdlError"]


class DdlError(ValueError):
    pass


_CREATE_TABLE_HEAD_RE = re.compile(
    r"^\s*CREATE\s+TABLE\s+(?P<ine>IF\s+NOT\s+EXISTS\s+)?`?(?P<name>[\w.]+)`?\s*\(",
    re.I | re.S,
)
_CREATE_TABLE_TAIL_RE = re.compile(
    r"^\s*(?:PARTITIONED\s+BY\s*\((?P<parts>[^)]*)\)\s*)?"
    r"(?:WITH\s*\((?P<opts>.*)\)\s*)?;?\s*$",
    re.I | re.S,
)
_DROP_TABLE_RE = re.compile(
    r"^\s*DROP\s+TABLE\s+(?P<ife>IF\s+EXISTS\s+)?`?(?P<name>[\w.]+)`?\s*;?\s*$", re.I
)
_CREATE_DB_RE = re.compile(
    r"^\s*CREATE\s+DATABASE\s+(?P<ine>IF\s+NOT\s+EXISTS\s+)?`?(?P<name>\w+)`?\s*;?\s*$", re.I
)
_DROP_DB_RE = re.compile(
    r"^\s*DROP\s+DATABASE\s+(?P<ife>IF\s+EXISTS\s+)?`?(?P<name>\w+)`?\s*;?\s*$", re.I
)
_SHOW_DBS_RE = re.compile(r"^\s*SHOW\s+DATABASES\s*;?\s*$", re.I)
_SHOW_TABLES_RE = re.compile(r"^\s*SHOW\s+TABLES(?:\s+(?:IN|FROM)\s+`?(?P<db>\w+)`?)?\s*;?\s*$", re.I)
_SHOW_CREATE_RE = re.compile(r"^\s*SHOW\s+CREATE\s+TABLE\s+`?(?P<name>[\w.]+)`?\s*;?\s*$", re.I)
_DESCRIBE_RE = re.compile(r"^\s*(?:DESCRIBE|DESC)\s+`?(?P<name>[\w.$]+)`?\s*;?\s*$", re.I)
_ALTER_RE = re.compile(
    r"^\s*ALTER\s+TABLE\s+`?(?P<name>[\w.]+)`?\s+(?P<rest>.*?);?\s*$", re.I | re.S
)
_ANALYZE_RE = re.compile(
    r"^\s*ANALYZE\s+TABLE\s+`?(?P<name>[\w.]+)`?"
    r"\s+COMPUTE\s+STATISTICS(?P<cols>\s+FOR\s+ALL\s+COLUMNS)?\s*;?\s*$",
    re.I,
)


def _get_table(catalog: "Catalog", name: str):
    try:
        return catalog.get_table(name)
    except FileNotFoundError:
        raise DdlError(f"table {name} does not exist") from None


def _split_top(body: str) -> list[str]:
    """Split on top-level commas. Parens (DECIMAL(10,2)), angle brackets
    (ARRAY<INT>) and single-quoted literals ('a,b', COMMENT 'x(y') guard."""
    out, depth, buf = [], 0, []
    i, n = 0, len(body)
    while i < n:
        c = body[i]
        if c == "'":
            j = i + 1
            while j < n:
                if body[j] == "'":
                    if j + 1 < n and body[j + 1] == "'":
                        j += 2
                        continue
                    break
                j += 1
            if j >= n:
                raise DdlError(f"unterminated string literal in {body!r}")
            buf.append(body[i : j + 1])
            i = j + 1
            continue
        if c in "(<":
            depth += 1
        elif c in ")>":
            depth -= 1
        if c == "," and depth == 0:
            out.append("".join(buf).strip())
        else:
            buf.append(c)
        i += 1
        if c == "," and depth == 0:
            buf = []
    tail = "".join(buf).strip()
    if tail:
        out.append(tail)
    return out


def _parse_sql_type(text: str):
    """SQL type text -> DataType. ARRAY<T> and MAP<K, V> raise
    NotImplementedError: the port's types are flat."""
    t = text.strip()
    nullable = True
    if re.search(r"\s+NOT\s+NULL$", t, re.I):
        nullable = False
        t = re.sub(r"\s+NOT\s+NULL$", "", t, flags=re.I).strip()
    if re.match(r"^(ARRAY|MAP)\s*<", t, re.I):
        raise NotImplementedError(f"nested column type {text!r} is not supported by the torch port yet")
    try:
        return parse_type(re.sub(r"\s+", "", t).upper() + ("" if nullable else " NOT NULL"))
    except ValueError as e:
        raise DdlError(str(e)) from None


def _sql_type_text(dtype) -> str:
    """DataType -> DDL type text (inverse of _parse_sql_type); serialize()
    carries NOT NULL."""
    return dtype.serialize()


def _parse_columns(body: str) -> tuple[list[DataField], list[str]]:
    fields: list[DataField] = []
    pks: list[str] = []
    for item in _split_top(body):
        pk = re.match(r"^PRIMARY\s+KEY\s*\(([^)]*)\)(?:\s+NOT\s+ENFORCED)?$", item, re.I)
        if pk:
            pks = [c.strip().strip("`") for c in pk.group(1).split(",") if c.strip()]
            continue
        m = re.match(
            r"^`?(?P<name>\w+)`?\s+(?P<type>[A-Za-z]+(?:\s*[(<].*[)>])?)"
            r"(?P<notnull>\s+NOT\s+NULL)?(?:\s+COMMENT\s+'(?P<comment>(?:[^']|'')*)')?$",
            item.strip(), re.I | re.S,
        )
        if not m:
            raise DdlError(f"cannot parse column definition {item!r}")
        type_text = m.group("type") + (" NOT NULL" if m.group("notnull") else "")
        dtype = _parse_sql_type(type_text)
        comment = m.group("comment").replace("''", "'") if m.group("comment") else None
        fields.append(DataField(len(fields), m.group("name"), dtype, description=comment))
    return fields, pks


def _parse_options(opts: str | None) -> dict[str, str]:
    if not opts:
        return {}
    out = {}
    for item in _split_top(opts):
        m = re.match(r"^'(?P<k>[^']+)'\s*=\s*'(?P<v>[^']*)'$", item.strip())
        if not m:
            raise DdlError(f"cannot parse WITH option {item!r} (expect 'key' = 'value')")
        out[m.group("k")] = m.group("v")
    return out


def _show_batch(name: str, rows: list[str]):
    from ..data.batch import ColumnBatch
    from ..types import STRING

    schema = RowType((DataField(0, name, STRING()),))
    return ColumnBatch.from_pydict(schema, {name: rows})


def ddl(catalog: "Catalog", statement: str) -> Any:
    """Execute one DDL statement. Returns a dict (create/drop), a ColumnBatch
    (SHOW/DESCRIBE), or a string (SHOW CREATE TABLE)."""
    m = _CREATE_TABLE_HEAD_RE.match(statement)
    if m:
        # balanced scan of the column list (types carry their own parens:
        # DECIMAL(10, 2); a single regex cannot pick the closing paren);
        # quoted literals (COMMENT 'a(b') never affect the depth
        depth, i = 1, m.end()
        while i < len(statement) and depth:
            c = statement[i]
            if c == "'":
                j = statement.find("'", i + 1)
                while j != -1 and statement[j : j + 2] == "''":
                    j = statement.find("'", j + 2)
                if j == -1:
                    raise DdlError(f"unterminated string literal in {statement!r}")
                i = j + 1
                continue
            if c == "(":
                depth += 1
            elif c == ")":
                depth -= 1
            i += 1
        if depth:
            raise DdlError(f"unbalanced parentheses in {statement!r}")
        body = statement[m.end() : i - 1]
        tail = _CREATE_TABLE_TAIL_RE.match(statement[i:])
        if not tail:
            raise DdlError(f"cannot parse CREATE TABLE tail: {statement[i:]!r}")
        fields, pks = _parse_columns(body)
        parts = [p.strip().strip("`") for p in (tail.group("parts") or "").split(",") if p.strip()]
        opts = _parse_options(tail.group("opts"))
        try:
            catalog.create_table(
                m.group("name"), RowType(tuple(fields)),
                primary_keys=pks, partition_keys=tuple(parts), options=opts,
                ignore_if_exists=bool(m.group("ine")),
            )
        except (FileExistsError, ValueError) as e:
            if "exists" in str(e):
                raise DdlError(f"table {m.group('name')} already exists") from None
            raise DdlError(str(e)) from e
        return {"created": m.group("name")}
    m = _DROP_TABLE_RE.match(statement)
    if m:
        try:
            exists = catalog.get_table(m.group("name")) is not None
        except FileNotFoundError:
            exists = False
        if not exists:
            if not m.group("ife"):
                raise DdlError(f"table {m.group('name')} does not exist")
            return {"dropped": None}
        catalog.drop_table(m.group("name"))
        return {"dropped": m.group("name")}
    m = _CREATE_DB_RE.match(statement)
    if m:
        catalog.create_database(m.group("name"), ignore_if_exists=bool(m.group("ine")))
        return {"created_database": m.group("name")}
    m = _DROP_DB_RE.match(statement)
    if m:
        # existence check up front: FileIO.delete is a no-op on missing paths,
        # so the catalog's drop never raises by itself
        if m.group("name") not in catalog.list_databases():
            if not m.group("ife"):
                raise DdlError(f"database {m.group('name')} does not exist")
            return {"dropped_database": None}
        catalog.drop_database(m.group("name"))
        return {"dropped_database": m.group("name")}
    if _SHOW_DBS_RE.match(statement):
        return _show_batch("database_name", sorted(catalog.list_databases()))
    m = _SHOW_TABLES_RE.match(statement)
    if m:
        dbs = [m.group("db")] if m.group("db") else sorted(catalog.list_databases())
        rows = [f"{db}.{t}" for db in dbs for t in sorted(catalog.list_tables(db))]
        return _show_batch("table_name", rows)
    m = _SHOW_CREATE_RE.match(statement)
    if m:
        t = _get_table(catalog, m.group("name"))
        cols = []
        for f in t.row_type.fields:
            comment = ""
            if getattr(f, "description", None):
                comment = f" COMMENT '{f.description.replace(chr(39), chr(39) * 2)}'"
            cols.append(f"  `{f.name}` {_sql_type_text(f.type)}{comment}")
        if t.primary_keys:
            cols.append(f"  PRIMARY KEY ({', '.join(t.primary_keys)}) NOT ENFORCED")
        out = f"CREATE TABLE {m.group('name')} (\n" + ",\n".join(cols) + "\n)"
        if t.partition_keys:
            out += f" PARTITIONED BY ({', '.join(t.partition_keys)})"
        opts = {k: v for k, v in t.options.options.to_map().items() if k != "path"}
        if opts:
            out += " WITH (" + ", ".join(f"'{k}' = '{v}'" for k, v in sorted(opts.items())) + ")"
        return out
    m = _DESCRIBE_RE.match(statement)
    if m:
        t = _get_table(catalog, m.group("name"))
        from ..data.batch import ColumnBatch
        from ..types import STRING

        # system tables have a row_type but no key metadata
        pks = getattr(t, "primary_keys", None) or ()
        parts = getattr(t, "partition_keys", None) or ()
        schema = RowType((
            DataField(0, "name", STRING()), DataField(1, "type", STRING()),
            DataField(2, "key", STRING()),
        ))
        return ColumnBatch.from_pydict(schema, {
            "name": [f.name for f in t.row_type.fields],
            "type": [str(f.type) for f in t.row_type.fields],
            "key": ["PRI" if f.name in pks else ("PART" if f.name in parts else "")
                    for f in t.row_type.fields],
        })
    m = _ALTER_RE.match(statement)
    if m:
        return _alter(catalog, m.group("name"), m.group("rest"))
    m = _ANALYZE_RE.match(statement)
    if m:
        from ..table.statistics import analyze_table

        t = _get_table(catalog, m.group("name"))
        stats = analyze_table(t, with_columns=bool(m.group("cols")))
        return {"analyzed": m.group("name"), "rows": stats.merged_record_count,
                "columns": sorted(stats.col_stats) if stats.col_stats else []}
    raise DdlError(f"unrecognized DDL statement: {statement!r}")


def _alter(catalog: "Catalog", name: str, rest: str) -> dict:
    """ALTER TABLE t ADD COLUMN c TYPE | DROP COLUMN c | RENAME COLUMN a TO b
    | MODIFY c TYPE | SET ('k' = 'v', ...) | RESET ('k', ...), lowered onto
    SchemaChange."""
    from ..core.schema import SchemaChange

    changes = []
    add = re.match(
        r"^ADD\s+COLUMN\s+`?(\w+)`?\s+([A-Za-z]+(?:\s*\([\d\s,]*\))?)(\s+NOT\s+NULL)?$",
        rest.strip(), re.I,
    )
    drop = re.match(r"^DROP\s+COLUMN\s+`?(\w+)`?$", rest.strip(), re.I)
    ren = re.match(r"^RENAME\s+COLUMN\s+`?(\w+)`?\s+TO\s+`?(\w+)`?$", rest.strip(), re.I)
    mod = re.match(
        r"^MODIFY\s+(?:COLUMN\s+)?`?(\w+)`?\s+([A-Za-z]+(?:\s*\([\d\s,]*\))?)$",
        rest.strip(), re.I,
    )
    set_m = re.match(r"^SET\s*\((?P<opts>.*)\)$", rest.strip(), re.I | re.S)
    reset_m = re.match(r"^RESET\s*\((?P<keys>.*)\)$", rest.strip(), re.I | re.S)
    if add:
        type_text = re.sub(r"\s+", "", add.group(2)).upper() + (" NOT NULL" if add.group(3) else "")
        try:
            changes.append(SchemaChange.add_column(add.group(1), parse_type(type_text)))
        except ValueError as e:
            raise DdlError(str(e)) from None
    elif drop:
        changes.append(SchemaChange.drop_column(drop.group(1)))
    elif ren:
        changes.append(SchemaChange.rename_column(ren.group(1), ren.group(2)))
    elif mod:
        try:
            changes.append(SchemaChange.update_column_type(
                mod.group(1), parse_type(re.sub(r"\s+", "", mod.group(2)).upper())
            ))
        except ValueError as e:
            raise DdlError(str(e)) from None
    elif set_m:
        for k, v in _parse_options(set_m.group("opts")).items():
            changes.append(SchemaChange.set_option(k, v))
    elif reset_m:
        for item in _split_top(reset_m.group("keys")):
            km = re.match(r"^'([^']+)'$", item.strip())
            if not km:
                raise DdlError(f"RESET expects quoted option keys, got {item!r}")
            changes.append(SchemaChange.remove_option(km.group(1)))
    else:
        raise DdlError(f"unsupported ALTER TABLE clause: {rest!r}")
    try:
        schema = catalog.alter_table(name, *changes)
    except (ValueError, KeyError) as e:
        raise DdlError(str(e)) from e
    return {"altered": name, "schema_id": schema.id}
