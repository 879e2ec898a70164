"""SELECT over tables: the query half of the SQL surface (port of
paimon_tpu/sql/select.py).

    SELECT a, b FROM db.t WHERE k >= 10 AND s LIKE 'x%' ORDER BY a DESC LIMIT 5
    SELECT * FROM db.t$snapshots                    -- system tables too
    SELECT count(*), sum(v), min(v) FROM db.t WHERE k < 100
    SELECT region, count(*), avg(amount) FROM db.t GROUP BY region ORDER BY region
    SELECT f.k, d.name, sum(f.v) FROM db.fact f JOIN db.dim d ON f.k = d.id
        WHERE d.region = 'EU' GROUP BY f.k, d.name

WHERE lowers onto the predicate algebra (file and row-group pruning), the
projection prunes the columns decoded, and a bare LIMIT stops the scan
early. Every scan is the table's merge read on the catalog's device (K1 and
K2 under sort-engine=pallas).

JOIN: single-side WHERE conjuncts push into that side's scan, each side
decodes only the columns the query touches, and the smaller side's join
keys prune the bigger side's scan (an IN list up to
`join.pushdown-in-limit` distinct keys, a BETWEEN above it) before
ops/join.join_batches matches the rows on the device. Inner and LEFT
equi-joins; the residual WHERE evaluates over the joined batch with SQL's
three-valued logic.

GROUP BY encodes the group keys as uint32 code lanes (ops/dicts.py
encode_column, on the host) and reduces on the device through
ops/aggregates.segment_reduce, in the engine `_engine_for` picks: the
table's explicit sort-engine (pallas: the hand kernels; numpy: the host
twin), else plain torch ops. Output rows come in first-appearance order.

Under merge.dict-domain the tables hand over code-backed columns: a join
key prunes the other side from its pool, joins match on the codes, and
GROUP BY takes encode_column's code branch, so a coded group key never
expands. Not ported: the SQL cluster that shares SelectPlan and the GROUP
BY plan with this module (sql/cluster.py).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any

import numpy as np

from .expr import ExprError, eval_mask, parse_expr, to_predicate

if TYPE_CHECKING:
    from ..catalog import FileSystemCatalog as Catalog
    from ..data.batch import ColumnBatch

__all__ = ["query", "explain", "QueryError", "SelectPlan", "parse_select"]


class QueryError(ValueError):
    pass


_EXPLAIN_RE = re.compile(r"^\s*EXPLAIN\s+", re.I)


_SELECT_RE = re.compile(
    r"^\s*SELECT\s+(?:(?P<distinct>DISTINCT)\s+)?(?P<cols>.*?)\s+FROM\s+(?P<from>.*?)"
    r"(?:\s+WHERE\s+(?P<where>.*?))?"
    r"(?:\s+GROUP\s+BY\s+(?P<group>.*?))?"
    r"(?:\s+HAVING\s+(?P<having>.*?))?"
    r"(?:\s+ORDER\s+BY\s+(?P<order>.*?))?"
    r"(?:\s+LIMIT\s+(?P<limit>\d+))?\s*;?\s*$",
    re.I | re.S,
)

# the FROM clause: table [hints] [time travel] [alias] [JOIN table [hints]
# [alias] ON <equi conjunction>]
_KEYWORDS_NOT_ALIAS = r"(?!JOIN\b|INNER\b|LEFT\b|ON\b|AS\b)"
_FROM_RE = re.compile(
    r"^(?P<table>`?[\w.$]+`?)"
    r"(?:\s*/\*\+\s*OPTIONS\s*\((?P<hints>.*?)\)\s*\*/)?"
    r"(?:\s+FOR\s+(?P<tt_kind>VERSION|TIMESTAMP|TAG)\s+AS\s+OF\s+(?P<tt_val>'[^']*'|[^\s;]+))?"
    r"(?:\s+(?:AS\s+)?(?P<alias>" + _KEYWORDS_NOT_ALIAS + r"[A-Za-z_]\w*))?"
    r"(?:\s+(?:(?P<jtype>INNER|LEFT(?:\s+OUTER)?)\s+)?JOIN\s+(?P<jtable>`?[\w.$]+`?)"
    r"(?:\s*/\*\+\s*OPTIONS\s*\((?P<jhints>.*?)\)\s*\*/)?"
    r"(?:\s+(?:AS\s+)?(?P<jalias>" + _KEYWORDS_NOT_ALIAS + r"[A-Za-z_]\w*))?"
    r"\s+ON\s+(?P<on>.*))?$",
    re.I | re.S,
)

_AGG_FNS = ("count", "sum", "min", "max", "avg")


def _split_select_list(cols: str) -> list[str]:
    """Split the projection list on top-level commas (parens guard fn args)."""
    parts, depth, buf = [], 0, []
    for c in cols:
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
        if c == "," and depth == 0:
            parts.append("".join(buf).strip())
            buf = []
        else:
            buf.append(c)
    tail = "".join(buf).strip()
    if tail:
        parts.append(tail)
    return parts


def _parse_agg(item: str):
    """'sum(v)' -> ('sum', 'v') | 'count(*)' -> ('count', '*') | None.
    Join queries may qualify the column: 'sum(f.v)' -> ('sum', 'f.v')."""
    m = re.match(r"^(\w+)\s*\(\s*(\*|`?[\w.]+`?)\s*\)$", item)
    if m and m.group(1).lower() in _AGG_FNS:
        return m.group(1).lower(), m.group(2).strip("`")
    return None


def _dynamic_options(hints: str | None, tt_kind: str | None, tt_val: str | None) -> dict:
    """OPTIONS hints + time travel accumulate into ONE table copy."""
    dynamic: dict[str, str] = {}
    if hints is not None:
        # Flink's dynamic table options: SELECT ... FROM t /*+ OPTIONS('k'='v') */,
        # per-query overrides of any table option: scan modes, time travel,
        # merge knobs, the sort engine
        from .ddl import DdlError, _parse_options

        try:
            parsed = _parse_options(hints)
        except DdlError as e:
            raise QueryError(f"cannot parse OPTIONS hint: {e}") from e
        if not parsed:
            raise QueryError("empty OPTIONS hint")
        dynamic.update(parsed)

    if tt_kind:
        # time travel (Spark grammar: FOR VERSION|TIMESTAMP AS OF; TAG as an
        # explicit alias): lowers onto the scan options
        kind = tt_kind.upper()
        val = (tt_val or "").strip("'")
        if not val:
            raise QueryError(f"FOR {kind} AS OF requires a non-empty value")
        if kind == "VERSION":
            # scan.version resolves a snapshot id or a tag name, as Spark's
            # VERSION AS OF does in Apache Paimon
            dynamic["scan.version"] = val
        elif kind == "TAG":
            dynamic["scan.tag-name"] = val
        elif val.isdigit():
            dynamic["scan.timestamp-millis"] = val
        else:
            import datetime as _dt

            try:
                _dt.datetime.fromisoformat(val)
            except ValueError:
                raise QueryError(
                    f"TIMESTAMP AS OF expects epoch millis or "
                    f"'YYYY-MM-DD[ HH:MM:SS]', got {val!r}"
                ) from None
            dynamic["scan.timestamp"] = val
    return dynamic


def _resolve_table(catalog: "Catalog", name: str, hints, tt_kind, tt_val):
    t = catalog.get_table(name.strip("`"))
    dynamic = _dynamic_options(hints, tt_kind, tt_val)
    if dynamic:
        if not hasattr(t, "copy"):
            raise QueryError(
                "OPTIONS hints / time travel apply to data tables, not system tables"
            )
        t = t.copy(dynamic)
    return t


@dataclass
class SelectPlan:
    """One parsed SELECT, clause by clause."""

    items: list[str]
    aggs: list
    is_agg: bool
    group_cols: list[str]
    order_text: str | None
    limit: int | None
    where_text: str | None
    having_text: str | None
    cols_text: str
    from_match: Any = field(repr=False)

    @property
    def table_name(self) -> str:
        return self.from_match.group("table").strip("`")

    @property
    def is_join(self) -> bool:
        return self.from_match.group("jtable") is not None


def parse_select(statement: str) -> SelectPlan:
    """Parse one SELECT statement into a SelectPlan (clause validation
    included); raises QueryError on anything the grammar does not cover."""
    m = _SELECT_RE.match(statement)
    if not m:
        raise QueryError(f"not a SELECT statement: {statement!r}")
    fm = _FROM_RE.match(m.group("from").strip())
    if not fm:
        raise QueryError(f"cannot parse FROM clause: {m.group('from')!r}")

    cols_text = m.group("cols").strip()
    items = _split_select_list(cols_text)
    aggs = [_parse_agg(i) for i in items]
    is_agg = any(a is not None for a in aggs)
    group_text = m.group("group")
    group_cols = [g.strip().strip("`") for g in group_text.split(",")] if group_text else []
    if m.group("distinct"):
        # SELECT DISTINCT a, b = GROUP BY a, b with no aggregates
        if is_agg or group_cols:
            raise QueryError("DISTINCT cannot combine with aggregates or GROUP BY")
        if cols_text == "*":
            raise QueryError("DISTINCT requires an explicit column list")
        group_cols = [i.strip("`") for i in items]
    if group_cols:
        bad = [i for i, a in zip(items, aggs) if a is None and i.strip("`") not in group_cols]
        if bad:
            raise QueryError(f"non-aggregate select items must appear in GROUP BY: {bad}")
    elif is_agg and not all(a is not None for a in aggs):
        raise QueryError("cannot mix aggregate and plain columns without GROUP BY")
    if m.group("having") and not group_cols:
        raise QueryError("HAVING requires GROUP BY")

    return SelectPlan(
        items=items,
        aggs=aggs,
        is_agg=is_agg,
        group_cols=group_cols,
        order_text=m.group("order"),
        limit=int(m.group("limit")) if m.group("limit") else None,
        where_text=m.group("where"),
        having_text=m.group("having"),
        cols_text=cols_text,
        from_match=fm,
    )


def _engine_for(table) -> str:
    """Engine of the GROUP BY segment-reduce: the table's explicit
    sort-engine (option or hint) wins; with none, plain torch ops ("xla"),
    as the JAX package runs its XLA program. A system table has no store
    and takes "xla" too."""
    from ..options import CoreOptions

    store = getattr(table, "store", None)
    if store is not None and store.options.options.contains(CoreOptions.SORT_ENGINE):
        name = str(store.options.sort_engine.value).lower()
    else:
        name = "xla"
    if "pallas" in name:
        return "pallas"
    if "numpy" in name:
        return "numpy"
    return "xla"


def agg_projection(p: SelectPlan, row_type) -> list[str] | None:
    """Columns an aggregate-only SELECT actually reads (projection pruning
    before the scan is planned): group keys, aggregate arguments, ORDER BY
    keys. A pure count(*) reads a single cheap column — merged row count is
    projection-independent. None = the plan is not aggregate-shaped."""
    if p.group_cols:
        needed = list(
            dict.fromkeys(
                p.group_cols
                + [a[1] for a in p.aggs if a is not None and a[1] != "*"]
                + _having_cols(p.having_text)
                + [c for c in _order_cols(p.order_text) if c in row_type]
            )
        )
    elif p.is_agg:
        needed = list(dict.fromkeys(a[1] for a in p.aggs if a[1] != "*"))
        if not needed:
            needed = [row_type.field_names[0]]
    else:
        return None
    return needed


def explain_plan(catalog: "Catalog", statement: str):
    """Plan facts for one SELECT without executing it: (SelectPlan, table,
    display lines, pushed-down splits)."""
    p = parse_select(statement)
    if p.is_join:
        jt = p.from_match.group("jtable").strip("`")
        return p, None, [
            f"join query: {p.table_name} JOIN {jt}",
            "plan: per-side WHERE/projection pushdown, join-key stats prune "
            "the bigger side, device join kernel (ops.join.join_batches)",
        ], None
    fm = p.from_match
    t = _resolve_table(
        catalog, fm.group("table"), fm.group("hints"), fm.group("tt_kind"), fm.group("tt_val")
    )
    shape = (
        f"grouped aggregate (group by: {', '.join(p.group_cols)})"
        if p.group_cols
        else "scalar aggregate" if p.is_agg else "rows"
    )
    lines = [f"table: {p.table_name}", f"shape: {shape}"]
    if not hasattr(t, "new_read_builder"):
        lines.append("source: system table (static batch; no scan pushdown)")
        return p, t, lines, None
    pred = None
    if p.where_text:
        try:
            pred = to_predicate(parse_expr(p.where_text), p.where_text)
        except ExprError as e:
            raise QueryError(str(e)) from e
    needed = agg_projection(p, t.row_type)
    if needed is None and not p.is_agg and p.cols_text != "*":
        names = [i.strip("`") for i in p.items]
        needed = list(dict.fromkeys(names + _order_cols(p.order_text)))
    if needed is not None:
        for n in needed:
            if n not in t.row_type:
                raise QueryError(f"unknown column {n!r} in {p.table_name}")
    limit_push = (
        p.limit if (not p.is_agg and not p.group_cols and p.order_text is None) else None
    )
    lines.append(f"engine: {_engine_for(t)}")
    lines.append(f"where (pushed): {p.where_text.strip()}" if p.where_text else "where: none")
    lines.append(
        f"projection (pushed): [{', '.join(needed)}]"
        if needed is not None
        else "projection: * (full row)"
    )
    if limit_push is not None:
        lines.append(f"limit (pushed): {limit_push}")
    elif p.limit is not None:
        lines.append(f"limit: {p.limit} (applied after ORDER BY)")
    if p.order_text:
        lines.append(f"order by: {p.order_text.strip()}")
    if p.having_text:
        lines.append(f"having: {p.having_text.strip()}")
    all_splits = t.new_read_builder().new_scan().plan()
    rb = t.new_read_builder()
    if pred is not None:
        rb = rb.with_filter(pred)
    if needed is not None:
        rb = rb.with_projection(list(needed))
    if limit_push is not None:
        rb = rb.with_limit(limit_push)
    splits = rb.new_scan().plan()
    total_files = sum(len(sp.files) for sp in all_splits)
    files = sum(len(sp.files) for sp in splits)
    lines.append(
        f"splits: {len(splits)} (files {files} of {total_files}, "
        f"{total_files - files} pruned)"
    )
    return p, t, lines, splits


def plan_batch(lines: list) -> "ColumnBatch":
    """EXPLAIN wire shape: one STRING column named 'plan', one line per row."""
    from ..data.batch import ColumnBatch
    from ..types import STRING, RowType

    return ColumnBatch.from_pydict(RowType.of(("plan", STRING())), {"plan": list(lines)})


def explain(catalog: "Catalog", statement: str) -> "ColumnBatch":
    """EXPLAIN SELECT ...: the local plan — files pruned, pushed predicates
    / projection / LIMIT, engine, result shape — as a one-column batch."""
    _, _, lines, _ = explain_plan(catalog, statement)
    return plan_batch(lines)


def query(catalog: "Catalog", statement: str) -> "ColumnBatch":
    """Execute one SELECT statement; returns the result as a ColumnBatch.
    ``EXPLAIN SELECT ...`` returns the plan instead (see :func:`explain`)."""
    m = _EXPLAIN_RE.match(statement)
    if m:
        return explain(catalog, statement[m.end():])
    p = parse_select(statement)
    if p.is_join:
        return _join_query(catalog, p)
    fm = p.from_match

    t = _resolve_table(
        catalog, fm.group("table"), fm.group("hints"), fm.group("tt_kind"), fm.group("tt_val")
    )
    table_name = p.table_name
    pred = None
    if p.where_text:
        try:
            pred = to_predicate(parse_expr(p.where_text), p.where_text)
        except ExprError as e:
            raise QueryError(str(e)) from e

    if not hasattr(t, "new_read_builder"):
        # system tables ($snapshots, $files, ...) are static batches:
        # evaluate the clauses directly, no scan pushdown to drive
        out = t.read()
        if pred is not None:
            mask = pred.eval(out)
            if not mask.all():
                out = out.filter(mask)
        engine = "xla"
        device = catalog.device
    else:
        rb = t.new_read_builder()
        if pred is not None:
            rb = rb.with_filter(pred)
        needed = agg_projection(p, t.row_type)
        if needed is not None:
            # decode only what the aggregation consumes
            for n in needed:
                if n not in t.row_type:
                    raise QueryError(f"unknown column {n!r} in {table_name}")
            rb = rb.with_projection(needed)
        elif not p.is_agg:
            if p.cols_text != "*":
                names = [i.strip("`") for i in p.items]
                for n in names:
                    if n not in t.row_type:
                        raise QueryError(f"unknown column {n!r} in {table_name}")
                # ORDER BY columns must survive until after the sort
                order_cols = _order_cols(p.order_text)
                rb = rb.with_projection(list(dict.fromkeys(names + order_cols)))
            if p.limit is not None and p.order_text is None:
                rb = rb.with_limit(p.limit)
        out = rb.new_read().read_all(rb.new_scan().plan())
        engine = _engine_for(t)
        device = t.device

    return _finish(out, p.items, p.aggs, p.is_agg, p.group_cols, p.order_text,
                   p.limit, p.cols_text, having_text=p.having_text, engine=engine, device=device)


def _finish(out, items, aggs, is_agg, group_cols, order_text, limit, cols_text,
            having_text=None, engine="xla", device="cuda"):
    """The engine-independent tail: GROUP BY / aggregates / HAVING /
    ORDER BY / LIMIT / final projection over an already-scanned (or
    joined) batch. (The JAX package's group_reduce / scalar_reduce hooks
    serve its SQL cluster, which is not ported.)"""
    if group_cols:
        # ORDER BY may reference group columns outside the select list: carry
        # them as hidden output columns through the sort, then project away.
        # HAVING likewise: its aggregate calls and group-column refs compute
        # as hidden items, filter after grouping, then project away.
        labels = [i.strip("`") if a is None else re.sub(r"\s+", "", i).lower()
                  for i, a in zip(items, aggs)]
        plain = [i.strip("`") for i, a in zip(items, aggs) if a is None]
        hidden_items: list[str] = []
        hidden_aggs: list = []
        for c in _order_cols(order_text):
            if c in group_cols and c not in plain and c not in hidden_items:
                hidden_items.append(c)
                hidden_aggs.append(None)
        having_node, pmap = None, {}
        if having_text:
            having_node, pmap, extra_items, extra_aggs = _rewrite_having(
                having_text, labels, group_cols, plain + hidden_items
            )
            hidden_items += extra_items
            hidden_aggs += extra_aggs
        out = _group_aggregate(out, items + hidden_items, aggs + hidden_aggs,
                               group_cols, engine=engine, device=device)
        if having_node is not None:
            out = _apply_having(out, having_node, pmap)
        if order_text:
            out = out.take(_order_index(out, order_text))
        if limit is not None:
            out = out.slice(0, min(limit, out.num_rows))
        return out.select(labels) if hidden_items else out
    if is_agg:
        return _aggregate(out, items, aggs)

    if order_text:
        idx = _order_index(out, order_text)
        out = out.take(idx)
    if limit is not None:
        out = out.slice(0, min(limit, out.num_rows))
    if cols_text != "*":
        out = out.select([i.strip("`") for i in items])
    return out


# ---------------------------------------------------------------------------
# JOIN planning
# ---------------------------------------------------------------------------


def _conjuncts(node) -> list:
    return list(node[1]) if node[0] == "and" else [node]


def _col_nodes(node, acc: list) -> list:
    """Collect every ('col', alias, name) reference in an AST."""
    if not isinstance(node, tuple):
        return acc
    if node[0] == "col":
        acc.append(node)
        return acc
    for part in node[1:]:
        if isinstance(part, tuple):
            _col_nodes(part, acc)
        elif isinstance(part, list):
            for p in part:
                _col_nodes(p, acc)
    return acc


class _JoinScope:
    """Name resolution over the two joined tables: alias-qualified refs pin
    a side, bare refs resolve by unique membership; canonical output names
    stay bare when unambiguous and qualify as 'alias.col' on collision."""

    def __init__(self, la, t_l, ra, t_r):
        if la == ra:
            raise QueryError(f"duplicate table alias {la!r} in JOIN")
        self.aliases = (la, ra)
        self.tables = (t_l, t_r)

    def resolve_ref(self, alias, name):
        name = name.strip("`")
        if alias is not None:
            if alias not in self.aliases:
                raise QueryError(
                    f"unknown table alias {alias!r} (have {list(self.aliases)})"
                )
            side = self.aliases.index(alias)
            if name not in self.tables[side].row_type:
                raise QueryError(f"unknown column {name!r} in {alias!r}")
            return side, name
        in_l = name in self.tables[0].row_type
        in_r = name in self.tables[1].row_type
        if in_l and in_r:
            raise QueryError(f"ambiguous column {name!r}: qualify with an alias")
        if in_l:
            return 0, name
        if in_r:
            return 1, name
        raise QueryError(f"unknown column {name!r}")

    def resolve_tok(self, tok: str):
        tok = tok.strip().strip("`")
        if "." in tok:
            a, n = tok.split(".", 1)
            return self.resolve_ref(a, n)
        return self.resolve_ref(None, tok)

    def canonical(self, side: int, col: str) -> str:
        other = self.tables[1 - side]
        if col in other.row_type:
            return f"{self.aliases[side]}.{col}"
        return col


def _estimate_rows(splits) -> int:
    return sum(f.row_count for s in splits for f in getattr(s, "files", []))


def _key_prune_predicate(batch, src_col: str, target_col: str, in_limit: int):
    """The small side's join keys as a predicate on the big side: an exact
    IN list up to in_limit distinct keys, a BETWEEN envelope above it.
    None when the side has no key (the caller then prunes nothing). A
    code-backed key column gives its pool pruned to the valid rows' codes,
    no row expanded."""
    from ..data import predicate as P
    from ..ops.dicts import prune_pool

    col = batch.column(src_col)
    if col.is_code_backed:
        pool, codes = col.dict_cache
        vals = prune_pool(pool, codes, col.validity)[0].tolist() if col.null_count < len(col) else []
    else:
        v = col.values
        if col.validity is not None:
            v = v[col.validity]
        if len(v) == 0:
            return None
        try:
            vals = np.unique(v).tolist()
        except TypeError:
            vals = sorted(set(v.tolist()))
    if not vals:
        return None
    if len(vals) <= in_limit:
        return P.in_(target_col, vals)
    return P.between(target_col, vals[0], vals[-1])


def _join_query(catalog, p: SelectPlan):
    from ..data import predicate as P
    from ..ops.join import JoinError, join_batches, materialize_join

    fm = p.from_match
    items, aggs, is_agg = p.items, p.aggs, p.is_agg
    group_cols, order_text, limit, cols_text = p.group_cols, p.order_text, p.limit, p.cols_text
    how = "left" if (fm.group("jtype") or "").strip().upper().startswith("LEFT") else "inner"
    t_l = _resolve_table(
        catalog, fm.group("table"), fm.group("hints"), fm.group("tt_kind"), fm.group("tt_val")
    )
    t_r = _resolve_table(catalog, fm.group("jtable"), fm.group("jhints"), None, None)
    for t in (t_l, t_r):
        if not hasattr(t, "new_read_builder"):
            raise QueryError("JOIN applies to data tables, not system tables")
    la = fm.group("alias") or fm.group("table").strip("`").split(".")[-1]
    ra = fm.group("jalias") or fm.group("jtable").strip("`").split(".")[-1]
    scope = _JoinScope(la, t_l, ra, t_r)

    # ---- ON: a conjunction of cross-side column equalities ---------------
    try:
        on_ast = parse_expr(fm.group("on"))
    except ExprError as e:
        raise QueryError(f"cannot parse ON clause: {e}") from e
    left_keys, right_keys = [], []
    for c in _conjuncts(on_ast):
        if not (c[0] == "cmp" and c[1] == "=" and c[2][0] == "col" and c[3][0] == "col"):
            raise QueryError(
                "JOIN ON supports a conjunction of equalities between the two "
                f"tables' columns, got {fm.group('on')!r}"
            )
        sides = [scope.resolve_ref(c[2][1], c[2][2]), scope.resolve_ref(c[3][1], c[3][2])]
        if {sides[0][0], sides[1][0]} != {0, 1}:
            raise QueryError("each ON equality must reference BOTH tables")
        pair = dict(sides)
        left_keys.append(pair[0])
        right_keys.append(pair[1])

    # ---- WHERE: single-side conjuncts push into that side's scan ---------
    where_text = p.where_text
    side_preds: list[list] = [[], []]
    residual: list = []
    if where_text:
        try:
            where_ast = parse_expr(where_text)
        except ExprError as e:
            raise QueryError(str(e)) from e
        for c in _conjuncts(where_ast):
            refs = {scope.resolve_ref(n[1], n[2]) for n in _col_nodes(c, [])}
            sides = {s for s, _ in refs}
            pushable = sides == {0} or (sides == {1} and how == "inner")
            if pushable:
                # a LEFT join's right-side conjunct must see post-join NULLs,
                # so only the inner case pushes the right side
                try:
                    side_preds[sides.pop()].append(to_predicate(c, where_text))
                    continue
                except ExprError:
                    pass  # not predicate-lowerable (e.g. col vs col): residual
            residual.append(c)

    # ---- needed columns & output naming ----------------------------------
    def out_cols_for_star():
        cols = [(0, n) for n in t_l.row_type.field_names]
        cols += [(1, n) for n in t_r.row_type.field_names]
        return cols

    plain_refs: list[tuple[int, str]] = []  # select-list order
    if cols_text == "*":
        plain_refs = out_cols_for_star()
        items = [scope.canonical(s, n) for s, n in plain_refs]
        aggs = [None] * len(items)
        cols_text = ", ".join(items)
    else:
        new_items = []
        for item, agg in zip(items, aggs):
            if agg is None:
                side, col = scope.resolve_tok(item)
                plain_refs.append((side, col))
                new_items.append(scope.canonical(side, col))
            elif agg[1] == "*":
                new_items.append(re.sub(r"\s+", "", item).lower())
            else:
                side, col = scope.resolve_tok(agg[1])
                plain_refs.append((side, col))
                canon = scope.canonical(side, col)
                new_items.append(f"{agg[0]}({canon})")
        items = new_items
        aggs = [_parse_agg(i) for i in items]
    group_refs = [scope.resolve_tok(g) for g in group_cols]
    group_cols = [scope.canonical(s, n) for s, n in group_refs]
    order_refs = []
    if order_text:
        parts = []
        for part in [p.strip() for p in order_text.split(",")]:
            toks = part.split()
            side, col = scope.resolve_tok(toks[0])
            order_refs.append((side, col))
            parts.append(" ".join([scope.canonical(side, col)] + toks[1:]))
        order_text = ", ".join(parts)
    residual_refs = [
        scope.resolve_ref(n[1], n[2]) for c in residual for n in _col_nodes(c, [])
    ]

    needed: list[list[str]] = [[], []]
    out_pairs: list[list[tuple[str, str]]] = [[], []]
    seen = set()
    for side, col in plain_refs + group_refs + order_refs + residual_refs:
        if (side, col) not in seen:
            seen.add((side, col))
            out_pairs[side].append((col, scope.canonical(side, col)))
        if col not in needed[side]:
            needed[side].append(col)
    for side, keys in ((0, left_keys), (1, right_keys)):
        for col in keys:
            if col not in needed[side]:
                needed[side].append(col)

    # ---- scans: per-side pushdown + small-side key pruning ---------------
    def builder(side):
        t = scope.tables[side]
        rb = t.new_read_builder()
        preds = side_preds[side]
        if preds:
            rb = rb.with_filter(P.and_(*preds) if len(preds) > 1 else preds[0])
        rb = rb.with_projection(list(needed[side]))
        return rb

    rb_l, rb_r = builder(0), builder(1)
    plan_l, plan_r = rb_l.new_scan().plan(), rb_r.new_scan().plan()
    est = (_estimate_rows(plan_l), _estimate_rows(plan_r))
    # which side's key stats prune the other: the smaller one — except a
    # LEFT join must never prune its preserved (left) side
    prune_from = 0 if (how == "left" or est[0] <= est[1]) else 1
    key_pairs = list(zip(left_keys, right_keys))
    from ..options import CoreOptions

    in_limit = t_l.options.options.get(CoreOptions.JOIN_PUSHDOWN_IN_LIMIT)
    if prune_from == 0:
        batch_l = rb_l.new_read().read_all(plan_l)
        prune = [
            _key_prune_predicate(batch_l, lk, rk, in_limit) for lk, rk in key_pairs
        ]
        prune = [p for p in prune if p is not None]
        if prune:
            rb_r = rb_r.with_filter(P.and_(*prune) if len(prune) > 1 else prune[0])
            plan_r = rb_r.new_scan().plan()
        batch_r = rb_r.new_read().read_all(plan_r)
    else:
        batch_r = rb_r.new_read().read_all(plan_r)
        prune = [
            _key_prune_predicate(batch_r, rk, lk, in_limit) for lk, rk in key_pairs
        ]
        prune = [p for p in prune if p is not None]
        if prune:
            rb_l = rb_l.with_filter(P.and_(*prune) if len(prune) > 1 else prune[0])
            plan_l = rb_l.new_scan().plan()
        batch_l = rb_l.new_read().read_all(plan_l)

    # ---- the join itself -------------------------------------------------
    try:
        res = join_batches(
            batch_l, batch_r, left_keys, right_keys, how=how,
            options=t_l.options.options, device=t_l.device,
        )
    except JoinError as e:
        raise QueryError(str(e)) from e
    joined = materialize_join(batch_l, batch_r, res, out_pairs[0], out_pairs[1])

    # ---- residual WHERE over the joined batch (SQL 3-valued logic) -------
    if residual:

        def resolve(alias, name):
            side, col = scope.resolve_ref(alias, name)
            c = joined.column(scope.canonical(side, col))
            return np.asarray(c.values), c.validity

        node = residual[0] if len(residual) == 1 else ("and", residual)
        try:
            mask = eval_mask(node, resolve, joined.num_rows)
        except ExprError as e:
            raise QueryError(str(e)) from e
        if not mask.all():
            joined = joined.filter(mask)

    # HAVING refs lower onto the joined batch's canonical naming: aggregate
    # arguments resolve through the scope exactly like select items do
    having_text = p.having_text
    if having_text:
        def _canon_call(mo):
            fn = mo.group(1)
            if fn.lower() not in _AGG_FNS:
                return mo.group(0)
            arg = mo.group(2)
            if arg == "*":
                return re.sub(r"\s+", "", mo.group(0)).lower()
            side, col = scope.resolve_tok(arg)
            return f"{fn.lower()}({scope.canonical(side, col)})"

        having_text = _AGG_CALL_RE.sub(_canon_call, having_text)

    return _finish(joined, items, aggs, is_agg, group_cols, order_text, limit, cols_text,
                   having_text=having_text, engine=_engine_for(t_l), device=t_l.device)


_AGG_CALL_RE = re.compile(r"(\w+)\s*\(\s*(\*|`?[\w.]+`?)\s*\)")


def _having_cols(having_text: str | None) -> list[str]:
    """Table columns a HAVING clause's aggregate calls read (its bare column
    refs must be group columns, which the projection already carries)."""
    if not having_text:
        return []
    return [
        mo.group(2).strip("`")
        for mo in _AGG_CALL_RE.finditer(having_text)
        if mo.group(1).lower() in _AGG_FNS and mo.group(2) != "*"
    ]


def _rewrite_having(having_text, labels, group_cols, present):
    """Lower HAVING onto the grouped batch: each aggregate call becomes a
    placeholder column (an existing select-item label when the same call is
    already selected, a hidden extra aggregate otherwise) and bare refs are
    checked against the GROUP BY list. Returns (expr node, placeholder →
    label map, extra hidden items, extra hidden aggs). Refs must use the
    output's canonical naming (join queries: the same names the select list
    resolves to)."""
    pmap: dict[str, str] = {}
    extra_items: list[str] = []
    extra_aggs: list = []

    def repl(mo):
        if mo.group(1).lower() not in _AGG_FNS:
            return mo.group(0)
        norm = re.sub(r"\s+", "", mo.group(0)).lower().replace("`", "")
        for ph, label in pmap.items():
            if label == norm:
                return ph
        ph = f"__h{len(pmap)}"
        pmap[ph] = norm
        if norm not in labels and norm not in extra_items:
            agg = _parse_agg(norm)
            if agg is None:
                raise QueryError(f"unsupported aggregate in HAVING: {mo.group(0)!r}")
            extra_items.append(norm)
            extra_aggs.append(agg)
        return ph

    rewritten = _AGG_CALL_RE.sub(repl, having_text)
    try:
        node = parse_expr(rewritten)
    except ExprError as e:
        raise QueryError(f"cannot parse HAVING: {e}") from e
    for ref in _col_nodes(node, []):
        name = f"{ref[1]}.{ref[2]}" if ref[1] else ref[2].strip("`")
        if name.startswith("__h"):
            continue
        if name not in group_cols:
            raise QueryError(f"HAVING references non-grouped column {name!r}")
        if name not in present and name not in extra_items:
            extra_items.append(name)
            extra_aggs.append(None)
    return node, pmap, extra_items, extra_aggs


def _apply_having(out, node, pmap):
    """Evaluate a rewritten HAVING over the grouped batch (SQL three-valued
    logic via eval_mask: a NULL comparison drops the group)."""
    def resolve(alias, name):
        label = f"{alias}.{name}" if alias else name
        label = pmap.get(label, label)
        if label not in out.schema:
            raise QueryError(f"HAVING references unknown column {label!r}")
        c = out.column(label)
        return np.asarray(c.values), c.validity

    try:
        mask = eval_mask(node, resolve, out.num_rows)
    except ExprError as e:
        raise QueryError(str(e)) from e
    return out if mask.all() else out.filter(mask)


def _order_cols(order_text: str | None) -> list[str]:
    if not order_text:
        return []
    cols = []
    for part in order_text.split(","):
        cols.append(part.split()[0].strip("`"))
    return cols


def _order_index(batch: "ColumnBatch", order_text: str) -> np.ndarray:
    keys = []
    for part in reversed([p.strip() for p in order_text.split(",")]):
        toks = part.split()
        name = toks[0].strip("`")
        desc = len(toks) > 1 and toks[1].lower() == "desc"
        if len(toks) > 2 or (len(toks) == 2 and toks[1].lower() not in ("asc", "desc")):
            raise QueryError(f"bad ORDER BY term {part!r}")
        if name not in batch.schema:
            raise QueryError(f"unknown ORDER BY column {name!r}")
        vals = np.asarray(batch.column(name).values)
        if desc:
            if vals.dtype.kind in "iuf":
                vals = -vals
            else:  # lexsort has no per-key descending: rank-invert instead
                _, inv = np.unique(vals, return_inverse=True)
                vals = -inv
        keys.append(vals)
    return np.lexsort(keys)


def _aggregate(batch: "ColumnBatch", items: list[str], aggs) -> "ColumnBatch":
    from ..data.batch import ColumnBatch
    from ..types import BIGINT, DOUBLE, DataField, RowType

    names, types, values = [], [], []
    for item, (fn, col) in zip(items, aggs):
        label = re.sub(r"\s+", "", item).lower()
        if fn == "count":
            if col == "*":
                v: Any = batch.num_rows
            else:
                c = batch.column(col)
                v = int(c.validity.sum()) if c.validity is not None else batch.num_rows
            ty = BIGINT()
        else:
            if col == "*":
                raise QueryError(f"{fn}(*) is not valid")
            c = batch.column(col)
            vals = np.asarray(c.values)
            if c.validity is not None:
                vals = vals[c.validity]
            def _py(x):
                return x.item() if hasattr(x, "item") else x

            if vals.size == 0:
                v, ty = None, DOUBLE()
            elif fn == "sum":
                v, ty = _py(vals.sum()), batch.schema.field(col).type
            elif fn == "min":
                v, ty = _py(vals.min()), batch.schema.field(col).type
            elif fn == "max":
                v, ty = _py(vals.max()), batch.schema.field(col).type
            else:  # avg
                v, ty = float(vals.mean()), DOUBLE()
        names.append(label)
        types.append(ty)
        values.append(v)
    schema = RowType(tuple(DataField(i, n, ty) for i, (n, ty) in enumerate(zip(names, types))))
    return ColumnBatch.from_pydict(schema, {n: [v] for n, v in zip(names, values)})

# ---------------------------------------------------------------------------
# the GROUP BY plan: group keys to code lanes, one segment_reduce call
# ---------------------------------------------------------------------------


def _agg_kernel_plan(aggs):
    """(kern, imap): `kern` is the deduplicated list of (fn, col) reductions
    the segment-reduce kernel computes (fn in sum|sum_f64|count — avg splits
    into a float64 sum plus a count); `imap` says how each select item
    assembles from kernel outputs."""
    kern: list[tuple[str, str]] = []
    imap: list[tuple] = []

    def _add(fn, col):
        spec = (fn, col)
        if spec in kern:
            return kern.index(spec)
        kern.append(spec)
        return len(kern) - 1

    for a in aggs:
        if a is None:
            imap.append(("group",))
            continue
        fn, col = a
        if fn == "count":
            imap.append(("count", _add("count", col)))
        elif fn == "avg":
            if col == "*":
                raise QueryError("avg(*) is not valid")
            imap.append(("avg", _add("sum_f64", col), _add("count", col)))
        else:
            if col == "*":
                raise QueryError(f"{fn}(*) is not valid")
            imap.append((fn, _add(fn, col)))
    return kern, imap


def _kernel_routable(batch, kern) -> bool:
    """True when every reduced column is numeric (count only reads validity,
    so its argument may be any type); object/bool columns keep the host
    fallback, zero rows produce zero groups without a kernel."""
    if batch.num_rows == 0:
        return False
    for fn, col in kern:
        if fn == "count":
            continue
        if np.asarray(batch.column(col).values).dtype.kind not in "iuf":
            return False
    return True


def _kernel_columns(batch, kern):
    """Materialize kern specs against a batch: (values, valid) pairs plus
    the segment_reduce fn per column."""
    n = batch.num_rows
    cols, fns = [], []
    for fn, col in kern:
        if fn == "count":
            valid = None if col == "*" else batch.column(col).validity
            cols.append((np.ones(n, np.int64), valid))
            fns.append("sum")
        else:
            c = batch.column(col)
            v = np.asarray(c.values)
            if fn == "sum_f64":
                v = v.astype(np.float64, copy=False)
            cols.append((v, c.validity))
            fns.append("sum" if fn == "sum_f64" else fn)
    return cols, tuple(fns)


def _encode_group_lanes(batch, group_cols):
    """Group keys -> uint32 code lanes (ops.dicts.encode_column on the host;
    NULL rows carry the sentinel code)."""
    from ..ops.dicts import encode_column

    pools, codes_list = [], []
    for g in group_cols:
        pool, codes = encode_column(batch.column(g))
        pools.append(pool)
        codes_list.append(codes)
    return pools, codes_list, np.column_stack(codes_list)


def _assemble_group_batch(schema, items, aggs, imap, group_cols, pools, group_codes,
                          outs, anyv, first_pos) -> "ColumnBatch":
    """Kernel outputs -> the grouped result batch, rows in first-appearance
    order (the argsort of each group's minimum input position)."""
    from ..data.batch import ColumnBatch
    from ..types import BIGINT, DOUBLE, DataField, RowType

    order = np.argsort(first_pos, kind="stable")
    names, types, columns = [], [], []
    for item, agg, spec in zip(items, aggs, imap):
        if spec[0] == "group":
            name = item.strip("`")
            gi = group_cols.index(name)
            pool = pools[gi]
            sent = len(pool)
            vals = [
                None if c == sent else (pool[c].item() if hasattr(pool[c], "item") else pool[c])
                for c in group_codes[gi][order].tolist()
            ]
            names.append(name)
            types.append(schema.field(name).type)
            columns.append(vals)
            continue
        label = re.sub(r"\s+", "", item).lower()
        if spec[0] == "count":
            names.append(label)
            types.append(BIGINT())
            columns.append(outs[spec[1]][order].astype(np.int64).tolist())
        elif spec[0] == "avg":
            s = outs[spec[1]][order]
            c = outs[spec[2]][order]
            names.append(label)
            types.append(DOUBLE())
            columns.append([float(s[j] / c[j]) if c[j] else None for j in range(len(c))])
        else:  # sum / min / max
            o = outs[spec[1]][order].tolist()
            av = anyv[spec[1]][order]
            names.append(label)
            types.append(schema.field(agg[1]).type)
            columns.append([o[j] if av[j] else None for j in range(len(o))])
    rt = RowType(tuple(DataField(i, nm, ty) for i, (nm, ty) in enumerate(zip(names, types))))
    return ColumnBatch.from_pydict(rt, dict(zip(names, columns)))


def _device_group_aggregate(batch, items, aggs, group_cols, kern, imap, engine, device):
    from ..ops.aggregates import segment_reduce

    pools, codes_list, lanes = _encode_group_lanes(batch, group_cols)
    cols, fns = _kernel_columns(batch, kern)
    rep, outs, anyv, first_pos = segment_reduce(lanes, cols, fns, engine=engine, device=device)
    group_codes = [c[rep] for c in codes_list]
    return _assemble_group_batch(batch.schema, items, aggs, imap, group_cols,
                                 pools, group_codes, outs, anyv, first_pos)


def _group_aggregate(batch: "ColumnBatch", items, aggs, group_cols, engine="xla", device="cuda") -> "ColumnBatch":
    """GROUP BY. The main path encodes the group keys as uint32 code lanes
    and reduces on the device through ops.aggregates.segment_reduce; object
    or bool aggregate arguments and empty inputs keep the host reduceat
    path. Output rows are in first-appearance order of each group's key."""
    from ..data.batch import ColumnBatch
    from ..types import BIGINT, DOUBLE, DataField, RowType

    n = batch.num_rows
    for g in group_cols:
        if g not in batch.schema:
            raise QueryError(f"unknown GROUP BY column {g!r}")
    kern, imap = _agg_kernel_plan(aggs)
    if _kernel_routable(batch, kern):
        return _device_group_aggregate(batch, items, aggs, group_cols, kern, imap, engine, device)

    def _codes(col):
        """Dense group codes for one column, null-aware: NULL rows form their
        own group (SQL GROUP BY semantics); sentinel-filled values never
        merge with real values."""
        vals = np.asarray(col.values)
        valid = col.validity
        if (valid is None or valid.all()) and vals.dtype != object:
            _, codes = np.unique(vals, return_inverse=True)
            return codes
        if valid is None or valid.all():
            try:  # pure-string object columns sort fine
                _, codes = np.unique(vals, return_inverse=True)
                return codes
            except TypeError:
                pass
        mapping: dict = {}
        codes = np.empty(n, dtype=np.int64)
        vlist = vals.tolist() if vals.dtype != object else vals
        for i in range(n):
            key = None if (valid is not None and not valid[i]) else vlist[i]
            codes[i] = mapping.setdefault(key, len(mapping))
        return codes

    if n == 0:
        gid = np.empty(0, dtype=np.int64)
        uniq_first = np.empty(0, dtype=np.int64)
    else:
        gid = np.zeros(n, dtype=np.int64)
        for g in group_cols:
            codes = _codes(batch.column(g))
            gid = gid * (int(codes.max()) + 1 if len(codes) else 1) + codes
        # remap combined ids to dense group numbers in first-appearance order
        _, first_idx, inv = np.unique(gid, return_index=True, return_inverse=True)
        rank = np.argsort(np.argsort(first_idx))  # unique-id index -> appearance rank
        gid = rank[inv]
        uniq_first = np.sort(first_idx)  # each group's first row, appearance order

    n_groups = len(uniq_first)
    row_order = np.argsort(gid, kind="stable")
    sorted_gid = gid[row_order]
    starts = np.searchsorted(sorted_gid, np.arange(n_groups))
    counts = np.diff(np.concatenate([starts, [n]]))

    names, types, columns = [], [], []
    for item, agg in zip(items, aggs):
        if agg is None:  # a group column: its value at each group's first row
            name = item.strip("`")
            col = batch.column(name)
            arr = np.asarray(col.values)[uniq_first].tolist()
            if col.validity is not None:  # NULL group key surfaces as None
                arr = [None if not col.validity[i] else v for i, v in zip(uniq_first.tolist(), arr)]
            names.append(name)
            types.append(batch.schema.field(name).type)
            columns.append(arr)
            continue
        fn, colname = agg
        label = re.sub(r"\s+", "", item).lower()
        if fn == "count":
            if colname == "*":
                vals_out = counts.astype(np.int64).tolist()
            else:
                c = batch.column(colname)
                valid = c.validity if c.validity is not None else np.ones(n, dtype=bool)
                vals_out = (
                    np.add.reduceat(valid[row_order].astype(np.int64), starts).tolist()
                    if n else []
                )
            names.append(label); types.append(BIGINT()); columns.append(vals_out)
            continue
        if colname == "*":
            raise QueryError(f"{fn}(*) is not valid")
        c = batch.column(colname)
        ty = DOUBLE() if fn == "avg" else batch.schema.field(colname).type
        vals = np.asarray(c.values)[row_order]
        valid = c.validity
        if vals.dtype == object or (valid is not None and not valid.all()):
            # null-aware / object fallback: per-group reduction over the
            # VALID values only (a fully-null group aggregates to NULL)
            sorted_valid = (valid[row_order] if valid is not None else np.ones(n, dtype=bool))
            out = []
            py_vals = vals.tolist() if vals.dtype != object else vals
            for gi in range(n_groups):
                lo = int(starts[gi])
                hi = lo + int(counts[gi])
                vv = [py_vals[i] for i in range(lo, hi) if sorted_valid[i]]
                if not vv:
                    out.append(None)
                elif fn == "sum":
                    out.append(sum(vv))
                elif fn == "min":
                    out.append(min(vv))
                elif fn == "max":
                    out.append(max(vv))
                else:
                    out.append(float(sum(vv)) / len(vv))
        elif fn == "sum":
            out = (np.add.reduceat(vals, starts) if n else np.zeros(0, vals.dtype)).tolist()
        elif fn == "min":
            out = (np.minimum.reduceat(vals, starts) if n else np.zeros(0, vals.dtype)).tolist()
        elif fn == "max":
            out = (np.maximum.reduceat(vals, starts) if n else np.zeros(0, vals.dtype)).tolist()
        else:  # avg
            out = ((np.add.reduceat(vals.astype(np.float64), starts) / counts) if n else np.zeros(0)).tolist()
        names.append(label); types.append(ty); columns.append(out)

    schema = RowType(tuple(DataField(i, nm, ty) for i, (nm, ty) in enumerate(zip(names, types))))
    return ColumnBatch.from_pydict(schema, dict(zip(names, columns)))
