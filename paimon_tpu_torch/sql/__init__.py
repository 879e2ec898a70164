"""SQL: the string entry point of the port (port of
paimon_tpu/sql/__init__.py): `execute` routes one statement (SELECT,
EXPLAIN, DDL, DML or CALL), `execute_script` runs a script of them, and
`call` runs one ``CALL sys.<proc>(...)`` procedure with positional
arguments, ``name => value`` named arguments and SQL literals, onto the
same table-API paths.

    >>> from paimon_tpu_torch.catalog import FileSystemCatalog
    >>> from paimon_tpu_torch.sql import execute
    >>> cat = FileSystemCatalog(warehouse, device="cpu")  # "cuda" by default
    >>> execute(cat, "SELECT s, count(*) FROM db.t GROUP BY s")
    >>> execute(cat, "CALL sys.create_tag('db.t', 'v1')")

Procedures return plain dicts, as in the JAX package. Every procedure keeps
the JAX package's name; those whose modules are not ported yet raise
NotImplementedError naming their ROADMAP item: remove_orphan_files
(resilience/orphan.py), migrate_table / migrate_database / migrate_file
(table/migrate.py), query_service (service/), the privilege procedures
(catalog/privilege.py) and cluster_query (sql/cluster.py). `repair` raises
ProcedureError on a FileSystemCatalog, as in the JAX package.
"""

from __future__ import annotations

import re
from typing import TYPE_CHECKING, Any, Callable

if TYPE_CHECKING:
    from ..catalog import FileSystemCatalog as Catalog

__all__ = ["call", "parse_call", "procedures", "query", "cluster_query",
           "execute", "execute_script", "split_statements"]

_CALL_RE = re.compile(r"^\s*CALL\s+(?:`?sys`?\.)?`?(\w+)`?\s*\((.*)\)\s*;?\s*$", re.I | re.S)


class ProcedureError(ValueError):
    pass


def _tokenize_args(body: str) -> list[str]:
    """Split the argument body on top-level commas, honoring single-quoted
    SQL strings (with '' escaping) and backquoted identifiers."""
    parts: list[str] = []
    buf: list[str] = []
    i, n = 0, len(body)
    while i < n:
        c = body[i]
        if c == "'":
            buf.append(c)
            i += 1
            closed = False
            while i < n:
                buf.append(body[i])
                if body[i] == "'":
                    if i + 1 < n and body[i + 1] == "'":  # '' escape
                        buf.append("'")
                        i += 2
                        continue
                    i += 1
                    closed = True
                    break
                i += 1
            if not closed:
                raise ProcedureError(f"unterminated string literal in arguments: {body!r}")
            continue
        if c == "`":
            j = body.find("`", i + 1)
            if j < 0:
                raise ProcedureError(f"unterminated backquote in arguments: {body!r}")
            buf.append(body[i : j + 1])
            i = j + 1
            continue
        if c == ",":
            parts.append("".join(buf).strip())
            buf = []
            i += 1
            continue
        buf.append(c)
        i += 1
    tail = "".join(buf).strip()
    if tail:
        parts.append(tail)
    return parts


def _literal(tok: str) -> Any:
    """One SQL literal -> python value."""
    t = tok.strip()
    if t.startswith("'") and t.endswith("'"):
        return t[1:-1].replace("''", "'")
    low = t.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    if low == "null":
        return None
    try:
        return int(t)
    except ValueError:
        pass
    try:
        return float(t)
    except ValueError:
        raise ProcedureError(f"unsupported literal: {tok!r}") from None


def parse_call(statement: str) -> tuple[str, list[Any], dict[str, Any]]:
    """'CALL sys.proc(a, k => v)' -> (proc, [a], {k: v})."""
    m = _CALL_RE.match(statement)
    if not m:
        raise ProcedureError(f"not a CALL statement: {statement!r}")
    name = m.group(1).lower()
    args: list[Any] = []
    kwargs: dict[str, Any] = {}
    for tok in _tokenize_args(m.group(2)):
        nm = re.match(r"^`?(\w+)`?\s*=>\s*(.+)$", tok, re.S)
        if nm:
            kwargs[nm.group(1).lower()] = _literal(nm.group(2))
        else:
            if kwargs:
                raise ProcedureError("positional argument after named argument")
            args.append(_literal(tok))
    return name, args, kwargs


# --------------------------------------------------------------------------
# procedure implementations
# --------------------------------------------------------------------------

def _t(cat: "Catalog", ident: str):
    return cat.get_table(ident)


def _proc_compact(cat, table: str, partitions: str | None = None,
                  order_strategy: str | None = None, order_by: str | None = None,
                  full: bool = False):
    """Plain compaction (DedicatedCompactor), or clustered when an order
    strategy is given (zorder/hilbert/order; table/sort_compact.py)."""
    t = _t(cat, table)
    if order_strategy:
        from ..table.sort_compact import sort_compact

        cols = [c.strip() for c in (order_by or "").split(",") if c.strip()]
        if not cols:
            raise ProcedureError("order_by is required with order_strategy")
        n = sort_compact(t, cols, order=order_strategy)
        return {"rows_clustered": n, "strategy": order_strategy}
    from ..table.compactor import DedicatedCompactor

    return {"compacted": DedicatedCompactor(t).run_once(full=full), "full": full}


def _proc_compact_database(cat, including_databases: str | None = None,
                           mode: str | None = None,
                           including_tables: str | None = None,
                           excluding_tables: str | None = None,
                           full: bool = False):
    from ..table.compactor import DedicatedCompactor

    db_pat = re.compile(including_databases or ".*")
    inc = re.compile(including_tables or ".*")
    exc = re.compile(excluding_tables) if excluding_tables else None
    compacted, skipped = [], []
    for db in cat.list_databases():
        if not db_pat.fullmatch(db):
            continue
        for name in cat.list_tables(db):
            ident = f"{db}.{name}"
            if not (inc.fullmatch(ident) or inc.fullmatch(name)):
                continue
            if exc and (exc.fullmatch(ident) or exc.fullmatch(name)):
                continue
            t = cat.get_table(ident)
            try:
                # primary-key and append tables both compact
                if DedicatedCompactor(t).run_once(full=full):
                    compacted.append(ident)
            except (ValueError, NotImplementedError) as e:
                skipped.append({"table": ident, "reason": str(e)})
    return {"compacted": compacted, "skipped": skipped}


def _proc_create_tag(cat, table: str, tag: str, snapshot_id: int | None = None):
    _t(cat, table).create_tag(tag, snapshot_id=snapshot_id)
    return {"tag": tag}


def _proc_delete_tag(cat, table: str, tag: str):
    _t(cat, table).delete_tag(tag)
    return {"deleted_tag": tag}


def _proc_rollback_to(cat, table: str, snapshot_or_tag):
    target = snapshot_or_tag
    if isinstance(target, str) and target.isdigit():
        target = int(target)
    _t(cat, table).rollback_to(target)
    return {"rolled_back_to": target}


def _proc_create_branch(cat, table: str, branch: str, tag: str | None = None):
    from ..table.branch import BranchManager

    t = _t(cat, table)
    BranchManager(t.file_io, t.path).create(branch, from_tag=tag)
    return {"branch": branch}


def _proc_delete_branch(cat, table: str, branch: str):
    from ..table.branch import BranchManager

    t = _t(cat, table)
    BranchManager(t.file_io, t.path).delete(branch)
    return {"deleted_branch": branch}


def _proc_fast_forward(cat, table: str, branch: str):
    from ..table.branch import BranchManager

    t = _t(cat, table)
    BranchManager(t.file_io, t.path).fast_forward(branch)
    return {"fast_forwarded": branch}


def _proc_expire_snapshots(cat, table: str, retain_max: int | None = None,
                           retain_min: int | None = None,
                           older_than: str | None = None,
                           max_deletes: int | None = None):
    t = _t(cat, table)
    overrides = {}
    if retain_max is not None:
        overrides["snapshot.num-retained.max"] = str(retain_max)
    if retain_min is not None:
        overrides["snapshot.num-retained.min"] = str(retain_min)
    if max_deletes is not None:
        overrides["snapshot.expire.limit"] = str(max_deletes)
    if overrides:
        t = t.copy(overrides)
    return {"expired": t.expire_snapshots()}


def _proc_expire_partitions(cat, table: str, expiration_time: str,
                            timestamp_formatter: str = "%Y-%m-%d",
                            timestamp_pattern: str | None = None):
    from ..options import parse_duration_millis
    from ..table.maintenance import expire_partitions

    t = _t(cat, table)
    expired = expire_partitions(
        t,
        parse_duration_millis(expiration_time),
        time_col=timestamp_pattern,
        pattern=timestamp_formatter,
    )
    return {"expired_partitions": [list(p) for p in expired]}


def _parse_partition_specs(partitions: str) -> list[dict]:
    """Apache Paimon's partition-string syntax: 'k1=v1,k2=v2;k1=v3' (';' separates
    multiple specs)."""
    specs = []
    for spec in partitions.split(";"):
        if spec.strip():
            specs.append(dict(kv.strip().split("=", 1) for kv in spec.split(",")))
    return specs


def _proc_drop_partition(cat, table: str, partitions: str):
    from ..table.maintenance import drop_partition

    dropped = drop_partition(_t(cat, table), *_parse_partition_specs(partitions))
    return {"dropped_partitions": [list(p) for p in dropped]}


def _proc_mark_partition_done(cat, table: str, partitions: str):
    from ..table.maintenance import mark_partition_done

    paths = mark_partition_done(_t(cat, table), _parse_partition_specs(partitions))
    return {"markers": paths}


def _proc_reset_consumer(cat, table: str, consumer_id: str,
                         next_snapshot_id: int | None = None):
    from ..table.consumer import ConsumerManager

    t = _t(cat, table)
    cm = ConsumerManager(t.file_io, t.path)
    if next_snapshot_id is None:
        cm.delete(consumer_id)
        return {"deleted_consumer": consumer_id}
    cm.record(consumer_id, next_snapshot_id)
    return {"consumer": consumer_id, "next_snapshot": next_snapshot_id}


def _parse_where(where: str):
    """WHERE argument -> Predicate|None: a SQL expression string, or the
    JAX package's legacy JSON form {"field", "op", "value"}."""
    where = where.strip()
    if where.startswith("{"):
        import json as _json

        from ..data import predicate as P

        d = _json.loads(where)
        op = d.get("op", "=")
        fns = {"=": P.equal, "!=": P.not_equal, ">": P.greater_than,
               ">=": P.greater_or_equal, "<": P.less_than, "<=": P.less_or_equal}
        if op == "in":
            return P.in_(d["field"], d["value"])
        if op == "is_null":
            return P.is_null(d["field"])
        return fns[op](d["field"], d["value"])
    from .expr import ExprError, parse_where

    try:
        return parse_where(where)
    except ExprError as e:
        raise ProcedureError(str(e)) from e


def _proc_delete(cat, table: str, where: str):
    """DELETE by a SQL expression ("dt = '2024-01-01' AND hh >= 10")."""
    pred = _parse_where(where)
    if pred is None:
        raise ProcedureError("refusing unconditional DELETE; pass an explicit WHERE")
    return {"rows_deleted": _t(cat, table).delete_where(pred)}


def _proc_merge_into(cat, target_table: str, target_alias: str = "",
                     source_sqls: str = "", source_table: str = "",
                     merge_condition: str = "",
                     matched_upsert_condition: str = "",
                     matched_upsert_setting: str = "",
                     not_matched_insert_condition: str = "",
                     not_matched_insert_values: str = "",
                     matched_delete_condition: str = ""):
    """The string surface of table/rowops.py MergeInto. '' stands for an
    unused argument. The short delete form `CALL sys.merge_into(tgt, alias,
    '', src, cond, del)` is recognised by _merge_into_dispatch from the
    positional shape only: a named matched_upsert_condition is never taken
    for a delete."""
    from .expr import ExprError, eval_mask, eval_value, parse_assignments, parse_expr

    if source_sqls:
        raise ProcedureError(
            "source_sqls is not supported (no SQL DDL engine); register the "
            "source as a catalog table and pass source_table"
        )
    if not source_table:
        raise ProcedureError("source_table is required")
    if matched_upsert_condition and not matched_upsert_setting:
        raise ProcedureError("matched-upsert must set the 'matched_upsert_setting' argument")

    t = _t(cat, target_table)
    src_t = _t(cat, source_table)
    rb = src_t.new_read_builder()
    source = rb.new_read().read_all(rb.new_scan().plan())

    tgt_names = {a for a in (target_alias, target_table.split(".")[-1], "tgt", "t") if a}
    src_names = {a for a in (source_table.split(".")[-1], "src", "s") if a} - tgt_names

    def make_resolver(src_b, tgt_b):
        def resolve(alias, name):
            order = []
            if alias is None:
                order = [b for b in (src_b, tgt_b) if b is not None]
            elif alias in src_names:
                order = [src_b]
            elif alias in tgt_names:
                if tgt_b is None:
                    raise ProcedureError(f"'{alias}.{name}': no target row in NOT MATCHED clause")
                order = [tgt_b]
            else:
                raise ProcedureError(f"unknown table alias {alias!r} in merge_into")
            for b in order:
                if name in b.schema:
                    c = b.column(name)
                    import numpy as _np

                    return _np.asarray(c.values), c.validity
            raise ProcedureError(f"unknown column {name!r} in merge_into")

        return resolve

    def cond_fn(expr_text):
        if not expr_text or expr_text.strip().upper() == "TRUE":
            return None
        ast = parse_expr(expr_text)

        def fn(src_b, tgt_b=None):
            return eval_mask(ast, make_resolver(src_b, tgt_b), src_b.num_rows)

        return fn

    def value_fn(ast):
        def fn(src_b, tgt_b=None):
            return eval_value(ast, make_resolver(src_b, tgt_b), src_b.num_rows)

        return fn

    # the merge condition must equi-join on the full target primary key
    if merge_condition:
        ast = parse_expr(merge_condition)
        parts = ast[1] if ast[0] == "and" else [ast]
        joined = set()
        for p in parts:
            ok = (
                p[0] == "cmp" and p[1] == "=" and p[2][0] == "col" and p[3][0] == "col"
                and p[2][2] == p[3][2]
            )
            if not ok:
                raise ProcedureError(
                    f"merge_condition must be an equi-join on the primary key, got {merge_condition!r}"
                )
            joined.add(p[2][2])
        if joined != set(t.primary_keys):
            raise ProcedureError(
                f"merge_condition must cover the full primary key {sorted(t.primary_keys)}, got {sorted(joined)}"
            )

    from ..table.rowops import MergeInto

    m = MergeInto(t, source)
    try:
        if matched_upsert_setting:
            assigns = parse_assignments(matched_upsert_setting)
            if assigns and assigns[0][0] == "*":
                set_map = {
                    f.name: f"src.{f.name}"
                    for f in t.row_type.fields
                    if f.name not in t.primary_keys and f.name in source.schema
                }
            else:
                set_map = {col: value_fn(ast) for col, ast in assigns}
            m.when_matched_update(set_map, condition=cond_fn(matched_upsert_condition))
        if matched_delete_condition:
            m.when_matched_delete(condition=cond_fn(matched_delete_condition))
        if not_matched_insert_values:
            if not_matched_insert_values.strip() == "*":
                values = None
            else:
                if "=" in not_matched_insert_values:  # 'col = expr, ...' form
                    values = {
                        col: value_fn(ast)
                        for col, ast in parse_assignments(not_matched_insert_values)
                    }
                else:
                    # positional list over the target schema
                    from .expr import _Parser, _tokenize  # noqa: SLF001

                    p = _Parser(_tokenize(not_matched_insert_values), not_matched_insert_values)
                    asts = [p.parse_operand()]
                    while p.peek() == ("op", ","):
                        p.next()
                        asts.append(p.parse_operand())
                    fields = t.row_type.fields
                    if len(asts) != len(fields):
                        raise ProcedureError(
                            f"not_matched_insert_values has {len(asts)} expressions; "
                            f"target has {len(fields)} columns"
                        )
                    values = {f.name: value_fn(a) for f, a in zip(fields, asts)}
            m.when_not_matched_insert(values=values, condition=cond_fn(not_matched_insert_condition))
        r = m.execute()
    except ExprError as e:
        raise ProcedureError(str(e)) from e
    return {"rows_updated": r.rows_updated, "rows_deleted": r.rows_deleted,
            "rows_inserted": r.rows_inserted}


def _merge_into_dispatch(cat, *args, **kwargs):
    """Positional calls only: exactly 6 positional arguments are the short
    delete form (tgt, alias, sqls, src, merge_cond, delete_cond). Named
    arguments always mean what they say."""
    if len(args) == 6 and not kwargs:
        return _proc_merge_into(
            cat, args[0], args[1], args[2], args[3], args[4],
            matched_delete_condition=args[5],
        )
    return _proc_merge_into(cat, *args, **kwargs)


def _not_ported(name: str, module: str, item: int):
    def proc(cat, *args, **kwargs):
        raise NotImplementedError(
            f"CALL sys.{name} needs {module}, which the torch port does not have yet (ROADMAP Queue 1 item {item})"
        )

    proc.__name__ = f"_proc_{name}"
    return proc


def _proc_repair(cat, identifier: str | None = None):
    """Sync catalog metadata with the filesystem: only catalogs that keep
    metadata of their own support it, not a FileSystemCatalog."""
    repair = getattr(cat, "repair", None)
    if repair is None:
        raise ProcedureError(f"catalog {type(cat).__name__} does not support repair")
    return repair() if identifier is None else repair(identifier)


def _proc_rewrite_file_index(cat, table: str, partitions: str | None = None):
    """Build the file indexes of data files written before indexing was
    enabled: for each live file without one, build the configured column
    blooms (and the composite key bloom of a primary-key table under
    file-index.bloom-filter.primary-key.enabled) from the file's rows, and
    commit one COMPACT snapshot that swaps each file's metadata for the same
    file with its index (embedded, or in a .index sidecar). Returns
    {"rewritten": files, "columns": bloom columns}."""
    import dataclasses

    from ..format.fileindex import build_index_payload, index_path, resolve_key_bloom
    from ..options import CoreOptions

    t = _t(cat, table)
    opts = t.options
    cols_opt = opts.options.get(CoreOptions.FILE_INDEX_BLOOM_COLUMNS)
    key_bloom = (
        resolve_key_bloom(opts.options.get(CoreOptions.FILE_INDEX_BLOOM_KEY_ENABLED))
        and t.is_primary_key_table
    )
    if not cols_opt and not key_bloom:
        raise ProcedureError(
            "table has no file-index.bloom-filter.columns (or primary-key "
            "bloom) configured; set the option, then CALL sys.rewrite_file_index"
        )
    bloom_cols = [c.strip() for c in cols_opt.split(",") if c.strip()] if cols_opt else []
    fpp = opts.options.get(CoreOptions.FILE_INDEX_BLOOM_FPP)
    threshold = opts.options.get(CoreOptions.FILE_INDEX_IN_MANIFEST_THRESHOLD)
    part_filter = _parse_partition_specs(partitions) if partitions else None

    store = t.store
    snap = store.snapshot_manager.latest_snapshot_id()
    if snap is None:
        return {"rewritten": 0}
    plan = store.new_scan().plan()
    from ..core.manifest import CommitMessage

    by_pb: dict[tuple, CommitMessage] = {}
    rewritten = 0
    for e in plan.entries:
        f = e.file
        if f.embedded_index is not None or any(x.endswith(".index") for x in f.extra_files):
            continue  # already indexed
        if part_filter is not None:
            part_names = t.partition_keys
            spec_match = any(
                all(str(dict(zip(part_names, e.partition)).get(k)) == v for k, v in spec.items())
                for spec in part_filter
            )
            if not spec_match:
                continue
        rf = store.reader_factory(e.partition, e.bucket)
        present = [c for c in bloom_cols if c in t.row_type]
        if not present and not key_bloom:
            continue
        read_fields = sorted(set(present) | (set(store.key_names) if key_bloom else set()))
        kv = rf.read(f, fields=read_fields, system_columns=False)
        hashes = None
        if key_bloom:
            from ..table.bucket import key_hashes

            hashes = key_hashes(kv.data, store.key_names)
        payload = build_index_payload(kv.data, present, fpp, key_hashes=hashes)
        if payload is None:
            continue
        extra = list(f.extra_files)
        embedded = None
        if len(payload) <= threshold:
            embedded = payload
        else:
            data_path = f"{rf.bucket_dir}/{f.file_name}"
            t.file_io.write_bytes(index_path(data_path), payload, overwrite=True)
            extra.append(f.file_name + ".index")
        new_meta = dataclasses.replace(f, extra_files=tuple(extra), embedded_index=embedded)
        key = (e.partition, e.bucket)
        msg = by_pb.get(key)
        if msg is None:
            msg = by_pb[key] = CommitMessage(
                partition=e.partition, bucket=e.bucket, total_buckets=e.total_buckets
            )
        msg.compact_before.append(f)
        msg.compact_after.append(new_meta)
        rewritten += 1
    if by_pb:
        from ..core.commit import BATCH_COMMIT_IDENTIFIER
        from ..table.write import TableCommit

        TableCommit(t).commit_messages(BATCH_COMMIT_IDENTIFIER, list(by_pb.values()))
    return {"rewritten": rewritten, "columns": bloom_cols}


procedures: dict[str, Callable[..., Any]] = {
    "compact": _proc_compact,
    "compact_database": _proc_compact_database,
    "create_tag": _proc_create_tag,
    "delete_tag": _proc_delete_tag,
    "rollback_to": _proc_rollback_to,
    "create_branch": _proc_create_branch,
    "delete_branch": _proc_delete_branch,
    "fast_forward": _proc_fast_forward,
    "expire_snapshots": _proc_expire_snapshots,
    "expire_partitions": _proc_expire_partitions,
    "drop_partition": _proc_drop_partition,
    "mark_partition_done": _proc_mark_partition_done,
    "remove_orphan_files": _not_ported("remove_orphan_files", "resilience/orphan.py", 15),
    "reset_consumer": _proc_reset_consumer,
    "delete": _proc_delete,
    "merge_into": _merge_into_dispatch,
    "migrate_table": _not_ported("migrate_table", "table/migrate.py", 15),
    "migrate_database": _not_ported("migrate_database", "table/migrate.py", 15),
    "migrate_file": _not_ported("migrate_file", "table/migrate.py", 15),
    "repair": _proc_repair,
    "query_service": _not_ported("query_service", "service/", 15),
    "rewrite_file_index": _proc_rewrite_file_index,
    **{
        name: _not_ported(name, "catalog/privilege.py", 15)
        for name in ("init_file_based_privilege", "create_privileged_user", "drop_privileged_user",
                     "grant_privilege_to_user", "revoke_privilege_from_user")
    },
}


def call(catalog: "Catalog", statement: str) -> Any:
    """Execute one ``CALL sys.<proc>(...)`` statement against a catalog."""
    name, args, kwargs = parse_call(statement)
    fn = procedures.get(name)
    if fn is None:
        raise ProcedureError(
            f"unknown procedure {name!r}; available: {sorted(procedures)}"
        )
    try:
        return fn(catalog, *args, **kwargs)
    except TypeError as e:
        # surface signature mistakes as procedure errors with the usage
        raise ProcedureError(f"CALL {name}: {e}") from e


def query(catalog: "Catalog", statement: str):
    """Execute one SELECT statement (see sql.select for the grammar)."""
    from .select import query as _query

    return _query(catalog, statement)


def cluster_query(
    catalog: "Catalog", statement: str, client, busy_wait_s: float = 10.0, scan_frag_fn=None
):
    """One SELECT across cluster-service workers: needs sql/cluster.py and
    service/, which the torch port does not have yet."""
    raise NotImplementedError(
        "cluster_query needs sql/cluster.py and service/, which the torch port does not have yet "
        "(ROADMAP Queue 1 items 14 and 15)"
    )


def split_statements(script: str) -> list[str]:
    """Split a SQL script on top-level semicolons. ONE scanner pass with
    quote state carried across newlines: single-quoted literals (with ''
    escapes, including multi-line literals) and backticked identifiers keep
    their ';' and '--'; `-- line comments` outside quotes are stripped."""
    stmts: list[str] = []
    buf: list[str] = []
    i, n = 0, len(script)
    while i < n:
        c = script[i]
        if c == "'":
            j = script.find("'", i + 1)
            while j != -1 and script[j : j + 2] == "''":
                j = script.find("'", j + 2)
            if j == -1:  # unterminated: keep verbatim; the parser reports it
                buf.append(script[i:])
                break
            buf.append(script[i : j + 1])
            i = j + 1
            continue
        if c == "`":
            j = script.find("`", i + 1)
            if j == -1:
                buf.append(script[i:])
                break
            buf.append(script[i : j + 1])
            i = j + 1
            continue
        if script[i : i + 2] == "--":
            j = script.find("\n", i)
            i = n if j == -1 else j  # keep the newline as whitespace
            continue
        if c == ";":
            stmts.append("".join(buf).strip())
            buf = []
            i += 1
            continue
        buf.append(c)
        i += 1
    tail = "".join(buf).strip()
    if tail:
        stmts.append(tail)
    return [s for s in stmts if s]


def execute_script(catalog: "Catalog", script: str) -> list[Any]:
    """Run a multi-statement SQL script in order; returns one result per
    statement. A failure stops the script (statements already executed have
    committed: each statement is atomic on its own)."""
    return [execute(catalog, s) for s in split_statements(script)]


def execute(catalog: "Catalog", statement: str) -> Any:
    """One string entry point: SELECT -> ColumnBatch, CALL -> procedure
    dict, DDL (CREATE/DROP/SHOW/DESCRIBE) -> dict | ColumnBatch | str."""
    if re.match(r"^\s*(EXPLAIN\s+)?SELECT\b", statement, re.I):
        return query(catalog, statement)
    if re.match(r"^\s*(CREATE|DROP|ALTER|SHOW|DESC(RIBE)?|ANALYZE)\b", statement, re.I):
        from .ddl import ddl as _ddl

        return _ddl(catalog, statement)
    if re.match(r"^\s*INSERT\b", statement, re.I):
        from .dml import insert

        return insert(catalog, statement)
    if re.match(r"^\s*UPDATE\b", statement, re.I):
        from .dml import update

        return update(catalog, statement)
    if re.match(r"^\s*DELETE\s+FROM\b", statement, re.I):
        from .dml import delete as dml_delete

        return dml_delete(catalog, statement)
    if re.match(r"^\s*TRUNCATE\b", statement, re.I):
        from .dml import truncate

        return truncate(catalog, statement)
    return call(catalog, statement)
