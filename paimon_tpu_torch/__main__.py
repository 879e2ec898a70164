"""The actions CLI of the port: `python -m paimon_tpu_torch <action> ...`
(port of paimon_tpu/__main__.py).

The maintenance and ingestion actions an operator runs without writing
code: compact, sort-compact, delete, tags, rollback, snapshot and
partition expiry, orphan cleanup, migration, clone, CDC sync, queries, and
`call` / `sql` for any CALL procedure or SQL statement. Each action prints
one JSON object (query and SELECT: one JSON row per line), with the JAX
package's arguments and output.

repair syncs a JdbcCatalog (catalog/jdbc.py, --jdbc-path) with its
warehouse; query-service runs the KV query service (service/) for a table
for --serve-seconds, or until interrupted.

Every action takes --device {cuda,cpu} (default cuda), the device of each
catalog it opens; without a CUDA device the default raises RuntimeError. A
usage mistake exits with argparse's code 2 before the device is resolved.
"""

from __future__ import annotations

import argparse
import json
import sys

_ACTIONS = (
    "compact",
    "sort_compact",
    "delete",
    "create_tag",
    "delete_tag",
    "list_tags",
    "rollback_to",
    "expire_snapshots",
    "remove_orphan_files",
    "migrate_table",
    "query",
    "sync_table",
    "create_branch",
    "fast_forward",
    "clone",
    "compact_database",
    "reset_consumer",
    "expire_partitions",
    "drop_partition",
    "mark_partition_done",
    "query_service",
    "repair",
    "migrate_database",
)

def _add_common(p):
    p.add_argument("--warehouse", required=True, help="warehouse directory")
    p.add_argument("--table", required=True, help="db.table identifier")
    p.add_argument("--user", default="cli", help="commit user")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="paimon_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="action", required=True)
    for name in _ACTIONS:
        p = sub.add_parser(name.replace("_", "-"))
        if name not in ("migrate_table", "clone", "compact_database", "repair", "migrate_database"):
            _add_common(p)
        if name == "compact":
            p.add_argument("--full", action="store_true")
        elif name == "sort_compact":
            p.add_argument("--order-by", required=True, help="comma-separated cluster columns")
            p.add_argument("--strategy", default="zorder", choices=["zorder", "hilbert", "order"])
        elif name == "delete":
            p.add_argument("--where", required=True, help='predicate json: {"field":..,"op":..,"value":..}')
        elif name in ("create_tag", "delete_tag"):
            p.add_argument("--tag", required=True)
            if name == "create_tag":
                p.add_argument("--snapshot", type=int, default=None)
        elif name == "rollback_to":
            p.add_argument("--to", required=True, help="snapshot id or tag name")
        elif name == "remove_orphan_files":
            p.add_argument("--older-than-hours", type=float, default=None,
                           help="safety threshold (default: table option orphan.clean.older-than, 1 day)")
            p.add_argument("--dry-run", action="store_true")
        elif name == "migrate_table":
            p.add_argument("--warehouse", required=True)
            p.add_argument("--table", required=True, help="target db.table")
            p.add_argument("--source-dir", required=True, help="directory of parquet/orc files")
            p.add_argument("--format", default="parquet")
            p.add_argument("--user", default="cli")
        elif name == "query":
            p.add_argument("--limit", type=int, default=20)
            p.add_argument("--filter", default=None, help="predicate json")
        elif name == "sync_table":
            p.add_argument("--format", default="debezium-json", help="cdc format")
            p.add_argument("--input", default="-", help="file of json messages (- = stdin)")
        elif name in ("create_branch", "fast_forward"):
            p.add_argument("--branch", required=True)
        elif name == "clone":
            p.add_argument("--warehouse", required=True, help="source warehouse")
            p.add_argument("--database", default=None, help="source database (omit = all)")
            p.add_argument("--table", default=None, help="source table (omit = whole database)")
            p.add_argument("--target-warehouse", required=True)
            p.add_argument("--target-database", default=None)
            p.add_argument("--target-table", default=None)
            p.add_argument("--tag", default=None, help="clone this tag's snapshot")
            p.add_argument("--branch", default=None, help="clone from this branch")
            p.add_argument("--parallelism", type=int, default=8)
            p.add_argument("--user", default="cli")
        elif name == "compact_database":
            p.add_argument("--warehouse", required=True)
            p.add_argument("--including-databases", default=None, help="regex (default .*)")
            p.add_argument("--including-tables", default=None, help="regex (default .*)")
            p.add_argument("--excluding-tables", default=None, help="regex")
            p.add_argument("--full", action="store_true")
            p.add_argument("--user", default="cli")
        elif name == "reset_consumer":
            p.add_argument("--consumer-id", required=True)
            p.add_argument("--next-snapshot", type=int, default=None, help="omit = delete consumer")
        elif name == "expire_partitions":
            p.add_argument("--expiration-time-hours", type=float, required=True)
            p.add_argument("--timestamp-formatter", default="%Y-%m-%d")
            p.add_argument("--time-col", default=None, help="partition key holding the timestamp")
        elif name in ("drop_partition", "mark_partition_done"):
            p.add_argument("--partition", required=True, action="append", help="k=v[,k=v...] (repeatable)")
        elif name == "query_service":
            p.add_argument("--host", default="127.0.0.1")
            p.add_argument("--port", type=int, default=0, help="0 = ephemeral")
            p.add_argument("--serve-seconds", type=float, default=None,
                           help="exit after this many seconds (tests); default: run until interrupted")
        elif name == "repair":
            p.add_argument("--warehouse", required=True)
            p.add_argument("--jdbc-path", required=True, help="sqlite db of the JdbcCatalog to repair")
            p.add_argument("--user", default="cli")
        elif name == "migrate_database":
            p.add_argument("--warehouse", required=True)
            p.add_argument("--database", required=True, help="target database")
            p.add_argument("--source-dir", required=True,
                           help="directory of per-table subdirectories of parquet/orc files")
            p.add_argument("--format", default="parquet")
            p.add_argument("--user", default="cli")

    p = sub.add_parser("call", help="execute a SQL CALL procedure statement")
    p.add_argument("--warehouse", required=True)
    p.add_argument("--user", default="cli")
    p.add_argument("statement", help="e.g. \"CALL sys.compact(`table` => 'db.t')\"")

    p = sub.add_parser("sql", help="execute SQL statements (SELECT/DDL/DML/CALL)")
    p.add_argument("--warehouse", required=True)
    p.add_argument("--user", default="cli")
    p.add_argument("--file", help="run a multi-statement .sql script file")
    p.add_argument("statement", nargs="?", default=None,
                   help="e.g. \"SELECT k, v FROM db.t WHERE k > 5 LIMIT 10\"")

    for p in sub.choices.values():
        p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="device of the merge kernels (default cuda)")
    return ap


def _usage_errors(ap: argparse.ArgumentParser, args, action: str) -> None:
    """The JAX package's usage checks, made before the device is resolved."""
    if action == "sql":
        if args.file and args.statement:
            ap.error("pass a statement or --file, not both")
        if not args.file and args.statement is None:
            ap.error("sql needs a statement or --file")
    elif action == "clone":
        if not args.table and (args.tag or args.branch or args.target_table):
            ap.error("--tag/--branch/--target-table require --table")
        if not args.database and args.target_database:
            ap.error("--target-database requires --database")
        if args.table and not args.database:
            ap.error("--table requires --database")


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    action = args.action.replace("-", "_")
    _usage_errors(ap, args, action)

    from .catalog import FileSystemCatalog
    from .utils import resolve_device

    device = resolve_device(args.device)

    def catalog(warehouse: str) -> FileSystemCatalog:
        return FileSystemCatalog(warehouse, commit_user=args.user, device=device)

    if action == "call":
        from .sql import call as sql_call

        print(json.dumps(sql_call(catalog(args.warehouse), args.statement), default=str))
        return 0

    if action == "sql":
        from .sql import execute as sql_execute, split_statements

        cat = catalog(args.warehouse)
        if args.file:
            with open(args.file) as f:
                statements = split_statements(f.read())
        else:
            statements = split_statements(args.statement)
        for stmt in statements:
            out = sql_execute(cat, stmt)
            if hasattr(out, "to_pylist"):  # SELECT/SHOW -> one JSON row per line
                for row in out.to_pylist():
                    print(json.dumps(list(row), default=str))
            elif isinstance(out, str):  # SHOW CREATE TABLE
                print(out)
            else:
                print(json.dumps(out, default=str))
        return 0

    if action == "clone":
        from .table import clone as C

        src_cat, dst_cat = catalog(args.warehouse), catalog(args.target_warehouse)
        if args.table:
            t = src_cat.get_table(f"{args.database}.{args.table}")
            sid = None
            if args.branch:
                from .table.branch import branch_table

                t = branch_table(t, args.branch)
            if args.tag:
                from .table.tags import TagManager

                sid = TagManager(t.file_io, t.path).snapshot_id(args.tag)
            target = f"{args.target_database or args.database}.{args.target_table or args.table}"
            C.clone_table(t, dst_cat, target, snapshot_id=sid, parallelism=args.parallelism)
            cloned = [target]
        elif args.database:
            cloned = C.clone_database(src_cat, args.database, dst_cat, args.target_database,
                                      parallelism=args.parallelism)
        else:
            cloned = C.clone_warehouse(src_cat, dst_cat, parallelism=args.parallelism)
        print(json.dumps({"cloned": cloned}))
        return 0

    if action == "compact_database":
        # one implementation: the SQL procedure's (the CLI and CALL agree)
        from .sql import _proc_compact_database

        out = _proc_compact_database(
            catalog(args.warehouse),
            including_databases=args.including_databases,
            including_tables=args.including_tables,
            excluding_tables=args.excluding_tables,
            full=args.full,
        )
        print(json.dumps({**out, "full": args.full}))
        return 0

    if action == "repair":
        from .catalog.jdbc import JdbcCatalog

        cat = JdbcCatalog(args.jdbc_path, args.warehouse, commit_user=args.user, device=device)
        print(json.dumps(cat.repair()))
        return 0

    if action in ("migrate_table", "migrate_database"):
        # one implementation: the SQL procedures'; a directory without such
        # files is a usage mistake, as in the JAX package's CLI
        from .sql import ProcedureError, _proc_migrate_database, _proc_migrate_table

        cat = catalog(args.warehouse)
        try:
            if action == "migrate_table":
                out = _proc_migrate_table(cat, args.table, args.source_dir, args.format)
            else:
                out = _proc_migrate_database(cat, args.database, args.source_dir, args.format)
        except ProcedureError as e:
            ap.error(str(e))
        print(json.dumps(out))
        return 0

    t = catalog(args.warehouse).get_table(args.table)
    if action == "compact":
        from .table.compactor import DedicatedCompactor

        # the CLI is the dedicated compaction job: it compacts even a
        # write-only table
        done = DedicatedCompactor(t).run_once(full=args.full)
        print(json.dumps({"compacted": done, "full": args.full}))
    elif action == "sort_compact":
        from .table.sort_compact import sort_compact

        n = sort_compact(t, [c.strip() for c in args.order_by.split(",")], order=args.strategy)
        print(json.dumps({"rows_clustered": n, "strategy": args.strategy}))
    elif action == "delete":
        print(json.dumps({"rows_deleted": t.delete_where(_predicate(args.where))}))
    elif action == "create_tag":
        t.create_tag(args.tag, snapshot_id=args.snapshot)
        print(json.dumps({"tag": args.tag}))
    elif action == "delete_tag":
        t.delete_tag(args.tag)
        print(json.dumps({"deleted_tag": args.tag}))
    elif action == "list_tags":
        print(json.dumps(t.tags()))
    elif action == "rollback_to":
        target = int(args.to) if args.to.isdigit() else args.to
        t.rollback_to(target)
        print(json.dumps({"rolled_back_to": target}))
    elif action == "expire_snapshots":
        print(json.dumps({"expired": t.expire_snapshots()}))
    elif action == "remove_orphan_files":
        from .table.maintenance import remove_orphan_files

        removed = remove_orphan_files(
            t,
            older_than_millis=None if args.older_than_hours is None else int(args.older_than_hours * 3600_000),
            dry_run=args.dry_run,
        )
        print(json.dumps({"orphans": removed, "dry_run": args.dry_run}))
    elif action == "query":
        rb = t.new_read_builder()
        if args.filter:
            rb = rb.with_filter(_predicate(args.filter))
        rb = rb.with_limit(args.limit)
        out = rb.new_read().read_all(rb.new_scan().plan())
        for row in out.to_pylist():
            print(json.dumps(list(row), default=str))
    elif action == "sync_table":
        from contextlib import nullcontext

        from .table.cdc_format import CdcStream

        stream = CdcStream(t, args.format)
        ctx = nullcontext(sys.stdin) if args.input == "-" else open(args.input)
        with ctx as source:
            n = stream.ingest(line for line in source if line.strip())
        print(json.dumps({"records_applied": n}))
    elif action == "reset_consumer":
        from .table.consumer import ConsumerManager

        cm = ConsumerManager(t.file_io, t.path)
        if args.next_snapshot is None:
            cm.delete(args.consumer_id)
            print(json.dumps({"deleted_consumer": args.consumer_id}))
        else:
            cm.record(args.consumer_id, args.next_snapshot)
            print(json.dumps({"consumer": args.consumer_id, "next_snapshot": args.next_snapshot}))
    elif action == "expire_partitions":
        from .table.maintenance import expire_partitions

        expired = expire_partitions(
            t, int(args.expiration_time_hours * 3600_000), time_col=args.time_col, pattern=args.timestamp_formatter
        )
        print(json.dumps({"expired_partitions": [list(p) for p in expired]}))
    elif action == "drop_partition":
        from .table.maintenance import drop_partition

        specs = [dict(kv.split("=", 1) for kv in s.split(",")) for s in args.partition]
        print(json.dumps({"dropped_partitions": [list(p) for p in drop_partition(t, *specs)]}))
    elif action == "mark_partition_done":
        from .table.maintenance import mark_partition_done

        specs = [dict(kv.split("=", 1) for kv in s.split(",")) for s in args.partition]
        print(json.dumps({"markers": mark_partition_done(t, specs)}))
    elif action == "query_service":
        import time

        from .service import KvQueryServer

        server = KvQueryServer(t, host=args.host, port=args.port)
        host, port = server.start()
        print(json.dumps({"service": "kv-query", "host": host, "port": port}), flush=True)
        try:
            if args.serve_seconds is not None:
                time.sleep(args.serve_seconds)
            else:
                while True:
                    time.sleep(3600)
        except KeyboardInterrupt:
            pass
        finally:
            server.shutdown()
    elif action == "create_branch":
        from .table.branch import BranchManager

        BranchManager(t.file_io, t.path).create(args.branch)
        print(json.dumps({"branch": args.branch}))
    elif action == "fast_forward":
        from .table.branch import BranchManager

        BranchManager(t.file_io, t.path).fast_forward(args.branch)
        print(json.dumps({"fast_forwarded": args.branch}))
    return 0


def _predicate(spec: str):
    from .data import predicate as P

    d = json.loads(spec)
    op = d.get("op", "=")
    fns = {
        "=": P.equal,
        "!=": P.not_equal,
        ">": P.greater_than,
        ">=": P.greater_or_equal,
        "<": P.less_than,
        "<=": P.less_or_equal,
    }
    if op == "in":
        return P.in_(d["field"], d["value"])
    if op == "is_null":
        return P.is_null(d["field"])
    return fns[op](d["field"], d["value"])


if __name__ == "__main__":
    sys.exit(main())
