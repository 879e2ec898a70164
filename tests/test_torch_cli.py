"""The port's actions CLI (`python -m paimon_tpu_torch`,
paimon_tpu_torch/__main__.py) and docs_gen against the JAX package's, on
the CPU.

Every action of tests/test_cli_actions.py and tests/test_clone_actions.py
runs in-process through both CLIs, the JAX package's
(`paimon_tpu.__main__.main`) on one warehouse and the port's (with
--device cpu) on a twin written with the same rows, and prints the same
JSON (warehouse paths replaced by a placeholder); each package then reads
the other's warehouse to the same rows. The port's tables merge under
sort-engine=pallas (the kernels' plain versions on the CPU), the JAX
package's under its numpy engine. repair (a JdbcCatalog on --jdbc-path)
registers the same table in both twins, and query-service prints the same
JSON but for its host and port; with the default device and no CUDA every
action raises RuntimeError, after the usage checks, which still exit with
code 2. Three child processes run
the CLI as an operator would: sync-table from stdin, clone, and docs_gen.
docs_gen's table holds one row per option the port reads, each the JAX
package's row for that key (the JAX keys the port does not read are listed
in ROADMAP.md).

Tolerance: exact.
"""

import datetime
import importlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import paimon_tpu.__main__ as jcli
import paimon_tpu.catalog as jcatalog
import paimon_tpu.types as jtypes
import paimon_tpu_torch.__main__ as pcli
import paimon_tpu_torch.catalog as pcatalog
import paimon_tpu_torch.types as ptypes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("jax", "port")
ENGINE = {"jax": {"sort-engine": "numpy"}, "port": {"sort-engine": "pallas"}}
TYPES = {"jax": jtypes, "port": ptypes}
CLI = {"jax": jcli, "port": pcli}


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


@pytest.fixture(autouse=True)
def _plain_download(monkeypatch):
    monkeypatch.setenv("PAIMON_TPU_FORCE_COMPACT", "0")


def catalog(pkg, warehouse, user="setup"):
    if pkg == "jax":
        return jcatalog.FileSystemCatalog(str(warehouse), commit_user=user)
    return pcatalog.FileSystemCatalog(str(warehouse), commit_user=user, device="cpu")


class Twin:
    """One warehouse per package, and the CLIs run on them in-process."""

    def __init__(self, tmp_path, capsys):
        self.root = tmp_path
        self.capsys = capsys
        self.wh = {pkg: tmp_path / pkg for pkg in PKGS}

    def run(self, pkg, *argv) -> str:
        """The action's stdout, with this package's root as <root>."""
        argv = [a.replace("<root>", str(self.root / pkg)) if isinstance(a, str) else a for a in argv]
        if pkg == "port":
            argv.append("--device=cpu")
        self.capsys.readouterr()
        assert CLI[pkg].main(argv) == 0
        return self.capsys.readouterr().out.replace(str(self.root / pkg), "<root>").strip()

    def both(self, *argv) -> str:
        """Run the action through both CLIs; their outputs must agree."""
        out = {pkg: self.run(pkg, *argv) for pkg in PKGS}
        assert out["port"] == out["jax"], argv
        return out["port"]

    def rows(self, name: str) -> list:
        """The table's rows, read by each package in both warehouses, all
        equal."""
        seen = []
        for wh in PKGS:
            for reader in PKGS:
                t = catalog(reader, self.wh[wh]).get_table(name).copy(ENGINE[reader])
                rb = t.new_read_builder()
                seen.append(sorted(rb.new_read().read_all(rb.new_scan().plan()).to_pylist(), key=repr))
        assert all(s == seen[0] for s in seen), name
        return seen[0]

    def each(self, fn):
        return {pkg: fn(pkg, catalog(pkg, self.wh[pkg])) for pkg in PKGS}


@pytest.fixture
def twin(tmp_path, capsys):
    return Twin(tmp_path, capsys)


def schema(pkg, *extra):
    t = TYPES[pkg]
    return t.RowType.of(("id", t.BIGINT()), ("v", t.DOUBLE()), *[(n, getattr(t, ty)()) for n, ty in extra])


def write(t, ids, values, **more):
    wb = t.new_batch_write_builder()
    w = wb.new_write()
    w.write({"id": np.asarray(ids, dtype=np.int64), "v": np.asarray(values, dtype=np.float64), **more})
    wb.new_commit().commit(w.prepare_commit())


def base_table(pkg, cat, name="db.t"):
    """tests/test_cli_actions.py's fixture: 3 commits of ids 0..9."""
    t = cat.create_table(name, schema(pkg), primary_keys=["id"],
                         options={"bucket": "1", "write-only": "true", **ENGINE[pkg]})
    for r in range(3):
        write(t, range(10), [float(r * 10 + i) for i in range(10)])
    return t


def lines(out: str) -> list:
    return [json.loads(line) for line in out.splitlines()]


def test_cli_compact_query_tags_rollback(twin):
    twin.each(base_table)
    base = ["--warehouse", "<root>", "--table", "db.t"]
    assert json.loads(twin.both("compact", "--full", *base)) == {"compacted": True, "full": True}
    assert len(lines(twin.both("query", *base, "--limit", "5"))) == 5
    flt = '{"field": "id", "op": "=", "value": 3}'
    assert lines(twin.both("query", *base, "--filter", flt)) == [[3, 23.0]]
    twin.both("query", *base, "--filter", '{"field": "id", "op": "in", "value": [1, 4]}')
    twin.both("create-tag", *base, "--tag", "v1")
    assert json.loads(twin.both("list-tags", *base)) == {"v1": 4}
    twin.both("create-tag", *base, "--tag", "v0", "--snapshot", "2")
    where = '{"field": "id", "op": ">=", "value": 5}'
    assert json.loads(twin.both("delete", *base, "--where", where)) == {"rows_deleted": 5}
    assert json.loads(twin.both("rollback-to", *base, "--to", "v1")) == {"rolled_back_to": "v1"}
    assert len(lines(twin.both("query", *base, "--limit", "100"))) == 10
    twin.both("delete-tag", *base, "--tag", "v0")
    twin.both("rollback-to", *base, "--to", "3")
    assert json.loads(twin.both("list-tags", *base)) == {"v1": 4}
    assert len(twin.rows("db.t")) == 10


def test_cli_sync_table_and_expire(twin, tmp_path):
    twin.each(base_table)
    base = ["--warehouse", "<root>", "--table", "db.t"]
    stream = tmp_path / "cdc.jsonl"
    msgs = [
        {"payload": {"op": "c", "before": None, "after": {"id": 100, "v": 1.5}}},
        {"payload": {"op": "d", "before": {"id": 0, "v": 0.0}, "after": None}},
        {"payload": {"op": "u", "before": {"id": 1, "v": 21.0}, "after": {"id": 1, "v": 2.5, "tag": "x"}}},
    ]
    stream.write_text("\n".join(json.dumps(m) for m in msgs) + "\n\n")
    out = twin.both("sync-table", *base, "--format", "debezium-json", "--input", str(stream))
    assert json.loads(out) == {"records_applied": 4}
    ids = {r[0] for r in twin.rows("db.t")}
    assert 100 in ids and 0 not in ids
    assert "expired" in json.loads(twin.both("expire-snapshots", *base))
    canal = tmp_path / "canal.jsonl"
    canal.write_text(json.dumps({"type": "INSERT", "data": [{"id": 7, "v": 0.5, "tag": "y"}], "old": None}))
    twin.both("sync-table", *base, "--format", "canal-json", "--input", str(canal))
    assert (7, 0.5, "y") in twin.rows("db.t")


def test_cli_migrate_table_and_database(twin):
    for pkg in PKGS:
        src = twin.root / pkg / "legacy"
        src.mkdir(parents=True)
        pq.write_table(pa.table({"a": [1, 2], "s": ["x", "y"]}), src / "part-0.parquet")
        for name in ("orders", "users"):
            (twin.root / pkg / "lake" / name).mkdir(parents=True)
            pq.write_table(pa.table({"id": pa.array([1, 2, 3], pa.int64()), "v": pa.array([1.0, 2.0, 3.0])}),
                           twin.root / pkg / "lake" / name / "part-0.parquet")
        (twin.root / pkg / "lake" / "empty").mkdir()
    out = twin.both("migrate-table", "--warehouse", "<root>/wh", "--table", "db.mig",
                    "--source-dir", "<root>/legacy", "--format", "parquet")
    assert json.loads(out) == {"migrated": "db.mig", "snapshot": 1}
    assert lines(twin.both("query", "--warehouse", "<root>/wh", "--table", "db.mig", "--limit", "10")) == [
        [1, "x"], [2, "y"]]
    out = twin.both("migrate-database", "--warehouse", "<root>/wh", "--database", "lakehouse",
                    "--source-dir", "<root>/lake")
    assert json.loads(out) == {"migrated": ["lakehouse.orders", "lakehouse.users"]}
    twin.wh = {pkg: twin.root / pkg / "wh" for pkg in PKGS}
    assert sorted(r[0] for r in twin.rows("lakehouse.users")) == [1, 2, 3]


def test_cli_sql_and_call_actions(twin, tmp_path):
    twin.each(base_table)
    rows = lines(twin.both("sql", "--warehouse", "<root>", "SELECT id, v FROM db.t WHERE id >= 8 ORDER BY id"))
    assert [r[0] for r in rows] == [8, 9]
    assert lines(twin.both("sql", "--warehouse", "<root>", "SELECT count(*), max(id) FROM db.t")) == [[10, 9]]
    assert json.loads(twin.both("sql", "--warehouse", "<root>", "CALL sys.create_tag('db.t', 'via-sql')"))[
        "tag"] == "via-sql"
    script = tmp_path / "s.sql"
    script.write_text("CREATE TABLE db.u (k BIGINT NOT NULL, s STRING, PRIMARY KEY (k) NOT ENFORCED) "
                      "WITH ('bucket' = '1');\nINSERT INTO db.u VALUES (1, 'a'), (2, 'b');\n"
                      "SELECT k, s FROM db.u ORDER BY k;\nSHOW CREATE TABLE db.u;\n")
    twin.both("sql", "--warehouse", "<root>", "--file", str(script))
    out = twin.both("call", "--warehouse", "<root>", "CALL sys.create_tag(`table` => 'db.u', tag => 't1')")
    assert json.loads(out) == {"tag": "t1"}
    twin.both("call", "--warehouse", "<root>", "CALL sys.expire_snapshots('db.u')")
    assert twin.rows("db.u") == [(1, "a"), (2, "b")]


def clone_source(pkg, cat):
    t = cat.create_table("db.t", schema(pkg, ("s", "STRING")), primary_keys=["id"],
                         options={"bucket": "2", **ENGINE[pkg]})
    ids = np.arange(100)
    write(t, ids, ids * 0.5, s=np.array([f"s{i}" for i in ids], dtype=object))
    t.create_tag("v1")
    ids = np.arange(50, 150)
    write(t, ids, ids * 0.5, s=np.array([f"s{i}" for i in ids], dtype=object))
    u = cat.create_table("db.u", schema(pkg), primary_keys=["id"], options={"bucket": "1", **ENGINE[pkg]})
    write(u, range(10), np.arange(10.0))
    branch = __import__(f"{'paimon_tpu' if pkg == 'jax' else 'paimon_tpu_torch'}.table.branch",
                        fromlist=["BranchManager"])
    branch.BranchManager(t.file_io, t.path).create("b1", from_tag="v1")
    write(branch.branch_table(t, "b1"), range(1000, 1010), np.zeros(10), s=np.array(["b"] * 10, dtype=object))


def test_cli_clone(twin):
    twin.each(clone_source)
    src = ["--warehouse", "<root>"]
    out = twin.both("clone", *src, "--database", "db", "--table", "t", "--target-warehouse", "<root>/dst")
    assert json.loads(out) == {"cloned": ["db.t"]}
    twin.both("clone", *src, "--database", "db", "--table", "t", "--tag", "v1", "--target-warehouse", "<root>/dst",
              "--target-table", "tagged")
    twin.both("clone", *src, "--database", "db", "--table", "t", "--branch", "b1", "--target-warehouse",
              "<root>/dst", "--target-database", "br", "--parallelism", "2")
    out = twin.both("clone", *src, "--database", "db", "--target-warehouse", "<root>/dst2",
                    "--target-database", "copy")
    assert sorted(json.loads(out)["cloned"]) == ["copy.t", "copy.u"]
    assert sorted(json.loads(twin.both("clone", *src, "--target-warehouse", "<root>/dst3"))["cloned"]) == [
        "db.t", "db.u"]
    twin.wh = {pkg: twin.root / pkg / "dst" for pkg in PKGS}
    assert sorted(r[0] for r in twin.rows("db.t")) == list(range(150))
    assert sorted(r[0] for r in twin.rows("db.tagged")) == list(range(100))
    assert sorted(r[0] for r in twin.rows("br.t")) == list(range(100)) + list(range(1000, 1010))


def test_cli_compact_database(twin):
    def tables(pkg, cat):
        for name in ("db1.a", "db1.b", "db2.c"):
            t = cat.create_table(name, schema(pkg), primary_keys=["id"],
                                 options={"bucket": "1", "write-only": "true", **ENGINE[pkg]})
            write(t, range(20), np.arange(20.0))
            write(t, range(10, 30), np.arange(20.0))

    twin.each(tables)
    out = twin.both("compact-database", "--warehouse", "<root>", "--including-databases", "db1",
                    "--excluding-tables", "b", "--full")
    assert json.loads(out)["compacted"] == ["db1.a"]
    twin.both("compact-database", "--warehouse", "<root>", "--including-tables", "c")
    assert sorted(r[0] for r in twin.rows("db1.a")) == list(range(30))


def test_cli_reset_consumer_branch_and_orphans(twin):
    def setup(pkg, cat):
        t = base_table(pkg, cat)
        consumer = __import__(f"{'paimon_tpu' if pkg == 'jax' else 'paimon_tpu_torch'}.table.consumer",
                              fromlist=["ConsumerManager"])
        consumer.ConsumerManager(t.file_io, t.path).record("job7", 2)
        with open(f"{t.path}/bucket-0/data-debris.parquet", "wb") as f:
            f.write(b"junk")

    twin.each(setup)
    base = ["--warehouse", "<root>", "--table", "db.t"]
    out = twin.both("reset-consumer", *base, "--consumer-id", "job7", "--next-snapshot", "1")
    assert json.loads(out) == {"consumer": "job7", "next_snapshot": 1}
    assert json.loads(twin.both("reset-consumer", *base, "--consumer-id", "job7")) == {"deleted_consumer": "job7"}
    twin.both("create-branch", *base, "--branch", "b1")
    twin.both("fast-forward", *base, "--branch", "b1")
    out = json.loads(twin.both("remove-orphan-files", *base, "--older-than-hours", "-1", "--dry-run"))
    assert out == {"orphans": ["<root>/db.db/t/bucket-0/data-debris.parquet"], "dry_run": True}
    twin.both("remove-orphan-files", *base, "--older-than-hours", "-1")
    assert json.loads(twin.both("remove-orphan-files", *base)) == {"orphans": [], "dry_run": False}
    assert len(twin.rows("db.t")) == 10


def test_cli_sort_compact(twin):
    def setup(pkg, cat):
        t_ = TYPES[pkg]
        t = cat.create_table("db.a", t_.RowType.of(("x", t_.BIGINT()), ("y", t_.BIGINT())),
                             options={"bucket": "1", "write-only": "true"})
        rng = np.random.default_rng(5)
        for _ in range(3):
            wb = t.new_batch_write_builder()
            w = wb.new_write()
            w.write({"x": rng.integers(0, 100, 50), "y": rng.integers(0, 100, 50)})
            wb.new_commit().commit(w.prepare_commit())

    twin.each(setup)
    out = twin.both("sort-compact", "--warehouse", "<root>", "--table", "db.a", "--order-by", "x, y")
    assert json.loads(out) == {"rows_clustered": 150, "strategy": "zorder"}
    twin.both("sort-compact", "--warehouse", "<root>", "--table", "db.a", "--order-by", "y", "--strategy", "order")
    assert len(twin.rows("db.a")) == 150


def partition_table(pkg, cat):
    t_ = TYPES[pkg]
    row_type = t_.RowType.of(("dt", t_.STRING(False)), ("id", t_.BIGINT()), ("v", t_.DOUBLE()))
    t = cat.create_table("db.p", row_type, primary_keys=["dt", "id"], partition_keys=["dt"],
                         options={"bucket": "1", **ENGINE[pkg]})
    for dt in OLD_NEW:
        wb = t.new_batch_write_builder()
        w = wb.new_write()
        w.write({"dt": np.array([dt] * 5, dtype=object), "id": np.arange(5, dtype=np.int64),
                 "v": np.arange(5, dtype=np.float64)})
        wb.new_commit().commit(w.prepare_commit())


OLD_NEW = ((datetime.date.today() - datetime.timedelta(days=30)).isoformat(), datetime.date.today().isoformat())


def test_cli_expire_partitions(twin):
    twin.each(partition_table)
    out = twin.both("expire-partitions", "--warehouse", "<root>", "--table", "db.p",
                    "--expiration-time-hours", str(7 * 24), "--timestamp-formatter", "%Y-%m-%d")
    assert json.loads(out) == {"expired_partitions": [[OLD_NEW[0]]]}
    assert {r[0] for r in twin.rows("db.p")} == {OLD_NEW[1]}


def test_cli_drop_partition_and_mark_done(twin):
    twin.each(partition_table)
    base = ["--warehouse", "<root>", "--table", "db.p"]
    out = twin.both("drop-partition", *base, "--partition", f"dt={OLD_NEW[0]}")
    assert json.loads(out) == {"dropped_partitions": [[OLD_NEW[0]]]}
    assert {r[0] for r in twin.rows("db.p")} == {OLD_NEW[1]}
    out = json.loads(twin.run("port", "mark-partition-done", *base, "--partition", f"dt={OLD_NEW[1]}"))
    jax = json.loads(twin.run("jax", "mark-partition-done", *base, "--partition", f"dt={OLD_NEW[1]}"))
    assert out == jax and len(out["markers"]) == 1
    marker = json.loads(open(out["markers"][0].replace("<root>", str(twin.root / "port")), "rb").read())
    assert marker["creationTime"] <= marker["modificationTime"]


@pytest.mark.parametrize("action, argv, module, item", [
    ("repair", ["--warehouse", "w", "--jdbc-path", "m.db"], "catalog/jdbc.py", r"15 \(c\)"),
    ("query-service", ["--warehouse", "w", "--table", "db.t", "--serve-seconds", "0"], "service/", r"15 \(d\)"),
])
def test_the_actions_not_ported_yet_raise(action, argv, module, item, tmp_path, monkeypatch, capsys):
    """repair and query-service waited for `module` (ROADMAP Queue 1 item
    `item`); now ported, each prints what the JAX CLI prints for the same
    arguments, run in a twin directory per package: repair the same
    registrations, query-service the same JSON but for its host and port."""
    importlib.import_module("paimon_tpu_torch." + module.rstrip("/").removesuffix(".py").replace("/", "."))
    out = {}
    for pkg in PKGS:
        (tmp_path / pkg).mkdir()
        monkeypatch.chdir(tmp_path / pkg)
        if action == "repair":
            jdbc = importlib.import_module(("paimon_tpu" if pkg == "jax" else "paimon_tpu_torch") + ".catalog.jdbc")
            kw = {} if pkg == "jax" else {"device": "cpu"}
            write(jdbc.JdbcCatalog("m.db", "w", **kw).create_table(
                "db.kept", schema(pkg), primary_keys=["id"], options={"bucket": "1"}), [1], [1.0])
            base_table(pkg, catalog(pkg, "w"), "db.behind")  # a table the sqlite catalog does not know
        else:
            write(catalog(pkg, "w").create_table("db.t", schema(pkg), primary_keys=["id"],
                                                 options={"bucket": "1", **ENGINE[pkg]}), [1, 2], [1.0, 2.0])
        capsys.readouterr()
        assert CLI[pkg].main([action, *argv] + (["--device", "cpu"] if pkg == "port" else [])) == 0
        printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        if action == "query-service":
            assert isinstance(printed.pop("host"), str) and printed.pop("port") > 0
            printed.update(host="<host>", port="<port>")
            assert not os.path.exists("w/db.db/t/service/primary-key-lookup"), "the address file outlived the server"
        out[pkg] = printed
    assert out["port"] == out["jax"]
    if action == "repair":
        assert out["port"] == {"registered": ["db.behind"], "removed": [], "removed_databases": []}
    else:
        assert out["port"] == {"service": "kv-query", "host": "<host>", "port": "<port>"}


ACTION_ARGS = {
    "compact": ["--warehouse", "w", "--table", "db.t"],
    "sort-compact": ["--warehouse", "w", "--table", "db.t", "--order-by", "x"],
    "delete": ["--warehouse", "w", "--table", "db.t", "--where", "{}"],
    "create-tag": ["--warehouse", "w", "--table", "db.t", "--tag", "x"],
    "delete-tag": ["--warehouse", "w", "--table", "db.t", "--tag", "x"],
    "list-tags": ["--warehouse", "w", "--table", "db.t"],
    "rollback-to": ["--warehouse", "w", "--table", "db.t", "--to", "1"],
    "expire-snapshots": ["--warehouse", "w", "--table", "db.t"],
    "remove-orphan-files": ["--warehouse", "w", "--table", "db.t"],
    "migrate-table": ["--warehouse", "w", "--table", "db.t", "--source-dir", "<src>"],
    "query": ["--warehouse", "w", "--table", "db.t"],
    "sync-table": ["--warehouse", "w", "--table", "db.t"],
    "create-branch": ["--warehouse", "w", "--table", "db.t", "--branch", "b"],
    "fast-forward": ["--warehouse", "w", "--table", "db.t", "--branch", "b"],
    "clone": ["--warehouse", "w", "--target-warehouse", "w2"],
    "compact-database": ["--warehouse", "w"],
    "reset-consumer": ["--warehouse", "w", "--table", "db.t", "--consumer-id", "c"],
    "expire-partitions": ["--warehouse", "w", "--table", "db.t", "--expiration-time-hours", "1"],
    "drop-partition": ["--warehouse", "w", "--table", "db.t", "--partition", "dt=1"],
    "mark-partition-done": ["--warehouse", "w", "--table", "db.t", "--partition", "dt=1"],
    "query-service": ["--warehouse", "w", "--table", "db.t"],
    "repair": ["--warehouse", "w", "--jdbc-path", "m.db"],
    "migrate-database": ["--warehouse", "w", "--database", "d", "--source-dir", "<src>"],
    "call": ["--warehouse", "w", "CALL sys.expire_snapshots('db.t')"],
    "sql": ["--warehouse", "w", "SELECT 1"],
}


def test_every_action_has_its_arguments():
    assert sorted(ACTION_ARGS) == sorted(pcli._parser()._subparsers._group_actions[0].choices)
    assert sorted(ACTION_ARGS) == sorted([n.replace("_", "-") for n in pcli._ACTIONS] + ["call", "sql"])


@pytest.mark.parametrize("action", sorted(ACTION_ARGS))
def test_the_default_device_without_cuda_raises(action, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "src").mkdir()
    pq.write_table(pa.table({"a": [1]}), tmp_path / "src" / "p.parquet")
    argv = [a.replace("<src>", str(tmp_path / "src")) for a in ACTION_ARGS[action]]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcli.main([action, *argv])


@pytest.mark.parametrize("argv", [
    ["sql", "--warehouse", "w"],
    ["sql", "--warehouse", "w", "--file", "f.sql", "SELECT 1"],
    ["clone", "--warehouse", "w", "--target-warehouse", "w2", "--tag", "v1"],
    ["clone", "--warehouse", "w", "--target-warehouse", "w2", "--target-database", "d"],
    ["clone", "--warehouse", "w", "--target-warehouse", "w2", "--table", "t"],
    ["query", "--warehouse", "w"],
    ["compact", "--warehouse", "w", "--table", "db.t", "--device", "tpu"],
], ids=["sql_nothing", "sql_both", "clone_tag", "clone_target_db", "clone_table", "missing_table",
        "bad_device"])
def test_usage_mistakes_exit_2_before_the_device(argv, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        pcli.main(argv)
    assert e.value.code == 2


def test_migrating_a_directory_without_files_exits_2(tmp_path, capsys):
    """A directory that holds no files of the format is a usage mistake in
    both CLIs (the port's through the migrate procedure's ProcedureError):
    exit code 2 with the JAX package's message."""
    src = tmp_path / "legacy"
    src.mkdir()
    (src / "part-0.orc").write_bytes(b"")
    errors = {}
    for pkg in PKGS:
        argv = ["migrate-table", "--warehouse", str(tmp_path / pkg), "--table", "db.t", "--source-dir", str(src)]
        capsys.readouterr()
        with pytest.raises(SystemExit) as e:
            CLI[pkg].main(argv + (["--device", "cpu"] if pkg == "port" else []))
        assert e.value.code == 2
        errors[pkg] = capsys.readouterr().err.splitlines()[-1]
    assert errors["port"] == errors["jax"].replace("paimon_tpu:", "paimon_tpu_torch:")
    assert errors["port"].endswith(f"error: no *.parquet files found in {src}")


# the port's descriptions differ from the JAX package's only here: it reads
# no PAIMON_TPU_* override, it writes avro where the JAX package names
# lance, and it names its buffer controller without the JAX package's history
DESCRIPTION_EDITS = {
    "merge.dict-domain": (" PAIMON_TPU_DICT_DOMAIN overrides.", ""),
    "merge.dict-domain.pool-limit": (" PAIMON_TPU_DICT_POOL_LIMIT overrides.", ""),
    "join.engine": (" PAIMON_TPU_JOIN_ENGINE overrides.", ""),
    "file-index.bloom-filter.primary-key.enabled": (" PAIMON_TPU_KEY_BLOOM=1/0 overrides.", ""),
    "file.format": ("parquet|orc|lance", "parquet|orc|avro"),
    "subscription.buffer.max-memory": ("(the PR 8 WriteBufferController", "(the WriteBufferController"),
}


def _doc_rows(doc: str) -> dict:
    rows = [line.split(" | ", 2) for line in doc.splitlines() if line.startswith("| `")]
    return {key.strip("| `"): (default, desc.removesuffix(" |")) for key, default, desc in rows}


def test_docs_gen_rows_equal_the_jax_packages():
    """docs_gen prints one row per option the port reads, each the JAX
    package's row for that key (key, default, description, the edits above
    applied), under the JAX package's header but for the package name."""
    from paimon_tpu.docs_gen import generate_options_doc as jax_doc
    from paimon_tpu_torch.docs_gen import generate_options_doc as port_doc
    from paimon_tpu_torch.options import ConfigOption, CoreOptions

    jax, port = jax_doc(), port_doc()
    jax_rows, port_rows = _doc_rows(jax), _doc_rows(port)
    assert sorted(port_rows) == sorted(o.key for o in vars(CoreOptions).values() if isinstance(o, ConfigOption))
    for key, (default, desc) in port_rows.items():
        assert key in jax_rows, key
        jax_default, jax_desc = jax_rows[key]
        old, new = DESCRIPTION_EDITS.get(key, ("", ""))
        assert old in jax_desc, key
        assert (default, desc) == (jax_default, jax_desc.replace(old, new)), key
    head = lambda doc: [line for line in doc.splitlines() if not line.startswith("| `")]  # noqa: E731
    assert head(port) == [line.replace("paimon_tpu.", "paimon_tpu_torch.") for line in head(jax)]


def child(*argv, stdin=None):
    """`python -m <argv>` in a child process: no JAX, the repo on the path."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-m", *argv], input=stdin, capture_output=True, text=True, timeout=300,
                       cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr
    return r.stdout.strip()


def test_child_processes_sync_clone_and_docs(tmp_path):
    """Three children, as an operator runs the CLI: sync-table reading
    debezium messages from stdin, clone, and docs_gen."""
    wh = tmp_path / "wh"
    base_table("port", catalog("port", wh))
    msgs = "\n".join(json.dumps({"payload": {"op": "c", "before": None, "after": {"id": 100 + i, "v": 0.5}}})
                     for i in range(3))
    out = child("paimon_tpu_torch", "sync-table", "--warehouse", str(wh), "--table", "db.t", "--device", "cpu",
                stdin=msgs)
    assert json.loads(out) == {"records_applied": 3}
    out = child("paimon_tpu_torch", "clone", "--warehouse", str(wh), "--database", "db", "--table", "t",
                "--target-warehouse", str(tmp_path / "dst"), "--device", "cpu")
    assert json.loads(out) == {"cloned": ["db.t"]}
    for reader in PKGS:
        t = catalog(reader, tmp_path / "dst").get_table("db.t").copy(ENGINE[reader])
        rb = t.new_read_builder()
        assert len(rb.new_read().read_all(rb.new_scan().plan()).to_pylist()) == 13
    from paimon_tpu_torch.docs_gen import generate_options_doc

    assert child("paimon_tpu_torch.docs_gen") == generate_options_doc().strip()
