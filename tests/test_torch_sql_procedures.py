"""The CALL procedures of the port's SQL surface (paimon_tpu_torch/sql/
__init__.py, table/rowops.py MergeInto, table/maintenance.py
mark_partition_done) against the JAX package's, on the CPU
(device="cpu").

Each case runs one script twice, through paimon_tpu.sql.execute on one
warehouse and paimon_tpu_torch.sql.execute on another, and after every
statement asserts the same result (paths relative to the warehouse) or the
same error, the same rows in every table of both warehouses, and each
package reading the other's warehouse to those rows. The scripts are the
counterparts of tests/test_sql_procedures.py (parse_call, the tag,
rollback, branch and fast-forward procedures, compact and
compact_database, expire_snapshots, delete by the JSON and the SQL form,
reset_consumer), of tests/test_sql_round5.py (merge_into in its named,
positional, short delete and '*' forms and its refusals,
rewrite_file_index with pruning after it, repair on a FileSystemCatalog,
the privilege procedures and query_service; its migrate cases are in
tests/test_torch_migrate.py, its JdbcCatalog repair in
tests/test_torch_catalogs.py) and of tests/test_sql_grand_tour.py, plus
expire_partitions, drop_partition and mark_partition_done. The privilege
procedures and query_service return or raise what the JAX package's do on
a twin warehouse (the servers' addresses aside, each package's client
reading the other's server), and so do the migrate procedures;
cluster_query, which waits for a later slice, is pinned to
NotImplementedError naming its ROADMAP items.

Tolerance: exact.
"""

import io
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from paimon_tpu.catalog import FileSystemCatalog as JaxCatalog
from paimon_tpu.sql import execute as jax_execute
from paimon_tpu.sql import parse_call as jax_parse_call
from paimon_tpu_torch.catalog import FileSystemCatalog as PortCatalog
from paimon_tpu_torch.sql import ProcedureError, call, cluster_query, parse_call, procedures
from paimon_tpu_torch.sql import execute as port_execute


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


@pytest.fixture(autouse=True)
def _plain_download(monkeypatch):
    monkeypatch.setenv("PAIMON_TPU_FORCE_COMPACT", "0")


def same_values(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return False
    if a.dtype.kind == "f" and b.dtype.kind == "f":
        i = f"i{a.itemsize}"
        return a.dtype == b.dtype and bool(((a.view(i) == b.view(i)) | (np.isnan(a) & np.isnan(b))).all())
    return a.tolist() == b.tolist()


def assert_same(want, got, what: str) -> None:
    if not hasattr(want, "schema"):
        assert type(got) is type(want) and got == want, f"{what}: {got!r} != {want!r}"
        return
    assert got.schema.field_names == want.schema.field_names, what
    assert [f.type.serialize() for f in got.schema.fields] == [f.type.serialize() for f in want.schema.fields], what
    assert got.num_rows == want.num_rows, f"{what}: {got.num_rows} != {want.num_rows} rows"
    for name in want.schema.field_names:
        w, g = want.column(name), got.column(name)
        ok = np.asarray(w.valid_mask())
        assert same_values(g.valid_mask(), ok), f"{what}: nulls of {name}"
        assert same_values(np.asarray(g.values)[ok], np.asarray(w.values)[ok]), f"{what}: column {name}"


def _relative(x, warehouse: str):
    if isinstance(x, str):
        return x.replace(warehouse, "<w>")
    if isinstance(x, list):
        return [_relative(v, warehouse) for v in x]
    if isinstance(x, dict):
        return {k: _relative(v, warehouse) for k, v in x.items()}
    return x


def _read(t):
    rb = t.new_read_builder()
    return rb.new_read().read_all(rb.new_scan().plan())


class Twin:
    """One warehouse per package, the same statements on both."""

    def __init__(self, tmp_path):
        self.jw, self.pw = str(tmp_path / "jax"), str(tmp_path / "port")
        self.jcat = JaxCatalog(self.jw, commit_user="twin")
        self.pcat = PortCatalog(self.pw, commit_user="twin", device="cpu")

    def __call__(self, statement: str):
        try:
            want = jax_execute(self.jcat, statement)
        except Exception as e:  # noqa: BLE001 - the port must raise the same
            with pytest.raises(Exception) as info:
                port_execute(self.pcat, statement)
            assert type(info.value).__name__ == type(e).__name__, f"{statement}: {info.value!r} vs {e!r}"
            assert str(info.value).replace(self.pw, "<w>") == str(e).replace(self.jw, "<w>"), statement
            return None
        got = port_execute(self.pcat, statement)
        assert_same(_relative(want, self.jw), _relative(got, self.pw), statement)
        if not statement.lstrip().upper().startswith(("SELECT", "SHOW", "DESC", "EXPLAIN")):
            self.check_tables()
        return got

    def tables(self, cat):
        return [f"{db}.{t}" for db in cat.list_databases() for t in cat.list_tables(db)]

    def check_tables(self) -> None:
        names = self.tables(self.jcat)
        assert self.tables(self.pcat) == names
        pcat_of_jax, jcat_of_port = PortCatalog(self.jw, device="cpu"), JaxCatalog(self.pw)
        for name in names:
            reads = [_read(c.get_table(name)) for c in (self.jcat, self.pcat, pcat_of_jax, jcat_of_port)]
            for i, r in enumerate(reads[1:]):
                assert_same(reads[0], r, f"{name} (read {i + 1})")

    def both(self, fn):
        """fn(catalog, package) on each side: the same value."""
        want, got = fn(self.jcat, "jax"), fn(self.pcat, "port")
        assert got == want, f"{got!r} != {want!r}"
        return got


@pytest.fixture
def twin(tmp_path):
    return Twin(tmp_path)


def _three_commits(twin):
    twin("CREATE TABLE db.t (k BIGINT NOT NULL, v BIGINT, PRIMARY KEY (k) NOT ENFORCED) WITH ('bucket' = '1')")
    for r in range(3):
        twin("INSERT INTO db.t VALUES " + ", ".join(f"({i}, {i + r})" for i in range(0, 200, 7)))


@pytest.mark.parametrize("statement", [
    "CALL sys.compact(`table` => 'db.t', `full` => true)",
    "call create_tag('db.t', 'it''s', 2);",
    "CALL sys.p(null, 1.5, FALSE)",
    "CALL `sys`.`p`(-3, 'a,b', `x` => 'y')",
    "CALL p()",
    "SELECT 1",
    "CALL p(a => 1, 2)",
    "CALL p('unterminated)",
    "CALL p(`x => 1)",
    "CALL p(bare_word)",
])
def test_parse_call_matches_jax(statement):
    try:
        want = jax_parse_call(statement)
    except Exception as e:  # noqa: BLE001
        with pytest.raises(ProcedureError) as info:
            parse_call(statement)
        assert type(e).__name__ == "ProcedureError" and str(info.value) == str(e)
        return
    assert parse_call(statement) == want


def test_tag_rollback_branch_procedures(twin):
    _three_commits(twin)
    twin("CALL sys.create_tag('db.t', 'v1', 1)")
    twin("CALL sys.create_tag('db.t', 'v2')")
    twin("CALL sys.create_tag('db.t', 'v2')")
    twin.both(lambda c, _: sorted(c.get_table("db.t").tags()))
    twin("CALL sys.delete_tag('db.t', 'v2')")
    twin("SELECT * FROM db.t$tags")
    twin("CALL sys.create_branch('db.t', 'b1', tag => 'v1')")
    twin("CALL sys.create_branch('db.t', 'b2')")
    twin("SELECT branch_name, created_from_snapshot, latest_snapshot, latest_schema_id FROM db.t$branches")
    twin("CALL sys.delete_branch('db.t', 'b2')")
    twin("CALL sys.fast_forward('db.t', 'b1')")
    twin("SELECT count(*), sum(v) FROM db.t")
    twin("CALL sys.rollback_to('db.t', '1')")
    twin("SELECT snapshot_id FROM db.t$snapshots")
    twin("CALL sys.rollback_to('db.t', 'v1')")
    twin("CALL sys.rollback_to('db.t', 99)")
    twin("CALL sys.create_tag('db.nope', 'x')")


def test_compact_and_expire_procedures(twin):
    _three_commits(twin)
    twin("CALL sys.compact(`table` => 'db.t', `full` => true)")
    twin("SELECT level, record_count FROM db.t$files")
    twin("SELECT commit_kind FROM db.t$snapshots")
    twin("CALL sys.expire_snapshots(`table` => 'db.t', retain_max => 1, retain_min => 1)")
    twin("SELECT snapshot_id FROM db.t$snapshots")
    twin("CALL sys.expire_snapshots('db.t')")
    twin("CREATE TABLE db.ap (a BIGINT, s STRING) WITH ('bucket' = '-1', 'compaction.min.file-num' = '2')")
    for r in range(3):
        twin(f"INSERT INTO db.ap VALUES ({r}, 'x{r}'), ({r + 10}, 'y{r}')")
    twin("CALL sys.compact('db.ap')")
    twin("CALL sys.compact('db.ap', order_strategy => 'zorder', order_by => 'a, s')")
    twin("CALL sys.compact('db.ap', order_strategy => 'order')")
    twin("CALL sys.compact('db.t', order_strategy => 'zorder', order_by => 'v')")


def test_compact_database_and_unknown_procedure(twin):
    _three_commits(twin)
    twin("CREATE TABLE other.u (k BIGINT NOT NULL, PRIMARY KEY (k) NOT ENFORCED) WITH ('bucket' = '1')")
    twin("INSERT INTO other.u VALUES (1)")
    twin("INSERT INTO other.u VALUES (2)")
    twin("CALL sys.compact_database(including_databases => 'db', full => true)")
    twin("CALL sys.compact_database(full => true, excluding_tables => 'db.*')")
    twin("CALL sys.compact_database(including_tables => 'u')")
    twin("CALL sys.no_such_proc('x')")
    twin("CALL sys.compact('db.t', bogus_arg => 1)")
    twin("CALL sys.compact()")


def test_delete_and_consumer_procedures(twin):
    _three_commits(twin)
    twin('CALL sys.delete(\'db.t\', \'{"field": "k", "op": ">=", "value": 100}\')')
    twin('CALL sys.delete(\'db.t\', \'{"field": "k", "op": "in", "value": [0, 7]}\')')
    twin("CALL sys.delete('db.t', 'k >= 30 AND k < 60')")
    twin("CALL sys.delete('db.t', 'TRUE')")
    twin("CALL sys.delete('db.t', 'k = v')")
    twin("CALL sys.reset_consumer('db.t', 'ci', 2)")
    twin.both(lambda c, pkg: _consumer(c, pkg, "ci"))
    twin("SELECT * FROM db.t$consumers")
    twin("CALL sys.reset_consumer('db.t', 'ci')")
    twin.both(lambda c, pkg: _consumer(c, pkg, "ci"))


def _consumer(cat, pkg, cid):
    if pkg == "jax":
        from paimon_tpu.table.consumer import ConsumerManager
    else:
        from paimon_tpu_torch.table.consumer import ConsumerManager
    t = cat.get_table("db.t")
    return ConsumerManager(t.file_io, t.path).consumer(cid)


def _src(twin, name, rows):
    twin(f"CREATE TABLE {name} (k BIGINT NOT NULL, v BIGINT, s STRING, PRIMARY KEY (k) NOT ENFORCED) "
         "WITH ('bucket' = '1')")
    twin(f"INSERT INTO {name} VALUES " + ", ".join(rows))


def test_merge_into_upsert_and_insert(twin):
    _src(twin, "db.t", [f"({i}, {i * 10}, 's-{i % 7}')" for i in range(100)])
    _src(twin, "db.src", ["(50, 1, 'a')", "(60, 2, 'b')", "(200, 3, 'c')", "(201, 4, NULL)"])
    twin("CALL sys.merge_into(target_table => 'db.t', source_table => 'db.src', merge_condition => 't.k = src.k', "
         "matched_upsert_condition => 'src.v < 2', matched_upsert_setting => 'v = src.v + 1000', "
         "not_matched_insert_values => '*')")
    twin("CALL sys.merge_into(target_table => 'db.t', source_table => 'db.src', merge_condition => 't.k = src.k', "
         "matched_upsert_setting => 'v = t.v + src.v, s = NULL', not_matched_insert_condition => 'src.v > 3', "
         "not_matched_insert_values => 'k = src.k, v = -src.v')")
    twin("CALL sys.merge_into('db.t', 't', '', 'db.src', 't.k = src.k', 'src.v = 2', 'v = 7', "
         "'src.v >= 0', 'src.k, src.v * 2, src.s')")
    twin("CALL sys.merge_into(target_table => 'db.t', source_table => 'db.src', merge_condition => 't.k = src.k', "
         "not_matched_insert_values => 'src.k, src.v')")
    twin("CALL sys.merge_into(target_table => 'db.t', source_table => 'db.src', merge_condition => 't.k = src.k', "
         "matched_delete_condition => 'src.s = ''a''', matched_upsert_setting => 'v = 0')")


def test_merge_into_short_delete_form_and_star_setting(twin):
    _src(twin, "db.t", [f"({i}, {i}, 'x')" for i in range(50)])
    _src(twin, "db.sd", ["(1, 7, 'x')", "(2, 8, 'y')", "(3, 9, 'z')"])
    twin("CALL sys.merge_into('db.t', 'T', '', 'db.sd', 'T.k = sd.k', 'sd.v >= 8')")
    twin("CALL sys.merge_into(target_table => 'db.t', source_table => 'db.sd', merge_condition => 't.k = sd.k', "
         "matched_upsert_condition => '', matched_upsert_setting => '*')")


def test_merge_into_rejects_bad_condition(twin):
    _src(twin, "db.t", [f"({i}, {i}, 'x')" for i in range(10)])
    _src(twin, "db.bad", ["(1, 1, 'q')", "(1, 2, 'r')"])
    _src(twin, "db.good", ["(1, 1, 'q')"])
    twin("CALL sys.merge_into(target_table => 'db.t', source_table => 'db.good', merge_condition => 't.v = good.v', "
         "matched_upsert_condition => '', matched_upsert_setting => 'v = good.v')")
    twin("CALL sys.merge_into(target_table => 'db.t', source_table => 'db.good', merge_condition => 't.k = good.k', "
         "matched_upsert_condition => 'good.v > 0')")
    twin("CALL sys.merge_into(target_table => 'db.t', source_table => 'db.good', source_sqls => 'CREATE VIEW x', "
         "merge_condition => 't.k = good.k', matched_upsert_setting => '*')")
    twin("CALL sys.merge_into(target_table => 'db.t', merge_condition => 't.k = good.k')")
    twin("CALL sys.merge_into(target_table => 'db.t', source_table => 'db.good', merge_condition => 't.k = good.k', "
         "matched_upsert_setting => 'k = 5')")
    twin("CALL sys.merge_into(target_table => 'db.t', source_table => 'db.good', merge_condition => 't.k = good.k', "
         "matched_upsert_setting => 'v = q.v')")
    twin("CALL sys.merge_into(target_table => 'db.t', source_table => 'db.good', merge_condition => 't.k = good.k', "
         "not_matched_insert_values => '1, 2')")
    twin("CREATE TABLE db.agg (k BIGINT NOT NULL, v BIGINT, s STRING, PRIMARY KEY (k) NOT ENFORCED) "
         "WITH ('bucket' = '1', 'merge-engine' = 'aggregation')")
    twin("CALL sys.merge_into(target_table => 'db.agg', source_table => 'db.good', merge_condition => 'agg.k = good.k', "
         "matched_upsert_setting => '*')")
    twin("CREATE TABLE db.ap (k BIGINT, v BIGINT, s STRING)")
    twin("CALL sys.merge_into(target_table => 'db.ap', source_table => 'db.good', merge_condition => 'ap.k = good.k', "
         "matched_upsert_setting => '*')")


def test_rewrite_file_index_builds_missing_indexes(twin):
    twin("CREATE TABLE db.fi (id BIGINT NOT NULL, x DOUBLE, s STRING, PRIMARY KEY (id) NOT ENFORCED) "
         "WITH ('bucket' = '1', 'write-only' = 'true')")
    for start in (0, 1):
        twin("INSERT INTO db.fi VALUES " + ", ".join(f"({i}, {i * 0.5}, 's{i}')" for i in range(start, 200, 2)))
    twin("CALL sys.rewrite_file_index('db.fi')")
    twin("ALTER TABLE db.fi SET ('file-index.bloom-filter.columns' = 'id, s')")
    assert twin("CALL sys.rewrite_file_index('db.fi')") == {"rewritten": 2, "columns": ["id", "s"]}
    twin("CALL sys.rewrite_file_index('db.fi')")
    twin("SELECT count(*) FROM db.fi WHERE id = 151")
    twin("EXPLAIN SELECT x FROM db.fi WHERE id = 151")
    # each package builds the same index bytes and prunes by the other's
    payloads = twin.both(lambda c, _: sorted(e.file.embedded_index or b"" for e in
                                             c.get_table("db.fi").store.new_scan().plan().entries))
    assert all(payloads)
    from paimon_tpu.data import predicate as JP
    from paimon_tpu_torch.data import predicate as TP

    for cat, P in ((PortCatalog(twin.jw, device="cpu"), TP), (JaxCatalog(twin.pw), JP)):
        rb = cat.get_table("db.fi").new_read_builder().with_filter(P.equal("id", 151))
        assert sum(len(s.files) for s in rb.new_scan().plan()) == 1
    # the primary-key bloom, enabled after the data was written
    twin("ALTER TABLE db.fi SET ('file-index.bloom-filter.primary-key.enabled' = 'true', "
         "'file-index.bloom-filter.columns' = 'x')")
    twin("INSERT INTO db.fi VALUES (1000, 1.0, 'new')")
    twin("CALL sys.rewrite_file_index('db.fi')")
    twin("CREATE TABLE db.pfi (id BIGINT NOT NULL, dt STRING, PRIMARY KEY (id, dt) NOT ENFORCED) "
         "PARTITIONED BY (dt) WITH ('bucket' = '1', 'file-index.bloom-filter.columns' = 'id', "
         "'file-index.in-manifest-threshold' = '1 b')")
    twin("ALTER TABLE db.pfi SET ('file-index.bloom-filter.columns' = 'nope')")
    twin("INSERT INTO db.pfi VALUES (1, 'a'), (2, 'b')")
    twin("ALTER TABLE db.pfi SET ('file-index.bloom-filter.columns' = 'id')")
    twin("CALL sys.rewrite_file_index('db.pfi', 'dt=a')")
    twin.both(lambda c, _: sorted(x for e in c.get_table("db.pfi").store.new_scan().plan().entries
                                  for x in (len(e.file.extra_files), e.file.embedded_index is None)))
    twin("CALL sys.rewrite_file_index('db.pfi')")


def test_partition_procedures(twin):
    twin("CREATE TABLE db.p (k BIGINT NOT NULL, dt STRING, hh INT, PRIMARY KEY (k, dt, hh) NOT ENFORCED) "
         "PARTITIONED BY (dt, hh) WITH ('bucket' = '1')")
    twin("INSERT INTO db.p VALUES (1, '2020-01-01', 1), (2, '2020-01-02', 1), (3, '2020-01-02', 2), "
         "(4, '2999-01-01', 1)")
    # file sizes differ between the two warehouses: each package encodes its own parquet
    twin("SELECT partition, record_count, file_count FROM db.p$partitions")
    twin("SELECT partition, bucket, record_count FROM db.p$buckets")
    got = twin("CALL sys.mark_partition_done('db.p', 'dt=2020-01-02,hh=1;dt=2020-01-01,hh=1')")
    for path in got["markers"]:
        body = open(path).read()
        assert '"creationTime"' in body and '"modificationTime"' in body
    twin("CALL sys.mark_partition_done('db.p', 'dt=2020-01-02')")
    twin("CALL sys.drop_partition('db.p', 'dt=2020-01-02,hh=2')")
    twin("CALL sys.drop_partition('db.p', 'nope=1')")
    twin("CALL sys.expire_partitions('db.p', '7 d')")
    twin("CALL sys.expire_partitions('db.p', '7 d', timestamp_pattern => 'hh')")
    twin("SELECT * FROM db.p ORDER BY k")
    twin("CREATE TABLE db.flat (k BIGINT NOT NULL, PRIMARY KEY (k) NOT ENFORCED)")
    twin("CALL sys.mark_partition_done('db.flat', 'dt=1')")
    twin("CALL sys.drop_partition('db.flat', 'dt=1')")
    twin("CALL sys.expire_partitions('db.flat', '1 d')")


def test_system_tables_after_procedures(twin):
    _three_commits(twin)
    twin("CALL sys.compact('db.t', `full` => true)")
    for name in ("schemas", "options", "manifests", "aggregation_fields", "read_optimized", "audit_log",
                 "file_monitor"):
        twin(f"DESCRIBE db.t${name}")
    twin("SELECT schema_id, fields, partition_keys, primary_keys, options FROM db.t$schemas")
    twin("SELECT * FROM db.t$options")
    twin("SELECT num_added_files, num_deleted_files, schema_id FROM db.t$manifests")
    twin("SELECT * FROM db.t$aggregation_fields")
    twin("SELECT * FROM db.t$read_optimized ORDER BY k")
    twin("SELECT rowkind, k, v FROM db.t$audit_log")
    twin("SELECT _SNAPSHOT_ID, _PARTITION, _BUCKET FROM db.t$file_monitor")
    twin("SELECT * FROM db.t$nope")


def test_repair_and_not_ported_procedures(tmp_path):
    cat = PortCatalog(str(tmp_path), device="cpu")
    with pytest.raises(ProcedureError, match="does not support repair"):
        call(cat, "CALL sys.repair()")
    # remove_orphan_files is ported: it sweeps the test's table
    port_execute(cat, "CREATE TABLE db.t (k BIGINT NOT NULL, v DOUBLE, PRIMARY KEY (k) NOT ENFORCED) "
                      "WITH ('bucket' = '1')")
    port_execute(cat, "INSERT INTO db.t VALUES (1, 1.0), (2, 2.0)")
    assert call(cat, "CALL sys.remove_orphan_files('db.t')") == {"orphans": [], "dry_run": False}
    debris = f"{tmp_path}/db.db/t/bucket-0/data-orphan.parquet"
    with open(debris, "wb") as f:
        f.write(b"junk")
    assert call(cat, "CALL sys.remove_orphan_files('db.t', -1, true)") == {"orphans": [debris], "dry_run": True}
    assert call(cat, "CALL sys.remove_orphan_files(`table` => 'db.t', older_than_hours => -1)") == {
        "orphans": [debris], "dry_run": False}
    assert not os.path.exists(debris) and port_execute(cat, "SELECT count(*) FROM db.t").to_pylist() == [(2,)]
    jcat = JaxCatalog(str(tmp_path / "jax"))
    jax_execute(jcat, "CREATE TABLE db.t (k BIGINT NOT NULL, v DOUBLE, PRIMARY KEY (k) NOT ENFORCED) "
                      "WITH ('bucket' = '1')")
    jax_execute(jcat, "INSERT INTO db.t VALUES (1, 1.0), (2, 2.0)")
    # the privilege procedures are ported: on a FileSystemCatalog the same
    # call raises what the JAX package raises (no privilege support, or the
    # procedure's arity)
    for name in ("init_file_based_privilege", "create_privileged_user", "drop_privileged_user",
                 "grant_privilege_to_user", "revoke_privilege_from_user"):
        statement = f"CALL sys.{name}('db.t', 'x')"
        with pytest.raises(Exception) as jax_err:
            jax_execute(jcat, statement)
        with pytest.raises(ProcedureError) as port_err:
            call(cat, statement)
        assert type(jax_err.value).__name__ == type(port_err.value).__name__
        assert str(port_err.value) == str(jax_err.value)
    # on a PrivilegedCatalog each returns what the JAX package returns, and
    # each package's grants hold in the other's manager
    from paimon_tpu.catalog.privilege import PrivilegedCatalog as JaxPrivileged
    from paimon_tpu.sql import call as jax_call
    from paimon_tpu_torch.catalog.privilege import PrivilegedCatalog as PortPrivileged

    privileged = {"jax": JaxPrivileged(str(tmp_path / "jax"), "root", "rootpw"),
                  "port": PortPrivileged(str(tmp_path), "root", "rootpw", device="cpu")}
    for statement in ("CALL sys.init_file_based_privilege('rootpw')", "CALL sys.create_privileged_user('alice', 'pw1')",
                      "CALL sys.grant_privilege_to_user('alice', 'SELECT', 'db', 't')",
                      "CALL sys.grant_privilege_to_user('alice', 'INSERT', 'db')",
                      "CALL sys.revoke_privilege_from_user('alice', 'INSERT', 'db')"):
        got = {"jax": jax_call(privileged["jax"], statement), "port": call(privileged["port"], statement)}
        assert got["port"] == got["jax"], statement
    from paimon_tpu.catalog.privilege import PrivilegeManager as JaxManager
    from paimon_tpu_torch.catalog.privilege import PrivilegeManager as PortManager

    for warehouse in (tmp_path / "jax", tmp_path):
        for manager in (JaxManager, PortManager):
            m = manager(str(warehouse))
            assert m.has("alice", "db.t", "SELECT") and not m.has("alice", "db.t", "INSERT")
            assert m.authenticate("alice", "pw1") and not m.authenticate("alice", "pw2")
    assert call(privileged["port"], "CALL sys.drop_privileged_user('alice')") == {"dropped_user": "alice"}
    # query_service is ported: the same call returns the JAX package's
    # result but for the address, and each package's client reads the
    # other's server
    from paimon_tpu.service import KvQueryClient as JaxClient
    from paimon_tpu_torch.service import KvQueryClient as PortClient

    served = {"jax": jax_execute(jcat, "CALL sys.query_service('db.t')"),
              "port": call(cat, "CALL sys.query_service('db.t')")}
    try:
        assert {k: v for k, v in served["port"].items() if k not in ("host", "port", "server")} == \
            {k: v for k, v in served["jax"].items() if k not in ("host", "port", "server")} == {"service": "kv-query"}
        for server, client in (("jax", PortClient), ("port", JaxClient)):
            c = client(served[server]["host"], served[server]["port"])
            assert c.get_batch([1, 2, 3]) == [(1, 1.0), (2, 2.0), None] and c.lookup((), 2) == (2, 2.0)
            c.close()
    finally:
        for got in served.values():
            got["server"].shutdown()
    # the migrate procedures are ported: the same call raises what the JAX
    # package raises on the same warehouse (no files in 'x', no directory
    # 'x', no table 'x')
    for name, error in (("migrate_table", ProcedureError), ("migrate_database", FileNotFoundError),
                        ("migrate_file", ProcedureError)):
        statement = f"CALL sys.{name}('db.t', 'x')"
        with pytest.raises(Exception) as jax_err:
            jax_execute(jcat, statement)
        with pytest.raises(error) as port_err:
            call(cat, statement)
        assert type(jax_err.value).__name__ == type(port_err.value).__name__
        assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(NotImplementedError, match="sql/cluster.py"):
        cluster_query(cat, "SELECT 1 FROM db.t", client=None)
    # the catalog-scope system tables are ported
    assert cat.get_table("sys.all_table_options").to_pylist() == jcat.get_table("sys.all_table_options").to_pylist()
    from paimon_tpu.sql import procedures as jax_procedures

    assert set(procedures) == set(jax_procedures)


def test_sql_grand_tour(twin):
    twin("CREATE TABLE shop.orders ("
         "  oid BIGINT NOT NULL, region STRING NOT NULL, amount DOUBLE,"
         "  status STRING COMMENT 'open|done', PRIMARY KEY (oid, region) NOT ENFORCED"
         ") PARTITIONED BY (region) WITH ('bucket' = '2', 'write-only' = 'true')")
    twin("CREATE TABLE shop.staging ("
         "  oid BIGINT NOT NULL, region STRING NOT NULL, amount DOUBLE, status STRING,"
         "  PRIMARY KEY (oid, region) NOT ENFORCED) WITH ('bucket' = '1')")
    twin("INSERT INTO shop.orders VALUES "
         "(1, 'eu', 10, 'open'), (2, 'eu', 20, 'open'), (3, 'us', 30, 'open'), (4, 'us', 40, 'done')")
    twin("UPDATE shop.orders SET status = 'done' WHERE amount >= 30")
    twin("SELECT count(*) FROM shop.orders WHERE status = 'done'")
    twin("DELETE FROM shop.orders WHERE oid = 2")
    twin("CALL sys.create_tag('shop.orders', 'pre-fix')")
    twin("INSERT INTO shop.staging VALUES (1, 'eu', 11, 'fixed'), (9, 'eu', 99, 'new')")
    out = twin("CALL sys.merge_into(target_table => 'shop.orders', source_table => 'shop.staging', "
               "merge_condition => 'orders.oid = staging.oid AND orders.region = staging.region', "
               "matched_upsert_setting => '*', not_matched_insert_values => '*')")
    assert out == {"rows_updated": 1, "rows_deleted": 0, "rows_inserted": 1}
    twin("SELECT region, count(*), sum(amount) FROM shop.orders GROUP BY region ORDER BY region")
    twin("SELECT count(*) FROM shop.orders FOR TAG AS OF 'pre-fix'")
    twin("CALL sys.compact(`table` => 'shop.orders', `full` => true)")
    twin("ALTER TABLE shop.orders SET ('file-index.bloom-filter.columns' = 'oid')")
    twin("CALL sys.rewrite_file_index('shop.orders')")
    twin("ANALYZE TABLE shop.orders COMPUTE STATISTICS FOR ALL COLUMNS")
    twin("ALTER TABLE shop.orders ADD COLUMN note STRING")
    twin("SELECT note FROM shop.orders LIMIT 1")
    created = twin("SHOW CREATE TABLE shop.orders")
    twin(created.replace("shop.orders", "shop.orders_copy"))
    twin("SHOW TABLES IN shop")
    twin("TRUNCATE TABLE shop.staging")
    twin("SELECT count(*) FROM shop.staging")
    assert os.path.isdir(twin.pw)
