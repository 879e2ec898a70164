"""DDL and DML through the port's SQL surface (paimon_tpu_torch/sql/ddl.py,
sql/dml.py, table/rowops.py, table/statistics.py) against the JAX
package's, on the CPU (device="cpu").

Each case runs one script of statements twice, through
paimon_tpu.sql.execute on one warehouse and paimon_tpu_torch.sql.execute on
another, and after every statement asserts the same result (or the same
error class and message). After every statement that writes, each table
holds the same rows in both warehouses, and each package reads the other's
warehouse to the same rows. The scripts are the counterparts of
tests/test_sql_ddl.py: CREATE TABLE with the full grammar (types,
comments, keys, partitions, options, IF NOT EXISTS), SHOW, SHOW CREATE
TABLE round trips, DESCRIBE (of a system table too), DROP, CREATE and DROP
DATABASE, every ALTER clause, INSERT VALUES (column subsets, NULLs, NOT
NULL checks), INSERT ... SELECT, INSERT OVERWRITE, UPDATE with
self-referencing and table-qualified SET expressions (on primary-key and
append tables, and a string literal holding WHERE), DELETE FROM, TRUNCATE
(of a partitioned table too, and time travel before it), ANALYZE and
$statistics, execute_script and split_statements. Nested column types are
pinned to NotImplementedError (the port's types are flat, ROADMAP Queue 1
item 11).

Tolerance: exact. Rows are compared as multisets where the order of an
append table's copy-on-write rewrite is not defined (ROADMAP Queue 3 item
20), and in order everywhere else; floats bit for bit.
"""

import io

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from paimon_tpu.catalog import FileSystemCatalog as JaxCatalog
from paimon_tpu.sql import execute as jax_execute
from paimon_tpu.sql import split_statements as jax_split
from paimon_tpu_torch.catalog import FileSystemCatalog as PortCatalog
from paimon_tpu_torch.sql import execute as port_execute
from paimon_tpu_torch.sql import execute_script, split_statements
from paimon_tpu_torch.sql.ddl import DdlError


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


def _sort_key(row):
    return tuple((v is None, repr(v)) for v in row)


class Twin:
    """One warehouse per package, the same statements on both."""

    def __init__(self, tmp_path):
        self.jw, self.pw = str(tmp_path / "jax"), str(tmp_path / "port")
        self.jcat = JaxCatalog(self.jw, commit_user="twin")
        self.pcat = PortCatalog(self.pw, commit_user="twin", device="cpu")
        self.unordered: set = set()

    def __call__(self, statement: str, check: bool = True, same_message: bool = True):
        try:
            want = jax_execute(self.jcat, statement)
        except Exception as e:  # noqa: BLE001 - the port must raise the same
            with pytest.raises(Exception) as info:
                port_execute(self.pcat, statement)
            assert type(info.value).__name__ == type(e).__name__, f"{statement}: {info.value!r} vs {e!r}"
            if same_message:
                assert str(info.value).replace(self.pw, "<w>") == str(e).replace(self.jw, "<w>"), statement
            return None
        got = port_execute(self.pcat, statement)
        if isinstance(want, str):
            want, got = want.replace(self.jw, "<w>"), got.replace(self.pw, "<w>")
        assert_same(want, got, statement)
        if check and not statement.lstrip().upper().startswith(("SELECT", "SHOW", "DESC", "EXPLAIN")):
            self.check_tables()
        return got

    def tables(self):
        return [f"{db}.{t}" for db in self.jcat.list_databases() for t in self.jcat.list_tables(db)]

    def check_tables(self) -> None:
        """Every table: the same rows in both warehouses, and each package
        reads the other's warehouse to them."""
        assert self.tables() == [f"{db}.{t}" for db in self.pcat.list_databases() for t in self.pcat.list_tables(db)]
        pcat_of_jax = PortCatalog(self.jw, device="cpu")
        jcat_of_port = JaxCatalog(self.pw)
        for name in self.tables():
            reads = [_read(c.get_table(name)) for c in (self.jcat, self.pcat, pcat_of_jax, jcat_of_port)]
            if name in self.unordered:
                reads = [sorted(r.to_pylist(), key=_sort_key) for r in reads]
                assert reads[1] == reads[0] and reads[2] == reads[0] and reads[3] == reads[0], name
            else:
                for i, r in enumerate(reads[1:]):
                    assert_same(reads[0], r, f"{name} (read {i + 1})")


def _read(t):
    rb = t.new_read_builder()
    return rb.new_read().read_all(rb.new_scan().plan())


@pytest.fixture
def twin(tmp_path):
    return Twin(tmp_path)


CREATE = """
CREATE TABLE db.orders (
  `id` BIGINT NOT NULL,
  region STRING,
  amount DECIMAL(10, 2),
  note VARCHAR(40) COMMENT 'freeform',
  ts TIMESTAMP(3),
  PRIMARY KEY (id, region) NOT ENFORCED
) PARTITIONED BY (region) WITH ('bucket' = '2', 'file.format' = 'parquet')
"""


def test_create_table_full_grammar(twin):
    assert twin(CREATE) == {"created": "db.orders"}
    t = twin.pcat.get_table("db.orders")
    assert t.row_type.field_names == ["id", "region", "amount", "note", "ts"]
    assert t.primary_keys == ["id", "region"] and t.partition_keys == ["region"]
    assert t.row_type.field("amount").type.precision == 10
    twin("INSERT INTO db.orders VALUES (1, 'eu', 100, 'a', 0), (2, 'eu', 250, 'b', 0), (3, 'us', 7, NULL, 12)")
    twin("SELECT id, amount, note FROM db.orders ORDER BY id")
    twin("CREATE TABLE db.orders (x INT)")
    twin("CREATE TABLE IF NOT EXISTS db.orders (x INT)")
    twin("CREATE TABLE db.bad (x INT, PRIMARY KEY (nope) NOT ENFORCED)")
    twin("CREATE TABLE db.bad2 (x FROBNICATOR)")
    twin("CREATE TABLE db.bad3 (x INT) WITH (bucket = 2)")


def test_show_describe_drop(twin):
    twin(CREATE)
    twin("CREATE TABLE db.t2 (a INT)")
    twin("CREATE DATABASE other")
    twin("CREATE DATABASE other")
    twin("CREATE DATABASE IF NOT EXISTS other")
    twin("SHOW DATABASES")
    twin("SHOW TABLES IN db")
    twin("SHOW TABLES FROM other")
    twin("SHOW TABLES")
    twin("DESCRIBE db.orders")
    twin("DESC db.t2")
    created = twin("SHOW CREATE TABLE db.orders")
    assert "PARTITIONED BY (region)" in created and "'bucket' = '2'" in created
    twin(created.replace("db.orders", "db.copy"))
    twin("DESCRIBE db.copy")
    twin("DROP TABLE db.t2")
    twin("DROP TABLE db.t2")
    twin("DROP TABLE IF EXISTS db.t2")
    twin("TRUNCATE TABLE db.nope")
    twin("DROP DATABASE other")
    twin("DROP DATABASE nope")
    twin("DROP DATABASE IF EXISTS nope")
    twin("CREATE DATABASE sys")
    twin("SHOW DATABASES")


def test_alter_table(twin):
    twin("CREATE TABLE db.a (k BIGINT NOT NULL, v STRING, n INT, PRIMARY KEY (k) NOT ENFORCED) WITH ('bucket' = '1')")
    twin("INSERT INTO db.a VALUES (1, 'x', 5), (2, NULL, 6)")
    twin("ALTER TABLE db.a ADD COLUMN score DOUBLE")
    twin("INSERT INTO db.a VALUES (3, 'z', 7, 2.5)")
    twin("ALTER TABLE db.a RENAME COLUMN score TO points")
    twin("ALTER TABLE db.a SET ('snapshot.num-retained.max' = '5', 'write-only' = 'true')")
    twin("SHOW CREATE TABLE db.a")
    twin("ALTER TABLE db.a RESET ('write-only')")
    twin("ALTER TABLE db.a MODIFY n BIGINT")
    # the port's schema evolution words its refusal of a narrowing its own way
    twin("ALTER TABLE db.a MODIFY COLUMN n INT", same_message=False)
    twin("ALTER TABLE db.a ADD COLUMN req BIGINT NOT NULL")
    twin("ALTER TABLE db.a DROP COLUMN points")
    twin("ALTER TABLE db.a DROP COLUMN nope")
    twin("ALTER TABLE db.a RESET (write-only)")
    twin("ALTER TABLE db.a FROBNICATE")
    twin("ALTER TABLE db.nope ADD COLUMN c INT")
    twin("DESCRIBE db.a")
    twin("SELECT * FROM db.a ORDER BY k")


def test_insert_statements(twin):
    twin("CREATE TABLE db.i (k BIGINT NOT NULL, s STRING, x DOUBLE, PRIMARY KEY (k) NOT ENFORCED) "
         "WITH ('bucket' = '1')")
    assert twin("INSERT INTO db.i VALUES (1, 'a', 1.5), (2, 'b', NULL), (3, NULL, -2)")["inserted"] == 3
    twin("SELECT k, s, x FROM db.i ORDER BY k")
    twin("INSERT INTO db.i (k, s) VALUES (2, 'B')")
    twin("INSERT INTO db.i (s, k) VALUES ('neg', -7), ('it''s', 8)")
    twin("INSERT INTO db.i VALUES (4, 'e', 2 * 3 + 0.5), (-(5), 'f', -0.0)")
    twin("CREATE TABLE db.i2 (k BIGINT NOT NULL, s STRING, x DOUBLE, PRIMARY KEY (k) NOT ENFORCED) "
         "WITH ('bucket' = '1')")
    twin("INSERT INTO db.i2 SELECT k, s, x FROM db.i WHERE k <= 2")
    twin("INSERT INTO db.i2 SELECT k, s FROM db.i")
    twin("INSERT INTO db.i2 (k, s) SELECT k, s FROM db.i WHERE s IS NOT NULL")
    twin("INSERT INTO db.i2 SELECT nope FROM db.i")
    twin("INSERT OVERWRITE db.i2 VALUES (9, 'z', 0)")
    twin("INSERT OVERWRITE db.i2 SELECT k, s, x FROM db.i WHERE k > 2")
    twin("INSERT INTO db.i (s) VALUES ('no-key')")
    twin("INSERT INTO db.i VALUES (1, 'a')")
    twin("INSERT INTO db.i VALUES (NULL, 'x', 1)")
    twin("INSERT INTO db.i (k, nope) VALUES (1, 2)")
    twin("INSERT INTO db.nope VALUES (1)")
    twin("INSERT INTO db.i VALUES 1")
    twin("INSERT INTO db.i VALUES (1, k, 2)")
    twin("INSERT INTO db.i VALUES (1, 'a', 2) garbage")
    twin("INSERT db.i VALUES (1, 'a', 2)")


def test_update_delete_truncate_statements(twin):
    twin("CREATE TABLE db.u (k BIGINT NOT NULL, v BIGINT, s STRING, PRIMARY KEY (k) NOT ENFORCED) "
         "WITH ('bucket' = '1')")
    twin("INSERT INTO db.u VALUES (1, 10, 'a'), (2, 20, 'b'), (3, 30, 'c'), (4, NULL, 'd')")
    assert twin("UPDATE db.u SET v = v + 100, s = 'up' WHERE k <= 2")["rows_updated"] == 2
    twin("UPDATE db.u SET v = v + 1 WHERE k = 4")
    twin("UPDATE db.u SET v = v * 2 - k, s = u.s WHERE s <> 'up' AND v IS NOT NULL")
    twin("UPDATE db.u SET v = NULL WHERE k = 3")
    twin("UPDATE db.u SET k = 5 WHERE k = 1")
    twin("UPDATE db.u SET nope = 5 WHERE k = 1")
    twin("UPDATE db.u SET v = 1 WHERE k = v")
    twin("UPDATE db.u SET * WHERE k = 1")
    assert twin("DELETE FROM db.u WHERE s = 'up'")["rows_deleted"] == 2
    twin("DELETE FROM db.u WHERE k > 100")
    twin("DELETE FROM db.u")
    twin("DELETE FROM db.u WHERE TRUE")
    twin("DELETE FROM db.nope WHERE k = 1")
    twin("TRUNCATE TABLE db.u")
    twin("SELECT count(*) FROM db.u$snapshots")
    snaps = port_execute(twin.pcat, "SELECT count(*) FROM db.u$snapshots").to_pylist()[0][0]
    twin(f"SELECT * FROM db.u FOR VERSION AS OF {snaps - 1}")
    twin("UPDATE db.nope SET v = 1 WHERE k = 1")


def test_update_truncate_review_fixes(twin):
    twin("CREATE TABLE db.w (k BIGINT NOT NULL, s STRING, PRIMARY KEY (k) NOT ENFORCED) WITH ('bucket' = '1')")
    twin("INSERT INTO db.w VALUES (1, 'x')")
    twin("UPDATE db.w SET s = 'no WHERE clause'")
    twin("INSERT INTO db.w VALUES (2, 'y')")
    twin("UPDATE db.w SET s = w.s WHERE k = 2")
    twin("UPDATE db.w SET s = `db.w`.s WHERE k = 2")
    twin("UPDATE db.w SET s = t.s || 'x' WHERE k = 2")
    twin.unordered.add("db.ap")
    twin("CREATE TABLE db.ap (a BIGINT, b BIGINT, c STRING) WITH ('bucket' = '1')")
    twin("INSERT INTO db.ap VALUES (NULL, 5, 'p'), (1, 6, 'q'), (2, 7, 'r')")
    twin("UPDATE db.ap SET b = 0")
    twin("UPDATE db.ap SET c = 'upd', b = b + a WHERE a >= 1")
    twin("DELETE FROM db.ap WHERE c = 'upd' AND a = 2")
    twin("INSERT INTO db.ap VALUES (3, 3, 's')")
    twin("SELECT a, b, c FROM db.ap ORDER BY a")
    twin("CREATE TABLE db.pt (k BIGINT NOT NULL, dt STRING, PRIMARY KEY (k, dt) NOT ENFORCED) "
         "PARTITIONED BY (dt) WITH ('bucket' = '1')")
    twin("INSERT INTO db.pt VALUES (1, 'a'), (2, 'b')")
    twin("INSERT OVERWRITE db.pt VALUES (3, 'a')")
    twin("TRUNCATE TABLE db.pt")


def test_analyze_table_statement(twin):
    twin("CREATE TABLE db.an (k BIGINT NOT NULL, v DOUBLE, s STRING, PRIMARY KEY (k) NOT ENFORCED) "
         "WITH ('bucket' = '1')")
    twin("SELECT * FROM db.an$statistics")
    twin("INSERT INTO db.an VALUES (1, 0.5, 'a'), (2, 1.5, NULL), (3, 2.5, 'c')")
    out = twin("ANALYZE TABLE db.an COMPUTE STATISTICS FOR ALL COLUMNS")
    assert out["rows"] == 3 and "v" in out["columns"]
    twin("SELECT snapshot_id, schema_id, mergedRecordCount, colstat FROM db.an$statistics")
    twin("ANALYZE TABLE db.an COMPUTE STATISTICS")
    twin("SELECT snapshot_id, mergedRecordCount, colstat FROM db.an$statistics")
    twin("SELECT snapshot_id, commit_kind, total_record_count FROM db.an$snapshots")
    twin("ANALYZE TABLE db.nope COMPUTE STATISTICS")
    from paimon_tpu.table.statistics import read_statistics as jax_read
    from paimon_tpu_torch.table.statistics import read_statistics

    got = read_statistics(twin.pcat.get_table("db.an"))
    want = jax_read(JaxCatalog(twin.pw).get_table("db.an"))  # the port's file, read by the JAX package
    assert got.merged_record_count == want.merged_record_count == 3 and got.col_stats == want.col_stats


def test_ddl_review_fixes(twin):
    twin("CREATE TABLE db.q (k BIGINT NOT NULL, s STRING COMMENT 'a,b(c) it''s', "
         "PRIMARY KEY (k) NOT ENFORCED) WITH ('bucket' = '1')")
    assert twin.pcat.get_table("db.q").row_type.field("s").description == "a,b(c) it's"
    twin("SHOW CREATE TABLE db.nope")
    twin("DESCRIBE db.nope")
    twin("DESCRIBE db.q$snapshots")
    twin("DESCRIBE db.q$files")
    twin("CREATE TABLE db.cm (k BIGINT NOT NULL, s STRING COMMENT 'it''s a, (note)', "
         "PRIMARY KEY (k) NOT ENFORCED)")
    created = twin("SHOW CREATE TABLE db.cm")
    assert "COMMENT 'it''s a, (note)'" in created
    twin(created.replace("db.cm", "db.cm2"))
    twin("SHOW CREATE TABLE db.cm2")
    twin("FROBNICATE TABLE db.q")


def test_nested_types_are_refused():
    from paimon_tpu_torch.sql.ddl import ddl

    cat = PortCatalog("/nonexistent-warehouse", device="cpu")
    for text in ("CREATE TABLE db.n (k INT NOT NULL, tags ARRAY<STRING>)",
                 "CREATE TABLE db.n (k INT NOT NULL, attrs MAP<STRING, INT>)"):
        with pytest.raises(NotImplementedError, match="nested"):
            ddl(cat, text)
    with pytest.raises(DdlError):
        ddl(cat, "SHOW CREATE TABLE db.n")


def test_execute_script_and_split(twin):
    script = ("CREATE TABLE db.sc (k BIGINT NOT NULL, s STRING, PRIMARY KEY (k) NOT ENFORCED);\n"
              "-- a comment; with a semicolon\n"
              "INSERT INTO db.sc VALUES (1, 'a;b'), (2, 'it''s');  -- trailing comment\n"
              "SELECT count(*) FROM db.sc")
    stmts = split_statements(script)
    assert stmts == jax_split(script) and len(stmts) == 3
    results = execute_script(twin.pcat, ";\n".join(stmts))
    assert results[0] == {"created": "db.sc"} and results[1]["inserted"] == 2
    assert results[2].to_pylist() == [(2,)]
    assert dict(port_execute(twin.pcat, "SELECT k, s FROM db.sc").to_pylist()) == {1: "a;b", 2: "it's"}


@pytest.mark.parametrize("script", [
    "INSERT INTO db.t VALUES (1, 'line1\n-- not a comment\nline3');",
    "SELECT * FROM `weird;--name`",
    "-- header\nSELECT 1 FROM a; SELECT 2 FROM b -- tail",
    "INSERT INTO t VALUES ('unterminated; -- x",
    "SELECT 'a''b;c' FROM t;;  ; SELECT `x` FROM `y`",
    "",
])
def test_split_statements_matches_jax(script):
    assert split_statements(script) == jax_split(script)
