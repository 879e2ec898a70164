"""sequence.field and partial-update sequence groups in the port
(paimon_tpu_torch) against the JAX package, on the CPU (device="cpu" for
the port; the JAX package's Pallas kernels run in interpret mode).

MergeExecutor parity: one merge of the same seeded rows in each package,
for 4 merge engines x 3 sort engines, ordered by a BIGINT, a TIMESTAMP, a
STRING or a two-field (BIGINT, STRING) sequence.field with ties (which the
system sequence number breaks) and, with seq_ascending, without the
system sequence lanes. A null in the sequence field raises the JAX
package's ValueError. Sequence groups: every case of
tests/test_sequence_groups.py on a port table, with the JAX package's
expected rows, and MergeExecutor parity with BIGINT and STRING group
columns holding nulls, aggregates inside groups (a field's own function
and fields.default-aggregate-function), -U/-D rows under
remove-record-on-delete, at each sort engine.

Tables: each package writes streaming commits with compaction (late rows
among them, which must lose) under each engine, and both packages read
both tables, equal to an oracle; each package continues the other's table
through more compactions. local-merge-buffer-size with sequence.field
raises the JAX package's ValueError.

Tolerance: exact. Keys, sequence numbers, row kinds and values are copied,
picked or summed over integers, so every value must be equal.
"""

import io

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import paimon_tpu as jt
import paimon_tpu_torch as tt
from paimon_tpu.catalog import FileSystemCatalog as JaxCatalog
from paimon_tpu.core.kv import KVBatch as JaxKV
from paimon_tpu.core.mergefn import MergeExecutor as JaxMerge
from paimon_tpu.data.batch import Column as JaxColumn
from paimon_tpu.data.batch import ColumnBatch as JaxBatch
from paimon_tpu.options import CoreOptions as JaxOptions
from paimon_tpu.types import parse_type as jax_type
from paimon_tpu_torch.catalog import FileSystemCatalog as PortCatalog
from paimon_tpu_torch.core.kv import KVBatch as PortKV
from paimon_tpu_torch.core.mergefn import MergeExecutor as PortMerge
from paimon_tpu_torch.data.batch import Column as PortColumn
from paimon_tpu_torch.data.batch import ColumnBatch as PortBatch
from paimon_tpu_torch.options import CoreOptions as PortOptions
from paimon_tpu_torch.types import parse_type as port_type

INSERT, UPDATE_BEFORE, UPDATE_AFTER, DELETE = 0, 1, 2, 3
SORT_ENGINES = ["pallas", "xla-segmented", "numpy"]


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


@pytest.fixture
def warehouse(tmp_path):
    return str(tmp_path)


def _batches(fields: dict, columns: dict, valid: dict | None = None):
    """The same rows as a JAX and a port ColumnBatch; fields maps a name to
    its type string, valid a name to its non-null mask."""
    valid = valid or {}
    jschema = jt.RowType.of(*((n, jax_type(t)) for n, t in fields.items()))
    tschema = tt.RowType.of(*((n, port_type(t)) for n, t in fields.items()))
    jb = JaxBatch(jschema, {n: JaxColumn(np.asarray(v), None if n not in valid else valid[n].copy())
                            for n, v in columns.items()})
    tb = PortBatch(tschema, {n: PortColumn(np.asarray(v), None if n not in valid else valid[n].copy())
                             for n, v in columns.items()})
    return jb, tb


def _merge_both(jb, tb, key, opts, seq, kind, seq_ascending=False):
    """Each package's MergeExecutor merge of the same rows: (port, jax)."""
    jo, to = JaxOptions(opts), PortOptions(opts)
    want = JaxMerge(jb.schema, key, jo.merge_engine, jo).merge(JaxKV(jb, seq, kind), seq_ascending=seq_ascending)
    got = PortMerge(tb.schema, key, to.merge_engine, to, device="cpu").merge(
        PortKV(tb, seq, kind), seq_ascending=seq_ascending)
    return got, want


def _assert_same(got, want):
    assert np.array_equal(got.seq, want.seq) and np.array_equal(got.kind, want.kind)
    assert got.data.to_pylist() == want.data.to_pylist()


# ---------------------------------------------------------------------------
# sequence.field
# ---------------------------------------------------------------------------

MERGE_ENGINES = {
    "deduplicate": {},
    "partial-update": {"merge-engine": "partial-update"},
    "aggregation": {"merge-engine": "aggregation", "fields.a.aggregate-function": "sum"},
    "first-row": {"merge-engine": "first-row"},
}
SEQ_TYPES = {
    "bigint": {"ts": "BIGINT"},
    "timestamp": {"ts": "TIMESTAMP(3)"},
    "string": {"ts": "STRING"},
    "two-fields": {"ts": "BIGINT", "tz": "STRING"},
}


def _seq_values(rng, name, type_str, n):
    """Few distinct values, so equal keys often tie on the field."""
    if type_str == "STRING":
        return np.array(["", "a", "a\x00", "ab", "b", "é"], dtype=object)[rng.integers(0, 6, n)]
    base = 1_700_000_000_000 if type_str.startswith("TIMESTAMP") else -3
    return base + rng.integers(0, 6, n).astype(np.int64)


@pytest.mark.parametrize("seq_ascending", [False, True], ids=["seq-lanes", "seq-ascending"])
@pytest.mark.parametrize("seq_type", list(SEQ_TYPES))
@pytest.mark.parametrize("sort_engine", SORT_ENGINES)
@pytest.mark.parametrize("engine", list(MERGE_ENGINES))
def test_merge_executor_matches_with_sequence_field(engine, sort_engine, seq_type, seq_ascending):
    rng = np.random.default_rng(7 + list(SEQ_TYPES).index(seq_type))
    n = 300
    seq_fields = SEQ_TYPES[seq_type]
    fields = {"id": "BIGINT NOT NULL", **{f: f"{t} NOT NULL" for f, t in seq_fields.items()},
              "a": "BIGINT", "s": "STRING"}
    columns = {"id": rng.integers(0, 60, n).astype(np.int64),
               **{f: _seq_values(rng, f, t, n) for f, t in seq_fields.items()},
               "a": rng.integers(-50, 50, n).astype(np.int64),
               "s": np.array([f"s{x}" for x in rng.integers(0, 9, n)], dtype=object)}
    valid = {"a": rng.random(n) < 0.8, "s": rng.random(n) < 0.8}
    jb, tb = _batches(fields, columns, valid)
    seq = np.arange(n, dtype=np.int64) if seq_ascending else rng.permutation(n).astype(np.int64)
    kind = np.zeros(n, dtype=np.uint8)
    if engine == "deduplicate":
        kind = rng.choice([INSERT, UPDATE_AFTER, DELETE], n, p=[0.7, 0.2, 0.1]).astype(np.uint8)
    opts = {**MERGE_ENGINES[engine], "sort-engine": sort_engine, "sequence.field": ",".join(seq_fields)}
    got, want = _merge_both(jb, tb, ["id"], opts, seq, kind, seq_ascending)
    _assert_same(got, want)
    assert got.num_rows == len(set(columns["id"].tolist()))


def test_sequence_field_orders_before_arrival():
    """A late row (lower ts) loses to an earlier row with a higher ts; a tie
    on ts goes to the later arrival."""
    fields = {"id": "BIGINT NOT NULL", "ts": "BIGINT NOT NULL", "v": "STRING"}
    jb, tb = _batches(fields, {"id": np.array([1, 1, 2, 2, 3]), "ts": np.array([5, 3, 2, 2, 9]),
                               "v": np.array(["new", "late", "first", "second", "only"], dtype=object)})
    seq = np.arange(5, dtype=np.int64)
    got, want = _merge_both(jb, tb, ["id"], {"sequence.field": "ts", "sort-engine": "pallas"}, seq,
                            np.zeros(5, np.uint8), seq_ascending=True)
    _assert_same(got, want)
    assert got.data.column("v").values.tolist() == ["new", "second", "only"]


@pytest.mark.parametrize("sort_engine", SORT_ENGINES)
def test_null_sequence_field_raises_the_jax_value_error(sort_engine):
    fields = {"id": "BIGINT NOT NULL", "ts": "BIGINT", "v": "BIGINT"}
    jb, tb = _batches(fields, {"id": np.array([1, 1]), "ts": np.array([1, 2]), "v": np.array([1, 2])},
                      {"ts": np.array([True, False])})
    opts = {"sequence.field": "ts", "sort-engine": sort_engine}
    seq, kind = np.arange(2, dtype=np.int64), np.zeros(2, np.uint8)
    with pytest.raises(ValueError) as want:
        JaxMerge(jb.schema, ["id"], JaxOptions(opts).merge_engine, JaxOptions(opts)).merge(JaxKV(jb, seq, kind))
    with pytest.raises(ValueError) as got:
        PortMerge(tb.schema, ["id"], PortOptions(opts).merge_engine, PortOptions(opts), device="cpu").merge(
            PortKV(tb, seq, kind))
    assert str(got.value) == str(want.value) == "key column 'ts' contains nulls"


def test_sequence_field_disables_the_keys_only_read():
    schema = tt.RowType.of(("id", tt.BIGINT(False)), ("ts", tt.BIGINT(False)))
    plain = PortMerge(schema, ["id"], options=PortOptions({}), device="cpu")
    ordered = PortMerge(schema, ["id"], options=PortOptions({"sequence.field": "ts"}), device="cpu")
    assert plain.supports_keys_only_pipeline() and not ordered.supports_keys_only_pipeline()


# ---------------------------------------------------------------------------
# sequence groups
# ---------------------------------------------------------------------------

GROUPED = {"bucket": "1", "merge-engine": "partial-update", "fields.seq_a.sequence-group": "a",
           "fields.seq_b.sequence-group": "b"}
AGG_GROUP = {"bucket": "1", "merge-engine": "partial-update", "fields.g.sequence-group": "total"}


def _group_table(name, warehouse, ident, options, fields):
    pkg = jt if name == "jax" else tt
    catalog = JaxCatalog(warehouse) if name == "jax" else PortCatalog(warehouse, device="cpu")
    schema = pkg.RowType.of(*((n, pkg.types.parse_type(t)) for n, t in fields))
    return catalog.create_table(f"{ident}_{name}", schema, primary_keys=["k"], options=options)


def _write(table, data):
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.write(data)
    wb.new_commit().commit(w.prepare_commit())


def _read(table, engine=None) -> list:
    if engine is not None:
        table = table.copy({"sort-engine": engine})
    rb = table.new_read_builder()
    return rb.new_read().read_all(rb.new_scan().plan()).to_pylist()


GROUP_FIELDS = [("k", "BIGINT"), ("a", "INT"), ("seq_a", "BIGINT"), ("b", "INT"), ("seq_b", "BIGINT")]
AGG_FIELDS = [("k", "BIGINT"), ("total", "INT"), ("g", "BIGINT")]
# the cases of tests/test_sequence_groups.py: (options, fields, commits, rows read)
GROUP_CASES = {
    "independent_ordering": (GROUPED, GROUP_FIELDS, [
        {"k": [1], "a": [20], "seq_a": [2], "b": [None], "seq_b": [None]},
        {"k": [1], "a": [10], "seq_a": [1], "b": [100], "seq_b": [5]}], [(1, 20, 2, 100, 5)]),
    "update_on_higher_seq": (GROUPED, GROUP_FIELDS, [
        {"k": [1], "a": [10], "seq_a": [1], "b": [100], "seq_b": [1]},
        {"k": [1], "a": [30], "seq_a": [3], "b": [None], "seq_b": [None]}], [(1, 30, 3, 100, 1)]),
    "ties_resolved_by_system_seq": (GROUPED, GROUP_FIELDS, [
        {"k": [1, 1], "a": [10, 11], "seq_a": [7, 7], "b": [None, None], "seq_b": [None, None]}],
        [(1, 11, 7, None, None)]),
    "aggregation_within_sequence_group": ({**AGG_GROUP, "fields.total.aggregate-function": "sum"}, AGG_FIELDS, [
        {"k": [1, 1], "total": [10, 5], "g": [1, 2]}, {"k": [1], "total": [7], "g": [3]}], [(1, 22, 3)]),
    "group_aggregation_skips_null_group_rows": ({**AGG_GROUP, "fields.total.aggregate-function": "sum"}, AGG_FIELDS,
                                                [{"k": [1, 1], "total": [10, 5], "g": [1, None]}], [(1, 10, 1)]),
    "group_aggregation_default_function": ({**AGG_GROUP, "fields.default-aggregate-function": "sum"}, AGG_FIELDS,
                                           [{"k": [1, 1], "total": [10, 5], "g": [1, 2]}], [(1, 15, 2)]),
}


@pytest.mark.parametrize("case", list(GROUP_CASES))
def test_sequence_group_cases_of_the_reference(warehouse, case):
    options, fields, commits, want = GROUP_CASES[case]
    tables = {name: _group_table(name, warehouse, f"db.{case}", options, fields) for name in ("jax", "port")}
    for table in tables.values():
        for data in commits:
            _write(table, data)
    assert _read(tables["jax"]) == want
    for engine in SORT_ENGINES:
        assert _read(tables["port"], engine) == want
    assert _read(PortCatalog(warehouse, device="cpu").get_table(f"db.{case}_jax")) == want
    assert _read(JaxCatalog(warehouse).get_table(f"db.{case}_port")) == want


GROUP_EXECUTORS = {
    "bigint-groups": {"fields.g1.sequence-group": "a,b", "fields.g2.sequence-group": "c,d"},
    "string-group": {"fields.gs.sequence-group": "a,b", "fields.g2.sequence-group": "c,d"},
    "aggregates-in-groups": {"fields.g1.sequence-group": "a,b", "fields.g2.sequence-group": "c,d",
                             "fields.c.aggregate-function": "sum", "fields.b.aggregate-function": "max"},
    "default-aggregate": {"fields.g1.sequence-group": "a,b", "fields.default-aggregate-function": "sum"},
    "remove-on-delete": {"fields.g1.sequence-group": "a,b", "fields.g2.sequence-group": "c,d",
                         "partial-update.remove-record-on-delete": "true"},
    "with-sequence-field": {"fields.g1.sequence-group": "a,b", "sequence.field": "ts"},
}


@pytest.mark.parametrize("seq_ascending", [False, True], ids=["seq-lanes", "seq-ascending"])
@pytest.mark.parametrize("sort_engine", SORT_ENGINES)
@pytest.mark.parametrize("case", list(GROUP_EXECUTORS))
def test_merge_executor_matches_with_sequence_groups(case, sort_engine, seq_ascending):
    rng = np.random.default_rng(40 + list(GROUP_EXECUTORS).index(case))
    n = 300
    fields = {"k": "BIGINT NOT NULL", "ts": "BIGINT NOT NULL", "a": "BIGINT", "b": "BIGINT", "g1": "BIGINT",
              "gs": "STRING", "c": "BIGINT", "d": "STRING", "g2": "BIGINT", "e": "BIGINT"}
    columns = {"k": rng.integers(0, 50, n).astype(np.int64), "ts": rng.integers(0, 5, n).astype(np.int64)}
    for name in ("a", "b", "c", "e"):
        columns[name] = rng.integers(-100, 100, n).astype(np.int64)
    for name in ("g1", "g2"):
        columns[name] = rng.integers(0, 6, n).astype(np.int64)
    columns["gs"] = np.array(["", "a", "a\x00", "b", "é"], dtype=object)[rng.integers(0, 5, n)]
    columns["d"] = np.array([f"d{x}" for x in rng.integers(0, 9, n)], dtype=object)
    valid = {name: rng.random(n) < 0.75 for name in ("a", "b", "c", "d", "e", "g1", "gs", "g2")}
    jb, tb = _batches(fields, columns, valid)
    seq = np.arange(n, dtype=np.int64) if seq_ascending else rng.permutation(n).astype(np.int64)
    kind = np.zeros(n, dtype=np.uint8)
    if case == "remove-on-delete":
        kind = rng.choice([INSERT, UPDATE_BEFORE, UPDATE_AFTER, DELETE], n, p=[0.6, 0.1, 0.2, 0.1]).astype(np.uint8)
    opts = {"merge-engine": "partial-update", "sort-engine": sort_engine, **GROUP_EXECUTORS[case]}
    got, want = _merge_both(jb, tb, ["k"], opts, seq, kind, seq_ascending)
    _assert_same(got, want)


def test_sequence_groups_take_the_planned_path(monkeypatch):
    """With groups the port plans (one plan for the key, one per group)
    instead of the fused partial-update call, as the JAX package does."""
    import paimon_tpu_torch.ops.merge as tm

    plans = []
    real = tm.merge_plan
    monkeypatch.setattr(tm, "merge_plan", lambda *a, **k: plans.append(0 if a[1] is None else a[1].shape[1]) or real(*a, **k))
    fields = {"k": "BIGINT NOT NULL", "a": "BIGINT", "g1": "BIGINT", "c": "BIGINT", "g2": "STRING"}
    _, tb = _batches(fields, {"k": np.array([1, 1, 2]), "a": np.array([1, 2, 3]), "g1": np.array([2, 1, 0]),
                              "c": np.array([4, 5, 6]), "g2": np.array(["x", "y", "z"], dtype=object)})
    opts = PortOptions({"merge-engine": "partial-update", "sort-engine": "pallas", "fields.g1.sequence-group": "a",
                        "fields.g2.sequence-group": "c"})
    out = PortMerge(tb.schema, ["k"], opts.merge_engine, opts, device="cpu").merge(
        PortKV(tb, np.arange(3, dtype=np.int64), np.zeros(3, np.uint8)), seq_ascending=True)
    assert out.data.to_pylist() == [(1, 1, 2, 5, "y"), (2, 3, 0, 6, "z")]
    # the key plan has no sequence lanes; each group plan has its lanes and
    # the system sequence number's two
    assert plans == [0, 4, 3]


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

TABLE_ENGINES = {
    "deduplicate": {},
    "partial-update": {"merge-engine": "partial-update"},
    "aggregation": {"merge-engine": "aggregation", "fields.a.aggregate-function": "sum"},
    "first-row": {"merge-engine": "first-row"},
}
COMPACTING = {"bucket": "1", "num-sorted-run.compaction-trigger": "3",
              "compaction.max-size-amplification-percent": "0", "sort-engine": "pallas"}
SEQ_TABLES = {"bigint": "BIGINT NOT NULL", "string": "STRING NOT NULL"}


def _seq_table(name, catalog, ident, engine, ts_type, extra=None):
    pkg = jt if name == "jax" else tt
    schema = pkg.RowType.of(("id", pkg.BIGINT(False)), ("ts", pkg.types.parse_type(ts_type)), ("a", pkg.BIGINT()),
                            ("s", pkg.STRING()))
    options = {**COMPACTING, **TABLE_ENGINES[engine], "sequence.field": "ts", **(extra or {})}
    return catalog.create_table(ident, schema, primary_keys=["id"], options=options)


def _ts(values, ts_type):
    return np.array([f"{v:04d}" for v in values], dtype=object) if ts_type.startswith("STRING") else values


def _seq_commits(ts_type, n=8, rows=40, seed=17):
    """Commits of a CDC stream: ts rises with the commit, but a tenth of each
    commit's rows carry a ts older than their id's newest (late events), and
    some ids repeat within a commit."""
    rng = np.random.default_rng(seed)
    newest = {}
    out = []
    for c in range(n):
        ids = rng.integers(0, 50, rows).astype(np.int64)
        ts = (c + 1) * 100 + rng.integers(0, 50, rows)
        late = rng.random(rows) < 0.1
        for i in np.flatnonzero(late):
            if int(ids[i]) in newest:
                ts[i] = newest[int(ids[i])] - 1 - rng.integers(0, 20)
        for i, t in zip(ids.tolist(), ts.tolist()):
            newest[i] = max(newest.get(i, t), t)
        a = rng.integers(0, 100, rows).astype(np.int64)
        s = np.array([f"s{x}" for x in rng.integers(0, 9, rows)], dtype=object)
        a_valid, s_valid = rng.random(rows) < 0.8, rng.random(rows) < 0.8
        out.append({"id": ids, "ts": _ts(ts, ts_type), "a": [int(x) if ok else None for x, ok in zip(a, a_valid)],
                    "s": [x if ok else None for x, ok in zip(s, s_valid)]})
    return out


def _seq_oracle(engine, commits) -> list:
    """Per id over every row in (ts, arrival) order: the last (deduplicate),
    the first (first-row), the last non-null of each field
    (partial-update), or the sum of a and the last non-null s
    (aggregation)."""
    rows = [(int(c["id"][i]), c["ts"][i], arrival, c["a"][i], c["s"][i])
            for arrival, c in enumerate(commits) for i in range(len(c["id"]))]
    rows = sorted(enumerate(rows), key=lambda r: (r[1][0], r[1][1], r[1][2], r[0]))
    by_id: dict = {}
    for _, r in rows:
        by_id.setdefault(r[0], []).append(r)
    out = []
    for k in sorted(by_id):
        rs = by_id[k]
        if engine == "deduplicate":
            r = rs[-1]
        elif engine == "first-row":
            r = rs[0]
        else:
            last_ts = rs[-1][1]
            a = [x[3] for x in rs if x[3] is not None]
            s = [x[4] for x in rs if x[4] is not None]
            a_out = (sum(a) if a else None) if engine == "aggregation" else (a[-1] if a else None)
            r = (k, last_ts, None, a_out, s[-1] if s else None)
        out.append((r[0], r[1], r[3], r[4]))
    return out


def _stream(table, commits, first_identifier=1):
    wb = table.new_stream_write_builder()
    w, c = wb.new_write(), wb.new_commit()
    for i, rows in enumerate(commits):
        w.write(rows)
        c.commit_messages(first_identifier + i, w.prepare_commit())


def _rows(table, engine=None) -> list:
    return [tuple(v.item() if hasattr(v, "item") else v for v in r) for r in _read(table, engine)]


TABLE_CASES = [(engine, ts) for engine in TABLE_ENGINES for ts in SEQ_TABLES]


@pytest.mark.parametrize("engine, ts", TABLE_CASES, ids=[f"{e}-{t}" for e, t in TABLE_CASES])
def test_tables_match_across_packages(warehouse, engine, ts):
    commits = _seq_commits(SEQ_TABLES[ts])
    want = _seq_oracle(engine, commits)
    for name, catalog in (("jax", JaxCatalog(warehouse)), ("port", PortCatalog(warehouse, device="cpu"))):
        table = _seq_table(name, catalog, f"db.seq_{engine.replace('-', '_')}_{ts}_{name}", engine, SEQ_TABLES[ts])
        _stream(table, commits)
    for name in ("jax", "port"):
        ident = f"db.seq_{engine.replace('-', '_')}_{ts}_{name}"
        port = PortCatalog(warehouse, device="cpu").get_table(ident)
        for sort_engine in SORT_ENGINES:
            assert _rows(port, sort_engine) == want, (name, sort_engine)
        assert _rows(JaxCatalog(warehouse).get_table(ident), "numpy") == want, name
    sm = PortCatalog(warehouse, device="cpu").get_table(f"db.seq_{engine.replace('-', '_')}_{ts}_port").store.snapshot_manager
    kinds = [sm.snapshot(i).commit_kind.value for i in range(1, sm.latest_snapshot_id() + 1)]
    assert "COMPACT" in kinds


@pytest.mark.parametrize("first", ["jax", "port"])
@pytest.mark.parametrize("engine", ["deduplicate", "partial-update"])
def test_each_package_continues_the_others_table(warehouse, first, engine):
    commits = _seq_commits(SEQ_TABLES["bigint"], n=10, seed=23)
    second = "port" if first == "jax" else "jax"
    catalogs = {"jax": JaxCatalog(warehouse), "port": PortCatalog(warehouse, device="cpu")}
    ident = f"db.continue_{engine.replace('-', '_')}_{first}"
    _stream(_seq_table(first, catalogs[first], ident, engine, SEQ_TABLES["bigint"]), commits[:5])
    _stream(catalogs[second].get_table(ident), commits[5:], first_identifier=6)
    want = _seq_oracle(engine, commits)
    assert _rows(catalogs["port"].get_table(ident)) == want
    assert _rows(catalogs["jax"].get_table(ident), "numpy") == want
    wb = catalogs["port"].get_table(ident).new_batch_write_builder()
    w = wb.new_write()
    w.compact(full=True)
    wb.new_commit().commit(w.prepare_commit())
    assert _rows(catalogs["jax"].get_table(ident), "numpy") == _rows(catalogs["port"].get_table(ident)) == want


def test_local_merge_buffer_with_sequence_field_raises_the_jax_value_error(warehouse):
    messages = []
    for name, catalog in (("jax", JaxCatalog(warehouse)), ("port", PortCatalog(warehouse, device="cpu"))):
        table = _seq_table(name, catalog, f"db.local_merge_{name}", "deduplicate", SEQ_TABLES["bigint"],
                           {"local-merge-buffer-size": "1 mb"})
        with pytest.raises(ValueError) as err:
            table.new_stream_write_builder().new_write()
        messages.append(str(err.value))
    assert messages[0] == messages[1] == "local-merge-buffer-size cannot combine with sequence.field"
