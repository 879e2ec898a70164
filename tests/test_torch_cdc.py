"""Schema-evolving CDC ingestion and the CDC formats of the port
(paimon_tpu_torch/table/cdc.py, table/cdc_format.py) against the JAX
package's, on the CPU (device="cpu" for the port).

Held equal between the packages on the same messages: every parser case
of tests/test_cdc_sources.py and more (records as (kind, fields), or the
same exception type and message), every formatter's messages and
parse(format(events)) == events in both, encode_changelog over one batch;
the streams of tests/test_cdc_sources.py and
tests/test_aux.py::test_cdc_schema_evolving_ingestion run by each package
on a warehouse of its own (records applied, rows, and the evolved
TableSchema field for field and id for id); replay filtering, resume, the
batch-sentinel skip and a parse error that leaves no file behind; a CDC
table written by each package read by the other. The port's tables merge
under sort-engine=pallas (the kernels' plain versions on the CPU), the JAX
package's under its numpy engine.

Where the port does not copy the JAX package (ROADMAP Queue 3 items 13
and 27): after a DELETE by the stream's own commit user, the JAX package
resumes from the DELETE's sentinel identifier (1 << 63) - 2, so its next
ingest commits under the batch sentinel, and its commit filter drops the
user's later streaming commits; the port resumes from the last streaming
identifier and its filter keeps them.

Tolerance: exact.
"""

import io
import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import paimon_tpu.catalog as jcatalog
import paimon_tpu.table.cdc as jcdc
import paimon_tpu.table.cdc_format as jfmt
import paimon_tpu.types as jtypes
import paimon_tpu_torch.catalog as pcatalog
import paimon_tpu_torch.table.cdc as pcdc
import paimon_tpu_torch.table.cdc_format as pfmt
import paimon_tpu_torch.types as ptypes
from paimon_tpu.data.batch import ColumnBatch as JaxBatch
from paimon_tpu_torch.data.batch import ColumnBatch as PortBatch

PKGS = ("jax", "port")
ENGINE = {"jax": {"sort-engine": "numpy"}, "port": {"sort-engine": "pallas"}}
FMT = {"jax": jfmt, "port": pfmt}
CDC = {"jax": jcdc, "port": pcdc}
TYPES = {"jax": jtypes, "port": ptypes}
DELETE_IDENTIFIER = (1 << 63) - 2


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


@pytest.fixture(autouse=True)
def _plain_download(monkeypatch):
    monkeypatch.setenv("PAIMON_TPU_FORCE_COMPACT", "0")


def catalog(pkg, warehouse, user="cdc"):
    if pkg == "jax":
        return jcatalog.FileSystemCatalog(str(warehouse), commit_user=user)
    return pcatalog.FileSystemCatalog(str(warehouse), commit_user=user, device="cpu")


def schema(pkg):
    t = TYPES[pkg]
    return t.RowType.of(("id", t.BIGINT()), ("name", t.STRING()))


def create(pkg, warehouse, name, user="cdc", row_type=None, options=None):
    cat = catalog(pkg, warehouse, user)
    t = cat.create_table(name, row_type or schema(pkg), primary_keys=["id"],
                         options={"bucket": "1", **ENGINE[pkg], **(options or {})})
    return cat, t


def read(t, pkg=None):
    if pkg is not None:
        t = t.copy(ENGINE[pkg])
    rb = t.new_read_builder()
    return sorted(rb.new_read().read_all(rb.new_scan().plan()).to_pylist(), key=repr)


def records(recs) -> list:
    return [(r.kind, dict(r)) for r in recs]


def outcome(fn, *args):
    """('ok', value) or ('raises', type name, message)."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 - the exception is the result compared
        return ("raises", type(e).__name__, str(e))


def table_schema(t) -> tuple:
    s = t.schema
    return (s.id, [(f.id, f.name, repr(f.type)) for f in s.fields], list(s.primary_keys), s.highest_field_id)


# ------------------------------------------------------------ the parsers
DEBEZIUM_STREAM = [
    {"schema": {}, "payload": {"op": "r", "before": None, "after": {"id": 1, "name": "ann"}}},
    {"schema": {}, "payload": {"op": "c", "before": None, "after": {"id": 2, "name": "bob"}}},
    {"schema": {}, "payload": {"op": "u", "before": {"id": 1, "name": "ann"}, "after": {"id": 1, "name": "anne"}}},
    {"schema": {}, "payload": {"op": "d", "before": {"id": 2, "name": "bob"}, "after": None}},
    {"schema": {}, "payload": {"op": "c", "before": None, "after": {"id": 3, "name": "cy", "city": "berlin"}}},
]
CANAL_STREAM = [
    {"type": "INSERT", "data": [{"id": 1, "name": "x"}, {"id": 2, "name": "y"}], "old": None},
    {"type": "UPDATE", "data": [{"id": 2, "name": "y2"}], "old": [{"name": "y"}]},
    {"type": "DELETE", "data": [{"id": 1, "name": "x"}], "old": None},
    {"type": "CREATE", "sql": "alter table ..."},
]
MAXWELL_STREAM = [
    {"type": "insert", "data": {"id": 1, "name": "m"}},
    {"type": "update", "data": {"id": 1, "name": "m2"}, "old": {"name": "m"}},
    {"type": "insert", "data": {"id": 9, "name": "z"}},
    {"type": "delete", "data": {"id": 9, "name": "z"}},
    {"type": "bootstrap-start"},
]
JSON_STREAM = [{"id": 1, "name": "a"}, {"id": 2, "name": "b", "score": 2.5}]

PARSE_CASES = {
    "debezium": [
        *DEBEZIUM_STREAM,
        {"op": "u", "before": {"id": 1, "v": 1}, "after": {"id": 1, "v": 2}},
        {"op": "u", "before": None, "after": {"id": 1, "v": 2}},
        {"op": "c", "before": None, "after": None},
        {"op": "d", "before": None, "after": None},
        {"schema": {}, "payload": None},
        None,
        json.dumps({"payload": {"op": "c", "after": {"id": 5}}}),
        json.dumps({"payload": {"op": "c", "after": {"id": 5}}}).encode(),
        {"op": "??"},
        {"payload": {"op": "t"}},
    ],
    "canal": [
        *CANAL_STREAM,
        {"type": "UPDATE", "data": [{"id": 1, "v": 2}], "old": [{"v": 1}]},
        {"type": "UPDATE", "data": [{"id": 1, "v": 2}, {"id": 2, "v": 3}], "old": [None]},
        {"type": "update", "data": [{"id": 1, "v": 2}], "old": []},
        {"type": "ALTER"}, {"type": "QUERY"}, {"type": "TRUNCATE"},
        {"type": "UPSERT", "data": [{"id": 1}]},
        {"data": [{"id": 1}]},
    ],
    "maxwell": [
        *MAXWELL_STREAM,
        {"type": "delete", "data": {"id": 4}},
        {"type": "bootstrap-insert", "data": {"id": 4}},
        {"type": "bootstrap-complete"}, {"type": "table-create"}, {"type": "table-alter"},
        {"type": "update", "data": {"id": 1}},
        {"type": "INSERT", "data": {"id": 1}},
    ],
    "json": [*JSON_STREAM, json.dumps({"id": 3}), {}],
}


@pytest.mark.parametrize("fmt, message", [(f, m) for f, ms in PARSE_CASES.items() for m in ms],
                         ids=lambda x: x if isinstance(x, str) and len(x) < 12 else None)
def test_parser_gives_the_same_records(fmt, message):
    got = {pkg: outcome(lambda m: records(getattr(FMT[pkg], f"parse_{fmt}")(m)), message) for pkg in PKGS}
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("alias", ["debezium-json", "debezium", "canal-json", "canal", "maxwell-json",
                                   "maxwell", "json", "avro-json"])
def test_parser_and_formatter_aliases(alias):
    for getter in ("get_cdc_parser", "get_cdc_formatter"):
        got = {pkg: outcome(lambda a: getattr(FMT[pkg], getter)(a).__name__, alias) for pkg in PKGS}
        assert got["port"] == got["jax"]


def test_parsers_unit_semantics():
    """tests/test_cdc_sources.py::test_parsers_unit_semantics on the port."""
    recs = pfmt.parse_debezium({"op": "u", "before": {"id": 1, "v": 1}, "after": {"id": 1, "v": 2}})
    assert records(recs) == [("-U", {"id": 1, "v": 1}), ("+U", {"id": 1, "v": 2})]
    recs = pfmt.parse_canal({"type": "UPDATE", "data": [{"id": 1, "v": 2}], "old": [{"v": 1}]})
    assert dict(recs[0]) == {"id": 1, "v": 1} and recs[0].kind == "-U"
    assert pfmt.parse_maxwell({"type": "delete", "data": {"id": 4}})[0].kind == "-D"
    with pytest.raises(ValueError, match="unknown debezium op"):
        pfmt.parse_debezium({"op": "??"})


# --------------------------------------------------------- the formatters
EVENT_CASES = {
    "inserts": [("+I", {"id": 1, "v": 1.5}), ("+I", {"id": 2, "v": None})],
    "update_pair": [("+I", {"id": 1, "v": 1}), ("-U", {"id": 1, "v": 1}), ("+U", {"id": 1, "v": 2})],
    "lone_plus_u": [("+U", {"id": 1, "s": "x"})],
    "delete": [("+I", {"id": 1}), ("-D", {"id": 1})],
    "mixed": [("+I", {"id": i, "s": f"s{i}"}) for i in range(3)]
    + [("-U", {"id": 0, "s": "s0"}), ("+U", {"id": 0, "s": "t0"}), ("-D", {"id": 2, "s": "s2"})],
    "u_without_plus_u": [("-U", {"id": 1}), ("-D", {"id": 1})],
    "dangling_u": [("+I", {"id": 1}), ("-U", {"id": 1})],
    "unknown_kind": [("+X", {"id": 1})],
}


def _folded(events):
    """The events a parser gives back: a lone +U comes back as +I."""
    return [("+I" if k == "+U" and (i == 0 or events[i - 1][0] != "-U") else k, dict(r))
            for i, (k, r) in enumerate(events)]


@pytest.mark.parametrize("fmt", ["debezium", "canal", "maxwell", "json"])
@pytest.mark.parametrize("case", sorted(EVENT_CASES))
def test_formatter_messages_and_round_trip(fmt, case):
    events = EVENT_CASES[case]
    got = {pkg: outcome(getattr(FMT[pkg], f"format_{fmt}"), events) for pkg in PKGS}
    assert got["port"] == got["jax"]
    if got["port"][0] == "ok":
        for pkg in PKGS:
            parsed = [r for m in got[pkg][1] for r in records(getattr(FMT[pkg], f"parse_{fmt}")(m))]
            assert parsed == _folded(events)


def test_encode_changelog_over_one_batch():
    rows = {"id": [1, 2, 2, 3], "name": ["a", "b", "b2", None]}
    kinds = np.array([0, 1, 2, 3], dtype=np.uint8)
    for fmt in ("debezium-json", "canal-json", "maxwell-json", "json"):
        got = {}
        for pkg in PKGS:
            batch = (JaxBatch if pkg == "jax" else PortBatch).from_pydict(schema(pkg), rows)
            got[pkg] = outcome(FMT[pkg].encode_changelog, batch, kinds, fmt)
        assert got["port"] == got["jax"], fmt
    assert got["port"][0] == "raises"  # plain json refuses the retractions


# ------------------------------------------------------------- the streams
STREAMS = {
    "debezium-json": [json.dumps(m) for m in DEBEZIUM_STREAM],
    "canal-json": CANAL_STREAM,
    "maxwell-json": MAXWELL_STREAM,
    "json": JSON_STREAM,
}


@pytest.mark.parametrize("fmt", sorted(STREAMS))
def test_stream_end_to_end(fmt, tmp_path):
    got = {}
    for pkg in PKGS:
        _, t = create(pkg, tmp_path / pkg, "db.s")
        stream = FMT[pkg].CdcStream(t, fmt)
        applied = stream.ingest(STREAMS[fmt])
        got[pkg] = (applied, read(stream.table), table_schema(stream.table), stream._commit_id)
    assert got["port"] == got["jax"]
    if fmt == "debezium-json":
        assert got["port"][:2] == (6, [(1, "anne", None), (3, "cy", "berlin")])
    # each package reads the other's table
    for reader, writer in (("jax", "port"), ("port", "jax")):
        t = catalog(reader, tmp_path / writer).get_table("db.s")
        assert read(t, reader) == got[writer][1]


def test_cdc_schema_evolving_ingestion(tmp_path):
    """tests/test_aux.py::test_cdc_schema_evolving_ingestion in both."""
    got = {}
    for pkg in PKGS:
        t_ = TYPES[pkg]
        cat, t = create(pkg, tmp_path / pkg, "db.cdc", row_type=t_.RowType.of(("id", t_.BIGINT()), ("v", t_.DOUBLE())))
        w = CDC[pkg].CdcTableWrite(t)
        w.write({"id": 1, "v": 1.5})
        w.write({"id": 2, "v": 2.5, "city": "berlin"})
        n1 = w.flush(1)
        t2 = cat.get_table("db.cdc")
        first = (n1, read(t2, pkg), table_schema(t2))
        w2 = CDC[pkg].CdcTableWrite(t2)
        w2.write({"id": 1, "v": 1.5}, kind="-D")
        n2 = w2.flush(2)
        got[pkg] = (first, n2, read(cat.get_table("db.cdc"), pkg))
    assert got["port"] == got["jax"]
    assert got["port"][0][:2] == (2, [(1, 1.5, None), (2, 2.5, "berlin")])
    assert [r[0] for r in got["port"][2]] == [2]


EVOLUTION_BATCHES = {
    # a BIGINT column widened to DOUBLE, a new column that widens from
    # BIGINT to DOUBLE within its first batch, a BOOLEAN one, nulls
    "widen": [[{"id": 1, "v": 1, "n": 3, "b": True}, {"id": 2, "v": 2.5, "n": 4.5, "b": None}],
              [{"id": 3, "v": 7, "n": None}]],
    # the JAX package's dedup keeps the LAST qualifying value's type: a
    # STRING value between two DOUBLE ones leaves the column DOUBLE
    "last_type_wins": [[{"id": 1, "v": 0.5}, {"id": 2, "v": "2.25"}, {"id": 3, "v": 1.5}]],
    # new columns in the order they first appear, a string after a number
    "new_columns": [[{"id": 1, "z": 1}, {"id": 2, "a": "x", "z": "y"}, {"id": 3, "m": 1.0, "a": 2}],
                    [{"id": 4, "q": False, "a": "w"}]],
    # a narrower value never narrows; a kind column of -U/+U pairs
    "no_narrowing": [[{"id": 1, "v": 1.5}], [{"id": 1, "v": 2}, {"id": 5, "v": 3}]],
}


@pytest.mark.parametrize("case", sorted(EVOLUTION_BATCHES))
def test_evolved_schema_field_for_field(case, tmp_path):
    got = {}
    for pkg in PKGS:
        t_ = TYPES[pkg]
        cat, t = create(pkg, tmp_path / pkg, "db.ev", row_type=t_.RowType.of(("id", t_.BIGINT()), ("v", t_.BIGINT())))
        w = CDC[pkg].CdcTableWrite(t)
        steps = []
        for ident, batch in enumerate(EVOLUTION_BATCHES[case], start=1):
            for r in batch:
                w.write(r)
            steps.append((outcome(w.flush, ident), table_schema(w.table)))
        got[pkg] = (steps, read(cat.get_table("db.ev"), pkg), w.table.device.type if pkg == "port" else "cpu")
    assert got["port"] == got["jax"]


def test_evolved_table_keeps_its_device(tmp_path):
    _, t = create("port", tmp_path, "db.dev")
    w = pcdc.CdcTableWrite(t)
    w.write({"id": 1, "name": "a", "extra": 1})
    w.flush(1)
    assert w.table is not t and w.table.device == t.device and w.table.store.device == t.device
    assert w.table.store.commit_user == "cdc"


# ------------------------------------------------- replay, resume, errors
def test_replay_is_filtered(tmp_path):
    got = {}
    for pkg in PKGS:
        _, t = create(pkg, tmp_path / pkg, "db.rep")
        stream = FMT[pkg].CdcStream(t, "json")
        applied = [stream.ingest([{"id": 1, "name": "a"}]), stream.ingest([{"id": 2, "name": "b"}])]
        w = CDC[pkg].CdcTableWrite(stream.table)
        w.write({"id": 2, "name": "DUPLICATE"})
        applied.append(w.flush(commit_identifier=2))
        got[pkg] = (applied, read(stream.table))
    assert got["port"] == got["jax"] == ([1, 1, 0], [(1, "a"), (2, "b")])


def test_resume_skips_tombstones(tmp_path):
    got = {}
    for pkg in PKGS:
        _, t = create(pkg, tmp_path / pkg, "db.res")
        s1 = FMT[pkg].CdcStream(t, "debezium-json")
        a1 = s1.ingest([{"payload": {"op": "c", "before": None, "after": {"id": 1, "name": "a"}}}])
        s2 = FMT[pkg].CdcStream(s1.table, "debezium-json")
        resumed = s2._commit_id
        a2 = s2.ingest([{"schema": {}, "payload": None}, None,
                        {"payload": {"op": "c", "before": None, "after": {"id": 2, "name": "b"}}}])
        got[pkg] = (a1, resumed, a2, read(s2.table))
    assert got["port"] == got["jax"] == (1, 1, 1, [(1, "a"), (2, "b")])


def test_resume_skips_the_batch_sentinel(tmp_path):
    got = {}
    for pkg in PKGS:
        _, t = create(pkg, tmp_path / pkg, "db.batchmix")
        s1 = FMT[pkg].CdcStream(t, "json")
        s1.ingest([{"id": 1, "name": "a"}])
        wb = s1.table.new_batch_write_builder()
        w = wb.new_write()
        w.write({"id": [7], "name": ["batch"]})
        wb.new_commit().commit(w.prepare_commit())
        s2 = FMT[pkg].CdcStream(s1.table, "json")
        got[pkg] = (s2._commit_id, s2.ingest([{"id": 2, "name": "b"}]), read(s2.table))
    assert got["port"] == got["jax"] == (1, 1, [(1, "a"), (2, "b"), (7, "batch")])


def _delete_then_resume(pkg, warehouse):
    from_pred = __import__(f"{'paimon_tpu' if pkg == 'jax' else 'paimon_tpu_torch'}.data.predicate",
                           fromlist=["equal"])
    # a DELETE through deletion vectors commits under (1 << 63) - 2
    _, t = create(pkg, warehouse, "db.del", options={"deletion-vectors.enabled": "true"})
    s1 = FMT[pkg].CdcStream(t, "json")
    s1.ingest([{"id": 1, "name": "a"}, {"id": 2, "name": "b"}])
    s1.table.delete_where(from_pred.equal("id", 2))
    s2 = FMT[pkg].CdcStream(s1.table, "json")
    resumed = s2._commit_id
    applied = s2.ingest([{"id": 3, "name": "c"}])
    sm = s2.table.store.snapshot_manager
    idents = [s.commit_identifier for s in sm.snapshots()]
    return resumed, applied, idents, read(s2.table, pkg)


def test_resume_after_a_delete_by_the_same_user(tmp_path):
    """ROADMAP Queue 3 item 27: the JAX package resumes from the DELETE's
    identifier, so its next ingest commits under the batch sentinel (and a
    stream that keeps going passes int64); the port resumes from the last
    streaming identifier, and its commit filter lets identifier 2 through
    (Queue 3 item 13)."""
    jax = _delete_then_resume("jax", tmp_path / "jax")
    port = _delete_then_resume("port", tmp_path / "port")
    assert jax[0] == DELETE_IDENTIFIER and jax[2] == [1, DELETE_IDENTIFIER, (1 << 63) - 1]
    assert port[0] == 1 and port[2] == [1, DELETE_IDENTIFIER, 2]
    assert jax[1] == port[1] == 1 and jax[3] == port[3] == [(1, "a"), (3, "c")]


def test_streaming_commits_after_a_sentinel_commit_are_kept(tmp_path):
    """ROADMAP Queue 3 item 13: the port's commit filter ignores the
    sentinel identifiers, so a stream writer of the DELETE's own commit user
    keeps committing; the JAX package drops its commits as replays."""
    got = {}
    for pkg in PKGS:
        pred = __import__(f"{'paimon_tpu' if pkg == 'jax' else 'paimon_tpu_torch'}.data.predicate",
                          fromlist=["equal"])
        _, t = create(pkg, tmp_path / pkg, "db.keep", options={"deletion-vectors.enabled": "true"})
        w = CDC[pkg].CdcTableWrite(t)
        w.write({"id": 1, "name": "a"})
        w.write({"id": 2, "name": "b"})
        w.flush(1)
        t.delete_where(pred.equal("id", 1))
        w.write({"id": 3, "name": "c"})
        got[pkg] = (w.flush(2), read(t, pkg))
    assert got["jax"] == (0, [(2, "b")])
    assert got["port"] == (1, [(2, "b"), (3, "c")])


def test_parse_error_leaves_no_files(tmp_path):
    got = {}
    for pkg in PKGS:
        _, t = create(pkg, tmp_path / pkg, "db.err")
        stream = FMT[pkg].CdcStream(t, "debezium-json")
        root = t.path

        def files():
            return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)

        before = files()
        bad = [{"payload": {"op": "c", "before": None, "after": {"id": 1, "name": "x"}}}, {"payload": {"op": "??"}}]
        err = outcome(stream.ingest, bad)
        after = files()
        ok = stream.ingest([{"payload": {"op": "c", "before": None, "after": {"id": 9, "name": "ok"}}}])
        got[pkg] = (err, before == after, stream._commit_id, ok, read(stream.table))
    assert got["port"] == got["jax"]
    assert got["port"][0] == ("raises", "ValueError", "unknown debezium op '??'") and got["port"][1]
    assert got["port"][4] == [(9, "ok")]


def test_each_package_continues_the_others_stream(tmp_path):
    """A stream the JAX package started, resumed by the port (and the
    reverse), evolving the schema on its side: both read the result."""
    for first, second in (("jax", "port"), ("port", "jax")):
        wh = tmp_path / f"{first}_{second}"
        _, t = create(first, wh, "db.x", user="sync")
        FMT[first].CdcStream(t, "maxwell-json").ingest(MAXWELL_STREAM)
        t2 = catalog(second, wh, "sync").get_table("db.x").copy(ENGINE[second])
        s2 = FMT[second].CdcStream(t2, "maxwell-json")
        assert s2._commit_id == 1
        s2.ingest([{"type": "insert", "data": {"id": 4, "name": "q", "score": 0.5}},
                   {"type": "update", "data": {"id": 1, "name": "m3", "score": 1}, "old": {"name": "m2"}}])
        rows = {pkg: read(catalog(pkg, wh).get_table("db.x"), pkg) for pkg in PKGS}
        assert rows["jax"] == rows["port"] == [(1, "m3", 1.0), (4, "q", 0.5)]
