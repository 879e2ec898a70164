"""Compaction parity: the LSM planner, compacted tables across packages,
streaming commits and their replay, on the CPU (device="cpu" for the port).

Planner: about 500 seeded level layouts, each built once as DataFileMeta
JSON and loaded into both packages, go through Levels, UniversalCompaction
(pick, force_full) and the compaction manager's upgrade-or-rewrite plan;
every output (levels, units, file names, drop_delete) must be equal.

Tables: BASELINE config 4 (a Flink CDC upsert stream with universal
compaction, benchmarks/baseline_configs.py config4) cut to 20 streaming
commits of 500 rows over ids 0..4999, trigger 4, written by each package.
The two packages' Parquet encoders write files of other sizes, and the
planner compares sizes, so the tables are held to the rows and to the LSM
invariants, not to their file layout.

Tolerance: exact. Rows hold integers, doubles and strings copied untouched
from the written values.
"""

import io
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import paimon_tpu as jt
import paimon_tpu_torch as tt
from paimon_tpu.catalog import FileSystemCatalog as JaxCatalog
from paimon_tpu.core import compact as jcompact
from paimon_tpu.core import datafile as jdatafile
from paimon_tpu.core import levels as jlevels
from paimon_tpu.options import CoreOptions as JaxOptions
from paimon_tpu_torch.catalog import FileSystemCatalog as PortCatalog
from paimon_tpu_torch.core import compact as pcompact
from paimon_tpu_torch.core import datafile as pdatafile
from paimon_tpu_torch.core import levels as plevels
from paimon_tpu_torch.core.commit import CommitConflictError, FileStoreCommit
from paimon_tpu_torch.core.manifest import ManifestCommittable
from paimon_tpu_torch.core.read import order_runs_for_merge
from paimon_tpu_torch.core.schema import SchemaManager
from paimon_tpu_torch.core.snapshot import CommitKind, SnapshotManager
from paimon_tpu_torch.core.store import KeyValueFileStore
from paimon_tpu_torch.fs import LocalFileIO
from paimon_tpu_torch.options import CoreOptions as PortOptions

ENGINES = ["pallas", "xla-segmented", "numpy"]
TRIGGER = 4
C4_OPTIONS = {"bucket": "1", "num-sorted-run.compaction-trigger": str(TRIGGER), "sort-engine": "pallas"}
C4_COMMITS, C4_ROWS, C4_IDS = 20, 500, 5000


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


# ---------------------------------------------------------------------------
# the planner, on identical metadata
# ---------------------------------------------------------------------------


def _meta(name, lo, hi, level, size, seq, deletes):
    """One file's DataFileMeta JSON, as the JAX package writes it."""
    return jdatafile.DataFileMeta(
        file_name=name, file_size=size, row_count=hi - lo + 1, min_key=(lo,), max_key=(hi,), key_stats={},
        value_stats={}, min_sequence_number=seq[0], max_sequence_number=seq[1], schema_id=0, level=level,
        delete_row_count=deletes,
    ).to_dict()


def _layout(rng, num_levels: int, coarse: bool) -> list[dict]:
    """Higher levels older, one key-disjoint run per level above 0, then
    level-0 files with random overlapping key ranges, newest last. coarse
    sizes (multiples of 100) meet the pickers' thresholds exactly."""
    metas, seq = [], 0

    def size(hi):
        return 100 * int(rng.integers(1, 4)) if coarse else int(rng.integers(10, hi))

    for level in range(num_levels - 1, 0, -1):
        if rng.random() < 0.45:
            continue
        n = int(rng.integers(1, 5))
        bounds = np.sort(rng.choice(1000, 2 * n, replace=False))
        for i in range(n):
            lo, hi = int(bounds[2 * i]), int(bounds[2 * i + 1])
            metas.append(_meta(f"L{level}-{i}", lo, hi, level, size(20_000), (seq, seq + 9),
                               int(rng.integers(0, 3)) * int(rng.random() < 0.3)))
            seq += 10
    for i in range(int(rng.integers(0, 9))):
        lo = int(rng.integers(0, 990))
        hi = int(rng.integers(lo, 1000))
        metas.append(_meta(f"L0-{i}", lo, hi, 0, size(5_000), (seq, seq + 9),
                           int(rng.integers(0, 3)) * int(rng.random() < 0.3)))
        seq += 10
    return metas


def _runs(runs) -> list:
    return [(lv, [f.file_name for f in run.files]) for lv, run in runs]


def _levels_view(lv) -> tuple:
    return _runs(lv.level_sorted_runs()), lv.non_empty_highest_level(), lv.number_of_sorted_runs(), lv.num_levels


def _unit_view(unit) -> tuple | None:
    return None if unit is None else (unit.output_level, [f.file_name for f in unit.files], unit.file_num_based)


def _plan_view(plan) -> tuple | None:
    if plan is None:
        return None
    unit, drop_delete, result, sections = plan
    return (_unit_view(unit), drop_delete, [(f.file_name, f.level) for f in result.before],
            [(f.file_name, f.level) for f in result.after],
            [[[f.file_name for f in run.files] for run in section] for section in sections])


def _planner(pkg_levels, pkg_compact, pkg_datafile, options_cls, metas, num_levels, strategy_args, target):
    files = [pkg_datafile.DataFileMeta.from_dict(d) for d in metas]
    levels = pkg_levels.Levels(files, num_levels)
    strategy = pkg_compact.UniversalCompaction(*strategy_args)
    manager = pkg_compact.MergeTreeCompactManager(
        levels, strategy, pkg_compact.MergeTreeCompactRewriter(None, None, None),
        options_cls({"target-file-size": str(target)}))
    return levels, strategy, manager


def _apply(levels, pkg_datafile, plan) -> None:
    """Levels.update with the plan's upgrades plus one output file per
    rewritten section, spanning the section's keys at the output level."""
    unit, _, result, sections = plan
    after = list(result.after)
    for i, section in enumerate(sections):
        files = [f for run in section for f in run.files]
        after.append(pkg_datafile.DataFileMeta.from_dict(_meta(
            f"out-{i}", min(f.min_key[0] for f in files), max(f.max_key[0] for f in files), unit.output_level,
            sum(f.file_size for f in files), (min(f.min_sequence_number for f in files),
                                               max(f.max_sequence_number for f in files)), 0)))
    before = list(result.before) + [f for section in sections for run in section for f in run.files]
    levels.update(before, after)


@pytest.mark.parametrize("seed", range(10))
def test_planner_matches_the_reference(seed):
    """50 layouts a seed: trigger 2-6, size ratio 0-50, size amplification
    50-400%, max file count 1-12, target file size 200-20,000 bytes; every
    other layout coarse (sizes, ratio and amplification on a grid where the
    pickers' comparisons meet equality)."""
    rng = np.random.default_rng(seed)
    picked = 0
    for i in range(50):
        coarse = i % 2 == 1
        trigger = int(rng.integers(2, 7))
        num_levels = trigger + 1
        amp = 50 * int(rng.integers(1, 9)) if coarse else int(rng.integers(50, 401))
        ratio = 50 * int(rng.integers(0, 2)) if coarse else int(rng.integers(0, 51))
        strategy_args = (amp, ratio, trigger, None, int(rng.integers(1, 13)))
        target = int(rng.integers(200, 20_001))
        metas = _layout(rng, num_levels, coarse)
        jax_side = _planner(jlevels, jcompact, jdatafile, JaxOptions, metas, num_levels, strategy_args, target)
        port_side = _planner(plevels, pcompact, pdatafile, PortOptions, metas, num_levels, strategy_args, target)
        (jl, js, jm), (pl, ps, pm) = jax_side, port_side
        assert _levels_view(pl) == _levels_view(jl)
        runs_j, runs_p = jl.level_sorted_runs(), pl.level_sorted_runs()
        assert _unit_view(ps.pick(num_levels, runs_p)) == _unit_view(js.pick(num_levels, runs_j))
        assert _unit_view(ps.force_full(num_levels, runs_p)) == _unit_view(js.force_full(num_levels, runs_j))
        assert _plan_view(pm._plan_unit(True)) == _plan_view(jm._plan_unit(True))
        jplan, pplan = jm._plan_unit(False), pm._plan_unit(False)
        assert _plan_view(pplan) == _plan_view(jplan)
        if pplan is not None:
            picked += 1
            _apply(jl, jdatafile, jplan)
            _apply(pl, pdatafile, pplan)
            assert _levels_view(pl) == _levels_view(jl)
    assert picked > 0


def _f(name, lo, hi, level=0, size=100, seq=0):
    return pdatafile.DataFileMeta.from_dict(_meta(name, lo, hi, level, size, (seq, seq), 0))


def _sections(files):
    return [sorted((x.min_key[0], x.max_key[0]) for r in s for x in r.files) for s in plevels.IntervalPartition(files).partition()]


def _case_disjoint_sections():
    sections = plevels.IntervalPartition([_f("a", 0, 10), _f("b", 20, 30), _f("c", 40, 50)]).partition()
    assert len(sections) == 3 and all(len(s) == 1 for s in sections)


def _case_overlap_groups():
    sections = plevels.IntervalPartition([_f("a", 0, 10), _f("b", 5, 15), _f("c", 12, 20), _f("d", 30, 40)]).partition()
    assert len(sections) == 2 and len(sections[0]) == 2
    for r in sections[0]:
        r.validate()


def _case_minimal_runs():
    runs = plevels.IntervalPartition([_f("a", 0, 10), _f("b", 11, 20), _f("c", 5, 15)]).partition()[0]
    assert sorted(len(r.files) for r in runs) == [1, 2]


def _case_levels_structure():
    files = [_f("l0a", 0, 5, 0, seq=9), _f("l0b", 0, 5, 0, seq=5), _f("l1", 0, 10, 1), _f("l2a", 0, 4, 2),
             _f("l2b", 6, 9, 2)]
    lv = plevels.Levels(files, 3)
    assert [x.file_name for x in lv.level0] == ["l0a", "l0b"]
    assert lv.number_of_sorted_runs() == 4 and lv.non_empty_highest_level() == 2
    runs = lv.level_sorted_runs()
    assert runs[0][0] == 0 and runs[-1][0] == 2
    lv.update([files[0], files[3], files[4]], [_f("new", 0, 10, 2, seq=10)])
    assert lv.number_of_sorted_runs() == 3


def _case_levels_rejects_overlapping_run():
    with pytest.raises(ValueError, match="overlapping run"):
        plevels.Levels([_f("x", 0, 10, 1), _f("y", 5, 15, 1)], 2)


def _case_size_amp_triggers_full():
    uc = pcompact.UniversalCompaction(max_size_amp_percent=100, size_ratio_percent=1, num_run_compaction_trigger=2)
    runs = [(0, plevels.SortedRun([_f("a", 0, 1, 0, size=60)])), (0, plevels.SortedRun([_f("b", 0, 1, 0, size=50)])),
            (2, plevels.SortedRun([_f("c", 0, 1, 2, size=100)]))]
    unit = uc.pick(3, runs)
    assert unit.output_level == 2 and len(unit.files) == 3


def _case_size_ratio():
    uc = pcompact.UniversalCompaction(max_size_amp_percent=10000, size_ratio_percent=1, num_run_compaction_trigger=2)
    runs = [(0, plevels.SortedRun([_f("a", 0, 1, 0, size=100)])), (0, plevels.SortedRun([_f("b", 0, 1, 0, size=100)])),
            (3, plevels.SortedRun([_f("c", 0, 1, 3, size=100000)]))]
    unit = uc.pick(4, runs)
    assert sorted(x.file_name for x in unit.files) == ["a", "b"] and unit.output_level == 2


def _case_below_trigger_no_pick():
    uc = pcompact.UniversalCompaction(num_run_compaction_trigger=5)
    assert uc.pick(5, [(0, plevels.SortedRun([_f("a", 0, 1, 0)]))]) is None


def _case_unit_absorbs_occupied_level():
    uc = pcompact.UniversalCompaction(max_size_amp_percent=10_000_000, size_ratio_percent=1, num_run_compaction_trigger=4)
    runs = [(0, plevels.SortedRun([_f(f"l0{i}", 0, 1, 0, size=100, seq=10 - i)])) for i in range(5)]
    runs.append((1, plevels.SortedRun([_f("l1", 0, 1, 1, size=600)])))
    unit = uc.pick(3, runs)
    assert sorted(x.file_name for x in unit.files) == ["l00", "l01", "l02", "l03", "l04", "l1"]
    assert unit.output_level == 2


def _case_unit_outputs_at_first_nonzero_level():
    uc = pcompact.UniversalCompaction(max_size_amp_percent=10_000_000, size_ratio_percent=1, num_run_compaction_trigger=3)
    runs = [(0, plevels.SortedRun([_f("a", 0, 1, 0, size=100, seq=3)])),
            (0, plevels.SortedRun([_f("b", 0, 1, 0, size=100, seq=2)])),
            (0, plevels.SortedRun([_f("big", 0, 1, 0, size=10_000, seq=1)])),
            (1, plevels.SortedRun([_f("c", 0, 1, 1, size=20_000)])),
            (3, plevels.SortedRun([_f("deep", 0, 1, 3, size=10_000_000)]))]
    unit = uc.pick(4, runs)
    assert sorted(x.file_name for x in unit.files) == ["a", "b", "big", "c"] and unit.output_level == 1


LEVELS_CASES = {
    "interval_partition_disjoint_sections": _case_disjoint_sections,
    "interval_partition_overlap_groups": _case_overlap_groups,
    "interval_partition_minimal_runs": _case_minimal_runs,
    "levels_structure": _case_levels_structure,
    "levels_rejects_overlapping_run": _case_levels_rejects_overlapping_run,
    "universal_size_amp_triggers_full": _case_size_amp_triggers_full,
    "universal_size_ratio": _case_size_ratio,
    "universal_below_trigger_no_pick": _case_below_trigger_no_pick,
    "universal_unit_absorbs_occupied_level": _case_unit_absorbs_occupied_level,
    "universal_unit_outputs_at_first_nonzero_level": _case_unit_outputs_at_first_nonzero_level,
}


@pytest.mark.parametrize("case", list(LEVELS_CASES))
def test_reference_levels_cases(case):
    """The JAX package's tests/test_levels.py cases, on the port (the port
    raises ValueError where the reference asserts)."""
    LEVELS_CASES[case]()


# ---------------------------------------------------------------------------
# config 4 cut to size, written by each package
# ---------------------------------------------------------------------------


def _c4_schema(pkg):
    return pkg.RowType.of(("id", pkg.BIGINT(False)), ("v", pkg.DOUBLE()), ("tag", pkg.STRING()))


def _c4_batches() -> list[dict]:
    """baseline_configs.config4's stream: one generator, ids drawn with
    repeats, so each flush dedups too."""
    rng = np.random.default_rng(2)
    out = []
    for b in range(C4_COMMITS):
        ids = rng.integers(0, C4_IDS, C4_ROWS)
        out.append({"id": ids, "v": ids * 0.5 + b, "tag": np.array([f"t{b}"] * C4_ROWS, dtype=object)})
    return out


def _oracle(batches) -> list[tuple]:
    last = {}
    for batch in batches:
        for i, v, t in zip(batch["id"].tolist(), batch["v"].tolist(), batch["tag"]):
            last[i] = (i, v, t)
    return [last[i] for i in sorted(last)]


def _py(v):
    return v.item() if hasattr(v, "item") else v


def _read(table, engine=None) -> list[tuple]:
    if engine is not None:
        table = table.copy({"sort-engine": engine})
    rb = table.new_read_builder()
    return [tuple(_py(v) for v in row) for row in rb.new_read().read_all(rb.new_scan().plan()).to_pylist()]


def _port_levels(warehouse, ident):
    store = PortCatalog(warehouse, device="cpu").get_table(ident).store
    return plevels.Levels(store.restore_files((), 0), store.options.num_levels)  # validates every run


def _kinds(warehouse, ident, sids) -> list[str]:
    sm = SnapshotManager(LocalFileIO(), PortCatalog(warehouse, device="cpu").table_path(ident))
    return [sm.snapshot(s).commit_kind.value for s in sids]


def _stream(table, batches, first_identifier: int, after_commit=None) -> None:
    wb = table.new_stream_write_builder()
    w, c = wb.new_write(), wb.new_commit()
    for i, batch in enumerate(batches):
        w.write(batch)
        msgs = w.prepare_commit()
        sids = c.commit_messages(first_identifier + i, msgs)
        if after_commit is not None:
            after_commit(msgs, sids)


@pytest.fixture(scope="module")
def warehouse(tmp_path_factory):
    return str(tmp_path_factory.mktemp("torch_compact_warehouse"))


@pytest.fixture(scope="module")
def c4_tables(warehouse):
    """db.c4_jax (the JAX package) and db.c4_port (the port), and after
    every commit of the port: compacted?, snapshot kinds, level layout."""
    batches = _c4_batches()
    jax_table = JaxCatalog(warehouse, commit_user="jax").create_table(
        "db.c4_jax", _c4_schema(jt), primary_keys=["id"], options=dict(C4_OPTIONS))
    _stream(jax_table, batches, 1)
    port_table = PortCatalog(warehouse, commit_user="port", device="cpu").create_table(
        "db.c4_port", _c4_schema(tt), primary_keys=["id"], options=dict(C4_OPTIONS))
    record = []

    def after_commit(msgs, sids):
        lv = _port_levels(warehouse, "db.c4_port")
        compacted = any(m.compact_before or m.compact_after for m in msgs)
        record.append((compacted, _kinds(warehouse, "db.c4_port", sids), lv.number_of_sorted_runs(),
                       sorted(lv.runs)))

    _stream(port_table, batches, 1, after_commit)
    return {"jax": "db.c4_jax", "port": "db.c4_port", "oracle": _oracle(batches), "record": record}


def test_reference_compacted_table_reads_the_oracle(warehouse, c4_tables):
    """The JAX package's own table, read by its numpy engine and its pallas
    engine (under this suite's forced device encodings), before it serves
    as the port's parity input."""
    table = JaxCatalog(warehouse).get_table(c4_tables["jax"])
    assert _read(table, "numpy") == c4_tables["oracle"]
    assert _read(table, "pallas") == c4_tables["oracle"]
    assert any(f.level > 0 for f in table.store.restore_files((), 0))


@pytest.mark.parametrize("engine", ENGINES)
def test_port_reads_reference_compacted_table(warehouse, c4_tables, engine):
    assert _read(PortCatalog(warehouse, device="cpu").get_table(c4_tables["jax"]), engine) == c4_tables["oracle"]


@pytest.mark.parametrize("engine", ENGINES)
def test_reference_reads_port_compacted_table(warehouse, c4_tables, engine):
    assert _read(JaxCatalog(warehouse).get_table(c4_tables["port"]), engine) == c4_tables["oracle"]
    assert _read(PortCatalog(warehouse, device="cpu").get_table(c4_tables["port"]), engine) == c4_tables["oracle"]


def test_port_levels_after_every_commit(c4_tables):
    """Every level above 0 one sorted run (Levels validates), at most
    `trigger` runs, APPEND then COMPACT exactly where the writer compacted."""
    record = c4_tables["record"]
    assert len(record) == C4_COMMITS
    for compacted, kinds, runs, _ in record:
        assert kinds == (["APPEND", "COMPACT"] if compacted else ["APPEND"])
        assert runs <= TRIGGER
    assert sum(compacted for compacted, *_ in record) >= 4
    assert record[-1][3] and max(record[-1][3]) == TRIGGER  # the highest level holds the oldest run


@pytest.mark.parametrize("first, second", [("jax", "port"), ("port", "jax")])
def test_each_package_continues_the_others_compacted_table(warehouse, first, second):
    """`first` streams commits 1-10, then `second` restores the levels from
    the manifests and streams commits 11-20 onto it; both packages read the
    oracle, and the levels stay valid after every commit."""
    ident = f"db.c4_{first}_then_{second}"
    catalogs = {"jax": JaxCatalog(warehouse, commit_user="jax"),
                "port": PortCatalog(warehouse, commit_user="port", device="cpu")}
    pkgs = {"jax": jt, "port": tt}
    batches = _c4_batches()
    table = catalogs[first].create_table(ident, _c4_schema(pkgs[first]), primary_keys=["id"],
                                         options={**C4_OPTIONS, "sort-engine": "xla-segmented"})
    _stream(table, batches[:10], 1)
    runs = []
    _stream(catalogs[second].get_table(ident), batches[10:], 11,
            lambda msgs, sids: runs.append(_port_levels(warehouse, ident).number_of_sorted_runs()))
    assert max(runs) <= TRIGGER
    want = _oracle(batches)
    for engine in ("pallas", "numpy"):
        assert _read(PortCatalog(warehouse, device="cpu").get_table(ident), engine) == want
        assert _read(JaxCatalog(warehouse).get_table(ident), engine) == want


# ---------------------------------------------------------------------------
# the JAX package's tests/test_store.py compaction cases, on the port's store
# ---------------------------------------------------------------------------


def _store(path, options=None, user="u1"):
    io_ = LocalFileIO()
    schema = tt.RowType.of(("k", tt.BIGINT()), ("v", tt.DOUBLE()), ("name", tt.STRING()))
    ts = SchemaManager(io_, path).create_table(schema, primary_keys=["k"],
                                               options={"bucket": "1", "file.format": "parquet", **(options or {})})
    return KeyValueFileStore(io_, path, ts, commit_user=user, device="cpu")


def _batch(store, data):
    return tt.ColumnBatch.from_pydict(store.value_schema, data)


def _write_and_commit(store, data, identifier, kinds=None):
    w = store.new_writer((), 0)
    w.write(_batch(store, data), kinds)
    return store.new_commit().commit(ManifestCommittable(identifier, messages=[w.prepare_commit()]))


def _store_rows(store):
    return store.read_bucket((), 0, store.restore_files((), 0)).to_pylist()


def test_compaction_reduces_runs_and_preserves_data(tmp_path):
    store = _store(str(tmp_path / "t5"), {"num-sorted-run.compaction-trigger": "3", "target-file-size": "1 kb"})
    oracle = {}
    w = store.new_writer((), 0)
    for c in range(6):
        ks = list(range(c * 10, c * 10 + 30))
        vs = [float(k * c) for k in ks]
        oracle.update(zip(ks, vs))
        w.write(_batch(store, {"k": ks, "v": vs, "name": [None] * len(ks)}))
        w.flush()
    store.new_commit().commit(ManifestCommittable(1, messages=[w.prepare_commit()]))
    sm = SnapshotManager(store.file_io, store.table_path)
    assert [sm.snapshot(i).commit_kind for i in (1, 2)] == [CommitKind.APPEND, CommitKind.COMPACT]
    assert {r[0]: r[1] for r in _store_rows(store)} == oracle
    assert plevels.Levels(store.restore_files((), 0), store.options.num_levels).number_of_sorted_runs() <= 3


def test_full_compact_drops_deletes(tmp_path):
    store = _store(str(tmp_path / "t6"))
    _write_and_commit(store, {"k": [1, 2], "v": [1.0, 2.0], "name": ["a", "b"]}, 1)
    _write_and_commit(store, {"k": [1], "v": [None], "name": [None]}, 2, np.array([int(tt.RowKind.DELETE)], np.uint8))
    w = store.new_writer((), 0)
    w.compact(full=True)
    store.new_commit().commit(ManifestCommittable(3, messages=[w.prepare_commit()]))
    files = store.restore_files((), 0)
    assert all(f.level == store.options.num_levels - 1 for f in files)
    assert sum(f.delete_row_count for f in files) == 0
    assert [r[0] for r in _store_rows(store)] == [2]


def test_compact_conflict_detected(tmp_path):
    store = _store(str(tmp_path / "t9"))
    _write_and_commit(store, {"k": [1, 2], "v": [1.0, 2.0], "name": ["a", "b"]}, 1)
    wa = store.new_writer((), 0)
    wa.compact(full=True)
    ma = wa.prepare_commit()
    wb = store.new_writer((), 0)
    wb.compact(full=True)
    mb = wb.prepare_commit()
    store.new_commit().commit(ManifestCommittable(2, messages=[ma]))
    with pytest.raises(CommitConflictError):
        store.new_commit().commit(ManifestCommittable(3, messages=[mb]))
    assert [r[0] for r in _store_rows(store)] == [1, 2]


# ---------------------------------------------------------------------------
# forced compaction, replayed commits, sections across levels, guards
# ---------------------------------------------------------------------------


def _rows(ids, v):
    ids = np.asarray(ids, dtype=np.int64)
    return {"id": ids, "v": ids * 0.5 + v, "tag": np.array([f"t{v}"] * len(ids), dtype=object)}


def _wide_rows(ids, v):
    rng = np.random.default_rng(v)
    return {**_rows(ids, v), "tag": np.array([rng.bytes(60).hex() for _ in ids], dtype=object)}


@pytest.mark.parametrize("mode", ["batch", "stream"])
def test_force_compact_commits_a_full_compaction(warehouse, mode):
    """commit.force-compact: every commit is APPEND + COMPACT and leaves only
    files at the highest level; a streaming commit replayed under its
    identifier, forced compaction and all, is filtered."""
    ident = f"db.force_compact_{mode}"
    cat = PortCatalog(warehouse, commit_user=f"force_{mode}", device="cpu")
    table = cat.create_table(ident, _c4_schema(tt), primary_keys=["id"],
                             options={"bucket": "1", "commit.force-compact": "true"})
    batches = [_rows(np.arange(0, 100), 0), _rows(np.arange(50, 150), 1), _rows(np.arange(140, 160), 2)]
    stream = table.new_stream_write_builder()
    w, c = stream.new_write(), stream.new_commit()
    for i, batch in enumerate(batches):
        if mode == "batch":
            wb = table.new_batch_write_builder()
            w = wb.new_write()
            w.write(batch)
            sids = wb.new_commit().commit(w.prepare_commit())
        else:
            w.write(batch)
            msgs = w.prepare_commit()
            sids = c.commit_messages(i + 1, msgs)
            assert c.commit_messages(i + 1, msgs) == []
        assert _kinds(warehouse, ident, sids) == ["APPEND", "COMPACT"]
        assert {f.level for f in table.store.restore_files((), 0)} == {table.store.options.num_levels - 1}
    assert SnapshotManager(LocalFileIO(), table.path).latest_snapshot_id() == 2 * len(batches)
    assert _read(table) == _oracle(batches) == _read(JaxCatalog(warehouse).get_table(ident))


def test_replayed_streaming_identifiers_are_filtered(warehouse):
    """A streaming identifier committed once is filtered on replay, by
    commit_messages and by filter_and_commit."""
    table = PortCatalog(warehouse, commit_user="replay", device="cpu").create_table(
        "db.replay", _c4_schema(tt), primary_keys=["id"], options=dict(C4_OPTIONS))
    wb = table.new_stream_write_builder()
    w, c = wb.new_write(), wb.new_commit()
    w.write(_rows([1, 2], 1))
    msgs = w.prepare_commit()
    assert c.commit_messages(1, msgs) == [1]
    assert c.commit_messages(1, msgs) == []
    w.write(_rows([3], 2))
    later = ManifestCommittable(2, messages=w.prepare_commit())
    assert c.filter_and_commit([ManifestCommittable(1, messages=msgs), later]) == 1
    assert c.filter_and_commit([ManifestCommittable(1, messages=msgs), later]) == 0
    assert SnapshotManager(LocalFileIO(), table.path).latest_snapshot_id() == 2
    assert _read(table) == _oracle([_rows([1, 2], 1), _rows([3], 2)])


def test_replay_commits_only_the_missing_compact_half(warehouse, monkeypatch):
    """The COMPACT half of commit 5 fails after its APPEND landed; the
    rebuilt committable, replayed under the same identifier, is flagged
    skip_append and commits only the COMPACT half."""
    table = PortCatalog(warehouse, commit_user="crash", device="cpu").create_table(
        "db.compact_half", _c4_schema(tt), primary_keys=["id"], options=dict(C4_OPTIONS))
    batches = _c4_batches()[:5]
    _stream(table, batches[:4], 1)
    wb = table.new_stream_write_builder()
    w = wb.new_write()
    w.write(batches[4])
    msgs = w.prepare_commit()
    assert msgs[0].compact_before  # the fifth run crosses the trigger
    real = FileStoreCommit._try_commit

    def crash_on_compact(self, kind, entries, committable, check_conflicts=False):
        if kind == CommitKind.COMPACT:
            raise OSError("lost the COMPACT half")
        return real(self, kind, entries, committable, check_conflicts)

    monkeypatch.setattr(FileStoreCommit, "_try_commit", crash_on_compact)
    with pytest.raises(OSError):
        wb.new_commit().commit_messages(5, msgs)
    monkeypatch.undo()
    commit = wb.new_commit()
    (pending,) = commit._commit.filter_committed([ManifestCommittable(5, messages=msgs)])
    assert pending.skip_append
    assert _kinds(warehouse, "db.compact_half", commit.commit_messages(5, msgs)) == ["COMPACT"]
    assert commit.commit_messages(5, msgs) == []
    sm = SnapshotManager(LocalFileIO(), table.path)
    assert [sm.snapshot(i).commit_kind.value for i in range(5, 7)] == ["APPEND", "COMPACT"]
    assert sm.latest_snapshot().total_record_count == sum(f.row_count for f in table.store.restore_files((), 0))
    assert _read(table) == _oracle(batches) == _read(JaxCatalog(warehouse).get_table("db.compact_half"), "numpy")


@pytest.mark.parametrize("mixed_run", [False, True], ids=["runs-in-sequence", "run-mixing-levels"])
def test_section_with_an_upgraded_file_reads_the_newest_row(warehouse, mixed_run):
    """A file upgraded to the highest level (not rewritten) and newer
    level-0 files in one section. Without mixed_run the section's runs
    ascend in sequence (the stability route); with it one run holds the
    upgraded file and a level-0 file newer than another run (the
    sequence-lane route)."""
    ident = f"db.upgraded_{int(mixed_run)}"
    # 4 kb rolls files at 128 rows (32 estimated bytes a row), while the
    # incompressible tags make a 100-row file larger than 4 kb: upgradable
    table = PortCatalog(warehouse, device="cpu").create_table(
        ident, _c4_schema(tt), primary_keys=["id"],
        options={"bucket": "1", "target-file-size": "4 kb", "num-sorted-run.compaction-trigger": "10"})
    first = _wide_rows(np.arange(0, 100), 0)
    later = ([_wide_rows(np.arange(90, 206), 1), _wide_rows(np.arange(200, 211), 2)] if mixed_run
             else [_wide_rows(np.arange(50, 150), 1), _wide_rows(np.arange(75, 81), 2)])
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.write(first)
    wb.new_commit().commit(w.prepare_commit())
    (appended,) = table.store.restore_files((), 0)
    w = wb.new_write()
    w.compact(full=True)
    assert wb.new_commit().commit(w.prepare_commit()) == [2]
    (upgraded,) = table.store.restore_files((), 0)
    assert upgraded.file_name == appended.file_name and upgraded.level == table.store.options.num_levels - 1
    for batch in later:
        w = wb.new_write()
        w.write(batch)
        wb.new_commit().commit(w.prepare_commit())
    (section,) = plevels.IntervalPartition(table.store.restore_files((), 0)).partition()
    runs, seq_ascending = order_runs_for_merge(section)
    assert seq_ascending is not mixed_run
    assert any(len({f.level for f in run.files}) == 2 for run in runs) is mixed_run
    want = _oracle([first, *later])
    for engine in ENGINES:
        assert _read(table, engine) == want
    assert _read(JaxCatalog(warehouse).get_table(ident), "numpy") == want


GUARDS = [
    ("changelog-producer", "input", {}, "stream"),
    ("changelog-producer", "lookup", {}, "stream"),
    ("changelog-producer", "full-compaction", {}, "stream"),
    ("record-level.expire-time", "1 d", {"record-level.time-field": "v"}, "stream"),
    ("record-level.expire-time.ms", "86400000", {"record-level.time-field": "v"}, "stream"),
    ("snapshot.num-retained.max", "5", {}, "stream"),
    ("snapshot.time-retained", "10 min", {}, "stream"),
    ("snapshot.num-retained.max", "5", {"write-only": "true"}, "stream"),
    ("sequence.field", "v", {}, "stream"),
    # batch writes of write-only tables: the JAX package writes the input
    # changelog and expires snapshots after each commit there too
    ("changelog-producer", "input", {"write-only": "true"}, "batch"),
    ("snapshot.num-retained.max", "5", {"write-only": "true"}, "batch"),
    ("snapshot.time-retained", "1 ms", {"write-only": "true", "snapshot.num-retained.min": "2"}, "batch"),
]


def _guard_id(key, value, extra, mode):
    return f"{key}={value}{'-write-only' if extra.get('write-only') else ''}{'-batch' if mode == 'batch' else ''}"


def _jax_batch_commits(warehouse, ident, options, commits=7):
    """The JAX package's table under `options` after `commits` batch commits:
    (changelog files in its bucket, snapshot files left)."""
    table = JaxCatalog(warehouse).create_table(ident, _c4_schema(jt), primary_keys=["id"], options=options)
    for c in range(commits):
        wb = table.new_batch_write_builder()
        w = wb.new_write()
        w.write(_rows(np.arange(10) + c, c))
        wb.new_commit().commit(w.prepare_commit())
    bucket = os.listdir(os.path.join(table.path, "bucket-0"))
    snapshots = [n for n in os.listdir(os.path.join(table.path, "snapshot")) if n.startswith("snapshot-")]
    return sum(n.startswith("changelog") for n in bucket), len(snapshots)


@pytest.mark.parametrize("key, value, extra, mode", GUARDS, ids=[_guard_id(*g) for g in GUARDS])
def test_unported_write_options_raise_naming_the_option(warehouse, key, value, extra, mode):
    """What the port's write path would get wrong raises at the write's
    creation (sequence.field at its first write), naming the option:
    changelog files, record TTL and snapshot expiry on tables that are not
    write-only, snapshot expiry on any streaming table; and on batch writes
    of write-only tables the input changelog and snapshot expiry, which the
    JAX package is first shown to produce on the same table."""
    ident = f"db.guard_{key.replace('.', '_').replace('-', '_')}_{value.replace(' ', '_')}_{len(extra)}_{mode}"
    options = {**C4_OPTIONS, key: value, **extra}
    if mode == "batch":
        changelogs, snapshots = _jax_batch_commits(warehouse, ident + "_jax", options)
        if key == "changelog-producer":
            assert changelogs == 7 and snapshots == 7
        else:
            assert changelogs == 0 and snapshots < 7
    table = PortCatalog(warehouse, device="cpu").create_table(
        ident, _c4_schema(tt), primary_keys=["id"], options=options)
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        builder = table.new_batch_write_builder() if mode == "batch" else table.new_stream_write_builder()
        builder.new_write().write(_rows([1], 0))
