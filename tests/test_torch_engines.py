"""The partial-update, aggregation and first-row merge engines of the port
(paimon_tpu_torch) against the JAX package's, on the CPU (device="cpu").

Module parity: segment_last_where, first_row_take, partial_update_takes,
fused_partial_update, aggregate_merge (every ported function) and
fused_aggregate get the same seeded numpy inputs in both packages, at both
pallas tiers (K1, and the stock sort + K2 sweep reached by lowering the
admission cap in both packages) and on the plain (xla) engine; the JAX
package's Pallas kernels run in interpret mode, the port's wrappers take the
plain versions. Its fused partial-update runs with its compact link
encoding (PAIMON_TPU_FORCE_COMPACT=1, as tests/conftest.py sets) and with
the index download (=0). MergeExecutor parity adds the numpy engine. Inputs
hold nulls, -U/-D rows with and without remove-record-on-delete and
ignore-retract, NaN, -0.0 and +0.0, the int64 extremes, an empty input, one
row and an all-constant key.

Table parity: for each engine, the JAX package writes and the port reads;
the port writes and the JAX package reads; the port streams commits with
compaction (write-only=false, trigger 4) and then compacts fully. Every read
equals the other package's read and a numpy oracle built here.

Tolerance: exact. Indices, masks and integers must be equal; floats bit for
bit (so -0.0 differs from +0.0). The one allowance: a NaN equals any NaN,
since the two packages may produce other NaN payloads for the same sum.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import paimon_tpu as jt
import paimon_tpu.ops.pallas_kernels as pk
import paimon_tpu_torch as tt
import paimon_tpu_torch.ops.hopper_kernels as hk
from paimon_tpu.catalog import FileSystemCatalog as JaxCatalog
from paimon_tpu.core.kv import KVBatch as JaxKV
from paimon_tpu.core.mergefn import MergeExecutor as JaxMerge
from paimon_tpu.data.batch import Column as JaxColumn
from paimon_tpu.data.batch import ColumnBatch as JaxBatch
from paimon_tpu.ops import aggregates as JA
from paimon_tpu.ops import merge as JM
from paimon_tpu.options import CoreOptions as JaxOptions
from paimon_tpu_torch.catalog import FileSystemCatalog as PortCatalog
from paimon_tpu_torch.core.kv import KVBatch as PortKV
from paimon_tpu_torch.core.mergefn import MergeExecutor as PortMerge
from paimon_tpu_torch.core.snapshot import SnapshotManager
from paimon_tpu_torch.data.batch import Column as PortColumn
from paimon_tpu_torch.data.batch import ColumnBatch as PortBatch
from paimon_tpu_torch.ops import aggregates as TA
from paimon_tpu_torch.ops import merge as TM
from paimon_tpu_torch.options import CoreOptions as PortOptions

INSERT, UPDATE_BEFORE, UPDATE_AFTER, DELETE = 0, 1, 2, 3
ENGINES = ["pallas", "xla-segmented", "numpy"]


@pytest.fixture(scope="module", autouse=True)
def _warm_pyarrow():
    """The JAX writer encodes on a flush thread; pyarrow's lazy first-use
    initialisation must happen on the main thread first."""
    pq.write_table(pa.table({"x": [0]}), io.BytesIO())


@pytest.fixture
def sweep_tier(monkeypatch):
    """Lower the fused-kernel row cap in both packages so test-size batches
    take the stock sort + boundary-sweep tier."""
    monkeypatch.setattr(pk, "_FUSE_MAX_ROWS", 1)
    monkeypatch.setattr(hk, "_FUSE_MAX_ROWS", 1)


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts calls of each plain kernel version (the CPU stand-in for a
    launch), so a test can show which tier served it."""
    calls = dict.fromkeys(hk.KERNEL_SOURCES, 0)
    for name in calls:
        real = getattr(hk, f"{name}_plain")

        def counted(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)

        monkeypatch.setattr(hk, f"{name}_plain", counted)
    return calls


# the plain engine, and the pallas engine at each tier (the tier changes
# nothing on the plain engine)
ENGINE_TIERS = [("xla", "fused"), ("pallas", "fused"), ("pallas", "sweep")]
ENGINE_TIER_IDS = ["xla", "pallas-fused", "pallas-sweep"]
# every case on the plain engine; at the pallas tiers the cases whose lane
# counts differ (the JAX package compiles its interpreted kernel for each)
ENGINE_TIER_CASES = [("xla", "fused", c) for c in ("random", "empty", "one_row", "constant_key")] + [
    (e, t, c) for e, t in ENGINE_TIERS[1:] for c in ("random", "constant_key")]
ENGINE_TIER_CASE_IDS = [f"{'pallas-' + t if e == 'pallas' else e}-{c}" for e, t, c in ENGINE_TIER_CASES]


def _tier(request, tier):
    if tier == "sweep":
        request.getfixturevalue("sweep_tier")


def same(a: np.ndarray, b: np.ndarray) -> bool:
    """Equal; floats bit for bit, any NaN equal to any NaN."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return False
    if a.dtype.kind != "f":
        return bool((a == b).all()) if a.dtype != object else a.tolist() == b.tolist()
    if a.dtype != b.dtype:
        return False
    i = f"i{a.itemsize}"
    return bool(((a.view(i) == b.view(i)) | (np.isnan(a) & np.isnan(b))).all())


def same_column(port, jax_col) -> bool:
    return same(port.valid_mask(), jax_col.valid_mask()) and same(port.values, np.asarray(jax_col.values))


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

CASES = ["random", "empty", "one_row", "constant_key"]


def _keys(rng, case: str, n: int) -> np.ndarray:
    """(n, 2) uint32 key lanes."""
    if case == "constant_key":
        return np.full((n, 2), 7, np.uint32)
    return np.stack([rng.integers(0, 3, n), rng.integers(0, max(2, n // 3), n)], axis=1).astype(np.uint32)


def _n(rng, case: str) -> int:
    return {"empty": 0, "one_row": 1}.get(case, int(rng.integers(300, 500)))  # one padded size: m = 512


def _kinds(rng, n: int, retract: bool) -> np.ndarray:
    p = [0.6, 0.1, 0.15, 0.15] if retract else [0.8, 0.0, 0.2, 0.0]
    return rng.choice(4, n, p=p).astype(np.uint8)


def _seq(rng, n: int, with_seq: bool):
    return rng.permutation(n).astype(np.uint32).reshape(-1, 1) if with_seq else None


def _values(rng, dtype, n: int) -> np.ndarray:
    """Values with the edge cases of their type mixed in."""
    if dtype == np.float64 or dtype == np.float32:
        v = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n)).astype(dtype)
        special = rng.integers(0, 10, n)
        v[special == 0] = -0.0
        v[special == 1] = 0.0
        v[special == 2] = np.nan
        v[special == 3] = np.inf
        return v
    if dtype == np.bool_:
        return rng.random(n) < 0.5
    if dtype == object:
        return np.array([f"s{int(x)}" for x in rng.integers(0, 50, n)], dtype=object)
    info = np.iinfo(dtype)
    v = rng.integers(-1000, 1000, n).astype(dtype)
    special = rng.integers(0, 10, n)
    v[special == 0] = info.min
    v[special == 1] = info.max
    return v


def _both_plans(lanes, seq, engine):
    return (JM.merge_plan(lanes, seq, engine=engine),
            TM.merge_plan(lanes, seq, engine=engine, device="cpu"))


# ---------------------------------------------------------------------------
# module parity: ops/merge.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_segment_last_where_matches_jax(seed):
    rng = np.random.default_rng(seed)
    m = 256
    seg_id = np.sort(rng.integers(0, 40, m)).astype(np.int32)
    seg_id -= seg_id[0]
    masks = rng.random((3, m)) < 0.3
    want = np.asarray(jax.jit(JM.segment_last_where)(jnp.asarray(seg_id), jnp.asarray(masks)))
    got = TM.segment_last_where(torch.from_numpy(seg_id), torch.from_numpy(masks))
    assert same(got.numpy(), want)


@pytest.mark.parametrize("case", CASES)
def test_first_row_take_matches_jax(case):
    rng = np.random.default_rng(11)
    n = _n(rng, case)
    jplan, tplan = _both_plans(_keys(rng, case, n), _seq(rng, n, True), "xla")
    assert tplan.num_segments == jplan.num_segments
    assert same(TM.first_row_take(tplan), JM.first_row_take(jplan))


@pytest.mark.parametrize("remove_on_delete", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_partial_update_takes_matches_jax(case, remove_on_delete):
    """Over a plan (the plans themselves, at every engine and tier, are held
    to the JAX package's in tests/test_torch_merge.py)."""
    rng = np.random.default_rng(20 + CASES.index(case))
    n = _n(rng, case)
    lanes, seq = _keys(rng, case, n), _seq(rng, n, True)
    fv = rng.random((3, n)) < 0.7
    kind = _kinds(rng, n, remove_on_delete)
    jplan, tplan = _both_plans(lanes, seq, "xla")
    want = JM.partial_update_takes(jplan, fv, kind, remove_on_delete)
    got = TM.partial_update_takes(tplan, fv, kind, remove_on_delete, device="cpu")
    assert same(got[0], want[0]) and same(got[1], want[1])


def _fused_partial_update_case(engine, case, remove_on_delete):
    rng = np.random.default_rng(40 + CASES.index(case))
    n = _n(rng, case)
    lanes, seq = _keys(rng, case, n), _seq(rng, n, case != "random")
    fv = rng.random((4, n)) < 0.6
    kind = _kinds(rng, n, remove_on_delete)
    want = JM.fused_partial_update(lanes, seq, fv, kind, remove_on_delete, compress=True, engine=engine)
    got = TM.fused_partial_update(lanes, seq, fv, kind, remove_on_delete, compress=True, engine=engine, device="cpu")
    for g, w in zip(got, want):
        assert same(g, w)


@pytest.mark.parametrize("remove_on_delete", [False, True])
@pytest.mark.parametrize("engine, tier, case", ENGINE_TIER_CASES, ids=ENGINE_TIER_CASE_IDS)
def test_fused_partial_update_matches_jax(request, monkeypatch, kernel_calls, engine, tier, case, remove_on_delete):
    """Against the JAX package's index download (what the port does)."""
    _tier(request, tier)
    monkeypatch.setenv("PAIMON_TPU_FORCE_COMPACT", "0")
    _fused_partial_update_case(engine, case, remove_on_delete)
    if engine == "pallas" and case != "empty":
        assert kernel_calls["sort_segments" if tier == "fused" else "keep_last_mask"] == 1


@pytest.mark.parametrize("remove_on_delete", [False, True])
@pytest.mark.parametrize("engine, tier", ENGINE_TIERS[:2], ids=ENGINE_TIER_IDS[:2])
def test_fused_partial_update_matches_the_jax_compact_link(request, monkeypatch, engine, tier, remove_on_delete):
    """The JAX package's compact link encoding (PAIMON_TPU_FORCE_COMPACT=1,
    as tests/conftest.py sets) gives the same result."""
    _tier(request, tier)
    monkeypatch.setenv("PAIMON_TPU_FORCE_COMPACT", "1")
    _fused_partial_update_case(engine, "random", remove_on_delete)


# ---------------------------------------------------------------------------
# module parity: ops/aggregates.py
# ---------------------------------------------------------------------------

AGG_CASES = [
    # (function, dtype, retract rows, ignore-retract)
    ("sum", np.int64, True, False),
    ("sum", np.int32, False, False),
    ("sum", np.float64, True, False),
    ("sum", np.float32, True, True),
    ("count", np.int64, True, False),
    ("count", np.float64, True, True),
    ("sum", object, False, False),  # raises: not for strings
    ("max", np.int64, True, False),  # raises: max cannot retract
    ("max", np.int64, False, False),
    ("max", np.float64, True, True),
    ("min", np.float64, False, False),
    ("min", np.int16, True, True),
    ("max", np.float32, False, False),
    ("bool_and", np.bool_, True, True),
    ("bool_or", np.bool_, False, False),
    ("first_value", np.float64, True, True),
    ("first_non_null_value", object, False, False),
    ("last_value", object, True, True),
    ("last_non_null_value", np.int64, True, True),
    ("primary-key", np.float64, True, False),
    ("product", np.int64, False, False),
    ("product", np.float64, True, True),
    ("listagg", object, True, True),
    ("listagg", object, False, False),
]


def _agg_input(case: str, dtype, retract: bool, seed: int):
    rng = np.random.default_rng(seed)
    n = _n(rng, case)
    values = _values(rng, dtype, n)
    valid = rng.random(n) < 0.8
    return rng, n, values, valid, _kinds(rng, n, retract), _keys(rng, case, n), _seq(rng, n, True)


def _columns(values, valid):
    return PortColumn(values, valid.copy()), JaxColumn(values, valid.copy())


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("fn, dtype, retract, ignore_retract", AGG_CASES,
                         ids=[f"{c[0]}-{np.dtype(c[1]).name}{'-retract' if c[2] else ''}{'-ignore' if c[3] else ''}"
                              for c in AGG_CASES])
def test_aggregate_merge_matches_jax(fn, dtype, retract, ignore_retract, case):
    seed = AGG_CASES.index((fn, dtype, retract, ignore_retract))
    _, n, values, valid, kind, lanes, seq = _agg_input(case, dtype, retract, seed)
    jplan, tplan = _both_plans(lanes, seq, "xla")
    spec_j = JA.AggregateSpec(fn, ignore_retract, "|")
    spec_t = TA.AggregateSpec(fn, ignore_retract, "|")
    tcol, jcol = _columns(values, valid)
    try:
        want = JA.aggregate_merge(jplan, jcol, spec_j, kind)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            TA.aggregate_merge(tplan, tcol, spec_t, kind, device="cpu")
        assert str(got.value) == str(e)
        return
    got = TA.aggregate_merge(tplan, tcol, spec_t, kind, device="cpu")
    assert same_column(got, want)


@pytest.mark.parametrize("fn", ["max", "min", "sum"])
def test_float_edge_values_reduce_as_in_jax(fn):
    """Segments of only -0.0 and +0.0 in both orders, NaN first and last,
    +-inf: max takes +0.0, min -0.0, NaN wins, as XLA's reductions."""
    segs = [[-0.0, 0.0], [0.0, -0.0], [-0.0], [0.0], [np.nan, 1.0], [1.0, np.nan], [np.inf, -np.inf], [-np.inf],
            [np.nan, -np.inf], [3.0, -0.0, 0.0]]
    values = np.array([x for s in segs for x in s], np.float64)
    lanes = np.repeat(np.arange(len(segs)), [len(s) for s in segs]).astype(np.uint32).reshape(-1, 1)
    kind = np.zeros(len(values), np.uint8)
    jplan, tplan = _both_plans(lanes, None, "xla")
    tcol, jcol = _columns(values, np.ones(len(values), np.bool_))
    want = JA.aggregate_merge(jplan, jcol, JA.AggregateSpec(fn), kind)
    got = TA.aggregate_merge(tplan, tcol, TA.AggregateSpec(fn), kind, device="cpu")
    assert same_column(got, want)


FUSED_SPECS = [
    ("sum", np.int64, False), ("sum", np.float64, False), ("sum", np.float32, False), ("count", np.int64, False),
    ("max", np.float64, True), ("min", np.int64, True), ("bool_and", np.bool_, True), ("bool_or", np.bool_, True),
    ("first_value", object, True), ("first_non_null_value", np.float64, True), ("last_value", np.int64, True),
    ("last_non_null_value", object, True), ("sum", np.int64, True),
]


@pytest.mark.parametrize("engine, tier, case", ENGINE_TIER_CASES, ids=ENGINE_TIER_CASE_IDS)
def test_fused_aggregate_matches_jax(request, kernel_calls, engine, tier, case):
    _tier(request, tier)
    rng = np.random.default_rng(60 + CASES.index(case))
    n = _n(rng, case)
    lanes, seq, kind = _keys(rng, case, n), _seq(rng, n, case == "random"), _kinds(rng, n, True)
    cols = [(_values(rng, d, n), rng.random(n) < 0.8) for _, d, _ in FUSED_SPECS]
    tcols, jcols = zip(*[_columns(v, ok) for v, ok in cols])
    tspecs = [TA.AggregateSpec(fn, ig) for fn, _, ig in FUSED_SPECS]
    jspecs = [JA.AggregateSpec(fn, ig) for fn, _, ig in FUSED_SPECS]
    assert TA.fused_routable(tspecs, list(tcols)) and JA.fused_routable(jspecs, list(jcols))
    want_cols, want_take = JA.fused_aggregate(lanes, seq, list(jcols), jspecs, kind, compress=True, engine=engine)
    got_cols, got_take = TA.fused_aggregate(lanes, seq, list(tcols), tspecs, kind, compress=True, engine=engine,
                                            device="cpu")
    assert same(got_take, want_take)
    for g, w in zip(got_cols, want_cols):
        assert same_column(g, w)
    if engine == "pallas" and case != "empty":
        assert kernel_calls["sort_segments" if tier == "fused" else "keep_last_mask"] == 1
        assert kernel_calls["segment_sum"] == 2  # the float64 and float32 sums


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_segment_sum_plain_adds_in_sorted_order_as_jax(dtype):
    """segment_sum's plain version is bit-identical to jax.ops.segment_sum
    on the CPU (each segment's rows added in order, from 0)."""
    rng = np.random.default_rng(5)
    m = 4096
    v = (rng.standard_normal(m) * 10.0 ** rng.integers(-8, 9, m)).astype(dtype)
    v[rng.integers(0, m, 50)] = -0.0
    seg_id = np.sort(rng.integers(0, 700, m)).astype(np.int32)
    seg_id = (np.cumsum(np.concatenate([[True], seg_id[1:] != seg_id[:-1]])) - 1).astype(np.int32)
    starts = np.concatenate([[True], seg_id[1:] != seg_id[:-1]])
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(v), jnp.asarray(seg_id), num_segments=m))
    got = hk.segment_sum(torch.from_numpy(v), torch.from_numpy(starts), torch.from_numpy(seg_id)).numpy()
    assert same(got, want)


class _CudaFloatStandIn:
    """Duck-types a contiguous 1-D float64 CUDA tensor."""

    dtype = torch.float64
    device = torch.device("cuda", 0)
    shape = (128,)

    def dim(self):
        return 1

    def is_contiguous(self):
        return True


def test_segment_sum_cuda_tensor_without_gpu_raises_instead_of_falling_back(monkeypatch):
    monkeypatch.setattr(hk, "_KERNELS", {})
    monkeypatch.setattr(hk, "_BUILD", "/nonexistent-paimon-build-dir")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda-home")
    monkeypatch.setattr(hk.shutil, "which", lambda name: None)
    monkeypatch.setattr(hk, "segment_sum_plain", lambda *a: pytest.fail("fell back to the plain version"))
    starts = torch.zeros(128, dtype=torch.bool)
    before = dict(hk.launches)
    with pytest.raises(RuntimeError):
        hk.segment_sum(_CudaFloatStandIn(), starts, torch.zeros(128, dtype=torch.int32))
    assert hk.launches == before


# ---------------------------------------------------------------------------
# MergeExecutor parity (adds the numpy engine and the engines' row kinds)
# ---------------------------------------------------------------------------

EXECUTOR_TABLES = {
    "partial-update": ({}, ("a", "d", "s")),
    "partial-update-remove": ({"partial-update.remove-record-on-delete": "true"}, ("a", "d", "s")),
    "partial-update-ignore-delete": ({"partial-update.ignore-delete": "true"}, ("a", "d", "s")),
    "aggregation": ({"fields.a.aggregate-function": "sum", "fields.d.aggregate-function": "max",
                     "fields.d.ignore-retract": "true", "fields.s.aggregate-function": "last_value",
                     "fields.s.ignore-retract": "true"}, ("a", "d", "s")),
    "aggregation-planned": ({"fields.a.aggregate-function": "product", "fields.a.ignore-retract": "true",
                             "fields.d.aggregate-function": "sum", "fields.s.aggregate-function": "listagg",
                             "fields.s.ignore-retract": "true"}, ("a", "d", "s")),
    "aggregation-default": ({"fields.default-aggregate-function": "last_non_null_value"}, ("a", "d", "s")),
    "first-row": ({}, ("a", "d", "s")),
    "first-row-ignore-delete": ({"first-row.ignore-delete": "true"}, ("a", "d", "s")),
}


def _executor_pair(table: str, sort_engine: str):
    extra, _ = EXECUTOR_TABLES[table]
    engine = table.split("-")[0] if not table.startswith("partial") else "partial-update"
    engine = {"first": "first-row"}.get(engine, engine)
    opts = {"merge-engine": engine, "sort-engine": sort_engine, **extra}
    jschema = jt.RowType.of(("id", jt.BIGINT(False)), ("a", jt.BIGINT()), ("d", jt.DOUBLE()), ("s", jt.STRING()))
    tschema = tt.RowType.of(("id", tt.BIGINT(False)), ("a", tt.BIGINT()), ("d", tt.DOUBLE()), ("s", tt.STRING()))
    jopts, topts = JaxOptions(opts), PortOptions(opts)
    return (JaxMerge(jschema, ["id"], jopts.merge_engine, jopts),
            PortMerge(tschema, ["id"], topts.merge_engine, topts, device="cpu"), jschema, tschema)


def _kv_pair(jschema, tschema, ids, kinds, rng, seq_start=0):
    n = len(ids)
    a = rng.integers(1, 5, n)
    d = rng.standard_normal(n)
    s = np.array([f"s{int(x)}" for x in rng.integers(0, 9, n)], dtype=object)
    valid = [rng.random(n) < 0.75 for _ in range(3)]
    seq = np.arange(seq_start, seq_start + n, dtype=np.int64)
    cols = {"id": ids.astype(np.int64), "a": a, "d": d, "s": s}
    jb = JaxBatch(jschema, {k: JaxColumn(v, None if k == "id" else valid[i - 1].copy())
                            for i, (k, v) in enumerate(cols.items())})
    tb = PortBatch(tschema, {k: PortColumn(v, None if k == "id" else valid[i - 1].copy())
                             for i, (k, v) in enumerate(cols.items())})
    return JaxKV(jb, seq, kinds), PortKV(tb, seq, kinds)


def _same_kv(got, want):
    assert same(got.seq, want.seq) and same(got.kind, want.kind)
    for name in want.data.schema.field_names:
        assert same_column(got.data.column(name), want.data.column(name)), name


@pytest.mark.parametrize("seq_ascending", [True, False])
@pytest.mark.parametrize("sort_engine", ["xla-segmented", "numpy"])
@pytest.mark.parametrize("table", list(EXECUTOR_TABLES))
def test_merge_executor_matches_jax(table, sort_engine, seq_ascending):
    """The engine dispatch: fused or planned path, row kinds, the raises.
    (The pallas engine's programs are held to the JAX package's above, and
    the pallas reads to the JAX package's in the table tests below.)"""
    rng = np.random.default_rng(80 + list(EXECUTOR_TABLES).index(table))
    jm, tm, jschema, tschema = _executor_pair(table, sort_engine)
    n = 400
    ids = rng.integers(0, 150, n)
    deletes = table.endswith(("remove", "ignore-delete")) or table.startswith("aggregation")
    kinds = _kinds(rng, n, deletes)
    if table.endswith("ignore-delete"):
        kinds[kinds == UPDATE_BEFORE] = INSERT
    jkv, tkv = _kv_pair(jschema, tschema, ids, kinds, rng)
    try:
        want = jm.merge(jkv, seq_ascending=seq_ascending)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:30]):
            tm.merge(tkv, seq_ascending=seq_ascending)
        return
    _same_kv(tm.merge(tkv, seq_ascending=seq_ascending), want)


@pytest.mark.parametrize("sort_engine", ["xla-segmented", "numpy"])
@pytest.mark.parametrize("table", ["aggregation", "partial-update-remove"])
def test_sorted_unique_input_is_still_merged(table, sort_engine):
    """Key-sorted unique input skips the merge only under deduplicate: one
    aggregation row still becomes +I with a -D sum negated, and a lone -D
    under remove-record-on-delete still becomes a removed key."""
    jm, tm, jschema, tschema = _executor_pair(table, sort_engine)
    rng = np.random.default_rng(3)
    ids = np.arange(60)
    kinds = np.where(ids % 5 == 0, DELETE, np.where(ids % 7 == 0, UPDATE_AFTER, INSERT)).astype(np.uint8)
    jkv, tkv = _kv_pair(jschema, tschema, ids, kinds, rng)
    want = jm.merge(jkv, seq_ascending=True)
    got = tm.merge(tkv, seq_ascending=True)
    _same_kv(got, want)
    assert not same(got.kind, kinds)


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------


def _port_table(warehouse, name, options, schema=None):
    schema = schema or tt.RowType.of(("id", tt.BIGINT(False)), ("a", tt.BIGINT()), ("s", tt.STRING()))
    return PortCatalog(warehouse, device="cpu").create_table(
        f"db.{name}", schema, primary_keys=["id"], options={"bucket": "1", "sort-engine": "pallas", **options})


def _write(table, rows, kinds=None):
    wb = table.new_batch_write_builder()
    w = wb.new_write()
    w.write(rows, kinds)
    return wb.new_commit().commit(w.prepare_commit())


PU, AGG = {"merge-engine": "partial-update"}, {"merge-engine": "aggregation"}
GUARDED = [
    ("fields.a.sequence-group", PU, {"fields.a.sequence-group": "s"}),
    ("sequence.field", PU, {"sequence.field": "a"}),
    ("fields.s.aggregate-function", AGG, {"fields.s.aggregate-function": "collect"}),
    ("fields.s.aggregate-function", AGG, {"fields.s.aggregate-function": "merge_map"}),
    ("fields.s.aggregate-function", AGG, {"fields.s.aggregate-function": "nested_update"}),
    ("fields.default-aggregate-function", AGG, {"fields.default-aggregate-function": "collect"}),
]


@pytest.mark.parametrize("key, base, bad", GUARDED, ids=[f"{k}={list(b.values())[-1]}" for k, _, b in GUARDED])
def test_unported_engine_features_raise_naming_the_option(tmp_path, key, base, bad):
    """A table written without the feature: writing, reading and compacting
    it with the feature's option set raise, naming the option."""
    table = _port_table(str(tmp_path), "guarded", base)
    rows = {"id": np.arange(3), "a": np.arange(3), "s": np.array(["x", "y", "z"], dtype=object)}
    _write(table, rows)
    _write(table, rows)
    with_option = table.copy(bad)
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        _write(with_option, rows)
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        rb = with_option.new_read_builder()
        rb.new_read().read_all(rb.new_scan().plan())
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        with_option.new_batch_write_builder().new_write().compact(full=True)


def test_unknown_aggregate_function_raises_the_jax_value_error(tmp_path):
    options = {"merge-engine": "aggregation", "fields.a.aggregate-function": "median", "write-only": "true"}
    rows = {"id": np.array([1, 1, 2]), "a": np.arange(3), "s": np.array(["x", "y", "z"], dtype=object)}
    jtable = JaxCatalog(str(tmp_path)).create_table(
        "db.jax_unknown", jt.RowType.of(("id", jt.BIGINT(False)), ("a", jt.BIGINT()), ("s", jt.STRING())),
        primary_keys=["id"], options={"bucket": "1", "sort-engine": "pallas", **options})
    with pytest.raises(ValueError, match="unknown aggregate function 'median'") as want:
        _write(jtable, rows)
    with pytest.raises(ValueError) as got:
        _write(_port_table(str(tmp_path), "unknown", options), rows)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# table parity
# ---------------------------------------------------------------------------

SCHEMA = (("id", "BIGINT NOT NULL"), ("a", "BIGINT"), ("d", "DOUBLE"), ("s", "STRING"), ("b", "BOOLEAN"))
TABLES = {
    "partial-update": {"merge-engine": "partial-update"},
    "partial-update-remove": {"merge-engine": "partial-update", "partial-update.remove-record-on-delete": "true"},
    "aggregation": {"merge-engine": "aggregation", "fields.a.aggregate-function": "sum",
                    "fields.d.aggregate-function": "sum", "fields.s.aggregate-function": "first_non_null_value",
                    "fields.s.ignore-retract": "true", "fields.b.aggregate-function": "bool_or",
                    "fields.b.ignore-retract": "true"},
    "aggregation-planned": {"merge-engine": "aggregation", "fields.a.aggregate-function": "max",
                            "fields.a.ignore-retract": "true", "fields.d.aggregate-function": "sum",
                            "fields.s.aggregate-function": "listagg", "fields.s.ignore-retract": "true",
                            "fields.b.aggregate-function": "primary-key"},
    "first-row": {"merge-engine": "first-row", "first-row.ignore-delete": "true"},
}
COMMITS, ROWS, IDS = 3, 300, 400


def _row_type(pkg):
    return pkg.RowType.of(("id", pkg.BIGINT(False)), ("a", pkg.BIGINT()), ("d", pkg.DOUBLE()), ("s", pkg.STRING()),
                          ("b", pkg.BOOLEAN()))


def _commits(table: str, commits: int = COMMITS):
    """Seeded commits with overlapping keys, nulls and the row kinds the
    table takes: (columns dict, kinds) each."""
    rng = np.random.default_rng(list(TABLES).index(table))
    out = []
    for c in range(commits):
        ids = rng.integers(0, IDS, ROWS)
        a = rng.integers(-50, 50, ROWS)
        d = np.round(rng.standard_normal(ROWS) * 8) / 8  # eighths: every partial sum is exact, in any order
        s = [f"v{c}-{int(x)}" for x in rng.integers(0, 20, ROWS)]
        b = rng.random(ROWS) < 0.5
        nulls = [rng.random(ROWS) < 0.2 for _ in range(4)]
        cols = {"id": ids, **{k: [None if nul else (x.item() if hasattr(x, "item") else x) for x, nul in zip(v, nn)]
                              for (k, v), nn in zip((("a", a), ("d", d), ("s", s), ("b", b)), nulls)}}
        if table == "partial-update":
            kinds = rng.choice([INSERT, UPDATE_AFTER], ROWS, p=[0.8, 0.2])
        elif table == "first-row":
            kinds = rng.choice([INSERT, UPDATE_AFTER, DELETE], ROWS, p=[0.75, 0.15, 0.1])
        else:
            kinds = rng.choice(4, ROWS, p=[0.7, 0.1, 0.1, 0.1])
        out.append((cols, kinds.astype(np.uint8)))
    return out


def _oracle(table: str, commits) -> list[tuple]:
    """The merged rows of batch commits: each commit's rows merged per key
    (its flush), then each key's merged rows merged in commit order (the
    read), the engine's rule at both steps; -U/-D rows dropped at the end.
    Two steps, because partial-update with remove-record-on-delete gives
    another result when a commit's rows are merged apart from the rest: a
    commit whose only rows for a key are -U removes the key."""
    merged: dict[int, list] = {}
    for cols, kinds in commits:
        rows: dict[int, list] = {}
        for i in range(len(kinds)):
            rows.setdefault(int(cols["id"][i]), []).append(
                (int(kinds[i]), cols["a"][i], cols["d"][i], cols["s"][i], cols["b"][i]))
        for key, key_rows in rows.items():
            row = _merge_rows(table, key_rows)
            if row is not None:
                merged.setdefault(key, []).append(row)
    out = []
    for key in sorted(merged):
        row = _merge_rows(table, merged[key])
        if row is not None and row[0] in (INSERT, UPDATE_AFTER):
            out.append((key, *row[1:]))
    return out


def _last(vals):
    vals = [v for v in vals if v is not None]
    return vals[-1] if vals else None


def _sum(vals):
    """Added in order from 0, as the merge does; None when nothing to add."""
    vals = list(vals)
    total = 0.0 if vals and isinstance(vals[0], float) else 0
    for x in vals:
        total += x
    return total if vals else None


def _merge_rows(table, rows):
    """One key's rows (kind, a, d, s, b) in arrival order through the
    engine: the merged (kind, a, d, s, b), or None for no row."""
    if table == "first-row":
        rows = [r for r in rows if r[0] != DELETE]  # first-row.ignore-delete
        return rows[0] if rows else None
    adds = [r for r in rows if r[0] in (INSERT, UPDATE_AFTER)]
    if table.startswith("partial-update"):
        last_del = max((i for i, r in enumerate(rows) if r[0] == DELETE), default=-1)
        adds = [r for r in rows[last_del + 1:] if r[0] in (INSERT, UPDATE_AFTER)]
        if not adds:
            return (DELETE, None, None, None, None) if table.endswith("remove") else None
        return (INSERT, *[_last(r[f] for r in adds) for f in range(1, 5)])
    signed = [(1 if r[0] in (INSERT, UPDATE_AFTER) else -1, r) for r in rows]
    d = _sum(r[2] * s for s, r in signed if r[2] is not None)
    if table == "aggregation":
        b = [r[4] for r in adds if r[4] is not None]
        return (INSERT, _sum(s * r[1] for s, r in signed if r[1] is not None), d,
                next((r[3] for r in adds if r[3] is not None), None), any(b) if b else None)
    a = [r[1] for r in adds if r[1] is not None]
    s_vals = [r[3] for r in adds if r[3] is not None]
    return (INSERT, max(a) if a else None, d, ",".join(s_vals) if s_vals else None, rows[-1][4])


def _create(pkg, catalog, ident: str, table: str, extra=None):
    """The JAX package's tables sort with its plain engine (its Pallas
    programs are held to the port's in the module tests above)."""
    engine = "pallas" if pkg is tt else "xla-segmented"
    options = {"bucket": "1", "sort-engine": engine, "write-only": "true", **TABLES[table], **(extra or {})}
    return catalog.create_table(ident, _row_type(pkg), primary_keys=["id"], options=options)


def _write_commits(tbl, commits, stream: bool = False):
    builder = tbl.new_stream_write_builder() if stream else None
    w = builder.new_write() if stream else None
    c = builder.new_commit() if stream else None
    for i, (cols, kinds) in enumerate(commits):
        if stream:
            w.write(cols, kinds)
            c.commit_messages(i + 1, w.prepare_commit())
        else:
            _write(tbl, cols, kinds)


def _read(tbl, engine=None) -> list[tuple]:
    if engine is not None:
        tbl = tbl.copy({"sort-engine": engine})
    rb = tbl.new_read_builder()
    rows = rb.new_read().read_all(rb.new_scan().plan()).to_pylist()
    return [tuple(v.item() if hasattr(v, "item") else v for v in row) for row in rows]


def _float_exact(rows):
    """Rows with doubles as their bits, so equality is bit for bit."""
    return [tuple(np.float64(v).view(np.int64).item() if isinstance(v, float) else v for v in row) for row in rows]


@pytest.fixture(scope="module")
def warehouse(tmp_path_factory):
    return str(tmp_path_factory.mktemp("torch_engines_warehouse"))


@pytest.mark.parametrize("table", list(TABLES))
def test_jax_writes_port_reads(warehouse, table):
    commits = _commits(table)
    ident = f"db.jw_{table.replace('-', '_')}"
    jtable = _create(jt, JaxCatalog(warehouse), ident, table)
    _write_commits(jtable, commits)
    want = _read(jtable)
    assert _float_exact(want) == _float_exact(_oracle(table, commits))
    ptable = PortCatalog(warehouse, device="cpu").get_table(ident)
    for engine in ENGINES:
        assert _float_exact(_read(ptable, engine)) == _float_exact(want), engine


@pytest.mark.parametrize("table", list(TABLES))
def test_port_writes_jax_reads(warehouse, table):
    commits = _commits(table)
    ident = f"db.pw_{table.replace('-', '_')}"
    ptable = _create(tt, PortCatalog(warehouse, device="cpu"), ident, table)
    _write_commits(ptable, commits)
    want = _float_exact(_oracle(table, commits))
    for engine in ENGINES:
        assert _float_exact(_read(ptable, engine)) == want, engine
    assert _float_exact(_read(JaxCatalog(warehouse).get_table(ident), "xla-segmented")) == want


@pytest.mark.parametrize("table", list(TABLES))
def test_port_streams_with_compaction_then_compacts_fully(warehouse, table):
    """write-only=false, trigger 4: the stream's commits compact; then one
    full compaction. Both reads equal the JAX package's and the oracle."""
    commits = _commits(table, 8)
    ident = f"db.st_{table.replace('-', '_')}"
    ptable = _create(tt, PortCatalog(warehouse, device="cpu"), ident, table,
                     {"write-only": "false", "num-sorted-run.compaction-trigger": "4"})
    _write_commits(ptable, commits, stream=True)
    # compactions regroup the rows, which changes partial-update's result
    # under remove-record-on-delete: there the JAX package's read alone
    # holds the port to account
    want = None if table.endswith("remove") else _float_exact(_oracle(table, commits))
    snapshots = SnapshotManager(ptable.file_io, ptable.path)
    kinds = [snapshots.snapshot(i).commit_kind.value for i in range(1, snapshots.latest_snapshot_id() + 1)]
    assert "COMPACT" in kinds
    for step in ("stream", "full"):
        if step == "full":
            wb = ptable.new_batch_write_builder()
            w = wb.new_write()
            w.compact(full=True)
            wb.new_commit().commit(w.prepare_commit())
            assert len({f.level for f in ptable.store.restore_files((), 0)}) == 1
        jax_read = _float_exact(_read(JaxCatalog(warehouse).get_table(ident), "xla-segmented"))
        assert want is None or jax_read == want, step
        for engine in ENGINES:
            assert _float_exact(_read(ptable, engine)) == jax_read, (step, engine)
