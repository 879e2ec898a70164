"""The port's SQL expressions (paimon_tpu_torch/sql/expr.py) against the
JAX package's, on the CPU: a seeded fuzz.

Random expression trees over a batch with NULLs (BIGINT, DOUBLE with NaN
and -0.0, STRING columns; comparisons, arithmetic, IN and NOT IN,
BETWEEN, LIKE and NOT LIKE, IS [NOT] NULL, NOT, AND, OR, TRUE, FALSE and
NULL literals, alias-qualified and backquoted refs) go through both
packages' parse_expr (the same AST), eval_mask and eval_value (SQL
three-valued logic over two aliased batches), and to_predicate, whose
predicate is evaluated on the same batch by each package's predicate
algebra (or both refuse it with the same message). The counterparts of
tests/test_sql_expr_fuzz.py's pinned cases run too: the negation
lowerings, NULL under LIKE and NOT LIKE, and the Kleene cases of the
two-table evaluator. The tokenizer's and parser's errors are compared
message for message.

Tolerance: exact. Masks equal; values equal, floats bit for bit with any
NaN equal to any NaN, NULL as None.
"""

import numpy as np
import pytest

import paimon_tpu.data.batch as jbatch
import paimon_tpu.sql.expr as jexpr
import paimon_tpu.types as jtypes
import paimon_tpu_torch.data.batch as tbatch
import paimon_tpu_torch.sql.expr as texpr
import paimon_tpu_torch.types as ttypes

N = 400


def _batches(seed: int):
    rng = np.random.default_rng(seed)
    a = [None if x < 0 else int(x) for x in rng.integers(-10, 60, N)]
    b = np.round(rng.normal(size=N) * 20, 1)
    b[rng.random(N) < 0.05] = np.nan
    b[rng.random(N) < 0.05] = -0.0
    bl = [None if z else float(v) for z, v in zip(rng.random(N) < 0.1, b)]
    s = [None if z else f"w{int(v)}x" for z, v in zip(rng.random(N) < 0.1, rng.integers(0, 30, N))]
    k = list(range(N))
    out = []
    for types, batch in ((jtypes, jbatch), (ttypes, tbatch)):
        schema = types.RowType.of(("k", types.BIGINT(False)), ("a", types.BIGINT()), ("b", types.DOUBLE()),
                                  ("s", types.STRING()))
        out.append(batch.ColumnBatch.from_pydict(schema, {"k": k, "a": a, "b": bl, "s": s}))
    return out


def _operand(rng, depth=0, alias=True):
    r = rng.random()
    if depth < 2 and r < 0.3:
        op = rng.choice(["+", "-", "*", "/", "%"])
        return f"({_operand(rng, depth + 1, alias)} {op} {_operand(rng, depth + 1, alias)})"
    if r < 0.4:
        return f"-{_operand(rng, depth + 1, alias)}"
    if r < 0.55:
        return str(int(rng.integers(-5, 60)))
    if r < 0.6:
        return f"{rng.normal() * 10:.2f}"
    if r < 0.62:
        return "NULL"
    col = str(rng.choice(["a", "b", "k", "`a`"]))
    return f"{rng.choice(['src', 'tgt'])}.{col}" if alias and rng.random() < 0.5 else col


def _condition(rng, depth=0, alias=True):
    if depth < 3 and rng.random() < 0.45:
        kind = rng.choice(["and", "or", "not"])
        if kind == "not":
            return f"NOT ({_condition(rng, depth + 1, alias)})"
        return f"({_condition(rng, depth + 1, alias)}) {kind.upper()} ({_condition(rng, depth + 1, alias)})"
    leaf = rng.choice(["cmp", "cmp_lit", "in", "between", "like", "isnull", "bool", "s_eq"])
    col = str(rng.choice(["a", "b", "k"]))
    if leaf == "cmp":
        return f"{_operand(rng, 1, alias)} {rng.choice(['=', '<>', '!=', '<', '<=', '>', '>='])} {_operand(rng, 1, alias)}"
    if leaf == "cmp_lit":
        v = int(rng.integers(0, 60))
        return f"{col} {rng.choice(['=', '<>', '<', '<=', '>', '>='])} {v}" if rng.random() < 0.5 else \
            f"{v} {rng.choice(['<', '>=', '='])} {col}"
    if leaf == "in":
        vals = ", ".join(str(int(x)) for x in rng.integers(0, 60, 3))
        return f"{col} {'NOT ' if rng.random() < 0.4 else ''}IN ({vals})"
    if leaf == "between":
        lo, hi = sorted(int(x) for x in rng.integers(0, 60, 2))
        return f"{col} {'NOT ' if rng.random() < 0.4 else ''}BETWEEN {lo} AND {hi}"
    if leaf == "like":
        w = int(rng.integers(0, 30))
        pat = str(rng.choice([f"w{w}%", f"%{w}x", f"%{w}%", f"w{w}x", f"w_{w}"]))
        return f"s {'NOT ' if rng.random() < 0.4 else ''}LIKE '{pat}'"
    if leaf == "isnull":
        return f"{rng.choice(['a', 'b', 's', 'k'])} IS {'NOT ' if rng.random() < 0.5 else ''}NULL"
    if leaf == "bool":
        return str(rng.choice(["TRUE", "FALSE"]))
    return f"s = 'w{int(rng.integers(0, 30))}x'"


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.kind == "f":
        i = f"i{a.itemsize}"
        return bool(((a.view(i) == b.view(i)) | (np.isnan(a) & np.isnan(b))).all())
    if a.dtype == object:
        return all((x is None and y is None) or x == y or (isinstance(x, float) and isinstance(y, float)
                                                           and np.isnan(x) and np.isnan(y)) for x, y in zip(a, b))
    return bool((a == b).all())


def _outcome(fn):
    try:
        with np.errstate(all="ignore"):
            return "ok", fn()
    except Exception as e:  # noqa: BLE001 - both packages must fail alike
        return type(e).__name__, str(e)


def _assert_same_outcome(want, got, what):
    assert got[0] == want[0], f"{what}: {got} vs {want}"
    if want[0] != "ok":
        assert got[1] == want[1], what
        return
    w, g = want[1], got[1]
    if isinstance(w, (tuple, list, dict)):
        assert g == w, what
    elif w is None:
        assert g is None, what
    else:
        assert _same(w, g), what


@pytest.mark.parametrize("seed", range(6))
def test_two_table_eval_matches_jax(seed):
    rng = np.random.default_rng(1000 + seed)
    (js, ps), (jt, pt) = _batches(seed), _batches(seed + 50)
    jres = jexpr.batch_resolver({"src": js, "tgt": jt})
    pres = texpr.batch_resolver({"src": ps, "tgt": pt})
    for trial in range(60):
        cond = _condition(rng)
        ast = (_outcome(lambda: jexpr.parse_expr(cond)), _outcome(lambda: texpr.parse_expr(cond)))
        _assert_same_outcome(*ast, f"parse {cond}")
        if ast[0][0] != "ok":
            continue
        _assert_same_outcome(_outcome(lambda: jexpr.eval_mask(ast[0][1], jres, N)),
                             _outcome(lambda: texpr.eval_mask(ast[1][1], pres, N)), f"mask {cond}")
        op = _operand(rng)
        _assert_same_outcome(_outcome(lambda: jexpr.eval_value(jexpr.parse_expr(op), jres, N)),
                             _outcome(lambda: texpr.eval_value(texpr.parse_expr(op), pres, N)), f"value {op}")


@pytest.mark.parametrize("seed", range(6))
def test_to_predicate_matches_jax(seed):
    rng = np.random.default_rng(2000 + seed)
    jb, pb = _batches(seed)
    for trial in range(80):
        cond = _condition(rng, alias=False)
        jp = _outcome(lambda: jexpr.parse_where(cond))
        pp = _outcome(lambda: texpr.parse_where(cond))
        assert pp[0] == jp[0], f"{cond}: {pp} vs {jp}"
        if jp[0] != "ok":
            assert pp[1] == jp[1], cond
            continue
        if jp[1] is None:
            assert pp[1] is None, cond
            continue
        # TRUE inside AND/OR lowers to a None child in both packages: their
        # to_dict and eval then fail alike
        _assert_same_outcome(_outcome(lambda: jp[1].to_dict()), _outcome(lambda: pp[1].to_dict()), cond)
        _assert_same_outcome(_outcome(lambda: np.asarray(jp[1].eval(jb), bool)),
                             _outcome(lambda: np.asarray(pp[1].eval(pb), bool)), cond)


PINNED = [
    "s NOT LIKE 'w1%'", "NOT (s LIKE '%3x')", "NOT (a < 10 AND s = 'w2x')", "NOT (a < 10 OR a > 40)",
    "NOT (NOT a = 7)", "a NOT BETWEEN 10 AND 20", "NOT (a BETWEEN 10 AND 20)", "s LIKE 'w1%'",
    "NOT (a IS NULL)", "NOT (a IN (1, 2))", "NOT (s NOT LIKE '%1x')", "NOT (a < b)", "NOT (a + 1)",
    "k >= 7", "k >= 3 AND k < 5", "k = 1 OR k = 8", "NOT k < 8", "k IN (2, 4, 99)", "k BETWEEN 2 AND 4",
    "v / 10 = k AND TRUE", "100 <= k", "TRUE", "FALSE", "k = ", "s = 'unterminated", "k = v", "k = 1 1",
    "a @ 3", "`a = 1", "k IN (a, 2)", "s LIKE a", "NOT", "s LIKE 'a%b%'", "1.5e3 < b", "(a + 2) * 3 > b",
    "-(a) <= -3", "a IN (1, 2.5, 'x')", "a BETWEEN k AND 3", "NULL IS NULL", "a + NULL > 1",
]


@pytest.mark.parametrize("text", PINNED)
def test_pinned_expressions_match_jax(text):
    jb, pb = _batches(7)
    jres, pres = jexpr.batch_resolver({"t": jb}), texpr.batch_resolver({"t": pb})
    _assert_same_outcome(_outcome(lambda: jexpr.parse_expr(text)), _outcome(lambda: texpr.parse_expr(text)), text)
    _assert_same_outcome(_outcome(lambda: jexpr.eval_mask(jexpr.parse_expr(text), jres, N)),
                         _outcome(lambda: texpr.eval_mask(texpr.parse_expr(text), pres, N)), text)
    jp, pp = _outcome(lambda: jexpr.parse_where(text)), _outcome(lambda: texpr.parse_where(text))
    assert pp[0] == jp[0] and (jp[0] == "ok" or pp[1] == jp[1]), f"{text}: {pp} vs {jp}"
    if jp[0] == "ok" and jp[1] is not None:
        _assert_same_outcome(_outcome(lambda: np.asarray(jp[1].eval(jb), bool)),
                             _outcome(lambda: np.asarray(pp[1].eval(pb), bool)), text)


@pytest.mark.parametrize("text", ["a = 1, s = 'x'", "t.a = a + 1", "*", " * ", "a = ", "a = 1 b = 2", "1 = a"])
def test_parse_assignments_matches_jax(text):
    _assert_same_outcome(_outcome(lambda: jexpr.parse_assignments(text)),
                         _outcome(lambda: texpr.parse_assignments(text)), text)
