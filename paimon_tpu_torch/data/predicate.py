"""Predicates: a serialisable AST evaluated on rows and on file statistics
(port of paimon_tpu/data/predicate.py).

The same tree is evaluated (a) against a ColumnBatch as a dense boolean
mask, one numpy expression per leaf on the host, with SQL's three-valued
logic collapsed to False for NULL, and (b) against per-file or per-row-group
min/max/null-count statistics (format.FieldStats) to decide whether a file
or row group might hold a matching row. Leaves serialise with
to_dict/from_dict in the JAX package's form.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np

from ..format import FieldStats
from .batch import ColumnBatch

__all__ = [
    "Predicate",
    "LeafPredicate",
    "CompoundPredicate",
    "PredicateBuilder",
    "FieldStats",
    "and_",
    "or_",
    "equal",
    "not_equal",
    "less_than",
    "less_or_equal",
    "greater_than",
    "greater_or_equal",
    "is_null",
    "is_not_null",
    "in_",
    "not_in",
    "starts_with",
    "ends_with",
    "contains",
    "between",
]


def _all_null(st: FieldStats) -> bool:
    """Every row null (a null_count of None is unknown, never all-null)."""
    return st.null_count is not None and st.null_count >= st.row_count


class Predicate:
    def eval(self, batch: ColumnBatch) -> np.ndarray:
        """Dense bool mask; NULL collapses to False."""
        raise NotImplementedError

    def test_stats(self, stats: dict[str, FieldStats]) -> bool:
        """True if rows with these stats might match. A field without stats
        cannot prune."""
        raise NotImplementedError

    def referenced_fields(self) -> set[str]:
        raise NotImplementedError

    def negate(self) -> Optional["Predicate"]:
        return None

    def to_dict(self) -> dict:
        raise NotImplementedError

    @staticmethod
    def from_dict(d: dict) -> "Predicate":
        if d["kind"] == "leaf":
            return LeafPredicate(d["function"], d["field"], d.get("literals"))
        return CompoundPredicate(d["function"], [Predicate.from_dict(c) for c in d["children"]])

    def __and__(self, other: "Predicate") -> "Predicate":
        return and_(self, other)

    def __or__(self, other: "Predicate") -> "Predicate":
        return or_(self, other)


_NEGATIONS = {
    "equal": "notEqual",
    "notEqual": "equal",
    "lessThan": "greaterOrEqual",
    "greaterOrEqual": "lessThan",
    "greaterThan": "lessOrEqual",
    "lessOrEqual": "greaterThan",
    "isNull": "isNotNull",
    "isNotNull": "isNull",
    "in": "notIn",
    "notIn": "in",
    "startsWith": "notStartsWith",
    "notStartsWith": "startsWith",
    "endsWith": "notEndsWith",
    "notEndsWith": "endsWith",
    "contains": "notContains",
    "notContains": "contains",
}

_CMP = {
    "equal": "==",
    "notEqual": "!=",
    "lessThan": "<",
    "lessOrEqual": "<=",
    "greaterThan": ">",
    "greaterOrEqual": ">=",
}


@dataclass(frozen=True)
class LeafPredicate(Predicate):
    function: str
    field: str
    literals: Any = None  # a scalar, or a list for in / notIn / between

    def referenced_fields(self) -> set[str]:
        return {self.field}

    def negate(self) -> Optional[Predicate]:
        neg = _NEGATIONS.get(self.function)
        return LeafPredicate(neg, self.field, self.literals) if neg else None

    def to_dict(self) -> dict:
        return {"kind": "leaf", "function": self.function, "field": self.field, "literals": self.literals}

    def eval(self, batch: ColumnBatch) -> np.ndarray:
        col = batch.column(self.field)
        if self.function == "isNull":
            return ~col.valid_mask()
        if self.function == "isNotNull":
            return col.valid_mask().copy()
        if col.is_code_backed:
            # every other leaf is value-determined and fails on NULL: one
            # eval over the pool, one gather of the verdicts through the codes
            pool, codes = col.dict_cache
            if len(pool) == 0:
                return np.zeros(len(col), dtype=np.bool_)
            verdict = self._eval_values(pool, np.ones(len(pool), dtype=np.bool_))
            return verdict.take(np.minimum(codes, len(pool) - 1)) & col.valid_mask()
        return self._eval_values(col.values, col.valid_mask())

    def _eval_values(self, v: np.ndarray, valid: np.ndarray) -> np.ndarray:
        f, lit = self.function, self.literals
        if f in _CMP:
            m = _masked_cmp(v, valid, _CMP[f], lit)
        elif f in ("in", "notIn"):
            m = np.isin(v, np.asarray(list(lit), dtype=v.dtype)) if v.dtype != object else np.isin(v, list(lit))
            if f == "notIn":
                m = ~m
        elif f == "between":
            lo, hi = lit
            m = _masked_cmp(v, valid, ">=", lo) & _masked_cmp(v, valid, "<=", hi)
        elif f in ("startsWith", "endsWith", "contains"):
            m = _string_match(v, f, lit)
        elif f in ("notStartsWith", "notEndsWith", "notContains"):
            # NULL rows match neither LIKE nor NOT LIKE (the & valid below)
            m = ~_string_match(v, f[3].lower() + f[4:], lit)
        else:
            raise ValueError(f"unknown predicate function {f}")
        return np.asarray(m, dtype=np.bool_) & valid

    def test_stats(self, stats: dict[str, FieldStats]) -> bool:
        st = stats.get(self.field)
        if st is None:
            return True
        f, lit = self.function, self.literals
        if f == "isNull":
            return st.null_count is None or st.null_count > 0
        if f == "isNotNull":
            return not _all_null(st)
        if _all_null(st):
            return False
        if st.min is None or st.max is None:
            return True
        lo, hi = st.min, st.max
        if f == "equal":
            return lo <= lit <= hi
        if f == "notEqual":
            return not (lo == lit == hi)
        if f == "lessThan":
            return lo < lit
        if f == "lessOrEqual":
            return lo <= lit
        if f == "greaterThan":
            return hi > lit
        if f == "greaterOrEqual":
            return hi >= lit
        if f == "in":
            return any(lo <= x <= hi for x in lit)
        if f == "notIn":
            return not all(lo == x == hi for x in lit)
        if f == "between":
            return hi >= lit[0] and lo <= lit[1]
        if f == "startsWith":
            return str(lo)[: len(lit)] <= lit <= str(hi)[: len(lit)]
        return True  # endsWith / contains and the negated matches cannot prune


_OPS = {
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}


def _masked_cmp(v: np.ndarray, valid: np.ndarray, op: str, lit: Any) -> np.ndarray:
    """A comparison that never evaluates null slots of an object vector
    (they hold None, which does not order)."""
    fn = _OPS[op]
    if v.dtype == np.dtype(object) and not valid.all():
        out = np.zeros(len(v), dtype=np.bool_)
        out[valid] = np.asarray(fn(v[valid], lit), dtype=np.bool_)
        return out
    return np.asarray(fn(v, lit), dtype=np.bool_)


def _string_match(v: np.ndarray, f: str, lit: Any) -> np.ndarray:
    test = {"startsWith": str.startswith, "endsWith": str.endswith, "contains": lambda x, s: s in x}[f]
    return np.fromiter((x is not None and bool(test(str(x), lit)) for x in v), dtype=np.bool_, count=len(v))


@dataclass(frozen=True)
class CompoundPredicate(Predicate):
    function: str  # "and" | "or"
    children: tuple[Predicate, ...]

    def __init__(self, function: str, children: Sequence[Predicate]):
        object.__setattr__(self, "function", function)
        object.__setattr__(self, "children", tuple(children))

    def referenced_fields(self) -> set[str]:
        return set().union(*(c.referenced_fields() for c in self.children))

    def negate(self) -> Optional[Predicate]:
        negs = [c.negate() for c in self.children]
        if any(n is None for n in negs):
            return None
        return CompoundPredicate("or" if self.function == "and" else "and", negs)

    def to_dict(self) -> dict:
        return {"kind": "compound", "function": self.function, "children": [c.to_dict() for c in self.children]}

    def eval(self, batch: ColumnBatch) -> np.ndarray:
        masks = [c.eval(batch) for c in self.children]
        out = masks[0]
        for m in masks[1:]:
            out = (out & m) if self.function == "and" else (out | m)
        return out

    def test_stats(self, stats: dict[str, FieldStats]) -> bool:
        if self.function == "and":
            return all(c.test_stats(stats) for c in self.children)
        return any(c.test_stats(stats) for c in self.children)


def equal(field: str, value: Any) -> Predicate:
    return LeafPredicate("equal", field, value)


def not_equal(field: str, value: Any) -> Predicate:
    return LeafPredicate("notEqual", field, value)


def less_than(field: str, value: Any) -> Predicate:
    return LeafPredicate("lessThan", field, value)


def less_or_equal(field: str, value: Any) -> Predicate:
    return LeafPredicate("lessOrEqual", field, value)


def greater_than(field: str, value: Any) -> Predicate:
    return LeafPredicate("greaterThan", field, value)


def greater_or_equal(field: str, value: Any) -> Predicate:
    return LeafPredicate("greaterOrEqual", field, value)


def is_null(field: str) -> Predicate:
    return LeafPredicate("isNull", field)


def is_not_null(field: str) -> Predicate:
    return LeafPredicate("isNotNull", field)


def in_(field: str, values: Sequence[Any]) -> Predicate:
    return LeafPredicate("in", field, list(values))


def not_in(field: str, values: Sequence[Any]) -> Predicate:
    return LeafPredicate("notIn", field, list(values))


def starts_with(field: str, prefix: str) -> Predicate:
    return LeafPredicate("startsWith", field, prefix)


def ends_with(field: str, suffix: str) -> Predicate:
    return LeafPredicate("endsWith", field, suffix)


def contains(field: str, sub: str) -> Predicate:
    return LeafPredicate("contains", field, sub)


def between(field: str, lo: Any, hi: Any) -> Predicate:
    return LeafPredicate("between", field, [lo, hi])


def _flatten(function: str, preds: Sequence[Predicate]) -> Predicate:
    flat: list[Predicate] = []
    for p in preds:
        flat.extend(p.children if isinstance(p, CompoundPredicate) and p.function == function else [p])
    return flat[0] if len(flat) == 1 else CompoundPredicate(function, flat)


def and_(*preds: Predicate) -> Predicate:
    return _flatten("and", preds)


def or_(*preds: Predicate) -> Predicate:
    return _flatten("or", preds)


class PredicateBuilder:
    """Builds leaves on fields of a row type (raising KeyError for a field
    it lacks) and splits conjunctions for pushdown."""

    def __init__(self, row_type):
        self.row_type = row_type

    def _check(self, field: str) -> str:
        if field not in self.row_type:
            raise KeyError(f"no field {field!r} in {self.row_type.field_names}")
        return field

    def equal(self, field: str, value: Any) -> Predicate:
        return equal(self._check(field), value)

    def not_equal(self, field: str, value: Any) -> Predicate:
        return not_equal(self._check(field), value)

    def less_than(self, field: str, value: Any) -> Predicate:
        return less_than(self._check(field), value)

    def less_or_equal(self, field: str, value: Any) -> Predicate:
        return less_or_equal(self._check(field), value)

    def greater_than(self, field: str, value: Any) -> Predicate:
        return greater_than(self._check(field), value)

    def greater_or_equal(self, field: str, value: Any) -> Predicate:
        return greater_or_equal(self._check(field), value)

    def is_null(self, field: str) -> Predicate:
        return is_null(self._check(field))

    def is_not_null(self, field: str) -> Predicate:
        return is_not_null(self._check(field))

    def in_(self, field: str, values: Sequence[Any]) -> Predicate:
        return in_(self._check(field), values)

    def between(self, field: str, lo: Any, hi: Any) -> Predicate:
        return between(self._check(field), lo, hi)

    def starts_with(self, field: str, prefix: str) -> Predicate:
        return starts_with(self._check(field), prefix)

    @staticmethod
    def split_and(p: Predicate | None) -> list[Predicate]:
        if p is None:
            return []
        if isinstance(p, CompoundPredicate) and p.function == "and":
            return list(p.children)
        return [p]

    @staticmethod
    def pick_by_fields(preds: Sequence[Predicate], fields: set[str]) -> list[Predicate]:
        return [p for p in preds if p.referenced_fields() <= fields]
