"""SQL expressions: the tokenizer, the parser, constant folding and the two
lowerings (port of paimon_tpu/sql/expr.py).

A small recursive-descent parser over the comparison and boolean grammar
that WHERE clauses, HAVING, SET lists and the procedures' conditions use,
with two lowerings:

- :func:`to_predicate`: single-table mode, onto the port's predicate
  algebra (data/predicate.py), so a WHERE string prunes files and row
  groups as a programmatic predicate does.
- :func:`eval_mask` / :func:`eval_value`: column refs, optionally
  qualified by a table alias, evaluated over aligned ColumnBatches with
  SQL's three-valued (Kleene) logic; MERGE INTO, UPDATE, HAVING and a
  JOIN's residual WHERE use them.

Grammar (case-insensitive keywords)::

    expr    := or ;  or := and (OR and)* ;  and := not (AND not)*
    not     := NOT not | primary
    primary := '(' expr ')' | TRUE | FALSE | comparison
    cmp     := operand (('='|'<>'|'!='|'<'|'<='|'>'|'>=') operand
               | IS [NOT] NULL | [NOT] IN '(' lit (',' lit)* ')'
               | [NOT] LIKE string | BETWEEN operand AND operand)
    operand := term (('+'|'-') term)* ; term := factor (('*'|'/'|'%') factor)*
    factor  := '-' factor | literal | ref | '(' operand ')'
    ref     := [`]?alias[`]? '.' [`]?name[`]? | [`]?name[`]?

Everything here is host numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np

__all__ = [
    "ExprError",
    "parse_expr",
    "parse_assignments",
    "to_predicate",
    "eval_mask",
    "eval_value",
]


class ExprError(ValueError):
    pass


# --------------------------------------------------------------------------
# tokenizer
# --------------------------------------------------------------------------

_KEYWORDS = {"and", "or", "not", "in", "is", "null", "like", "between", "true", "false"}
_OPS = ("<>", "!=", "<=", ">=", "=", "<", ">", "(", ")", ",", "+", "-", "*", "/", "%", ".")


def _tokenize(s: str) -> list[tuple[str, Any]]:
    """-> [(kind, value)]: kind in {'num','str','name','kw','op'}."""
    toks: list[tuple[str, Any]] = []
    i, n = 0, len(s)
    while i < n:
        c = s[i]
        if c.isspace():
            i += 1
            continue
        if c == "'":
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise ExprError(f"unterminated string literal at offset {i}: {s!r}")
                if s[j] == "'":
                    if j + 1 < n and s[j + 1] == "'":  # '' escape
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(s[j])
                j += 1
            toks.append(("str", "".join(buf)))
            i = j + 1
            continue
        if c == "`":
            j = s.find("`", i + 1)
            if j < 0:
                raise ExprError(f"unterminated backquote at offset {i}: {s!r}")
            toks.append(("name", s[i + 1 : j]))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and s[i + 1].isdigit()):
            j = i
            while j < n and (s[j].isdigit() or s[j] in ".eE" or (s[j] in "+-" and s[j - 1] in "eE")):
                j += 1
            text = s[i:j]
            try:
                toks.append(("num", int(text)))
            except ValueError:
                try:
                    toks.append(("num", float(text)))
                except ValueError:
                    raise ExprError(f"bad number {text!r}") from None
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (s[j].isalnum() or s[j] == "_"):
                j += 1
            word = s[i:j]
            toks.append(("kw", word.lower()) if word.lower() in _KEYWORDS else ("name", word))
            i = j
            continue
        for op in _OPS:
            if s.startswith(op, i):
                toks.append(("op", op))
                i += len(op)
                break
        else:
            raise ExprError(f"unexpected character {c!r} at offset {i} in {s!r}")
    return toks


# --------------------------------------------------------------------------
# parser -> AST tuples
#   ('lit', v) ('col', alias|None, name) ('neg', x) ('arith', op, l, r)
#   ('cmp', op, l, r) ('and', [..]) ('or', [..]) ('not', x)
#   ('isnull', operand, negated) ('in', operand, [vals], negated)
#   ('like', operand, pattern, negated) ('between', operand, lo, hi)
# --------------------------------------------------------------------------


class _Parser:
    def __init__(self, toks: list[tuple[str, Any]], src: str):
        self.toks = toks
        self.src = src
        self.i = 0

    def peek(self, k: int = 0):
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else ("eof", None)

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def expect(self, kind: str, value=None):
        t = self.next()
        if t[0] != kind or (value is not None and t[1] != value):
            raise ExprError(f"expected {value or kind} at token {self.i - 1} in {self.src!r}, got {t}")
        return t

    # boolean levels ------------------------------------------------------
    def parse_expr(self):
        node = self.parse_and()
        parts = [node]
        while self.peek() == ("kw", "or"):
            self.next()
            parts.append(self.parse_and())
        return parts[0] if len(parts) == 1 else ("or", parts)

    def parse_and(self):
        parts = [self.parse_not()]
        while self.peek() == ("kw", "and"):
            self.next()
            parts.append(self.parse_not())
        return parts[0] if len(parts) == 1 else ("and", parts)

    def parse_not(self):
        if self.peek() == ("kw", "not"):
            self.next()
            return ("not", self.parse_not())
        return self.parse_primary()

    def parse_primary(self):
        t = self.peek()
        if t == ("kw", "true"):
            self.next()
            return ("lit", True)
        if t == ("kw", "false"):
            self.next()
            return ("lit", False)
        if t == ("op", "("):
            # boolean group or parenthesized operand: backtrack on failure
            mark = self.i
            self.next()
            try:
                inner = self.parse_expr()
                self.expect("op", ")")
                if self._at_cmp_op():
                    raise ExprError("operand paren")  # '(a+b) > c': redo as operand
                return inner
            except ExprError:
                self.i = mark
        return self.parse_comparison()

    def _at_cmp_op(self) -> bool:
        t = self.peek()
        return (t[0] == "op" and t[1] in ("=", "<>", "!=", "<", "<=", ">", ">=")) or (
            t[0] == "kw" and t[1] in ("is", "in", "like", "between", "not")
        )

    def parse_comparison(self):
        left = self.parse_operand()
        t = self.peek()
        if t[0] == "op" and t[1] in ("=", "<>", "!=", "<", "<=", ">", ">="):
            self.next()
            return ("cmp", t[1], left, self.parse_operand())
        if t == ("kw", "is"):
            self.next()
            negated = False
            if self.peek() == ("kw", "not"):
                self.next()
                negated = True
            self.expect("kw", "null")
            return ("isnull", left, negated)
        negated = False
        if t == ("kw", "not"):
            self.next()
            negated = True
            t = self.peek()
        if t == ("kw", "in"):
            self.next()
            self.expect("op", "(")
            vals = [self._literal_value()]
            while self.peek() == ("op", ","):
                self.next()
                vals.append(self._literal_value())
            self.expect("op", ")")
            return ("in", left, vals, negated)
        if t == ("kw", "like"):
            self.next()
            pat = self.next()
            if pat[0] != "str":
                raise ExprError(f"LIKE needs a string pattern in {self.src!r}")
            return ("like", left, pat[1], negated)
        if t == ("kw", "between"):
            self.next()
            lo = self.parse_operand()
            self.expect("kw", "and")
            node = ("between", left, lo, self.parse_operand())
            return ("not", node) if negated else node
        if negated:
            raise ExprError(f"dangling NOT in {self.src!r}")
        # bare operand as boolean (e.g. a boolean column)
        return left

    def _literal_value(self):
        node = self.parse_operand()
        v = _const_fold(node)
        if v is _NOT_CONST:
            raise ExprError(f"IN list elements must be literals in {self.src!r}")
        return v

    # arithmetic levels ---------------------------------------------------
    def parse_operand(self):
        node = self.parse_term()
        while self.peek()[0] == "op" and self.peek()[1] in ("+", "-"):
            op = self.next()[1]
            node = ("arith", op, node, self.parse_term())
        return node

    def parse_term(self):
        node = self.parse_factor()
        while self.peek()[0] == "op" and self.peek()[1] in ("*", "/", "%"):
            op = self.next()[1]
            node = ("arith", op, node, self.parse_factor())
        return node

    def parse_factor(self):
        t = self.peek()
        if t == ("op", "-"):
            self.next()
            return ("neg", self.parse_factor())
        if t == ("op", "("):
            self.next()
            node = self.parse_operand()
            self.expect("op", ")")
            return node
        if t[0] == "num" or t[0] == "str":
            self.next()
            return ("lit", t[1])
        if t == ("kw", "null"):
            self.next()
            return ("lit", None)
        if t == ("kw", "true"):
            self.next()
            return ("lit", True)
        if t == ("kw", "false"):
            self.next()
            return ("lit", False)
        if t[0] == "name":
            self.next()
            if self.peek() == ("op", "."):
                self.next()
                name = self.expect("name")[1]
                return ("col", t[1], name)
            return ("col", None, t[1])
        raise ExprError(f"unexpected token {t} in {self.src!r}")


_NOT_CONST = object()


def _const_fold(node):
    kind = node[0]
    if kind == "lit":
        return node[1]
    if kind == "neg":
        v = _const_fold(node[1])
        return _NOT_CONST if v is _NOT_CONST else -v
    if kind == "arith":
        left, right = _const_fold(node[2]), _const_fold(node[3])
        if left is _NOT_CONST or right is _NOT_CONST:
            return _NOT_CONST
        return _APPLY[node[1]](left, right)
    return _NOT_CONST


_APPLY = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "%": lambda a, b: a % b,
}


def parse_expr(s: str):
    """WHERE-clause string -> AST."""
    p = _Parser(_tokenize(s), s)
    node = p.parse_expr()
    if p.peek()[0] != "eof":
        raise ExprError(f"trailing tokens after expression in {s!r}")
    return node


def parse_assignments(s: str) -> list[tuple[str, Any]]:
    """SET-list string 'a = expr, b = expr' -> [(col, value_ast)].
    The special string '*' returns [('*', None)] (take all source columns)."""
    if s.strip() == "*":
        return [("*", None)]
    p = _Parser(_tokenize(s), s)
    out: list[tuple[str, Any]] = []
    while True:
        tgt = p.expect("name")[1]
        if p.peek() == ("op", "."):  # optional target alias prefix
            p.next()
            tgt = p.expect("name")[1]
        p.expect("op", "=")
        out.append((tgt, p.parse_operand()))
        if p.peek() == ("op", ","):
            p.next()
            continue
        if p.peek()[0] == "eof":
            return out
        raise ExprError(f"trailing tokens in assignment list {s!r}")


# --------------------------------------------------------------------------
# lowering 1: single-table AST -> Predicate (pushdown-capable)
# --------------------------------------------------------------------------


def _col_name(node, src: str) -> str:
    if node[0] != "col":
        raise ExprError(f"expected a column reference in {src!r}")
    return node[2]


def to_predicate(node, src: str = ""):
    """AST -> the port's data.predicate Predicate. Comparisons must be `col op literal`
    (either side); arithmetic is allowed only among literals (folded)."""
    from ..data import predicate as P

    kind = node[0]
    if kind == "and":
        return P.and_(*[to_predicate(x, src) for x in node[1]])
    if kind == "or":
        return P.or_(*[to_predicate(x, src) for x in node[1]])
    if kind == "not":
        inner = node[1]
        if inner[0] == "cmp":
            flip = {"=": "<>", "<>": "=", "!=": "=", "<": ">=", "<=": ">", ">": "<=", ">=": "<"}
            return to_predicate(("cmp", flip[inner[1]], inner[2], inner[3]), src)
        if inner[0] == "isnull":
            return to_predicate(("isnull", inner[1], not inner[2]), src)
        if inner[0] == "in":
            return to_predicate(("in", inner[1], inner[2], not inner[3]), src)
        if inner[0] == "like":
            return to_predicate(("like", inner[1], inner[2], not inner[3]), src)
        if inner[0] == "not":  # double negation
            return to_predicate(inner[1], src)
        if inner[0] == "and":  # De Morgan
            return to_predicate(("or", [("not", x) for x in inner[1]]), src)
        if inner[0] == "or":
            return to_predicate(("and", [("not", x) for x in inner[1]]), src)
        if inner[0] == "between":
            # NOT (x BETWEEN lo AND hi) = x < lo OR x > hi; reuses the cmp
            # lowering (and its bounds validation)
            return to_predicate(
                ("or", [("cmp", "<", inner[1], inner[2]), ("cmp", ">", inner[1], inner[3])]),
                src,
            )
        raise ExprError(f"NOT over this construct is not supported in {src!r}")
    if kind == "cmp":
        op, left, right = node[1], node[2], node[3]
        lv, rv = _const_fold(left), _const_fold(right)
        if lv is _NOT_CONST and rv is not _NOT_CONST:
            col, lit = _col_name(left, src), rv
        elif rv is _NOT_CONST and lv is not _NOT_CONST:
            flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "=", "<>": "<>", "!=": "!="}
            col, lit, op = _col_name(right, src), lv, flip[op]
        else:
            raise ExprError(f"comparison must be column vs literal in {src!r}")
        fns = {"=": P.equal, "<>": P.not_equal, "!=": P.not_equal, "<": P.less_than,
               "<=": P.less_or_equal, ">": P.greater_than, ">=": P.greater_or_equal}
        return fns[op](col, lit)
    if kind == "isnull":
        col = _col_name(node[1], src)
        return P.is_not_null(col) if node[2] else P.is_null(col)
    if kind == "in":
        col = _col_name(node[1], src)
        return P.not_in(col, node[2]) if node[3] else P.in_(col, node[2])
    if kind == "like":
        col, pat, negated = _col_name(node[1], src), node[2], node[3]
        body = pat.strip("%")
        if "%" in body or "_" in pat:
            raise ExprError(f"only prefix/suffix/contains LIKE patterns are supported: {pat!r}")
        if pat.startswith("%") and pat.endswith("%"):
            pred = P.contains(col, body)
        elif pat.endswith("%"):
            pred = P.starts_with(col, body)
        elif pat.startswith("%"):
            pred = P.ends_with(col, body)
        else:
            pred = P.equal(col, pat)
        if negated:
            pred = pred.negate()
            if pred is None:
                raise ExprError(f"NOT LIKE cannot be expressed for {pat!r}")
        return pred
    if kind == "between":
        col = _col_name(node[1], src)
        lo, hi = _const_fold(node[2]), _const_fold(node[3])
        if lo is _NOT_CONST or hi is _NOT_CONST:
            raise ExprError(f"BETWEEN bounds must be literals in {src!r}")
        return P.between(col, lo, hi)
    if kind == "lit":
        if node[1] is True:
            return None  # TRUE -> no filter (caller treats None as match-all)
        raise ExprError(f"constant {node[1]!r} is not a usable filter in {src!r}")
    raise ExprError(f"cannot lower {kind!r} to a predicate in {src!r}")


def parse_where(s: str):
    """WHERE string -> Predicate (None for 'TRUE')."""
    return to_predicate(parse_expr(s), s)


# --------------------------------------------------------------------------
# lowering 2: two-table evaluation for MERGE INTO
# --------------------------------------------------------------------------

Resolver = Callable[[Any, str], tuple[np.ndarray, np.ndarray | None]]
"""(alias, column) -> (values, validity|None); alias None = unqualified."""


def _eval_vv(node, resolve: Resolver, n: int):
    """Value AST -> (values, valid) where valid=None means all rows known.
    Unknown rows carry garbage values (columns store sentinel fills); the
    boolean layer masks them via Kleene `known` tracking."""
    kind = node[0]
    if kind == "lit":
        if node[1] is None:
            return np.zeros(n), np.zeros(n, dtype=bool)
        return np.full(n, node[1]), None
    if kind == "col":
        return resolve(node[1], node[2])
    if kind == "neg":
        v, k = _eval_vv(node[1], resolve, n)
        return -v, k
    if kind == "arith":
        lv, lk = _eval_vv(node[2], resolve, n)
        rv, rk = _eval_vv(node[3], resolve, n)
        return _APPLY[node[1]](lv, rv), _and_valid(lk, rk)
    raise ExprError(f"cannot evaluate {kind!r} as a value")


def _and_valid(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


_CMP = {"=": lambda a, b: a == b, "<>": lambda a, b: a != b, "!=": lambda a, b: a != b,
        "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
        ">": lambda a, b: a > b, ">=": lambda a, b: a >= b}


def eval_value(node, resolve: Resolver, n: int):
    """Value AST -> ndarray of length n (literals broadcast). Rows whose
    value is unknown (NULL operands anywhere in the expression) come back as
    None — SET v = NULL writes NULL, not the storage sentinel."""
    v, k = _eval_vv(node, resolve, n)
    if k is None or k.all():
        return v
    out = np.asarray(v, dtype=object).copy()
    out[~k] = None
    return out


def _eval_tk(node, resolve: Resolver, n: int):
    """Boolean AST -> (truth, known) under SQL/Kleene three-valued logic;
    known=None means every row is known."""
    kind = node[0]
    if kind == "lit":
        if isinstance(node[1], bool):
            return np.full(n, node[1], dtype=bool), None
        raise ExprError(f"constant {node[1]!r} is not a boolean")
    if kind in ("and", "or"):
        t, k = _eval_tk(node[1][0], resolve, n)
        for x in node[1][1:]:
            t2, k2 = _eval_tk(x, resolve, n)
            if kind == "and":
                # known iff both known, or either is known-False
                nk = None if (k is None and k2 is None) else (
                    _bool(k, n) & _bool(k2, n)
                    | (_bool(k, n) & ~t)
                    | (_bool(k2, n) & ~t2)
                )
                t = t & t2
            else:
                nk = None if (k is None and k2 is None) else (
                    _bool(k, n) & _bool(k2, n)
                    | (_bool(k, n) & t)
                    | (_bool(k2, n) & t2)
                )
                t = t | t2
            k = nk
        return t, k
    if kind == "not":
        t, k = _eval_tk(node[1], resolve, n)
        return ~t, k
    if kind == "cmp":
        lv, lk = _eval_vv(node[2], resolve, n)
        rv, rk = _eval_vv(node[3], resolve, n)
        return np.asarray(_CMP[node[1]](lv, rv), dtype=bool), _and_valid(lk, rk)
    if kind == "isnull":
        # IS NULL is always KNOWN, and applies to any operand: unknownness of
        # the operand expression IS the nullness being tested
        _, lk = _eval_vv(node[1], resolve, n)
        null = ~_bool(lk, n)
        return (~null if node[2] else null), None
    if kind == "in":
        lv, lk = _eval_vv(node[1], resolve, n)
        mask = np.isin(lv, np.asarray(node[2]))
        return (~mask if node[3] else mask), lk
    if kind == "between":
        lv, lk = _eval_vv(node[1], resolve, n)
        lov, lok = _eval_vv(node[2], resolve, n)
        hiv, hik = _eval_vv(node[3], resolve, n)
        return (lv >= lov) & (lv <= hiv), _and_valid(lk, _and_valid(lok, hik))
    if kind == "like":
        lv, lk = _eval_vv(node[1], resolve, n)
        pat, negated = node[2], node[3]
        body = pat.strip("%")
        s = np.asarray(lv, dtype=object)
        if pat.startswith("%") and pat.endswith("%"):
            mask = np.array([body in (x or "") for x in s], dtype=bool)
        elif pat.endswith("%"):
            mask = np.array([(x or "").startswith(body) for x in s], dtype=bool)
        elif pat.startswith("%"):
            mask = np.array([(x or "").endswith(body) for x in s], dtype=bool)
        else:
            mask = np.asarray(s == pat, dtype=bool)
        return (~mask if negated else mask), lk
    raise ExprError(f"cannot evaluate {kind!r} as a mask")


def _bool(k, n):
    return np.ones(n, dtype=bool) if k is None else k


def eval_mask(node, resolve: Resolver, n: int) -> np.ndarray:
    """Boolean AST -> bool ndarray of length n. SQL WHERE semantics: a row
    passes only when the expression is known TRUE (UNKNOWN filters out) —
    Kleene logic carried through NOT/AND/OR, same as the predicate path."""
    t, k = _eval_tk(node, resolve, n)
    return t if k is None else (t & k)


def batch_resolver(aliases: Mapping[str, Any]) -> Resolver:
    """Resolver over named ColumnBatches: aliases maps alias -> ColumnBatch.
    Unqualified refs try each batch in insertion order (first hit wins)."""

    def resolve(alias, name):
        if alias is not None:
            b = aliases.get(alias)
            if b is None:
                raise ExprError(f"unknown table alias {alias!r} (have {sorted(aliases)})")
            c = b.column(name)
            return np.asarray(c.values), c.validity
        for b in aliases.values():
            if name in b.schema:
                c = b.column(name)
                return np.asarray(c.values), c.validity
        raise ExprError(f"unknown column {name!r}")

    return resolve
