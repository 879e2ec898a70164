"""Runtime casts: schema-evolution reads and the explicit cast matrix (port
of paimon_tpu/data/casting.py).

  can_cast / cast_column            the evolution gate: widening casts only
  can_cast_explicit / cast_explicit the full matrix of explicit casts
                                    (narrowing truncates as Java does,
                                    unparseable strings become null)

Values, null masks and dtypes are the JAX package's, with one difference:
the JAX package takes any change within one type root as a widening and
returns the column untouched. So a DECIMAL whose scale grew keeps its
unscaled values (12345 at scale 2, 123.45, reads as 1.2345 at scale 4), and
a CHAR or VARCHAR cut to a shorter length keeps its longer values. Here a
DECIMAL change must keep or grow both the scale and the integer digits and
its values are rescaled, a string change must keep or grow the length, and
anything else within one root is refused by can_cast and raises in
cast_column.

Internal value representations: DATE = int32 days since epoch, TIMESTAMP =
int64 micros, DECIMAL = unscaled int64 (scale on the type).
"""

from __future__ import annotations

import datetime

import numpy as np

from ..types import _MAX_LEN, DataType, TypeRoot
from .batch import Column

__all__ = ["cast_column", "can_cast", "cast_explicit", "can_cast_explicit", "stats_comparable"]

_NUMERIC_ORDER = [
    TypeRoot.TINYINT,
    TypeRoot.SMALLINT,
    TypeRoot.INT,
    TypeRoot.BIGINT,
    TypeRoot.FLOAT,
    TypeRoot.DOUBLE,
]
_STRINGS = (TypeRoot.CHAR, TypeRoot.VARCHAR)
_BINARIES = (TypeRoot.BINARY, TypeRoot.VARBINARY)
_TIMESTAMPS = (TypeRoot.TIMESTAMP, TypeRoot.TIMESTAMP_LTZ)
_US_PER_DAY = 86_400_000_000


def _length(t: DataType) -> int:
    return _MAX_LEN if t.length is None else t.length


def _widens_within_root(src: DataType, dst: DataType) -> bool:
    """A change within one root keeps every value's meaning: a DECIMAL
    keeps or grows its scale and its integer digits, a string its length."""
    if src.root == TypeRoot.DECIMAL:
        s_scale, d_scale = src.scale or 0, dst.scale or 0
        s_int, d_int = (src.precision or 18) - s_scale, (dst.precision or 18) - d_scale
        return d_scale >= s_scale and d_int >= s_int
    if src.root in _STRINGS:
        return _length(dst) >= _length(src)
    return True


def can_cast(src: DataType, dst: DataType) -> bool:
    """Only *widening* casts are allowed: schema evolution must never wrap
    or truncate stored data, nor change what a stored DECIMAL means."""
    if src.root == dst.root:
        return _widens_within_root(src, dst)
    if src.root in _STRINGS and dst.root in _STRINGS:
        return _length(dst) >= _length(src)
    if src.root in _NUMERIC_ORDER and dst.root in _NUMERIC_ORDER:
        return _NUMERIC_ORDER.index(src.root) < _NUMERIC_ORDER.index(dst.root)
    if dst.root in _STRINGS:
        return True  # anything can render to string
    if src.root == TypeRoot.DATE and dst.root in _TIMESTAMPS:
        return True
    return False


def stats_comparable(src: DataType, dst: DataType) -> bool:
    """Whether statistics a file wrote under `src` bound the values cast to
    `dst` exactly: the same root (a DECIMAL at the same scale), an integer
    widened to a wider integer, or FLOAT to DOUBLE."""
    if src.root == dst.root:
        return src.root != TypeRoot.DECIMAL or (src.scale or 0) == (dst.scale or 0)
    if src.root in _NUMERIC_ORDER[:4] and dst.root in _NUMERIC_ORDER[:4]:
        return True
    return src.root == TypeRoot.FLOAT and dst.root == TypeRoot.DOUBLE


def can_cast_explicit(src: DataType, dst: DataType) -> bool:
    """The full CastExecutors matrix."""
    s, d = src.root, dst.root
    if s == d or (s in _STRINGS and d in _STRINGS):
        return True  # a shorter string truncates, as Java's cast does
    if can_cast(src, dst):
        return True
    numericish = set(_NUMERIC_ORDER) | {TypeRoot.DECIMAL}
    if s in numericish and d in numericish:
        return True
    if s == TypeRoot.BOOLEAN and (d in numericish or d in _STRINGS):
        return True
    if d == TypeRoot.BOOLEAN and (s in numericish or s in _STRINGS):
        return True
    if s in _STRINGS and (
        d in numericish or d in _BINARIES or d == TypeRoot.DATE or d in _TIMESTAMPS
    ):
        return True
    if s in _BINARIES and d in _STRINGS:
        return True
    if s in _TIMESTAMPS and (d == TypeRoot.DATE or d in _TIMESTAMPS or d in _STRINGS):
        return True
    if s == TypeRoot.DATE and (d in _TIMESTAMPS or d in _STRINGS):
        return True
    return False


def cast_column(col: Column, src: DataType, dst: DataType) -> Column:
    """Evolution cast (widening only): a DECIMAL whose scale grew is
    rescaled; a narrowing raises ValueError."""
    if not can_cast(src, dst):
        raise ValueError(f"cannot cast {src.serialize()} -> {dst.serialize()}: not a widening")
    if src.root == dst.root:
        if src.root == TypeRoot.DECIMAL and (src.scale or 0) != (dst.scale or 0):
            return Column(_rescale(col.values.astype(np.int64), src.scale or 0, dst.scale or 0), col.validity)
        return col
    return _cast(col, src, dst)


def cast_explicit(col: Column, src: DataType, dst: DataType) -> Column:
    """Explicit cast with the full matrix (Java truncation semantics for
    narrowing; unparseable strings become null)."""
    if src.root == dst.root and src.root != TypeRoot.DECIMAL:
        if src.root in _STRINGS and _bounded_string(dst):
            return _string_to_string(col, dst)
        return col
    if not can_cast_explicit(src, dst):
        raise ValueError(f"cannot cast {src.root} -> {dst.root}")
    return _cast(col, src, dst)


def _cast(col: Column, src: DataType, dst: DataType) -> Column:
    s, d = src.root, dst.root
    v, validity = col.values, col.validity

    if d in _STRINGS:
        return _to_string(col, src, dst)
    if s in _STRINGS:
        return _from_string(col, src, dst)
    if s == TypeRoot.BOOLEAN and d in _NUMERIC_ORDER:
        return Column(v.astype(dst.numpy_dtype()), validity)
    if d == TypeRoot.BOOLEAN:
        return Column(v != 0, validity)
    if s == TypeRoot.DATE and d in _TIMESTAMPS:
        return Column(v.astype(np.int64) * _US_PER_DAY, validity)
    if s in _TIMESTAMPS and d == TypeRoot.DATE:
        return Column(np.floor_divide(v.astype(np.int64), _US_PER_DAY).astype(np.int32), validity)
    if s in _TIMESTAMPS and d in _TIMESTAMPS:
        return Column(v.astype(np.int64), validity)
    if s == TypeRoot.DECIMAL and d == TypeRoot.DECIMAL:
        return Column(_rescale(v.astype(np.int64), src.scale or 0, dst.scale or 0), validity)
    if s == TypeRoot.DECIMAL and d in _NUMERIC_ORDER:
        scale = src.scale or 0
        if dst.numpy_dtype().kind == "f":
            return Column((v.astype(np.float64) / 10**scale).astype(dst.numpy_dtype()), validity)
        u = v.astype(np.int64)
        # truncate toward zero like Java's BigDecimal narrowing (-1.5 -> -1)
        q = np.where(u < 0, -((-u) // 10**scale), u // 10**scale)
        return Column(q.astype(dst.numpy_dtype()), validity)
    if s in _NUMERIC_ORDER and d == TypeRoot.DECIMAL:
        scale = dst.scale or 0
        if v.dtype.kind == "f":
            scaled = v.astype(np.float64) * 10**scale
            # HALF_UP (away from zero), matching _rescale and the string path
            return Column((np.sign(scaled) * np.floor(np.abs(scaled) + 0.5)).astype(np.int64), validity)
        return Column(v.astype(np.int64) * 10**scale, validity)
    if s == TypeRoot.BOOLEAN and d == TypeRoot.DECIMAL:
        return Column(v.astype(np.int64) * 10 ** (dst.scale or 0), validity)
    if s in _BINARIES and d in _BINARIES:
        return col
    # numeric <-> numeric: any direction, Java truncation via astype
    return Column(v.astype(dst.numpy_dtype()), validity)


def _rescale(unscaled: np.ndarray, s_from: int, s_to: int) -> np.ndarray:
    if s_to == s_from:
        return unscaled
    if s_to > s_from:
        return unscaled * 10 ** (s_to - s_from)
    div = 10 ** (s_from - s_to)
    # round half away from zero like BigDecimal.setScale(HALF_UP)
    q, r = np.divmod(np.abs(unscaled), div)
    q = q + (2 * r >= div)
    return np.where(unscaled < 0, -q, q)


def _to_string(col: Column, src: DataType, dst: DataType) -> Column:
    v = col.values
    valid = col.valid_mask()
    out = np.empty(len(v), dtype=object)
    s = src.root
    for i in range(len(v)):
        if not valid[i]:
            out[i] = None
        elif s == TypeRoot.BOOLEAN:
            out[i] = "true" if v[i] else "false"
        elif s == TypeRoot.DATE:
            out[i] = (datetime.date(1970, 1, 1) + datetime.timedelta(days=int(v[i]))).isoformat()
        elif s in _TIMESTAMPS:
            dt = datetime.datetime(1970, 1, 1) + datetime.timedelta(microseconds=int(v[i]))
            out[i] = dt.isoformat(sep=" ")
        elif s == TypeRoot.DECIMAL:
            scale = src.scale or 0
            x = int(v[i])
            if scale == 0:
                out[i] = str(x)
            else:
                sign = "-" if x < 0 else ""
                x = abs(x)
                out[i] = f"{sign}{x // 10**scale}.{x % 10**scale:0{scale}d}"
        elif s in _BINARIES:
            out[i] = bytes(v[i]).decode("utf-8", "replace")
        else:
            out[i] = str(v[i])
    c = Column(out, col.validity)
    if _bounded_string(dst):
        return _string_to_string(c, dst)
    return c


def _bounded_string(dst: DataType) -> bool:
    return dst.root in _STRINGS and dst.length is not None and dst.length < _MAX_LEN


def _string_to_string(col: Column, dst: DataType) -> Column:
    """CHAR(n)/VARCHAR(n): truncate over-length values (reference
    StringToStringCastRule)."""
    n = dst.length
    v = col.values
    out = np.empty(len(v), dtype=object)
    for i in range(len(v)):
        x = v[i]
        out[i] = x[:n] if isinstance(x, str) and len(x) > n else x
    return Column(out, col.validity)


def _from_string(col: Column, src: DataType, dst: DataType) -> Column:
    v = col.values
    valid = col.valid_mask().copy()
    d = dst.root
    if d in _BINARIES:
        out = np.empty(len(v), dtype=object)
        for i in range(len(v)):
            out[i] = v[i].encode("utf-8") if valid[i] else None
        return Column(out, col.validity)
    if d == TypeRoot.BOOLEAN:
        out = np.zeros(len(v), dtype=np.bool_)
        truthy = {"true", "t", "yes", "y", "1"}
        falsy = {"false", "f", "no", "n", "0"}
        for i in range(len(v)):
            if valid[i]:
                t = str(v[i]).strip().lower()
                if t in truthy:
                    out[i] = True
                elif t in falsy:
                    out[i] = False
                else:
                    valid[i] = False
        return Column(out, valid if not valid.all() else None)
    if d == TypeRoot.DATE:
        out = np.zeros(len(v), dtype=np.int32)
        epoch = datetime.date(1970, 1, 1)
        for i in range(len(v)):
            if valid[i]:
                try:
                    out[i] = (datetime.date.fromisoformat(str(v[i]).strip()) - epoch).days
                except ValueError:
                    valid[i] = False
        return Column(out, valid if not valid.all() else None)
    if d in _TIMESTAMPS:
        out = np.zeros(len(v), dtype=np.int64)
        epoch = datetime.datetime(1970, 1, 1)
        for i in range(len(v)):
            if valid[i]:
                try:
                    t = str(v[i]).strip().replace("T", " ")
                    dt = datetime.datetime.fromisoformat(t)
                    out[i] = int((dt - epoch).total_seconds() * 1_000_000)
                except ValueError:
                    valid[i] = False
        return Column(out, valid if not valid.all() else None)
    if d == TypeRoot.DECIMAL:
        scale = dst.scale or 0
        out = np.zeros(len(v), dtype=np.int64)
        from decimal import ROUND_HALF_UP, Decimal, InvalidOperation

        for i in range(len(v)):
            if valid[i]:
                try:
                    out[i] = int(Decimal(str(v[i]).strip()).scaleb(scale).to_integral_value(rounding=ROUND_HALF_UP))
                except (InvalidOperation, ValueError, OverflowError):
                    valid[i] = False
        return Column(out, valid if not valid.all() else None)
    # string -> numeric
    tgt = dst.numpy_dtype()
    out = np.zeros(len(v), dtype=tgt)
    for i in range(len(v)):
        if valid[i]:
            try:
                if tgt.kind == "f":
                    out[i] = tgt.type(float(v[i]))
                else:
                    s = str(v[i]).strip()
                    # exact integer parse first: int-via-float corrupts
                    # values past 2^53
                    try:
                        out[i] = tgt.type(int(s))
                    except ValueError:
                        out[i] = tgt.type(int(float(s)))
            except (TypeError, ValueError, OverflowError):
                valid[i] = False
    return Column(out, valid if not valid.all() else None)
