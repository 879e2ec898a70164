"""SQL-style types with field-id based schemas (port of paimon_tpu/types.py).

The flat types: the fixed-width roots stored as dense numpy vectors
(DATE as int32 days, TIMESTAMP as int64 micros, DECIMAL as its unscaled
int64), the string and bytes roots as object vectors, and RowKind. Type
strings serialize exactly as the JAX package writes them into the schema
JSON ("BIGINT NOT NULL", "STRING", ...), so each package reads the other's
warehouse.
"""

from __future__ import annotations

import enum
import re
from dataclasses import dataclass, replace
from typing import Any, Iterable

import numpy as np

__all__ = [
    "TypeRoot",
    "DataType",
    "DataField",
    "RowType",
    "RowKind",
    "TINYINT",
    "SMALLINT",
    "INT",
    "BIGINT",
    "FLOAT",
    "DOUBLE",
    "BOOLEAN",
    "CHAR",
    "VARCHAR",
    "STRING",
    "BYTES",
    "DATE",
    "TIME",
    "TIMESTAMP",
    "DECIMAL",
    "parse_type",
]


class TypeRoot(str, enum.Enum):
    BOOLEAN = "BOOLEAN"
    TINYINT = "TINYINT"
    SMALLINT = "SMALLINT"
    INT = "INT"
    BIGINT = "BIGINT"
    FLOAT = "FLOAT"
    DOUBLE = "DOUBLE"
    DECIMAL = "DECIMAL"
    CHAR = "CHAR"
    VARCHAR = "VARCHAR"
    BINARY = "BINARY"
    VARBINARY = "VARBINARY"
    DATE = "DATE"
    TIME = "TIME"
    TIMESTAMP = "TIMESTAMP"
    TIMESTAMP_LTZ = "TIMESTAMP_LTZ"
    ARRAY = "ARRAY"
    MAP = "MAP"
    ROW = "ROW"


STRING_ROOTS = (TypeRoot.CHAR, TypeRoot.VARCHAR, TypeRoot.BINARY, TypeRoot.VARBINARY)

_FIXED_NUMPY = {
    TypeRoot.BOOLEAN: np.dtype(np.bool_),
    TypeRoot.TINYINT: np.dtype(np.int8),
    TypeRoot.SMALLINT: np.dtype(np.int16),
    TypeRoot.INT: np.dtype(np.int32),
    TypeRoot.BIGINT: np.dtype(np.int64),
    TypeRoot.FLOAT: np.dtype(np.float32),
    TypeRoot.DOUBLE: np.dtype(np.float64),
    TypeRoot.DATE: np.dtype(np.int32),
    TypeRoot.TIME: np.dtype(np.int32),
    TypeRoot.TIMESTAMP: np.dtype(np.int64),
    TypeRoot.TIMESTAMP_LTZ: np.dtype(np.int64),
    TypeRoot.DECIMAL: np.dtype(np.int64),
}

_MAX_LEN = 2147483647


@dataclass(frozen=True)
class DataType:
    root: TypeRoot
    nullable: bool = True
    length: int | None = None
    precision: int | None = None
    scale: int | None = None

    def numpy_dtype(self) -> np.dtype:
        """Host dtype; variable-width types are object vectors."""
        return _FIXED_NUMPY.get(self.root, np.dtype(object))

    def with_nullable(self, nullable: bool) -> "DataType":
        return replace(self, nullable=nullable)

    def serialize(self) -> Any:
        r = self.root
        if r in STRING_ROOTS:
            if self.length is None or self.length == _MAX_LEN:
                base = {"VARCHAR": "STRING", "VARBINARY": "BYTES"}.get(r.value, f"{r.value}({_MAX_LEN})")
            else:
                base = f"{r.value}({self.length})"
        elif r == TypeRoot.DECIMAL:
            base = f"DECIMAL({self.precision or 18},{self.scale or 0})"
        elif r in (TypeRoot.TIMESTAMP, TypeRoot.TIMESTAMP_LTZ):
            base = f"{r.value}({6 if self.precision is None else self.precision})"
        else:
            base = r.value
        return base if self.nullable else base + " NOT NULL"

    def __str__(self) -> str:
        return self.serialize()


def TINYINT(nullable: bool = True) -> DataType:
    return DataType(TypeRoot.TINYINT, nullable)


def SMALLINT(nullable: bool = True) -> DataType:
    return DataType(TypeRoot.SMALLINT, nullable)


def INT(nullable: bool = True) -> DataType:
    return DataType(TypeRoot.INT, nullable)


def BIGINT(nullable: bool = True) -> DataType:
    return DataType(TypeRoot.BIGINT, nullable)


def FLOAT(nullable: bool = True) -> DataType:
    return DataType(TypeRoot.FLOAT, nullable)


def DOUBLE(nullable: bool = True) -> DataType:
    return DataType(TypeRoot.DOUBLE, nullable)


def BOOLEAN(nullable: bool = True) -> DataType:
    return DataType(TypeRoot.BOOLEAN, nullable)


def CHAR(length: int, nullable: bool = True) -> DataType:
    return DataType(TypeRoot.CHAR, nullable, length=length)


def VARCHAR(length: int, nullable: bool = True) -> DataType:
    return DataType(TypeRoot.VARCHAR, nullable, length=length)


def STRING(nullable: bool = True) -> DataType:
    return DataType(TypeRoot.VARCHAR, nullable, length=_MAX_LEN)


def BYTES(nullable: bool = True) -> DataType:
    return DataType(TypeRoot.VARBINARY, nullable, length=_MAX_LEN)


def DATE(nullable: bool = True) -> DataType:
    return DataType(TypeRoot.DATE, nullable)


def TIME(nullable: bool = True) -> DataType:
    return DataType(TypeRoot.TIME, nullable)


def TIMESTAMP(precision: int = 6, nullable: bool = True) -> DataType:
    return DataType(TypeRoot.TIMESTAMP, nullable, precision=precision)


def DECIMAL(precision: int = 18, scale: int = 0, nullable: bool = True) -> DataType:
    """An unscaled int64 with its scale on the type, as the JAX package
    stores it: precision up to 18."""
    if precision > 18:
        raise ValueError("DECIMAL precision above 18 does not fit the unscaled int64")
    return DataType(TypeRoot.DECIMAL, nullable, precision=precision, scale=scale)


_TYPE_RE = re.compile(r"^([A-Z_]+)(?:\((\d+)(?:,\s*(\d+))?\))?( NOT NULL)?$")


def parse_type(s: Any) -> DataType:
    """Inverse of DataType.serialize() for the flat types of this slice;
    nested types raise NotImplementedError."""
    if isinstance(s, dict):
        raise NotImplementedError(f"nested type {s.get('type')!r} is not supported by the torch port yet")
    m = _TYPE_RE.match(s.strip())
    if not m:
        raise ValueError(f"cannot parse type {s!r}")
    name, p1, p2, notnull = m.groups()
    nullable = notnull is None
    if name == "STRING":
        return STRING(nullable)
    if name == "BYTES":
        return BYTES(nullable)
    root = TypeRoot(name)
    if root in STRING_ROOTS:
        return DataType(root, nullable, length=int(p1) if p1 else _MAX_LEN)
    if root == TypeRoot.DECIMAL:
        return DataType(root, nullable, precision=int(p1 or 18), scale=int(p2 or 0))
    if root in (TypeRoot.TIMESTAMP, TypeRoot.TIMESTAMP_LTZ):
        return DataType(root, nullable, precision=int(p1) if p1 else 6)
    return DataType(root, nullable)


@dataclass(frozen=True)
class DataField:
    id: int
    name: str
    type: DataType
    description: str | None = None

    def to_dict(self) -> dict:
        d = {"id": self.id, "name": self.name, "type": self.type.serialize()}
        if self.description:
            d["description"] = self.description
        return d

    @staticmethod
    def from_dict(d: dict) -> "DataField":
        return DataField(d["id"], d["name"], parse_type(d["type"]), d.get("description"))


class RowType:
    """An ordered tuple of DataFields: the schema of every batch."""

    def __init__(self, fields: Iterable[DataField]):
        self.fields = tuple(fields)
        names = [f.name for f in self.fields]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate field names in {names}")
        self._index = {f.name: i for i, f in enumerate(self.fields)}

    @staticmethod
    def of(*spec: tuple[str, DataType]) -> "RowType":
        """RowType.of(("k", INT()), ("v", STRING())) with ids 0..n-1."""
        return RowType([DataField(i, n, t) for i, (n, t) in enumerate(spec)])

    @property
    def field_names(self) -> list[str]:
        return [f.name for f in self.fields]

    def field(self, name: str) -> DataField:
        return self.fields[self._index[name]]

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def project(self, names: Iterable[str]) -> "RowType":
        return RowType([self.field(n) for n in names])

    def __eq__(self, other: object) -> bool:
        return isinstance(other, RowType) and self.fields == other.fields

    def __hash__(self) -> int:
        return hash(self.fields)

    def __repr__(self) -> str:
        return f"RowType({[(f.name, f.type.serialize()) for f in self.fields]})"


class RowKind(enum.IntEnum):
    """Changelog row kinds, stored as uint8 (+I, -U, +U, -D)."""

    INSERT = 0
    UPDATE_BEFORE = 1
    UPDATE_AFTER = 2
    DELETE = 3

    @property
    def short_string(self) -> str:
        return ("+I", "-U", "+U", "-D")[int(self)]

    @staticmethod
    def from_short_string(s: str) -> "RowKind":
        return {"+I": RowKind.INSERT, "-U": RowKind.UPDATE_BEFORE, "+U": RowKind.UPDATE_AFTER, "-D": RowKind.DELETE}[s]
