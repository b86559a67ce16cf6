"""SQL type system mapped onto torch dtypes.

Reference parity: core/trino-spi/src/main/java/io/trino/spi/type/ (81 files) —
Type.java:29 defines the contract (fixed-size, comparable/orderable flags,
block accessors). Here each SQL type maps to a torch dtype plus a *physical
layout* describing how values live on device:

- numeric/date/time types  -> one device array of the listed dtype
- VARCHAR/CHAR             -> dictionary encoding: int32 code array on device
                              + host-side sorted string dictionary (so that
                              code order == collation order, making device-side
                              <, >, ORDER BY, min/max correct on codes)
- DECIMAL(p<=18, s)        -> scaled int64 ("short decimal",
                              spi/type/DecimalType.java short path)
- DECIMAL(p>18)            -> round 1: unsupported (reference Int128 long
                              decimals; planned as dual-int64 limbs)

All types are null-aware: nullability is carried by the Column validity mask
(see page.py), not the dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Type:
    """Base SQL type. Reference: spi/type/Type.java:29."""

    name: ClassVar[str] = "unknown"

    @property
    def dtype(self) -> Any:
        raise NotImplementedError

    @property
    def comparable(self) -> bool:
        return True

    @property
    def orderable(self) -> bool:
        return True

    def display(self) -> str:
        return self.name

    def __str__(self) -> str:  # pragma: no cover - debug aid
        return self.display()


@dataclasses.dataclass(frozen=True)
class BooleanType(Type):
    name: ClassVar[str] = "boolean"

    @property
    def dtype(self):
        return torch.bool


@dataclasses.dataclass(frozen=True)
class TinyintType(Type):
    name: ClassVar[str] = "tinyint"

    @property
    def dtype(self):
        return torch.int8


@dataclasses.dataclass(frozen=True)
class SmallintType(Type):
    name: ClassVar[str] = "smallint"

    @property
    def dtype(self):
        return torch.int16


@dataclasses.dataclass(frozen=True)
class IntegerType(Type):
    name: ClassVar[str] = "integer"

    @property
    def dtype(self):
        return torch.int32


@dataclasses.dataclass(frozen=True)
class BigintType(Type):
    name: ClassVar[str] = "bigint"

    @property
    def dtype(self):
        return torch.int64


@dataclasses.dataclass(frozen=True)
class DoubleType(Type):
    name: ClassVar[str] = "double"

    @property
    def dtype(self):
        return torch.float64


@dataclasses.dataclass(frozen=True)
class RealType(Type):
    name: ClassVar[str] = "real"

    @property
    def dtype(self):
        return torch.float32


@dataclasses.dataclass(frozen=True)
class DateType(Type):
    """Days since 1970-01-01, like spi/type/DateType.java (int32 days)."""

    name: ClassVar[str] = "date"

    @property
    def dtype(self):
        return torch.int32


@dataclasses.dataclass(frozen=True)
class TimestampType(Type):
    """Microseconds since epoch as int64.

    The reference supports picosecond precision (spi/type/TimestampType.java,
    LongTimestamp). Round 1 carries microseconds (precision<=6) in one int64;
    pico precision is a planned dual-limb extension.
    """

    name: ClassVar[str] = "timestamp"
    precision: int = 3

    @property
    def dtype(self):
        return torch.int64

    def display(self) -> str:
        return f"timestamp({self.precision})"


@dataclasses.dataclass(frozen=True)
class DecimalType(Type):
    """Fixed-point decimal as scaled int64 (short decimal path).

    Reference: spi/type/DecimalType.java + Decimals.java. precision<=18 fits
    the Java "short decimal" (single long) representation we mirror.
    """

    name: ClassVar[str] = "decimal"
    precision: int = 18
    scale: int = 0

    def __post_init__(self):
        # Long decimals (precision 19-38 in Trino) need the int128 two-limb
        # path; fail loudly rather than silently wrapping in int64. Planner
        # code that derives result types clamps with min(p, 18) explicitly
        # (sql/analyzer.arithmetic_type), accepting Java-long-overflow
        # semantics there; a user-declared decimal(>18) is rejected here.
        if self.precision > 18:
            raise NotImplementedError(
                "long decimals (precision>18) not supported yet")

    @property
    def dtype(self):
        return torch.int64

    def display(self) -> str:
        return f"decimal({self.precision},{self.scale})"


@dataclasses.dataclass(frozen=True)
class VarcharType(Type):
    """Variable-width string, dictionary-encoded on device.

    Reference: spi/type/VarcharType.java. Device representation is an int32
    code per row; the dictionary (host numpy array of python str, sorted) lives
    on the Column. length is a bound like varchar(n); None = unbounded.
    """

    name: ClassVar[str] = "varchar"
    length: Optional[int] = None

    @property
    def dtype(self):
        return torch.int32

    def display(self) -> str:
        return "varchar" if self.length is None else f"varchar({self.length})"


@dataclasses.dataclass(frozen=True)
class CharType(Type):
    name: ClassVar[str] = "char"
    length: int = 1

    @property
    def dtype(self):
        return torch.int32

    def display(self) -> str:
        return f"char({self.length})"


@dataclasses.dataclass(frozen=True)
class UnknownType(Type):
    """Type of NULL literals before coercion (spi/type/UnknownType analog)."""

    name: ClassVar[str] = "unknown"

    @property
    def dtype(self):
        return torch.bool


@dataclasses.dataclass(frozen=True)
class IntervalDayTimeType(Type):
    """Interval day-to-second as microseconds (int64)."""

    name: ClassVar[str] = "interval day to second"

    @property
    def dtype(self):
        return torch.int64


@dataclasses.dataclass(frozen=True)
class IntervalYearMonthType(Type):
    """Interval year-to-month as months (int32)."""

    name: ClassVar[str] = "interval year to month"

    @property
    def dtype(self):
        return torch.int32


# Singletons, mirroring the reference's static INSTANCE fields.
BOOLEAN = BooleanType()
TINYINT = TinyintType()
SMALLINT = SmallintType()
INTEGER = IntegerType()
BIGINT = BigintType()
DOUBLE = DoubleType()
REAL = RealType()
DATE = DateType()
TIMESTAMP = TimestampType()
VARCHAR = VarcharType()
UNKNOWN = UnknownType()
INTERVAL_DAY_TIME = IntervalDayTimeType()
INTERVAL_YEAR_MONTH = IntervalYearMonthType()


_INTEGRAL = (TinyintType, SmallintType, IntegerType, BigintType)
_NUMERIC = _INTEGRAL + (DoubleType, RealType, DecimalType)


def is_integral(t: Type) -> bool:
    return isinstance(t, _INTEGRAL)


def is_numeric(t: Type) -> bool:
    return isinstance(t, _NUMERIC)


def is_string(t: Type) -> bool:
    return isinstance(t, (VarcharType, CharType))


def is_dictionary_encoded(t: Type) -> bool:
    return is_string(t)


_INT_WIDTH = {TinyintType: 8, SmallintType: 16, IntegerType: 32, BigintType: 64}


def common_super_type(a: Type, b: Type) -> Optional[Type]:
    """Implicit coercion lattice.

    Reference: sql/analyzer/TypeCoercion.java (core/trino-main). Covers the
    numeric ladder, date/timestamp, varchar widening, and NULL (unknown).
    """
    if a == b:
        return a
    if isinstance(a, UnknownType):
        return b
    if isinstance(b, UnknownType):
        return a
    # numeric ladder: tinyint < smallint < integer < bigint < (decimal) < real < double
    if is_numeric(a) and is_numeric(b):
        if isinstance(a, DoubleType) or isinstance(b, DoubleType):
            return DOUBLE
        if isinstance(a, RealType) or isinstance(b, RealType):
            # decimal/bigint with real -> double keeps precision closer to Java
            if isinstance(a, (DecimalType, BigintType)) or isinstance(
                    b, (DecimalType, BigintType)):
                return DOUBLE
            return REAL
        if isinstance(a, DecimalType) and isinstance(b, DecimalType):
            scale = max(a.scale, b.scale)
            intd = max(a.precision - a.scale, b.precision - b.scale)
            # clamp at the short-decimal limit (same Java-long-overflow
            # acceptance as sql/analyzer.arithmetic_type; a long-decimal
            # two-limb path would lift this)
            return DecimalType(precision=min(intd + scale, 18), scale=scale)
        if isinstance(a, DecimalType) or isinstance(b, DecimalType):
            dec = a if isinstance(a, DecimalType) else b
            other = b if isinstance(a, DecimalType) else a
            width = _INT_WIDTH[type(other)]
            intd = {8: 3, 16: 5, 32: 10, 64: 19}[width]
            prec = max(dec.precision - dec.scale, intd) + dec.scale
            if prec > 18 and isinstance(other, BigintType):
                # bigint+decimal as double keeps queries runnable in round 1
                return DOUBLE
            return DecimalType(precision=prec, scale=dec.scale)
        wa, wb = _INT_WIDTH[type(a)], _INT_WIDTH[type(b)]
        return a if wa >= wb else b
    if isinstance(a, TimestampType) and isinstance(b, TimestampType):
        return a if a.precision >= b.precision else b
    if isinstance(a, DateType) and isinstance(b, TimestampType):
        return b
    if isinstance(a, TimestampType) and isinstance(b, DateType):
        return a
    if isinstance(a, VarcharType) and isinstance(b, VarcharType):
        if a.length is None or b.length is None:
            return VARCHAR
        return VarcharType(length=max(a.length, b.length))
    if is_string(a) and is_string(b):
        return VARCHAR
    return None


@dataclasses.dataclass(frozen=True)
class ArrayType(Type):
    """ARRAY(element) with a TPU-first list layout: a Column carries
    values [capacity, max_len] + per-row lengths (the reference's
    ArrayBlock offsets+flattened-values, re-cut for static shapes —
    spi/block/ArrayBlock.java, spi/type/ArrayType.java). Element NULLs
    are not represented (documented deviation; aggregation skips NULL
    inputs, constructors take non-null elements)."""

    name: ClassVar[str] = "array"
    element: Type = None  # type: ignore[assignment]

    @property
    def dtype(self):
        return self.element.dtype

    @property
    def comparable(self) -> bool:
        return False

    @property
    def orderable(self) -> bool:
        return False

    def display(self) -> str:
        return f"array({self.element.display()})"


@dataclasses.dataclass(frozen=True)
class MapType(Type):
    """MAP(key, value): list layout of keys in Column.values plus a
    companion per-element value plane (Column.aux). Reference:
    spi/type/MapType.java / MapBlock.java."""

    name: ClassVar[str] = "map"
    key: Type = None    # type: ignore[assignment]
    value: Type = None  # type: ignore[assignment]

    @property
    def dtype(self):
        return self.key.dtype

    @property
    def comparable(self) -> bool:
        return False

    @property
    def orderable(self) -> bool:
        return False

    def display(self) -> str:
        return f"map({self.key.display()}, {self.value.display()})"


def parse_type(text: str) -> Type:
    """Parse a SQL type name (analog of spi/type/TypeSignature parsing)."""
    s = text.strip().lower()
    simple = {
        "boolean": BOOLEAN, "tinyint": TINYINT, "smallint": SMALLINT,
        "integer": INTEGER, "int": INTEGER, "bigint": BIGINT,
        "double": DOUBLE, "double precision": DOUBLE, "real": REAL,
        "float": REAL, "date": DATE, "varchar": VARCHAR, "string": VARCHAR,
        "timestamp": TIMESTAMP, "unknown": UNKNOWN,
        "interval day to second": INTERVAL_DAY_TIME,
        "interval year to month": INTERVAL_YEAR_MONTH,
    }
    if s in simple:
        return simple[s]
    if s.startswith("decimal"):
        if "(" not in s:
            return DecimalType(precision=18, scale=0)
        inner = s[s.index("(") + 1:s.rindex(")")]
        parts = [p.strip() for p in inner.split(",")]
        prec = int(parts[0])
        scale = int(parts[1]) if len(parts) > 1 else 0
        # declared long decimals (p>18, e.g. TPC-DS CAST(.. AS
        # DECIMAL(38,3))) clamp to the short-decimal limit — the same
        # Java-long-overflow acceptance as arithmetic_type/common_type
        prec = min(prec, 18)
        return DecimalType(precision=prec, scale=min(scale, prec))
    if s.startswith("array(") and s.endswith(")"):
        return ArrayType(element=parse_type(s[6:-1]))
    if s.startswith("map(") and s.endswith(")"):
        inner = s[4:-1]
        depth = 0
        for i, ch in enumerate(inner):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
            elif ch == "," and depth == 0:
                return MapType(key=parse_type(inner[:i]),
                               value=parse_type(inner[i + 1:]))
    if s == "char":
        return CharType(length=1)
    if s.startswith("varchar("):
        return VarcharType(length=int(s[8:-1]))
    if s.startswith("char("):
        return CharType(length=int(s[5:-1]))
    if s.startswith("timestamp("):
        return TimestampType(precision=int(s[10:-1]))
    raise ValueError(f"unknown type: {text}")


_NUMPY_OF = {
    torch.bool: np.dtype(np.bool_), torch.int8: np.dtype(np.int8),
    torch.int16: np.dtype(np.int16), torch.int32: np.dtype(np.int32),
    torch.int64: np.dtype(np.int64), torch.float32: np.dtype(np.float32),
    torch.float64: np.dtype(np.float64),
}


def numpy_dtype_of(dtype: torch.dtype) -> np.dtype:
    return _NUMPY_OF[dtype]


def to_numpy_dtype(t: Type) -> np.dtype:
    return _NUMPY_OF[t.dtype]
