"""Expression typing, coercion, and function resolution rules.

Reference parity: core/trino-main sql/analyzer/ExpressionAnalyzer.java (2,795
LoC) + TypeCoercion.java + metadata/FunctionRegistry.java:372. The planner
calls into these rules while translating AST expressions; keeping them here
mirrors the reference's analyzer/planner split without the Analysis side-table
machinery (we type during translation instead).

Decimal result types follow Trino's DecimalOperators:
  add/sub:  scale max(s1,s2), precision max(p1-s1,p2-s2)+scale+1
  multiply: precision p1+p2, scale s1+s2
  divide:   precision p1+s2+max(0,s2-s1), scale max(s1,s2)
(precision clamps to 18 — short-decimal int64 path, types.DecimalType).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from trino_tpu_torch import types as T
from trino_tpu_torch.errors import GENERIC_USER_ERROR, TrinoError


class SemanticError(TrinoError):
    """Analysis-time user error: never retryable (re-running the same
    statement re-fails the same way — the FTE non-retryable class)."""

    CODE = GENERIC_USER_ERROR


@dataclasses.dataclass(frozen=True)
class ResolvedFunction:
    """Outcome of function resolution: registry name + types."""

    name: str                      # canonical registry/compiler name
    arg_types: Tuple[T.Type, ...]  # post-coercion argument types
    return_type: T.Type


AGGREGATE_NAMES = frozenset({
    "count", "sum", "avg", "min", "max", "count_if", "bool_and", "bool_or",
    "every", "arbitrary", "any_value", "stddev", "stddev_pop", "stddev_samp",
    "variance", "var_pop", "var_samp", "approx_distinct", "corr", "covar_pop",
    "covar_samp", "regr_slope", "regr_intercept", "checksum", "geometric_mean",
    "min_by", "max_by", "approx_percentile", "array_agg", "histogram",
    "map_agg",
})

WINDOW_NAMES = frozenset({
    "row_number", "rank", "dense_rank", "percent_rank", "cume_dist", "ntile",
    "lag", "lead", "first_value", "last_value", "nth_value",
})


def is_aggregate(name: str) -> bool:
    return name.lower() in AGGREGATE_NAMES


def is_window(name: str) -> bool:
    return name.lower() in WINDOW_NAMES


# --------------------------------------------------------------- coercion

def can_coerce(src: T.Type, dst: T.Type) -> bool:
    """Implicit coercion lattice (TypeCoercion.canCoerce)."""
    if src == dst:
        return True
    if isinstance(src, T.UnknownType):
        return True
    order = (T.TinyintType, T.SmallintType, T.IntegerType, T.BigintType)
    if isinstance(src, order) and isinstance(dst, order):
        return order.index(type(src)) <= order.index(type(dst))
    if isinstance(src, order) and isinstance(dst, (T.DoubleType, T.RealType,
                                                   T.DecimalType)):
        return True
    if isinstance(src, T.DecimalType):
        if isinstance(dst, T.DoubleType) or isinstance(dst, T.RealType):
            return True
        if isinstance(dst, T.DecimalType):
            return (dst.scale >= src.scale and
                    dst.precision - dst.scale >= src.precision - src.scale)
        return False
    if isinstance(src, T.RealType) and isinstance(dst, T.DoubleType):
        return True
    if isinstance(src, (T.VarcharType, T.CharType)) and isinstance(
            dst, (T.VarcharType, T.CharType)):
        return True
    if isinstance(src, T.DateType) and isinstance(dst, T.TimestampType):
        return True
    return False


def common_type(a: T.Type, b: T.Type) -> Optional[T.Type]:
    """Least common supertype for comparisons/CASE/set-ops
    (TypeCoercion.getCommonSuperType)."""
    if a == b:
        return a
    if isinstance(a, T.UnknownType):
        return b
    if isinstance(b, T.UnknownType):
        return a
    if isinstance(a, T.DecimalType) and isinstance(b, T.DecimalType):
        scale = max(a.scale, b.scale)
        whole = max(a.precision - a.scale, b.precision - b.scale)
        return T.DecimalType(min(whole + scale, 18), scale)
    ints = (T.TinyintType, T.SmallintType, T.IntegerType, T.BigintType)
    if isinstance(a, ints) and isinstance(b, T.DecimalType):
        return common_type(_int_as_decimal(a), b)
    if isinstance(b, ints) and isinstance(a, T.DecimalType):
        return common_type(a, _int_as_decimal(b))
    if can_coerce(a, b):
        return b
    if can_coerce(b, a):
        return a
    # numeric tower fallback: anything numeric with double/real -> double
    if T.is_numeric(a) and T.is_numeric(b):
        return T.DOUBLE
    return None


def _int_as_decimal(t: T.Type) -> T.DecimalType:
    digits = {T.TinyintType: 3, T.SmallintType: 5, T.IntegerType: 10,
              T.BigintType: 18}[type(t)]
    return T.DecimalType(digits, 0)


# ------------------------------------------------- arithmetic result types

def arithmetic_type(op: str, a: T.Type, b: T.Type) -> T.Type:
    """+ - * / % result type (DecimalOperators / BigintOperators)."""
    if isinstance(a, (T.DoubleType,)) or isinstance(b, (T.DoubleType,)):
        return T.DOUBLE
    if isinstance(a, T.RealType) or isinstance(b, T.RealType):
        return T.REAL
    ints = (T.TinyintType, T.SmallintType, T.IntegerType, T.BigintType)
    if isinstance(a, ints) and isinstance(b, ints):
        order = [T.TinyintType, T.SmallintType, T.IntegerType, T.BigintType]
        win = max(order.index(type(a)), order.index(type(b)))
        # integer arithmetic stays integer; div is integer division
        return (T.TINYINT, T.SMALLINT, T.INTEGER, T.BIGINT)[win]
    da = a if isinstance(a, T.DecimalType) else (
        _int_as_decimal(a) if isinstance(a, ints) else None)
    db = b if isinstance(b, T.DecimalType) else (
        _int_as_decimal(b) if isinstance(b, ints) else None)
    if da is None or db is None:
        raise SemanticError(
            f"cannot apply operator {op} to {a.display()}, {b.display()}")
    p1, s1, p2, s2 = da.precision, da.scale, db.precision, db.scale
    if op in ("+", "-"):
        scale = max(s1, s2)
        precision = max(p1 - s1, p2 - s2) + scale + 1
    elif op == "*":
        precision, scale = p1 + p2, s1 + s2
    elif op == "/":
        scale = max(s1, s2)
        precision = p1 + s2 + max(0, s2 - s1)
    elif op == "%":
        scale = max(s1, s2)
        precision = min(p1 - s1, p2 - s2) + scale
    else:
        raise SemanticError(f"unknown operator {op}")
    return T.DecimalType(min(precision, 18), min(scale, 18))


_ARITH_NAMES = {"+": "add", "-": "subtract", "*": "multiply", "/": "divide",
                "%": "modulus"}
_CMP_NAMES = {"=": "eq", "<>": "ne", "<": "lt", "<=": "le", ">": "gt",
              ">=": "ge"}


def arithmetic_call(op: str, a: T.Type, b: T.Type) -> ResolvedFunction:
    # date/timestamp ± interval
    if isinstance(a, T.DateType) and isinstance(
            b, (T.IntervalDayTimeType, T.IntervalYearMonthType)):
        name = ("date_add_ym" if isinstance(b, T.IntervalYearMonthType)
                else "date_add_dt")
        return ResolvedFunction(name, (a, b), a)
    if isinstance(b, T.DateType) and isinstance(
            a, (T.IntervalDayTimeType, T.IntervalYearMonthType)) and op == "+":
        name = ("date_add_ym" if isinstance(a, T.IntervalYearMonthType)
                else "date_add_dt")
        return ResolvedFunction(name, (b, a), b)
    out = arithmetic_type(op, a, b)
    # operands coerce to a common computation type; decimal ops rescale inside
    return ResolvedFunction(_ARITH_NAMES[op], (a, b), out)


def comparison_call(op: str, a: T.Type, b: T.Type
                    ) -> Tuple[ResolvedFunction, T.Type]:
    """Comparison: (resolved fn, operand coercion target)."""
    ct = common_type(a, b)
    if ct is None:
        raise SemanticError(
            f"cannot compare {a.display()} with {b.display()}")
    base = _CMP_NAMES.get(op)
    if base is None:
        raise SemanticError(f"unsupported comparison {op}")
    return ResolvedFunction(base, (ct, ct), T.BOOLEAN), ct


# ------------------------------------------------------ scalar signatures

def resolve_scalar(name: str, arg_types: Sequence[T.Type]) -> ResolvedFunction:
    """FunctionRegistry.resolveFunction analog for scalar calls."""
    n = name.lower()
    args = tuple(arg_types)

    def sig(out, coerced=None):
        return ResolvedFunction(n, tuple(coerced or args), out)

    if n in ("abs", "ceil", "ceiling", "floor", "negate"):
        if not args or not T.is_numeric(args[0]):
            raise SemanticError(f"{n}() requires a numeric argument")
        canonical = "ceil" if n == "ceiling" else n
        out = args[0]
        if n in ("ceil", "ceiling", "floor") and isinstance(
                args[0], T.DecimalType):
            out = T.DecimalType(args[0].precision - args[0].scale + 1, 0)
        return ResolvedFunction(canonical, args, out)
    if n == "round":
        if len(args) == 1:
            out = args[0]
            if isinstance(args[0], T.DecimalType):
                out = T.DecimalType(args[0].precision - args[0].scale + 1, 0)
            return ResolvedFunction("round", args, out)
        return ResolvedFunction("round_digits", args, args[0])
    if n == "truncate":
        if len(args) == 2:
            return ResolvedFunction("truncate", (T.DOUBLE, T.BIGINT),
                                    T.DOUBLE)
        return ResolvedFunction("truncate", (T.DOUBLE,), T.DOUBLE)
    if n in ("sqrt", "exp", "ln", "log10", "log2", "power", "pow", "cbrt",
             "sin", "cos", "tan", "asin", "acos", "atan", "atan2", "sinh",
             "cosh", "tanh", "radians", "degrees", "log"):
        canonical = "power" if n == "pow" else n
        coerced = tuple(T.DOUBLE for _ in args)
        return ResolvedFunction(canonical, coerced, T.DOUBLE)
    if n in ("pi", "e"):
        if args:
            raise SemanticError(f"{n}() takes no arguments")
        return ResolvedFunction(n, (), T.DOUBLE)
    if n == "mod":
        return ResolvedFunction("modulus", args,
                                common_type(args[0], args[1]) or args[0])
    if n == "sign":
        return sig(args[0])
    if n in ("bitwise_and", "bitwise_or", "bitwise_xor",
             "bitwise_left_shift", "bitwise_right_shift",
             "bitwise_right_shift_arithmetic"):
        return ResolvedFunction(n, (T.BIGINT, T.BIGINT), T.BIGINT)
    if n == "bitwise_not":
        return ResolvedFunction(n, (T.BIGINT,), T.BIGINT)
    if n == "bit_count":
        return ResolvedFunction(n, (T.BIGINT, T.BIGINT), T.BIGINT)
    if n == "width_bucket":
        return ResolvedFunction(
            n, (T.DOUBLE, T.DOUBLE, T.DOUBLE, T.BIGINT), T.BIGINT)
    if n in ("format_datetime", "date_format"):
        if len(args) != 2 or not T.is_string(args[1]):
            raise SemanticError(f"{n}(temporal, pattern) takes a "
                                "temporal and a varchar pattern")
        return ResolvedFunction(n, args, T.VarcharType())
    if n in ("greatest", "least"):
        ct = args[0]
        for t2 in args[1:]:
            nt = common_type(ct, t2)
            if nt is None:
                raise SemanticError(f"{n}() mixed argument types")
            ct = nt
        return ResolvedFunction(n, tuple(ct for _ in args), ct)
    if n in ("year", "month", "day", "quarter", "day_of_week", "dow",
             "day_of_year", "doy", "week", "week_of_year", "day_of_month",
             "hour", "minute", "second"):
        canonical = {"dow": "day_of_week", "doy": "day_of_year",
                     "week_of_year": "week", "day_of_month": "day"}.get(n, n)
        return ResolvedFunction(canonical, args, T.BIGINT)
    if n == "date_trunc":
        return sig(args[1] if len(args) > 1 else T.DATE)
    if n == "date_diff":
        if len(args) == 3 and {type(args[1]), type(args[2])} == \
                {T.DateType, T.TimestampType}:
            # mixed operands: DATE coerces to TIMESTAMP (TypeCoercion)
            coerced = (args[0], T.TIMESTAMP, T.TIMESTAMP)
            return ResolvedFunction(n, coerced, T.BIGINT)
        return sig(T.BIGINT)
    if n == "date_add":
        return sig(args[2] if len(args) > 2 else T.DATE)
    if n == "last_day_of_month":
        return sig(T.DATE)
    if n in ("lower", "upper", "trim", "ltrim", "rtrim", "reverse"):
        return sig(args[0])
    if n in ("substr", "substring"):
        return ResolvedFunction("substr", args, args[0])
    if n in ("replace", "lpad", "rpad", "split_part", "regexp_replace",
             "regexp_extract", "concat_ws"):
        return sig(T.VarcharType())
    if n == "concat":
        return sig(args[0] if T.is_string(args[0]) else T.VarcharType())
    if n in ("length", "strpos", "codepoint"):
        return ResolvedFunction(n, args, T.BIGINT)
    if n in ("like", "regexp_like", "starts_with"):
        return sig(T.BOOLEAN)
    if n == "try_cast":
        # synthesized by the translator for TRY_CAST; target type is
        # pre-resolved there
        return sig(args[0])
    # ------------------------------------------------- array/map functions
    if n == "array_ctor":
        if not args:
            raise SemanticError("ARRAY[] needs an element type; "
                                "cast to a typed empty array")
        ct = args[0]
        for a in args[1:]:
            nt = common_type(ct, a)
            if nt is None:
                raise SemanticError("ARRAY elements have mixed types")
            ct = nt
        return ResolvedFunction("array_ctor", (ct,) * len(args),
                                T.ArrayType(element=ct))
    if n == "cardinality":
        if not isinstance(args[0], (T.ArrayType, T.MapType)):
            raise SemanticError("cardinality() needs ARRAY or MAP")
        return ResolvedFunction("cardinality", args, T.BIGINT)
    if n == "element_at":
        if isinstance(args[0], T.ArrayType):
            return ResolvedFunction("element_at", (args[0], T.BIGINT),
                                    args[0].element)
        if isinstance(args[0], T.MapType):
            return ResolvedFunction("map_element_at",
                                    (args[0], args[0].key),
                                    args[0].value)
        raise SemanticError("element_at() needs ARRAY or MAP")
    if n == "contains":
        if not isinstance(args[0], T.ArrayType):
            raise SemanticError("contains() needs an ARRAY")
        return ResolvedFunction(
            "contains", (args[0], args[0].element), T.BOOLEAN)
    raise SemanticError(f"unknown function: {name}()")


def resolve_aggregate(name: str, arg_types: Sequence[T.Type]
                      ) -> ResolvedFunction:
    """Aggregate output types (mirrors ops/aggregate.get_aggregate)."""
    n = name.lower()
    args = tuple(arg_types)
    if n == "count":
        return ResolvedFunction("count", args, T.BIGINT)
    a = args[0] if args else T.UNKNOWN
    if n == "sum":
        if isinstance(a, (T.DecimalType,)):
            return ResolvedFunction("sum", args, T.DecimalType(18, a.scale))
        if isinstance(a, T.DoubleType):
            return ResolvedFunction("sum", args, T.DOUBLE)
        if isinstance(a, T.RealType):
            return ResolvedFunction("sum", args, T.REAL)
        if T.is_integral(a):
            return ResolvedFunction("sum", args, T.BIGINT)
        raise SemanticError(f"sum() does not accept {a.display()}")
    if n == "avg":
        if isinstance(a, T.DecimalType):
            return ResolvedFunction("avg", args, a)
        if isinstance(a, T.RealType):
            return ResolvedFunction("avg", args, T.REAL)
        if T.is_numeric(a):
            return ResolvedFunction("avg", args, T.DOUBLE)
        raise SemanticError(f"avg() does not accept {a.display()}")
    if n in ("min", "max"):
        return ResolvedFunction(n, args, a)
    if n in ("count_if",):
        return ResolvedFunction("count_if", args, T.BIGINT)
    if n in ("bool_and", "bool_or", "every"):
        canonical = "bool_and" if n == "every" else n
        return ResolvedFunction(canonical, args, T.BOOLEAN)
    if n in ("stddev", "stddev_samp", "stddev_pop", "variance", "var_samp",
             "var_pop", "geometric_mean"):
        return ResolvedFunction(n, args, T.DOUBLE)
    if n in ("arbitrary", "any_value"):
        return ResolvedFunction("arbitrary", args, a)
    if n == "approx_distinct":
        return ResolvedFunction("approx_distinct", args, T.BIGINT)
    if n == "approx_percentile":
        if len(args) != 2:
            raise SemanticError(
                "approx_percentile(x, percentile) takes two arguments")
        return ResolvedFunction("approx_percentile",
                                (args[0], T.DOUBLE), args[0])
    if n == "checksum":
        return ResolvedFunction("checksum", args, T.BIGINT)
    if n in ("corr", "covar_pop", "covar_samp", "regr_slope",
             "regr_intercept"):
        return ResolvedFunction(n, tuple(T.DOUBLE for _ in args), T.DOUBLE)
    if n in ("min_by", "max_by"):
        if len(args) != 2:
            raise SemanticError(f"{n}() takes exactly two arguments")
        return ResolvedFunction(n, args, args[0])
    if n == "array_agg":
        return ResolvedFunction("array_agg", args,
                                T.ArrayType(element=a))
    if n == "histogram":
        return ResolvedFunction("histogram", args,
                                T.MapType(key=a, value=T.BIGINT))
    if n == "map_agg":
        if len(args) != 2:
            raise SemanticError("map_agg(key, value) takes two arguments")
        return ResolvedFunction("map_agg", args,
                                T.MapType(key=args[0], value=args[1]))
    raise SemanticError(f"unknown aggregate: {name}()")


# ------------------------------------------- prepared-statement parameters
#
# PREPARE stores the raw AST with `?` markers (sql/tree.Parameter, lexer-
# numbered left to right); EXECUTE ... USING binds one constant per marker.
# The checks here are the ExpressionAnalyzer.analyzeParameters slice: arity
# must match exactly, and each bound value must be a constant whose type
# the comparison/coercion rules can place in the marker's context (the
# context check itself happens during planning, where a mis-typed
# parameter fails the same way a mis-typed literal would — e.g. "cannot
# compare decimal(12,2) with varchar").


def count_parameters(stmt) -> int:
    """Number of `?` markers in a statement AST (markers are numbered
    contiguously by the lexer, so the count is max position + 1)."""
    from trino_tpu_torch.sql import tree as t

    return 1 + max((n.position for n in t.walk(stmt)
                    if isinstance(n, t.Parameter)), default=-1)


def check_execute_arity(name: str, markers: int, provided: int) -> None:
    """EXECUTE ... USING arity: one value per marker, no extras
    (io.trino.sql.analyzer: "Incorrect number of parameters")."""
    if markers != provided:
        raise SemanticError(
            f"incorrect number of parameters for prepared statement "
            f"'{name}': expected {markers} but found {provided}")


def substitute_parameters(stmt, parameters):
    """Rebuild a statement AST with each `?` marker replaced by its bound
    value EXPRESSION — the non-cached execution path (DDL/INSERT prepared
    statements, and any runner that plans per execution). Equivalent to
    re-parsing the statement with the values spliced in."""
    import dataclasses as _dc

    from trino_tpu_torch.sql import tree as t

    def walk(x):
        if isinstance(x, t.Parameter):
            if x.position >= len(parameters):
                raise SemanticError(
                    f"parameter ?{x.position + 1} has no bound value")
            return parameters[x.position]
        if _dc.is_dataclass(x) and isinstance(x, t.Node):
            changed = False
            fields = {}
            for f in _dc.fields(x):
                old = getattr(x, f.name)
                new = walk(old)
                fields[f.name] = new
                changed = changed or new is not old
            return _dc.replace(x, **fields) if changed else x
        if isinstance(x, tuple):
            out = tuple(walk(item) for item in x)
            return out if any(a is not b for a, b in zip(out, x)) else x
        if isinstance(x, list):
            return [walk(item) for item in x]
        return x
    return walk(stmt)
