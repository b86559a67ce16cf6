"""Scopes + AST-expression -> RowExpression translation.

Reference parity: sql/analyzer/Scope.java + sql/planner/TranslationMap.java +
ExpressionAnalyzer typing (via sql/analyzer.py rules here). Translation is
typed bottom-up; coercions become Call("cast", ...) nodes; BETWEEN/IN(list)
desugar with per-side coercions so decimal scales always align.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from trino_tpu_torch import types as T
from trino_tpu_torch.expr.ir import (BoundParam, Call, Literal, RowExpression,
                               SpecialForm, SpecialKind, SymbolRef)
from trino_tpu_torch.expr.functions import days_from_civil
from trino_tpu_torch.sql import tree as t
from trino_tpu_torch.sql.analyzer import (SemanticError, arithmetic_call,
                                    can_coerce, common_type, comparison_call,
                                    is_aggregate, is_window, resolve_scalar)
from trino_tpu_torch.planner.nodes import Symbol


@dataclasses.dataclass(frozen=True)
class Field:
    """One visible column of a relation (sql/analyzer/Field.java)."""

    name: Optional[str]           # None for anonymous expressions
    qualifier: Optional[str]      # relation alias / table name
    symbol: Symbol


class Scope:
    """Name-resolution scope with outer parent for correlated subqueries."""

    def __init__(self, fields: Sequence[Field],
                 parent: Optional["Scope"] = None):
        self.fields = list(fields)
        self.parent = parent

    def try_resolve(self, parts: Tuple[str, ...]
                    ) -> Optional[Tuple[int, Field]]:
        """(scope_level, field); level 0 = this scope, 1+ = outer scopes.
        Identifier matching is case-INSENSITIVE (Trino semantics: a
        quoted \"YEAR\" alias resolves for an unquoted `year` lookup)."""
        def eq(a, b):
            return a is not None and b is not None and \
                a.casefold() == b.casefold()
        if len(parts) == 1:
            name = parts[0]
            matches = [f for f in self.fields if eq(f.name, name)]
        else:
            qualifier, name = parts[-2], parts[-1]
            matches = [f for f in self.fields
                       if eq(f.name, name) and eq(f.qualifier, qualifier)]
        if len(matches) > 1:
            raise SemanticError(f"column '{'.'.join(parts)}' is ambiguous")
        if matches:
            return 0, matches[0]
        if self.parent is not None:
            r = self.parent.try_resolve(parts)
            if r is not None:
                return r[0] + 1, r[1]
        return None

    def resolve(self, parts: Tuple[str, ...]) -> Tuple[int, Field]:
        r = self.try_resolve(parts)
        if r is None:
            raise SemanticError(f"column '{'.'.join(parts)}' cannot be resolved")
        return r


def cast_to(expr: RowExpression, target: T.Type) -> RowExpression:
    if expr.type == target:
        return expr
    # varchar(n) length coercions are representation no-ops (dictionary
    # codes / host strings carry no length) — and a cast Call would defeat
    # the compiler's dictionary-folded string comparisons
    if T.is_string(expr.type) and T.is_string(target):
        return expr
    if isinstance(expr, Literal) and expr.value is None:
        return Literal(None, target)
    # fold literal int -> decimal casts at plan time (LiteralEncoder analog)
    if isinstance(expr, Literal) and isinstance(target, T.DecimalType) and \
            T.is_integral(expr.type):
        return Literal(expr.value * 10 ** target.scale, target)
    if isinstance(expr, Literal) and isinstance(target, T.DecimalType) and \
            isinstance(expr.type, T.DecimalType):
        delta = target.scale - expr.type.scale
        if delta >= 0:
            return Literal(expr.value * 10 ** delta, target)
    # fold literal string casts at plan time: CAST('1999-02-22' AS DATE)
    # (+ numeric variants) is the TPC-DS date-arithmetic idiom
    if isinstance(expr, Literal) and T.is_string(expr.type) and \
            expr.value is not None:
        s = str(expr.value).strip()
        try:
            if isinstance(target, T.DateType):
                return Literal(_parse_date(s), target)
            if isinstance(target, T.TimestampType):
                return Literal(_parse_timestamp(s), target)
            if T.is_integral(target):
                return Literal(int(s), target)
            if isinstance(target, (T.DoubleType, T.RealType)):
                return Literal(float(s), target)
            if isinstance(target, T.DecimalType):
                import decimal as _dec
                q = _dec.Decimal(s).scaleb(target.scale)
                return Literal(
                    int(q.to_integral_value(rounding=_dec.ROUND_HALF_UP)),
                    target)
        except (ValueError, ArithmeticError) as e:
            raise SemanticError(f"cannot cast '{s}' to "
                                f"{target.display()}: {e}")
    return Call("cast", (expr,), target)


def _parse_date(text: str) -> int:
    y, m, d = text.strip().split("-")
    return days_from_civil(int(y), int(m), int(d))


_MICROS = {"DAY": 86_400_000_000, "HOUR": 3_600_000_000,
           "MINUTE": 60_000_000, "SECOND": 1_000_000}


def _interval_literal(node: t.IntervalLiteral) -> Literal:
    unit, end = node.unit, node.end_unit
    if unit in ("YEAR", "MONTH"):
        if end == "MONTH" and unit == "YEAR":
            yy, mm = node.value.split("-")
            months = int(yy) * 12 + int(mm)
        else:
            months = int(node.value) * (12 if unit == "YEAR" else 1)
        return Literal(node.sign * months, T.INTERVAL_YEAR_MONTH)
    if unit in _MICROS:
        if end is not None:
            raise SemanticError(
                f"INTERVAL {unit} TO {end} literals not supported")
        micros = int(node.value) * _MICROS[unit]
        return Literal(node.sign * micros, T.INTERVAL_DAY_TIME)
    raise SemanticError(f"unsupported interval unit {unit}")


def _decimal_literal(text: str) -> Literal:
    neg = text.startswith("-")
    body = text.lstrip("+-")
    if "." in body:
        whole, frac = body.split(".")
    else:
        whole, frac = body, ""
    scale = len(frac)
    digits = (whole + frac).lstrip("0") or "0"
    precision = max(len(digits), scale + 1)
    value = int(whole + frac or "0")
    return Literal(-value if neg else value,
                   T.DecimalType(min(precision, 18), min(scale, 18)))


class ExpressionTranslator:
    """AST expression -> typed RowExpression against a Scope.

    `substitutions` maps already-planned RowExpressions (group-by keys,
    aggregate calls, window calls) to their output symbols — the
    TranslationMap mechanism, keyed structurally.
    `subquery_handler(node) -> RowExpression` is provided by the planner to
    splice subquery plans in (SubqueryPlanner role); None = reject subqueries.
    `on_outer_reference` is called with (level, Field) for correlated refs.
    """

    def __init__(self, scope: Scope,
                 substitutions: Optional[Dict[RowExpression, Symbol]] = None,
                 subquery_handler: Optional[Callable] = None,
                 on_outer_reference: Optional[Callable] = None,
                 session=None, grouping_handler: Optional[Callable] = None):
        self.scope = scope
        self.substitutions = substitutions or {}
        self.subquery_handler = subquery_handler
        self.on_outer_reference = on_outer_reference
        self.session = session
        self.grouping_handler = grouping_handler

    def _sub(self, expr: RowExpression) -> RowExpression:
        sym = self.substitutions.get(expr)
        return sym.ref() if sym is not None else expr

    def translate(self, node: t.Expression) -> RowExpression:
        out = self._translate(node)
        return out

    def _translate(self, node: t.Expression) -> RowExpression:
        # --------------------------------------------------------- literals
        if isinstance(node, t.NullLiteral):
            return Literal(None, T.UNKNOWN)
        if isinstance(node, t.BooleanLiteral):
            return Literal(node.value, T.BOOLEAN)
        if isinstance(node, t.LongLiteral):
            if -(2 ** 31) <= node.value < 2 ** 31:
                return Literal(node.value, T.INTEGER)
            return Literal(node.value, T.BIGINT)
        if isinstance(node, t.DoubleLiteral):
            return Literal(node.value, T.DOUBLE)
        if isinstance(node, t.DecimalLiteral):
            return _decimal_literal(node.text)
        if isinstance(node, t.StringLiteral):
            return Literal(node.value, T.VarcharType(max(len(node.value), 1)))
        if isinstance(node, t.DateLiteral):
            return Literal(_parse_date(node.text), T.DATE)
        if isinstance(node, t.TimestampLiteral):
            return Literal(_parse_timestamp(node.text), T.TIMESTAMP)
        if isinstance(node, t.IntervalLiteral):
            return _interval_literal(node)
        if isinstance(node, t.CurrentTime):
            if self.session is None or node.function != "DATE":
                raise SemanticError(f"current_{node.function.lower()} "
                                    "not available here")
            return Literal(self.session.start_date, T.DATE)
        if isinstance(node, t.Parameter):
            # a `?` marker: only plannable under EXECUTE ... USING, which
            # stashes the bound value types on the session before planning
            # (ParameterRewriter analog — the plan stays value-free, so
            # the plan cache reuses it across executions)
            types = getattr(self.session, "param_types", None) \
                if self.session is not None else None
            if types is None:
                raise SemanticError(
                    "parameters are only supported in EXECUTE ... USING")
            if node.position >= len(types):
                raise SemanticError(
                    f"parameter ?{node.position + 1} has no bound value "
                    f"({len(types)} provided)")
            return BoundParam(node.position, types[node.position])
        # ------------------------------------------------------- references
        if isinstance(node, t.Identifier):
            return self._column((node.value,))
        if isinstance(node, t.DereferenceExpression):
            parts = _dereference_parts(node)
            if parts is None:
                raise SemanticError(f"unsupported dereference: {node}")
            return self._column(parts)
        # ------------------------------------------------------- operators
        if isinstance(node, t.ArithmeticBinary):
            a = self._translate(node.left)
            b = self._translate(node.right)
            return self._sub(make_arithmetic(node.op, a, b))
        if isinstance(node, t.ArithmeticUnary):
            a = self._translate(node.value)
            if node.op == "+":
                return a
            return self._sub(Call("negate", (a,), a.type))
        if isinstance(node, t.ComparisonExpression):
            a = self._translate(node.left)
            b = self._translate(node.right)
            return self._sub(make_comparison(node.op, a, b))
        if isinstance(node, t.LogicalBinary):
            a = self._to_bool(self._translate(node.left))
            b = self._to_bool(self._translate(node.right))
            kind = SpecialKind.AND if node.op == "AND" else SpecialKind.OR
            return SpecialForm(kind, (a, b), T.BOOLEAN)
        if isinstance(node, t.NotExpression):
            a = self._to_bool(self._translate(node.value))
            return SpecialForm(SpecialKind.NOT, (a,), T.BOOLEAN)
        if isinstance(node, t.IsNullPredicate):
            a = self._translate(node.value)
            return SpecialForm(SpecialKind.IS_NULL, (a,), T.BOOLEAN)
        if isinstance(node, t.IsNotNullPredicate):
            a = self._translate(node.value)
            inner = SpecialForm(SpecialKind.IS_NULL, (a,), T.BOOLEAN)
            return SpecialForm(SpecialKind.NOT, (inner,), T.BOOLEAN)
        if isinstance(node, t.BetweenPredicate):
            v = self._translate(node.value)
            lo = self._translate(node.min)
            hi = self._translate(node.max)
            return SpecialForm(SpecialKind.AND, (
                make_comparison(">=", v, lo),
                make_comparison("<=", v, hi)), T.BOOLEAN)
        if isinstance(node, t.InPredicate):
            return self._in_predicate(node)
        if isinstance(node, t.LikePredicate):
            v = self._translate(node.value)
            p = self._translate(node.pattern)
            args = (v, p)
            if node.escape is not None:
                args = args + (self._translate(node.escape),)
            return Call("like", args, T.BOOLEAN)
        if isinstance(node, t.ExistsPredicate):
            return self._subquery(node)
        if isinstance(node, t.SubqueryExpression):
            return self._subquery(node)
        # ------------------------------------------------------ conditionals
        if isinstance(node, t.SearchedCaseExpression):
            whens = [(self._to_bool(self._translate(w.operand)),
                      self._translate(w.result)) for w in node.when_clauses]
            default = (self._translate(node.default)
                       if node.default is not None else None)
            return _make_case(whens, default)
        if isinstance(node, t.SimpleCaseExpression):
            operand = self._translate(node.operand)
            whens = []
            for w in node.when_clauses:
                cond = make_comparison("=", operand,
                                       self._translate(w.operand))
                whens.append((cond, self._translate(w.result)))
            default = (self._translate(node.default)
                       if node.default is not None else None)
            return _make_case(whens, default)
        if isinstance(node, t.IfExpression):
            cond = self._to_bool(self._translate(node.condition))
            then = self._translate(node.true_value)
            els = (self._translate(node.false_value)
                   if node.false_value is not None else None)
            return _make_case([(cond, then)], els)
        if isinstance(node, t.CoalesceExpression):
            args = [self._translate(a) for a in node.operands]
            ct = args[0].type
            for a in args[1:]:
                nt = common_type(ct, a.type)
                if nt is None:
                    raise SemanticError("COALESCE argument types differ")
                ct = nt
            args = tuple(cast_to(a, ct) for a in args)
            return SpecialForm(SpecialKind.COALESCE, args, ct)
        if isinstance(node, t.NullIfExpression):
            # Trino contract: the comparison runs at the common type but the
            # result keeps the FIRST argument's type and (uncast) value, so
            # the IR type always agrees with the produced dtype
            a = self._translate(node.first)
            b = self._translate(node.second)
            ct = common_type(a.type, b.type)
            if ct is None:
                raise SemanticError("NULLIF argument types differ")
            cond = Call("eq", (cast_to(a, ct), cast_to(b, ct)), T.BOOLEAN)
            return SpecialForm(SpecialKind.IF,
                               (cond, Literal(None, a.type), a), a.type)
        # ----------------------------------------------------------- casts
        if isinstance(node, t.Cast):
            a = self._translate(node.value)
            target = T.parse_type(node.target_type)
            if isinstance(a, Literal) and a.value is None:
                return Literal(None, target)
            if node.safe:
                # TRY_CAST: NULL instead of error on unconvertible values
                return Call("try_cast", (a,), target)
            return cast_to(a, target)
        if isinstance(node, t.Extract):
            a = self._translate(node.value)
            fn = node.field.lower()
            if fn not in ("year", "month", "day", "quarter"):
                raise SemanticError(f"EXTRACT({node.field}) not supported")
            return self._sub(Call(fn, (a,), T.BIGINT))
        # ------------------------------------------------------- functions
        if isinstance(node, t.FunctionCall):
            return self._function_call(node)
        if isinstance(node, t.Row):
            raise SemanticError("ROW constructor not supported here")
        raise SemanticError(f"unsupported expression: {node!r}")

    # ------------------------------------------------------------- helpers

    def _column(self, parts: Tuple[str, ...]) -> RowExpression:
        level, field = self.scope.resolve(parts)
        if level > 0 and self.on_outer_reference is not None:
            self.on_outer_reference(level, field)
        return self._sub(field.symbol.ref())

    def _to_bool(self, e: RowExpression) -> RowExpression:
        if not isinstance(e.type, T.BooleanType):
            raise SemanticError(
                f"expected boolean, got {e.type.display()}: {e}")
        return e

    def _in_predicate(self, node: t.InPredicate) -> RowExpression:
        if isinstance(node.value_list, t.SubqueryExpression):
            return self._subquery(node)
        assert isinstance(node.value_list, t.InListExpression)
        v = self._translate(node.value)
        items = [self._translate(x) for x in node.value_list.values]
        ct = v.type
        for it in items:
            nt = common_type(ct, it.type)
            if nt is None:
                raise SemanticError(
                    f"IN list type mismatch: {ct.display()} vs "
                    f"{it.type.display()}")
            ct = nt
        v = cast_to(v, ct)
        eqs = tuple(make_comparison("=", v, cast_to(it, ct)) for it in items)
        if len(eqs) == 1:
            return eqs[0]
        out = eqs[0]
        for e in eqs[1:]:
            out = SpecialForm(SpecialKind.OR, (out, e), T.BOOLEAN)
        return out

    def _subquery(self, node: t.Expression) -> RowExpression:
        if self.subquery_handler is None:
            raise SemanticError("subqueries are not allowed here")
        return self.subquery_handler(self, node)

    def _function_call(self, node: t.FunctionCall) -> RowExpression:
        name = node.name.suffix.lower()
        if name == "grouping":
            # decoded from the GroupId set index (GroupingOperationRewriter
            # analog); only meaningful above ROLLUP/CUBE/GROUPING SETS
            if self.grouping_handler is None:
                raise SemanticError(
                    "grouping() outside a grouping-sets aggregation")
            return self.grouping_handler(self, node)
        if is_aggregate(name) or is_window(name):
            # aggregates/windows must have been planned already; look up the
            # translated form in substitutions
            key = self.aggregate_key(node)
            sym = self.substitutions.get(key)
            if sym is None:
                raise SemanticError(
                    f"aggregate/window {name}() not allowed in this context")
            return sym.ref()
        args = tuple(self._translate(a) for a in node.args)
        resolved = resolve_scalar(name, [a.type for a in args])
        args = tuple(cast_to(a, ty)
                     for a, ty in zip(args, resolved.arg_types))
        return self._sub(Call(resolved.name, args, resolved.return_type))

    def aggregate_key(self, node: t.FunctionCall) -> RowExpression:
        """Canonical RowExpression key for an aggregate/window call AST."""
        name = node.name.suffix.lower()
        args = tuple(self._translate(a) for a in node.args)
        filt = (self._translate(node.filter)
                if node.filter is not None else None)
        key_args = args if filt is None else args + (filt,)
        tag = f"$agg_{name}{'_distinct' if node.distinct else ''}"
        return Call(tag, key_args, T.UNKNOWN)


def _parse_timestamp(text: str) -> int:
    """'yyyy-mm-dd hh:mm:ss[.fff]' -> micros since epoch."""
    date_part, _, time_part = text.strip().partition(" ")
    days = _parse_date(date_part)
    micros = days * 86_400_000_000
    if time_part:
        hh, mm, ss = (time_part.split(":") + ["0", "0"])[:3]
        sec, _, frac = ss.partition(".")
        micros += (int(hh) * 3600 + int(mm) * 60 + int(sec)) * 1_000_000
        if frac:
            micros += int((frac + "000000")[:6])
    return micros


def _dereference_parts(node: t.Expression) -> Optional[Tuple[str, ...]]:
    if isinstance(node, t.Identifier):
        return (node.value,)
    if isinstance(node, t.DereferenceExpression):
        base = _dereference_parts(node.base)
        if base is None:
            return None
        return base + (node.field.value,)
    return None


def make_arithmetic(op: str, a: RowExpression,
                    b: RowExpression) -> RowExpression:
    resolved = arithmetic_call(op, a.type, b.type)
    if resolved.name in ("date_add_ym", "date_add_dt"):
        # canonical arg order: (date, interval)
        if isinstance(a.type, (T.IntervalDayTimeType, T.IntervalYearMonthType)):
            a, b = b, a
        if op == "-":
            b = Call("negate", (b,), b.type)
        return Call(resolved.name, (a, b), resolved.return_type)
    out = resolved.return_type
    # cross-class operands (int with decimal) coerce to the decimal class so
    # the kernel's scale handling sees two decimals
    if isinstance(out, T.DecimalType):
        a = _as_decimal(a)
        b = _as_decimal(b)
    elif isinstance(out, (T.DoubleType, T.RealType)):
        a = cast_to(a, out)
        b = cast_to(b, out)
    return Call(resolved.name, (a, b), out)


def _as_decimal(e: RowExpression) -> RowExpression:
    if isinstance(e.type, T.DecimalType):
        return e
    digits = {T.TinyintType: 3, T.SmallintType: 5, T.IntegerType: 10,
              T.BigintType: 18}.get(type(e.type))
    if digits is None:
        raise SemanticError(f"cannot treat {e.type.display()} as decimal")
    return cast_to(e, T.DecimalType(digits, 0))


def make_comparison(op: str, a: RowExpression,
                    b: RowExpression) -> RowExpression:
    if op in ("IS DISTINCT FROM", "IS NOT DISTINCT FROM"):
        eq, ct = comparison_call("=", a.type, b.type)
        # null-safe equality: translate via case on IS NULL flags
        a = cast_to(a, ct)
        b = cast_to(b, ct)
        a_null = SpecialForm(SpecialKind.IS_NULL, (a,), T.BOOLEAN)
        b_null = SpecialForm(SpecialKind.IS_NULL, (b,), T.BOOLEAN)
        both_null = SpecialForm(SpecialKind.AND, (a_null, b_null), T.BOOLEAN)
        eq_call = Call("eq", (a, b), T.BOOLEAN)
        eq_or = SpecialForm(SpecialKind.OR, (
            both_null,
            SpecialForm(SpecialKind.AND, (
                SpecialForm(SpecialKind.NOT, (a_null,), T.BOOLEAN),
                SpecialForm(SpecialKind.AND, (
                    SpecialForm(SpecialKind.NOT, (b_null,), T.BOOLEAN),
                    eq_call), T.BOOLEAN)), T.BOOLEAN)), T.BOOLEAN)
        not_distinct = SpecialForm(SpecialKind.COALESCE, (
            eq_or, Literal(False, T.BOOLEAN)), T.BOOLEAN)
        if op == "IS NOT DISTINCT FROM":
            return not_distinct
        return SpecialForm(SpecialKind.NOT, (not_distinct,), T.BOOLEAN)
    resolved, ct = comparison_call(op, a.type, b.type)
    return Call(resolved.name, (cast_to(a, ct), cast_to(b, ct)), T.BOOLEAN)


def _make_case(whens: List[Tuple[RowExpression, RowExpression]],
               default: Optional[RowExpression]) -> RowExpression:
    result_types = [v.type for _, v in whens]
    if default is not None:
        result_types.append(default.type)
    ct = result_types[0]
    for rt in result_types[1:]:
        nt = common_type(ct, rt)
        if nt is None:
            raise SemanticError("CASE branches have incompatible types")
        ct = nt
    args: List[RowExpression] = []
    for cond, val in whens:
        args += [cond, cast_to(val, ct)]
    args.append(cast_to(default, ct) if default is not None
                else Literal(None, ct))
    return SpecialForm(SpecialKind.SWITCH, tuple(args), ct)
