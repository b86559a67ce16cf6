"""Literal hoisting: canonicalize lowered expressions for kernel sharing.

Reference parity: sql/gen/PageFunctionCompiler.java:101 — the reference
rewrites constants out of the expression tree before keying its generated
bytecode cache, so `l_quantity < 24` and `l_quantity < 25` share one
compiled PageProcessor and the constant arrives through a session slot.
Here the unit of compilation is an XLA executable, and on TPU compilation
dominates cold latency — so the same move matters more: this pass rewrites
trace-shape-irrelevant Literals into positional `Param` leaves, the
jit-cache key becomes the literal-free canonical tree (+ parameter dtypes,
carried by the Param nodes themselves), and the values flow into the
jitted kernel as a runtime scalar tuple (traced operands, not baked
constants). Second-and-later literal variants of a query shape then run
with ZERO XLA compiles.

What hoists: non-null numeric, decimal (scaled-int), date, timestamp, and
interval literals — comparison/arithmetic constants, IN-list members,
BETWEEN bounds, CASE outputs. Statement-level parameters (`BoundParam`,
from EXECUTE ... USING) fold into the same positional slots, pulling
their values from the execution's bound-value tuple — a cached
(value-free) plan re-executed with new parameters therefore dispatches
the same canonical kernels.

IN-list padding (round 10): an OR-chain of equality tests of ONE needle
against hoistable literals — the translator's desugaring of
`x IN (v1, .., vn)` — used to produce an n-branch canonical tree, so a
5-member and a 6-member list compiled twice. The chain now rewrites to a
single `$in_padded` node whose members ride as ONE padded parameter
vector of width-bucketed (power-of-two, minimum 8) length: every list
length within a bucket shares one executable. Padding slots repeat the
first member, which makes an explicit validity mask unnecessary — a
padding slot's comparison duplicates a real member's comparison, so it
can never change membership. The bucket width is baked into the
canonical tree (it IS trace shape).

What stays static (and why, per call site): see
expr/compiler.py STATIC_LITERAL_ARGS — LIKE/regex patterns and every
string-function literal feed host-side per-dictionary tables; date/format
unit strings select the kernel at trace time. Globally static here:
string literals (comparisons fold against the column's dictionary codes
at trace time), NULL literals (validity structure differs), and booleans
(worthless to parameterize, often trace-shaping). String/boolean
BoundParams bake in as Literals the same way (their kernels key
per-value, like hand-written string literals). Plan-level counts
(LIMIT/TopN, GROUPING set indices, window frame offsets) never pass
through this pass at all — they are operator-spec fields, not expression
leaves, and they size capacities or planes.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from trino_tpu_torch import types as T
from trino_tpu_torch.expr.ir import (BoundParam, Call, Literal, Param,
                               RowExpression, SpecialForm, SpecialKind)

# minimum padded IN-list width: lists of 1..8 members share one bucket
# (comparing 8 scalars costs the same fused op as comparing 3 on TPU),
# so the common dashboard IN-lists all dispatch a single executable
IN_PAD_MIN_WIDTH = 8


def hoistable(lit: Literal) -> bool:
    """True when this literal's value can become a traced scalar operand
    without changing the trace: non-null, non-string (dictionary folds are
    host-side), non-boolean."""
    if lit.value is None:
        return False
    t = lit.type
    if T.is_string(t):
        return False
    if isinstance(t, T.BooleanType):
        return False
    return True


def param_value(lit: Literal) -> np.ndarray:
    """The runtime scalar for a hoisted literal: a 0-d numpy array of the
    type's device dtype, mirroring expr/compiler._lit_column exactly so
    the parameterized trace is operand-for-operand identical to the
    constant-embedding one. An explicit dtype (never a weak Python
    scalar) keeps jit's trace cache keyed stably across variants."""
    value = lit.value
    if isinstance(lit.type, T.DecimalType):
        value = int(value)   # scaled-int, same as _lit_column
    return np.asarray(value, dtype=T.to_numpy_dtype(lit.type))


def hoist_literals(expr: RowExpression, bound: Tuple = ()
                   ) -> Tuple[RowExpression, Tuple[np.ndarray, ...]]:
    """Canonicalize one lowered expression: (literal-free tree, values).

    Param indices are assigned in depth-first visitation order, so the
    canonical tree of any two literal variants of one shape is identical
    and their values tuples align positionally. `bound` is the statement
    parameter values (EXECUTE ... USING) BoundParam leaves draw from.
    """
    values: List[np.ndarray] = []
    out = _walk(expr, values, bound)
    return out, tuple(values)


def hoist_literal_seq(exprs: Sequence[RowExpression], bound: Tuple = ()
                      ) -> Tuple[Tuple[RowExpression, ...],
                                 Tuple[np.ndarray, ...]]:
    """Canonicalize a projection list with ONE shared params tuple:
    indices run on across expressions, so the whole operator passes a
    single values tuple to its compiled kernel."""
    values: List[np.ndarray] = []
    outs = tuple(_walk(e, values, bound) for e in exprs)
    return outs, tuple(values)


def materialize_bound(expr: RowExpression, bound: Tuple) -> RowExpression:
    """Replace BoundParam leaves with their bound values as Literals —
    the hoist-disabled execution path for prepared statements (kernels
    then key per-value, exactly like hand-written literals)."""
    if isinstance(expr, BoundParam):
        return _bound_literal(expr, bound)
    if isinstance(expr, Call):
        args = tuple(materialize_bound(a, bound) for a in expr.args)
        if all(a is b for a, b in zip(args, expr.args)):
            return expr
        return Call(expr.name, args, expr.type)
    if isinstance(expr, SpecialForm):
        args = tuple(materialize_bound(a, bound) for a in expr.args)
        if all(a is b for a, b in zip(args, expr.args)):
            return expr
        return SpecialForm(expr.kind, args, expr.type)
    return expr


def _bound_literal(e: BoundParam, bound: Tuple) -> Literal:
    if e.position >= len(bound):
        raise IndexError(
            f"statement parameter ?{e.position + 1} has no bound value "
            f"({len(bound)} bound)")
    return Literal(bound[e.position], e.type)


def _static_bound(e: BoundParam) -> bool:
    """Statement parameters whose values must bake in as Literals:
    strings fold against dictionaries host-side, booleans are often
    trace-shaping — the same rules `hoistable` applies to Literals."""
    return T.is_string(e.type) or isinstance(e.type, T.BooleanType)


def _walk(e: RowExpression, values: List[np.ndarray],
          bound: Tuple = ()) -> RowExpression:
    from trino_tpu_torch.expr.compiler import STATIC_LITERAL_ARGS
    if isinstance(e, Literal):
        if not hoistable(e):
            return e
        values.append(param_value(e))
        return Param(len(values) - 1, e.type)
    if isinstance(e, BoundParam):
        lit = _bound_literal(e, bound)
        if _static_bound(e):
            return lit
        values.append(param_value(lit))
        return Param(len(values) - 1, e.type)
    if isinstance(e, Call):
        static = STATIC_LITERAL_ARGS.get(e.name)
        if static == "all":
            # the whole call (column subtree included) evaluates inside
            # host-side dictionary machinery that requires Literal args —
            # leave it byte-identical (bound params bake in as Literals)
            return materialize_bound(e, bound)
        args = tuple(materialize_bound(a, bound)
                     if (static is not None and i in static)
                     else _walk(a, values, bound)
                     for i, a in enumerate(e.args))
        return Call(e.name, args, e.type)
    if isinstance(e, SpecialForm):
        if e.kind is SpecialKind.OR:
            padded = _pad_in_chain(e, values, bound)
            if padded is not None:
                return padded
        return SpecialForm(e.kind,
                           tuple(_walk(a, values, bound) for a in e.args),
                           e.type)
    return e   # InputRef / SymbolRef / already-canonical Param


# ------------------------------------------------------- padded IN-lists


def _flatten_or(e: RowExpression, out: List[RowExpression]) -> None:
    if isinstance(e, SpecialForm) and e.kind is SpecialKind.OR:
        for a in e.args:
            _flatten_or(a, out)
    else:
        out.append(e)


def _match_in_chain(e: SpecialForm, bound: Tuple
                    ) -> Optional[Tuple[RowExpression, List[Literal]]]:
    """(needle, members) when `e` is an OR-chain of equality tests of ONE
    needle subtree against hoistable literals of one type — the
    translator's IN-list desugaring (and any hand-written equivalent;
    the rewrite is semantics-preserving for every such chain). Statement
    parameters (`IN (?, ?, ?)`) resolve to their bound values here, so
    prepared IN-lists ride the same padded vector literal lists do."""
    leaves: List[RowExpression] = []
    _flatten_or(e, leaves)
    if len(leaves) < 2:
        return None
    needle: Optional[RowExpression] = None
    members: List[Literal] = []
    for leaf in leaves:
        if not (isinstance(leaf, Call) and leaf.name == "eq"
                and len(leaf.args) == 2):
            return None
        lhs, rhs = leaf.args
        if isinstance(rhs, BoundParam) and not _static_bound(rhs):
            rhs = _bound_literal(rhs, bound)
        if not isinstance(rhs, Literal) or not hoistable(rhs):
            return None
        if isinstance(lhs, (Literal, BoundParam)):
            return None
        if needle is None:
            needle = lhs
        elif lhs != needle:
            return None
        members.append(rhs)
    if any(m.type != members[0].type for m in members):
        return None
    return needle, members


def pad_width(n: int) -> int:
    """Power-of-two bucket for an n-member IN-list, floored at
    IN_PAD_MIN_WIDTH so typical dashboard lists all share one bucket."""
    w = IN_PAD_MIN_WIDTH
    while w < n:
        w *= 2
    return w


def _pad_in_chain(e: SpecialForm, values: List[np.ndarray],
                  bound: Tuple) -> Optional[RowExpression]:
    """Rewrite an IN-style OR-chain to `$in_padded(needle, Param)` with
    the members as ONE width-bucketed padded parameter vector. Padding
    repeats the first member (a duplicate comparison, never a new match),
    so no separate validity mask rides along. The static width Literal in
    the canonical tree keys the bucket — a 9-member list (width 16) must
    not silently retrace a warm width-8 executable."""
    got = _match_in_chain(e, bound)
    if got is None:
        return None
    needle, members = got
    canon_needle = _walk(needle, values, bound)
    width = pad_width(len(members))
    vec = np.stack([param_value(m) for m in members]
                   + [param_value(members[0])] * (width - len(members)))
    values.append(vec)
    return Call("$in_padded",
                (canon_needle, Param(len(values) - 1, members[0].type),
                 Literal(width, T.INTEGER)),
                e.type)
