"""Expression compiler parity: trino_tpu_torch vs trino_tpu (CPU).

Each case builds one expression tree with each package's own IR and types
(the same builder runs against both), evaluates it on the same seeded page
through compile_expression / compile_filter, and compares values and
validity row by row: integers, decimals, dates, booleans and strings
exactly, doubles to 1e-9 relative (NaN equals NaN). Cases cover the
q1/q6 predicates and projections plus cases from tests/test_expr.py and
tests/test_scalars.py. A second pass runs every case through each
package's literal hoisting, so Param slots reach the compilers as runtime
operands.
"""

import types as _pytypes

import numpy as np
import pytest
import torch

import trino_tpu.expr as RE
import trino_tpu.expr.hoist as RH
from trino_tpu import page as RP
from trino_tpu import types as RT
from trino_tpu.expr.functions import days_from_civil as d

import trino_tpu_torch.expr as PE
import trino_tpu_torch.expr.hoist as PH
from trino_tpu_torch import page as PP
from trino_tpu_torch import types as PT

torch.set_num_threads(1)

REF = _pytypes.SimpleNamespace(E=RE, T=RT, P=RP, H=RH)
PORT = _pytypes.SimpleNamespace(E=PE, T=PT, P=PP, H=PH)

D122 = ("DecimalType", 12, 2)
N = 64
_RNG = np.random.default_rng(20261017)


def ty(T, spec):
    if isinstance(spec, tuple):
        return getattr(T, spec[0])(spec[1], spec[2])
    return getattr(T, spec)


def _valid(p):
    return _RNG.random(N) < p


# seeded columns: name -> (values, type spec, validity or None)
COLS = {
    "qty": (_RNG.integers(100, 5001, N), D122, None),
    "price": (_RNG.integers(90_000, 10_500_000, N), D122, None),
    "disc": (_RNG.integers(0, 11, N), D122, None),
    "tax": (_RNG.integers(0, 9, N), D122, None),
    "ship": (_RNG.integers(d(1992, 1, 1), d(1998, 12, 1), N).astype(np.int32),
             "DATE", None),
    "a": (_RNG.integers(-50, 50, N), "BIGINT", _valid(0.8)),
    "b": (np.where(_RNG.random(N) < 0.2, 0, _RNG.integers(-7, 8, N)),
          "BIGINT", _valid(0.8)),
    "i32": (_RNG.integers(-1000, 1000, N).astype(np.int32), "INTEGER",
            None),
    "x": (np.where(_RNG.random(N) < 0.1, np.nan, _RNG.normal(size=N) * 10),
          "DOUBLE", _valid(0.9)),
    "neg": (np.where(_RNG.random(N) < 0.3, -0.0, _RNG.normal(size=N)),
            "DOUBLE", None),
    "p": (_RNG.random(N) < 0.5, "BOOLEAN", _valid(0.7)),
    "q": (_RNG.random(N) < 0.5, "BOOLEAN", _valid(0.7)),
    "s": (np.array(["BRASS", "COPPER", "STEEL", "PROMO BRUSHED", "TIN"],
                   dtype=object)[_RNG.integers(0, 5, N)], "VARCHAR",
          _valid(0.9)),
    "dec4": (_RNG.integers(-99_999, 99_999, N), ("DecimalType", 12, 4),
             _valid(0.9)),
    "big": (_RNG.integers(-2**62, 2**62, N, dtype=np.int64), "BIGINT",
            None),
    "sh": (_RNG.integers(0, 66, N), "BIGINT", None),
}
NAMES = list(COLS)


def make_page(pkg):
    arrays, typs, valids = [], [], []
    for name in NAMES:
        vals, spec, valid = COLS[name]
        arrays.append(vals)
        typs.append(ty(pkg.T, spec))
        valids.append(valid)
    if pkg is PORT:
        return pkg.P.Page.from_numpy(arrays, typs, valids=valids,
                                     device="cpu")
    return pkg.P.Page.from_numpy(arrays, typs, valids=valids)


def col(pkg, name):
    return pkg.E.InputRef(NAMES.index(name), ty(pkg.T, COLS[name][1]))


def lit(pkg, v, spec):
    return pkg.E.Literal(v, ty(pkg.T, spec))


def call(pkg, name, args, spec):
    return pkg.E.Call(name, tuple(args), ty(pkg.T, spec))


def special(pkg, kind, args, spec="BOOLEAN"):
    return pkg.E.SpecialForm(getattr(pkg.E.SpecialKind, kind), tuple(args),
                             ty(pkg.T, spec))


def c_(g, n):
    return col(g, n)


# name -> (builder(pkg) -> expression, "expr" | "filter")
CASES = {
    # ---- q6 / q1 shapes
    "q6_predicate": (lambda g: special(g, "AND", [
        call(g, "ge", [c_(g, "ship"), lit(g, d(1994, 1, 1), "DATE")],
             "BOOLEAN"),
        call(g, "lt", [c_(g, "ship"), lit(g, d(1995, 1, 1), "DATE")],
             "BOOLEAN"),
        special(g, "BETWEEN", [c_(g, "disc"), lit(g, 5, D122),
                               lit(g, 7, D122)]),
        call(g, "lt", [c_(g, "qty"), lit(g, 2400, D122)], "BOOLEAN")]),
        "filter"),
    "q6_revenue": (lambda g: call(g, "multiply", [c_(g, "price"),
                                                  c_(g, "disc")],
                                  ("DecimalType", 18, 4)), "expr"),
    "q1_predicate": (lambda g: call(g, "le", [
        c_(g, "ship"), lit(g, d(1998, 12, 1) - 90, "DATE")], "BOOLEAN"),
        "filter"),
    "q1_disc_price": (lambda g: call(g, "multiply", [
        c_(g, "price"),
        call(g, "subtract", [lit(g, 100, D122), c_(g, "disc")],
             ("DecimalType", 13, 2))], ("DecimalType", 18, 4)), "expr"),
    "q1_charge": (lambda g: call(g, "multiply", [
        call(g, "multiply", [
            c_(g, "price"),
            call(g, "subtract", [lit(g, 100, D122), c_(g, "disc")],
                 ("DecimalType", 13, 2))], ("DecimalType", 18, 4)),
        call(g, "add", [lit(g, 100, D122), c_(g, "tax")],
             ("DecimalType", 13, 2))], ("DecimalType", 18, 6)), "expr"),
    # ---- decimals
    "decimal_rescale_half_up": (lambda g: call(g, "cast", [c_(g, "dec4")],
                                               D122), "expr"),
    "decimal_add_mixed_scale": (lambda g: call(g, "add", [
        c_(g, "dec4"), c_(g, "qty")], ("DecimalType", 15, 4)), "expr"),
    "decimal_divide": (lambda g: call(g, "divide", [
        c_(g, "price"), c_(g, "qty")], D122), "expr"),
    "decimal_round_ceil_floor": (lambda g: call(g, "add", [
        call(g, "ceil", [c_(g, "dec4")], "BIGINT"),
        call(g, "floor", [c_(g, "dec4")], "BIGINT")], "BIGINT"), "expr"),
    "decimal_to_double": (lambda g: call(g, "cast", [c_(g, "dec4")],
                                         "DOUBLE"), "expr"),
    # ---- Java integer semantics
    "truncating_divide": (lambda g: call(g, "divide", [c_(g, "a"),
                                                       c_(g, "b")],
                                         "BIGINT"), "expr"),
    "truncating_modulus": (lambda g: call(g, "modulus", [c_(g, "a"),
                                                         c_(g, "b")],
                                          "BIGINT"), "expr"),
    "int32_plus_bigint_literal": (lambda g: call(g, "add", [
        c_(g, "i32"), lit(g, 3_000_000_000, "BIGINT")], "BIGINT"), "expr"),
    "negate_abs_greatest": (lambda g: call(g, "greatest", [
        call(g, "negate", [c_(g, "a")], "BIGINT"),
        call(g, "abs", [c_(g, "b")], "BIGINT"), lit(g, 3, "BIGINT")],
        "BIGINT"), "expr"),
    # ---- doubles
    "double_nan_null": (lambda g: call(g, "multiply", [
        c_(g, "x"), c_(g, "neg")], "DOUBLE"), "expr"),
    "double_to_bigint_round": (lambda g: call(g, "cast", [c_(g, "x")],
                                              "BIGINT"), "expr"),
    "round_digits_double": (lambda g: call(g, "round_digits", [
        c_(g, "x"), lit(g, 2, "INTEGER")], "DOUBLE"), "expr"),
    "round_digits_decimal": (lambda g: call(g, "round_digits", [
        c_(g, "dec4"), lit(g, 1, "INTEGER")], ("DecimalType", 12, 4)),
        "expr"),
    "sqrt_ln_power": (lambda g: call(g, "add", [
        call(g, "sqrt", [call(g, "abs", [c_(g, "x")], "DOUBLE")], "DOUBLE"),
        call(g, "power", [c_(g, "neg"), lit(g, 2.0, "DOUBLE")], "DOUBLE")],
        "DOUBLE"), "expr"),
    # ---- comparisons, BETWEEN, IN, Kleene logic
    "between_nulls": (lambda g: special(g, "BETWEEN", [
        c_(g, "a"), lit(g, -10, "BIGINT"), c_(g, "b")]), "expr"),
    "in_list": (lambda g: special(g, "IN", [
        c_(g, "a"), lit(g, 1, "BIGINT"), lit(g, 7, "BIGINT"),
        lit(g, -3, "BIGINT")]), "expr"),
    "kleene_and": (lambda g: special(g, "AND", [c_(g, "p"), c_(g, "q")]),
                   "expr"),
    "kleene_or": (lambda g: special(g, "OR", [c_(g, "p"), c_(g, "q")]),
                  "expr"),
    "kleene_filter": (lambda g: special(g, "OR", [
        special(g, "NOT", [c_(g, "p")]),
        call(g, "gt", [c_(g, "a"), lit(g, 0, "BIGINT")], "BOOLEAN")]),
        "filter"),
    "is_null_coalesce": (lambda g: special(g, "COALESCE", [
        c_(g, "a"), c_(g, "b"), lit(g, -1, "BIGINT")], "BIGINT"), "expr"),
    "case_switch": (lambda g: special(g, "SWITCH", [
        call(g, "lt", [c_(g, "a"), lit(g, 0, "BIGINT")], "BOOLEAN"),
        lit(g, 10, "BIGINT"),
        special(g, "IS_NULL", [c_(g, "b")]), lit(g, 20, "BIGINT"),
        c_(g, "b")], "BIGINT"), "expr"),
    "if_null_branch": (lambda g: special(g, "IF", [
        call(g, "eq", [c_(g, "a"), c_(g, "b")], "BOOLEAN"),
        lit(g, None, "BIGINT"), c_(g, "a")], "BIGINT"), "expr"),
    # ---- dates
    "date_plus_days": (lambda g: call(g, "date_add_dt", [
        c_(g, "ship"), lit(g, 90 * 86_400_000_000, "INTERVAL_DAY_TIME")],
        "DATE"), "expr"),
    "date_plus_months": (lambda g: call(g, "date_add_ym", [
        c_(g, "ship"), lit(g, 13, "INTERVAL_YEAR_MONTH")], "DATE"), "expr"),
    "date_parts": (lambda g: call(g, "add", [
        call(g, "multiply", [call(g, "year", [c_(g, "ship")], "BIGINT"),
                             lit(g, 10000, "BIGINT")], "BIGINT"),
        call(g, "add", [
            call(g, "multiply", [call(g, "month", [c_(g, "ship")],
                                      "BIGINT"), lit(g, 100, "BIGINT")],
                 "BIGINT"),
            call(g, "day", [c_(g, "ship")], "BIGINT")], "BIGINT")],
        "BIGINT"), "expr"),
    "date_week_quarter_dow": (lambda g: call(g, "add", [
        call(g, "week", [c_(g, "ship")], "BIGINT"),
        call(g, "add", [call(g, "quarter", [c_(g, "ship")], "BIGINT"),
                        call(g, "day_of_week", [c_(g, "ship")], "BIGINT")],
             "BIGINT")], "BIGINT"), "expr"),
    "date_trunc_month": (lambda g: call(g, "date_trunc", [
        lit(g, "month", "VARCHAR"), c_(g, "ship")], "DATE"), "expr"),
    "date_diff_month": (lambda g: call(g, "date_diff", [
        lit(g, "month", "VARCHAR"), lit(g, d(1995, 6, 17), "DATE"),
        c_(g, "ship")], "BIGINT"), "expr"),
    # ---- dictionary strings
    "string_eq": (lambda g: call(g, "eq", [c_(g, "s"),
                                           lit(g, "COPPER", "VARCHAR")],
                                 "BOOLEAN"), "expr"),
    "string_lt_flipped": (lambda g: call(g, "gt", [
        lit(g, "PROMO", "VARCHAR"), c_(g, "s")], "BOOLEAN"), "expr"),
    "string_ge_absent": (lambda g: call(g, "ge", [
        c_(g, "s"), lit(g, "D", "VARCHAR")], "BOOLEAN"), "expr"),
    "like": (lambda g: call(g, "like", [c_(g, "s"),
                                        lit(g, "%R%", "VARCHAR")],
                            "BOOLEAN"), "expr"),
    "substr_upper": (lambda g: call(g, "lower", [
        call(g, "substr", [c_(g, "s"), lit(g, 2, "BIGINT"),
                           lit(g, 3, "BIGINT")], "VARCHAR")], "VARCHAR"),
        "expr"),
    "length": (lambda g: call(g, "length", [c_(g, "s")], "BIGINT"), "expr"),
    # ---- logical shifts and bits (uint64 in the reference)
    "logical_right_shift": (lambda g: call(g, "bitwise_right_shift", [
        c_(g, "big"), c_(g, "sh")], "BIGINT"), "expr"),
    "arithmetic_right_shift": (lambda g: call(
        g, "bitwise_right_shift_arithmetic", [c_(g, "big"), c_(g, "sh")],
        "BIGINT"), "expr"),
    "left_shift": (lambda g: call(g, "bitwise_left_shift", [
        c_(g, "big"), c_(g, "sh")], "BIGINT"), "expr"),
    "bit_count": (lambda g: call(g, "bit_count", [
        c_(g, "big"), lit(g, 64, "BIGINT")], "BIGINT"), "expr"),
    "bitwise_and_xor": (lambda g: call(g, "bitwise_xor", [
        call(g, "bitwise_and", [c_(g, "big"), c_(g, "a")], "BIGINT"),
        c_(g, "b")], "BIGINT"), "expr"),
}


def _values(pkg, case, page, hoist):
    build, kind = CASES[case]
    expr = build(pkg)
    params = ()
    if hoist:
        expr, params = pkg.H.hoist_literals(expr)
    if kind == "filter":
        mask = pkg.E.compile_filter(expr)(page, params)
        return np.asarray(mask)[:N].tolist()
    out = pkg.E.compile_expression(expr)(page, params)
    return out.to_numpy(N).tolist()


def _same(x, y) -> bool:
    if x is None or y is None:
        return x is None and y is None
    if isinstance(x, float) or isinstance(y, float):
        x, y = float(x), float(y)
        if x != x or y != y:
            return x != x and y != y
        if x == y:
            return np.signbit(x) == np.signbit(y) or x != 0
        return abs(x - y) <= 1e-9 * max(abs(x), abs(y))
    return x == y


@pytest.fixture(scope="module")
def pages():
    return make_page(REF), make_page(PORT)


@pytest.mark.parametrize("hoist", [False, True], ids=["literal", "hoisted"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_expression_matches_reference(pages, case, hoist):
    want = _values(REF, case, pages[0], hoist)
    got = _values(PORT, case, pages[1], hoist)
    assert len(got) == len(want) == N
    bad = [(i, g, w) for i, (g, w) in enumerate(zip(got, want))
           if not _same(g, w)]
    assert not bad, f"{case}: rows differ (row, port, reference): {bad[:5]}"


def test_page_invariant_subtrees_evaluate_once_per_query(monkeypatch):
    """A subtree without column inputs (DATE + INTERVAL YEAR in q6) runs
    once for all pages that share one params tuple, and again for new
    values."""
    import trino_tpu_torch.expr.functions as F
    calls = []
    real = F._add_months_device
    monkeypatch.setattr(F, "_add_months_device",
                        lambda *a: calls.append(1) or real(*a))
    g = PORT
    expr = call(g, "lt", [c_(g, "ship"), call(g, "date_add_ym", [
        lit(g, d(1994, 1, 1), "DATE"), lit(g, 12, "INTERVAL_YEAR_MONTH")],
        "DATE")], "BOOLEAN")
    canon, params = PH.hoist_literals(expr)
    fn = PE.compile_filter(canon)
    page = make_page(PORT)
    first = fn(page, params)
    for _ in range(3):
        assert torch.equal(fn(page, params), first)
    assert len(calls) == 1
    fn(page, tuple(list(params)))     # a new values tuple re-evaluates
    assert len(calls) == 2
