"""Expression compiler: RowExpression -> torch function over a Page.

Port of `trino_tpu/expr/compiler.py` (reference parity:
sql/gen/ExpressionCompiler.java:56 + PageFunctionCompiler.java:101). Each
tree evaluates node by node as torch tensor ops over the page's columns:
the plain form, which CPU pages run. CUDA pages run K11 instead, one
generated Triton kernel per filter or project step (expr/kernel_gen.py),
and the host-side work below is shared with it: each dictionary fold,
lookup table, page-invariant subtree and padded IN vector is computed by
one function that returns the operand (a scalar, or a device table plus
the output dictionary), and both forms call it.

Null semantics are SQL three-valued logic, carried as (values, valid) pairs:
- default functions: result null iff any input null (RETURNS NULL ON NULL)
- AND/OR: Kleene logic (false AND null = false, true OR null = true)
- comparisons with null: null; WHERE treats null as false (compile_filter)

Dictionary folding happens on the host (dictionaries live there):
  varchar_col = 'FOO'   -> codes == dict.code_of('FOO')
  varchar_col < 'FOO'   -> codes < dict.lower_bound('FOO')
  varchar_col LIKE 'F%' -> gather of a host-computed boolean table by code
so string predicates cost one int32 compare/gather per row on device.
"""

from __future__ import annotations

import re
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.expr import functions as F
from trino_tpu_torch.expr.ir import (
    Call, InputRef, Literal, Param, RowExpression, SpecialForm, SpecialKind)
from trino_tpu_torch.page import Column, Dictionary, Page, _to_device, \
    device_scalar

_COMPARISONS = {"eq", "ne", "lt", "le", "gt", "ge"}

# ---------------------------------------------------------------------------
# Literal-hoisting whitelist (expr/hoist.py consults this table).
#
# Call sites below REQUIRE `isinstance(arg, Literal)` at trace time because
# the literal's VALUE determines trace shape or feeds host-side dictionary
# work: LIKE/regex patterns compile per-pool boolean tables, string-function
# literals parameterize host dictionary transforms, date/format units pick
# the kernel, list lengths size planes. Hoisting one of these into a traced
# Param would either fail loudly (the isinstance checks) or silently bake a
# stale table into a shared kernel — so the hoister leaves the annotated
# argument positions (or, for "all", the entire call) untouched. Every entry
# names the evaluator that owns the constraint, so correctness is auditable
# next to the code that enforces it.
#
#   name -> frozenset of arg positions that must stay Literal, or "all"
#   (skip the whole call — no hoisting anywhere beneath it).
STATIC_LITERAL_ARGS = {
    # _like: pattern + escape build a host like-table over the dictionary
    "like": frozenset({1, 2}),
    # _date_unit_call: the unit string selects the arithmetic at trace time
    "date_trunc": frozenset({0}),
    "date_diff": frozenset({0}),
    "date_add": frozenset({0}),
    # _format_datetime: the pattern formats the whole day domain host-side
    "format_datetime": frozenset({1}),
    "date_format": frozenset({1}),
}
# _string_transform/_string_scalar/_concat_ws (_column_and_literals): every
# literal argument parameterizes a memoized host-side dictionary table, and
# the column argument's subtree is evaluated inside that machinery — keep
# the entire call static.
for _name in ("lower", "upper", "trim", "ltrim", "rtrim", "substr",
              "substring", "concat", "replace", "reverse", "lpad", "rpad",
              "split_part", "regexp_replace", "regexp_extract", "concat_ws",
              "length", "codepoint", "strpos", "regexp_like", "starts_with"):
    STATIC_LITERAL_ARGS[_name] = "all"




def _vand(a: Optional[torch.Tensor], b: Optional[torch.Tensor]):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _table(d: Dictionary, key, host: np.ndarray, device) -> torch.Tensor:
    """A host lookup table over a dictionary as a device tensor, memoized
    beside the host table per device."""
    cache = F._dict_cache(d)
    ck = (key, "device", str(device))
    t = cache.get(ck)
    if t is None:
        t = cache[ck] = torch.from_numpy(np.ascontiguousarray(host)).to(
            device)
    return t


def _take(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """table[codes] with out-of-range codes clipped to the ends."""
    if table.shape[0] == 0:
        return torch.zeros(codes.shape, dtype=table.dtype,
                           device=codes.device)
    return table[codes.long().clamp(0, table.shape[0] - 1)]


def _lit_column(lit: Literal, device) -> Column:
    typ = lit.type
    if lit.value is None:
        return Column(torch.zeros((), dtype=typ.dtype, device=device),
                      torch.zeros((), dtype=torch.bool, device=device),
                      typ, None)
    if T.is_string(typ):
        # projected string literal: singleton dictionary, every row code 0
        d = Dictionary(np.asarray([lit.value], dtype=object))
        return Column(torch.zeros((), dtype=torch.int32, device=device),
                      None, typ, d)
    value = lit.value
    if isinstance(typ, T.DecimalType):
        value = int(value)   # literals carried as ints already scaled
    return Column(device_scalar(value, typ.dtype, device), None, typ, None)


class _Operands:
    """The hoisted literal values of one call of a compiled expression,
    plus the results of its page-invariant subtrees (no column input).
    The executor passes one values tuple for every page of a query, so a
    subtree such as DATE '1994-01-01' + INTERVAL '1' YEAR evaluates once
    per query and device instead of once per page (on the reference's
    device those tiny scalar ops fuse into the page program; here each
    would be a separate kernel launch)."""

    def __init__(self, values, invariant):
        self.values = values
        self.invariant = invariant
        self.memo = {}

    def __getitem__(self, i):
        return self.values[i]


def _invariant_ids(expr: RowExpression, out: set) -> bool:
    """Collect the ids of subtrees without column inputs; True when
    `expr` itself is one."""
    if isinstance(expr, InputRef):
        return False
    kids = [_invariant_ids(a, out) for a in expr.children()]
    if all(kids):
        out.add(id(expr))
        return True
    return False


def _operands_for(state: dict, params, invariant) -> _Operands:
    """The _Operands of this params tuple, reused while the caller keeps
    passing the same tuple object (one query's pages).

    The memo is sound because: `params` is an immutable tuple built once
    per query (compose_chain's param_groups) whose values nothing
    mutates; `state` holds the tuple alive, so a later query's tuple can
    never be the same object; and the memo's id(expr) keys name nodes of
    the one tree this closure holds. It assumes one query at a time per
    compiled closure, as the single-threaded runner of this package
    does. Folding column-free subtrees when the expression is hoisted
    would make it unneeded."""
    ops = state.get("ops")
    if ops is None or ops.values is not params:
        ops = state["ops"] = _Operands(params, invariant)
    return ops


_HOST_PAGE = Page((), torch.zeros((), dtype=torch.int32))


def _to_page_device(t: Optional[torch.Tensor], device):
    if t is None or t.device == device:
        return t
    if t.numel() == 1:
        return torch.full(t.shape, t.item(), dtype=t.dtype, device=device)
    return t.to(device)


def on_device(col: Column, device) -> Column:
    """A host-evaluated invariant's tensors (a list's planes too) moved to
    the page's device."""
    return Column(*[_to_page_device(a, device) for a in (col.values,
                                                         col.valid)],
                  col.type, col.dictionary,
                  *[_to_page_device(a, device) for a in (col.lengths,
                                                         col.aux)],
                  col.aux_dictionary)


def invariant_value(expr: RowExpression, params=()) -> Column:
    """A page-invariant subtree evaluated once on the host: 0-d values
    (and validity, and a dictionary for strings) on the CPU. Scalar math
    runs there because on the card each tiny op would cost a launch."""
    return _eval_node(expr, _HOST_PAGE, params)


def _eval(expr: RowExpression, page: Page, params=()) -> Column:
    if isinstance(params, _Operands) and id(expr) in params.invariant:
        key = (id(expr), page.device)
        hit = params.memo.get(key)
        if hit is None:
            col = invariant_value(expr, params)
            hit = params.memo[key] = on_device(col, page.device)
        return hit
    return _eval_node(expr, page, params)


def _eval_node(expr: RowExpression, page: Page, params=()) -> Column:
    if isinstance(expr, InputRef):
        return page.columns[expr.index]
    if isinstance(expr, Literal):
        return _lit_column(expr, page.device)
    if isinstance(expr, Param):
        # hoisted literal: a 0-d operand of the type's dtype (numeric or
        # temporal, non-null — the same Column _lit_column builds)
        v = np.asarray(params[expr.index])
        return Column(device_scalar(v.item(), expr.type.dtype, page.device), None,
                      expr.type, None)
    if isinstance(expr, Call):
        return _eval_call(expr, page, params)
    if isinstance(expr, SpecialForm):
        return _eval_special(expr, page, params)
    raise TypeError(f"unknown expression node: {expr!r}")


STRING_TRANSFORMS = frozenset((
    "lower", "upper", "trim", "ltrim", "rtrim", "substr", "substring",
    "concat", "replace", "reverse", "lpad", "rpad", "split_part",
    "regexp_replace", "regexp_extract", "concat_ws"))
DATE_UNIT_CALLS = frozenset(("date_trunc", "date_diff", "date_add"))
LIST_CALLS = frozenset(("array_ctor", "cardinality", "element_at",
                        "map_element_at", "contains"))
FORMAT_CALLS = frozenset(("format_datetime", "date_format"))


def _string_side(args) -> bool:
    return any(T.is_string(a.type) for a in args)


def _eval_call(expr: Call, page: Page, params=()) -> Column:
    name = expr.name
    # --- dictionary-folded string paths -----------------------------------
    if name in _COMPARISONS and _string_side(expr.args):
        return _string_comparison(name, expr.args, page, expr.type, params)
    if name == "like":
        return _like(expr, page, params)
    if name in STRING_TRANSFORMS:
        return _string_transform(expr, page, params)
    if name in _STRING_SCALAR_FNS:
        return _string_scalar(expr, page, params)
    if name in DATE_UNIT_CALLS:
        return _date_unit_call(expr, page, params)
    if name == "try_cast":
        return _try_cast(expr, page, params)
    if name in LIST_CALLS:
        return _array_call(expr, page, params)
    if name in FORMAT_CALLS:
        return _format_datetime(expr, page, params)
    if name == "$in_padded":
        return _in_padded(expr, page, params)
    # --- generic null-propagating scalar ----------------------------------
    impl = F.lookup(name)
    args = [_eval(a, page, params) for a in expr.args]
    values = impl(expr.type, [a.type for a in expr.args],
                  *[a.values for a in args])
    if values.device != page.device:    # argument-free constants (pi, e)
        values = values.to(page.device)
    valid = None
    for a in args:
        valid = _vand(valid, a.valid)
    return Column(values, valid, expr.type, None)


def in_padded_members(expr: Call, params) -> np.ndarray:
    """The member vector of a padded IN list (its Param operand)."""
    return np.asarray(params[expr.args[1].index])


def _in_padded(expr: Call, page: Page, params=()) -> Column:
    """Padded fixed-width IN-list membership (expr/hoist._pad_in_chain):
    the member vector arrives as a 1-d operand; the result is null iff the
    needle is null."""
    col = _eval(expr.args[0], page, params)
    vec = _to_device(in_padded_members(expr, params), page.device)
    a, b = F._promote(col.values, vec)
    vals = (a[..., None] == b).any(dim=-1)
    return Column(vals, col.valid, expr.type, None)


def _literal_str(expr: RowExpression) -> Optional[str]:
    if isinstance(expr, Literal) and T.is_string(expr.type):
        return expr.value
    return None


# varchar comparison with a literal -> comparison of the codes with a bound
FOLDED_COMPARISON = {"eq": "eq", "ne": "ne", "lt": "lt", "le": "lt",
                     "gt": "ge", "ge": "ge"}


def fold_string_comparison(d: Optional[Dictionary], name: str,
                           lit: str) -> Tuple[str, int]:
    """`varchar_col <name> 'lit'` as a comparison of the int32 codes with
    one bound of the column's sorted dictionary: (FOLDED_COMPARISON[name],
    bound). An absent literal's code is -1, which no code equals."""
    if d is None:
        raise NotImplementedError("string comparison without dictionary")
    if name in ("eq", "ne"):
        bound = d.code_of(lit)
    elif name in ("lt", "ge"):
        bound = d.lower_bound(lit)
    else:
        bound = d.upper_bound(lit)
    return FOLDED_COMPARISON[name], bound


_CODE_COMPARE = {"eq": torch.eq, "ne": torch.ne, "lt": torch.lt,
                 "ge": torch.ge}


def check_same_dictionary(a: Optional[Dictionary],
                          b: Optional[Dictionary]) -> None:
    if a != b:
        raise NotImplementedError(
            "string column comparison across distinct dictionaries")


def _string_comparison(name: str, args, page: Page, out_type,
                       params=()) -> Column:
    a_lit, b_lit = _literal_str(args[0]), _literal_str(args[1])
    dev = page.device
    if a_lit is not None and b_lit is not None:
        result = {
            "eq": a_lit == b_lit, "ne": a_lit != b_lit, "lt": a_lit < b_lit,
            "le": a_lit <= b_lit, "gt": a_lit > b_lit, "ge": a_lit >= b_lit,
        }[name]
        return Column(device_scalar(result, torch.bool, dev), None, out_type, None)
    if b_lit is None and a_lit is not None:
        flip = {"eq": "eq", "ne": "ne", "lt": "gt", "le": "ge",
                "gt": "lt", "ge": "le"}[name]
        return _string_comparison(flip, (args[1], args[0]), page, out_type,
                                  params)
    col = _eval(args[0], page, params)
    if b_lit is not None:
        op, bound = fold_string_comparison(col.dictionary, name, b_lit)
        return Column(_CODE_COMPARE[op](col.values, bound), col.valid,
                      out_type, None)
    # column vs column: only valid when both sides share one dictionary
    other = _eval(args[1], page, params)
    check_same_dictionary(col.dictionary, other.dictionary)
    vals = F.lookup(name)(out_type, [T.BIGINT, T.BIGINT],
                          col.values, other.values)
    return Column(vals, _vand(col.valid, other.valid), out_type, None)


def like_operand(expr: Call, d: Optional[Dictionary], device
                 ) -> torch.Tensor:
    """LIKE with a literal pattern: a bool table over the dictionary."""
    pattern = _literal_str(expr.args[1])
    if pattern is None or d is None:
        raise NotImplementedError("LIKE requires literal pattern + dictionary")
    escape = None
    if len(expr.args) > 2:
        escape = _literal_str(expr.args[2])
    host = F.like_table(d, pattern, escape)
    return _table(d, ("like", pattern, escape), host.astype(np.bool_),
                  device)


def _like(expr: Call, page: Page, params=()) -> Column:
    col = _eval(expr.args[0], page, params)
    table = like_operand(expr, col.dictionary, page.device)
    return Column(_take(table, col.values), col.valid, expr.type, None)


def column_arg(expr: Call) -> int:
    """The one non-literal argument of a dictionary string function (the
    first argument when all are literals); every other must be literal."""
    col_i = None
    for i, a in enumerate(expr.args):
        if not isinstance(a, Literal):
            if col_i is not None:
                raise NotImplementedError(
                    f"{expr.name} over two non-literal string args")
            col_i = i
    return 0 if col_i is None else col_i


def _with_literals(expr: Call, col_i: int):
    """(call(fn, s) applying fn with the column's string at its argument
    position and the literals elsewhere, memo key)."""
    lit_by_pos = {i: a.value for i, a in enumerate(expr.args) if i != col_i}

    def call(fn, s):
        args = [s if i == col_i else lit_by_pos[i]
                for i in range(len(expr.args))]
        return fn(*args)
    key = (col_i,) + tuple(sorted(lit_by_pos.items()))
    return call, key


def string_transform_operand(expr: Call, d: Optional[Dictionary], device):
    """A str -> str function as a dictionary remap: (output dictionary,
    int32 remap table, bool ok table or None). NULL-producing transforms
    carry the ok table."""
    name = expr.name
    if d is None:
        raise NotImplementedError(f"{name} requires dictionary-encoded input")
    call, akey = _with_literals(expr, column_arg(expr))
    py = _PY_STRING_FNS[name]
    key = (name, akey)
    if name in _NULLABLE_STRING_FNS:
        nd, remap, ok = F.transform_dictionary_nullable(
            d, key, lambda s: call(py, s))
        return (nd, _table(d, (key, "remap-null"), remap, device),
                _table(d, (key, "ok"), ok, device))
    nd, remap = F.transform_dictionary(d, key, lambda s: call(py, s))
    return nd, _table(d, (key, "remap"), remap, device), None


def _string_transform(expr: Call, page: Page, params=()) -> Column:
    """str->str functions as dictionary remap (host transform, device
    gather). NULL-producing transforms carry a per-pool ok-table."""
    if expr.name == "concat_ws":
        return _concat_ws(expr, page, params)
    col = _eval(expr.args[column_arg(expr)], page, params)
    nd, remap, ok = string_transform_operand(expr, col.dictionary,
                                             page.device)
    codes = _take(remap, col.values)
    if ok is None:
        return Column(codes, col.valid, expr.type, nd)
    okv = _take(ok, col.values)
    valid = okv if col.valid is None else (okv & col.valid)
    return Column(codes, valid, expr.type, nd)


def concat_ws_column(expr: Call) -> Optional[int]:
    """The non-literal value argument of concat_ws (None: all literal)."""
    if not isinstance(expr.args[0], Literal):
        raise NotImplementedError("concat_ws separator must be a literal")
    col_i = None
    for i, a in enumerate(expr.args[1:], start=1):
        if not isinstance(a, Literal):
            if col_i is not None:
                raise NotImplementedError(
                    "concat_ws over two non-literal string args")
            col_i = i
    return col_i


def concat_ws_operand(expr: Call, d: Optional[Dictionary], device):
    """concat_ws over one dictionary column (non-NULL separator):
    (output dictionary, int32 remap table, the code of a NULL input)."""
    if d is None:
        raise NotImplementedError("concat_ws requires dictionary input")
    sep = str(expr.args[0].value)
    col_i = concat_ws_column(expr)
    lits = {i: a.value for i, a in enumerate(expr.args) if i != col_i
            and i > 0}

    def join_with(s):
        parts = [lits[i] if i != col_i else s
                 for i in range(1, len(expr.args))]
        return sep.join(str(p) for p in parts if p is not None)

    cache = F._dict_cache(d)
    ck = ("concat_ws", sep, tuple(sorted(lits.items())), col_i, "xform")
    if ck not in cache:
        table = [join_with(s) for s in d.values] + [join_with(None)]
        new_vals, codes = np.unique(np.asarray(table, dtype=object),
                                    return_inverse=True)
        cache[ck] = (Dictionary(new_vals), codes[:-1].astype(np.int32),
                     int(codes[-1]))
    nd, remap, null_code = cache[ck]
    return nd, _table(d, ck, remap, device), null_code


_EMPTY_STRING = Dictionary(np.asarray([""], dtype=object))


def _concat_ws(expr: Call, page: Page, params=()) -> Column:
    """concat_ws(sep, v1, v2, ...): NULL value arguments are skipped; only
    a NULL separator yields NULL (StringFunctions.java concatWs)."""
    dev = page.device
    if not isinstance(expr.args[0], Literal):
        raise NotImplementedError("concat_ws separator must be a literal")
    if expr.args[0].value is None:
        return Column(torch.zeros((), dtype=torch.int32, device=dev),
                      torch.zeros((), dtype=torch.bool, device=dev),
                      expr.type, _EMPTY_STRING)
    col_i = concat_ws_column(expr)
    if col_i is None:
        sep = str(expr.args[0].value)
        joined = sep.join(str(a.value) for a in expr.args[1:]
                          if a.value is not None)
        d = Dictionary(np.asarray([joined], dtype=object))
        return Column(torch.zeros((), dtype=torch.int32, device=dev), None,
                      expr.type, d)
    col = _eval(expr.args[col_i], page, params)
    nd, remap, null_code = concat_ws_operand(expr, col.dictionary, dev)
    out = _take(remap, col.values)
    if col.valid is not None:
        out = torch.where(col.valid, out,
                          device_scalar(null_code, out.dtype, dev))
    return Column(out, None, expr.type, nd)


_STRING_SCALAR_FNS = {
    "length": (lambda s: len(s), torch.int64),
    "codepoint": (lambda s: ord(s[0]) if s else 0, torch.int64),
    "strpos": (lambda s, sub: s.find(sub) + 1, torch.int64),
    "regexp_like": (lambda s, pat: re.search(pat, s) is not None,
                    torch.bool),
    "starts_with": (lambda s, pre: s.startswith(pre), torch.bool),
}


def string_scalar_operand(expr: Call, d: Optional[Dictionary], device
                          ) -> torch.Tensor:
    """A str -> number/bool function as a table over the dictionary."""
    name = expr.name
    if d is None:
        raise NotImplementedError(f"{name} requires dictionary-encoded input")
    call, akey = _with_literals(expr, column_arg(expr))
    fn, dtype = _STRING_SCALAR_FNS[name]
    host = F.dictionary_table(d, (name, akey), lambda s: call(fn, s))
    host = host.astype(T.numpy_dtype_of(dtype)) if host.size \
        else np.zeros(0, dtype=T.numpy_dtype_of(dtype))
    return _table(d, (name, akey), host, device)


def _string_scalar(expr: Call, page: Page, params=()) -> Column:
    """str -> number/bool functions as a memoized per-pool host table +
    device gather."""
    col = _eval(expr.args[column_arg(expr)], page, params)
    table = string_scalar_operand(expr, col.dictionary, page.device)
    return Column(_take(table, col.values), col.valid, expr.type, None)


def date_unit_static(expr: Call) -> tuple:
    """The static arguments of F's date_trunc/date_diff/date_add device
    function for a call with a literal unit."""
    unit_arg = expr.args[0]
    if not isinstance(unit_arg, Literal):
        raise NotImplementedError(f"{expr.name} unit must be a literal")
    unit = str(unit_arg.value).lower()
    if expr.name == "date_trunc":
        return (unit, expr.type)
    if expr.name == "date_diff":
        return (unit, expr.args[1].type, expr.args[2].type)
    return (unit, expr.args[2].type, expr.type)


def _date_unit_call(expr: Call, page: Page, params=()) -> Column:
    """date_trunc / date_diff / date_add with a literal unit."""
    static = date_unit_static(expr)
    rest = [_eval(a, page, params) for a in expr.args[1:]]
    valid = None
    for a in rest:
        valid = _vand(valid, a.valid)
    vals = F.lookup_device(expr.name)(*static, *[a.values for a in rest])
    return Column(vals, valid, expr.type, None)


def _try_cast(expr: Call, page: Page, params=()) -> Column:
    """TRY_CAST: NULL instead of failure. Numeric sources use the
    saturating cast plus an out-of-range mask; varchar sources parse the
    dictionary pool host-side into a value table + an ok-mask table."""
    target = expr.type
    src_t = expr.args[0].type
    col = _eval(expr.args[0], page, params)
    if not T.is_string(src_t):
        values = F.lookup("cast")(target, [src_t], col.values)
        ok = F.numeric_cast_ok(src_t, target, col.values)
        valid = col.valid if ok is None else _vand(col.valid, ok)
        return Column(values, valid, target,
                      col.dictionary if T.is_string(target) else None)
    if col.dictionary is None:
        raise NotImplementedError("try_cast requires dictionary input")
    if T.is_string(target):
        return Column(col.values, col.valid, target, col.dictionary)
    vals, ok = try_cast_operand(target, col.dictionary, page.device)
    okv = _take(ok, col.values)
    valid = okv if col.valid is None else (okv & col.valid)
    return Column(_take(vals, col.values), valid, target, None)


def try_cast_operand(target, d: Dictionary, device):
    """TRY_CAST of a varchar dictionary to `target`: (value table, bool ok
    table), the pool parsed on the host."""
    parse = _py_parser_for(target)
    table = F.dictionary_table(d, ("try_cast", target.display()),
                               lambda s: parse(s))
    vals_np = np.asarray(
        [0 if v is None else v for v in table],
        dtype=T.to_numpy_dtype(target))
    ok_np = np.asarray([v is not None for v in table], dtype=np.bool_)
    key = ("try_cast", target.display())
    return (_table(d, key + ("v",), vals_np, device),
            _table(d, key + ("ok",), ok_np, device))


_DATE_FMT_CACHE: dict = {}
_FMT_BASE_Y, _FMT_END_Y = 1900, 2100


def _joda_to_strftime(pattern: str) -> str:
    """Joda (format_datetime) -> strftime, date-resolution subset."""
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        run = 1
        while i + run < len(pattern) and pattern[i + run] == ch:
            run += 1
        tok = ch * run
        mapping = {"yyyy": "%Y", "yy": "%y", "y": "%Y", "MMMM": "%B",
                   "MMM": "%b", "MM": "%m", "M": "%-m", "dd": "%d",
                   "d": "%-d", "EEEE": "%A", "EEE": "%a", "e": "%u",
                   "DDD": "%j", "D": "%-j"}
        if ch in "HhmsSaKkZzwQx":
            raise NotImplementedError(
                f"format_datetime token {tok!r} unsupported on DATE")
        out.append(mapping.get(tok, tok))
        i += run
    return "".join(out)


def _mysql_to_strftime(pattern: str) -> str:
    """MySQL (date_format) -> strftime, date-resolution subset."""
    out = []
    i = 0
    while i < len(pattern):
        if pattern[i] == "%" and i + 1 < len(pattern):
            c = pattern[i + 1]
            mapping = {"Y": "%Y", "y": "%y", "m": "%m", "c": "%-m",
                       "d": "%d", "e": "%-d", "j": "%j", "W": "%A",
                       "a": "%a", "M": "%B", "b": "%b", "u": "%W",
                       "%": "%%"}
            if c in "HhiSsTrpf":
                raise NotImplementedError(
                    f"date_format time-of-day token %{c} on DATE")
            out.append(mapping.get(c, "%" + c))
            i += 2
        else:
            out.append(pattern[i])
            i += 1
    return "".join(out)


def format_datetime_static(expr: Call) -> tuple:
    """(source is a TIMESTAMP, first day, days) of the day table."""
    pat = expr.args[1]
    if not isinstance(pat, Literal):
        raise NotImplementedError(f"{expr.name} pattern must be a literal")
    src_t = expr.args[0].type
    if not isinstance(src_t, (T.TimestampType, T.DateType)):
        raise NotImplementedError(
            f"{expr.name} over {src_t.display()}")
    _, _, days0, ndays = _format_table(expr.name, pat.value)
    return isinstance(src_t, T.TimestampType), days0, ndays


def format_datetime_operand(expr: Call, device):
    """(output dictionary, int32 code table by day offset)."""
    d, remap, _, _ = _format_table(expr.name, expr.args[1].value)
    return d, _table(d, ("fmt", (expr.name, expr.args[1].value)), remap,
                     device)


def _format_datetime(expr: Call, page: Page, params=()) -> Column:
    """format_datetime/date_format with a literal pattern over DATE (and
    day-resolution TIMESTAMP): the 1900-2100 day domain formats once into
    a memoized dictionary + code table; the device gathers by day."""
    static = format_datetime_static(expr)
    col = _eval(expr.args[0], page, params)
    off = F.day_offset(*static, col.values)
    d, table = format_datetime_operand(expr, page.device)
    codes = _take(table, off)
    return Column(codes.to(torch.int32), col.valid, expr.type, d)


def _format_table(name: str, pattern: str):
    """The memoized day table of one pattern: (dictionary, int32 codes,
    days0, ndays)."""
    key = (name, pattern)
    got = _DATE_FMT_CACHE.get(key)
    if got is None:
        import datetime as _dt
        fmt = _joda_to_strftime(pattern) if name == "format_datetime" \
            else _mysql_to_strftime(pattern)
        base = _dt.date(_FMT_BASE_Y, 1, 1)
        days0 = (base - _dt.date(1970, 1, 1)).days
        ndays = (_dt.date(_FMT_END_Y, 1, 1) - base).days
        strings = np.asarray(
            [(base + _dt.timedelta(days=i)).strftime(fmt)
             for i in range(ndays)]
            + [f"<date out of {_FMT_BASE_Y}-{_FMT_END_Y}>"], dtype=object)
        uniq, remap = np.unique(strings, return_inverse=True)
        got = _DATE_FMT_CACHE[key] = (Dictionary(uniq),
                                      remap.astype(np.int32), days0, ndays)
    return got


def _py_parser_for(target):
    """Python parser matching Trino varchar->X cast semantics; None = NULL."""
    import decimal as _dec
    if isinstance(target, (T.BigintType, T.IntegerType, T.SmallintType,
                           T.TinyintType)):
        def parse_int(s):
            try:
                return int(s.strip())
            except ValueError:
                return None
        return parse_int
    if isinstance(target, (T.DoubleType, T.RealType)):
        def parse_float(s):
            try:
                return float(s.strip())
            except ValueError:
                return None
        return parse_float
    if isinstance(target, T.DecimalType):
        def parse_dec(s):
            try:
                q = _dec.Decimal(s.strip()).scaleb(target.scale)
                return int(q.to_integral_value(rounding=_dec.ROUND_HALF_UP))
            except (_dec.InvalidOperation, ValueError):
                return None
        return parse_dec
    if isinstance(target, T.DateType):
        def parse_date(s):
            try:
                y, m, d = s.strip().split("-")
                return F.days_from_civil(int(y), int(m), int(d))
            except (ValueError, AttributeError):
                return None
        return parse_date
    if isinstance(target, T.BooleanType):
        def parse_bool(s):
            v = s.strip().lower()
            if v in ("true", "t", "1"):
                return True
            if v in ("false", "f", "0"):
                return False
            return None
        return parse_bool
    raise NotImplementedError(f"try_cast to {target.display()}")


def _py_substr(s: str, start: int, length: Optional[int] = None) -> str:
    # SQL substr is 1-based; negative start counts from the end (Trino)
    if start > 0:
        i = start - 1
    elif start < 0:
        i = len(s) + start
        if i < 0:
            return ""
    else:
        return ""
    piece = s[i:]
    if length is not None:
        piece = piece[:max(length, 0)]
    return piece


def _py_pad(s: str, size: int, pad: str, left: bool) -> str:
    # StringFunctions.java lpad/rpad: truncate when longer; cycle the pad
    size = int(size)
    if len(s) >= size:
        return s[:size]
    fill = (pad * ((size - len(s)) // max(len(pad), 1) + 1))[:size - len(s)]
    return fill + s if left else s + fill


def _py_split_part(s: str, delim: str, index: int):
    parts = s.split(delim) if delim else [s]
    return parts[index - 1] if 1 <= index <= len(parts) else None


def _py_regexp_replace(s: str, pattern: str, repl: str = "") -> str:
    # Trino uses $g group references; re wants \g
    return re.sub(pattern, re.sub(r"\$(\d+)", r"\\\1", repl), s)


def _py_regexp_extract(s: str, pattern: str, group: int = 0):
    m = re.search(pattern, s)
    if m is None:
        return None
    return m.group(group)


_PY_STRING_FNS = {
    "lower": lambda s: s.lower(),
    "upper": lambda s: s.upper(),
    "trim": lambda s: s.strip(),
    "ltrim": lambda s: s.lstrip(),
    "rtrim": lambda s: s.rstrip(),
    "substr": _py_substr,
    "substring": _py_substr,
    "concat": lambda s, suffix: s + suffix,
    "replace": lambda s, find, repl="": s.replace(find, repl),
    "reverse": lambda s: s[::-1],
    "lpad": lambda s, size, pad=" ": _py_pad(s, size, pad, True),
    "rpad": lambda s, size, pad=" ": _py_pad(s, size, pad, False),
    "split_part": _py_split_part,
    "regexp_replace": _py_regexp_replace,
    "regexp_extract": _py_regexp_extract,
    "concat_ws": lambda sep, *vals: sep.join(vals),
}

# transforms that may yield NULL per input value (carry an ok-table)
_NULLABLE_STRING_FNS = {"split_part", "regexp_extract"}


def _true(device) -> torch.Tensor:
    return torch.ones((), dtype=torch.bool, device=device)


def _eval_special(expr: SpecialForm, page: Page, params=()) -> Column:
    kind = expr.kind
    if kind is SpecialKind.AND:
        return _kleene_and([_eval(a, page, params) for a in expr.args],
                           expr.type)
    if kind is SpecialKind.OR:
        return _kleene_or([_eval(a, page, params) for a in expr.args],
                          expr.type)
    if kind is SpecialKind.NOT:
        a = _eval(expr.args[0], page, params)
        return Column(~a.values, a.valid, expr.type, None)
    if kind is SpecialKind.IS_NULL:
        a = _eval(expr.args[0], page, params)
        if a.valid is None:
            vals = torch.zeros(a.values.shape, dtype=torch.bool,
                               device=a.values.device)
        else:
            vals = ~a.valid
        return Column(vals, None, expr.type, None)
    if kind is SpecialKind.COALESCE:
        args = [_eval(a, page, params) for a in expr.args]
        dicts = {a.dictionary for a in args if a.dictionary is not None}
        if len(dicts) > 1:
            raise NotImplementedError("COALESCE over distinct dictionaries")
        dictionary = next((a.dictionary for a in args
                           if a.dictionary is not None), None)
        out = args[-1]
        for a in reversed(args[:-1]):
            if a.valid is None:
                out = a
                continue
            av, ov = F._promote(a.values, out.values)
            values = torch.where(a.valid, av, ov)
            valid = a.valid | out.valid if out.valid is not None else None
            out = Column(values, valid, expr.type, dictionary)
        return out
    if kind is SpecialKind.IF:
        return _if_merge(_eval(expr.args[0], page, params),
                         _eval(expr.args[1], page, params),
                         _eval(expr.args[2], page, params), expr.type)
    if kind is SpecialKind.SWITCH:
        # [c1, v1, c2, v2, ..., default] folded right into nested IFs
        args = list(expr.args)
        out = _eval(args[-1], page, params)
        pairs = list(zip(args[:-1:2], args[1:-1:2]))
        for cond_e, val_e in reversed(pairs):
            out = _if_merge(_eval(cond_e, page, params),
                            _eval(val_e, page, params), out,
                            expr.type)
        return out
    if kind is SpecialKind.IN:
        needle = expr.args[0]
        eqs = [Call("eq", (needle, v), T.BOOLEAN) for v in expr.args[1:]]
        return _kleene_or([_eval(e, page, params) for e in eqs], expr.type)
    if kind is SpecialKind.BETWEEN:
        value, low, high = expr.args
        conj = SpecialForm(SpecialKind.AND, (
            Call("ge", (value, low), T.BOOLEAN),
            Call("le", (value, high), T.BOOLEAN)), T.BOOLEAN)
        return _eval(conj, page, params)
    raise TypeError(f"unknown special form: {kind}")


def _if_merge(cond: Column, then: Column, els: Column, out_type) -> Column:
    """IF(cond, then, els) null semantics: null condition selects else."""
    take_then = cond.values
    if cond.valid is not None:
        take_then = take_then & cond.valid
    if (then.dictionary is not None and els.dictionary is not None
            and then.dictionary != els.dictionary):
        then, els = _merge_dictionaries(then, els)
    tvals, evals = F._promote(then.values, els.values)
    values = torch.where(take_then, tvals, evals)
    if then.valid is None and els.valid is None:
        valid = None
    else:
        dev = values.device
        tv = then.valid if then.valid is not None else _true(dev)
        ev = els.valid if els.valid is not None else _true(dev)
        valid = torch.where(take_then, tv, ev)
    dictionary = then.dictionary if then.dictionary is not None \
        else els.dictionary
    return Column(values, valid, out_type, dictionary)


def merge_dictionaries_operand(da: Dictionary, db: Dictionary, device):
    """Two dictionaries rebased onto one union pool: (union, int32 remap
    of a, int32 remap of b), memoized beside a's tables."""
    from trino_tpu_torch.page import union_dictionaries
    cache = F._dict_cache(da)
    ck = ("union", db.fingerprint, str(device))
    got = cache.get(ck)
    if got is None:
        merged, (ra, rb) = union_dictionaries([da, db], device=device)
        got = cache[ck] = (merged, ra, rb)
    return got


def _merge_dictionaries(a: Column, b: Column):
    """Rebase two dictionary columns onto one union pool."""
    merged, ra, rb = merge_dictionaries_operand(a.dictionary, b.dictionary,
                                                a.values.device)
    a2 = Column(_take(ra, a.values), a.valid, a.type, merged)
    b2 = Column(_take(rb, b.values), b.valid, b.type, merged)
    return a2, b2


def _kleene_and(args, out_type) -> Column:
    # false dominates null; null & true = null
    value, valid = args[0].values, args[0].valid
    for a in args[1:]:
        av, an = a.values, a.valid
        new_value = value & av
        if valid is None and an is None:
            new_valid = None
        else:
            v1 = valid if valid is not None else _true(value.device)
            v2 = an if an is not None else _true(value.device)
            # valid iff both valid, or either side is a definite false
            new_valid = (v1 & v2) | (v1 & ~value) | (v2 & ~av)
        value, valid = new_value, new_valid
    return Column(value, valid, out_type, None)


def _kleene_or(args, out_type) -> Column:
    value, valid = args[0].values, args[0].valid
    for a in args[1:]:
        av, an = a.values, a.valid
        new_value = value | av
        if valid is None and an is None:
            new_valid = None
        else:
            v1 = valid if valid is not None else _true(value.device)
            v2 = an if an is not None else _true(value.device)
            # valid iff both valid, or either side is a definite true
            new_valid = (v1 & v2) | (v1 & value) | (v2 & av)
        value, valid = new_value, new_valid
    return Column(value, valid, out_type, None)


def array_ctor_dictionary(dicts, device):
    """array_ctor's dictionary: the arguments' one pool, or their union
    with a remap table per distinct pool (by identity, as the reference
    keys them)."""
    uniq = {id(d): d for d in dicts}
    if len(uniq) == 1:
        return dicts[0], None
    from trino_tpu_torch.page import union_dictionaries
    dictionary, tables = union_dictionaries(list(uniq.values()), device)
    return dictionary, dict(zip(uniq, tables))


def membership_needle(arr: Column, x: Column, arg: RowExpression, rows: int):
    """contains / map_element_at: the searched value in the list's
    element space (a string literal folds to its code in the list's
    pool). Raises the reference's refusal across distinct pools."""
    if arr.dictionary is None or x.dictionary == arr.dictionary:
        return x.values
    if isinstance(arg, Literal):
        code = arr.dictionary.code_of(arg.value)
        return torch.full((rows,), code, dtype=arr.values.dtype,
                          device=arr.values.device)
    raise NotImplementedError(
        "array membership across distinct dictionaries")


def _array_call(expr: Call, page: Page, params=()) -> Column:
    """ARRAY/MAP scalars over the list layout (values [cap, L] +
    lengths; reference: trino_tpu/expr/compiler.py _array_call). Element
    NULLs are not represented: ARRAY[x, NULL] is NULL as a whole. A
    page-invariant call (every argument 0-d, on the host page) runs over
    one row and returns 0-d values (an [L] plane with 0-d lengths for
    array_ctor)."""
    name = expr.name
    args = [_eval(a, page, params) for a in expr.args]
    rowless = all((a.lengths if a.is_list else a.values).dim() == 0
                  for a in args)
    cap = 1 if rowless else page.capacity
    one = (lambda a: None if a is None else a.unsqueeze(0)) if rowless \
        else (lambda a: a)
    cols = []
    for a in args:
        a = a if rowless else _broadcast(a, cap)
        cols.append(Column(one(a.values), one(a.valid), a.type,
                           a.dictionary, one(a.lengths), one(a.aux),
                           a.aux_dictionary))
    out = _list_op(expr, cols, cap)
    if not rowless:
        return out
    first = lambda a: None if a is None else a[0]
    return Column(first(out.values), first(out.valid), out.type,
                  out.dictionary, first(out.lengths), first(out.aux),
                  out.aux_dictionary)


def _list_op(expr: Call, args, cap: int) -> Column:
    name = expr.name
    if name == "array_ctor":
        dicts = [a.dictionary for a in args if a.dictionary is not None]
        dictionary = None
        if dicts:
            dictionary, remap = array_ctor_dictionary(
                dicts, args[0].values.device)
            if remap is not None:
                args = [Column(_take(remap[id(a.dictionary)],
                                     a.values.clamp(min=0)),
                               a.valid, a.type, dictionary)
                        if a.dictionary is not None else a for a in args]
        elem_dt = expr.type.element.dtype
        values = torch.stack([a.values.to(elem_dt) for a in args], dim=1)
        lengths = torch.full((cap,), len(args), dtype=torch.int32,
                             device=values.device)
        valid = None
        for a in args:
            valid = _vand(valid, a.valid)
        return Column(values, valid, expr.type, dictionary, lengths)
    arr = args[0]
    if not arr.is_list:
        raise NotImplementedError(f"{name} over a non-list column")
    L = arr.values.shape[1]
    if name == "cardinality":
        return Column(arr.lengths.to(torch.int64), arr.valid, expr.type,
                      None)
    if name == "element_at":
        i = args[1]
        iv = i.values.to(torch.int32)
        idx = torch.where(iv < 0, arr.lengths + iv, iv - 1)
        inb = (iv != 0) & (idx >= 0) & (idx < arr.lengths)
        vals = torch.gather(arr.values, 1, idx.clamp(0, max(L - 1, 0))
                            .long()[:, None])[:, 0] if L else \
            torch.zeros(cap, dtype=arr.values.dtype,
                        device=arr.values.device)
        valid = _vand(_vand(arr.valid, i.valid), inb)
        return Column(vals, valid, expr.type, arr.dictionary)
    x = args[1]
    xv = membership_needle(arr, x, expr.args[1], cap)
    in_len = torch.arange(L, dtype=torch.int32, device=arr.values.device)[
        None, :] < arr.lengths[:, None]
    match = (arr.values == xv[:, None]) & in_len
    found = match.any(dim=1)
    if name == "contains":
        return Column(found, _vand(arr.valid, x.valid), expr.type, None)
    if L == 0:
        vals = torch.zeros(cap, dtype=arr.aux.dtype, device=found.device)
    else:    # map_element_at: the first matching key wins
        first = match.to(torch.uint8).argmax(dim=1)
        vals = torch.gather(arr.aux, 1, first[:, None])[:, 0]
    valid = _vand(_vand(arr.valid, x.valid), found)
    return Column(vals, valid, expr.type, arr.aux_dictionary)


def _broadcast(col: Column, capacity: int) -> Column:
    """A page-invariant value spread over the page's rows: 0-d values (a
    list invariant's [L] planes with 0-d lengths) expand to the page."""
    values, valid = col.values, col.valid
    if col.is_list:
        if col.lengths.dim() > 0:
            return col if valid is None or valid.dim() > 0 else \
                col.with_valid(valid.expand(capacity))
        rows = lambda a: None if a is None else \
            a.expand((capacity,) + tuple(a.shape))
        return Column(rows(values),
                      None if valid is None else valid.expand(capacity),
                      col.type, col.dictionary, col.lengths.expand(capacity),
                      rows(col.aux), col.aux_dictionary)
    if values.dim() == 0:
        values = values.expand(capacity)
    if valid is not None and valid.dim() == 0:
        valid = valid.expand(capacity)
    if values is col.values and valid is col.valid:
        return col
    return Column(values, valid, col.type, col.dictionary)


# Steps of the plain form run on CUDA pages. The main path runs K11 there,
# so chip_smoke.py holds this at 0 over its queries; comparisons with the
# plain twin on the card count here too.
cuda_evaluations = 0


def _count(page: Page) -> None:
    global cuda_evaluations
    if page.device.type == "cuda":
        cuda_evaluations += 1


def compile_expression(expr: RowExpression) -> Callable[..., Column]:
    """Build fn(page, params=()) -> Column of per-row results (project
    channel). `params` is the positional tuple Param leaves index into."""
    invariant: set = set()
    _invariant_ids(expr, invariant)
    state: dict = {}

    def fn(page: Page, params=()) -> Column:
        _count(page)
        ops = _operands_for(state, params, invariant)
        col = _broadcast(_eval(expr, page, ops), page.capacity)
        contig = lambda a: None if a is None else a.contiguous()
        return Column(contig(col.values), contig(col.valid), col.type,
                      col.dictionary, contig(col.lengths), contig(col.aux),
                      col.aux_dictionary)

    return fn


def compile_filter(expr: RowExpression) -> Callable[..., torch.Tensor]:
    """Build fn(page, params=()) -> bool mask; SQL WHERE: null counts as
    false."""
    invariant: set = set()
    _invariant_ids(expr, invariant)
    state: dict = {}

    def fn(page: Page, params=()) -> torch.Tensor:
        _count(page)
        ops = _operands_for(state, params, invariant)
        col = _broadcast(_eval(expr, page, ops), page.capacity)
        mask = col.values
        if col.valid is not None:
            mask = mask & col.valid
        return mask.contiguous()

    return fn
