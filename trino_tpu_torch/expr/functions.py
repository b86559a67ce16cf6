"""Scalar function registry + builtin implementations over torch tensors.

Port of `trino_tpu/expr/functions.py`. Implementations take value tensors
(0-d for literals and hoisted parameters); the compiler wraps them with
RETURNS NULL ON NULL INPUT semantics (valid = AND of input valids).

Semantics kept bit for bit with the reference:
- integer division/remainder truncate toward zero (Java), never floor;
  x / 0 = -1 and x % 0 = x, INT_MIN / -1 = INT_MIN (what the reference's
  lax.div/lax.rem give), computed without a trapping division;
- CAST(double AS bigint) rounds like Java Math.round: floor(x + 0.5);
- decimal arithmetic on scaled int64 with HALF_UP rescaling;
- logical right shifts on int64 with a mask, as the reference's uint64
  bitcast shifts give them (torch has no uint64 shift on the CPU);
- binary operands promote by dtype alone (int32 column + int64 literal is
  int64), as the reference's non-weak 0-d operands do — torch would keep
  the column's dtype for a 0-d operand.

String functions run against the host-side Dictionary: a per-(dictionary,
op) table is computed once on the host and gathered by code on the device.

Beside each function stands its Triton emission (`@emits`), the body of
the same computation as a template over the argument expressions, which
K11 (expr/kernel_gen.py) strings into one generated kernel per filter or
project step. An emission takes the emitter `g` (kernel_gen.Emitter: typed
expressions, casts, temporaries) and returns an expression whose dtype is
the one the torch form gives; the device helpers it calls (`_tdiv`,
`_civil`, ...) are expr/triton_lib.py's. Constants in an emission come from
the types (decimal scales, units), never from a literal's value.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.page import Dictionary

# impl(out_type, arg_types, *value_tensors) -> value_tensor
_SCALARS: Dict[str, Callable] = {}
# device functions the compiler calls with static arguments other than
# (out_type, arg_types): fn(*static, *value_tensors) -> value_tensor
_DEVICE: Dict[str, Callable] = {}
# Triton emission of a scalar or device function:
# emit(g, *static, *argument expressions) -> expression
_EMITS: Dict[str, Callable] = {}


def scalar(name: str):
    def deco(fn):
        _SCALARS[name] = fn
        return fn
    return deco


def device(name: str):
    def deco(fn):
        _DEVICE[name] = fn
        return fn
    return deco


def emits(name: str):
    def deco(fn):
        _EMITS[name] = fn
        return fn
    return deco


def lookup(name: str) -> Callable:
    if name not in _SCALARS:
        raise KeyError(f"unknown scalar function: {name}")
    return _SCALARS[name]


def lookup_device(name: str) -> Callable:
    return _DEVICE[name]


def emission(name: str) -> Callable:
    """The Triton emission of scalar or device function `name`."""
    if name not in _EMITS:
        raise NotImplementedError(f"{name}: no Triton emission")
    return _EMITS[name]


# ---------------------------------------------------------------------------
# helpers

def _is_decimal(t):
    return isinstance(t, T.DecimalType)


def _is_int(x: torch.Tensor) -> bool:
    return not x.is_floating_point() and x.dtype != torch.bool


def _promote(*xs: torch.Tensor):
    """Cast operands to their common dtype by dtype alone."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return tuple(x if x.dtype == dt else x.to(dt) for x in xs)


def _const(v, like: torch.Tensor, dtype=None) -> torch.Tensor:
    return torch.full((), v, dtype=dtype or like.dtype, device=like.device)


def tdiv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer division truncating toward zero, with the reference's
    results for a zero divisor (-1) and INT_MIN / -1 (INT_MIN)."""
    a, b = _promote(a, b)
    zero = b == 0
    neg1 = b == -1
    safe = torch.where(zero | neg1, torch.ones_like(b), b)
    q = torch.div(a, safe, rounding_mode="trunc")
    q = torch.where(neg1, -a, q)
    return torch.where(zero, torch.full_like(q, -1), q)


def trem(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer remainder with the dividend's sign (Java %); x % 0 = x."""
    a, b = _promote(a, b)
    zero = b == 0
    neg1 = b == -1
    safe = torch.where(zero | neg1, torch.ones_like(b), b)
    r = torch.fmod(a, safe)
    r = torch.where(neg1, torch.zeros_like(r), r)
    return torch.where(zero, a, r)


def logical_shr(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Zero-filling right shift of int64 bits (uint64 >> s). Shift counts
    of 64 or more give 0, as the reference's uint64 shift does."""
    a = a.to(torch.int64)
    s = s.to(torch.int64)
    sc = s.clamp(0, 63)
    shifted = torch.bitwise_right_shift(a, sc)
    # clear the sign-extended high bits: keep the low (64 - s) bits
    keep = torch.bitwise_left_shift(torch.ones_like(sc), 63 - sc)
    keep = (keep - 1) | keep  # low (64 - s) bits set
    out = torch.where(sc == 0, a, shifted & keep)
    # counts outside [0, 64) are huge unsigned counts: every bit shifts out
    return torch.where((s >= 64) | (s < 0), torch.zeros_like(out), out)


def _rescale(values, from_scale: int, to_scale: int):
    """Scaled-int64 rescale with HALF_UP rounding on scale-down."""
    if to_scale == from_scale:
        return values
    if to_scale > from_scale:
        return values * (10 ** (to_scale - from_scale))
    factor = 10 ** (from_scale - to_scale)
    half = factor // 2
    adj = torch.where(values >= 0, values + half, values - half)
    return torch.div(adj, factor, rounding_mode="trunc")


def _rescale_tl(g, v, from_scale: int, to_scale: int):
    if to_scale == from_scale:
        return v
    if to_scale > from_scale:
        return g.op(f"{{}} * {10 ** (to_scale - from_scale)}", v)
    factor = 10 ** (from_scale - to_scale)
    return g.op(f"_rescale_down({{}}, {factor}, {factor // 2})", v)


# ---------------------------------------------------------------------------
# arithmetic

@scalar("add")
def _add(out_type, arg_types, a, b):
    if _is_decimal(out_type):
        a = _rescale(a, arg_types[0].scale, out_type.scale)
        b = _rescale(b, arg_types[1].scale, out_type.scale)
    a, b = _promote(a, b)
    return a + b


@emits("add")
def _add_tl(g, out_type, arg_types, a, b):
    if _is_decimal(out_type):
        a = _rescale_tl(g, a, arg_types[0].scale, out_type.scale)
        b = _rescale_tl(g, b, arg_types[1].scale, out_type.scale)
    a, b = g.promote(a, b)
    return g.op("{} + {}", a, b)


@scalar("subtract")
def _subtract(out_type, arg_types, a, b):
    if _is_decimal(out_type):
        a = _rescale(a, arg_types[0].scale, out_type.scale)
        b = _rescale(b, arg_types[1].scale, out_type.scale)
    a, b = _promote(a, b)
    return a - b


@emits("subtract")
def _subtract_tl(g, out_type, arg_types, a, b):
    if _is_decimal(out_type):
        a = _rescale_tl(g, a, arg_types[0].scale, out_type.scale)
        b = _rescale_tl(g, b, arg_types[1].scale, out_type.scale)
    a, b = g.promote(a, b)
    return g.op("{} - {}", a, b)


@scalar("multiply")
def _multiply(out_type, arg_types, a, b):
    a, b = _promote(a, b)
    if _is_decimal(out_type):
        raw = a * b  # scale = s1 + s2
        return _rescale(raw, arg_types[0].scale + arg_types[1].scale,
                        out_type.scale)
    return a * b


@emits("multiply")
def _multiply_tl(g, out_type, arg_types, a, b):
    a, b = g.promote(a, b)
    if _is_decimal(out_type):
        raw = g.op("{} * {}", a, b)
        return _rescale_tl(g, raw, arg_types[0].scale + arg_types[1].scale,
                           out_type.scale)
    return g.op("{} * {}", a, b)


@scalar("divide")
def _divide(out_type, arg_types, a, b):
    a, b = _promote(a, b)
    if _is_decimal(out_type):
        # one integer division + one HALF_UP rounding at out_type.scale
        shift = out_type.scale + arg_types[1].scale - arg_types[0].scale
        num = a * (10 ** max(shift, 0)) if shift >= 0 else a
        den = b * (10 ** max(-shift, 0)) if shift < 0 else b
        half = tdiv(den.abs(), _const(2, den))
        adj = torch.where((num >= 0) == (den >= 0), num + half, num - half)
        return tdiv(adj, den)
    if _is_int(a):
        return tdiv(a, b)  # truncate toward zero (Java)
    return a / b


@emits("divide")
def _divide_tl(g, out_type, arg_types, a, b):
    a, b = g.promote(a, b)
    if _is_decimal(out_type):
        shift = out_type.scale + arg_types[1].scale - arg_types[0].scale
        num = g.op(f"{{}} * {10 ** shift}", a) if shift > 0 else a
        den = g.op(f"{{}} * {10 ** -shift}", b) if shift < 0 else b
        half = g.op("_idiv(tl.abs({}), 2)", den)
        adj = g.op("tl.where(({} >= 0) == ({} >= 0), {} + {}, {} - {})",
                   num, den, num, half, num, half)
        return g.op("_tdiv({}, {})", adj, den)
    if g.is_int(a):
        return g.op("_tdiv({}, {})", a, b)
    return g.op("{} / {}", a, b)


@scalar("modulus")
def _modulus(out_type, arg_types, a, b):
    a, b = _promote(a, b)
    if _is_int(a):
        return trem(a, b)  # sign of dividend (Java %)
    return torch.fmod(a, b)


@emits("modulus")
def _modulus_tl(g, out_type, arg_types, a, b):
    a, b = g.promote(a, b)
    if g.is_int(a):
        return g.op("_trem({}, {})", a, b)
    return g.op("_fmod({}, {})", a, b)


@scalar("negate")
def _negate(out_type, arg_types, a):
    return -a


@emits("negate")
def _negate_tl(g, out_type, arg_types, a):
    if g.is_float(a):   # Triton's unary minus is 0 - x: +0.0 for 0.0
        return g.op("{} * -1.0", a)
    return g.op("-{}", a)


# ------------------------------------------------------- bitwise / buckets

@scalar("bitwise_and")
def _bitand(out_type, arg_types, a, b):
    return a.to(torch.int64) & b.to(torch.int64)


@emits("bitwise_and")
def _bitand_tl(g, out_type, arg_types, a, b):
    return g.op("{} & {}", g.i64(a), g.i64(b))


@scalar("bitwise_or")
def _bitor(out_type, arg_types, a, b):
    return a.to(torch.int64) | b.to(torch.int64)


@emits("bitwise_or")
def _bitor_tl(g, out_type, arg_types, a, b):
    return g.op("{} | {}", g.i64(a), g.i64(b))


@scalar("bitwise_xor")
def _bitxor(out_type, arg_types, a, b):
    return a.to(torch.int64) ^ b.to(torch.int64)


@emits("bitwise_xor")
def _bitxor_tl(g, out_type, arg_types, a, b):
    return g.op("{} ^ {}", g.i64(a), g.i64(b))


@scalar("bitwise_not")
def _bitnot(out_type, arg_types, a):
    return ~a.to(torch.int64)


@emits("bitwise_not")
def _bitnot_tl(g, out_type, arg_types, a):
    return g.op("~{}", g.i64(a))


@scalar("bitwise_left_shift")
def _bitshl(out_type, arg_types, a, b):
    s = b.to(torch.int64)
    out = torch.bitwise_left_shift(a.to(torch.int64), s.clamp(0, 63))
    return torch.where((s >= 64) | (s < 0), torch.zeros_like(out), out)


@emits("bitwise_left_shift")
def _bitshl_tl(g, out_type, arg_types, a, b):
    return g.op("_shl({}, {})", g.i64(a), g.i64(b))


@scalar("bitwise_right_shift")
def _bitshr(out_type, arg_types, a, b):
    # logical shift (Trino bitwise_right_shift zero-fills)
    return logical_shr(a, b)


@emits("bitwise_right_shift")
def _bitshr_tl(g, out_type, arg_types, a, b):
    return g.op("_lshr({}, {})", g.i64(a), g.i64(b))


@scalar("bitwise_right_shift_arithmetic")
def _bitsar(out_type, arg_types, a, b):
    s = b.to(torch.int64)
    # counts outside [0, 64) fill with the sign bit, as the reference does
    s = torch.where((s >= 64) | (s < 0), torch.full_like(s, 63), s)
    return torch.bitwise_right_shift(a.to(torch.int64), s)


@emits("bitwise_right_shift_arithmetic")
def _bitsar_tl(g, out_type, arg_types, a, b):
    return g.op("_ashr({}, {})", g.i64(a), g.i64(b))


def _popcount64(u: torch.Tensor) -> torch.Tensor:
    """Population count of int64 bit patterns (SWAR, logical shifts)."""
    m1, m2, m4 = 0x5555555555555555, 0x3333333333333333, 0x0F0F0F0F0F0F0F0F
    one = torch.ones((), dtype=torch.int64, device=u.device)
    x = u - (logical_shr(u, one) & m1)
    x = (x & m2) + (logical_shr(x, one * 2) & m2)
    x = (x + logical_shr(x, one * 4)) & m4
    return logical_shr(x * 0x0101010101010101, one * 56)


@scalar("bit_count")
def _bit_count(out_type, arg_types, a, bits):
    """Values not representable in `bits` mask to the low bits."""
    u = a.to(torch.int64)
    b = bits.to(torch.int64)
    mask = torch.where(
        b >= 64, torch.full_like(b, -1),
        torch.bitwise_left_shift(torch.ones_like(b), b.clamp(0, 63)) - 1)
    return _popcount64(u & mask)


@emits("bit_count")
def _bit_count_tl(g, out_type, arg_types, a, bits):
    return g.op("_bit_count({}, {})", g.i64(a), g.i64(bits))


@scalar("width_bucket")
def _width_bucket(out_type, arg_types, x, lo, hi, n):
    x = x.to(torch.float64)
    lo = lo.to(torch.float64)
    hi = hi.to(torch.float64)
    n = n.to(torch.int64)
    b = torch.floor((x - lo) / (hi - lo) * n.to(torch.float64)) + 1
    b = torch.minimum(torch.clamp(b, min=0), (n + 1).to(torch.float64))
    return b.to(torch.int64)


@emits("width_bucket")
def _width_bucket_tl(g, out_type, arg_types, x, lo, hi, n):
    return g.op("_width_bucket({}, {}, {}, {})", g.f64(x), g.f64(lo),
                g.f64(hi), g.i64(n), dtype=torch.int64)


# ---------------------------------------------------------------------------
# comparison (numeric / date / codes)

@scalar("eq")
def _eq(out_type, arg_types, a, b):
    a, b = _promote(a, b)
    return a == b


@emits("eq")
def _eq_tl(g, out_type, arg_types, a, b):
    a, b = g.promote(a, b)
    return g.op("{} == {}", a, b, dtype=torch.bool)


@scalar("ne")
def _ne(out_type, arg_types, a, b):
    a, b = _promote(a, b)
    return a != b


@emits("ne")
def _ne_tl(g, out_type, arg_types, a, b):
    a, b = g.promote(a, b)
    return g.op("{} != {}", a, b, dtype=torch.bool)


@scalar("lt")
def _lt(out_type, arg_types, a, b):
    a, b = _promote(a, b)
    return a < b


@emits("lt")
def _lt_tl(g, out_type, arg_types, a, b):
    a, b = g.promote(a, b)
    return g.op("{} < {}", a, b, dtype=torch.bool)


@scalar("le")
def _le(out_type, arg_types, a, b):
    a, b = _promote(a, b)
    return a <= b


@emits("le")
def _le_tl(g, out_type, arg_types, a, b):
    a, b = g.promote(a, b)
    return g.op("{} <= {}", a, b, dtype=torch.bool)


@scalar("gt")
def _gt(out_type, arg_types, a, b):
    a, b = _promote(a, b)
    return a > b


@emits("gt")
def _gt_tl(g, out_type, arg_types, a, b):
    a, b = g.promote(a, b)
    return g.op("{} > {}", a, b, dtype=torch.bool)


@scalar("ge")
def _ge(out_type, arg_types, a, b):
    a, b = _promote(a, b)
    return a >= b


@emits("ge")
def _ge_tl(g, out_type, arg_types, a, b):
    a, b = g.promote(a, b)
    return g.op("{} >= {}", a, b, dtype=torch.bool)


# ---------------------------------------------------------------------------
# math

@scalar("abs")
def _abs(out_type, arg_types, a):
    return a.abs()


@emits("abs")
def _abs_tl(g, out_type, arg_types, a):
    return g.op("tl.abs({})", a)


@scalar("ceil")
def _ceil(out_type, arg_types, a):
    if _is_decimal(arg_types[0]):
        f = _const(10 ** arg_types[0].scale, a)
        q = tdiv(a, f)
        return q + ((trem(a, f) > 0) & (a > 0)).to(torch.int64)
    if _is_int(a):
        return a
    return torch.ceil(a)


@emits("ceil")
def _ceil_tl(g, out_type, arg_types, a):
    if _is_decimal(arg_types[0]):
        f = 10 ** arg_types[0].scale
        return g.op(f"_idiv({{}}, {f}) + ((_irem({{}}, {f}) > 0) "
                    f"& ({{}} > 0)).to(tl.int64)", a, a, a)
    if g.is_int(a):
        return a
    return g.op("_ceil({})", a)


@scalar("floor")
def _floor(out_type, arg_types, a):
    if _is_decimal(arg_types[0]):
        f = _const(10 ** arg_types[0].scale, a)
        q = tdiv(a, f)
        return q - ((trem(a, f) < 0) & (a < 0)).to(torch.int64)
    if _is_int(a):
        return a
    return torch.floor(a)


@emits("floor")
def _floor_tl(g, out_type, arg_types, a):
    if _is_decimal(arg_types[0]):
        f = 10 ** arg_types[0].scale
        return g.op(f"_idiv({{}}, {f}) - ((_irem({{}}, {f}) < 0) "
                    f"& ({{}} < 0)).to(tl.int64)", a, a, a)
    if g.is_int(a):
        return a
    return g.op("_floor({})", a)


@scalar("round")
def _round(out_type, arg_types, a):
    if _is_decimal(arg_types[0]):
        return _rescale(a, arg_types[0].scale, 0)
    if _is_int(a):
        return a
    # Trino rounds half away from zero
    return torch.where(a >= 0, torch.floor(a + 0.5), torch.ceil(a - 0.5))


@emits("round")
def _round_tl(g, out_type, arg_types, a):
    if _is_decimal(arg_types[0]):
        return _rescale_tl(g, a, arg_types[0].scale, 0)
    if g.is_int(a):
        return a
    return g.op("tl.where({} >= 0, _floor({} + 0.5), _ceil({} - 0.5))",
                a, a, a)


def _pow10_int(e: torch.Tensor) -> torch.Tensor:
    """10 ** e for int64 e in [0, 17], exactly."""
    return torch.pow(10, e.clamp(0, 17))


@scalar("round_digits")
def _round_digits(out_type, arg_types, a, d):
    """round(x, d), half away from zero."""
    keep = d.to(torch.int64)
    if _is_decimal(arg_types[0]):
        scale = arg_types[0].scale
        step = _pow10_int(scale - keep)
        half = torch.div(step, 2, rounding_mode="floor")
        mag = torch.div(a.abs() + half, step, rounding_mode="floor") * step
        rounded = torch.where(a >= 0, mag, -mag).to(torch.int64)
        return torch.where(keep >= scale, a, rounded)
    if _is_int(a):
        p = _pow10_int(-keep)
        half = torch.div(p, 2, rounding_mode="floor")
        mag = torch.div(a.abs() + half, p, rounding_mode="floor") * p
        rounded = torch.where(a >= 0, mag, -mag).to(a.dtype)
        return torch.where(keep >= 0, a, rounded)
    f = torch.pow(10.0, d.to(torch.float64))
    scaled = a * f
    return torch.where(scaled >= 0, torch.floor(scaled + 0.5),
                       torch.ceil(scaled - 0.5)) / f


@emits("round_digits")
def _round_digits_tl(g, out_type, arg_types, a, d):
    keep = g.i64(d)
    if _is_decimal(arg_types[0]):
        scale = arg_types[0].scale
        return g.op(f"_round_dec({{}}, {{}}, {scale})", a, keep)
    if g.is_int(a):
        return g.op("_round_int({}, {})", a, keep)
    f = g.op("_pow({}, {})", g.const(10.0, torch.float64), g.f64(d))
    scaled = g.op("{} * {}", *g.arith(a, f))
    rounded = g.op("tl.where({} >= 0, _floor({} + 0.5), _ceil({} - 0.5))",
                   scaled, scaled, scaled)
    return g.op("{} / {}", *g.arith(rounded, f))


def _f64(a):
    return a.to(torch.float64)


@scalar("sqrt")
def _sqrt(out_type, arg_types, a):
    return torch.sqrt(a if a.is_floating_point() else _f64(a))


def _float_arg(g, a):
    return a if g.is_float(a) else g.f64(a)


@emits("sqrt")
def _sqrt_tl(g, out_type, arg_types, a):
    return g.op("_sqrt({})", _float_arg(g, a))


@scalar("power")
def _power(out_type, arg_types, a, b):
    a, b = _promote(a, b)
    return torch.pow(a, b)


@emits("power")
def _power_tl(g, out_type, arg_types, a, b):
    a, b = g.promote(a, b)
    if g.is_int(a):
        return g.op("_ipow({}, {})", a, b)   # torch's integer pow
    return g.op("_pow({}, {})", a, b)


@scalar("exp")
def _exp(out_type, arg_types, a):
    return torch.exp(a if a.is_floating_point() else _f64(a))


@emits("exp")
def _exp_tl(g, out_type, arg_types, a):
    return g.op("_exp({})", _float_arg(g, a))


@scalar("ln")
def _ln(out_type, arg_types, a):
    return torch.log(a if a.is_floating_point() else _f64(a))


@emits("ln")
def _ln_tl(g, out_type, arg_types, a):
    return g.op("_log({})", _float_arg(g, a))


@scalar("log10")
def _log10(out_type, arg_types, a):
    return torch.log10(a if a.is_floating_point() else _f64(a))


@emits("log10")
def _log10_tl(g, out_type, arg_types, a):
    return g.op("_log10({})", _float_arg(g, a))


@scalar("cbrt")
def _cbrt(out_type, arg_types, a):
    x = _f64(a)
    return torch.sign(x) * torch.pow(x.abs(), 1.0 / 3.0)


@emits("cbrt")
def _cbrt_tl(g, out_type, arg_types, a):
    x = g.f64(a)
    return g.op("_fsign({}) * _pow(tl.abs({}), {})", x, x,
                g.const(1.0 / 3.0, torch.float64))


@scalar("log2")
def _log2(out_type, arg_types, a):
    return torch.log2(_f64(a))


@emits("log2")
def _log2_tl(g, out_type, arg_types, a):
    return g.op("_log2({})", g.f64(a))


@scalar("log")
def _log(out_type, arg_types, b, x):
    # Trino log(b, x) = ln(x) / ln(b)
    return torch.log(_f64(x)) / torch.log(_f64(b))


@emits("log")
def _log_tl(g, out_type, arg_types, b, x):
    return g.op("_log({}) / _log({})", g.f64(x), g.f64(b))


@scalar("radians")
def _radians(out_type, arg_types, a):
    return torch.deg2rad(_f64(a))


@emits("radians")
def _radians_tl(g, out_type, arg_types, a):
    # torch.deg2rad multiplies by pi / 180 as one double
    return g.op("{} * {}", g.f64(a), g.const(math.pi / 180.0, torch.float64))


@scalar("degrees")
def _degrees(out_type, arg_types, a):
    return torch.rad2deg(_f64(a))


@emits("degrees")
def _degrees_tl(g, out_type, arg_types, a):
    return g.op("{} * {}", g.f64(a), g.const(180.0 / math.pi, torch.float64))


for _trig, _tfn in (("sin", torch.sin), ("cos", torch.cos),
                    ("tan", torch.tan), ("asin", torch.asin),
                    ("acos", torch.acos), ("atan", torch.atan),
                    ("sinh", torch.sinh), ("cosh", torch.cosh),
                    ("tanh", torch.tanh)):
    def _mk(tfn):
        def impl(out_type, arg_types, a):
            return tfn(_f64(a))
        return impl

    def _mk_tl(name):
        def emit(g, out_type, arg_types, a):
            return g.op(f"_{name}({{}})", g.f64(a))
        return emit
    _SCALARS[_trig] = _mk(_tfn)
    _EMITS[_trig] = _mk_tl(_trig)


@scalar("atan2")
def _atan2(out_type, arg_types, a, b):
    return torch.atan2(_f64(a), _f64(b))


@emits("atan2")
def _atan2_tl(g, out_type, arg_types, a, b):
    return g.op("_atan2({}, {})", g.f64(a), g.f64(b))


@scalar("pi")
def _pi(out_type, arg_types):
    return torch.tensor(math.pi, dtype=torch.float64)


@emits("pi")
def _pi_tl(g, out_type, arg_types):
    return g.const(math.pi, torch.float64)


@scalar("e")
def _e(out_type, arg_types):
    return torch.tensor(math.e, dtype=torch.float64)


@emits("e")
def _e_tl(g, out_type, arg_types):
    return g.const(math.e, torch.float64)


@scalar("truncate")
def _truncate(out_type, arg_types, a, n=None):
    a = _f64(a)
    if n is None:
        return torch.trunc(a)
    factor = torch.pow(10.0, _f64(n))
    return torch.trunc(a * factor) / factor


@emits("truncate")
def _truncate_tl(g, out_type, arg_types, a, n=None):
    a = g.f64(a)
    if n is None:
        return g.op("_trunc({})", a)
    factor = g.op("_pow({}, {})", g.const(10.0, torch.float64), g.f64(n))
    return g.op("_trunc({} * {}) / {}", a, factor, factor)


@scalar("sign")
def _sign(out_type, arg_types, a):
    return torch.sign(a)


@emits("sign")
def _sign_tl(g, out_type, arg_types, a):
    if g.is_float(a):
        return g.op("_fsign({})", a)
    return g.op(f"tl.where({{}} > 0, 1, tl.where({{}} < 0, -1, 0))"
                f".to({g.tl_dtype(a)})", a, a)


@scalar("greatest")
def _greatest(out_type, arg_types, *args):
    args = _promote(*args)
    out = args[0]
    for a in args[1:]:
        out = torch.maximum(out, a)
    return out


@emits("greatest")
def _greatest_tl(g, out_type, arg_types, *args):
    args = g.promote(*args)
    out = args[0]
    for a in args[1:]:   # torch.maximum propagates NaN
        out = g.op("_max({}, {})", out, a)
    return out


@scalar("least")
def _least(out_type, arg_types, *args):
    args = _promote(*args)
    out = args[0]
    for a in args[1:]:
        out = torch.minimum(out, a)
    return out


@emits("least")
def _least_tl(g, out_type, arg_types, *args):
    args = g.promote(*args)
    out = args[0]
    for a in args[1:]:
        out = g.op("_min({}, {})", out, a)
    return out


# ---------------------------------------------------------------------------
# date/time. DATE = int32 days since epoch; civil-date math in pure integer
# ops (reference: scalar/DateTimeFunctions.java).

def _i64(x) -> torch.Tensor:
    return x.to(torch.int64)


def _fdiv(a, k: int):
    """Division of an int64 tensor by a positive constant, truncating."""
    return torch.div(a, k, rounding_mode="trunc")


def _civil_from_days(days):
    """days since 1970-01-01 -> (year, month, day), proleptic Gregorian."""
    z = _i64(days) + 719468
    era = _fdiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(torch.int64)
    return y, m, d


def days_from_civil(y: int, m: int, d: int) -> int:
    """Host-side inverse (for literals/boundaries)."""
    y -= m <= 2
    era = (y if y >= 0 else y - 399) // 400
    yoe = y - era * 400
    doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


@scalar("year")
def _year(out_type, arg_types, a):
    y, _, _ = _civil_from_days(_days_of(arg_types[0], a))
    return y


def _civil_tl(g, typ, a, part: int):
    days = g.i64(_days_of_tl(g, typ, a))
    return g.multi("_civil({})", 3, torch.int64, days)[part]


@emits("year")
def _year_tl(g, out_type, arg_types, a):
    return _civil_tl(g, arg_types[0], a, 0)


@scalar("month")
def _month(out_type, arg_types, a):
    _, m, _ = _civil_from_days(_days_of(arg_types[0], a))
    return m


@emits("month")
def _month_tl(g, out_type, arg_types, a):
    return _civil_tl(g, arg_types[0], a, 1)


@scalar("day")
def _day(out_type, arg_types, a):
    _, _, d = _civil_from_days(_days_of(arg_types[0], a))
    return d


@emits("day")
def _day_tl(g, out_type, arg_types, a):
    return _civil_tl(g, arg_types[0], a, 2)


@scalar("quarter")
def _quarter(out_type, arg_types, a):
    _, m, _ = _civil_from_days(_days_of(arg_types[0], a))
    return _fdiv(m - 1, 3) + 1


@emits("quarter")
def _quarter_tl(g, out_type, arg_types, a):
    m = _civil_tl(g, arg_types[0], a, 1)
    return g.op("_idiv({} - 1, 3) + 1", m)


def _days_of(typ, a):
    if isinstance(typ, T.DateType):
        return a
    if isinstance(typ, T.TimestampType):
        mpd = 86_400_000_000
        return _fdiv(torch.where(a >= 0, a, a - mpd + 1), mpd)
    raise TypeError(f"not a temporal type: {typ}")


def _days_of_tl(g, typ, a):
    if isinstance(typ, T.DateType):
        return a
    if isinstance(typ, T.TimestampType):
        return g.op("_ts_days({})", a)
    raise TypeError(f"not a temporal type: {typ}")


def _days_from_civil_device(y, m, d):
    yy = y - (m <= 2).to(torch.int64)
    era = _fdiv(torch.where(yy >= 0, yy, yy - 399), 400)
    yoe = yy - era * 400
    doy = _fdiv(153 * (m + torch.where(m > 2, -3, 9)) + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _add_months_device(days, months):
    """date + interval year-month with end-of-month clamping."""
    y, m, d = _civil_from_days(days)
    total = y * 12 + (m - 1) + _i64(months)
    ny = _fdiv(torch.where(total >= 0, total, total - 11), 12)
    nm = total - ny * 12 + 1
    leap = ((trem(ny, _const(4, ny)) == 0)
            & (trem(ny, _const(100, ny)) != 0)
            | (trem(ny, _const(400, ny)) == 0))
    # month length: 31 except Apr/Jun/Sep/Nov (30) and Feb (28, 29 leap)
    length = 31 - ((nm == 4) | (nm == 6) | (nm == 9) | (nm == 11)).to(
        torch.int64) - (nm == 2).to(torch.int64) * 3 \
        + ((nm == 2) & leap).to(torch.int64)
    nd = torch.minimum(d, length)
    return _days_from_civil_device(ny, nm, nd).to(torch.int32)
# Triton form: triton_lib._add_months (the same steps)


@scalar("day_of_week")
def _day_of_week(out_type, arg_types, a):
    # ISO: 1 = Monday .. 7 = Sunday (1970-01-01 was a Thursday)
    days = _i64(_days_of(arg_types[0], a))
    return torch.remainder(days + 3, 7) + 1


@emits("day_of_week")
def _day_of_week_tl(g, out_type, arg_types, a):
    days = g.i64(_days_of_tl(g, arg_types[0], a))
    return g.op("_floormod({} + 3, 7) + 1", days)


def _trunc_year_days(days):
    y, _, _ = _civil_from_days(days)
    one = torch.ones_like(y)
    return _days_from_civil_device(y, one, one)


@scalar("day_of_year")
def _day_of_year(out_type, arg_types, a):
    days = _i64(_days_of(arg_types[0], a))
    return days - _trunc_year_days(days) + 1


@emits("day_of_year")
def _day_of_year_tl(g, out_type, arg_types, a):
    days = g.i64(_days_of_tl(g, arg_types[0], a))
    year = _civil_tl(g, arg_types[0], a, 0)
    return g.op("{} - _year_start({}) + 1", days, year)


@scalar("week")
def _week(out_type, arg_types, a):
    # ISO 8601 week-of-year: the week containing this date's Thursday
    days = _i64(_days_of(arg_types[0], a))
    dow0 = torch.remainder(days + 3, 7)          # 0 = Monday
    thursday = days - dow0 + 3
    return _fdiv(thursday - _trunc_year_days(thursday), 7) + 1


@emits("week")
def _week_tl(g, out_type, arg_types, a):
    days = g.i64(_days_of_tl(g, arg_types[0], a))
    return g.op("_iso_week({})", days)


@scalar("last_day_of_month")
def _last_day_of_month(out_type, arg_types, a):
    days = _i64(_days_of(arg_types[0], a))
    y, m, _ = _civil_from_days(days)
    nxt_m = torch.where(m == 12, torch.ones_like(m), m + 1)
    nxt_y = torch.where(m == 12, y + 1, y)
    return (_days_from_civil_device(nxt_y, nxt_m, torch.ones_like(m)) - 1) \
        .to(torch.int32)


@emits("last_day_of_month")
def _last_day_of_month_tl(g, out_type, arg_types, a):
    days = g.i64(_days_of_tl(g, arg_types[0], a))
    return g.op("_last_day_of_month({})", days, dtype=torch.int32)


def date_trunc_days(unit: str, days):  # Triton: triton_lib._trunc_days
    """DATE date_trunc (DateTimeFunctions.java truncateDate analog)."""
    days = _i64(days)
    if unit == "day":
        return days.to(torch.int32)
    if unit == "week":
        return (days - torch.remainder(days + 3, 7)).to(torch.int32)
    y, m, _ = _civil_from_days(days)
    one = torch.ones_like(y)
    if unit == "month":
        return _days_from_civil_device(y, m, one).to(torch.int32)
    if unit == "quarter":
        qm = _fdiv(m - 1, 3) * 3 + 1
        return _days_from_civil_device(y, qm, one).to(torch.int32)
    if unit == "year":
        return _days_from_civil_device(y, one, one).to(torch.int32)
    raise NotImplementedError(f"date_trunc unit {unit!r} on DATE")


def date_diff_days(unit: str, a, b):
    """date_diff(unit, a, b) = b - a in whole units."""
    a = _i64(a)
    b = _i64(b)
    if unit == "day":
        return b - a
    if unit == "week":
        return _fdiv(b - a, 7)
    if unit in ("month", "quarter", "year"):
        ay, am, ad = _civil_from_days(a)
        by, bm, bd = _civil_from_days(b)
        months = (by - ay) * 12 + (bm - am)
        months = months - ((months > 0) & (bd < ad)).to(torch.int64)
        months = months + ((months < 0) & (bd > ad)).to(torch.int64)
        if unit == "month":
            return months
        return _fdiv(months, 3 if unit == "quarter" else 12)
    raise NotImplementedError(f"date_diff unit {unit!r} on DATE")


def date_add_days(unit: str, n, days):
    if unit == "day":
        return (days + n).to(torch.int32)
    if unit == "week":
        return (days + 7 * n).to(torch.int32)
    if unit == "month":
        return _add_months_device(days, n)
    if unit == "quarter":
        return _add_months_device(days, 3 * n)
    if unit == "year":
        return _add_months_device(days, 12 * n)
    raise NotImplementedError(f"date_add unit {unit!r} on DATE")


_DATE_UNITS_TS = {"second": 1_000_000, "minute": 60_000_000,
                  "hour": 3_600_000_000, "day": 86_400_000_000,
                  "millisecond": 1_000}
_DAY_UNITS = {"day": 0, "week": 1, "month": 2, "quarter": 3, "year": 4}


@device("date_trunc")
def date_trunc(unit: str, out_type, v):
    """date_trunc(unit, v) with a literal unit, DATE or TIMESTAMP."""
    if isinstance(out_type, T.DateType):
        return date_trunc_days(unit, v)
    if unit in _DATE_UNITS_TS:
        step = _DATE_UNITS_TS[unit]
        v = v.to(torch.int64)
        return torch.div(torch.where(v >= 0, v, v - step + 1), step,
                         rounding_mode="trunc") * step
    raise NotImplementedError(
        f"date_trunc({unit!r}) on {out_type.display()}")


@emits("date_trunc")
def _date_trunc_tl(g, unit: str, out_type, v):
    if isinstance(out_type, T.DateType):
        if unit not in _DAY_UNITS:
            raise NotImplementedError(f"date_trunc unit {unit!r} on DATE")
        return g.op(f"_trunc_days({{}}, {_DAY_UNITS[unit]})", g.i64(v),
                    dtype=torch.int32)
    step = _DATE_UNITS_TS[unit]
    v = g.i64(v)
    return g.op(f"_idiv(tl.where({{}} >= 0, {{}}, {{}} - {step - 1}), "
                f"{step}) * {step}", v, v, v)


@device("date_diff")
def date_diff(unit: str, at, bt, a, b):
    """date_diff(unit, a, b) with a literal unit."""
    if isinstance(at, T.DateType) and isinstance(bt, T.DateType):
        return date_diff_days(unit, a, b)
    if isinstance(at, T.TimestampType) and \
            isinstance(bt, T.TimestampType) and unit in _DATE_UNITS_TS:
        return torch.div(b.to(torch.int64) - a.to(torch.int64),
                         _DATE_UNITS_TS[unit], rounding_mode="trunc")
    raise NotImplementedError(
        f"date_diff({unit!r}) over {at.display()}, {bt.display()}")


@emits("date_diff")
def _date_diff_tl(g, unit: str, at, bt, a, b):
    a, b = g.i64(a), g.i64(b)
    if isinstance(at, T.DateType):
        if unit not in _DAY_UNITS:
            raise NotImplementedError(f"date_diff unit {unit!r} on DATE")
        return g.op(f"_diff_days({{}}, {{}}, {_DAY_UNITS[unit]})", a, b)
    return g.op(f"_idiv({{}} - {{}}, {_DATE_UNITS_TS[unit]})", b, a)


@device("date_add")
def date_add(unit: str, dt, out_type, n, d):
    """date_add(unit, n, temporal) with a literal unit."""
    if isinstance(out_type, T.DateType) and isinstance(dt, T.DateType):
        return date_add_days(unit, n.to(torch.int64), d)
    if isinstance(dt, T.TimestampType) and unit in _DATE_UNITS_TS:
        return d.to(torch.int64) + n.to(torch.int64) * _DATE_UNITS_TS[unit]
    raise NotImplementedError(f"date_add({unit!r}) on {dt.display()}")


@emits("date_add")
def _date_add_tl(g, unit: str, dt, out_type, n, d):
    n = g.i64(n)
    if isinstance(dt, T.DateType):
        if unit not in _DAY_UNITS:
            raise NotImplementedError(f"date_add unit {unit!r} on DATE")
        return g.op(f"_add_days({{}}, {{}}, {_DAY_UNITS[unit]})", n,
                    g.i64(d), dtype=torch.int32)
    return g.op(f"{{}} + {{}} * {_DATE_UNITS_TS[unit]}", g.i64(d), n)


@scalar("date_add_ym")
def _date_add_ym(out_type, arg_types, days, months):
    return _add_months_device(days, months)


@emits("date_add_ym")
def _date_add_ym_tl(g, out_type, arg_types, days, months):
    return g.op("_add_months({}, {})", g.i64(days), g.i64(months),
                dtype=torch.int32)


@scalar("date_add_dt")
def _date_add_dt(out_type, arg_types, days, micros):
    return (_i64(days) + tdiv(_i64(micros),
                              _const(86_400_000_000, micros,
                                     torch.int64))).to(torch.int32)


@emits("date_add_dt")
def _date_add_dt_tl(g, out_type, arg_types, days, micros):
    return g.op("({} + _idiv({}, 86400000000)).to(tl.int32)", g.i64(days),
                g.i64(micros), dtype=torch.int32)


# ---------------------------------------------------------------------------
# casts

@scalar("cast")
def _cast(out_type, arg_types, a):
    src = arg_types[0]
    if src == out_type:
        return a
    if isinstance(out_type, T.DoubleType):
        if _is_decimal(src):
            return _f64(a) / (10.0 ** src.scale)
        return _f64(a)
    if isinstance(out_type, T.RealType):
        if _is_decimal(src):
            return (_f64(a) / (10.0 ** src.scale)).to(torch.float32)
        return a.to(torch.float32)
    if isinstance(out_type, (T.BigintType, T.IntegerType, T.SmallintType,
                             T.TinyintType)):
        if isinstance(src, (T.DoubleType, T.RealType)):
            # Java Math.round: floor(x + 0.5), saturating like XLA's cast
            x = torch.floor(_f64(a) + 0.5)
            return _saturating_int(x, out_type.dtype)
        if _is_decimal(src):
            return _rescale(a, src.scale, 0).to(out_type.dtype)
        return a.to(out_type.dtype)
    if _is_decimal(out_type):
        if _is_decimal(src):
            return _rescale(a, src.scale, out_type.scale)
        if isinstance(src, (T.DoubleType, T.RealType)):
            scaled = _f64(a) * (10.0 ** out_type.scale)
            x = torch.floor(scaled + torch.where(scaled >= 0, 0.5, -0.5))
            return _saturating_int(x, torch.int64)
        if T.is_integral(src):
            return a.to(torch.int64) * (10 ** out_type.scale)
    if isinstance(out_type, T.TimestampType) and isinstance(src, T.DateType):
        return a.to(torch.int64) * 86_400_000_000
    if isinstance(out_type, T.DateType) and isinstance(src, T.TimestampType):
        return _days_of(src, a).to(torch.int32)
    if isinstance(out_type, T.BooleanType):
        return a != 0
    if isinstance(src, T.BooleanType) and T.is_numeric(out_type):
        return a.to(out_type.dtype)
    raise NotImplementedError(f"cast {src} -> {out_type}")


def _saturating_int(x: torch.Tensor, dtype) -> torch.Tensor:
    """float -> int conversion that clamps out-of-range values and maps
    NaN to 0, as the reference's XLA convert does (torch's is undefined)."""
    info = torch.iinfo(dtype)
    hi = float(info.max)
    out = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    big = out >= hi
    small = out <= float(info.min)
    res = out.clamp(float(info.min), hi).to(dtype)
    res = torch.where(big, torch.full_like(res, info.max), res)
    return torch.where(small, torch.full_like(res, info.min), res)


def _saturating_int_tl(g, x, dtype):
    info = torch.iinfo(dtype)
    return g.op(f"_saturate({{}}, {{}}, {{}}, {g.int_lit(int(info.min))}, "
                f"{int(info.max)}).to({g.tl_name(dtype)})", x,
                g.const(float(info.min), torch.float64),
                g.const(float(info.max), torch.float64), dtype=dtype)


@emits("cast")
def _cast_tl(g, out_type, arg_types, a):
    src = arg_types[0]
    if src == out_type:
        return a
    if isinstance(out_type, T.DoubleType):
        if _is_decimal(src):
            return g.op("{} / {}", g.f64(a),
                        g.const(10.0 ** src.scale, torch.float64))
        return g.f64(a)
    if isinstance(out_type, T.RealType):
        if _is_decimal(src):
            return g.to(g.op("{} / {}", g.f64(a),
                             g.const(10.0 ** src.scale, torch.float64)),
                        torch.float32)
        return g.to(a, torch.float32)
    if isinstance(out_type, (T.BigintType, T.IntegerType, T.SmallintType,
                             T.TinyintType)):
        if isinstance(src, (T.DoubleType, T.RealType)):
            x = g.op("_floor({} + 0.5)", g.f64(a))
            return _saturating_int_tl(g, x, out_type.dtype)
        if _is_decimal(src):
            return g.to(_rescale_tl(g, a, src.scale, 0), out_type.dtype)
        return g.to(a, out_type.dtype)
    if _is_decimal(out_type):
        if _is_decimal(src):
            return _rescale_tl(g, a, src.scale, out_type.scale)
        if isinstance(src, (T.DoubleType, T.RealType)):
            scaled = g.op("{} * {}", g.f64(a),
                          g.const(10.0 ** out_type.scale, torch.float64))
            x = g.op("_floor({} + tl.where({} >= 0, 0.5, -0.5))", scaled,
                     scaled)
            return _saturating_int_tl(g, x, torch.int64)
        if T.is_integral(src):
            return g.op(f"{{}} * {10 ** out_type.scale}", g.i64(a))
    if isinstance(out_type, T.TimestampType) and isinstance(src, T.DateType):
        return g.op("{} * 86400000000", g.i64(a))
    if isinstance(out_type, T.DateType) and isinstance(src, T.TimestampType):
        return g.to(_days_of_tl(g, src, a), torch.int32)
    if isinstance(out_type, T.BooleanType):
        return g.op("{} != 0", a, dtype=torch.bool)
    if isinstance(src, T.BooleanType) and T.is_numeric(out_type):
        return g.to(a, out_type.dtype)
    raise NotImplementedError(f"cast {src} -> {out_type}")


_INT_TYPES = (T.BigintType, T.IntegerType, T.SmallintType, T.TinyintType)
_I64 = (-(1 << 63), (1 << 63) - 1)


def _int_range_ok(v: torch.Tensor, lo: int, hi: int
                  ) -> Optional[torch.Tensor]:
    """v (int64) within [lo, hi]; a bound outside int64 can never be
    violated, so that side is skipped."""
    ok = None
    if lo > _I64[0]:
        ok = v >= lo
    if hi < _I64[1]:
        c = v <= hi
        ok = c if ok is None else (ok & c)
    return ok


def _int_range_ok_tl(g, v, lo: int, hi: int):
    ok = None
    if lo > _I64[0]:
        ok = g.op(f"{{}} >= {g.int_lit(lo)}", v, dtype=torch.bool)
    if hi < _I64[1]:
        c = g.op(f"{{}} <= {g.int_lit(hi)}", v, dtype=torch.bool)
        ok = c if ok is None else g.op("{} & {}", ok, c)
    return ok


def cast_ok_needed(src_t, target) -> bool:
    """Whether TRY_CAST from src_t to target can fail on a number (only
    integer and decimal targets: float/bool/date saturate like Trino)."""
    return isinstance(target, (_INT_TYPES, T.DecimalType))


@device("cast_ok")
def numeric_cast_ok(src_t, target, values: torch.Tensor
                    ) -> Optional[torch.Tensor]:
    """Out-of-range mask for TRY_CAST on numeric sources (NULL where the
    plain CAST would fail). None = always representable."""
    if isinstance(target, _INT_TYPES):
        info = torch.iinfo(target.dtype)
        if values.is_floating_point():
            v = values
            if int(info.max) == _I64[1]:
                # float64(int64.max) rounds UP to exactly 2^63: exclusive
                return torch.isfinite(v) & (v >= float(info.min)) \
                    & (v < 9223372036854775808.0)
            return torch.isfinite(v) & (v >= float(info.min)) \
                & (v <= float(info.max))
        v = values.to(torch.int64)
        if isinstance(src_t, T.DecimalType):
            scale = 10 ** src_t.scale
            return _int_range_ok(v, int(info.min) * scale,
                                 int(info.max) * scale)
        return _int_range_ok(v, int(info.min), int(info.max))
    if isinstance(target, T.DecimalType):
        if values.is_floating_point():
            bound = float(10 ** (target.precision - target.scale))
            v = values
            return torch.isfinite(v) & (v > -bound) & (v < bound)
        src_scale = src_t.scale if isinstance(src_t, T.DecimalType) else 0
        bound = 10 ** (target.precision - target.scale + src_scale)
        v = values.to(torch.int64)
        return _int_range_ok(v, -(bound - 1), bound - 1)
    return None   # float/bool/date targets: saturation matches Trino


@emits("cast_ok")
def _numeric_cast_ok_tl(g, src_t, target, v):
    """None where the torch form returns None or a range test that can
    never fail; the caller then keeps the source's validity."""
    if isinstance(target, _INT_TYPES):
        info = torch.iinfo(target.dtype)
        if g.is_float(v):
            lo = g.const(float(info.min), v.dtype)
            if int(info.max) == _I64[1]:
                # float64(int64.max) rounds UP to exactly 2^63: exclusive
                hi = g.const(9223372036854775808.0, v.dtype)
                return g.op("_isfinite({}) & ({} >= {}) & ({} < {})", v, v,
                            lo, v, hi, dtype=torch.bool)
            hi = g.const(float(info.max), v.dtype)
            return g.op("_isfinite({}) & ({} >= {}) & ({} <= {})", v, v, lo,
                        v, hi, dtype=torch.bool)
        v = g.i64(v)
        if isinstance(src_t, T.DecimalType):
            scale = 10 ** src_t.scale
            return _int_range_ok_tl(g, v, int(info.min) * scale,
                                    int(info.max) * scale)
        return _int_range_ok_tl(g, v, int(info.min), int(info.max))
    if isinstance(target, T.DecimalType):
        if g.is_float(v):
            bound = float(10 ** (target.precision - target.scale))
            return g.op("_isfinite({}) & ({} > {}) & ({} < {})", v, v,
                        g.const(-bound, v.dtype), v,
                        g.const(bound, v.dtype), dtype=torch.bool)
        src_scale = src_t.scale if isinstance(src_t, T.DecimalType) else 0
        bound = 10 ** (target.precision - target.scale + src_scale)
        return _int_range_ok_tl(g, g.i64(v), -(bound - 1), bound - 1)
    return None


@device("day_offset")
def day_offset(src_is_ts: bool, days0: int, ndays: int, values):
    """format_datetime's index into its day table: days since `days0`,
    `ndays` (the table's out-of-range entry) outside [0, ndays)."""
    if src_is_ts:
        values = torch.div(values.to(torch.int64), 86_400_000_000,
                           rounding_mode="floor").to(torch.int32)
    off = values.to(torch.int64) - days0
    oob = (off < 0) | (off >= ndays)
    return torch.where(oob, torch.full_like(off, ndays), off)


@emits("day_offset")
def _day_offset_tl(g, src_is_ts: bool, days0: int, ndays: int, v):
    if src_is_ts:
        v = g.to(g.op("_floordiv_pos({}, 86400000000)", g.i64(v)), torch.int32)
    off = g.op(f"{{}} - {days0}", g.i64(v))
    return g.op(f"tl.where(({{}} < 0) | ({{}} >= {ndays}), {ndays}, {{}})",
                off, off, off)


# ---------------------------------------------------------------------------
# dictionary-backed string ops: host computes a per-pool table, the device
# gathers it by code.

def _dict_cache(d: Dictionary) -> Dict:
    """Per-Dictionary memo table, living and dying with the pool object."""
    cache = getattr(d, "_table_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(d, "_table_cache", cache)
    return cache


def dictionary_table(d: Dictionary, key, fn) -> np.ndarray:
    """Memoized host map over the string pool, indexed by code."""
    cache = _dict_cache(d)
    if key not in cache:
        cache[key] = np.asarray([fn(s) for s in d.values])
    return cache[key]


def like_pattern_to_regex(pattern: str, escape: Optional[str] = None) -> str:
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if escape and c == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return "^" + "".join(out) + "$"


def like_table(d: Dictionary, pattern: str,
               escape: Optional[str] = None) -> np.ndarray:
    rx = re.compile(like_pattern_to_regex(pattern, escape), re.DOTALL)
    return dictionary_table(d, ("like", pattern, escape),
                            lambda s: rx.match(s) is not None)


def transform_dictionary_nullable(d: Dictionary, key, fn):
    """Like transform_dictionary but fn may return None (SQL NULL):
    (new dictionary, code remap, ok mask per input code)."""
    cache = _dict_cache(d)
    ck = (key, "xform-null")
    if ck not in cache:
        transformed = [fn(s) for s in d.values]
        ok = np.asarray([t is not None for t in transformed], dtype=bool)
        vals = np.asarray(["" if t is None else t for t in transformed],
                          dtype=object)
        new_vals, remap = np.unique(vals, return_inverse=True)
        cache[ck] = (Dictionary(new_vals), remap.astype(np.int32), ok)
    return cache[ck]


def transform_dictionary(d: Dictionary, key, fn
                         ) -> Tuple[Dictionary, np.ndarray]:
    """str->str transform as (new sorted dictionary, code remap table)."""
    cache = _dict_cache(d)
    ck = (key, "xform")
    if ck not in cache:
        transformed = np.asarray([fn(s) for s in d.values], dtype=object)
        new_vals, remap = np.unique(transformed, return_inverse=True)
        cache[ck] = (Dictionary(new_vals), remap.astype(np.int32))
    return cache[ck]
