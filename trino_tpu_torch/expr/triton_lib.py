"""Device helpers of K11's generated Triton kernels (expr/kernel_gen.py).

Every function below is copied as source text, under `@triton.jit`, into
each generated kernel file, and called from the emissions of
expr/functions.py. They are written in the subset of Python that Triton
compiles, and each mirrors one torch form of functions.py step by step
(the name of the form is in its docstring), so that a reader can hold the
two side by side.

`tl` and `libdevice` are the names the generated file binds (Triton's
language module and its libdevice wrappers); nothing here imports Triton,
so the module loads on a machine without it. INTRINSICS are the few
helpers whose bodies rest on what only Triton defines (C integer division,
bit casts, libdevice, NaN-propagating min/max); the CPU tests bind torch
forms of those and run every other helper, and the generated kernels,
as written.
"""

# flake8: noqa: F821  (tl and libdevice are bound by the generated file)

from __future__ import annotations   # `tl.constexpr` stays unevaluated


# ------------------------------------------------------------ intrinsics

def _idiv(a, b):
    """Integer division truncating toward zero (C); b != 0."""
    return a // b


def _irem(a, b):
    """Integer remainder with the dividend's sign (C); b != 0."""
    return a % b


def _lshr64(a, s):
    """Logical right shift of int64 bits by s in [0, 63]."""
    return (a.to(tl.uint64, bitcast=True) >> s.to(tl.uint64)).to(
        tl.int64, bitcast=True)


def _lshr_c(a, s: tl.constexpr):
    """Logical right shift of int64 bits by a constant s in [1, 63]."""
    return (a.to(tl.uint64, bitcast=True) >> s).to(tl.int64, bitcast=True)


def _bits_f64(x):
    """The float64 whose bits are the int64 x."""
    return x.to(tl.float64, bitcast=True)


def _not(x):
    return x == 0


def _max(a, b):
    """torch.maximum: NaN propagates."""
    return tl.maximum(a, b, propagate_nan=tl.PropagateNan.ALL)


def _min(a, b):
    """torch.minimum: NaN propagates."""
    return tl.minimum(a, b, propagate_nan=tl.PropagateNan.ALL)


def _floor(x):
    return libdevice.floor(x)


def _ceil(x):
    return libdevice.ceil(x)


def _trunc(x):
    return libdevice.trunc(x)


def _sqrt(x):
    return libdevice.sqrt(x)


def _pow(x, y):
    return libdevice.pow(x, y)


def _exp(x):
    return libdevice.exp(x)


def _log(x):
    return libdevice.log(x)


def _log10(x):
    return libdevice.log10(x)


def _log2(x):
    return libdevice.log2(x)


def _sin(x):
    return libdevice.sin(x)


def _cos(x):
    return libdevice.cos(x)


def _tan(x):
    return libdevice.tan(x)


def _asin(x):
    return libdevice.asin(x)


def _acos(x):
    return libdevice.acos(x)


def _atan(x):
    return libdevice.atan(x)


def _sinh(x):
    return libdevice.sinh(x)


def _cosh(x):
    return libdevice.cosh(x)


def _tanh(x):
    return libdevice.tanh(x)


def _atan2(y, x):
    return libdevice.atan2(y, x)


def _fmod(a, b):
    """torch.fmod of floats (C fmod)."""
    return libdevice.fmod(a, b)


INTRINSICS = ("_idiv", "_irem", "_lshr64", "_lshr_c", "_bits_f64", "_not",
              "_max", "_min", "_floor", "_ceil", "_trunc", "_sqrt", "_pow",
              "_exp", "_log", "_log10", "_log2", "_sin", "_cos", "_tan",
              "_asin", "_acos", "_atan", "_sinh", "_cosh", "_tanh",
              "_atan2", "_fmod")


# ---------------------------------------------------------------- helpers

def _tdiv(a, b):
    """functions.tdiv: truncating division, x / 0 = -1, MIN / -1 = MIN."""
    zero = b == 0
    neg1 = b == -1
    safe = tl.where(zero | neg1, 1, b)
    q = _idiv(a, safe)
    q = tl.where(neg1, -a, q)
    return tl.where(zero, -1, q)


def _trem(a, b):
    """functions.trem: the dividend's sign, x % 0 = x."""
    zero = b == 0
    neg1 = b == -1
    safe = tl.where(zero | neg1, 1, b)
    r = _irem(a, safe)
    r = tl.where(neg1, 0, r)
    return tl.where(zero, a, r)


def _floordiv_pos(a, b):
    """Floor division by a positive b (torch rounding_mode="floor")."""
    q = _idiv(a, b)
    return q - ((_irem(a, b) != 0) & (a < 0)).to(q.dtype)


def _floormod(a, b):
    """torch.remainder by a positive b."""
    r = _irem(a, b)
    return tl.where(r < 0, r + b, r)


def _rescale_down(v, factor, half):
    """functions._rescale to a smaller scale: HALF_UP."""
    adj = tl.where(v >= 0, v + half, v - half)
    return _idiv(adj, factor)


def _lshr(a, s):
    """functions.logical_shr: counts outside [0, 64) give 0."""
    sc = tl.minimum(tl.maximum(s, 0), 63)
    out = _lshr64(a, sc)
    return tl.where((s >= 64) | (s < 0), 0, out)


def _shl(a, s):
    """functions._bitshl: counts outside [0, 64) give 0."""
    out = a << tl.minimum(tl.maximum(s, 0), 63)
    return tl.where((s >= 64) | (s < 0), 0, out)


def _ashr(a, s):
    """functions._bitsar: counts outside [0, 64) fill with the sign."""
    s = tl.where((s >= 64) | (s < 0), 63, s)
    return a >> s


def _bit_count(a, bits):
    """functions._bit_count: popcount of the low `bits` bits (SWAR)."""
    mask = tl.where(bits >= 64, -1,
                    ~(-1 << tl.minimum(tl.maximum(bits, 0), 63)))
    u = a & mask
    x = u - (_lshr_c(u, 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + (_lshr_c(x, 2) & 0x3333333333333333)
    x = (x + _lshr_c(x, 4)) & 0x0F0F0F0F0F0F0F0F
    return _lshr_c(x * 0x0101010101010101, 56)


def _width_bucket(x, lo, hi, n):
    """functions._width_bucket over float64 bounds and an int64 count."""
    b = _floor((x - lo) / (hi - lo) * n.to(tl.float64)) + 1
    b = _min(_max(b, 0.0), (n + 1).to(tl.float64))
    return b.to(tl.int64)


def _fsign(x):
    """torch.sign of a float: NaN and +-0.0 give +0.0."""
    return tl.where(x > 0, 1.0, tl.where(x < 0, -1.0, 0.0)).to(x.dtype)


def _isfinite(x):
    return (x - x) == 0


def _pow10(e):
    """functions._pow10_int: 10 ** e for e clamped to [0, 17], exactly."""
    e = tl.minimum(tl.maximum(e, 0), 17)
    r = tl.where(e > 0, 10, 1).to(tl.int64)
    for i in tl.static_range(1, 17):
        r = tl.where(i < e, r * 10, r)
    return r


def _round_dec(a, keep, scale: tl.constexpr):
    """functions._round_digits of a decimal of `scale`: half away."""
    step = _pow10(scale - keep)
    half = _floordiv_pos(step, 2)
    mag = _floordiv_pos(tl.abs(a) + half, step) * step
    rounded = tl.where(a >= 0, mag, -mag)
    return tl.where(keep >= scale, a, rounded)


def _round_int(a, keep):
    """functions._round_digits of an integer: half away from zero."""
    p = _pow10(-keep)
    half = _floordiv_pos(p, 2)
    mag = _floordiv_pos(tl.abs(a) + half, p) * p
    rounded = tl.where(a >= 0, mag, -mag).to(a.dtype)
    return tl.where(keep >= 0, a, rounded)


def _ipow(a, b):
    """torch.pow of integers: by squaring, wrapping; b < 0 gives 1 for
    a == 1, +-1 for a == -1 and 0 otherwise."""
    r = tl.where((b & 1) != 0, a, 1)
    base = a * a
    e = b >> 1
    for _ in tl.static_range(63):
        r = tl.where((e & 1) != 0, r * base, r)
        base = base * base
        e = e >> 1
    odd = (b & 1) != 0
    neg = tl.where(a == 1, 1, tl.where(a == -1, tl.where(odd, -1, 1), 0))
    return tl.where(b < 0, neg.to(r.dtype), r)


def _saturate(x, flo, fhi, ilo, ihi):
    """functions._saturating_int: float64 to int64 clamping out-of-range
    values to the type's ends (flo, fhi float64 operands; ilo, ihi ints)
    and NaN to 0."""
    out = tl.where(x != x, 0.0, x)
    big = out >= fhi
    small = out <= flo
    res = tl.minimum(tl.maximum(out, flo), fhi).to(tl.int64)
    res = tl.where(big, ihi, res)
    return tl.where(small, ilo, res)


def _ts_days(a):
    """functions._days_of a TIMESTAMP (microseconds): floor to days."""
    return _idiv(tl.where(a >= 0, a, a - 86399999999), 86400000000)


def _civil(days):
    """functions._civil_from_days: (year, month, day), proleptic
    Gregorian, int64."""
    z = days.to(tl.int64) + 719468
    era = _idiv(tl.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = _idiv(doe - _idiv(doe, 1460) + _idiv(doe, 36524)
                - _idiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _idiv(yoe, 4) - _idiv(yoe, 100))
    mp = _idiv(5 * doy + 2, 153)
    d = doy - _idiv(153 * mp + 2, 5) + 1
    m = mp + tl.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(tl.int64)
    return y, m, d


def _days_from_civil(y, m, d):
    """functions._days_from_civil_device."""
    yy = y - (m <= 2).to(tl.int64)
    era = _idiv(tl.where(yy >= 0, yy, yy - 399), 400)
    yoe = yy - era * 400
    doy = _idiv(153 * (m + tl.where(m > 2, -3, 9)) + 2, 5) + d - 1
    doe = yoe * 365 + _idiv(yoe, 4) - _idiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _month_start(y, m):
    """functions._days_from_civil_device(y, m, 1)."""
    yy = y - (m <= 2).to(tl.int64)
    era = _idiv(tl.where(yy >= 0, yy, yy - 399), 400)
    yoe = yy - era * 400
    doy = _idiv(153 * (m + tl.where(m > 2, -3, 9)) + 2, 5)
    doe = yoe * 365 + _idiv(yoe, 4) - _idiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _year_start(y):
    """functions._days_from_civil_device(y, 1, 1): January is month 13
    of the year before, whose March-based day of year is 306."""
    yy = y - 1
    era = _idiv(tl.where(yy >= 0, yy, yy - 399), 400)
    yoe = yy - era * 400
    doe = yoe * 365 + _idiv(yoe, 4) - _idiv(yoe, 100) + 306
    return era * 146097 + doe - 719468


def _add_months(days, months):
    """functions._add_months_device: end-of-month clamping, int32."""
    y, m, d = _civil(days)
    total = y * 12 + (m - 1) + months.to(tl.int64)
    ny = _idiv(tl.where(total >= 0, total, total - 11), 12)
    nm = total - ny * 12 + 1
    leap = ((_irem(ny, 4) == 0) & (_irem(ny, 100) != 0)
            | (_irem(ny, 400) == 0))
    length = 31 - ((nm == 4) | (nm == 6) | (nm == 9) | (nm == 11)).to(
        tl.int64) - (nm == 2).to(tl.int64) * 3 \
        + ((nm == 2) & leap).to(tl.int64)
    nd = tl.minimum(d, length)
    return _days_from_civil(ny, nm, nd).to(tl.int32)


def _trunc_year_days(days):
    """functions._trunc_year_days."""
    y, m, d = _civil(days)
    return _year_start(y)


def _iso_week(days):
    """functions._week: the ISO week of the week's Thursday."""
    thursday = days - _floormod(days + 3, 7) + 3
    return _idiv(thursday - _trunc_year_days(thursday), 7) + 1


def _last_day_of_month(days):
    """functions._last_day_of_month, int32."""
    y, m, d = _civil(days)
    nxt_m = tl.where(m == 12, 1, m + 1)
    nxt_y = tl.where(m == 12, y + 1, y)
    return (_month_start(nxt_y, nxt_m) - 1).to(tl.int32)


def _trunc_days(days, unit: tl.constexpr):
    """functions.date_trunc_days; unit 0 day, 1 week, 2 month, 3 quarter,
    4 year (functions._DAY_UNITS)."""
    if unit == 0:
        out = days
    elif unit == 1:
        out = days - _floormod(days + 3, 7)
    else:
        y, m, d = _civil(days)
        if unit == 2:
            out = _month_start(y, m)
        elif unit == 3:
            out = _month_start(y, _idiv(m - 1, 3) * 3 + 1)
        else:
            out = _year_start(y)
    return out.to(tl.int32)


def _diff_days(a, b, unit: tl.constexpr):
    """functions.date_diff_days: b - a in whole units."""
    if unit == 0:
        out = b - a
    elif unit == 1:
        out = _idiv(b - a, 7)
    else:
        ay, am, ad = _civil(a)
        by, bm, bd = _civil(b)
        months = (by - ay) * 12 + (bm - am)
        months = months - ((months > 0) & (bd < ad)).to(tl.int64)
        months = months + ((months < 0) & (bd > ad)).to(tl.int64)
        if unit == 2:
            out = months
        elif unit == 3:
            out = _idiv(months, 3)
        else:
            out = _idiv(months, 12)
    return out


def _add_days(n, days, unit: tl.constexpr):
    """functions.date_add_days: days + n units, int32."""
    if unit == 0:
        out = (days + n).to(tl.int32)
    elif unit == 1:
        out = (days + 7 * n).to(tl.int32)
    elif unit == 2:
        out = _add_months(days, n)
    elif unit == 3:
        out = _add_months(days, 3 * n)
    else:
        out = _add_months(days, 12 * n)
    return out
