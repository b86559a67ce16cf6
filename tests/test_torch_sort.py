"""trino_tpu_torch.ops.sort against trino_tpu.ops.sort on seeded pages (CPU).

The port's sort packs the reference's sort operands into order-preserving
64-bit words (encode_sort_keys) and sorts the words stably (the plain
twin of K10, which the CPU path runs). Its order_by and top_n_masked must
give the reference's rows exactly, in the reference's order, over NULLs,
NaN, +-0.0, INT_MIN (which DESC leaves where the reference's negation
puts it), duplicate keys (ties keep input order), every ASC/DESC x NULLS
FIRST/LAST combination, one to four keys of mixed types whose fields
span several words, an empty page and a capacity above num_rows. The
byte passes K10 runs (sort_passes) are replayed here as stable sorts of
single bytes and must give the twin's permutation.
"""

import itertools
import zlib

import numpy as np
import pytest
import torch

from trino_tpu import page as RP
from trino_tpu import types as RT
from trino_tpu.ops import sort as RS
from trino_tpu_torch import page as PP
from trino_tpu_torch import types as PT
from trino_tpu_torch.ops import sort as PS

torch.set_num_threads(1)
CPU = torch.device("cpu")
I32_MIN, I64_MIN = -(1 << 31), -(1 << 63)


def columns(rng, cap):
    """name -> (values, type name, validity or None): few distinct values
    so that ties are common, with the edge values planted."""
    dbl = rng.choice([-1.5, -0.0, 0.0, 2.25, np.nan, np.inf, -np.inf], cap)
    big = rng.choice([I64_MIN, -7, 0, 3, (1 << 63) - 1], cap)
    i32 = rng.choice([I32_MIN, -2, 0, 5, (1 << 31) - 1], cap)
    return {
        "dbl": (dbl.astype(np.float64), "DOUBLE", rng.random(cap) < 0.8),
        "big": (big.astype(np.int64), "BIGINT", rng.random(cap) < 0.85),
        "i32": (i32.astype(np.int32), "INTEGER", None),
        "date": (rng.integers(-800, 800, cap).astype(np.int32), "DATE",
                 rng.random(cap) < 0.9),
        "flag": (rng.random(cap) < 0.5, "BOOLEAN", rng.random(cap) < 0.7),
        "dec": (rng.integers(-3, 4, cap).astype(np.int64) * 125,
                ("DecimalType", 12, 2), None),
        "code": (rng.integers(0, 4, cap).astype(np.int32), "VARCHAR",
                 rng.random(cap) < 0.9),
        "row": (np.arange(cap, dtype=np.int64), "BIGINT", None),
    }


def ty(T, spec):
    return getattr(T, spec[0])(*spec[1:]) if isinstance(spec, tuple) \
        else getattr(T, spec)


def pages(cols, n):
    names = list(cols)
    arrays = [cols[k][0] for k in names]
    valids = [cols[k][2] for k in names]
    dict_vals = np.asarray(["AIR", "MAIL", "RAIL", "SHIP"], dtype=object)
    ref_dicts = [RP.Dictionary(dict_vals) if cols[k][1] == "VARCHAR"
                 else None for k in names]
    port_dicts = [PP.Dictionary(dict_vals) if cols[k][1] == "VARCHAR"
                  else None for k in names]
    ref = RP.Page.from_numpy(arrays, [ty(RT, cols[k][1]) for k in names],
                             valids=valids, dictionaries=ref_dicts)
    port = PP.Page.from_numpy(arrays, [ty(PT, cols[k][1]) for k in names],
                              valids=valids, dictionaries=port_dicts,
                              device="cpu")
    return (RP.Page(ref.columns, np.int32(n)),
            PP.Page(port.columns, PP.row_count(n, CPU))), names


def rows_of(page, n):
    """The page's live values, column by column."""
    return [list(c) for c in page.to_host(n)]


def same_rows(got, want) -> bool:
    def same(x, y):
        if isinstance(x, float) and isinstance(y, float):
            return (x != x and y != y) or (
                x == y and np.signbit(x) == np.signbit(y))
        return x == y
    return len(got) == len(want) and all(
        len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        for a, b in zip(got, want))


KEY_SETS = {
    "double": ["dbl"],
    "bigint": ["big"],
    "integer_min": ["i32"],
    "boolean": ["flag"],
    "decimal_then_code": ["dec", "code"],
    "date_double_bigint": ["date", "dbl", "big"],
    "four_mixed": ["code", "flag", "dbl", "date"],
    "four_wide": ["big", "dbl", "dec", "i32"],
}
DIRECTIONS = list(itertools.product([True, False], [None, True, False]))


def sort_keys(pkg, names, key_names, directions):
    return [pkg.SortKey(names.index(k), asc, nf)
            for k, (asc, nf) in zip(key_names, directions)]


@pytest.mark.parametrize("keyset", sorted(KEY_SETS))
@pytest.mark.parametrize("cap,n", [(300, 300), (512, 357)],
                         ids=["full", "capacity_above_rows"])
def test_order_by_matches_reference(keyset, cap, n):
    """Every direction and NULLS placement on each key, rotated across
    the keys so that one run covers all combinations of a key set."""
    rng = np.random.default_rng(zlib.crc32(f"{keyset}/{cap}".encode()))
    (ref, port), names = pages(columns(rng, cap), n)
    key_names = KEY_SETS[keyset]
    for r in range(len(DIRECTIONS)):
        dirs = [DIRECTIONS[(r + j) % len(DIRECTIONS)]
                for j in range(len(key_names))]
        want = rows_of(RS.order_by(sort_keys(RS, names, key_names, dirs))(
            ref), n)
        got = rows_of(PS.order_by(sort_keys(PS, names, key_names, dirs))(
            port), n)
        assert same_rows(got, want), (keyset, dirs)


@pytest.mark.parametrize("count", [0, 1, 17, 400])
def test_top_n_masked_matches_reference(count):
    rng = np.random.default_rng(count + 5)
    (ref, port), names = pages(columns(rng, 256), 200)
    keys = ["dbl", "big"]
    dirs = [(False, None), (True, True)]
    want_page = RS.top_n_masked(sort_keys(RS, names, keys, dirs))(ref, count)
    got_page = PS.top_n_masked(sort_keys(PS, names, keys, dirs))(port, count)
    n = int(want_page.num_rows)
    assert int(got_page.num_rows) == n == min(count, 200)
    assert same_rows(rows_of(got_page, n), rows_of(want_page, n))


def test_empty_page_sorts_to_nothing():
    rng = np.random.default_rng(3)
    (ref, port), names = pages(columns(rng, 64), 0)
    out = PS.order_by(sort_keys(PS, names, ["big", "dbl"],
                                [(True, None)] * 2))(port)
    want = RS.order_by(sort_keys(RS, names, ["big", "dbl"],
                                 [(True, None)] * 2))(ref)
    assert int(out.num_rows) == int(want.num_rows) == 0
    assert rows_of(out, 0) == rows_of(want, 0)


def test_int_min_desc_keeps_the_reference_quirk():
    """DESC negates: -INT_MIN wraps to INT_MIN, so INT_MIN sorts FIRST
    under DESC, before the largest value (ROADMAP §C)."""
    vals = np.asarray([5, I32_MIN, (1 << 31) - 1, -1], dtype=np.int32)
    (ref, port), _ = pages({"i32": (vals, "INTEGER", None)}, 4)
    got = rows_of(PS.order_by([PS.SortKey(0, False)])(port), 4)
    want = rows_of(RS.order_by([RS.SortKey(0, False)])(ref), 4)
    assert got == want == [[I32_MIN, (1 << 31) - 1, 5, -1]]


def test_ties_keep_input_order():
    rng = np.random.default_rng(11)
    (_, port), names = pages(columns(rng, 500), 500)
    keys = sort_keys(PS, names, ["code"], [(True, None)])
    perm = PS.sort_rows_plain(port, keys)
    codes = port.column(names.index("code")).values[perm]
    valid = port.column(names.index("code")).valid[perm]
    for c in range(4):
        run = perm[(codes == c) & valid]
        assert torch.all(run[1:] > run[:-1])


@pytest.mark.parametrize("keyset", sorted(KEY_SETS))
def test_words_order_equals_the_operands_order(keyset):
    """The packed words sort exactly as the reference's operand list
    does, and every field lands in its own bits of one word."""
    rng = np.random.default_rng(len(keyset))
    (_, port), names = pages(columns(rng, 400), 333)
    keys = sort_keys(PS, names, KEY_SETS[keyset],
                     [(False, True), (True, None), (False, False),
                      (True, False)])
    layout = PS.sort_layout(port, keys)
    for f in layout:
        assert 0 <= f.shift and f.shift + f.width <= 64
    bits = sum(f.width for f in layout)
    assert len(PS.encode_sort_keys(port, keys)) >= -(-bits // 64)
    want = PS.sort_permutation(PS._sort_operands(port, keys))
    got = PS.sort_rows_plain(port, keys)
    assert torch.equal(got[:333], want[:333])


@pytest.mark.parametrize("keyset", sorted(KEY_SETS))
def test_radix_passes_replayed_give_the_twin(keyset):
    """K10's LSD passes (sort_passes: only the bytes fields occupy) run
    here as one stable sort per byte over the live prefix; the order must
    be the twin's."""
    rng = np.random.default_rng(7 + len(keyset))
    n = 290
    (_, port), names = pages(columns(rng, 320), n)
    keys = sort_keys(PS, names, KEY_SETS[keyset],
                     [(True, None), (False, None), (True, True),
                      (False, False)])
    layout = PS.sort_layout(port, keys)
    words = PS.encode_sort_keys(port, keys)
    perm = torch.arange(n)
    for w, shift in PS.sort_passes(layout):
        u = words[w][:n] ^ I64_MIN          # the unsigned bit pattern
        digit = (u >> shift) & 0xFF
        perm = perm[torch.sort(digit[perm], stable=True).indices]
    assert torch.equal(perm, PS.sort_rows_plain(port, keys)[:n])
