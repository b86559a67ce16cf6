"""K10's pass plan on the CPU: the plain models in trino_tpu_torch.ops.sort
of what csrc/sort.cu does between the packed words and the permutation.

K10 counts every pass's digits in one histogram launch, skips the passes
whose digit is the same in every live row (a stable pass over one digit
moves nothing), gathers each word once through the current permutation and
scatters (key, index) pairs to digit base + the earlier tiles' prefix + the
in-tile rank. These tests hold that plan against the twin (a stable
torch.sort per packed word) and, through the twin, against the reference's
order_by on seeded pages: every KEY_SETS entry, pages whose rows are all
equal, no live row, one live row and a capacity above the live rows.
"""

import numpy as np
import pytest
import torch

from test_torch_sort import KEY_SETS, columns, pages, rows_of, same_rows, \
    sort_keys
from trino_tpu.ops import sort as RS
from trino_tpu_torch.ops import sort as PS

torch.set_num_threads(1)
I64_MIN = -(1 << 63)
DIRS = [(True, None), (False, None), (True, True), (False, False)]


def equal_rows(cols):
    """Every column's row 0 repeated: each pass of each key set is trivial
    over the live rows."""
    return {k: (np.repeat(v[:1], len(v)), t,
                None if m is None else np.repeat(m[:1], len(m)))
            for k, (v, t, m) in cols.items()}


def plan_inputs(keyset, cap, n, seed, same=False):
    rng = np.random.default_rng(seed)
    cols = columns(rng, cap)
    (ref, port), names = pages(equal_rows(cols) if same else cols, n)
    keys = sort_keys(PS, names, KEY_SETS[keyset], DIRS)
    words = PS.encode_sort_keys(port, keys)
    passes = PS.sort_passes(PS.sort_layout(port, keys))
    return ref, port, names, keys, words, passes


CASES = [(300, 300), (512, 357), (64, 0), (64, 1)]


@pytest.mark.parametrize("keyset", sorted(KEY_SETS))
@pytest.mark.parametrize("cap,n", CASES,
                         ids=["full", "capacity_above_rows", "no_live_row",
                              "one_live_row"])
def test_informative_passes_replayed_give_the_twin(keyset, cap, n):
    """Only the informative passes, as stable sorts of single bytes over
    the live prefix, give the twin's permutation; K10's step-by-step
    replay (gathers, tiled scatters) gives it with the identity tail, and
    the rows equal the reference's order_by."""
    ref, port, names, keys, words, passes = plan_inputs(
        keyset, cap, n, len(keyset) * 31 + cap)
    keep = PS.informative_passes_plain(words, port.num_rows, passes)
    perm = torch.arange(n)
    for (w, shift), k in zip(passes, keep):
        if k:
            digit = ((words[w][:n] ^ I64_MIN) >> shift) & 0xFF
            perm = perm[torch.sort(digit[perm], stable=True).indices]
    twin = PS.sort_rows_plain(port, keys)
    assert torch.equal(perm, twin[:n])
    for tile in (1, 7, PS.SORT_TILE):
        got = PS.radix_replay_plain(words, port.num_rows, passes, tile)
        assert got.dtype == torch.int32
        assert torch.equal(got[:n].to(torch.int64), twin[:n])
        assert torch.equal(got[n:].to(torch.int64), torch.arange(n, cap))
    want = RS.order_by(sort_keys(RS, names, KEY_SETS[keyset], DIRS))(ref)
    got_page = port.gather(twin, port.num_rows)
    assert same_rows(rows_of(got_page, n), rows_of(want, n))
    if n <= 1:
        assert not any(keep)


@pytest.mark.parametrize("keyset", sorted(KEY_SETS))
@pytest.mark.parametrize("cap,n", [(300, 300), (300, 200)],
                         ids=["full", "capacity_above_rows"])
def test_equal_rows_need_no_pass(keyset, cap, n):
    """A page whose rows are all equal: every pass is trivial (the dead
    flag's byte too, since rows past num_rows take no part), no word is
    gathered and the permutation is the identity, as the twin's over the
    live rows."""
    _, port, _, keys, words, passes = plan_inputs(keyset, cap, n, 3,
                                                  same=True)
    assert not any(PS.informative_passes_plain(words, port.num_rows, passes))
    assert torch.equal(PS.sort_rows_plain(port, keys)[:n], torch.arange(n))
    assert torch.equal(PS.radix_replay_plain(
        words, port.num_rows, passes).to(torch.int64), torch.arange(cap))


@pytest.mark.parametrize("keyset", sorted(KEY_SETS))
def test_histograms_count_the_live_rows(keyset):
    """The histogram launch's twin: per pass, each digit's count over the
    live rows (rows past num_rows never count); a pass is informative
    exactly when no digit holds every live row."""
    cap, n = 512, 357
    _, port, _, _, words, passes = plan_inputs(keyset, cap, n, 11)
    hist = PS.digit_histograms_plain(words, port.num_rows, passes)
    assert hist.shape == (len(passes), 256)
    assert torch.equal(hist.sum(1), torch.full((len(passes),), n))
    for q, (w, shift) in enumerate(passes):
        u = words[w][:n].numpy().view(np.uint64) ^ np.uint64(1 << 63)
        digit = ((u >> np.uint64(shift)) & np.uint64(0xFF)).astype(np.int64)
        assert hist[q].tolist() == np.bincount(digit, minlength=256).tolist()
    keep = PS.informative_passes_plain(words, port.num_rows, passes)
    assert keep == [bool(h.max() < n) for h in hist]
    # the dead flag (word 0's top bit) is 0 in every live row
    assert bool(((words[0][:n] ^ I64_MIN) >= 0).all())


@pytest.mark.parametrize("tile", [1, 7, PS.SORT_TILE])
@pytest.mark.parametrize("distinct", [1, 3, 256])
def test_scatter_positions_are_a_stable_sort(tile, distinct):
    """One pass's positions (digit base + the earlier tiles' rows of the
    digit + the in-tile rank) are a permutation that a stable argsort of
    the digit inverts: heavy ties, one digit, every digit; more rows than
    one tile of the kernel."""
    rng = np.random.default_rng(tile * 7 + distinct)
    n = 2 * PS.SORT_TILE + 123 if tile == PS.SORT_TILE else 1000
    digits = torch.from_numpy(rng.integers(0, distinct, n))
    pos = PS.scatter_positions_plain(digits, tile)
    assert torch.equal(torch.sort(pos).values, torch.arange(n))
    assert torch.equal(torch.argsort(pos), torch.argsort(digits,
                                                         stable=True))


def test_pass_groups_follow_one_word_up_to_eight_passes():
    passes = [(2, 0), (2, 8)] + [(1, 8 * b) for b in range(8)] + \
        [(1, 0), (0, 56)]
    assert PS.pass_groups(passes) == [(0, 2), (2, 10), (10, 11), (11, 12)]
    assert PS.pass_groups([]) == []
    # the u64 sort: one word, eight passes, one gather
    assert PS.pass_groups([(0, 8 * b) for b in range(8)]) == [(0, 8)]


def test_sort_passes_cover_exactly_the_fields_bytes():
    """A field's bytes, and no other, get a pass: a 1-bit flag one byte, a
    32-bit value four, a 64-bit value eight."""
    _, port, _, keys, _, passes = plan_inputs("four_mixed", 64, 64, 5)
    layout = PS.sort_layout(port, keys)
    want = set()
    for f in layout:
        for b in range(f.shift, f.shift + f.width):
            want.add((f.word, 8 * (b // 8)))
    assert sorted(passes, key=lambda p: (-p[0], p[1])) == passes
    assert set(passes) == want and len(passes) == len(want)
