"""K2's and K4's one-launch designs on the CPU: the plain models of what
csrc/concat.cu and csrc/global_agg.cu do, and the wrappers' parameter
words read back the way the kernels read them.

K2 walks the (page, tile) items of the live rows with a persistent grid;
K4 folds every state in one launch over a grid fixed by the capacity and
folds the per-block partials in block order. The wrappers here run on CPU
tensors with the launch replaced by a model that reads the parameter
words and the memory behind every pointer as the kernel does (counts and
descriptors included), so the table layout, its sizing and the state
descriptors are held against the plain twins: K2 bit for bit, K4 exactly
but float sums (1e-9 relative, the twin sums in another order). The twins
themselves are held against the JAX package by test_torch_page.py and
test_torch_aggregate.py.
"""

import ctypes

import numpy as np
import pytest
import torch

from trino_tpu_torch import native
from trino_tpu_torch import page as P
from trino_tpu_torch.ops import aggregate as A

torch.set_num_threads(1)


# ------------------------------------------------------------ K2's walk


WALK_CASES = {
    "mixed": [(10, 3), (0, 0), (4097, 4097), (5, 0)],
    "none_live": [(100, 0), (2049, 0), (1, 0)],
    "single_row": [(1, 1)],
    "counts_past_caps": [(7, 9), (3000, -4), (2048, 2048)],
    "off_tile_caps": [(2049, 2049), (4095, 4095), (6143, 2050)],
    "64_pages": [(37 + 11 * i, (5 * i) % 41) for i in range(64)],
    "receive": [(2_097_152, 20_193 + (i % 2)) for i in range(8)],
}


@pytest.mark.parametrize("grid", [1, 3, 528])
@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_concat_walk_covers_every_live_row_once(case, grid):
    """Every live row of every page is copied by exactly one item, to its
    running offset; no padding row and no empty item is visited; block b
    takes the items b, b + grid, ... in order."""
    caps = [c for c, _ in WALK_CASES[case]]
    counts = [n for _, n in WALK_CASES[case]]
    items, total = P.concat_items_plain(counts, caps, grid)
    live = [max(0, min(n, c)) for c, n in zip(caps, counts)]
    assert total == sum(live)
    seen = np.zeros(total, dtype=np.int64)
    for b, p, r0, r1, off in items:
        assert 0 <= b < grid and 0 <= r0 < r1 <= live[p]
        assert r0 % P.CONCAT_TILE == 0 and r1 - r0 <= P.CONCAT_TILE
        assert off == sum(live[:p])
        seen[off + r0:off + r1] += 1
    assert (seen == 1).all()
    n_items = sum(-(-n // P.CONCAT_TILE) for n in live)
    assert len(items) == n_items
    for b in range(grid):
        mine = [i for i, it in enumerate(items) if it[0] == b]
        assert len(mine) == len(range(b, n_items, grid))


@pytest.mark.parametrize("caps,sms,want", [
    ([0], 132, 1), ([12, 12], 132, 2), ([2048], 132, 1), ([2049], 132, 2),
    ([1, 0, 4097], 132, 4), ([2_097_152] * 8, 132, 528),
    ([1_000_000], 132, 489), ([2_097_152] * 8, 114, 456)])
def test_concat_grid_is_capped_by_the_card_and_the_items(caps, sms, want):
    """At most CONCAT_BLOCKS_PER_SM blocks per SM and no more blocks than
    the pages' capacities allow items: every block can have work."""
    assert P.concat_grid(caps, sms) == want
    items, _ = P.concat_items_plain(caps, caps, 1)
    assert want <= max(1, len(items))


@pytest.mark.parametrize("npages,words,block", [
    (2, 56, 256), (8, 256, 256), (128, 256, 256), (129, 258, 2048),
    (8, 257, 2048), (64, 2048, 2048), (1024, 2048, 2048), (2, 2049, 0),
    (1025, 2050, 0)])
def test_concat_parameter_block_is_sized_to_the_call(npages, words, block):
    assert P.concat_param_words(npages, words) == block


def test_concat_table_layout():
    t = P.concat_table([11, 12], [3, 4], [21, 22, 0, 24], [31, 32], [8, 1],
                       [8, 1, 8, 1])
    assert t == [11, 12, 3, 4, 21, 22, 0, 24, 31, 32, 8, 1, 8, 1, 8, 1]
    assert P.concat_table([11], [3], [21], [31], [8]) == [11, 3, 21, 31, 8]


# ----------------------------------------------- K2 through its model


def concat_kernel_model(calls):
    """csrc/concat.cu's concat_rows on CPU memory: reads the table and
    the counts behind its pointers, walks concat_items_plain and copies
    each item column by column (all-valid bytes for a null source, zeros
    past a narrower plane's row)."""
    def concat_rows(npages, ncols, with_srb, table, length, total, grid,
                    stream):
        words = list((ctypes.c_int64 * length).from_address(table))
        assert length == 2 * npages + 2 * ncols \
            + (1 + bool(with_srb)) * npages * ncols
        assert P.concat_param_words(npages, length)
        calls.append((npages, ncols, with_srb, length, grid))
        count_ptrs, caps = words[:npages], words[npages:2 * npages]
        srcs = words[2 * npages:2 * npages + npages * ncols]
        rest = words[2 * npages + npages * ncols:]
        dsts, drb = rest[:ncols], rest[ncols:2 * ncols]
        srb = rest[2 * ncols:]
        counts = [ctypes.c_int32.from_address(a).value for a in count_ptrs]
        items, n = P.concat_items_plain(counts, caps, grid)
        ctypes.c_int32.from_address(total).value = n
        for _, p, r0, r1, off in items:
            for c in range(ncols):
                k = p * ncols + c
                src, dst, d = srcs[k], dsts[c], drb[c]
                s = srb[k] if with_srb else d
                if src == 0:
                    ctypes.memset(dst + off + r0, 1, r1 - r0)
                elif s == d:
                    ctypes.memmove(dst + (off + r0) * d, src + r0 * s,
                                   (r1 - r0) * d)
                else:
                    for r in range(r0, r1):
                        ctypes.memmove(dst + (off + r) * d, src + r * s, s)
                        ctypes.memset(dst + (off + r) * d + s, 0, d - s)
        return 0
    return concat_rows


def kernel_models(monkeypatch):
    """Run the CUDA wrappers on CPU tensors: the device index reads 0 and
    each launch runs its model; returns the list of launches."""
    calls = []
    models = {"concat_rows": concat_kernel_model(calls),
              "global_reduce": global_kernel_model(calls)}
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 0)
    monkeypatch.setattr(native, "function",
                        lambda name, entry, argtypes: models[entry])
    monkeypatch.setattr(native, "raw_stream", lambda index: 0)
    monkeypatch.setattr(native, "sm_count", lambda index: 132)
    monkeypatch.setattr(A, "_global_scratch", lambda index, words: (
        torch.empty(words, dtype=torch.int64),
        torch.zeros(1, dtype=torch.int32)))
    return calls


def page_arrays(rng, cap, with_valid, plane=None):
    """int64, float64 (NaN, +-0.0, +-inf), int32, int16, a validity (or
    None) and, with `plane`, an int64 [cap, plane] list plane."""
    f = rng.standard_normal(cap) * 1e3
    f[::7] = np.nan
    f[1::11] = -0.0
    f[2::13] = np.inf
    f[3::17] = -np.inf
    out = [torch.from_numpy(rng.integers(-2**62, 2**62, cap)),
           torch.from_numpy(f),
           torch.from_numpy(rng.integers(-2**31, 2**31 - 1, cap,
                                         dtype=np.int32)),
           torch.from_numpy(rng.integers(-2**15, 2**15 - 1, cap,
                                         dtype=np.int16)),
           torch.from_numpy(rng.random(cap) < 0.8) if with_valid else None]
    if plane is not None:
        out.append(torch.from_numpy(
            rng.integers(-2**40, 2**40, (cap, plane))))
    return out


CONCAT_CASES = {   # (cap, live rows, plane width or None) per page
    "mixed": [(10, 3, None), (0, 0, None), (4097, 4097, None),
              (5, 0, None)],
    "none_live": [(100, 0, None), (2049, 0, None), (3, 0, None)],
    "single_row": [(1, 1, None), (6, 0, None)],
    "64_pages": [(13 + 7 * i, (3 * i) % 14, None) for i in range(64)],
    "narrower_planes": [(9, 9, 4), (3000, 2100, 1), (2, 1, 8)],
    "receive": [(2500, 300 + 11 * i, None) for i in range(8)],
}


@pytest.mark.parametrize("case", sorted(CONCAT_CASES))
def test_concat_wrapper_and_table_give_the_twin(monkeypatch, case):
    """One launch whatever the number of pages; the rows, the all-valid
    bytes of an absent validity, a narrower plane's zero padding and the
    total equal concat_rows_plain's bit for bit."""
    rng = np.random.default_rng(len(case))
    layout = CONCAT_CASES[case]
    arrays = [page_arrays(rng, cap, i % 2 == 0 or case == "receive", L)
              for i, (cap, _, L) in enumerate(layout)]
    counts = [torch.tensor(n, dtype=torch.int32) for _, n, _ in layout]
    out_cap = sum(cap for cap, _, _ in layout)
    want, wtot = P.concat_rows_plain(arrays, counts, out_cap)
    calls = kernel_models(monkeypatch)
    before = P.concat_rows_cuda.launches
    got, tot = P.concat_rows_cuda(arrays, counts, out_cap)
    assert len(calls) == 1 and P.concat_rows_cuda.launches == before + 1
    assert calls[0][4] == P.concat_grid([c for c, _, _ in layout], 132)
    k = int(wtot)
    assert int(tot) == k
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a[:k].view(torch.uint8), b[:k].view(torch.uint8))


def test_concat_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    rng = np.random.default_rng(3)
    arrays = [page_arrays(rng, 10, True), page_arrays(rng, 12, True)]
    counts = [torch.tensor(4, dtype=torch.int32)] * 2
    kernel_models(monkeypatch)
    with pytest.raises(ValueError, match="sum of the page capacities"):
        P.concat_rows_cuda(arrays, counts, 23)
    bad = [list(arrays[0]), list(arrays[1])]
    bad[1][0] = bad[1][0].to(torch.int32)
    with pytest.raises(ValueError, match="do not match"):
        P.concat_rows_cuda(bad, counts, 22)
    bad[1][0] = torch.arange(24)[::2]      # strided
    with pytest.raises(ValueError, match="do not match"):
        P.concat_rows_cuda(bad, counts, 22)
    bad[1] = list(arrays[1])
    bad[1][1] = None      # a value column may not be absent
    with pytest.raises(ValueError, match="only validity"):
        P.concat_rows_cuda(bad, counts, 22)
    with pytest.raises(ValueError, match="int32"):
        P.concat_rows_cuda(arrays, [c.to(torch.int64) for c in counts], 22)
    many = [[torch.zeros(1, dtype=torch.int64)] for _ in range(1025)]
    with pytest.raises(ValueError, match="table holds"):
        P.concat_rows_cuda(many, [counts[0]] * 1025, 1025)


# ------------------------------------------------------------ K4


def global_kernel_model(calls):
    """csrc/global_agg.cu's global_reduce on CPU memory: reads each
    state's descriptor and the columns behind its pointers, folds them
    with global_fold_plain and writes one word per state."""
    def global_reduce(table, nstates, num_rows, cap, part, ticket, out,
                      grid, stream):
        words = list((ctypes.c_int64 * (A.STATE_FIELDS * nstates))
                     .from_address(table))
        assert grid == A.global_grid(cap)
        assert ctypes.c_int32.from_address(ticket).value == 0
        calls.append((nstates, grid))
        n = ctypes.c_int32.from_address(num_rows).value
        res = (ctypes.c_int64 * nstates).from_address(out)

        def column(ptr, ctype):
            if ptr == 0 or cap == 0:
                return None
            return np.ctypeslib.as_array((ctype * cap).from_address(ptr))
        for j in range(nstates):
            vp, vd, mk, kind, is_float = \
                words[A.STATE_FIELDS * j:A.STATE_FIELDS * (j + 1)]
            values = column(vp, ctypes.c_int64)
            if values is not None and is_float:
                values = values.view(np.float64)
            res[j] = A.global_fold_plain(
                values, column(vd, ctypes.c_uint8),
                column(mk, ctypes.c_uint8), kind, bool(is_float), n, cap)
        return 0
    return global_reduce


KINDS = [(A.SUM, False), (A.SUM, True), (A.COUNT, False), (A.MIN, False),
         (A.MAX, False), (A.MIN, True), (A.MAX, True)]


def states_of(rng, cap, k, special=True):
    """k states cycling through every kind, with validity and FILTER
    masks on some; floats carry NaN, +-0.0 and +-inf when `special`."""
    f = rng.standard_normal(cap) * 1e3
    if special and cap >= 4:
        f[::97] = np.nan
        f[1::5] = -0.0
        f[2::7] = 0.0
        f[3::211] = np.inf
        f[4::223] = -np.inf
    ints = rng.integers(-10**12, 10**12, cap)
    valid = torch.from_numpy(rng.random(cap) < 0.9)
    mask = torch.from_numpy(rng.random(cap) < 0.7)
    out = []
    for j in range(k):
        kind, is_float = KINDS[j % len(KINDS)]
        values = None if kind == A.COUNT else torch.from_numpy(
            f.copy() if is_float else ints.copy())
        out.append(A.StateInput(values, valid if j % 3 != 1 else None,
                                mask if j % 2 else None, kind, is_float))
    return out


def same_results(states, got, want) -> None:
    for s, a, b in zip(states, got, want):
        assert a.shape == (1,) and a.dtype == b.dtype
        if s.kind == A.SUM and s.is_float:
            x, y = float(a), float(b)
            assert (np.isnan(x) and np.isnan(y)) or x == y \
                or abs(x - y) <= 1e-9 * max(abs(x), abs(y))
        else:
            assert torch.equal(a.view(torch.int64), b.view(torch.int64))


@pytest.mark.parametrize("k", [1, 2, 7, 8, 9, 16, 17])
def test_global_descriptors_carry_every_state(monkeypatch, k):
    """1 to 17 states of every kind in one launch: the descriptors hold
    each state's pointers, kind and float flag, and the results (one int64
    word per state, float states viewed as float64) equal the twin's."""
    rng = np.random.default_rng(k)
    cap, n = 5000, 4321
    states = states_of(rng, cap, k)
    words = A.global_descriptors(states)
    assert len(words) == A.STATE_FIELDS * k
    for j, s in enumerate(states):
        vp, vd, mk, kind, is_float = words[5 * j:5 * j + 5]
        assert vp == (0 if s.values is None else s.values.data_ptr())
        assert vd == (0 if s.valid is None else s.valid.data_ptr())
        assert mk == (0 if s.mask is None else s.mask.data_ptr())
        assert (kind, is_float) == (s.kind, int(s.is_float))
    num_rows = torch.tensor(n, dtype=torch.int32)
    want = A.global_reduce_plain(states, num_rows, cap)
    calls = kernel_models(monkeypatch)
    before = A.global_reduce_cuda.launches
    got = A.global_reduce_cuda(states, num_rows, cap)
    assert calls == [(k, A.global_grid(cap))]
    assert A.global_reduce_cuda.launches == before + 1
    same_results(states, got, want)


GLOBAL_CASES = [  # cap, live rows: empty, 0 and cap live, caps off the
    (0, 0), (1, 1), (300, 0), (4097, 10), (5000, 5000),  # grid's stride
    (262_145, 262_145), (1_200_003, 1_000_001)]


@pytest.mark.parametrize("cap,n", GLOBAL_CASES)
@pytest.mark.parametrize("special", [False, True])
def test_global_fold_model_gives_the_twin(cap, n, special):
    """The fold in the kernel's grid and order gives the twin's results:
    integers, counts and min/max exactly (NaN, -0.0 < +0.0, infinities,
    identities for empty input), float sums to 1e-9 relative."""
    rng = np.random.default_rng(cap + n)
    states = states_of(rng, cap, len(KINDS), special)
    num_rows = torch.tensor(n, dtype=torch.int32)
    want = A.global_reduce_plain(states, num_rows, cap)
    got = []
    for s in states:
        np_ = (lambda t: None if t is None else t.numpy())
        word = A.global_fold_plain(np_(s.values), np_(s.valid),
                                   np_(s.mask), s.kind, s.is_float, n, cap)
        t = torch.tensor([word], dtype=torch.int64)
        got.append(t.view(torch.float64) if s.is_float else t)
    same_results(states, got, want)


def test_global_grid_depends_on_the_capacity_alone():
    assert [A.global_grid(c) for c in (0, 1, 4096, 4097, 1 << 22, 1 << 30)] \
        == [1, 1, 1, 2, 512, 512]


def test_global_fold_repeats_bit_for_bit():
    """Two folds of one page give the same float64 sum bits: the order is
    fixed by the capacity."""
    rng = np.random.default_rng(5)
    cap = 300_007
    x = rng.standard_normal(cap) * 1e6
    a = A.global_fold_plain(x, None, None, A.SUM, True, cap, cap)
    b = A.global_fold_plain(x.copy(), None, None, A.SUM, True, cap, cap)
    assert a == b
    assert A.global_grid(cap) == 74
