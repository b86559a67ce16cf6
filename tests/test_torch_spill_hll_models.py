"""K16's spilled-build plan and K30's two-word HLL fold on the CPU: the
plain models of what csrc/join_spill.cu (around K10's radix passes) and
csrc/special_agg.cu's HLL fold do, and the wrappers' parameters and
buffers read back the way the kernels read them.

K16 writes the two sort words of the live rows, sorts the live prefix with
K10 (the dead word's pass trivial unless a live key is NULL; the sorted
keys from the last pass) and finishes the keys and statistics from the
sorted ends. The HLL fold packs each group's present-bucket count into
bits 44-63 of the low half's sum. Both models are held against the plain
twins bit for bit; the twins themselves are held against the JAX package
by test_torch_join_spill.py and test_torch_special_agg.py, and the packed
estimate here against the reference's _hll_estimate too.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trino_tpu.ops import aggregate as RA
from trino_tpu_torch import native
from trino_tpu_torch.ops import aggregate as A
from trino_tpu_torch.ops import join as J
from trino_tpu_torch.ops import sort as S

torch.set_num_threads(1)
_I64_MIN = -(1 << 63)


# ------------------------------------------------------------ K16 builds


def spill_build(kind: str, cap: int, n: int, seed: int = 0):
    """(key columns, num_rows) of one K16 build, made with numpy."""
    rng = np.random.default_rng(seed + cap + n)

    def valid(frac):
        return torch.from_numpy(rng.random(cap) >= frac)
    if kind == "no_null":
        cols = [(torch.from_numpy(rng.integers(-2**62, 2**62, cap)), None)]
    elif kind == "nulls":
        cols = [(torch.from_numpy(rng.integers(-2**40, 2**40, cap)),
                 valid(0.1))]
    elif kind == "minus1":          # a live key of -1 (u64::MAX) and NULLs
        v = rng.permutation(cap).astype(np.int64) - 1
        cols = [(torch.from_numpy(v), valid(0.1))]
    elif kind == "composite":
        a = rng.integers(0, 50, cap).astype(np.int32)
        b = rng.integers(-10**12, 10**12, cap)
        cols = [(torch.from_numpy(a), valid(0.05)),
                (torch.from_numpy(b), None)]
    elif kind == "duplicates":
        cols = [(torch.from_numpy(rng.integers(0, cap // 3 + 1, cap)),
                 None)]
    elif kind == "float":           # NaN, -0.0 and +0.0 among the keys
        f = rng.standard_normal(cap) * 1e6
        f[::17] = np.nan
        f[1::19] = -0.0
        f[2::23] = 0.0
        cols = [(torch.from_numpy(f), valid(0.02))]
    elif kind == "all_null":
        cols = [(torch.from_numpy(rng.integers(0, 9, cap)),
                 torch.zeros(cap, dtype=torch.bool))]
    else:                           # "span24": one column below 2^24
        cols = [(torch.from_numpy(rng.integers(0, 1 << 24, cap)), None)]
    return cols, torch.tensor(n, dtype=torch.int32)


SPILL_CASES = [  # kind, cap, live rows
    ("no_null", 5000, 4000), ("nulls", 5000, 4321), ("minus1", 3000, 3000),
    ("composite", 6000, 5999), ("duplicates", 4100, 4097),
    ("float", 2500, 2400), ("no_null", 1024, 0), ("nulls", 700, 700),
    ("duplicates", 9000, 9000), ("all_null", 300, 250),
    ("span24", 8193, 8193), ("no_null", 1, 1)]


@pytest.mark.parametrize("kind,cap,n", SPILL_CASES)
def test_spill_plan_gives_the_twin(kind, cap, n):
    """The live-prefix plan gives spill_prep_plain's sorted keys,
    permutation and statistics bit for bit: rows past num_rows keep their
    places, a live -1 sorts before the NULL-keyed rows, KMIN and KMAX come
    from the sorted ends, UNIQUE from neighbours below N_LIVE."""
    cols, nr = spill_build(kind, cap, n)
    want = J.spill_prep_plain(cols, nr)
    got = J.spill_plan_plain(cols, nr)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(got[1][n:], torch.arange(n, cap, dtype=torch.int32))


@pytest.mark.parametrize("kind,cap,n", SPILL_CASES)
def test_spill_dead_pass_is_trivial_without_live_nulls(kind, cap, n):
    """K10's histogram skips the dead word's pass exactly when no live row
    has a NULL key (or every one has): the main path's builds, keyed on
    every row, run the key's passes alone."""
    cols, nr = spill_build(kind, cap, n)
    words, stats = J.spill_words_plain(cols, nr)
    nulls = n - int(stats[J.N_LIVE])
    plan = S.informative_passes_plain(words, nr, J.SPILL_PASSES)
    assert plan[0] == (0 < nulls < n)
    assert bool(stats[J.HAS_NULL]) == (nulls > 0)


def test_spill_span_below_2_24_keeps_only_its_bytes():
    """A single-column key span below 2^24 without NULLs: only the key's
    three low bytes can be informative, and sorting by them alone gives
    the whole plan's permutation."""
    cols, nr = spill_build("span24", 8193, 8193)
    words, _ = J.spill_words_plain(cols, nr)
    plan = S.informative_passes_plain(words, nr, J.SPILL_PASSES)
    ran = [p for p, keep in zip(J.SPILL_PASSES, plan) if keep]
    assert ran == [(0, 0), (0, 8), (0, 16)]
    assert torch.equal(S.radix_replay_plain(words, nr, ran),
                       S.radix_replay_plain(words, nr, J.SPILL_PASSES))


def test_spill_prep_layout_is_one_allocation_of_words_and_scratch():
    assert J.spill_prep_layout(0) == (0,)
    assert J.spill_prep_layout(S.SMALL_ROWS) == (2 * S.SMALL_ROWS,)
    cap = 2_097_152
    assert J.spill_prep_layout(cap) == (2 * cap,) + S.radix_scratch_sizes(
        cap, 9) == (2 * cap, 2 * cap, cap // 2, 257 * 9 + 4,
                    2 * 256 * (cap // S.SORT_TILE))


# -------------------------------------------- K16 through its wrapper


def mem(addr: int, ctype, count: int, dtype) -> torch.Tensor:
    """`count` elements of memory at `addr` as a tensor sharing it."""
    if count == 0:
        return torch.empty(0, dtype=dtype)
    return torch.from_numpy(np.ctypeslib.as_array(
        (ctype * count).from_address(addr))).view(dtype)


def spill_kernel_models(monkeypatch, tensors):
    """Run K16's wrapper on CPU tensors: each of its three launches runs a
    model reading the parameters and the memory behind every pointer as
    the kernel does (`tensors` maps a column's data pointer to it); rows
    the kernels leave unwritten hold a marker. Returns the launches."""
    calls = []

    def spill_prep(table, nkeys, cap, num_rows, words, stats, stream):
        t = list(table)[:4 * nkeys]
        cols = []
        for q in range(nkeys):
            vp, mp, esz, is_float = t[4 * q:4 * q + 4]
            v = tensors[vp]
            assert (esz, is_float) == (v.element_size(),
                                       int(v.is_floating_point()))
            cols.append((v, None if mp == 0 else tensors[mp]))
        n = ctypes.c_int32.from_address(num_rows).value
        w, st = J.spill_words_plain(cols, torch.tensor(n))
        out = mem(words, ctypes.c_int64, 2 * cap, torch.int64).view(2, cap)
        out.fill_(0x5A5A5A5A5A5A5A5A)
        live = min(max(n, 0), cap)
        out[:, :live] = w[:, :live]
        mem(stats, ctypes.c_int64, J.N_STATS, torch.int64).copy_(st)
        calls.append(("spill_prep", words, stats))
        return 0

    def sort_radix(num_rows, cap, words, npasses, passes, perm, keys_out,
                   keys, idx, plan, status, stream):
        p = list(passes)[:2 * npasses]
        assert tuple(zip(p[:npasses], p[npasses:])) == J.SPILL_PASSES
        n = ctypes.c_int32.from_address(num_rows).value
        w = mem(words, ctypes.c_int64, 2 * cap, torch.int64).view(2, cap)
        order = S.radix_replay_plain(w, n, J.SPILL_PASSES)
        mem(perm, ctypes.c_int32, cap, torch.int32).copy_(order)
        live = min(max(n, 0), cap)
        out = mem(keys_out, ctypes.c_int64, cap, torch.int64)
        out.fill_(0x5A5A5A5A5A5A5A5A)
        out[:live] = (w[0, :live] ^ _I64_MIN)[order[:live].to(torch.int64)]
        calls.append(("sort_radix", words, perm, keys_out,
                      (keys, idx, plan, status)))
        return 0

    def spill_prep_finish(cap, num_rows, keys, stats, stream):
        n = ctypes.c_int32.from_address(num_rows).value
        J.spill_finish_plain(mem(keys, ctypes.c_int64, cap, torch.int64), n,
                             mem(stats, ctypes.c_int64, J.N_STATS,
                                 torch.int64))
        calls.append(("spill_prep_finish", keys, stats))
        return 0
    models = {"spill_prep": spill_prep, "sort_radix": sort_radix,
              "spill_prep_finish": spill_prep_finish}
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 0)
    monkeypatch.setattr(native, "function",
                        lambda name, entry, argtypes: models[entry])
    monkeypatch.setattr(native, "raw_stream", lambda index: 0)
    return calls


@pytest.mark.parametrize("kind,cap,n", SPILL_CASES + [
    ("composite", 9000, 8500)])
def test_spill_wrapper_gives_the_twin_in_one_scratch(monkeypatch, kind, cap,
                                                      n):
    """Three launches (prep, K10's radix, finish) give the twin's keys,
    permutation and statistics; the words and K10's scratch are one
    allocation laid out as spill_prep_layout says; the keys and the
    permutation share the other; K10 gets the build's num_rows."""
    cols, nr = spill_build(kind, cap, n)
    want = J.spill_prep_plain(cols, nr)
    tensors = {t.data_ptr(): t for c in cols for t in c if t is not None}
    calls = spill_kernel_models(monkeypatch, tensors)
    before = J.spill_prep_cuda.launches
    got = J.spill_prep_cuda(cols, nr)
    assert J.spill_prep_cuda.launches == before + 1
    assert [c[0] for c in calls] == ["spill_prep", "sort_radix",
                                     "spill_prep_finish"]
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)
    keys, perm, stats = got
    _, words, stats_ptr = calls[0]
    _, words2, perm_ptr, keys_ptr, scratch = calls[1]
    assert words2 == words and stats_ptr == stats.data_ptr()
    assert (keys_ptr, perm_ptr) == (keys.data_ptr(), perm.data_ptr())
    assert perm_ptr == keys_ptr + 8 * cap
    offsets = np.cumsum((0,) + J.spill_prep_layout(cap))[1:-1]
    if cap > S.SMALL_ROWS:
        assert list(scratch) == [words + 8 * int(o) for o in offsets]
    else:
        assert scratch == (None,) * 4
    assert calls[2][1:] == (keys.data_ptr(), stats.data_ptr())


def test_spill_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    cols, nr = spill_build("nulls", 100, 90)
    with pytest.raises(ValueError, match="CUDA"):
        J.spill_prep_cuda(cols, nr)        # CPU tensors: no device
    spill_kernel_models(monkeypatch, {})
    with pytest.raises(ValueError, match="int32"):
        J.spill_prep_cuda(cols, nr.to(torch.int64))
    with pytest.raises(ValueError, match="int32"):
        J.spill_prep_cuda(cols, nr.reshape(1))
    strided = [(torch.arange(200)[::2], None)]
    with pytest.raises(ValueError, match="does not match"):
        J.spill_prep_cuda(strided, nr)
    short = [cols[0], (torch.arange(99), None)]
    with pytest.raises(ValueError, match="does not match"):
        J.spill_prep_cuda(short, nr)
    bad_valid = [(cols[0][0], cols[0][1].to(torch.uint8))]
    with pytest.raises(ValueError, match="validity"):
        J.spill_prep_cuda(bad_valid, nr)


# ------------------------------------------------------- the HLL fold


def hll_page(rng, groups: int, per_group, cap: int, regs_of=None):
    """Sorted distinct (group << 11 | bucket) pairs, `per_group` buckets
    of each group (an int or a list), their registers (`regs_of` or 1 +
    the larger of two geometric draws), on a page of `cap` rows."""
    pairs, regs = [], []
    for g in range(groups):
        k = per_group if isinstance(per_group, int) else per_group[g]
        b = np.sort(rng.choice(2048, k, replace=False))
        pairs.append((g << 11) | b)
        regs.append(regs_of(k) if regs_of else 1 + np.maximum(
            rng.geometric(0.5, k), rng.geometric(0.5, k)))
    pairs = np.concatenate(pairs or [np.zeros(0, np.int64)])
    regs = np.minimum(np.concatenate(regs or [np.zeros(0, np.int64)]), 54)
    p = torch.full((cap,), -1, dtype=torch.int64)
    r = torch.zeros(cap, dtype=torch.int64)
    p[:len(pairs)] = torch.from_numpy(pairs.astype(np.int64))
    r[:len(pairs)] = torch.from_numpy(regs.astype(np.int64))
    return p, r, torch.tensor(len(pairs), dtype=torch.int32)


def hll_case(name: str):
    """(pairs, regs, num_pairs, num_groups, nseg) of one fold case."""
    rng = np.random.default_rng(len(name))
    t = A.HLL_LAST_BLOCK_GROUPS
    if name == "every_register":      # registers 1-54 in one group
        p, r, n = hll_page(rng, 1, 54, 64,
                           lambda k: np.arange(1, k + 1))
        return p, r, n, None, 1
    if name == "all_buckets_reg1":    # the largest high sums (2^32)
        p, r, n = hll_page(rng, 2, 2048, 4096, lambda k: np.ones(k, int))
        return p, r, n, torch.tensor(2, dtype=torch.int32), 4096
    if name == "all_buckets_reg23":   # the largest low sums (2^42)
        p, r, n = hll_page(rng, 1, 2048, 2048,
                           lambda k: np.full(k, 23))
        return p, r, n, None, 1
    if name == "empty_group":         # group 1 holds no pair
        p, r, n = hll_page(rng, 3, [5, 0, 2040], 4096)
        return p, r, n, torch.tensor(3, dtype=torch.int32), 4096
    if name == "one_group":
        p, r, n = hll_page(rng, 1, 700, 1024)
        return p, r, n, torch.tensor(1, dtype=torch.int32), 1024
    if name == "at_threshold":
        p, r, n = hll_page(rng, t, 3, 4 * t)
        return p, r, n, torch.tensor(t, dtype=torch.int32), t
    if name == "above_threshold":
        p, r, n = hll_page(rng, t + 1, 3, 4 * t + 4)
        return p, r, n, torch.tensor(t + 1, dtype=torch.int32), 4 * t + 4
    # "dead_rows": rows past num_pairs and groups past num_groups ignored
    p, r, n = hll_page(rng, 40, 33, 2048)
    return p, r, n - 11, torch.tensor(37, dtype=torch.int32), 2048


HLL_CASES = ["every_register", "all_buckets_reg1", "all_buckets_reg23",
             "empty_group", "one_group", "at_threshold", "above_threshold",
             "dead_rows"]


def live_groups(num_groups, nseg: int) -> int:
    return nseg if num_groups is None else min(int(num_groups), nseg)


@pytest.mark.parametrize("name", HLL_CASES)
def test_hll_packed_fold_gives_the_twin(name):
    """Two words a group (hi; lo with the count in bits 44-63) give
    hll_fold_plain's estimates bit for bit: every register 1-54, all
    2,048 buckets at register 1 (hi's largest sum) and at 23 (lo's), an
    empty group, one group, both sides of the last-block threshold."""
    pairs, regs, n, ng, nseg = hll_case(name)
    G = live_groups(ng, nseg)
    hi, lo = A.hll_fold_packed_plain(pairs, regs, n, ng, nseg)
    assert int(hi.max()) <= 1 << 32 and int((lo >> 44).max()) <= 2048
    assert int((lo & ((1 << 44) - 1)).max()) <= 2048 * (1 << 31)
    got = A.hll_estimate_packed_plain(hi, lo)[:G]
    assert torch.equal(got, A.hll_fold_plain(pairs, regs, n, ng, nseg)[:G])


def test_hll_packed_estimate_matches_reference():
    """test_torch_special_agg's reference inputs (every register 1-54 with
    the rest of the buckets at 1, an empty group, a few registers) through
    the two-word model: the reference's _hll_estimate per group."""
    regs = np.concatenate([np.arange(1, 55), np.ones(2048 - 54)])
    pairs = np.concatenate([np.arange(54), np.arange(54, 2048)]).astype(
        np.int64)
    pairs = np.concatenate([pairs, 2 * 2048 + np.arange(7)])
    regs = np.concatenate([regs, [3, 9, 20, 1, 2, 45, 54]]).astype(np.int64)
    hi, lo = A.hll_fold_packed_plain(
        torch.from_numpy(pairs), torch.from_numpy(regs),
        torch.tensor(len(pairs), dtype=torch.int32), None, 3)
    want = []
    for g in range(3):
        sel = (pairs >> 11) == g
        want.append(int(np.asarray(RA._hll_estimate(
            jnp.sum(jnp.exp2(-jnp.asarray(regs[sel], jnp.float64))),
            jnp.asarray(float(sel.sum()))))))
    assert A.hll_estimate_packed_plain(hi, lo).tolist() == want


def test_hll_grid_depends_on_the_capacity_alone():
    assert [A.hll_grid(c) for c in (0, 1, 1024, 1025, 1 << 20, 1 << 23)] \
        == [1, 1, 1, 2, A.HLL_GRID_MAX, A.HLL_GRID_MAX]


def hll_kernel_models(monkeypatch):
    """Run the HLL wrapper on CPU tensors: its launch runs a model that
    requires zero scratch words and ticket, adds the packed sums into
    them, and finalizes in the last block (at most last_max groups) or in
    the second launch, returning the words to zero. The scratch persists
    across calls as the per-device one does. Returns the launches."""
    calls = []
    scratch = {}

    def scratch_of(index, nseg):
        words, ticket = scratch.get(index, (None, None))
        if words is None or words.numel() < 2 * nseg:
            words = torch.zeros(2 * nseg, dtype=torch.int64)
            ticket = torch.zeros(1, dtype=torch.int32)
            scratch[index] = (words, ticket)
        return words, ticket

    def special_hll(pairs, regs, num_pairs, cap, num_groups, nseg, alpha_mm,
                    hi, lo, ticket, out, grid, last_max, stream):
        assert grid == A.hll_grid(cap)
        assert alpha_mm == A._HLL_ALPHA * A.HLL_M * A.HLL_M
        half = (lo - hi) // 8
        assert half >= nseg
        h = mem(hi, ctypes.c_int64, half, torch.int64)
        lw = mem(lo, ctypes.c_int64, half, torch.int64)
        assert ctypes.c_int32.from_address(ticket).value == 0
        assert not h.any() and not lw.any()
        n = ctypes.c_int32.from_address(num_pairs).value
        ng = None if num_groups == 0 else torch.tensor(
            ctypes.c_int32.from_address(num_groups).value)
        G = live_groups(ng, nseg)
        ph, pl = A.hll_fold_packed_plain(
            mem(pairs, ctypes.c_int64, cap, torch.int64),
            mem(regs, ctypes.c_int64, cap, torch.int64), n, ng, nseg)
        h[:nseg] += ph
        lw[:nseg] += pl
        mem(out, ctypes.c_int64, nseg, torch.int64)[:G] = \
            A.hll_estimate_packed_plain(h[:G], lw[:G])
        h[:G] = 0
        lw[:G] = 0
        launches = 1 + (nseg > last_max)
        calls.append((launches, "last block" if G <= last_max
                      else "second launch"))
        return 0
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 0)
    monkeypatch.setattr(native, "function",
                        lambda name, entry, argtypes: special_hll)
    monkeypatch.setattr(native, "raw_stream", lambda index: 0)
    monkeypatch.setattr(A, "_hll_scratch", scratch_of)
    return calls, scratch


@pytest.mark.parametrize("name", HLL_CASES)
def test_hll_wrapper_gives_the_twin_twice(monkeypatch, name):
    """Two calls in a row on the same inputs give the twin's estimates:
    the scratch and the ticket are zero again after each call. One launch
    while nseg is at most HLL_LAST_BLOCK_GROUPS."""
    pairs, regs, n, ng, nseg = hll_case(name)
    G = live_groups(ng, nseg)
    want = A.hll_fold_plain(pairs, regs, n, ng, nseg)[:G]
    calls, scratch = hll_kernel_models(monkeypatch)
    before = A.hll_fold_cuda.launches
    first = A.hll_fold_cuda(pairs, regs, n, ng, nseg)[:G].clone()
    second = A.hll_fold_cuda(pairs, regs, n, ng, nseg)[:G]
    assert A.hll_fold_cuda.launches == before + 2
    assert torch.equal(first, want) and torch.equal(second, want)
    words, _ = scratch[0]
    assert not words.any()
    t = A.HLL_LAST_BLOCK_GROUPS
    assert [c[0] for c in calls] == [1 + (nseg > t)] * 2
    assert [c[1] for c in calls] == ["last block" if G <= t
                                     else "second launch"] * 2


def test_hll_scratch_grows_to_the_largest_nseg(monkeypatch):
    calls, scratch = hll_kernel_models(monkeypatch)
    for name in ("one_group", "empty_group", "one_group"):
        A.hll_fold_cuda(*hll_case(name))
    assert scratch[0][0].numel() == 2 * 4096


def test_hll_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    pairs, regs, n, ng, nseg = hll_case("one_group")
    with pytest.raises(ValueError, match="CUDA"):
        A.hll_fold_cuda(pairs, regs, n, ng, nseg)
    hll_kernel_models(monkeypatch)
    with pytest.raises(ValueError, match="int64"):
        A.hll_fold_cuda(pairs.to(torch.int32), regs, n, ng, nseg)
    with pytest.raises(ValueError, match="int32"):
        A.hll_fold_cuda(pairs, regs, n.to(torch.int64), ng, nseg)
    with pytest.raises(ValueError, match="int32"):
        A.hll_fold_cuda(pairs, regs, n, ng.reshape(1), nseg)
    with pytest.raises(ValueError, match="contiguous"):
        A.hll_fold_cuda(pairs, regs[:-1], n, ng, nseg)
    assert A.hll_fold_cuda(pairs[:0], regs[:0], n, ng, 0).numel() == 0
