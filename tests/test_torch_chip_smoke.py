"""chip_smoke.py runs on the card the TPC-H queries that the CPU parity
tests check: its own copy of the 22 SQL texts (it may not import
tests/tpch_sql.py, which imports the JAX package) must equal
tests/tpch_sql.py's QUERIES, text and row-order flag alike. Its window
queries W1-W8 (which tests/test_torch_window_queries.py runs against the
reference) cover what the window slice puts on the card."""

import importlib.util
import pathlib

import pytest
import torch

from tpch_sql import QUERIES

torch.set_num_threads(1)
_REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_sql", _REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)    # defines, runs nothing: main() guarded
    return module


def test_chip_smoke_carries_every_query(chip_smoke):
    assert list(chip_smoke.TPCH) == sorted(QUERIES,
                                           key=lambda q: int(q[1:]))


@pytest.mark.parametrize("name", sorted(QUERIES, key=lambda q: int(q[1:])))
def test_chip_smoke_sql_equals_the_parity_tests(chip_smoke, name):
    sql, _, ordered = QUERIES[name]
    assert chip_smoke.TPCH[name] == (sql, ordered)


def test_chip_smoke_window_queries_cover_the_slice(chip_smoke):
    """W1-W8: W7 at sf10, the rest at sf1; between them every ranking and
    value function, running RANGE, bounded, reversed and whole frames, a
    ROLLUP with grouping(), a CUBE, UNION ALL and a string UNION."""
    queries = chip_smoke.WINDOW_QUERIES
    assert list(queries) == [f"W{i}" for i in range(1, 9)]
    assert [queries[w][0] for w in queries] == ["sf1"] * 6 + ["sf10", "sf1"]
    text = " ".join(" ".join(sql.split())
                    for _, _, sql in queries.values()).lower()
    for part in ("row_number()", "rank()", "dense_rank()", "percent_rank()",
                 "cume_dist()", "ntile(4)", "lead(", "lag(", "first_value(",
                 "last_value(", "nth_value(", "group by rollup",
                 "group by cube", "grouping(", "union all", "union select",
                 "rows between 1 following and unbounded following",
                 "rows between 2 preceding and 2 following"):
        assert part in text, part


def test_chip_smoke_window_pages_cover_the_edges(chip_smoke):
    pages = chip_smoke.WIN_PAGES
    assert pages["4M rows"][0] == 4_194_304
    frames = set(chip_smoke.WIN_FRAMES)
    assert {"whole", "rows", "range", "b0_0", "b-5000_None"} <= frames
    assert set(chip_smoke.WIN_BIG_FRAMES) <= frames


def test_chip_smoke_sort_sizes_cover_the_new_paths(chip_smoke):
    """Phase 2's K10 pages: the earlier sizes, both sides of the one-block
    threshold by capacity and by live rows, a capacity off the tile, no
    live row on a large capacity, equal rows on both paths and 16,777,216
    rows; the u64 sort on both sides of the threshold and at a D4 shard's
    8,388,608 words."""
    from trino_tpu_torch.ops import sort as S
    sizes = chip_smoke.sort_sizes()
    plain = {(c, n) for c, n, same in sizes if not same}
    small = S.SMALL_ROWS
    assert {(1, 1), (100, 0), (300, 257), (4096, 4093), (65_536, 65_536),
            (65_537, 65_537), (131_072, 100_003),
            (4_194_304, 4_194_304)} <= plain
    assert {(small, small), (small + 1, small + 1)} <= plain
    assert any(c > small and n == small for c, n in plain)
    assert any(c > small and n == small + 1 for c, n in plain)
    assert any(c % S.SORT_TILE and c > S.SORT_TILE for c, _ in plain)
    assert any(n == 0 and c >= 1 << 20 for c, n in plain)
    assert (16_777_216, 16_777_216) in plain
    same = [(c, n) for c, n, s in sizes if s]
    for path in (lambda c: c <= small, lambda c: c > small):
        assert any(path(c) and n == c for c, n in same)
        assert any(path(c) and 0 < n < c for c, n in same)
    u64 = chip_smoke.U64_SIZES
    assert {small, small + 1, 8_388_608} <= set(u64)


def test_chip_smoke_times_k10_at_three_shapes(chip_smoke):
    """Phase 4's K10 rows: q16's ORDER BY and W2's window sort (both sf1
    queries of the card's main path), and the u64 sort, with distinct
    names in the kernels line."""
    timed = chip_smoke.K10_TIMED
    assert set(timed) == {"q16", "W2"}
    assert "order by" in chip_smoke.TPCH["q16"][0].lower()
    assert chip_smoke.WINDOW_QUERIES["W2"][0] == "sf1"
    assert len(set(timed.values())) == 2
    import inspect
    src = inspect.getsource(chip_smoke.kernel_rows_dist)
    assert '("sort_u64_cuda", "dist")' in src


@pytest.mark.parametrize("index", range(13))
def test_chip_smoke_sort_pages_replay_on_the_cpu(chip_smoke, index):
    """Each phase-2 page up to 65,537 rows of capacity, on the CPU: the
    plain model of K10's pass plan gives the twin's permutation over the
    live rows and the identity past them, for two key sets."""
    from trino_tpu_torch.ops import sort as S
    sizes = [s for s in chip_smoke.sort_sizes() if s[0] <= 65_537]
    assert len(sizes) == 13
    cap, n, same = sizes[index]
    page = chip_smoke.sort_page(cap, n, 500 + index, "cpu")
    if same:
        page = chip_smoke.same_page(page)
    for ks in (chip_smoke.SORT_KEYSETS[0], chip_smoke.SORT_KEYSETS[3]):
        keys = [S.SortKey(c, a, nf) for c, a, nf in ks]
        words = S.encode_sort_keys(page, keys)
        passes = S.sort_passes(S.sort_layout(page, keys))
        got = S.radix_replay_plain(words, page.num_rows, passes)
        want = S.sort_rows_plain(page, keys)
        assert torch.equal(got[:n].to(torch.int64), want[:n])
        assert torch.equal(got[n:].to(torch.int64), torch.arange(n, cap))
        if same:
            assert not any(S.informative_passes_plain(words, page.num_rows,
                                                      passes))


@pytest.mark.parametrize("kind", ["random", "duplicates"])
def test_chip_smoke_u64_words_replay_on_the_cpu(chip_smoke, kind):
    """The u64 sort's plan (one word, eight passes) over phase 2's words up
    to 8,193: its keys in permutation order equal torch.sort's."""
    from trino_tpu_torch.ops import sort as S
    lo = -(1 << 63)
    for n in [n for n in chip_smoke.U64_SIZES if n <= 8193]:
        words = chip_smoke.sort_u64_words(kind, n, 900 + n, "cpu")
        perm = S.radix_replay_plain([words ^ lo], n,
                                    [(0, 8 * b) for b in range(8)])
        want = torch.sort(words ^ lo, stable=True).values ^ lo
        assert torch.equal(words[perm.to(torch.int64)], want)


def test_chip_smoke_concat_cases_cover_the_one_launch_design(chip_smoke):
    """Phase 2's K2 layouts: no live row, one page of one row, 64 pages,
    pages without validity, narrower planes and the receive's shape (8
    slices of 2,097,152 rows, 12 arrays, 161,549 live rows)."""
    cases = chip_smoke.CONCAT_CASES
    assert all(n == 0 for _, n, _ in cases["none_live"])
    assert cases["single_row"] == [(1, 1, None)]
    assert len(cases["64_pages"]) == 64
    widths = [L for _, _, L in cases["narrower_planes"]]
    assert None not in widths and len(set(widths)) == len(widths)
    receive = cases["receive"]
    assert [c for c, _, _ in receive] == [2_097_152] * 8
    assert sum(n for _, n, _ in receive) == 161_549
    for name, layout in cases.items():
        assert all(0 <= n <= c for c, n, _ in layout), name
    g = torch.Generator().manual_seed(0)
    arrays, counts, out_cap = chip_smoke.concat_layout(
        g, [(5, 3, None), (7, 7, 2)], "cpu")
    assert out_cap == 12 and arrays[1][3] is None
    assert arrays[0][3].dtype == torch.bool and arrays[1][4].shape == (7, 2)
    arrays, _, _ = chip_smoke.concat_layout(g, [(4, 4, None)] * 2, "cpu",
                                            receive=True)
    assert all(len(pa) == 12 and None not in pa for pa in arrays)


def test_chip_smoke_global_cases_cover_the_one_launch_design(chip_smoke):
    """Phase 2's K4 calls: 1, 8, 9 and 17 states in one launch, no live
    row and every row live, capacities off the grid's stride; the floats
    carry NaN, +-0.0 and +-inf."""
    from trino_tpu_torch.ops import aggregate as A
    cases = chip_smoke.GLOBAL_CASES
    assert {1, 8, 9, 17} <= {k for _, _, k in cases}
    assert any(n == 0 < c for c, n, _ in cases)
    assert any(n == c > 0 for c, n, _ in cases)
    assert any(c % (A.global_grid(c) * A.GLOBAL_THREADS) for c, _, _ in cases
               if c)
    g = torch.Generator().manual_seed(0)
    states = chip_smoke.global_states(g, 5000, "cpu", 17)
    assert len(states) == 17
    assert {(s.kind, s.is_float) for s in states} == {
        (A.SUM, False), (A.SUM, True), (A.COUNT, False), (A.MIN, False),
        (A.MAX, False), (A.MIN, True), (A.MAX, True)}
    f = torch.cat([s.values for s in states if s.is_float])
    assert torch.isnan(f).any() and torch.isinf(f).any()
    assert (f == float("-inf")).any() and (f == 0).any()
    assert (torch.signbit(f) & (f == 0)).any()


def test_chip_smoke_spill_cases_cover_the_live_prefix_plan(chip_smoke):
    """Phase 2's K16 builds: sf1's spilled orders build (2,097,152 slots,
    1,500,000 live, two key columns without validity), no live row and
    every row live above K10's one-block threshold, NULL keys with a live
    -1, composite, float, code and bool keys, an empty build."""
    from trino_tpu_torch.ops import sort as S
    cases = chip_smoke.SPILL_JOIN_CASES
    assert ("orders", 2_097_152, 1_500_000) in {c[:3] for c in cases}
    assert any(n == 0 and c > S.SMALL_ROWS for _, c, n, *_ in cases)
    assert any(n == c > S.SMALL_ROWS for _, c, n, *_ in cases)
    assert any(n == 0 for _, c, n, *_ in cases if c <= S.SMALL_ROWS)
    assert {"minus1", "composite", "float", "codes", "bool", "wide",
            "dense", "orders"} == {k for k, *_ in cases}
    g = torch.Generator().manual_seed(0)
    cols = chip_smoke.spill_key_cols(g, "orders", 64, 48, False, "cpu")
    assert len(cols) == 2 and all(v is None for _, v in cols)


SPILL_REPLAYED = 14


@pytest.mark.parametrize("index", range(SPILL_REPLAYED))
def test_chip_smoke_spill_builds_replay_on_the_cpu(chip_smoke, index):
    """Each phase-2 K16 build up to 65,536 slots (the orders build at
    20,000 slots), on the CPU: K16's plan (the prep words, K10's passes
    over the live prefix, the finish) gives spill_prep_plain's sorted
    keys, permutation and statistics bit for bit."""
    from trino_tpu_torch.ops import join as J
    cases = [(k, c, n, d) if c <= 65_536 else (k, 20_000, 15_000, d)
             for k, c, n, d, *_ in chip_smoke.SPILL_JOIN_CASES
             if c <= 65_536 or k == "orders"]
    assert len(cases) == SPILL_REPLAYED
    kind, cap, n, dup = cases[index]
    g = torch.Generator().manual_seed(700 + index)
    cols = chip_smoke.spill_key_cols(g, kind, cap, n, dup, "cpu")
    nr = torch.tensor(n, dtype=torch.int32)
    for got, want in zip(J.spill_plan_plain(cols, nr),
                         J.spill_prep_plain(cols, nr)):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_chip_smoke_special_cases_cover_the_hll_threshold(chip_smoke):
    """Phase 2's HLL folds: one group, a grouped page of at most
    HLL_LAST_BLOCK_GROUPS slots (one launch, the last block estimates),
    few groups on a larger page (two launches, the second finds nothing
    to do) and more groups than the last block takes (the second
    launch estimates); a global fold takes one launch."""
    from trino_tpu_torch.ops import aggregate as A
    t = A.HLL_LAST_BLOCK_GROUPS
    grouped = [(c, k) for _, c, _, k in chip_smoke.SPECIAL_CASES if k and c]
    assert any(k == 1 for _, k in grouped)
    assert any(c <= t for c, _ in grouped)
    assert any(k <= t < c for c, k in grouped)
    assert any(k > t for _, k in grouped)
    assert {1 + (c > t) for c, _ in grouped} == {1, 2}
    assert any(k == 0 and c for _, c, _, k in chip_smoke.SPECIAL_CASES)


def test_launch_trace_queries_are_chip_smokes(chip_smoke):
    """The host trace captures K2 and K4 from the same q1 and q6 texts
    that chip_smoke.py runs."""
    from trino_tpu_torch import launch_trace
    assert launch_trace.Q1 == chip_smoke.TPCH["q1"][0]
    assert launch_trace.Q6 == chip_smoke.TPCH["q6"][0]


def test_chip_smoke_heavy_cases_cover_the_one_launch_design(chip_smoke):
    """Phase 2's K36 local-mode cases: cap 0, cap < k, all sentinel, every
    live word distinct, fewer keys than k, a run of 1,000,000 over many
    tiles, runs from tile boundaries and the D4 sf10 q9 shard's shape
    (8,388,608 words, 3,805,999 live), each at k 1, 8 and 64, two calls
    in a row; K27 for 0, 1, 2, 9 and 40 helpers."""
    from trino_tpu_torch.parallel import exchange as X
    assert chip_smoke.HEAVY_KS == (1, 8, 64)
    assert chip_smoke.HEAVY_D4 == (8_388_608, 3_805_999, 1_000_000)
    layouts = {lay: cap for _, cap, lay in chip_smoke.HEAVY_CASES}
    assert set(layouts) == {"empty", "short", "sentinel", "distinct", "few",
                            "long", "boundary", "d4"}
    assert layouts["empty"] == 0 and 0 < layouts["short"] < 8
    g = torch.Generator().manual_seed(0)
    words = {lay: chip_smoke.heavy_case_words(g, cap, lay)
             for lay, cap in layouts.items() if lay != "d4"}
    for lay, w in words.items():
        assert w.shape == (layouts[lay],) and w.dtype == torch.int64
        u = w ^ (-(1 << 63))
        assert bool((u[1:] >= u[:-1]).all()), lay   # unsigned ascending
    assert not (words["sentinel"] != -1).any()
    d = words["distinct"][words["distinct"] != -1]
    assert d.unique().numel() == d.numel() < layouts["distinct"]
    assert words["few"][words["few"] != -1].unique().numel() < 8
    _, runs = torch.unique_consecutive(words["long"], return_counts=True)
    assert int(runs.max()) == 1_000_000 >= 244 * X.HEAVY_TILE
    b = words["boundary"]
    # a run of 4,096 from the tile boundary 4,096, one of 4,097 from 8,192
    assert b[4095] != b[4096] == b[8191] != b[8192] == b[12_288] \
        != b[12_289]
    assert set(chip_smoke.POST_HELPERS) == {0, 1, 2, 9, 40}


@pytest.mark.parametrize("layout", ["short", "sentinel", "distinct", "few",
                                    "boundary"])
def test_chip_smoke_heavy_cases_replay_on_the_cpu(chip_smoke, layout):
    """Each phase-2 K36 case up to 50,000 words, on the CPU: the model of
    the one-launch plan gives heavy_local_plain's counts and keys bit for
    bit at k 1, 8 and 64."""
    from trino_tpu_torch.parallel import exchange as X
    cap = {lay: c for _, c, lay in chip_smoke.HEAVY_CASES}[layout]
    g = torch.Generator().manual_seed(31)
    words = chip_smoke.heavy_case_words(g, cap, layout)
    for k in chip_smoke.HEAVY_KS:
        counts, keys, _ = X.heavy_local_model(words, k)
        want = X.heavy_local_plain(words, k)
        assert torch.equal(counts, want[0]) and torch.equal(keys, want[1])


def test_launch_trace_heavy_words_have_the_shards_shape():
    """launch_trace's K36 input (and phase 2's D4 case): `live` words of
    at most `keys` distinct values in unsigned order, the sentinel after."""
    from trino_tpu_torch import launch_trace
    w = launch_trace.heavy_words(10_000, 3_806, 1_000)
    assert int((w != -1).sum()) == 3_806 and not (w[3_806:] != -1).any()
    u = w[:3_806] ^ (-(1 << 63))
    assert bool((u[1:] >= u[:-1]).all()) and u.unique().numel() <= 1_000


@pytest.mark.parametrize("kernels,memsets,n,verdict", [
    (10, 0, 10, "clean"), (50, 0, 50, "clean"),
    (0, 0, 10, "lossy"), (9, 0, 10, "lossy"), (11, 0, 10, "lossy"),
    (10, 3, 10, "lossy"),
    (20, 0, 10, "extra"), (10, 10, 10, "extra"), (0, 10, 10, "extra")])
def test_chip_smoke_enqueue_windows(chip_smoke, kernels, memsets, n,
                                    verdict):
    """A profiler window that dropped device events neither passes nor
    fails the one-enqueue check; only a clean window passes it, and only
    a whole extra kernel or memset a call counts against it."""
    assert chip_smoke.enqueue_window(kernels, memsets, n) == verdict
