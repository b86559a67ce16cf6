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


def test_launch_trace_queries_are_chip_smokes(chip_smoke):
    """The host trace captures K2 and K4 from the same q1 and q6 texts
    that chip_smoke.py runs."""
    from trino_tpu_torch import launch_trace
    assert launch_trace.Q1 == chip_smoke.TPCH["q1"][0]
    assert launch_trace.Q6 == chip_smoke.TPCH["q6"][0]
