"""chip_smoke.py runs on the card the TPC-H queries that the CPU parity
tests check: its own copy of the 22 SQL texts (it may not import
tests/tpch_sql.py, which imports the JAX package) must equal
tests/tpch_sql.py's QUERIES, text and row-order flag alike. Its window
queries W1-W8 (which tests/test_torch_window_queries.py runs against the
reference) cover what the window slice puts on the card."""

import importlib.util
import pathlib

import pytest

from tpch_sql import QUERIES

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
