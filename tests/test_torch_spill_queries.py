"""Memory-bounded execution through the port's LocalQueryRunner at `tiny`
on the CPU, against the reference's rows, routes and spill counters.

The spilled joins of tests/test_queries.py (a dense unique build, a
composite key, a duplicate-key build), the aggregation and sort spill of
tests/test_spill.py (its NULL-key sort reads a subquery over lineitem),
tests/test_adaptive.py's tight-session cases (the partial-aggregation
downgrade to bypass, adaptive off, recursion, the fallback at zero
recursion, the skewed self-join, the heavy-key split and the fallback
with heavy detection off; its memory tables become subqueries over
lineitem), tests/test_memory.py's query_max_memory cases, and a
string-keyed build that overflows query_max_memory mid-collect. Each
query's rows equal the reference's (as multisets unless ordered), its
spill routes (`spill-dense`, `spill-search`, `partitioned`) the routes the
reference took (learned by wrapping the reference planner's methods at
test time), and its counters the reference's; the spill ledger ends at 0.
"""

import gc

import pytest
import torch

from oracle import assert_same
import trino_tpu.exec.local_planner as RL
from trino_tpu.exec import LocalQueryRunner as RefRunner
from trino_tpu_torch.exec import LocalQueryRunner as PortRunner
from trino_tpu_torch.exec.memory import ExceededMemoryLimitError
from trino_tpu_torch.exec.spill import SPILL_LEDGER

torch.set_num_threads(1)

SPILL_ROUTES = ("spill-dense", "spill-search", "partitioned")
COUNTERS = ("spilled_bytes", "agg_recursions", "join_recursions",
            "heavy_key_splits", "spill_fallbacks", "agg_mode_downgrades",
            "agg_mode_upgrades")

AGG_SQL = ("SELECT l_orderkey, l_linenumber, sum(l_extendedprice) AS s "
           "FROM lineitem GROUP BY l_orderkey, l_linenumber")
SKEW_JOIN_SQL = ("SELECT count(*), sum(l2.l_extendedprice) "
                 "FROM lineitem l1 JOIN lineitem l2 "
                 "ON l1.l_orderkey = l2.l_orderkey")
HEAVY_SQL = ("SELECT count(*), sum(b.v) FROM lineitem l JOIN (SELECT "
             "CASE WHEN l_orderkey % 2 = 0 THEN 7 ELSE l_orderkey END AS k, "
             "l_partkey AS v FROM lineitem) b ON l.l_orderkey = b.k")
HEAVY2_SQL = ("SELECT count(*), sum(b.v) FROM lineitem l JOIN (SELECT "
              "CAST(7 AS bigint) AS k, l_partkey AS v FROM lineitem "
              "WHERE l_orderkey % 4 = 0) b ON l.l_orderkey = b.k")
SPILL_AGG_SQL = ("SELECT l_orderkey, count(*) AS c, sum(l_extendedprice) "
                 "AS s, min(l_shipdate) AS mn, max(l_comment) AS mx, "
                 "avg(l_quantity) AS a FROM lineitem GROUP BY l_orderkey")
SORT_SQL = ("SELECT l_orderkey, l_partkey, l_shipdate, l_comment "
            "FROM lineitem ORDER BY l_shipdate DESC, l_orderkey, "
            "l_linenumber")
NULL_SORT_SQL = ("SELECT k, v FROM (SELECT CASE WHEN l_orderkey % 7 = 0 "
                 "THEN NULL ELSE l_orderkey END AS k, l_partkey AS v FROM "
                 "lineitem) t ORDER BY k ASC NULLS FIRST, v")


def tight(**extra):
    """tests/test_adaptive.py's _tight_session."""
    props = {"page_capacity": 2048, "scan_page_capacity": 2048,
             "spill_partition_count": 4,
             "agg_spill_threshold_bytes": 1 << 15,
             "join_spill_threshold_bytes": 1 << 14,
             "spill_max_recursion": 2}
    props.update(extra)
    return props


def small(**extra):
    """tests/test_spill.py's fixture session."""
    props = {"page_capacity": 4096, "scan_page_capacity": 4096,
             "spill_partition_count": 4}
    props.update(extra)
    return props


class RouteWatch:
    """The spill routes the reference planner takes: `_run_partitioned_
    inner` calls, and the probe kernel `_run_spilled_inner` asks the kernel
    cache for (dense or search)."""

    def __init__(self, monkeypatch):
        self.routes = []
        orig_part = RL.LocalExecutionPlanner._run_partitioned_inner
        orig_cached = RL.cached_kernel

        def part(planner, *a, **k):
            self.routes.append("partitioned")
            return orig_part(planner, *a, **k)

        def cached(key, *a, **k):
            if key[0] == "spill-probe-dense":
                self.routes.append("spill-dense")
            elif key[0] == "spill-probe":
                self.routes.append("spill-search")
            return orig_cached(key, *a, **k)
        monkeypatch.setattr(RL.LocalExecutionPlanner,
                            "_run_partitioned_inner", part)
        monkeypatch.setattr(RL, "cached_kernel", cached)


def run_both(monkeypatch, sql, props, ordered=None):
    """(port runner, port rows): rows, spill routes and counters held to
    the reference's."""
    port = PortRunner.tpch("tiny", device="cpu")
    ref = RefRunner.tpch("tiny")
    for k, v in props.items():
        port.session.set(k, v)
        ref.session.set(k, v)
    watch = RouteWatch(monkeypatch)
    want = ref.execute(sql).rows
    got = port.execute(sql).rows
    ordered = "ORDER BY" in sql if ordered is None else ordered
    if ordered:
        assert got == want
    else:
        assert_same(got, want, ordered=False)
    port_routes = sorted(j["route"] for j in port.last_joins
                         if j["route"] in SPILL_ROUTES)
    assert port_routes == sorted(watch.routes)
    for name in COUNTERS:
        assert port.last_query_stats[name] == \
            ref.last_query_stats.get(name, 0), name
    gc.collect()    # an abandoned operator's stores close when collected
    assert SPILL_LEDGER.reserved == 0
    return port, got


# ------------------------------------------- tests/test_queries.py:808-844

SPILLED_JOINS = {
    "dense_unique": ("SELECT o_orderkey, c_name FROM orders, customer "
                     "WHERE o_custkey = c_custkey AND o_orderkey <= 100",
                     "spill-dense"),
    "composite": ("SELECT l_orderkey, l_linenumber, ps_availqty "
                  "FROM lineitem, partsupp "
                  "WHERE l_partkey = ps_partkey AND l_suppkey = ps_suppkey "
                  "AND l_orderkey <= 40", "partitioned"),
    "nonunique": ("SELECT o_orderkey, l_linenumber FROM orders, lineitem "
                  "WHERE o_orderkey = l_orderkey AND o_orderkey <= 30",
                  "spill-dense"),
    "wide_span": ("SELECT o.o_orderkey, c.c_name FROM (SELECT o_orderkey, "
                  "o_custkey * 1000000000 AS k FROM orders WHERE o_orderkey "
                  "<= 2000) o JOIN (SELECT c_name, c_custkey * 1000000000 "
                  "AS k FROM customer) c ON o.k = c.k", "spill-search"),
    "composite_unique": ("SELECT p_name, ps_availqty FROM part, partsupp, "
                         "supplier WHERE p_partkey = ps_partkey AND "
                         "s_suppkey = ps_suppkey AND p_size < 3",
                         None),
}


@pytest.mark.parametrize("name", sorted(SPILLED_JOINS))
def test_spilled_join_matches_reference(monkeypatch, name):
    sql, route = SPILLED_JOINS[name]
    port, rows = run_both(monkeypatch, sql,
                          {"join_spill_threshold_bytes": 1024})
    assert rows
    routes = [j["route"] for j in port.last_joins]
    if route is not None:
        assert route in routes
    for j in port.last_joins:
        if j["route"] in SPILL_ROUTES:
            assert j["build_bytes"] > 0 and j["host_bytes"] >= 0
            assert port.last_query_stats["spilled_bytes"] > 0


def test_spilled_search_route_takes_the_host_attach(monkeypatch):
    """A composite unique build past the threshold: K16's keys, K17's
    search mode and the host attach with its composite re-check."""
    sql = ("SELECT l.l_orderkey, l.l_linenumber, o.o_totalprice FROM "
           "(SELECT l_orderkey, l_linenumber, l_orderkey % 1000 AS k2 FROM "
           "lineitem) l JOIN (SELECT o_orderkey, o_totalprice, o_orderkey "
           "% 1000 AS k2 FROM orders) o ON l.l_orderkey = o.o_orderkey AND "
           "l.k2 = o.k2")
    port, rows = run_both(monkeypatch, sql,
                          {"join_spill_threshold_bytes": 4096})
    assert [j["route"] for j in port.last_joins] == ["spill-search"]
    assert port.last_joins[0]["host_bytes"] > 0
    assert len(rows) == 60050


# --------------------------------------------------- tests/test_spill.py


@pytest.mark.parametrize("sql,props", [
    (SPILL_AGG_SQL, small(agg_spill_threshold_bytes=262144)),
    (SORT_SQL, small(sort_spill_threshold_bytes=262144)),
    (NULL_SORT_SQL, small(sort_spill_threshold_bytes=262144)),
    ("SELECT count(*), sum(l_quantity) FROM lineitem",
     small(agg_spill_threshold_bytes=65536)),
], ids=["agg", "sort", "null_sort", "global_agg"])
def test_spill_shapes_match_reference(monkeypatch, sql, props):
    port, rows = run_both(monkeypatch, sql, props)
    if "GROUP BY" in sql or "ORDER BY" in sql:
        assert port.last_query_stats["spilled_bytes"] > 0
        assert len(rows) > 1000
    else:
        assert port.last_query_stats["spilled_bytes"] == 0


# ------------------------------------------------- tests/test_adaptive.py


@pytest.mark.parametrize("sql,props,counter", [
    (AGG_SQL, tight(), "agg_mode_downgrades"),
    (AGG_SQL, tight(adaptive_partial_agg=False), None),
    (AGG_SQL, tight(spill_max_recursion=0), "spill_fallbacks"),
    (SKEW_JOIN_SQL, tight(), "join_recursions"),
    (HEAVY_SQL, tight(), "heavy_key_splits"),
    (HEAVY2_SQL, tight(spill_heavy_key_limit=0, spill_max_recursion=1),
     "spill_fallbacks"),
], ids=["downgrade", "adaptive_off", "fallback_zero_recursion",
        "skewed_self_join", "heavy_key_split", "fallback_no_heavy"])
def test_tight_session_matches_reference(monkeypatch, sql, props, counter):
    port, _ = run_both(monkeypatch, sql, props)
    stats = port.last_query_stats
    if counter is not None:
        assert stats[counter] > 0
    if props.get("adaptive_partial_agg") is False:
        assert stats["agg_mode_downgrades"] == 0
    if sql == AGG_SQL and props.get("spill_max_recursion") == 2 \
            and props.get("adaptive_partial_agg", True):
        assert stats["agg_recursions"] > 0
    if sql == SKEW_JOIN_SQL:
        assert stats["join_recursions"] <= 4 + 4 * 4
        assert [j["route"] for j in port.last_joins] == ["partitioned"]
        assert port.last_joins[0]["depth"] >= 1


def test_spill_budget_exceeded_is_classified():
    from trino_tpu_torch.errors import TrinoError
    port = PortRunner.tpch("tiny", device="cpu")
    for k, v in tight(spill_max_bytes=8192).items():
        port.session.set(k, v)
    with pytest.raises(TrinoError) as ei:
        port.execute(AGG_SQL)
    assert ei.value.error_name == "EXCEEDED_SPILL_LIMIT"
    assert not ei.value.retryable
    gc.collect()
    assert SPILL_LEDGER.reserved == 0 and SPILL_LEDGER.denials > 0


# --------------------------------------------------- tests/test_memory.py


@pytest.mark.parametrize("limit", [1000, 0])
def test_query_over_limit_fails_cleanly(limit):
    port = PortRunner.tpch("tiny", device="cpu")
    port.session.set("query_max_memory", limit)
    with pytest.raises(ExceededMemoryLimitError) as ei:
        # the ORDER BY collects the whole customer table
        port.execute("SELECT c_custkey FROM customer ORDER BY c_acctbal")
    assert "Query exceeded per-node memory limit" in str(ei.value)
    assert ei.value.error_name == "EXCEEDED_LOCAL_MEMORY_LIMIT"
    port.session.properties.pop("query_max_memory")
    assert port.execute("SELECT count(*) FROM customer").rows == [(1500,)]


def test_string_key_build_overflows_mid_collect(monkeypatch):
    """A string-keyed INNER build past query_max_memory mid-collect hands
    off to the streaming partitioned join through the host restage onto
    one pool; rows equal the reference's and the in-memory run's."""
    sql = ("SELECT count(*), sum(o2.o_orderkey) FROM orders o JOIN "
           "(SELECT o_clerk AS k, o_orderkey FROM orders WHERE "
           "o_orderkey % 3 = 0) o2 ON o.o_clerk = o2.k "
           "WHERE o.o_orderkey < 4000")
    baseline = PortRunner.tpch("tiny", device="cpu").execute(sql).rows
    props = small(query_max_memory=65536)
    port, rows = run_both(monkeypatch, sql, props)
    assert rows == baseline and rows[0][0] > 1000
    assert [j["route"] for j in port.last_joins] == ["partitioned"]
    assert port.last_query_stats["spilled_bytes"] > 0


def test_result_conversion_matches_per_cell():
    """The runner converts result columns at once (the forced spill runs
    return millions of rows); the values and their Python types equal the
    per-cell conversion's for every type, NULLs included."""
    from trino_tpu_torch.exec import runner as R
    from trino_tpu_torch.exec.local_planner import LocalExecutionPlanner
    from trino_tpu_torch.sql import parse_statement
    port = PortRunner.tpch("tiny", device="cpu")
    sql = ("SELECT o_orderkey, CASE WHEN o_orderkey % 3 = 0 THEN NULL ELSE "
           "o_totalprice END, CASE WHEN o_orderkey % 5 = 0 THEN NULL ELSE "
           "o_orderdate END, CASE WHEN o_orderkey % 7 = 0 THEN NULL ELSE "
           "o_comment END, o_orderkey % 2 = 0, CAST(o_totalprice AS real), "
           "CAST(o_orderkey AS integer), CAST(o_totalprice AS double) "
           "FROM orders")
    plan = port._plan(parse_statement(sql))
    types = [s.type for s in plan.symbols]
    executor = LocalExecutionPlanner(port.metadata, port.session, "cpu")
    checked = 0
    for page in executor.execute(plan).iter_pages():
        n = int(page.num_rows)
        cols = page.to_host(n)
        per_cell = [tuple(R._to_python(cols[j][i], types[j])
                          for j in range(len(cols))) for i in range(n)]
        at_once = list(zip(*(R.column_values(c, t)
                             for c, t in zip(cols, types))))
        assert at_once == per_cell
        assert [[type(x) for x in r] for r in at_once] == \
            [[type(x) for x in r] for r in per_cell]
        checked += n
    assert checked == 15000
