"""End-to-end parity: trino_tpu_torch's LocalQueryRunner (device="cpu")
against trino_tpu's LocalQueryRunner on TPC-H `tiny`.

All 22 TPC-H queries of tests/tpch_sql.py, single-table queries in the
style of tests/test_queries.py (scan, filter, arithmetic, global,
dictionary-key and general GROUP BY, ORDER BY, LIMIT, TopN, OFFSET) and
joins (unique builds on both join routes, string keys across
dictionaries, a residual filter, composite keys, RIGHT, FULL and cross
joins, an IN subquery inside an OR (MARK), NOT IN against a build holding
a NULL, a scalar subquery with no row). Rows compare through
tests/oracle.assert_same (decimals and integers exact, doubles to 1e-9
relative). The EXPLAIN text of the TPC-H queries must match too, so that
a row mismatch is an execution fault and not a planning one.
"""

import pytest
import torch

from oracle import assert_same
from tpch_sql import QUERIES
from trino_tpu.exec import LocalQueryRunner as RefRunner
from trino_tpu_torch.exec import LocalQueryRunner as PortRunner

torch.set_num_threads(1)

SINGLE_TABLE = {
    "filter_scan": ("SELECT n_nationkey, n_name FROM nation "
                    "WHERE n_regionkey = 1", False),
    "arithmetic": ("SELECT n_nationkey + 100, n_nationkey * 2, "
                   "n_nationkey / 3, n_nationkey % 4 FROM nation", False),
    "topn_desc": ("SELECT n_name FROM nation ORDER BY n_name DESC LIMIT 5",
                  True),
    "in_list_sort": ("SELECT n_name FROM nation WHERE n_regionkey IN (0, 3) "
                     "ORDER BY n_name", True),
    "case_when": ("SELECT n_name, CASE WHEN n_regionkey = 0 THEN 'africa' "
                  "WHEN n_regionkey = 1 THEN 'america' ELSE 'other' END "
                  "FROM nation", False),
    "string_fns": ("SELECT upper(n_name), length(n_name), "
                   "substr(n_name, 1, 3) FROM nation WHERE n_name LIKE '%IA'",
                   False),
    "global_agg": ("SELECT count(*), sum(n_regionkey), min(n_name), "
                   "max(n_name) FROM nation", False),
    "count_filter": ("SELECT count(*) FILTER (WHERE n_regionkey = 2), "
                     "count(*) FROM nation", False),
    "dict_key_group_by": ("SELECT l_returnflag, count(*), sum(l_quantity), "
                          "avg(l_discount), min(l_shipdate), "
                          "max(l_extendedprice) FROM lineitem "
                          "GROUP BY l_returnflag", False),
    "two_key_group_order": ("SELECT o_orderstatus, o_orderpriority, "
                            "count(*), avg(o_totalprice), min(o_orderdate) "
                            "FROM orders GROUP BY o_orderstatus, "
                            "o_orderpriority ORDER BY 1, 2", True),
    "order_limit": ("SELECT l_orderkey, l_linenumber, l_extendedprice "
                    "FROM lineitem WHERE l_quantity > 49 "
                    "ORDER BY l_extendedprice DESC, l_orderkey, "
                    "l_linenumber LIMIT 10", True),
    "offset": ("SELECT n_name FROM nation ORDER BY n_nationkey OFFSET 20",
               True),
    "double_agg": ("SELECT avg(CAST(l_quantity AS double)), "
                   "sum(CAST(l_tax AS double)), min(l_discount) "
                   "FROM lineitem WHERE l_shipmode IN ('MAIL', 'SHIP')",
                   False),
    "limit": ("SELECT l_orderkey FROM lineitem LIMIT 7", False),
    "general_group_by": ("SELECT l_orderkey, l_shipdate, count(*), "
                         "sum(l_quantity), avg(l_discount), "
                         "max(l_extendedprice) FROM lineitem "
                         "WHERE l_orderkey < 2000 "
                         "GROUP BY l_orderkey, l_shipdate", False),
    "double_key_group_by": ("SELECT CAST(l_discount AS double) * -1, "
                            "l_returnflag, count(*), min(l_tax) "
                            "FROM lineitem GROUP BY 1, 2", False),
}

JOINS = {
    "fact_to_dim": ("SELECT o_orderpriority, count(*), sum(l_quantity) "
                    "FROM lineitem JOIN orders ON l_orderkey = o_orderkey "
                    "WHERE o_orderdate < DATE '1993-06-01' "
                    "GROUP BY o_orderpriority", False),
    "string_keys_across_pools": (
        "SELECT n_nationkey, x.k FROM nation JOIN (VALUES ('GERMANY', 1), "
        "('FRANCE', 2), ('ATLANTIS', 3)) AS x(name, k) ON n_name = x.name",
        False),
    "residual_filter": ("SELECT c_name, o_orderkey FROM orders JOIN "
                        "customer ON o_custkey = c_custkey AND "
                        "o_totalprice > c_acctbal * 40", False),
    "composite_keys": ("SELECT count(*), sum(ps_supplycost) FROM lineitem "
                       "JOIN partsupp ON l_partkey = ps_partkey "
                       "AND l_suppkey = ps_suppkey", False),
    "three_way": ("SELECT n_name, count(*) FROM customer JOIN nation ON "
                  "c_nationkey = n_nationkey JOIN region ON n_regionkey = "
                  "r_regionkey WHERE r_name = 'ASIA' GROUP BY n_name "
                  "ORDER BY n_name", True),
    "right_join": ("SELECT n_name, r_name FROM (SELECT * FROM region "
                   "WHERE r_name <> 'ASIA') r RIGHT JOIN nation "
                   "ON n_regionkey = r_regionkey", False),
    "full_join": ("SELECT n_name, r_name FROM (SELECT * FROM nation WHERE "
                  "n_regionkey < 2) n FULL JOIN (SELECT * FROM region "
                  "WHERE r_regionkey > 0) r ON n_regionkey = r_regionkey",
                  False),
    "cross_join": ("SELECT n_name, r_name FROM nation CROSS JOIN region "
                   "WHERE n_nationkey < 3", False),
    "mark_in_or": ("SELECT n_name FROM nation WHERE n_regionkey IN "
                   "(SELECT r_regionkey FROM region WHERE r_name LIKE 'A%') "
                   "OR n_nationkey = 3", False),
    "not_in_null_build": ("SELECT n_name, n_regionkey NOT IN (SELECT x FROM "
                          "(VALUES 1, NULL) t(x)) FROM nation", False),
    "not_in_null_build_filter": ("SELECT n_name FROM nation WHERE "
                                 "n_regionkey NOT IN (SELECT x FROM "
                                 "(VALUES 1, NULL) t(x))", False),
    "scalar_zero_rows": ("SELECT n_name, (SELECT r_name FROM region WHERE "
                         "r_regionkey = 99) FROM nation WHERE "
                         "n_nationkey < 3", False),
}


@pytest.fixture(scope="module")
def runners():
    return RefRunner.tpch("tiny"), PortRunner.tpch("tiny", device="cpu")


@pytest.mark.parametrize("name", sorted(QUERIES, key=lambda q: int(q[1:])))
def test_tpch_query_matches_reference(runners, name):
    ref, port = runners
    sql, _, ordered = QUERIES[name]
    assert port.execute(f"EXPLAIN {sql}").rows == \
        ref.execute(f"EXPLAIN {sql}").rows
    got = port.execute(sql)
    want = ref.execute(sql)
    assert got.column_names == want.column_names
    assert [t.display() for t in got.column_types] == \
        [t.display() for t in want.column_types]
    assert_same(got.rows, want.rows, ordered)


@pytest.mark.parametrize("name", sorted(SINGLE_TABLE))
def test_single_table_query_matches_reference(runners, name):
    ref, port = runners
    sql, ordered = SINGLE_TABLE[name]
    got = port.execute(sql).rows
    want = ref.execute(sql).rows
    if name == "limit":     # any 7 rows of the table
        assert len(got) == len(want) == 7
        return
    assert_same(got, want, ordered)


@pytest.mark.parametrize("name", sorted(JOINS))
def test_join_query_matches_reference(runners, name):
    ref, port = runners
    sql, ordered = JOINS[name]
    assert_same(port.execute(sql).rows, ref.execute(sql).rows, ordered)
    assert port.last_joins and all(
        j["route"] in ("mxu", "dense", "search") or j["kind"] == "cross"
        for j in port.last_joins)
    # the joins the reference routes onto its matrix-unit lookup
    assert port.last_query_stats["mxu_joins"] == \
        ref.last_query_stats.get("mxu_joins", 0)


def test_scalar_subquery_with_two_rows_raises(runners):
    """EnforceSingleRow: more than one row raises the reference's error."""
    from trino_tpu_torch.exec.local_planner import ExecutionError
    sql = ("SELECT n_name, (SELECT r_name FROM region WHERE "
           "r_regionkey < 2) FROM nation")
    for runner, error in zip(runners, (Exception, ExecutionError)):
        with pytest.raises(error,
                           match="Scalar sub-query has returned multiple"):
            runner.execute(sql)


def test_q3_takes_the_reference_routes(runners):
    """q3 at tiny: both builds are unique and both key spans are small;
    the customer join's span fits mxu_join_max_slots densely enough, so
    it takes the matrix-unit route as the reference does, and the orders
    join takes the dense route."""
    ref, port = runners
    port.execute(QUERIES["q3"][0])
    ref.execute(QUERIES["q3"][0])
    assert [j["route"] for j in port.last_joins] == ["mxu", "dense"]
    assert port.last_query_stats["mxu_joins"] == \
        ref.last_query_stats["mxu_joins"] == 1
    assert all(0 < j["matched"] <= j["probe_rows"]
               for j in port.last_joins)


def test_unported_node_names_its_roadmap_item(runners):
    _, port = runners
    from trino_tpu_torch.exec.local_planner import ExecutionError
    # UNNEST is still to be ported (with the list layouts)
    with pytest.raises(ExecutionError, match="UnnestNode.*ROADMAP A8/B13"):
        port.execute("SELECT x FROM UNNEST(ARRAY[1,2]) t(x)")
    # and so are the collecting aggregates, whose output is a list
    with pytest.raises(NotImplementedError, match="ROADMAP B13"):
        port.execute("SELECT array_agg(n_name) FROM nation")


def test_repeat_query_reuses_built_pipelines(runners):
    """A second run of a query shape builds nothing new; new literal
    values reuse the same entries (hoisted into runtime parameters)."""
    from trino_tpu_torch.exec import jit_cache
    _, port = runners
    sql = ("SELECT count(*), sum(l_quantity) FROM lineitem "
           "WHERE l_discount < {}")
    port.execute(sql.format("0.05"))
    before = jit_cache.stats()
    port.execute(sql.format("0.05"))
    port.execute(sql.format("0.07"))
    after = jit_cache.stats()
    assert after["misses"] == before["misses"]
    assert after["param_hits"] > before["param_hits"]
