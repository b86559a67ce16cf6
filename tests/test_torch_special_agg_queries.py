"""The special aggregates end to end: trino_tpu_torch's LocalQueryRunner
(device="cpu": K28's twin for the group ids, the twins of K29-K31)
against trino_tpu's on TPC-H `tiny`.

The cases are every query of tests/test_aggregates.py that runs on the
TPC-H catalog; its memory-table cases (min_by over a NULL y, the NaN
fixture, variance over DISTINCT) rewritten over inline UNION ALL
subqueries, which both engines run (the port has no memory connector
yet; the NULL string there is NULLIF('d', 'd'): both engines refuse to
concatenate a CAST(NULL AS varchar) branch, which carries no dictionary,
with a string branch's dictionary); and S1-S7, the queries chip_smoke.py
runs on the card (read from chip_smoke.py itself, so the two cannot
drift). Rows compare through tests/oracle.assert_same (integers,
decimals, the positional picks, approx_distinct, approx_percentile and
checksum exactly; doubles to 1e-9
relative), and the EXPLAIN text must be the reference's.
"""

import importlib.util
import pathlib

import pytest
import torch

from oracle import assert_same
from trino_tpu.exec import LocalQueryRunner as RefRunner
from trino_tpu_torch.exec import LocalQueryRunner as PortRunner

torch.set_num_threads(1)
_REPO = pathlib.Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_special", _REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)    # defines, runs nothing: main() guarded
    return module


SPECIAL_QUERIES = _chip_smoke().SPECIAL_QUERIES

NAN_TABLE = ("(SELECT 1 AS g, sqrt(-1e0) AS x UNION ALL SELECT 1, "
             "sqrt(-1e0) UNION ALL SELECT 1, sqrt(-1e0) UNION ALL SELECT 1, "
             "1.0e0 UNION ALL SELECT 1, 1.0e0 UNION ALL SELECT 2, 2.0e0) t")

# tests/test_aggregates.py's TPC-H queries, then its memory-table cases
# over inline tables: name -> SQL
CASES = {
    "stddev_variance_global":
        "SELECT stddev(c_acctbal), stddev_pop(c_acctbal), "
        "variance(c_acctbal), var_pop(c_acctbal), var_samp(c_acctbal) "
        "FROM customer",
    "stddev_grouped":
        "SELECT c_nationkey, stddev(c_acctbal) FROM customer "
        "GROUP BY c_nationkey",
    "var_samp_single_row_null":
        "SELECT var_samp(n_nationkey), var_pop(n_nationkey) "
        "FROM nation WHERE n_nationkey = 7",
    "corr_covar":
        "SELECT corr(c_acctbal, c_custkey), covar_samp(c_acctbal, "
        "c_custkey), covar_pop(c_acctbal, c_custkey) FROM customer",
    "regr_slope_intercept":
        "SELECT regr_slope(c_acctbal, c_custkey), "
        "regr_intercept(c_acctbal, c_custkey) FROM customer",
    "min_by_max_by":
        "SELECT c_nationkey, min_by(c_name, c_acctbal), "
        "max_by(c_name, c_acctbal) FROM customer GROUP BY c_nationkey",
    "bool_and_or_count_if":
        "SELECT c_nationkey, bool_and(c_acctbal > 0), "
        "bool_or(c_acctbal > 9000), count_if(c_acctbal > 0), "
        "every(c_acctbal > -1000) FROM customer GROUP BY c_nationkey",
    "approx_distinct_exact":
        "SELECT approx_distinct(o_orderstatus), "
        "count(DISTINCT o_orderstatus) FROM orders",
    "arbitrary_any_value":
        "SELECT arbitrary(n_name), any_value(n_name) "
        "FROM nation WHERE n_nationkey = 3",
    "geometric_mean": "SELECT geometric_mean(c_custkey) FROM customer",
    "distinct_agg_with_filter":
        "SELECT count(DISTINCT o_orderstatus) "
        "FILTER (WHERE o_totalprice > 100000), count(DISTINCT o_orderstatus)"
        " FROM orders",
    "variance_large_mean_stable":
        "SELECT stddev(c_custkey + 1000000000), stddev(c_custkey) "
        "FROM customer WHERE c_custkey <= 100",
    "covar_corr_large_mean_stable":
        "SELECT covar_samp(c_acctbal + 1000000000, c_custkey + 1000000000), "
        "covar_samp(c_acctbal, c_custkey), "
        "corr(c_acctbal + 1000000000, c_custkey + 1000000000), "
        "corr(c_acctbal, c_custkey) "
        "FROM customer WHERE c_custkey <= 100",
    "approx_distinct_in_correlated_subquery":
        "SELECT r_name, (SELECT approx_distinct(n_name) FROM nation "
        "WHERE n_regionkey = r_regionkey) FROM region",
    "approx_distinct_accuracy_exact":
        "SELECT count(DISTINCT o_custkey) FROM orders",
    "approx_distinct_accuracy":
        "SELECT approx_distinct(o_custkey) FROM orders",
    "approx_distinct_grouped":
        "SELECT o_orderpriority, approx_distinct(o_custkey), "
        "count(DISTINCT o_custkey) FROM orders GROUP BY o_orderpriority",
    "approx_distinct_small_exact_region":
        "SELECT approx_distinct(n_regionkey) FROM nation",
    "approx_distinct_small_exact_nation":
        "SELECT approx_distinct(n_nationkey) FROM nation",
    "approx_distinct_empty_and_null":
        "SELECT approx_distinct(n_nationkey) FROM nation "
        "WHERE n_nationkey < 0",
    "approx_percentile":
        "SELECT approx_percentile(o_totalprice, 0.5e0), "
        "approx_percentile(o_totalprice, 0.9e0) FROM orders",
    "approx_percentile_grouped":
        "SELECT o_orderpriority, approx_percentile(o_totalprice, 0.5e0) "
        "FROM orders GROUP BY o_orderpriority ORDER BY 1",
    "checksum": "SELECT checksum(n_nationkey) FROM nation",
    "checksum_reordered":
        "SELECT checksum(k) FROM (SELECT n_nationkey AS k "
        "FROM nation ORDER BY n_name)",
    "checksum_empty":
        "SELECT checksum(n_nationkey) FROM nation WHERE n_nationkey < 0",
    # the memory-table cases over inline tables
    "min_by_null_y_skipped":
        "SELECT min_by(x, y), max_by(x, y) FROM (SELECT 'a' AS x, "
        "CAST(NULL AS bigint) AS y UNION ALL SELECT 'b', 5 UNION ALL "
        "SELECT 'c', 2 UNION ALL SELECT NULLIF('d', 'd'), 1) t",
    "count_distinct_nan_single_value":
        f"SELECT count(DISTINCT x) FROM {NAN_TABLE}",
    "group_by_nan_single_group":
        f"SELECT count(*) FROM (SELECT x, count(*) AS c FROM {NAN_TABLE} "
        "GROUP BY x) u",
    "min_max_by_nan_largest":
        f"SELECT min_by(g, x), max_by(g, x) FROM {NAN_TABLE} WHERE g = 1",
    "min_by_nan_all_groups": f"SELECT min_by(g, x) FROM {NAN_TABLE}",
    "variance_distinct":
        "SELECT var_pop(DISTINCT x), var_pop(x) FROM (SELECT 1 AS x "
        "UNION ALL SELECT 1 UNION ALL SELECT 1 UNION ALL SELECT 2) t",
    # beyond test_aggregates.py: every centered kind grouped with a
    # FILTER, positional ties and NULL x, percentile over a varchar
    "centered_filtered_grouped":
        "SELECT o_orderstatus, var_samp(o_totalprice) FILTER (WHERE "
        "o_orderpriority < '3'), regr_intercept(o_totalprice, o_custkey), "
        "covar_pop(o_custkey, o_shippriority), stddev_pop(DISTINCT "
        "o_shippriority) FROM orders GROUP BY o_orderstatus",
    "positional_ties":
        "SELECT n_regionkey, min_by(n_name, n_regionkey), "
        "max_by(n_nationkey, n_regionkey), arbitrary(n_comment) "
        "FROM nation GROUP BY n_regionkey",
    "percentile_varchar_and_date":
        "SELECT approx_percentile(o_orderdate, 0.3e0), "
        "approx_percentile(o_clerk, 0.7e0), approx_distinct(o_orderdate) "
        "FROM orders",
    "checksum_keys":
        "SELECT o_orderstatus, checksum(o_comment), checksum(o_totalprice), "
        "checksum(DISTINCT o_orderpriority) FROM orders "
        "GROUP BY o_orderstatus",
}


@pytest.fixture(scope="module")
def runners():
    return RefRunner.tpch("tiny"), PortRunner.tpch("tiny", device="cpu")


def _check(runners, sql, ordered=False):
    ref, port = runners
    assert port.execute(f"EXPLAIN {sql}").rows == \
        ref.execute(f"EXPLAIN {sql}").rows
    got = port.execute(sql)
    want = ref.execute(sql)
    assert got.column_names == want.column_names
    assert [t.display() for t in got.column_types] == \
        [t.display() for t in want.column_types]
    assert_same(got.rows, want.rows, ordered)
    return got


@pytest.mark.parametrize("name", sorted(CASES))
def test_query_matches_reference(runners, name):
    _check(runners, CASES[name], ordered="ORDER BY 1" in CASES[name])


@pytest.mark.parametrize("name", sorted(SPECIAL_QUERIES))
def test_chip_smoke_special_query_matches_reference(runners, name):
    _, sql = SPECIAL_QUERIES[name]
    assert _check(runners, sql).rows


def test_min_by_distinct_rejected(runners):
    """Both engines refuse min_by(DISTINCT ...) (tests/test_aggregates.py
    test_min_by_distinct_rejected)."""
    for runner in runners:
        with pytest.raises(Exception, match=r"min_by\(DISTINCT"):
            runner.execute("SELECT min_by(DISTINCT n_name, n_nationkey) "
                           "FROM nation")


def test_collecting_aggregate_names_b13(runners):
    _, port = runners
    with pytest.raises(NotImplementedError, match="ROADMAP B13"):
        port.execute("SELECT array_agg(n_name) FROM nation")
