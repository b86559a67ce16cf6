"""ARRAY and MAP end to end: trino_tpu_torch's LocalQueryRunner
(device="cpu": the twins of K32-K34 and the plain compiler) against
trino_tpu's on TPC-H `tiny`.

The cases are every query of tests/test_arrays.py (constructors,
lookups, UNNEST alone, with ORDINALITY and in a CROSS JOIN, array_agg's
round trip, histogram, map_agg and a map lookup, decimal elements), the
reference's quirks (NULL inputs skipped, DISTINCT not narrowing a
collecting aggregate, a NaN map key as +inf, +-0.0 keys merged under the
first row's sign, element_at(..., 0) NULL, membership across distinct
dictionaries refused), a MAP through UNNEST, list columns through a
join, a sort and a window, and L1-L6, the queries chip_smoke.py runs on
the card (read from chip_smoke.py itself). The EXPLAIN text and the
column types must be the reference's; rows compare through
tests/oracle.assert_same, lists exactly and in order (the cases with NaN
or a signed zero inside a list by each float's repr).
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
        "chip_smoke_list", _REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)    # defines, runs nothing: main() guarded
    return module


LIST_QUERIES = {name: sql for name, (schema, sql)
                in _chip_smoke().LIST_QUERIES.items() if schema == "sf1"}

# tests/test_arrays.py's queries: name -> (SQL, ordered)
CASES = {
    "array_literal": ("SELECT ARRAY[1, 2, 3]", True),
    "cardinality": ("SELECT cardinality(ARRAY[1, 2, 3])", True),
    "subscript": ("SELECT ARRAY[1, 2, 3][2]", True),
    "element_at": ("SELECT element_at(ARRAY[10, 20], 2), "
                   "element_at(ARRAY[10, 20], -1), "
                   "element_at(ARRAY[10, 20], 5)", True),
    "contains": ("SELECT contains(ARRAY[1, 2, 3], 2), "
                 "contains(ARRAY[1, 2, 3], 9)", True),
    "string_array": ("SELECT ARRAY['a', 'b'], contains(ARRAY['x', 'y'], "
                     "'y')", True),
    "array_over_rows": ("SELECT n_nationkey, ARRAY[n_nationkey, "
                        "n_regionkey] FROM nation ORDER BY n_nationkey "
                        "LIMIT 3", True),
    "unnest_standalone": ("SELECT * FROM UNNEST(ARRAY[7, 8, 9])", True),
    "unnest_ordinality": ("SELECT x, o FROM UNNEST(ARRAY[5, 6]) WITH "
                          "ORDINALITY AS t(x, o)", True),
    "unnest_cross_join": ("SELECT n_name, e FROM nation CROSS JOIN "
                          "UNNEST(ARRAY[n_nationkey, n_regionkey]) AS u(e) "
                          "WHERE n_nationkey < 2 ORDER BY n_name, e", True),
    "array_agg": ("SELECT n_regionkey, array_agg(n_nationkey) AS ks "
                  "FROM nation GROUP BY n_regionkey ORDER BY n_regionkey",
                  True),
    "array_agg_roundtrip": ("SELECT rk, e FROM (SELECT n_regionkey rk, "
                            "array_agg(n_nationkey) ks FROM nation GROUP BY "
                            "n_regionkey) CROSS JOIN UNNEST(ks) AS u(e) "
                            "ORDER BY rk, e", True),
    "histogram": ("SELECT n_regionkey, histogram(n_name) FROM nation "
                  "WHERE n_regionkey = 0 GROUP BY n_regionkey", False),
    "map_agg": ("SELECT n_regionkey, map_agg(n_nationkey, n_name) FROM "
                "nation GROUP BY n_regionkey ORDER BY n_regionkey", True),
    "map_element_at": ("SELECT element_at(map_agg(n_nationkey, n_name), 3) "
                       "FROM nation GROUP BY n_regionkey % 1", False),
    "decimal_elements": ("SELECT ARRAY[o_totalprice] FROM orders WHERE "
                         "o_orderkey = 1", False),
    # beyond test_arrays.py
    "quirk_distinct_not_applied": (
        "SELECT n_regionkey, array_agg(DISTINCT n_regionkey) FROM nation "
        "GROUP BY n_regionkey ORDER BY 1", True),
    "quirk_element_at_zero": ("SELECT element_at(ARRAY[1, 2], 0)", True),
    "quirk_null_skipped": (
        "SELECT g, array_agg(x), histogram(x), map_agg(x, g) FROM (SELECT "
        "1 AS g, 5 AS x UNION ALL SELECT 1, NULLIF(3, 3) UNION ALL SELECT "
        "1, 7 UNION ALL SELECT 2, NULLIF(4, 4)) t GROUP BY g", False),
    "map_unnest": ("SELECT k, v FROM (SELECT map_agg(n_nationkey, n_name) m "
                   "FROM nation GROUP BY n_regionkey) CROSS JOIN UNNEST(m) "
                   "AS u(k, v) ORDER BY k", True),
    "histogram_unnest_ordinality": (
        "SELECT rk, k, v, o FROM (SELECT n_regionkey rk, histogram(n_name) "
        "h FROM nation GROUP BY n_regionkey) CROSS JOIN UNNEST(h) WITH "
        "ORDINALITY AS u(k, v, o) ORDER BY rk, o", True),
    "list_through_join_and_sort": (
        "SELECT n_name, ks, cardinality(ks) FROM nation JOIN (SELECT "
        "n_regionkey rk, array_agg(n_nationkey) ks FROM nation GROUP BY "
        "n_regionkey) ON n_regionkey = rk ORDER BY n_name", True),
    "list_through_window": (
        "SELECT rk, ks, rank() OVER (ORDER BY rk DESC) FROM (SELECT "
        "n_regionkey rk, array_agg(n_name) ks FROM nation GROUP BY "
        "n_regionkey)", False),
    "list_filter": ("SELECT n_name FROM nation JOIN (SELECT n_regionkey rk, "
                    "array_agg(n_nationkey) ks FROM nation GROUP BY "
                    "n_regionkey) ON n_regionkey = rk WHERE contains(ks, 3)",
                    False),
    "string_ctor_union": ("SELECT ARRAY[n_name, r_name], element_at(ARRAY["
                          "n_name, r_name], -1) FROM nation JOIN region ON "
                          "n_regionkey = r_regionkey", False),
}
# lists holding NaN or a signed zero: compared by each float's repr
REPR_CASES = {
    "quirk_nan_and_zero_keys":
        "SELECT g, histogram(x), map_agg(x, y), array_agg(x) FROM (SELECT "
        "1 AS g, 0.0e0 AS x, 5 AS y UNION ALL SELECT 1, -0.0e0, 6 UNION ALL "
        "SELECT 1, sqrt(-1e0), 7 UNION ALL SELECT 1, 1.0e0 / 0.0e0, 8 "
        "UNION ALL SELECT 2, -0.0e0, 9 UNION ALL SELECT 2, 0.0e0, 10) t "
        "GROUP BY g",
}


@pytest.fixture(scope="module")
def runners():
    return RefRunner.tpch("tiny"), PortRunner.tpch("tiny", device="cpu")


def _explain_and_types(runners, sql):
    ref, port = runners
    assert port.execute(f"EXPLAIN {sql}").rows == \
        ref.execute(f"EXPLAIN {sql}").rows
    got, want = port.execute(sql), ref.execute(sql)
    assert got.column_names == want.column_names
    assert [t.display() for t in got.column_types] == \
        [t.display() for t in want.column_types]
    return got, want


@pytest.mark.parametrize("name", sorted(CASES))
def test_array_case_matches_reference(runners, name):
    sql, ordered = CASES[name]
    got, want = _explain_and_types(runners, sql)
    assert_same(got.rows, want.rows, ordered)


def _canon(v):
    if isinstance(v, dict):
        return sorted((_canon(k), _canon(x)) for k, x in v.items())
    if isinstance(v, (list, tuple)):
        return [_canon(x) for x in v]
    return repr(v)


@pytest.mark.parametrize("name", sorted(REPR_CASES))
def test_float_keys_match_reference(runners, name):
    got, want = _explain_and_types(runners, REPR_CASES[name])
    assert sorted(map(_canon, got.rows)) == sorted(map(_canon, want.rows))


@pytest.mark.parametrize("name", sorted(LIST_QUERIES))
def test_chip_smoke_list_query_matches_reference(runners, name):
    sql = LIST_QUERIES[name]
    got, want = _explain_and_types(runners, sql)
    assert_same(got.rows, want.rows, "ORDER BY" in sql)


def test_refusals_carry_the_reference_text(runners):
    for runner in runners:
        with pytest.raises(NotImplementedError,
                           match=r"global array_agg/histogram/map_agg "
                                 r"\(no GROUP BY\)"):
            runner.execute("SELECT array_agg(n_name) FROM nation")
        with pytest.raises(NotImplementedError,
                           match="array membership across distinct "
                                 "dictionaries"):
            runner.execute("SELECT contains(ARRAY[n_name, r_name], n_name) "
                           "FROM nation JOIN region ON n_regionkey = "
                           "r_regionkey")


def test_list_column_refused_where_the_reference_fails():
    """A list column reaching a host spill store (the spilled join's
    payload) or a GROUP BY key raises naming its ROADMAP item, where the
    reference's spill store drops the list's lengths and its sort refuses
    a plane."""
    port = PortRunner.tpch("tiny", device="cpu")
    sub = ("(SELECT n_regionkey rk, array_agg(n_nationkey) ks FROM nation "
           "GROUP BY n_regionkey)")
    with pytest.raises(NotImplementedError, match="ROADMAP B item 6"):
        port.execute(f"SELECT ks, count(*) FROM {sub} GROUP BY ks")
    port.session.set("join_spill_threshold_bytes", 1)
    with pytest.raises(NotImplementedError, match="ROADMAP B item 6"):
        port.execute(f"SELECT n_name, ks FROM nation JOIN {sub} "
                     "ON n_regionkey = rk")
