"""Window functions, grouping sets and UNION end to end: trino_tpu_torch's
LocalQueryRunner (device="cpu", the plain twins of K20-K23 behind K10's
sort) against trino_tpu's on TPC-H `tiny`.

The cases are the window, union and rollup queries of tests/test_queries.py
and W1-W8, the queries chip_smoke.py runs on the card at sf1 and sf10
(read from chip_smoke.py itself, so the two cannot drift). Rows compare
through tests/oracle.assert_same (decimals and integers exact, doubles to
1e-9 relative), and the EXPLAIN text must be the reference's, so that a
row mismatch is an execution fault and not a planning one.
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
        "chip_smoke_window", _REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)    # defines, runs nothing: main() guarded
    return module


WINDOW_QUERIES = _chip_smoke().WINDOW_QUERIES

# tests/test_queries.py's window, union and rollup cases: name -> SQL
CASES = {
    "union": "SELECT n_regionkey FROM nation UNION SELECT r_regionkey + 3 "
             "FROM region",
    "union_all": "SELECT n_regionkey FROM nation UNION ALL SELECT "
                 "r_regionkey FROM region",
    "rollup": "SELECT n_regionkey, count(*) FROM nation GROUP BY ROLLUP "
              "(n_regionkey)",
    "union_mixed_dictionaries_sorted":
        "SELECT name FROM (SELECT n_name AS name FROM nation UNION ALL "
        "SELECT r_name AS name FROM region) t ORDER BY name",
    "union_mixed_dictionaries_groupby":
        "SELECT name, count(*) FROM (SELECT n_name AS name FROM nation "
        "UNION ALL SELECT r_name AS name FROM region) t GROUP BY name",
    "window_ranking":
        "SELECT n_name, row_number() OVER (PARTITION BY n_regionkey "
        "ORDER BY n_name), rank() OVER (PARTITION BY n_regionkey ORDER BY "
        "n_name), dense_rank() OVER (PARTITION BY n_regionkey ORDER BY "
        "n_name) FROM nation",
    "window_rank_with_ties":
        "SELECT s_suppkey, rank() OVER (ORDER BY s_nationkey), "
        "dense_rank() OVER (ORDER BY s_nationkey) FROM supplier",
    "window_running_agg":
        "SELECT n_name, sum(n_nationkey) OVER (PARTITION BY n_regionkey "
        "ORDER BY n_name), count(*) OVER (PARTITION BY n_regionkey "
        "ORDER BY n_name), min(n_name) OVER (PARTITION BY n_regionkey "
        "ORDER BY n_name), max(n_nationkey) OVER (PARTITION BY "
        "n_regionkey ORDER BY n_name) FROM nation",
    "window_whole_partition":
        "SELECT n_name, sum(n_nationkey) OVER (PARTITION BY n_regionkey), "
        "count(*) OVER () FROM nation",
    "window_lead_lag":
        "SELECT n_name, lead(n_name) OVER (ORDER BY n_name), "
        "lag(n_name) OVER (ORDER BY n_name), "
        "lag(n_nationkey, 2) OVER (ORDER BY n_name) FROM nation",
    "window_first_last_value":
        "SELECT n_name, first_value(n_name) OVER (PARTITION BY "
        "n_regionkey ORDER BY n_name), last_value(n_name) OVER "
        "(PARTITION BY n_regionkey ORDER BY n_name) FROM nation",
    "window_pct_cume_ntile":
        "SELECT s_suppkey, percent_rank() OVER (ORDER BY s_nationkey), "
        "cume_dist() OVER (ORDER BY s_nationkey), "
        "ntile(3) OVER (ORDER BY s_suppkey) FROM supplier",
    "window_rows_frame":
        "SELECT n_name, sum(n_nationkey) OVER (ORDER BY n_name "
        "ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) FROM nation",
    "window_bounded_rows_frame":
        "SELECT n_nationkey, sum(n_nationkey) OVER (ORDER BY n_nationkey "
        "ROWS BETWEEN 2 PRECEDING AND CURRENT ROW), "
        "min(n_nationkey) OVER (ORDER BY n_nationkey "
        "ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) FROM nation",
    "window_bounded_frame_partitioned":
        "SELECT s_suppkey, avg(s_suppkey) OVER (PARTITION BY s_nationkey "
        "ORDER BY s_suppkey ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING), "
        "sum(s_acctbal) OVER (PARTITION BY s_nationkey ORDER BY s_suppkey "
        "ROWS BETWEEN CURRENT ROW AND 2 FOLLOWING) FROM supplier",
    "window_frame_unbounded_following":
        "SELECT n_nationkey, max(n_nationkey) OVER (ORDER BY n_nationkey "
        "ROWS BETWEEN 1 FOLLOWING AND UNBOUNDED FOLLOWING), "
        "first_value(n_name) OVER (ORDER BY n_nationkey "
        "ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) FROM nation",
    # a grouping set over a dictionary key, a lead/lag default from
    # another dictionary, a wide frame (K23's doubling table)
    "grouping_sets_dictionary_key":
        "SELECT n_name, n_regionkey, count(*), grouping(n_name) FROM "
        "nation GROUP BY GROUPING SETS ((n_name), (n_regionkey), ())",
    "lead_default_other_dictionary":
        "SELECT n_name, lead(n_name, 1, 'NONE') OVER (ORDER BY "
        "n_nationkey) FROM nation",
    "wide_bounded_minmax":
        "SELECT o_orderkey, max(o_totalprice) OVER (PARTITION BY "
        "o_orderpriority ORDER BY o_orderkey ROWS BETWEEN 100 PRECEDING "
        "AND 150 FOLLOWING) FROM orders",
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
    _check(runners, CASES[name], ordered="ORDER BY name" in CASES[name])


@pytest.mark.parametrize("name", sorted(WINDOW_QUERIES))
def test_chip_smoke_window_query_matches_reference(runners, name):
    _, _, sql = WINDOW_QUERIES[name]
    got = _check(runners, sql)
    assert got.rows
    port = runners[1]
    for w in port.last_windows:
        assert 0 < w["partitions"] <= w["peer_groups"] <= w["rows"]


def test_window_entries_describe_each_node(runners):
    _, port = runners
    port.execute("SELECT n_name, rank() OVER (PARTITION BY n_regionkey "
                 "ORDER BY n_name), sum(n_nationkey) OVER (PARTITION BY "
                 "n_regionkey ORDER BY n_name ROWS BETWEEN 1 PRECEDING AND "
                 "1 FOLLOWING) FROM nation")
    assert port.last_windows == [
        {"rows": 25, "partitions": 5, "peer_groups": 25,
         "functions": {"ranking": 1}, "frames": {"range": 1}},
        {"rows": 25, "partitions": 5, "peer_groups": 25,
         "functions": {"aggregate": 1}, "frames": {"bounded": 1}}]


def test_nth_value_nonpositive_rejected(runners):
    """window/NthValueFunction: a literal n <= 0 fails at planning with
    the reference's message (over nation: the port has no memory
    connector)."""
    sql = "SELECT nth_value(n_name, 0) OVER (ORDER BY n_nationkey) " \
        "FROM nation"
    for runner in runners:
        with pytest.raises(Exception, match="NTH_VALUE must be greater"):
            runner.execute(sql)


@pytest.mark.parametrize("frame,message", [
    ("RANGE BETWEEN 1 PRECEDING AND CURRENT ROW",
     "RANGE frames with value offsets not supported"),
    ("GROUPS BETWEEN 1 PRECEDING AND CURRENT ROW",
     "GROUPS window frames not supported")])
def test_refused_frames_raise_the_reference_error(runners, frame, message):
    from trino_tpu.exec.local_planner import ExecutionError as RefError
    from trino_tpu_torch.exec.local_planner import ExecutionError
    sql = f"SELECT sum(n_nationkey) OVER (ORDER BY n_nationkey {frame}) " \
        "FROM nation"
    for runner, error in zip(runners, (RefError, ExecutionError)):
        with pytest.raises(error, match=message):
            runner.execute(sql)


def test_group_id_pages_follow_the_grouping_sets(runners):
    """GroupId emits, per source page, one page per grouping set in set
    order; keys outside the set are NULL, the group id is BIGINT."""
    from trino_tpu_torch.planner.nodes import GroupIdNode
    from trino_tpu_torch.sql import parse_statement
    _, port = runners
    plan = port._plan(parse_statement(
        "SELECT n_regionkey, n_name, count(*) FROM nation GROUP BY "
        "GROUPING SETS ((n_regionkey), (n_name, n_regionkey))"))

    def find(node):
        if isinstance(node, GroupIdNode):
            return node
        return next(filter(None, (find(s) for s in node.sources)), None)
    node = find(plan)
    from trino_tpu_torch.exec.local_planner import LocalExecutionPlanner
    ex = LocalExecutionPlanner(port.metadata, port.session, "cpu")
    stream = ex.execute(node)
    pages = list(stream.iter_pages())
    assert len(pages) == len(node.grouping_sets)
    names = [s.name for s in stream.symbols]
    gid = pages[0].columns[-1]
    assert gid.values.dtype == torch.int64 and gid.valid is None
    for set_idx, (page, gset) in enumerate(zip(pages, node.grouping_sets)):
        assert page.columns[-1].values[:25].tolist() == [set_idx] * 25
        in_set = {s.name for s in gset}
        for sym in node.grouping_sets[0] + node.grouping_sets[1]:
            col = page.columns[names.index(sym.name)]
            if sym.name in in_set:
                assert col.valid is None or bool(col.valid[:25].all())
            else:
                assert not bool(col.valid.any())
