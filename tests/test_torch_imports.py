"""The port stands alone: trino_tpu_torch (and chip_smoke.py) import
neither jax nor trino_tpu, run q6, q3, q13 and the later slices' paths
with both made unimportable, and refuse to start on a missing CUDA
device unless the caller asks for the CPU."""

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

import trino_tpu_torch

torch.set_num_threads(1)

_PKG = pathlib.Path(trino_tpu_torch.__file__).parent
_REPO = _PKG.parent
FORBIDDEN = ("jax", "jaxlib", "trino_tpu")


def _sources():
    # _build/ holds what the package builds at run time, not its sources
    files = sorted(p for p in _PKG.rglob("*.py")
                   if "_build" not in p.relative_to(_PKG).parts) + \
        [_REPO / "chip_smoke.py"]
    return [str(p.relative_to(_REPO)) for p in files]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0]


def test_inventory_covers_the_slice():
    files = set(_sources())
    for rel in ("trino_tpu_torch/page.py", "trino_tpu_torch/ops/aggregate.py",
                "trino_tpu_torch/ops/join.py",
                "trino_tpu_torch/exec/local_planner.py",
                "trino_tpu_torch/exec/runner.py",
                "trino_tpu_torch/connector/tpch_gen.py",
                "trino_tpu_torch/ops/join_mxu.py",
                "trino_tpu_torch/connector/tpch_dev.py",
                "trino_tpu_torch/exec/spill.py",
                "trino_tpu_torch/exec/memory.py",
                "trino_tpu_torch/exec/adaptive.py",
                "trino_tpu_torch/ops/window.py",
                "trino_tpu_torch/connector/tpcds.py", "chip_smoke.py"):
        assert rel in files
    # every CUDA source native.py builds is in the package, and no source
    # of csrc/ is left out of the build
    from trino_tpu_torch import native
    cu = {p.stem for p in (_PKG / "csrc").glob("*.cu")}
    assert cu == set(native.SOURCES)
    assert {"gather", "join_build", "join_probe", "join_expand",
            "join_mxu", "group_agg", "tpch_gen", "join_spill",
            "spill_part", "window", "special_agg", "list"} <= cu


@pytest.mark.parametrize("rel", _sources())
def test_no_jax_or_reference_import(rel):
    roots = set(_imported_roots(_REPO / rel))
    assert not roots & set(FORBIDDEN), f"{rel} imports {roots & set(FORBIDDEN)}"


_BLOCKED_RUN = textwrap.dedent("""
    import importlib.abc, sys

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "trino_tpu"):
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, Block())
    import torch
    torch.set_num_threads(1)
    import json
    from trino_tpu_torch.exec import LocalQueryRunner
    runner = LocalQueryRunner.tpch("tiny", device="cpu")
    for k, v in json.loads(sys.argv[2] if len(sys.argv) > 2 else "{}").items():
        runner.session.set(k, v)
    rows = runner.execute(sys.argv[1]).rows
    print([j["route"] for j in runner.last_joins])
    assert not any(m.split(".")[0] in ("jax", "trino_tpu")
                   for m in sys.modules), "reference module loaded"
    print(sorted(rows, key=repr) if sys.argv[3] == "sorted" else rows)
""")


def _run_blocked(name: str, session=None, ordered: bool = True) -> list:
    """Run one TPC-H query (or SQL) through the port in a process where jax
    and trino_tpu cannot be imported, under `session` properties; its rows
    must be the reference's (as sorted lists unless `ordered`). Returns
    the port's join routes."""
    import json
    from tpch_sql import QUERIES
    sql = QUERIES[name][0] if name in QUERIES else name
    session = session or {}
    env = dict(os.environ)
    env["PYTHONPATH"] = str(_REPO)
    out = subprocess.run([sys.executable, "-c", _BLOCKED_RUN, sql,
                          json.dumps(session),
                          "ordered" if ordered else "sorted"],
                         cwd=str(_REPO), env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    from trino_tpu.exec import LocalQueryRunner as RefRunner
    ref = RefRunner.tpch("tiny")
    for k, v in session.items():
        ref.session.set(k, v)
    want = ref.execute(sql).rows
    *_, routes, rows = out.stdout.strip().splitlines()
    assert rows == str(want if ordered else sorted(want, key=repr))
    return routes


def test_q6_runs_with_jax_and_reference_unimportable():
    _run_blocked("q6")


def test_q3_runs_with_jax_and_reference_unimportable():
    """The join path (the K5-K8 twins) imports nothing of JAX either."""
    _run_blocked("q3")


def test_q13_runs_with_jax_and_reference_unimportable():
    """The expanding probe (K5 runs mode and K9's twins, a LEFT join)
    imports nothing of JAX either."""
    _run_blocked("q13")


def test_default_device_is_cuda():
    from trino_tpu_torch.exec import LocalQueryRunner
    if torch.cuda.is_available():
        assert LocalQueryRunner.tpch("tiny").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            LocalQueryRunner.tpch("tiny")
    assert LocalQueryRunner.tpch("tiny", device="cpu").device.type == "cpu"


def test_spilled_join_runs_with_jax_and_reference_unimportable():
    """The spilled join (K16, K17 and the host attach through their twins)
    imports nothing of JAX either."""
    routes = _run_blocked(
        "SELECT o_orderkey, c_name FROM orders, customer WHERE "
        "o_custkey = c_custkey AND o_orderkey <= 100",
        {"join_spill_threshold_bytes": 1024})
    assert "spill-dense" in routes


def test_partitioned_join_runs_with_jax_and_reference_unimportable():
    """The partitioned join (K18's twin, the host stores, the recursion)
    and the aggregation spill import nothing of JAX either."""
    routes = _run_blocked(
        "SELECT count(*), sum(l2.l_extendedprice) FROM lineitem l1 JOIN "
        "lineitem l2 ON l1.l_orderkey = l2.l_orderkey",
        {"page_capacity": 2048, "scan_page_capacity": 2048,
         "spill_partition_count": 4, "join_spill_threshold_bytes": 16384,
         "spill_max_recursion": 2})
    assert "partitioned" in routes


def test_window_rollup_union_run_with_jax_and_reference_unimportable():
    """The window operator (K20-K23's twins behind K10's), the GroupId
    lowering of a ROLLUP and the UNION lowering with its dictionary
    remap import nothing of JAX either."""
    _run_blocked(
        "SELECT name, g, s, rank() OVER (PARTITION BY g ORDER BY s DESC), "
        "sum(s) OVER (PARTITION BY g ORDER BY name ROWS BETWEEN 1 "
        "PRECEDING AND 1 FOLLOWING) FROM (SELECT name, grouping(name) AS g, "
        "count(*) AS s FROM (SELECT n_name AS name FROM nation UNION ALL "
        "SELECT r_name FROM region) u GROUP BY ROLLUP (name)) t")


def test_tpcds_and_fused_join_run_with_jax_and_reference_unimportable():
    """The TPC-DS connector (q42 over tpcds.tiny) and the fused
    aggregating join (G1: K24-K27's twins) import nothing of JAX
    either."""
    _run_blocked(
        "SELECT d_year, i_category_id, i_category, sum(ss_ext_sales_price) "
        "FROM tpcds.tiny.date_dim, tpcds.tiny.store_sales, tpcds.tiny.item "
        "WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk "
        "AND i_manufact_id > 500 AND d_year = 2000 AND d_moy = 11 "
        "GROUP BY d_year, i_category_id, i_category "
        "ORDER BY 4 DESC, d_year, i_category_id, i_category LIMIT 100")
    routes = _run_blocked(
        "SELECT ss_sold_date_sk, count(*), sum(ss_quantity), "
        "sum(s_number_employees), count(s_store_name) "
        "FROM tpcds.tiny.store_sales, tpcds.tiny.store "
        "WHERE ss_store_sk = s_store_sk GROUP BY ss_sold_date_sk",
        ordered=False)
    assert "mxu-agg" in routes


def test_special_aggregates_run_with_jax_and_reference_unimportable():
    """The special aggregates (S4's grouped form: K28's group ids, K30's
    positional mode) and checksum (K29) import nothing of JAX either."""
    _run_blocked(
        "SELECT o_custkey, min_by(o_orderkey, o_totalprice), "
        "max_by(o_orderdate, o_totalprice), arbitrary(o_orderpriority), "
        "checksum(o_comment) FROM orders GROUP BY o_custkey",
        ordered=False)


def test_list_query_runs_with_jax_and_reference_unimportable():
    """The list layouts (K33's size pre-pass and array mode, K34's count
    and expansion, the K32 moves through their twins) import nothing of
    JAX either: L2 at tiny, array_agg's round trip through UNNEST."""
    _run_blocked(
        "SELECT count(*), sum(e), sum(o) FROM (SELECT l_orderkey, "
        "array_agg(l_partkey) ks FROM lineitem GROUP BY l_orderkey) "
        "CROSS JOIN UNNEST(ks) WITH ORDINALITY AS u(e, o)")
