"""The TPC-DS catalog of trino_tpu_torch against trino_tpu's (CPU).

* Data: every table at tiny bit-equal to the reference's get_table, and
  the chunked fact streams (chunk_numeric, chunk_string) over every column;
  the row counts of every table at sf1 and sf10, and sf1 windows of
  store_sales and inventory (the first rows and a window past 2^24);
  equal statistics (row counts and every column's NDV) at tiny and sf1.
* Catalog statements: SHOW SCHEMAS FROM tpcds, SHOW TABLES, USE.
* Queries: the TPC-DS queries of tests/test_tpcds.py and the two router
  variants of tests/test_mxu_join.py (read from chip_smoke.TPCDS, whose
  texts must equal the tests'), at tiny: the reference's EXPLAIN text,
  rows (tests/oracle.assert_same), mxu_joins and mxu_flops.
"""

import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from oracle import assert_same
from trino_tpu.connector import tpcds as RD
from trino_tpu.exec import LocalQueryRunner as RefRunner
from trino_tpu_torch.connector import tpcds as PD
from trino_tpu_torch.exec import LocalQueryRunner as PortRunner

torch.set_num_threads(1)
_REPO = pathlib.Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_tpcds", _REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)    # defines, runs nothing: main() guarded
    return module


TPCDS = _chip_smoke().TPCDS
TINY = 0.01

# ---------------------------------------------------------------- data


def test_schemas_and_tables_are_the_reference_s():
    assert PD.SCHEMAS == RD.SCHEMAS
    assert list(PD.TABLES) == list(RD.TABLES)
    for name, (cols, base) in RD.TABLES.items():
        pcols, pbase = PD.TABLES[name]
        assert pbase == base
        assert [(n, t.display()) for n, t in pcols] == \
            [(n, t.display()) for n, t in cols]


@pytest.mark.parametrize("table", sorted(RD.TABLES))
def test_tiny_table_bit_equal(table):
    want = RD.get_table(table, TINY)
    got = PD.get_table(table, TINY)
    assert list(got) == list(want)
    for col, arr in want.items():
        g = got[col]
        assert g.dtype == arr.dtype, col
        np.testing.assert_array_equal(g, arr, err_msg=col)


CHUNKED = sorted(RD._CHUNKED)


def _chunk_cols(table):
    for name, typ in RD.TABLES[table][0]:
        yield name, typ


@pytest.mark.parametrize("table", CHUNKED)
def test_tiny_chunks_bit_equal(table):
    n = RD.table_row_count(table, TINY)
    for start, end in ((0, min(n, 4096)), (n // 3, n)):
        for name, typ in _chunk_cols(table):
            if typ.display().startswith("varchar"):
                codes, pool = PD.chunk_string(table, TINY, name, start, end)
                rcodes, rpool = RD.chunk_string(table, TINY, name, start, end)
                np.testing.assert_array_equal(codes, rcodes)
                np.testing.assert_array_equal(pool, rpool)
            else:
                np.testing.assert_array_equal(
                    PD.chunk_numeric(table, TINY, name, start, end),
                    RD.chunk_numeric(table, TINY, name, start, end))


@pytest.mark.parametrize("sf", [1.0, 10.0])
def test_row_counts(sf):
    for table in RD.TABLES:
        assert PD.table_row_count(table, sf) == \
            RD.table_row_count(table, sf), table
    assert PD.table_row_count("store_sales", 1.0) == 2_880_404
    assert PD.table_row_count("inventory", 1.0) == 23_490_000


@pytest.mark.parametrize("table", ["store_sales", "inventory",
                                   "customer_demographics"])
def test_sf1_chunk_windows(table):
    n = RD.table_row_count(table, 1.0)
    windows = [(0, 2048), (n - 2048, n)]
    if n > (1 << 24) + 2048:
        windows.append(((1 << 24) - 1024, (1 << 24) + 1024))
    for start, end in windows:
        for name, typ in _chunk_cols(table):
            if typ.display().startswith("varchar"):
                np.testing.assert_array_equal(
                    PD.chunk_string(table, 1.0, name, start, end)[0],
                    RD.chunk_string(table, 1.0, name, start, end)[0])
            else:
                np.testing.assert_array_equal(
                    PD.chunk_numeric(table, 1.0, name, start, end),
                    RD.chunk_numeric(table, 1.0, name, start, end))


@pytest.mark.parametrize("schema", ["tiny", "sf1"])
def test_statistics_equal(schema):
    from trino_tpu.connector.spi import ConnectorTableHandle as RH
    from trino_tpu.connector.spi import SchemaTableName as RN
    from trino_tpu_torch.connector.spi import ConnectorTableHandle as PH
    from trino_tpu_torch.connector.spi import SchemaTableName as PN
    rmeta, pmeta = RD.TpcdsMetadata(), PD.TpcdsMetadata()
    for table in RD.TABLES:
        want = rmeta.get_table_statistics(RH(RN(schema, table)))
        got = pmeta.get_table_statistics(PH(PN(schema, table)))
        assert got.row_count == want.row_count, table
        assert set(got.columns) == set(want.columns)
        for col, stats in want.columns.items():
            assert got.columns[col].distinct_count == stats.distinct_count
            assert got.columns[col].null_fraction == stats.null_fraction


def test_page_source_stages_the_reference_rows():
    """Scans of chunked tables (store_sales, customer_demographics) and of
    a materialized dimension (customer), two splits each in pages of
    4,096 rows, as the reference's page source gives them."""
    from trino_tpu.connector.spi import ColumnHandle as RC
    from trino_tpu.connector.spi import ConnectorTableHandle as RH
    from trino_tpu.connector.spi import SchemaTableName as RN
    from trino_tpu.connector.spi import Split as RS
    from trino_tpu_torch.connector.spi import ColumnHandle as PC
    from trino_tpu_torch.connector.spi import ConnectorTableHandle as PH
    from trino_tpu_torch.connector.spi import SchemaTableName as PN
    from trino_tpu_torch.connector.spi import Split as PS
    ref, port = RD.TpcdsPageSource(), PD.TpcdsPageSource("cpu")
    for table in ("store_sales", "customer", "customer_demographics"):
        cols = RD.TABLES[table][0][:6]
        pcols = PD.TABLES[table][0][:6]
        for part in range(2):
            rsplit = RS(RH(RN("tiny", table)), part, 2, host=part)
            psplit = PS(PH(PN("tiny", table)), part, 2, host=part)
            rpages = list(ref.pages(
                rsplit, [RC(n, t, i) for i, (n, t) in enumerate(cols)], 4096))
            ppages = list(port.pages(
                psplit, [PC(n, t, i) for i, (n, t) in enumerate(pcols)],
                4096))
            assert len(ppages) == len(rpages) >= 1
            for rp, pp in zip(rpages, ppages):
                n = int(rp.num_rows)
                assert int(pp.num_rows) == n
                for rv, pv in zip(rp.to_host(n), pp.to_host(n)):
                    assert list(pv) == list(rv)


# ------------------------------------------------------------ catalog


@pytest.fixture(scope="module")
def runners():
    """(reference, port) per session: default, or the forced router."""
    made = {}

    def get(session):
        if session not in made:
            ref = RefRunner.tpch("tiny")
            port = PortRunner.tpch("tiny", device="cpu")
            ref.execute("USE tpcds.tiny")
            port.execute("USE tpcds.tiny")
            for k, v in session:
                ref.session.set(k, v)
                port.session.set(k, v)
            made[session] = (ref, port)
        return made[session]
    return get


def test_catalog_statements(runners):
    ref, port = runners(())
    for sql in ("SHOW SCHEMAS FROM tpcds", "SHOW TABLES",
                "SHOW TABLES FROM tpcds.sf1", "SHOW COLUMNS FROM item"):
        assert port.execute(sql).rows == ref.execute(sql).rows, sql
    assert port.session.catalog == "tpcds"
    assert port.session.schema == "tiny"


# ------------------------------------------------------------ queries


def _test_sql(path, fn, var):
    body = (_REPO / "tests" / path).read_text()
    body = body[body.index(f"def {fn}("):]
    return re.search(var + r' = """(.*?)"""', body, re.S).group(1)


def test_chip_smoke_carries_the_tests_queries():
    """chip_smoke.TPCDS's texts are the tests' (it may not import them:
    they import the JAX package)."""
    src = {"ds_q3": ("test_tpcds.py", "test_q3_shape", "sql"),
           "ds_q42": ("test_tpcds.py", "test_q42_shape", "sql"),
           "ds_q64": ("test_tpcds.py", "test_q64_shape", "engine"),
           "ds_q72": ("test_tpcds.py", "test_q72", "engine"),
           "ds_q72_router": ("test_mxu_join.py",
                             "test_q72_with_router_enabled", "engine"),
           "ds_q64_router": ("test_mxu_join.py",
                             "test_q64_core_with_router_enabled", "engine")}
    for name, where in src.items():
        assert TPCDS[name][2] == _test_sql(*where), name
    # the two one-line texts are adjacent literals there: one constant each
    import ast
    tree = ast.parse((_REPO / "tests" / "test_tpcds.py").read_text())
    literals = {n.value for n in ast.walk(tree)
                if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    for name in ("ds_scan", "ds_inventory_week"):
        assert TPCDS[name][2] in literals, name
    assert TPCDS["G1"][1] == TPCDS["G4"][1] == ()
    assert all(TPCDS[n][1] for n in ("ds_q72_router", "ds_q64_router",
                                     "G2", "G3"))


DS = [name for name in TPCDS if TPCDS[name][0] == "tpcds"
      and not name.startswith("G")]


@pytest.mark.parametrize("name", DS)
def test_tpcds_query_like_the_reference(runners, name):
    _, session, sql, ordered = TPCDS[name]
    ref, port = runners(session)
    assert port.execute("EXPLAIN " + sql).rows == \
        ref.execute("EXPLAIN " + sql).rows
    want = ref.execute(sql).rows
    rstats = dict(ref.last_query_stats)
    got = port.execute(sql).rows
    assert_same(got, want, ordered)
    pstats = port.last_query_stats
    assert pstats["mxu_joins"] == rstats.get("mxu_joins", 0)
    assert pstats["mxu_flops"] == rstats.get("mxu_flops", 0)
    if session:
        assert pstats["mxu_joins"] > 0
