"""chip_smoke.py runs on the card the TPC-H queries that the CPU parity
tests check: its own copy of the 22 SQL texts (it may not import
tests/tpch_sql.py, which imports the JAX package) must equal
tests/tpch_sql.py's QUERIES, text and row-order flag alike."""

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
