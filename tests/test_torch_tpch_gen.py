"""TPC-H generator parity: trino_tpu_torch.connector.tpch_gen (NumPy only)
against trino_tpu.connector.tpch_gen at `tiny`: every column of lineitem
and orders array-equal, dictionaries included, and the port connector's
scan pages carry the same bytes."""

import numpy as np
import pytest
import torch

from trino_tpu.connector import tpch as RC
from trino_tpu.connector import tpch_gen as RG
from trino_tpu_torch.connector import tpch as PC
from trino_tpu_torch.connector import tpch_gen as PG

torch.set_num_threads(1)

SF = 0.01
COLUMNS = [(t, c) for t in ("lineitem", "orders")
           for c, _ in RC.TABLES[t][0]]


@pytest.mark.parametrize("table,column", COLUMNS)
def test_column_matches_reference(table, column):
    n = RG.row_count(table, SF)
    assert PG.row_count(table, SF) == n
    kind = RG.string_kind(table, column)
    assert PG.string_kind(table, column) == kind
    if kind == "pooled":
        np.testing.assert_array_equal(PG.pool_values(table, column, SF),
                                      RG.pool_values(table, column, SF))
        np.testing.assert_array_equal(PG.codes_chunk(table, SF, column, 0, n),
                                      RG.codes_chunk(table, SF, column, 0, n))
    elif kind is not None:
        np.testing.assert_array_equal(
            PG.object_chunk(table, SF, column, 0, n),
            RG.object_chunk(table, SF, column, 0, n))
    else:
        want = RG.numeric_chunk(table, SF, column, 0, n)
        got = PG.numeric_chunk(table, SF, column, 0, n)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    # a chunk from the middle of the table (seekable streams)
    lo, hi = n // 3, n // 3 + 101
    if kind is None:
        np.testing.assert_array_equal(
            PG.numeric_chunk(table, SF, column, lo, hi),
            RG.numeric_chunk(table, SF, column, lo, hi))
    rd = RC.table_dictionary(table, SF, column) if kind else None
    pd = PC.table_dictionary(table, SF, column) if kind else None
    if kind:
        np.testing.assert_array_equal(pd.values, rd.values)
        assert pd.fingerprint == rd.fingerprint


def test_days_from_civil_copy():
    from trino_tpu.expr.functions import days_from_civil
    for y, m, d in [(1970, 1, 1), (1992, 2, 29), (1998, 12, 31),
                    (1900, 3, 1), (2100, 1, 1)]:
        assert PG.days_from_civil(y, m, d) == days_from_civil(y, m, d)


def test_scan_pages_carry_the_generated_bytes():
    from trino_tpu_torch.connector.spi import ColumnHandle, Split
    conn = PC.create_connector("cpu")
    meta = conn.metadata
    handle = meta.get_table_handle(
        PC.SchemaTableName("tiny", "lineitem"))
    cols = [ColumnHandle(c, t, i) for i, (c, t)
            in enumerate(PC.TABLES["lineitem"][0])
            if c in ("l_quantity", "l_returnflag", "l_shipdate")]
    n = RG.row_count("lineitem", SF)
    pages = list(conn.page_source.pages(Split(handle, 0, 1), cols, 1 << 15))
    assert sum(int(p.num_rows) for p in pages) == n
    first = pages[0]
    k = int(first.num_rows)
    np.testing.assert_array_equal(
        first.columns[0].values[:k].numpy(),
        RG.numeric_chunk("lineitem", SF, "l_quantity", 0, k))
    np.testing.assert_array_equal(
        first.columns[1].values[:k].numpy(),
        RG.codes_chunk("lineitem", SF, "l_returnflag", 0, k))
