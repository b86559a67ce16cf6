"""Device-side TPC-H generation of trino_tpu_torch (connector/tpch_dev.py,
the twins of K14/K15 on the CPU) against trino_tpu.connector.tpch_dev
(JAX on the CPU) and against the port's own NumPy path, bit for bit.

Every supported column of every table at `tiny`, over the row ranges of
tests/test_connector.py::test_device_gen_matches_host and whole pages;
sf1 windows of lineitem (one starting in the middle of an order) and of
orders; the unsigned-modulo helper on edge words; lineitem's order index
(K15's twin); and the connector's staged columns, device path against the
NumPy path over the whole capacity (dtype, values and the zero padding).
"""

import numpy as np
import pytest
import torch

from trino_tpu.connector import tpch_dev as RD
from trino_tpu_torch import types as PT
from trino_tpu_torch.connector import tpch as PC
from trino_tpu_torch.connector import tpch_dev as PD
from trino_tpu_torch.connector import tpch_gen as PG

torch.set_num_threads(1)
TINY = 0.01

COLUMNS = [(t, n) for t, (cols, _) in PC.TABLES.items() for n, _ in cols
           if PD.supported(t, n)]
TYPES = {(t, n): typ for t, (cols, _) in PC.TABLES.items()
         for n, typ in cols}


def dtype_of(table, column):
    typ = TYPES[(table, column)]
    return torch.int32 if PT.is_string(typ) else typ.dtype


def host_chunk(table, sf, column, start, end):
    """The port's NumPy chunk in the staged dtype."""
    if PG.string_kind(table, column) == "pooled":
        return PG.codes_chunk(table, sf, column, start, end)
    return np.asarray(PG.numeric_chunk(table, sf, column, start, end),
                      PT.to_numpy_dtype(TYPES[(table, column)]))


def check(table, sf, column, start, end, cap, reference=True):
    got = PD.generate(table, sf, column, start, end, cap,
                      dtype_of(table, column), "cpu").numpy()
    n = end - start
    host = host_chunk(table, sf, column, start, end)
    assert got.dtype == host.dtype
    np.testing.assert_array_equal(got[:n], host)
    assert not got[n:].any(), "rows past the slice must hold 0"
    if reference:
        ref = np.asarray(RD.generate(table, sf, column, start, end, cap))
        np.testing.assert_array_equal(got[:n].astype(np.int64),
                                      ref[:n].astype(np.int64))


def test_every_big_table_column_is_covered():
    assert {t for t, _ in COLUMNS} == {"supplier", "customer", "part",
                                       "partsupp", "orders", "lineitem"}
    for table, column in COLUMNS:
        assert PD.supported(table, column) == RD.supported(table, column)
    for table, column in [("lineitem", "l_linenumber"),
                          ("supplier", "s_name"), ("customer", "c_phone"),
                          ("nation", "n_nationkey"), ("region", "r_name")]:
        assert not PD.supported(table, column)


@pytest.mark.parametrize("table,column", COLUMNS)
def test_matches_reference_and_numpy_at_tiny(table, column):
    n = PC.table_row_count(table, TINY)
    for start, end in ((0, min(n, 257)), (max(0, n - 100), n)):
        check(table, TINY, column, start, end, 512)
    cap = 1 << (n - 1).bit_length()
    check(table, TINY, column, 0, n, cap)


@pytest.mark.parametrize("column", [n for t, n in COLUMNS
                                    if t == "lineitem"])
def test_lineitem_sf1_windows(column):
    _, starts = PG._line_index(1.0)
    mid = int(starts[700_000]) + 1          # inside an order
    assert mid not in set(starts[699_990:700_010].tolist())
    for start in (0, mid, 5_999_956 - 4096):
        check("lineitem", 1.0, column, start, start + 4096, 4096,
              reference=column in ("l_receiptdate", "l_returnflag"))


@pytest.mark.parametrize("column", [n for t, n in COLUMNS
                                    if t == "orders"])
def test_orders_sf1_window(column):
    check("orders", 1.0, column, 1_000_003, 1_004_099, 4096,
          reference=column == "o_orderstatus")


def test_unsigned_modulo_matches_numpy():
    edge = [0, 1, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**64 - 1]
    rng = np.random.default_rng(7)
    words = np.concatenate([np.array(edge, dtype=np.uint64),
                            rng.integers(0, 2**64 - 1, 2000,
                                         dtype=np.uint64)])
    x = torch.from_numpy(words.view(np.int64))
    for s in (1, 2, 3, 4, 7, 25, 92, 2048, 55_473_642, 2**31 - 1):
        np.testing.assert_array_equal(
            PD.umod(x, s).numpy(), (words % np.uint64(s)).astype(np.int64))
    with pytest.raises(ValueError):
        PD.umod(x, 2**31)


@pytest.mark.parametrize("sf,start,n", [(TINY, 0, 60_175),
                                        (TINY, 1_001, 3_000),
                                        (1.0, 2_500_003, 4_096)])
def test_order_index_twin_matches_the_rowmap(sf, start, n):
    seed, o_first, s0, norders = PG.order_index_params(sf, start)
    n = min(n, PG.row_count("lineitem", sf) - start)
    got = PD.order_index_plain(seed, o_first, s0, start, n,
                               min(n, norders - o_first), n + 5, "cpu")
    oidx, _ = PG._lineitem_rowmap(sf, start, start + n)
    np.testing.assert_array_equal(got[:n].numpy(), oidx)
    assert not got[n:].any()


@pytest.mark.parametrize("table", ["supplier", "customer", "part",
                                   "partsupp", "orders", "lineitem"])
def test_staged_columns_equal_the_numpy_path(table):
    """The connector's two paths stage the same bits over the whole
    capacity, in the same dtype, cached once per slice and capacity."""
    n = PC.table_row_count(table, TINY)
    cap = 1 << n.bit_length()
    for name, typ in PC.TABLES[table][0]:
        PC.drop_cached_columns("cpu")
        dev = PC._staged_column(table, TINY, name, typ, 0, n, cap, "cpu",
                                True)
        PC.drop_cached_columns("cpu")
        host = PC._staged_column(table, TINY, name, typ, 0, n, cap, "cpu",
                                 False)
        assert dev.values.dtype == host.values.dtype, name
        assert torch.equal(dev.values, host.values), name
        assert dev.dictionary == host.dictionary
        again = PC._staged_column(table, TINY, name, typ, 0, n, cap, "cpu",
                                  True)
        assert again is host      # the LRU keeps one entry per slice
    PC.drop_cached_columns("cpu")


def test_device_gen_switch(monkeypatch):
    """TRINO_TPU_DEVICE_GEN=0 (read at import, as the reference's) or
    device_gen=False stages from NumPy: tpch_dev generates nothing."""
    calls = []
    monkeypatch.setattr(PD, "generate",
                        lambda *a, **k: calls.append(a) or None)
    PC.drop_cached_columns("cpu")
    monkeypatch.setattr(PC, "_DEVICE_GEN", False)
    source = PC.TpchPageSource("cpu")
    assert source.device_gen is False
    assert PC.TpchPageSource("cpu", device_gen=True).device_gen is True
    typ = TYPES[("orders", "o_totalprice")]
    PC._staged_column("orders", TINY, "o_totalprice", typ, 0, 100, 128,
                      "cpu", source.device_gen)
    assert not calls
    PC.drop_cached_columns("cpu")
