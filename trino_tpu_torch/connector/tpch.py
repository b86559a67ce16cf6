"""TPC-H generator connector: deterministic in-memory data, no files.

Reference parity: plugin/trino-tpch (TpchMetadata.java, TpchRecordSetProvider
.java, TpchSplitManager.java) — schemas tiny/sf1/sf10/... expose the 8 TPC-H
tables, rows generated on demand. The reference delegates to io.airlift.tpch
(a dbgen port); data here comes from `tpch_gen` — stateless counter-hash
column streams reproducing dbgen's seekability (any column, any row range,
any process, identical bytes) so scans materialize only the columns and row
ranges they touch. That is what makes SF100 runnable on one host: a q9 scan
of 600M-row lineitem generates 7 of 16 columns, chunk by chunk, and pooled
varchar columns are emitted directly as dictionary codes (no Python string
objects on the scan path).

Correctness contract: engine and sqlite oracle read the SAME generated data
(the H2QueryRunner pattern); see tpch_gen's docstring for the documented
re-scope vs dbgen bit-identical rows.

All varchar columns come dictionary-encoded; dates are int32 days since epoch;
prices are short decimals (scaled int64).

Port of `trino_tpu/connector/tpch.py`. As in the reference, every numeric
and pooled column of the six large tables is generated on the connector's
device (`tpch_dev`: kernels K14/K15 on CUDA, their torch twins on the CPU);
formatted strings, `l_linenumber` and region/nation are generated with
NumPy (`tpch_gen`) and staged through pinned memory. The reference's
switch `TRINO_TPU_DEVICE_GEN=0` (or `create_connector(device,
device_gen=False)`) stages every column from NumPy; the staged columns are
bit-identical either way.
"""

from __future__ import annotations

import collections
import math
import os
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.connector import tpch_dev
from trino_tpu_torch.connector import tpch_gen as G
from trino_tpu_torch.connector.spi import (
    ColumnHandle, ColumnMetadata, Connector, ConnectorMetadata,
    ConnectorPageSource, ConnectorSplitManager, ConnectorTableHandle,
    ColumnStatistics, SchemaTableName, Split, TableMetadata, TableStatistics,
    pad_to_capacity, split_range)
from trino_tpu_torch.page import Column, Dictionary, Page, row_count

_D12_2 = T.DecimalType(12, 2)

SCHEMAS = {
    "tiny": 0.01, "sf1": 1.0, "sf10": 10.0, "sf100": 100.0,
    "sf300": 300.0, "sf1000": 1000.0,
}

# table -> (columns, base row count at sf1); row counts per TPC-H spec 4.2.5
TABLES: Dict[str, tuple] = {
    "region": ((("r_regionkey", T.BIGINT), ("r_name", T.VarcharType(25)),
                ("r_comment", T.VarcharType(152))), None),
    "nation": ((("n_nationkey", T.BIGINT), ("n_name", T.VarcharType(25)),
                ("n_regionkey", T.BIGINT), ("n_comment", T.VarcharType(152))),
               None),
    "supplier": ((("s_suppkey", T.BIGINT), ("s_name", T.VarcharType(25)),
                  ("s_address", T.VarcharType(40)), ("s_nationkey", T.BIGINT),
                  ("s_phone", T.VarcharType(15)), ("s_acctbal", _D12_2),
                  ("s_comment", T.VarcharType(101))), 10_000),
    "customer": ((("c_custkey", T.BIGINT), ("c_name", T.VarcharType(25)),
                  ("c_address", T.VarcharType(40)), ("c_nationkey", T.BIGINT),
                  ("c_phone", T.VarcharType(15)), ("c_acctbal", _D12_2),
                  ("c_mktsegment", T.VarcharType(10)),
                  ("c_comment", T.VarcharType(117))), 150_000),
    "part": ((("p_partkey", T.BIGINT), ("p_name", T.VarcharType(55)),
              ("p_mfgr", T.VarcharType(25)), ("p_brand", T.VarcharType(10)),
              ("p_type", T.VarcharType(25)), ("p_size", T.INTEGER),
              ("p_container", T.VarcharType(10)), ("p_retailprice", _D12_2),
              ("p_comment", T.VarcharType(23))), 200_000),
    "partsupp": ((("ps_partkey", T.BIGINT), ("ps_suppkey", T.BIGINT),
                  ("ps_availqty", T.INTEGER), ("ps_supplycost", _D12_2),
                  ("ps_comment", T.VarcharType(199))), 800_000),
    "orders": ((("o_orderkey", T.BIGINT), ("o_custkey", T.BIGINT),
                ("o_orderstatus", T.VarcharType(1)), ("o_totalprice", _D12_2),
                ("o_orderdate", T.DATE),
                ("o_orderpriority", T.VarcharType(15)),
                ("o_clerk", T.VarcharType(15)), ("o_shippriority", T.INTEGER),
                ("o_comment", T.VarcharType(79))), 1_500_000),
    "lineitem": ((("l_orderkey", T.BIGINT), ("l_partkey", T.BIGINT),
                  ("l_suppkey", T.BIGINT), ("l_linenumber", T.INTEGER),
                  ("l_quantity", _D12_2), ("l_extendedprice", _D12_2),
                  ("l_discount", _D12_2), ("l_tax", _D12_2),
                  ("l_returnflag", T.VarcharType(1)),
                  ("l_linestatus", T.VarcharType(1)), ("l_shipdate", T.DATE),
                  ("l_commitdate", T.DATE), ("l_receiptdate", T.DATE),
                  ("l_shipinstruct", T.VarcharType(25)),
                  ("l_shipmode", T.VarcharType(10)),
                  ("l_comment", T.VarcharType(44))), None),  # ~4x orders
}


def table_row_count(table: str, sf: float) -> int:
    return G.row_count(table, sf)


def _column_ndv(table: str, name: str, sf: float, rows: float) -> float:
    """Real distinct counts (cost/StatsCalculator parity): FK columns get
    their DOMAIN size, not the table's row count — the round-4 q9
    join-order regression traced to l_partkey claiming 600M NDV."""
    fk_domain = {
        "l_partkey": "part", "ps_partkey": "part",
        "l_suppkey": "supplier", "ps_suppkey": "supplier",
        "l_orderkey": "orders",
    }
    if name in fk_domain:
        return float(G.row_count(fk_domain[name], sf))
    if name == "o_custkey":
        # spec: a third of customers place no orders
        return float(G.row_count("customer", sf)) * 2 / 3
    if name in ("c_nationkey", "s_nationkey", "n_nationkey"):
        return 25.0
    if name in ("n_regionkey", "r_regionkey"):
        return 5.0
    if G.string_kind(table, name) == "pooled":
        return float(min(rows, len(G.pool_values(table, name, sf))))
    if name.endswith("date"):
        return float(min(rows, 2500.0))   # ~7 years of days
    if name.endswith("key"):
        return rows                        # primary keys
    if name in ("l_quantity", "l_linenumber", "p_size", "l_discount",
                "l_tax", "o_shippriority"):
        return float(min(rows, 50.0))
    return float(min(rows, max(rows / 4, 1000.0)))


def _host_chunk(table: str, sf: float, column: str, start: int,
                end: int) -> np.ndarray:
    """Object strings or numerics for a row range (oracle / CTAS path)."""
    if G.string_kind(table, column) is not None:
        return G.object_chunk(table, sf, column, start, end)
    return G.numeric_chunk(table, sf, column, start, end)


def get_table(table: str, sf: float) -> Dict[str, np.ndarray]:
    """Full host arrays for one table (oracle loading; small sf only —
    large-sf scans go through the chunked code path instead)."""
    n = G.row_count(table, sf)
    return {name: _host_chunk(table, sf, name, 0, n)
            for name, _ in TABLES[table][0]}


_DICT_CACHE: Dict[tuple, Dictionary] = {}


def table_dictionary(table: str, sf: float, column: str) -> Dictionary:
    """Shared per-(table, sf, column) dictionary so every page of a scan uses
    one pool (stable codes across splits; one trace per table). Pooled
    columns build from their fixed pool without materializing the column;
    formatted (per-row unique) columns materialize once on first use."""
    key = (table, round(sf * 1000), column)
    if key not in _DICT_CACHE:
        if G.string_kind(table, column) == "pooled":
            _DICT_CACHE[key] = Dictionary(
                G.pool_values(table, column, sf))
        else:
            n = G.row_count(table, sf)
            data = G.object_chunk(table, sf, column, 0, n)
            _DICT_CACHE[key] = Dictionary.build(data)[0]
    return _DICT_CACHE[key]


class TpchMetadata(ConnectorMetadata):
    """plugin/trino-tpch TpchMetadata.java analog."""

    def list_schemas(self) -> List[str]:
        return sorted(SCHEMAS)

    def list_tables(self, schema: Optional[str] = None) -> List[SchemaTableName]:
        schemas = [schema] if schema else sorted(SCHEMAS)
        return [SchemaTableName(s, t) for s in schemas for t in sorted(TABLES)]

    def get_table_handle(self, name: SchemaTableName) -> Optional[ConnectorTableHandle]:
        if name.schema in SCHEMAS and name.table in TABLES:
            return ConnectorTableHandle(name)
        return None

    def get_table_metadata(self, handle: ConnectorTableHandle) -> TableMetadata:
        cols = tuple(ColumnMetadata(n, t)
                     for n, t in TABLES[handle.name.table][0])
        return TableMetadata(handle.name, cols)

    def get_table_statistics(self, handle: ConnectorTableHandle) -> TableStatistics:
        sf = SCHEMAS[handle.name.schema]
        rows = float(table_row_count(handle.name.table, sf))
        cols: Dict[str, ColumnStatistics] = {}
        for name, typ in TABLES[handle.name.table][0]:
            cols[name] = ColumnStatistics(
                null_fraction=0.0,
                distinct_count=_column_ndv(handle.name.table, name, sf,
                                           rows))
        return TableStatistics(rows, cols)

    # date-derived status columns are heavily skewed (e.g. ~2/3 of orders
    # are fulfilled 'F'), so pool-uniform estimation would mislead
    _SKEWED_POOLED = {"o_orderstatus", "l_returnflag", "l_linestatus"}

    def estimate_like_selectivity(self, handle, column, pattern,
                                  escape=None):
        """Exact match fraction over the column's dictionary pool — valid
        because every non-skewed pooled column draws codes UNIFORMLY from
        its pool (tpch_gen `_ui` streams)."""
        table = handle.name.table
        if G.string_kind(table, column) != "pooled" \
                or column in self._SKEWED_POOLED:
            return None
        import re as _re
        from trino_tpu_torch.expr.functions import like_pattern_to_regex
        values = G.pool_values(table, column, SCHEMAS[handle.name.schema])
        if len(values) == 0:
            return None
        rx = _re.compile(like_pattern_to_regex(pattern, escape), _re.DOTALL)
        hits = sum(1 for v in values if rx.match(v))
        return hits / len(values)

    def apply_filter(self, handle, constraint):
        # accept the whole domain for split pruning; engine re-applies row-wise
        merged = handle.constraint.intersect(constraint)
        return (ConnectorTableHandle(handle.name, merged, handle.limit),
                constraint)

    def apply_limit(self, handle, limit):
        if handle.limit is not None and handle.limit <= limit:
            return None
        return ConnectorTableHandle(handle.name, handle.constraint, limit)


class TpchSplitManager(ConnectorSplitManager):
    def get_splits(self, handle: ConnectorTableHandle,
                   target_splits: int = 1) -> List[Split]:
        sf = SCHEMAS[handle.name.schema]
        rows = table_row_count(handle.name.table, sf)
        parts = max(1, min(target_splits, math.ceil(rows / 4096)))
        return [Split(handle, p, parts, host=p) for p in range(parts)]


# device-side generation (tpch_dev): on by default; =0 forces the NumPy
# path (the reference's switch, trino_tpu/connector/tpch.py)
_DEVICE_GEN = os.environ.get("TRINO_TPU_DEVICE_GEN", "1") != "0"

# one lock for both LRU caches: the byte accounting (USED counters vs
# OrderedDict) must not interleave across threads
_CACHE_LOCK = threading.RLock()

# host-side generated-chunk LRU: regenerating hash streams costs seconds
# per column at SF1, so repeated scans (and a CPU run checking a device
# run) reuse the numpy chunks
_HOST_CHUNK_CACHE: "collections.OrderedDict[tuple, np.ndarray]" = \
    collections.OrderedDict()
_HOST_CHUNK_CACHE_BYTES = 48 << 30
_HOST_CHUNK_CACHE_USED = 0


def _host_cached(key: tuple, build) -> np.ndarray:
    global _HOST_CHUNK_CACHE_USED
    with _CACHE_LOCK:
        arr = _HOST_CHUNK_CACHE.get(key)
        if arr is not None:
            _HOST_CHUNK_CACHE.move_to_end(key)
            return arr
    # build OUTSIDE the lock (two racers may both build; check-then-insert
    # keeps the accounting exact)
    arr = build()
    nbytes = arr.nbytes
    with _CACHE_LOCK:
        if nbytes <= _HOST_CHUNK_CACHE_BYTES \
                and key not in _HOST_CHUNK_CACHE:
            while (_HOST_CHUNK_CACHE_USED + nbytes > _HOST_CHUNK_CACHE_BYTES
                   and _HOST_CHUNK_CACHE):
                _, evicted = _HOST_CHUNK_CACHE.popitem(last=False)
                _HOST_CHUNK_CACHE_USED -= evicted.nbytes
            _HOST_CHUNK_CACHE[key] = arr
            _HOST_CHUNK_CACHE_USED += nbytes
    return arr


# per-device LRUs of staged table columns under one byte budget each
# (device memory is finite), so a CPU run of a table never evicts the
# card's copy
_DEVICE_COL_CACHE: "Dict[str, collections.OrderedDict]" = {}
_DEVICE_COL_CACHE_BYTES = 4 << 30
_DEVICE_COL_CACHE_USED: Dict[str, int] = {}


def _evict_to(dev: str, budget: int) -> None:
    lru = _DEVICE_COL_CACHE.get(dev)
    while lru and _DEVICE_COL_CACHE_USED[dev] > budget:
        _, evicted = lru.popitem(last=False)
        _DEVICE_COL_CACHE_USED[dev] -= evicted.nbytes


def drop_cached_columns(device=None, host_chunks: bool = False) -> None:
    """Empty the staged-column LRU of `device` (every device when None)
    and, with `host_chunks`, the host chunk LRU: the next scan generates
    and stages again, as a cold first run does."""
    global _HOST_CHUNK_CACHE_USED
    with _CACHE_LOCK:
        for dev in ([str(torch.device(device))] if device is not None
                    else list(_DEVICE_COL_CACHE)):
            _DEVICE_COL_CACHE.pop(dev, None)
            _DEVICE_COL_CACHE_USED.pop(dev, None)
        if host_chunks:
            _HOST_CHUNK_CACHE.clear()
            _HOST_CHUNK_CACHE_USED = 0


def device_cached(key: tuple, device, build) -> Column:
    """The staged column under `key` on `device`, built by `build()` on a
    miss and kept in the device's LRU under its byte budget (a column
    larger than the whole budget is never cached). Generator output is
    immutable, so re-staging identical bytes on every execution would only
    re-measure PCIe."""
    dev = str(device)
    with _CACHE_LOCK:
        lru = _DEVICE_COL_CACHE.setdefault(dev, collections.OrderedDict())
        _DEVICE_COL_CACHE_USED.setdefault(dev, 0)
        col = lru.get(key)
        if col is not None:
            lru.move_to_end(key)
            return col
    col = build()
    nbytes = col.nbytes
    with _CACHE_LOCK:
        if nbytes > _DEVICE_COL_CACHE_BYTES:
            return col   # larger than the whole budget: never cache
        if key not in lru:
            _evict_to(dev, _DEVICE_COL_CACHE_BYTES - nbytes)
            lru[key] = col
            _DEVICE_COL_CACHE_USED[dev] += nbytes
    return col


def _staged_column(table: str, sf: float, name: str, typ: T.Type,
                   off: int, hi: int, page_capacity: int,
                   device, device_gen: bool = True) -> Column:
    """Generate + pad + stage one column slice to `device`, once per
    (table, sf, column, slice, capacity) and device (device_cached): on
    the device itself when `device_gen` and tpch_dev supports the column,
    else with NumPy through pinned memory."""
    return device_cached(
        (table, round(sf * 1000), name, off, hi, page_capacity), device,
        lambda: _generate_column(table, sf, name, typ, off, hi,
                                 page_capacity, device, device_gen))


def _generate_column(table: str, sf: float, name: str, typ: T.Type,
                     off: int, hi: int, page_capacity: int, device,
                     device_gen: bool) -> Column:
    hkey = (table, round(sf * 1000), name, off, hi)
    if device_gen and tpch_dev.supported(table, name):
        # generated ON the device: no host hashing, no column transfer
        dtype = torch.int32 if T.is_string(typ) else typ.dtype
        values = tpch_dev.generate(table, sf, name, off, hi, page_capacity,
                                   dtype, device)
        return Column(values, None, typ,
                      table_dictionary(table, sf, name)
                      if T.is_string(typ) else None)
    if T.is_string(typ):
        d = table_dictionary(table, sf, name)
        if G.string_kind(table, name) == "pooled":
            codes = _host_cached(
                hkey, lambda: G.codes_chunk(table, sf, name, off, hi))
        else:
            codes = _host_cached(
                hkey, lambda: d.encode(
                    G.object_chunk(table, sf, name, off, hi)))
        return Column.from_numpy(pad_to_capacity(codes, page_capacity, 0),
                                 typ, dictionary=d, device=device)
    arr = pad_to_capacity(
        _host_cached(hkey, lambda: np.asarray(
            G.numeric_chunk(table, sf, name, off, hi),
            T.to_numpy_dtype(typ))), page_capacity, 0)
    return Column.from_numpy(arr, typ, device=device)


class TpchPageSource(ConnectorPageSource):
    def __init__(self, device, device_gen: Optional[bool] = None):
        self.device = torch.device(device)
        self.device_gen = _DEVICE_GEN if device_gen is None else device_gen

    def pages(self, split: Split, columns: Sequence[ColumnHandle],
              page_capacity: int) -> Iterator[Page]:
        handle = split.table
        table = handle.name.table
        sf = SCHEMAS[handle.name.schema]
        total = table_row_count(table, sf)
        start, end = split_range(total, split.part, split.total_parts)
        if handle.limit is not None:
            end = min(end, start + handle.limit)
        for off in range(start, end, page_capacity):
            hi = min(off + page_capacity, end)
            n = hi - off
            cols = [_staged_column(table, sf, ch.name, ch.type, off, hi,
                                   page_capacity, self.device,
                                   self.device_gen)
                    for ch in columns]
            yield Page(tuple(cols), row_count(n, self.device))


def create_connector(device, device_gen: Optional[bool] = None
                     ) -> Connector:
    """The TPC-H connector on `device`; `device_gen` False stages every
    column from NumPy (default: on unless TRINO_TPU_DEVICE_GEN=0)."""
    return Connector("tpch", TpchMetadata(), TpchSplitManager(),
                     TpchPageSource(device, device_gen))
