"""Device-side TPC-H column generation.

Port of `trino_tpu/connector/tpch_dev.py`. Every numeric and pooled column
of supplier, customer, part, partsupp, orders and lineitem is a stateless
hash stream of its row index (connector/tpch_gen.py), so the device can
generate any row range of it from a few host scalars: the host computes no
hash and moves no column, and lineitem's order index needs two scalars of
the cached line index. Formatted (per-row unique) strings, `l_linenumber`
and the tiny fixed tables stay on the host path, as in the reference.

Device kernels, each beside its plain PyTorch twin (`csrc/tpch_gen.cu`):

* K14 `gen_column` (the reference's `_chunk_fn` over `column_stream` /
  `code_stream`): one column slice from its recipe
  (`tpch_gen.device_recipe`), pooled columns mapped through the pool LUT.
* K15 `order_index` (the reference's `_oidx_fn`): lineitem's order index
  per row of a chunk, rebuilt from (o_first, s0, start) with a scan of the
  per-order line counts.

The twins run only for CPU tensors. torch has no uint64 arithmetic: they
hold the words in int64 tensors, multiply with wraparound, shift with a
masked logical right shift (ops/join.py `_srl`, `_mix64`) and take the
unsigned modulo over the two 32-bit halves (`umod`). A generated slice is
bit-identical to the host path's padded chunk: rows past the slice hold 0.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from trino_tpu_torch import native
from trino_tpu_torch.connector import tpch_gen as G
from trino_tpu_torch.ops.join import _mix64, _signed, _srl
from trino_tpu_torch.page import _to_device, host_table

_DEV_TABLES = {"supplier", "customer", "part", "partsupp", "orders",
               "lineitem"}
# rowmap-derived: generated host-side (cheap repeat, no hashing)
_HOST_ONLY = {("lineitem", "l_linenumber")}


def supported(table: str, column: str) -> bool:
    """Device generation covers every numeric and pooled column of the big
    tables; formatted (per-row unique) strings and the tiny fixed tables
    stay on the host path."""
    if table not in _DEV_TABLES or (table, column) in _HOST_ONLY:
        return False
    return G.string_kind(table, column) != "formatted"


# ------------------------------------------------------------- the twins

_GOLD = _signed(0x9E3779B97F4A7C15)
_LO32 = (1 << 32) - 1


def umod(x: torch.Tensor, s: int) -> torch.Tensor:
    """x mod s for int64 words holding uint64 values, 0 < s < 2**31:
    ((hi mod s) * (2**32 mod s) + lo) mod s over the 32-bit halves (every
    term stays below 2**63)."""
    if not 0 < s < 1 << 31:
        raise ValueError(f"modulus {s} outside (0, 2**31)")
    return ((_srl(x, 32) % s) * ((1 << 32) % s) + (x & _LO32)) % s


def _u64(seed: int, idx: torch.Tensor) -> torch.Tensor:
    """tpch_gen._u64 on int64 words (wrapping arithmetic)."""
    return _mix64((idx + 1) * _GOLD + seed)


def _draw(seed: int, lo: int, span: int, idx: torch.Tensor) -> torch.Tensor:
    """tpch_gen._ui: lo + (u64 % span)."""
    return lo + umod(_u64(seed, idx), span)


def _retail(pk):
    return 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)


def _ps_supp(pk, i, nsupp: int):
    return (pk + i * (nsupp // 4 + (pk - 1) // nsupp)) % nsupp + 1


def _coin(seed: int, idx: torch.Tensor) -> torch.Tensor:
    return (_u64(seed, idx) & 1) == 0


def _values(recipe: G.Recipe, idx: torch.Tensor,
            oidx: Optional[torch.Tensor]) -> torch.Tensor:
    """The recipe's int64 value per row index (csrc/tpch_gen.cu value)."""
    p = recipe.params
    kind = recipe.kind

    def d(k):
        if k == 0:
            return _draw(p[G.P_S0], p[G.P_LO0], p[G.P_SPAN0], idx)
        return _draw(p[G.P_S1], p[G.P_LO1], p[G.P_SPAN1], idx)

    if kind == G.R_ROWKEY:
        return idx // p[G.P_ARG] + 1
    if kind == G.R_UI:
        v = d(0) * p[G.P_MUL]
        return v + d(1) if p[G.P_SPAN1] else v
    if kind == G.R_RETAIL:
        return _retail(idx + 1)
    if kind == G.R_PS_SUPPKEY:
        return _ps_supp(idx // 4 + 1, idx % 4, p[G.P_ARG])
    if kind == G.R_CONST:
        return torch.full_like(idx, p[G.P_ARG])
    if kind == G.R_O_CUSTKEY:
        ck = d(0)
        return torch.where(ck % 3 == 0,
                           ((ck + 1) % (p[G.P_ARG] + 1)).clamp(min=1), ck)
    if kind == G.R_O_ORDERSTATUS:
        od = _draw(p[G.P_OD_S], p[G.P_OD_LO], p[G.P_OD_SPAN], idx)
        half = torch.where(_coin(p[G.P_COIN], idx), 1, 2)
        return torch.where(od + 151 < p[G.P_CURRENT], 0, half)
    if kind == G.R_L_ORDERKEY:
        return oidx + 1
    if kind == G.R_L_SUPPKEY:
        return _ps_supp(d(0), d(1), p[G.P_ARG])
    if kind == G.R_L_EXTENDEDPRICE:
        return d(0) * _retail(d(1))
    # L_DATE, L_RETURNFLAG, L_LINESTATUS: order date, ship, receipt
    date = _draw(p[G.P_OD_S], p[G.P_OD_LO], p[G.P_OD_SPAN], oidx) + d(0)
    if p[G.P_SPAN1]:
        date = date + d(1)
    if kind == G.R_L_DATE:
        return date
    if kind == G.R_L_LINESTATUS:
        return (date > p[G.P_CURRENT]).to(torch.int64)
    flag = torch.where(_coin(p[G.P_COIN], idx), 2, 0)
    return torch.where(date <= p[G.P_CURRENT], flag, 1)


def gen_column_plain(recipe: G.Recipe, start: int, n: int, cap: int,
                     oidx: Optional[torch.Tensor],
                     lut: Optional[torch.Tensor], dtype: torch.dtype,
                     device) -> torch.Tensor:
    """Plain twin of K14: rows [start, start + n) of the column in
    `dtype`[cap], rows n..cap 0."""
    idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
    v = _values(recipe, idx, None if oidx is None else oidx[:n])
    if lut is not None:
        v = lut[v.clamp(0, lut.numel() - 1)].to(torch.int64)
    out = torch.zeros(cap, dtype=dtype, device=device)
    out[:n] = v.to(dtype)
    return out


def gen_column_cuda(recipe: G.Recipe, start: int, n: int, cap: int,
                    oidx: Optional[torch.Tensor],
                    lut: Optional[torch.Tensor], dtype: torch.dtype,
                    device) -> torch.Tensor:
    """K14 launch: see csrc/tpch_gen.cu tpch_column."""
    dev = torch.device(device)
    if dtype not in (torch.int32, torch.int64):
        raise ValueError(f"K14 writes int32 or int64, not {dtype}")
    if recipe.needs_oidx and (oidx is None or oidx.dtype != torch.int64
                              or not oidx.is_cuda or oidx.shape[0] < cap):
        raise ValueError("K14 needs lineitem's int64 order index per row "
                         "on the card")
    if lut is not None and (lut.dtype != torch.int32 or not lut.is_cuda):
        raise ValueError("the pool LUT must be int32 on the card")
    out = torch.empty(cap, dtype=dtype, device=dev)
    lib = native.library("tpch_gen")
    rc = lib.tpch_column(
        ctypes.c_int64(recipe.kind), host_table(recipe.params),
        ctypes.c_int64(start), ctypes.c_int64(n), ctypes.c_int64(cap),
        ctypes.c_void_p(0 if oidx is None or not recipe.needs_oidx
                        else oidx.data_ptr()),
        ctypes.c_void_p(0 if lut is None else lut.data_ptr()),
        ctypes.c_int64(0 if lut is None else lut.numel()),
        ctypes.c_void_p(out.data_ptr()),
        ctypes.c_int64(out.element_size()),
        ctypes.c_void_p(native.stream_ptr(dev)))
    native.check(rc, "tpch_column")
    gen_column_cuda.launches += 1
    return out


gen_column_cuda.launches = 0


def gen_column(recipe, start, n, cap, oidx, lut, dtype, device):
    """K14 wrapper: plain twin on the CPU, kernel on CUDA."""
    run = gen_column_cuda if torch.device(device).type == "cuda" \
        else gen_column_plain
    return run(recipe, start, n, cap, oidx, lut, dtype, device)


def order_index_plain(seed: int, o_first: int, s0: int, start: int, n: int,
                      norders: int, cap: int, device) -> torch.Tensor:
    """Plain twin of K15: int64[cap], the order of each row of [start,
    start + n) (rows n..cap 0)."""
    orders = o_first + torch.arange(norders, dtype=torch.int64,
                                    device=device)
    lines = 1 + umod(_u64(seed, orders), 7)
    rows = torch.repeat_interleave(orders, lines)[start - s0:start - s0 + n]
    out = torch.zeros(cap, dtype=torch.int64, device=device)
    out[:rows.numel()] = rows
    return out


def order_index_cuda(seed: int, o_first: int, s0: int, start: int, n: int,
                     norders: int, cap: int, device) -> torch.Tensor:
    """K15 launch: see csrc/tpch_gen.cu tpch_order_index."""
    dev = torch.device(device)
    oidx = torch.empty(max(cap, 1), dtype=torch.int64, device=dev)
    scratch = torch.empty(max(-(-norders // 4096), 1), dtype=torch.int64,
                          device=dev)
    total = torch.empty((), dtype=torch.int32, device=dev)
    lib = native.library("tpch_gen")
    rc = lib.tpch_order_index(
        ctypes.c_int64(seed), ctypes.c_int64(o_first), ctypes.c_int64(s0),
        ctypes.c_int64(start), ctypes.c_int64(n), ctypes.c_int64(norders),
        ctypes.c_void_p(scratch.data_ptr()), ctypes.c_void_p(total.data_ptr()),
        ctypes.c_int64(cap), ctypes.c_void_p(oidx.data_ptr()),
        ctypes.c_void_p(native.stream_ptr(dev)))
    native.check(rc, "tpch_order_index")
    order_index_cuda.launches += 1
    return oidx[:cap]


order_index_cuda.launches = 0


def order_index(seed, o_first, s0, start, n, norders, cap, device):
    """K15 wrapper: plain twin on the CPU, kernel on CUDA."""
    run = order_index_cuda if torch.device(device).type == "cuda" \
        else order_index_plain
    return run(seed, o_first, s0, start, n, norders, cap, device)


# ------------------------------------------------------------ generation

# small LRU of per-chunk order-index arrays: the columns of one scan chunk
# are staged one after another, so a few entries give full reuse of one
# reconstruction
_OIDX_CACHE: "collections.OrderedDict[tuple, torch.Tensor]" = \
    collections.OrderedDict()
_OIDX_CACHE_MAX = 4
_LUT_CACHE: Dict[tuple, torch.Tensor] = {}
_RECIPES: Dict[tuple, G.Recipe] = {}


def _recipe(table: str, column: str, sf: float) -> G.Recipe:
    key = (table, column, round(sf * 1000))
    got = _RECIPES.get(key)
    if got is None:
        got = _RECIPES[key] = G.device_recipe(table, column, sf)
    return got


def drop_order_index() -> None:
    """Empty the order-index LRU (a cold generation rebuilds it)."""
    _OIDX_CACHE.clear()


def _device_oidx(sf: float, start: int, end: int, cap: int,
                 device) -> torch.Tensor:
    key = (round(sf * 1000), start, end, cap, str(device))
    got = _OIDX_CACHE.get(key)
    if got is not None:
        _OIDX_CACHE.move_to_end(key)
        return got
    # host side: two scalars from the cached line index (a bisect)
    seed, o_first, s0, total_orders = G.order_index_params(sf, start)
    n = end - start
    dev = order_index(seed, o_first, s0, start, n,
                      min(n, total_orders - o_first), cap, device)
    while len(_OIDX_CACHE) >= _OIDX_CACHE_MAX:
        _OIDX_CACHE.popitem(last=False)
    _OIDX_CACHE[key] = dev
    return dev


def _lut(table: str, column: str, sf: float, recipe: G.Recipe,
         device) -> Optional[torch.Tensor]:
    if recipe.lut is None:
        return None
    key = (table, column, round(sf * 1000), str(device))
    got = _LUT_CACHE.get(key)
    if got is None:
        got = _LUT_CACHE[key] = _to_device(
            np.asarray(recipe.lut, np.int32), device)
    return got


def generate(table: str, sf: float, column: str, start: int, end: int,
             cap: int, dtype: torch.dtype, device) -> torch.Tensor:
    """`dtype`[cap] on `device` for rows [start, end) of a supported
    column; rows past end - start hold 0."""
    recipe = _recipe(table, column, sf)
    oidx = _device_oidx(sf, start, end, cap, device) \
        if recipe.needs_oidx else None
    return gen_column(recipe, start, end - start, cap, oidx,
                  _lut(table, column, sf, recipe, device), dtype, device)
