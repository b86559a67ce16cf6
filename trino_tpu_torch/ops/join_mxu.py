"""The `mxu` join route: a per-key (count, first) table over a dense key span.

Port of the lookup half of `trino_tpu/ops/join_mxu.py`. The reference
gives every key of a dense span its own column of a 0/1 indicator matrix
and probes with blocked one-hot matmuls on the TPU's matrix unit: per probe
row, (match count, first sorted build position) from the build's per-key
table. Exactness there rests on float32 accumulation with operands under
2^24 (MAX_EXACT_ROWS). The function is a table lookup, and on the H100 an
int32 table computes it exactly with one read per probe row, so:

* K12 `mxu_table` (build_count_pos_table; csrc/join_mxu.cu): the int32
  (size, 2) table — per slot of [kmin, kmin + size) the live match count
  and the first position in the port's order: the build row for a unique
  build (K6 attaches it), the start of the key's run for a build with K5's
  runs (K9 walks it), so rows and their order stay the reference's. The
  distinct live-key count the router reads (distinct_live_keys) is K5's
  NDISTINCT statistic, counted as the build inserts each key first and
  read with the build's other statistics in one host read.
* K13 (matmul_lookup, blocked_lookup): the `mxu` mode of K6
  (csrc/join_probe.cu) and of K9's count and verdict launches
  (csrc/join_expand.cu) — the table staged in shared memory, one lookup
  per probe row, no extra pass over the probe. `matmul_lookup` below is its
  plain twin, which the twins of K6 and K9 call.

Not ported here (ROADMAP B11b): the aggregating join's
`scatter_agg_table`, `key_bounds`, `agg_join_lookup` and `agg_join_post`.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Optional, Tuple

import torch

from trino_tpu_torch import native
from trino_tpu_torch.ops.join import (KMIN, NDISTINCT, Prepared, _key_cols,
                                      _check_key_cols, _key_table,
                                      _page_key_cols)
from trino_tpu_torch.page import host_table

# the reference's key-range block width of its one-hot matmuls; the port
# reads the table directly and needs no blocking
BLOCK = 512

# the reference's float32 exactness bound: the router refuses builds whose
# capacity reaches it, so both packages route the same joins
MAX_EXACT_ROWS = 1 << 24

_I32_MAX = (1 << 31) - 1


def distinct_live_keys(prepared: Prepared) -> torch.Tensor:
    """Distinct live, non-NULL build keys: the numerator of the router's
    observed density (distinct keys / key span), K5's NDISTINCT slot."""
    return prepared.stats[NDISTINCT]


def mxu_table_plain(cols, num_rows: torch.Tensor, stats: torch.Tensor,
                    lookup: tuple, runs: Optional[tuple],
                    size: int) -> torch.Tensor:
    """Plain twin of K12: int32 (size, 2), slot key - kmin -> (live match
    count, first position: the smallest build row, or with `runs` the start
    of the key's run); (0, INT32_MAX) where no live key falls."""
    cap = cols[0][0].shape[0]
    dev = num_rows.device
    live = torch.arange(cap, device=dev, dtype=torch.int32) < num_rows
    key, null = _key_cols(cols)
    raw = key - stats[KMIN]
    inb = live & ~null & (raw >= 0) & (raw < size)
    slot = torch.where(inb, raw, torch.full_like(raw, size))
    pos = torch.arange(cap, dtype=torch.int64, device=dev)
    if runs is not None and cap:
        # the twin's runs: slot u is the u-th distinct key of lookup[1]
        skeys = lookup[1]
        u = torch.searchsorted(skeys ^ (-(1 << 63)), key ^ (-(1 << 63)))
        pos = runs[1].to(torch.int64)[u.clamp(max=max(skeys.numel() - 1,
                                                      0))] \
            if skeys.numel() else pos
    count = torch.zeros(size + 1, dtype=torch.int64, device=dev)
    count.scatter_add_(0, slot, inb.to(torch.int64))
    first = torch.full((size + 1,), _I32_MAX, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, slot, pos, "amin")
    return torch.stack([count[:size], first[:size]], 1).to(torch.int32)


def mxu_table_cuda(cols, num_rows: torch.Tensor, stats: torch.Tensor,
                   lookup: tuple, runs: Optional[tuple],
                   size: int) -> torch.Tensor:
    """K12 launch: see csrc/join_mxu.cu mxu_table."""
    cap = cols[0][0].shape[0]
    dev = num_rows.device
    _check_key_cols(cols, cap, dev)
    if num_rows.dtype != torch.int32 or num_rows.dim() != 0:
        raise ValueError("num_rows must be a 0-d int32 tensor")
    if lookup[0] != "hash" or stats.device != dev:
        raise ValueError("K12 needs the hash table K5 built on the card")
    _, slot_keys, slot_rows, _ = lookup
    table = torch.empty((size, 2), dtype=torch.int32, device=dev)
    lib = native.library("join_mxu")
    rc = lib.mxu_table(
        host_table(_key_table(cols)), ctypes.c_int64(len(cols)),
        ctypes.c_int64(cap), ctypes.c_void_p(num_rows.data_ptr()),
        ctypes.c_void_p(stats.data_ptr()),
        ctypes.c_void_p(slot_keys.data_ptr()),
        ctypes.c_void_p(slot_rows.data_ptr()),
        ctypes.c_int64(slot_rows.shape[0]),
        ctypes.c_void_p(0 if runs is None else runs[1].data_ptr()),
        ctypes.c_void_p(table.data_ptr()), ctypes.c_int64(size),
        ctypes.c_void_p(native.stream_ptr(dev)))
    native.check(rc, "mxu_table")
    mxu_table_cuda.launches += 1
    return table


mxu_table_cuda.launches = 0


def mxu_table(cols, num_rows, stats, lookup, runs, size):
    """K12 wrapper: plain twin on the CPU, kernel on CUDA."""
    run = mxu_table_cuda if num_rows.is_cuda else mxu_table_plain
    return run(cols, num_rows, stats, lookup, runs, size)


def build_count_pos_table(size: int) -> Callable[[Prepared], Prepared]:
    """The `mxu` route's table of `size` slots from the build's kmin over a
    Prepared (after prepare_runs when the join expands), K12."""

    def op(prepared: Prepared) -> Prepared:
        table = mxu_table(_page_key_cols(prepared.build, prepared.keys),
                          prepared.build.num_rows, prepared.stats,
                          prepared.lookup, prepared.runs, size)
        return dataclasses.replace(prepared, mxu=table)
    return op


def blocked_lookup(table: torch.Tensor, kmin: torch.Tensor,
                   pkey: torch.Tensor) -> torch.Tensor:
    """Plain twin of K13's read: `table[key - kmin]` per probe key (int64
    words), all-zero rows for a key outside the span (a key below kmin
    wraps to a negative difference)."""
    slots = table.shape[0]
    raw = pkey - kmin
    inb = (raw >= 0) & (raw < slots)
    got = table[raw.clamp(0, max(slots - 1, 0))] if slots else \
        torch.zeros((pkey.shape[0],) + table.shape[1:], dtype=table.dtype,
                    device=table.device)
    return torch.where(inb.reshape(-1, *([1] * (table.dim() - 1))), got,
                       torch.zeros_like(got))


def matmul_lookup(table: torch.Tensor, kmin: torch.Tensor,
                  pkey: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(count, first) per probe key, the plain twin of K13 (first is 0
    where count is 0; callers mask on count)."""
    looked = blocked_lookup(table, kmin, pkey)
    cnt = looked[:, 0]
    return cnt, torch.where(cnt > 0, looked[:, 1], torch.zeros_like(cnt))


def lookup_flops(rows: int, slots: int, ncols: int) -> int:
    """The reference's cost-model count of one lookup dispatch (2 flops a
    multiply-add of its (rows x slots) @ (slots x ncols) product), which
    the query's mxu_flops counter sums per probe page."""
    return 2 * int(rows) * int(slots) * int(ncols)
