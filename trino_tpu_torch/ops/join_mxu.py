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

The aggregating join (the reference's `scatter_agg_table`, `key_bounds`,
`agg_join_lookup` and `agg_join_post`, which exec/local_planner
`_mxu_agg_join` drives): the build side scatters to per-key vectors
[pair count, sum of a build column, count of its valid values], each probe
row reads its key's vector and carries its pair multiplicity into one
SINGLE aggregation, so the cross product is never materialized.

* K24 `agg_table` (scatter_agg_table; csrc/join_mxu.cu): one thread per
  build row adds its vectors into the (slots, C) table with 64-bit
  atomics, then one block counts the distinct slots, the live rows and
  the magnitude gate.
* K25 `agg_lookup` (agg_join_lookup; csrc/join_mxu.cu): one launch whose
  threads take two live probe rows each, read their keys' table rows and
  write every derived column (the rows of one allocation) and the live
  mask below num_rows, the padding unwritten; K1 then compacts the page.
* K26 `key_bounds` (csrc/join_mxu.cu): the live key's unsigned 64-bit
  min/max and its min/max in its own type (the dynamic filter's range),
  one launch over the live rows, the key read in its own width, each
  block folding its five values into per-device words with one atomic
  each and the last block (by ticket) writing the call's words.
* K27 `agg_post` (agg_join_post; csrc/join_mxu.cu): the SQL NULL of a
  build-side SUM, `helper > 0` over the aggregated page's live rows, one
  launch for every helper.

Exactness: the reference accumulates the table in float64 on its CPU and
float32 on an accelerator (gated at 2^24). The port keeps the reference
CPU's results on both devices: counts and integer-kind sums accumulate in
int64 (exact), float sums in float64, and an integer per-key sum at or past
MAX_EXACT_INT_SUM = 2^53 clears `mag_ok`, which declines to the gather
join, as the reference's CPU does. One table holds both: an int64 (slots,
C) tensor whose float-sum columns carry float64 bits.
"""

from __future__ import annotations

import array
import ctypes
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from trino_tpu_torch import native
from trino_tpu_torch import types as T
from trino_tpu_torch.ops.aggregate import (KEY_NEG_INF, KEY_POS_INF,
                                           from_ordered_key, ordered_key)
from trino_tpu_torch.ops.join import (KMIN, NDISTINCT, Prepared, _key_cols,
                                      _check_key_cols, _key_table,
                                      _key_words, _page_key_cols, _reduce)
from trino_tpu_torch.page import Column, Page, host_table

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


# ------------------------------------------------------------------ B11b

# an integer-kind per-key sum at or past this bound declines the fused
# join (the reference's float64 bound on its CPU; the port's int64 sums
# are exact further, but the route stays the reference's)
MAX_EXACT_INT_SUM = float(1 << 53)

_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1

# a table column's vector kind (csrc/join_mxu.cu enum Vec)
VEC_CNT, VEC_SUM_I, VEC_SUM_F, VEC_VALIDCNT = range(4)

# K24's info words: distinct occupied slots, mag_ok, live build rows, the
# float64 bits of the integer values' absolute total (its order of
# additions is the device's)
INFO_DISTINCT, INFO_MAG_OK, INFO_LIVE, INFO_ABSUM = range(4)

# K24's modes: AGG_TABLE_AUTO adds into a per-block shared copy where the
# table fits AGG_SHARED_WORDS words (csrc/join_mxu.cu SUB_WORDS), else into
# the global table; AGG_TABLE_GLOBAL takes the global atomics where the
# copy would fit. The engine always runs AUTO. GLOBAL stays so that the
# card check can hold the global path against the twin at shapes where
# AUTO copies (few slots: the contention case) and time both paths at one
# call, which is what AUTO's rule rests on, as K23's `nlevels` does.
AGG_TABLE_AUTO, AGG_TABLE_GLOBAL = 0, 1
AGG_SHARED_WORDS = 6080

# K25's output column ops (csrc/join_mxu.cu enum Op)
OP_PAIRS, OP_CNTP, OP_SUMP_I, OP_SUMP_F, OP_TABLE_I, OP_TABLE_F = range(6)


def vec_kind(spec) -> int:
    """A vec_specs entry ('cnt',) | ('sum', ch, 'i'|'f') | ('validcnt', ch)
    as its vector kind."""
    if spec[0] == "cnt":
        return VEC_CNT
    if spec[0] == "validcnt":
        return VEC_VALIDCNT
    return VEC_SUM_F if spec[2] == "f" else VEC_SUM_I


def table_column(table: torch.Tensor, kind: int, i: int) -> torch.Tensor:
    """Column i of an aggregate table as its values: float64 for a float
    sum (its bits), int64 otherwise."""
    col = table[:, i].contiguous()
    return col.view(torch.float64) if kind == VEC_SUM_F else col


# ------------------------------------------------------------------ K24


def agg_table_plain(key, vecs, num_rows: torch.Tensor, kmin: torch.Tensor,
                    slots: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K24. `key` is the build key column (values, valid);
    `vecs` one (kind, values, valid) per table column, the first VEC_CNT.
    Returns (table int64 (slots, C), info int64[4]): per slot key - kmin
    of a live non-NULL build row, the row count, the sum of an integer
    column (int64, wrapping) or a float column (float64 bits) over its
    valid values, and the count of valid values; info is (distinct
    occupied slots, mag_ok, live rows, the absolute total's float64 bits),
    mag_ok false when an integer sum reaches +-MAX_EXACT_INT_SUM or the
    integer values' absolute total reaches 2^63 (where an int64 sum could
    have wrapped)."""
    cap = key[0].shape[0]
    dev = num_rows.device
    live = torch.arange(cap, device=dev, dtype=torch.int32) < num_rows
    k, null = _key_cols([key])
    raw = k - kmin
    inb = live & ~null & (raw >= 0) & (raw < slots)
    slot = torch.where(inb, raw, torch.full_like(raw, slots))
    cols = []
    mag_ok = torch.ones((), dtype=torch.bool, device=dev)
    absum = torch.zeros((), dtype=torch.float64, device=dev)
    for kind, values, valid in vecs:
        ok = inb if valid is None or kind == VEC_CNT else inb & valid
        if kind in (VEC_CNT, VEC_VALIDCNT):
            contrib = ok.to(torch.int64)
        elif kind == VEC_SUM_I:
            v = values.to(torch.int64)
            contrib = torch.where(ok, v, torch.zeros_like(v))
            absum = absum + torch.where(ok, v.to(torch.float64).abs(),
                                        torch.zeros((), dtype=torch.float64,
                                                    device=dev)).sum()
        else:
            v = values.to(torch.float64)
            contrib = torch.where(ok, v, torch.zeros_like(v))
        acc = torch.zeros(slots + 1, dtype=contrib.dtype, device=dev)
        acc.scatter_add_(0, slot, contrib)
        acc = acc[:slots]
        if kind == VEC_SUM_I:
            bound = int(MAX_EXACT_INT_SUM)
            mag_ok = mag_ok & ((acc > -bound) & (acc < bound)).all()
        cols.append(acc.view(torch.int64) if kind == VEC_SUM_F else acc)
    table = torch.stack(cols, 1)
    mag_ok = mag_ok & (absum < 2.0 ** 63)
    info = torch.stack([(table[:, 0] > 0).sum(), mag_ok.to(torch.int64),
                        table[:, 0].sum(), absum.view(torch.int64)])
    return table, info


def _vec_table(vecs) -> list:
    """K24's 5-word entries: kind, values ptr, valid ptr, element size,
    is_float."""
    out = []
    for kind, values, valid in vecs:
        out += [kind, 0 if values is None else values.data_ptr(),
                0 if valid is None else valid.data_ptr(),
                0 if values is None else values.element_size(),
                0 if values is None else int(values.is_floating_point())]
    return out


def _check_vecs(vecs, cap: int, dev) -> None:
    if not vecs or vecs[0][0] != VEC_CNT:
        raise ValueError("the first vector must be the pair count")
    for kind, values, valid in vecs:
        if kind in (VEC_SUM_I, VEC_SUM_F, VEC_VALIDCNT) and values is None:
            raise ValueError("a sum or valid count needs its column")
        if values is not None:
            _check_key_cols([(values, valid)], cap, dev)


def agg_table_cuda(key, vecs, num_rows: torch.Tensor, kmin: torch.Tensor,
                   slots: int, mode: int = AGG_TABLE_AUTO
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K24 launch: see csrc/join_mxu.cu agg_table (`mode` AGG_TABLE_GLOBAL
    keeps the global atomics where the shared copy would fit)."""
    cap = key[0].shape[0]
    dev = num_rows.device
    _check_key_cols([key], cap, dev)
    _check_vecs(vecs, cap, dev)
    if num_rows.dtype != torch.int32 or num_rows.dim() != 0:
        raise ValueError("num_rows must be a 0-d int32 tensor")
    if kmin.dtype != torch.int64 or kmin.numel() != 1 or kmin.device != dev:
        raise ValueError("kmin must be one int64 word on the card")
    table = torch.empty((slots, len(vecs)), dtype=torch.int64, device=dev)
    info = torch.empty(4, dtype=torch.int64, device=dev)
    lib = native.library("join_mxu")
    rc = lib.agg_table(
        host_table(_key_table([key]), _vec_table(vecs)),
        ctypes.c_int64(len(vecs)), ctypes.c_int64(cap),
        ctypes.c_void_p(num_rows.data_ptr()),
        ctypes.c_void_p(kmin.data_ptr()), ctypes.c_void_p(table.data_ptr()),
        ctypes.c_int64(slots), ctypes.c_void_p(info.data_ptr()),
        ctypes.c_int64(mode), ctypes.c_void_p(native.stream_ptr(dev)))
    native.check(rc, "agg_table")
    agg_table_cuda.launches += 1
    return table, info


agg_table_cuda.launches = 0


def agg_table(key, vecs, num_rows, kmin, slots):
    """K24 wrapper: plain twin on the CPU, kernel on CUDA."""
    run = agg_table_cuda if num_rows.is_cuda else agg_table_plain
    return run(key, vecs, num_rows, kmin, slots)


def scatter_agg_table(slots: int, vec_specs, key_channel: int):
    """The build side's accumulation table for the aggregating join over
    `slots` key slots from kmin, one column per `vec_specs` entry (the
    first ('cnt',)). Returns op(build_page, kmin) -> (table, info): K24's
    int64 (slots, C) table and its info words (INFO_DISTINCT feeds the
    router's density check; INFO_MAG_OK false declines to the gather
    join; INFO_LIVE is the build's live rows)."""
    vec_specs = tuple(vec_specs)

    def op(build: Page, kmin: torch.Tensor):
        key = _page_key_cols(build, (key_channel,))[0]
        vecs = []
        for spec in vec_specs:
            kind = vec_kind(spec)
            if kind == VEC_CNT:
                vecs.append((kind, None, None))
            else:
                c = build.column(spec[1])
                vecs.append((kind, _word_values(c.values), c.valid))
        return agg_table(key, vecs, build.num_rows, kmin, slots)
    return op


def _word_values(values: torch.Tensor) -> torch.Tensor:
    """A column the kernels read as 1-8 byte words (bool as uint8)."""
    values = values.contiguous()
    return values.view(torch.uint8) if values.dtype == torch.bool else values


# ------------------------------------------------------------------ K26

# words of K26's output: the same statistics as K5's KMIN..LO_NAN
B_KMIN, B_KMAX, B_LO, B_HI, B_LO_NAN = range(5)
KEY_BOUNDS_WORDS = 5
_F64_NAN_BITS = 0x7FF8000000000000
_F64_NEG_INF_BITS = -0x10000000000000          # -inf's float64 bits
KEY_BOUNDS_THREADS = 256        # csrc/join_mxu.cu KB_THREADS
KEY_BOUNDS_ROWS = 8             # KB_ROWS: rows a thread reads a round
KEY_BOUNDS_BLOCKS_PER_SM = 2    # the fastest of 1-4 at G3's build
_KEY_BOUNDS_SCRATCH: dict = {}
_KEY_BOUNDS_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                    ctypes.c_void_p)


def key_bounds_plain(values: torch.Tensor, valid, num_rows: torch.Tensor
                     ) -> torch.Tensor:
    """Plain twin of K26: int64[5] = (kmin, kmax) of the live, non-NULL
    keys in unsigned 64-bit order after the key encoding (kmin > kmax when
    there are none), and (lo, hi, lo_nan) of the same rows in the column's
    own order, as K5's LO/HI/LO_NAN statistics: the min/max of an integer
    column, the float64 bits of a float column's min/max over its non-NaN
    values (NaN bits and lo_nan 1 when it holds a NaN, +inf/-inf when
    empty)."""
    cap = values.shape[0]
    dev = num_rows.device
    live = torch.arange(cap, device=dev, dtype=torch.int32) < num_rows
    key, null = _key_cols([(values, valid)])
    ok = live & ~null
    flipped = key ^ _I64_MIN
    kmin = _reduce(flipped, ok, _I64_MAX, True) ^ _I64_MIN
    kmax = _reduce(flipped, ok, _I64_MIN, False) ^ _I64_MIN
    if values.is_floating_point():
        f = values.to(torch.float64)
        isnan = torch.isnan(f)
        nan = (ok & isnan).any()
        ordk = ordered_key(torch.where(isnan, torch.zeros_like(f), f))
        lo = from_ordered_key(_reduce(ordk, ok & ~isnan, KEY_POS_INF,
                                      True).reshape(1))
        hi = from_ordered_key(_reduce(ordk, ok & ~isnan, KEY_NEG_INF,
                                      False).reshape(1))
        lo = torch.where(nan, float("nan"), lo).view(torch.int64)[0]
        hi = torch.where(nan, float("nan"), hi).view(torch.int64)[0]
        lo_nan = nan.to(torch.int64)
    else:
        w = values.to(torch.int64)
        lo = _reduce(w, ok, _I64_MAX, True)
        hi = _reduce(w, ok, _I64_MIN, False)
        lo_nan = torch.zeros((), dtype=torch.int64, device=dev)
    return torch.stack([kmin, kmax, lo, hi, lo_nan])


def key_bounds_grid(cap: int, sms: int) -> int:
    """Blocks of K26's launch: one per KEY_BOUNDS_THREADS x
    KEY_BOUNDS_ROWS rows of capacity, at most KEY_BOUNDS_BLOCKS_PER_SM per
    SM."""
    need = -(-cap // (KEY_BOUNDS_THREADS * KEY_BOUNDS_ROWS))
    return max(1, min(need, KEY_BOUNDS_BLOCKS_PER_SM * sms))


def key_bounds_acc_init() -> List[int]:
    """K26's per-device words between calls: the ticket (word 0's low
    half) at 0, then umin, umax, lo and hi at their identities (u64::MAX,
    0, int64 max, int64 min) and the NaN flag at 0."""
    return [0, -1, 0, _I64_MAX, _I64_MIN, 0]


def _key_bounds_scratch(index: int) -> torch.Tensor:
    """K26's per-device words (key_bounds_acc_init), set once: every call's
    last block writes the call's five words from them and sets them back.
    Calls share them, so they must be ordered on one stream, as every
    launch of the port is (the device's current stream), from one host
    thread."""
    s = _KEY_BOUNDS_SCRATCH.get(index)
    if s is None:
        s = _KEY_BOUNDS_SCRATCH[index] = torch.tensor(
            key_bounds_acc_init(), dtype=torch.int64,
            device=torch.device("cuda", index))
    return s


def key_bounds_launch_model(values, valid, n: int, grid: int,
                            acc: torch.Tensor, out: torch.Tensor,
                            order: Optional[Sequence[int]] = None
                            ) -> torch.Tensor:
    """K26 as its one launch runs it (csrc/join_mxu.cu key_bounds_kernel)
    over `grid` blocks, on the kernel's own arguments: block b takes the
    rows of the tiles b, b + grid, ... of KEY_BOUNDS_THREADS x
    KEY_BOUNDS_ROWS rows below n, each row's key read in its own width (a
    float32 widened to float64), and folds their unsigned key encoding,
    own-order value (a float's order key, NaN left out) and NaN flag from
    the identities of key_bounds_acc_init; the blocks, in `order`, fold
    each word that left its identity into the per-device words `acc` and
    take a ticket, and the block that takes the last writes the five
    words to `out` (a float column's lo and hi as float64 bits: +inf and
    -inf where no value, NaN bits where a NaN) and sets `acc` back.
    Returns the times each row was read (1 below n, 0 past it)."""
    cap = values.shape[0]
    is_float = values.is_floating_point()
    i = torch.arange(cap)
    block = (i // (KEY_BOUNDS_THREADS * KEY_BOUNDS_ROWS)) % grid
    ok = i < n
    read = ok.to(torch.int64)
    if valid is not None:
        ok = ok & valid
    if is_float:
        x = values.to(torch.float64)
        key = torch.where(x == 0, torch.zeros_like(x), x).view(torch.int64)
        isnan = torch.isnan(x)
        own = ordered_key(torch.where(isnan, torch.zeros_like(x), x))
    else:
        key = own = values.to(torch.int64)
        isnan = torch.zeros(cap, dtype=torch.bool)
    flipped = key ^ _I64_MIN
    ident = key_bounds_acc_init()
    for b in (range(grid) if order is None else order):
        m = ok & (block == b)
        good = m & ~isnan
        words = [_reduce(flipped, m, _I64_MAX, True) ^ _I64_MIN,
                 _reduce(flipped, m, _I64_MIN, False) ^ _I64_MIN,
                 _reduce(own, good, _I64_MAX, True),
                 _reduce(own, good, _I64_MIN, False),
                 (m & isnan).any().to(torch.int64)]
        for j, w in enumerate(words, 1):
            w, was = int(w), int(acc[j])
            if w == ident[j]:
                continue
            if j <= 2:      # unsigned min, max
                pick = min if j == 1 else max
                acc[j] = pick(was ^ _I64_MIN, w ^ _I64_MIN) ^ _I64_MIN
            elif j <= 4:
                acc[j] = (min if j == 3 else max)(was, w)
            else:
                acc[j] = was | w
        ticket = int(acc[0])
        acc[0] = ticket + 1
        if ticket != grid - 1:
            continue
        umin, umax, lo, hi, nan = (int(w) for w in acc[1:6])
        if is_float:
            lo = KEY_POS_INF if lo == _I64_MAX else int(
                from_ordered_key(torch.tensor([lo])).view(torch.int64)[0])
            hi = _F64_NEG_INF_BITS if hi == _I64_MIN else int(
                from_ordered_key(torch.tensor([hi])).view(torch.int64)[0])
            if nan:
                lo = hi = _F64_NAN_BITS
        out.copy_(torch.tensor([umin, umax, lo, hi, nan]))
        acc.copy_(torch.tensor(ident))
    return read


def key_bounds_cuda(values: torch.Tensor, valid, num_rows: torch.Tensor
                    ) -> torch.Tensor:
    """K26 launch: see csrc/join_mxu.cu key_bounds. One launch (each block
    folds its words into the per-device words, the last block writes the
    call's), the key read in its own width, one allocation (the five
    output words)."""
    cap = values.shape[0]
    index = num_rows.get_device()
    if index < 0 or num_rows.dtype is not torch.int32 or num_rows.dim():
        raise ValueError("num_rows must be a 0-d int32 CUDA tensor")
    ptr, vptr, esz, is_float = _key_words([(values, valid)], cap, index,
                                          "build")
    grid = key_bounds_grid(cap, native.sm_count(index))
    out = torch.empty(KEY_BOUNDS_WORDS, dtype=torch.int64,
                      device=num_rows.device)
    rc = native.function("join_mxu", "key_bounds", _KEY_BOUNDS_ARGS)(
        ptr, vptr, esz, is_float, num_rows.data_ptr(), cap,
        _key_bounds_scratch(index).data_ptr(), out.data_ptr(), grid,
        native.raw_stream(index))
    native.check(rc, "key_bounds")
    key_bounds_cuda.launches += 1
    return out


key_bounds_cuda.launches = 0


def key_bounds_words(values, valid, num_rows) -> torch.Tensor:
    """K26 wrapper: plain twin on the CPU, kernel on CUDA."""
    run = key_bounds_cuda if num_rows.is_cuda else key_bounds_plain
    return run(values, valid, num_rows)


def key_bounds(channel: int):
    """The fused join's span probe over one build key channel. Returns
    op(page) -> int64[5] on the device (B_KMIN, B_KMAX in unsigned order
    of the key encoding, kmin > kmax for an all-dead build; B_LO, B_HI,
    B_LO_NAN the dynamic filter's bounds, ops/join.typed_bounds)."""

    def op(page: Page) -> torch.Tensor:
        c = page.column(channel)
        return key_bounds_words(c.values.contiguous(), c.valid,
                                page.num_rows)
    return op


# ------------------------------------------------------------------ K25


def agg_lookup_plain(key, num_rows: torch.Tensor, table: torch.Tensor,
                     kmin: torch.Tensor, outs
                     ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Plain twin of K25. `key` is the probe key column (values, valid);
    `outs` one (op, table column, values, valid) per output column.
    Returns (one int64/float64 [cap] tensor per output, live mask): per
    probe row its key's table row (zeros outside [kmin, kmin + slots)),
    cnt = its pair count, live = row < num_rows, key not NULL and cnt > 0,
    and per op: OP_PAIRS cnt; OP_CNTP cnt where the probe value is valid,
    else 0; OP_SUMP_I value * cnt in int64 (wrapping); OP_SUMP_F value *
    cnt in float64; OP_TABLE_I / OP_TABLE_F the table column (float64
    from its bits)."""
    cap = key[0].shape[0]
    dev = num_rows.device
    k, null = _key_cols([key])
    looked = blocked_lookup(table, kmin, k)
    cnt = looked[:, 0]
    live = (torch.arange(cap, device=dev, dtype=torch.int32) < num_rows) \
        & ~null & (cnt > 0)
    got = []
    for op, col, values, valid in outs:
        if op == OP_PAIRS:
            got.append(cnt.clone())
        elif op == OP_CNTP:
            got.append(cnt.clone() if valid is None else
                       torch.where(valid, cnt, torch.zeros_like(cnt)))
        elif op == OP_SUMP_I:
            got.append(values.to(torch.int64) * cnt)
        elif op == OP_SUMP_F:
            got.append(values.to(torch.float64) * cnt.to(torch.float64))
        else:
            got.append(table_column(looked, VEC_SUM_F if op == OP_TABLE_F
                                    else VEC_SUM_I, col))
    return got, live


AGG_LOOKUP_THREADS = 256   # csrc/join_mxu.cu LK_THREADS
AGG_LOOKUP_ROWS = 2        # LK_ROWS: consecutive rows a thread
AGG_LOOKUP_PER_SM = 8      # resident blocks of K25 on an SM (2,048 threads)
AGG_LOOKUP_FIELDS = 6      # LK_FIELDS: words of an output's descriptor
AGG_LOOKUP_MAX = (native.TABLE_MAX - 4) // AGG_LOOKUP_FIELDS   # LK_MAX
AGG_LOOKUP_SMEM_WORDS = 6144   # SMEM_WORDS: a table staged in shared memory
_AGG_LOOKUP_ARGS = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                    ctypes.c_void_p)


def agg_lookup_grid(cap: int, sms: int, words: int) -> int:
    """Blocks of K25's grid: one per AGG_LOOKUP_THREADS x AGG_LOOKUP_ROWS
    rows of capacity, at most as many as the card holds at once (so none
    waits for another's stride): AGG_LOOKUP_PER_SM an SM, half as many
    when each stages a table of more than a quarter of SMEM_WORDS (`words`
    = slots x columns; a larger table is not staged)."""
    step = AGG_LOOKUP_THREADS * AGG_LOOKUP_ROWS
    per_sm = AGG_LOOKUP_PER_SM // 2 if AGG_LOOKUP_SMEM_WORDS // 4 < words \
        <= AGG_LOOKUP_SMEM_WORDS else AGG_LOOKUP_PER_SM
    return max(1, min(-(-cap // step), per_sm * sms))


def agg_lookup_stride(cap: int) -> int:
    """The row stride of K25's int64 (nout, stride) output block: a
    multiple of 32 words, so every output starts 256-byte aligned."""
    return -(-cap // 32) * 32


def agg_lookup_words(key, outs) -> List[int]:
    """K25's parameter words: the key column's four (csrc/common.cuh
    join_key), then per output its op, table column, values and validity
    pointers (0 where absent), element size and float flag."""
    words = _key_table([key])
    for op, col, values, valid in outs:
        if values is None:
            words += (op, col, 0, 0, 0, 0)
        else:
            words += (op, col, values.data_ptr(),
                      0 if valid is None else valid.data_ptr(),
                      values.element_size(), int(values.is_floating_point()))
    return words


def agg_lookup_cuda(key, num_rows: torch.Tensor, table: torch.Tensor,
                    kmin: torch.Tensor, outs
                    ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """K25 launch: see csrc/join_mxu.cu agg_lookup. One launch; the outputs
    are the rows of one allocation (agg_lookup_stride), the mask a second;
    both are written below num_rows only."""
    cap = key[0].shape[0]
    index = num_rows.get_device()
    if index < 0:
        raise ValueError("K25's num_rows must be on a CUDA device")
    dev = num_rows.device
    _check_key_cols([key], cap, dev)
    if num_rows.dtype != torch.int32 or num_rows.dim() != 0:
        raise ValueError("num_rows must be a 0-d int32 tensor")
    if table.dtype != torch.int64 or table.dim() != 2 \
            or table.get_device() != index or not table.is_contiguous():
        raise ValueError("the table must be a contiguous int64 (slots, C) "
                         "tensor on the card")
    if kmin.dtype != torch.int64 or kmin.numel() != 1 \
            or kmin.get_device() != index:
        raise ValueError("kmin must be one int64 word on the card")
    nout = len(outs)
    if nout > AGG_LOOKUP_MAX:
        raise ValueError(f"{nout} outputs: one launch's table holds "
                         f"{AGG_LOOKUP_MAX}")
    slots, ncols = table.shape
    for op, col, values, valid in outs:
        if values is not None:
            _check_key_cols([(values, valid)], cap, dev)
        elif op in (OP_CNTP, OP_SUMP_I, OP_SUMP_F):
            raise ValueError("a probe-side output needs its column")
        if op >= OP_TABLE_I and not 0 <= col < ncols:
            raise ValueError(f"table column {col} out of range")
    stride = agg_lookup_stride(cap)
    block = torch.empty(max(1, nout * stride), dtype=torch.int64, device=dev)
    live = torch.empty(cap, dtype=torch.bool, device=dev)
    got = list(block.as_strided((nout, cap), (stride, 1)).unbind(0))
    for q, (op, *_) in enumerate(outs):
        if op == OP_SUMP_F or op == OP_TABLE_F:
            got[q] = got[q].view(torch.float64)
    desc = array.array("q", agg_lookup_words(key, outs))
    rc = native.function("join_mxu", "agg_lookup", _AGG_LOOKUP_ARGS)(
        desc.buffer_info()[0], nout, cap, num_rows.data_ptr(),
        table.data_ptr(), slots, ncols, kmin.data_ptr(), block.data_ptr(),
        stride, live.data_ptr(),
        agg_lookup_grid(cap, native.sm_count(index), slots * ncols),
        native.raw_stream(index))
    native.check(rc, "agg_lookup")
    agg_lookup_cuda.launches += 1
    return got, live


agg_lookup_cuda.launches = 0


def agg_lookup_launch_model(key, num_rows: int, table: torch.Tensor,
                            kmin: int, outs, got, live, grid: int) -> dict:
    """Model of K25's launch (csrc/join_mxu.cu agg_lookup_kernel) writing
    into `got` (one [cap] tensor per output, float64 columns as float64)
    and `live` (bool [cap]): `grid` blocks of AGG_LOOKUP_THREADS threads,
    AGG_LOOKUP_ROWS consecutive rows a thread, striding the live rows; a
    block with no live row returns before it stages the table. Returns
    stats: blocks run, tables staged in shared memory, stores of two rows
    and of one, and each row's writes."""
    import numpy as np
    cap = key[0].shape[0]
    n = max(0, min(int(num_rows), cap))
    step = AGG_LOOKUP_THREADS * AGG_LOOKUP_ROWS
    slots, ncols = table.shape
    k, null = _key_cols([key])
    writes = np.zeros(cap, dtype=np.int64)
    stats = dict(blocks=0, staged=0, pairs=0, singles=0, writes=writes)
    for b in range(grid):
        if b * step >= n:
            continue
        stats["blocks"] += 1
        stats["staged"] += int(slots * ncols <= AGG_LOOKUP_SMEM_WORDS)
        t0 = (b * AGG_LOOKUP_THREADS + np.arange(AGG_LOOKUP_THREADS)) * \
            AGG_LOOKUP_ROWS
        firsts = (t0[None, :] + np.arange(0, n, grid * step)[:, None])
        firsts = firsts[firsts < n]
        two = firsts + 1 < n
        stats["pairs"] += int(two.sum())
        stats["singles"] += int((~two).sum())
        rows = np.concatenate([firsts, firsts[two] + 1])
        np.add.at(writes, rows, 1)
        idx = torch.from_numpy(rows)
        raw = k[idx] - kmin                 # u64 difference as int64
        inb = (raw >= 0) & (raw < slots)
        trow = table[raw.clamp(0, max(slots - 1, 0))] if slots else \
            torch.zeros((len(rows), ncols), dtype=torch.int64)
        cnt = torch.where(inb, trow[:, 0], torch.zeros_like(raw))
        live[idx] = ~null[idx] & (cnt > 0)
        for (op, col, values, valid), out in zip(outs, got):
            if op == OP_PAIRS:
                v = cnt
            elif op == OP_CNTP:
                v = cnt if valid is None else torch.where(
                    valid[idx], cnt, torch.zeros_like(cnt))
            elif op == OP_SUMP_I:
                v = values[idx].to(torch.int64) * cnt
            elif op == OP_SUMP_F:
                v = (values[idx].to(torch.float64) * cnt.to(torch.float64)
                     ).view(torch.int64)
            else:
                v = torch.where(inb, trow[:, col], torch.zeros_like(cnt))
            out.view(torch.int64)[idx] = v
    return stats


def agg_lookup(key, num_rows, table, kmin, outs):
    """K25 wrapper: plain twin on the CPU, kernel on CUDA."""
    run = agg_lookup_cuda if num_rows.is_cuda else agg_lookup_plain
    return run(key, num_rows, table, kmin, outs)


def agg_join_lookup(key_channel: int, group_channels, derive, helpers):
    """Per-probe-page derived rows of the fused aggregating join: the group
    columns pass through, each aggregate becomes a per-row contribution
    from the row's looked-up build vector, and rows without a match (or
    dead, or with a NULL key) are compacted away (K25, then K1).

    `derive` entries (one per aggregate, planner-encoded):
      ('pairs',)                 count(*)   -> pair multiplicity
      ('cntp', probe_ch)         count(p.v) -> multiplicity where v valid
      ('sump', probe_ch, 'i'|'f') sum(p.v)  -> v * multiplicity (NULL
                                  rides the probe column's validity)
      ('cntb', vec_idx)          count(b.w) -> looked-up #valid-w
      ('sumb', vec_idx, 'i'|'f', helper_pos) sum(b.w) -> looked-up sum of w
    `helpers` lists the #valid-w table columns that ride along as extra
    summed columns (agg_join_post turns them into SUM null masks).
    Returns op(page, table, kmin) -> Page."""
    group_channels = tuple(group_channels)
    derive = tuple(derive)
    helpers = tuple(helpers)

    def op(page: Page, table: torch.Tensor, kmin: torch.Tensor) -> Page:
        outs, meta = [], []
        for d in derive:
            if d[0] == "pairs":
                outs.append((OP_PAIRS, 0, None, None))
                meta.append((T.BIGINT, None))
            elif d[0] == "cntp":
                c = page.column(d[1])
                outs.append((OP_CNTP, 0, _word_values(c.values), c.valid))
                meta.append((T.BIGINT, None))
            elif d[0] == "sump":
                c = page.column(d[1])
                f = d[2] == "f"
                outs.append((OP_SUMP_F if f else OP_SUMP_I, 0,
                             _word_values(c.values), c.valid))
                meta.append((T.DOUBLE if f else T.BIGINT, c.valid))
            elif d[0] == "cntb":
                outs.append((OP_TABLE_I, d[1], None, None))
                meta.append((T.BIGINT, None))
            else:   # 'sumb'
                f = d[2] == "f"
                outs.append((OP_TABLE_F if f else OP_TABLE_I, d[1], None,
                             None))
                meta.append((T.DOUBLE if f else T.BIGINT, None))
        for h in helpers:
            outs.append((OP_TABLE_I, h, None, None))
            meta.append((T.BIGINT, None))
        key = _page_key_cols(page, (key_channel,))[0]
        got, live = agg_lookup(key, page.num_rows, table, kmin, outs)
        cols = [page.columns[ch] for ch in group_channels]
        cols += [Column(v, valid, typ, None)
                 for v, (typ, valid) in zip(got, meta)]
        return Page(tuple(cols), page.num_rows).filter(live)
    return op


# ------------------------------------------------------------------ K27

AGG_POST_THREADS = 256     # csrc/join_mxu.cu POST_THREADS
AGG_POST_GRID_MAX = 264    # blocks of K27's grid at most; they stride
AGG_POST_MAX = 1024        # helpers of one launch (common.cuh TABLE_MAX / 2)
_AGG_POST_ARGS = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                  ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p)


def agg_post_plain(helpers: Sequence[torch.Tensor], num_rows: torch.Tensor
                   ) -> List[torch.Tensor]:
    """Plain twin of K27: per summed #valid-w helper column, the validity
    of its build-side SUM, helper > 0, on the page's num_rows live rows
    (the padding past them is False here, undefined in the kernel's)."""
    if not helpers:
        return []
    live = torch.arange(helpers[0].shape[0], device=num_rows.device,
                        dtype=torch.int32) < num_rows
    return [(h > 0) & live for h in helpers]


def agg_post_grid(cap: int) -> int:
    """Blocks of K27's grid: one per AGG_POST_THREADS rows of capacity,
    at most AGG_POST_GRID_MAX; the blocks stride the live rows."""
    return max(1, min(AGG_POST_GRID_MAX, -(-cap // AGG_POST_THREADS)))


def agg_post_table(helpers: Sequence[torch.Tensor], base: int, cap: int
                   ) -> List[int]:
    """K27's parameter words: per helper its pointer and its mask row's,
    the rows of `cap` bytes from `base` (csrc/join_mxu.cu PostPairs)."""
    words: List[int] = []
    for j, h in enumerate(helpers):
        words += (h.data_ptr(), base + j * cap)
    return words


def agg_post_cuda(helpers: Sequence[torch.Tensor], num_rows: torch.Tensor
                  ) -> List[torch.Tensor]:
    """K27 launch: see csrc/join_mxu.cu. One launch for every helper; the
    masks are the rows of one bool [helpers, cap] allocation."""
    if not helpers:
        return []
    cap = helpers[0].shape[0]
    dev = helpers[0].device
    index = helpers[0].get_device()
    for h in helpers:
        if index < 0 or h.dtype is not torch.int64 or h.shape != (cap,) \
                or h.device != dev or not h.is_contiguous():
            raise ValueError("helpers must be contiguous int64 [cap] on the "
                             "card")
    if num_rows.dtype is not torch.int32 or num_rows.dim() != 0 \
            or num_rows.device != dev:
        raise ValueError("num_rows must be a 0-d int32 tensor beside the "
                         "helpers")
    if len(helpers) > AGG_POST_MAX:
        raise ValueError(f"{len(helpers)} helpers: one launch's table "
                         f"holds {AGG_POST_MAX}")
    masks = torch.empty((len(helpers), cap), dtype=torch.bool, device=dev)
    table = array.array("q", agg_post_table(helpers, masks.data_ptr(), cap))
    rc = native.function("join_mxu", "agg_post", _AGG_POST_ARGS)(
        table.buffer_info()[0], len(helpers), num_rows.data_ptr(), cap,
        agg_post_grid(cap), native.raw_stream(index))
    native.check(rc, "agg_post")
    agg_post_cuda.launches += 1
    return list(masks.unbind(0))


agg_post_cuda.launches = 0


def agg_post(helpers: Sequence[torch.Tensor], num_rows: torch.Tensor
             ) -> List[torch.Tensor]:
    """K27 wrapper: plain twin on the CPU, kernel on CUDA."""
    run = agg_post_cuda if num_rows.is_cuda else agg_post_plain
    return run(helpers, num_rows)


def agg_join_post(nk: int, derive, nhelpers: int, out_types):
    """Final shaping after the SINGLE aggregation over the derived rows:
    the plan's declared output types, SQL NULL for a build-side SUM whose
    group saw no non-NULL build value (its summed #valid-w helper is 0:
    K27), the helper columns dropped. Returns op(agg_page) -> Page."""
    derive = tuple(derive)
    out_types = tuple(out_types)

    def op(page: Page) -> Page:
        base = nk + len(derive)
        masks = agg_post([page.columns[base + h].values.contiguous()
                          for h in range(nhelpers)], page.num_rows)
        cols = list(page.columns[:nk])
        for i, (d, typ) in enumerate(zip(derive, out_types)):
            c = page.columns[nk + i]
            if d[0] in ("pairs", "cntp", "cntb"):
                cols.append(Column(c.values, None, typ, None))
            elif d[0] == "sump":
                cols.append(Column(c.values, c.valid, typ, None))
            else:   # 'sumb'
                cols.append(Column(c.values, masks[d[3]], typ, None))
        return Page(tuple(cols), page.num_rows)
    return op
