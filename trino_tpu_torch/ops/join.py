"""Equi-joins of every kind: build, unique probe, expanding probe, attach.

Port of `trino_tpu/ops/join.py`. The reference sorts the build keys once
and probes them with searchsorted or, for a dense key span, a direct-
address table; the port replaces the sort with a hash table and keeps what
each function returns. Device kernels, each beside its plain PyTorch twin:

* K5 `join_build` (prepare_build, build_key_bounds): per build row its
  64-bit key, the statistics the executor reads once per join (live rows,
  NULL keys, max_run, the unsigned key min/max, the first key's bounds)
  and an open-addressing hash table, `csrc/join_build.cu`; its dense mode
  `join_dense` (build_dense_table) fills the direct-address table of a
  small key span; its runs mode `join_runs` (the reference's bperm and
  run_len) lays every key's build rows out together, in ascending row
  order, for the expanding probe, with the dense table of that mode.
* K6 `unique_probe` (unique_inner_probe): one lookup per probe row, the
  found mask, the matching build row and the match count,
  `csrc/join_probe.cu`.
* K9 (hash_join, _mark_page, unmatched_build_page), `csrc/join_expand.cu`:
  `expand_count` counts each probe row's verified matches (or its one
  null-extended row) and their int64 total, `expand_write` writes the
  (probe row, build row) pairs at that total, and `probe_verdict` answers
  SEMI, ANTI and MARK per probe row without expanding.
* range_prefilter runs K1's range mode (`page.compact_range`), the
  attaches and the expanded columns K7 (`page.gather_rows`), SEMI/ANTI
  output and the FULL join's unmatched build rows K1 (`Page.filter`).

Keys are 64-bit words held in int64 tensors (torch has no uint64
arithmetic): the reference's uint64 mix is computed with a wrapping
multiply and a masked logical right shift, bit for bit, and unsigned
comparisons flip the sign bit first.

The twins run only for CPU tensors: they keep the build's keys sorted
(searchsorted probes) where the kernels keep a hash table. Both give the
same statistics, the same rows per key, and the same output rows in the
same order (probe-row order, then each key's build rows in row order).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from trino_tpu_torch import native
from trino_tpu_torch import types as T
from trino_tpu_torch.ops.aggregate import (KEY_NEG_INF, KEY_POS_INF,
                                           from_ordered_key, hash_slots,
                                           ordered_key)
from trino_tpu_torch.page import (Column, Page, _movable, _rebuild,
                                  compact_range, gather_rows, host_table)


class JoinType:
    INNER = "inner"
    LEFT = "left"          # probe side preserved
    SEMI = "semi"          # probe rows with >=1 match (IN / EXISTS)
    ANTI = "anti"          # probe rows with 0 matches (NOT IN w/o nulls)
    FULL = "full"          # both sides preserved
    MARK = "mark"          # all probe rows + bool match channel


_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1
_I32_MAX = (1 << 31) - 1


def _signed(u: int) -> int:
    """A 64-bit unsigned constant as the int64 with the same bits."""
    return u - (1 << 64) if u >= 1 << 63 else u


def unsigned(x: int) -> int:
    """An int64 read back from the device as the uint64 it holds."""
    return x & ((1 << 64) - 1)


_MIX = _signed(0x9E3779B97F4A7C15)
_C1 = _signed(0xBF58476D1CE4E5B9)
_C2 = _signed(0x94D049BB133111EB)


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 words (the uint64 `>>`)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer on int64 words: the reference's uint64 _mix64,
    bit for bit (int64 multiplication wraps as uint64 does)."""
    x = (x ^ _srl(x, 30)) * _C1
    x = (x ^ _srl(x, 27)) * _C2
    return x ^ _srl(x, 31)


def _to_u64(raw: torch.Tensor) -> torch.Tensor:
    """One key column as the reference widens it to uint64: integers
    sign-extended, floats as float64 bits with -0.0 made +0.0."""
    if raw.dtype == torch.bool:
        return raw.to(torch.int64)
    if raw.is_floating_point():
        x = raw.to(torch.float64)
        return torch.where(x == 0, torch.zeros_like(x), x).view(torch.int64)
    return raw.to(torch.int64)


def _key_cols(cols: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(key words, key is NULL) over (values, valid) key columns."""
    cap = cols[0][0].shape[0]
    null = torch.zeros(cap, dtype=torch.bool, device=cols[0][0].device)
    for _, valid in cols:
        if valid is not None:
            null = null | ~valid
    if len(cols) == 1:
        return _to_u64(cols[0][0]), null
    acc = torch.zeros(cap, dtype=torch.int64, device=null.device)
    for values, _ in cols:
        acc = _mix64(acc ^ _mix64(_to_u64(values)) ^ (acc * _MIX))
    return acc, null


def _key_u64(page: Page, channels: Sequence[int]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(key, key_is_null): one 64-bit key per row (int64 words holding the
    reference's uint64); composite keys mix-hashed."""
    return _key_cols([(page.column(ch).values, page.column(ch).valid)
                      for ch in channels])


# ------------------------------------------------------------------ K5

# int64 statistics a build writes (csrc/join_build.cu enum Stat)
N_LIVE, N_ROWS, HAS_NULL, MAX_RUN, KMIN, KMAX, LO, HI, LO_NAN = range(9)
N_STATS = 10


def _reduce(x: torch.Tensor, ok: torch.Tensor, ident: int, lowest: bool
            ) -> torch.Tensor:
    """min (lowest) or max of x where ok, `ident` when none."""
    v = torch.where(ok, x, torch.full_like(x, ident))
    v = torch.cat([v, torch.full((1,), ident, dtype=x.dtype,
                                 device=x.device)])
    return v.min() if lowest else v.max()


def join_build_plain(cols, num_rows: torch.Tensor):
    """Plain twin of K5: (stats int64[10], ("sorted", keys, rows)) — the
    live non-NULL keys in unsigned order with their first build row."""
    cap = cols[0][0].shape[0]
    dev = num_rows.device
    live = torch.arange(cap, device=dev, dtype=torch.int32) < num_rows
    key, null = _key_cols(cols)
    ok = live & ~null
    flipped = key ^ _I64_MIN          # signed order == unsigned order
    kmin = _reduce(flipped, ok, _I64_MAX, True) ^ _I64_MIN
    kmax = _reduce(flipped, ok, _I64_MIN, False) ^ _I64_MIN
    first, fvalid = cols[0]
    bl = live if fvalid is None else live & fvalid
    if first.is_floating_point():
        f = first.to(torch.float64)
        nan = (bl & torch.isnan(f)).any()
        ok_b = bl & ~torch.isnan(f)
        ordk = ordered_key(torch.where(torch.isnan(f), torch.zeros_like(f),
                                       f))
        lo = from_ordered_key(
            _reduce(ordk, ok_b, KEY_POS_INF, True).reshape(1))
        hi = from_ordered_key(
            _reduce(ordk, ok_b, KEY_NEG_INF, False).reshape(1))
        lo = torch.where(nan, float("nan"), lo).view(torch.int64)[0]
        hi = torch.where(nan, float("nan"), hi).view(torch.int64)[0]
        lo_nan = nan.to(torch.int64)
    else:
        w = first.to(torch.int64)
        lo = _reduce(w, bl, _I64_MAX, True)
        hi = _reduce(w, bl, _I64_MIN, False)
        lo_nan = torch.zeros((), dtype=torch.int64, device=dev)
    live_keys = key[ok]
    rows = torch.nonzero(ok).flatten()
    order = torch.sort(live_keys ^ _I64_MIN, stable=True).indices
    skeys, srows = live_keys[order], rows[order]
    if skeys.numel():
        _, counts = torch.unique_consecutive(skeys, return_counts=True)
        max_run = counts.max()
        first_of = torch.ones_like(skeys, dtype=torch.bool)
        first_of[1:] = skeys[1:] != skeys[:-1]
        skeys, srows = skeys[first_of], srows[first_of]
    else:
        max_run = torch.zeros((), dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    stats = torch.stack([
        ok.sum(dtype=torch.int64), live.sum(dtype=torch.int64),
        (live & null).any().to(torch.int64), max_run.to(torch.int64),
        kmin, kmax, lo, hi, lo_nan, zero])
    return stats, ("sorted", skeys, srows)


def _key_table(cols) -> List[int]:
    """The 4-word key-column entries of a K5/K6 pointer table."""
    out = []
    for values, valid in cols:
        out += [values.data_ptr(), 0 if valid is None else valid.data_ptr(),
                values.element_size(), int(values.is_floating_point())]
    return out


def _check_key_cols(cols, cap: int, dev) -> None:
    for values, valid in cols:
        if values.device != dev or values.dim() != 1 \
                or values.shape[0] != cap or not values.is_contiguous() \
                or values.element_size() not in (1, 2, 4, 8) \
                or (values.is_floating_point()
                    and values.element_size() not in (4, 8)):
            raise ValueError(f"key column {values.dtype}"
                             f"{tuple(values.shape)} on {values.device} "
                             "does not match")
        if valid is not None and (valid.dtype != torch.bool
                                  or valid.shape != values.shape
                                  or valid.device != dev
                                  or not valid.is_contiguous()):
            raise ValueError("key validity must be a contiguous bool [cap]")


def join_build_cuda(cols, num_rows: torch.Tensor):
    """K5 launch: see csrc/join_build.cu. Returns (stats int64[10],
    ("hash", slot_keys, slot_rows, slot_counts))."""
    cap = cols[0][0].shape[0]
    dev = num_rows.device
    _check_key_cols(cols, cap, dev)
    if num_rows.dtype != torch.int32 or num_rows.dim() != 0:
        raise ValueError("num_rows must be a 0-d int32 tensor")
    slots = hash_slots(cap)
    slot_keys = torch.empty(slots, dtype=torch.int64, device=dev)
    slot_rows = torch.empty(slots, dtype=torch.int32, device=dev)
    slot_counts = torch.empty(slots, dtype=torch.int32, device=dev)
    stats = torch.empty(N_STATS, dtype=torch.int64, device=dev)
    lib = native.library("join_build")
    rc = lib.join_build(
        host_table(_key_table(cols)), ctypes.c_int64(len(cols)),
        ctypes.c_int64(cap), ctypes.c_void_p(num_rows.data_ptr()),
        ctypes.c_void_p(slot_keys.data_ptr()),
        ctypes.c_void_p(slot_rows.data_ptr()),
        ctypes.c_void_p(slot_counts.data_ptr()), ctypes.c_int64(slots),
        ctypes.c_void_p(stats.data_ptr()),
        ctypes.c_void_p(native.stream_ptr(dev)))
    native.check(rc, "join_build")
    join_build_cuda.launches += 1
    return stats, ("hash", slot_keys, slot_rows, slot_counts)


join_build_cuda.launches = 0


def join_build(cols, num_rows: torch.Tensor):
    """K5 wrapper: plain twin on the CPU, kernel on CUDA."""
    run = join_build_cuda if num_rows.is_cuda else join_build_plain
    return run(cols, num_rows)


def join_dense_plain(cols, num_rows: torch.Tensor, stats: torch.Tensor,
                     size: int) -> torch.Tensor:
    """Plain twin of K5's dense mode: int32[size], key kmin + s -> the
    smallest build row holding it, INT32_MAX where absent."""
    cap = cols[0][0].shape[0]
    dev = num_rows.device
    live = torch.arange(cap, device=dev, dtype=torch.int32) < num_rows
    key, null = _key_cols(cols)
    raw = key - stats[KMIN]
    inb = live & ~null & (raw >= 0) & (raw < size)
    slot = torch.where(inb, raw, torch.full_like(raw, size))
    table = torch.full((size + 1,), _I32_MAX, dtype=torch.int32, device=dev)
    table.scatter_reduce_(0, slot, torch.arange(cap, dtype=torch.int32,
                                                device=dev), "amin")
    return table[:size]


def join_dense_cuda(cols, num_rows: torch.Tensor, stats: torch.Tensor,
                    size: int) -> torch.Tensor:
    """K5 dense-mode launch: see csrc/join_build.cu join_dense."""
    cap = cols[0][0].shape[0]
    dev = num_rows.device
    _check_key_cols(cols, cap, dev)
    if stats.dtype != torch.int64 or stats.shape != (N_STATS,) \
            or stats.device != dev:
        raise ValueError("stats must be K5's int64[10] on the device")
    table = torch.empty(size, dtype=torch.int32, device=dev)
    lib = native.library("join_build")
    rc = lib.join_dense(
        host_table(_key_table(cols)), ctypes.c_int64(len(cols)),
        ctypes.c_int64(cap), ctypes.c_void_p(num_rows.data_ptr()),
        ctypes.c_void_p(stats.data_ptr()), ctypes.c_void_p(table.data_ptr()),
        ctypes.c_int64(size), ctypes.c_void_p(native.stream_ptr(dev)))
    native.check(rc, "join_dense")
    join_dense_cuda.launches += 1
    return table


join_dense_cuda.launches = 0


def join_dense(cols, num_rows, stats, size):
    """K5 dense-mode wrapper: plain twin on the CPU, kernel on CUDA."""
    run = join_dense_cuda if num_rows.is_cuda else join_dense_plain
    return run(cols, num_rows, stats, size)


@dataclasses.dataclass
class Prepared:
    """A built join side (the reference's LookupSource tuple): the build
    page, its key channels, K5's statistics (int64[10] on the device), its
    lookup structure, on the dense route the direct-address table and, for
    the expanding probe, the runs (runs mode: build rows grouped by key,
    each slot's start and length). With runs, the dense table maps a key
    to its slot, not to a row."""

    build: Page
    keys: Tuple[int, ...]
    stats: torch.Tensor
    lookup: tuple
    dense: Optional[torch.Tensor] = None
    runs: Optional[tuple] = None


def _page_key_cols(page: Page, channels: Sequence[int]):
    return [(page.column(ch).values.contiguous(), page.column(ch).valid)
            for ch in channels]


def prepare_build(build_keys: Sequence[int]) -> Callable[[Page], Prepared]:
    """Build-phase operator (LookupSourceFactory analog): runs K5 once per
    join; every probe page then reads the Prepared it returns."""
    build_keys = tuple(build_keys)

    def prep(build: Page) -> Prepared:
        stats, lookup = join_build(_page_key_cols(build, build_keys),
                                   build.num_rows)
        return Prepared(build, build_keys, stats, lookup)
    return prep


def build_dense_table(size: int) -> Callable[[Prepared], Prepared]:
    """The dense route's direct-address table (K5 dense mode): `size`
    slots from the build's kmin, as the reference's build_dense_table."""

    def op(prepared: Prepared) -> Prepared:
        table = join_dense(_page_key_cols(prepared.build, prepared.keys),
                           prepared.build.num_rows, prepared.stats, size)
        return dataclasses.replace(prepared, dense=table)
    return op


def build_key_bounds(build_keys: Sequence[int]):
    """Dynamic-filter source: the live, non-NULL min/max of the first build
    key column in its own type, as 0-d tensors on the device (K5 computed
    them with the build; nothing is read on the host)."""
    build_keys = tuple(build_keys)

    def op(prepared: Prepared) -> Tuple[torch.Tensor, torch.Tensor]:
        dtype = prepared.build.column(build_keys[0]).values.dtype
        words = prepared.stats[LO:HI + 1]
        if dtype.is_floating_point:
            lo, hi = words.view(torch.float64).to(dtype)
        elif dtype == torch.bool:
            lo, hi = words.clamp(0, 1).to(dtype)
        else:
            info = torch.iinfo(dtype)
            lo, hi = words.clamp(info.min, info.max).to(dtype)
        return lo, hi
    return op


def range_prefilter(probe_key: int):
    """Probe-side dynamic filter: drop rows whose key lies outside [lo, hi]
    or is NULL, in one K1 range-mode compaction."""

    def op(page: Page, lo, hi) -> Page:
        return compact_range(page, probe_key, lo, hi)
    return op


# ------------------------------------------------------------------ K6


def unique_probe_plain(pcols, bcols, num_rows: torch.Tensor,
                       prepared: Prepared):
    """Plain twin of K6: (found bool[cap], brow int64[cap], count int64)."""
    cap = pcols[0][0].shape[0]
    dev = num_rows.device
    live = torch.arange(cap, device=dev, dtype=torch.int32) < num_rows
    key, null = _key_cols(pcols)
    ok = live & ~null
    if prepared.dense is not None:
        size = prepared.dense.shape[0]
        raw = key - prepared.stats[KMIN]
        inb = (raw >= 0) & (raw < size)
        row = prepared.dense[raw.clamp(0, max(size - 1, 0))]
        found = ok & inb & (row != _I32_MAX)
        brow = row.to(torch.int64)
    else:
        _, skeys, srows = prepared.lookup
        n = skeys.numel()
        if n == 0:
            found = torch.zeros(cap, dtype=torch.bool, device=dev)
            brow = torch.zeros(cap, dtype=torch.int64, device=dev)
        else:
            pos = torch.searchsorted(skeys ^ _I64_MIN, key ^ _I64_MIN)
            posc = pos.clamp(max=n - 1)
            found = ok & (pos < n) & (skeys[posc] == key)
            brow = srows[posc]
    if len(pcols) > 1:     # a mixed composite key: check each column
        for (pv, _), (bv, _) in zip(pcols, bcols):
            cand = bv[brow.clamp(0, max(bv.shape[0] - 1, 0))] \
                if bv.shape[0] else torch.zeros_like(pv)
            found = found & (pv == cand)
    brow = torch.where(found, brow, torch.zeros_like(brow))
    return found, brow, found.sum(dtype=torch.int64)


def unique_probe_cuda(pcols, bcols, num_rows: torch.Tensor,
                      prepared: Prepared):
    """K6 launch: see csrc/join_probe.cu."""
    cap = pcols[0][0].shape[0]
    dev = num_rows.device
    _check_key_cols(pcols, cap, dev)
    _check_key_cols(bcols, bcols[0][0].shape[0], dev)
    if num_rows.dtype != torch.int32 or num_rows.dim() != 0:
        raise ValueError("num_rows must be a 0-d int32 tensor")
    found = torch.empty(cap, dtype=torch.bool, device=dev)
    brow = torch.empty(cap, dtype=torch.int64, device=dev)
    count = torch.empty((), dtype=torch.int64, device=dev)
    if prepared.dense is not None:
        dense, size = prepared.dense, prepared.dense.shape[0]
        slot_keys = slot_rows = dense
        slots = 1
    else:
        if prepared.lookup[0] != "hash":
            raise ValueError("K6 needs the hash table K5 built on the card")
        _, slot_keys, slot_rows, _ = prepared.lookup
        dense, size, slots = slot_rows, 0, slot_rows.shape[0]
    lib = native.library("join_probe")
    rc = lib.join_probe(
        host_table(_key_table(pcols), _key_table(bcols)),
        ctypes.c_int64(len(pcols)), ctypes.c_int64(cap),
        ctypes.c_void_p(num_rows.data_ptr()),
        ctypes.c_int64(int(prepared.dense is not None)),
        ctypes.c_void_p(dense.data_ptr()), ctypes.c_int64(size),
        ctypes.c_void_p(prepared.stats.data_ptr()),
        ctypes.c_void_p(slot_keys.data_ptr()),
        ctypes.c_void_p(slot_rows.data_ptr()), ctypes.c_int64(slots),
        ctypes.c_void_p(found.data_ptr()),
        ctypes.c_void_p(brow.data_ptr()), ctypes.c_void_p(count.data_ptr()),
        ctypes.c_void_p(native.stream_ptr(dev)))
    native.check(rc, "join_probe")
    unique_probe_cuda.launches += 1
    return found, brow, count


unique_probe_cuda.launches = 0


def unique_probe(pcols, bcols, num_rows, prepared):
    """K6 wrapper: plain twin on the CPU, kernel on CUDA."""
    run = unique_probe_cuda if num_rows.is_cuda else unique_probe_plain
    return run(pcols, bcols, num_rows, prepared)


def _check_dictionaries(probe: Page, build: Page, probe_keys, build_keys):
    for pk, bk in zip(probe_keys, build_keys):
        pd = probe.column(pk).dictionary
        bd = build.column(bk).dictionary
        if pd is not None and bd is not None and pd != bd:
            raise NotImplementedError(
                "string join keys across distinct dictionaries; "
                "re-encode to a shared dictionary first")


def unique_inner_probe(
    probe_keys: Sequence[int],
    build_keys: Sequence[int],
    lookup: str = "search",
    probe_out: Optional[Sequence[int]] = None,
) -> Callable[[Page, Prepared], Tuple[Page, torch.Tensor, torch.Tensor]]:
    """INNER-join probe against a UNIQUE build side (max_run == 1), K6.

    Returns (pre_page, found, match_count): pre_page is the probe columns
    (probe_out, default all) ++ a BIGINT `brow` channel in probe order,
    0 where no row matched. `lookup` names the route the Prepared was built
    for ('dense' carries its table; 'search' uses the hash table)."""
    probe_keys = tuple(probe_keys)
    build_keys = tuple(build_keys)

    def op(probe: Page, prepared: Prepared):
        if (lookup == "dense") != (prepared.dense is not None):
            raise ValueError(f"lookup {lookup!r} does not match the "
                             "prepared build")
        _check_dictionaries(probe, prepared.build, probe_keys, build_keys)
        found, brow, count = unique_probe(
            _page_key_cols(probe, probe_keys),
            _page_key_cols(prepared.build, build_keys), probe.num_rows,
            prepared)
        brow_col = Column(brow, None, T.BIGINT, None)
        p_idx = range(probe.num_columns) if probe_out is None else probe_out
        pre = Page(tuple(probe.columns[i] for i in p_idx) + (brow_col,),
                   probe.num_rows)
        return pre, found, count

    return op


def attach_build(n_probe_cols: int,
                 build_out: Optional[Sequence[int]] = None
                 ) -> Callable[[Page, Prepared], Page]:
    """Second phase of the unique-build path: the emitted build columns
    gathered at the (compacted) brow channel in one K7 launch, after the
    probe columns."""

    def op(pre: Page, prepared: Prepared) -> Page:
        build = prepared.build
        brow = pre.columns[n_probe_cols].values
        b_idx = range(build.num_columns) if build_out is None else build_out
        cols = [build.columns[i] for i in b_idx]
        moved = gather_rows([a for c in cols for a in _movable(c)], brow)
        return Page(tuple(pre.columns[:n_probe_cols])
                    + _rebuild(cols, moved), pre.num_rows)

    return op




# ------------------------------------------------------- K5 runs mode


def join_runs_plain(cols, num_rows: torch.Tensor, stats: torch.Tensor,
                    lookup: tuple, size: int):
    """Plain twin of K5's runs mode: ((runs int32[cap], starts int32[u],
    counts int32[u]), dense int32[size] or None). The live non-NULL rows
    in unsigned key order, each key's rows ascending (one stable sort);
    slot u is the u-th distinct key, as in the twin's sorted lookup; the
    dense table maps key kmin + d to its slot, INT32_MAX where absent."""
    cap = cols[0][0].shape[0]
    dev = num_rows.device
    live = torch.arange(cap, device=dev, dtype=torch.int32) < num_rows
    key, null = _key_cols(cols)
    ok = live & ~null
    keys = key[ok]
    order = torch.sort(keys ^ _I64_MIN, stable=True).indices
    runs = torch.zeros(cap, dtype=torch.int32, device=dev)
    runs[:order.numel()] = torch.nonzero(ok).flatten()[order].to(
        torch.int32)
    _, skeys, _ = lookup
    if keys.numel():
        _, counts = torch.unique_consecutive(keys[order],
                                             return_counts=True)
    else:
        counts = torch.zeros(0, dtype=torch.int64, device=dev)
    starts = torch.cumsum(counts, 0) - counts
    dense = None
    if size:
        raw = skeys - stats[KMIN]
        inb = (raw >= 0) & (raw < size)
        dense = torch.full((size + 1,), _I32_MAX, dtype=torch.int32,
                           device=dev)
        dense[torch.where(inb, raw, torch.full_like(raw, size))] = \
            torch.arange(skeys.numel(), dtype=torch.int32, device=dev)
        dense = dense[:size]
    return (runs, starts.to(torch.int32), counts.to(torch.int32)), dense


def join_runs_cuda(cols, num_rows: torch.Tensor, stats: torch.Tensor,
                   lookup: tuple, size: int):
    """K5 runs-mode launch: see csrc/join_build.cu join_runs. Returns
    ((runs, slot_start, slot_counts), dense slot table or None)."""
    cap = cols[0][0].shape[0]
    dev = num_rows.device
    _check_key_cols(cols, cap, dev)
    if lookup[0] != "hash":
        raise ValueError("K5 runs mode needs the hash table K5 built on "
                         "the card")
    _, slot_keys, slot_rows, slot_counts = lookup
    slots = slot_rows.shape[0]
    slot_start = torch.empty(slots, dtype=torch.int32, device=dev)
    cursor = torch.empty(slots, dtype=torch.int32, device=dev)
    placed = torch.empty(max(cap, 1), dtype=torch.int32, device=dev)
    runs = torch.empty(max(cap, 1), dtype=torch.int32, device=dev)
    scratch = torch.empty(-(-slots // 4096), dtype=torch.int64, device=dev)
    total = torch.empty((), dtype=torch.int32, device=dev)
    dense = torch.empty(max(size, 1), dtype=torch.int32, device=dev)
    lib = native.library("join_build")
    rc = lib.join_runs(
        host_table(_key_table(cols)), ctypes.c_int64(len(cols)),
        ctypes.c_int64(cap), ctypes.c_void_p(num_rows.data_ptr()),
        ctypes.c_void_p(stats.data_ptr()),
        ctypes.c_void_p(slot_keys.data_ptr()),
        ctypes.c_void_p(slot_rows.data_ptr()),
        ctypes.c_void_p(slot_counts.data_ptr()), ctypes.c_int64(slots),
        ctypes.c_void_p(slot_start.data_ptr()),
        ctypes.c_void_p(cursor.data_ptr()),
        ctypes.c_void_p(placed.data_ptr()),
        ctypes.c_void_p(scratch.data_ptr()),
        ctypes.c_void_p(total.data_ptr()), ctypes.c_void_p(runs.data_ptr()),
        ctypes.c_void_p(dense.data_ptr()), ctypes.c_int64(size),
        ctypes.c_void_p(native.stream_ptr(dev)))
    native.check(rc, "join_runs")
    join_runs_cuda.launches += 1
    return (runs, slot_start, slot_counts), (dense if size else None)


join_runs_cuda.launches = 0


def join_runs(cols, num_rows, stats, lookup, size):
    """K5 runs-mode wrapper: plain twin on the CPU, kernel on CUDA."""
    run = join_runs_cuda if num_rows.is_cuda else join_runs_plain
    return run(cols, num_rows, stats, lookup, size)


def prepare_runs(size: int = 0) -> Callable[[Prepared], Prepared]:
    """The expanding probe's build side (K5 runs mode) over a Prepared from
    prepare_build; `size` > 0 adds the dense route's table of slots."""

    def op(prepared: Prepared) -> Prepared:
        runs, dense = join_runs(
            _page_key_cols(prepared.build, prepared.keys),
            prepared.build.num_rows, prepared.stats, prepared.lookup, size)
        return dataclasses.replace(prepared, runs=runs, dense=dense)
    return op


# ------------------------------------------------------------------ K9

# csrc/join_expand.cu enum Kind
JOIN_KIND_CODE = {JoinType.INNER: 0, JoinType.LEFT: 1, JoinType.FULL: 2,
                  JoinType.SEMI: 3, JoinType.ANTI: 4, JoinType.MARK: 5}
_PRESERVING = (JoinType.LEFT, JoinType.FULL)


@dataclasses.dataclass
class Counted:
    """Launch A of the expanding probe for one probe page: per probe row
    its run (start, length) and its output rows `emit`, the int64 `total`
    on the device and, from the kernel, each tile's first output row."""

    probe: Page
    prepared: Prepared
    cand_start: torch.Tensor
    cand_len: torch.Tensor
    emit: torch.Tensor
    total: torch.Tensor
    offsets: Optional[torch.Tensor] = None


def _runs_of(pcols, num_rows: torch.Tensor, prepared: Prepared):
    """Twin lookup: (start, length) of each probe row's run (0, 0 for a
    dead row, a NULL key or a key the build lacks)."""
    cap = pcols[0][0].shape[0]
    dev = num_rows.device
    live = torch.arange(cap, device=dev, dtype=torch.int32) < num_rows
    key, null = _key_cols(pcols)
    ok = live & ~null
    _, starts, counts = prepared.runs
    nu = counts.numel()
    if prepared.dense is not None:
        size = prepared.dense.shape[0]
        raw = key - prepared.stats[KMIN]
        inb = (raw >= 0) & (raw < size)
        u = prepared.dense[raw.clamp(0, max(size - 1, 0))].to(torch.int64)
        found = ok & inb & (u != _I32_MAX)
    elif nu:
        skeys = prepared.lookup[1]
        u = torch.searchsorted(skeys ^ _I64_MIN, key ^ _I64_MIN)
        found = ok & (u < nu) & (skeys[u.clamp(max=nu - 1)] == key)
    else:
        u = torch.zeros(cap, dtype=torch.int64, device=dev)
        found = torch.zeros(cap, dtype=torch.bool, device=dev)
    u = torch.where(found, u, torch.zeros_like(u)).clamp(max=max(nu - 1, 0))
    zero = torch.zeros(cap, dtype=torch.int32, device=dev)
    if not nu:
        return zero, zero
    return (torch.where(found, starts[u], zero),
            torch.where(found, counts[u], zero))


def _candidates(pcols, bcols, runs, start, length):
    """Twin expansion of the runs: (probe row, build row, verified) per
    candidate, in probe-row order and run order; `verified` compares every
    key column (a composite key's mixed word can collide)."""
    cap = start.shape[0]
    dev = start.device
    length = length.to(torch.int64)
    prow = torch.repeat_interleave(torch.arange(cap, device=dev), length)
    first = torch.cumsum(length, 0) - length
    within = torch.arange(prow.numel(), device=dev) - first[prow]
    brow = runs[(start.to(torch.int64)[prow] + within)].to(torch.int64) \
        if prow.numel() else prow
    ok = torch.ones(prow.numel(), dtype=torch.bool, device=dev)
    if len(pcols) > 1:
        for (pv, _), (bv, _) in zip(pcols, bcols):
            ok = ok & (pv[prow] == bv[brow])
    return prow, brow, ok


def expand_count_plain(pcols, bcols, num_rows: torch.Tensor,
                       prepared: Prepared, kind: str) -> Counted:
    """Plain twin of K9 launch A."""
    cap = pcols[0][0].shape[0]
    dev = num_rows.device
    start, length = _runs_of(pcols, num_rows, prepared)
    emit = length
    if len(pcols) > 1:
        prow, _, ok = _candidates(pcols, bcols, prepared.runs[0], start,
                                  length)
        emit = torch.bincount(prow[ok], minlength=cap).to(torch.int32)
    if kind in _PRESERVING:
        live = torch.arange(cap, device=dev, dtype=torch.int32) < num_rows
        emit = torch.where(live, emit.clamp(min=1), torch.zeros_like(emit))
    return Counted(None, prepared, start, length, emit,
                   emit.sum(dtype=torch.int64))


def _check_runs(prepared: Prepared, dev) -> None:
    if prepared.runs is None or prepared.lookup[0] != "hash" \
            or prepared.stats.device != dev:
        raise ValueError("K9 needs K5's hash table and runs built on the "
                         "card (prepare_build, prepare_runs)")


def _runs_args(prepared: Prepared) -> list:
    """The lookup arguments K9's launchers share (csrc/join_expand.cu)."""
    _, slot_keys, slot_rows, _ = prepared.lookup
    runs, slot_start, slot_counts = prepared.runs
    dense = prepared.dense if prepared.dense is not None else slot_rows
    return [ctypes.c_int64(int(prepared.dense is not None)),
            ctypes.c_void_p(dense.data_ptr()),
            ctypes.c_int64(0 if prepared.dense is None
                           else prepared.dense.shape[0]),
            ctypes.c_void_p(prepared.stats.data_ptr()),
            ctypes.c_void_p(slot_keys.data_ptr()),
            ctypes.c_void_p(slot_rows.data_ptr()),
            ctypes.c_int64(slot_rows.shape[0]),
            ctypes.c_void_p(slot_start.data_ptr()),
            ctypes.c_void_p(slot_counts.data_ptr()),
            ctypes.c_void_p(runs.data_ptr())]


def _check_probe(pcols, bcols, num_rows: torch.Tensor, dev) -> int:
    cap = pcols[0][0].shape[0]
    _check_key_cols(pcols, cap, dev)
    _check_key_cols(bcols, bcols[0][0].shape[0], dev)
    if num_rows.dtype != torch.int32 or num_rows.dim() != 0 \
            or num_rows.device != dev:
        raise ValueError("num_rows must be a 0-d int32 tensor")
    return cap


def expand_count_cuda(pcols, bcols, num_rows: torch.Tensor,
                      prepared: Prepared, kind: str) -> Counted:
    """K9 launch A: see csrc/join_expand.cu expand_count."""
    dev = num_rows.device
    cap = _check_probe(pcols, bcols, num_rows, dev)
    _check_runs(prepared, dev)
    cand_start = torch.empty(cap, dtype=torch.int32, device=dev)
    cand_len = torch.empty(cap, dtype=torch.int32, device=dev)
    emit = torch.empty(cap, dtype=torch.int32, device=dev)
    offsets = torch.empty(max(-(-cap // 4096), 1), dtype=torch.int64,
                          device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    lib = native.library("join_expand")
    rc = lib.expand_count(
        host_table(_key_table(pcols), _key_table(bcols)),
        ctypes.c_int64(len(pcols)), ctypes.c_int64(cap),
        ctypes.c_void_p(num_rows.data_ptr()),
        ctypes.c_int64(JOIN_KIND_CODE[kind]), *_runs_args(prepared),
        ctypes.c_void_p(cand_start.data_ptr()),
        ctypes.c_void_p(cand_len.data_ptr()),
        ctypes.c_void_p(emit.data_ptr()), ctypes.c_void_p(offsets.data_ptr()),
        ctypes.c_void_p(total.data_ptr()),
        ctypes.c_void_p(native.stream_ptr(dev)))
    native.check(rc, "expand_count")
    expand_count_cuda.launches += 1
    expand_count_cuda.by_kind[kind] = \
        expand_count_cuda.by_kind.get(kind, 0) + 1
    return Counted(None, prepared, cand_start, cand_len, emit, total, offsets)


expand_count_cuda.launches = 0
expand_count_cuda.by_kind = {}


def expand_count(pcols, bcols, num_rows, prepared, kind) -> Counted:
    """K9 launch-A wrapper: plain twin on the CPU, kernel on CUDA."""
    run = expand_count_cuda if num_rows.is_cuda else expand_count_plain
    return run(pcols, bcols, num_rows, prepared, kind)


def expand_write_plain(pcols, bcols, counted: Counted, kind: str,
                       out_cap: int, build_matched=None):
    """Plain twin of K9 launch B: (prow int64[out_cap], brow int64[out_cap]
    with -1 on a null-extended row); FULL sets build_matched (bool per
    build row) where a verified match hit the row."""
    dev = counted.emit.device
    prow, brow, ok = _candidates(pcols, bcols, counted.prepared.runs[0],
                                 counted.cand_start, counted.cand_len)
    prow, brow = prow[ok], brow[ok]
    if kind == JoinType.FULL and build_matched is not None:
        build_matched[brow] = True
    if kind in _PRESERVING:
        cap = counted.emit.shape[0]
        alone = (counted.emit > 0) & (torch.bincount(
            prow, minlength=cap) == 0)
        extra = torch.nonzero(alone).flatten()
        order = torch.sort(torch.cat([prow, extra]), stable=True).indices
        prow = torch.cat([prow, extra])[order]
        brow = torch.cat([brow, torch.full_like(extra, -1)])[order]
    out_p = torch.zeros(out_cap, dtype=torch.int64, device=dev)
    out_b = torch.zeros(out_cap, dtype=torch.int64, device=dev)
    k = min(prow.numel(), out_cap)
    out_p[:k], out_b[:k] = prow[:k], brow[:k]
    return out_p, out_b


def expand_write_cuda(pcols, bcols, counted: Counted, kind: str,
                      out_cap: int, build_matched=None):
    """K9 launch B: see csrc/join_expand.cu expand_write."""
    dev = counted.emit.device
    cap = counted.emit.shape[0]
    _check_key_cols(pcols, cap, dev)
    bcap = bcols[0][0].shape[0]
    _check_key_cols(bcols, bcap, dev)
    if counted.offsets is None:
        raise ValueError("K9 launch B needs launch A's kernel result")
    if kind == JoinType.FULL and (
            build_matched is None or build_matched.dtype != torch.bool
            or build_matched.shape != (bcap,)
            or build_matched.device != dev):
        raise ValueError("a FULL join needs a bool build_matched per build "
                         "row on the device")
    prow = torch.empty(max(out_cap, 1), dtype=torch.int64, device=dev)
    brow = torch.empty(max(out_cap, 1), dtype=torch.int64, device=dev)
    lib = native.library("join_expand")
    rc = lib.expand_write(
        host_table(_key_table(pcols), _key_table(bcols)),
        ctypes.c_int64(len(pcols)), ctypes.c_int64(cap),
        ctypes.c_int64(JOIN_KIND_CODE[kind]),
        ctypes.c_void_p(counted.prepared.runs[0].data_ptr()),
        ctypes.c_void_p(counted.cand_start.data_ptr()),
        ctypes.c_void_p(counted.cand_len.data_ptr()),
        ctypes.c_void_p(counted.emit.data_ptr()),
        ctypes.c_void_p(counted.offsets.data_ptr()), ctypes.c_int64(out_cap),
        ctypes.c_void_p(prow.data_ptr()), ctypes.c_void_p(brow.data_ptr()),
        ctypes.c_void_p(0 if kind != JoinType.FULL
                        else build_matched.data_ptr()),
        ctypes.c_void_p(native.stream_ptr(dev)))
    native.check(rc, "expand_write")
    expand_write_cuda.launches += 1
    return prow[:out_cap], brow[:out_cap]


expand_write_cuda.launches = 0


def expand_write(pcols, bcols, counted, kind, out_cap, build_matched=None):
    """K9 launch-B wrapper: plain twin on the CPU, kernel on CUDA."""
    run = expand_write_cuda if counted.emit.is_cuda else expand_write_plain
    return run(pcols, bcols, counted, kind, out_cap, build_matched)


def probe_verdict_plain(pcols, bcols, num_rows: torch.Tensor,
                        prepared: Prepared, kind: str, null_aware: bool):
    """Plain twin of K9's SEMI/ANTI/MARK launch: (flag bool[cap], flag2
    bool[cap] for MARK, else None), the reference's formulas."""
    cap = pcols[0][0].shape[0]
    dev = num_rows.device
    live = torch.arange(cap, device=dev, dtype=torch.int32) < num_rows
    _, pnull = _key_cols(pcols)
    start, length = _runs_of(pcols, num_rows, prepared)
    matched = length > 0
    if len(pcols) > 1:
        prow, _, ok = _candidates(pcols, bcols, prepared.runs[0], start,
                                  length)
        matched = torch.bincount(prow[ok], minlength=cap) > 0
    empty = prepared.stats[N_ROWS] == 0
    build_null = prepared.stats[HAS_NULL] != 0
    if kind == JoinType.SEMI:
        return matched, None
    if kind == JoinType.ANTI:
        if null_aware:
            return live & torch.where(pnull, empty,
                                      ~matched & ~build_null), None
        return live & ~matched, None
    return matched, matched | torch.where(pnull, empty, ~build_null)


def probe_verdict_cuda(pcols, bcols, num_rows: torch.Tensor,
                       prepared: Prepared, kind: str, null_aware: bool):
    """K9 SEMI/ANTI/MARK launch: see csrc/join_expand.cu probe_verdict."""
    dev = num_rows.device
    cap = _check_probe(pcols, bcols, num_rows, dev)
    _check_runs(prepared, dev)
    flag = torch.empty(cap, dtype=torch.bool, device=dev)
    flag2 = torch.empty(cap, dtype=torch.bool, device=dev) \
        if kind == JoinType.MARK else None
    lib = native.library("join_expand")
    rc = lib.probe_verdict(
        host_table(_key_table(pcols), _key_table(bcols)),
        ctypes.c_int64(len(pcols)), ctypes.c_int64(cap),
        ctypes.c_void_p(num_rows.data_ptr()),
        ctypes.c_int64(JOIN_KIND_CODE[kind]),
        ctypes.c_int64(int(null_aware)), *_runs_args(prepared),
        ctypes.c_void_p(flag.data_ptr()),
        ctypes.c_void_p(0 if flag2 is None else flag2.data_ptr()),
        ctypes.c_void_p(native.stream_ptr(dev)))
    native.check(rc, "probe_verdict")
    probe_verdict_cuda.launches += 1
    probe_verdict_cuda.by_kind[kind] = \
        probe_verdict_cuda.by_kind.get(kind, 0) + 1
    return flag, flag2


probe_verdict_cuda.launches = 0
probe_verdict_cuda.by_kind = {}


def probe_verdict(pcols, bcols, num_rows, prepared, kind, null_aware):
    """K9 SEMI/ANTI/MARK wrapper: plain twin on the CPU, kernel on CUDA."""
    run = probe_verdict_cuda if num_rows.is_cuda else probe_verdict_plain
    return run(pcols, bcols, num_rows, prepared, kind, null_aware)


def _mark_column(flag: torch.Tensor, flag2: Optional[torch.Tensor],
                 null_aware: bool) -> Column:
    """The semi-join verdict as a BOOLEAN channel (the reference's
    _mark_page): IN's three values when null-aware, else EXISTS's two."""
    return Column(flag, flag2 if null_aware else None, T.BOOLEAN, None)


class HashJoin:
    """The expanding probe (reference: hash_join) of one join shape over a
    Prepared build side with runs (prepare_build, then prepare_runs).

    Output layout: probe columns (`probe_out`, default all) ++ build
    columns (`build_out`, default all); SEMI/ANTI emit the probe columns
    only and MARK adds a BOOLEAN channel. The executor runs `count` (K9
    launch A) on every page of a batch, reads the totals in one host read,
    and then `emit` (launch B and the K7 gathers) at a capacity of its
    choice; `verdict` answers SEMI/ANTI/MARK in one launch. Calling the
    object does both for one page, as the reference's op does: (page,
    total), plus the build_matched mask for FULL."""

    def __init__(self, probe_keys, build_keys, join_type, null_aware,
                 lookup, probe_out, build_out):
        if lookup not in ("search", "dense"):
            raise NotImplementedError(
                f"join lookup {lookup!r}: the matrix-unit probe is ROADMAP "
                "B11")
        self.probe_keys = tuple(probe_keys)
        self.build_keys = tuple(build_keys)
        self.join_type = join_type
        self.null_aware = null_aware
        self.lookup = lookup
        self.probe_out = probe_out
        self.build_out = build_out

    def _cols(self, probe: Page, prepared: Prepared):
        if (self.lookup == "dense") != (prepared.dense is not None):
            raise ValueError(f"lookup {self.lookup!r} does not match the "
                             "prepared build")
        _check_dictionaries(probe, prepared.build, self.probe_keys,
                            self.build_keys)
        return (_page_key_cols(probe, self.probe_keys),
                _page_key_cols(prepared.build, self.build_keys))

    def count(self, probe: Page, prepared: Prepared) -> Counted:
        pcols, bcols = self._cols(probe, prepared)
        counted = expand_count(pcols, bcols, probe.num_rows, prepared,
                               self.join_type)
        counted.probe = probe
        return counted

    def emit(self, counted: Counted, out_cap: int,
             build_matched: Optional[torch.Tensor] = None) -> Page:
        probe, build = counted.probe, counted.prepared.build
        pcols, bcols = self._cols(probe, counted.prepared)
        prow, brow = expand_write(pcols, bcols, counted, self.join_type,
                                  out_cap, build_matched)
        p_idx = range(probe.num_columns) if self.probe_out is None \
            else self.probe_out
        b_idx = range(build.num_columns) if self.build_out is None \
            else self.build_out
        pc = [probe.columns[i] for i in p_idx]
        bc = [build.columns[i] for i in b_idx]
        out = _rebuild(pc, gather_rows([a for c in pc for a in _movable(c)],
                                       prow))
        moved = _rebuild(bc, gather_rows([a for c in bc for a in _movable(c)],
                                         brow))
        if self.join_type in _PRESERVING:
            ext = brow >= 0
            moved = tuple(Column(c.values, ext if c.valid is None
                                 else c.valid & ext, c.type, c.dictionary)
                          for c in moved)
        rows = counted.total.clamp(max=out_cap).to(torch.int32)
        return Page(out + moved, rows)

    def verdict(self, probe: Page, prepared: Prepared) -> Page:
        pcols, bcols = self._cols(probe, prepared)
        flag, flag2 = probe_verdict(pcols, bcols, probe.num_rows, prepared,
                                    self.join_type, self.null_aware)
        if self.join_type == JoinType.MARK:
            return Page(probe.columns + (_mark_column(
                flag, flag2, self.null_aware),), probe.num_rows)
        return probe.filter(flag)

    def __call__(self, probe: Page, prepared: Prepared,
                 output_capacity: Optional[int] = None):
        if self.join_type in (JoinType.SEMI, JoinType.ANTI, JoinType.MARK):
            out = self.verdict(probe, prepared)
            return out, out.num_rows.to(torch.int64)
        counted = self.count(probe, prepared)
        cap = output_capacity or max(int(counted.total), 1)
        if self.join_type != JoinType.FULL:
            return self.emit(counted, cap), counted.total
        matched = torch.zeros(prepared.build.capacity, dtype=torch.bool,
                              device=prepared.build.device)
        return self.emit(counted, cap, matched), counted.total, matched


def hash_join(probe_keys: Sequence[int], build_keys: Sequence[int],
              join_type: str = JoinType.INNER, null_aware: bool = True,
              lookup: str = "search",
              probe_out: Optional[Sequence[int]] = None,
              build_out: Optional[Sequence[int]] = None) -> HashJoin:
    """The expanding probe for every join kind: INNER (duplicate build
    keys), LEFT, FULL, SEMI, ANTI and MARK. `null_aware` picks IN's
    semantics for SEMI/ANTI/MARK (a NULL probe key or a NULL in a non-
    empty build makes membership UNKNOWN) over EXISTS's (NULL keys never
    match); see the reference's hash_join for the full statement."""
    return HashJoin(probe_keys, build_keys, join_type, null_aware, lookup,
                    probe_out, build_out)


def unmatched_build_page(probe_meta: Sequence[Tuple[T.Type, object]]
                         ) -> Callable[[Page, torch.Tensor], Page]:
    """FULL-join finisher (the reference's unmatched_build_page): the live
    build rows no probe row matched (K1 over ~matched), null-extended on
    the probe side; `probe_meta` is (type, dictionary) per probe column so
    the NULL columns keep the stream's dictionaries."""
    probe_meta = tuple(probe_meta)

    def op(build: Page, matched: torch.Tensor) -> Page:
        kept = build.filter(~matched)
        cap, dev = kept.capacity, kept.device
        pcols = tuple(Column(torch.zeros(cap, dtype=t.dtype, device=dev),
                             torch.zeros(cap, dtype=torch.bool, device=dev),
                             t, d) for t, d in probe_meta)
        return Page(pcols + kept.columns, kept.num_rows)
    return op
