"""The list layouts' kernels: K33 (the collecting aggregates' pack) and
K34 (the UNNEST expansion), each beside its plain PyTorch twin.

Port of the list parts of `trino_tpu/ops/aggregate.py` (group_max_size,
_collect_grouped) and `trino_tpu/exec/local_planner.py`
(_exec_UnnestNode's count and expand ops). See csrc/list.cu for the
kernels' design. Every K33 function reads K28's row -> group map (`gid`,
int32 [cap]) and the group count (`num_groups`, a 0-d int32 tensor), and
a row takes part when it is below `num_rows` and every mask holds.

* K33 size mode `collect_sizes`: (largest live group, groups), int64 [2];
* K33 array mode `collect_array` (array_agg): plane [rows, L] and lengths
  [rows], each group's eligible values in row order;
* K33 map mode `collect_map` (histogram, map_agg): keys [rows, L], values
  [rows, L] and lengths [rows], one entry per distinct key (NaN as +inf,
  +-0.0 one key) in ascending key order; `map_plan` says what the host
  knows before the launches (the direct-address route when a dictionary's
  size bounds the span) and `map_launch_model` models them;
* K34 `unnest_count` / `unnest_expand`: the output slots of a page's list
  column, and each slot's source row, ordinal and element.

`rows` is the output's row count (at least the group count): the
aggregation passes the next power of two above the group count, where
the reference sizes a collect output at the page's capacity.

A wrapper takes its plain twin only for tensors on the CPU; on a CUDA
tensor it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from trino_tpu_torch import native
from trino_tpu_torch.ops.sort import (radix_into, radix_replay_plain,
                                      radix_scratch_sizes, radix_sort_words)
from trino_tpu_torch.page import COMPACT_TILE, host_table

_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1
_I32_MAX = (1 << 31) - 1
MAX_MASKS = 6


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _live(num_rows: torch.Tensor, cap: int) -> torch.Tensor:
    return torch.arange(cap, dtype=torch.int32,
                        device=num_rows.device) < num_rows


def _eligible(masks: Sequence[torch.Tensor], num_rows: torch.Tensor,
              cap: int) -> torch.Tensor:
    elig = _live(num_rows, cap)
    for m in masks:
        elig = elig & m
    return elig


def element_key(x: torch.Tensor) -> torch.Tensor:
    """The order key K33's map mode sorts and compares: an integer as
    itself; a float with NaN as +inf and -0.0 as +0.0 (the reference's
    _nan_as_largest, and its `!=`, under which +-0.0 are one key) as an
    order-preserving int64."""
    if not x.is_floating_point():
        return x.to(torch.int64)
    v = x.to(torch.float64)
    v = torch.where(torch.isnan(v), float("inf"), v)
    b = torch.where(v == 0, 0.0, v).view(torch.int64)
    return torch.where(b >= 0, b, b ^ _I64_MAX)


def _nan_as_inf(x: torch.Tensor) -> torch.Tensor:
    if not x.is_floating_point():
        return x
    return torch.where(torch.isnan(x), torch.full_like(x, float("inf")), x)


def _check(cols, masks, cap: int, dev) -> List[int]:
    for c in cols:
        if c is not None and (c.device != dev or c.shape != (cap,)
                              or not c.is_contiguous()
                              or c.element_size() not in (1, 2, 4, 8)):
            raise ValueError("list kernel inputs must be contiguous [cap] "
                             "tensors on the device")
    if len(masks) > MAX_MASKS:
        raise ValueError(f"at most {MAX_MASKS} masks")
    for m in masks:
        if m.device != dev or m.dtype != torch.bool or m.shape != (cap,) \
                or not m.is_contiguous():
            raise ValueError("masks must be contiguous bool [cap] on the "
                             "device")
    return [m.data_ptr() for m in masks]


def _check_scalars(dev, *scalars) -> None:
    for s in scalars:
        if s.dtype != torch.int32 or s.dim() != 0 or s.device != dev:
            raise ValueError("counts must be 0-d int32 tensors on the "
                             "device")


# ------------------------------------------------------ K33 size mode


def collect_sizes_plain(gid: torch.Tensor, num_rows: torch.Tensor,
                        num_groups: torch.Tensor) -> torch.Tensor:
    """Plain twin of K33's size mode (group_max_size): int64 [2] = (the
    largest live group's row count, the group count)."""
    cap = gid.shape[0]
    g = gid.to(torch.int64)[_live(num_rows, cap)]
    G = int(num_groups)
    counts = torch.bincount(g, minlength=G) if g.numel() else \
        torch.zeros(1, dtype=torch.int64, device=gid.device)
    return torch.stack([counts.max(), torch.tensor(
        G, dtype=torch.int64, device=gid.device)])


def collect_sizes_cuda(gid: torch.Tensor, num_rows: torch.Tensor,
                       num_groups: torch.Tensor) -> torch.Tensor:
    """K33 size-mode launch: see csrc/list.cu collect_sizes."""
    cap = gid.shape[0]
    dev = gid.device
    _check([gid], [], cap, dev)
    _check_scalars(dev, num_rows, num_groups)
    counts = torch.empty(cap + 1, dtype=torch.int32, device=dev)
    out = torch.empty(2, dtype=torch.int64, device=dev)
    rc = native.library("list").collect_sizes(
        ctypes.c_void_p(gid.data_ptr()), ctypes.c_int64(cap),
        ctypes.c_void_p(num_rows.data_ptr()),
        ctypes.c_void_p(num_groups.data_ptr()),
        ctypes.c_void_p(counts.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(native.stream_ptr(dev)))
    native.check(rc, "collect_sizes")
    collect_sizes_cuda.launches += 1
    return out


collect_sizes_cuda.launches = 0


def collect_sizes(gid, num_rows, num_groups):
    """K33 size-mode wrapper: plain twin on the CPU, kernel on CUDA."""
    run = collect_sizes_cuda if gid.is_cuda else collect_sizes_plain
    return run(gid, num_rows, num_groups)


# ----------------------------------------------- K33 array and map modes


def _sorted_eligible(gid, masks, num_rows, key=None):
    """The eligible rows in (group, key) order, row order within ties:
    (rows, groups), int64."""
    cap = gid.shape[0]
    r = torch.nonzero(_eligible(masks, num_rows, cap)).flatten()
    if key is not None:
        r = r[torch.sort(key[r], stable=True).indices]
    g = gid.to(torch.int64)[r]
    order = torch.sort(g, stable=True).indices
    return r[order], g[order]


def _first_of_group(g_s: torch.Tensor, rows: int) -> torch.Tensor:
    pos = torch.arange(g_s.shape[0], dtype=torch.int64, device=g_s.device)
    return torch.full((rows + 1,), g_s.shape[0], dtype=torch.int64,
                      device=g_s.device).scatter_reduce(0, g_s, pos, "amin")


def collect_array_plain(x: torch.Tensor, masks, num_rows: torch.Tensor,
                        gid: torch.Tensor, num_groups: torch.Tensor, L: int,
                        rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K33's array mode (_collect_grouped, array_agg): each
    group's eligible values in row order, the first L of them, at the
    group's row of plane [rows, L] (zeros past them); lengths [rows]."""
    dev = x.device
    r_s, g_s = _sorted_eligible(gid, masks, num_rows)
    plane = torch.zeros((rows, L), dtype=x.dtype, device=dev)
    lengths = torch.zeros(rows, dtype=torch.int32, device=dev)
    if not r_s.numel():
        return plane, lengths
    ordinal = torch.arange(r_s.shape[0], device=dev) \
        - _first_of_group(g_s, rows)[g_s]
    ok = ordinal < L
    plane[g_s[ok], ordinal[ok]] = x[r_s[ok]]
    lengths[:] = torch.bincount(g_s, minlength=rows)[:rows].clamp(max=L) \
        .to(torch.int32)
    return plane, lengths


def _array_passes(rows: int) -> List[Tuple[int, int]]:
    """K10's digit passes of array mode's word, least significant first:
    the flag byte and the bytes a group id below rows uses (rows is at
    least the group count)."""
    group_bytes = max(1, -(-(max(rows, 1) - 1).bit_length() // 8))
    return [(0, 24)] + [(0, 32 + 8 * b) for b in range(group_bytes)]


def _collect_words(ptrs, num_rows, gid, rows, dev):
    """K33 array mode's words launch and K10's radix passes: the
    permutation."""
    cap = gid.shape[0]
    words = torch.empty((1, cap), dtype=torch.int64, device=dev)
    rc = native.library("list").collect_words(
        ctypes.c_int64(cap), ctypes.c_void_p(num_rows.data_ptr()),
        host_table(ptrs), ctypes.c_int64(len(ptrs)),
        ctypes.c_void_p(gid.data_ptr()), ctypes.c_void_p(words.data_ptr()),
        ctypes.c_void_p(native.stream_ptr(dev)))
    native.check(rc, "collect_words")
    return radix_sort_words(words, num_rows, _array_passes(rows))


def collect_array_cuda(x: torch.Tensor, masks, num_rows: torch.Tensor,
                       gid: torch.Tensor, num_groups: torch.Tensor, L: int,
                       rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K33 array-mode launch: the words launch, K10's radix passes
    (ops/sort.py radix_sort_words), the pack; see csrc/list.cu."""
    cap = x.shape[0]
    dev = x.device
    ptrs = _check([x, gid], masks, cap, dev)
    _check_scalars(dev, num_rows, num_groups)
    plane = torch.empty((rows, L), dtype=x.dtype, device=dev)
    lengths = torch.empty(rows, dtype=torch.int32, device=dev)
    perm = _collect_words(ptrs, num_rows, gid, rows, dev)
    scratch = torch.empty(2 * rows, dtype=torch.int64, device=dev)
    rc = native.library("list").collect_array(
        ctypes.c_void_p(perm.data_ptr()), ctypes.c_int64(cap),
        ctypes.c_void_p(num_rows.data_ptr()), host_table(ptrs),
        ctypes.c_int64(len(ptrs)), ctypes.c_void_p(gid.data_ptr()),
        ctypes.c_void_p(num_groups.data_ptr()), ctypes.c_void_p(x.data_ptr()),
        ctypes.c_int64(x.element_size()), ctypes.c_int64(L),
        ctypes.c_int64(rows), ctypes.c_void_p(scratch.data_ptr()),
        ctypes.c_void_p(plane.data_ptr()), ctypes.c_void_p(lengths.data_ptr()),
        ctypes.c_void_p(native.stream_ptr(dev)))
    native.check(rc, "collect_array")
    collect_array_cuda.launches += 1
    return plane, lengths


collect_array_cuda.launches = 0


def collect_array(x, masks, num_rows, gid, num_groups, L, rows):
    """K33 array-mode wrapper: plain twin on the CPU, kernel on CUDA."""
    run = collect_array_cuda if x.is_cuda else collect_array_plain
    return run(x, masks, num_rows, gid, num_groups, L, rows)


def collect_map_plain(x: torch.Tensor, x2: Optional[torch.Tensor], masks,
                      num_rows: torch.Tensor, gid: torch.Tensor,
                      num_groups: torch.Tensor, L: int, rows: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of K33's map mode (_collect_grouped, histogram and
    map_agg): per group one entry per distinct key in ascending key order
    (the first L), the key its first row's value with NaN as +inf, the
    value the key's row count (x2 None: histogram) or x2 at its first
    row (map_agg); (keys [rows, L], values [rows, L], lengths [rows])."""
    dev = x.device
    keys = torch.zeros((rows, L), dtype=x.dtype, device=dev)
    vals = torch.zeros((rows, L), dtype=torch.int64 if x2 is None
                       else x2.dtype, device=dev)
    lengths = torch.zeros(rows, dtype=torch.int32, device=dev)
    kx = element_key(x)
    r_s, g_s = _sorted_eligible(gid, masks, num_rows, kx)
    m = r_s.shape[0]
    if not m:
        return keys, vals, lengths
    k_s = kx[r_s]
    start = torch.ones(m, dtype=torch.bool, device=dev)
    start[1:] = (g_s[1:] != g_s[:-1]) | (k_s[1:] != k_s[:-1])
    run = torch.cumsum(start.to(torch.int64), 0) - 1
    pos = torch.nonzero(start).flatten()           # each run's first position
    rg = g_s[pos]
    ordinal = run[pos] - _first_of_group(rg, rows)[rg]
    ok = ordinal < L
    first_rows = r_s[pos]
    keys[rg[ok], ordinal[ok]] = _nan_as_inf(x[first_rows[ok]])
    if x2 is None:
        counts = torch.bincount(run, minlength=pos.shape[0])
        vals[rg[ok], ordinal[ok]] = counts[ok]
    else:
        vals[rg[ok], ordinal[ok]] = x2[first_rows[ok]]
    lengths[:] = torch.bincount(rg, minlength=rows)[:rows].clamp(max=L) \
        .to(torch.int32)
    return keys, vals, lengths


# csrc/list.cu's map mode
MAP_THREADS = 256
MAP_DIRECT_SPAN = 4096      # the widest span of the direct route
MAP_DIRECT_LIMIT = 1 << 22  # entries of its table (16 MiB, inside the L2)
MAP_MAX_GRID = 2048
MAP_RUN = 4                 # consecutive sorted positions a thread takes
MAP_TILE = MAP_THREADS * MAP_RUN
MAP_INFO_WORDS = 4
ROUTE_DIRECT, ROUTE_AUTO, ROUTE_SORT = 0, 1, 2
_MAP_ARGS = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p)
_PACK_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
              ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
              ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)


@dataclasses.dataclass(frozen=True)
class MapPlan:
    """What the host knows of a map-mode call before any launch: the
    route (ROUTE_DIRECT when a dictionary's size bounds the span, so G x
    span fits the table; ROUTE_SORT for a float key;
    else ROUTE_AUTO, chosen on the device), the direct table's entries,
    the sort route's words and K10 passes (over the bytes the key type
    and the group count can set), and on ROUTE_DIRECT the keys' range
    [kmin, kmin + span) the host knows."""

    route: int
    table: int
    words: int
    passes: Tuple[Tuple[int, int], ...]
    kmin: int = 0
    span: int = 0


def map_plan(x: torch.Tensor, rows: int, span: Optional[int] = None
             ) -> MapPlan:
    """The plan of a map-mode call over key column `x` into `rows` list
    rows; `span`, when given, is a dictionary's size: its codes lie in
    [0, span)."""
    if x.is_floating_point():
        route, table = ROUTE_SORT, 0
    elif span is not None and span <= MAP_DIRECT_SPAN \
            and rows * max(span, 1) <= MAP_DIRECT_LIMIT:
        span = max(span, 1)
        return MapPlan(ROUTE_DIRECT, rows * span, 0, (), 0, span)
    else:
        route, table = ROUTE_AUTO, MAP_DIRECT_LIMIT
    key_bits, group_bits = 8 * x.element_size(), rows.bit_length()  # 0..G
    if key_bits + group_bits <= 64:
        passes = [(0, 8 * b) for b in range(-(-(key_bits + group_bits)
                                               // 8))]
        return MapPlan(route, table, 1, tuple(passes))
    passes = [(0, 8 * b) for b in range(8)] + \
        [(1, 8 * b) for b in range(-(-group_bits // 8))]
    return MapPlan(route, table, 2, tuple(passes))


def map_key(x: torch.Tensor) -> torch.Tensor:
    """The order key csrc/list.cu map_key compares, int64: an integer as
    itself, a float with NaN as +inf and -0.0 as +0.0, a float32 through
    its own 32 bits (so its span fits 32 bits), a float64 as element_key
    takes it."""
    if not x.is_floating_point() or x.element_size() == 8:
        return element_key(x)
    v = torch.where(torch.isnan(x), torch.full_like(x, float("inf")), x)
    b = torch.where(v == 0, torch.zeros_like(v), v).view(torch.int32)
    return torch.where(b >= 0, b, b ^ 0x7FFFFFFF).to(torch.int64)


def _blocks_rows(cap: int, grid: int) -> torch.Tensor:
    """The block that takes row i: b x MAP_THREADS + k x grid x
    MAP_THREADS + t."""
    return (torch.arange(cap) % (grid * MAP_THREADS)) // MAP_THREADS


def map_launch_model(x: torch.Tensor, x2: Optional[torch.Tensor], masks,
                     num_rows: torch.Tensor, gid: torch.Tensor,
                     num_groups: torch.Tensor, L: int, rows: int,
                     plan: MapPlan, grid: int,
                     order: Optional[Sequence[int]] = None):
    """K33's map mode as its launches run it (csrc/list.cu map_prep_kernel,
    K10, map_pack_kernel), each over `grid` blocks taken in `order`:
    the blocks' partial (kmin, kmax) of the eligible order keys, folded by
    every block after the barrier (on ROUTE_DIRECT the plan's range
    instead); the route (the plan's, or on
    ROUTE_AUTO direct when the span is at most MAP_DIRECT_SPAN and G x
    span within the table); on the direct route the table's identities,
    each block's rows added or min-ed into it, and a warp per list row
    walking its span; on the sort route the words, K10's permutation
    (ops/sort.py radix_replay_plain over the plan's passes), each
    position's words staged and each tile's run starts counted, then each
    block's tiles numbered from the tiles before them, and the zeros past
    each list. Returns ((keys, values, lengths)
    from memory that held garbage, the route taken, the K10 rows)."""
    cap = x.shape[0]
    n = max(0, min(int(num_rows), cap))
    G = max(0, min(int(num_groups), rows))
    hist = x2 is None
    aux_dtype = torch.int64 if hist else x2.dtype
    keys = torch.randint(-5, 5, (rows, L), generator=torch.Generator()
                         .manual_seed(1)).to(x.dtype)
    vals = torch.randint(-5, 5, (rows, L), generator=torch.Generator()
                         .manual_seed(2)).to(aux_dtype)
    lengths = torch.full((rows,), -9, dtype=torch.int32)
    g = gid[:n].to(torch.int64)
    elig = _eligible(masks, num_rows, cap)[:n] & (g >= 0) & (g < G)
    k = map_key(x[:n])
    block = _blocks_rows(n, grid)
    if plan.route == ROUTE_DIRECT:       # the host's span: no fold
        kmin, kmax = plan.kmin, plan.kmin + plan.span - 1
    else:
        parts = []
        for b in range(grid):
            m = elig & (block == b)
            parts.append((int(k[m].min()) if m.any() else _I64_MAX,
                          int(k[m].max()) if m.any() else _I64_MIN))
        kmin = min(p[0] for p in parts)
        kmax = max(p[1] for p in parts)
    spanm1 = 0 if kmin > kmax else kmax - kmin
    direct = plan.route == ROUTE_DIRECT or (
        plan.route == ROUTE_AUTO and spanm1 < MAP_DIRECT_SPAN
        and G * (spanm1 + 1) <= plan.table)
    blocks = range(grid) if order is None else order
    if direct:
        sp = 0 if kmin > kmax else spanm1 + 1
        entries = min(G * sp, plan.table)
        ident = 0 if hist else _I32_MAX
        table = torch.full((entries,), ident, dtype=torch.int64)
        idx = g * sp + (k - kmin)
        ok = elig & (k - kmin >= 0) & (k - kmin < sp) & (idx < entries)
        rows_i = torch.arange(n)
        for b in blocks:
            m = ok & (block == b)
            if hist:
                table.index_add_(0, idx[m], torch.ones_like(idx[m]))
            else:
                table.scatter_reduce_(0, idx[m], rows_i[m], "amin")
        for r in range(rows):
            ent = table[r * sp:(r + 1) * sp] if r < G else table[:0]
            d = torch.nonzero(ent != ident).flatten()
            ln = min(d.numel(), L)
            keys[r, ln:] = 0
            vals[r, ln:] = 0
            keys[r, :ln] = (kmin + d[:ln]).to(x.dtype)
            vals[r, :ln] = ent[d[:ln]] if hist else x2[ent[d[:ln]]]
            lengths[r] = ln
        return (keys, vals, lengths), "direct", 0
    # the sort route: (code, d) packed as the device packs them
    kbits = spanm1.bit_length()
    packed = kbits + G.bit_length() <= 64
    code = torch.where(elig, g, torch.full_like(g, G))
    d = torch.where(elig, k - kmin, torch.zeros_like(k))
    words = torch.zeros((max(plan.words, 1), cap), dtype=torch.int64)
    if packed:
        words[0, :n] = (code << kbits if kbits < 64 else 0) | d
    else:
        words[0, :n] = d
        words[1, :n] = code
    perm = radix_replay_plain([w ^ _I64_MIN for w in words], n,
                              plan.passes).to(torch.int64)[:n]
    code_s, d_s = code[perm], d[perm]
    el = code_s < G
    start = el.clone()
    start[1:] &= (code_s[1:] != code_s[:-1]) | (d_s[1:] != d_s[:-1])
    tiles = -(-n // MAP_TILE)
    tile_runs = [int(start[t * MAP_TILE:(t + 1) * MAP_TILE].sum())
                 for t in range(tiles)]
    run = torch.full((n,), -1, dtype=torch.int64)
    for b in blocks:                 # each block's tiles, in tile order
        acc, done = 0, 0
        for t in range(b, tiles, grid):
            acc += sum(tile_runs[done:t])
            seg = start[t * MAP_TILE:(t + 1) * MAP_TILE].to(torch.int64)
            run[t * MAP_TILE:(t + 1) * MAP_TILE] = acc + torch.cumsum(
                seg, 0) - 1
            acc += int(seg.sum())
            done = t + 1
    pos = torch.nonzero(start).flatten()
    run_pos = pos                    # run k starts at run_pos[k]
    first_run = {}
    for p in pos.tolist():
        if p == 0 or code_s[p] != code_s[p - 1]:
            first_run[int(code_s[p])] = int(run[p])
    lengths[:] = 0
    end = el.clone()
    end[:-1] &= (code_s[1:] != code_s[:-1]) | (d_s[1:] != d_s[:-1])
    for i in torch.nonzero(end).flatten().tolist():
        kk, c = int(run[i]), int(code_s[i])
        s0 = int(run_pos[kk])
        ordn = kk - first_run[c]
        r0 = int(perm[s0])
        if ordn < L:
            keys[c, ordn] = _nan_as_inf(x[r0:r0 + 1])[0]
            vals[c, ordn] = i + 1 - s0 if hist else x2[r0]
        if i + 1 == n or code_s[i + 1] != c:
            lengths[c] = min(ordn + 1, L)
    cols = torch.arange(L)
    past = cols[None, :] >= lengths.to(torch.int64)[:, None]
    keys[past] = 0
    vals[past] = 0
    return (keys, vals, lengths), "sort", n


def collect_map_cuda(x: torch.Tensor, x2: Optional[torch.Tensor], masks,
                     num_rows: torch.Tensor, gid: torch.Tensor,
                     num_groups: torch.Tensor, L: int, rows: int,
                     span: Optional[int] = None, with_route: bool = False
                     ) -> Tuple[torch.Tensor, ...]:
    """K33 map-mode launch: one cooperative launch on the direct route
    (map_plan), else that launch, K10's radix passes over the words it
    wrote and the pack launch; see csrc/list.cu. `span` bounds the
    eligible keys' span where the caller knows it (a dictionary's
    size). With `with_route`, a fourth output: the route the card took,
    a 0-d int64 tensor on the device, 1 where it sorted, 0 on the direct
    route (read without a sync here)."""
    cap = x.shape[0]
    dev = x.device
    index = x.get_device()
    if index < 0:
        raise ValueError("collect_map_cuda takes CUDA tensors")
    ptrs = _check([x, x2, gid], masks, cap, dev)
    _check_scalars(dev, num_rows, num_groups)
    if x.is_floating_point() and x.element_size() not in (4, 8):
        raise ValueError("map keys must be 4- or 8-byte floats or integers")
    if L < 1 or rows < 1:
        raise ValueError("a map needs L >= 1 and rows >= 1")
    plan = map_plan(x, rows, span)
    keys = torch.empty((rows, L), dtype=x.dtype, device=dev)
    vals = torch.empty((rows, L), dtype=torch.int64 if x2 is None
                       else x2.dtype, device=dev)
    lengths = torch.empty(rows, dtype=torch.int32, device=dev)
    sorted_ = plan.route != ROUTE_DIRECT
    # the pack's scratch: the staged words (2 cap), then int32 run
    # positions, first runs and tile counts
    pack = 2 * cap + -(-(cap + 1 + rows + -(-cap // MAP_TILE)) // 2) \
        if sorted_ else 0
    radix = radix_scratch_sizes(cap, len(plan.passes)) if sorted_ else ()
    wide = [MAP_INFO_WORDS, 2 * MAP_MAX_GRID, plan.words * cap, pack, *radix]
    narrow = [plan.table, 1] + ([cap] if sorted_ else [])
    i64 = torch.empty(sum(wide), dtype=torch.int64, device=dev)
    i32 = torch.empty(sum(narrow), dtype=torch.int32, device=dev)
    info, partials, words, pack, *k10 = torch.split(i64, wide)
    table, sort_n, *perm = torch.split(i32, narrow)
    sort_n = sort_n.view(())
    rc = native.function("list", "collect_map", _MAP_ARGS)(
        x.data_ptr(), x.element_size(), int(x.is_floating_point()),
        _ptr(x2), 8 if x2 is None else x2.element_size(), cap,
        num_rows.data_ptr(), host_table(ptrs), len(ptrs), gid.data_ptr(),
        num_groups.data_ptr(), L, rows, plan.route, plan.kmin, plan.span,
        table.data_ptr(),
        plan.table, words.data_ptr(), plan.words,
        sort_n.data_ptr() if sorted_ else None, info.data_ptr(),
        partials.data_ptr(), keys.data_ptr(), vals.data_ptr(),
        lengths.data_ptr(), native.raw_stream(index))
    native.check(rc, "collect_map")
    if sorted_:
        perm = perm[0]
        radix_into(words.view(plan.words, cap), sort_n, plan.passes, perm,
                   None, k10)
        rc = native.function("list", "collect_map_pack", _PACK_ARGS)(
            perm.data_ptr(), words.data_ptr(), cap, sort_n.data_ptr(),
            info.data_ptr(), x.data_ptr(), x.element_size(),
            int(x.is_floating_point()), _ptr(x2),
            8 if x2 is None else x2.element_size(), num_groups.data_ptr(),
            L, rows, pack.data_ptr(), keys.data_ptr(), vals.data_ptr(),
            lengths.data_ptr(), native.raw_stream(index))
        native.check(rc, "collect_map_pack")
    collect_map_cuda.launches += 1
    if with_route:
        return keys, vals, lengths, info[0]
    return keys, vals, lengths


collect_map_cuda.launches = 0


def collect_map(x, x2, masks, num_rows, gid, num_groups, L, rows,
                span=None):
    """K33 map-mode wrapper: plain twin on the CPU, kernel on CUDA (`span`
    bounds the eligible keys' span where the caller knows it)."""
    if not x.is_cuda:
        return collect_map_plain(x, x2, masks, num_rows, gid, num_groups, L,
                                 rows)
    return collect_map_cuda(x, x2, masks, num_rows, gid, num_groups, L,
                            rows, span)


# ----------------------------------------------------------------- K34


def _slots(lengths, valid, num_rows) -> torch.Tensor:
    cap = lengths.shape[0]
    live = _live(num_rows, cap)
    if valid is not None:
        live = live & valid
    return torch.where(live, lengths, 0).to(torch.int64)


def unnest_count_plain(lengths: torch.Tensor, valid: Optional[torch.Tensor],
                       num_rows: torch.Tensor) -> torch.Tensor:
    """Plain twin of K34's count: the live non-NULL rows' lengths summed,
    a 0-d int32 tensor (the reference's count op)."""
    return _slots(lengths, valid, num_rows).sum().to(torch.int32)


def _check_list(lengths, valid, num_rows, dev) -> int:
    cap = lengths.shape[0]
    if lengths.dtype != torch.int32 or lengths.dim() != 1 \
            or not lengths.is_contiguous() or lengths.device != dev:
        raise ValueError("lengths must be a contiguous int32 [cap] tensor")
    if valid is not None and (valid.dtype != torch.bool
                              or valid.shape != (cap,)
                              or not valid.is_contiguous()):
        raise ValueError("validity must be a contiguous bool [cap] tensor")
    _check_scalars(dev, num_rows)
    return cap


def unnest_count_cuda(lengths: torch.Tensor, valid: Optional[torch.Tensor],
                      num_rows: torch.Tensor) -> torch.Tensor:
    """K34 count launch: see csrc/list.cu unnest_count."""
    dev = lengths.device
    cap = _check_list(lengths, valid, num_rows, dev)
    scratch = torch.empty(max(1, -(-cap // COMPACT_TILE)), dtype=torch.int64,
                          device=dev)
    total = torch.empty((), dtype=torch.int32, device=dev)
    rc = native.library("list").unnest_count(
        ctypes.c_void_p(lengths.data_ptr()), ctypes.c_void_p(_ptr(valid)),
        ctypes.c_void_p(num_rows.data_ptr()), ctypes.c_int64(cap),
        ctypes.c_void_p(scratch.data_ptr()), ctypes.c_void_p(total.data_ptr()),
        ctypes.c_void_p(native.stream_ptr(dev)))
    native.check(rc, "unnest_count")
    unnest_count_cuda.launches += 1
    return total


unnest_count_cuda.launches = 0


def unnest_count(lengths, valid, num_rows):
    """K34 count wrapper: plain twin on the CPU, kernel on CUDA."""
    run = unnest_count_cuda if lengths.is_cuda else unnest_count_plain
    return run(lengths, valid, num_rows)


def unnest_expand_plain(lengths: torch.Tensor, valid: Optional[torch.Tensor],
                        num_rows: torch.Tensor, plane: torch.Tensor,
                        aux: Optional[torch.Tensor], out_cap: int,
                        with_ordinal: bool):
    """Plain twin of K34's expand (the reference's expand op): for each of
    the first min(total, out_cap) output slots its source row (int32),
    ordinal (int64, 1-based; None unless asked), element and MAP value
    (None without aux); the total slots (0-d int32). Slots past the total
    are 0."""
    dev = lengths.device
    lens = _slots(lengths, valid, num_rows)
    total = int(lens.sum())
    n = min(total, out_cap)
    src = torch.repeat_interleave(torch.arange(lengths.shape[0],
                                               device=dev), lens)[:n]
    starts = torch.cumsum(lens, 0) - lens
    ordinal = torch.arange(n, device=dev) - starts[src]

    def padded(vals, dtype):
        out = torch.zeros(out_cap, dtype=dtype, device=dev)
        out[:n] = vals
        return out
    return (padded(src, torch.int32),
            padded(ordinal + 1, torch.int64) if with_ordinal else None,
            padded(plane[src, ordinal], plane.dtype),
            None if aux is None else padded(aux[src, ordinal], aux.dtype),
            torch.tensor(total, dtype=torch.int32, device=dev))


def unnest_expand_cuda(lengths: torch.Tensor, valid: Optional[torch.Tensor],
                       num_rows: torch.Tensor, plane: torch.Tensor,
                       aux: Optional[torch.Tensor], out_cap: int,
                       with_ordinal: bool):
    """K34 expand launch: see csrc/list.cu unnest_expand. Slots past the
    total are not written."""
    dev = lengths.device
    cap = _check_list(lengths, valid, num_rows, dev)
    for p in (plane, aux):
        if p is not None and (p.device != dev or p.dim() != 2
                              or p.shape[0] != cap or not p.is_contiguous()
                              or p.shape[1] != plane.shape[1]
                              or p.element_size() not in (1, 2, 4, 8)):
            raise ValueError("planes must be contiguous [cap, L] tensors")
    L = plane.shape[1]
    src = torch.empty(out_cap, dtype=torch.int32, device=dev)
    ordinal = torch.empty(out_cap, dtype=torch.int64, device=dev) \
        if with_ordinal else None
    elem = torch.empty(out_cap, dtype=plane.dtype, device=dev)
    aux_out = None if aux is None else torch.empty(out_cap, dtype=aux.dtype,
                                                   device=dev)
    scratch = torch.empty(max(1, -(-cap // COMPACT_TILE)), dtype=torch.int64,
                          device=dev)
    total = torch.empty((), dtype=torch.int32, device=dev)
    rc = native.library("list").unnest_expand(
        ctypes.c_void_p(lengths.data_ptr()), ctypes.c_void_p(_ptr(valid)),
        ctypes.c_void_p(num_rows.data_ptr()), ctypes.c_int64(cap),
        ctypes.c_int64(L), ctypes.c_void_p(plane.data_ptr()),
        ctypes.c_int64(plane.element_size()), ctypes.c_void_p(_ptr(aux)),
        ctypes.c_int64(0 if aux is None else aux.element_size()),
        ctypes.c_int64(out_cap), ctypes.c_void_p(scratch.data_ptr()),
        ctypes.c_void_p(total.data_ptr()), ctypes.c_void_p(src.data_ptr()),
        ctypes.c_void_p(_ptr(ordinal)), ctypes.c_void_p(elem.data_ptr()),
        ctypes.c_void_p(_ptr(aux_out)),
        ctypes.c_void_p(native.stream_ptr(dev)))
    native.check(rc, "unnest_expand")
    unnest_expand_cuda.launches += 1
    return src, ordinal, elem, aux_out, total


unnest_expand_cuda.launches = 0


def unnest_expand(lengths, valid, num_rows, plane, aux, out_cap,
                  with_ordinal):
    """K34 expand wrapper: plain twin on the CPU, kernel on CUDA."""
    run = unnest_expand_cuda if lengths.is_cuda else unnest_expand_plain
    return run(lengths, valid, num_rows, plane, aux, out_cap, with_ordinal)
