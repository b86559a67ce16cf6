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
  +-0.0 one key) in ascending key order;
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
from typing import List, Optional, Sequence, Tuple

import torch

from trino_tpu_torch import native
from trino_tpu_torch.ops.sort import radix_sort_words
from trino_tpu_torch.page import COMPACT_TILE, host_table

_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1
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


def _words_passes(rows: int, with_key: bool) -> List[Tuple[int, int]]:
    """K10's digit passes, least significant first: word 1's 8 bytes (map
    mode), word 0's flag byte and the bytes a group id below rows uses
    (rows is at least the group count)."""
    group_bytes = max(1, -(-(max(rows, 1) - 1).bit_length() // 8))
    return [(1, 8 * b) for b in range(8 if with_key else 0)] + \
        [(0, 24)] + [(0, 32 + 8 * b) for b in range(group_bytes)]


def _collect_words(with_key: bool, x, ptrs, num_rows, gid, rows, dev):
    """K33's words launch and K10's radix passes: the permutation."""
    cap = x.shape[0]
    words = torch.empty((2 if with_key else 1, cap), dtype=torch.int64,
                        device=dev)
    rc = native.library("list").collect_words(
        ctypes.c_int64(int(with_key)), ctypes.c_void_p(x.data_ptr()),
        ctypes.c_int64(x.element_size()),
        ctypes.c_int64(int(x.is_floating_point())), ctypes.c_int64(cap),
        ctypes.c_void_p(num_rows.data_ptr()), host_table(ptrs),
        ctypes.c_int64(len(ptrs)), ctypes.c_void_p(gid.data_ptr()),
        ctypes.c_void_p(words.data_ptr()),
        ctypes.c_void_p(native.stream_ptr(dev)))
    native.check(rc, "collect_words")
    return words, radix_sort_words(words, num_rows,
                                   _words_passes(rows, with_key))


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
    _, perm = _collect_words(False, x, ptrs, num_rows, gid, rows, dev)
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


def collect_map_cuda(x: torch.Tensor, x2: Optional[torch.Tensor], masks,
                     num_rows: torch.Tensor, gid: torch.Tensor,
                     num_groups: torch.Tensor, L: int, rows: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K33 map-mode launch: the words launch (group, key), K10's radix
    passes, the run scan and the pack; see csrc/list.cu."""
    cap = x.shape[0]
    dev = x.device
    ptrs = _check([x, x2, gid], masks, cap, dev)
    _check_scalars(dev, num_rows, num_groups)
    if x.is_floating_point() and x.element_size() not in (4, 8):
        raise ValueError("map keys must be 4- or 8-byte floats or integers")
    keys = torch.empty((rows, L), dtype=x.dtype, device=dev)
    vals = torch.empty((rows, L), dtype=torch.int64 if x2 is None
                       else x2.dtype, device=dev)
    lengths = torch.empty(rows, dtype=torch.int32, device=dev)
    words, perm = _collect_words(True, x, ptrs, num_rows, gid, rows, dev)
    tiles = max(1, -(-cap // COMPACT_TILE))
    scratch = torch.empty(3 * rows + 2 * cap + tiles, dtype=torch.int64,
                          device=dev)
    nruns = torch.empty((), dtype=torch.int32, device=dev)
    rc = native.library("list").collect_map(
        ctypes.c_void_p(perm.data_ptr()), ctypes.c_void_p(words.data_ptr()),
        ctypes.c_int64(cap), ctypes.c_void_p(num_rows.data_ptr()),
        host_table(ptrs), ctypes.c_int64(len(ptrs)),
        ctypes.c_void_p(gid.data_ptr()),
        ctypes.c_void_p(num_groups.data_ptr()), ctypes.c_void_p(x.data_ptr()),
        ctypes.c_int64(x.element_size()),
        ctypes.c_int64(int(x.is_floating_point())),
        ctypes.c_void_p(_ptr(x2)),
        ctypes.c_int64(8 if x2 is None else x2.element_size()),
        ctypes.c_int64(L), ctypes.c_int64(rows),
        ctypes.c_void_p(scratch.data_ptr()), ctypes.c_void_p(nruns.data_ptr()),
        ctypes.c_void_p(keys.data_ptr()), ctypes.c_void_p(vals.data_ptr()),
        ctypes.c_void_p(lengths.data_ptr()),
        ctypes.c_void_p(native.stream_ptr(dev)))
    native.check(rc, "collect_map")
    collect_map_cuda.launches += 1
    return keys, vals, lengths


collect_map_cuda.launches = 0


def collect_map(x, x2, masks, num_rows, gid, num_groups, L, rows):
    """K33 map-mode wrapper: plain twin on the CPU, kernel on CUDA."""
    run = collect_map_cuda if x.is_cuda else collect_map_plain
    return run(x, x2, masks, num_rows, gid, num_groups, L, rows)


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
