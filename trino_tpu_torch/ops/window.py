"""Window operator: sort-partitioned, vectorized frame evaluation.

Port of `trino_tpu/ops/window.py` (WindowOperator.java with the window
framework: rank/row_number/lead/lag/first/last/nth plus aggregates over
frames). The whole input is one page: it is sorted by (partition, order)
keys, and every function becomes a per-row pass over segment arrays:

  partition boundaries -> segment ids (cumsum of change flags)
  ROWS frames          -> running prefix scans reset at segment starts
  RANGE frames         -> the same, read at the current peer group's end
  whole-partition      -> the scan read at the segment's end

Supported frames: UNBOUNDED PRECEDING .. CURRENT ROW (ROWS and RANGE),
UNBOUNDED PRECEDING .. UNBOUNDED FOLLOWING, and bounded ROWS frames with
literal offsets. RANGE frames with value offsets and GROUPS frames raise
at lowering (exec/local_planner.py _lower_frame).

Four kernels, each beside its plain PyTorch twin (the reference's
formulas, which the CPU pages take):

* K20 `window_bounds` (csrc/window.cu): the change flags of the partition
  and order columns and the segment and peer arrays (seg/peer start, id
  and live length), a tiled count -> scan -> write with no host sync.
* K21 `rank_value` (Triton, `_rank_value_kernel` below): row_number, rank,
  dense_rank, percent_rank, cume_dist, ntile, lead/lag and
  first/last/nth_value, one fused elementwise pass with at most one
  gather per row.
* K22 `frame_aggregate` (csrc/window.cu): sum/avg/count/min/max over
  running ROWS, RANGE, whole-partition and bounded frames as a segmented
  block scan (forward, or reversed for a frame with an unbounded end) read
  per row at the frame's ends.
* K23 `bounded_minmax` (csrc/window.cu): min/max over a two-sided bounded
  ROWS frame, values and validity.

The sort reuses K10 (ops/sort.py sort_rows) and the row move K7
(Page.gather). A wrapper takes its plain twin only for tensors on the
CPU; on a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

from trino_tpu_torch import native
from trino_tpu_torch import types as T
from trino_tpu_torch.ops.sort import SortKey, sort_rows
from trino_tpu_torch.page import Column, Page, gather_rows, host_table, \
    union_dictionaries

RANKING = ("row_number", "rank", "dense_rank", "percent_rank", "cume_dist",
           "ntile")
VALUE = ("lead", "lag", "first_value", "last_value", "nth_value")
AGGREGATE = ("sum", "avg", "min", "max", "count")


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    name: str
    arg_channels: Tuple[int, ...]
    out_type: T.Type
    frame_whole: bool    # UNBOUNDED..UNBOUNDED (or no ORDER BY)
    frame_rows: bool     # ROWS vs RANGE for the running frame
    # bounded ROWS frame: (start_off, end_off) row offsets relative to the
    # current row (negative = PRECEDING); None inside the tuple = unbounded
    # on that side. None overall = use frame_whole/frame_rows.
    bounds: Optional[Tuple[Optional[int], Optional[int]]] = None


@dataclasses.dataclass
class Bounds:
    """K20's arrays over the sorted page (every row, dead ones included):
    each row's segment (partition) and peer group: the first row, the
    0-based id and the number of live rows."""

    seg_start: torch.Tensor     # int64
    seg_len: torch.Tensor       # int64
    peer_start: torch.Tensor    # int64
    peer_len: torch.Tensor      # int64
    seg_id: torch.Tensor        # int32
    peer_id: torch.Tensor       # int32


def window(partition_channels: Sequence[int],
           order_keys: Sequence[SortKey],
           specs: Sequence[WindowSpec]) -> Callable[..., Page]:
    """op(page[, stats]) -> page sorted by (partition, order) with one
    appended column per spec. Consumers see rows grouped by partition; SQL
    row order is otherwise unspecified. A `stats` dict, when given, gets
    the live partitions and peer groups as 0-d device tensors."""
    partition_channels = tuple(partition_channels)
    order_keys = tuple(order_keys)
    specs = tuple(specs)
    sort_keys = tuple(SortKey(c) for c in partition_channels) + order_keys
    order_channels = tuple(k.channel for k in order_keys)

    def op(page: Page, stats: Optional[dict] = None) -> Page:
        if sort_keys:
            page = page.gather(sort_rows(page, sort_keys), page.num_rows)
        b = window_bounds(page, partition_channels, order_channels)
        if stats is not None and page.capacity:
            # the ids of the last live row (a 1-element index: a 0-d one
            # would be read on the host, waiting for the device)
            last = (page.num_rows.to(torch.int64) - 1).clamp(min=0)[None]
            some = (page.num_rows > 0).to(torch.int64)
            stats["partitions"] = (b.seg_id[last][0].to(torch.int64) + 1) \
                * some
            stats["peer_groups"] = (b.peer_id[last][0].to(torch.int64)
                                    + 1) * some
        cols = list(page.columns)
        for spec in specs:
            cols.append(_eval(spec, page, b))
        return Page(tuple(cols), page.num_rows)

    return op


def frame_kind(spec: WindowSpec) -> str:
    """whole, rows (running), range (running, read at the peer end) or
    bounded: the frame a spec evaluates over."""
    if spec.bounds is not None:
        return "bounded"
    if spec.frame_whole:
        return "whole"
    return "rows" if spec.frame_rows else "range"


# ------------------------------------------------------------------ K20


def _change_flags(page: Page, channels: Sequence[int],
                  live: torch.Tensor) -> torch.Tensor:
    """True where any listed column differs from the previous row (values
    compared where both are valid, NULL equal to NULL; NaN differs from
    everything, so every NaN row starts a group: the reference's quirk);
    dead rows (sorted last) start their own segment."""
    n = page.capacity
    flag = torch.zeros(n, dtype=torch.bool, device=page.device)
    for ch in channels:
        col = page.column(ch)
        differ = col.values != torch.roll(col.values, 1)
        if col.valid is not None:
            pv = torch.roll(col.valid, 1)
            differ = (differ & col.valid & pv) | (col.valid != pv)
        flag |= differ
    dead = ~live
    flag |= dead != torch.roll(dead, 1)
    if n:
        flag[0] = True
    return flag


def window_bounds_plain(page: Page, partition_channels: Sequence[int],
                        order_channels: Sequence[int]) -> Bounds:
    """Plain twin of K20 (the reference's `window` body, :81-114)."""
    n = page.capacity
    dev = page.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    live = page.row_mask()
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    def arrays(flags):
        start = torch.cummax(torch.where(flags, idx, zero), 0).values \
            if n else idx
        ids = torch.cumsum(flags.to(torch.int64), 0) - 1
        length = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
            0, ids.clamp(min=0), live.to(torch.int64))[ids.clamp(min=0)]
        return start, ids.to(torch.int32), length

    seg_b = _change_flags(page, partition_channels, live)
    seg_start, seg_id, seg_len = arrays(seg_b)
    peer_b = seg_b | _change_flags(page, order_channels, live) \
        if order_channels else seg_b
    peer_start, peer_id, peer_len = arrays(peer_b)
    return Bounds(seg_start, seg_len, peer_start, peer_len, seg_id, peer_id)


WINDOW_TILE = 4096   # rows per block of K20's and K22's tiles (window.cu)


def _key_table(page: Page, channels: Sequence[int]) -> list:
    out = []
    for ch in channels:
        c = page.column(ch)
        v = c.values
        for t in (v, c.valid):
            if t is not None and (t.dim() != 1 or not t.is_contiguous()
                                  or t.shape[0] != page.capacity
                                  or t.device != page.device):
                raise ValueError("window key columns must be contiguous "
                                 "1-D tensors of the page's capacity")
        out += [v.data_ptr(), 0 if c.valid is None else c.valid.data_ptr(),
                v.element_size(), int(v.is_floating_point())]
    return out


def window_bounds_cuda(page: Page, partition_channels: Sequence[int],
                       order_channels: Sequence[int]) -> Bounds:
    """K20 launch: see csrc/window.cu."""
    dev = page.device
    cap = page.capacity
    ntiles = max(1, -(-cap // WINDOW_TILE))
    table = _key_table(page, tuple(partition_channels)
                       + tuple(order_channels))
    counts = torch.empty(ntiles + 1, dtype=torch.int64, device=dev)
    first = torch.empty((2, max(cap, 1)), dtype=torch.int64, device=dev)
    i64 = [torch.empty(cap, dtype=torch.int64, device=dev) for _ in range(4)]
    i32 = [torch.empty(cap, dtype=torch.int32, device=dev) for _ in range(2)]
    if cap:
        rc = native.library("window").window_bounds(
            ctypes.c_void_p(page.num_rows.data_ptr()), ctypes.c_int64(cap),
            ctypes.c_int64(len(partition_channels)),
            ctypes.c_int64(len(order_channels)), host_table(table),
            ctypes.c_void_p(counts.data_ptr()),
            ctypes.c_void_p(first.data_ptr()),
            *(ctypes.c_void_p(t.data_ptr()) for t in i32 + i64),
            ctypes.c_void_p(native.stream_ptr(dev)))
        native.check(rc, "window_bounds")
        window_bounds_cuda.launches += 1
    seg_start, seg_len, peer_start, peer_len = i64
    return Bounds(seg_start, seg_len, peer_start, peer_len, *i32)


window_bounds_cuda.launches = 0


def window_bounds(page: Page, partition_channels: Sequence[int],
                  order_channels: Sequence[int]) -> Bounds:
    """K20 wrapper: plain twin on the CPU, kernel on CUDA."""
    run = window_bounds_cuda if page.device.type == "cuda" \
        else window_bounds_plain
    return run(page, partition_channels, order_channels)


# ------------------------------------------------------------------ K21


def _eval(spec: WindowSpec, page: Page, b: Bounds) -> Column:
    if spec.name in RANKING or spec.name in VALUE:
        return rank_value(spec, page, b)
    if spec.name in AGGREGATE:
        return _eval_aggregate(spec, page, b)
    raise NotImplementedError(f"window function {spec.name}")


def _bounded_range(spec: WindowSpec, idx, seg_start, seg_len, live):
    """[lo, hi] absolute row positions of a bounded ROWS frame, clipped to
    the partition (FramedWindowFunction's frame computation)."""
    bs, be = spec.bounds
    seg_end = seg_start + seg_len - 1
    lo = seg_start if bs is None else torch.maximum(idx + bs, seg_start)
    hi = seg_end if be is None else torch.minimum(idx + be, seg_end)
    return lo, hi, (hi >= lo) & live


def _lead_lag_default(spec: WindowSpec, page: Page):
    """(x values, default column, output dictionary) of lead/lag: a
    dictionary argument and a default from another dictionary are both
    re-encoded onto their union pool through K7."""
    x = page.column(spec.arg_channels[0])
    xv = x.values
    out_dict = x.dictionary
    if len(spec.arg_channels) <= 2:
        return xv, None, out_dict
    dflt = page.column(spec.arg_channels[2])
    if x.dictionary != dflt.dictionary:
        if x.dictionary is None or dflt.dictionary is None:
            raise NotImplementedError(
                "lead/lag mixes dictionary and non-dictionary operands")
        out_dict, (rx, rd) = union_dictionaries(
            [x.dictionary, dflt.dictionary], device=page.device)
        xv = gather_rows([rx], xv.clamp(min=0))[0]
        dflt = Column(gather_rows([rd], dflt.values.clamp(min=0))[0],
                      dflt.valid, dflt.type, out_dict)
    return xv, dflt, out_dict


def rank_value_plain(spec: WindowSpec, page: Page, b: Bounds) -> Column:
    """Plain twin of K21 (the reference's `_eval`, :135-237)."""
    name = spec.name
    n = page.capacity
    dev = page.device
    dtype = spec.out_type.dtype
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    live = page.row_mask()
    seg_start, seg_len = b.seg_start, b.seg_len
    rn0 = idx - seg_start
    peer_end0 = b.peer_start - seg_start + b.peer_len

    def arg(i: int) -> Column:
        return page.column(spec.arg_channels[i])

    def out(values):
        return Column(values.to(dtype), None, spec.out_type, None)

    if name == "row_number":
        return out(rn0 + 1)
    if name == "rank":
        return out(b.peer_start - seg_start + 1)
    if name == "dense_rank":
        pid = b.peer_id.to(torch.int64)
        return out(pid - pid[seg_start.clamp(0, max(n - 1, 0))] + 1)
    if name == "percent_rank":
        rank = (b.peer_start - seg_start).to(torch.float64)
        denom = torch.clamp(seg_len - 1, min=1).to(torch.float64)
        return out(torch.where(seg_len <= 1,
                               torch.zeros((), dtype=torch.float64,
                                           device=dev), rank / denom))
    if name == "cume_dist":
        return out(peer_end0.to(torch.float64)
                   / torch.clamp(seg_len, min=1).to(torch.float64))
    if name == "ntile":
        k = torch.clamp(arg(0).values.to(torch.int64), min=1)
        base = seg_len // k
        rem = seg_len % k
        cut = rem * (base + 1)
        tile = torch.where(
            rn0 < cut, rn0 // torch.clamp(base + 1, min=1),
            rem + (rn0 - cut) // torch.clamp(base, min=1))
        return out(tile + 1)

    x = arg(0)
    if name in ("lead", "lag"):
        xv, dflt, out_dict = _lead_lag_default(spec, page)
        off = arg(1).values.to(torch.int64) \
            if len(spec.arg_channels) > 1 else torch.ones_like(idx)
        tgt = idx + off if name == "lead" else idx - off
        in_frame = (tgt >= seg_start) & (tgt < seg_start + seg_len) & live
        tgt_c = tgt.clamp(0, max(n - 1, 0))
        vals = xv[tgt_c]
        valid = in_frame
        if x.valid is not None:
            valid = valid & x.valid[tgt_c]
        if dflt is not None:
            vals = torch.where(in_frame, vals, dflt.values)
            valid = torch.where(in_frame, valid, dflt.valid_mask())
        return Column(vals, valid, spec.out_type, out_dict)

    # first_value, last_value, nth_value
    if spec.bounds is not None:
        lo, hi, nonempty = _bounded_range(spec, idx, seg_start, seg_len,
                                          live)
        if name == "first_value":
            tgt = lo
        elif name == "last_value":
            tgt = hi
        else:
            tgt = lo + arg(1).values.to(torch.int64) - 1
            # a dynamic n <= 0 yields NULL rather than reading before the
            # frame (a literal n <= 0 is rejected at planning)
            nonempty = nonempty & (tgt <= hi) & (tgt >= lo)
        in_frame = nonempty
    else:
        if name == "first_value":
            tgt = seg_start
        elif name == "last_value":
            if spec.frame_whole:
                tgt = seg_start + seg_len - 1
            elif spec.frame_rows:
                tgt = idx                       # frame ends at current row
            else:
                tgt = seg_start + peer_end0 - 1  # peer-inclusive RANGE
        else:
            tgt = seg_start + arg(1).values.to(torch.int64) - 1
        frame_end = seg_start + seg_len if spec.frame_whole else (
            idx + 1 if spec.frame_rows else seg_start + peer_end0)
        in_frame = (tgt >= seg_start) & (tgt < frame_end)
    tgt_c = tgt.clamp(0, max(n - 1, 0))
    valid = in_frame
    if x.valid is not None:
        valid = valid & x.valid[tgt_c]
    return Column(x.values[tgt_c], valid, spec.out_type, x.dictionary)


# K21's function and frame codes (the constexprs of _rank_value_kernel)
FUNCTION_CODE = {name: i for i, name in enumerate(RANKING + VALUE)}
FRAME_CODE = {"whole": 0, "rows": 1, "range": 2, "bounded": 3}
RANK_VALUE_BLOCK = 1024
_K21 = {}
tl = None   # triton.language, bound by _k21 at the first launch


# K21: one window function per row of a BLOCK-row slice, from K20's arrays
# (codes: FUNCTION_CODE, FRAME_CODE). Each row reads its own entries and at
# most one other row (the value functions' target, or dense_rank's segment
# start): no cooperation between rows. Built by _k21 with `tl` bound to
# triton.language.
def _rank_value_kernel(num_rows_ptr, seg_start_ptr, seg_len_ptr,
                       peer_start_ptr, peer_len_ptr, peer_id_ptr, x_ptr,
                       xv_ptr, d_ptr, dv_ptr, a_ptr, out_ptr, outv_ptr, cap,
                       bs, be, FN: tl.constexpr, FRAME: tl.constexpr,
                       HAS_XV: tl.constexpr, HAS_D: tl.constexpr,
                       HAS_DV: tl.constexpr, HAS_A: tl.constexpr,
                       HAS_BS: tl.constexpr, HAS_BE: tl.constexpr,
                       BLOCK: tl.constexpr):
    pid = tl.program_id(0)
    idx = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    inb = idx < cap
    live = idx < tl.load(num_rows_ptr).to(tl.int64)
    seg_start = tl.load(seg_start_ptr + idx, mask=inb, other=0)
    seg_len = tl.load(seg_len_ptr + idx, mask=inb, other=0)
    rn0 = idx - seg_start
    if FN < 6:
        if FN == 0:                                   # row_number
            res = rn0 + 1
        elif FN == 1:                                 # rank
            res = tl.load(peer_start_ptr + idx, mask=inb, other=0) \
                - seg_start + 1
        elif FN == 2:                                 # dense_rank
            at = tl.minimum(tl.maximum(seg_start, 0), cap - 1)
            res = tl.load(peer_id_ptr + idx, mask=inb, other=0).to(
                tl.int64) - tl.load(peer_id_ptr + at, mask=inb,
                                    other=0).to(tl.int64) + 1
        elif FN == 3:                                 # percent_rank
            rank = (tl.load(peer_start_ptr + idx, mask=inb, other=0)
                    - seg_start).to(tl.float64)
            denom = tl.maximum(seg_len - 1, 1).to(tl.float64)
            res = tl.where(seg_len <= 1, 0.0, rank / denom)
        elif FN == 4:                                 # cume_dist
            end0 = tl.load(peer_start_ptr + idx, mask=inb, other=0) \
                - seg_start + tl.load(peer_len_ptr + idx, mask=inb, other=0)
            res = end0.to(tl.float64) / tl.maximum(seg_len, 1).to(
                tl.float64)
        else:                                         # ntile
            k = tl.maximum(tl.load(a_ptr + idx, mask=inb, other=1).to(
                tl.int64), 1)
            base = seg_len // k
            rem = seg_len % k
            cut = rem * (base + 1)
            tile = tl.where(rn0 < cut, rn0 // tl.maximum(base + 1, 1),
                            rem + (rn0 - cut) // tl.maximum(base, 1))
            res = tile + 1
        tl.store(out_ptr + idx, res.to(out_ptr.dtype.element_ty), mask=inb)
    else:
        if FN < 8:                                    # lead, lag
            if HAS_A:
                off = tl.load(a_ptr + idx, mask=inb, other=0).to(tl.int64)
            else:
                off = idx * 0 + 1
            if FN == 6:
                tgt = idx + off
            else:
                tgt = idx - off
            ok = (tgt >= seg_start) & (tgt < seg_start + seg_len) & live
        elif FRAME == 3:                              # bounded ROWS
            seg_end = seg_start + seg_len - 1
            if HAS_BS:
                lo = tl.maximum(idx + bs, seg_start)
            else:
                lo = seg_start
            if HAS_BE:
                hi = tl.minimum(idx + be, seg_end)
            else:
                hi = seg_end
            ok = (hi >= lo) & live
            if FN == 8:
                tgt = lo
            elif FN == 9:
                tgt = hi
            else:
                tgt = lo + tl.load(a_ptr + idx, mask=inb, other=0).to(
                    tl.int64) - 1
                ok = ok & (tgt <= hi) & (tgt >= lo)
        else:
            if FRAME == 0:
                frame_end = seg_start + seg_len
            elif FRAME == 1:
                frame_end = idx + 1
            else:
                frame_end = tl.load(peer_start_ptr + idx, mask=inb,
                                    other=0) \
                    + tl.load(peer_len_ptr + idx, mask=inb, other=0)
            if FN == 8:
                tgt = seg_start
            elif FN == 9:
                tgt = frame_end - 1
            else:
                tgt = seg_start + tl.load(a_ptr + idx, mask=inb,
                                          other=0).to(tl.int64) - 1
            ok = (tgt >= seg_start) & (tgt < frame_end)
        tgt_c = tl.minimum(tl.maximum(tgt, 0), cap - 1)
        vals = tl.load(x_ptr + tgt_c, mask=inb, other=0).to(
            out_ptr.dtype.element_ty)
        valid = ok
        if HAS_XV:
            valid = valid & (tl.load(xv_ptr + tgt_c, mask=inb, other=0) != 0)
        if HAS_D:
            dvals = tl.load(d_ptr + idx, mask=inb, other=0).to(
                out_ptr.dtype.element_ty)
            vals = tl.where(ok, vals, dvals)
            if HAS_DV:
                valid = tl.where(ok, valid, tl.load(dv_ptr + idx, mask=inb,
                                                    other=0) != 0)
            else:
                valid = valid | (ok == 0)
        tl.store(out_ptr + idx, vals, mask=inb)
        tl.store(outv_ptr + idx, valid.to(tl.uint8), mask=inb)


def _k21():
    """Build (once per process) K21's Triton program.

    Replaces trino_tpu/ops/window.py `_eval` (:126) for the ranking and
    value functions, which XLA fuses into one elementwise pass with
    gathers. Bound on this card: bytes — K20's arrays the function reads,
    its argument's values and validity at one row each, the output
    written once. One program per RANK_VALUE_BLOCK rows, one thread per
    row: no reduction, no cross-row step."""
    if not _K21:
        import triton
        import triton.language as tl_mod
        globals()["tl"] = tl_mod
        # sizes and frame offsets stay runtime values: one compile per
        # function, frame and argument type, not per page or offset
        _K21["k"] = triton.jit(_rank_value_kernel,
                               do_not_specialize=["cap", "bs", "be"])
    return _K21["k"]


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def rank_value_triton(spec: WindowSpec, page: Page, b: Bounds) -> Column:
    """K21 launch: one Triton program over the page for one spec."""
    dev = page.device
    cap = page.capacity
    name = spec.name
    dummy = torch.empty(1, dtype=torch.int64, device=dev)   # never read
    x = xv = d = dv = a = dummy
    out_dict = None
    bs = be = 0
    # only first/last/nth_value read the frame
    framed = name in ("first_value", "last_value", "nth_value")
    frame = FRAME_CODE[frame_kind(spec)] if framed else 0
    bounded = framed and spec.bounds is not None
    if name in VALUE:
        col = page.column(spec.arg_channels[0])
        x, dflt, out_dict = _lead_lag_default(spec, page) \
            if name in ("lead", "lag") else (col.values, None,
                                             col.dictionary)
        xv = col.valid if col.valid is not None else dummy
        if dflt is not None:
            d = dflt.values
            dv = dflt.valid if dflt.valid is not None else dummy
        out_dtype = x.dtype if dflt is None else \
            torch.promote_types(x.dtype, d.dtype)
        if len(spec.arg_channels) > 1:
            a = page.column(spec.arg_channels[1]).values
        if bounded:
            bs = 0 if spec.bounds[0] is None else spec.bounds[0]
            be = 0 if spec.bounds[1] is None else spec.bounds[1]
    else:
        out_dtype = spec.out_type.dtype
        if name == "ntile":
            a = page.column(spec.arg_channels[0]).values
    for t in (x, xv, d, dv, a):
        if t is not dummy and (t.device != dev or t.shape != (cap,)
                               or not t.is_contiguous()):
            raise ValueError("window arguments must be contiguous "
                             "[capacity] tensors on the page's device")
    out = torch.empty(cap, dtype=out_dtype, device=dev)
    valid = torch.empty(cap, dtype=torch.bool, device=dev) \
        if name in VALUE else None
    if cap:
        _k21()[(-(-cap // RANK_VALUE_BLOCK),)](
            page.num_rows, b.seg_start, b.seg_len, b.peer_start, b.peer_len,
            b.peer_id, _as_bytes(x), _as_bytes(xv), _as_bytes(d),
            _as_bytes(dv), a, _as_bytes(out),
            _as_bytes(valid if valid is not None else dummy), cap, bs, be,
            FN=FUNCTION_CODE[name], FRAME=frame,
            HAS_XV=xv is not dummy, HAS_D=d is not dummy,
            HAS_DV=dv is not dummy, HAS_A=a is not dummy,
            HAS_BS=bounded and spec.bounds[0] is not None,
            HAS_BE=bounded and spec.bounds[1] is not None,
            BLOCK=RANK_VALUE_BLOCK, num_warps=4)
        rank_value_triton.launches += 1
    return Column(out, valid, spec.out_type, out_dict)


rank_value_triton.launches = 0


def rank_value(spec: WindowSpec, page: Page, b: Bounds) -> Column:
    """K21 wrapper: plain twin on the CPU, Triton kernel on CUDA."""
    run = rank_value_triton if page.device.type == "cuda" \
        else rank_value_plain
    return run(spec, page, b)


# ------------------------------------------------------------- K22, K23


def _segmented_scan(values: torch.Tensor, boundaries: torch.Tensor,
                    combine) -> torch.Tensor:
    """Inclusive segmented prefix scan: `combine` applied within segments,
    restarting wherever boundaries is True (the flag-value pair op, in
    log2(n) doubling steps)."""
    v, f = values, boundaries
    n = v.shape[0]
    d = 1
    while d < n:
        vb, fb = v[d:], f[d:]
        v = torch.cat([v[:d], torch.where(fb, vb, combine(v[:-d], vb))])
        f = torch.cat([f[:d], f[:-d] | fb])
        d *= 2
    return v


def _bounded_counts(cnt_contrib, seg_b, seg_start, lo, hi, nonempty, n):
    """Frame row count via prefix-sum difference (shared by every bounded
    aggregate's validity bit)."""
    prefc = _segmented_scan(cnt_contrib, seg_b, torch.add)
    c_hi = prefc[hi.clamp(0, n - 1)]
    c_lo = torch.where(lo > seg_start, prefc[(lo - 1).clamp(0, n - 1)],
                       torch.zeros_like(c_hi))
    return torch.where(nonempty, c_hi - c_lo, torch.zeros_like(c_hi))


def _neutral(name: str, dtype: torch.dtype):
    """min/max identity: +-inf for floats, the dtype's extreme for ints."""
    if dtype.is_floating_point:
        return float("inf") if name == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if name == "min" else info.min


def _agg_inputs(spec: WindowSpec, page: Page, live: torch.Tensor):
    """(x values, rows that contribute: live and not NULL)."""
    if spec.arg_channels:
        x = page.column(spec.arg_channels[0])
        return x.values, live & x.valid_mask()
    return torch.ones(page.capacity, dtype=torch.int64,
                      device=page.device), live       # count(*)


def frame_aggregate_plain(spec: WindowSpec, page: Page, b: Bounds
                          ) -> Column:
    """Plain twin of K22 (the reference's `_eval_aggregate`, :276-369):
    sum/avg/count/min/max over the spec's frame, but for a two-sided
    bounded min/max (K23's)."""
    name = spec.name
    n = page.capacity
    dev = page.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    live = page.row_mask()
    seg_start, seg_len = b.seg_start, b.seg_len
    seg_b = seg_start == idx
    seg_id = b.seg_id.to(torch.int64)
    xv, xvalid = _agg_inputs(spec, page, live)
    cnt_contrib = xvalid.to(torch.int64)
    peer_end = (b.peer_start + b.peer_len - 1).clamp(0, max(n - 1, 0))
    seg_end = (seg_start + seg_len - 1).clamp(0, max(n - 1, 0))
    if name in ("sum", "avg", "count"):
        acc = torch.float64 if xv.is_floating_point() else torch.int64
        contrib = torch.where(xvalid, xv, torch.zeros_like(xv)).to(acc)
        if spec.bounds is not None:
            lo, hi, nonempty = _bounded_range(spec, idx, seg_start, seg_len,
                                              live)
            pref = _segmented_scan(contrib, seg_b, torch.add)
            s_hi = pref[hi.clamp(0, n - 1)]
            s_lo = torch.where(lo > seg_start,
                               pref[(lo - 1).clamp(0, n - 1)],
                               torch.zeros_like(s_hi))
            sums = torch.where(nonempty, s_hi - s_lo, torch.zeros_like(s_hi))
            cnts = _bounded_counts(cnt_contrib, seg_b, seg_start, lo, hi,
                                   nonempty, n)
        elif spec.frame_whole:
            sums = torch.zeros(n, dtype=acc, device=dev).index_add_(
                0, seg_id, contrib)[seg_id]
            cnts = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
                0, seg_id, cnt_contrib)[seg_id]
        else:
            run_s = _segmented_scan(contrib, seg_b, torch.add)
            run_c = _segmented_scan(cnt_contrib, seg_b, torch.add)
            if spec.frame_rows:
                sums, cnts = run_s, run_c
            else:   # RANGE: all peers share the frame ending at peer end
                sums, cnts = run_s[peer_end], run_c[peer_end]
        dtype = spec.out_type.dtype
        if name == "count":
            return Column(cnts.to(dtype), None, spec.out_type, None)
        if name == "avg":
            c = torch.clamp(cnts, min=1)
            if dtype.is_floating_point:
                vals = sums.to(torch.float64) / c.to(torch.float64)
            else:
                # decimal average: round half away from zero at the scale
                vals = torch.sign(sums) * torch.div(
                    sums.abs() + c // 2, c, rounding_mode="floor")
            return Column(vals.to(dtype), cnts > 0, spec.out_type, None)
        return Column(sums.to(dtype), cnts > 0, spec.out_type, None)

    # min / max
    neutral = torch.tensor(_neutral(name, xv.dtype), dtype=xv.dtype,
                           device=dev)
    contrib = torch.where(xvalid, xv, neutral)
    combine = torch.minimum if name == "min" else torch.maximum
    if spec.bounds is not None:
        bs, be = spec.bounds
        lo, hi, nonempty = _bounded_range(spec, idx, seg_start, seg_len,
                                          live)
        if bs is None:
            res = _segmented_scan(contrib, seg_b, combine)[hi.clamp(0, n - 1)]
        else:   # be is None: a suffix scan, reversed, with boundaries at
            # the segment ENDS
            end_flags = torch.roll(seg_b, -1)
            end_flags[-1] = True
            run_r = _segmented_scan(torch.flip(contrib, (0,)),
                                    torch.flip(end_flags, (0,)), combine)
            res = torch.flip(run_r, (0,))[lo.clamp(0, n - 1)]
        res = torch.where(nonempty, res, neutral)
        cnts = _bounded_counts(cnt_contrib, seg_b, seg_start, lo, hi,
                               nonempty, n)
    elif spec.frame_whole:
        res = _segmented_scan(contrib, seg_b, combine)[seg_end]
        res = torch.where(seg_len > 0, res, neutral)
        cnts = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
            0, seg_id, cnt_contrib)[seg_id]
    else:
        run = _segmented_scan(contrib, seg_b, combine)
        run_c = _segmented_scan(cnt_contrib, seg_b, torch.add)
        if spec.frame_rows:
            res, cnts = run, run_c
        else:
            res, cnts = run[peer_end], run_c[peer_end]
    dictionary = page.column(spec.arg_channels[0]).dictionary \
        if spec.arg_channels else None
    return Column(res, cnts > 0, spec.out_type, dictionary)


# K22's operations and reads (csrc/window.cu ScanOp and Read)
OP_SUM, OP_MIN, OP_MAX, OP_COUNT = 0, 1, 2, 3
READ_ROWS, READ_RANGE, READ_WHOLE, READ_BOUNDED, READ_AT_HI, \
    READ_REV_AT_LO = 0, 1, 2, 3, 4, 5


def scan_plan(spec: WindowSpec) -> Tuple[int, int]:
    """K22's (operation, read) for a spec: a bounded sum/avg/count reads a
    prefix difference; a bounded min/max with an unbounded start reads
    the forward scan at the frame's end, one with an unbounded end the
    reversed scan at its start (a two-sided one is K23's)."""
    op = {"sum": OP_SUM, "avg": OP_SUM, "count": OP_COUNT, "min": OP_MIN,
          "max": OP_MAX}[spec.name]
    kind = frame_kind(spec)
    if kind != "bounded":
        return op, {"rows": READ_ROWS, "range": READ_RANGE,
                    "whole": READ_WHOLE}[kind]
    if op in (OP_SUM, OP_COUNT):
        return op, READ_BOUNDED
    return op, READ_AT_HI if spec.bounds[0] is None else READ_REV_AT_LO


def _word(value, dtype: torch.dtype) -> int:
    """A scalar as the int64 bit pattern of its accumulator word."""
    if dtype.is_floating_point:
        return torch.tensor(float(value), dtype=torch.float64).view(
            torch.int64).item()
    return int(value)


def frame_aggregate_cuda(spec: WindowSpec, page: Page, b: Bounds
                         ) -> Column:
    """K22 launch: see csrc/window.cu."""
    dev = page.device
    cap = page.capacity
    op, read = scan_plan(spec)
    if spec.arg_channels:
        col = page.column(spec.arg_channels[0])
        x, xvalid = col.values, col.valid
        if x.shape != (cap,) or not x.is_contiguous() or (
                xvalid is not None and not xvalid.is_contiguous()):
            raise ValueError("window aggregate argument must be a "
                             "contiguous [capacity] column")
        dictionary = col.dictionary
    else:
        x = xvalid = dictionary = None
    is_float = x is not None and x.is_floating_point()
    neutral = _word(_neutral(spec.name, x.dtype), x.dtype) \
        if op in (OP_MIN, OP_MAX) else 0
    dtype = spec.out_type.dtype
    avg = 0 if spec.name != "avg" else (1 if dtype.is_floating_point else 2)
    if spec.name in ("min", "max"):
        dtype = x.dtype
    out = torch.empty(cap, dtype=dtype, device=dev)
    valid = None if spec.name == "count" else torch.empty(
        cap, dtype=torch.bool, device=dev)
    ntiles = max(1, -(-cap // WINDOW_TILE))
    tiles = torch.empty((3, ntiles), dtype=torch.int64, device=dev)
    pref = torch.empty((2, max(cap, 1)), dtype=torch.int64, device=dev)
    bs, be = spec.bounds if spec.bounds is not None else (None, None)
    if cap:
        rc = native.library("window").window_scan(
            ctypes.c_void_p(page.num_rows.data_ptr()), ctypes.c_int64(cap),
            ctypes.c_void_p(0 if x is None else x.data_ptr()),
            ctypes.c_void_p(0 if xvalid is None else xvalid.data_ptr()),
            ctypes.c_int64(0 if x is None else x.element_size()),
            ctypes.c_int64(int(is_float)), ctypes.c_int64(op),
            ctypes.c_int64(read), ctypes.c_int64(int(bs is not None)),
            ctypes.c_int64(bs or 0), ctypes.c_int64(int(be is not None)),
            ctypes.c_int64(be or 0), ctypes.c_int64(neutral),
            ctypes.c_int64(avg), ctypes.c_int64(out.element_size()),
            ctypes.c_int64(int(dtype.is_floating_point)),
            *(ctypes.c_void_p(t.data_ptr()) for t in (
                b.seg_start, b.seg_len, b.peer_start, b.peer_len, tiles,
                pref)),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(0 if valid is None else valid.data_ptr()),
            ctypes.c_void_p(native.stream_ptr(dev)))
        native.check(rc, "window_scan")
        frame_aggregate_cuda.launches += 1
    return Column(out, valid, spec.out_type,
                  dictionary if spec.name in ("min", "max") else None)


frame_aggregate_cuda.launches = 0


def frame_aggregate(spec: WindowSpec, page: Page, b: Bounds) -> Column:
    """K22 wrapper: plain twin on the CPU, kernel on CUDA."""
    run = frame_aggregate_cuda if page.device.type == "cuda" \
        else frame_aggregate_plain
    return run(spec, page, b)


def _bounded_minmax(spec: WindowSpec, page: Page, b: Bounds
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K23: (values, validity) of min/max over a two-sided
    bounded ROWS frame by segmented power-of-two doubling (the
    reference's `_bounded_minmax`, :398-422): level k holds the min over
    [i, i + 2^k) within the segment, and any frame of length <= 2^(k+1)
    is two level-k reads. Empty frames give the neutral value; a frame is
    valid where it holds a non-NULL row."""
    name = spec.name
    n = page.capacity
    dev = page.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    live = page.row_mask()
    xv, xvalid = _agg_inputs(spec, page, live)
    neutral = torch.tensor(_neutral(name, xv.dtype), dtype=xv.dtype,
                           device=dev)
    contrib = torch.where(xvalid, xv, neutral)
    combine = torch.minimum if name == "min" else torch.maximum
    bs, be = spec.bounds
    lo, hi, nonempty = _bounded_range(spec, idx, b.seg_start, b.seg_len,
                                      live)
    lo_c = lo.clamp(0, n - 1)
    seg_id = b.seg_id
    k_max = max((be - bs + 1).bit_length() - 1, 0)
    levels = [contrib]
    step = 1
    for _ in range(k_max):
        prev = levels[-1]
        ahead = (idx + step).clamp(0, n - 1)
        same = ((idx + step) < n) & (seg_id[ahead] == seg_id)
        levels.append(combine(prev, torch.where(same, prev[ahead], neutral)))
        step *= 2
    flat = torch.stack(levels).reshape(-1)
    length = torch.clamp(hi - lo + 1, min=1)
    k = torch.zeros(n, dtype=torch.int64, device=dev)
    for j in range(1, k_max + 1):
        k = k + (length >= (1 << j)).to(torch.int64)
    p2 = (hi - (1 << k) + 1).clamp(0, n - 1)
    res = combine(flat[k * n + lo_c], flat[k * n + p2])
    cnts = _bounded_counts(xvalid.to(torch.int64), b.seg_start == idx,
                           b.seg_start, lo, hi, nonempty, n)
    return torch.where(nonempty, res, neutral), cnts > 0


def bounded_minmax_cuda(spec: WindowSpec, page: Page, b: Bounds,
                        nlevels: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K23 launch: see csrc/window.cu. `nlevels` rows of doubling table
    (by default as many as window.cu asks for the frame: 0, its halo
    path, for a narrow one); a narrow frame given levels runs the table."""
    dev = page.device
    cap = page.capacity
    col = page.column(spec.arg_channels[0])
    x = col.values
    if x.shape != (cap,) or not x.is_contiguous() or (
            col.valid is not None and not col.valid.is_contiguous()):
        raise ValueError("window min/max argument must be a contiguous "
                         "[capacity] column")
    bs, be = spec.bounds
    lib = native.library("window")
    if nlevels is None:
        nlevels = lib.window_minmax_levels(ctypes.c_int64(bs),
                                           ctypes.c_int64(be))
    levels = torch.empty(nlevels * cap, dtype=torch.int64, device=dev)
    any_levels = torch.empty(nlevels * cap, dtype=torch.uint8, device=dev)
    out = torch.empty(cap, dtype=x.dtype, device=dev)
    valid = torch.empty(cap, dtype=torch.bool, device=dev)
    if cap:
        rc = lib.window_minmax(
            ctypes.c_void_p(page.num_rows.data_ptr()), ctypes.c_int64(cap),
            ctypes.c_void_p(x.data_ptr()),
            ctypes.c_void_p(0 if col.valid is None
                            else col.valid.data_ptr()),
            ctypes.c_int64(x.element_size()),
            ctypes.c_int64(int(x.is_floating_point())),
            ctypes.c_int64(int(spec.name == "max")), ctypes.c_int64(bs),
            ctypes.c_int64(be), ctypes.c_int64(
                _word(_neutral(spec.name, x.dtype), x.dtype)),
            ctypes.c_void_p(b.seg_start.data_ptr()),
            ctypes.c_void_p(b.seg_len.data_ptr()),
            ctypes.c_void_p(b.seg_id.data_ptr()),
            ctypes.c_void_p(levels.data_ptr() if nlevels else 0),
            ctypes.c_void_p(any_levels.data_ptr() if nlevels else 0),
            ctypes.c_int64(nlevels), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(valid.data_ptr()),
            ctypes.c_void_p(native.stream_ptr(dev)))
        native.check(rc, "window_minmax")
        bounded_minmax_cuda.launches += 1
    return out, valid


bounded_minmax_cuda.launches = 0


def bounded_minmax(spec: WindowSpec, page: Page, b: Bounds
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K23 wrapper: plain twin on the CPU, kernel on CUDA."""
    run = bounded_minmax_cuda if page.device.type == "cuda" \
        else _bounded_minmax
    return run(spec, page, b)


def two_sided_minmax(spec: WindowSpec) -> bool:
    """min/max over a bounded ROWS frame with both ends bounded (K23's)."""
    return spec.name in ("min", "max") and spec.bounds is not None \
        and None not in spec.bounds


def _eval_aggregate(spec: WindowSpec, page: Page, b: Bounds) -> Column:
    """sum/avg/count/min/max over the spec's frame: K23 for a two-sided
    bounded min/max, K22 for every other."""
    if two_sided_minmax(spec):
        values, valid = bounded_minmax(spec, page, b)
        return Column(values, valid, spec.out_type,
                      page.column(spec.arg_channels[0]).dictionary)
    return frame_aggregate(spec, page, b)
