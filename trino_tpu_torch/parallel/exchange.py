"""Collective exchanges over a shard list: the shuffle data plane.

Port of `trino_tpu/parallel/exchange.py` (B12). The reference runs these
inside a shard_map, as XLA collectives over the mesh axis; here each
takes the whole list of per-shard pages (one per worker, on the worker's
device) and returns the list the workers receive, with the reference's
contracts:

  all_to_all_by_key    : FIXED_HASH_DISTRIBUTION. K35 routes each source's
                         rows (mix64 of the join-key word mod n, NULL keys
                         to shard 0, heavy keys spread by row in spread
                         mode) into fixed per-destination buckets, stable
                         within a destination; the receive (K2) gives each
                         destination min(count, bucket) rows of every
                         source in source order, in a page of capacity
                         n x bucket, and the overflow sum(max(count -
                         bucket, 0)) is returned for the capacity ladder.
  all_to_all_replicate : the build half of the skew-aware pair: heavy rows
                         go to every destination.
  detect_heavy_keys    : K10 sorts each shard's masked key words, K36's
                         local mode keeps each shard's k longest runs, the
                         n x k candidates gather shard-major onto shard 0's
                         device and K36's merge mode picks the global
                         heavy set (u64 words as int64, the sentinel -1).
  broadcast_page       : FIXED_BROADCAST: every shard's live rows in shard
                         order (K2), capacity n x cap.
  gather_page          : SINGLE: the same; shard 0 consumes.

`bucket_capacity` may be a function of the largest source -> destination
count: K35's count pass gives every count before any row moves, so the
caller takes the bucket its capacity ladder would end on from one fetch
instead of re-running the exchange. Every column a repartition returns has
a validity mask (true on the live rows it had, false on padding), as the
reference's scattered columns have.

On the CPU each kernel wrapper runs its plain PyTorch twin; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import array
import ctypes
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

from trino_tpu_torch import native
from trino_tpu_torch.ops.join import _C1, _C2, _key_cols, _key_table, _srl
from trino_tpu_torch.page import (Column, Page, device_concat, host_table,
                                  row_count)
from trino_tpu_torch.parallel.mesh import to_device

SENTINEL = -1          # u64 2^64 - 1 as an int64 word
MODE_HASH, MODE_SPREAD, MODE_REPLICATE = 0, 1, 2
MAX_HEAVY = 64         # csrc/exchange.cu MAX_HEAVY
MAX_DESTINATIONS = 64  # csrc/exchange.cu MAX_N
TILE = 4096            # csrc/tile.cuh TILE
HEAVY_TILE = 4096      # csrc/exchange.cu HL_TILE: words of a K36 tile
HEAVY_GRID_MAX = 256   # csrc/exchange.cu HL_GRID_MAX
_HEAVY_SCRATCH: dict = {}  # device index -> K36's partials and ticket
_HEAVY_ARGS = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
               ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
               ctypes.c_void_p)
SCATTER_WARPS = 8      # csrc/exchange.cu SC_WARPS: warps of a tile's block
SCATTER_STAGE = 4096   # csrc/exchange.cu SC_STAGE: positions of a window
SCATTER_ALIGN = 256    # bytes between the starts of two output arrays
SCATTER_MAX_ARRAYS = native.TABLE_MAX // 3
_SCATTER_ARGS = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                 ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                 ctypes.c_void_p)

Bucket = Union[int, Callable[[int], int]]


def _mix64(x: torch.Tensor) -> torch.Tensor:
    x = (x ^ _srl(x, 30)) * _C1
    x = (x ^ _srl(x, 27)) * _C2
    return x ^ _srl(x, 31)


def _umod(x: torch.Tensor, n: int) -> torch.Tensor:
    """int64 words read as uint64, mod n (n < 2^31)."""
    return ((_srl(x, 1) % n) * 2 + (x & 1)) % n


def _is_heavy(key: torch.Tensor, heavy: torch.Tensor) -> torch.Tensor:
    """Row mask: key word appears in the (sentinel-padded) heavy set."""
    hk = heavy.to(key.device)[None, :]
    return ((key[:, None] == hk) & (hk != SENTINEL)).any(dim=1)


def key_columns(page: Page, key_channels: Sequence[int]):
    return [(page.column(ch).values.contiguous(), page.column(ch).valid)
            for ch in key_channels]


# ------------------------------------------------------------------ K35


def exchange_count_plain(key_cols, num_rows: torch.Tensor, n: int,
                         mode: int, heavy: Optional[torch.Tensor]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K35's count pass: (dest int32[cap], counts
    int64[n]). dest is the reference's _partition_of (-1: every
    destination, a heavy row in replicate mode; n: a dead row); counts[d]
    the rows bound for d."""
    key, null = _key_cols(key_cols)
    cap = key.shape[0]
    dev = key.device
    idx = torch.arange(cap, dtype=torch.int64, device=dev)
    h = _mix64(key)
    dest = torch.where(null, torch.zeros_like(h), _umod(h, n))
    if mode != MODE_HASH and heavy is not None:
        hv = _is_heavy(key, heavy) & ~null
        other = _umod(h + idx, n) if mode == MODE_SPREAD \
            else torch.full_like(h, -1)
        dest = torch.where(hv, other, dest)
    dest = torch.where(idx < num_rows.to(torch.int64), dest,
                       torch.full_like(dest, n)).to(torch.int32)
    counts = torch.stack([((dest == d) | (dest == -1)).sum(dtype=torch.int64)
                          for d in range(n)]) if n else \
        torch.zeros(0, dtype=torch.int64, device=dev)
    return dest, counts


def exchange_scatter_plain(dest: torch.Tensor, arrays, n: int, bucket: int
                           ) -> List[torch.Tensor]:
    """Plain twin of K35's scatter pass: per destination d its rows in
    source order, the first `bucket` of them at d * bucket + rank of every
    array (None: a validity written as true); the other slots zero."""
    dev = dest.device
    outs = []
    for a, like in arrays:
        shape = (n * bucket,) + tuple(like.shape[1:])
        outs.append(torch.zeros(shape, dtype=like.dtype, device=dev))
    for d in range(n):
        m = (dest == d) | (dest == -1)
        rank = torch.cumsum(m.to(torch.int64), 0) - 1
        ok = m & (rank < bucket)
        slot = d * bucket + rank[ok]
        for (a, _), o in zip(arrays, outs):
            o[slot] = True if a is None else a[ok]
    return outs


def exchange_count_cuda(key_cols, num_rows: torch.Tensor, n: int, mode: int,
                        heavy: Optional[torch.Tensor]):
    """K35's count pass: see csrc/exchange.cu. Returns ((dest, hist,
    num_rows, mode), counts int64[n]); the state feeds
    exchange_scatter_cuda, which reads num_rows on the device."""
    from trino_tpu_torch.ops.join import _check_key_cols
    cap = key_cols[0][0].shape[0]
    dev = num_rows.device
    _check_key_cols(key_cols, cap, dev)
    if num_rows.dtype != torch.int32 or num_rows.dim() != 0:
        raise ValueError("num_rows must be a 0-d int32 tensor")
    if not 1 <= n <= MAX_DESTINATIONS:
        raise ValueError(f"{n} destinations: 1 to {MAX_DESTINATIONS}")
    k = 0 if heavy is None or mode == MODE_HASH else heavy.numel()
    if k > MAX_HEAVY:
        raise ValueError(f"{k} heavy keys: at most {MAX_HEAVY}")
    hv = None if k == 0 else heavy.to(device=dev,
                                      dtype=torch.int64).contiguous()
    dest = torch.empty(max(cap, 1), dtype=torch.int32, device=dev)
    ntiles = max(1, -(-cap // TILE))
    hist = torch.empty(n * ntiles + 1, dtype=torch.int64, device=dev)
    counts = torch.empty(n, dtype=torch.int64, device=dev)
    rc = native.library("exchange").exchange_count(
        host_table(_key_table(key_cols)), ctypes.c_int64(len(key_cols)),
        ctypes.c_int64(cap), ctypes.c_void_p(num_rows.data_ptr()),
        ctypes.c_int64(n), ctypes.c_int64(mode),
        ctypes.c_void_p(0 if hv is None else hv.data_ptr()),
        ctypes.c_int64(k), ctypes.c_void_p(dest.data_ptr()),
        ctypes.c_void_p(hist.data_ptr()), ctypes.c_void_p(counts.data_ptr()),
        ctypes.c_void_p(native.stream_ptr(dev)))
    native.check(rc, "exchange_count")
    exchange_count_cuda.launches += 1
    return (dest[:cap], hist, num_rows, mode), counts


exchange_count_cuda.launches = 0


def scatter_layout(arrays, n: int, bucket: int):
    """K35's outputs in one allocation, the arrays of one dtype and row
    shape side by side as the rows of one block: [(byte offset, dtype, row
    shape, row bytes, array indices)] per block, each block's start
    SCATTER_ALIGN-aligned, and the allocation's bytes. A row of an array
    starts at a multiple of its row bytes from its block's start."""
    blocks = {}
    for i, (_, like) in enumerate(arrays):
        blocks.setdefault((like.dtype, tuple(like.shape[1:])), []).append(i)
    out, at = [], 0
    for (dtype, rshape), idx in blocks.items():
        rb = dtype.itemsize
        for d in rshape:
            rb *= d
        out.append((at, dtype, rshape, rb, idx))
        at += -(-len(idx) * n * bucket * rb // SCATTER_ALIGN) * SCATTER_ALIGN
    return out, at


def exchange_scatter_cuda(state, arrays, n: int, bucket: int
                          ) -> List[torch.Tensor]:
    """K35's scatter pass: see csrc/exchange.cu. One launch; the outputs
    are views of one allocation (scatter_layout)."""
    dest, hist, num_rows, mode = state
    cap = dest.shape[0]
    index = dest.get_device()
    if index < 0:
        raise ValueError("K35's state must be on a CUDA device")
    if not 1 <= n <= MAX_DESTINATIONS or bucket < 1:
        raise ValueError(f"{n} destinations, bucket {bucket}")
    if len(arrays) > SCATTER_MAX_ARRAYS:
        raise ValueError(f"{len(arrays)} arrays: one launch's table holds "
                         f"{SCATTER_MAX_ARRAYS}")
    for a, like in arrays:
        if a is not None and (a.get_device() != index or a.shape[0] != cap
                              or a.dtype != like.dtype
                              or not a.is_contiguous()):
            raise ValueError(f"array {a.dtype}{tuple(a.shape)} does not "
                             "match the page")
    layout, nbytes = scatter_layout(arrays, n, bucket)
    buf = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=dest.device)
    base, rows = buf.data_ptr(), n * bucket
    outs: List[Optional[torch.Tensor]] = [None] * len(arrays)
    words = array.array("q", bytes(24 * len(arrays)))
    for at, dtype, rshape, rb, idx in layout:
        block = buf[at:at + len(idx) * rows * rb].view(dtype).view(
            (len(idx), rows) + rshape)
        for j, (i, o) in enumerate(zip(idx, block.unbind(0))):
            a = arrays[i][0]
            outs[i] = o
            words[3 * i] = 0 if a is None else a.data_ptr()
            words[3 * i + 1] = base + at + j * rows * rb
            words[3 * i + 2] = rb
    rc = native.function("exchange", "exchange_scatter", _SCATTER_ARGS)(
        dest.data_ptr(), cap, n, hist.data_ptr(), num_rows.data_ptr(), mode,
        bucket, words.buffer_info()[0], len(arrays),
        native.raw_stream(index))
    native.check(rc, "exchange_scatter")
    exchange_scatter_cuda.launches += 1
    return outs


exchange_scatter_cuda.launches = 0


def scatter_offsets_plain(dest: torch.Tensor, num_rows, n: int,
                          tile: int = TILE) -> torch.Tensor:
    """The count pass's scanned offsets (its `hist`): per (destination,
    tile), destination-major, the members of d before the tile in the
    whole page (a replicated row a member of every destination; rows at
    and past num_rows of none), then the total."""
    cap = dest.shape[0]
    ntiles = max(1, -(-cap // tile))
    live = torch.arange(cap) < int(num_rows)
    counts = torch.zeros((n, ntiles), dtype=torch.int64)
    tiles = torch.arange(cap) // tile
    for d in range(n):
        m = ((dest == d) | (dest == -1)) & live
        counts[d].index_add_(0, tiles[m], torch.ones(int(m.sum()),
                                                      dtype=torch.int64))
    flat = counts.reshape(-1)
    return torch.cat([torch.cumsum(flat, 0) - flat, flat.sum().view(1)])


def scatter_launch_model(dest, hist, num_rows: int, mode: int, cols,
                         n: int, bucket: int, tile: int = TILE,
                         warps: int = SCATTER_WARPS,
                         stage: int = SCATTER_STAGE) -> dict:
    """NumPy model of K35's scatter launch (csrc/exchange.cu scatter_kernel)
    over tiles of `tile` rows, `warps` warps a tile's block taking rounds
    of 32 rows, windows of `stage` positions. `dest` int32[cap] and `hist`
    (the count pass's offsets) as numpy arrays; `cols` [(source bytes
    (cap, rb) or None, destination bytes (n * bucket, rb))], written in
    place. Returns stats: tiles run, the furthest dest word and source
    row read, windows, replicated passes, staged and direct array moves,
    and the largest window."""
    import numpy as np
    cap = dest.shape[0]
    live = max(0, min(int(num_rows), cap))
    ntiles = max(1, -(-cap // tile))
    rounds = tile // warps // 32
    drop = 0xFF
    stats = dict(tiles=0, read=-1, windows=0, rep_passes=0, staged=0,
                 direct=0, widest=0)
    lanes = np.arange(32)

    def ballot_rank(m):
        """Each lane's members below it, and the round's members."""
        return np.cumsum(m) - m, int(m.sum())
    for b in range(ntiles):
        base = b * tile
        if base >= live:
            continue          # the block returns at once
        rows = min(tile, live - base)
        stats["tiles"] += 1
        stats["read"] = max(stats["read"], base + rows - 1)
        dv = np.full(tile, n, dtype=np.int64)
        dv[:rows] = dest[base:base + rows]
        dv = dv.reshape(warps, rounds, 32)
        rep = dv == -1 if mode == MODE_REPLICATE else np.zeros_like(dv,
                                                                   bool)
        pos = np.zeros_like(dv)
        wcount = np.zeros((warps, n), dtype=np.int64)
        # 1. ranks from ballots, destination by destination
        for w in range(warps):
            for d in range(n):
                run = 0
                for r in range(rounds):
                    m = (dv[w, r] == d) | rep[w, r]
                    ex, c = ballot_rank(m)
                    mine = dv[w, r] == d
                    pos[w, r][mine] = run + ex[mine]
                    run += c
                wcount[w, d] = run
        # 2. the scan over (destination, warp)
        wbase = np.cumsum(wcount, 0) - wcount
        cnt = wcount.sum(0)
        sbase = np.concatenate([[0], np.cumsum(cnt)])
        total = int(sbase[n])
        rank0 = np.array([hist[d * ntiles + b] - hist[d * ntiles]
                          for d in range(n)], dtype=np.int64)
        dslot0 = np.arange(n) * bucket + rank0 - sbase[:n]
        hashed = (dv >= 0) & (dv < n)
        dd = np.where(hashed, dv, 0)
        p_all = np.where(hashed, sbase[dd] + wbase[np.arange(warps)[:, None,
                                                                  None], dd]
                         + pos, -1)
        trow = (np.arange(warps)[:, None, None] * (tile // warps)
                + np.arange(rounds)[None, :, None] * 32 + lanes)
        # 3. windows
        for w0 in range(0, total, stage):
            wlen = min(stage, total - w0)
            stats["windows"] += 1
            stats["widest"] = max(stats["widest"], wlen)
            srow = np.full(wlen, -1, dtype=np.int64)
            sdst = np.full(wlen, -1, dtype=np.int64)
            writes = np.zeros(wlen, dtype=np.int64)

            def place(p, row, d):
                q = p - w0
                if 0 <= q < wlen:
                    srow[q] = row
                    sdst[q] = d if rank0[d] + p - sbase[d] < bucket \
                        else drop
                    writes[q] += 1
            q = p_all - w0
            sel = hashed & (q >= 0) & (q < wlen)
            qs, ds = q[sel], dv[sel]
            srow[qs] = trow[sel]
            sdst[qs] = np.where(rank0[ds] + p_all[sel] - sbase[ds] < bucket,
                                ds, drop)
            np.add.at(writes, qs, 1)
            if mode == MODE_REPLICATE and rep.any():
                for d in range(n):
                    if sbase[d + 1] <= w0 or sbase[d] >= w0 + wlen:
                        continue
                    stats["rep_passes"] += 1
                    for w in range(warps):
                        run = int(wbase[w, d])
                        for r in range(rounds):
                            m = (dv[w, r] == d) | rep[w, r]
                            ex, c = ballot_rank(m)
                            for lane in np.nonzero(rep[w, r])[0]:
                                place(int(sbase[d] + run + ex[lane]),
                                      int(trow[w, r, lane]), d)
                            run += c
            assert (writes == 1).all(), "a window position set twice or never"
            kept = sdst != drop
            slots = dslot0[sdst[kept]] + w0 + np.nonzero(kept)[0]
            for src, dst in cols:
                if src is None:
                    dst[slots] = 1
                    continue
                if src.shape[1] in (1, 2, 4, 8):
                    stats["staged"] += 1
                else:
                    stats["direct"] += 1
                dst[slots] = src[base + srow[kept]]
    return stats


def exchange_count(key_cols, num_rows, n, mode, heavy):
    """K35's count pass: plain twin on the CPU, kernel on CUDA. Returns
    (state for exchange_scatter, counts int64[n] on the device)."""
    if num_rows.is_cuda:
        return exchange_count_cuda(key_cols, num_rows, n, mode, heavy)
    dest, counts = exchange_count_plain(key_cols, num_rows, n, mode, heavy)
    return dest, counts


def exchange_scatter(state, arrays, n, bucket):
    """K35's scatter pass: plain twin on the CPU, kernel on CUDA."""
    if isinstance(state, tuple):
        return exchange_scatter_cuda(state, arrays, n, bucket)
    return exchange_scatter_plain(state, arrays, n, bucket)


# ------------------------------------------------------------------ K36


def _sorted_words(words: torch.Tensor) -> torch.Tensor:
    """u64 words (int64) in unsigned ascending order: K10 on CUDA."""
    if words.is_cuda:
        from trino_tpu_torch.ops.sort import sort_u64_cuda
        return sort_u64_cuda(words.contiguous())
    lo = torch.iinfo(torch.int64).min
    return torch.sort(words ^ lo, stable=True).values ^ lo


def heavy_local_plain(sorted_words: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K36's local mode: (counts int64[k], keys int64[k]),
    the reference's run lengths at run starts of non-sentinel words and
    lax.top_k of them (count descending, the lower position first)."""
    s = sorted_words
    cap = s.shape[0]
    dev = s.device
    if cap == 0:
        return (torch.zeros(k, dtype=torch.int64, device=dev),
                torch.full((k,), SENTINEL, dtype=torch.int64, device=dev))
    idx = torch.arange(cap, dtype=torch.int64, device=dev)
    boundary = s != torch.roll(s, 1)
    boundary[0] = True
    run_start = torch.cummax(torch.where(boundary, idx, 0), 0).values
    nxt = torch.where(boundary, idx, torch.full_like(idx, cap))
    suffix_min = torch.flip(torch.cummin(torch.flip(nxt, (0,)), 0).values,
                            (0,))
    next_start = torch.cat([suffix_min[1:],
                            torch.full((1,), cap, dtype=torch.int64,
                                       device=dev)])
    run_len = next_start - run_start
    cand = torch.where(boundary & (s != SENTINEL), run_len,
                       torch.zeros_like(run_len))
    top = torch.argsort(-cand, stable=True)[:k]
    counts, keys = cand[top], s[top]
    if top.shape[0] < k:
        pad = k - top.shape[0]
        counts = torch.cat([counts, torch.zeros(pad, dtype=torch.int64,
                                                device=dev)])
        keys = torch.cat([keys, torch.full((pad,), SENTINEL,
                                           dtype=torch.int64, device=dev)])
    return counts, keys


def heavy_local_model(sorted_words: torch.Tensor, k: int,
                      tile: int = HEAVY_TILE, grid_max: int = HEAVY_GRID_MAX,
                      per_thread: int = 8):
    """NumPy model of K36's local-mode launch (csrc/exchange.cu
    heavy_local_kernel) over `tile`-word tiles of `per_thread` words a
    thread. Returns (counts, keys, stats): stats counts the tiles walked,
    the tiles the threshold skipped, the searches past a tile's end and
    the furthest position a tile read (the live prefix's end L, the
    sentinel tail never), besides L and the grid."""
    import numpy as np
    s = sorted_words.cpu().numpy().view(np.uint64)
    cap = s.shape[0]
    grid = max(1, min(grid_max, -(-cap // tile)))
    live = int(np.searchsorted(s, np.uint64(2**64 - 1)))  # first sentinel
    stats = dict(live=live, grid=grid, tiles=0, skipped=0, searches=0,
                 furthest=-1)
    no_start = 1 << 32

    def score(count, pos):
        return ((count << 32) | (0xFFFFFFFF - pos)) + 1
    partials = []
    for b in range(grid):
        held, kth = [], 0         # the block's best so far, descending
        for t0 in range(b * tile, live, grid * tile):
            t1 = min(t0 + tile, live)
            stats["tiles"] += 1
            w = s[t0:t1]
            prev = np.concatenate([s[t0 - 1:t0] if t0 else w[:1] + 1,
                                   w[:-1]])
            start = w != prev
            # the end of the run holding the tile's last word
            e_tile = live
            if t1 < live:
                stats["searches"] += 1
                e_tile = t1 + int(np.searchsorted(s[t1:live], w[-1],
                                                  side="right"))
            stats["furthest"] = max(stats["furthest"], e_tile - 1, t1 - 1)
            # each thread's first start; the first start of a later thread
            offs = np.arange(t1 - t0)
            first = np.full(-(-tile // per_thread) + 1, no_start)
            np.minimum.at(first, offs[start] // per_thread, offs[start])
            after = np.minimum.accumulate(first[::-1])[::-1][1:]
            scores = [0] * (t1 - t0)
            for t in range(-(-(t1 - t0) // per_thread)):
                end = t0 + int(after[t]) if after[t] != no_start else e_tile
                for o in range(min((t + 1) * per_thread, t1 - t0) - 1,
                               t * per_thread - 1, -1):
                    count = 0
                    if start[o]:       # the run ends at the next start
                        count, end = end - (t0 + o), t0 + o
                    scores[o] = score(count, t0 + o)
            if max(scores) <= kth:      # the tile beats none of the k held
                stats["skipped"] += 1
                continue
            held = sorted(held + scores, reverse=True)[:k]
            kth = held[-1] if len(held) == k else 0
        partials.append(held + [0] * (k - len(held)))
    # the last block: k rounds over the lists' heads, the sentinel tail
    # (positions live, live + 1, ... with count 0) as one more list
    tail = [score(0, p) for p in range(live, min(live + k, cap))]
    lists = partials + [tail + [0] * (k - len(tail))]
    heads = [0] * len(lists)
    counts, keys = [], []
    for _ in range(k):
        j = max(range(len(lists)), key=lambda i: lists[i][heads[i]]
                if heads[i] < k else 0)
        m = lists[j][heads[j]] if heads[j] < k else 0
        if m == 0:
            break
        heads[j] += 1
        counts.append((m - 1) >> 32)
        keys.append(int(s[0xFFFFFFFF - ((m - 1) & 0xFFFFFFFF)]))
    counts += [0] * (k - len(counts))
    keys += [2**64 - 1] * (k - len(keys))
    keys = np.array(keys, dtype=np.uint64).view(np.int64)
    return (torch.tensor(counts, dtype=torch.int64),
            torch.from_numpy(keys.copy()), stats)


def heavy_merge_plain(keys: torch.Tensor, counts: torch.Tensor, k: int,
                      min_global_count: int) -> torch.Tensor:
    """Plain twin of K36's merge mode over the shard-major candidates:
    the reference's global sums, first occurrences, threshold and top_k,
    the sentinel past the heavy keys."""
    m = keys.shape[0]
    eq = keys[:, None] == keys[None, :]
    glob = (eq.to(torch.int64) * counts[None, :]).sum(dim=1)
    ar = torch.arange(m, device=keys.device)
    first = ~(eq & (ar[None, :] < ar[:, None])).any(dim=1)
    score = torch.where((keys != SENTINEL) & first
                        & (glob >= min_global_count), glob,
                        torch.full_like(glob, -1))
    sel = torch.argsort(-score, stable=True)[:k]
    return torch.where(score[sel] > 0, keys[sel],
                       torch.full_like(keys[sel], SENTINEL))


def heavy_grid(cap: int) -> int:
    """Blocks of K36's local-mode grid: one per HEAVY_TILE words of
    capacity, at most HEAVY_GRID_MAX (csrc/exchange.cu HL_GRID_MAX). It
    depends on the capacity alone; the blocks find the live prefix
    themselves."""
    return max(1, min(HEAVY_GRID_MAX, -(-cap // HEAVY_TILE)))


def _heavy_scratch(index: int) -> torch.Tensor:
    """K36's local-mode scratch on CUDA device `index`: the grid's k-word
    partials (HEAVY_GRID_MAX x MAX_HEAVY words), then the ticket word,
    zero between calls (the last block resets it). Calls share it, so
    they must be ordered on one stream: the executor issues every launch
    from one host thread on the device's current stream, the mesh's
    shards over one card one after another."""
    scratch = _HEAVY_SCRATCH.get(index)
    if scratch is None:
        scratch = _HEAVY_SCRATCH[index] = torch.zeros(
            HEAVY_GRID_MAX * MAX_HEAVY + 1, dtype=torch.int64,
            device=torch.device("cuda", index))
    return scratch


def heavy_local_cuda(sorted_words: torch.Tensor, k: int):
    """K36's local mode: see csrc/exchange.cu. One launch; counts and keys
    are the two halves of one int64[2k] allocation."""
    index = sorted_words.get_device()
    if index < 0:
        raise ValueError("K36's sorted words must be on a CUDA device")
    if not 1 <= k <= MAX_HEAVY:
        raise ValueError(f"k = {k}: 1 to {MAX_HEAVY}")
    if sorted_words.dtype is not torch.int64 or sorted_words.dim() != 1 \
            or not sorted_words.is_contiguous():
        raise ValueError("sorted words must be contiguous int64")
    cap = sorted_words.shape[0]
    if cap >= 1 << 32:
        raise ValueError(f"{cap} words: K36 scores positions in 32 bits")
    scratch = _heavy_scratch(index)
    out = torch.empty(2 * k, dtype=torch.int64, device=sorted_words.device)
    rc = native.function("exchange", "heavy_local", _HEAVY_ARGS)(
        sorted_words.data_ptr(), cap, k, scratch.data_ptr(), out.data_ptr(),
        heavy_grid(cap), native.raw_stream(index))
    native.check(rc, "heavy_local")
    heavy_local_cuda.launches += 1
    return out.view(2, k).unbind(0)


heavy_local_cuda.launches = 0


def heavy_merge_cuda(keys: torch.Tensor, counts: torch.Tensor, k: int,
                     min_global_count: int) -> torch.Tensor:
    """K36's merge mode: see csrc/exchange.cu."""
    dev = keys.device
    m = keys.shape[0]
    if not 1 <= k <= MAX_HEAVY or m >= 1 << 20:
        raise ValueError(f"k = {k}, {m} candidates")
    keys = keys.to(torch.int64).contiguous()
    counts = counts.to(device=dev, dtype=torch.int64).contiguous()
    heavy = torch.empty(k, dtype=torch.int64, device=dev)
    rc = native.library("exchange").heavy_merge(
        ctypes.c_void_p(keys.data_ptr()), ctypes.c_void_p(counts.data_ptr()),
        ctypes.c_int64(m), ctypes.c_int64(k),
        ctypes.c_int64(int(min_global_count)),
        ctypes.c_void_p(heavy.data_ptr()),
        ctypes.c_void_p(native.stream_ptr(dev)))
    native.check(rc, "heavy_merge")
    heavy_merge_cuda.launches += 1
    return heavy


heavy_merge_cuda.launches = 0


def heavy_local(sorted_words, k):
    """K36 local-mode wrapper: plain twin on the CPU, kernel on CUDA."""
    run = heavy_local_cuda if sorted_words.is_cuda else heavy_local_plain
    return run(sorted_words, k)


def heavy_merge(keys, counts, k, min_global_count):
    """K36 merge-mode wrapper: plain twin on the CPU, kernel on CUDA."""
    run = heavy_merge_cuda if keys.is_cuda else heavy_merge_plain
    return run(keys, counts, k, min_global_count)


# ------------------------------------------------------------ collectives


def detect_heavy_keys(pages: List[Page], key_channels: Sequence[int],
                      k: int, min_global_count: int
                      ) -> List[torch.Tensor]:
    """Globally frequent keys (JSPIM's heavy-hitter pre-pass): each shard
    sorts its live non-NULL key words, keeps its k most frequent as
    candidates; the n x k candidates gather shard-major onto shard 0's
    device, and the keys whose summed count reaches min_global_count come
    back, [k] words padded with the sentinel, one copy per shard device.
    A truly heavy key is in the local top k of every shard where it is
    frequent, so the sum is exact for the keys that matter."""
    cand_keys, cand_counts = [], []
    home = pages[0].device
    for page in pages:
        key, null = _key_cols(key_columns(page, key_channels))
        live = page.row_mask() & ~null
        masked = torch.where(live, key, torch.full_like(key, SENTINEL))
        counts, keys = heavy_local(_sorted_words(masked), k)
        cand_keys.append(keys.to(home, non_blocking=True))
        cand_counts.append(counts.to(home, non_blocking=True))
    heavy = heavy_merge(torch.cat(cand_keys), torch.cat(cand_counts), k,
                        min_global_count)
    copies = {}
    return [copies.setdefault(p.device, heavy.to(p.device,
                                                 non_blocking=True))
            for p in pages]


def _moved_arrays(page: Page):
    """Each column's movable arrays for K35, validity always present (an
    absent one written as true): [(array or None, template)]."""
    out = []
    for c in page.columns:
        out.append((c.values, c.values))
        out.append((c.valid, c.valid if c.valid is not None
                    else torch.empty(0, dtype=torch.bool,
                                     device=c.values.device)))
        out += [(a, a) for a in (c.lengths, c.aux) if a is not None]
    return out


def _rebuild_valid(ref: Page, moved: List[torch.Tensor]) -> Tuple[Column, ...]:
    it = iter(moved)
    cols = []
    for c in ref.columns:
        values, valid = next(it), next(it)
        lengths = next(it) if c.lengths is not None else None
        aux = next(it) if c.aux is not None else None
        cols.append(Column(values, valid, c.type, c.dictionary, lengths, aux,
                           c.aux_dictionary))
    return tuple(cols)


class ExchangePlan:
    """K35's count pass over every source: the per-source states the
    scatter reads and the n x n counts on the host (counts[s][d]: rows of
    source s bound for destination d)."""

    def __init__(self, states, counts: List[List[int]], live: List[int]):
        self.states = states
        self.counts = counts
        self.live = live

    @property
    def largest(self) -> int:
        """The largest source -> destination count (what a bucket must
        hold for no row to overflow)."""
        return max((c for row in self.counts for c in row), default=0)

    @property
    def rows(self) -> int:
        """The sources' live rows (a replicated row counts once)."""
        return sum(self.live)


def exchange_plan(pages: List[Page], key_channels: Sequence[int], mode: int,
                  heavy: Optional[List[torch.Tensor]]) -> ExchangePlan:
    """K35's count pass on every source, then one fetch of the n x n
    counts and the sources' live rows (one fetch per device where the
    shards' devices differ)."""
    n = len(pages)
    states, counts_dev = [], []
    for s, page in enumerate(pages):
        state, counts = exchange_count(
            key_columns(page, key_channels), page.num_rows, n, mode,
            None if heavy is None else heavy[s])
        states.append(state)
        counts_dev.append(torch.cat([counts, page.num_rows.view(1).to(
            torch.int64)]))
    fetched = _fetch(counts_dev)
    return ExchangePlan(states, [row[:n] for row in fetched],
                        [row[n] for row in fetched])


def _exchange(pages: List[Page], key_channels: Sequence[int],
              bucket_capacity: Bucket, mode: int,
              heavy: Optional[List[torch.Tensor]]
              ) -> Tuple[List[Page], int]:
    plan = exchange_plan(pages, key_channels, mode, heavy)
    bucket = bucket_capacity(plan.largest) if callable(bucket_capacity) \
        else bucket_capacity
    return exchange_apply(pages, plan, int(bucket))


def exchange_apply(pages: List[Page], plan: ExchangePlan, bucket: int
                   ) -> Tuple[List[Page], int]:
    """K35's scatter into buckets of `bucket` rows, then the receive (K2):
    returns (each destination's page of capacity n x bucket, the
    overflow sum(max(count - bucket, 0)))."""
    n = len(pages)
    states, counts = plan.states, plan.counts
    overflow = sum(max(c - bucket, 0) for row in counts for c in row)
    sent = []
    for state, page in zip(states, pages):
        arrays = _moved_arrays(page)
        sent.append(_rebuild_valid(page, exchange_scatter(state, arrays, n,
                                                          bucket)))
    # the receive: destination d takes min(count, bucket) rows of each
    # source's bucket d, in source order (K2)
    out = []
    for d, dst in enumerate(pages):
        parts = []
        for s, cols in enumerate(sent):
            lo, hi = d * bucket, (d + 1) * bucket
            sl = tuple(Column(c.values[lo:hi], c.valid[lo:hi], c.type,
                              c.dictionary,
                              None if c.lengths is None
                              else c.lengths[lo:hi],
                              None if c.aux is None else c.aux[lo:hi],
                              c.aux_dictionary) for c in cols)
            part = Page(sl, row_count(min(counts[s][d], bucket),
                                      cols[0].device))
            parts.append(to_device(part, dst.device))
        out.append(device_concat(parts))
    return out, overflow


def _fetch(tensors: List[torch.Tensor]) -> List[List[int]]:
    """Host copies of per-shard count vectors: one transfer per device."""
    by_dev = {}
    for i, t in enumerate(tensors):
        by_dev.setdefault(t.device, []).append(i)
    out: List[Optional[List[int]]] = [None] * len(tensors)
    for idx in by_dev.values():
        rows = torch.stack([tensors[i] for i in idx]).tolist()
        for i, r in zip(idx, rows):
            out[i] = r
    return out


def all_to_all_by_key(pages: List[Page], key_channels: Sequence[int],
                      bucket_capacity: Bucket,
                      heavy: Optional[List[torch.Tensor]] = None
                      ) -> Tuple[List[Page], int]:
    """Hash-repartition the shards' rows. Returns (the page each shard now
    owns, the global overflow count). Overflow > 0 means some source had
    more than bucket rows for one destination (those rows are dropped; the
    caller re-runs with a larger bucket). `heavy` (per-shard copies of
    detect_heavy_keys's set) engages SPREAD mode: rows of heavy keys
    spread over all shards by row position — the probe half of the
    skew-aware join exchange."""
    mode = MODE_HASH if heavy is None else MODE_SPREAD
    return _exchange(pages, key_channels, bucket_capacity, mode, heavy)


def all_to_all_replicate(pages: List[Page], key_channels: Sequence[int],
                         bucket_capacity: Bucket,
                         heavy: List[torch.Tensor]
                         ) -> Tuple[List[Page], int]:
    """Skew-aware build-side repartition: rows of non-heavy keys route by
    hash; rows of heavy keys go to every destination, so each shard holds
    the whole build set for the keys whose probe rows were spread.
    Returns (pages, global overflow), as all_to_all_by_key."""
    return _exchange(pages, key_channels, bucket_capacity, MODE_REPLICATE,
                     heavy)


def broadcast_page(pages: List[Page]) -> List[Page]:
    """Every shard's live rows, in shard order, on every shard (capacity
    n x cap; validity kept where the input has it). Shards on one device
    share one replica: pages are never written in place, so a shared
    replica is read-only for every consumer."""
    replicas = {}
    out = []
    for p in pages:
        dev = p.device
        if dev not in replicas:
            replicas[dev] = device_concat([to_device(q, dev)
                                           for q in pages]) \
                if len(pages) > 1 else pages[0]
        out.append(replicas[dev])
    return out


def gather_page(pages: List[Page]) -> List[Page]:
    """SINGLE distribution: every shard receives all rows; shard 0's
    replica is the one read (coordinator-only consumption)."""
    return broadcast_page(pages)
