"""Spill-to-host partition store and the device partitioner (K18).

Port of `trino_tpu/exec/spill.py`. Device memory is the scarce resource
and the host holds far more RAM behind a PCIe link, so "disk" is host
memory and the spill unit is a hash PARTITION (Grace aggregation), not a
sorted run. An over-budget batch is partitioned ON THE DEVICE (K18: one
pid per row, then one stable move of every column by pid), its live rows
fetched in one transfer and split on the host at the partition
boundaries; finalization restages one bounded partition at a time. The
same store backs the sort spill (range partitions instead of hash) and
the partitioned join.

K18, `csrc/spill_part.cu`, beside its plain PyTorch twins:
* `partition_rows` — a pid per row, in one of two modes: the salted
  canonical key hash mod npart (`partition_by_hash`) or the leading sort
  key's rank searched in the range bounds (`partition_by_range`); dead
  rows take pid npart and stay where they are. Then csrc/tile.cuh's
  binned count -> scan -> stable scatter moves each column's values and
  validity, and writes the live count of every partition.
* `rank_rows` — the rank mode alone (`leading_rank`), read by
  `rank_bounds`, whose sort is K10's radix passes (ops/sort.py).

Partition ids are bit-identical to the reference's, so partitions, and
with them the output order, are the reference's. Keys are 64-bit words
held in int64 tensors (ops/join.py's `_mix64` and `_srl`); the unsigned
modulo of the twin goes over 32-bit halves (connector/tpch_dev.py
`umod`).

Host pieces are CPU tensors, pinned when the store serves a CUDA device;
a restage is one pinned-to-device copy per column. The heavy-key helpers
run in NumPy over views of those tensors.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from trino_tpu_torch import native
from trino_tpu_torch import types as T
from trino_tpu_torch.connector.tpch_dev import umod
from trino_tpu_torch.errors import EXCEEDED_SPILL_LIMIT, TrinoError
from trino_tpu_torch.exec.memory import fmt_bytes
from trino_tpu_torch.ops.join import _mix64, _signed, _srl
from trino_tpu_torch.page import (Column, Page, _movable, _rebuild,
                                  host_table, row_count)

_GOLDEN = 0x9E3779B97F4A7C15
_U64 = (1 << 64) - 1
_NULL_TAG = _signed(_GOLDEN)
_I64_MIN = -(1 << 63)

# csrc/spill_part.cu: pid modes, and the most partitions one launch
# bins (pid npart holds the dead rows; tile.cuh has 256 bins)
MODE_HASH, MODE_RANGE = 0, 1
MAX_PARTITIONS = 255


# ------------------------------------------------------ K18's plain twin


def _hash_word(values: torch.Tensor) -> torch.Tensor:
    """One key column as the canonical hash reads it: a bool 0/1, a float
    as its float64 bits with -0.0 made +0.0 (NaN keeps its bits), an
    integer sign-extended."""
    if values.dtype == torch.bool:
        return values.to(torch.int64)
    if values.is_floating_point():
        f = values.to(torch.float64)
        return torch.where(f == 0, torch.zeros_like(f), f).view(torch.int64)
    return values.to(torch.int64)


def key_hash_plain(key_cols, salt: int = 0) -> torch.Tensor:
    """The reference's _canonical_key_hash (every NULL of a column hashes
    to _NULL_TAG) with `partition_by_hash`'s salt mixed in: int64 words."""
    cap = key_cols[0][0].shape[0]
    acc = torch.zeros(cap, dtype=torch.int64, device=key_cols[0][0].device)
    for values, valid in key_cols:
        u = _hash_word(values)
        if valid is not None:
            u = torch.where(valid, u, torch.full_like(u, _NULL_TAG))
        acc = _mix64(acc ^ _mix64(u))
    if salt:
        acc = _mix64(acc ^ _salt_mix(salt))
    return acc


def _salt_mix(salt: int) -> int:
    return _signed((_GOLDEN * (int(salt) + 1)) & _U64)


def rank_plain(values: torch.Tensor, valid: Optional[torch.Tensor],
               ascending: bool, nulls_first: bool) -> torch.Tensor:
    """The reference's leading_rank: a monotone u64 rank (int64 words) of
    one sort key with direction, NULL placement and NaN-as-largest folded
    in; NULLs rank 0 (first) or u64::MAX (last)."""
    if values.dtype == torch.bool:
        u = values.to(torch.int64)
    elif values.is_floating_point():
        f = values.to(torch.float64)
        f = torch.where(torch.isnan(f), torch.full_like(f, float("inf")), f)
        bits = torch.where(f == 0, torch.zeros_like(f), f).view(torch.int64)
        u = torch.where(bits < 0, ~bits, bits | _I64_MIN)
    else:
        u = values.to(torch.int64) ^ _I64_MIN
    if not ascending:
        u = ~u
    u = _srl(u, 2) + 1
    if valid is not None:
        u = torch.where(valid, u, torch.full_like(u, 0 if nulls_first
                                                  else -1))
    return u


def _pids_plain(key_cols, num_rows, spec, npart: int) -> torch.Tensor:
    cap = key_cols[0][0].shape[0]
    if spec[0] == MODE_HASH:
        pid = umod(key_hash_plain(key_cols, spec[1]), npart)
    else:
        _, ascending, nulls_first, bounds = spec
        values, valid = key_cols[0]
        r = rank_plain(values, valid, ascending, nulls_first)
        pid = torch.searchsorted(bounds ^ _I64_MIN, r ^ _I64_MIN, right=True)
    live = torch.arange(cap, dtype=torch.int32, device=pid.device) < num_rows
    return torch.where(live, pid.to(torch.int64),
                       torch.full_like(pid, npart, dtype=torch.int64))


def partition_rows_plain(arrays: Sequence[torch.Tensor], key_cols,
                         num_rows: torch.Tensor, spec, npart: int
                         ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Plain twin of K18: every array moved stably by partition id (dead
    rows, pid npart, keep their places past the live ones) and the live
    count of each partition (int64[npart]). `spec` is (MODE_HASH, salt)
    or (MODE_RANGE, ascending, nulls_first, bounds)."""
    pid = _pids_plain(key_cols, num_rows, spec, npart)
    perm = torch.sort(pid, stable=True).indices
    counts = torch.bincount(pid, minlength=npart + 1)[:npart]
    return [a[perm] for a in arrays], counts.to(torch.int64)


def rank_rows_plain(values: torch.Tensor, valid: Optional[torch.Tensor],
                    ascending: bool, nulls_first: bool) -> torch.Tensor:
    """Plain twin of K18's rank mode."""
    return rank_plain(values, valid, ascending, nulls_first)


# -------------------------------------------------------------- K18


def _key_table(key_cols) -> List[int]:
    out = []
    for values, valid in key_cols:
        flags = int(values.is_floating_point()) \
            | int(values.dtype == torch.bool) << 3
        out += [values.data_ptr(), 0 if valid is None else valid.data_ptr(),
                values.element_size(), flags]
    return out


def _check(arrays, cap: int, dev) -> None:
    for a in arrays:
        if a.device != dev or a.dim() != 1 or a.shape[0] != cap \
                or not a.is_contiguous() \
                or a.element_size() not in (1, 2, 4, 8):
            raise ValueError(f"array {a.dtype}{tuple(a.shape)} on {a.device}"
                             f" does not match a {cap}-row page on {dev}")


def partition_rows_cuda(arrays: Sequence[torch.Tensor], key_cols,
                        num_rows: torch.Tensor, spec, npart: int
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """K18 launch: see csrc/spill_part.cu spill_partition."""
    cap = key_cols[0][0].shape[0]
    dev = num_rows.device
    _check([v for v, _ in key_cols] + [m for _, m in key_cols
                                        if m is not None], cap, dev)
    _check(arrays, cap, dev)
    if not 0 < npart <= MAX_PARTITIONS:
        raise ValueError(f"npart {npart} outside [1, {MAX_PARTITIONS}]")
    if num_rows.dtype != torch.int32 or num_rows.dim() != 0:
        raise ValueError("num_rows must be a 0-d int32 tensor")
    moved = [torch.empty_like(a) for a in arrays]
    if spec[0] == MODE_HASH:
        salt = int(spec[1])
        mix = _salt_mix(salt) if salt else 0
        has_salt, asc, nf = int(bool(salt)), True, False
        bounds = torch.empty(1, dtype=torch.int64, device=dev)
        nb = 0
    else:
        _, asc, nf, bounds = spec
        mix, has_salt = 0, 0
        if bounds.dtype != torch.int64 or bounds.device != dev \
                or bounds.dim() != 1:
            raise ValueError("range bounds must be int64 words on the "
                             "device")
        nb = bounds.shape[0]
        bounds = bounds.contiguous() if nb else torch.empty(
            1, dtype=torch.int64, device=dev)
    pid = torch.empty(max(cap, 1), dtype=torch.int32, device=dev)
    ntiles = max(1, -(-cap // 4096))
    hist = torch.empty(256 * ntiles + 1, dtype=torch.int64, device=dev)
    counts = torch.empty(npart, dtype=torch.int64, device=dev)
    cols = []
    for a, m in zip(arrays, moved):
        cols += [a.data_ptr(), m.data_ptr(), a.element_size()]
    rc = native.library("spill_part").spill_partition(
        host_table(_key_table(key_cols)), ctypes.c_int64(len(key_cols)),
        ctypes.c_int64(cap), ctypes.c_void_p(num_rows.data_ptr()),
        ctypes.c_int64(spec[0]), ctypes.c_int64(mix),
        ctypes.c_int64(has_salt), ctypes.c_int64(int(asc)),
        ctypes.c_int64(int(nf)), ctypes.c_void_p(bounds.data_ptr()),
        ctypes.c_int64(nb), host_table(cols), ctypes.c_int64(len(arrays)),
        ctypes.c_int64(npart), ctypes.c_void_p(pid.data_ptr()),
        ctypes.c_void_p(hist.data_ptr()), ctypes.c_void_p(counts.data_ptr()),
        ctypes.c_void_p(native.stream_ptr(dev)))
    native.check(rc, "spill_partition")
    partition_rows_cuda.launches += 1
    mode = "hash" if spec[0] == MODE_HASH else "range"
    partition_rows_cuda.by_mode[mode] = \
        partition_rows_cuda.by_mode.get(mode, 0) + 1
    return moved, counts


partition_rows_cuda.launches = 0
partition_rows_cuda.by_mode = {}


def rank_rows_cuda(values: torch.Tensor, valid: Optional[torch.Tensor],
                   ascending: bool, nulls_first: bool) -> torch.Tensor:
    """K18 rank-mode launch: see csrc/spill_part.cu spill_rank."""
    cap = values.shape[0]
    dev = values.device
    _check([values] + ([valid] if valid is not None else []), cap, dev)
    rank = torch.empty(max(cap, 1), dtype=torch.int64, device=dev)
    rc = native.library("spill_part").spill_rank(
        host_table(_key_table([(values, valid)])), ctypes.c_int64(cap),
        ctypes.c_int64(int(ascending)), ctypes.c_int64(int(nulls_first)),
        ctypes.c_void_p(rank.data_ptr()),
        ctypes.c_void_p(native.stream_ptr(dev)))
    native.check(rc, "spill_rank")
    rank_rows_cuda.launches += 1
    return rank[:cap]


rank_rows_cuda.launches = 0


def partition_rows(arrays, key_cols, num_rows, spec, npart):
    """K18 wrapper: plain twin on the CPU, kernel on CUDA."""
    run = partition_rows_cuda if num_rows.is_cuda else partition_rows_plain
    return run(arrays, key_cols, num_rows, spec, npart)


def rank_rows(values, valid, ascending, nulls_first):
    """K18 rank-mode wrapper: plain twin on the CPU, kernel on CUDA."""
    run = rank_rows_cuda if values.is_cuda else rank_rows_plain
    return run(values, valid, ascending, nulls_first)


# ------------------------------------------------- the device operators


def _key_cols(page: Page, channels: Sequence[int]):
    return [(page.column(ch).values.contiguous(), page.column(ch).valid)
            for ch in channels]


def refuse_lists(page: Page) -> None:
    """A host spill store keeps (values, validity) per column, as the
    reference's does, which would drop a list column's lengths and MAP
    values (the reference's spill then fails): raise instead."""
    if any(c.is_list for c in page.columns):
        raise NotImplementedError(
            "a list column (ARRAY/MAP) cannot go to a host spill store: "
            "ROADMAP B item 6 (B13)")


def _partition_sort(page: Page, key_cols, spec, npart: int):
    refuse_lists(page)
    arrays = [a.contiguous() for c in page.columns for a in _movable(c)]
    moved, counts = partition_rows(arrays, key_cols, page.num_rows, spec,
                                   npart)
    return Page(_rebuild(page.columns, moved), page.num_rows), counts


def partition_by_hash(key_channels: Sequence[int], npart: int,
                      salt: int = 0):
    """op(page) -> (page sorted by partition id, int64 counts[npart]).
    `salt` derives an independent hash family per recursion depth (rows of
    one key colocate at every salt); salt 0 is the unsalted hash."""
    key_channels = tuple(key_channels)

    def op(page: Page):
        return _partition_sort(page, _key_cols(page, key_channels),
                               (MODE_HASH, int(salt)), npart)
    return op


def leading_rank(channel: int, ascending: bool, nulls_first: bool):
    """op(page) -> the monotone u64 rank (int64 words) of one sort key:
    ascending rank order is the key's output order, so range partitions
    on it keep ties (equal leading keys) in one partition."""

    def op(page: Page) -> torch.Tensor:
        c = page.column(channel)
        return rank_rows(c.values.contiguous(), c.valid, ascending,
                         nulls_first)
    return op


def rank_bounds(npart: int):
    """op(ranks, live, num_rows) -> u64 bounds[npart-1] (int64 words):
    quantile split points of the live ranks; dead rows sort to the top as
    u64::MAX. The sort is K10's radix passes on CUDA."""

    def op(ranks: torch.Tensor, live: torch.Tensor, num_rows
           ) -> torch.Tensor:
        masked = torch.where(live, ranks, torch.full_like(ranks, -1))
        if masked.is_cuda:
            from trino_tpu_torch.ops.sort import sort_u64_cuda
            s = sort_u64_cuda(masked)
        else:
            s = masked[torch.sort(masked ^ _I64_MIN, stable=True).indices]
        n = num_rows.to(torch.int64)
        q = torch.arange(1, npart, dtype=torch.int64,
                         device=ranks.device) * n // npart
        return s[q.clamp(0, max(s.shape[0] - 1, 0))]
    return op


def partition_by_range(channel: int, ascending: bool, nulls_first: bool,
                       npart: int):
    """op(page, bounds) -> (page sorted by range partition id, counts).
    side='right': every row equal to a bound stays in one partition."""

    def op(page: Page, bounds: torch.Tensor):
        return _partition_sort(page, _key_cols(page, (channel,)),
                               (MODE_RANGE, ascending, nulls_first, bounds),
                               npart)
    return op


# ------------------------------------------------------ the spill ledger


class ExceededSpillLimitError(TrinoError, RuntimeError):
    """A spill reservation would push the query past its host-RAM spill
    budget (`spill_max_bytes`): classified, not retryable."""

    CODE = EXCEEDED_SPILL_LIMIT


def default_spill_limit_bytes() -> int:
    """`spill_max_bytes` when unset (0): half of physical host RAM."""
    try:
        total = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
        return max(int(total) // 2, 1 << 30)
    except (AttributeError, OSError, ValueError):
        return 64 << 30


def resolve_spill_limit(session) -> int:
    """Session `spill_max_bytes`; 0 = the host-RAM-derived default."""
    v = int(session.get("spill_max_bytes"))
    return v if v > 0 else default_spill_limit_bytes()


class SpillLedger:
    """Process-wide host-RAM accounting for spill partition stores: every
    store charges its pieces here per query and frees them on drop/close,
    and an over-budget query fails with a classified error."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reserved = 0
        self.peak = 0
        self.denials = 0
        self.by_query: Dict[str, int] = {}

    def reserve(self, nbytes: int, query_id: str,
                limit: Optional[int]) -> None:
        nbytes = int(nbytes)
        if nbytes <= 0:
            return
        with self._lock:
            held = self.by_query.get(query_id, 0)
            if limit is not None and held + nbytes > limit:
                self.denials += 1
                raise ExceededSpillLimitError(
                    f"Query exceeded spill limit of {fmt_bytes(limit)} "
                    f"[spill store requested {fmt_bytes(nbytes)} with "
                    f"{fmt_bytes(held)} spilled]")
            self.by_query[query_id] = held + nbytes
            self.reserved += nbytes
            self.peak = max(self.peak, self.reserved)

    def release(self, nbytes: int, query_id: str) -> None:
        nbytes = int(nbytes)
        if nbytes <= 0:
            return
        with self._lock:
            held = self.by_query.get(query_id, 0)
            freed = min(nbytes, held)
            if held - freed <= 0:
                self.by_query.pop(query_id, None)
            else:
                self.by_query[query_id] = held - freed
            self.reserved = max(0, self.reserved - freed)


# the process singleton every store charges (host RAM is shared)
SPILL_LEDGER = SpillLedger()


def _pow2(n: int) -> int:
    return max(1 << max(int(n) - 1, 0).bit_length(), 8)


def _tensor_bytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


class HostPartitionStore:
    """Per-partition host pieces of spilled pages.

    A piece is [(values, valid or None)] per column, CPU tensors; `meta`
    is (type, dictionary) per column from the first spill (every spilled
    page of a store has one layout). Bytes are accounted per partition
    and, with a ledger, against the process SpillLedger under the query's
    `spill_max_bytes`. `device` is where restaged pages go; for a CUDA
    device the pieces are pinned, so a restage is one copy per column."""

    def __init__(self, npart: int, ledger: Optional[SpillLedger] = None,
                 query_id: str = "", limit: Optional[int] = None,
                 device=None):
        self.npart = npart
        self.pieces: List[List[list]] = [[] for _ in range(npart)]
        self.meta: Optional[List[Tuple[T.Type, object]]] = None
        self.bytes = 0
        self.part_bytes = [0] * npart
        self.ledger = ledger
        self.query_id = query_id
        self.limit = limit
        self.device = torch.device("cpu" if device is None else device)
        self.pinned = self.device.type == "cuda"

    # --------------------------------------------------- byte accounting

    def _settle(self, p: int, delta: int) -> None:
        """Charge (positive) or release (negative) partition p's bytes,
        mirrored into the ledger; a charge can raise
        ExceededSpillLimitError, so callers charge BEFORE appending."""
        if delta > 0:
            if self.ledger is not None:
                self.ledger.reserve(delta, self.query_id, self.limit)
            self.bytes += delta
            self.part_bytes[p] += delta
        elif delta < 0:
            if self.ledger is not None:
                self.ledger.release(-delta, self.query_id)
            self.bytes = max(0, self.bytes + delta)
            self.part_bytes[p] = max(0, self.part_bytes[p] + delta)

    @staticmethod
    def _piece_bytes(piece) -> int:
        return sum(_tensor_bytes(v) + _tensor_bytes(m) for v, m in piece)

    def _host(self, n: int, dtype) -> torch.Tensor:
        return torch.empty(n, dtype=dtype, pin_memory=self.pinned)

    def spill_partitioned(self, page: Page, counts) -> None:
        """Fetch a partition-sorted page's live rows (one copy per column,
        one wait) and slice them at the partition offsets."""
        refuse_lists(page)
        counts = [int(c) for c in counts]
        total = sum(counts)
        if total == 0:
            return
        if self.meta is None:
            self.meta = [(c.type, c.dictionary) for c in page.columns]
        host_cols = []
        for c in page.columns:
            pair = []
            for t in (c.values, c.valid):
                if t is None:
                    pair.append(None)
                    continue
                h = self._host(total, t.dtype)
                h.copy_(t[:total], non_blocking=t.is_cuda)
                pair.append(h)
            host_cols.append(tuple(pair))
        if page.device.type == "cuda":
            torch.cuda.current_stream(page.device).synchronize()
        lo = 0
        for p, n in enumerate(counts):
            if n <= 0:
                continue
            piece = [(vals[lo:lo + n],
                      None if valid is None else valid[lo:lo + n])
                     for vals, valid in host_cols]
            self._settle(p, self._piece_bytes(piece))
            self.pieces[p].append(piece)
            lo += n

    def add_piece(self, p: int, piece) -> None:
        """Append a host-built piece (heavy-key splitting) with the same
        accounting as a device spill."""
        self._settle(p, self._piece_bytes(piece))
        self.pieces[p].append(piece)

    def partition_rows(self, p: int) -> int:
        return sum(len(piece[0][0]) for piece in self.pieces[p])

    def partition_bytes(self, p: int) -> int:
        return self.part_bytes[p]

    def chunk_rows_for(self, p: int, budget_bytes: int) -> int:
        """Rows per bounded restage chunk so one staged chunk stays within
        `budget_bytes` (at least 4096 rows)."""
        rows = self.partition_rows(p)
        if rows <= 0:
            return 4096
        per_row = max(1, self.part_bytes[p] // rows)
        return max(4096, int(budget_bytes) // per_row)

    def _stage(self, spans, n: int,
               capacity: Optional[int] = None) -> Page:
        """ONE device page from host (piece, lo, hi) spans: each column
        filled into one (pinned) buffer, then one copy to the device."""
        capacity = capacity if capacity is not None else _pow2(max(n, 1))
        cols = []
        for ci in range(len(self.meta)):
            dtype = spans[0][0][ci][0].dtype
            has_valid = any(piece[ci][1] is not None
                            for piece, _, _ in spans)
            vals = self._host(capacity, dtype)
            vals[n:] = 0
            valid = None
            if has_valid:
                valid = self._host(capacity, torch.bool)
                valid[n:] = False
            off = 0
            for piece, lo, hi in spans:
                v, m = piece[ci]
                vals[off:off + hi - lo] = v[lo:hi]
                if valid is not None:
                    valid[off:off + hi - lo] = True if m is None \
                        else m[lo:hi]
                off += hi - lo
            typ, d = self.meta[ci]
            cols.append(Column(
                self._to_device(vals),
                None if valid is None else self._to_device(valid), typ, d))
        return Page(tuple(cols), row_count(n, self.device))

    def _to_device(self, t: torch.Tensor) -> torch.Tensor:
        if self.device.type == "cpu":
            return t
        return t.to(self.device, non_blocking=True)

    def restage(self, p: int, capacity: int) -> Optional[Page]:
        """Partition p as ONE device page."""
        if not self.pieces[p] or self.meta is None:
            return None
        n = self.partition_rows(p)
        spans = [(piece, 0, len(piece[0][0])) for piece in self.pieces[p]]
        return self._stage(spans, n, capacity)

    def iter_partition_chunks(self, p: int,
                              chunk_rows: int) -> Iterator[Page]:
        """Partition p as device pages of <= chunk_rows live rows each.
        Does NOT drop the partition, so a caller can iterate it again
        (the chunked-build join re-streams the probe partition)."""
        if not self.pieces[p] or self.meta is None:
            return
        chunk_rows = max(int(chunk_rows), 1)
        spans = []
        acc = 0
        for piece in self.pieces[p]:
            n = len(piece[0][0])
            lo = 0
            while lo < n:
                take = min(chunk_rows - acc, n - lo)
                spans.append((piece, lo, lo + take))
                acc += take
                lo += take
                if acc == chunk_rows:
                    yield self._stage(spans, acc)
                    spans, acc = [], 0
        if spans:
            yield self._stage(spans, acc)

    def drain_partition_chunks(self, p: int,
                               chunk_rows: int) -> Iterator[Page]:
        """iter_partition_chunks that RELEASES each piece as soon as its
        last row has been staged, so a single-pass consumer never holds a
        partition's bytes twice against the spill budget."""
        if not self.pieces[p] or self.meta is None:
            return
        chunk_rows = max(int(chunk_rows), 1)
        pieces = self.pieces[p]
        spans = []
        acc = 0
        done: List[list] = []
        while pieces:
            piece = pieces.pop(0)
            n = len(piece[0][0])
            lo = 0
            while lo < n:
                take = min(chunk_rows - acc, n - lo)
                spans.append((piece, lo, lo + take))
                acc += take
                lo += take
                if acc == chunk_rows:
                    yield self._stage(spans, acc)
                    spans, acc = [], 0
                    for d in done:
                        self._settle(p, -self._piece_bytes(d))
                    done = []
            done.append(piece)
        if spans:
            yield self._stage(spans, acc)
        for d in done:
            self._settle(p, -self._piece_bytes(d))

    def drop(self, p: int) -> None:
        self._settle(p, -self.part_bytes[p])
        self.pieces[p] = []

    def close(self) -> None:
        """Release every partition (generator finally blocks call this, so
        an abandoned or failed operator never strands ledger bytes)."""
        for p in range(self.npart):
            self.drop(p)


# ---------------------------------------------------------------------------
# host-side heavy-hitter detection and splitting, in NumPy over the pieces

_NP_SM1 = np.uint64(0xBF58476D1CE4E5B9)
_NP_SM2 = np.uint64(0x94D049BB133111EB)
_NP_NULL_TAG = np.uint64(_GOLDEN)


def _np_mix64(x: np.ndarray) -> np.ndarray:
    x = (x ^ (x >> np.uint64(30))) * _NP_SM1
    x = (x ^ (x >> np.uint64(27))) * _NP_SM2
    return x ^ (x >> np.uint64(31))


def _np(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    return None if t is None else t.numpy()


def _np_piece_key_hash(piece, key_idxs: Sequence[int]) -> np.ndarray:
    """Host mirror of the canonical key hash over one spilled piece: the
    key identity heavy detection and splitting group rows by (consistent
    across pieces and across the two sides of a join)."""
    n = len(piece[0][0])
    acc = np.zeros(n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for ci in key_idxs:
            vals, valid = _np(piece[ci][0]), _np(piece[ci][1])
            if vals.dtype == np.bool_:
                u = vals.astype(np.uint64)
            elif np.issubdtype(vals.dtype, np.floating):
                u = (vals.astype(np.float64) + 0.0).view(np.uint64)
            else:
                u = vals.astype(np.uint64)
            if valid is not None:
                u = np.where(valid, u, _NP_NULL_TAG)
            acc = _np_mix64(acc ^ _np_mix64(u))
    return acc


def partition_key_hashes(store: HostPartitionStore, p: int,
                         key_idxs: Sequence[int]) -> List[np.ndarray]:
    """Per-piece canonical key hashes of one partition, computed once and
    shared by detection and splitting."""
    return [_np_piece_key_hash(piece, key_idxs)
            for piece in store.pieces[p]]


def detect_partition_heavy_keys(store: HostPartitionStore, p: int,
                                key_idxs: Sequence[int], limit: int,
                                min_count: int,
                                piece_hashes=None) -> np.ndarray:
    """Top-`limit` key identities of partition p whose row count reaches
    `min_count` (uint64 hashes): the keys recursive repartitioning can
    never split, since every row of one key re-hashes to one child."""
    if not store.pieces[p]:
        return np.empty(0, dtype=np.uint64)
    if piece_hashes is None:
        piece_hashes = partition_key_hashes(store, p, key_idxs)
    hashes = np.concatenate(piece_hashes)
    keys, counts = np.unique(hashes, return_counts=True)
    mask = counts >= max(int(min_count), 1)
    keys, counts = keys[mask], counts[mask]
    if len(keys) > int(limit):
        top = np.argsort(counts)[::-1][:int(limit)]
        keys = keys[top]
    return keys


def split_partition(store: HostPartitionStore, p: int,
                    key_idxs: Sequence[int],
                    heavy: np.ndarray,
                    piece_hashes=None) -> HostPartitionStore:
    """Move partition p's rows whose key identity is in `heavy` into a NEW
    single-partition store (same ledger and budget); the source keeps the
    rest. Pure host work."""
    sub = HostPartitionStore(1, ledger=store.ledger,
                             query_id=store.query_id, limit=store.limit,
                             device=store.device)
    sub.meta = None if store.meta is None else list(store.meta)
    old_bytes = store.part_bytes[p]
    rest_pieces: List[list] = []
    heavy_pieces: List[list] = []
    if piece_hashes is None:
        piece_hashes = partition_key_hashes(store, p, key_idxs)

    def take(piece, mask):
        idx = torch.from_numpy(np.nonzero(mask)[0])
        return [(v[idx], None if m is None else m[idx]) for v, m in piece]
    for piece, h in zip(store.pieces[p], piece_hashes):
        mask = np.isin(h, heavy)
        if not mask.any():
            # no heavy rows here: keep the piece by reference
            rest_pieces.append(piece)
            continue
        heavy_pieces.append(take(piece, mask))
        if not mask.all():
            rest_pieces.append(take(piece, ~mask))
    # release the whole old partition first, then re-charge the halves: a
    # transient double charge could trip the budget for bytes already held
    store.pieces[p] = []
    store._settle(p, -old_bytes)
    for piece in rest_pieces:
        store.add_piece(p, piece)
    for piece in heavy_pieces:
        sub.add_piece(0, piece)
    return sub
