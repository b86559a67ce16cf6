"""Sort / TopN / Limit operators.

Port of `trino_tpu/ops/sort.py`. The reference runs one multi-operand
stable `lax.sort` whose leading keys are the dead-row flag and per-key
null and NaN flags. Here the same operands are packed, most significant
first, into order-preserving 64-bit words (`encode_sort_keys`), and the
words are sorted stably: by K10 (`csrc/sort.cu`, an LSD radix sort that
moves (key, index) pairs and skips the digit passes every live row
shares) for CUDA pages, by a chain of stable `torch.sort`s (least
significant word first) for CPU pages. Both give the reference's
permutation; `Page.gather` (K7) applies it. `radix_replay_plain` and the
functions before it model K10's pass plan step by step for the tests.

Ordering semantics (Trino): ASC defaults to NULLS LAST, DESC to NULLS
FIRST; NaN sorts largest; -0.0 and +0.0 tie; ties keep input order. DESC
is the reference's negation, so INT_MIN under DESC stays INT_MIN and
sorts first (ROADMAP §C).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from trino_tpu_torch import native
from trino_tpu_torch.page import Page, host_table, row_count

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


@dataclasses.dataclass(frozen=True)
class SortKey:
    channel: int
    ascending: bool = True
    nulls_first: Optional[bool] = None  # None = Trino default for direction

    def resolved_nulls_first(self) -> bool:
        if self.nulls_first is not None:
            return self.nulls_first
        return not self.ascending


def _descending_form(values: torch.Tensor) -> torch.Tensor:
    """Map values so ascending sort yields descending order."""
    if values.dtype == torch.bool:
        return ~values
    return -values  # int overflow only at INT_MIN, as in the reference


def _float_order(values: torch.Tensor) -> torch.Tensor:
    """Floats as int64 keys in the order the reference's sort uses: its
    comparator makes -0.0 equal +0.0 (the two tie and keep input order);
    NaN is already replaced by its own flag key."""
    v = values.to(torch.float64)
    b = torch.where(v == 0, torch.zeros_like(v), v).view(torch.int64)
    return torch.where(b >= 0, b, b ^ _I64_MAX)


def _sort_operands(page: Page, keys: Sequence[SortKey]):
    operands = [~page.row_mask()]
    for k in keys:
        col = page.column(k.channel)
        values = col.values
        is_float = values.is_floating_point()
        if col.valid is not None:
            null_flag = ~col.valid
            operands.append(~null_flag if k.resolved_nulls_first()
                            else null_flag)
            values = torch.where(col.valid, values,
                                 torch.zeros((), dtype=values.dtype,
                                             device=values.device))
        if is_float:
            nan = torch.isnan(values)
            operands.append(nan if k.ascending else ~nan)
            values = torch.where(nan, torch.zeros_like(values), values)
        values = values if k.ascending else _descending_form(values)
        operands.append(_float_order(values) if is_float else values)
    return operands


# ----------------------------------------------------------- key encoding

# field kinds of a sort layout (csrc/sort.cu reads the same numbers)
DEAD, NULL, NAN, VALUE = 0, 1, 2, 3


def _value_bits(dtype: torch.dtype) -> int:
    """Width of a key's value field: BOOLEAN 1 bit; INTEGER, DATE and
    dictionary codes (and the narrower integers) 32; BIGINT, DECIMAL and
    the floats (REAL widened to float64, as _float_order does) 64."""
    if dtype == torch.bool:
        return 1
    if dtype in (torch.int8, torch.int16, torch.int32):
        return 32
    return 64


@dataclasses.dataclass(frozen=True)
class SortField:
    kind: int      # DEAD, NULL, NAN or VALUE
    key: int       # index into the sort keys (-1 for DEAD)
    width: int     # bits
    word: int      # index of the 64-bit word holding it
    shift: int     # position of its least significant bit in the word


def sort_layout(page: Page, keys: Sequence[SortKey]
                ) -> Tuple[SortField, ...]:
    """The fields of `_sort_operands` in order (the dead flag; per key a
    null flag when the column has validity, a NaN flag when it is a
    float, the value), packed most significant first into 64-bit words. A
    field never straddles two words: one that does not fit in what is
    left of a word starts the next, so the words compare in the fields'
    lexicographic order however wide the key tuple is."""
    return _layout(tuple((page.column(k.channel).valid is not None,
                          page.column(k.channel).values.dtype)
                         for k in keys))


@functools.lru_cache(maxsize=None)
def _layout(spec: Tuple[Tuple[bool, torch.dtype], ...]
            ) -> Tuple[SortField, ...]:
    """sort_layout of keys given as (has validity, dtype) pairs."""
    raw = [(DEAD, -1, 1)]
    for j, (has_valid, dtype) in enumerate(spec):
        if has_valid:
            raw.append((NULL, j, 1))
        if dtype.is_floating_point:
            raw.append((NAN, j, 1))
        raw.append((VALUE, j, _value_bits(dtype)))
    out, word, used = [], 0, 0
    for kind, key, width in raw:
        if used + width > 64:
            word, used = word + 1, 0
        out.append(SortField(kind, key, width, word, 64 - used - width))
        used += width
    return tuple(out)


def _field_bits(op: torch.Tensor) -> torch.Tensor:
    """One operand as the int64 bit pattern of its unsigned, order-
    preserving field value: a flag or BOOLEAN as 0/1, a 32-bit integer
    offset by 2^31, a 64-bit integer (or float order key) with its sign
    bit flipped."""
    if op.dtype == torch.bool:
        return op.to(torch.int64)
    if op.dtype in (torch.int8, torch.int16, torch.int32):
        return op.to(torch.int64) + (1 << 31)
    return op ^ _I64_MIN


def encode_sort_keys(page: Page, keys: Sequence[SortKey]
                     ) -> List[torch.Tensor]:
    """Plain twin of K10's encode launch: the operands of `_sort_operands`
    packed into order-preserving 64-bit words, most significant first.
    Each word is stored as int64 with its sign bit flipped, so signed
    order equals the words' unsigned order (torch on the CPU has no
    uint64)."""
    layout = sort_layout(page, keys)
    operands = _sort_operands(page, keys)
    words = [torch.zeros(page.capacity, dtype=torch.int64,
                         device=page.device)
             for _ in range(layout[-1].word + 1)]
    for f, op in zip(layout, operands):
        words[f.word] |= _field_bits(op) << f.shift
    return [w ^ _I64_MIN for w in words]


def sort_permutation(operands) -> torch.Tensor:
    """Stable lexicographic order of `operands` (first = most major)."""
    n = operands[0].shape[0]
    perm = torch.arange(n, device=operands[0].device)
    for op in reversed(operands):
        key = op[perm]
        if key.dtype == torch.bool:
            key = key.to(torch.uint8)
        perm = perm[torch.sort(key, stable=True).indices]
    return perm


def sort_rows_plain(page: Page, keys: Sequence[SortKey]) -> torch.Tensor:
    """Plain twin of K10: the stable order of the page's rows by `keys`
    (a stable torch.sort per packed word, least significant first)."""
    return sort_permutation(encode_sort_keys(page, keys))


# K10's radix launch (csrc/sort.cu): one block sorts a live prefix of up
# to SMALL_ROWS rows in shared memory; larger ones take one launch per
# informative digit pass over tiles of SORT_TILE rows; a word's passes
# follow one gather of that word, GROUP_PASSES passes at most.
SMALL_ROWS = 8192
SORT_TILE = 4096
GROUP_PASSES = 8
_MAX_KEYS = 64


def _key_table(page: Page, keys, layout) -> Tuple[list, list]:
    cols = []
    for k in keys:
        c = page.column(k.channel)
        v = c.values
        if any(t is not None and (t.dim() != 1 or not t.is_contiguous()
                                  or t.shape[0] != page.capacity)
               for t in (v, c.valid)):
            raise ValueError("sort key columns must be contiguous 1-D "
                             "tensors of the page's capacity")
        flags = (int(v.is_floating_point()) | int(k.ascending) << 1
                 | int(k.resolved_nulls_first()) << 2
                 | int(v.dtype == torch.bool) << 3)
        cols += [v.data_ptr(), 0 if c.valid is None else
                 c.valid.data_ptr(), v.element_size(), flags]
    return cols, _fields(layout)


@functools.lru_cache(maxsize=None)
def _fields(layout: Tuple[SortField, ...]) -> Tuple[int, ...]:
    return tuple(x for f in layout
                 for x in (f.kind, f.key, f.word, f.shift, f.width))


def sort_passes(layout: Sequence[SortField]) -> List[Tuple[int, int]]:
    """The 8-bit digit passes of an LSD radix sort of the packed words,
    least significant first: only bytes that hold a field's bits (the
    unused low bits of a word are 0 in every row)."""
    return list(_passes(tuple(layout)))


@functools.lru_cache(maxsize=None)
def _passes(layout: Tuple[SortField, ...]) -> Tuple[Tuple[int, int], ...]:
    used = {}
    for f in layout:
        used.setdefault(f.word, set()).update(
            range(f.shift // 8, (f.shift + f.width - 1) // 8 + 1))
    return tuple((w, 8 * byte) for w in sorted(used, reverse=True)
                 for byte in sorted(used[w]))


@functools.lru_cache(maxsize=None)
def _passes_table(passes: Tuple[Tuple[int, int], ...]):
    """The passes as sort_radix reads them: words, then shifts."""
    return host_table([w for w, _ in passes], [s for _, s in passes])


def _encode(page: Page, keys, layout, words: torch.Tensor) -> None:
    """K10's encode launch into words [nwords, cap] (live rows only)."""
    if not 0 < len(keys) <= _MAX_KEYS:
        raise ValueError(f"K10 sorts by 1 to {_MAX_KEYS} keys")
    cols, fields = _key_table(page, keys, layout)
    rc = native.library("sort").sort_encode(
        ctypes.c_void_p(page.num_rows.data_ptr()),
        ctypes.c_int64(page.capacity), ctypes.c_int64(len(keys)),
        ctypes.c_int64(len(layout)), host_table(cols, fields),
        ctypes.c_void_p(words.data_ptr()),
        ctypes.c_void_p(native.stream_ptr(page.device)))
    native.check(rc, "sort_encode")


def sort_rows_cuda(page: Page, keys: Sequence[SortKey]) -> torch.Tensor:
    """K10 launch: see csrc/sort.cu. Encodes the keys of the live prefix,
    then radix-sorts it; rows past num_rows keep their places."""
    dev = page.device
    keys = tuple(keys)
    cap = page.capacity
    layout = sort_layout(page, keys)
    words = torch.empty((layout[-1].word + 1, cap), dtype=torch.int64,
                        device=dev)
    _encode(page, keys, layout, words)
    perm = radix_sort_words(words, page.num_rows, _passes(layout))
    sort_rows_cuda.launches += 1
    return perm


sort_rows_cuda.launches = 0


def radix_sort_words(words: torch.Tensor, num_rows: torch.Tensor,
                     passes: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """K10's radix launch over words [nwords, cap] (each word stored with
    its sign bit flipped) for the 8-bit digit `passes`, least significant
    first: the int32 permutation that sorts the live prefix stably (rows
    past num_rows keep their places). The sort of K16 (ops/join.py) and
    of rank_bounds (exec/spill.py) reuse it."""
    return _radix(words, num_rows, passes, False)[0]


_RADIX_ARGS = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
               ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)


def radix_scratch_sizes(cap: int, npasses: int) -> Tuple[int, ...]:
    """int64 words of K10's scratch parts above SMALL_ROWS rows of
    capacity: two key buffers, the second index buffer, the plan, two
    status buffers (256 words per tile); none at or below it."""
    if cap <= SMALL_ROWS:
        return ()
    return (2 * cap, -(-cap // 2), 257 * npasses + 4,
            2 * 256 * -(-cap // SORT_TILE))


def _radix(words: torch.Tensor, num_rows: torch.Tensor,
           passes: Sequence[Tuple[int, int]], want_keys: bool):
    """radix_sort_words, and with `want_keys` also the sorted unsigned
    words (int64) of the last pass's word over the live rows."""
    dev = words.device
    cap = words.shape[1]
    perm = torch.empty(cap, dtype=torch.int32, device=dev)
    keys_out = torch.empty(cap, dtype=torch.int64, device=dev) \
        if want_keys else None
    sizes = radix_scratch_sizes(cap, len(passes))
    scratch = torch.split(torch.empty(sum(sizes), dtype=torch.int64,
                                      device=dev), sizes) if sizes else ()
    radix_into(words, num_rows, passes, perm, keys_out, scratch)
    return perm, keys_out


def radix_into(words: torch.Tensor, num_rows: torch.Tensor,
               passes: Sequence[Tuple[int, int]], perm: torch.Tensor,
               keys_out: Optional[torch.Tensor], scratch) -> None:
    """K10's radix launch into buffers the caller allocated: perm int32
    [cap], keys_out int64 [cap] or None, and `scratch`, the parts of
    radix_scratch_sizes (none at or below SMALL_ROWS rows of capacity).
    K16 (ops/join.py) carves them from its one allocation."""
    cap = words.shape[1]
    ptrs = [t.data_ptr() for t in scratch] if scratch else [None] * 4
    rc = native.function("sort", "sort_radix", _RADIX_ARGS)(
        num_rows.data_ptr(), cap, words.data_ptr(), len(passes),
        _passes_table(tuple(passes)), perm.data_ptr(),
        None if keys_out is None else keys_out.data_ptr(), *ptrs,
        native.raw_stream(words.get_device()))
    native.check(rc, "sort_radix")


def sort_u64_cuda(words: torch.Tensor) -> torch.Tensor:
    """int64 words holding u64 values, sorted in unsigned order by K10's
    radix passes (all eight bytes; every row sorted). The result is the
    last pass's keys: no gather through the permutation."""
    cap = words.shape[0]
    n = torch.full((), cap, dtype=torch.int32, device=words.device)
    _, keys = _radix((words ^ _I64_MIN).reshape(1, cap), n,
                     [(0, 8 * b) for b in range(8)], True)
    sort_u64_cuda.launches += 1
    return keys


sort_u64_cuda.launches = 0


# ------------------------------------- plain models of K10's pass plan

def pass_groups(passes: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The passes K10 runs after one gather: [start, end) runs of passes
    over one word, at most GROUP_PASSES long (csrc/sort.cu Passes)."""
    out = []
    for q, (w, _) in enumerate(passes):
        if not out or passes[q - 1][0] != w or q - out[-1][0] == GROUP_PASSES:
            out.append([q, q])
        out[-1][1] = q + 1
    return [tuple(g) for g in out]


def _live(num_rows, cap: int) -> int:
    return min(max(int(num_rows), 0), cap)


def digit_histograms_plain(words: Sequence[torch.Tensor], num_rows,
                           passes: Sequence[Tuple[int, int]]
                           ) -> torch.Tensor:
    """Plain twin of K10's histogram launch: int64 [npasses, 256], the
    live rows' count of each digit of each pass (the counts do not depend
    on the rows' order, so one launch counts every pass)."""
    cap = words[0].shape[0]
    n = _live(num_rows, cap)
    out = torch.zeros((len(passes), 256), dtype=torch.int64,
                      device=words[0].device)
    for q, (w, shift) in enumerate(passes):
        digit = ((words[w][:n] ^ _I64_MIN) >> shift) & 0xFF
        out[q] = torch.bincount(digit, minlength=256)
    return out


def informative_passes_plain(words: Sequence[torch.Tensor], num_rows,
                             passes: Sequence[Tuple[int, int]]
                             ) -> List[bool]:
    """Plain twin of K10's plan: a pass is informative unless one digit
    holds every live row (a stable pass over one digit moves nothing; with
    0 or 1 live rows no pass is informative)."""
    n = _live(num_rows, words[0].shape[0])
    return [bool(h.max() != n) for h in
            digit_histograms_plain(words, num_rows, passes)]


def scatter_positions_plain(digits: torch.Tensor, tile: int
                            ) -> torch.Tensor:
    """Plain model of one pass's scatter: row i of digit d goes to d's
    base (the rows of smaller digits), plus the rows of d in the tiles
    before i's (the look-back's prefix), plus i's rank among the rows of
    d in its own tile (rows in order)."""
    d = digits.to(torch.int64).cpu()
    counts = torch.bincount(d, minlength=256)
    before = torch.cumsum(counts, 0) - counts     # the digits' bases
    pos = torch.empty_like(d)
    for lo in range(0, d.shape[0], tile):
        dt = d[lo:lo + tile]
        # the earlier rows of the tile with the same digit
        order = torch.argsort(dt, stable=True)
        rank = torch.empty_like(dt)
        rank[order] = torch.arange(dt.shape[0]) - torch.searchsorted(
            dt[order], dt[order])
        pos[lo:lo + tile] = before[dt] + rank
        before += torch.bincount(dt, minlength=256)   # the next tiles'
    return pos


def radix_replay_plain(words: Sequence[torch.Tensor], num_rows,
                       passes: Sequence[Tuple[int, int]],
                       tile: int = SORT_TILE) -> torch.Tensor:
    """K10's radix launch replayed step by step on the CPU: the plan's
    informative passes only, one gather of each word whose group has one,
    each pass's (key, index) pairs moved to scatter_positions_plain; the
    identity past num_rows. Equal to the permutation of sort_permutation
    over the live prefix."""
    cap = words[0].shape[0]
    n = _live(num_rows, cap)
    keep = informative_passes_plain(words, num_rows, passes)
    idx = torch.arange(n)
    for q0, q1 in pass_groups(passes):
        if not any(keep[q0:q1]):
            continue
        keys = (words[passes[q0][0]][:n].cpu() ^ _I64_MIN)[idx]
        for q in range(q0, q1):
            if keep[q]:
                pos = scatter_positions_plain(
                    (keys >> passes[q][1]) & 0xFF, tile)
                keys = torch.empty_like(keys).index_put_((pos,), keys)
                idx = torch.empty_like(idx).index_put_((pos,), idx)
    return torch.cat([idx, torch.arange(n, cap)]).to(torch.int32)


def encode_sort_keys_cuda(page: Page, keys: Sequence[SortKey]
                          ) -> List[torch.Tensor]:
    """K10's encode launch alone (the words of the live prefix), for the
    comparison with encode_sort_keys."""
    keys = tuple(keys)
    layout = sort_layout(page, keys)
    words = torch.zeros((layout[-1].word + 1, page.capacity),
                        dtype=torch.int64, device=page.device)
    _encode(page, keys, layout, words)
    return list(words)


def sort_rows(page: Page, keys: Sequence[SortKey]) -> torch.Tensor:
    """K10 wrapper: plain twin on the CPU, kernel on CUDA."""
    run = sort_rows_cuda if page.device.type == "cuda" else sort_rows_plain
    return run(page, keys)


def order_by(keys: Sequence[SortKey]) -> Callable[[Page], Page]:
    """Full sort of the page by keys (stable)."""
    keys = tuple(keys)

    def op(page: Page) -> Page:
        return page.gather(sort_rows(page, keys), page.num_rows)

    return op


def top_n_masked(keys: Sequence[SortKey]) -> Callable[[Page, Any], Page]:
    """ORDER BY ... LIMIT ? with the count as a runtime operand: the sort
    runs over the page and the count only masks num_rows."""
    sort_op = order_by(keys)

    def op(page: Page, count) -> Page:
        out = sort_op(page)
        return Page(out.columns, torch.minimum(
            out.num_rows, row_count(count, out.device)))

    return op


def top_n(count: int, keys: Sequence[SortKey]) -> Callable[[Page], Page]:
    """ORDER BY ... LIMIT n with the count baked in."""
    masked = top_n_masked(keys)

    def op(page: Page) -> Page:
        return masked(page, count)

    return op


def limit(count: int) -> Callable[[Page], Page]:
    def op(page: Page) -> Page:
        return Page(page.columns, torch.minimum(
            page.num_rows, row_count(count, page.device)))

    return op
