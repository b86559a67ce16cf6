"""Sort / TopN / Limit operators.

Port of `trino_tpu/ops/sort.py`. The reference runs one multi-operand
stable `lax.sort` whose leading keys are the dead-row flag and per-key
null and NaN flags. Here the same operands are packed, most significant
first, into order-preserving 64-bit words (`encode_sort_keys`), and the
words are sorted stably: by K10 (`csrc/sort.cu`, an LSD radix sort that
carries an int32 permutation) for CUDA pages, by a chain of stable
`torch.sort`s (least significant word first) for CPU pages. Both give the
reference's permutation; `Page.gather` (K7) applies it.

Ordering semantics (Trino): ASC defaults to NULLS LAST, DESC to NULLS
FIRST; NaN sorts largest; -0.0 and +0.0 tie; ties keep input order. DESC
is the reference's negation, so INT_MIN under DESC stays INT_MIN and
sorts first (ROADMAP §C).
"""

from __future__ import annotations

import ctypes
import dataclasses
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


def sort_layout(page: Page, keys: Sequence[SortKey]) -> List[SortField]:
    """The fields of `_sort_operands` in order (the dead flag; per key a
    null flag when the column has validity, a NaN flag when it is a
    float, the value), packed most significant first into 64-bit words. A
    field never straddles two words: one that does not fit in what is
    left of a word starts the next, so the words compare in the fields'
    lexicographic order however wide the key tuple is."""
    raw = [(DEAD, -1, 1)]
    for j, k in enumerate(keys):
        col = page.column(k.channel)
        if col.valid is not None:
            raw.append((NULL, j, 1))
        if col.values.is_floating_point():
            raw.append((NAN, j, 1))
        raw.append((VALUE, j, _value_bits(col.values.dtype)))
    out, word, used = [], 0, 0
    for kind, key, width in raw:
        if used + width > 64:
            word, used = word + 1, 0
        out.append(SortField(kind, key, width, word, 64 - used - width))
        used += width
    return out


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


# One block sorts a live prefix up to this many rows with every digit
# pass inside one launch; larger pages take the multi-block passes.
ONE_BLOCK_ROWS = 1 << 16
SORT_TILE = 4096          # rows per block of a multi-block pass (tile.cuh)
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
    fields = [x for f in layout
              for x in (f.kind, f.key, f.word, f.shift, f.width)]
    return cols, fields


def sort_passes(layout: Sequence[SortField]) -> List[Tuple[int, int]]:
    """The 8-bit digit passes of an LSD radix sort of the packed words,
    least significant first: only bytes that hold a field's bits (the
    unused low bits of a word are 0 in every row)."""
    used = {}
    for f in layout:
        for b in range(f.shift, f.shift + f.width):
            used.setdefault(f.word, set()).add(b // 8)
    return [(w, 8 * byte) for w in sorted(used, reverse=True)
            for byte in sorted(used[w])]


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
    perm = radix_sort_words(words, page.num_rows, sort_passes(layout))
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
    dev = words.device
    cap = words.shape[1]
    perm = torch.empty(cap, dtype=torch.int32, device=dev)
    tmp = torch.empty(cap, dtype=torch.int32, device=dev)
    one_block = cap <= ONE_BLOCK_ROWS
    ntiles = max(1, -(-cap // SORT_TILE))
    hist = torch.empty(1 if one_block else 256 * ntiles + 1,
                       dtype=torch.int64, device=dev)
    rc = native.library("sort").sort_radix(
        ctypes.c_void_p(num_rows.data_ptr()), ctypes.c_int64(cap),
        ctypes.c_void_p(words.data_ptr()), ctypes.c_int64(len(passes)),
        host_table([w for w, _ in passes], [s for _, s in passes]),
        ctypes.c_void_p(perm.data_ptr()), ctypes.c_void_p(tmp.data_ptr()),
        ctypes.c_void_p(hist.data_ptr()), ctypes.c_int64(int(one_block)),
        ctypes.c_void_p(native.stream_ptr(dev)))
    native.check(rc, "sort_radix")
    return perm


def sort_u64_cuda(words: torch.Tensor) -> torch.Tensor:
    """int64 words holding u64 values, sorted in unsigned order by K10's
    radix passes (all eight bytes; every row sorted)."""
    cap = words.shape[0]
    n = torch.full((), cap, dtype=torch.int32, device=words.device)
    perm = radix_sort_words((words ^ _I64_MIN).reshape(1, cap), n,
                            [(0, 8 * b) for b in range(8)])
    return words[perm.to(torch.int64)]


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
