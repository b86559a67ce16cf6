"""Sort / TopN / Limit operators.

Port of `trino_tpu/ops/sort.py` in plain torch tensor ops (the hand-written
radix sort is ROADMAP B5). The reference runs one multi-operand stable
`lax.sort` whose leading keys are the dead-row flag and per-key null and
NaN flags; here the same operands drive a chain of stable sorts from the
last key to the first, which yields the same permutation.

Ordering semantics (Trino): ASC defaults to NULLS LAST, DESC to NULLS
FIRST; NaN sorts largest; ties keep input order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import torch

from trino_tpu_torch.page import Page, row_count

_I64_MAX = (1 << 63) - 1


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
    """Floats as int64 keys in the total order the reference's sort uses
    (-0.0 before +0.0); NaN is already replaced by its own flag key."""
    b = values.to(torch.float64).view(torch.int64)
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


def order_by(keys: Sequence[SortKey]) -> Callable[[Page], Page]:
    """Full sort of the page by keys (stable)."""
    keys = tuple(keys)

    def op(page: Page) -> Page:
        order = sort_permutation(_sort_operands(page, keys))
        return page.gather(order, page.num_rows)

    return op


def top_n_masked(keys: Sequence[SortKey]) -> Callable[[Page, Any], Page]:
    """ORDER BY ... LIMIT ? with the count as a runtime operand: the sort
    runs at full capacity and the count only masks num_rows."""
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
