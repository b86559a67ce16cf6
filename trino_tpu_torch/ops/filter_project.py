"""Fused filter + project operator.

Reference parity: operator/ScanFilterAndProjectOperator.java +
FilterAndProjectOperator.java with their compiled PageProcessor
(operator/project/PageProcessor.java). Here: compile_filter/compile_expression
produce torch tensor functions, and the page compaction runs K1
(Page.filter).

Parameterized compilation: expressions may carry `Param` leaves
(expr/hoist.py) indexing one shared runtime values tuple for the whole
fused op — hoist the filter and projections together with
hoist_literal_seq so their indices align, then pass that tuple per call.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

from trino_tpu_torch.expr.compiler import compile_expression, compile_filter
from trino_tpu_torch.expr.ir import RowExpression
from trino_tpu_torch.page import Page


def filter_project(
    filter_expr: Optional[RowExpression],
    projections: Sequence[RowExpression],
    params: tuple = (),
) -> Callable[..., Page]:
    """Build op: keep rows passing filter_expr, emit one column per
    projection. `params` is the default hoisted-literal tuple; callers
    running literal variants of the same compiled op pass theirs per
    call: op(page, variant_params)."""
    filter_fn = compile_filter(filter_expr) if filter_expr is not None else None
    project_fns = [compile_expression(p) for p in projections]

    def op(page: Page, call_params: tuple = params) -> Page:
        if filter_fn is not None:
            page = page.filter(filter_fn(page, call_params))
        cols = tuple(fn(page, call_params) for fn in project_fns)
        return Page(cols, page.num_rows)

    return op
