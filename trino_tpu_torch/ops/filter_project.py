"""Fused filter + project operator.

Reference parity: operator/ScanFilterAndProjectOperator.java +
FilterAndProjectOperator.java with their compiled PageProcessor
(operator/project/PageProcessor.java). A filter and a project step are
each an expr/kernel_gen.ExprStep: on a CUDA page one generated Triton
kernel (K11) per step, on a CPU page the plain torch-op compiler; the
page compaction runs K1 (Page.filter).

Parameterized compilation: expressions may carry `Param` leaves
(expr/hoist.py) indexing one shared runtime values tuple for the whole
fused op — hoist the filter and projections together with
hoist_literal_seq so their indices align, then pass that tuple per call.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

from trino_tpu_torch.expr.ir import RowExpression
from trino_tpu_torch.expr.kernel_gen import filter_step, project_step
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
    keep = filter_step(filter_expr) if filter_expr is not None else None
    project = project_step(projections)

    def op(page: Page, call_params: tuple = params) -> Page:
        if keep is not None:
            page = page.filter(keep(page, call_params))
        return Page(project(page, call_params), page.num_rows)

    return op
