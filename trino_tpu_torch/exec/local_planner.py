"""Local execution: lower a logical plan to streaming page pipelines.

Port of `trino_tpu/exec/local_planner.py`, the subset on the TPC-H q1/q6
path: TableScan, Values, Filter, Project, Limit, Offset, Aggregation
(partial per page, a device-side buffer merge, final), Sort, TopN and
Output. A node executes to an iterator of fixed-capacity Pages plus a
symbol layout; streaming operators (filter/project/select) queue entries
on the stream, and the consumer runs the composed chain per page, fused
with a blocking consumer's tail (the partial aggregation).

The per-page loop never reads a row count on the host: the only count
fetch is one batched read at the merge boundary (merge_counted_rows).

Every other node, and an aggregation buffer past
`agg_spill_threshold_bytes`, raises an ExecutionError naming the ROADMAP
item that ports it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.errors import GENERIC_INTERNAL_ERROR, TrinoError
from trino_tpu_torch.exec.jit_cache import cached_kernel
from trino_tpu_torch.expr.compiler import compile_expression, compile_filter
from trino_tpu_torch.expr.ir import (Call, InputRef, Literal, RowExpression,
                                     SpecialForm, SymbolRef)
from trino_tpu_torch.metadata import Metadata, Session
from trino_tpu_torch.ops import (AggSpec, SortKey, Step, hash_aggregate,
                                 order_by, top_n_masked)
from trino_tpu_torch.page import Column, Dictionary, Page, _to_device, \
    device_concat, row_count
from trino_tpu_torch.planner.nodes import (
    AggregationNode, FilterNode, LimitNode, OffsetNode, OutputNode,
    PlanNode, ProjectNode, SortNode, Symbol, TableScanNode, TopNNode,
    ValuesNode)

# plan nodes of the reference this slice does not run yet -> ROADMAP item
_LATER = {
    "JoinNode": "A3/B4 (hash join)",
    "SemiJoinNode": "A3/B4 (hash join)",
    "WindowNode": "A8/B7 (window functions)",
    "GroupIdNode": "A8 (grouping sets)",
    "UnionNode": "A8 (union)",
    "UnnestNode": "A8 (unnest)",
    "ExchangeNode": "A9 (multi-GPU exchange)",
    "TableWriterNode": "A10 (writes)",
    "DistinctLimitNode": "A3/B3 (sort-based aggregation)",
    "EnforceSingleRowNode": "A6 (scalar subqueries)",
    "AssignUniqueIdNode": "A6 (scalar subqueries)",
}


class ExecutionError(TrinoError):
    """Operator-lowering/runtime defect: internal, not retryable."""

    CODE = GENERIC_INTERNAL_ERROR


def lower_expr(e: RowExpression, layout: Dict[str, int],
               types: Dict[str, T.Type]) -> RowExpression:
    """SymbolRef -> InputRef against a page layout."""
    if isinstance(e, SymbolRef):
        if e.name not in layout:
            raise ExecutionError(f"symbol {e.name} not in layout")
        return InputRef(layout[e.name], types[e.name])
    if isinstance(e, Call):
        return Call(e.name, tuple(lower_expr(a, layout, types)
                                  for a in e.args), e.type)
    if isinstance(e, SpecialForm):
        return SpecialForm(e.kind, tuple(lower_expr(a, layout, types)
                                         for a in e.args), e.type)
    return e


def _layout(symbols: Sequence[Symbol]) -> Tuple[Dict[str, int],
                                                Dict[str, T.Type]]:
    lay = {s.name: i for i, s in enumerate(symbols)}
    typ = {s.name: s.type for s in symbols}
    return lay, typ


def _next_pow2(n: int) -> int:
    out = 1024
    while out < n:
        out *= 2
    return out


def page_bytes(page: Page) -> int:
    return sum(c.nbytes for c in page.columns)


@dataclasses.dataclass
class PageStream:
    """Stream of pages + a lazy chain of per-page transforms. Streaming
    operators append (cache_key, builder, params) entries to `pending`;
    consumers run the composed chain per page (iter_pages) or fuse it
    with their own tail (compose_chain)."""

    pages: Iterator[Page]
    symbols: Tuple[Symbol, ...]
    pending: Tuple[tuple, ...] = ()

    def iter_pages(self) -> Iterator[Page]:
        fn = compose_chain(self.pending)
        if fn is None:
            yield from self.pages
        else:
            for p in self.pages:
                yield fn(p)


def compose_chain(pending, tail_key=None, tail_builder=None):
    """One cached callable running every pending transform (+ optional
    tail op, e.g. a partial aggregation). The cache key holds only the
    canonical (literal-free) op keys; hoisted literal values are passed
    per call."""
    if not pending and tail_builder is None:
        return None
    key = ("chain",) + tuple(e[0] for e in pending) + \
        ((tail_key,) if tail_key is not None else ())
    param_groups = tuple(tuple(e[2]) for e in pending)

    def build():
        fns = [e[1]() for e in pending]
        tail = tail_builder() if tail_builder is not None else None

        def run(page, groups):
            for f, g in zip(fns, groups):
                page = f(page, g)
            if tail is not None:
                page = tail(page)
            return page
        return run
    kernel = cached_kernel(key, build, params=param_groups)

    def call(page):
        return kernel(page, param_groups)
    return call


class LocalExecutionPlanner:
    """Single-process executor over one device."""

    def __init__(self, metadata: Metadata, session: Session, device):
        self.metadata = metadata
        self.session = session
        self.device = torch.device(device)
        self.page_capacity = int(session.get("page_capacity"))
        self._hoist_on = bool(session.get("hoist_literals"))
        # statement parameter values (EXECUTE ... USING)
        self.exec_params: tuple = ()

    # ------------------------------------------------- literal hoisting

    def _hoist(self, expr):
        """(literal-free tree, runtime values tuple) for one expression."""
        if expr is None:
            return expr, ()
        from trino_tpu_torch.expr.hoist import hoist_literals, \
            materialize_bound
        if not self._hoist_on:
            return materialize_bound(expr, self.exec_params), ()
        return hoist_literals(expr, bound=self.exec_params)

    def _hoist_seq(self, exprs):
        from trino_tpu_torch.expr.hoist import hoist_literal_seq, \
            materialize_bound
        if not self._hoist_on:
            return tuple(materialize_bound(e, self.exec_params)
                         for e in exprs), ()
        return hoist_literal_seq(exprs, bound=self.exec_params)

    # ------------------------------------------------------------ dispatch

    def execute(self, node: PlanNode) -> PageStream:
        name = type(node).__name__
        method = getattr(self, f"_exec_{name}", None)
        if method is None:
            later = _LATER.get(name, "its own slice")
            raise ExecutionError(
                f"no executor for {name} yet: ROADMAP {later}")
        return method(node)

    # ---------------------------------------------------------------- leaf

    def _exec_TableScanNode(self, node: TableScanNode) -> PageStream:
        conn = self.metadata.connector(node.catalog)
        columns = [c for _, c in node.assignments]
        cap = self._scan_capacity(conn, node)
        symbols = tuple(s for s, _ in node.assignments)

        def gen():
            splits = conn.split_manager.get_splits(node.table,
                                                   target_splits=1)
            for split in splits:
                yield from conn.page_source.pages(split, columns, cap)
        return PageStream(gen(), symbols)

    def _scan_capacity(self, conn, node: TableScanNode) -> int:
        """One big page per split (up to scan_page_capacity rows) keeps
        the steady state at a handful of device calls per scan."""
        cap = self.page_capacity
        stats = conn.metadata.get_table_statistics(node.table)
        rows = int(stats.row_count) if stats and stats.row_count else 0
        if rows > cap:
            max_cap = int(self.session.get("scan_page_capacity"))
            cap = min(_next_pow2(rows), max_cap)
        return cap

    def _exec_ValuesNode(self, node: ValuesNode) -> PageStream:
        cols = []
        n = len(node.rows)
        cap = max(_next_pow2(n), 8)
        for i, sym in enumerate(node.symbols):
            typ = sym.type
            vals = []
            valid = []
            for row in node.rows:
                lit = row[i]
                if not isinstance(lit, Literal):
                    raise ExecutionError("VALUES row is not literal")
                vals.append(0 if lit.value is None else lit.value)
                valid.append(lit.value is not None)
            if T.is_string(typ):
                d, codes = Dictionary.build(np.asarray(
                    [v if isinstance(v, str) else "" for v in vals],
                    dtype=object))
                arr = np.zeros(cap, dtype=np.int32)
                arr[:n] = codes
            else:
                d = None
                arr = np.zeros(cap, dtype=T.to_numpy_dtype(typ))
                arr[:n] = vals
            cols.append(Column(_to_device(arr, self.device),
                               _valid_arr(valid, cap, self.device), typ, d))
        page = Page(tuple(cols), row_count(n, self.device))
        return PageStream(iter([page]), node.symbols)

    # ----------------------------------------------------------- streaming

    def _exec_FilterNode(self, node: FilterNode) -> PageStream:
        src = self.execute(node.source)
        lay, typ = _layout(src.symbols)
        pred, prm = self._hoist(lower_expr(node.predicate, lay, typ))
        return PageStream(
            src.pages, src.symbols,
            src.pending + ((("filter", pred),
                            lambda: lambda p, g, f=compile_filter(pred):
                            p.filter(f(p, g)), prm),))

    def _exec_ProjectNode(self, node: ProjectNode) -> PageStream:
        src = self.execute(node.source)
        lay, typ = _layout(src.symbols)
        exprs, prm = self._hoist_seq(
            tuple(lower_expr(e, lay, typ) for _, e in node.assignments))

        def builder():
            fns = [compile_expression(e) for e in exprs]
            return lambda page, g: Page(tuple(fn(page, g) for fn in fns),
                                        page.num_rows)
        return PageStream(src.pages, tuple(s for s, _ in node.assignments),
                          src.pending + ((("project", exprs), builder,
                                          prm),))

    def _exec_LimitNode(self, node: LimitNode) -> PageStream:
        src = self.execute(node.source)

        def gen():
            remaining = node.count
            for page in src.iter_pages():
                n = int(page.num_rows)
                if n >= remaining:
                    yield Page(page.columns, row_count(remaining,
                                                       page.device))
                    return
                remaining -= n
                yield page
        return PageStream(gen(), src.symbols)

    def _exec_OffsetNode(self, node: OffsetNode) -> PageStream:
        src = self.execute(node.source)

        def gen():
            to_skip = node.count
            for page in src.iter_pages():
                n = int(page.num_rows)
                if to_skip >= n:
                    to_skip -= n
                    continue
                if to_skip > 0:
                    idx = torch.arange(page.capacity, dtype=torch.int64,
                                       device=page.device) + to_skip
                    page = page.gather(idx, n - to_skip)
                    to_skip = 0
                yield page
        return PageStream(gen(), src.symbols)

    # ------------------------------------------------------------ blocking

    def merge_counted(self, pages: List[Page]) -> Optional[Page]:
        page, _ = self.merge_counted_rows(pages)
        return page

    def merge_counted_rows(self, pages: List[Page]
                           ) -> Tuple[Optional[Page], int]:
        """Concatenate pages on the device (K2) after ONE batched count
        fetch; each page first shrinks to its live pow2 envelope so the
        concat is O(live rows)."""
        if not pages:
            return None, 0
        counts = torch.stack([p.num_rows for p in pages]).tolist()
        total = sum(counts)
        if total == 0:
            return None, 0
        live = [self._tight(p, c) for p, c in zip(pages, counts) if c > 0]
        return self._merge_buf(live, total), total

    @staticmethod
    def _tight(page: Page, n: int) -> Page:
        """Shrink a page to the pow2 envelope of its live count."""
        tight = _next_pow2(max(n, 1))
        if page.capacity > 2 * tight:
            return page.shrink_to(tight)
        return page

    def _merge_buf(self, buf: List[Page], rows: int) -> Page:
        page = buf[0] if len(buf) == 1 else device_concat(buf)
        return self._tight(page, rows)

    def _exec_AggregationNode(self, node: AggregationNode) -> PageStream:
        src = self.execute(node.source)
        lay, typ = _layout(src.symbols)
        key_channels = [lay[s.name] for s in node.group_by]
        specs = []
        for out_sym, call in node.aggregations:
            input_ch = in_type = None
            if call.args:
                arg = call.args[0]
                if not isinstance(arg, SymbolRef):
                    raise ExecutionError("aggregate argument not a symbol")
                input_ch, in_type = lay[arg.name], typ[arg.name]
            in2_ch = in2_type = None
            if len(call.args) > 1:
                in2_ch = lay[call.args[1].name]
                in2_type = typ[call.args[1].name]
            mask_ch = None
            if call.filter is not None:
                mask_ch = lay[call.filter.name]
            specs.append(AggSpec(call.name, input_ch, in_type, mask_ch,
                                 call.distinct, in2_ch, in2_type))
        key_channels_t = tuple(key_channels)
        specs_t = tuple(specs)
        # scan -> filter -> project -> partial agg as ONE composed call
        partial_op = compose_chain(
            src.pending, ("agg-partial", key_channels_t, specs_t),
            lambda: hash_aggregate(key_channels, specs, Step.PARTIAL))
        from trino_tpu_torch.ops.aggregate import get_aggregate
        nkeys = len(key_channels)
        state_channels = []
        ch = nkeys
        for spec in specs:
            fn = get_aggregate(spec.name, spec.input_type)
            k = len(fn.state(spec.input_type))
            state_channels.append(list(range(ch, ch + k)))
            ch += k
        final_keys = list(range(nkeys))
        final_op = cached_kernel(
            ("agg-final", nkeys, specs_t),
            lambda: hash_aggregate(final_keys, specs, Step.FINAL,
                                   state_channels))
        threshold = int(self.session.get("agg_spill_threshold_bytes"))
        spillable = bool(self.session.get("spill_enabled")) \
            and bool(key_channels)

        def gen():
            # no per-page num_rows sync: empty pages produce neutral
            # partial states that merge correctly
            buf: List[Page] = []
            buf_bytes = 0
            for page in src.pages:
                pp = partial_op(page)
                buf.append(pp)
                buf_bytes += page_bytes(pp)
                if spillable and buf_bytes >= threshold:
                    raise ExecutionError(
                        "aggregation buffer past agg_spill_threshold_bytes"
                        ": spill is ROADMAP A7/B10")
            merged, _ = self.merge_counted_rows(buf)
            if merged is None:
                # no input pages, or every partial empty (grouped agg ->
                # no output; a global agg's partials always carry a row)
                if not key_channels:
                    yield self._empty_global_agg(node)
                return
            yield final_op(merged)
        return PageStream(gen(), node.outputs)

    def _empty_global_agg(self, node: AggregationNode) -> Page:
        cols = []
        dev = self.device
        for sym, call in node.aggregations:
            typ = sym.type
            values = torch.zeros(8, dtype=typ.dtype, device=dev)
            if call.name in ("count", "count_if", "approx_distinct"):
                cols.append(Column(values, None, typ, None))
            else:
                cols.append(Column(values, torch.zeros(
                    8, dtype=torch.bool, device=dev), typ, None))
        return Page(tuple(cols), row_count(1, dev))

    def _exec_SortNode(self, node: SortNode) -> PageStream:
        src = self.execute(node.source)
        lay, _ = _layout(src.symbols)
        keys = [SortKey(lay[o.symbol.name], o.ascending, o.nulls_first)
                for o in node.order_by]
        sort_op = cached_kernel(("sort", tuple(keys)),
                                lambda: order_by(keys))

        def gen():
            page = self.merge_counted(list(src.iter_pages()))
            if page is not None:
                yield sort_op(page)
        return PageStream(gen(), src.symbols)

    def _exec_TopNNode(self, node: TopNNode) -> PageStream:
        src = self.execute(node.source)
        lay, _ = _layout(src.symbols)
        keys = tuple(SortKey(lay[o.symbol.name], o.ascending,
                             o.nulls_first) for o in node.order_by)
        # the count rides as a runtime operand: the cache key is count-free
        count = np.int32(node.count)
        key = ("topn-masked", keys)

        def builder():
            fn = top_n_masked(keys)
            return lambda page, g: fn(page, g[0])
        partial_topn = compose_chain(src.pending + ((key, builder,
                                                     (count,)),))
        merge_kernel = cached_kernel(key, lambda: top_n_masked(keys),
                                     params=(count,))

        def gen():
            # partial top-n per page bounds the merge at count * n_pages
            merged = self.merge_counted(
                [partial_topn(page) for page in src.pages])
            if merged is not None:
                yield merge_kernel(merged, int(count))
        return PageStream(gen(), src.symbols)

    def _exec_OutputNode(self, node: OutputNode) -> PageStream:
        src = self.execute(node.source)
        return _reorder_stream(src, node.symbols)


def _reorder_stream(src: PageStream, symbols: Tuple[Symbol, ...]
                    ) -> PageStream:
    """Select/reorder a stream's columns to `symbols` (identity is free)."""
    lay, _ = _layout(src.symbols)
    order = tuple(lay[s.name] for s in symbols)
    if order == tuple(range(len(src.symbols))):
        return PageStream(src.pages, symbols, src.pending)
    return PageStream(
        src.pages, symbols,
        src.pending + ((("select", order),
                        lambda: lambda p, g: Page(
                            tuple(p.columns[c] for c in order),
                            p.num_rows), ()),))


def _valid_arr(valid: List[bool], cap: int, device
               ) -> Optional[torch.Tensor]:
    if all(valid):
        return None
    arr = np.zeros(cap, dtype=bool)
    arr[:len(valid)] = valid
    return _to_device(arr, device)
