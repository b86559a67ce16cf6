"""Local execution: lower a logical plan to streaming page pipelines.

Port of `trino_tpu/exec/local_planner.py`, the subset every TPC-H query
runs: TableScan, Values, Filter, Project, Limit, Offset, Aggregation
(partial per page, a device-side buffer merge, final; DISTINCT collected
and run in one SINGLE step), joins of every kind (INNER over a unique
build side, the expanding probe for duplicate build keys, LEFT, RIGHT as
a flipped LEFT, FULL, cross joins), semi joins (SEMI/ANTI fused into a
Filter, MARK otherwise), AssignUniqueId, EnforceSingleRow, Sort, TopN and
Output. A node executes to an iterator of fixed-capacity Pages plus a
symbol layout; streaming operators (filter/project/select) queue entries
on the stream, and the consumer runs the composed chain per page, fused
with a blocking consumer's tail (the partial aggregation).

The per-page loop never reads a row count on the host: count fetches are
batched at the merge boundary (merge_counted_rows), per probe window
(_coalesce_stream), once per join build (_prepare_probe: max_run, the key
span, live rows) and once per probe batch (the join's output totals).

The join router keeps the reference's `dense` (direct-address table) and
`search` routes; the reference's `mxu` route (ops/join_mxu.py, ROADMAP
B11) is not ported, so where the reference would take it the port takes
`dense`, the reference's next choice. Not ported either, and named in
ROADMAP: the build collection that spills under memory pressure
(`_collect_build_resilient`) and the spilled and partitioned joins
(A7/B9; the port collects the build whole and raises past
`join_spill_threshold_bytes`), the aggregating matrix-unit join
`_mxu_agg_join` (B11) and the adaptive partial aggregation (A7).

Every other node and an aggregation buffer past
`agg_spill_threshold_bytes` raise an ExecutionError naming the ROADMAP
item that ports it.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.errors import GENERIC_INTERNAL_ERROR, TrinoError
from trino_tpu_torch.exec.jit_cache import cached_kernel
from trino_tpu_torch.expr.kernel_gen import filter_step, project_step
from trino_tpu_torch.expr.ir import (Call, InputRef, Literal, RowExpression,
                                     SpecialForm, SpecialKind, SymbolRef)
from trino_tpu_torch.metadata import Metadata, Session
from trino_tpu_torch.ops import (AggSpec, SortKey, Step, hash_aggregate,
                                 order_by, top_n_masked)
from trino_tpu_torch.ops.join import (KMAX, KMIN, MAX_RUN, N_LIVE, JoinType,
                                      attach_build, build_dense_table,
                                      build_key_bounds, hash_join,
                                      prepare_build, prepare_runs,
                                      range_prefilter, unique_inner_probe,
                                      unmatched_build_page, unsigned)
from trino_tpu_torch.page import Column, Dictionary, Page, _to_device, \
    device_concat, gather_rows, row_count
from trino_tpu_torch.planner.nodes import (
    AggregationNode, FilterNode, JoinClause, JoinKind, JoinNode, LimitNode,
    OffsetNode, OutputNode, PlanNode, ProjectNode, SemiJoinNode, SortNode,
    Symbol, TableScanNode, TopNNode, ValuesNode)
from trino_tpu_torch.planner.optimizer import combine, conjuncts

# pages looked ahead per batched count fetch (the reference's window)
_WINDOW_PAGES = 8

# plan nodes of the reference this slice does not run yet -> ROADMAP item
_LATER = {
    "WindowNode": "A8/B7 (window functions)",
    "GroupIdNode": "A8 (grouping sets)",
    "UnionNode": "A8 (union)",
    "UnnestNode": "A8 (unnest)",
    "ExchangeNode": "A9 (multi-GPU exchange)",
    "TableWriterNode": "A10 (writes)",
    "DistinctLimitNode": "A3/B3 (sort-based aggregation)",
}

# a cross join past this many output rows per probe page raises, as the
# reference's bounded expansion does
_CROSS_MAX_ROWS = 4 * 1024 * 1024


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
        # one entry per join run (runner.last_joins): kind, route, build
        # live rows, max_run, probe rows, output rows
        self.joins: List[dict] = []

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
        # a Filter over a SemiJoin that uses the match flag as a plain
        # conjunct fuses into the SEMI/ANTI probe; any other use of the
        # flag (inside OR/CASE/a projection) takes the MARK path
        if isinstance(node.source, SemiJoinNode) and \
                _semijoin_filter_mode(node) is not None:
            return self._exec_semijoin_filter(node)
        src = self.execute(node.source)
        lay, typ = _layout(src.symbols)
        pred, prm = self._hoist(lower_expr(node.predicate, lay, typ))
        return PageStream(
            src.pages, src.symbols,
            src.pending + ((("filter", pred),
                            lambda: lambda p, g, f=filter_step(pred):
                            p.filter(f(p, g)), prm),))

    def _exec_ProjectNode(self, node: ProjectNode) -> PageStream:
        src = self.execute(node.source)
        lay, typ = _layout(src.symbols)
        exprs, prm = self._hoist_seq(
            tuple(lower_expr(e, lay, typ) for _, e in node.assignments))

        def builder():
            step = project_step(exprs)
            return lambda page, g: Page(step(page, g), page.num_rows)
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
        if any(spec.distinct for spec in specs):
            # distinctness belongs to a whole group, not a page: collect
            # and run one SINGLE-step aggregation (the reference's
            # MarkDistinct + aggregation in one kernel call)
            single_op = cached_kernel(
                ("agg-single", key_channels_t, specs_t),
                lambda: hash_aggregate(key_channels, specs, Step.SINGLE))

            def gen_distinct():
                page = self._collect(src)
                if page is None:
                    if not key_channels:
                        yield self._empty_global_agg(node)
                    return
                yield single_op(page)
            return PageStream(gen_distinct(), node.outputs)
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

    # ---------------------------------------------------------------- join

    def _collect(self, stream: PageStream) -> Optional[Page]:
        """Materialize a stream (a join build side) on the device. The
        reference also reserves it against the memory pool (ROADMAP A6)."""
        return self.merge_counted(list(stream.iter_pages()))

    def _exec_JoinNode(self, node: JoinNode) -> PageStream:
        if node.kind == JoinKind.CROSS and not node.criteria:
            return self._exec_cross_join(node)
        if node.kind == JoinKind.RIGHT:
            return self._exec_right_join(node)
        if node.kind == JoinKind.FULL:
            return self._exec_full_join(node)
        probe_stream = self.execute(node.left)
        build_stream = self.execute(node.right)
        # the reference collects an INNER build through
        # _collect_build_resilient (spill under memory pressure): ROADMAP
        # A7/B9; the rows are the same
        build_page = self._collect(build_stream)
        return self._join_with_build(node, probe_stream,
                                     build_stream.symbols, build_page)

    def _join_with_build(self, node: JoinNode, probe_stream: PageStream,
                         build_symbols, build_page: Optional[Page]
                         ) -> PageStream:
        """INNER or LEFT equi-join over a collected build side: an INNER
        join over a unique build takes the unique path (K5 build, K6
        probe, K1 compaction, K7 attach) with the build's key range as a
        dynamic filter on the probe stream; a build with duplicate keys or
        a LEFT join takes the expanding probe (K5 runs mode, K9, K7)."""
        probe_lay, _ = _layout(probe_stream.symbols)
        build_lay, _ = _layout(build_symbols)
        probe_keys = [probe_lay[c.left.name] for c in node.criteria]
        build_keys = [build_lay[c.right.name] for c in node.criteria]
        # PruneJoinColumns: emit only node.outputs' channels
        out_symbols = node.outputs
        out_names = {s.name for s in out_symbols}
        probe_keep = tuple(i for i, s in enumerate(probe_stream.symbols)
                           if s.name in out_names)
        build_keep = tuple(i for i, s in enumerate(build_symbols)
                           if s.name in out_names)
        join_kind = JoinType.INNER if node.kind == JoinKind.INNER \
            else JoinType.LEFT
        # residual non-equi filter over the joined layout, hoisted like a
        # chain predicate; INNER only (it would drop LEFT's null-extended
        # rows; the planner never asks for it)
        post_pred = None
        post_params = ()
        if node.filter is not None:
            if join_kind != JoinType.INNER:
                raise ExecutionError(
                    "non-inner join with residual filter not supported")
            lay, typ = _layout(out_symbols)
            post_pred, post_params = self._hoist(
                lower_expr(node.filter, lay, typ))
        n_probe_cols = len(probe_keep)

        def unique_ops(mode: str):
            probe_op = cached_kernel(
                ("uprobe", tuple(probe_keys), tuple(build_keys), mode,
                 probe_keep),
                lambda: unique_inner_probe(probe_keys, build_keys,
                                           lookup=mode,
                                           probe_out=probe_keep))

            def build_attach():
                at = attach_build(n_probe_cols, build_out=build_keep)
                fn = None if post_pred is None else filter_step(post_pred)

                def run(pre, prepared, g):
                    out = at(pre, prepared)
                    if fn is not None:
                        out = out.filter(fn(out, g))
                    return out
                return run
            attach_kernel = cached_kernel(
                ("uattach", n_probe_cols, post_pred, build_keep),
                build_attach, params=post_params)
            return probe_op, lambda pre, prepared: attach_kernel(
                pre, prepared, post_params)

        def expanding_ops(mode: str):
            op = cached_kernel(
                ("join", tuple(probe_keys), tuple(build_keys), join_kind,
                 mode, probe_keep, build_keep),
                lambda: hash_join(probe_keys, build_keys, join_kind,
                                  lookup=mode, probe_out=probe_keep,
                                  build_out=build_keep))
            if post_pred is None:
                return op, None
            post = cached_kernel(("join-post", post_pred),
                                 lambda: filter_step(post_pred),
                                 params=post_params)
            return op, lambda out: out.filter(post(out, post_params))

        def gen():
            bp = build_page
            if bp is None:
                if join_kind == JoinType.INNER:
                    return                   # INNER join, empty build
                # LEFT join, empty build: every probe row null-extended
                bp = self._null_build_page(build_symbols)
            if join_kind == JoinType.INNER \
                    and bool(self.session.get("spill_enabled")) and \
                    page_bytes(bp) > int(self.session.get(
                        "join_spill_threshold_bytes")):
                raise ExecutionError(
                    "join build past join_spill_threshold_bytes: the "
                    "spilled join is ROADMAP A7/B9")
            # INNER only: probe codes absent from the build pool become
            # codes that never match, which a LEFT join would emit; LEFT
            # keys across distinct dictionaries stay fail-loud in the probe
            aligned = probe_stream
            if join_kind == JoinType.INNER:
                aligned = self._align_join_dictionaries(
                    probe_stream, bp, probe_keys, build_keys)
            prepared, max_run, mode, n_live = self._prepare_probe(
                build_keys, bp, expanding=join_kind != JoinType.INNER)
            prefilter = None
            if join_kind == JoinType.INNER and \
                    self.session.get("enable_dynamic_filtering") and \
                    not T.is_string(
                        probe_stream.symbols[probe_keys[0]].type):
                # the build's key range filters the probe stream (the
                # first join key bounds any composite)
                bounds_op = cached_kernel(
                    ("dfbounds", build_keys[0]),
                    lambda: build_key_bounds(build_keys))
                pf_op = cached_kernel(
                    ("dfrange", probe_keys[0]),
                    lambda: range_prefilter(probe_keys[0]))
                prefilter = (pf_op, bounds_op(prepared))
            log = self._join_log(join_kind, mode, n_live, max_run)
            probe_in = self._coalesce_stream(aligned, prefilter=prefilter)
            if join_kind == JoinType.INNER and max_run <= 1:
                probe_op, attach_op = unique_ops(mode)
                yield from self._run_unique_inner(probe_in, prepared,
                                                  probe_op, attach_op, log)
                return
            op, post = expanding_ops(mode)
            yield from self._run_expanding(probe_in, prepared, op, log,
                                           post=post)
        return PageStream(gen(), out_symbols)

    def _join_log(self, kind: str, route: str, build_rows: int,
                  max_run: Optional[int]) -> dict:
        """A runner.last_joins entry, filled in as the probe runs: output
        rows are the join's rows before any residual filter; an INNER
        join's also count as `matched`."""
        log = {"kind": kind, "route": route, "build_rows": build_rows,
               "max_run": max_run, "probe_rows": 0, "output_rows": 0}
        if kind == JoinType.INNER:
            log["matched"] = 0
        self.joins.append(log)
        return log

    def _run_expanding(self, probe_stream: PageStream, prepared, op, log,
                       post=None, build_matched=None) -> Iterator[Page]:
        """The expanding probe over a probe stream: per batch of
        _byte_bounded_batches, K9 launch A on every page, ONE host read of
        the exact output totals, then launch B (and the K7 gathers) at
        next_pow2(total), so an output page ends at most 2x its live rows
        and nothing is re-run. FULL joins pass the build_matched mask
        launch B fills."""
        for batch in _byte_bounded_batches(probe_stream.iter_pages(),
                                           1 << 29):
            counted = [op.count(page, prepared) for page in batch]
            fetched = torch.stack(
                [c.total for c in counted]
                + [p.num_rows.to(torch.int64) for p in batch]).tolist()
            k = len(batch)
            for c, total, live in zip(counted, fetched[:k], fetched[k:]):
                log["probe_rows"] += live
                log["output_rows"] += total
                if "matched" in log:
                    log["matched"] += total
                if total == 0:
                    continue
                if total > _I32_ROWS:
                    raise ExecutionError(
                        f"join output of {total} rows from one probe page "
                        "exceeds a page's int32 row count")
                out = op.emit(c, _next_pow2(total), build_matched)
                yield out if post is None else post(out)

    def _exec_right_join(self, node: JoinNode) -> PageStream:
        """RIGHT as a LEFT join with the sides swapped (the engine always
        probes with the preserved side), columns put back in order."""
        flipped = JoinNode(
            JoinKind.LEFT, node.right, node.left,
            tuple(JoinClause(c.right, c.left) for c in node.criteria),
            node.filter, node.distribution)
        stream = self.execute(flipped)
        return _reorder_stream(stream,
                               node.left.outputs + node.right.outputs)

    def _exec_full_join(self, node: JoinNode) -> PageStream:
        """FULL outer: the LEFT-preserving expanding probe over the probe
        pages, marking which build rows matched (K9 launch B), then the
        never-matched live build rows null-extended (K1)."""
        if node.filter is not None:
            raise ExecutionError(
                "non-inner join with residual filter not supported")
        probe_stream = self.execute(node.left)
        build_stream = self.execute(node.right)
        probe_lay, _ = _layout(probe_stream.symbols)
        build_lay, _ = _layout(build_stream.symbols)
        probe_keys = [probe_lay[c.left.name] for c in node.criteria]
        build_keys = [build_lay[c.right.name] for c in node.criteria]
        build_page = self._collect(build_stream)
        out_symbols = node.left.outputs + node.right.outputs
        probe_meta = tuple((s.type, None) for s in node.left.outputs)

        def tracked(pages):
            # the finisher's NULL probe columns keep the dictionaries of
            # the last probe page (concat/union safety downstream)
            nonlocal probe_meta
            for page in pages:
                probe_meta = tuple((c.type, c.dictionary)
                                   for c in page.columns)
                yield page

        def gen():
            bp = build_page
            if bp is None:
                bp = self._null_build_page(build_stream.symbols)
            prepared, max_run, mode, n_live = self._prepare_probe(
                build_keys, bp, expanding=True)
            op = cached_kernel(
                ("fulljoin", tuple(probe_keys), tuple(build_keys), mode),
                lambda: hash_join(probe_keys, build_keys, JoinType.FULL,
                                  lookup=mode))
            matched = torch.zeros(bp.capacity, dtype=torch.bool,
                                  device=bp.device)
            log = self._join_log(JoinType.FULL, mode, n_live, max_run)
            coalesced = self._coalesce_stream(probe_stream)
            yield from self._run_expanding(
                PageStream(tracked(coalesced.iter_pages()),
                           coalesced.symbols),
                prepared, op, log, build_matched=matched)
            rest = unmatched_build_page(probe_meta)(bp, matched)
            n = int(rest.num_rows)
            log["output_rows"] += n
            if n:
                yield self._tight(rest, n)
        return PageStream(gen(), out_symbols)

    def _null_build_page(self, symbols: Sequence[Symbol]) -> Page:
        """An empty side (0 live rows of 8) in the given layout: the build
        of a LEFT/FULL/ANTI join whose build side produced nothing."""
        dev = self.device
        cols = [Column(torch.zeros(8, dtype=s.type.dtype, device=dev),
                       torch.zeros(8, dtype=torch.bool, device=dev),
                       s.type, None) for s in symbols]
        return Page(tuple(cols), row_count(0, dev))

    def _exec_cross_join(self, node: JoinNode) -> PageStream:
        """Cross join: a one-row build (a scalar subquery) is broadcast to
        every probe row; otherwise each probe page expands to its rows x
        the build's rows, bounded at _CROSS_MAX_ROWS. The index
        arithmetic is torch glue; the moves are K7 gathers."""
        probe_stream = self.execute(node.left)
        build_stream = self.execute(node.right)
        build_page = self._collect(build_stream)
        out_symbols = node.left.outputs + node.right.outputs

        def attach(page: Page, build: Page) -> Page:
            one = torch.zeros(page.capacity, dtype=torch.int64,
                              device=page.device)
            bcols = build.gather(one, page.num_rows).columns
            return Page(page.columns + bcols, page.num_rows)

        def gen():
            if build_page is None:
                return
            nb = int(build_page.num_rows)
            log = self._join_log("cross", "cross", nb, None)
            if nb == 1:
                # one row per probe row; the broadcast reads no counts
                log["probe_rows"] = log["output_rows"] = None
                run = cached_kernel(("cross-attach",), lambda: attach)
                for page in probe_stream.iter_pages():
                    yield run(page, build_page)
                return
            for page in probe_stream.iter_pages():
                np_rows = int(page.num_rows)
                log["probe_rows"] += np_rows
                if np_rows == 0:
                    continue
                total = np_rows * nb
                if total > _CROSS_MAX_ROWS:
                    raise ExecutionError(
                        f"cross join too large ({total} rows)")
                log["output_rows"] += total
                idx = torch.arange(_next_pow2(total), dtype=torch.int64,
                                   device=page.device)
                pi = torch.clamp(idx // nb, max=page.capacity - 1)
                bi = torch.clamp(idx % nb, max=build_page.capacity - 1)
                yield Page(page.gather(pi, total).columns
                           + build_page.gather(bi, total).columns, total)
        return PageStream(gen(), out_symbols)

    # ----------------------------------------------------------- semi join

    def _semi_parts(self, semi: SemiJoinNode):
        probe_stream = self.execute(semi.source)
        build_stream = self.execute(semi.filtering_source)
        probe_lay, _ = _layout(probe_stream.symbols)
        build_lay, _ = _layout(build_stream.symbols)
        probe_keys = tuple(probe_lay[s.name] for s in semi.source_keys)
        build_keys = tuple(build_lay[s.name] for s in semi.filtering_keys)
        return (probe_stream, build_stream, probe_keys, build_keys,
                self._collect(build_stream))

    def _exec_semijoin_filter(self, node: FilterNode) -> PageStream:
        """Filter(SemiJoin) with the match flag as a plain conjunct: the
        SEMI (flag) or ANTI (NOT flag) probe, K9's verdict compacted by
        K1, then the other conjuncts. Surviving rows share one match
        value, emitted as a constant column so pages carry the node's
        declared outputs."""
        semi: SemiJoinNode = node.source
        mode, rest = _semijoin_filter_mode(node)
        probe_stream, build_stream, probe_keys, build_keys, build_page = \
            self._semi_parts(semi)
        probe_lay, probe_typ = _layout(probe_stream.symbols)
        jt = JoinType.SEMI if mode == "semi" else JoinType.ANTI
        rest_pred = combine(rest)
        rest_lowered, rest_params = self._hoist(
            None if rest_pred is None else
            lower_expr(rest_pred, probe_lay, probe_typ))

        def gen():
            bp = build_page
            if bp is None:
                if jt == JoinType.SEMI:
                    return
                bp = self._null_build_page(build_stream.symbols)
            prepared, max_run, route, n_live = self._prepare_probe(
                build_keys, bp, expanding=True)
            op = cached_kernel(
                ("semijoin", probe_keys, build_keys, jt, semi.null_aware,
                 route),
                lambda: hash_join(probe_keys, build_keys, jt,
                                  null_aware=semi.null_aware, lookup=route))
            post = None
            if rest_lowered is not None:
                post = cached_kernel(("semijoin-rest", rest_lowered),
                                     lambda: filter_step(rest_lowered),
                                     params=rest_params)
            log = self._join_log(jt, route, n_live, max_run)

            def verdict(page):
                out = op.verdict(page, prepared)
                return out if post is None else out.filter(
                    post(out, rest_params))
            for out in self._run_verdict(probe_stream, verdict, log):
                flag = torch.full((out.capacity,), mode == "semi",
                                  dtype=torch.bool, device=out.device)
                yield out.append_column(Column(flag, None, T.BOOLEAN, None))
        return PageStream(gen(),
                          semi.source.outputs + (semi.match_symbol,))

    def _exec_SemiJoinNode(self, node: SemiJoinNode) -> PageStream:
        """A semi join whose match flag escapes a plain Filter conjunct:
        probe rows plus the MARK channel (HashSemiJoinOperator)."""
        probe_stream, build_stream, probe_keys, build_keys, build_page = \
            self._semi_parts(node)
        out_symbols = node.source.outputs + (node.match_symbol,)

        def gen():
            if build_page is None:
                # nothing to match: the flag is FALSE on every row
                for page in probe_stream.iter_pages():
                    flag = torch.zeros(page.capacity, dtype=torch.bool,
                                       device=page.device)
                    yield page.append_column(
                        Column(flag, None, T.BOOLEAN, None))
                return
            prepared, max_run, route, n_live = self._prepare_probe(
                build_keys, build_page, expanding=True)
            op = cached_kernel(
                ("markjoin", probe_keys, build_keys, node.null_aware, route),
                lambda: hash_join(probe_keys, build_keys, JoinType.MARK,
                                  null_aware=node.null_aware, lookup=route))
            log = self._join_log(JoinType.MARK, route, n_live, max_run)
            yield from self._run_verdict(
                probe_stream, lambda page: op.verdict(page, prepared), log)
        return PageStream(gen(), out_symbols)

    def _run_verdict(self, probe_stream: PageStream, verdict, log
                     ) -> Iterator[Page]:
        """SEMI/ANTI/MARK over the coalesced probe stream: the verdict op
        per page, ONE host read of the output rows per batch, each output
        shrunk to at most 2x its live rows."""
        pages = self._coalesce_stream(probe_stream).iter_pages()
        for batch in _byte_bounded_batches(pages, 1 << 29):
            outs = [verdict(page) for page in batch]
            fetched = torch.stack([o.num_rows for o in outs]
                                  + [p.num_rows for p in batch]).tolist()
            k = len(batch)
            for out, n, live in zip(outs, fetched[:k], fetched[k:]):
                log["probe_rows"] += live
                log["output_rows"] += n
                if n:
                    yield self._tight(out, n)

    # ---------------------------------------------------- scalar subqueries

    def _exec_AssignUniqueIdNode(self, node) -> PageStream:
        """AssignUniqueIdOperator: tag rows with a unique BIGINT id, the
        page's capacity offset plus the row's position. Padding rows take
        ids too, so no count is read, and since the pages of a subtree
        come out with the same capacities in the same order every time,
        executing the subtree twice (a decorrelated EXISTS) gives the
        same ids."""
        src = self.execute(node.source)

        def build():
            def tag(page: Page, offset: int) -> Page:
                ids = torch.arange(page.capacity, dtype=torch.int64,
                                   device=page.device) + offset
                return page.append_column(Column(ids, None, T.BIGINT, None))
            return tag
        tag = cached_kernel(("assign-unique-id",), build)

        def gen():
            offset = 0
            for page in src.iter_pages():
                yield tag(page, offset)
                offset += page.capacity
        return PageStream(gen(), node.source.outputs + (node.id_symbol,))

    def _exec_EnforceSingleRowNode(self, node) -> PageStream:
        """A scalar subquery's rows: none becomes one all-NULL row, more
        than one raises (EnforceSingleRowOperator)."""
        src = self.execute(node.source)

        def gen():
            page = self._collect(src)
            if page is None:
                yield Page(self._null_build_page(node.outputs).columns,
                           row_count(1, self.device))
                return
            if int(page.num_rows) > 1:
                raise ExecutionError(
                    "Scalar sub-query has returned multiple rows")
            yield page
        return PageStream(gen(), node.outputs)

    def _coalesce_stream(self, stream: PageStream,
                         prefilter=None) -> PageStream:
        """Batch filtered pages into few large probe buffers
        (`probe_coalesce_rows`), with one batched count fetch per window of
        _WINDOW_PAGES pages. `prefilter` is the dynamic filter (op, args),
        applied per page before buffering and dropped for the rest of the
        stream when the first window keeps more than 75% of its rows."""
        target_rows = int(self.session.get("probe_coalesce_rows"))
        row_bytes = 8 * max(len(stream.symbols), 1)
        target_rows = max(1 << 16, min(target_rows, (1 << 29) // row_bytes))

        def counts_of(pages):
            return torch.stack([p.num_rows for p in pages]).tolist()

        def gen():
            it = stream.iter_pages()
            buf: List[Page] = []
            buf_rows = 0
            use_df = prefilter is not None
            df_measured = False
            while True:
                window = list(itertools.islice(it, _WINDOW_PAGES))
                if not window:
                    break
                if use_df:
                    pf_op, pf_args = prefilter
                    filtered = [pf_op(p, *pf_args) for p in window]
                    if not df_measured:
                        both = counts_of(window + filtered)
                        pre, post = both[:len(window)], both[len(window):]
                        df_measured = True
                        if sum(post) > 0.75 * max(sum(pre), 1):
                            use_df = False   # not selective enough
                        counts = post
                    else:
                        counts = counts_of(filtered)
                    window = filtered
                else:
                    counts = counts_of(window)
                for p, n in zip(window, counts):
                    if n == 0:
                        continue
                    if n >= target_rows:
                        yield self._merge_buf([p], n)
                        continue
                    buf.append(self._tight(p, n))
                    buf_rows += n
                    if buf_rows >= target_rows:
                        yield self._merge_buf(buf, buf_rows)
                        buf, buf_rows = [], 0
            if buf:
                yield self._merge_buf(buf, buf_rows)
        return PageStream(gen(), stream.symbols)

    def _compact_probe(self, pre: Page, found, total: int,
                       live: int) -> Page:
        """A probe result compacted to its matched rows (K1), skipped when
        every live row matched."""
        if total == live:
            return pre
        op = cached_kernel(("probe-compact",),
                           lambda: lambda p, f: p.filter(f))
        return op(pre, found)

    def _run_unique_inner(self, probe_stream: PageStream, prepared,
                          probe_op, attach_op, log: dict) -> Iterator[Page]:
        """The unique-build INNER path: the probe (K6) per buffer, ONE
        count fetch per batch, compaction of partly matched buffers only,
        a shrink to live size, then the build attach (K7) at match count.
        Output rows never exceed probe rows, so there is no overflow
        re-run."""
        for batch in _byte_bounded_batches(probe_stream.iter_pages(),
                                           1 << 29):
            results = [probe_op(page, prepared) for page in batch]
            fetched = torch.stack(
                [t for _, _, t in results]
                + [pre.num_rows.to(torch.int64) for pre, _, _ in results]
            ).tolist()
            k = len(results)
            for (pre, found, _), total, live in zip(results, fetched[:k],
                                                    fetched[k:]):
                log["probe_rows"] += live
                log["output_rows"] += total
                log["matched"] += total
                if total == 0:
                    continue
                out = self._compact_probe(pre, found, total, live)
                yield attach_op(self._tight(out, total), prepared)

    def _align_join_dictionaries(self, probe_stream: PageStream,
                                 build_page: Page, probe_keys,
                                 build_keys) -> PageStream:
        """String join keys across DISTINCT dictionaries: remap probe key
        codes onto the build side's pool (the kernels compare codes)."""
        return self._align_probe_to_pools(
            probe_stream,
            {pk: build_page.columns[bk].dictionary
             for pk, bk in zip(probe_keys, build_keys)
             if build_page.columns[bk].dictionary is not None})

    def _align_probe_to_pools(self, probe_stream: PageStream, pools
                              ) -> PageStream:
        """Re-encode probe key channels onto given build-side pools
        ({probe_channel: build Dictionary}). Probe values absent from the
        build pool map to distinct codes past the pool's end, so they never
        match (INNER only). Each (probe pool, channel) builds its code map
        once, on the host; the remap is a K7 gather."""
        pools = {pk: bd for pk, bd in pools.items() if bd is not None}
        if not pools:
            return probe_stream
        maps: Dict[tuple, torch.Tensor] = {}

        def gen():
            for page in probe_stream.iter_pages():
                cols = list(page.columns)
                changed = False
                for pk, bd in pools.items():
                    pc = cols[pk]
                    if pc.dictionary is None or pc.dictionary is bd:
                        continue
                    key = (id(pc.dictionary), pk)
                    tbl = maps.get(key)
                    if tbl is None:
                        pvals = pc.dictionary.values
                        n_b = len(bd.values)
                        if n_b:
                            codes = np.minimum(
                                np.searchsorted(bd.values, pvals),
                                n_b - 1).astype(np.int64)
                            present = bd.values[codes] == pvals
                        else:
                            codes = np.zeros(len(pvals), np.int64)
                            present = np.zeros(len(pvals), bool)
                        out = np.where(
                            present, codes,
                            n_b + np.arange(len(pvals), dtype=np.int64))
                        if not len(out):    # an empty probe pool
                            out = np.array([n_b], dtype=np.int64)
                        tbl = maps[key] = _to_device(
                            out.astype(np.int32), page.device)
                    values, = gather_rows([tbl], pc.values)
                    cols[pk] = Column(values, pc.valid, pc.type, bd)
                    changed = True
                yield Page(tuple(cols), page.num_rows) if changed else page
        return PageStream(gen(), probe_stream.symbols)

    def _prepare_build(self, build_keys, build_page: Page):
        """K5 once per join: statistics and the hash table."""
        prep = cached_kernel(("join-prep", tuple(build_keys)),
                             lambda: prepare_build(build_keys))
        return prep(build_page)

    # direct-address tables: pow2 sizes; the slot cap bounds device memory
    # (64M slots = 256 MB of int32)
    _DENSE_MAX_SLOTS = 1 << 26

    def _dense_size(self, build_page: Page, span: int) -> int:
        """The dense route's table size when the live key span fits the
        direct-address limit, else 0 (the `search` route)."""
        limit = min(max(4 * build_page.capacity, 1 << 20),
                    self._DENSE_MAX_SLOTS)
        return _next_pow2(span) if 0 < span <= limit else 0

    def _prepare_probe(self, build_keys, build_page: Page,
                       expanding: bool = False):
        """K5 plus the per-join route: ONE host read of (live rows,
        max_run, kmin, kmax), then `dense` when the unsigned key span fits
        the direct-address limit, else `search` (the hash table). A build
        with duplicate keys, or any `expanding` join kind, also gets K5's
        runs mode (whose dense table holds slots, not rows). Returns
        (prepared, max_run, route, build live rows)."""
        prepared = self._prepare_build(build_keys, build_page)
        got = prepared.stats[:KMAX + 1].tolist()
        max_run, n_live = got[MAX_RUN], got[N_LIVE]
        kmin, kmax = unsigned(got[KMIN]), unsigned(got[KMAX])
        span = kmax - kmin + 1 if kmax >= kmin else 0
        size = self._dense_size(build_page, span)
        if expanding or max_run > 1:
            prepared = cached_kernel(("join-runs", size),
                                     lambda: prepare_runs(size))(prepared)
        elif size:
            prepared = cached_kernel(("dense-table", size),
                                     lambda: build_dense_table(size))(
                                         prepared)
        return prepared, max_run, "dense" if size else "search", n_live

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


def _byte_bounded_batches(it: Iterator[Page], budget_bytes: int
                          ) -> Iterator[List[Page]]:
    """Lookahead batches bounded by bytes (and at most _WINDOW_PAGES
    pages): one count fetch per batch without pinning unbounded
    intermediates."""
    batch: List[Page] = []
    used = 0
    for page in it:
        nbytes = page_bytes(page)
        if batch and (used + nbytes > budget_bytes
                      or len(batch) >= _WINDOW_PAGES):
            yield batch
            batch, used = [], 0
        batch.append(page)
        used += nbytes
    if batch:
        yield batch


# rows a page can count (num_rows is int32)
_I32_ROWS = (1 << 31) - 1


def _semijoin_filter_mode(node: FilterNode):
    """('semi' | 'anti', the other conjuncts) when the filter over a
    SemiJoin uses its match flag only as a plain top-level conjunct (or its
    NOT); None sends the SemiJoin down the MARK path."""
    match_name = node.source.match_symbol.name
    mode: Optional[str] = None
    rest: List[RowExpression] = []
    for c in conjuncts(node.predicate):
        if isinstance(c, SymbolRef) and c.name == match_name:
            mode = "semi"
        elif isinstance(c, SpecialForm) and c.kind is SpecialKind.NOT \
                and isinstance(c.args[0], SymbolRef) \
                and c.args[0].name == match_name:
            mode = "anti"
        elif match_name in _symbol_names(c):
            return None
        else:
            rest.append(c)
    if mode is None:
        return None
    return mode, rest


def _symbol_names(e: RowExpression) -> set:
    out = set()

    def visit(x):
        if isinstance(x, SymbolRef):
            out.add(x.name)
        for c in x.children():
            visit(c)
    visit(e)
    return out


def _valid_arr(valid: List[bool], cap: int, device
               ) -> Optional[torch.Tensor]:
    if all(valid):
        return None
    arr = np.zeros(cap, dtype=bool)
    arr[:len(valid)] = valid
    return _to_device(arr, device)
