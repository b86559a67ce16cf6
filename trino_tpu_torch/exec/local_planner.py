"""Local execution: lower a logical plan to streaming page pipelines.

Port of `trino_tpu/exec/local_planner.py`, the subset every TPC-H query
runs: TableScan, Values, Filter, Project, Limit, Offset, Aggregation
(partial per page, a device-side buffer merge, final; DISTINCT collected
and run in one SINGLE step), joins of every kind (INNER over a unique
build side, the expanding probe for duplicate build keys, LEFT, RIGHT as
a flipped LEFT, FULL, cross joins), semi joins (SEMI/ANTI fused into a
Filter, MARK otherwise), AssignUniqueId, EnforceSingleRow, Sort, TopN,
Window (ops/window.py: K20-K23 after K10's sort), GroupId (ROLLUP, CUBE,
GROUPING SETS), Union and Output. A node executes to an iterator of
fixed-capacity Pages plus a symbol layout; streaming operators
(filter/project/select) queue entries on the stream, and the consumer runs
the composed chain per page, fused with a blocking consumer's tail (the
partial aggregation).

The per-page loop never reads a row count on the host: count fetches are
batched at the merge boundary (merge_counted_rows), per probe window
(_coalesce_stream), once per join build (_prepare_probe: max_run, the key
span, live rows) and once per probe batch (the join's output totals).

The join router takes the reference's three routes on the reference's
gates: `mxu` (ops/join_mxu.py: K12's per-key (count, first) table, probed
by K13) for a single-key INNER, SEMI/ANTI or MARK join whose build key
span fits `mxu_join_max_slots` densely enough, else `dense` (a direct-
address table) for a span under the dense limit, else `search` (K5's hash
table); `mxu_joins` and `mxu_flops` count what ran (runner.
last_query_stats).

Memory-bounded execution, as the reference runs it under its default
session (spill on): every blocking collect reserves its bytes against the
query's `query_max_memory` ledger (exec/memory.py). An INNER build collects
with incremental reservation (`_collect_build_resilient`), and pressure
mid-collect streams the build into the partitioned join. A build past
`join_spill_threshold_bytes` takes the spilled join (`spill-dense` or
`spill-search`: K16's sorted keys or K5's row table on the device, the
payload on the host, K17's probe, the host attach) or, for duplicate,
string or skewed keys, the recursive hybrid partitioned join
(`partitioned`: K18 partitions both sides to host stores, each
co-partition joins in memory on the `dense`/`search` routes, over-budget
partitions repartition under a fresh salt, split out heavy keys, or fall
back to chunked builds). The aggregation compacts a partial buffer past
`agg_spill_threshold_bytes`, spills groups that do not collapse to host
hash partitions and walks the adaptive modes (full, shrunken, bypass:
K19's per-row states); the sort spills range partitions of its leading
key. The low-memory killer, the memory-pressure re-run, fault injection
and cancellation are ROADMAP A.6 (`_fault_site` and `_checkpoint` are
their hooks).

The aggregating join (`_mxu_agg_join`, ops/join_mxu.py K24-K27): a SINGLE
COUNT/SUM aggregation (or a DISTINCT projection) directly over a single-
clause INNER join with probe-side group keys is fused under
mxu_join_enabled, as the reference's default path does: the build scatters
to per-key vectors, each probe row reads its key's vector, one SINGLE
aggregation runs over the probe-sized derived rows (route `mxu-agg`); a
sparse, over-span, magnitude-unsafe or over-threshold build takes the
gather join and the normal aggregation.

Every other node raises an ExecutionError naming the ROADMAP item that
ports it.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.errors import GENERIC_INTERNAL_ERROR, TrinoError
from trino_tpu_torch.exec.adaptive import AdaptiveQueryState, AggMode
from trino_tpu_torch.exec.jit_cache import cached_kernel
from trino_tpu_torch.exec.memory import (NODE_POOL, ClusterOutOfMemoryError,
                                         ExceededMemoryLimitError,
                                         QueryMemoryContext, page_bytes)
from trino_tpu_torch.exec.spill import (SPILL_LEDGER, HostPartitionStore,
                                        detect_partition_heavy_keys,
                                        leading_rank, partition_by_hash,
                                        partition_by_range,
                                        partition_key_hashes, rank_bounds,
                                        refuse_lists, resolve_spill_limit,
                                        split_partition)
from trino_tpu_torch.expr.kernel_gen import filter_step, project_step
from trino_tpu_torch.expr.ir import (Call, InputRef, Literal, RowExpression,
                                     SpecialForm, SpecialKind, SymbolRef)
from trino_tpu_torch.metadata import Metadata, Session
from trino_tpu_torch.ops import (AggSpec, SortKey, Step, hash_aggregate,
                                 order_by, top_n_masked)
from trino_tpu_torch.ops import lists
from trino_tpu_torch.ops.aggregate import (COLLECT_AGGREGATES,
                                             SINGLE_STEP_AGGREGATES,
                                             passthrough_partial)
from trino_tpu_torch.ops.join import (
    KMAX, KMIN, MAX_RUN, N_LIVE, N_ROWS, NDISTINCT, SPILL_DENSE_MAX_SPAN,
    SPILL_UNIQUE, JoinType, attach_build, attach_build_host,
    build_dense_table, build_dense_table_rows, build_key_bounds, hash_join,
    prepare_build, prepare_build_spilled, prepare_runs, range_prefilter,
    spilled_dense_probe, spilled_unique_probe, typed_bounds,
    unique_inner_probe, unmatched_build_page, unsigned)
from trino_tpu_torch.ops.join_mxu import (
    B_HI, B_KMAX, B_KMIN, B_LO, INFO_LIVE, MAX_EXACT_ROWS, agg_join_lookup,
    agg_join_post, build_count_pos_table, key_bounds, lookup_flops,
    scatter_agg_table)
from trino_tpu_torch.ops.window import AGGREGATE, RANKING, WindowSpec, \
    frame_kind, window
from trino_tpu_torch.page import Column, Dictionary, Page, _to_device, \
    device_concat, gather_rows, row_count, union_dictionaries
from trino_tpu_torch.planner.nodes import (
    AggregationNode, AggStep, FilterNode, GroupIdNode, JoinClause, JoinKind,
    JoinNode, LimitNode, OffsetNode, OutputNode, PlanNode, ProjectNode,
    SemiJoinNode, SortNode, Symbol, TableScanNode, TopNNode, UnionNode,
    ValuesNode, WindowNode)
from trino_tpu_torch.planner.optimizer import combine, conjuncts

# pages looked ahead per batched count fetch (the reference's window)
_WINDOW_PAGES = 8

# plan nodes of the reference this slice does not run yet -> ROADMAP item
_LATER = {
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


# runner.last_query_stats keys (the reference's QueryStatsCollector names)
QUERY_COUNTERS = ("mxu_joins", "mxu_flops", "spilled_bytes",
                  "agg_recursions", "join_recursions", "heavy_key_splits",
                  "spill_fallbacks", "agg_mode_downgrades",
                  "agg_mode_upgrades", "exchanges_fused", "exchanges_staged",
                  "exchange_rows", "exchange_bytes", "mesh_devices")


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


class WindowLog(list):
    """One dict per WindowNode run (runner.last_windows): input rows,
    partitions, peer groups, functions by kind, frames by kind. The three
    counts stay on the device while the query runs and come over in one
    read when the log is first read (`entries`)."""

    def __init__(self):
        super().__init__()
        self.pending: List[Tuple[dict, torch.Tensor]] = []

    def entries(self) -> "WindowLog":
        if self.pending:
            pending, self.pending = self.pending, []
            counts = torch.stack([c for _, c in pending]).tolist()
            for (entry, _), (rows, parts, peers) in zip(pending, counts):
                entry.update(rows=rows, partitions=parts, peer_groups=peers)
        return self


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
        # one entry per WindowNode run (runner.last_windows)
        self.windows = WindowLog()
        # one entry per list step (runner.last_lists): a collecting
        # aggregation's groups, L and output rows, an UNNEST page's slots
        self.lists: List[dict] = []
        # the query's counters (runner.last_query_stats), under the
        # reference's names: joins routed onto the mxu lookup and their
        # probe pages' cost-model flops; bytes flushed to host spill
        # partitions; the adaptive and recursive-spill events
        self.stats = dict.fromkeys(QUERY_COUNTERS, 0)
        # the query's reservation ledger under query_max_memory, mirrored
        # into the process node pool (closed by the runner)
        self.memory = QueryMemoryContext(
            int(session.get("query_max_memory")), pool=NODE_POOL)
        # adaptive strategy state shared by the query's operators
        self.adaptive = AdaptiveQueryState()

    # ----------------------------------------------- spill and memory

    def _checkpoint(self) -> None:
        """Cooperative checkpoint at a page-batch boundary: a query marked
        by the memory pool stops here (deadlines and cancellation are
        ROADMAP A.6)."""
        self.memory.poll()

    def _fault_site(self, site: str, detail: str = "") -> None:
        """Fault-injection site; chaos testing is ROADMAP A.6."""

    def _record_spill(self, nbytes: int) -> None:
        """Bytes flushed to host partitions (QueryStats.spilledDataSize)."""
        self.stats["spilled_bytes"] += int(nbytes)

    def _new_spill_store(self, npart: int) -> HostPartitionStore:
        """A HostPartitionStore charged against the process SpillLedger
        under this query's `spill_max_bytes` budget; restages go to this
        executor's device."""
        return HostPartitionStore(
            npart, ledger=SPILL_LEDGER, query_id=self.memory.query_id,
            limit=resolve_spill_limit(self.session), device=self.device)

    def _adaptive_event(self, name: str, n: int = 1) -> None:
        """Count one adaptive strategy event (agg_mode_downgrades,
        join_recursions, heavy_key_splits, spill_fallbacks, ...)."""
        self.stats[name] += n

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
        fused = self._mxu_agg_join(node)
        if fused is not None:
            return fused
        return self._agg_over_stream(node, self.execute(node.source))

    def _agg_over_stream(self, node: AggregationNode,
                         src: PageStream) -> PageStream:
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
        if any(spec.distinct or spec.name in SINGLE_STEP_AGGREGATES
               for spec in specs):
            # distinctness, and the special aggregates' state (centered
            # moments, a row pick, registers, a rank, a list), belong to a
            # whole group, not a page: collect and run one SINGLE-step
            # aggregation (the reference's MarkDistinct + aggregation in
            # one kernel call; a collecting aggregate sizes its lists
            # there, with K33's size mode)
            has_lists = any(spec.name in COLLECT_AGGREGATES
                            for spec in specs)

            def gen_distinct():
                page = self._collect(src)
                if page is None:
                    if not key_channels:
                        yield self._empty_global_agg(node)
                    return
                single_op = cached_kernel(
                    ("agg-single", key_channels_t, specs_t),
                    lambda: hash_aggregate(key_channels, specs,
                                           Step.SINGLE))
                try:
                    out = single_op(page)
                    if has_lists:
                        # groups stays a device count: reading it here
                        # would wait for the lists
                        planes = [c for c in out.columns if c.is_list]
                        self.lists.append({
                            "step": "collect", "groups": out.num_rows,
                            "L": planes[0].values.shape[1],
                            "rows": out.capacity,
                            "plane_bytes": sum(c.nbytes for c in planes)})
                    yield out
                finally:
                    self._free_collected(page)
            return PageStream(gen_distinct(), node.outputs)
        # scan -> filter -> project -> partial agg as ONE composed call
        partial_op = compose_chain(
            src.pending, ("agg-partial", key_channels_t, specs_t),
            lambda: hash_aggregate(key_channels, specs, Step.PARTIAL))
        # the adaptive bypass: the same chain ending in one PARTIAL-layout
        # state row per input row (K19), no grouping
        bypass_op = compose_chain(
            src.pending, ("agg-bypass", key_channels_t, specs_t),
            lambda: passthrough_partial(key_channels, specs))
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
        intermediate_op = cached_kernel(
            ("agg-intermediate", nkeys, specs_t),
            lambda: hash_aggregate(final_keys, specs, Step.INTERMEDIATE,
                                   state_channels))
        threshold = int(self.session.get("agg_spill_threshold_bytes"))
        npart = int(self.session.get("spill_partition_count"))
        spillable = bool(self.session.get("spill_enabled")) \
            and bool(key_channels)

        def part_op_for(salt: int):
            return cached_kernel(
                ("agg-spill-part", nkeys, npart, salt),
                lambda: partition_by_hash(final_keys, npart, salt=salt))

        def gen():
            # No per-page count read: empty pages give neutral partial
            # states. A buffer past the threshold compacts (INTERMEDIATE);
            # groups that do not collapse spill to host hash partitions,
            # finalized one bounded partition at a time. The controller
            # walks full -> shrunken -> bypass on the observed reduction
            # ratio at each compaction, and back up when it recovers.
            ctl = None
            # adaptive modes only where spill can absorb them
            if bool(self.session.get("adaptive_partial_agg")) and spillable:
                ctl = self.adaptive.agg_controller(
                    ("agg", tuple(s.name for s in node.group_by),
                     tuple(s.name for s, _ in node.aggregations)),
                    ndv=node.ndv_estimate, rows=node.rows_estimate,
                    allow_bypass=spillable)
            store = None
            buf: List[Page] = []
            buf_bytes = 0
            any_pages = False
            # the ratio's denominator is RAW input rows in every mode:
            # page counts are read in one batch at the compaction, and a
            # re-buffered compacted page carries its history forward
            raw_counts: List[torch.Tensor] = []
            raw_carry = 0

            def compact_buffer():
                nonlocal buf, buf_bytes
                merged, rows_in = self.merge_counted_rows(buf)
                buf, buf_bytes = [], 0
                if merged is None:
                    return None, rows_in, 0
                out = intermediate_op(merged)
                n = int(out.num_rows)
                if n == 0:
                    return None, rows_in, 0
                return self._tight(out, n), rows_in, n

            def raw_rows_in():
                nonlocal raw_counts, raw_carry
                total = raw_carry
                if raw_counts:
                    total += sum(torch.stack(raw_counts).tolist())
                raw_counts = []
                return total

            def observe(rows_in, groups_out):
                if ctl is None or rows_in <= 0:
                    return
                transition = ctl.observe(rows_in, groups_out)
                if transition is not None:
                    self._adaptive_event(
                        "agg_mode_downgrades" if transition == "downgrade"
                        else "agg_mode_upgrades")

            def spill(combined):
                nonlocal store
                self._fault_site("spill", "agg")
                self._record_spill(page_bytes(combined))
                if store is None:
                    store = self._new_spill_store(npart)
                sorted_pg, counts = part_op_for(0)(combined)
                store.spill_partitioned(sorted_pg, counts.tolist())

            try:
                for page in src.pages:
                    self._checkpoint()
                    any_pages = True
                    mode = ctl.mode if ctl is not None else AggMode.FULL
                    pp = partial_op(page) if mode == AggMode.FULL \
                        else bypass_op(page)
                    buf.append(pp)
                    raw_counts.append(page.num_rows)
                    buf_bytes += page_bytes(pp)
                    if not (spillable and buf_bytes >= threshold):
                        continue
                    if mode == AggMode.BYPASS:
                        probe = ctl.should_probe()
                        ctl.note_flush()
                        if not probe:
                            # full bypass: per-row states straight to host
                            # partitions; the finalize groups them once
                            merged, _ = self.merge_counted_rows(buf)
                            buf, buf_bytes = [], 0
                            raw_counts, raw_carry = [], 0
                            if merged is not None:
                                spill(merged)
                            continue
                    elif ctl is not None:
                        ctl.note_flush()
                    rows_raw = raw_rows_in()
                    combined, _, groups_out = compact_buffer()
                    observe(rows_raw, groups_out)
                    if combined is None:
                        raw_carry = 0
                        continue
                    cb = page_bytes(combined)
                    if cb >= threshold // 2:
                        spill(combined)        # groups are not collapsing
                        raw_carry = 0
                    else:
                        buf, buf_bytes = [combined], cb
                        raw_carry = rows_raw   # history rides along

                if store is None:
                    if not any_pages:
                        if not key_channels:
                            yield self._empty_global_agg(node)
                        return
                    merged, _ = self.merge_counted_rows(buf)
                    if merged is None:
                        # every partial empty (grouped agg -> no output; a
                        # global agg's partials always carry a row)
                        if not key_channels:
                            yield self._empty_global_agg(node)
                        return
                    yield final_op(merged)
                    return
                rows_raw = raw_rows_in()
                combined, _, groups_out = compact_buffer()
                observe(rows_raw, groups_out)
                if combined is not None:
                    spill(combined)
                yield from self._finalize_agg_spill(
                    store, 0, final_op, intermediate_op, part_op_for,
                    final_keys, threshold)
            finally:
                if store is not None:
                    store.close()
        return PageStream(gen(), node.outputs)

    def _finalize_agg_spill(self, store, depth: int, final_op,
                            intermediate_op, part_op_for, key_idxs,
                            threshold: int) -> Iterator[Page]:
        """Finalize spilled hash partitions (the robust dynamic hybrid
        discipline): a partition within budget restages and finalizes in
        one call; one still over budget first splits out heavy keys
        (re-hashing never separates one key's rows: they fold chunk-wise,
        INTERMEDIATE collapsing a heavy key to one state row per chunk),
        then repartitions under a fresh hash salt up to
        `spill_max_recursion`, and at the maximum depth falls back to the
        bounded chunked fold."""
        threshold = self._spill_budget(threshold)
        max_rec = int(self.session.get("spill_max_recursion"))
        heavy_limit = int(self.session.get("spill_heavy_key_limit"))
        npart = store.npart

        def stage_final(p: int, nrows: int) -> Iterator[Page]:
            pg = store.restage(p, _next_pow2(max(nrows, 1)))
            store.drop(p)
            held = page_bytes(pg)
            self.memory.reserve(held, "agg-restage")
            try:
                yield final_op(pg)
            finally:
                self.memory.free(held, "agg-restage")

        for p in range(npart):
            self._checkpoint()
            nrows = store.partition_rows(p)
            if nrows == 0:
                continue
            if store.partition_bytes(p) <= max(threshold, 1):
                yield from stage_final(p, nrows)
                continue
            chunk_rows = store.chunk_rows_for(p, threshold)
            if heavy_limit > 0 and depth < max_rec and npart > 1:
                hashes = partition_key_hashes(store, p, key_idxs)
                heavy = detect_partition_heavy_keys(
                    store, p, key_idxs, heavy_limit,
                    max(2, nrows // (2 * max(npart, 2))),
                    piece_hashes=hashes)
                if len(heavy):
                    self._fault_site("spill", "agg-heavy")
                    self._adaptive_event("heavy_key_splits")
                    sub = split_partition(store, p, key_idxs, heavy,
                                          piece_hashes=hashes)
                    try:
                        yield from self._agg_chunk_fold(
                            sub, 0, final_op, intermediate_op, chunk_rows)
                    finally:
                        sub.close()
                    nrows = store.partition_rows(p)
                    if nrows == 0:
                        continue
                    if store.partition_bytes(p) <= max(threshold, 1):
                        yield from stage_final(p, nrows)
                        continue
            if depth >= max_rec or npart <= 1:
                # bounded depth: an irreducible partition folds in bounded
                # chunks instead of recursing forever
                self._fault_site("spill", "agg-fallback")
                self._adaptive_event("spill_fallbacks")
                yield from self._agg_chunk_fold(
                    store, p, final_op, intermediate_op, chunk_rows)
                continue
            # repartition under a fresh salt: the keys redistribute
            self._fault_site("spill", "agg-recurse")
            self._adaptive_event("agg_recursions")
            child = self._new_spill_store(npart)
            try:
                op = part_op_for(depth + 1)
                # drain: each piece releases before the child charges the
                # next, so the partition is never held twice
                for chunk in store.drain_partition_chunks(p, chunk_rows):
                    self._checkpoint()
                    sorted_pg, counts = op(chunk)
                    child.spill_partitioned(sorted_pg, counts.tolist())
                store.drop(p)
                yield from self._finalize_agg_spill(
                    child, depth + 1, final_op, intermediate_op,
                    part_op_for, key_idxs, threshold)
            finally:
                child.close()

    def _agg_chunk_fold(self, store, p: int, final_op, intermediate_op,
                        chunk_rows: int) -> Iterator[Page]:
        """Bounded chunked merge of one partition: restage at most
        chunk_rows at a time, INTERMEDIATE-fold into the carried state
        (K2 appends the chunk), finalize once. The heavy-key path and the
        maximum-depth fallback both end here."""
        state = None
        for chunk in store.drain_partition_chunks(p, chunk_rows):
            self._checkpoint()
            merged = chunk if state is None \
                else device_concat([state, chunk])
            out = intermediate_op(merged)
            n = int(out.num_rows)
            state = self._tight(out, n) if n else None
        store.drop(p)
        if state is not None:
            yield final_op(state)

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

    # ------------------------------------------- the aggregating join

    # aggregate functions the fused join factors through per-key build
    # vectors (arXiv 2206.04995's M = A·Bᵀ multiplicities)
    _MXU_FUSABLE_AGGS = ("count", "sum")

    def _mxu_agg_join(self, node: AggregationNode) -> Optional[PageStream]:
        """The many-to-many AGGREGATING join (ops/join_mxu.py K24-K27):
        when a SINGLE aggregation consumes an INNER single-clause equi-join
        directly (optionally through a pure column-select projection),
        every group key is probe-side, and every aggregate is a factorable
        COUNT/SUM over one side's column, the join's match multiplicities
        feed SUM/COUNT directly without materializing the cross product:
        the build side scatters to per-key [pair count, sum of w, #valid w]
        vectors, each probe row looks up its key's vector, and one standard
        SINGLE aggregation over the derived (probe-sized) rows gives the
        exact result. DISTINCT projections over a join (group-by, no
        aggregates) take the same path. Returns None when the plan shape is
        ineligible; what declines at run time (sparse or over-span keys,
        an unsafe magnitude, an over-threshold build) takes the gather
        join and the normal aggregation over its output."""
        if node.step != AggStep.SINGLE:
            return None
        if not bool(self.session.get("mxu_join_enabled")):
            return None
        source = node.source
        proj = None
        if isinstance(source, ProjectNode) and all(
                isinstance(e, SymbolRef) for _, e in source.assignments):
            proj = source
            source = source.source
        if not isinstance(source, JoinNode):
            return None
        join = source
        if join.kind != JoinKind.INNER or len(join.criteria) != 1 \
                or join.filter is not None:
            return None
        pmap = {s.name: i for i, s in enumerate(join.left.outputs)}
        bmap = {s.name: i for i, s in enumerate(join.right.outputs)}
        rename = None if proj is None else \
            {s.name: e.name for s, e in proj.assignments}

        def resolve(name):
            if rename is not None:
                name = rename.get(name)
                if name is None:
                    return None
            if name in pmap:
                return ("p", pmap[name])
            if name in bmap:
                return ("b", bmap[name])
            return None

        group_chs = []
        for s in node.group_by:
            r = resolve(s.name)
            if r is None or r[0] != "p":
                return None     # group keys must be probe-side
            group_chs.append(r[1])
        ptypes = [s.type for s in join.left.outputs]
        btypes = [s.type for s in join.right.outputs]

        def num_kind(t):
            try:
                dt = np.dtype(T.to_numpy_dtype(t))
            except Exception:
                return None
            if dt.kind in ("i", "u"):
                return "i"
            if dt.kind == "f" and dt.itemsize == 8:
                return "f"
            return None

        vec_specs = [("cnt",)]

        def vec(spec):
            if spec not in vec_specs:
                vec_specs.append(spec)
            return vec_specs.index(spec)

        derive: List[tuple] = []
        helpers: List[int] = []
        out_types: List = []
        for out_sym, call in node.aggregations:
            if call.distinct or call.filter is not None \
                    or call.name not in self._MXU_FUSABLE_AGGS \
                    or len(call.args) > 1:
                return None
            if not call.args:
                if call.name != "count":
                    return None
                derive.append(("pairs",))
                out_types.append(out_sym.type)
                continue
            arg = call.args[0]
            if not isinstance(arg, SymbolRef):
                return None
            r = resolve(arg.name)
            if r is None:
                return None
            side, ch = r
            in_t = ptypes[ch] if side == "p" else btypes[ch]
            if call.name == "count":
                if side == "p":
                    derive.append(("cntp", ch))
                else:
                    derive.append(("cntb", vec(("validcnt", ch))))
            else:
                kind = num_kind(in_t)
                if kind is None or num_kind(out_sym.type) != kind:
                    return None
                if side == "p":
                    derive.append(("sump", ch, kind))
                else:
                    v = vec(("sum", ch, kind))
                    hvec = vec(("validcnt", ch))
                    if hvec not in helpers:
                        helpers.append(hvec)
                    derive.append(("sumb", v, kind, helpers.index(hvec)))
            out_types.append(out_sym.type)
        clause = join.criteria[0]
        if clause.left.name not in pmap or clause.right.name not in bmap:
            return None
        return PageStream(
            self._mxu_agg_join_run(
                node, join, proj, tuple(group_chs), tuple(derive),
                tuple(helpers), tuple(vec_specs), tuple(out_types),
                pmap[clause.left.name], bmap[clause.right.name]),
            node.outputs)

    def _mxu_agg_join_run(self, node, join, proj, group_chs, derive,
                          helpers, vec_specs, out_types, pkey_ch,
                          bkey_ch) -> Iterator[Page]:
        """Drive the fused aggregating join (see _mxu_agg_join): K26's key
        bounds, K24's table, per probe page K25 and K1, ONE standard
        SINGLE aggregation over the derived rows, K27's SQL NULLs. Keeps
        the gather path's contracts: a build that overflows its
        reservation mid-collect streams into the partitioned join, a build
        past join_spill_threshold_bytes takes the spilled join, and
        sparse, over-span or magnitude-unsafe keys take the gather join;
        each then feeds the normal aggregation."""
        probe_stream = self.execute(join.left)
        build_stream = self.execute(join.right)
        build_iter = None
        if bool(self.session.get("spill_enabled")) \
                and int(self.session.get("spill_partition_count")) > 1:
            build_page, build_iter = \
                self._collect_build_resilient(build_stream)
        else:
            build_page = self._collect(build_stream)
        handed_off = False

        def gather_fallback(bp, bit=None):
            # the one gather-fallback shape, shared by every run-time
            # decline: _join_with_build owns the collected page or the
            # streaming iterator, then the normal aggregation runs over its
            # (re-projected) output
            jstream = self._join_with_build(
                join, probe_stream, build_stream.symbols, bp, bit)
            if proj is not None:
                jstream = self._select_stream(jstream, proj)
            return self._agg_over_stream(node, jstream).iter_pages()

        try:
            if build_iter is not None:
                # mid-collect memory pressure: the streaming partitioned
                # join owns the pages; aggregate its output
                handed_off = True
                yield from gather_fallback(None, build_iter)
                return
            if build_page is None:
                if not node.group_by:
                    yield self._empty_global_agg(node)
                return
            if bool(self.session.get("spill_enabled")) and \
                    page_bytes(build_page) > int(self.session.get(
                        "join_spill_threshold_bytes")):
                # over-threshold build: the gather path's memory discipline
                # (the spilled or partitioned join) instead of pinning the
                # whole side for the scatter
                handed_off = True
                yield from gather_fallback(build_page)
                return
            bounds = cached_kernel(("mxu-key-bounds", bkey_ch),
                                   lambda: key_bounds(bkey_ch))(build_page)
            kmin_d = bounds[B_KMIN]
            kmin, kmax = (unsigned(x) for x in bounds[:B_KMAX + 1].tolist())
            span = kmax - kmin + 1 if kmax >= kmin else 0
            size = 1 << max((span - 1).bit_length(), 7) if span else 0
            table = None
            if 0 < span <= int(self.session.get("mxu_join_max_slots")) \
                    and build_page.capacity < MAX_EXACT_ROWS:
                table, info = cached_kernel(
                    ("mxu-agg-table", bkey_ch, vec_specs, size),
                    lambda: scatter_agg_table(size, vec_specs, bkey_ch))(
                        build_page, kmin_d)
                ndistinct, mag_ok, n_live = info[:INFO_LIVE + 1].tolist()
                if not mag_ok or ndistinct < span * float(self.session.get(
                        "mxu_join_density_threshold")):
                    table = None
            if table is None:
                # sparse, over-span or magnitude-unsafe build keys: the
                # gather join and the normal aggregation
                handed_off = True
                yield from gather_fallback(build_page)
                return
            self.stats["mxu_joins"] += 1
            # the dynamic filter, as the gather join applies it: the build
            # key's range prefilters the probe pages (K1's range mode)
            prefilter = None
            if self.session.get("enable_dynamic_filtering") and \
                    not T.is_string(join.left.outputs[pkey_ch].type):
                pf_op = cached_kernel(("dfrange", pkey_ch),
                                      lambda: range_prefilter(pkey_ch))
                prefilter = (pf_op, typed_bounds(
                    build_page.column(bkey_ch).values.dtype,
                    bounds[B_LO:B_HI + 1]))
            aligned = self._align_join_dictionaries(
                probe_stream, build_page, [pkey_ch], [bkey_ch])
            lookup_op = cached_kernel(
                ("mxu-agg-lookup", pkey_ch, group_chs, derive, helpers),
                lambda: agg_join_lookup(pkey_ch, group_chs, derive,
                                        helpers))
            ncols = len(vec_specs)
            log = {"kind": JoinType.INNER, "route": "mxu-agg",
                   "slots": size, "vectors": ncols, "build_rows": n_live,
                   "max_run": None, "probe_rows": 0, "output_rows": 0}
            self.joins.append(log)
            derived: List[Page] = []
            probe_counts: List[torch.Tensor] = []
            for page in self._coalesce_stream(
                    aligned, prefilter=prefilter).iter_pages():
                self._checkpoint()
                self.stats["mxu_flops"] += lookup_flops(page.capacity, size,
                                                        ncols)
                probe_counts.append(page.num_rows)
                derived.append(lookup_op(page, table, kmin_d))
            merged, rows = self.merge_counted_rows(derived)
            if probe_counts:
                log["probe_rows"] = int(torch.stack(probe_counts).sum())
            log["output_rows"] = rows
            if merged is None:
                if not node.group_by:
                    yield self._empty_global_agg(node)
                return
            nk = len(group_chs)

            def dtyp(d):
                if d[0] in ("pairs", "cntp", "cntb"):
                    return T.BIGINT
                return T.BIGINT if d[2] == "i" else T.DOUBLE

            spec_types = tuple(dtyp(d) for d in derive) \
                + (T.BIGINT,) * len(helpers)
            agg_specs = tuple(AggSpec("sum", nk + i, t)
                              for i, t in enumerate(spec_types))
            single_op = cached_kernel(
                ("mxu-agg-single", nk, agg_specs),
                lambda: hash_aggregate(list(range(nk)), list(agg_specs),
                                       Step.SINGLE))
            post_op = cached_kernel(
                ("mxu-agg-post", nk, derive, len(helpers), out_types),
                lambda: agg_join_post(nk, derive, len(helpers), out_types))
            yield post_op(single_op(merged))
        finally:
            if not handed_off:
                self._free_collected(build_page)

    def _select_stream(self, stream: PageStream, proj) -> PageStream:
        """A pure column-select/rename ProjectNode over a stream (the
        unwrap _mxu_agg_join performed, applied again on its gather
        fallback so the aggregation sees its declared layout)."""
        lay = {s.name: i for i, s in enumerate(stream.symbols)}
        order = tuple(lay[e.name] for _, e in proj.assignments)
        return PageStream(
            stream.pages, tuple(s for s, _ in proj.assignments),
            stream.pending + ((("select", order),
                               lambda: lambda p, g, o=order: Page(
                                   tuple(p.columns[i] for i in o),
                                   p.num_rows), ()),))

    def _exec_GroupIdNode(self, node: GroupIdNode) -> PageStream:
        """Each source page once per grouping set, in set order: keys
        outside the set get an all-false validity, and a BIGINT group-id
        column (the set's index) is appended."""
        src = self.execute(node.source)
        lay, _ = _layout(src.symbols)
        all_group = tuple(dict.fromkeys(
            s for gs in node.grouping_sets for s in gs))

        def gen():
            for page in src.iter_pages():
                dev = page.device
                for set_idx, gset in enumerate(node.grouping_sets):
                    in_set = {s.name for s in gset}
                    cols = []
                    for sym in all_group + node.passthrough:
                        c = page.column(lay[sym.name])
                        if sym in all_group and sym.name not in in_set:
                            # null out keys excluded from this grouping set
                            c = Column(c.values, torch.zeros(
                                page.capacity, dtype=torch.bool, device=dev),
                                c.type, c.dictionary)
                        cols.append(c)
                    cols.append(Column(torch.full(
                        (page.capacity,), set_idx, dtype=torch.int64,
                        device=dev), None, T.BIGINT, None))
                    yield Page(tuple(cols), page.num_rows)
        return PageStream(gen(), node.outputs)

    # ---------------------------------------------------------------- join

    def _collect(self, stream: PageStream) -> Optional[Page]:
        """Materialize a stream (a blocking operator's input) on the
        device, reserved against query_max_memory; freed at operator scope
        by _free_collected."""
        page = self.merge_counted(list(stream.iter_pages()))
        if page is None:
            return None
        self._fault_site("memory", "collect")
        self.memory.reserve(page_bytes(page), "collect")
        return page

    def _free_collected(self, page: Optional[Page]) -> None:
        """Release a _collect reservation (else a query's peak would count
        every build side and sort input it ever held)."""
        if page is not None:
            self.memory.free(page_bytes(page), "collect")

    def _exec_JoinNode(self, node: JoinNode) -> PageStream:
        if node.kind == JoinKind.CROSS and not node.criteria:
            return self._exec_cross_join(node)
        if node.kind == JoinKind.RIGHT:
            return self._exec_right_join(node)
        if node.kind == JoinKind.FULL:
            return self._exec_full_join(node)
        probe_stream = self.execute(node.left)
        build_stream = self.execute(node.right)
        # an INNER build under spill collects with incremental reservation:
        # memory pressure mid-collect switches to the streaming partitioned
        # join (the build pages partition to host one at a time)
        build_iter = None
        if node.kind == JoinKind.INNER \
                and bool(self.session.get("spill_enabled")) \
                and int(self.session.get("spill_partition_count")) > 1:
            build_page, build_iter = \
                self._collect_build_resilient(build_stream)
        else:
            build_page = self._collect(build_stream)
        return self._join_with_build(node, probe_stream,
                                     build_stream.symbols, build_page,
                                     build_iter)

    def _join_with_build(self, node: JoinNode, probe_stream: PageStream,
                         build_symbols, build_page: Optional[Page],
                         build_iter=None) -> PageStream:
        """INNER or LEFT equi-join over a collected build side: an INNER
        join over a unique build takes the unique path (K5 build, K6
        probe, K1 compaction, K7 attach) with the build's key range as a
        dynamic filter on the probe stream; a build with duplicate keys or
        a LEFT join takes the expanding probe (K5 runs mode, K9, K7). An
        INNER build past join_spill_threshold_bytes takes the spilled join
        (K16, K17, the host attach) or, for duplicate or string keys, the
        partitioned join (K18); `build_iter` is a build that overflowed
        its reservation mid-collect, which streams into the partitioned
        join. Frees the collected page."""
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

        node_id = ("join", tuple(c.left.name for c in node.criteria),
                   tuple(c.right.name for c in node.criteria))

        def gen():
            if build_iter is not None:
                yield from self._run_overflowed_build(
                    probe_stream, build_iter, build_symbols, probe_keys,
                    build_keys, expanding_ops, node_id)
                return
            owned = [build_page]     # a spill path takes it over
            try:
                yield from body(owned)
            finally:
                self._free_collected(owned[0])

        def body(owned):
            bp = build_page
            if bp is None:
                if join_kind == JoinType.INNER:
                    return                   # INNER join, empty build
                # LEFT join, empty build: every probe row null-extended
                bp = self._null_build_page(build_symbols)
            # INNER only: probe codes absent from the build pool become
            # codes that never match, which a LEFT join would emit; LEFT
            # keys across distinct dictionaries stay fail-loud in the probe
            aligned = probe_stream
            if join_kind == JoinType.INNER:
                aligned = self._align_join_dictionaries(
                    probe_stream, bp, probe_keys, build_keys)
            if join_kind == JoinType.INNER and build_page is not None \
                    and bool(self.session.get("spill_enabled")) and \
                    page_bytes(build_page) > int(self.session.get(
                        "join_spill_threshold_bytes")):
                owned[0] = None
                yield from self._run_spilled_inner(
                    aligned, build_page, probe_keys, build_keys, post_pred,
                    post_params, probe_keep, build_keep, expanding_ops,
                    skew_hint=node.build_skew_estimate, node_id=node_id)
                return
            prepared, max_run, mode, n_live = self._prepare_probe(
                build_keys, bp, expanding=join_kind != JoinType.INNER,
                mxu_ok=(join_kind == JoinType.INNER
                        and len(build_keys) == 1))
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
            # an in-memory build holds its page on the device
            log.update(build_bytes=page_bytes(bp), device_bytes=page_bytes(
                bp), host_bytes=0)
            probe_in = self._mxu_stream(
                self._coalesce_stream(aligned, prefilter=prefilter),
                prepared)
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
                build_keys, bp, expanding=True,
                mxu_ok=len(build_keys) == 1)
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
            for out in self._run_verdict(probe_stream, verdict, log,
                                         prepared):
                flag = torch.full((out.capacity,), mode == "semi",
                                  dtype=torch.bool, device=out.device)
                yield out.append_column(Column(flag, None, T.BOOLEAN, None))

        def owned():
            try:
                yield from gen()
            finally:
                self._free_collected(build_page)
        return PageStream(owned(),
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
                build_keys, build_page, expanding=True,
                mxu_ok=len(build_keys) == 1)
            op = cached_kernel(
                ("markjoin", probe_keys, build_keys, node.null_aware, route),
                lambda: hash_join(probe_keys, build_keys, JoinType.MARK,
                                  null_aware=node.null_aware, lookup=route))
            log = self._join_log(JoinType.MARK, route, n_live, max_run)
            yield from self._run_verdict(
                probe_stream, lambda page: op.verdict(page, prepared), log,
                prepared)

        def owned():
            try:
                yield from gen()
            finally:
                self._free_collected(build_page)
        return PageStream(owned(), out_symbols)

    def _run_verdict(self, probe_stream: PageStream, verdict, log,
                     prepared) -> Iterator[Page]:
        """SEMI/ANTI/MARK over the coalesced probe stream: the verdict op
        per page, ONE host read of the output rows per batch, each output
        shrunk to at most 2x its live rows."""
        pages = self._mxu_stream(self._coalesce_stream(probe_stream),
                                 prepared).iter_pages()
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

    def _exec_UnnestNode(self, node) -> PageStream:
        """UNNEST (operator/unnest/UnnestOperator.java; reference:
        _exec_UnnestNode): per page K34 counts the live non-NULL elements
        (one fetch sizes the output at exactly that many rows, where the
        reference pads it to the next power of two), then expands them:
        each output slot's source row, ordinal and element (a MAP's key
        and value); the source columns are replicated at the source rows
        through K7."""
        src = self.execute(node.source)
        lay, _ = _layout(src.symbols)
        arr_ch = lay[node.arrays[0].name]
        el_types = node.elements[0]
        with_ord = node.ordinality is not None

        def gen():
            for page in src.iter_pages():
                c = page.column(arr_ch)
                total = int(lists.unnest_count(c.lengths, c.valid,
                                               page.num_rows))
                self.lists.append({"step": "unnest", "slots": total,
                                   "rows": int(page.capacity)})
                if total == 0:
                    continue
                srow, ordinal, elem, aval, count = lists.unnest_expand(
                    c.lengths, c.valid, page.num_rows, c.values, c.aux,
                    total, with_ord)
                cols = list(page.gather(srow, count).columns)
                cols.append(Column(elem, None, el_types[0].type,
                                   c.dictionary))
                if c.aux is not None:
                    cols.append(Column(aval, None, el_types[1].type,
                                       c.aux_dictionary))
                if with_ord:
                    cols.append(Column(ordinal, None, T.BIGINT, None))
                yield Page(tuple(cols), count)
        return PageStream(gen(), node.outputs)

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

    # ------------------------------------------------------- spilled joins

    def _run_overflowed_build(self, probe_stream, build_iter, build_symbols,
                              probe_keys, build_keys, join_op, node_id
                              ) -> Iterator[Page]:
        """The build overflowed its reservation mid-collect: the streaming
        partitioned join consumes the rest of it. String keys first stage
        the whole build on the host and rebase every page onto ONE union
        pool (the co-partition hash compares dictionary codes), and the
        probe re-encodes onto it."""
        if not any(T.is_string(build_symbols[bk].type) for bk in build_keys):
            yield from self._run_partitioned_inner(
                probe_stream, build_iter, probe_keys, build_keys, join_op,
                node_id=node_id)
            return
        stage, pools = self._restage_string_build(build_iter, build_keys)
        if stage is None:
            return          # empty build, INNER: no output rows
        try:
            aligned = self._align_probe_to_pools(
                probe_stream, {pk: pools[bk] for pk, bk in
                               zip(probe_keys, build_keys) if bk in pools})
            replay = stage.drain_partition_chunks(
                0, stage.chunk_rows_for(0, self._spill_budget(int(
                    self.session.get("join_spill_threshold_bytes")))))
            yield from self._run_partitioned_inner(
                aligned, replay, probe_keys, build_keys, join_op,
                node_id=node_id)
        finally:
            stage.close()

    def _run_spilled_inner(self, probe_stream, build_page, probe_keys,
                           build_keys, post_pred, post_params, probe_keep,
                           build_keep, join_op, skew_hint=None,
                           node_id=None) -> Iterator[Page]:
        """The spilled INNER join (HashBuilderOperator's spill states):
        K16 sorts the build keys on the device, the build's payload columns
        move to host memory, and the device keeps only the sorted keys and
        permutation (about 12 bytes a row; `spill-search`, probed by K17's
        search mode) or, for a key span up to 2^28, a table of build rows
        (4 bytes a slot, K5's dense mode; `spill-dense`, K17's dense
        mode). Matched rows' build columns are gathered on the host
        (attach_build_host). Duplicate-key and string-keyed builds, and
        builds the CBO expects skewed, take the partitioned join. Frees
        the collected build page."""
        self._fault_site("spill", "join-build")
        npart = int(self.session.get("spill_partition_count"))
        partitioned_ok = npart > 1
        # string keys compare by per-dictionary code, which the spilled
        # probe cannot guard; the partitioned path restages whole pages
        string_keyed = any(build_page.columns[bk].dictionary is not None
                           for bk in build_keys)
        is_unique = False
        cbo_partitioned = (partitioned_ok and skew_hint is not None
                           and skew_hint > 2.0)
        if not string_keyed and not cbo_partitioned:
            try:
                prep = cached_kernel(
                    ("spill-prep", tuple(build_keys)),
                    lambda: prepare_build_spilled(build_keys))
                bkey_s, bperm, sstats = prep(build_page)
                got = sstats.tolist()       # one host read
                is_unique = bool(got[SPILL_UNIQUE])
                n_rows, n_live = got[N_ROWS], got[N_LIVE]
                kmin, kmax = unsigned(got[KMIN]), unsigned(got[KMAX])
            except BaseException:
                self._free_collected(build_page)
                raise
        if string_keyed or cbo_partitioned or not is_unique:
            if partitioned_ok:
                yield from self._run_partitioned_inner(
                    probe_stream, build_page, probe_keys, build_keys,
                    join_op, node_id=node_id)
                return
            # partitioning off (spill_partition_count <= 1): the in-memory
            # expanding join
            try:
                prepared, max_run, route, n_live = self._prepare_probe(
                    build_keys, build_page, expanding=True)
                log = self._join_log(JoinType.INNER, route, n_live, max_run)
                op, post = join_op(route)
                yield from self._run_expanding(
                    self._coalesce_stream(probe_stream), prepared, op, log,
                    post=post)
            finally:
                self._free_collected(build_page)
            return
        # the pre page carries the kept probe columns (plus the key columns
        # a composite key re-checks, dropped after the attach); only the
        # kept build columns (and those keys) move to the host
        composite = len(probe_keys) > 1
        probe_out = list(probe_keep)
        extra_p = [k for k in probe_keys if k not in probe_out] \
            if composite else []
        probe_out_full = tuple(probe_out + extra_p)
        n_pre_cols = len(probe_out_full)
        host_idx = list(build_keep) + \
            ([k for k in build_keys if k not in build_keep]
             if composite else [])
        emit = tuple(range(len(build_keep)))
        verify = None
        if composite:
            verify = [(probe_out_full.index(pk), host_idx.index(bk))
                      for pk, bk in zip(probe_keys, build_keys)]
        build_bytes = page_bytes(build_page)
        try:
            host_cols = [self._stage_column_host(build_page.columns[ci],
                                                 n_rows)
                         for ci in host_idx]
        except BaseException:
            self._free_collected(build_page)
            raise
        host_bytes = sum(v.numel() * v.element_size()
                         + (0 if m is None else m.numel())
                         for v, m, _, _ in host_cols)
        self._record_spill(host_bytes)
        self._free_collected(build_page)
        span = kmax - kmin + 1 if kmax >= kmin else 0
        spill_dense = 0 < span <= SPILL_DENSE_MAX_SPAN
        if spill_dense:
            size = _next_pow2(span)
            table = cached_kernel(("dense-table-rows", size),
                                  lambda: build_dense_table_rows(size))(
                                      bkey_s, bperm, sstats)
            bkey_s = bperm = None       # the table replaces them
            held_bytes = table.numel() * table.element_size()
            probe_op = cached_kernel(
                ("spill-probe-dense", tuple(probe_keys), probe_out_full),
                lambda: spilled_dense_probe(probe_keys,
                                            probe_out=probe_out_full))
        else:
            held_bytes = bkey_s.numel() * bkey_s.element_size() \
                + bperm.numel() * bperm.element_size()
            probe_op = cached_kernel(
                ("spill-probe", tuple(probe_keys), probe_out_full),
                lambda: spilled_unique_probe(probe_keys,
                                             probe_out=probe_out_full))
        self.memory.reserve(held_bytes, "join-spill-keys")
        log = self._join_log(JoinType.INNER,
                             "spill-dense" if spill_dense else "spill-search",
                             n_live, 1)
        log.update(build_bytes=build_bytes, device_bytes=held_bytes,
                   host_bytes=host_bytes)
        post_filter = None if post_pred is None else filter_step(post_pred)
        drop_extra = None
        if extra_p:
            drop_extra = tuple(range(len(probe_keep))) + tuple(
                range(n_pre_cols, n_pre_cols + len(build_keep)))
        try:
            pages = self._coalesce_stream(probe_stream).iter_pages()
            for batch in _byte_bounded_batches(pages, 1 << 29):
                if spill_dense:
                    results = [probe_op(p, table, sstats) for p in batch]
                else:
                    results = [probe_op(p, bkey_s, bperm, sstats)
                               for p in batch]
                fetched = torch.stack(
                    [t for _, _, t in results]
                    + [pre.num_rows.to(torch.int64)
                       for pre, _, _ in results]).tolist()
                k = len(results)
                for (pre, found, _), total, live in zip(
                        results, fetched[:k], fetched[k:]):
                    log["probe_rows"] += live
                    log["output_rows"] += total
                    log["matched"] += total
                    if total == 0:
                        continue
                    pre = self._compact_probe(pre, found, total, live)
                    pre = self._tight(pre, total)
                    out = attach_build_host(pre, n_pre_cols, host_cols,
                                            verify=verify, emit=emit)
                    if drop_extra is not None:
                        out = out.select_columns(drop_extra)
                    if post_filter is not None:
                        out = out.filter(post_filter(out, post_params))
                    yield out
        finally:
            self.memory.free(held_bytes, "join-spill-keys")

    # device transient for staging one spilled-build column chunk
    _SPILL_STAGE_CHUNK_BYTES = 128 << 20

    def _stage_column_host(self, c: Column, n_rows: int):
        """One build payload column copied to host memory (pinned for a
        CUDA page) in bounded chunks, each reserved against the query
        ledger while it transfers. Returns (values, valid, type,
        dictionary) as attach_build_host reads them."""
        refuse_lists(Page((c,), 0))
        n = max(n_rows, 1)
        width = c.values.element_size() + (1 if c.valid is not None else 0)
        chunk = max(1 << 16, self._SPILL_STAGE_CHUNK_BYTES // max(width, 1))
        cuda = c.values.is_cuda
        vals = torch.empty(n, dtype=c.values.dtype, pin_memory=cuda)
        valid = None if c.valid is None else torch.empty(
            n, dtype=torch.bool, pin_memory=cuda)
        off = 0
        while off < n:
            hi = min(off + chunk, n)
            held = (hi - off) * width
            self.memory.reserve(held, "spill-stage")
            try:
                self._checkpoint()
                vals[off:hi].copy_(c.values[off:hi], non_blocking=cuda)
                if valid is not None:
                    valid[off:hi].copy_(c.valid[off:hi], non_blocking=cuda)
                if cuda:
                    torch.cuda.current_stream(c.values.device).synchronize()
            finally:
                self.memory.free(held, "spill-stage")
            off = hi
        return vals, valid, c.type, c.dictionary

    def _collect_build_resilient(self, stream: PageStream):
        """Collect a join build side with INCREMENTAL reservation: each page
        reserves before the next materializes, so memory pressure shows
        mid-collect, where it is a strategy switch: the pages so far
        chained with the rest of the stream go to the streaming
        partitioned join. Returns (page, None) when the build fit, (None,
        iterator) on pressure, (None, None) for an empty build."""
        self._fault_site("memory", "collect")
        pages: List[Page] = []
        held = 0
        it = stream.iter_pages()
        try:
            for page in it:
                self._checkpoint()
                b = page_bytes(page)
                try:
                    self.memory.reserve(b, "collect")
                except (ExceededMemoryLimitError, ClusterOutOfMemoryError):
                    # hand back every held byte: the pressure is relieved
                    # by NOT materializing this build
                    self.memory.free(held, "collect")
                    self.memory.clear_kill()
                    pages.append(page)
                    return None, _drain_then(pages, it)
                held += b
                pages.append(page)
        except BaseException:
            self.memory.free(held, "collect")
            raise
        merged = self.merge_counted(pages)
        # swap the per-page reservations for the merged page's bytes, the
        # free first (holding both could trip a limit the page fits under)
        self.memory.free(held, "collect")
        if merged is None:
            return None, None
        try:
            self.memory.reserve(page_bytes(merged), "collect")
        except (ExceededMemoryLimitError, ClusterOutOfMemoryError):
            # even the merged page is over the line: it becomes the
            # (single-page) streaming build
            self.memory.clear_kill()
            return None, iter([merged])
        return merged, None

    def _spill_budget(self, threshold: int) -> int:
        """The per-partition device budget for restage and recursion
        decisions: the spill threshold, shrunk under an active memory limit
        so a restaged partition's reservation can always be granted."""
        budget = int(threshold)
        limit = self.memory.limit
        if limit:
            budget = min(budget, max(int(limit) // 4, 1 << 16))
        pool = self.memory.pool
        if pool is not None and pool.limit:
            budget = min(budget, max(int(pool.limit) // 4, 1 << 16))
        return max(budget, 1)

    def _run_partitioned_inner(self, probe_stream, build_source,
                               probe_keys, build_keys, join_op,
                               node_id=None) -> Iterator[Page]:
        """The robust dynamic hybrid hash join, for duplicate-key, skewed
        and string-keyed builds past the threshold: both sides hash-
        partition into host stores (K18), then every co-partition joins
        with the in-memory kernels when its build fits the spill budget,
        and degrades when it does not (_join_partitions: salted recursive
        repartition, heavy-key splitting, the bounded chunked-build
        fallback). The device holds at most one partition's build and one
        probe chunk at any depth. `build_source` is the collected page
        (freed here) or the overflowed build's page iterator."""
        npart = int(self.session.get("spill_partition_count"))
        threshold = self._spill_budget(
            int(self.session.get("join_spill_threshold_bytes")))
        bkeys_t, pkeys_t = tuple(build_keys), tuple(probe_keys)
        build_is_page = isinstance(build_source, Page)

        def part_op(keys, salt):
            return cached_kernel(
                ("join-spill-part", keys, npart, salt),
                lambda: partition_by_hash(keys, npart, salt=salt))

        try:
            bstore = self._new_spill_store(npart)
            pstore = self._new_spill_store(npart)
        except BaseException:
            if build_is_page:
                self._free_collected(build_source)
            raise
        log = self._join_log(JoinType.INNER, "partitioned", 0, 0)
        log.update(depth=0, build_bytes=0, device_bytes=0, host_bytes=0)
        try:
            self._fault_site("spill", "join-part")
            bop = part_op(bkeys_t, 0)
            if build_is_page:
                log["build_bytes"] = page_bytes(build_source)
                self._record_spill(log["build_bytes"])
                try:
                    sorted_pg, counts = bop(build_source)
                    bstore.spill_partitioned(sorted_pg, counts.tolist())
                finally:
                    self._free_collected(build_source)
            else:
                # the overflowed build streams: its pages partition to the
                # host one at a time, never resident whole
                for bpage in build_source:
                    self._checkpoint()
                    log["build_bytes"] += page_bytes(bpage)
                    sorted_pg, counts = bop(bpage)
                    bstore.spill_partitioned(sorted_pg, counts.tolist())
                self._record_spill(bstore.bytes)
            pages = probe_stream if isinstance(probe_stream, Iterator) \
                else self._coalesce_stream(probe_stream).iter_pages()
            pop = part_op(pkeys_t, 0)
            for page in pages:
                self._checkpoint()
                sorted_pg, counts = pop(page)
                pstore.spill_partitioned(sorted_pg, counts.tolist())
            self._record_spill(pstore.bytes)
            log["host_bytes"] = bstore.bytes + pstore.bytes
            yield from self._join_partitions(
                bstore, pstore, 0, bkeys_t, pkeys_t, join_op, part_op,
                threshold, log, node_id)
        finally:
            bstore.close()
            pstore.close()

    def _join_partitions(self, bstore, pstore, depth: int, bkeys, pkeys,
                         join_op, part_op, threshold: int, log,
                         node_id=None) -> Iterator[Page]:
        """One round of the hybrid join over co-partitioned stores. Per
        partition: within budget, the in-memory join; heavy build keys
        (no re-hash splits them) split out of both sides into the chunked-
        build pass (build chunks replicate, the probe partition streams
        through each); still over budget, a salted repartition of BOTH
        sides up to `spill_max_recursion`; at the maximum depth, the
        bounded chunked-build fallback."""
        max_rec = int(self.session.get("spill_max_recursion"))
        heavy_limit = int(self.session.get("spill_heavy_key_limit"))
        npart = bstore.npart
        log["depth"] = max(log["depth"], depth)
        for p in range(npart):
            self._checkpoint()
            brows = bstore.partition_rows(p)
            prows = pstore.partition_rows(p)
            if brows == 0 or prows == 0:
                bstore.drop(p)
                pstore.drop(p)
                continue
            if bstore.partition_bytes(p) <= max(threshold, 1):
                yield from self._join_one_partition(
                    bstore, pstore, p, bkeys, join_op, threshold, log)
                continue
            if heavy_limit > 0 and depth < max_rec and npart > 1:
                bhashes = partition_key_hashes(bstore, p, bkeys)
                heavy = detect_partition_heavy_keys(
                    bstore, p, bkeys, heavy_limit,
                    max(2, brows // (2 * max(npart, 2))),
                    piece_hashes=bhashes)
                if len(heavy):
                    self._fault_site("spill", "join-heavy")
                    self._adaptive_event("heavy_key_splits")
                    if node_id is not None:
                        self.adaptive.record_join_heavy(node_id, heavy)
                    hb = split_partition(bstore, p, bkeys, heavy,
                                         piece_hashes=bhashes)
                    hp = split_partition(pstore, p, pkeys, heavy)
                    try:
                        yield from self._join_chunked_build(
                            hb, hp, 0, bkeys, join_op, threshold, log)
                    finally:
                        hb.close()
                        hp.close()
                    if bstore.partition_rows(p) == 0 or \
                            pstore.partition_rows(p) == 0:
                        bstore.drop(p)
                        pstore.drop(p)
                        continue
                    if bstore.partition_bytes(p) <= max(threshold, 1):
                        yield from self._join_one_partition(
                            bstore, pstore, p, bkeys, join_op, threshold,
                            log)
                        continue
            if depth >= max_rec or npart <= 1:
                self._fault_site("spill", "join-fallback")
                self._adaptive_event("spill_fallbacks")
                yield from self._join_chunked_build(
                    bstore, pstore, p, bkeys, join_op, threshold, log)
                continue
            self._fault_site("spill", "join-recurse")
            self._adaptive_event("join_recursions")
            childb = self._new_spill_store(npart)
            childp = self._new_spill_store(npart)
            try:
                bop = part_op(bkeys, depth + 1)
                # drain both sides: never parent AND child copies of one
                # side against the budget
                for chunk in bstore.drain_partition_chunks(
                        p, bstore.chunk_rows_for(p, threshold)):
                    self._checkpoint()
                    spg, cnt = bop(chunk)
                    childb.spill_partitioned(spg, cnt.tolist())
                bstore.drop(p)
                pop = part_op(pkeys, depth + 1)
                for chunk in pstore.drain_partition_chunks(
                        p, pstore.chunk_rows_for(p, threshold)):
                    self._checkpoint()
                    spg, cnt = pop(chunk)
                    childp.spill_partitioned(spg, cnt.tolist())
                pstore.drop(p)
                yield from self._join_partitions(
                    childb, childp, depth + 1, bkeys, pkeys, join_op,
                    part_op, threshold, log, node_id)
            finally:
                childb.close()
                childp.close()

    def _join_build_chunk(self, bpage: Page, probe_pages, bkeys, join_op,
                          log) -> Iterator[Page]:
        """One in-memory build (a partition or a chunk of one) joined with
        probe pages: K5 with the dense route where the span fits, never
        `mxu` (the reference's _prepare_with_dense), then the expanding
        probe (K9)."""
        prepared, max_run, route, n_live = self._prepare_probe(
            list(bkeys), bpage, expanding=True)
        log["build_rows"] += n_live
        log["max_run"] = max(log["max_run"], max_run)
        log["device_bytes"] = max(log["device_bytes"], page_bytes(bpage))
        op, post = join_op(route)
        yield from self._run_expanding(PageStream(probe_pages, ()),
                                       prepared, op, log, post=post)

    def _join_one_partition(self, bstore, pstore, p: int, bkeys, join_op,
                            threshold: int, log) -> Iterator[Page]:
        """In-memory join of one co-partition: the build side restaged
        (reserved against the query ledger) and prepared once, the probe
        partition streamed through in bounded chunks."""
        nrows = bstore.partition_rows(p)
        bpage = bstore.restage(p, _next_pow2(max(nrows, 1)))
        bstore.drop(p)
        held = page_bytes(bpage)
        self.memory.reserve(held, "join-part-build")
        try:
            yield from self._join_build_chunk(
                bpage, pstore.drain_partition_chunks(
                    p, pstore.chunk_rows_for(p, threshold)),
                bkeys, join_op, log)
            pstore.drop(p)
        finally:
            self.memory.free(held, "join-part-build")

    def _join_chunked_build(self, bstore, pstore, p: int, bkeys, join_op,
                            threshold: int, log) -> Iterator[Page]:
        """Bounded chunked-build join: an INNER join distributes over
        DISJOINT build chunks (a probe row meets each of its key's build
        rows in exactly one chunk), so the probe partition joined against
        budget-sized build chunks is right at any build size: more passes,
        never more memory."""
        pchunk_rows = pstore.chunk_rows_for(p, threshold)
        # build chunks drain (one pass); the probe partition stays, it
        # re-streams once per build chunk
        for bchunk in bstore.drain_partition_chunks(
                p, bstore.chunk_rows_for(p, threshold)):
            self._checkpoint()
            held = page_bytes(bchunk)
            self.memory.reserve(held, "join-chunk-build")
            try:
                yield from self._join_build_chunk(
                    bchunk, pstore.iter_partition_chunks(p, pchunk_rows),
                    bkeys, join_op, log)
            finally:
                self.memory.free(held, "join-chunk-build")
        bstore.drop(p)
        pstore.drop(p)

    def _restage_string_build(self, build_source, build_keys):
        """Overflow hand-off for STRING-keyed builds: pages of a streaming
        build may encode one key column against DISTINCT pools, and the
        co-partition hash compares codes, so the whole build stages on the
        host FIRST (a single-partition store: one device compaction per
        page, K18 with one partition), then every dictionary column whose
        pieces span several pools is rebased onto their union with a host
        code remap. Returns (stage, {build channel: dictionary}); the
        caller drains partition 0 as the build, aligns the probe to the
        pools, and closes the stage. (None, {}) = empty build."""
        from trino_tpu_torch.page import union_dictionaries
        bkeys_t = tuple(build_keys)
        compact = cached_kernel(
            ("join-spill-part", bkeys_t, 1, 0),
            lambda: partition_by_hash(bkeys_t, 1, salt=0))
        stage = self._new_spill_store(1)
        try:
            piece_dicts: List[list] = []
            for page in build_source:
                self._checkpoint()
                self._fault_site("spill", "join-string-stage")
                sorted_pg, counts = compact(page)
                before = len(stage.pieces[0])
                stage.spill_partitioned(sorted_pg, counts.tolist())
                if len(stage.pieces[0]) > before:
                    piece_dicts.append([c.dictionary for c in page.columns])
            self._record_spill(stage.bytes)
            if stage.meta is None:
                stage.close()
                return None, {}
            for ci in range(len(stage.meta)):
                dicts = [pd[ci] for pd in piece_dicts]
                if dicts[0] is None:
                    continue
                uniq: List = []
                for d in dicts:
                    if not any(d is u or d.fingerprint == u.fingerprint
                               for u in uniq):
                        uniq.append(d)
                final = uniq[0]
                if len(uniq) > 1:
                    union, remaps = union_dictionaries(uniq, device="cpu")
                    by_fp = {u.fingerprint: r.to(torch.int64)
                             for u, r in zip(uniq, remaps)}
                    for piece, d in zip(stage.pieces[0], dicts):
                        tbl = by_fp[d.fingerprint]
                        vals = piece[ci][0]
                        # padding and NULL codes (< 0) pass through
                        remapped = torch.where(
                            vals >= 0, tbl[vals.clamp(0, len(tbl) - 1).to(
                                torch.int64)].to(vals.dtype), vals)
                        piece[ci] = (remapped, piece[ci][1])
                    final = union
                typ, _ = stage.meta[ci]
                stage.meta[ci] = (typ, final)
            pools = {bk: stage.meta[bk][1] for bk in bkeys_t
                     if stage.meta[bk][1] is not None}
            return stage, pools
        except BaseException:
            stage.close()
            raise

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
                       expanding: bool = False, mxu_ok: bool = False):
        """K5 plus the per-join route (the reference's router): ONE host
        read of (live rows, max_run, kmin, kmax, distinct live keys), then

          'mxu'    — `mxu_ok` (one key; INNER, SEMI/ANTI or MARK),
                     mxu_join_enabled, the unsigned key span in (0,
                     mxu_join_max_slots], the build's capacity under
                     MAX_EXACT_ROWS and distinct keys >= span *
                     mxu_join_density_threshold: K12's (count, first)
                     table of 1 << max(bit_length(span - 1), 7) slots;
          'dense'  — the span fits the direct-address limit;
          'search' — K5's hash table.

        A build with duplicate keys, or any `expanding` join kind, also
        gets K5's runs mode (whose dense table holds slots and whose mxu
        table holds run starts, not rows). Returns (prepared, max_run,
        route, build live rows)."""
        prepared = self._prepare_build(build_keys, build_page)
        got = prepared.stats.tolist()
        max_run, n_live = got[MAX_RUN], got[N_LIVE]
        kmin, kmax = unsigned(got[KMIN]), unsigned(got[KMAX])
        span = kmax - kmin + 1 if kmax >= kmin else 0
        runs = expanding or max_run > 1
        if mxu_ok and bool(self.session.get("mxu_join_enabled")) \
                and 0 < span <= int(self.session.get("mxu_join_max_slots")) \
                and build_page.capacity < MAX_EXACT_ROWS \
                and got[NDISTINCT] >= span * float(self.session.get(
                    "mxu_join_density_threshold")):
            size = 1 << max((span - 1).bit_length(), 7)
            if runs:
                prepared = cached_kernel(("join-runs", 0),
                                         lambda: prepare_runs(0))(prepared)
            prepared = cached_kernel(("mxu-table", size),
                                     lambda: build_count_pos_table(size))(
                                         prepared)
            self.stats["mxu_joins"] += 1
            return prepared, max_run, "mxu", n_live
        size = self._dense_size(build_page, span)
        if runs:
            prepared = cached_kernel(("join-runs", size),
                                     lambda: prepare_runs(size))(prepared)
        elif size:
            prepared = cached_kernel(("dense-table", size),
                                     lambda: build_dense_table(size))(
                                         prepared)
        return prepared, max_run, "dense" if size else "search", n_live

    def _mxu_stream(self, stream: PageStream, prepared) -> PageStream:
        """A probe stream of an `mxu` join adding each page's cost-model
        flops to mxu_flops (the reference's _mxu_stream); other routes'
        streams pass as they are."""
        if prepared.mxu is None:
            return stream
        slots = prepared.mxu.shape[0]

        def gen():
            for page in stream.iter_pages():
                self.stats["mxu_flops"] += lookup_flops(page.capacity,
                                                        slots, 2)
                yield page
        return PageStream(gen(), stream.symbols)

    def _exec_SortNode(self, node: SortNode) -> PageStream:
        src = self.execute(node.source)
        lay, _ = _layout(src.symbols)
        keys = [SortKey(lay[o.symbol.name], o.ascending, o.nulls_first)
                for o in node.order_by]
        sort_op = cached_kernel(("sort", tuple(keys)),
                                lambda: order_by(keys))

        def gen():
            # sort spill: an input past sort_spill_threshold_bytes flushes
            # to host RANGE partitions of the leading sort key (K18; ties
            # and NULLs never straddle a partition), then each partition
            # restages, sorts whole (K10) and emits in partition order,
            # which is the global order
            threshold = int(self.session.get("sort_spill_threshold_bytes"))
            npart = int(self.session.get("spill_partition_count"))
            spillable = bool(self.session.get("spill_enabled")) and keys
            k0 = keys[0]
            store = None
            bounds = None
            part_op = None
            buf: List[Page] = []
            buf_bytes = 0

            def flush():
                nonlocal store, bounds, part_op, buf, buf_bytes
                self._fault_site("spill", "sort")
                merged = self.merge_counted(buf)
                buf, buf_bytes = [], 0
                if merged is None:
                    return
                self._record_spill(page_bytes(merged))
                if bounds is None:
                    store = self._new_spill_store(npart)
                    nf = k0.resolved_nulls_first()
                    rank_op = cached_kernel(
                        ("sort-spill-rank", k0.channel, k0.ascending, nf),
                        lambda: leading_rank(k0.channel, k0.ascending, nf))
                    bounds_op = cached_kernel(
                        ("sort-spill-bounds", npart),
                        lambda: rank_bounds(npart))
                    part_op = cached_kernel(
                        ("sort-spill-part", k0.channel, k0.ascending, nf,
                         npart),
                        lambda: partition_by_range(k0.channel, k0.ascending,
                                                   nf, npart))
                    bounds = bounds_op(rank_op(merged), merged.row_mask(),
                                       merged.num_rows)
                sorted_pg, counts = part_op(merged, bounds)
                store.spill_partitioned(sorted_pg, counts.tolist())

            try:
                for page in src.iter_pages():
                    self._checkpoint()
                    buf.append(page)
                    buf_bytes += page_bytes(page)
                    if spillable and buf_bytes >= threshold:
                        flush()
                if store is None:
                    page = self.merge_counted(buf)
                    if page is None:
                        return
                    self.memory.reserve(page_bytes(page), "collect")
                    try:
                        yield sort_op(page)
                    finally:
                        self._free_collected(page)
                    return
                if buf:
                    flush()
                for p in range(npart):
                    nrows = store.partition_rows(p)
                    if nrows == 0:
                        continue
                    pg = store.restage(p, _next_pow2(max(nrows, 1)))
                    store.drop(p)
                    yield sort_op(pg)
            finally:
                if store is not None:
                    store.close()
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

    def _exec_UnionNode(self, node: UnionNode) -> PageStream:
        nsyms = len(node.symbols)

        def gen():
            # start every child and peek one page each: string columns from
            # different tables carry different dictionaries, and blocking
            # consumers (sort, aggregation, join build) concatenate across
            # children, so each is re-encoded onto a shared union pool (K7
            # gathers the codes through the remap). Pages of one child
            # share a per-column dictionary, so one peek suffices.
            children = []
            for j, child in enumerate(node.children):
                stream = self.execute(child)
                lay, _ = _layout(stream.symbols)
                order = [lay[node.mappings[i][j].name] for i in range(nsyms)]
                it = iter(stream.iter_pages())
                first = next(it, None)
                children.append([it, first, order])
            remaps = _union_dictionary_remaps(node.symbols, children,
                                              self.device)
            for it, first, order in children:
                for page in _chain_first(first, it):
                    if int(page.num_rows) == 0:
                        continue
                    cols = []
                    for i, ch in enumerate(order):
                        col = page.column(ch)
                        remap = remaps[i].get(id(col.dictionary)) \
                            if remaps[i] else None
                        if remap is not None:
                            table, union_dict = remap
                            codes = gather_rows([table],
                                                col.values.clamp(min=0))[0]
                            col = Column(codes, col.valid, col.type,
                                         union_dict)
                        cols.append(col)
                    yield Page(tuple(cols), page.num_rows)
        return PageStream(gen(), node.symbols)

    def _exec_WindowNode(self, node: WindowNode) -> PageStream:
        """WindowOperator: blocking sort-partitioned evaluation
        (ops/window.py). The input is collected under query_max_memory."""
        src = self.execute(node.source)
        lay, _ = _layout(src.symbols)
        part = tuple(lay[s.name] for s in node.partition_by)
        okeys = tuple(SortKey(lay[o.symbol.name], o.ascending, o.nulls_first)
                      for o in node.order_by)
        specs = []
        for out_sym, wf in node.functions:
            whole, bounds = self._lower_frame(node, wf)
            args = []
            for a in wf.args:
                if not isinstance(a, SymbolRef):
                    raise ExecutionError("window args must be pre-projected")
                args.append(lay[a.name])
            specs.append(WindowSpec(wf.name.lower(), tuple(args),
                                    out_sym.type, whole,
                                    wf.frame_type == "ROWS", bounds))
        win = cached_kernel(
            ("window", part, okeys, tuple(specs)),
            lambda: window(part, okeys, specs))
        entry = {"rows": 0, "partitions": 0, "peer_groups": 0,
                 "functions": dict(collections.Counter(
                     "ranking" if s.name in RANKING else "aggregate"
                     if s.name in AGGREGATE else "value" for s in specs)),
                 "frames": dict(collections.Counter(
                     frame_kind(s) for s in specs))}
        self.windows.append(entry)

        def gen():
            page = self._collect(src)
            if page is None:
                return
            try:
                stats = {}
                out = win(page, stats)
                self.windows.pending.append((entry, torch.stack([
                    page.num_rows.to(torch.int64), stats["partitions"],
                    stats["peer_groups"]])))
                yield out
            finally:
                self._free_collected(page)
        return PageStream(gen(), node.outputs)

    @staticmethod
    def _lower_frame(node: WindowNode, wf):
        """WindowFunction frame -> (frame_whole, bounds) for WindowSpec.

        Ranking functions ignore frames (SQL). The default/unbounded frames
        map onto the whole/running paths; literal ROWS offsets become
        static (start_off, end_off) bounds; value-based RANGE offsets and
        GROUPS frames fail loud (FramedWindowFunction.java,
        sql/planner/plan/WindowNode.Frame)."""

        def literal_offset(value, kind: str) -> int:
            if not isinstance(value, Literal) or \
                    not isinstance(value.value, int):
                raise ExecutionError(
                    "window frame offsets must be integer literals")
            v = int(value.value)
            if v < 0:
                raise ExecutionError("window frame offset must be >= 0")
            return -v if kind == "PRECEDING" else v

        if wf.name.lower() in RANKING:
            return (not node.order_by), None
        st, sv = wf.start_type, wf.start_value
        et, ev = wf.end_type, wf.end_value
        if st == "UNBOUNDED_PRECEDING" and et == "UNBOUNDED_FOLLOWING":
            return True, None
        if not node.order_by:
            return True, None
        if st == "UNBOUNDED_PRECEDING" and et == "CURRENT_ROW":
            return False, None                     # running frame
        if wf.frame_type == "GROUPS":
            raise ExecutionError("GROUPS window frames not supported")
        if wf.frame_type == "RANGE":
            raise ExecutionError(
                "RANGE frames with value offsets not supported")
        start_off = None if st == "UNBOUNDED_PRECEDING" else (
            0 if st == "CURRENT_ROW" else literal_offset(sv, st))
        end_off = None if et == "UNBOUNDED_FOLLOWING" else (
            0 if et == "CURRENT_ROW" else literal_offset(ev, et))
        return False, (start_off, end_off)

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


def _chain_first(first: Optional[Page], rest: Iterator[Page]
                 ) -> Iterator[Page]:
    if first is not None:
        yield first
    yield from rest


def _union_dictionary_remaps(symbols, children, device):
    """Per output column: None when all children already share a
    dictionary, else {id(child dictionary): (code remap tensor, union
    dictionary)}."""
    remaps: List[Optional[Dict[int, tuple]]] = []
    for i, _ in enumerate(symbols):
        dicts = []
        for _, first, order in children:
            if first is None:
                continue
            d = first.column(order[i]).dictionary
            if d is not None:
                dicts.append(d)
        uniq = {id(d): d for d in dicts}
        if len(uniq) <= 1:
            remaps.append(None)
            continue
        union, tables = union_dictionaries(list(uniq.values()),
                                           device=device)
        remaps.append({did: (tbl, union) for did, tbl in zip(uniq, tables)})
    return remaps


def _drain_then(pages: List[Page], rest: Iterator[Page]) -> Iterator[Page]:
    """The buffered pages, each reference dropped as it is consumed
    (itertools.chain would pin the whole list, and its device memory,
    until the end), then the rest of the live stream."""
    while pages:
        yield pages.pop(0)
    yield from rest
