"""Co-scheduled fragment chains: a whole child chain in one host pass.

Port of `trino_tpu/exec/mesh_exec.py`. The per-shard dispatch loop
(exec/distributed.py `_fragment_attempt`) runs one fragment at a time,
merges each shard's output and applies the consuming exchange as a
standalone collective ('staged'). This module runs an eligible fragment
chain instead — leaf scans sharded one page per shard, every operator per
shard, every inter-fragment exchange inside the chain ('fused') — as one
pass that enqueues every shard's kernels: `MeshLowerer` turns each plan
node into a function over the shard list, and the pages never return to
the host between fragments. The reference's one XLA program has no torch
counterpart; its unit of fusion here is that pass.

Each node lowers to a function env -> [page per shard]: filter and project
run through K11 per shard; limits, TopN and sorts through the port's sort
operators; joins, semi joins, aggregations, windows and unique ids through
the port's own operators, by running the node per shard with its inputs
staged as RemoteSourceNodes of the chain (a ShardExecutionPlanner per
shard). MeshLowerer lowers the reference's nodes (TableScan,
RemoteSource, Filter, Project, Limit, TopN, Sort, Window, Aggregation,
Join, SemiJoin, AssignUniqueId) and raises MeshUnsupported where the
reference does, so the caller falls back to the dispatch loop for the
same chains and the fused and staged exchange counts equal the
reference's.

Exchange sites keep the reference's ladder: a repartition starts at
max(1024, next_pow2(cap // n)) and doubles while a source overflows, for
at most _MAX_LADDER_ROUNDS rounds, read off K35's counts before any row
moves. The skewed pair (a join whose inputs both repartition on its
clause keys, skewed_exchange_enabled) detects the probe's heavy keys with
the threshold max(pbucket // 2, 1024) and spreads their probe rows while
replicating their build rows (buckets: probe max(1024, next_pow2(cap //
n)), build twice that); a doubled probe bucket re-detects with its
threshold, as the reference's re-run program does. Joins size their
outputs from counts, as the port's join operators do everywhere.

Operator statistics (the reference's _record_program_stats) belong to
collect_operator_stats, ROADMAP A10: the runner refuses that session.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.errors import GENERIC_INTERNAL_ERROR, TrinoError
from trino_tpu_torch.exec.distributed import (fetch_counts,
                                              merge_shard_pages, merge_sort,
                                              split_scan_capacity)
from trino_tpu_torch.exec.local_planner import (ExecutionError,
                                                LocalExecutionPlanner,
                                                _layout, _next_pow2,
                                                lower_expr)
from trino_tpu_torch.exec.memory import page_bytes
from trino_tpu_torch.expr.ir import SymbolRef
from trino_tpu_torch.expr.kernel_gen import filter_step, project_step
from trino_tpu_torch.ops import SortKey, order_by
from trino_tpu_torch.ops.aggregate import COLLECT_AGGREGATES
from trino_tpu_torch.ops.join_mxu import key_bounds, lookup_flops
from trino_tpu_torch.ops.sort import top_n
from trino_tpu_torch.page import Column, Dictionary, Page, device_concat, \
    gather_rows, row_count
from trino_tpu_torch.parallel.exchange import (MODE_HASH, MODE_REPLICATE,
                                               MODE_SPREAD,
                                               detect_heavy_keys,
                                               exchange_apply, exchange_plan,
                                               broadcast_page)
from trino_tpu_torch.parallel.mesh import empty_like, normalize_pages
from trino_tpu_torch.planner.nodes import (AggregationNode, AggStep,
                                           ExchangeKind, FilterNode,
                                           JoinClause, JoinKind, JoinNode,
                                           LimitNode, ProjectNode,
                                           SemiJoinNode, SortNode,
                                           TableScanNode, TopNNode,
                                           WindowNode)
from trino_tpu_torch.planner.optimizer import PlanFragment, RemoteSourceNode


class MeshUnsupported(Exception):
    """This fragment chain does not lower to one co-scheduled pass; the
    caller falls back to the per-shard dispatch loop (not an error)."""


class MeshExecutionError(TrinoError):
    """A co-scheduled exchange's capacity ladder did not converge."""

    CODE = GENERIC_INTERNAL_ERROR


_MAX_LADDER_ROUNDS = 10

# staged inputs of a node run per shard: negative fragment ids, apart
# from the fragmenter's
_STAGE_IDS = itertools.count(-1, -1)

Shards = List[Optional[Page]]


class _Env:
    """One pass's state: the runner, the staged scans, the inputs staged
    for per-shard node runs, and each shard's executor."""

    def __init__(self, runner, scans: List[Shards]):
        self.runner = runner
        self.scans = scans
        self.inputs: Dict[int, Shards] = {}
        self.executors = [runner.executor(s, self.inputs, mesh=True)
                          for s in range(runner.mesh.n)]


def _page_row_bytes(page: Page) -> int:
    """Per-row bytes of a page (values element sizes, 1 per validity)."""
    total = 0
    for c in page.columns:
        total += c.values.element_size() * (
            c.values.shape[1] if c.values.dim() == 2 else 1)
        if c.valid is not None:
            total += 1
    return max(total, 1)


def _mesh_ladder(cap: int, n: int, largest: int, start=None) -> int:
    """The co-scheduled ladder: double from the start bucket until the
    largest source -> destination count fits (no cap: the reference's
    program re-runs with the doubled bucket)."""
    bucket = start if start is not None else \
        max(1024, _next_pow2(max(1, cap // n)))
    for _ in range(_MAX_LADDER_ROUNDS):
        if largest <= bucket:
            return bucket
        bucket *= 2
    raise MeshExecutionError(
        f"mesh capacity ladder did not converge (bucket {bucket}, largest "
        f"{largest})")


class MeshLowerer:
    """Lower a PlanFragment tree (+ its consuming exchange) into one
    function over the shard list."""

    def __init__(self, runner):
        self.runner = runner
        self.session = runner.session
        self.n = runner.mesh.n
        self.scans: List[TableScanNode] = []
        self._skew = bool(self.session.get("skewed_exchange_enabled"))
        self._skew_k = max(1, int(self.session.get("skew_heavy_key_limit")))
        self._mxu_slots = int(self.session.get("mxu_join_max_slots")) \
            if bool(self.session.get("mxu_join_enabled")) else None

    # ------------------------------------------------------------- entry

    def lower_child(self, frag: PlanFragment, remote: RemoteSourceNode
                    ) -> Callable:
        inner = self.lower_node(frag.root, frag)
        return self._lower_exchange(inner, remote, tuple(frag.root.outputs))

    # ----------------------------------------------------------- exchange

    def _lower_exchange(self, inner: Callable, remote: RemoteSourceNode,
                        symbols) -> Callable:
        n = self.n
        if remote.kind == ExchangeKind.REPARTITION:
            lay = {s.name: i for i, s in enumerate(symbols)}
            keys = [lay[s.name] for s in remote.partition_keys]

            def fn(env: _Env) -> Shards:
                pages = _filled(inner(env))
                plan = exchange_plan(pages, keys, MODE_HASH, None)
                bucket = _mesh_ladder(pages[0].capacity, n, plan.largest)
                out, _ = exchange_apply(pages, plan, bucket)
                rows = plan.rows
                env.runner._record_exchange(
                    remote, "fused", rows, rows * _page_row_bytes(pages[0]),
                    bucket=bucket)
                _note_peak(env, out)
                return out
            return fn

        def fn(env: _Env) -> Shards:
            pages = _filled(inner(env))
            rows = sum(fetch_counts([p.num_rows for p in pages]))
            out = broadcast_page(pages)
            if remote.kind == ExchangeKind.MERGE and remote.order_by:
                out = merge_sort(out, remote)
            env.runner._record_exchange(
                remote, "fused", rows, rows * _page_row_bytes(pages[0]))
            _note_peak(env, out)
            return out
        return fn

    # ------------------------------------------------------------- nodes

    def lower_node(self, node, frag: PlanFragment) -> Callable:
        method = getattr(self, f"_lower_{type(node).__name__}", None)
        if method is None:
            raise MeshUnsupported(f"no mesh lowering for "
                                  f"{type(node).__name__}")
        return method(node, frag)

    def _lower_TableScanNode(self, node: TableScanNode, frag) -> Callable:
        idx = len(self.scans)
        self.scans.append(node)
        return lambda env: env.scans[idx]

    def _lower_RemoteSourceNode(self, node: RemoteSourceNode, frag
                                ) -> Callable:
        child = next((c for c in frag.children
                      if c.fragment_id == node.fragment_id), None)
        if child is None:
            raise MeshUnsupported(f"missing child {node.fragment_id}")
        inner = self.lower_node(child.root, child)
        return self._lower_exchange(inner, node, tuple(child.root.outputs))

    def _lower_FilterNode(self, node: FilterNode, frag) -> Callable:
        src = self.lower_node(node.source, frag)
        lay, typ = _layout(node.source.outputs)
        step = filter_step(self._expr(node.predicate, lay, typ))
        return _per_shard(src, lambda p: p.filter(step(p, ())))

    def _lower_ProjectNode(self, node: ProjectNode, frag) -> Callable:
        src = self.lower_node(node.source, frag)
        lay, typ = _layout(node.source.outputs)
        step = project_step(tuple(self._expr(e, lay, typ)
                                  for _, e in node.assignments))
        return _per_shard(src, lambda p: Page(step(p, ()), p.num_rows))

    def _lower_LimitNode(self, node: LimitNode, frag) -> Callable:
        if not node.partial:
            raise MeshUnsupported("non-partial LIMIT in sharded fragment")
        src = self.lower_node(node.source, frag)
        return _per_shard(src, lambda p: Page(p.columns, torch.minimum(
            p.num_rows, row_count(node.count, p.device))))

    def _lower_TopNNode(self, node: TopNNode, frag) -> Callable:
        if node.step == "final":
            raise MeshUnsupported("final TopN in sharded fragment")
        src = self.lower_node(node.source, frag)
        lay, _ = _layout(node.source.outputs)
        op = top_n(node.count, [SortKey(lay[o.symbol.name], o.ascending,
                                        o.nulls_first)
                                for o in node.order_by])
        return _per_shard(src, op)

    def _lower_SortNode(self, node: SortNode, frag) -> Callable:
        src = self.lower_node(node.source, frag)
        lay, _ = _layout(node.source.outputs)
        op = order_by([SortKey(lay[o.symbol.name], o.ascending,
                               o.nulls_first) for o in node.order_by])
        return _per_shard(src, op)

    def _lower_WindowNode(self, node: WindowNode, frag) -> Callable:
        for _, wf in node.functions:
            try:
                LocalExecutionPlanner._lower_frame(node, wf)
            except ExecutionError as e:
                raise MeshUnsupported(f"window frame: {e}")
            if any(not isinstance(a, SymbolRef) for a in wf.args):
                raise MeshUnsupported("window args must be symbols")
        return self._run_node(node, [self.lower_node(node.source, frag)])

    def _lower_AggregationNode(self, node: AggregationNode, frag
                               ) -> Callable:
        src = self.lower_node(node.source, frag)
        if node.step == AggStep.FINAL and any(
                call.filter is not None for _, call in node.aggregations):
            raise MeshUnsupported("FILTER agg in final step")
        if node.step == AggStep.SINGLE and any(
                call.name in COLLECT_AGGREGATES
                for _, call in node.aggregations):
            raise MeshUnsupported("collect aggregate needs host sizing")
        return self._run_node(node, [src])

    def _lower_AssignUniqueIdNode(self, node, frag) -> Callable:
        return self._run_node(node, [self.lower_node(node.source, frag)])

    # -------------------------------------------------------------- joins

    def _lower_JoinNode(self, node: JoinNode, frag) -> Callable:
        if node.kind == JoinKind.RIGHT:
            flipped = JoinNode(
                JoinKind.LEFT, node.right, node.left,
                tuple(JoinClause(c.right, c.left) for c in node.criteria),
                node.filter, node.distribution)
            inner = self._lower_JoinNode(flipped, frag)
            lay, _ = _layout(flipped.outputs)
            order = [lay[s.name] for s in node.left.outputs
                     + node.right.outputs]
            return _per_shard(inner, lambda p: p.select_columns(order))
        if node.kind not in (JoinKind.INNER, JoinKind.LEFT):
            raise MeshUnsupported(f"{node.kind} join")
        if node.filter is not None and node.kind != JoinKind.INNER:
            raise MeshUnsupported("outer join residual filter")
        probe_lay, _ = _layout(node.left.outputs)
        build_lay, _ = _layout(node.right.outputs)
        probe_keys = [probe_lay[c.left.name] for c in node.criteria]
        build_keys = [build_lay[c.right.name] for c in node.criteria]
        sides = self._co_partitioned_inputs(node, frag)
        if sides is not None:
            pair = sides
        else:
            probe_fn = self.lower_node(node.left, frag)
            build_fn = self.lower_node(node.right, frag)

            def pair(env):
                return probe_fn(env), build_fn(env)
        mxu = self._mxu_slots \
            if (getattr(node, "join_strategy", None) == "mxu-matmul"
                and len(node.criteria) == 1) else None
        run = self._run_node(node, None)
        # the reference's co-scheduled join gives every build column a
        # validity mask; so do these pages, for the layout (and the
        # exchanged bytes) of the stages after it to be the reference's
        build_names = {s.name for s in node.right.outputs}
        masked = [i for i, s in enumerate(node.outputs)
                  if s.name in build_names]

        def fn(env: _Env) -> Shards:
            probe, build = pair(env)
            probe = _align_key_dictionaries(probe, build, probe_keys,
                                            build_keys)
            if mxu is not None:
                _mxu_aux(env, probe, build, build_keys[0], mxu)
            return [None if p is None else _with_validity(p, masked)
                    for p in run(env, [probe, build])]
        return fn

    def _co_partitioned_inputs(self, node: JoinNode, frag):
        left, right = node.left, node.right
        if not (isinstance(left, RemoteSourceNode)
                and isinstance(right, RemoteSourceNode)
                and left.kind == ExchangeKind.REPARTITION
                and right.kind == ExchangeKind.REPARTITION):
            return None
        lchild = next((c for c in frag.children
                       if c.fragment_id == left.fragment_id), None)
        rchild = next((c for c in frag.children
                       if c.fragment_id == right.fragment_id), None)
        if lchild is None or rchild is None:
            return None
        # the partition keys must be exactly the clause keys, in clause
        # order, for spread/replicate to keep the join's semantics
        if tuple(s.name for s in left.partition_keys) != \
                tuple(c.left.name for c in node.criteria) or \
                tuple(s.name for s in right.partition_keys) != \
                tuple(c.right.name for c in node.criteria):
            return None
        probe_fn = self.lower_node(lchild.root, lchild)
        build_fn = self.lower_node(rchild.root, rchild)
        play = {s.name: i for i, s in enumerate(left.symbols)}
        blay = {s.name: i for i, s in enumerate(right.symbols)}
        ppre = [play[s.name] for s in left.partition_keys]
        bpre = [blay[s.name] for s in right.partition_keys]
        n, skew, k = self.n, self._skew, self._skew_k

        def pair(env: _Env):
            probe_pre = _filled(probe_fn(env))
            build_pre = _filled(build_fn(env))
            pbucket = max(1024, _next_pow2(max(1, probe_pre[0].capacity
                                               // n)))
            bbucket = max(1024, 2 * _next_pow2(max(1, build_pre[0].capacity
                                                   // n)))
            for _ in range(_MAX_LADDER_ROUNDS):
                heavy = detect_heavy_keys(probe_pre, ppre, k,
                                          max(pbucket // 2, 1024)) \
                    if skew else None
                pplan = exchange_plan(probe_pre, ppre,
                                      MODE_HASH if heavy is None
                                      else MODE_SPREAD, heavy)
                if pplan.largest <= pbucket:
                    break
                pbucket *= 2
            else:
                raise MeshExecutionError("skewed pair: probe ladder did "
                                         "not converge")
            bplan = exchange_plan(build_pre, bpre,
                                  MODE_HASH if heavy is None
                                  else MODE_REPLICATE, heavy)
            bbucket = _mesh_ladder(0, n, bplan.largest, start=bbucket)
            probe, _ = exchange_apply(probe_pre, pplan, pbucket)
            build, _ = exchange_apply(build_pre, bplan, bbucket)
            hv = [] if heavy is None else \
                [int(h) for h in heavy[0].tolist() if h != -1]
            env.runner._record_exchange(
                left, "fused", pplan.rows,
                pplan.rows * _page_row_bytes(probe_pre[0]), bucket=pbucket,
                heavy=hv)
            env.runner._record_exchange(
                right, "fused", bplan.rows,
                bplan.rows * _page_row_bytes(build_pre[0]), bucket=bbucket,
                heavy=hv)
            _note_peak(env, probe)
            _note_peak(env, build)
            return probe, build
        return pair

    def _lower_SemiJoinNode(self, node: SemiJoinNode, frag) -> Callable:
        probe_fn = self.lower_node(node.source, frag)
        build_fn = self.lower_node(node.filtering_source, frag)
        probe_lay, _ = _layout(node.source.outputs)
        build_lay, _ = _layout(node.filtering_source.outputs)
        probe_keys = [probe_lay[s.name] for s in node.source_keys]
        build_keys = [build_lay[s.name] for s in node.filtering_keys]
        mxu = self._mxu_slots \
            if (getattr(node, "join_strategy", None) == "mxu-matmul"
                and len(node.source_keys) == 1) else None
        run = self._run_node(node, None)

        def fn(env: _Env) -> Shards:
            probe, build = probe_fn(env), build_fn(env)
            probe = _align_key_dictionaries(probe, build, probe_keys,
                                            build_keys)
            if mxu is not None:
                _mxu_aux(env, probe, build, build_keys[0], mxu)
            return run(env, [probe, build])
        return fn

    # ------------------------------------------------------------ helpers

    def _expr(self, e, layout, types):
        from trino_tpu_torch.expr.hoist import materialize_bound
        return materialize_bound(lower_expr(e, layout, types),
                                 ())

    def _run_node(self, node, sources: Optional[List[Callable]]):
        """`node` run per shard by the port's operator for it, its inputs
        staged as RemoteSourceNodes; each shard's output pages merged into
        one page after one batched count fetch. With `sources` None the
        result takes the input shard lists itself: fn(env, inputs)."""
        def run(env: _Env, inputs: List[Shards]) -> Shards:
            remotes = []
            for src, pages in zip(node.sources, inputs):
                fid = next(_STAGE_IDS)
                env.inputs[fid] = pages
                remotes.append(RemoteSourceNode(fid, tuple(src.outputs),
                                                "mesh"))
            staged = node.with_sources(remotes)
            produced = [list(ex.execute(staged).iter_pages())
                        for ex in env.executors]
            for r in remotes:
                del env.inputs[r.fragment_id]
            out, totals = merge_shard_pages(produced, tight=False)
            # a shard whose operator emitted nothing holds an empty page,
            # as every shard of the reference's program does
            ref = next((p for p in out if p is not None), None)
            if ref is None:
                cap = max([p.capacity for ps in inputs for p in ps
                           if p is not None] + [1024])
                out = [_empty_page(node.outputs, cap, ex.device)
                       for ex in env.executors]
            else:
                out = [empty_like(ref) if p is None else p for p in out]
            if isinstance(node, (JoinNode, SemiJoinNode)):
                out = _join_capacity(out, totals, inputs[0])
            return out
        if sources is None:
            return run
        return lambda env: run(env, [s(env) for s in sources])


def _join_capacity(out: Shards, totals: List[int], probe: Shards) -> Shards:
    """A co-scheduled join's output at the reference's capacity: the
    probe page's, or the next power of two of the largest shard's output
    when that is larger (its ladder's end). The port's join operators size
    their outputs from counts; later probes' mxu cost (lookup_flops of the
    probe capacity) then counts as the reference's does."""
    caps = [p.capacity for p in probe if p is not None]
    if not caps:
        return out
    cap = max(caps)
    if max(totals, default=0) > cap:
        cap = _next_pow2(max(totals))
    fitted = []
    for p in out:
        if p is not None and p.capacity != cap:
            p = p.pad_to(cap) if p.capacity < cap else p.shrink_to(cap)
        fitted.append(p)
    return fitted


def _empty_page(symbols, capacity: int, device) -> Page:
    """A page of `symbols`' types with no live rows (strings on an empty
    dictionary): a stage whose operator emitted nothing on any shard."""
    cols = []
    for s in symbols:
        if isinstance(s.type, (T.ArrayType, T.MapType)):
            raise MeshUnsupported(f"an empty stage of list column {s.name}")
        string = T.is_string(s.type)
        cols.append(Column(
            torch.zeros(capacity, dtype=torch.int32 if string
                        else s.type.dtype, device=device), None, s.type,
            Dictionary(np.array([], dtype=object)) if string else None))
    return Page(tuple(cols), row_count(0, device))


def _with_validity(page: Page, channels: Sequence[int]) -> Page:
    """The page with a validity mask on each of `channels` (all true where
    it had none)."""
    cols = list(page.columns)
    for i in channels:
        c = cols[i]
        if c.valid is None:
            cols[i] = c.with_valid(torch.ones(c.capacity, dtype=torch.bool,
                                              device=c.device))
    return Page(tuple(cols), page.num_rows)


def _per_shard(src: Callable, op) -> Callable:
    return lambda env: [None if p is None else op(p) for p in src(env)]


def _filled(pages: Shards) -> List[Page]:
    """A shard list with no holes (an empty page of the others' layout)
    and the collectives' normal form."""
    ref = next((p for p in pages if p is not None), None)
    if ref is None:
        raise MeshExecutionError("a co-scheduled stage produced no page")
    return normalize_pages([empty_like(ref) if p is None else p
                            for p in pages])


def _note_peak(env: _Env, pages: Shards) -> None:
    """Per-shard peak accounting for the exchange outputs the next stage
    consumes (reserve and free: the gauge is the peak)."""
    ledger = env.runner._memory
    for shard, p in enumerate(pages):
        if p is not None:
            nbytes = page_bytes(p)
            ledger.reserve(nbytes, "mesh-exchange", device=shard)
            ledger.free(nbytes, "mesh-exchange", device=shard)


def _mxu_aux(env: _Env, probe: Shards, build: Shards, build_key: int,
             mxu_slots: int) -> None:
    """The reference's per-site mxu counters: the join counts once when
    any shard's build key span fits the matmul table (kmax - kmin <
    mxu_slots, unsigned; none at 2^24 build rows or more), with the
    cost-model flops of every such shard's probe page."""
    oks = []
    bounds = []
    for p, b in zip(probe, build):
        if p is None or b is None or b.capacity >= (1 << 24):
            continue
        bounds.append((p, key_bounds(build_key)(b)))
    if not bounds:
        return
    words = torch.stack([kb[:2].to(bounds[0][1].device)
                         for _, kb in bounds]).tolist()
    flops = 0
    for (p, _), (kmin, kmax) in zip(bounds, words):
        umin, umax = kmin & (2 ** 64 - 1), kmax & (2 ** 64 - 1)
        ok = umax >= umin and umax - umin < mxu_slots
        oks.append(ok)
        if ok:
            flops += lookup_flops(p.capacity, mxu_slots, 2)
    if any(oks):
        env.runner._stats["mxu_joins"] += 1
        env.runner._stats["mxu_flops"] += flops


def _align_key_dictionaries(probe: Shards, build: Shards, probe_keys,
                            build_keys) -> Shards:
    """String join keys across distinct dictionaries: probe codes remapped
    onto the build pool (K7), a code absent from it past the pool's end
    so it matches nothing."""
    ref = next((b for b in build if b is not None), None)
    out = list(probe)
    if ref is None:
        return out
    for pk, bk in zip(probe_keys, build_keys):
        bd = ref.columns[bk].dictionary
        for s, p in enumerate(out):
            if p is None:
                continue
            pc = p.columns[pk]
            if bd is None or pc.dictionary is None or pc.dictionary == bd:
                continue
            pvals = pc.dictionary.values
            n_b = len(bd.values)
            if n_b:
                codes = np.minimum(np.searchsorted(bd.values, pvals),
                                   n_b - 1).astype(np.int64)
                present = bd.values[codes] == pvals
            else:
                codes = np.zeros(len(pvals), np.int64)
                present = np.zeros(len(pvals), bool)
            tbl = torch.from_numpy(np.where(
                present, codes, n_b + np.arange(len(pvals), dtype=np.int64))
                .astype(np.int32)).to(pc.values.device)
            cols = list(p.columns)
            cols[pk] = Column(gather_rows([tbl], pc.values.clamp(min=0))[0],
                              pc.valid, pc.type, bd)
            out[s] = Page(tuple(cols), p.num_rows)
    return out


def _stage_scan(runner, node: TableScanNode) -> Shards:
    """One leaf scan as n per-shard pages (splits round-robin, each
    shard's pages merged by K2 on its device), normalized for the
    collectives; an empty table falls back to the dispatch loop."""
    conn = runner.metadata.connector(node.catalog)
    columns = [c for _, c in node.assignments]
    n = runner.mesh.n
    splits = conn.split_manager.get_splits(node.table, target_splits=n)
    cap = split_scan_capacity(runner.session, conn, node, splits)
    per_shard: Shards = []
    for shard in range(n):
        dev = str(runner.mesh.device_of(shard))
        source = runner.page_sources.get((node.catalog, dev),
                                         conn.page_source)
        pages = [page for split in splits if split.part % n == shard
                 for page in source.pages(split, columns, cap)]
        per_shard.append(None if not pages else pages[0] if len(pages) == 1
                         else device_concat(pages))
    ref = next((p for p in per_shard if p is not None), None)
    if ref is None:
        raise MeshUnsupported(f"empty table {node.table}")
    return normalize_pages([empty_like(ref) if p is None else p
                            for p in per_shard])


def run_co_scheduled(runner, frag: PlanFragment,
                     remote: RemoteSourceNode) -> Shards:
    """Run `frag` (with its whole child tree) and the consuming exchange
    as one co-scheduled pass over the runner's mesh; returns each shard's
    post-exchange page for the parent fragment, or raises MeshUnsupported
    for the dispatch-loop fallback."""
    lowerer = MeshLowerer(runner)
    top = lowerer.lower_child(frag, remote)   # may raise MeshUnsupported
    runner._check_deadline(runner._memory)
    scans = [_stage_scan(runner, scan) for scan in lowerer.scans]
    ledger = runner._memory
    reserved = []
    for pages in scans:
        for shard, p in enumerate(pages):
            nbytes = page_bytes(p)
            ledger.reserve(nbytes, "mesh-stage", device=shard)
            reserved.append((nbytes, shard))
    try:
        return top(_Env(runner, scans))
    finally:
        for nbytes, shard in reserved:
            ledger.free(nbytes, "mesh-stage", device=shard)
