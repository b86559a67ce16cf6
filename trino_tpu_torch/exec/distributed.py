"""Distributed execution: fragmented plans over a query mesh.

Port of `trino_tpu/exec/distributed.py` (reference parity:
execution/scheduler/SqlQueryScheduler.java:112, PlanFragmenter.java:108,
PhasedExecutionSchedule.java, and the HTTP data plane that collectives
replace). One process plans the query once and drives a `QueryMesh` of
shards, as the reference's single controller does: each PlanFragment runs
as n per-shard "tasks" through the local operator pipelines (leaf scans
sharded by split, `split.part % n == shard`), and REMOTE exchanges lower
to the collectives of parallel/exchange.py:

  REPARTITION -> all_to_all_by_key (K35 + the K2 receive)
  BROADCAST   -> broadcast_page    (K2 over every shard's live rows)
  GATHER      -> broadcast_page, shard 0 consumes
  MERGE       -> gather + re-sort  (K10)

Pages cross fragment boundaries without leaving their devices. The
repartition bucket keeps the reference's capacity ladder (start at
max(1024, next_pow2(cap // n)), double on overflow, stop at cap), taken in
one fetch: K35's count pass gives every source -> destination count
before any row moves, so the bucket the ladder would end on is known
without re-running the exchange, and the receive keeps the reference's
capacity n x bucket.

Chains of two or more shards run co-scheduled under mesh_execution
(exec/mesh_exec.py); a chain it cannot lower falls back to the per-shard
dispatch loop here (`exchanges_staged`, as in the reference).

Under the reference's default session the runner services this path
calls are pass-throughs: retry_policy NONE runs each task once, the table
cache is off, checkpoints and fault sites need chaos. A session that turns
one on raises naming its ROADMAP item (runner._check_services).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from trino_tpu_torch.exec.jit_cache import cached_kernel
from trino_tpu_torch.exec.local_planner import (QUERY_COUNTERS,
                                                LocalExecutionPlanner,
                                                PageStream, WindowLog,
                                                _layout, _next_pow2,
                                                compose_chain)
from trino_tpu_torch.exec.memory import (NODE_POOL, QueryMemoryContext,
                                         autosize_node_pool, live_page_bytes)
from trino_tpu_torch.exec.runner import (LocalQueryRunner, MaterializedResult,
                                         column_values)
from trino_tpu_torch.metadata import Metadata, Session
from trino_tpu_torch.ops import AggSpec, SortKey, Step, hash_aggregate, \
    order_by
from trino_tpu_torch.ops.aggregate import get_aggregate
from trino_tpu_torch.page import Column, Page, device_concat
from trino_tpu_torch.parallel.exchange import (all_to_all_by_key,
                                               broadcast_page)
from trino_tpu_torch.parallel.mesh import QueryMesh, empty_like, \
    normalize_pages
from trino_tpu_torch.planner import LogicalPlanner
from trino_tpu_torch.planner.nodes import (AggregationNode, AggStep,
                                           ExchangeKind, OutputNode,
                                           TableScanNode, ValuesNode)
from trino_tpu_torch.planner.optimizer import (PlanFragment,
                                               RemoteSourceNode,
                                               fragment_plan, optimize)
from trino_tpu_torch.sql import parse_statement
from trino_tpu_torch.sql import tree as t


class ShardMemory:
    """A shard's view of the query's shared ledger: its reservations carry
    the shard as `device`, so the node pool keeps per-shard totals and
    peaks (the reference's per-chip accounting)."""

    def __init__(self, ctx: QueryMemoryContext, shard: int):
        self._ctx = ctx
        self.shard = shard

    def reserve(self, nbytes: int, tag: str = "operator") -> None:
        self._ctx.reserve(nbytes, tag, device=self.shard)

    def free(self, nbytes: int, tag: str = "operator") -> None:
        self._ctx.free(nbytes, tag, device=self.shard)

    def __getattr__(self, name):
        return getattr(self._ctx, name)


class ShardExecutionPlanner(LocalExecutionPlanner):
    """One distributed 'task': the local operator pipelines, executing
    shard `shard` of `n_shards` on the shard's device
    (execution/SqlTaskExecution.java analog). Differences from local
    execution:
      - leaf scans read only this shard's splits (split.part % n == shard),
        from a page source on the shard's device;
      - RemoteSourceNodes read the post-exchange page staged for this
        shard;
      - VALUES (SINGLE-distribution leaves) materialize on shard 0 only;
      - PARTIAL/FINAL aggregation steps execute as written (the exchange
        sits between them);
      - unique ids are disjoint across shards (the shard in bits 44 up).
    """

    def __init__(self, metadata: Metadata, session: Session, shard: int,
                 n_shards: int,
                 exchange_inputs: Dict[int, List[Optional[Page]]],
                 device, memory: QueryMemoryContext, page_sources=None):
        super().__init__(metadata, session, device)
        # the query's ledger is shared by every shard's executor
        self.memory.close()
        self.memory = ShardMemory(memory, shard)
        self.shard = shard
        self.n_shards = n_shards
        self.exchange_inputs = exchange_inputs
        self.page_sources = page_sources or {}

    # ------------------------------------------------------------- leaves

    def _exec_TableScanNode(self, node: TableScanNode) -> PageStream:
        conn = self.metadata.connector(node.catalog)
        columns = [c for _, c in node.assignments]
        symbols = tuple(s for s, _ in node.assignments)
        splits = conn.split_manager.get_splits(node.table,
                                               target_splits=self.n_shards)
        mine = [s for s in splits if s.part % self.n_shards == self.shard]
        cap = split_scan_capacity(self.session, conn, node, splits)
        source = self.page_sources.get((node.catalog, str(self.device)),
                                       conn.page_source)

        def gen():
            for split in mine:
                self._fault_site("scan", f"{node.table} part {split.part}")
                for page in source.pages(split, columns, cap):
                    self._checkpoint()
                    yield page
        return PageStream(gen(), symbols)

    def _exec_ValuesNode(self, node: ValuesNode) -> PageStream:
        if self.shard != 0:
            return PageStream(iter(()), node.symbols)
        return super()._exec_ValuesNode(node)

    def _exec_RemoteSourceNode(self, node: RemoteSourceNode) -> PageStream:
        pages = self.exchange_inputs.get(node.fragment_id)
        page = None if pages is None else pages[self.shard]
        if page is None:
            return PageStream(iter(()), node.symbols)
        return PageStream(iter([page]), node.symbols)

    # -------------------------------------------------------- aggregation

    def _exec_AggregationNode(self, node: AggregationNode) -> PageStream:
        if node.step == AggStep.SINGLE:
            return super()._exec_AggregationNode(node)
        if node.step == AggStep.PARTIAL:
            return self._exec_partial_agg(node)
        return self._exec_final_agg(node)

    @staticmethod
    def agg_specs(node: AggregationNode, lay) -> List[AggSpec]:
        specs = []
        for _, call in node.aggregations:
            input_ch = in_type = None
            if call.args:
                input_ch = lay[call.args[0].name] if lay else None
                in_type = call.input_type
            in2_ch = in2_type = None
            if len(call.args) > 1 and lay:
                arg2 = call.args[1]
                in2_ch, in2_type = lay[arg2.name], arg2.type
            mask_ch = None
            if call.filter is not None:
                mask_ch = lay[call.filter.name]
            specs.append(AggSpec(call.name, input_ch, in_type, mask_ch,
                                 call.distinct, in2_ch, in2_type))
        return specs

    def _exec_partial_agg(self, node: AggregationNode) -> PageStream:
        src = self.execute(node.source)
        lay, _ = _layout(src.symbols)
        key_channels = tuple(lay[s.name] for s in node.group_by)
        specs = tuple(self.agg_specs(node, lay))
        partial_op = compose_chain(
            src.pending, ("agg-partial", key_channels, specs),
            lambda: hash_aggregate(list(key_channels), list(specs),
                                   Step.PARTIAL))

        def gen():
            for page in src.pages:
                yield partial_op(page)
        return PageStream(gen(), node.outputs)

    def _exec_final_agg(self, node: AggregationNode) -> PageStream:
        src = self.execute(node.source)
        specs = tuple(self.agg_specs(node, None))
        nkeys = len(node.group_by)
        state_channels = []
        ch = nkeys
        for spec in specs:
            k = len(get_aggregate(spec.name, spec.input_type)
                    .state(spec.input_type))
            state_channels.append(list(range(ch, ch + k)))
            ch += k
        final_op = cached_kernel(
            ("agg-final", nkeys, specs),
            lambda: hash_aggregate(list(range(nkeys)), list(specs),
                                   Step.FINAL, state_channels))

        def gen():
            page = self._collect(src)
            if page is None:
                if not node.group_by:
                    yield self._empty_global_agg(node)
                return
            try:
                yield final_op(page)
            finally:
                self._free_collected(page)
        return PageStream(gen(), node.outputs)

    # ------------------------------------------------------------- unique

    def _exec_AssignUniqueIdNode(self, node) -> PageStream:
        stream = super()._exec_AssignUniqueIdNode(node)
        if self.shard == 0:
            return stream
        base = self.shard << 44

        def gen():
            for page in stream.iter_pages():
                col = page.columns[-1]
                shifted = Column(col.values + base, col.valid, col.type,
                                 None)
                yield Page(page.columns[:-1] + (shifted,), page.num_rows)
        return PageStream(gen(), stream.symbols)


class DistributedQueryRunner(LocalQueryRunner):
    """Multi-shard engine over a QueryMesh (testing/
    DistributedQueryRunner.java:72): the same SQL surface as
    LocalQueryRunner; SELECT queries plan with `distributed=True`,
    fragment at REMOTE exchanges and run stage by stage over the mesh;
    session statements, SHOW and EXPLAIN run through the local path.

    `devices` lists each shard's device and may repeat one (["cpu"] * 8
    runs eight shards on the CPU, ["cuda:0"] * 8 eight on one card);
    None takes every visible CUDA device and raises without one."""

    def __init__(self, session: Optional[Session] = None,
                 devices: Optional[Sequence] = None):
        self.mesh = QueryMesh(devices)
        super().__init__(session, device=self.mesh.device_of(0))
        # each shard's pool budget from its card's memory (a share of it
        # where shards share a card); the CPU keeps no budget
        autosize_node_pool(self.mesh.devices)
        # one page source per (catalog, device): each shard scans on its
        # own device
        self.page_sources: Dict[Tuple[str, str], object] = {}
        # one dict per exchange of the last query: fragment, kind, data
        # plane (fused/staged), rows, bytes, the repartition's bucket and,
        # on the skewed pair, the heavy keys
        self.last_exchanges: List[dict] = []

    @classmethod
    def tpch(cls, schema: str = "tiny", devices: Optional[Sequence] = None
             ) -> "DistributedQueryRunner":
        """Runner over the TPC-H and TPC-DS catalogs, as
        LocalQueryRunner.tpch; every shard device gets its own page
        sources (tables generated on that device)."""
        from trino_tpu_torch.connector import tpcds, tpch
        runner = cls(Session(catalog="tpch", schema=schema), devices)
        runner.catalogs.register("tpch", tpch.create_connector(runner.device))
        runner.catalogs.register("tpcds",
                                 tpcds.create_connector(runner.device))
        for dev in dict.fromkeys(str(d) for d in runner.mesh.devices):
            runner.page_sources[("tpch", dev)] = tpch.create_connector(
                dev).page_source
            runner.page_sources[("tpcds", dev)] = tpcds.create_connector(
                dev).page_source
        return runner

    # ------------------------------------------------------------ execute

    def execute(self, sql: str) -> MaterializedResult:
        stmt = parse_statement(sql)
        if isinstance(stmt, t.Query):
            self._check_services()
            return self._execute_query(stmt)
        return super().execute(sql)

    def _plan_for_execution(self, query: t.Statement) -> OutputNode:
        plan = LogicalPlanner(self.metadata, self.session).plan(query)
        return optimize(plan, self.metadata, self.session, distributed=True)

    def _execute_query(self, query: t.Query) -> MaterializedResult:
        plan = self._plan_for_execution(query)
        frag = fragment_plan(plan)
        self._memory = QueryMemoryContext(
            int(self.session.get("query_max_memory")), pool=NODE_POOL)
        self._executors: List[ShardExecutionPlanner] = []
        self._mesh_executors: List[ShardExecutionPlanner] = []
        self._stats = dict.fromkeys(QUERY_COUNTERS, 0)
        self._stats["mesh_devices"] = self.mesh.n
        self.last_exchanges = []
        try:
            # children schedule before the root's scope opens
            exchange_inputs = self._schedule_children(frag)
            return self._retry_task(
                "fragment-root",
                lambda: self._root_attempt(frag, plan, exchange_inputs))
        finally:
            self._finish_query()

    def _finish_query(self) -> None:
        stats = self._stats
        joins, lists = [], []
        windows = WindowLog()
        for ex in self._executors:
            co_scheduled = ex in self._mesh_executors
            for k, v in ex.stats.items():
                # a co-scheduled join counts its mxu use once per site
                # (mesh_exec._mxu_aux), not once per shard
                if co_scheduled and k in ("mxu_joins", "mxu_flops"):
                    continue
                stats[k] += v
            joins += [dict(j, shard=ex.shard) for j in ex.joins]
            windows.extend(ex.windows)
            windows.pending += ex.windows.pending
            lists += ex.lists
        self.last_query_stats = stats
        self.last_joins = joins
        self._last_windows = windows
        self.last_lists = lists
        leaked = self._memory.close()
        if leaked:
            NODE_POOL.record_leak(leaked)

    def executor(self, shard: int, exchange_inputs,
                 mesh: bool = False) -> ShardExecutionPlanner:
        ex = ShardExecutionPlanner(
            self.metadata, self.session, shard, self.mesh.n, exchange_inputs,
            self.mesh.device_of(shard), self._memory, self.page_sources)
        self._executors.append(ex)
        if mesh:
            self._mesh_executors.append(ex)
        return ex

    def _root_attempt(self, frag: PlanFragment, plan: OutputNode,
                      exchange_inputs) -> MaterializedResult:
        self._check_deadline(self._memory)
        executor = self.executor(0, exchange_inputs)
        types = [s.type for s in plan.symbols]
        rows = []
        for page in executor.execute(frag.root).iter_pages():
            self._check_deadline(self._memory)
            n = int(page.num_rows)
            if n == 0:
                continue
            rows.extend(zip(*(column_values(c, typ) for c, typ in
                              zip(page.to_host(n), types))))
        return MaterializedResult(list(plan.column_names), types, rows,
                                  row_count=len(rows))

    # --------------------------------------------------------- scheduling

    def _schedule_children(self, frag: PlanFragment
                           ) -> Dict[int, List[Optional[Page]]]:
        """Run every child fragment and apply its consuming exchange;
        build before probe: later sources (a join's build side is the
        second child) schedule first (PhasedExecutionSchedule). Eligible
        child chains run co-scheduled first (exec/mesh_exec.py)."""
        exchange_inputs: Dict[int, List[Optional[Page]]] = {}
        for child in reversed(frag.children):
            remote = _find_remote(frag.root, child.fragment_id)
            mesh_pages = self._try_mesh_child(child, remote)
            if mesh_pages is not None:
                exchange_inputs[child.fragment_id] = mesh_pages
                continue
            child_pages = self._run_fragment_to_pages(child)
            exchange_inputs[child.fragment_id] = self._retry_task(
                f"exchange-{child.fragment_id}",
                lambda p=child_pages, r=remote: self._apply_exchange(p, r))
        return exchange_inputs

    def _try_mesh_child(self, child: PlanFragment, remote
                        ) -> Optional[List[Optional[Page]]]:
        """The co-scheduled chain of one child fragment, or None for the
        dispatch-loop fallback (a chain with a node the mesh path does not
        lower, or one shard)."""
        if not bool(self.session.get("mesh_execution")) or self.mesh.n < 2:
            return None
        from trino_tpu_torch.exec import mesh_exec
        try:
            return mesh_exec.run_co_scheduled(self, child, remote)
        except (mesh_exec.MeshUnsupported, NotImplementedError):
            return None

    def _run_fragment_to_pages(self, frag: PlanFragment
                               ) -> List[Optional[Page]]:
        exchange_inputs = self._schedule_children(frag)
        return self._retry_task(
            f"fragment-{frag.fragment_id}",
            lambda: self._fragment_attempt(frag, exchange_inputs))

    def _fragment_attempt(self, frag: PlanFragment, exchange_inputs
                          ) -> List[Optional[Page]]:
        """Every participating shard's pipelines, dispatched in shard order
        (each shard's kernels queue on its device's stream), then each
        shard's output merged into one page after ONE batched count
        fetch."""
        self._check_deadline(self._memory)
        shards = [0] if frag.partitioning == "single" else \
            list(range(self.mesh.n))
        produced = []
        for shard in shards:
            self._check_deadline(self._memory)
            ex = self.executor(shard, exchange_inputs)
            produced.append((shard, list(ex.execute(frag.root).iter_pages())))
        out: List[Optional[Page]] = [None] * self.mesh.n
        merged, _ = merge_shard_pages([pages for _, pages in produced])
        for (shard, _), page in zip(produced, merged):
            out[shard] = page
        return out

    # ------------------------------------------------------ exchange plane

    def _apply_exchange(self, child_pages: List[Optional[Page]],
                        remote: RemoteSourceNode) -> List[Optional[Page]]:
        self._check_deadline(self._memory)
        n = self.mesh.n
        live = [p for p in child_pages if p is not None]
        # 'staged' data plane: the producer ran through the per-shard loop
        # and its outputs are re-staged for a standalone collective; one
        # batched count fetch
        counts = fetch_counts([p.num_rows for p in live])
        rows = sum(counts)
        nbytes = sum(live_page_bytes(p, c) for p, c in zip(live, counts))
        self._record_exchange(remote, "staged", rows, nbytes)
        ref = live[0] if live else None
        if ref is None:
            return [None] * n
        pages = normalize_pages([empty_like(ref) if p is None else p
                                 for p in child_pages])
        if remote.kind == ExchangeKind.REPARTITION:
            lay = {s.name: i for i, s in enumerate(remote.symbols)}
            keys = [lay[s.name] for s in remote.partition_keys]
            cap = pages[0].capacity
            out, _ = all_to_all_by_key(pages, keys, staged_ladder(cap, n))
            self.last_exchanges[-1]["bucket"] = out[0].capacity // n
            return out
        out = broadcast_page(pages)
        if remote.kind == ExchangeKind.MERGE and remote.order_by:
            out = merge_sort(out, remote)
        return out

    def _record_exchange(self, remote: RemoteSourceNode, plane: str,
                         rows: int, nbytes: int, **extra) -> None:
        self._stats["exchanges_fused" if plane == "fused"
                    else "exchanges_staged"] += 1
        self._stats["exchange_rows"] += int(rows)
        self._stats["exchange_bytes"] += int(nbytes)
        entry = {"fragment": remote.fragment_id,
                 "kind": str(remote.kind).rsplit(".", 1)[-1],
                 "plane": plane, "rows": int(rows), "bytes": int(nbytes)}
        entry.update(extra)
        self.last_exchanges.append(entry)


# ---------------------------------------------------------------------------
# page plumbing for the collective data plane


def staged_ladder(cap: int, n: int):
    """The dispatch loop's bucket ladder as a function of the largest
    source -> destination count: start at max(1024, next_pow2(cap // n)),
    double while a source overflows, stop at cap (a source never sends
    more than cap rows to one peer)."""
    def ladder(largest: int) -> int:
        bucket = max(1024, _next_pow2(max(1, cap // n)))
        while largest > bucket:
            bucket *= 2
            if bucket > cap:
                return cap
        return bucket
    return ladder


def merge_sort(pages: List[Page], remote: RemoteSourceNode) -> List[Page]:
    """MERGE: the gathered rows re-sorted (K10), once per replica."""
    lay = {s.name: i for i, s in enumerate(remote.symbols)}
    sort_keys = tuple(SortKey(lay[o.symbol.name], o.ascending,
                              o.nulls_first) for o in remote.order_by)
    sort_op = cached_kernel(("merge-sort", sort_keys),
                            lambda: order_by(list(sort_keys)))
    done: Dict[int, Page] = {}
    return [done.setdefault(id(p), sort_op(p)) for p in pages]


def fetch_counts(counts: List[torch.Tensor]) -> List[int]:
    """Host values of device row counts: one transfer per device."""
    by_dev: Dict[torch.device, List[int]] = {}
    for i, c in enumerate(counts):
        by_dev.setdefault(c.device, []).append(i)
    out = [0] * len(counts)
    for idx in by_dev.values():
        for i, v in zip(idx, torch.stack([counts[i] for i in idx]).tolist()):
            out[i] = int(v)
    return out


def merge_shard_pages(per_shard: List[List[Page]], tight: bool = True
                      ) -> Tuple[List[Optional[Page]], List[int]]:
    """Each shard's pages concatenated on its device (K2) after one
    batched count fetch for all shards, and each shard's live rows. With
    `tight` each page first shrinks to its live pow2 envelope
    (LocalExecutionPlanner.merge_counted_rows); without, a shard's single
    page keeps its capacity (a co-scheduled stage's pages keep the
    capacities the reference's program gives them)."""
    flat = [p for pages in per_shard for p in pages]
    counts = iter(fetch_counts([p.num_rows for p in flat]))
    out: List[Optional[Page]] = []
    totals: List[int] = []
    shrink = LocalExecutionPlanner._tight if tight else (lambda p, c: p)
    for pages in per_shard:
        cs = [next(counts) for _ in pages]
        total = sum(cs)
        totals.append(total)
        if total == 0 and (tight or not pages):
            out.append(None)
            continue
        live = [shrink(p, c) for p, c in zip(pages, cs) if c > 0 or not tight]
        page = live[0] if len(live) == 1 else device_concat(live)
        out.append(shrink(page, total))
    return out, totals


def split_scan_capacity(session, conn, node: TableScanNode, splits) -> int:
    """Scan page capacity for a sharded split set: the session page floor,
    grown to the per-split row envelope up to scan_page_capacity. Shared
    by the dispatch loop and the mesh staging, so both data planes size
    identical pages for the same query."""
    cap = int(session.get("page_capacity"))
    stats = conn.metadata.get_table_statistics(node.table)
    rows = int(stats.row_count) if stats and stats.row_count else 0
    per_split = math.ceil(rows / max(1, len(splits)))
    if per_split > cap:
        cap = min(_next_pow2(per_split),
                  int(session.get("scan_page_capacity")))
    return cap


def _find_remote(node, fragment_id: int) -> Optional[RemoteSourceNode]:
    if isinstance(node, RemoteSourceNode) and node.fragment_id == fragment_id:
        return node
    for s in node.sources:
        found = _find_remote(s, fragment_id)
        if found is not None:
            return found
    return None
