"""Logical plan nodes (symbol-based IR).

Reference parity: core/trino-main sql/planner/plan/ (57 node classes:
TableScanNode, FilterNode, ProjectNode, AggregationNode, JoinNode,
SemiJoinNode, ExchangeNode, SortNode, TopNNode, LimitNode, ValuesNode,
OutputNode, UnionNode, WindowNode, TableWriterNode, ...). Plans are immutable
dataclass trees; expressions inside are expr.ir.RowExpression with SymbolRef
leaves; LocalExecutionPlanner lowers symbols to page channels.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Sequence, Tuple

from trino_tpu_torch import types as T
from trino_tpu_torch.expr.ir import RowExpression, SymbolRef
from trino_tpu_torch.connector.spi import ColumnHandle, ConnectorTableHandle

_D = dataclasses.dataclass(frozen=True)


@_D
class Symbol:
    """sql/planner/Symbol.java — a named, typed plan column."""

    name: str
    type: T.Type

    def ref(self) -> SymbolRef:
        return SymbolRef(self.name, self.type)

    def __str__(self):
        return f"{self.name}:{self.type.display()}"


class SymbolAllocator:
    """sql/planner/SymbolAllocator.java — unique symbol names per plan."""

    def __init__(self):
        self._counter = itertools.count()
        self.types: Dict[str, T.Type] = {}

    def new(self, hint: str, typ: T.Type) -> Symbol:
        base = "".join(ch if ch.isalnum() or ch == "_" else "_"
                       for ch in hint.lower()) or "expr"
        name = f"{base}_{next(self._counter)}"
        self.types[name] = typ
        return Symbol(name, typ)


class PlanNode:
    id: int

    @property
    def sources(self) -> Tuple["PlanNode", ...]:
        return ()

    @property
    def outputs(self) -> Tuple[Symbol, ...]:
        raise NotImplementedError

    def with_sources(self, sources: Sequence["PlanNode"]) -> "PlanNode":
        """Structural rebuild with new children (rule-engine rewriting)."""
        raise NotImplementedError

    def node_name(self) -> str:
        return type(self).__name__.replace("Node", "")


_ids = itertools.count()


def _node(cls):
    cls = dataclasses.dataclass(frozen=True, eq=False)(cls)
    orig_init = cls.__init__

    def __init__(self, *args, **kwargs):
        orig_init(self, *args, **kwargs)
        object.__setattr__(self, "id", next(_ids))

    cls.__init__ = __init__
    return cls


@_node
class TableScanNode(PlanNode):
    """plan/TableScanNode.java — leaf scan with pushed-down handle state."""

    catalog: str
    table: ConnectorTableHandle
    assignments: Tuple[Tuple[Symbol, ColumnHandle], ...]  # output -> column

    @property
    def outputs(self):
        return tuple(s for s, _ in self.assignments)

    def with_sources(self, sources):
        assert not sources
        return self


@_node
class ValuesNode(PlanNode):
    """plan/ValuesNode.java — inline literal rows."""

    symbols: Tuple[Symbol, ...]
    rows: Tuple[Tuple[RowExpression, ...], ...]  # literal expressions

    @property
    def outputs(self):
        return self.symbols

    def with_sources(self, sources):
        assert not sources
        return self


@_node
class FilterNode(PlanNode):
    source: PlanNode
    predicate: RowExpression

    @property
    def sources(self):
        return (self.source,)

    @property
    def outputs(self):
        return self.source.outputs

    def with_sources(self, sources):
        return FilterNode(sources[0], self.predicate)


@_node
class ProjectNode(PlanNode):
    """plan/ProjectNode.java — assignments: output symbol -> expression."""

    source: PlanNode
    assignments: Tuple[Tuple[Symbol, RowExpression], ...]

    @property
    def sources(self):
        return (self.source,)

    @property
    def outputs(self):
        return tuple(s for s, _ in self.assignments)

    def with_sources(self, sources):
        return ProjectNode(sources[0], self.assignments)

    def is_identity(self) -> bool:
        return all(isinstance(e, SymbolRef) and e.name == s.name
                   for s, e in self.assignments)


@_D
class AggCall:
    """One aggregate in an AggregationNode (AggregationNode.Aggregation)."""

    name: str                              # registry name: sum/count/...
    args: Tuple[RowExpression, ...]        # SymbolRefs after planning
    distinct: bool = False
    filter: Optional[RowExpression] = None  # boolean SymbolRef
    input_type: Optional[T.Type] = None


class AggStep:
    """AggregationNode.Step — partial produces raw state, final merges it."""

    SINGLE = "single"
    PARTIAL = "partial"
    FINAL = "final"


@_node
class AggregationNode(PlanNode):
    source: PlanNode
    group_by: Tuple[Symbol, ...]
    aggregations: Tuple[Tuple[Symbol, AggCall], ...]
    step: str = AggStep.SINGLE
    # adaptive-strategy hints (optimizer.annotate_adaptive_hints): CBO
    # estimated input rows + group NDV. The executor's AggModeController
    # (exec/adaptive.py) picks its INITIAL partial-aggregation mode from
    # the ratio and re-decides at runtime from the OBSERVED reduction.
    rows_estimate: Optional[float] = None
    ndv_estimate: Optional[float] = None
    # grouping sets support: group id symbol when multiple sets (GroupIdNode
    # is planned separately; single set here)

    @property
    def sources(self):
        return (self.source,)

    @property
    def outputs(self):
        if self.step == AggStep.PARTIAL:
            # a PARTIAL aggregation emits raw accumulator state columns
            # (avg -> sum+count, ...) — the layout the exchange ships and
            # the FINAL side consumes positionally (reference:
            # AggregationNode intermediate symbols +
            # PushPartialAggregationThroughExchange.java)
            from trino_tpu_torch.ops.aggregate import get_aggregate
            syms = list(self.group_by)
            for s, call in self.aggregations:
                fn = get_aggregate(call.name, call.input_type)
                for i, st in enumerate(fn.state(call.input_type)):
                    syms.append(Symbol(f"{s.name}$state{i}", st.type))
            return tuple(syms)
        return self.group_by + tuple(s for s, _ in self.aggregations)

    def with_sources(self, sources):
        return AggregationNode(sources[0], self.group_by, self.aggregations,
                               self.step, self.rows_estimate,
                               self.ndv_estimate)


@_node
class GroupIdNode(PlanNode):
    """plan/GroupIdNode.java — replicates rows per grouping set with a
    group-id symbol (GROUPING SETS / ROLLUP / CUBE lowering)."""

    source: PlanNode
    grouping_sets: Tuple[Tuple[Symbol, ...], ...]
    group_id_symbol: Symbol
    # symbols not in any grouping set that aggregate args still need
    passthrough: Tuple[Symbol, ...]

    @property
    def sources(self):
        return (self.source,)

    @property
    def outputs(self):
        all_group = tuple(dict.fromkeys(
            s for gs in self.grouping_sets for s in gs))
        return all_group + self.passthrough + (self.group_id_symbol,)

    def with_sources(self, sources):
        return GroupIdNode(sources[0], self.grouping_sets,
                           self.group_id_symbol, self.passthrough)


class JoinKind:
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    FULL = "full"
    CROSS = "cross"


@_D
class JoinClause:
    left: Symbol
    right: Symbol


class JoinDistribution:
    """JoinNode.DistributionType — chosen by the optimizer."""

    AUTO = "auto"
    PARTITIONED = "partitioned"
    REPLICATED = "replicated"  # broadcast build side


@_node
class JoinNode(PlanNode):
    kind: str
    left: PlanNode
    right: PlanNode
    criteria: Tuple[JoinClause, ...]
    filter: Optional[RowExpression] = None   # non-equi residual
    distribution: str = JoinDistribution.AUTO
    # PruneJoinColumns analog (iterative/rule/PruneJoinColumns.java): when
    # set, only these symbols (a subset of left+right outputs, in that
    # order) are emitted — the executor then skips the build-column gathers
    # for dropped channels, the hot cost of wide fact-to-dim joins
    output_symbols: Optional[Tuple[Symbol, ...]] = None
    # adaptive-strategy hint (optimizer.annotate_adaptive_hints): CBO
    # estimated build rows / build-key NDV — the average duplication of
    # the build side. >2 pre-routes an over-threshold build to the
    # partitioned hybrid join (exec/local_planner._run_partitioned_inner)
    # without paying the unique-probe prep; the runtime observation
    # (`is_unique` from prepare) still re-decides when the estimate is
    # missing or wrong.
    build_skew_estimate: Optional[float] = None
    # plan-time probe-strategy candidate (optimizer.annotate_adaptive_
    # hints): 'mxu-matmul' = eligible for the density-partitioned
    # indicator-matmul probe on the matrix unit (ops/join_mxu.py),
    # 'gather' = the classic dense-gather/searchsorted path. EXPLAIN
    # prints it; the executor's runtime router (exec/local_planner.
    # _prepare_probe) re-decides from the OBSERVED key density, so
    # `mxu_joins` on the query stats reports what actually ran.
    join_strategy: Optional[str] = None

    @property
    def sources(self):
        return (self.left, self.right)

    @property
    def outputs(self):
        if self.output_symbols is not None:
            return self.output_symbols
        return self.left.outputs + self.right.outputs

    def with_sources(self, sources):
        return JoinNode(self.kind, sources[0], sources[1], self.criteria,
                        self.filter, self.distribution, self.output_symbols,
                        self.build_skew_estimate, self.join_strategy)


@_node
class UnnestNode(PlanNode):
    """UNNEST over list-layout columns (plan/UnnestNode.java +
    operator/unnest/UnnestOperator.java, re-cut for static shapes: the
    executor expands via the same counts->cumsum->searchsorted machinery
    as join expansion). `elements` has one output symbol per ARRAY input
    and (key, value) for a MAP input; replicated columns are the
    source's outputs."""

    source: PlanNode
    arrays: Tuple[Symbol, ...]
    elements: Tuple[Tuple[Symbol, ...], ...]
    ordinality: "Optional[Symbol]" = None

    @property
    def sources(self):
        return (self.source,)

    @property
    def outputs(self):
        flat = tuple(s for group in self.elements for s in group)
        ordi = (self.ordinality,) if self.ordinality is not None else ()
        return self.source.outputs + flat + ordi

    def with_sources(self, sources):
        return UnnestNode(sources[0], self.arrays, self.elements,
                          self.ordinality)


@_node
class SemiJoinNode(PlanNode):
    """plan/SemiJoinNode.java — emits source rows + match flag symbol.

    Composite keys supported (correlated-EXISTS decorrelation emits one
    clause per correlation equality)."""

    source: PlanNode
    filtering_source: PlanNode
    source_keys: Tuple[Symbol, ...]
    filtering_keys: Tuple[Symbol, ...]
    match_symbol: Symbol  # boolean output
    negate: bool = False  # True -> NOT IN / NOT EXISTS consumed as anti
    # IN-subquery 3VL (NULL key or NULL in build -> UNKNOWN membership) vs
    # EXISTS semantics (NULL correlation keys just never match); see
    # ops/join.py hash_join(null_aware=...)
    null_aware: bool = True
    # plan-time probe-strategy candidate (see JoinNode.join_strategy)
    join_strategy: Optional[str] = None

    @property
    def sources(self):
        return (self.source, self.filtering_source)

    @property
    def outputs(self):
        return self.source.outputs + (self.match_symbol,)

    def with_sources(self, sources):
        return SemiJoinNode(sources[0], sources[1], self.source_keys,
                            self.filtering_keys, self.match_symbol,
                            self.negate, self.null_aware,
                            self.join_strategy)


@_D
class Ordering:
    symbol: Symbol
    ascending: bool = True
    nulls_first: bool = False


@_node
class SortNode(PlanNode):
    source: PlanNode
    order_by: Tuple[Ordering, ...]

    @property
    def sources(self):
        return (self.source,)

    @property
    def outputs(self):
        return self.source.outputs

    def with_sources(self, sources):
        return SortNode(sources[0], self.order_by)


@_node
class TopNNode(PlanNode):
    source: PlanNode
    count: int
    order_by: Tuple[Ordering, ...]
    step: str = "single"  # single | partial | final

    @property
    def sources(self):
        return (self.source,)

    @property
    def outputs(self):
        return self.source.outputs

    def with_sources(self, sources):
        return TopNNode(sources[0], self.count, self.order_by, self.step)


@_node
class LimitNode(PlanNode):
    source: PlanNode
    count: int
    partial: bool = False

    @property
    def sources(self):
        return (self.source,)

    @property
    def outputs(self):
        return self.source.outputs

    def with_sources(self, sources):
        return LimitNode(sources[0], self.count, self.partial)


@_node
class OffsetNode(PlanNode):
    source: PlanNode
    count: int

    @property
    def sources(self):
        return (self.source,)

    @property
    def outputs(self):
        return self.source.outputs

    def with_sources(self, sources):
        return OffsetNode(sources[0], self.count)


@_node
class DistinctLimitNode(PlanNode):
    source: PlanNode
    count: int

    @property
    def sources(self):
        return (self.source,)

    @property
    def outputs(self):
        return self.source.outputs

    def with_sources(self, sources):
        return DistinctLimitNode(sources[0], self.count)


@_node
class UnionNode(PlanNode):
    """plan/UnionNode.java — outputs map per-child input symbols."""

    children: Tuple[PlanNode, ...]
    symbols: Tuple[Symbol, ...]
    # mappings[i][j] = child j's symbol feeding output symbol i
    mappings: Tuple[Tuple[Symbol, ...], ...]

    @property
    def sources(self):
        return self.children

    @property
    def outputs(self):
        return self.symbols

    def with_sources(self, sources):
        return UnionNode(tuple(sources), self.symbols, self.mappings)


@_D
class WindowFunction:
    name: str
    args: Tuple[RowExpression, ...]
    frame_type: str = "RANGE"
    start_type: str = "UNBOUNDED_PRECEDING"
    start_value: Optional[RowExpression] = None
    end_type: str = "CURRENT_ROW"
    end_value: Optional[RowExpression] = None


@_node
class WindowNode(PlanNode):
    source: PlanNode
    partition_by: Tuple[Symbol, ...]
    order_by: Tuple[Ordering, ...]
    functions: Tuple[Tuple[Symbol, WindowFunction], ...]

    @property
    def sources(self):
        return (self.source,)

    @property
    def outputs(self):
        return self.source.outputs + tuple(s for s, _ in self.functions)

    def with_sources(self, sources):
        return WindowNode(sources[0], self.partition_by, self.order_by,
                          self.functions)


@_node
class AssignUniqueIdNode(PlanNode):
    source: PlanNode
    id_symbol: Symbol

    @property
    def sources(self):
        return (self.source,)

    @property
    def outputs(self):
        return self.source.outputs + (self.id_symbol,)

    def with_sources(self, sources):
        return AssignUniqueIdNode(sources[0], self.id_symbol)


@_node
class EnforceSingleRowNode(PlanNode):
    """Scalar subquery guard: error if source has > 1 row, null-extend if 0."""

    source: PlanNode

    @property
    def sources(self):
        return (self.source,)

    @property
    def outputs(self):
        return self.source.outputs

    def with_sources(self, sources):
        return EnforceSingleRowNode(sources[0])


class ExchangeScope:
    REMOTE = "remote"  # across the mesh (collective)
    LOCAL = "local"    # intra-stage


class ExchangeKind:
    GATHER = "gather"          # N -> 1 (SINGLE distribution)
    REPARTITION = "repartition"  # hash all_to_all
    BROADCAST = "broadcast"    # all_gather replicate
    MERGE = "merge"            # ordered gather


@_node
class ExchangeNode(PlanNode):
    """plan/ExchangeNode.java — on TPU this lowers to mesh collectives:
    REPARTITION -> all_to_all by key hash, BROADCAST -> all_gather,
    GATHER -> single-shard collect (SURVEY §2.11)."""

    source: PlanNode
    scope: str
    kind: str
    partition_keys: Tuple[Symbol, ...] = ()
    order_by: Tuple[Ordering, ...] = ()  # for MERGE

    @property
    def sources(self):
        return (self.source,)

    @property
    def outputs(self):
        return self.source.outputs

    def with_sources(self, sources):
        return ExchangeNode(sources[0], self.scope, self.kind,
                            self.partition_keys, self.order_by)


@_node
class OutputNode(PlanNode):
    """plan/OutputNode.java — query root: result column names + symbols."""

    source: PlanNode
    column_names: Tuple[str, ...]
    symbols: Tuple[Symbol, ...]

    @property
    def sources(self):
        return (self.source,)

    @property
    def outputs(self):
        return self.symbols

    def with_sources(self, sources):
        return OutputNode(sources[0], self.column_names, self.symbols)


@_node
class TableWriterNode(PlanNode):
    """plan/TableWriterNode.java — append pages to a connector sink."""

    source: PlanNode
    catalog: str
    table: ConnectorTableHandle
    column_symbols: Tuple[Symbol, ...]
    rows_symbol: Symbol

    @property
    def sources(self):
        return (self.source,)

    @property
    def outputs(self):
        return (self.rows_symbol,)

    def with_sources(self, sources):
        return TableWriterNode(sources[0], self.catalog, self.table,
                               self.column_symbols, self.rows_symbol)


def visit_plan(node: PlanNode):
    """Pre-order traversal."""
    yield node
    for s in node.sources:
        yield from visit_plan(s)


def format_plan(node: PlanNode, indent: int = 0, annotate=None) -> str:
    """Plan printer (sql/planner/planprinter/PlanPrinter.java, text mode).

    `annotate(node) -> str` appends per-node runtime stats lines — the
    EXPLAIN ANALYZE rendering (PlanPrinter.textDistributedPlan with
    operator stats)."""
    pad = "   " * indent
    detail = ""
    if isinstance(node, TableScanNode):
        detail = f"[{node.catalog}.{node.table.name}]"
    elif isinstance(node, FilterNode):
        detail = f"[{node.predicate}]"
    elif isinstance(node, ProjectNode):
        detail = "[" + ", ".join(f"{s.name} := {e}"
                                 for s, e in node.assignments) + "]"
    elif isinstance(node, AggregationNode):
        aggs = ", ".join(f"{s.name} := {a.name}({', '.join(map(str, a.args))})"
                         for s, a in node.aggregations)
        keys = ", ".join(s.name for s in node.group_by)
        detail = f"[{node.step}; keys=({keys}); {aggs}]"
    elif isinstance(node, JoinNode):
        crit = " AND ".join(f"{c.left.name} = {c.right.name}"
                            for c in node.criteria)
        detail = f"[{node.kind}; {crit or 'cross'}; {node.distribution}]"
        if node.join_strategy is not None:
            detail = detail[:-1] + \
                f"; join strategy: {node.join_strategy}]"
    elif isinstance(node, SemiJoinNode):
        sk = ", ".join(s.name for s in node.source_keys)
        fk = ", ".join(s.name for s in node.filtering_keys)
        detail = f"[({sk}) IN ({fk}) -> {node.match_symbol.name}]"
        if node.join_strategy is not None:
            detail = detail[:-1] + \
                f"; join strategy: {node.join_strategy}]"
    elif isinstance(node, (SortNode, TopNNode)):
        keys = ", ".join(
            o.symbol.name + ("" if o.ascending else " DESC")
            for o in node.order_by)
        cnt = f" limit={node.count}" if isinstance(node, TopNNode) else ""
        detail = f"[{keys}{cnt}]"
    elif isinstance(node, LimitNode):
        detail = f"[{node.count}{' partial' if node.partial else ''}]"
    elif isinstance(node, ExchangeNode):
        keys = ", ".join(s.name for s in node.partition_keys)
        detail = f"[{node.scope} {node.kind} ({keys})]"
    elif isinstance(node, OutputNode):
        detail = "[" + ", ".join(node.column_names) + "]"
    elif isinstance(node, ValuesNode):
        detail = f"[{len(node.rows)} rows]"
    elif isinstance(node, GroupIdNode):
        detail = f"[{len(node.grouping_sets)} sets]"
    lines = [f"{pad}- {node.node_name()}{detail}"]
    if annotate is not None:
        extra = annotate(node)
        if extra:
            lines.append(f"{pad}     {extra}")
    for s in node.sources:
        lines.append(format_plan(s, indent + 1, annotate))
    return "\n".join(lines)
