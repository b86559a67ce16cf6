"""Plan optimizer: rewrite rules + exchange placement + fragmenter.

Reference parity: sql/planner/PlanOptimizers.java (the ~60-pass pipeline) with
the rules that carry TPC-H/DS (SURVEY.md §2.3):
- predicate pushdown incl. cross-join -> inner-join criteria extraction
  (optimizations/PredicatePushDown.java + EliminateCrossJoins intent)
- projection/column pruning (PruneUnreferencedOutputs)
- identity-projection removal, adjacent filter/project merging
- Limit+Sort -> TopN (CreatePartialTopN's single-node half)
- domain extraction into scans (PushPredicateIntoTableScan + DomainTranslator)
- limit pushdown into scans (PushLimitIntoTableScan)
- join distribution choice by stats (DetermineJoinDistributionType)
- AddExchanges: REMOTE exchange placement by partitioning properties —
  on the TPU these lower to mesh collectives (SURVEY §2.11): repartition =
  all_to_all, broadcast = all_gather, gather = single-shard collect
- partial aggregation below exchanges (PushPartialAggregationThroughExchange)
- PlanFragmenter.createSubPlans: cut at REMOTE exchanges
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from trino_tpu_torch import types as T
from trino_tpu_torch.expr.ir import (Call, Literal, RowExpression, SpecialForm,
                               SpecialKind, SymbolRef)
from trino_tpu_torch.metadata import Metadata, Session
from trino_tpu_torch.planner.nodes import (
    AggCall, AggregationNode, AggStep, DistinctLimitNode,
    EnforceSingleRowNode, ExchangeKind, ExchangeNode, ExchangeScope,
    FilterNode, GroupIdNode, JoinClause, JoinDistribution, JoinKind, JoinNode,
    LimitNode, OffsetNode, Ordering, OutputNode, PlanNode, ProjectNode,
    SemiJoinNode, SortNode, Symbol, TableScanNode, TopNNode, UnionNode,
    UnnestNode, ValuesNode, WindowNode, TableWriterNode,
    AssignUniqueIdNode)
from trino_tpu_torch.predicate import Domain, Range, TupleDomain


def conjuncts(e: Optional[RowExpression]) -> List[RowExpression]:
    if e is None:
        return []
    if isinstance(e, SpecialForm) and e.kind is SpecialKind.AND:
        out = []
        for a in e.args:
            out.extend(conjuncts(a))
        return out
    return [e]


def combine(parts: Sequence[RowExpression]) -> Optional[RowExpression]:
    parts = list(parts)
    if not parts:
        return None
    out = parts[0]
    for p in parts[1:]:
        out = SpecialForm(SpecialKind.AND, (out, p), T.BOOLEAN)
    return out


def disjuncts(e: Optional[RowExpression]) -> List[RowExpression]:
    if e is None:
        return []
    if isinstance(e, SpecialForm) and e.kind is SpecialKind.OR:
        out = []
        for a in e.args:
            out.extend(disjuncts(a))
        return out
    return [e]


def combine_or(parts: Sequence[RowExpression]) -> RowExpression:
    out = parts[0]
    for p in parts[1:]:
        out = SpecialForm(SpecialKind.OR, (out, p), T.BOOLEAN)
    return out


def extract_common_predicates(e: RowExpression) -> RowExpression:
    """(A ∧ B) ∨ (A ∧ C)  ->  A ∧ (B ∨ C), recursively
    (sql/planner/iterative/rule/ExtractCommonPredicatesExpressionRewriter).

    Kleene 3VL distributivity makes the rewrite exact. Load-bearing for
    q19-style filters: the factored-out equality conjunct becomes a join
    clause instead of a post-cross-join residual."""
    if not isinstance(e, SpecialForm):
        return e
    if e.kind is SpecialKind.AND:
        parts = [extract_common_predicates(c) for c in conjuncts(e)]
        return combine(parts)
    if e.kind is SpecialKind.OR:
        branches = [conjuncts(extract_common_predicates(d))
                    for d in disjuncts(e)]
        common = [c for c in branches[0]
                  if all(c in b for b in branches[1:])]
        if not common:
            return combine_or([combine(b) for b in branches])
        residuals = []
        for b in branches:
            rem = [c for c in b if c not in common]
            if not rem:
                # x ∨ (x ∧ y) = x: this branch absorbs the whole OR
                return combine(common)
            residuals.append(combine(rem))
        return combine(common + [combine_or(residuals)])
    return e


def symbols_in(e: RowExpression) -> Set[str]:
    out: Set[str] = set()

    def visit(x):
        if isinstance(x, SymbolRef):
            out.add(x.name)
        for c in x.children():
            visit(c)
    visit(e)
    return out


def _substitute(e: RowExpression,
                mapping: Dict[str, RowExpression]) -> RowExpression:
    if isinstance(e, SymbolRef):
        return mapping.get(e.name, e)
    if isinstance(e, Call):
        return Call(e.name, tuple(_substitute(a, mapping) for a in e.args),
                    e.type)
    if isinstance(e, SpecialForm):
        return SpecialForm(e.kind,
                           tuple(_substitute(a, mapping) for a in e.args),
                           e.type)
    return e


# ---------------------------------------------------------------------------
# generic bottom-up rewriting


def rewrite_sources(node: PlanNode, fn) -> PlanNode:
    new_sources = [fn(s) for s in node.sources]
    if all(a is b for a, b in zip(new_sources, node.sources)):
        return node
    return node.with_sources(new_sources)


class Rule:
    """One rewrite; return None when not applicable (iterative/Rule.java)."""

    def apply(self, node: PlanNode, ctx: "OptimizerContext"
              ) -> Optional[PlanNode]:
        raise NotImplementedError


@dataclasses.dataclass
class OptimizerContext:
    metadata: Metadata
    session: Session
    stats: "StatsEstimator"


def run_rules(root: PlanNode, rules: Sequence[Rule], ctx: OptimizerContext,
              max_passes: int = 10) -> PlanNode:
    """Fixpoint bottom-up rewriter (IterativeOptimizer.exploreGroup without
    the Memo: plans here are small enough to rewrite directly)."""
    for _ in range(max_passes):
        changed = [False]

        def walk(node: PlanNode) -> PlanNode:
            node = rewrite_sources(node, walk)
            for rule in rules:
                out = rule.apply(node, ctx)
                if out is not None and out is not node:
                    changed[0] = True
                    node = rewrite_sources(out, walk)
            return node

        root = walk(root)
        if not changed[0]:
            break
    return root


# ---------------------------------------------------------------------------
# stats (cost/StatsCalculator condensed)


class StatsEstimator:
    """Row-count + NDV estimation driving join distribution/ordering.

    cost/ parity (FilterStatsCalculator.java, JoinStatsRule.java,
    StatsCalculator): per-column distinct counts propagate bottom-up
    (scan stats -> filter scaling -> join/aggregate pass-through), join
    cardinality uses the classic |L||R| / max(ndv_l, ndv_r) with
    exponential damping across clauses, GROUP BY uses the NDV product,
    and LIKE selectivity comes from the connector's dictionary pool —
    the round-4 q9 join-order regression was exactly a missing
    dictionary-LIKE estimate plus FK columns claiming table-sized NDVs.
    """

    FILTER_SELECTIVITY = 0.33
    RANGE_SELECTIVITY = 0.3
    SEMI_SELECTIVITY = 0.5
    LIKE_SELECTIVITY = 0.25      # fallback when no dictionary answers

    def __init__(self, metadata: Metadata):
        self.metadata = metadata
        self._cache: Dict[int, float] = {}
        self._ndv_cache: Dict[Tuple[int, str], Optional[float]] = {}

    def rows(self, node: PlanNode) -> float:
        key = node.id
        if key not in self._cache:
            self._cache[key] = self._estimate(node)
        return self._cache[key]

    # ------------------------------------------------------------- NDV

    def ndv(self, node: PlanNode, sym: str) -> Optional[float]:
        """Distinct count of `sym` in node's output, None when unknown."""
        key = (node.id, sym)
        if key not in self._ndv_cache:
            self._ndv_cache[key] = self._ndv(node, sym)
        return self._ndv_cache[key]

    def _ndv(self, node: PlanNode, sym: str) -> Optional[float]:
        if isinstance(node, TableScanNode):
            try:
                stats = self.metadata.get_table_statistics(
                    node.catalog, node.table)
            except Exception:
                return None
            for s, col in node.assignments:
                if s.name == sym:
                    cs = (stats.columns or {}).get(col.name)
                    if cs is not None and cs.distinct_count:
                        return min(float(cs.distinct_count),
                                   self.rows(node))
                    return None
            return None
        if isinstance(node, ProjectNode):
            for s, e in node.assignments:
                if s.name == sym:
                    if isinstance(e, SymbolRef):
                        return self._capped(node.source, e.name,
                                            self.rows(node))
                    return None
            return None
        if isinstance(node, JoinNode):
            cap = self.rows(node)
            for side in (node.left, node.right):
                if any(s.name == sym for s in side.outputs):
                    return self._capped(side, sym, cap)
            return None
        if isinstance(node, AggregationNode):
            if any(s.name == sym for s in node.group_by):
                return self._capped(node.source, sym, self.rows(node))
            return None
        if isinstance(node, SemiJoinNode):
            return self._capped(node.source, sym, self.rows(node))
        if node.sources:
            return self._capped(node.sources[0], sym, self.rows(node))
        return None

    def _capped(self, src: PlanNode, sym: str, cap: float
                ) -> Optional[float]:
        n = self.ndv(src, sym)
        return None if n is None else min(n, max(cap, 1.0))

    def _scan_of(self, node: PlanNode, sym: str
                 ) -> Optional[Tuple[TableScanNode, str]]:
        """Descend identity chains to the scan providing `sym` (for the
        connector LIKE-selectivity hook)."""
        while True:
            if isinstance(node, TableScanNode):
                for s, col in node.assignments:
                    if s.name == sym:
                        return node, col.name
                return None
            if isinstance(node, ProjectNode):
                for s, e in node.assignments:
                    if s.name == sym:
                        if isinstance(e, SymbolRef):
                            sym = e.name
                            break
                        return None
                else:
                    return None
                node = node.source
            elif isinstance(node, FilterNode):
                node = node.source
            else:
                return None

    # ------------------------------------------------------ selectivity

    def _scan_selectivity(self, node: TableScanNode, stats) -> float:
        """Domain-based selectivity per constrained column
        (FilterStatsCalculator's point/range estimates)."""
        sel = 1.0
        domains = node.table.constraint.domains
        if domains is None:
            return sel
        for col, dom in domains.items():
            ndv = None
            cstats = (stats.columns or {}).get(col) if stats else None
            if cstats is not None and cstats.distinct_count:
                ndv = float(cstats.distinct_count)
            values = dom.values_if_discrete()
            if values is not None:
                k = len(values)
                sel *= min(1.0, k / ndv) if ndv else 0.1
            else:
                sel *= self.RANGE_SELECTIVITY
        return max(sel, 1e-6)

    def _conjunct_selectivity(self, p: RowExpression,
                              source: Optional[PlanNode]) -> float:
        def sym_lit(call):
            if len(call.args) == 2 and isinstance(call.args[0], SymbolRef) \
                    and isinstance(call.args[1], Literal):
                return call.args[0].name
            return None

        if isinstance(p, Call) and p.name == "eq":
            if source is not None:
                s = sym_lit(p)
                n = self.ndv(source, s) if s else None
                if n:
                    return 1.0 / n
            return 0.1
        if isinstance(p, Call) and p.name in ("lt", "le", "gt", "ge"):
            return self.RANGE_SELECTIVITY
        if isinstance(p, Call) and p.name == "like" and source is not None:
            if isinstance(p.args[0], SymbolRef) and \
                    isinstance(p.args[1], Literal):
                hit = self._scan_of(source, p.args[0].name)
                if hit is not None:
                    scan, col = hit
                    try:
                        conn = self.metadata.connector(scan.catalog)
                        est = conn.metadata.estimate_like_selectivity(
                            scan.table, col, p.args[1].value)
                        if est is not None:
                            return max(est, 1e-6)
                    except Exception:
                        pass
            return self.LIKE_SELECTIVITY
        if isinstance(p, SpecialForm) and p.kind is SpecialKind.BETWEEN:
            return self.RANGE_SELECTIVITY
        if isinstance(p, SpecialForm) and p.kind is SpecialKind.IN:
            k = len(p.args) - 1
            if source is not None and isinstance(p.args[0], SymbolRef):
                n = self.ndv(source, p.args[0].name)
                if n:
                    return min(1.0, k / n)
            return min(1.0, 0.1 * k)
        if isinstance(p, SpecialForm) and p.kind is SpecialKind.NOT:
            return max(1e-6, 1.0 - self._conjunct_selectivity(
                p.args[0], source))
        return 0.9  # UNKNOWN_FILTER_COEFFICIENT

    def _filter_selectivity(self, pred: RowExpression,
                            source: Optional[PlanNode] = None) -> float:
        sel = 1.0
        for p in conjuncts(pred):
            sel *= self._conjunct_selectivity(p, source)
        return max(sel, 1e-6)

    # ------------------------------------------------------------ rows

    @staticmethod
    def join_cardinality(lr: float, rr: float,
                         clause_ndvs) -> float:
        """|L JOIN R| = |L||R| * prod of per-clause 1/max(ndv), clauses
        sorted strongest-first with exponential damping (correlated
        composite keys would otherwise be catastrophically under-
        estimated — the SQL Server/Trino compromise)."""
        sels = []
        for nl, nr in clause_ndvs:
            d = max(nl or 0.0, nr or 0.0)
            if d > 0:
                sels.append(1.0 / d)
            else:
                sels.append(1.0 / max(min(lr, rr), 1.0))  # PK-FK fallback
        out = lr * rr
        for i, s in enumerate(sorted(sels)):
            out *= s ** (1.0 / (2 ** i))
        return max(out, 1.0)

    def _estimate(self, node: PlanNode) -> float:
        if isinstance(node, TableScanNode):
            stats = self.metadata.get_table_statistics(node.catalog,
                                                       node.table)
            base = stats.row_count if stats.row_count is not None else 1e6
            if node.table.limit is not None:
                base = min(base, float(node.table.limit))
            if not node.table.constraint.is_all():
                base *= self._scan_selectivity(node, stats)
            return max(base, 1.0)
        if isinstance(node, ValuesNode):
            return float(len(node.rows))
        if isinstance(node, FilterNode):
            return max(1.0, self.rows(node.source)
                       * self._filter_selectivity(node.predicate,
                                                  node.source))
        if isinstance(node, (LimitNode, TopNNode, DistinctLimitNode)):
            return min(self.rows(node.source), float(node.count))
        if isinstance(node, AggregationNode):
            src = self.rows(node.source)
            if not node.group_by:
                return 1.0
            # group count = NDV product, capped by input rows
            prod = 1.0
            known = True
            for s in node.group_by:
                n = self.ndv(node.source, s.name)
                if n is None:
                    known = False
                    break
                prod *= n
            if known:
                return max(1.0, min(src, prod))
            return max(1.0, src ** 0.75)
        if isinstance(node, JoinNode):
            lr = self.rows(node.left)
            rr = self.rows(node.right)
            if node.kind == JoinKind.CROSS and not node.criteria:
                return lr * rr
            clause_ndvs = [(self.ndv(node.left, c.left.name),
                            self.ndv(node.right, c.right.name))
                           for c in node.criteria]
            out = self.join_cardinality(lr, rr, clause_ndvs)
            if node.kind == JoinKind.LEFT:
                out = max(out, lr)
            elif node.kind == JoinKind.RIGHT:
                out = max(out, rr)
            elif node.kind == JoinKind.FULL:
                out = max(out, lr, rr)
            if node.filter is not None:
                out *= self.FILTER_SELECTIVITY
            return max(out, 1.0)
        if isinstance(node, SemiJoinNode):
            return self.rows(node.source)
        if isinstance(node, UnionNode):
            return sum(self.rows(c) for c in node.children)
        if isinstance(node, GroupIdNode):
            return self.rows(node.source) * len(node.grouping_sets)
        if node.sources:
            return self.rows(node.sources[0])
        return 1e6


# ---------------------------------------------------------------------------
# rules


_FOLD_ARITH = {
    "add": lambda a, b: a + b,
    "subtract": lambda a, b: a - b,
    "multiply": lambda a, b: a * b,
}
_FOLD_CMP = {
    "eq": lambda a, b: a == b, "ne": lambda a, b: a != b,
    "lt": lambda a, b: a < b, "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b, "ge": lambda a, b: a >= b,
}


def fold_constants(e: RowExpression) -> RowExpression:
    """ExpressionInterpreter-lite (sql/planner/ExpressionInterpreter.java
    partial evaluation): fold arithmetic/comparisons over literals so
    `BETWEEN 1200 AND (1200 + 11)` becomes domain-extractable and reaches
    scan pushdown. Division/modulo keep their kernel rounding semantics
    (not folded); decimal +,-,* fold exactly in scaled-int space because
    the translator already aligned argument scales."""
    if isinstance(e, Call):
        args = tuple(fold_constants(a) for a in e.args)
        e = Call(e.name, args, e.type)
        if len(args) == 2 and all(
                isinstance(a, Literal) and a.value is not None
                and isinstance(a.value, (int, float))
                and not isinstance(a.value, bool) for a in args):
            a, b = args
            if e.name in _FOLD_ARITH and a.type == b.type == e.type:
                return Literal(_FOLD_ARITH[e.name](a.value, b.value),
                               e.type)
            if e.name in _FOLD_CMP and a.type == b.type:
                return Literal(_FOLD_CMP[e.name](a.value, b.value),
                               e.type)
        if e.name == "negate" and len(args) == 1 and \
                isinstance(args[0], Literal) and \
                args[0].value is not None and e.type == args[0].type:
            return Literal(-args[0].value, e.type)
        return e
    if isinstance(e, SpecialForm):
        args = tuple(fold_constants(a) for a in e.args)
        return SpecialForm(e.kind, args, e.type)
    return e


class FoldConstants(Rule):
    def apply(self, node, ctx):
        if isinstance(node, FilterNode):
            folded = fold_constants(node.predicate)
            if folded != node.predicate:
                return FilterNode(node.source, folded)
        if isinstance(node, ProjectNode):
            assigns = tuple((s, fold_constants(x))
                            for s, x in node.assignments)
            if assigns != node.assignments:
                return ProjectNode(node.source, assigns)
        return None


class ExtractCommonPredicates(Rule):
    def apply(self, node: PlanNode, ctx: "OptimizerContext"
              ) -> Optional[PlanNode]:
        if not isinstance(node, FilterNode):
            return None
        new = extract_common_predicates(node.predicate)
        if new == node.predicate:
            return None
        return FilterNode(node.source, new)


class MergeFilters(Rule):
    def apply(self, node, ctx):
        if isinstance(node, FilterNode) and isinstance(node.source,
                                                       FilterNode):
            pred = combine(conjuncts(node.predicate) +
                           conjuncts(node.source.predicate))
            return FilterNode(node.source.source, pred)
        return None


class RemoveIdentityProjections(Rule):
    def apply(self, node, ctx):
        if isinstance(node, ProjectNode) and node.is_identity() and \
                tuple(node.outputs) == tuple(node.source.outputs):
            return node.source
        return None


class MergeAdjacentProjects(Rule):
    """InlineProjections: project(project(x)) -> project(x) when safe."""

    def apply(self, node, ctx):
        if not (isinstance(node, ProjectNode)
                and isinstance(node.source, ProjectNode)):
            return None
        inner = node.source
        mapping = {s.name: e for s, e in inner.assignments}
        # avoid duplicating expensive inner expressions referenced twice
        ref_counts: Dict[str, int] = {}
        for _, e in node.assignments:
            for name in symbols_in(e):
                ref_counts[name] = ref_counts.get(name, 0) + 1
        for s, e in inner.assignments:
            if not isinstance(e, (SymbolRef, Literal)) and \
                    ref_counts.get(s.name, 0) > 1:
                return None
        new_assigns = tuple(
            (s, _substitute(e, mapping)) for s, e in node.assignments)
        return ProjectNode(inner.source, new_assigns)


class EvaluateZeroLimit(Rule):
    def apply(self, node, ctx):
        if isinstance(node, LimitNode) and node.count == 0:
            return ValuesNode(tuple(node.outputs), ())
        return None


class MergeLimits(Rule):
    def apply(self, node, ctx):
        if isinstance(node, LimitNode) and isinstance(node.source, LimitNode):
            return LimitNode(node.source.source,
                             min(node.count, node.source.count))
        return None


class CreateTopN(Rule):
    """Limit over Sort -> TopN (MergeLimitWithSort.java)."""

    def apply(self, node, ctx):
        if isinstance(node, LimitNode) and isinstance(node.source, SortNode) \
                and node.count <= 100_000:
            return TopNNode(node.source.source, node.count,
                            node.source.order_by)
        return None


class CreateDistinctLimit(Rule):
    def apply(self, node, ctx):
        if isinstance(node, LimitNode) and \
                isinstance(node.source, AggregationNode) and \
                not node.source.aggregations and \
                tuple(node.source.group_by) == tuple(node.source.outputs):
            return DistinctLimitNode(node.source.source, node.count) \
                if False else None  # keep agg shape; operator later
        return None


class PushLimitThroughProject(Rule):
    def apply(self, node, ctx):
        if isinstance(node, LimitNode) and isinstance(node.source,
                                                      ProjectNode):
            return ProjectNode(LimitNode(node.source.source, node.count,
                                         node.partial),
                               node.source.assignments)
        return None


class PredicatePushDown(Rule):
    """optimizations/PredicatePushDown.java condensed:
    - through Project (substitute assignments)
    - into Join: equality conjuncts spanning both sides of a CROSS/INNER join
      become join criteria; side-local conjuncts push to that side
    - into SemiJoin source side
    - through Aggregation on group-by-only conjuncts
    - through Union (per-child substitution)
    """

    def apply(self, node, ctx):
        if not isinstance(node, FilterNode):
            return None
        parts = conjuncts(node.predicate)
        src = node.source

        if isinstance(src, ProjectNode):
            mapping = {s.name: e for s, e in src.assignments}
            # only push conjuncts whose symbols are all plain aliases or
            # cheap expressions
            pushed, kept = [], []
            for p in parts:
                subbed = _substitute(p, mapping)
                pushed.append(subbed)
            if not pushed:
                return None
            return ProjectNode(FilterNode(src.source, combine(pushed)),
                               src.assignments)

        if isinstance(src, JoinNode) and src.kind in (JoinKind.CROSS,
                                                      JoinKind.INNER):
            left_syms = {s.name for s in src.left.outputs}
            right_syms = {s.name for s in src.right.outputs}
            new_criteria = list(src.criteria)
            left_parts, right_parts, residual = [], [], []
            changed = False
            for p in parts:
                syms = symbols_in(p)
                if syms and syms <= left_syms:
                    left_parts.append(p)
                    changed = True
                elif syms and syms <= right_syms:
                    right_parts.append(p)
                    changed = True
                else:
                    eq = self._as_equi_clause(p, left_syms, right_syms)
                    if eq is not None:
                        new_criteria.append(eq)
                        changed = True
                    else:
                        residual.append(p)
            if not changed:
                return None
            left = src.left if not left_parts else FilterNode(
                src.left, combine(left_parts))
            right = src.right if not right_parts else FilterNode(
                src.right, combine(right_parts))
            kind = src.kind
            if kind == JoinKind.CROSS and new_criteria:
                kind = JoinKind.INNER
            out: PlanNode = JoinNode(kind, left, right, tuple(new_criteria),
                                     src.filter, src.distribution)
            if residual:
                out = FilterNode(out, combine(residual))
            return out

        if isinstance(src, JoinNode) and src.kind == JoinKind.LEFT:
            # push left-side-only conjuncts into the probe side
            left_syms = {s.name for s in src.left.outputs}
            left_parts, kept = [], []
            for p in parts:
                syms = symbols_in(p)
                if syms and syms <= left_syms:
                    left_parts.append(p)
                else:
                    kept.append(p)
            if not left_parts:
                return None
            left = FilterNode(src.left, combine(left_parts))
            out = JoinNode(src.kind, left, src.right, src.criteria,
                           src.filter, src.distribution)
            if kept:
                out = FilterNode(out, combine(kept))
            return out

        if isinstance(src, SemiJoinNode):
            source_syms = {s.name for s in src.source.outputs}
            pushable, kept = [], []
            for p in parts:
                syms = symbols_in(p)
                if syms and syms <= source_syms:
                    pushable.append(p)
                else:
                    kept.append(p)
            if not pushable:
                return None
            inner = FilterNode(src.source, combine(pushable))
            out = SemiJoinNode(inner, src.filtering_source, src.source_keys,
                               src.filtering_keys, src.match_symbol,
                               src.negate, src.null_aware)
            if kept:
                out = FilterNode(out, combine(kept))
            return out

        if isinstance(src, AggregationNode) and src.group_by:
            group = {s.name for s in src.group_by}
            pushable, kept = [], []
            for p in parts:
                syms = symbols_in(p)
                if syms and syms <= group:
                    pushable.append(p)
                else:
                    kept.append(p)
            if not pushable:
                return None
            inner = FilterNode(src.source, combine(pushable))
            out = AggregationNode(inner, src.group_by, src.aggregations,
                                  src.step)
            if kept:
                out = FilterNode(out, combine(kept))
            return out

        return None

    @staticmethod
    def _as_equi_clause(p: RowExpression, left_syms, right_syms
                        ) -> Optional[JoinClause]:
        if isinstance(p, Call) and p.name == "eq" and len(p.args) == 2:
            a, b = p.args
            if isinstance(a, SymbolRef) and isinstance(b, SymbolRef):
                if a.name in left_syms and b.name in right_syms:
                    return JoinClause(Symbol(a.name, a.type),
                                      Symbol(b.name, b.type))
                if b.name in left_syms and a.name in right_syms:
                    return JoinClause(Symbol(b.name, b.type),
                                      Symbol(a.name, a.type))
        return None


class PruneColumns(Rule):
    """PruneUnreferencedOutputs: narrow scans/projects to referenced symbols.

    Applied top-down from the root in one dedicated pass (prune_unreferenced)
    — kept out of the bottom-up loop.
    """

    def apply(self, node, ctx):
        return None


def prune_unreferenced(root: OutputNode) -> OutputNode:
    def needed_of(node: PlanNode, required: Set[str]) -> PlanNode:
        if isinstance(node, ProjectNode):
            kept = tuple((s, e) for s, e in node.assignments
                         if s.name in required)
            if not kept and node.assignments:
                # zero-column pages lose their capacity/row-count carrier;
                # keep the cheapest assignment (count(*) over a projection)
                kept = (min(node.assignments,
                            key=lambda se: len(str(se[1]))),)
            child_req = set()
            for _, e in kept:
                child_req |= symbols_in(e)
            src = needed_of(node.source, child_req)
            return ProjectNode(src, kept)
        if isinstance(node, FilterNode):
            req = required | symbols_in(node.predicate)
            return FilterNode(needed_of(node.source, req), node.predicate)
        if isinstance(node, TableScanNode):
            kept = tuple((s, c) for s, c in node.assignments
                         if s.name in required)
            if not kept:
                kept = node.assignments[:1]  # keep one column for count(*)
            return TableScanNode(node.catalog, node.table, kept)
        if isinstance(node, JoinNode):
            req = set(required)
            for c in node.criteria:
                req.add(c.left.name)
                req.add(c.right.name)
            if node.filter is not None:
                req |= symbols_in(node.filter)
            left = needed_of(node.left, req)
            right = needed_of(node.right, req)
            out_syms = None
            if node.kind in (JoinKind.INNER, JoinKind.LEFT):
                # PruneJoinColumns: emit only downstream-needed symbols
                # (plus residual-filter inputs, evaluated on the joined
                # layout) — join keys themselves can drop, saving the
                # probe-capacity build-column gathers
                keep = set(required)
                if node.filter is not None:
                    keep |= symbols_in(node.filter)
                full = left.outputs + right.outputs
                kept = tuple(s for s in full if s.name in keep)
                if not kept:
                    kept = left.outputs[:1]   # count(*) carrier
                if len(kept) != len(full):
                    out_syms = kept
            return JoinNode(node.kind, left, right, node.criteria,
                            node.filter, node.distribution, out_syms)
        if isinstance(node, SemiJoinNode):
            req = set(required)
            req |= {s.name for s in node.source_keys}
            filt_req = {s.name for s in node.filtering_keys}
            source = needed_of(node.source, req)
            filtering = needed_of(node.filtering_source, filt_req)
            return SemiJoinNode(source, filtering, node.source_keys,
                                node.filtering_keys, node.match_symbol,
                                node.negate, node.null_aware)
        if isinstance(node, AggregationNode):
            kept_aggs = tuple((s, a) for s, a in node.aggregations
                              if s.name in required or not required)
            req = {s.name for s in node.group_by}
            for _, a in kept_aggs:
                for arg in a.args:
                    req |= symbols_in(arg)
                if a.filter is not None:
                    req |= symbols_in(a.filter)
            return AggregationNode(needed_of(node.source, req),
                                   node.group_by, kept_aggs, node.step)
        if isinstance(node, GroupIdNode):
            req = set(required)
            for gs in node.grouping_sets:
                req |= {s.name for s in gs}
            req |= {s.name for s in node.passthrough}
            req.discard(node.group_id_symbol.name)
            return GroupIdNode(needed_of(node.source, req),
                               node.grouping_sets, node.group_id_symbol,
                               node.passthrough)
        if isinstance(node, UnnestNode):
            req = set(required) | {s.name for s in node.arrays}
            return node.with_sources([needed_of(node.source, req)])
        if isinstance(node, (SortNode, TopNNode)):
            req = set(required) | {o.symbol.name for o in node.order_by}
            src = needed_of(node.source, req)
            return node.with_sources([src])
        if isinstance(node, WindowNode):
            req = set(required)
            req |= {s.name for s in node.partition_by}
            req |= {o.symbol.name for o in node.order_by}
            for _, wf in node.functions:
                for a in wf.args:
                    req |= symbols_in(a)
            return WindowNode(needed_of(node.source, req), node.partition_by,
                              node.order_by, node.functions)
        if isinstance(node, UnionNode):
            keep_idx = [i for i, s in enumerate(node.symbols)
                        if s.name in required]
            if not keep_idx:
                keep_idx = [0]
            children = []
            for j, child in enumerate(node.children):
                child_req = {node.mappings[i][j].name for i in keep_idx}
                children.append(needed_of(child, child_req))
            return UnionNode(
                tuple(children),
                tuple(node.symbols[i] for i in keep_idx),
                tuple(node.mappings[i] for i in keep_idx))
        if isinstance(node, (LimitNode, OffsetNode, DistinctLimitNode,
                             EnforceSingleRowNode)):
            return node.with_sources(
                [needed_of(node.sources[0], set(required))])
        if isinstance(node, ValuesNode):
            return node
        if isinstance(node, ExchangeNode):
            req = set(required) | {s.name for s in node.partition_keys}
            return node.with_sources([needed_of(node.source, req)])
        if isinstance(node, (TableWriterNode, AssignUniqueIdNode)):
            req = set(required)
            if isinstance(node, TableWriterNode):
                req |= {s.name for s in node.column_symbols}
            if isinstance(node, AssignUniqueIdNode):
                req.discard(node.id_symbol.name)
            return node.with_sources([needed_of(node.sources[0], req)])
        return rewrite_sources(
            node, lambda s: needed_of(s, set(required)))

    out_req = {s.name for s in root.symbols}
    return OutputNode(needed_of(root.source, out_req), root.column_names,
                      root.symbols)


class PushPredicateIntoTableScan(Rule):
    """Extract a TupleDomain from scan-adjacent filters and offer it to the
    connector (DomainTranslator + PushPredicateIntoTableScan.java). The
    residual expression always stays — connectors treat domains as pruning
    hints (SPI contract in connector/spi.py)."""

    def apply(self, node, ctx):
        if not (isinstance(node, FilterNode)
                and isinstance(node.source, TableScanNode)):
            return None
        scan = node.source
        sym_to_col = {s.name: c for s, c in scan.assignments}
        domains: Dict[str, Domain] = {}
        for p in conjuncts(node.predicate):
            extracted = _extract_domain(p, sym_to_col)
            if extracted is None:
                extracted = _extract_or_domain(p, sym_to_col)
            if extracted is None:
                continue
            col, dom = extracted
            domains[col] = (domains[col].intersect(dom)
                            if col in domains else dom)
        if not domains:
            return None
        td = TupleDomain.with_column_domains(domains)
        if scan.table.constraint.intersect(td) == scan.table.constraint:
            return None  # already pushed
        conn = ctx.metadata.connector(scan.catalog)
        result = conn.metadata.apply_filter(scan.table, td)
        if result is None:
            return None
        new_handle, _ = result
        new_scan = TableScanNode(scan.catalog, new_handle, scan.assignments)
        return FilterNode(new_scan, node.predicate)


def _unwrap_literal(e: RowExpression) -> RowExpression:
    """See through value-preserving integer-widening casts so
    `bigint_col < 100` (planned as lt(col, cast(100))) still yields a
    pushable domain. Only integer->integer casts unwrap: a decimal/date
    cast changes the RAW representation the zone maps compare against."""
    from trino_tpu_torch import types as _T
    if (isinstance(e, Call) and e.name == "cast" and len(e.args) == 1
            and isinstance(e.args[0], Literal)
            and isinstance(e.type, (_T.BigintType, _T.IntegerType))
            and isinstance(e.args[0].type,
                           (_T.BigintType, _T.IntegerType))):
        return Literal(e.args[0].value, e.type)
    return e


def _extract_domain(p: RowExpression, sym_to_col
                    ) -> Optional[Tuple[str, Domain]]:
    if not (isinstance(p, Call) and len(p.args) == 2):
        return None
    a, b = (_unwrap_literal(x) for x in p.args)
    if isinstance(a, SymbolRef) and isinstance(b, Literal) and \
            b.value is not None and a.name in sym_to_col:
        col, val, op = sym_to_col[a.name].name, b.value, p.name
    elif isinstance(b, SymbolRef) and isinstance(a, Literal) and \
            a.value is not None and b.name in sym_to_col:
        col, val = sym_to_col[b.name].name, a.value
        op = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}.get(
            p.name, p.name)
    else:
        return None
    typ = p.args[0].type
    if op == "eq":
        return col, Domain.single_value(typ, val)
    if op == "lt":
        return col, Domain.from_range(typ, Range.less_than(val))
    if op == "le":
        return col, Domain.from_range(typ, Range.less_equal(val))
    if op == "gt":
        return col, Domain.from_range(typ, Range.greater_than(val))
    if op == "ge":
        return col, Domain.from_range(typ, Range.greater_equal(val))
    return None


def _extract_or_domain(p: RowExpression, sym_to_col
                       ) -> Optional[Tuple[str, Domain]]:
    """Disjunctions over ONE column union into a multi-range domain:
    `k IN (...)` (desugared to an OR-chain of eq by plan time) and ORed
    range predicates like `(k >= 1 AND k < 5) OR k = 9`. Any branch that
    constrains a different column — or nothing extractable — poisons the
    whole disjunction (the OR is then not a row filter on one column)."""
    if not (isinstance(p, SpecialForm) and p.kind is SpecialKind.OR):
        return None
    out_col: Optional[str] = None
    out_dom: Optional[Domain] = None
    stack = list(p.args)
    while stack:
        branch = stack.pop()
        if isinstance(branch, SpecialForm) and \
                branch.kind is SpecialKind.OR:
            stack.extend(branch.args)
            continue
        # a branch may be a conjunctive range over the column
        branch_dom: Optional[Domain] = None
        for c in conjuncts(branch):
            got = _extract_domain(c, sym_to_col) \
                or _extract_or_domain(c, sym_to_col)
            if got is None:
                return None
            col, d = got
            if out_col is None:
                out_col = col
            elif col != out_col:
                return None
            branch_dom = d if branch_dom is None \
                else branch_dom.intersect(d)
        if branch_dom is None:
            return None
        out_dom = branch_dom if out_dom is None \
            else out_dom.union(branch_dom)
    if out_col is None or out_dom is None:
        return None
    return out_col, out_dom


class PushLimitIntoTableScan(Rule):
    def apply(self, node, ctx):
        if not (isinstance(node, LimitNode)
                and isinstance(node.source, TableScanNode)):
            return None
        scan = node.source
        conn = ctx.metadata.connector(scan.catalog)
        new_handle = conn.metadata.apply_limit(scan.table, node.count)
        if new_handle is None:
            return None
        return LimitNode(TableScanNode(scan.catalog, new_handle,
                                       scan.assignments),
                         node.count, node.partial)


class DetermineJoinDistributionType(Rule):
    """Broadcast small build sides, partition large ones
    (iterative/rule/DetermineJoinDistributionType.java)."""

    def apply(self, node, ctx):
        if not isinstance(node, JoinNode) or \
                node.distribution != JoinDistribution.AUTO:
            return None
        if node.kind in (JoinKind.FULL, JoinKind.RIGHT):
            # FULL/RIGHT joins cannot broadcast the build side: the
            # unmatched-build pass would emit duplicates on every shard
            # (same restriction as the reference's replicated-join rules)
            return JoinNode(node.kind, node.left, node.right, node.criteria,
                            node.filter, JoinDistribution.PARTITIONED)
        forced = ctx.session.get("join_distribution_type")
        if forced == "BROADCAST":
            dist = JoinDistribution.REPLICATED
        elif forced == "PARTITIONED":
            dist = JoinDistribution.PARTITIONED
        else:
            threshold = ctx.session.get("join_broadcast_threshold_rows")
            build_rows = ctx.stats.rows(node.right)
            dist = (JoinDistribution.REPLICATED
                    if build_rows <= threshold
                    else JoinDistribution.PARTITIONED)
        return JoinNode(node.kind, node.left, node.right, node.criteria,
                        node.filter, dist)


class FlipJoinSides(Rule):
    """Build on the smaller input (ReorderJoins' local decision: the engine
    always builds the hash table on the right child)."""

    def apply(self, node, ctx):
        if not isinstance(node, JoinNode) or node.kind != JoinKind.INNER \
                or not node.criteria:
            return None
        if getattr(node, "_flip_checked", False):
            return None
        object.__setattr__(node, "_flip_checked", True)
        left_rows = ctx.stats.rows(node.left)
        right_rows = ctx.stats.rows(node.right)
        if right_rows > left_rows * 1.5:
            flipped = JoinNode(
                node.kind, node.right, node.left,
                tuple(JoinClause(c.right, c.left) for c in node.criteria),
                node.filter, node.distribution)
            object.__setattr__(flipped, "_flip_checked", True)
            # preserve output order with a projection
            want = node.outputs
            assigns = tuple((s, s.ref()) for s in want)
            return ProjectNode(flipped, assigns)
        return None


# ---------------------------------------------------------------------------
# join reordering (EliminateCrossJoins.java + ReorderJoins.java:96 greedy)


def reorder_joins(root: PlanNode, ctx: OptimizerContext) -> PlanNode:
    """Reassociate each maximal INNER/CROSS join tree along its equality
    graph so no avoidable cross join remains.

    The reference does DP enumeration over connected subgraphs
    (ReorderJoins.JoinEnumerator:168, capped at 9 relations) with full cost
    comparison; a greedy nearest-neighbor over estimated row counts picks the
    same plans for TPC-H's PK-FK star/snowflake shapes: start from the
    cheapest connected pair, then always attach the connected source that
    minimizes the estimated intermediate size. Cross joins only happen when
    the predicate graph is genuinely disconnected (EliminateCrossJoins'
    contract)."""
    if ctx.session.get("join_reordering_strategy") == "NONE":
        return root

    def walk(node: PlanNode) -> PlanNode:
        if isinstance(node, JoinNode) and \
                node.kind in (JoinKind.INNER, JoinKind.CROSS):
            sources: List[PlanNode] = []
            edges: List[JoinClause] = []
            filters: List[RowExpression] = []

            def flatten(n: PlanNode):
                if isinstance(n, JoinNode) and \
                        n.kind in (JoinKind.INNER, JoinKind.CROSS):
                    flatten(n.left)
                    flatten(n.right)
                    edges.extend(n.criteria)
                    if n.filter is not None:
                        filters.extend(conjuncts(n.filter))
                else:
                    sources.append(walk(n))

            flatten(node)
            if len(sources) < 3:
                # nothing to reorder (flatten already walked the leaves)
                return node.with_sources(sources)
            out = _build_join_tree(sources, edges, filters, ctx)
            want = node.outputs
            have = set(s.name for s in out.outputs)
            assigns = tuple((s, s.ref()) for s in want if s.name in have)
            return ProjectNode(out, assigns)
        return rewrite_sources(node, walk)

    return walk(root)


_DP_MAX_RELATIONS = 9    # ReorderJoins.java JoinEnumerator cap


def _build_join_tree(sources: List[PlanNode], edges: List[JoinClause],
                     filters: List[RowExpression],
                     ctx: OptimizerContext) -> PlanNode:
    syms_of = [{s.name for s in src.outputs} for src in sources]

    def locate(name: str) -> Optional[int]:
        for i, syms in enumerate(syms_of):
            if name in syms:
                return i
        return None

    located = []  # (source_a, source_b, clause); a owns clause.left
    for c in edges:
        a, b = locate(c.left.name), locate(c.right.name)
        if a is None or b is None or a == b:
            # degenerate (same-source equality or unknown symbol): filter
            filters.append(Call("eq", (c.left.ref(), c.right.ref()),
                                T.BOOLEAN))
        else:
            located.append((a, b, c))

    n = len(sources)
    if n <= _DP_MAX_RELATIONS:
        current = _dp_join_tree(sources, located, ctx)
    else:
        current = _greedy_join_tree(sources, syms_of, located, ctx)
    if filters:
        current = FilterNode(current, combine(filters))
    return current


def _dp_join_tree(sources: List[PlanNode], located,
                  ctx: OptimizerContext) -> PlanNode:
    """Selinger-style bitmask DP over connected subsets, minimizing the
    sum of intermediate result sizes (ReorderJoins.JoinEnumerator:168 with
    JoinStatsRule cardinalities). Cross joins only appear when the
    equality graph is genuinely disconnected."""
    n = len(sources)
    rows = [ctx.stats.rows(s) for s in sources]
    edge_info = []   # (mask_a, mask_b, per-clause selectivity)
    for a, b, c in located:
        na = ctx.stats.ndv(sources[a], c.left.name)
        nb = ctx.stats.ndv(sources[b], c.right.name)
        d = max(na or 0.0, nb or 0.0)
        if d <= 0:
            # unknown NDV: the same PK-FK fallback join_cardinality uses,
            # anchored on the edge's smaller endpoint
            d = max(min(rows[a], rows[b]), 1.0)
        edge_info.append((1 << a, 1 << b, 1.0 / d))

    from functools import lru_cache

    @lru_cache(maxsize=None)
    def mask_rows(mask: int) -> float:
        out = 1.0
        for i in range(n):
            if mask & (1 << i):
                out *= rows[i]
        sels = [s for ma, mb, s in edge_info
                if (mask & ma) and (mask & mb)]
        for i, s in enumerate(sorted(sels)):
            out *= s ** (1.0 / (2 ** i))
        return max(out, 1.0)

    def connects(ma: int, mb: int) -> bool:
        return any(((ea & ma) and (eb & mb)) or ((eb & ma) and (ea & mb))
                   for ea, eb, _ in edge_info)

    # cost of a subtree: (cross joins, summed intermediate rows), compared
    # in that order
    best: Dict[int, Tuple[Tuple[int, float], Optional[Tuple[int, int]]]] = {}
    for i in range(n):
        best[1 << i] = ((0, 0.0), None)

    full = (1 << n) - 1
    # iterate masks in popcount order so sub-results exist
    masks = sorted(range(1, full + 1), key=lambda m: bin(m).count("1"))
    for mask in masks:
        if mask in best:
            continue
        size = mask_rows(mask)
        # a cross join (disconnected partition) is counted before any row
        # estimate, so it survives ONLY when the equality graph is
        # genuinely disconnected — parents then avoid any split whose
        # subtree needs one (EliminateCrossJoins' contract). The reference
        # adds a fixed 1e12 instead, which connected plans' estimates
        # outgrow at sf10 (q9 then plans a cross join of supplier and part)
        picked: Optional[Tuple[Tuple[int, float], Tuple[int, int]]] = None
        # enumerate proper submask partitions (canonical: sub contains
        # lowest set bit, so each split is seen once)
        low = mask & (-mask)
        sub = (mask - 1) & mask
        while sub:
            other = mask ^ sub
            if (sub & low) and sub in best and other in best:
                (xa, ca), (xb, cb) = best[sub][0], best[other][0]
                cost = (xa + xb + (0 if connects(sub, other) else 1),
                        ca + cb + size)
                if picked is None or cost < picked[0]:
                    picked = (cost, (sub, other))
            sub = (sub - 1) & mask
        if picked is not None:
            best[mask] = picked
    if full not in best:
        # degenerate (shouldn't happen): chain greedily
        return _greedy_join_tree(sources,
                                 [{s.name for s in src.outputs}
                                  for src in sources], located, ctx)

    def build(mask: int) -> Tuple[PlanNode, Set[str], Set[int]]:
        _, split = best[mask]
        if split is None:
            i = mask.bit_length() - 1
            return sources[i], {s.name for s in sources[i].outputs}, {i}
        a, b = split
        na, sa, ia = build(a)
        nb, sb, ib = build(b)
        # probe (left) = larger estimated side; build (right) = smaller
        if mask_rows(a) < mask_rows(b):
            na, sa, ia, nb, sb, ib = nb, sb, ib, na, sa, ia
        criteria = []
        for x, y, c in located:
            if x in ia and y in ib:
                criteria.append(c)
            elif y in ia and x in ib:
                criteria.append(JoinClause(c.right, c.left))
        kind = JoinKind.INNER if criteria else JoinKind.CROSS
        return (JoinNode(kind, na, nb, tuple(criteria)),
                sa | sb, ia | ib)

    node, _, _ = build(full)
    return node


def _greedy_join_tree(sources: List[PlanNode], syms_of, located,
                      ctx: OptimizerContext) -> PlanNode:
    """Greedy nearest-neighbor fallback for >_DP_MAX_RELATIONS trees."""
    rows = [ctx.stats.rows(s) for s in sources]
    n = len(sources)

    best: Optional[Tuple[float, int, int]] = None
    for a, b, _ in located:
        cost = max(rows[a], rows[b])
        if best is None or cost < best[0]:
            best = (cost, a, b)
    if best is None:
        order = sorted(range(n), key=lambda i: rows[i])
        first, second = order[0], order[1]
    else:
        _, first, second = best

    used = {first, second}
    current = _join_step(sources[first], syms_of[first], sources[second],
                         second, located, used)
    cur_rows = max(rows[first], rows[second])
    cur_syms = syms_of[first] | syms_of[second]

    while len(used) < n:
        candidates = []
        for j in range(n):
            if j in used:
                continue
            connected = any((a in used and b == j) or (b in used and a == j)
                            for a, b, _ in located)
            est = max(cur_rows, rows[j]) if connected else cur_rows * rows[j]
            candidates.append((not connected, est, j))
        candidates.sort()
        _, est, j = candidates[0]
        current = _join_step(current, cur_syms, sources[j], j, located, used)
        used.add(j)
        cur_rows = est
        cur_syms |= syms_of[j]
    return current


def _join_step(left: PlanNode, left_syms: Set[str], right: PlanNode,
               right_idx: int, located, used: Set[int]) -> PlanNode:
    """Join `right` (source right_idx) onto `left`, consuming every edge
    between the current set and right_idx, oriented left-first."""
    criteria = []
    for a, b, c in located:
        if a in used and b == right_idx:
            criteria.append(c)
        elif b in used and a == right_idx:
            criteria.append(JoinClause(c.right, c.left))
    kind = JoinKind.INNER if criteria else JoinKind.CROSS
    return JoinNode(kind, left, right, tuple(criteria))


# ---------------------------------------------------------------------------
# exchange placement (AddExchanges.java:120 condensed)


def add_exchanges(root: OutputNode, ctx: OptimizerContext) -> OutputNode:
    """Insert REMOTE exchanges bottom-up.

    Partitioning property lattice is reduced to: 'source' (leaf-split
    partitioned), 'hashed(keys)', 'single'. Requirements:
      final agg keys / join keys / semi keys -> hashed; Output/Sort/Limit
      root -> single. Broadcast build sides replicate instead of hashing.
    """

    def visit(node: PlanNode) -> Tuple[PlanNode, str]:
        # returns (new_node, partitioning) where partitioning in
        # {"single", "source", "hashed"}
        if isinstance(node, (TableScanNode,)):
            return node, "source"
        if isinstance(node, ValuesNode):
            return node, "single"
        if isinstance(node, (FilterNode, ProjectNode, UnnestNode)):
            src, part = visit(node.source)
            return node.with_sources([src]), part

        if isinstance(node, AggregationNode):
            src, part = visit(node.source)
            if part == "single":
                return node.with_sources([src]), "single"
            # partial on the source partitioning, repartition/gather, final
            return _split_aggregation(node, src, ctx)

        if isinstance(node, GroupIdNode):
            src, part = visit(node.source)
            return node.with_sources([src]), part

        if isinstance(node, JoinNode):
            left, lpart = visit(node.left)
            right, rpart = visit(node.right)
            if node.distribution == JoinDistribution.REPLICATED or \
                    not node.criteria:
                if rpart != "single":
                    right = ExchangeNode(right, ExchangeScope.REMOTE,
                                         ExchangeKind.BROADCAST)
                return node.with_sources([left, right]), lpart
            lkeys = tuple(c.left for c in node.criteria)
            rkeys = tuple(c.right for c in node.criteria)
            left = ExchangeNode(left, ExchangeScope.REMOTE,
                                ExchangeKind.REPARTITION, lkeys)
            right = ExchangeNode(right, ExchangeScope.REMOTE,
                                 ExchangeKind.REPARTITION, rkeys)
            return node.with_sources([left, right]), "hashed"

        if isinstance(node, SemiJoinNode):
            src, spart = visit(node.source)
            filt, fpart = visit(node.filtering_source)
            # broadcast the filtering side (usually small; exact when keys
            # are replicated everywhere)
            if fpart != "single":
                filt = ExchangeNode(filt, ExchangeScope.REMOTE,
                                    ExchangeKind.BROADCAST)
            return node.with_sources([src, filt]), spart

        if isinstance(node, (SortNode,)):
            src, part = visit(node.source)
            if part != "single":
                if ctx.session.get("distributed_sort"):
                    # local sort then ordered merge gather
                    local = SortNode(src, node.order_by)
                    merged = ExchangeNode(local, ExchangeScope.REMOTE,
                                          ExchangeKind.MERGE, (),
                                          node.order_by)
                    return merged, "single"
                src = ExchangeNode(src, ExchangeScope.REMOTE,
                                   ExchangeKind.GATHER)
            return node.with_sources([src]), "single"

        if isinstance(node, TopNNode):
            src, part = visit(node.source)
            if part == "single":
                return node.with_sources([src]), "single"
            partial = TopNNode(src, node.count, node.order_by, "partial")
            gathered = ExchangeNode(partial, ExchangeScope.REMOTE,
                                    ExchangeKind.GATHER)
            return TopNNode(gathered, node.count, node.order_by,
                            "final"), "single"

        if isinstance(node, LimitNode):
            src, part = visit(node.source)
            if part == "single":
                return node.with_sources([src]), "single"
            partial = LimitNode(src, node.count, partial=True)
            gathered = ExchangeNode(partial, ExchangeScope.REMOTE,
                                    ExchangeKind.GATHER)
            return LimitNode(gathered, node.count), "single"

        if isinstance(node, (OffsetNode, EnforceSingleRowNode,
                             DistinctLimitNode)):
            src, part = visit(node.sources[0])
            if part != "single":
                src = ExchangeNode(src, ExchangeScope.REMOTE,
                                   ExchangeKind.GATHER)
            return node.with_sources([src]), "single"

        if isinstance(node, WindowNode):
            src, part = visit(node.source)
            if part != "single" and node.partition_by:
                src = ExchangeNode(src, ExchangeScope.REMOTE,
                                   ExchangeKind.REPARTITION,
                                   node.partition_by)
                return node.with_sources([src]), "hashed"
            if part != "single":
                src = ExchangeNode(src, ExchangeScope.REMOTE,
                                   ExchangeKind.GATHER)
            return node.with_sources([src]), "single"

        if isinstance(node, UnionNode):
            children = []
            for c in node.children:
                cc, cpart = visit(c)
                children.append(cc)
            return node.with_sources(children), "source"

        if isinstance(node, TableWriterNode):
            src, part = visit(node.source)
            return node.with_sources([src]), part

        if isinstance(node, OutputNode):
            src, part = visit(node.source)
            if part != "single":
                src = ExchangeNode(src, ExchangeScope.REMOTE,
                                   ExchangeKind.GATHER)
            return node.with_sources([src]), "single"

        src_parts = [visit(s) for s in node.sources]
        return node.with_sources([s for s, _ in src_parts]), \
            (src_parts[0][1] if src_parts else "single")

    out, _ = visit(root)
    return out


def _grouped_exchange_kind(agg: AggregationNode, src: PlanNode,
                           ctx: OptimizerContext) -> str:
    """Partitioned vs. global GROUP BY strategy ("Global Hash Tables
    Strike Back" mapped onto the mesh): a LOW-NDV grouping collapses into
    tiny partial states per shard, so gathering those states to one shard
    (the shared/global hash table) beats paying an all_to_all; a HIGH-NDV
    grouping must radix-partition so the final aggregation parallelizes
    and no single chip materializes every group. The CBO's NDV product
    picks the strategy; unknown NDV defaults to partitioned (the safe
    choice at scale)."""
    if not agg.group_by:
        return ExchangeKind.GATHER
    threshold = int(ctx.session.get("partitioned_agg_min_ndv"))
    groups = 1.0
    for s in agg.group_by:
        n = ctx.stats.ndv(src, s.name)
        if n is None:
            return ExchangeKind.REPARTITION
        groups *= max(n, 1.0)
    # cap the NDV product at the input row count BEFORE comparing: a
    # multi-key product can exceed the threshold while the true group
    # count (bounded by rows) stays tiny (float product cannot
    # meaningfully overflow — it saturates, and saturation > threshold)
    groups = min(groups, ctx.stats.rows(src))
    return (ExchangeKind.REPARTITION if groups >= threshold
            else ExchangeKind.GATHER)


def _split_aggregation(agg: AggregationNode, src: PlanNode,
                       ctx: OptimizerContext) -> Tuple[PlanNode, str]:
    """partial agg -> exchange -> final agg
    (PushPartialAggregationThroughExchange.java). DISTINCT or FILTER aggs
    can't split; gather instead. The exchange kind for grouped
    aggregations is CBO-chosen: REPARTITION (partitioned strategy) vs
    GATHER (global strategy) by estimated group NDV."""
    from trino_tpu_torch.ops.aggregate import SINGLE_STEP_AGGREGATES
    splittable = all(not a.distinct and a.filter is None
                     and a.name not in SINGLE_STEP_AGGREGATES
                     for _, a in agg.aggregations)
    if not splittable:
        # unsplittable aggs need every row of a group in ONE kernel call,
        # so a grouped agg must repartition regardless of NDV
        kind = (ExchangeKind.REPARTITION if agg.group_by
                else ExchangeKind.GATHER)
        ex = ExchangeNode(src, ExchangeScope.REMOTE, kind,
                          tuple(agg.group_by))
        return agg.with_sources([ex]), ("hashed" if agg.group_by
                                        else "single")
    # The PARTIAL node carries the same aggregations tuple; the execution
    # planner derives the operator-level state-column layout from the step
    # (keys + state columns per agg) and the FINAL side consumes positionally
    # through the exchange collective.
    partial = AggregationNode(src, agg.group_by, agg.aggregations,
                              AggStep.PARTIAL)
    kind = _grouped_exchange_kind(agg, src, ctx)
    ex = ExchangeNode(partial, ExchangeScope.REMOTE, kind,
                      tuple(agg.group_by))
    final = AggregationNode(ex, agg.group_by, agg.aggregations, AggStep.FINAL)
    return final, ("hashed" if kind == ExchangeKind.REPARTITION
                   else "single")


# ---------------------------------------------------------------------------
# fragmenter (PlanFragmenter.java:90)


@dataclasses.dataclass
class PlanFragment:
    """One stage program: executes `root` over its partitioning; consumes
    child fragments through the RemoteSourceNodes cut at REMOTE exchanges.

    `partition_keys` is the fragment's partitioning HANDLE (the reference's
    PartitioningHandle): for a "hashed" fragment, the symbol names whose
    hash placed each row on its shard — the mesh scheduler uses it to
    recognize co-partitioned inputs (a join over inputs repartitioned on
    the same clause keys needs no further exchange)."""

    fragment_id: int
    root: PlanNode
    partitioning: str               # single | source | hashed
    children: List["PlanFragment"]
    partition_keys: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class RemoteSourceNode(PlanNode):
    """Placeholder consuming a child fragment's output
    (plan/RemoteSourceNode.java)."""

    fragment_id: int
    symbols: Tuple[Symbol, ...]
    kind: str
    partition_keys: Tuple[Symbol, ...] = ()
    order_by: Tuple[Ordering, ...] = ()
    id: int = -1

    @property
    def sources(self):
        return ()

    @property
    def outputs(self):
        return self.symbols

    def with_sources(self, sources):
        return self

    def node_name(self):
        return f"RemoteSource[{self.fragment_id}, {self.kind}]"


def fragment_plan(root: OutputNode) -> PlanFragment:
    """Cut the plan at REMOTE exchanges into a fragment tree."""
    counter = [0]

    def cut(node: PlanNode, partitioning: str
            ) -> Tuple[PlanNode, List[PlanFragment]]:
        if isinstance(node, ExchangeNode) and \
                node.scope == ExchangeScope.REMOTE:
            child_part = ("hashed" if node.kind == ExchangeKind.REPARTITION
                          else "source")
            child_root, grandchildren = cut(node.source, child_part)
            counter[0] += 1
            fid = counter[0]
            frag = PlanFragment(fid, child_root, child_part, grandchildren,
                                tuple(s.name for s in node.partition_keys))
            remote = RemoteSourceNode(fid, tuple(node.source.outputs),
                                      node.kind, node.partition_keys,
                                      node.order_by)
            return remote, [frag]
        new_sources = []
        frags: List[PlanFragment] = []
        for s in node.sources:
            ns, f = cut(s, partitioning)
            new_sources.append(ns)
            frags.extend(f)
        if node.sources:
            node = node.with_sources(new_sources)
        return node, frags

    root_node, children = cut(root, "single")
    return PlanFragment(0, root_node, "single", children)


# ---------------------------------------------------------------------------
# pipeline (PlanOptimizers.java ordering)


def annotate_adaptive_hints(node: PlanNode,
                            ctx: OptimizerContext) -> PlanNode:
    """Stamp CBO NDV/skew estimates onto aggregation and join nodes as
    adaptive-strategy hints (exec/adaptive.py): aggregations carry
    (input rows, group NDV) so the partial-agg mode controller starts
    in the right lattice position; inner joins carry the build side's
    rows/NDV duplication so an over-threshold skewed build routes to
    the partitioned hybrid join without a wasted unique-probe prep.
    Runs LAST in optimize() — every other rule rebuilds nodes through
    with_sources, which preserves the fields, but the estimates
    themselves must see the final shape."""
    new_sources = [annotate_adaptive_hints(s, ctx) for s in node.sources]
    if not all(a is b for a, b in zip(new_sources, node.sources)):
        node = node.with_sources(new_sources)
    try:
        if isinstance(node, AggregationNode) and node.group_by and \
                node.step in (AggStep.SINGLE, AggStep.PARTIAL):
            rows = ctx.stats.rows(node.source)
            groups = ctx.stats.rows(node)
            if rows and groups:
                node = dataclasses.replace(
                    node, rows_estimate=float(rows),
                    ndv_estimate=float(groups))
        elif isinstance(node, JoinNode) and node.criteria and \
                node.kind == JoinKind.INNER:
            brows = ctx.stats.rows(node.right)
            ndvs = [ctx.stats.ndv(node.right, c.right.name)
                    for c in node.criteria]
            known = [n for n in ndvs if n]
            if brows and known:
                node = dataclasses.replace(
                    node, build_skew_estimate=(
                        float(brows) / max(min(known), 1.0)))
    except Exception:
        pass    # estimates are hints: a stats failure must not fail planning
    try:
        # MXU probe-strategy candidate (surfaced by EXPLAIN as `join
        # strategy: mxu-matmul | gather`): an INNER single-clause
        # equi-join is matmul-ELIGIBLE when the session enables the
        # path; the executor's runtime router re-decides from the
        # OBSERVED build-key density (the CBO has NDV but no key span),
        # so this stamp is the plan-time candidate, not the verdict.
        # Plan-cache-safe: mxu_join_* are PLAN_PROPERTIES.
        mxu_on = bool(ctx.session.get("mxu_join_enabled"))
        if isinstance(node, JoinNode) and node.criteria:
            strategy = "mxu-matmul" if (
                mxu_on and node.kind == JoinKind.INNER
                and len(node.criteria) == 1) else "gather"
            node = dataclasses.replace(node, join_strategy=strategy)
        elif isinstance(node, SemiJoinNode):
            strategy = "mxu-matmul" if (
                mxu_on and len(node.source_keys) == 1) else "gather"
            node = dataclasses.replace(node, join_strategy=strategy)
    except Exception:
        pass
    return node


def optimize(root: OutputNode, metadata: Metadata, session: Session,
             distributed: bool = False) -> OutputNode:
    from trino_tpu_torch.planner.validator import validate_plan
    ctx = OptimizerContext(metadata, session, StatsEstimator(metadata))
    rules = [
        FoldConstants(),
        MergeFilters(),
        ExtractCommonPredicates(),
        MergeAdjacentProjects(),
        RemoveIdentityProjections(),
        PredicatePushDown(),
        MergeLimits(),
        EvaluateZeroLimit(),
        PushLimitThroughProject(),
        CreateTopN(),
    ]
    root = run_rules(root, rules, ctx)
    root = validate_plan(prune_unreferenced(root))
    root = reorder_joins(root, ctx)
    root = run_rules(root, [
        MergeFilters(), MergeAdjacentProjects(), RemoveIdentityProjections(),
        PredicatePushDown(),
        PushPredicateIntoTableScan(), PushLimitIntoTableScan(),
        DetermineJoinDistributionType(), FlipJoinSides(),
    ], ctx)
    root = validate_plan(prune_unreferenced(root))
    if distributed:
        root = add_exchanges(root, ctx)
    return annotate_adaptive_hints(root, ctx)
