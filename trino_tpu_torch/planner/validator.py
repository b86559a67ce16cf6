"""Plan sanity checker run between optimizer stages.

Reference parity: sql/planner/sanity/PlanSanityChecker.java (+
ValidateDependenciesChecker.java:66): every symbol an expression
references must be produced by the node's children, output symbol names
must be unique per node, and join criteria sides must come from the
correct child. Catches optimizer-rule bugs at plan time instead of as
cryptic executor KeyErrors.
"""

from __future__ import annotations

from typing import Set

from trino_tpu_torch.expr.ir import RowExpression, SymbolRef
from trino_tpu_torch.planner.nodes import (
    AggregationNode, FilterNode, GroupIdNode, JoinNode, OutputNode,
    PlanNode, ProjectNode, SemiJoinNode, SortNode, TableScanNode, TopNNode,
    UnnestNode, ValuesNode, WindowNode)


class PlanValidationError(Exception):
    pass


def _refs(e: RowExpression) -> Set[str]:
    out: Set[str] = set()

    def visit(x):
        if isinstance(x, SymbolRef):
            out.add(x.name)
        for c in x.children():
            visit(c)
    visit(e)
    return out


def validate_plan(root: PlanNode) -> PlanNode:
    """Raise PlanValidationError on a broken plan; returns the plan so it
    slots into the optimize() pipeline."""

    def check(node: PlanNode) -> None:
        for s in node.sources:
            check(s)
        child_syms: Set[str] = set()
        for s in node.sources:
            child_syms |= {x.name for x in s.outputs}

        def need(names: Set[str], what: str) -> None:
            missing = names - child_syms
            if missing:
                raise PlanValidationError(
                    f"{type(node).__name__}: {what} references "
                    f"{sorted(missing)} not produced by children")

        if isinstance(node, (TableScanNode, ValuesNode)):
            pass
        elif isinstance(node, FilterNode):
            need(_refs(node.predicate), "predicate")
        elif isinstance(node, ProjectNode):
            for _, e in node.assignments:
                need(_refs(e), "assignment")
        elif isinstance(node, JoinNode):
            left = {s.name for s in node.left.outputs}
            right = {s.name for s in node.right.outputs}
            for c in node.criteria:
                if c.left.name not in left:
                    raise PlanValidationError(
                        f"join criterion left {c.left.name} not in left "
                        "child")
                if c.right.name not in right:
                    raise PlanValidationError(
                        f"join criterion right {c.right.name} not in "
                        "right child")
            if node.filter is not None:
                need(_refs(node.filter), "residual filter")
            if node.output_symbols is not None:
                extra = {s.name for s in node.output_symbols} - (
                    left | right)
                if extra:
                    raise PlanValidationError(
                        f"join output_symbols {sorted(extra)} not in "
                        "either child")
        elif isinstance(node, SemiJoinNode):
            src = {s.name for s in node.source.outputs}
            filt = {s.name for s in node.filtering_source.outputs}
            for s in node.source_keys:
                if s.name not in src:
                    raise PlanValidationError(
                        f"semi-join source key {s.name} missing")
            for s in node.filtering_keys:
                if s.name not in filt:
                    raise PlanValidationError(
                        f"semi-join filtering key {s.name} missing")
        elif isinstance(node, AggregationNode):
            need({s.name for s in node.group_by}, "group keys")
            for _, call in node.aggregations:
                for a in call.args:
                    need(_refs(a), "aggregate argument")
        elif isinstance(node, (SortNode, TopNNode)):
            need({o.symbol.name for o in node.order_by}, "sort keys")
        elif isinstance(node, WindowNode):
            need({s.name for s in node.partition_by}, "partition keys")
            need({o.symbol.name for o in node.order_by}, "window order")
        elif isinstance(node, GroupIdNode):
            req = {s.name for gs in node.grouping_sets for s in gs}
            need(req, "grouping sets")
        elif isinstance(node, UnnestNode):
            need({s.name for s in node.arrays}, "unnest arrays")
        # outputs must be uniquely named
        names = [s.name for s in node.outputs]
        if len(names) != len(set(names)):
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise PlanValidationError(
                f"{type(node).__name__}: duplicate output symbols "
                f"{dupes}")

    if isinstance(root, OutputNode):
        check(root.source)
        have = {s.name for s in root.source.outputs}
        missing = {s.name for s in root.symbols} - have
        if missing:
            raise PlanValidationError(
                f"Output references {sorted(missing)} not produced")
    else:
        check(root)
    return root
