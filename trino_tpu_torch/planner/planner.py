"""Logical planner: analyzed AST -> symbol-based plan.

Reference parity: sql/planner/LogicalPlanner.java:196 + QueryPlanner.java +
RelationPlanner.java + SubqueryPlanner.java. One-pass design: translation
types expressions while planning (analyzer rules live in sql/analyzer.py).

Subquery support (SubqueryPlanner + TransformCorrelated* rules condensed):
- uncorrelated scalar subquery  -> EnforceSingleRow + cross join
- correlated scalar aggregate with equality correlation
                                -> group-by-correlation-keys + LEFT join
- [NOT] IN (subquery)           -> SemiJoinNode (+ NOT via negated filter)
- [NOT] EXISTS with equality correlation -> SemiJoinNode on the keys
NOT IN is null-aware (SemiJoinNode.null_aware): the executor applies full
IN-subquery three-valued logic — a NULL probe value or a NULL in a non-empty
subquery result makes membership UNKNOWN, so NOT IN keeps a row only when
the subquery column is null-free (and x NOT IN (empty) is TRUE even for
NULL x). NOT EXISTS uses non-null-aware anti semantics (NULL correlation
keys simply never match).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from trino_tpu_torch import types as T
from trino_tpu_torch.expr.ir import (Call, Literal, RowExpression, SpecialForm,
                               SpecialKind, SymbolRef)
from trino_tpu_torch.metadata import Metadata, Session
from trino_tpu_torch.planner.nodes import (
    AggCall, AggregationNode, AggStep, AssignUniqueIdNode, DistinctLimitNode,
    EnforceSingleRowNode, FilterNode, GroupIdNode, JoinClause, JoinKind,
    JoinNode, LimitNode, OffsetNode, Ordering, OutputNode, PlanNode,
    ProjectNode, SemiJoinNode, SortNode, Symbol, SymbolAllocator,
    TableScanNode, TopNNode, UnionNode, UnnestNode, ValuesNode,
    WindowFunction, WindowNode)
from trino_tpu_torch.planner.translate import (
    ExpressionTranslator, Field, Scope, cast_to, make_comparison)
from trino_tpu_torch.sql import tree as t
from trino_tpu_torch.sql.analyzer import (SemanticError, common_type, is_aggregate,
                                    is_window, resolve_aggregate)


@dataclasses.dataclass
class RelationPlan:
    node: PlanNode
    scope: Scope


def _conjuncts(e: t.Expression) -> List[t.Expression]:
    if isinstance(e, t.LogicalBinary) and e.op == "AND":
        return _conjuncts(e.left) + _conjuncts(e.right)
    return [e]


def _combine_ast(parts: Sequence[t.Expression]) -> t.Expression:
    out = parts[0]
    for p in parts[1:]:
        out = t.LogicalBinary("AND", out, p)
    return out


def _has_subquery(e: t.Expression) -> bool:
    for n in t.walk(e):
        if isinstance(n, (t.SubqueryExpression, t.ExistsPredicate,
                          t.InPredicate)):
            if isinstance(n, t.InPredicate) and not isinstance(
                    n.value_list, t.SubqueryExpression):
                continue
            return True
    return False


def combine_conjuncts(parts: Sequence[RowExpression]) -> RowExpression:
    out = parts[0]
    for p in parts[1:]:
        out = SpecialForm(SpecialKind.AND, (out, p), T.BOOLEAN)
    return out


class LogicalPlanner:
    """LogicalPlanner.java:196 — entry point producing an OutputNode root."""

    def __init__(self, metadata: Metadata, session: Session):
        self.metadata = metadata
        self.session = session
        self.symbols = SymbolAllocator()

    def plan(self, statement: t.Statement) -> OutputNode:
        if isinstance(statement, t.Query):
            plan, names = self._plan_root_query(statement)
            return OutputNode(plan.node, tuple(names),
                              tuple(f.symbol for f in plan.scope.fields))
        raise SemanticError(
            f"cannot plan statement: {type(statement).__name__}")

    # ------------------------------------------------------------- queries

    def _plan_root_query(self, query: t.Query):
        plan = self._plan_query(query, None, {})
        names = []
        for i, f in enumerate(plan.scope.fields):
            names.append(f.name or f"_col{i}")
        return plan, names

    def _plan_query(self, query: t.Query, outer: Optional[Scope],
                    ctes: Dict[str, t.WithQuery]) -> RelationPlan:
        ctes = dict(ctes)
        if query.with_ is not None:
            if query.with_.recursive:
                raise SemanticError("recursive WITH not supported")
            for wq in query.with_.queries:
                ctes[wq.name.value] = wq
        plan = self._plan_query_body(query.body, outer, ctes)
        # trailing ORDER BY / OFFSET / LIMIT of a query expression
        plan = self._plan_order_limit(plan, query.order_by, query.offset,
                                      query.limit, outer, ctes)
        return plan

    def _plan_query_body(self, body: t.QueryBody, outer: Optional[Scope],
                         ctes: Dict[str, t.WithQuery]) -> RelationPlan:
        if isinstance(body, t.QuerySpecification):
            return self._plan_query_spec(body, outer, ctes)
        if isinstance(body, t.SetOperation):
            return self._plan_set_operation(body, outer, ctes)
        raise SemanticError(f"unsupported query body: {type(body).__name__}")

    def _plan_set_operation(self, body: t.SetOperation, outer, ctes
                            ) -> RelationPlan:
        if body.op in ("INTERSECT", "EXCEPT"):
            return self._plan_intersect_except(body, outer, ctes)
        if body.op != "UNION":
            raise SemanticError(f"{body.op} not supported yet")
        left = self._plan_query_body(body.left, outer, ctes)
        right = self._plan_query_body(body.right, outer, ctes)
        lf, rf = left.scope.fields, right.scope.fields
        if len(lf) != len(rf):
            raise SemanticError("UNION inputs have different column counts")
        out_syms, mappings, children = [], [], []
        casted = []
        for side in (left, right):
            casted.append(side)
        # compute common types; insert cast projections where needed
        types = []
        for a, b in zip(lf, rf):
            ct = common_type(a.symbol.type, b.symbol.type)
            if ct is None:
                raise SemanticError("UNION column types incompatible")
            types.append(ct)
        sides = []
        for side in (left, right):
            needs_cast = any(f.symbol.type != ty
                             for f, ty in zip(side.scope.fields, types))
            if needs_cast:
                assigns = []
                for f, ty in zip(side.scope.fields, types):
                    sym = self.symbols.new(f.name or "col", ty)
                    assigns.append((sym, cast_to(f.symbol.ref(), ty)))
                node = ProjectNode(side.node, tuple(assigns))
                sides.append((node, [s for s, _ in assigns]))
            else:
                sides.append((side.node, [f.symbol
                                          for f in side.scope.fields]))
        for i, (f, ty) in enumerate(zip(lf, types)):
            out_syms.append(self.symbols.new(f.name or f"col{i}", ty))
        mappings = tuple(
            tuple(side_syms[i] for _, side_syms in sides)
            for i in range(len(out_syms)))
        children = tuple(node for node, _ in sides)
        union = UnionNode(children, tuple(out_syms), mappings)
        fields = [Field(f.name, None, s) for f, s in zip(lf, out_syms)]
        result: PlanNode = union
        if body.distinct:
            result = AggregationNode(union, tuple(out_syms), ())
        return RelationPlan(result, Scope(fields, outer))

    def _plan_intersect_except(self, body: t.SetOperation, outer, ctes
                               ) -> RelationPlan:
        """INTERSECT/EXCEPT [DISTINCT] as distinct(left) SEMI/ANTI-joined
        against the right on every column (sql/planner/QueryPlanner's
        set-operation lowering via SemiJoin + MarkDistinct, condensed).
        NULL rows never match (generated datasets are null-free here;
        IS-NOT-DISTINCT matching is a known deviation for NULL keys)."""
        if not body.distinct:
            raise SemanticError(f"{body.op} ALL not supported yet")
        left = self._plan_query_body(body.left, outer, ctes)
        right = self._plan_query_body(body.right, outer, ctes)
        lf, rf = left.scope.fields, right.scope.fields
        if len(lf) != len(rf):
            raise SemanticError(
                f"{body.op} inputs have different column counts")
        types = []
        for a, b in zip(lf, rf):
            ct = common_type(a.symbol.type, b.symbol.type)
            if ct is None:
                raise SemanticError(f"{body.op} column types incompatible")
            types.append(ct)

        def casted(side):
            if all(f.symbol.type == ty
                   for f, ty in zip(side.scope.fields, types)):
                return side.node, [f.symbol for f in side.scope.fields]
            assigns = []
            for f, ty in zip(side.scope.fields, types):
                sym = self.symbols.new(f.name or "col", ty)
                assigns.append((sym, cast_to(f.symbol.ref(), ty)))
            return ProjectNode(side.node, tuple(assigns)), \
                [s for s, _ in assigns]
        lnode, lsyms = casted(left)
        rnode, rsyms = casted(right)
        distinct = AggregationNode(lnode, tuple(lsyms), ())
        match = self.symbols.new("setopmatch", T.BOOLEAN)
        semi = SemiJoinNode(distinct, rnode, tuple(lsyms), tuple(rsyms),
                            match, negate=False, null_aware=False)
        keep = match.ref() if body.op == "INTERSECT" else SpecialForm(
            SpecialKind.NOT, (match.ref(),), T.BOOLEAN)
        filt = FilterNode(semi, keep)
        proj = ProjectNode(filt, tuple((s, s.ref()) for s in lsyms))
        fields = [Field(f.name, None, s) for f, s in zip(lf, lsyms)]
        return RelationPlan(proj, Scope(fields, outer))

    # ----------------------------------------------------------- relations

    def _plan_relation(self, rel: t.Relation, outer: Optional[Scope],
                       ctes: Dict[str, t.WithQuery]) -> RelationPlan:
        if isinstance(rel, t.Table):
            name = rel.name
            if len(name.parts) == 1 and name.parts[0] in ctes:
                wq = ctes[name.parts[0]]
                sub = self._plan_query(wq.query, outer,
                                       {k: v for k, v in ctes.items()
                                        if k != name.parts[0]})
                alias = wq.name.value
                fields = []
                for i, f in enumerate(sub.scope.fields):
                    col = (wq.column_names[i].value
                           if i < len(wq.column_names) else f.name)
                    fields.append(Field(col, alias, f.symbol))
                return RelationPlan(sub.node, Scope(fields, outer))
            return self._plan_table(rel, outer)
        if isinstance(rel, t.AliasedRelation):
            sub = self._plan_relation(rel.relation, outer, ctes)
            alias = rel.alias.value
            fields = []
            for i, f in enumerate(sub.scope.fields):
                col = (rel.column_names[i].value
                       if i < len(rel.column_names) else f.name)
                fields.append(Field(col, alias, f.symbol))
            return RelationPlan(sub.node, Scope(fields, outer))
        if isinstance(rel, t.TableSubquery):
            # CTEs stay visible inside derived tables (q33-style
            # `FROM (SELECT ... FROM some_cte UNION ALL ...)`)
            sub = self._plan_query(rel.query, outer, ctes)
            # subquery loses outer qualifiers
            fields = [Field(f.name, None, f.symbol)
                      for f in sub.scope.fields]
            return RelationPlan(sub.node, Scope(fields, outer))
        if isinstance(rel, t.Join):
            return self._plan_join(rel, outer, ctes)
        if isinstance(rel, t.Values):
            return self._plan_values(rel, outer)
        if isinstance(rel, t.Unnest):
            # standalone FROM UNNEST(...): expand against one dummy row
            dummy = self.symbols.new("unnest_src", T.BIGINT)
            src = RelationPlan(
                ValuesNode((dummy,), ((Literal(0, T.BIGINT),),)),
                Scope([], outer))
            return self._plan_unnest(src, rel, None, outer)
        raise SemanticError(f"unsupported relation: {type(rel).__name__}")

    def _plan_unnest(self, left: RelationPlan, un: t.Unnest,
                     alias_rel: Optional[t.AliasedRelation],
                     outer) -> RelationPlan:
        """CROSS JOIN UNNEST(arr [, ...]) [WITH ORDINALITY] [AS a(c...)].
        One ARRAY argument yields one element column; a MAP argument
        yields (key, value)."""
        tr = ExpressionTranslator(left.scope)
        exprs = [tr.translate(e) for e in un.expressions]
        if len(exprs) > 1:
            raise SemanticError(
                "UNNEST of multiple arrays (zip) not supported yet")
        node = left.node
        array_syms = []
        pre = [(s, s.ref()) for s in node.outputs]
        for e in exprs:
            if not isinstance(e.type, (T.ArrayType, T.MapType)):
                raise SemanticError(
                    f"UNNEST argument must be ARRAY or MAP, got "
                    f"{e.type.display()}")
            if isinstance(e, SymbolRef):
                array_syms.append(Symbol(e.name, e.type))
            else:
                sym = self.symbols.new("unnest_arr", e.type)
                pre.append((sym, e))
                array_syms.append(sym)
        if len(pre) > len(node.outputs):
            node = ProjectNode(node, tuple(pre))
        names = [c.value for c in alias_rel.column_names] \
            if alias_rel is not None else []
        alias = alias_rel.alias.value if alias_rel is not None else None
        elements = []
        fields = list(left.scope.fields)
        ni = 0

        def next_name(default):
            nonlocal ni
            name = names[ni] if ni < len(names) else default
            ni += 1
            return name

        for s in array_syms:
            if isinstance(s.type, T.MapType):
                k = self.symbols.new("unnest_key", s.type.key)
                v = self.symbols.new("unnest_val", s.type.value)
                elements.append((k, v))
                fields.append(Field(next_name("key"), alias, k))
                fields.append(Field(next_name("value"), alias, v))
            else:
                el = self.symbols.new("unnest_el", s.type.element)
                elements.append((el,))
                fields.append(Field(next_name("col"), alias, el))
        ordi = None
        if un.with_ordinality:
            ordi = self.symbols.new("ordinality", T.BIGINT)
            fields.append(Field(next_name("ordinality"), alias, ordi))
        out = UnnestNode(node, tuple(array_syms), tuple(elements), ordi)
        return RelationPlan(out, Scope(fields, outer))

    def _plan_table(self, rel: t.Table, outer: Optional[Scope]) -> RelationPlan:
        qname = self.metadata.resolve_table_name(rel.name.parts, self.session)
        handle = self.metadata.get_table_handle(qname)
        if handle is None:
            raise SemanticError(f"table not found: {qname}")
        handle = self._pin_snapshot(rel, qname, handle)
        meta = self.metadata.get_table_metadata(qname.catalog, handle)
        columns = self.metadata.get_column_handles(qname.catalog, handle)
        assignments = []
        fields = []
        for col in columns:
            sym = self.symbols.new(col.name, col.type)
            assignments.append((sym, col))
            fields.append(Field(col.name, qname.table, sym))
        node = TableScanNode(qname.catalog, handle, tuple(assignments))
        return RelationPlan(node, Scope(fields, outer))

    def _pin_snapshot(self, rel: t.Table, qname, handle):
        """Resolve time travel (`FOR VERSION|TIMESTAMP AS OF`) and the
        MV refresher's internal scan pins into a version-pinned handle.
        Scan pins ride the session as `_mv_scan_pins`:
        {(catalog, schema, table): (v_from_or_None, v_to)} — never set
        by SQL; the runner bypasses the plan/result caches while they
        are armed."""
        pins = getattr(self.session, "_mv_scan_pins", None) or {}
        pin = pins.get((qname.catalog, qname.schema, qname.table))
        if rel.version is None and rel.timestamp is None and pin is None:
            return handle
        conn = self.metadata.connector(qname.catalog)
        resolve = getattr(conn.metadata, "resolve_version", None)
        if resolve is None:
            raise SemanticError(
                f"catalog '{qname.catalog}' does not support versioned "
                f"(time travel) reads")
        if pin is not None:
            delta_from, v_to = pin
            return dataclasses.replace(handle, version=int(v_to),
                                       delta_from=delta_from)
        try:
            if rel.version is not None:
                v = resolve(qname.schema_table,
                            version=_literal_version(rel.version))
            else:
                v = resolve(qname.schema_table,
                            timestamp=_literal_timestamp(rel.timestamp))
        except KeyError as e:
            raise SemanticError(str(e))
        return dataclasses.replace(handle, version=v)

    def _plan_values(self, rel: t.Values, outer) -> RelationPlan:
        rows = []
        for row_expr in rel.rows:
            items = (row_expr.items if isinstance(row_expr, t.Row)
                     else (row_expr,))
            tr = ExpressionTranslator(Scope([], None), session=self.session)
            rows.append(tuple(tr.translate(e) for e in items))
        width = len(rows[0])
        if any(len(r) != width for r in rows):
            raise SemanticError("VALUES rows have different column counts")
        types = []
        for i in range(width):
            ct = rows[0][i].type
            for r in rows[1:]:
                nt = common_type(ct, r[i].type)
                if nt is None:
                    raise SemanticError("VALUES column types incompatible")
                ct = nt
        # degrade unknown (all-null column) to bigint for execution
            types.append(T.BIGINT if isinstance(ct, T.UnknownType) else ct)
        rows = [tuple(cast_to(e, types[i]) for i, e in enumerate(r))
                for r in rows]
        syms = tuple(self.symbols.new(f"_col{i}", types[i])
                     for i in range(width))
        fields = [Field(f"_col{i}", None, s) for i, s in enumerate(syms)]
        return RelationPlan(ValuesNode(syms, tuple(rows)),
                            Scope(fields, outer))

    def _plan_join(self, rel: t.Join, outer, ctes) -> RelationPlan:
        # UNNEST on the right side is LATERAL-correlated: its expressions
        # see the LEFT relation (RelationPlanner.planJoinUnnest analog)
        inner_right = rel.right
        unnest_alias = None
        if isinstance(inner_right, t.AliasedRelation) and \
                isinstance(inner_right.relation, t.Unnest):
            unnest_alias = inner_right
            inner_right = inner_right.relation
        if isinstance(inner_right, t.Unnest):
            if rel.join_type not in ("IMPLICIT", "CROSS", "INNER"):
                raise SemanticError(
                    f"{rel.join_type} JOIN UNNEST not supported")
            left = self._plan_relation(rel.left, outer, ctes)
            return self._plan_unnest(left, inner_right, unnest_alias,
                                     outer)
        left = self._plan_relation(rel.left, outer, ctes)
        right = self._plan_relation(rel.right, outer, ctes)
        join_scope = Scope(left.scope.fields + right.scope.fields, outer)

        if rel.join_type in ("IMPLICIT", "CROSS"):
            node = JoinNode(JoinKind.CROSS, left.node, right.node, ())
            return RelationPlan(node, join_scope)

        kind = {"INNER": JoinKind.INNER, "LEFT": JoinKind.LEFT,
                "RIGHT": JoinKind.RIGHT, "FULL": JoinKind.FULL}[rel.join_type]
        swapped = False
        if kind == JoinKind.RIGHT:
            # normalize RIGHT to LEFT by swapping inputs (Trino AstBuilder
            # keeps RIGHT; its LocalExecutionPlanner flips — we flip early).
            # join_scope above was built pre-swap, preserving SELECT * order;
            # the USING branch below rebuilds fields orientation-aware.
            left, right = right, left
            kind = JoinKind.LEFT
            swapped = True

        criteria: List[JoinClause] = []
        residual: List[RowExpression] = []
        using_cols: List[str] = []
        if isinstance(rel.criteria, t.JoinUsing) or rel.criteria is None:
            names = ([c.value for c in rel.criteria.columns]
                     if rel.criteria else
                     sorted({f.name for f in left.scope.fields} &
                            {f.name for f in right.scope.fields}))
            for name in names:
                lf = [f for f in left.scope.fields if f.name == name]
                rf = [f for f in right.scope.fields if f.name == name]
                if len(lf) != 1 or len(rf) != 1:
                    raise SemanticError(f"USING column {name} ambiguous")
                lsym, rsym = lf[0].symbol, rf[0].symbol
                lx, rx = self._coerce_join_keys(lsym.ref(), rsym.ref())
                lsym2 = self._key_symbol(lx, "join_l")
                rsym2 = self._key_symbol(rx, "join_r")
                if lsym2 != lsym or rsym2 != rsym:
                    # needs projection below each side
                    left, lsym2 = self._append_projection(left, lx)
                    right, rsym2 = self._append_projection(right, rx)
                criteria.append(JoinClause(lsym2, rsym2))
                using_cols.append(name)
            # USING scope: join columns once, then remaining columns of the
            # ORIGINAL left, then remaining right (Trino output order; the
            # key value comes from the preserved/probe side = post-swap left)
            key_fields = [f for f in left.scope.fields
                          if f.name in using_cols]
            first, second = (right, left) if swapped else (left, right)
            fields = (key_fields +
                      [f for f in first.scope.fields
                       if f.name not in using_cols] +
                      [f for f in second.scope.fields
                       if f.name not in using_cols])
            join_scope = Scope(fields, outer)
        elif isinstance(rel.criteria, t.JoinOn):
            criteria, residual, left, right = self._extract_equi_criteria(
                rel.criteria.expression, left, right, join_scope)
        if kind == JoinKind.LEFT and residual:
            # ON conditions over the build side only restrict which build
            # rows can match -> pre-filter the build side (outer semantics
            # preserved). Mixed-side non-equi LEFT conditions need operator
            # filter support (tracked; q21-class queries).
            right_syms = {f.symbol.name for f in right.scope.fields}
            kept = []
            for p in residual:
                syms = _symbols_in(p)
                if syms and syms <= right_syms:
                    right = RelationPlan(FilterNode(right.node, p),
                                         right.scope)
                else:
                    kept.append(p)
            residual = kept
            if residual:
                raise SemanticError(
                    "LEFT JOIN with non-equi conditions across both sides "
                    "is not supported yet")
        node = JoinNode(kind, left.node, right.node, tuple(criteria),
                        combine_conjuncts(residual) if residual else None)
        return RelationPlan(node, Scope(join_scope.fields, outer))

    def _append_projection(self, plan: RelationPlan, expr: RowExpression
                           ) -> Tuple[RelationPlan, Symbol]:
        if isinstance(expr, SymbolRef):
            return plan, Symbol(expr.name, expr.type)
        sym = self.symbols.new("expr", expr.type)
        assigns = [(f.symbol, f.symbol.ref()) for f in plan.scope.fields]
        assigns.append((sym, expr))
        node = ProjectNode(plan.node, tuple(assigns))
        return RelationPlan(node, plan.scope), sym

    def _key_symbol(self, expr: RowExpression, hint: str) -> Symbol:
        if isinstance(expr, SymbolRef):
            return Symbol(expr.name, expr.type)
        return self.symbols.new(hint, expr.type)

    def _coerce_join_keys(self, lx: RowExpression, rx: RowExpression):
        ct = common_type(lx.type, rx.type)
        if ct is None:
            raise SemanticError("join key types incompatible")
        return cast_to(lx, ct), cast_to(rx, ct)

    def _extract_equi_criteria(self, on: t.Expression, left: RelationPlan,
                               right: RelationPlan, join_scope: Scope):
        """Split ON into equi-join clauses + residual filter
        (ReorderJoins/JoinNode criteria extraction)."""
        left_names = {f.symbol.name for f in left.scope.fields}
        right_names = {f.symbol.name for f in right.scope.fields}
        criteria: List[JoinClause] = []
        residual: List[RowExpression] = []
        tr = ExpressionTranslator(join_scope, session=self.session)
        for conj in _conjuncts(on):
            handled = False
            if isinstance(conj, t.ComparisonExpression) and conj.op == "=":
                a = tr.translate(conj.left)
                b = tr.translate(conj.right)
                sa = _symbols_in(a)
                sb = _symbols_in(b)
                if sa <= left_names and sb <= right_names and sa and sb:
                    la, rb = a, b
                elif sb <= left_names and sa <= right_names and sa and sb:
                    la, rb = b, a
                else:
                    la = rb = None
                if la is not None:
                    la, rb = self._coerce_join_keys(la, rb)
                    lsym = self._key_symbol(la, "join_l")
                    rsym = self._key_symbol(rb, "join_r")
                    if not isinstance(la, SymbolRef):
                        left, lsym = self._append_projection(left, la)
                    if not isinstance(rb, SymbolRef):
                        right, rsym = self._append_projection(right, rb)
                    criteria.append(JoinClause(lsym, rsym))
                    handled = True
            if not handled:
                residual.append(tr.translate(conj))
        return criteria, residual, left, right

    # ------------------------------------------------- query specification

    def _plan_query_spec(self, spec: t.QuerySpecification,
                         outer: Optional[Scope],
                         ctes: Dict[str, t.WithQuery]) -> RelationPlan:
        # FROM
        if spec.from_ is not None:
            source = self._plan_relation(spec.from_, outer, ctes)
        else:
            sym = self.symbols.new("dual", T.BIGINT)
            source = RelationPlan(
                ValuesNode((sym,), ((Literal(0, T.BIGINT),),)),
                Scope([], outer))
        builder = _PlanBuilder(self, source, ctes)

        # WHERE
        if spec.where is not None:
            builder.plan_where(spec.where)

        # aggregation / grouping
        select_items = self._expand_select(spec, builder.scope())
        agg_calls = self._collect_aggregates(spec, select_items)
        group_elements = spec.group_by.elements if spec.group_by else ()
        has_agg = bool(agg_calls) or spec.group_by is not None
        if has_agg:
            builder.plan_aggregation(group_elements, agg_calls, select_items,
                                     spec.having)
        if spec.having is not None:
            builder.plan_having(spec.having)

        # window functions
        win_calls = [fc for fc in _find_calls(
            [e for e, _ in select_items] +
            [s.key for s in (spec.order_by or ())])
            if fc.window is not None]
        if win_calls:
            builder.plan_windows(win_calls)

        # SELECT projection (+ extra sort keys), DISTINCT, ORDER BY, LIMIT.
        # ORDER BY may reference source columns that are not selected
        # (QueryPlanner's ORDER BY scope): carry them through the projection
        # and prune after the sort.
        order_keep: Tuple[Symbol, ...] = ()
        pre_fields = builder.scope().fields
        if spec.order_by and not spec.select.distinct:
            order_keep = builder.sort_key_source_symbols(spec.order_by)
        out_fields = builder.plan_select(select_items, keep=order_keep)
        if spec.select.distinct:
            builder.plan_distinct(out_fields)
        if spec.order_by:
            builder.plan_order_by(spec.order_by, out_fields,
                                  pre_fields if order_keep else None)
        if spec.offset is not None:
            builder.plan_offset(_literal_count(spec.offset, "OFFSET"))
        if spec.limit is not None:
            builder.plan_limit(_literal_count(spec.limit, "LIMIT"))
        builder.prune_to(out_fields)
        return RelationPlan(builder.node, Scope(out_fields, outer))

    def _plan_order_limit(self, plan: RelationPlan,
                          order_by: Tuple[t.SortItem, ...],
                          offset: Optional[t.Expression],
                          limit: Optional[t.Expression],
                          outer, ctes) -> RelationPlan:
        if not order_by and offset is None and limit is None:
            return plan
        builder = _PlanBuilder(self, plan, ctes)
        fields = plan.scope.fields
        if order_by:
            builder.plan_order_by(order_by, fields)
        if offset is not None:
            builder.plan_offset(_literal_count(offset, "OFFSET"))
        if limit is not None:
            builder.plan_limit(_literal_count(limit, "LIMIT"))
        return RelationPlan(builder.node, Scope(fields, outer))

    # ------------------------------------------------------------ helpers

    def _expand_select(self, spec: t.QuerySpecification, scope: Scope
                       ) -> List[Tuple[t.Expression, Optional[str]]]:
        """Select items -> (expression AST, output name); expands `*`."""
        items: List[Tuple[t.Expression, Optional[str]]] = []
        for item in spec.select.items:
            if isinstance(item, t.AllColumns):
                prefix = item.prefix.parts[-1] if item.prefix else None
                matched = False
                for f in scope.fields:
                    if prefix is None or f.qualifier == prefix:
                        if f.name is None:
                            continue
                        matched = True
                        items.append((t.Identifier(f.name) if prefix is None
                                      else t.DereferenceExpression(
                                          t.Identifier(prefix),
                                          t.Identifier(f.name)), f.name))
                if not matched:
                    raise SemanticError(
                        f"no columns for {prefix}.*" if prefix else
                        "SELECT * with no FROM columns")
            else:
                assert isinstance(item, t.SingleColumn)
                name = None
                if item.alias is not None:
                    name = item.alias.value
                elif isinstance(item.expression, t.Identifier):
                    name = item.expression.value
                elif isinstance(item.expression, t.DereferenceExpression):
                    name = item.expression.field.value
                items.append((item.expression, name))
        return items

    def _collect_aggregates(self, spec, select_items):
        exprs = [e for e, _ in select_items]
        if spec.having is not None:
            exprs.append(spec.having)
        for s in (spec.order_by or ()):
            exprs.append(s.key)
        return [fc for fc in _find_calls(exprs)
                if is_aggregate(fc.name.suffix) and fc.window is None]


def _find_calls(exprs: Sequence[t.Expression]) -> List[t.FunctionCall]:
    """Top-most aggregate/window FunctionCalls (not nested inside another)."""
    out: List[t.FunctionCall] = []
    seen = set()

    def visit(node: t.Expression):
        if isinstance(node, t.FunctionCall) and (
                is_aggregate(node.name.suffix) or node.window is not None):
            if id(node) not in seen:
                seen.add(id(node))
                out.append(node)
            if node.window is not None:
                # a window call may legally contain GROUP aggregates —
                # sum(sum(x)) OVER (...), rank() OVER (ORDER BY sum(x)) —
                # which must be collected for the aggregation phase
                for a in node.args:
                    visit(a)
                for e in node.window.partition_by:
                    visit(e)
                for s in node.window.order_by:
                    visit(s.key)
            return  # below a plain aggregate: nested aggs are illegal
        if isinstance(node, (t.SubqueryExpression, t.ExistsPredicate)):
            return  # subquery aggregates belong to the subquery
        for child in _ast_children(node):
            visit(child)

    for e in exprs:
        visit(e)
    return out


def _ast_children(node: t.Node):
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        items = v if isinstance(v, tuple) else (v,)
        for item in items:
            if isinstance(item, t.Node):
                yield item


def _symbols_in(e: RowExpression) -> set:
    out = set()

    def visit(x: RowExpression):
        if isinstance(x, SymbolRef):
            out.add(x.name)
        for c in x.children():
            visit(c)
    visit(e)
    return out


def _literal_count(e: t.Expression, what: str) -> int:
    if isinstance(e, t.LongLiteral):
        return e.value
    raise SemanticError(f"{what} must be a literal integer")


def _literal_version(e: t.Expression) -> int:
    if isinstance(e, t.LongLiteral):
        return int(e.value)
    raise SemanticError(
        "FOR VERSION AS OF expects a literal integer manifest version")


def _literal_timestamp(e: t.Expression) -> float:
    """FOR TIMESTAMP AS OF resolution: literal timestamp/string ->
    epoch seconds (manifest `committed_at` scale)."""
    from trino_tpu_torch.planner.translate import _parse_timestamp
    if isinstance(e, (t.TimestampLiteral, t.StringLiteral)):
        text = e.text if isinstance(e, t.TimestampLiteral) else e.value
        try:
            return _parse_timestamp(text) / 1e6
        except ValueError as err:
            raise SemanticError(f"invalid timestamp: {text!r}") from err
    if isinstance(e, (t.LongLiteral, t.DoubleLiteral)):
        return float(e.value)  # epoch seconds
    if isinstance(e, t.DecimalLiteral):
        return float(e.text)   # epoch seconds with a fractional part
    raise SemanticError(
        "FOR TIMESTAMP AS OF expects a literal timestamp")


class _PlanBuilder:
    """QueryPlanner's running (plan, translations) state."""

    def __init__(self, planner: LogicalPlanner, relation: RelationPlan,
                 ctes: Dict[str, t.WithQuery]):
        self.planner = planner
        self.node = relation.node
        self._scope = relation.scope
        self.ctes = ctes
        self.substitutions: Dict[RowExpression, Symbol] = {}
        self._grouping_info = None

    def scope(self) -> Scope:
        return self._scope

    def translator(self) -> ExpressionTranslator:
        return ExpressionTranslator(
            self._scope, self.substitutions,
            subquery_handler=self._handle_subquery,
            session=self.planner.session,
            grouping_handler=(self._grouping_expr
                              if self._grouping_info else None))

    def _grouping_expr(self, tr, node):
        """grouping(k1, ..., kn) -> SWITCH over the GroupId symbol: bit i
        (MSB-first) set when key i is aggregated away in the row's
        grouping set (GroupingOperationRewriter.java semantics)."""
        gid, sets_names = self._grouping_info
        arg_names = []
        for a in node.args:
            e = tr._translate(a)
            if not isinstance(e, SymbolRef):
                raise SemanticError(
                    "grouping() arguments must be grouping keys")
            arg_names.append(e.name)
        switch: List[RowExpression] = []
        for i, present in enumerate(sets_names):
            mask = 0
            for j, an in enumerate(arg_names):
                if an not in present:
                    mask |= 1 << (len(arg_names) - 1 - j)
            switch.append(Call("eq", (gid.ref(), Literal(i, T.BIGINT)),
                               T.BOOLEAN))
            switch.append(Literal(mask, T.BIGINT))
        switch.append(Literal(0, T.BIGINT))
        return SpecialForm(SpecialKind.SWITCH, tuple(switch), T.BIGINT)

    # -------------------------------------------------------- WHERE/HAVING

    def plan_where(self, where: t.Expression):
        # apply subquery-free conjuncts FIRST: subquery translation captures
        # self.node as the probe/outer side (SubqueryPlanner's contract), so
        # base filters must already be in place or the decorrelated plan
        # re-executes the unfiltered (possibly cross-join) outer subtree
        plain: List[t.Expression] = []
        with_sub: List[t.Expression] = []
        for conj in _conjuncts(where):
            (with_sub if _has_subquery(conj) else plain).append(conj)
        if plain and with_sub:
            pred = self.translator().translate(_combine_ast(plain))
            if not isinstance(pred.type, T.BooleanType):
                raise SemanticError("WHERE clause must be boolean")
            self.node = FilterNode(self.node, pred)
            where = _combine_ast(with_sub)
        pred = self.translator().translate(where)
        if not isinstance(pred.type, T.BooleanType):
            raise SemanticError("WHERE clause must be boolean")
        self.node = FilterNode(self.node, pred)

    def plan_having(self, having: t.Expression):
        pred = self.translator().translate(having)
        self.node = FilterNode(self.node, pred)

    # --------------------------------------------------------- aggregation

    def plan_aggregation(self, group_elements, agg_calls, select_items,
                         having):
        planner = self.planner
        tr = self.translator()
        # translate grouping expressions (flat list for simple GROUP BY;
        # grouping-set structure preserved for GroupId lowering)
        grouping_sets: List[List[RowExpression]] = []
        flat: List[RowExpression] = []
        simple = True
        for el in group_elements:
            if isinstance(el, t.SimpleGroupBy):
                for e in el.expressions:
                    flat.append(self._group_expr(tr, e, select_items))
            elif isinstance(el, t.Rollup):
                simple = False
                exprs = [self._group_expr(tr, e, select_items)
                         for e in el.expressions]
                grouping_sets = [exprs[:i] for i in range(len(exprs), -1, -1)]
                flat.extend(exprs)
            elif isinstance(el, t.Cube):
                simple = False
                exprs = [self._group_expr(tr, e, select_items)
                         for e in el.expressions]
                sets = [[]]
                for e in exprs:
                    sets = sets + [s + [e] for s in sets]
                grouping_sets = sets
                flat.extend(exprs)
            elif isinstance(el, t.GroupingSets):
                simple = False
                all_sets = []
                for gset in el.sets:
                    exprs = [self._group_expr(tr, e, select_items)
                             for e in gset]
                    all_sets.append(exprs)
                    flat.extend(exprs)
                grouping_sets = all_sets
            else:
                raise SemanticError("unsupported grouping element")
        # dedupe flat keys structurally
        uniq: List[RowExpression] = []
        for e in flat:
            if e not in uniq:
                uniq.append(e)

        # pre-projection: group keys + agg arguments + agg filters
        pre_assigns: List[Tuple[Symbol, RowExpression]] = []

        def to_symbol(expr: RowExpression, hint: str) -> Symbol:
            for s, e in pre_assigns:
                if e == expr:
                    return s
            if isinstance(expr, SymbolRef):
                sym = Symbol(expr.name, expr.type)
                pre_assigns.append((sym, expr))
                return sym
            sym = planner.symbols.new(hint, expr.type)
            pre_assigns.append((sym, expr))
            return sym

        key_syms: Dict[RowExpression, Symbol] = {}
        for e in uniq:
            key_syms[e] = to_symbol(e, "group")

        aggregations: List[Tuple[Symbol, AggCall]] = []
        for fc in agg_calls:
            name = fc.name.suffix.lower()
            args = tuple(tr.translate(a) for a in fc.args)
            resolved = resolve_aggregate(name, [a.type for a in args])
            args = tuple(cast_to(a, ty)
                         for a, ty in zip(args, resolved.arg_types))
            agg_name, distinct = resolved.name, fc.distinct
            if agg_name == "approx_distinct":
                # real HyperLogLog sketch (ops/aggregate._hll_grouped,
                # m=2048 -> 2.30% standard error); the optional
                # max-standard-error argument is advisory and dropped.
                # Reference: ApproximateCountDistinctAggregation.java
                args = args[:1]
            arg_syms = tuple(to_symbol(a, "aggarg") for a in args)
            filt_sym = None
            if fc.filter is not None:
                fx = tr.translate(fc.filter)
                filt_sym = to_symbol(fx, "aggfilter").ref()
            out_sym = planner.symbols.new(name, resolved.return_type)
            call = AggCall(agg_name,
                           tuple(s.ref() for s in arg_syms),
                           distinct, filt_sym,
                           args[0].type if args else None)
            aggregations.append((out_sym, call))
            # register substitution under the canonical aggregate key
            key = tr.aggregate_key(fc)
            self.substitutions[key] = out_sym

        if pre_assigns:  # count(*) with no keys needs no pre-projection
            self.node = ProjectNode(self.node, tuple(pre_assigns))

        group_symbols = tuple(key_syms[e] for e in uniq)
        if not simple and grouping_sets:
            sets_syms = tuple(
                tuple(key_syms[e] for e in gs) for gs in grouping_sets)
            gid = planner.symbols.new("groupid", T.BIGINT)
            passthrough = tuple(
                s for s, _ in pre_assigns if s not in group_symbols)
            self.node = GroupIdNode(self.node, sets_syms, gid, passthrough)
            self.node = AggregationNode(
                self.node, group_symbols + (gid,), tuple(aggregations))
            # grouping() in post-agg expressions decodes the set index
            self._grouping_info = (
                gid, [frozenset(s.name for s in gs) for gs in sets_syms])
        else:
            self.node = AggregationNode(self.node, group_symbols,
                                        tuple(aggregations))
        for e, s in key_syms.items():
            self.substitutions[e] = s
        # post-aggregation scope: original names resolve via substitutions,
        # so keep field list unchanged but symbols remapped where possible
        self._scope = Scope(self._scope.fields, self._scope.parent)

    def _group_expr(self, tr: ExpressionTranslator, e: t.Expression,
                    select_items) -> RowExpression:
        # GROUP BY <ordinal>
        if isinstance(e, t.LongLiteral):
            idx = e.value - 1
            if not 0 <= idx < len(select_items):
                raise SemanticError(f"GROUP BY position {e.value} out of range")
            return tr.translate(select_items[idx][0])
        return tr.translate(e)

    # ------------------------------------------------------------- windows

    def plan_windows(self, win_calls: List[t.FunctionCall]):
        planner = self.planner
        tr = self.translator()
        for fc in win_calls:
            w = fc.window
            name = fc.name.suffix.lower()
            if not (is_window(name) or is_aggregate(name)):
                raise SemanticError(f"not a window function: {name}")
            part_exprs = [tr.translate(e) for e in w.partition_by]
            order_items = [(tr.translate(s.key), s.ascending, s.nulls_first)
                           for s in w.order_by]
            # carry ALL current outputs (incl. previously planned window
            # symbols) through any pre-projection, not just scope fields —
            # a literal arg (lag(x, 2), ntile(3)) forces a ProjectNode and
            # must not drop earlier functions' outputs
            pre = [(s, s.ref()) for s in self.node.outputs]

            def sym_for(expr):
                for s, e in pre:
                    if e == expr:
                        return s
                s = planner.symbols.new("winkey", expr.type)
                pre.append((s, expr))
                return s

            part_syms = tuple(sym_for(e) for e in part_exprs)
            orderings = tuple(
                Ordering(sym_for(e), asc,
                         nf if nf is not None else not asc)
                for e, asc, nf in order_items)
            args = tuple(tr.translate(a) for a in fc.args)
            if name == "nth_value" and len(args) > 1 \
                    and isinstance(args[1], Literal) \
                    and args[1].value is not None \
                    and int(args[1].value) <= 0:
                # window/NthValueFunction parity: INVALID_FUNCTION_ARGUMENT
                raise SemanticError(
                    "Argument of NTH_VALUE must be greater than zero "
                    f"(actual value: {args[1].value})")
            arg_syms = tuple(sym_for(a).ref() for a in args)
            if any(not isinstance(e, SymbolRef) for _, e in pre):
                self.node = ProjectNode(self.node, tuple(pre))
            out_type = _window_type(name, args)
            out_sym = planner.symbols.new(name, out_type)
            frame = w.frame
            sv = (tr.translate(frame.start_value)
                  if frame and frame.start_value is not None else None)
            ev = (tr.translate(frame.end_value)
                  if frame and frame.end_value is not None else None)
            wf = WindowFunction(
                name, arg_syms,
                frame.frame_type if frame else "RANGE",
                frame.start_type if frame else "UNBOUNDED_PRECEDING",
                sv,
                (frame.end_type if frame and frame.end_type
                 else "CURRENT_ROW"),
                ev)
            self.node = WindowNode(self.node, part_syms, orderings,
                                   ((out_sym, wf),))
            self.substitutions[tr.aggregate_key(fc)] = out_sym

    # -------------------------------------------------------------- SELECT

    def plan_select(self, select_items, keep: Sequence[Symbol] = ()
                    ) -> List[Field]:
        """Project the select items; `keep` carries extra symbols (e.g.
        decorrelation join keys) through the projection."""
        tr = self.translator()
        assigns: List[Tuple[Symbol, RowExpression]] = [
            (s, s.ref()) for s in keep]
        fields: List[Field] = []
        for expr_ast, name in select_items:
            rx = tr.translate(expr_ast)
            # recompute after translate: select-list subqueries join extra
            # sources onto self.node as a translation side effect
            available = {s.name for s in self.node.outputs}
            missing = _symbols_in(rx) - available
            if missing:
                raise SemanticError(
                    f"'{expr_ast}' must be an aggregate expression or "
                    "appear in GROUP BY clause")
            if isinstance(rx, SymbolRef) and rx.name not in (
                    f.symbol.name for f in fields):
                sym = Symbol(rx.name, rx.type)
                assigns.append((sym, rx))
            else:
                # fresh symbol: non-trivial expression, or a second select
                # item resolving to an already-projected symbol (e.g. the
                # same aggregate under two aliases) — duplicate output
                # symbols are rejected by the plan validator
                sym = self.planner.symbols.new(name or "expr", rx.type)
                assigns.append((sym, rx))
            fields.append(Field(name, None, sym))
        self.node = ProjectNode(self.node, tuple(dict(
            (s.name, (s, e)) for s, e in assigns).values()))
        self._scope = Scope(fields, self._scope.parent)
        return fields

    def plan_distinct(self, out_fields: List[Field]):
        syms = tuple(f.symbol for f in out_fields)
        self.node = AggregationNode(self.node, syms, ())

    # ------------------------------------------------------------ ORDER BY

    def sort_key_source_symbols(self, sort_items) -> Tuple[Symbol, ...]:
        """Source symbols the ORDER BY needs that the SELECT list may not
        project — passed as `keep` through plan_select so sorting on
        unselected columns works (QueryPlanner ORDER BY scope)."""
        available = {s.name: s for s in self.node.outputs}
        keep: List[Symbol] = []
        tr = self.translator()
        for item in sort_items:
            if isinstance(item.key, t.LongLiteral):
                continue
            try:
                rx = tr.translate(item.key)
            except SemanticError:
                continue   # resolves only against output aliases
            for name in sorted(_symbols_in(rx)):
                sym = available.get(name)
                if sym is not None:
                    keep.append(sym)
        return tuple(dict.fromkeys(keep))

    def plan_order_by(self, sort_items: Tuple[t.SortItem, ...],
                      out_fields: List[Field],
                      pre_fields: Optional[List[Field]] = None):
        orderings: List[Ordering] = []
        extra: List[Tuple[Symbol, RowExpression]] = []
        # order-by scope: output aliases win, then the pre-projection scope
        for item in sort_items:
            sym = self._resolve_sort_key(item.key, out_fields, extra,
                                         pre_fields)
            nulls_first = item.nulls_first
            if nulls_first is None:
                nulls_first = not item.ascending  # Trino default
            orderings.append(Ordering(sym, item.ascending, nulls_first))
        if extra:
            assigns = [(s.name, (s, s.ref()))
                       for s in self.node.outputs]
            assigns += [(s.name, (s, e)) for s, e in extra]
            self.node = ProjectNode(self.node,
                                    tuple(dict(assigns).values()))
        self.node = SortNode(self.node, tuple(orderings))

    def _resolve_sort_key(self, key: t.Expression, out_fields: List[Field],
                          extra, pre_fields=None) -> Symbol:
        if isinstance(key, t.LongLiteral):
            idx = key.value - 1
            if not 0 <= idx < len(out_fields):
                raise SemanticError(
                    f"ORDER BY position {key.value} out of range")
            return out_fields[idx].symbol
        if isinstance(key, t.Identifier):
            matches = [f for f in out_fields if f.name == key.value]
            if len(matches) == 1:
                return matches[0].symbol
            if len(matches) > 1:
                raise SemanticError(f"ORDER BY '{key.value}' is ambiguous")
        # fall back: translate against the select-output scope (+ aggregate
        # substitutions). Output aliases win; the pre-projection scope
        # resolves source columns the SELECT list didn't project (their
        # symbols were carried through via plan_select's `keep`).
        parent = Scope(pre_fields, None) if pre_fields else None
        tr = ExpressionTranslator(
            Scope(out_fields, parent),
            self.substitutions, session=self.planner.session)
        rx = tr.translate(key)
        available = {s.name for s in self.node.outputs}
        missing = _symbols_in(rx) - available
        if missing:
            raise SemanticError(
                f"ORDER BY expression {key} references columns not in the "
                "select list")
        if isinstance(rx, SymbolRef):
            return Symbol(rx.name, rx.type)
        sym = self.planner.symbols.new("sortkey", rx.type)
        extra.append((sym, rx))
        return sym

    # -------------------------------------------------------- LIMIT/OFFSET

    def plan_offset(self, count: int):
        self.node = OffsetNode(self.node, count)

    def plan_limit(self, count: int):
        self.node = LimitNode(self.node, count)

    def prune_to(self, out_fields: List[Field]):
        want = tuple(f.symbol for f in out_fields)
        if tuple(self.node.outputs) != want:
            self.node = ProjectNode(
                self.node, tuple((s, s.ref()) for s in want))

    # ----------------------------------------------------------- subqueries

    def _handle_subquery(self, tr: ExpressionTranslator,
                         node: t.Expression) -> RowExpression:
        if isinstance(node, t.SubqueryExpression):
            return self._scalar_subquery(node)
        if isinstance(node, t.ExistsPredicate):
            return self._exists_subquery(node.subquery.query, negate=False)
        if isinstance(node, t.InPredicate):
            sub = node.value_list
            assert isinstance(sub, t.SubqueryExpression)
            return self._in_subquery(node.value, sub.query)
        raise SemanticError("unsupported subquery form")

    def _plan_subquery(self, query: t.Query) -> Tuple[RelationPlan, List]:
        """Plan a subquery against this scope as outer; collect correlated
        references (level, Field)."""
        correlated: List = []
        sub = self.planner._plan_query(query, self._scope, self.ctes)
        return sub, correlated

    def _scalar_subquery(self, node: t.SubqueryExpression) -> RowExpression:
        query = node.query
        decor = self._try_decorrelate_scalar_agg(query)
        if decor is not None:
            return decor
        sub = self.planner._plan_query(query, None, self.ctes)
        if len(sub.scope.fields) != 1:
            raise SemanticError("scalar subquery must return one column")
        enforced = EnforceSingleRowNode(sub.node)
        self.node = JoinNode(JoinKind.CROSS, self.node, enforced, ())
        return sub.scope.fields[0].symbol.ref()

    def _try_decorrelate_scalar_agg(self, query: t.Query
                                    ) -> Optional[RowExpression]:
        """min/avg/sum(...) correlated by equality -> group-by + LEFT join
        (TransformCorrelatedScalarAggregationToJoin)."""
        spec = query.body
        if not isinstance(spec, t.QuerySpecification) or query.with_ or \
                spec.group_by or spec.having or spec.limit or spec.offset \
                or spec.order_by or spec.from_ is None:
            return None
        split = self._split_correlation(spec)
        if split is None or not split[0]:
            return None  # uncorrelated or unsupported
        corr_pairs, local_where = split
        inner = self.planner._plan_relation(spec.from_, None, self.ctes)
        ib = _PlanBuilder(self.planner, inner, self.ctes)
        if local_where is not None:
            ib.plan_where(local_where)
        # single aggregate select item
        items = self.planner._expand_select(spec, ib.scope())
        if len(items) != 1:
            return None
        aggs = [fc for fc in _find_calls([items[0][0]])
                if is_aggregate(fc.name.suffix)]
        if len(aggs) == 0:
            return None
        # count-like aggregates yield 0 (not NULL) over an empty group; the
        # pre-aggregate-then-LEFT-join shape null-extends unmatched outer
        # rows, so a bare count must be COALESCE'd after the join. A count
        # buried in a larger select expression would need post-join
        # re-projection (the reference aggregates after the join instead) —
        # bail to the fail-loud path rather than return wrong results.
        _COUNT_LIKE = ("count", "count_if", "approx_distinct")
        has_count = any(fc.name.suffix.lower() in _COUNT_LIKE for fc in aggs)
        bare_agg = len(aggs) == 1 and items[0][0] is aggs[0]
        if has_count and not bare_agg:
            return None
        # inner grouping keys = inner sides of the correlation equalities
        inner_tr = ib.translator()
        inner_keys = [inner_tr.translate(ast) for _, ast in corr_pairs]
        # manually build aggregation grouped by correlation keys
        ib.plan_aggregation_with_keys(inner_keys, aggs, items)
        key_syms = ib.group_key_symbols
        out_fields = ib.plan_select(items, keep=key_syms)
        # LEFT join outer plan to the aggregated inner on the keys; the outer
        # side is cast to the inner key type (keys come from the same column
        # family in practice, so inner-type wins)
        outer_tr = self.translator()
        criteria = []
        probe = RelationPlan(self.node, self._scope)
        for (outer_ast, _), ksym in zip(corr_pairs, key_syms):
            ox = cast_to(outer_tr.translate(outer_ast), ksym.type)
            if isinstance(ox, SymbolRef):
                osym = Symbol(ox.name, ox.type)
            else:
                probe, osym = self.planner._append_projection(probe, ox)
            criteria.append(JoinClause(osym, ksym))
        # build side keeps key symbols + agg output
        build = ib.node
        self.node = JoinNode(JoinKind.LEFT, probe.node, build,
                             tuple(criteria))
        self._scope = Scope(probe.scope.fields, self._scope.parent)
        out = out_fields[0].symbol.ref()
        if has_count:
            # TransformCorrelatedScalarAggregationToJoin semantics: outer
            # rows with no matching inner rows see count(...) = 0
            out = SpecialForm(SpecialKind.COALESCE,
                              (out, Literal(0, out.type)), out.type)
        return out

    def _split_correlation(self, spec: t.QuerySpecification):
        """WHERE -> ([(outer_ast, inner_ast)], local_where_ast or None).

        Returns None when correlation exists but isn't equality-only
        (unsupported this round).
        """
        if spec.where is None:
            return [], None
        inner_scope_probe = self._inner_name_probe(spec)
        corr: List[Tuple[t.Expression, t.Expression]] = []
        local: List[t.Expression] = []
        def orient(eq):
            a, b = eq.left, eq.right
            if self._classify(a, inner_scope_probe) == "local":
                corr.append((b, a))   # (outer side, inner side)
            else:
                corr.append((a, b))

        for conj in _conjuncts(spec.where):
            side = self._classify(conj, inner_scope_probe)
            if side == "local":
                local.append(conj)
            elif side == "corr_eq":
                orient(conj)
            else:
                # (E AND L1) OR (E AND L2) with one shared correlation
                # equality E factors to E AND (L1 OR L2) — the TPC-DS q41
                # shape (TransformCorrelated* handles this via general
                # subquery planning in the reference)
                factored = self._factor_or_correlation(
                    conj, inner_scope_probe)
                if factored is None:
                    return None
                eqs, local_or = factored
                for eq in eqs:
                    orient(eq)
                local.append(local_or)
        where = None
        if local:
            where = local[0]
            for c in local[1:]:
                where = t.LogicalBinary("AND", where, c)
        return corr, where

    def _factor_or_correlation(self, conj, probe):
        """(E... AND L1) OR (E... AND L2) -> ([E...], L1 OR L2) when every
        disjunct carries the structurally-identical correlation
        equalities; None otherwise."""
        if not (isinstance(conj, t.LogicalBinary) and conj.op == "OR"):
            return None

        def disjuncts(e):
            if isinstance(e, t.LogicalBinary) and e.op == "OR":
                return disjuncts(e.left) + disjuncts(e.right)
            return [e]

        shared_key = None
        shared_eqs = None
        locals_ = []
        for d in disjuncts(conj):
            eqs, rest = [], []
            for c in _conjuncts(d):
                side = self._classify(c, probe)
                if side == "corr_eq":
                    eqs.append(c)
                elif side == "local":
                    rest.append(c)
                else:
                    return None
            key = tuple(sorted(repr(e) for e in eqs))
            if shared_key is None:
                shared_key, shared_eqs = key, eqs
            elif key != shared_key:
                return None
            locals_.append(_combine_ast(rest) if rest
                           else t.BooleanLiteral(True))
        if not shared_eqs:
            return None
        out = locals_[0]
        for x in locals_[1:]:
            out = t.LogicalBinary("OR", out, x)
        return shared_eqs, out

    def _inner_name_probe(self, spec: t.QuerySpecification):
        """Set of column names/qualifiers visible inside the subquery FROM."""
        probe = self.planner._plan_relation(spec.from_, None, self.ctes)
        names = set()
        quals = set()
        for f in probe.scope.fields:
            if f.name:
                names.add(f.name)
            if f.qualifier:
                quals.add(f.qualifier)
        return names, quals

    def _classify(self, e: t.Expression, probe) -> str:
        """'local' (inner-only), 'corr_eq' (equality inner=outer), 'other'."""
        names, quals = probe
        refs_inner = False
        refs_outer = False
        for parts in self._column_refs(e):
            if len(parts) >= 2:
                (refs_inner, refs_outer) = (
                    (True, refs_outer) if parts[-2] in quals
                    else (refs_inner, True))
            elif parts[0] in names:
                refs_inner = True
            elif self._scope.try_resolve(parts) is not None:
                refs_outer = True
        if not refs_outer:
            return "local"
        if isinstance(e, t.ComparisonExpression) and e.op == "=":
            ls = self._classify(e.left, probe)
            rs = self._classify(e.right, probe)
            # only a clean inner=outer split is a correlation key; a mixed
            # side (references both scopes) would silently rebind an
            # unqualified inner column against the outer scope
            if {ls, rs} == {"local", "outer_only"}:
                return "corr_eq"
        if not refs_inner:
            return "outer_only"
        return "other"

    @staticmethod
    def _column_refs(e: t.Expression):
        """Column references as qualified-name tuples; a dereference's
        component identifiers are NOT yielded separately (t1.rk must not
        read as a bare `rk` — that aliased inner fields named rk onto the
        outer side and killed the q01-shape decorrelation)."""
        stack = [e]
        out = []
        while stack:
            n = stack.pop()
            if isinstance(n, t.DereferenceExpression):
                from trino_tpu_torch.planner.translate import _dereference_parts
                parts = _dereference_parts(n)
                if parts is not None:
                    out.append(parts)
                    continue
            if isinstance(n, t.Identifier):
                out.append((n.value,))
                continue
            if isinstance(n, (t.SubqueryExpression, t.ExistsPredicate)):
                continue
            stack.extend(_ast_children(n))
        return out

    def _exists_subquery(self, query: t.Query, negate: bool) -> RowExpression:
        spec = query.body
        if not isinstance(spec, t.QuerySpecification) or spec.from_ is None:
            raise SemanticError("unsupported EXISTS subquery")
        # GROUP BY / HAVING / LIMIT / aggregates change EXISTS cardinality
        # semantics (e.g. HAVING count(*) > 5, LIMIT 0, global agg always
        # emitting one row); the translation below would silently drop them
        if spec.group_by or spec.having or spec.limit or spec.offset or any(
                is_aggregate(fc.name.suffix)
                for fc in _find_calls([i.expression
                                       for i in spec.select.items
                                       if isinstance(i, t.SingleColumn)])):
            raise SemanticError(
                "EXISTS subquery with GROUP BY/HAVING/LIMIT/OFFSET/"
                "aggregates not supported")
        split = self._split_correlation(spec)
        if split is None:
            # correlation beyond clean equalities (e.g. q21's
            # l2.l_suppkey <> l1.l_suppkey): general decorrelation
            return self._exists_general(spec, negate)
        corr_pairs, local_where = split
        inner = self.planner._plan_relation(spec.from_, None, self.ctes)
        ib = _PlanBuilder(self.planner, inner, self.ctes)
        if local_where is not None:
            ib.plan_where(local_where)
        if not corr_pairs:
            # uncorrelated EXISTS: cross join against (SELECT count(*) > 0)
            cnt = self.planner.symbols.new("cnt", T.BIGINT)
            agg = AggregationNode(
                ib.node, (), ((cnt, AggCall("count", (), False, None, None)),))
            flag = self.planner.symbols.new("exists", T.BOOLEAN)
            proj = ProjectNode(agg, ((flag, Call(
                "gt", (cnt.ref(), Literal(0, T.BIGINT)), T.BOOLEAN)),))
            self.node = JoinNode(JoinKind.CROSS, self.node, proj, ())
            out = flag.ref()
            return SpecialForm(SpecialKind.NOT, (out,), T.BOOLEAN) \
                if negate else out
        # correlated: semi join on the correlation keys
        inner_tr = ib.translator()
        inner_keys = [inner_tr.translate(iast) for _, iast in corr_pairs]
        outer_tr = self.translator()
        outer_keys = [outer_tr.translate(oast) for oast, _ in corr_pairs]
        return self._semi_join(outer_keys, inner_keys, ib, negate,
                               null_aware=False)

    def _exists_general(self, spec: t.QuerySpecification,
                        negate: bool) -> RowExpression:
        """EXISTS with arbitrary correlated predicates.

        TransformCorrelatedExistsSubquery's general shape: tag each outer row
        with a unique id, inner-join outer x subquery-FROM under the full
        correlated predicate (equalities become hash-join criteria via
        PredicatePushDown; the rest stays a join filter), then semi-join the
        outer rows against the surviving ids. NOT EXISTS = anti on the same
        set. Deterministic scan order makes the ids stable across the two
        traversals of the outer subtree."""
        planner = self.planner
        inner = planner._plan_relation(spec.from_, None, self.ctes)
        ib = _PlanBuilder(planner, inner, self.ctes)
        probe_names = self._inner_name_probe(spec)
        local: List[t.Expression] = []
        mixed: List[t.Expression] = []
        for conj in _conjuncts(spec.where) if spec.where is not None else []:
            if self._classify(conj, probe_names) == "local":
                local.append(conj)
            else:
                mixed.append(conj)
        if local:
            where = local[0]
            for c in local[1:]:
                where = t.LogicalBinary("AND", where, c)
            ib.plan_where(where)
        if not mixed:
            raise SemanticError("unsupported EXISTS subquery")
        uid = planner.symbols.new("unique", T.BIGINT)
        probe_node = AssignUniqueIdNode(self.node, uid)
        joined = JoinNode(JoinKind.CROSS, probe_node, ib.node, ())
        combined = Scope(list(self._scope.fields) + list(ib.scope().fields),
                         self._scope.parent)
        tr = ExpressionTranslator(combined, {},
                                  subquery_handler=self._handle_subquery,
                                  session=planner.session)
        pred = None
        for conj in mixed:
            rx = tr.translate(conj)
            if not isinstance(rx.type, T.BooleanType):
                raise SemanticError("EXISTS predicate must be boolean")
            pred = rx if pred is None else SpecialForm(
                SpecialKind.AND, (pred, rx), T.BOOLEAN)
        filtered = FilterNode(joined, pred)
        proj = ProjectNode(filtered, ((uid, uid.ref()),))
        match = planner.symbols.new("match", T.BOOLEAN)
        self.node = SemiJoinNode(probe_node, proj, (uid,), (uid,), match,
                                 negate, null_aware=False)
        out = match.ref()
        return SpecialForm(SpecialKind.NOT, (out,), T.BOOLEAN) \
            if negate else out

    def _in_subquery(self, value_ast: t.Expression,
                     query: t.Query) -> RowExpression:
        sub = self.planner._plan_query(query, None, self.ctes)
        if len(sub.scope.fields) != 1:
            raise SemanticError("IN subquery must return one column")
        ib = _PlanBuilder(self.planner,
                          RelationPlan(sub.node, sub.scope), self.ctes)
        outer_tr = self.translator()
        v = outer_tr.translate(value_ast)
        return self._semi_join([v], [sub.scope.fields[0].symbol.ref()], ib,
                               negate=False, null_aware=True)

    def _semi_join(self, outer_keys: List[RowExpression],
                   inner_keys: List[RowExpression], ib: "_PlanBuilder",
                   negate: bool, null_aware: bool = True) -> RowExpression:
        planner = self.planner
        # coerce pairwise
        okeys, ikeys = [], []
        for o, i in zip(outer_keys, inner_keys):
            o2, i2 = planner._coerce_join_keys(o, i)
            okeys.append(o2)
            ikeys.append(i2)
        probe = RelationPlan(self.node, self._scope)
        probe_syms = []
        for o in okeys:
            if isinstance(o, SymbolRef):
                probe_syms.append(Symbol(o.name, o.type))
            else:
                probe, s = planner._append_projection(probe, o)
                probe_syms.append(s)
        build_plan = RelationPlan(ib.node, ib.scope())
        build_syms = []
        for i in ikeys:
            if isinstance(i, SymbolRef):
                build_syms.append(Symbol(i.name, i.type))
            else:
                build_plan, s = planner._append_projection(build_plan, i)
                build_syms.append(s)
        match = planner.symbols.new("match", T.BOOLEAN)
        self.node = SemiJoinNode(
            probe.node, build_plan.node, tuple(probe_syms),
            tuple(build_syms), match, negate, null_aware)
        self._scope = Scope(probe.scope.fields, self._scope.parent)
        out = match.ref()
        if negate:
            return SpecialForm(SpecialKind.NOT, (out,), T.BOOLEAN)
        return out

    # -------------------------------------------- decorrelation helper API

    def plan_aggregation_with_keys(self, key_exprs: List[RowExpression],
                                   agg_calls, select_items):
        """Aggregation grouped by explicit key expressions (decorrelation)."""
        planner = self.planner
        tr = self.translator()
        pre_assigns: List[Tuple[Symbol, RowExpression]] = []

        def to_symbol(expr, hint):
            for s, e in pre_assigns:
                if e == expr:
                    return s
            if isinstance(expr, SymbolRef):
                sym = Symbol(expr.name, expr.type)
                pre_assigns.append((sym, expr))
                return sym
            sym = planner.symbols.new(hint, expr.type)
            pre_assigns.append((sym, expr))
            return sym

        key_syms = [to_symbol(e, "corrkey") for e in key_exprs]
        aggregations = []
        for fc in agg_calls:
            name = fc.name.suffix.lower()
            args = tuple(tr.translate(a) for a in fc.args)
            resolved = resolve_aggregate(name, [a.type for a in args])
            args = tuple(cast_to(a, ty)
                         for a, ty in zip(args, resolved.arg_types))
            agg_name, distinct = resolved.name, fc.distinct
            if agg_name == "approx_distinct":
                # HLL sketch; advisory error argument dropped
                args = args[:1]
            arg_syms = tuple(to_symbol(a, "aggarg") for a in args)
            out_sym = planner.symbols.new(name, resolved.return_type)
            aggregations.append((out_sym, AggCall(
                agg_name, tuple(s.ref() for s in arg_syms),
                distinct, None, args[0].type if args else None)))
            self.substitutions[tr.aggregate_key(fc)] = out_sym
        self.node = ProjectNode(self.node, tuple(pre_assigns))
        self.node = AggregationNode(self.node, tuple(key_syms),
                                    tuple(aggregations))
        self.group_key_symbols = key_syms


def _window_type(name: str, args) -> T.Type:
    n = name.lower()
    if n in ("row_number", "rank", "dense_rank", "ntile"):
        return T.BIGINT
    if n in ("percent_rank", "cume_dist"):
        return T.DOUBLE
    if n in ("lag", "lead", "first_value", "last_value", "nth_value"):
        return args[0].type if args else T.BIGINT
    if is_aggregate(n):
        return resolve_aggregate(n, [a.type for a in args]).return_type
    return T.BIGINT
