"""SQL AST node classes.

Reference parity: core/trino-parser/src/main/java/io/trino/sql/tree/ (224
immutable node classes + AstVisitor). Condensed to the nodes the analyzer and
planner consume; every node is a frozen dataclass so the tree is hashable and
printable for plan tests.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

_D = dataclasses.dataclass(frozen=True)


def _d(cls):
    return dataclasses.dataclass(frozen=True)(cls)


class Node:
    def children(self) -> Tuple["Node", ...]:
        return ()


class Expression(Node):
    pass


class Statement(Node):
    pass


class Relation(Node):
    pass


# ---------------------------------------------------------------- expressions

@_d
class Identifier(Expression):
    value: str
    quoted: bool = False

    def __str__(self):
        return f'"{self.value}"' if self.quoted else self.value


@_d
class QualifiedName(Node):
    """Dotted name: catalog.schema.table or table.column etc."""

    parts: Tuple[str, ...]

    def __str__(self):
        return ".".join(self.parts)

    @property
    def suffix(self) -> str:
        return self.parts[-1]


@_d
class DereferenceExpression(Expression):
    """base.field — qualified column reference before analysis."""

    base: Expression
    field: Identifier

    def children(self):
        return (self.base,)

    def __str__(self):
        return f"{self.base}.{self.field}"


@_d
class NullLiteral(Expression):
    def __str__(self):
        return "NULL"


@_d
class BooleanLiteral(Expression):
    value: bool

    def __str__(self):
        return "TRUE" if self.value else "FALSE"


@_d
class LongLiteral(Expression):
    value: int

    def __str__(self):
        return str(self.value)


@_d
class DoubleLiteral(Expression):
    value: float

    def __str__(self):
        return repr(self.value)


@_d
class DecimalLiteral(Expression):
    text: str  # e.g. "1.23"

    def __str__(self):
        return self.text


@_d
class StringLiteral(Expression):
    value: str

    def __str__(self):
        return "'" + self.value.replace("'", "''") + "'"


@_d
class DateLiteral(Expression):
    """DATE 'yyyy-mm-dd' (GenericLiteral in the reference)."""

    text: str

    def __str__(self):
        return f"DATE '{self.text}'"


@_d
class TimestampLiteral(Expression):
    text: str

    def __str__(self):
        return f"TIMESTAMP '{self.text}'"


@_d
class IntervalLiteral(Expression):
    value: str
    unit: str       # YEAR|MONTH|DAY|HOUR|MINUTE|SECOND
    sign: int = 1
    end_unit: Optional[str] = None  # INTERVAL '1-2' YEAR TO MONTH

    def __str__(self):
        s = "-" if self.sign < 0 else ""
        return f"INTERVAL {s}'{self.value}' {self.unit}"


@_d
class Parameter(Expression):
    position: int

    def __str__(self):
        return "?"


@_d
class ArithmeticBinary(Expression):
    op: str  # + - * / %
    left: Expression
    right: Expression

    def children(self):
        return (self.left, self.right)

    def __str__(self):
        return f"({self.left} {self.op} {self.right})"


@_d
class ArithmeticUnary(Expression):
    op: str  # + -
    value: Expression

    def children(self):
        return (self.value,)

    def __str__(self):
        return f"{self.op}{self.value}"


@_d
class ComparisonExpression(Expression):
    op: str  # = <> < <= > >= IS DISTINCT FROM
    left: Expression
    right: Expression

    def children(self):
        return (self.left, self.right)

    def __str__(self):
        return f"({self.left} {self.op} {self.right})"


@_d
class LogicalBinary(Expression):
    op: str  # AND OR
    left: Expression
    right: Expression

    def children(self):
        return (self.left, self.right)

    def __str__(self):
        return f"({self.left} {self.op} {self.right})"


@_d
class NotExpression(Expression):
    value: Expression

    def children(self):
        return (self.value,)

    def __str__(self):
        return f"(NOT {self.value})"


@_d
class IsNullPredicate(Expression):
    value: Expression

    def children(self):
        return (self.value,)

    def __str__(self):
        return f"({self.value} IS NULL)"


@_d
class IsNotNullPredicate(Expression):
    value: Expression

    def children(self):
        return (self.value,)

    def __str__(self):
        return f"({self.value} IS NOT NULL)"


@_d
class BetweenPredicate(Expression):
    value: Expression
    min: Expression
    max: Expression

    def children(self):
        return (self.value, self.min, self.max)

    def __str__(self):
        return f"({self.value} BETWEEN {self.min} AND {self.max})"


@_d
class InPredicate(Expression):
    value: Expression
    value_list: Expression  # InListExpression or SubqueryExpression

    def children(self):
        return (self.value, self.value_list)

    def __str__(self):
        return f"({self.value} IN {self.value_list})"


@_d
class InListExpression(Expression):
    values: Tuple[Expression, ...]

    def children(self):
        return self.values

    def __str__(self):
        return "(" + ", ".join(map(str, self.values)) + ")"


@_d
class LikePredicate(Expression):
    value: Expression
    pattern: Expression
    escape: Optional[Expression] = None

    def children(self):
        return (self.value, self.pattern) + (
            (self.escape,) if self.escape else ())

    def __str__(self):
        e = f" ESCAPE {self.escape}" if self.escape else ""
        return f"({self.value} LIKE {self.pattern}{e})"


@_d
class ExistsPredicate(Expression):
    subquery: "SubqueryExpression"

    def children(self):
        return (self.subquery,)

    def __str__(self):
        return f"EXISTS {self.subquery}"


@_d
class SubqueryExpression(Expression):
    query: "Query"

    def children(self):
        return (self.query,)

    def __str__(self):
        return "(<subquery>)"


@_d
class FunctionCall(Expression):
    name: QualifiedName
    args: Tuple[Expression, ...]
    distinct: bool = False
    filter: Optional[Expression] = None
    window: Optional["Window"] = None

    def children(self):
        return self.args

    def __str__(self):
        star = "*" if not self.args and self.name.suffix.lower() == "count" \
            else ", ".join(map(str, self.args))
        d = "DISTINCT " if self.distinct else ""
        return f"{self.name}({d}{star})"


@_d
class SortItem(Node):
    key: Expression
    ascending: bool = True
    nulls_first: Optional[bool] = None  # None = type default (Trino: NULLS LAST for ASC)

    def __str__(self):
        s = str(self.key) + ("" if self.ascending else " DESC")
        if self.nulls_first is True:
            s += " NULLS FIRST"
        elif self.nulls_first is False:
            s += " NULLS LAST"
        return s


@_d
class WindowFrame(Node):
    frame_type: str  # RANGE | ROWS | GROUPS
    start_type: str  # UNBOUNDED_PRECEDING | PRECEDING | CURRENT_ROW | FOLLOWING | UNBOUNDED_FOLLOWING
    start_value: Optional[Expression] = None
    end_type: Optional[str] = None
    end_value: Optional[Expression] = None


@_d
class Window(Node):
    partition_by: Tuple[Expression, ...]
    order_by: Tuple[SortItem, ...]
    frame: Optional[WindowFrame] = None


@_d
class Cast(Expression):
    value: Expression
    target_type: str
    safe: bool = False  # TRY_CAST

    def children(self):
        return (self.value,)

    def __str__(self):
        f = "TRY_CAST" if self.safe else "CAST"
        return f"{f}({self.value} AS {self.target_type})"


@_d
class Extract(Expression):
    field: str  # YEAR MONTH DAY HOUR MINUTE SECOND ...
    value: Expression

    def children(self):
        return (self.value,)

    def __str__(self):
        return f"EXTRACT({self.field} FROM {self.value})"


@_d
class WhenClause(Node):
    operand: Expression
    result: Expression


@_d
class SearchedCaseExpression(Expression):
    when_clauses: Tuple[WhenClause, ...]
    default: Optional[Expression] = None

    def children(self):
        out = []
        for w in self.when_clauses:
            out += [w.operand, w.result]
        if self.default is not None:
            out.append(self.default)
        return tuple(out)

    def __str__(self):
        parts = [f"WHEN {w.operand} THEN {w.result}" for w in self.when_clauses]
        if self.default is not None:
            parts.append(f"ELSE {self.default}")
        return "CASE " + " ".join(parts) + " END"


@_d
class SimpleCaseExpression(Expression):
    operand: Expression
    when_clauses: Tuple[WhenClause, ...]
    default: Optional[Expression] = None

    def children(self):
        out = [self.operand]
        for w in self.when_clauses:
            out += [w.operand, w.result]
        if self.default is not None:
            out.append(self.default)
        return tuple(out)


@_d
class CoalesceExpression(Expression):
    operands: Tuple[Expression, ...]

    def children(self):
        return self.operands

    def __str__(self):
        return "COALESCE(" + ", ".join(map(str, self.operands)) + ")"


@_d
class NullIfExpression(Expression):
    first: Expression
    second: Expression

    def children(self):
        return (self.first, self.second)


@_d
class IfExpression(Expression):
    condition: Expression
    true_value: Expression
    false_value: Optional[Expression] = None

    def children(self):
        return (self.condition, self.true_value) + (
            (self.false_value,) if self.false_value else ())


@_d
class Row(Expression):
    items: Tuple[Expression, ...]

    def children(self):
        return self.items

    def __str__(self):
        return "ROW(" + ", ".join(map(str, self.items)) + ")"


@_d
class CurrentTime(Expression):
    """current_date / current_timestamp / localtimestamp."""

    function: str  # DATE | TIMESTAMP | TIME

    def __str__(self):
        return f"current_{self.function.lower()}"


@_d
class AllColumns(Expression):
    """`*` or `t.*` in a select list."""

    prefix: Optional[QualifiedName] = None

    def __str__(self):
        return f"{self.prefix}.*" if self.prefix else "*"


# ------------------------------------------------------------------ relations

@_d
class Table(Relation):
    name: QualifiedName
    # Time travel: `FOR VERSION AS OF <expr>` pins the scan to a committed
    # manifest version; `FOR TIMESTAMP AS OF <expr>` resolves a commit
    # timestamp to the newest version committed at or before it.
    version: Optional[Expression] = None
    timestamp: Optional[Expression] = None

    def __str__(self):
        return str(self.name)


@_d
class AliasedRelation(Relation):
    relation: Relation
    alias: Identifier
    column_names: Tuple[Identifier, ...] = ()

    def children(self):
        return (self.relation,)


@_d
class TableSubquery(Relation):
    query: "Query"

    def children(self):
        return (self.query,)


@_d
class Join(Relation):
    join_type: str  # INNER LEFT RIGHT FULL CROSS IMPLICIT
    left: Relation
    right: Relation
    criteria: Optional[Node] = None  # JoinOn | JoinUsing | None

    def children(self):
        return (self.left, self.right)


@_d
class JoinOn(Node):
    expression: Expression


@_d
class JoinUsing(Node):
    columns: Tuple[Identifier, ...]


@_d
class Unnest(Relation):
    expressions: Tuple[Expression, ...]
    with_ordinality: bool = False


@_d
class Values(Relation):
    rows: Tuple[Expression, ...]

    def children(self):
        return self.rows


# -------------------------------------------------------------- query bodies

@_d
class SingleColumn(Node):
    expression: Expression
    alias: Optional[Identifier] = None

    def __str__(self):
        return f"{self.expression} AS {self.alias}" if self.alias else str(
            self.expression)


@_d
class Select(Node):
    distinct: bool
    items: Tuple[Node, ...]  # SingleColumn | AllColumns


@_d
class GroupingElement(Node):
    pass


@_d
class SimpleGroupBy(GroupingElement):
    expressions: Tuple[Expression, ...]


@_d
class Rollup(GroupingElement):
    expressions: Tuple[Expression, ...]


@_d
class Cube(GroupingElement):
    expressions: Tuple[Expression, ...]


@_d
class GroupingSets(GroupingElement):
    sets: Tuple[Tuple[Expression, ...], ...]


@_d
class GroupBy(Node):
    distinct: bool
    elements: Tuple[GroupingElement, ...]


class QueryBody(Relation):
    pass


@_d
class QuerySpecification(QueryBody):
    select: Select
    from_: Optional[Relation] = None
    where: Optional[Expression] = None
    group_by: Optional[GroupBy] = None
    having: Optional[Expression] = None
    order_by: Tuple[SortItem, ...] = ()
    offset: Optional[Expression] = None
    limit: Optional[Expression] = None  # LongLiteral or AllRows


@_d
class SetOperation(QueryBody):
    op: str  # UNION INTERSECT EXCEPT
    distinct: bool
    left: QueryBody
    right: QueryBody

    def children(self):
        return (self.left, self.right)


@_d
class WithQuery(Node):
    name: Identifier
    query: "Query"
    column_names: Tuple[Identifier, ...] = ()


@_d
class With(Node):
    recursive: bool
    queries: Tuple[WithQuery, ...]


@_d
class Query(Statement, Relation):
    body: QueryBody
    with_: Optional[With] = None
    order_by: Tuple[SortItem, ...] = ()
    offset: Optional[Expression] = None
    limit: Optional[Expression] = None

    def children(self):
        return (self.body,)


# ----------------------------------------------------------------- statements

@_d
class Explain(Statement):
    statement: Statement
    analyze: bool = False
    explain_type: str = "DISTRIBUTED"  # LOGICAL | DISTRIBUTED | IO | VALIDATE

    def children(self):
        return (self.statement,)


@_d
class ShowTables(Statement):
    schema: Optional[QualifiedName] = None
    like: Optional[str] = None


@_d
class ShowSchemas(Statement):
    catalog: Optional[str] = None


@_d
class ShowCatalogs(Statement):
    pass


@_d
class ShowColumns(Statement):
    table: QualifiedName


@_d
class ShowSession(Statement):
    pass


@_d
class ShowFunctions(Statement):
    pass


@_d
class SetSession(Statement):
    name: QualifiedName
    value: Expression


@_d
class ResetSession(Statement):
    name: QualifiedName


@_d
class ColumnDefinition(Node):
    name: Identifier
    type: str
    nullable: bool = True


@_d
class CreateTable(Statement):
    name: QualifiedName
    elements: Tuple[ColumnDefinition, ...]
    not_exists: bool = False
    properties: Tuple[Tuple[str, Expression], ...] = ()


@_d
class CreateTableAsSelect(Statement):
    name: QualifiedName
    query: Query
    not_exists: bool = False
    with_data: bool = True
    properties: Tuple[Tuple[str, Expression], ...] = ()


@_d
class DropTable(Statement):
    name: QualifiedName
    exists: bool = False


@_d
class Insert(Statement):
    target: QualifiedName
    query: Query
    columns: Tuple[Identifier, ...] = ()


@_d
class Delete(Statement):
    table: QualifiedName
    where: Optional[Expression] = None


@_d
class CreateView(Statement):
    name: QualifiedName
    query: Query
    replace: bool = False


@_d
class DropView(Statement):
    name: QualifiedName
    exists: bool = False


@_d
class CreateMaterializedView(Statement):
    name: QualifiedName
    query: Query
    replace: bool = False
    not_exists: bool = False
    properties: Tuple[Tuple[str, Expression], ...] = ()


@_d
class RefreshMaterializedView(Statement):
    name: QualifiedName


@_d
class DropMaterializedView(Statement):
    name: QualifiedName
    exists: bool = False


@_d
class CreateSchema(Statement):
    name: QualifiedName
    not_exists: bool = False


@_d
class DropSchema(Statement):
    name: QualifiedName
    exists: bool = False


@_d
class Use(Statement):
    catalog: Optional[Identifier]
    schema: Identifier


@_d
class Prepare(Statement):
    name: Identifier
    statement: Statement


@_d
class ExecuteStatement(Statement):
    name: Identifier
    parameters: Tuple[Expression, ...] = ()


@_d
class Deallocate(Statement):
    name: Identifier


@_d
class ShowStats(Statement):
    relation: Relation


@_d
class Analyze(Statement):
    table: QualifiedName


@_d
class Commit(Statement):
    pass


@_d
class Rollback(Statement):
    pass


@_d
class StartTransaction(Statement):
    pass


def _iter_nodes(value):
    if isinstance(value, Node):
        yield value
    elif isinstance(value, tuple):
        # handles nested tuples: GroupingSets.sets, CreateTable properties
        for item in value:
            yield from _iter_nodes(item)


def walk(node: Node):
    """Pre-order traversal over every Node reachable from `node`."""
    yield node
    for f in dataclasses.fields(node):
        for child in _iter_nodes(getattr(node, f.name)):
            yield from walk(child)
