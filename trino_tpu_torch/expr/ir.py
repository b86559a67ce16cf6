"""Row-expression IR.

Reference parity: the planner-side RowExpression family backing
sql/gen/RowExpressionCompiler.java (ConstantExpression, InputReferenceExpression,
CallExpression, SpecialForm). Expressions reference operator input channels by
index (InputRef), matching how compiled PageProcessors address Page blocks.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional, Tuple

from trino_tpu_torch import types as T


class RowExpression:
    type: T.Type

    def children(self) -> Tuple["RowExpression", ...]:
        return ()


@dataclasses.dataclass(frozen=True)
class InputRef(RowExpression):
    """Reference to input channel `index` of the page being processed."""

    index: int
    type: T.Type

    def __str__(self):
        return f"#{self.index}"


@dataclasses.dataclass(frozen=True)
class SymbolRef(RowExpression):
    """Plan-level reference to a named symbol (sql/planner/Symbol.java).

    Logical plans carry SymbolRef expressions; LocalExecutionPlanner rewrites
    them to channel-indexed InputRefs against each operator's page layout.
    """

    name: str
    type: T.Type

    def __str__(self):
        return self.name


@dataclasses.dataclass(frozen=True)
class Literal(RowExpression):
    """Constant. value=None means typed NULL."""

    value: Optional[Any]
    type: T.Type

    def __str__(self):
        return "null" if self.value is None else repr(self.value)


@dataclasses.dataclass(frozen=True)
class Param(RowExpression):
    """Positional runtime parameter slot (parameterized kernel compilation).

    Produced by expr/hoist.py: trace-shape-irrelevant Literals in lowered
    expressions are rewritten to Param leaves so the jit-cache key — the
    canonical literal-free tree — is shared by every literal variant of a
    query shape. The value arrives at kernel call time as element `index`
    of the op's params tuple (a traced 0-d scalar of `type.dtype`), so
    `l_quantity < 24` and `l_quantity < 25` run one XLA executable.
    Reference parity: PageFunctionCompiler.java rewriting constants out of
    the expression tree before keying its bytecode cache."""

    index: int
    type: T.Type

    def __str__(self):
        return f"?{self.index}"


@dataclasses.dataclass(frozen=True)
class BoundParam(RowExpression):
    """Statement-level parameter reference (`?` in a prepared statement).

    Produced by planner/translate.py when EXECUTE ... USING binds values:
    `position` indexes the statement's parameter list, typed from the
    bound value. Plans carrying BoundParam leaves are value-free — the
    plan cache reuses them across EXECUTEs — and expr/hoist.py folds them
    into the SAME positional `Param` slots hoisted literals use, so a
    re-execution with new values dispatches only warm executables.
    Reference parity: sql/planner/ParameterRewriter.java binding
    Parameter nodes during planning."""

    position: int
    type: T.Type

    def __str__(self):
        return f"$param{self.position}"


@dataclasses.dataclass(frozen=True)
class Call(RowExpression):
    """Scalar function call resolved to a registry name, e.g. 'add:bigint'."""

    name: str
    args: Tuple[RowExpression, ...]
    type: T.Type

    def children(self):
        return self.args

    def __str__(self):
        return f"{self.name}({', '.join(map(str, self.args))})"


class SpecialKind(enum.Enum):
    """Forms with non-default null/shortcut semantics (SpecialForm.Form)."""

    AND = "and"
    OR = "or"
    NOT = "not"
    IS_NULL = "is_null"
    COALESCE = "coalesce"
    IF = "if"            # args: cond, then, else
    IN = "in"            # args: needle, value1..valueN (literals or exprs)
    BETWEEN = "between"  # args: value, low, high
    SWITCH = "switch"    # searched CASE: [cond1, val1, ..., condN, valN, default]


@dataclasses.dataclass(frozen=True)
class SpecialForm(RowExpression):
    kind: SpecialKind
    args: Tuple[RowExpression, ...]
    type: T.Type

    def children(self):
        return self.args

    def __str__(self):
        return f"{self.kind.value}({', '.join(map(str, self.args))})"
