"""Expression engine: IR + compiler lowering row expressions to torch
tensor functions (port of `trino_tpu/expr`)."""

from trino_tpu_torch.expr.ir import (  # noqa: F401
    Call, InputRef, Literal, Param, RowExpression, SpecialForm, SpecialKind)
from trino_tpu_torch.expr.compiler import (  # noqa: F401
    compile_expression, compile_filter)
from trino_tpu_torch.expr.hoist import (  # noqa: F401
    hoist_literal_seq, hoist_literals)
