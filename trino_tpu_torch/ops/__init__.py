"""Operator library: the compute kernels of the engine (port of
`trino_tpu/ops`). Operators are functions Page -> Page built from static
parameters."""

from trino_tpu_torch.ops.filter_project import filter_project  # noqa: F401
from trino_tpu_torch.ops.aggregate import (  # noqa: F401
    AGGREGATES, AggSpec, hash_aggregate, Step)
from trino_tpu_torch.ops.join import (  # noqa: F401
    JoinType, hash_join, prepare_build)
from trino_tpu_torch.ops.sort import (  # noqa: F401
    limit, order_by, top_n, top_n_masked, SortKey)
