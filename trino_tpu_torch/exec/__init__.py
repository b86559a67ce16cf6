"""Execution engine: plan -> operator pipelines over device Pages (port of
`trino_tpu/exec`)."""

from trino_tpu_torch.exec.runner import LocalQueryRunner  # noqa: F401
