"""trino_tpu_torch — the PyTorch/CUDA port of trino_tpu.

A Trino-style SQL engine: SQL in, plans lowered to per-page device
operators over columnar Pages, rows out. It mirrors the JAX package
`trino_tpu` module by module and imports nothing from it. Entry points run
on `cuda` unless the caller passes `device="cpu"`; hand-written CUDA and
Triton kernels (csrc/, built at first use) carry the device path.
"""

__version__ = "0.1.0"

from trino_tpu_torch import types  # noqa: F401,E402
from trino_tpu_torch.page import Column, Dictionary, Page  # noqa: F401,E402
