"""Multi-shard execution: the query mesh and its collective exchanges.

Port of `trino_tpu/parallel/` (B12): stages run as per-shard tasks over a
QueryMesh driven by one process, and REMOTE exchanges lower to the
collectives of exchange.py —
  FIXED_HASH_DISTRIBUTION  -> K35's bucket pack + the K2 receive
  FIXED_BROADCAST          -> K2 over every shard's live rows
  SINGLE / gather          -> the same (+ shard 0 reads)
"""

from trino_tpu_torch.parallel.mesh import QueryMesh  # noqa: F401
from trino_tpu_torch.parallel.exchange import (  # noqa: F401
    all_to_all_by_key, all_to_all_replicate, broadcast_page,
    detect_heavy_keys, gather_page)
