"""Query and node memory accounting.

Port of `trino_tpu/exec/memory.py` (reference parity: memory/MemoryPool
.java + lib/trino-memory-context): every blocking materialization (a join
build side, an aggregation or sort collect, a restaged spill partition)
reserves its page bytes against the query's `query_max_memory` ledger
and, when one is attached, the process-wide `NodeMemoryPool`. A
reservation past the query limit fails with the reference's "Query
exceeded per-node memory limit" error (ExceededMemoryLimitError); one
past the node pool fails with the retryable ClusterOutOfMemoryError. The
join build collection turns either into a strategy switch: the build
streams into the partitioned join instead (exec/local_planner.py
`_collect_build_resilient`).

The pool models one card's device memory. Left for ROADMAP A.6: the
low-memory killer (picking and marking a victim query), `degrade_to_spill`
and the `retry_policy` re-run; here a pool overflow fails the requester,
as the reference's pool does with its killer disabled.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from trino_tpu_torch.errors import (CLUSTER_OUT_OF_MEMORY,
                                    EXCEEDED_LOCAL_MEMORY_LIMIT, TrinoError)


class ExceededMemoryLimitError(TrinoError, RuntimeError):
    """io.trino.ExceededMemoryLimitException analog."""

    CODE = EXCEEDED_LOCAL_MEMORY_LIMIT


class ClusterOutOfMemoryError(TrinoError, RuntimeError):
    """A reservation would overflow the node pool. Retryable: re-running
    after the pressure clears may succeed."""

    CODE = CLUSTER_OUT_OF_MEMORY


def fmt_bytes(n: int) -> str:
    units = ("B", "kB", "MB", "GB", "TB")
    v = float(n)
    for u in units:
        if abs(v) < 1024 or u == units[-1]:
            return f"{int(v)}{u}" if u == "B" else f"{v:.2f}{u}"
        v /= 1024
    return f"{n}B"


def page_bytes(page) -> int:
    """Device bytes of one Page (values and validity of every column)."""
    return sum(col.nbytes for col in page.columns)


def live_page_bytes(page, rows: int) -> int:
    """Bytes of the LIVE rows of a Page: pages are capacity-padded, so a
    counter scales page_bytes to the live row count."""
    cap = max(int(page.capacity), 1)
    return page_bytes(page) * int(rows) // cap


class NodeMemoryPool:
    """Process-wide reservation pool all queries share (MemoryPool.java
    for one node). `limit` is the reservable byte budget (None =
    unbounded, the default: tests and direct runners size their own
    queries)."""

    def __init__(self, limit_bytes: Optional[int] = None):
        self._cond = threading.Condition()
        self.limit = limit_bytes
        self.reserved = 0
        self.peak = 0
        self.leaks = 0
        self.leaked_bytes = 0
        self._contexts: Dict[str, "QueryMemoryContext"] = {}

    def set_limit(self, limit_bytes: Optional[int]) -> None:
        with self._cond:
            self.limit = limit_bytes
            self._cond.notify_all()

    def register(self, ctx: "QueryMemoryContext") -> None:
        with self._cond:
            self._contexts[ctx.query_id] = ctx

    def unregister(self, ctx: "QueryMemoryContext") -> None:
        with self._cond:
            if self._contexts.get(ctx.query_id) is ctx:
                del self._contexts[ctx.query_id]
            self._cond.notify_all()

    def acquire(self, ctx: "QueryMemoryContext", nbytes: int,
                tag: str) -> None:
        """Grant `nbytes` to `ctx` or raise ClusterOutOfMemoryError."""
        with self._cond:
            if ctx.kill_reason is not None:
                raise ClusterOutOfMemoryError(ctx.kill_reason)
            if self.limit is not None and self.reserved + nbytes > self.limit:
                raise ClusterOutOfMemoryError(
                    f"node memory pool exhausted: [{tag}] requested "
                    f"{fmt_bytes(nbytes)} with {fmt_bytes(self.reserved)}/"
                    f"{fmt_bytes(self.limit)} reserved")
            self.reserved += nbytes
            self.peak = max(self.peak, self.reserved)

    def release(self, nbytes: int) -> None:
        if nbytes <= 0:
            return
        with self._cond:
            self.reserved = max(0, self.reserved - nbytes)
            self._cond.notify_all()

    def record_leak(self, nbytes: int) -> None:
        with self._cond:
            self.leaks += 1
            self.leaked_bytes += nbytes


# the process-wide pool (one card's budget; unbounded until sized)
NODE_POOL = NodeMemoryPool()


class QueryMemoryContext:
    """Single-query reservation ledger checked against query_max_memory,
    mirrored into a NodeMemoryPool when one is attached. `by_tag` names
    the operator holding the bytes (for error messages)."""

    _anon = 0

    def __init__(self, limit_bytes: Optional[int],
                 query_id: Optional[str] = None,
                 pool: Optional[NodeMemoryPool] = None):
        self.limit = int(limit_bytes) if limit_bytes is not None else None
        self.reserved = 0
        self.peak = 0
        self.by_tag: Dict[str, int] = {}
        if not query_id:
            QueryMemoryContext._anon += 1
            query_id = f"ctx_{QueryMemoryContext._anon}"
        self.query_id = query_id
        self.pool = pool
        self.kill_reason: Optional[str] = None
        if pool is not None:
            pool.register(self)

    def reserve(self, nbytes: int, tag: str = "operator") -> None:
        nbytes = int(nbytes)
        if nbytes <= 0:
            return
        if self.kill_reason is not None:
            raise ClusterOutOfMemoryError(self.kill_reason)
        if self.limit is not None and self.reserved + nbytes > self.limit:
            raise ExceededMemoryLimitError(
                f"Query exceeded per-node memory limit of "
                f"{fmt_bytes(self.limit)} [{tag} requested "
                f"{fmt_bytes(nbytes)}, reserved "
                f"{fmt_bytes(self.reserved)}]")
        if self.pool is not None:
            self.pool.acquire(self, nbytes, tag)
        self.reserved += nbytes
        self.by_tag[tag] = self.by_tag.get(tag, 0) + nbytes
        self.peak = max(self.peak, self.reserved)

    def free(self, nbytes: int, tag: str = "operator") -> None:
        nbytes = int(nbytes)
        released = min(max(nbytes, 0), self.reserved)
        self.reserved -= released
        if tag in self.by_tag:
            self.by_tag[tag] = max(0, self.by_tag[tag] - nbytes)
        if self.pool is not None:
            self.pool.release(released)

    def poll(self) -> None:
        """Cooperative checkpoint: raise if the query was marked."""
        if self.kill_reason is not None:
            raise ClusterOutOfMemoryError(self.kill_reason)

    def clear_kill(self) -> None:
        """Clear the kill mark (under the pool lock when pooled)."""
        if self.pool is not None:
            with self.pool._cond:
                self.kill_reason = None
                self.pool._cond.notify_all()
        else:
            self.kill_reason = None

    def rollback_to(self, mark: int) -> None:
        """Release everything reserved past `mark`."""
        delta = self.reserved - int(mark)
        if delta <= 0:
            return
        self.reserved = int(mark)
        if self.pool is not None:
            self.pool.release(delta)

    def close(self) -> int:
        """Query end: the ledger must read zero. Returns the leaked byte
        count (0 when clean), releases any remainder and unregisters."""
        leaked = self.reserved
        self.rollback_to(0)
        if self.pool is not None:
            self.pool.unregister(self)
        return leaked
