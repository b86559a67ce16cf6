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

The pool models one card's device memory. Reservations of the
distributed runner's shards carry `device=` (the shard) and keep a
reserved total and a peak per shard, as the reference's per-chip
accounting does; `autosize_node_pool` gives each shard a budget from its
card's memory, checked when `enforce_per_device` is set (off by default).
Left for ROADMAP A.6: the low-memory killer (picking and marking a victim
query), `degrade_to_spill` and the `retry_policy` re-run; here a pool
overflow fails the requester, as the reference's pool does with its
killer disabled.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

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
        # per-shard accounting (device= reservations of mesh shards): the
        # bytes each holds, its peak, and its budget when sized
        self.device_reserved: Dict[int, int] = {}
        self.device_peak: Dict[int, int] = {}
        self.device_limit: Dict[int, int] = {}
        self.enforce_per_device = False
        self.budget_source = "default"

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
                tag: str, device: Optional[int] = None) -> None:
        """Grant `nbytes` to `ctx` (on shard `device`, when given) or raise
        ClusterOutOfMemoryError."""
        with self._cond:
            if ctx.kill_reason is not None:
                raise ClusterOutOfMemoryError(ctx.kill_reason)
            limit, current = self.limit, self.reserved
            if self.enforce_per_device and device is not None \
                    and device in self.device_limit:
                # a shard's budget bounds what that shard holds
                limit = self.device_limit[device]
                current = self.device_reserved.get(device, 0)
            if limit is not None and current + nbytes > limit:
                raise ClusterOutOfMemoryError(
                    f"node memory pool exhausted: [{tag}] requested "
                    f"{fmt_bytes(nbytes)} with {fmt_bytes(current)}/"
                    f"{fmt_bytes(limit)} reserved")
            self.reserved += nbytes
            self.peak = max(self.peak, self.reserved)
            if device is not None:
                d = self.device_reserved.get(device, 0) + nbytes
                self.device_reserved[device] = d
                self.device_peak[device] = max(
                    self.device_peak.get(device, 0), d)

    def release(self, nbytes: int, device: Optional[int] = None) -> None:
        if nbytes <= 0:
            return
        with self._cond:
            self.reserved = max(0, self.reserved - nbytes)
            if device is not None:
                self.device_reserved[device] = max(
                    0, self.device_reserved.get(device, 0) - nbytes)
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
        # bytes held per shard (device= reservations)
        self.device_reserved: Dict[int, int] = {}
        if not query_id:
            QueryMemoryContext._anon += 1
            query_id = f"ctx_{QueryMemoryContext._anon}"
        self.query_id = query_id
        self.pool = pool
        self.kill_reason: Optional[str] = None
        if pool is not None:
            pool.register(self)

    def reserve(self, nbytes: int, tag: str = "operator",
                device: Optional[int] = None) -> None:
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
            self.pool.acquire(self, nbytes, tag, device)
        self.reserved += nbytes
        self.by_tag[tag] = self.by_tag.get(tag, 0) + nbytes
        self.peak = max(self.peak, self.reserved)
        if device is not None:
            self.device_reserved[device] = \
                self.device_reserved.get(device, 0) + nbytes

    def free(self, nbytes: int, tag: str = "operator",
             device: Optional[int] = None) -> None:
        nbytes = int(nbytes)
        released = min(max(nbytes, 0), self.reserved)
        self.reserved -= released
        if tag in self.by_tag:
            self.by_tag[tag] = max(0, self.by_tag[tag] - nbytes)
        if device is not None:
            self.device_reserved[device] = max(
                0, self.device_reserved.get(device, 0) - released)
        if self.pool is not None:
            self.pool.release(released, device)

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
            if int(mark) == 0:
                # everything goes: each shard's bytes leave its account
                for dev, held in self.device_reserved.items():
                    self.pool.release(held, dev)
                    delta -= held
                self.device_reserved.clear()
            self.pool.release(delta)

    def close(self) -> int:
        """Query end: the ledger must read zero. Returns the leaked byte
        count (0 when clean), releases any remainder and unregisters."""
        leaked = self.reserved
        self.rollback_to(0)
        if self.pool is not None:
            self.pool.unregister(self)
        return leaked


def measured_device_memory_bytes(device) -> Optional[int]:
    """A CUDA card's total memory, or None for a device that does not
    report it (the CPU)."""
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(dev).total_memory)


def autosize_node_pool(devices, scan_cache_budget: Optional[int] = None,
                       pool: Optional[NodeMemoryPool] = None
                       ) -> Tuple[Dict[int, int], str]:
    """Each shard's budget from its device's measured memory (the
    reference's autosize_node_pool, per chip): the card's memory minus
    the connector's staged-column cache, floored at a quarter of the card,
    divided among the shards placed on that card — shards of one card
    share its memory, so n virtual shards on one H100 each get a 1/n
    share, and their reservations together cannot oversubscribe it.
    Devices that report no capacity (the CPU) keep no budget ("default").
    Returns (shard -> budget, source) and turns `enforce_per_device` on
    when any budget was measured."""
    pool = pool if pool is not None else NODE_POOL
    if scan_cache_budget is None:
        from trino_tpu_torch.connector import tpch
        scan_cache_budget = int(tpch._DEVICE_COL_CACHE_BYTES)
    per_device: Dict[str, List[int]] = {}
    for shard, dev in enumerate(devices):
        per_device.setdefault(str(dev), []).append(shard)
    budgets: Dict[int, int] = {}
    for dev, shards in per_device.items():
        measured = measured_device_memory_bytes(dev)
        if measured is None:
            continue
        card = max(measured - int(scan_cache_budget), measured // 4)
        for shard in shards:
            budgets[shard] = card // len(shards)
    with pool._cond:
        pool.device_limit = dict(budgets)
        pool.enforce_per_device = bool(budgets)
        pool.budget_source = "measured" if budgets else "default"
    return budgets, pool.budget_source
