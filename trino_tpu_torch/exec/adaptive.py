"""Adaptive operator strategies: runtime re-decision of CBO choices.

Port of `trino_tpu/exec/adaptive.py`: host logic, the same thresholds
and transitions.

Reference grounding (PAPERS.md): "Partial Partial Aggregates" — partial
aggregation should shrink or bypass ITSELF at runtime when the observed
reduction ratio says NDV is effectively high, instead of burning a sort
per page that collapses nothing — and "Design Trade-offs for a Robust
Dynamic Hybrid Hash Join" — spill partitions that miss their budget must
recursively repartition (fresh hash salt) with heavy-hitter keys split
out, because a bad NDV/skew estimate is a *runtime* problem no better
estimate fixes.

This module holds the decision state; the execution paths live in
exec/local_planner.py (aggregation buffer loop + `_finalize_agg_spill`,
join `_run_partitioned_inner`) and exec/spill.py (salted partitioning,
heavy-key detection/splitting, the spill ledger).

The aggregation mode lattice (session prop `adaptive_partial_agg`):

  full      per-page sort-based partial aggregation + buffer compaction
            (the classic path — wins when groups collapse early)
  shrunken  per-page partial SKIPPED: pages map to per-row partial
            states (no sort), duplicates are caught only by the
            amortized buffer compaction — one sort per buffer instead
            of one per page
  bypass    compaction skipped too: per-row states go straight to host
            spill partitions and the per-partition finalize does ALL
            the grouping (zero wasted reduction work at NDV ~ rows;
            reachable only when spill is enabled)

The controller starts from the CBO hint (estimated group NDV / input
rows, stamped by planner/optimizer.annotate_adaptive_hints) and
re-decides at every buffer-compaction boundary from the OBSERVED
reduction ratio `groups_out / rows_in`, with hysteresis so a borderline
ratio doesn't thrash. Decisions happen only at compaction boundaries —
between device dispatches — so the sliced executor's cooperative
boundary (cancel / low-memory kill / chaos) is never blocked by a mode
switch. In bypass, every `BYPASS_PROBE_EVERY`-th flush still compacts
as a probe so a recovering ratio can re-upgrade.

`AdaptiveQueryState` is the per-QUERY carrier: it outlives a failed
attempt, so the memory-degrade re-run (exec/runner.py's spill-forced
retry) starts from the mode and heavy keys the failed attempt OBSERVED
instead of re-learning them from scratch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# downgrade when a compaction keeps >= this fraction of its input rows
# (partial aggregation is not collapsing groups)
DOWNGRADE_RATIO = 0.8
# re-upgrade when a compaction keeps <= this fraction (hysteresis gap
# between the two keeps a borderline ratio from thrashing)
UPGRADE_RATIO = 0.4
# in bypass, compact every Nth flush anyway to re-measure the ratio
BYPASS_PROBE_EVERY = 4


class AggMode:
    FULL = "full"
    SHRUNKEN = "shrunken"
    BYPASS = "bypass"
    LATTICE = (FULL, SHRUNKEN, BYPASS)


class AggModeController:
    """Reduction-ratio monitor for ONE aggregation operator.

    Owns the mode and the transition counts; the executor mirrors
    transitions into the query's QueryStatsCollector
    (`agg_mode_downgrades` / `agg_mode_upgrades`)."""

    def __init__(self, mode: str = AggMode.FULL,
                 allow_bypass: bool = True):
        self.mode = mode
        self.allow_bypass = bool(allow_bypass)
        self.downgrades = 0
        self.upgrades = 0
        self.flushes = 0
        self.last_ratio: Optional[float] = None
        self.history: List[str] = [mode]

    @staticmethod
    def initial_mode(ndv: Optional[float],
                     rows: Optional[float]) -> str:
        """The CBO's pick: estimated groups / input rows at or past the
        downgrade threshold starts SHRUNKEN (never straight to BYPASS —
        full bypass needs runtime confirmation, estimates miss)."""
        if ndv and rows and rows > 0 and ndv / rows >= DOWNGRADE_RATIO:
            return AggMode.SHRUNKEN
        return AggMode.FULL

    def note_flush(self) -> None:
        self.flushes += 1

    def should_probe(self) -> bool:
        """In bypass: is this flush a ratio-probing compaction?"""
        if self.mode != AggMode.BYPASS:
            return True
        return self.flushes % BYPASS_PROBE_EVERY == 0

    def observe(self, rows_in: int, groups_out: int) -> Optional[str]:
        """One compaction boundary's measurement. Returns 'downgrade',
        'upgrade', or None; at most one lattice step per observation."""
        if rows_in <= 0:
            return None
        ratio = float(groups_out) / float(rows_in)
        self.last_ratio = ratio
        i = AggMode.LATTICE.index(self.mode)
        if ratio >= DOWNGRADE_RATIO and i < len(AggMode.LATTICE) - 1:
            nxt = AggMode.LATTICE[i + 1]
            if nxt == AggMode.BYPASS and not self.allow_bypass:
                return None
            self.mode = nxt
            self.downgrades += 1
            self.history.append(nxt)
            return "downgrade"
        if ratio <= UPGRADE_RATIO and i > 0:
            self.mode = AggMode.LATTICE[i - 1]
            self.upgrades += 1
            self.history.append(self.mode)
            return "upgrade"
        return None


class AdaptiveQueryState:
    """Per-query adaptive state, shared by every executor the query runs
    (local pipeline, shard executors) and — the point — by every retry
    ATTEMPT: the runner keeps one instance for the query's lifetime, so
    the once-per-query spill-forced degrade re-run inherits the failed
    attempt's observed modes and heavy keys instead of restarting cold.

    Keyed by STRUCTURAL operator identity (group-by / join-clause
    symbol names), not plan-node ids: a re-run that re-plans past a
    missed plan cache builds fresh node objects, and the inherited
    state must still find its controller. In distributed runs every
    shard executor binds the shared controller, so
    `attempt_initial_modes` records one entry per executor binding
    (one per attempt on the local engine)."""

    def __init__(self):
        self.agg: Dict[object, AggModeController] = {}
        self.join_heavy: Dict[object, Tuple[int, ...]] = {}
        # per-operator list of the mode each executor binding started
        # in (the regression surface for the degrade-rerun inheritance
        # contract)
        self.attempt_initial_modes: Dict[object, List[str]] = {}

    def agg_controller(self, node_id, ndv: Optional[float] = None,
                       rows: Optional[float] = None,
                       allow_bypass: bool = True) -> AggModeController:
        ctl = self.agg.get(node_id)
        if ctl is None:
            ctl = AggModeController(
                AggModeController.initial_mode(ndv, rows), allow_bypass)
            self.agg[node_id] = ctl
        else:
            # a re-run may force spill on (degrade), flipping bypass
            # from unreachable to reachable
            ctl.allow_bypass = bool(allow_bypass)
        self.attempt_initial_modes.setdefault(node_id, []).append(ctl.mode)
        return ctl

    def record_join_heavy(self, node_id, keys) -> None:
        self.join_heavy[node_id] = tuple(int(k) for k in keys)

    def join_heavy_hint(self, node_id) -> Tuple[int, ...]:
        return self.join_heavy.get(node_id, ())
