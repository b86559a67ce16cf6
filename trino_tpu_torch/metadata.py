"""Metadata facade + Session.

Reference parity: core/trino-main metadata/MetadataManager.java (catalog/
table resolution over connectors) and Session.java (catalog/schema defaults,
session properties — SystemSessionProperties.java's property bag).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Tuple

from trino_tpu_torch.connector.spi import (
    CatalogManager, ColumnHandle, Connector, ConnectorTableHandle,
    SchemaTableName, TableMetadata, TableStatistics)

_query_ids = itertools.count(1)

# SystemSessionProperties.java:55-120 analogs (the load-bearing subset)
SESSION_PROPERTY_DEFAULTS: Dict[str, Any] = {
    "join_distribution_type": "AUTOMATIC",   # BROADCAST | PARTITIONED
    "join_reordering_strategy": "AUTOMATIC",  # NONE | ELIMINATE_CROSS_JOINS | AUTOMATIC
    "query_max_memory": 16 << 30,
    "page_capacity": 1 << 16,      # rows per device page
    "scan_page_capacity": 1 << 22,  # max rows per scan page (big fused scans)
    "join_broadcast_threshold_rows": 1_000_000,
    # coalesce filtered probe pages into buffers of ~this many rows before
    # join probes: a probe kernel has a large fixed cost (sort-engine
    # passes), so fewer, larger launches win (round-4 profiling: q3 SF10
    # spent ~23s in 19 per-page probe calls)
    "probe_coalesce_rows": 1 << 25,
    "distributed_sort": True,
    "enable_dynamic_filtering": True,
    # spill defaults ON (SystemSessionProperties spill_enabled; the v5e
    # HBM is the scarce resource — a >threshold INNER build keeps only its
    # sorted key array on device and pays host gathers at match count)
    "spill_enabled": True,
    "join_spill_threshold_bytes": 1 << 30,
    # aggregation spill: partial-state buffers over this compact via
    # Step.INTERMEDIATE; non-collapsing groups spill to host hash
    # partitions (exec/spill.py), finalized one partition at a time
    "agg_spill_threshold_bytes": 2 << 30,
    "spill_partition_count": 16,
    # sort spill: buffered input over this flushes as host runs, finished
    # by range partitions of the leading sort key
    "sort_spill_threshold_bytes": 2 << 30,
    # adaptive partial aggregation ("Partial Partial Aggregates"): the
    # partial-aggregation step monitors its observed reduction ratio at
    # every buffer-compaction boundary and walks the mode lattice
    # full (per-page sort partial) -> shrunken (per-row pass-through
    # states, compaction only per buffer) -> bypass (states straight to
    # spill partitions; the per-partition finalize does ALL grouping)
    # when NDV turns out effectively high — re-upgrading when the ratio
    # recovers. Initial mode comes from the CBO NDV hint; transitions
    # count as agg_mode_downgrades / agg_mode_upgrades. Set false to pin
    # the classic always-full partial aggregation.
    "adaptive_partial_agg": True,
    # recursive hybrid spill ("Robust Dynamic Hybrid Hash Join"): a
    # spill partition still over its byte budget after a round
    # repartitions with a FRESH hash salt up to this depth, then falls
    # back to bounded chunked processing (spill_fallbacks counter).
    # 0 = no recursion, straight to the chunked fallback.
    "spill_max_recursion": 3,
    # per-partition heavy-hitter splitting: up to this many heavy keys
    # (top-k over host partition pieces — detect_heavy_keys' discipline
    # applied to spilled data) are split into dedicated bounded paths
    # instead of recursing forever (re-hashing can never separate one
    # key's rows). 0 disables detection. Counted as heavy_key_splits.
    "spill_heavy_key_limit": 8,
    # host-RAM byte budget for a query's spill partition stores, charged
    # through the process SpillLedger (trino_tpu_spill_bytes gauge);
    # an over-budget spill fails classified EXCEEDED_SPILL_LIMIT instead
    # of silently exhausting host RAM. 0 = default: half of physical
    # host RAM (exec/spill.default_spill_limit_bytes).
    "spill_max_bytes": 0,
    # MXU-native join-project (ops/join_mxu.py; router in
    # exec/local_planner._prepare_probe): eligible INNER join-project,
    # semijoin/anti-semijoin, distinct-project, and many-to-many
    # AGGREGATING joins (the TPC-DS q64/q72 shapes — match
    # multiplicities feed SUM/COUNT without materializing the cross
    # product) execute as density-partitioned indicator MATMULS on the
    # matrix unit instead of gather/searchsorted probes. Routing is
    # per-join from the OBSERVED build-key density at runtime; EXPLAIN
    # prints the plan-time candidate (`join strategy: mxu-matmul |
    # gather`) and the mxu_joins / mxu_flops counters report what
    # actually ran. All three properties are plan-affecting (the plan
    # cache keys on them).
    "mxu_join_enabled": True,
    # minimum observed key-range density (distinct live build keys /
    # key span) to route onto the matmul path; sparser builds keep the
    # gather path — their indicator matrices would be mostly zeros
    # (the density partitioning of arXiv 2206.04995)
    "mxu_join_density_threshold": 0.05,
    # maximum key-span slots for the indicator tables: bounds the
    # per-probe-page matmul cost (O(rows x slots) MACs) and the
    # table's HBM footprint
    "mxu_join_max_slots": 4096,
    # fault-tolerant execution (RetryPolicy / SystemSessionProperties
    # retry_policy + task_retry_attempts_per_task analogs): TASK retries
    # individual fragments, QUERY re-runs the whole statement, NONE fails
    # fast. Backoff is exponential with jitter between attempts.
    "retry_policy": "NONE",            # NONE | TASK | QUERY
    "retry_attempts": 4,
    "retry_initial_delay_ms": 10,
    "retry_max_delay_ms": 1000,
    # chaos harness (exec/faults.py): rate > 0 arms a seeded injector per
    # query; sites is a comma list drawn from fragment,exchange,scan,
    # spill,memory,slice,engine (empty = all). Same seed + same
    # statements = same faults. Site `engine` is PROCESS-level: inside a
    # fleet engine child it kills the engine process mid-dispatch
    # (SIGKILL, or $TRINO_TPU_FAULT_ENGINE_SIGNAL), driving the
    # supervisor crash-recovery path; elsewhere it raises an ordinary
    # retryable InjectedFault.
    "fault_injection_rate": 0.0,
    "fault_injection_seed": 0,
    "fault_injection_sites": "",
    # idempotent-write identity: empty means each execution is its own
    # write (token = query id). A client that must RETRY a failed
    # INSERT/CTAS — e.g. after the fleet's retryable ENGINE_UNAVAILABLE
    # answer — sets the same token on both attempts and the sink's
    # committed-token ledger makes the replay exactly-once: if the first
    # attempt's commit landed before the engine died, the replay
    # becomes a no-op instead of a duplicate append.
    "write_token": "",
    # deadlines (QueryTracker.enforceTimeLimits analogs): Trino Duration
    # strings ('30s', '2m', '500ms') or bare seconds; empty = unlimited.
    # run time counts from queueing, execution time from planning start.
    "query_max_run_time": "",
    "query_max_execution_time": "",
    # resource governance (InternalResourceGroup + ClusterMemoryManager
    # analogs): `resource_group` routes the query through the server's
    # group tree (admission + weighted-fair scheduling) and is stamped on
    # system.runtime.queries; `cluster_memory_wait_ms` bounds how long a
    # reservation blocks for a low-memory-killer victim to release node
    # pool bytes before failing retryable (CLUSTER_OUT_OF_MEMORY).
    "resource_group": "global",
    "cluster_memory_wait_ms": 2000,
    # parameterized kernel compilation (expr/hoist.py): hoist numeric/
    # date/decimal literals out of lowered expressions into runtime
    # parameter slots so literal variants of one query shape share a
    # single XLA executable (jit-cache key = canonical literal-free
    # tree). Default on; set false to pin a misbehaving shape back to
    # per-literal compilation for debugging.
    "hoist_literals": True,
    # plan cache (exec/plan_cache.py): reuse optimized plans for repeated
    # statement shapes — a prepared statement's EXECUTE ... USING binds
    # new values to one cached (value-free) plan, so re-execution skips
    # parse/analyze/plan/optimize entirely. Keys include catalog/schema,
    # current_date, parameter types, and the plan-affecting properties
    # (join_*, distributed_sort); DDL/INSERT invalidate by table. Set
    # false to pin a statement back to plan-per-execution.
    # plan_cache_max_entries resizes the LRU only on the runner that OWNS
    # the cache (SET SESSION on a direct runner / server config) — a
    # per-request header override on a pooled query clone must not evict
    # every other session's warm plans from the shared cache.
    "plan_cache_enabled": True,
    "plan_cache_max_entries": 256,
    # serving tier (trino_tpu/serve/): result-set caching — a repeated
    # statement (same fingerprint + literal/parameter VALUES) over
    # unchanged tables returns its materialized answer with zero
    # planning, zero compiles, zero execution. INSERT/DDL evicts through
    # the plan cache's invalidation hooks. Off by default on direct
    # runners; TrinoServer turns it on for server sessions (the
    # production front door is what the cache exists for). Skipped per
    # query under fault injection (a cached answer would dodge the chaos
    # the session asked for) and under collect_operator_stats (operator
    # rows must come from a real execution).
    "result_cache_enabled": False,
    "result_cache_max_entries": 128,
    # per-entry row bound: results larger than this are never cached
    # (and a streamed result past the bound stops buffering host-side)
    "result_cache_max_rows": 100000,
    # table-scan page cache: raw connector pages staged on device,
    # reusable by ANY query over the same columns; byte-budgeted LRU,
    # invalidated per table like the result cache. Off by default
    # (direct runners); TrinoServer turns it on.
    "scan_cache_enabled": False,
    # device-resident hot-table cache (exec/table_cache.py): columns of
    # frequently-scanned tables promote into HBM and stay resident
    # ACROSS queries — a warm repeated scan (local dispatch loop or
    # mesh shard_map staging alike) does zero host->device transfers
    # (proven per query by the scan_staging_bytes counter). Admission
    # is scan-frequency x size under table_cache_max_bytes, residency
    # is accounted against the per-chip node pool, and invalidation
    # rides the PlanCache hook fan-out (one INSERT/DDL drops plans,
    # results, scan pages, and device columns). Off by default on
    # direct runners; TrinoServer turns it on. The warmup manifest's
    # `tables:` entries preload into this tier at server start.
    "table_cache_enabled": False,
    # byte budget for resident columns; the lowest-frequency entry
    # evicts first when a promotion would overflow it
    "table_cache_max_bytes": 1 << 30,
    # scans of one (table, columns) working set before promotion —
    # 1 promotes on the first scan (bench/warmup style), higher values
    # keep one-shot scans from churning HBM
    "table_cache_min_scans": 2,
    # lake connector pruning (connector/lake/): evaluate partition
    # values + per-file/per-row-group min/max zone maps against the
    # scan's TupleDomain (static pushdown AND join dynamic filters) and
    # skip non-overlapping files/row groups entirely — counted per
    # query as files_pruned / row_groups_pruned. Set false to force
    # full-table reads (debugging / pruning-correctness comparisons).
    "lake_zone_maps_enabled": True,
    # lake read-side content verification (connector/lake/): every data
    # file carries a blake2b physical digest and every (row group,
    # column) a canonical content digest, recorded at commit.
    # "row_group" (default) re-hashes exactly the decoded chunks the
    # scan touches; "file" additionally verifies the physical file bytes
    # before decode; "off" trusts the bytes (the chaos suite proves
    # "off" is how silent wrong answers happen). A mismatch raises
    # classified LAKE_DATA_CORRUPTION and quarantines the file. Each
    # (file content, chunk) is verified ONCE per process — a ledger
    # keyed on (path, mtime_ns, size) skips re-hashing on warm scans;
    # lake_fsck / bench --scrub re-verify every digest regardless.
    "lake_verify_checksums": "row_group",
    # retained manifest-log depth (the Iceberg metadata-pointer model):
    # each commit writes an immutable manifest-<v>.json and swaps the
    # pointer; the last N versions stay on disk as lake_fsck's rollback
    # targets. Min 1 (the current version itself).
    "lake_manifest_history": 8,
    # observability (obs/stats.py + obs/profiler.py): per-operator stats
    # collection for EVERY query on the session (EXPLAIN ANALYZE forces
    # it regardless). Since round 13 this does NOT split fused kernel
    # chains or change which executables run: a chain is timed once per
    # dispatch (block_until_ready at chain granularity) and the measured
    # device wall apportions across the chain's operators by XLA cost
    # analysis. Off by default because the per-chain fence still costs
    # host/device pipelining, not because it changes the plan.
    "collect_operator_stats": False,
    # Chrome-trace export (obs/spans.to_chrome_trace): at query end the
    # span tree (query -> phase -> fragment -> exchange -> operator,
    # plus slice/checkpoint/spill/adaptive spans) serializes as
    # Perfetto-loadable JSON into $TRINO_TPU_TRACE_DIR (or the server's
    # trace_dir, or <tmp>/trino_tpu_traces), and QueryInfo.trace_file /
    # GET /v1/query/{id}/trace point at it. Off by default (one file
    # per query).
    "trace_export": False,
    # query-history ring (obs/history.py): completed/failed/canceled
    # queries retained past the live tracker's pruning bound, queryable
    # via system.runtime.completed_queries and GET /v1/query/{id}.
    # Sized by the OWNING runner's session (server deployments:
    # TrinoServer(history_max_entries=...)); eviction is FIFO by
    # completion order.
    "history_max_entries": 512,
    # multi-chip sharded execution (exec/mesh_exec.py): co-schedule
    # eligible fragment chains as ONE jitted shard_map program over the
    # device mesh — per-shard scan/filter/join/aggregate pipelines with
    # the inter-fragment exchanges as in-program collectives (all_to_all /
    # all_gather), so multi-stage plans never stage pages through the
    # host. Unsupported shapes (and chaos runs — per-shard fault sites
    # must fire) fall back to the per-shard dispatch loop transparently;
    # operator-stats runs STAY on the mesh and emit program-level rows.
    "mesh_execution": True,
    # partitioned vs. global GROUP BY strategy threshold ("Global Hash
    # Tables Strike Back"): estimated group NDV at or above this
    # repartitions by group key (partitioned strategy, final agg
    # parallelizes across chips); below it the tiny partial states gather
    # to one shard (global strategy, no all_to_all). Plan-affecting
    # (plan cache keys on it).
    "partitioned_agg_min_ndv": 1024,
    # skew-aware repartition (JSPIM heavy-hitter handling) for
    # mesh-co-scheduled partitioned joins: probe rows of globally-heavy
    # keys spread round-robin across shards and the matching build rows
    # replicate to every shard, so one hot key cannot overload a chip.
    "skewed_exchange_enabled": True,
    # static top-k candidate slots per shard for in-program heavy-hitter
    # detection (per-shard top-k -> all_gather -> global counts)
    "skew_heavy_key_limit": 8,
    # preemptible sliced execution (exec/sliced/): long operators run as
    # row-budgeted slices with a cooperative boundary between them —
    # DELETE cancels within one slice, the low-memory killer reclaims a
    # victim's HBM at the next boundary, and fragment retry resumes from
    # per-shard checkpoints instead of re-running whole fragments. Scan
    # page capacity is bounded by the slice budget so no single kernel
    # launch exceeds a slice. Set false to pin a query back to
    # unbounded operator runs (debugging).
    "sliced_execution": True,
    # initial rows-per-slice budget; the wall EWMA retunes it toward
    # slice_target_ms per slice (0 disables wall tuning — the static
    # row budget binds)
    "slice_target_rows": 1 << 20,
    "slice_target_ms": 250,
    # materialized views (trino_tpu/mv/): rewrite eligible aggregate
    # queries onto a fresh-enough MV's stored state instead of scanning
    # the base table — the update-on-write serving path. A rewrite only
    # fires when the MV's refresh lag (base table's current version
    # committed_at minus the version the MV last folded in) is within
    # mv_max_staleness_s; 0 demands the MV be exactly current.
    "mv_rewrite_enabled": True,
    "mv_max_staleness_s": 60.0,
    # REFRESH strategy: AUTO tries the manifest-delta incremental path
    # and falls back to full recompute when the delta is unavailable
    # (pruned baseline / non-append commit) or the view shape is
    # non-incrementalizable; FULL always recomputes; DELTA fails
    # instead of falling back (tests/bench determinism).
    "mv_refresh_mode": "AUTO",
}

# One doc line per SESSION property — system.runtime surfaces and the
# property-docs lint (tests/test_property_docs.py) key off this dict:
# registering a property without documenting it fails CI.
SESSION_PROPERTY_DOCS: Dict[str, str] = {
    "join_distribution_type":
        "Join build-side placement: AUTOMATIC (cost-based), BROADCAST, "
        "or PARTITIONED. Plan-affecting (plan cache keys on it).",
    "join_reordering_strategy":
        "Join-order search: AUTOMATIC, ELIMINATE_CROSS_JOINS, or NONE. "
        "Plan-affecting.",
    "query_max_memory":
        "Per-query device-memory reservation ceiling in bytes.",
    "page_capacity":
        "Rows per device page for operator pipelines.",
    "scan_page_capacity":
        "Max rows per scan page (big fused scans).",
    "join_broadcast_threshold_rows":
        "Estimated build rows at or below which AUTOMATIC join "
        "distribution broadcasts. Plan-affecting.",
    "probe_coalesce_rows":
        "Coalesce filtered probe pages into buffers of ~this many rows "
        "before join probes (fewer, larger kernel launches).",
    "distributed_sort":
        "Sort via per-shard runs + merge instead of a global sort. "
        "Plan-affecting.",
    "enable_dynamic_filtering":
        "Build-side join key domains prune probe-side scans "
        "(files/row groups) at runtime.",
    "spill_enabled":
        "Over-threshold join builds keep only sorted keys on device "
        "and pay host gathers (HBM is the scarce resource).",
    "join_spill_threshold_bytes":
        "Build-side byte size that triggers the join spill path.",
    "agg_spill_threshold_bytes":
        "Partial-aggregation state bytes that trigger INTERMEDIATE "
        "compaction and host hash-partition spill.",
    "spill_partition_count":
        "Hash partitions for spilled aggregation/join state.",
    "sort_spill_threshold_bytes":
        "Buffered sort input bytes that flush as host runs finished "
        "by range partitions of the leading key.",
    "adaptive_partial_agg":
        "Partial aggregation walks full -> shrunken -> bypass modes "
        "from the observed reduction ratio ('Partial Partial "
        "Aggregates'); false pins classic full partials.",
    "spill_max_recursion":
        "Over-budget spill partitions repartition with fresh hash "
        "salts up to this depth, then fall back to bounded chunking.",
    "spill_heavy_key_limit":
        "Heavy keys split into dedicated bounded paths per spill "
        "partition (re-hashing cannot separate one key); 0 disables.",
    "spill_max_bytes":
        "Host-RAM budget for a query's spill stores; exceeding fails "
        "EXCEEDED_SPILL_LIMIT. 0 = half of physical host RAM.",
    "mxu_join_enabled":
        "Route eligible joins as density-partitioned indicator matmuls "
        "on the matrix unit (ops/join_mxu.py). Plan-affecting.",
    "mxu_join_density_threshold":
        "Minimum observed build-key density to take the matmul path; "
        "sparser builds keep gather probes. Plan-affecting.",
    "mxu_join_max_slots":
        "Max key-span slots for MXU indicator tables (bounds per-page "
        "matmul cost and HBM footprint). Plan-affecting.",
    "retry_policy":
        "Fault-tolerant execution: NONE fails fast, TASK retries "
        "fragments, QUERY re-runs the whole statement.",
    "retry_attempts":
        "Max retry attempts under TASK/QUERY retry policies.",
    "retry_initial_delay_ms":
        "Base of the exponential retry backoff.",
    "retry_max_delay_ms":
        "Cap of the exponential retry backoff.",
    "fault_injection_rate":
        "Chaos harness: probability a declared fault site fires "
        "(seeded per query); 0 disables injection.",
    "fault_injection_seed":
        "Chaos determinism: same seed + same statements = same faults.",
    "fault_injection_sites":
        "Comma list of armed fault sites (fragment,exchange,scan,spill,"
        "memory,slice,engine,corrupt); empty = all.",
    "write_token":
        "Idempotent-write identity: a client retrying a failed "
        "INSERT/CTAS sets the same token on both attempts and the "
        "sink's committed-token ledger makes the replay exactly-once. "
        "Empty = each execution is its own write (token = query id).",
    "query_max_run_time":
        "Deadline from queueing ('30s', '2m', bare seconds); empty = "
        "unlimited.",
    "query_max_execution_time":
        "Deadline from planning start; empty = unlimited.",
    "resource_group":
        "Resource-group path for admission + weighted-fair scheduling.",
    "cluster_memory_wait_ms":
        "How long a reservation blocks for a low-memory-killer victim "
        "before failing retryable CLUSTER_OUT_OF_MEMORY.",
    "hoist_literals":
        "Hoist numeric/date/decimal literals into runtime parameter "
        "slots so literal variants share one XLA executable.",
    "plan_cache_enabled":
        "Reuse optimized plans for repeated statement shapes "
        "(exec/plan_cache.py).",
    "plan_cache_max_entries":
        "Plan-cache LRU capacity (resized only by the owning runner).",
    "result_cache_enabled":
        "Serve repeated statements over unchanged tables from the "
        "materialized result tier (serve/caches.py).",
    "result_cache_max_entries":
        "Result-cache LRU capacity.",
    "result_cache_max_rows":
        "Results larger than this many rows are never cached.",
    "scan_cache_enabled":
        "Stage raw connector pages on device for reuse by any query "
        "over the same columns (byte-budgeted LRU).",
    "table_cache_enabled":
        "Promote frequently-scanned table columns into HBM across "
        "queries (exec/table_cache.py).",
    "table_cache_max_bytes":
        "Byte budget for HBM-resident table columns.",
    "table_cache_min_scans":
        "Scans of one (table, columns) working set before promotion.",
    "lake_zone_maps_enabled":
        "Prune lake files/row groups via partition values + min/max "
        "zone maps against the scan's TupleDomain.",
    "lake_verify_checksums":
        "Lake read verification: row_group (default) re-hashes decoded "
        "chunks, file also verifies physical bytes, off trusts them.",
    "lake_manifest_history":
        "Retained manifest-log depth per lake table (rollback targets; "
        "MV-pinned versions are kept beyond it). Min 1.",
    "collect_operator_stats":
        "Per-operator stats for every query on the session (EXPLAIN "
        "ANALYZE forces it); costs a per-chain dispatch fence.",
    "trace_export":
        "Serialize the query's span tree as a Perfetto-loadable "
        "Chrome trace at query end.",
    "history_max_entries":
        "Completed-query history ring size (owning runner's session).",
    "mesh_execution":
        "Co-schedule eligible fragment chains as one jitted shard_map "
        "program with in-program collective exchanges.",
    "partitioned_agg_min_ndv":
        "Estimated group NDV at/above which GROUP BY repartitions by "
        "key instead of gathering tiny partials to one shard "
        "('Global Hash Tables Strike Back'). Plan-affecting.",
    "skewed_exchange_enabled":
        "Spread globally-heavy probe keys round-robin and replicate "
        "their build rows (skew-aware repartition).",
    "skew_heavy_key_limit":
        "Top-k candidate slots per shard for in-program heavy-hitter "
        "detection.",
    "sliced_execution":
        "Run long operators as row-budgeted preemptible slices with "
        "cooperative cancel/checkpoint boundaries.",
    "slice_target_rows":
        "Initial rows-per-slice budget.",
    "slice_target_ms":
        "Wall target the slice EWMA retunes the row budget toward "
        "(0 = static row budget).",
    "mv_rewrite_enabled":
        "Rewrite eligible aggregate queries onto a fresh-enough "
        "materialized view's stored state (trino_tpu/mv/) — the "
        "update-on-write serving path.",
    "mv_max_staleness_s":
        "Max refresh lag (seconds between the base table's current "
        "commit and the version the MV last folded in) an MV rewrite "
        "tolerates; 0 demands the MV be exactly current.",
    "mv_refresh_mode":
        "REFRESH MATERIALIZED VIEW strategy: AUTO (manifest-delta "
        "incremental, full-recompute fallback), FULL (always "
        "recompute), DELTA (fail instead of falling back).",
}

# SERVER- and FLEET-level properties (round 14): deployment knobs that
# live on the server/fleet constructors, NOT in the per-session bag —
# documented here alongside the session properties because operators
# reach for one list. The resource-group JSON file (TrinoServer
# resource_groups_path / FleetServer resource_groups_path) additionally
# accepts per-group `result_cache_qps` / `result_cache_qps_burst`
# (camelCase aliases accepted): a token-bucket QPS quota on the
# result-cache fast path — over-quota hits answer QUERY_QUEUE_FULL.
# The file HOT-RELOADS on mtime change (engine and fleet workers alike),
# so quota/limit edits apply without a restart.
SERVER_PROPERTY_DOCS: Dict[str, str] = {
    "drain_timeout_s":
        "TrinoServer: how long stop() lets in-flight queries and "
        "actively-consumed result streams finish before canceling the "
        "rest and tearing down (default 10.0; 0 = immediate teardown).",
    "drain_idle_grace_s":
        "TrinoServer: an open result stream with no page request for "
        "this long counts as abandoned and no longer holds the drain "
        "(default 1.0).",
    "resource_groups_path":
        "TrinoServer/FleetServer: resource-group JSON config file; "
        "re-applied automatically on mtime change (hot reload), "
        "including per-group result_cache_qps quotas.",
    "workers":
        "FleetServer: number of SO_REUSEPORT worker processes sharing "
        "the fleet port (default 2). Workers answer result-cache hits "
        "from the cross-process shared tier; everything else funnels "
        "to the one engine process that owns the device runner.",
    "fleet_dir":
        "FleetServer: rendezvous directory (shm cache file, bus "
        "sockets, prepared-statement registry, worker records); a "
        "private tempdir by default.",
    "shm_data_bytes":
        "FleetServer: byte size of the shared result-cache ring "
        "(default 64MB).",
    "drain_grace_s":
        "FleetServer/worker: how long a draining worker keeps "
        "accepting while answering `Connection: close` before closing "
        "its listener (default 0.5) — the zero-drop handoff window of "
        "a rolling restart.",
    "in_process":
        "FleetServer: run workers as in-process threads instead of "
        "subprocesses (tests/debugging only — shares the GIL).",
    "engine_in_process":
        "FleetServer: run the engine inside the parent process (PR-13 "
        "topology; implied by passing a runner). Default False: the "
        "engine is a supervised subprocess that crash-recovers by "
        "rehydrating prepared statements, warmup priming, and the "
        "crash-surviving shm tier.",
    "probe_interval_s":
        "FleetServer supervisor: seconds between engine/worker "
        "liveness checks (default 0.5). Engine death is also caught "
        "immediately via waitpid.",
    "probe_timeout_s":
        "FleetServer supervisor: HTTP liveness-probe timeout against "
        "the engine's metrics endpoint (default 2.0).",
    "engine_stall_probes":
        "FleetServer supervisor: consecutive failed liveness probes "
        "before a live-but-wedged engine is SIGKILLed and respawned "
        "(default 6).",
    "worker_respawn_max":
        "FleetServer: bounded respawn attempts for a worker that dies "
        "at startup or mid-flight before the fleet gives up on that "
        "logical worker (default 3).",
    "respawn_backoff_s":
        "FleetServer: base of the exponential respawn backoff for "
        "crashed workers (default 0.25; doubles per attempt).",
    "breaker_failure_threshold":
        "Fleet worker: consecutive engine-dispatch failures before the "
        "circuit breaker opens and misses fast-fail with the "
        "retryable ENGINE_UNAVAILABLE answer (default 3). Hits keep "
        "serving from the shm tier regardless.",
    "breaker_reset_s":
        "Fleet worker: seconds an open breaker waits before a single "
        "half-open trial probes the engine (default 1.0); the "
        "supervisor's engine-epoch bus notice closes it immediately "
        "on respawn.",
    "forward_retries":
        "Fleet worker: dispatch attempts (with exponential backoff) "
        "against the engine before a miss is answered "
        "ENGINE_UNAVAILABLE (default 3).",
    "forward_backoff_s":
        "Fleet worker: base backoff between dispatch retries "
        "(default 0.05; doubles per attempt).",
    "handoff_enabled":
        "FleetServer: engine_restart() passes the LIVE dispatch "
        "listener to the replacement over SCM_RIGHTS (default True; "
        "zero dropped queries — misses included). False swaps "
        "stop-then-bind: a brief miss outage covered by the workers' "
        "retry discipline.",
    "lake_fsck gc_grace_s":
        "lake_fsck(gc_grace_s=...): orphan data files (referenced by "
        "NO retained manifest version) younger than this are never "
        "collected (default 900s) — an open sink's staged files are "
        "unreferenced until its commit.",
    "poison_crash_threshold":
        "FleetSupervisor: crash-correlated engine restarts attributed "
        "to the same statement digest before that digest is "
        "quarantined (default 2). Workers then fast-fail it with "
        "non-retryable STATEMENT_QUARANTINED instead of letting one "
        "query crash-loop the engine.",
    "poison_ttl_s":
        "FleetSupervisor: how long a poisoned statement digest stays "
        "quarantined (default 300s); after the TTL workers let it "
        "through again.",
    "host":
        "TrinoServer/FleetServer: bind address (default 127.0.0.1).",
    "port":
        "TrinoServer/FleetServer: bind port; 0 picks an ephemeral "
        "port (read it back from server.port).",
    "listen_fd":
        "TrinoServer: adopt an already-bound listening socket by file "
        "descriptor instead of binding host:port — the SCM_RIGHTS "
        "zero-drop restart handoff path.",
    "max_queued":
        "TrinoServer: queued-statement bound before new submissions "
        "answer QUERY_QUEUE_FULL (default 200).",
    "max_running":
        "TrinoServer: concurrent running-statement bound; the "
        "scheduler holds the rest queued (default 4).",
    "keep":
        "TrinoServer: finished-query records retained for the "
        "status/results endpoints (default 200).",
    "query_timeout_s":
        "TrinoServer: wall-clock ceiling per statement; over-limit "
        "queries cancel with EXCEEDED_TIME_LIMIT (default None).",
    "schema":
        "FleetServer: TPC-H schema the engine subprocess loads "
        "(default 'tiny').",
    "streaming":
        "TrinoServer: stream result pages through the spooled ring "
        "instead of materializing full results (default True).",
    "stream_ring_chunks":
        "TrinoServer: page slots in each streaming result ring "
        "(producer backpressure depth).",
    "stream_stall_timeout_s":
        "TrinoServer: producer-side stall bound when a streaming "
        "consumer stops fetching; on expiry the stream cancels "
        "instead of wedging a worker.",
    "plan_cache_max_entries":
        "TrinoServer: process plan-cache capacity override.",
    "history_max_entries":
        "TrinoServer: completed-query history ring capacity "
        "(system.runtime.completed_queries depth).",
    "metrics_wall_buckets":
        "TrinoServer: histogram bucket edges (ms) for the query wall "
        "latency metric.",
    "otlp_export":
        "TrinoServer: OTLP span-export target for query traces "
        "(endpoint URL, or a file path sink).",
    "trace_dir":
        "TrinoServer: directory for per-query JSON trace files "
        "(default off).",
    "compilation_cache_dir":
        "TrinoServer: persistent XLA compilation cache directory — "
        "restarts skip recompilation of warmed query shapes.",
}


@dataclasses.dataclass
class Session:
    catalog: Optional[str] = "tpch"
    schema: Optional[str] = "tiny"
    user: str = "user"
    query_id: str = ""
    start_date: int = 0  # days since epoch; current_date constant for the query
    properties: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.query_id:
            self.query_id = f"q_{next(_query_ids)}"
        if not self.start_date:
            import datetime
            self.start_date = (datetime.date.today()
                               - datetime.date(1970, 1, 1)).days

    def get(self, prop: str) -> Any:
        if prop in self.properties:
            return self.properties[prop]
        if prop not in SESSION_PROPERTY_DEFAULTS:
            from trino_tpu_torch.errors import InvalidSessionPropertyError
            raise InvalidSessionPropertyError(
                f"unknown session property: {prop}")
        return SESSION_PROPERTY_DEFAULTS[prop]

    def set(self, prop: str, value: Any):
        if prop not in SESSION_PROPERTY_DEFAULTS:
            from trino_tpu_torch.errors import InvalidSessionPropertyError
            raise InvalidSessionPropertyError(
                f"unknown session property: {prop}")
        self.properties[prop] = _coerce_property(prop, value)


def _coerce_property(prop: str, value: Any) -> Any:
    """Coerce a session-property value to its default's type
    (SessionPropertyManager.decodeProperty analog): values arrive as raw
    strings over the X-Trino-Session header, and storing `"false"` for a
    boolean property would read truthy everywhere (`bool("false")` is
    True). A malformed value raises InvalidSessionPropertyError at SET
    time, not mid-query."""
    from trino_tpu_torch.errors import InvalidSessionPropertyError
    default = SESSION_PROPERTY_DEFAULTS[prop]
    try:
        if isinstance(default, bool):
            if isinstance(value, str):
                lowered = value.strip().lower()
                if lowered in ("true", "1", "on", "yes"):
                    return True
                if lowered in ("false", "0", "off", "no"):
                    return False
                raise ValueError(f"not a boolean: {value!r}")
            return bool(value)
        if isinstance(default, int):
            return int(value)
        if isinstance(default, float):
            return float(value)
        if isinstance(default, str):
            return str(value)
        return value
    except (TypeError, ValueError) as e:
        raise InvalidSessionPropertyError(
            f"invalid value for session property {prop}: {e}") from e


@dataclasses.dataclass(frozen=True)
class QualifiedTable:
    catalog: str
    schema: str
    table: str

    def __str__(self):
        return f"{self.catalog}.{self.schema}.{self.table}"

    @property
    def schema_table(self) -> SchemaTableName:
        return SchemaTableName(self.schema, self.table)


class Metadata:
    """MetadataManager.java — name resolution across catalogs."""

    def __init__(self, catalogs: CatalogManager):
        self.catalogs = catalogs

    def resolve_table_name(self, parts: Tuple[str, ...],
                           session: Session) -> QualifiedTable:
        if len(parts) == 1:
            if not session.catalog or not session.schema:
                raise ValueError(
                    f"session catalog/schema not set for table {parts[0]}")
            return QualifiedTable(session.catalog, session.schema, parts[0])
        if len(parts) == 2:
            if not session.catalog:
                raise ValueError("session catalog not set")
            return QualifiedTable(session.catalog, parts[0], parts[1])
        if len(parts) == 3:
            return QualifiedTable(parts[0], parts[1], parts[2])
        raise ValueError(f"invalid table name: {'.'.join(parts)}")

    def connector(self, catalog: str) -> Connector:
        return self.catalogs.get(catalog)

    def get_table_handle(self, name: QualifiedTable
                         ) -> Optional[ConnectorTableHandle]:
        try:
            conn = self.catalogs.get(name.catalog)
        except KeyError:
            return None
        return conn.metadata.get_table_handle(name.schema_table)

    def get_table_metadata(self, catalog: str,
                           handle: ConnectorTableHandle) -> TableMetadata:
        return self.catalogs.get(catalog).metadata.get_table_metadata(handle)

    def get_column_handles(self, catalog: str,
                           handle: ConnectorTableHandle) -> List[ColumnHandle]:
        return self.catalogs.get(catalog).metadata.get_column_handles(handle)

    def get_table_statistics(self, catalog: str,
                             handle: ConnectorTableHandle) -> TableStatistics:
        return self.catalogs.get(catalog).metadata.get_table_statistics(handle)
