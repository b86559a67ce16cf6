"""LocalQueryRunner: SQL in, rows out, one process, one device.

Port of `trino_tpu/exec/runner.py` (reference parity: testing/
LocalQueryRunner.java:230): parse, analyze, plan, optimize and execute on
one device, plus the session-level statements (USE, SET SESSION, EXPLAIN,
SHOW ...). The runner runs on `cuda` unless the caller passes a device
(`device="cpu"` for the tests); without CUDA and without an explicit
device it raises.

Every query gets a memory context under `query_max_memory`, attached to
the process node pool (exec/memory.py). Left out (ROADMAP A6/A10): the
plan, result, scan and table caches, materialized views, retries and the
memory-pressure re-run, the low-memory killer, fault injection,
deadlines, the query tracker, DDL/DML and prepared statements.
"""

from __future__ import annotations

import dataclasses
import datetime
import decimal
from typing import Any, List, Optional, Tuple

import numpy as np

from trino_tpu_torch import types as T
from trino_tpu_torch.connector import tpcds, tpch
from trino_tpu_torch.connector.spi import CatalogManager
from trino_tpu_torch.exec.local_planner import (QUERY_COUNTERS,
                                                LocalExecutionPlanner,
                                                WindowLog)
from trino_tpu_torch.exec.memory import NODE_POOL
from trino_tpu_torch.metadata import Metadata, Session
from trino_tpu_torch.page import resolve_device
from trino_tpu_torch.planner import LogicalPlanner
from trino_tpu_torch.planner.nodes import OutputNode, format_plan
from trino_tpu_torch.planner.optimizer import fragment_plan, optimize
from trino_tpu_torch.sql import parse_statement
from trino_tpu_torch.sql import tree as t
from trino_tpu_torch.sql.analyzer import SemanticError


@dataclasses.dataclass
class MaterializedResult:
    """testing/MaterializedResult.java analog."""

    column_names: List[str]
    column_types: List[T.Type]
    rows: List[Tuple[Any, ...]]
    row_count: Optional[int] = None

    @property
    def reported_rows(self) -> int:
        return len(self.rows) if self.row_count is None else self.row_count

    def __len__(self):
        return len(self.rows)

    def only_value(self):
        if len(self.rows) != 1 or len(self.rows[0]) != 1:
            raise ValueError("result is not a single value")
        return self.rows[0][0]


def _to_python(value, typ: T.Type):
    if value is None:
        return None
    if isinstance(typ, T.ArrayType):
        return [_to_python(v, typ.element) for v in value]
    if isinstance(typ, T.MapType):
        return {_to_python(k, typ.key): _to_python(v, typ.value)
                for k, v in value.items()}
    if isinstance(typ, T.DecimalType):
        return decimal.Decimal(int(value)).scaleb(-typ.scale)
    if isinstance(typ, T.DateType):
        return datetime.date(1970, 1, 1) + datetime.timedelta(days=int(value))
    if isinstance(typ, T.TimestampType):
        return (datetime.datetime(1970, 1, 1)
                + datetime.timedelta(microseconds=int(value)))
    if isinstance(typ, T.BooleanType):
        return bool(value)
    if isinstance(typ, (T.DoubleType, T.RealType)):
        return float(value)
    if isinstance(typ, (T.VarcharType, T.CharType)):
        return str(value)
    return int(value)


# types whose decoded host elements (Page.to_host: an object array of
# Python ints, floats or bools, None for NULL) already are their values
_PASS_THROUGH = (T.BooleanType, T.TinyintType, T.SmallintType,
                 T.IntegerType, T.BigintType, T.DoubleType, T.RealType)


def column_values(values, typ: T.Type) -> list:
    """One decoded host column as Python values: _to_python applied
    column by column (the per-cell dispatch costs a microsecond a cell,
    which sets the wall of a query returning millions of cells)."""
    if isinstance(typ, _PASS_THROUGH):
        return values.tolist()
    if isinstance(typ, (T.VarcharType, T.CharType)):
        return [None if v is None else str(v) for v in values]
    if isinstance(typ, T.DateType) and len(values):
        null = values == None  # noqa: E711 (elementwise over objects)
        days = np.where(null, 0, values).astype(np.int64)
        if -719162 <= days.min() and days.max() <= 2932896:
            # inside datetime.date's range: numpy builds the same dates
            out = days.astype("datetime64[D]").astype(object)
            out[null] = None
            return out.tolist()
    return [_to_python(v, typ) for v in values]


class LocalQueryRunner:
    def __init__(self, session: Optional[Session] = None, device=None):
        self.device = resolve_device(device)
        self.catalogs = CatalogManager()
        self.metadata = Metadata(self.catalogs)
        self.session = session or Session()
        # one dict per join of the last query, in the order the joins
        # started: kind (inner, left, full, semi, anti, mark, cross), route
        # (dense, search, mxu; cross for a cross join; spill-dense,
        # spill-search and partitioned for a build past
        # join_spill_threshold_bytes), build_rows (live build rows),
        # max_run (the longest run of one build key), probe_rows and
        # output_rows (None for a one-row cross join, which reads no
        # counts); INNER joins also carry matched (== output_rows); the
        # spilled routes also build_bytes (the collected build),
        # device_bytes (held on the device while probing) and host_bytes
        # (spilled to host memory), a partitioned join its recursion depth
        self.last_joins: list = []
        # the last query's counters (the reference's QueryStatsCollector
        # subset the port keeps, exec/local_planner.QUERY_COUNTERS):
        # mxu_joins, the joins routed onto the `mxu` lookup, and
        # mxu_flops, their probe pages' cost-model multiply-adds
        # (ops/join_mxu.lookup_flops); spilled_bytes, the bytes flushed to
        # host spill partitions; agg_recursions and join_recursions (salted
        # repartitions), heavy_key_splits, spill_fallbacks (bounded
        # chunked passes at the maximum depth), agg_mode_downgrades and
        # agg_mode_upgrades (the adaptive partial aggregation's moves)
        self.last_query_stats: dict = dict.fromkeys(QUERY_COUNTERS, 0)
        self._last_windows = WindowLog()
        # one dict per list step of the last query: a collecting
        # aggregation's groups, L (the plane width) and output rows, or an
        # UNNEST page's output slots and input rows
        self.last_lists: list = []

    @property
    def last_windows(self) -> list:
        """One dict per WindowNode of the last query: rows (its input's
        live rows), partitions and peer_groups (live), functions (count per
        kind: ranking, value, aggregate) and frames (count per kind: whole,
        rows, range, bounded). The first read fetches the counts."""
        return self._last_windows.entries()

    @classmethod
    def tpch(cls, schema: str = "tiny", device=None,
             device_gen: Optional[bool] = None) -> "LocalQueryRunner":
        """Runner over the TPC-H and TPC-DS catalogs (TpchQueryRunner;
        `USE tpcds.<schema>` switches to TPC-DS); `device_gen` False
        stages every TPC-H column from NumPy instead of generating it on
        the device (default: TRINO_TPU_DEVICE_GEN, on). TPC-DS is always
        staged from NumPy, as the reference has no device generator for
        it."""
        runner = cls(Session(catalog="tpch", schema=schema), device=device)
        runner.catalogs.register(
            "tpch", tpch.create_connector(runner.device, device_gen))
        runner.catalogs.register("tpcds",
                                 tpcds.create_connector(runner.device))
        return runner

    # ------------------------------------------------------------- execute

    def execute(self, sql: str) -> MaterializedResult:
        stmt = parse_statement(sql)
        if isinstance(stmt, t.Query):
            return self._run_plan(self._plan(stmt))
        if isinstance(stmt, t.Explain):
            return self._explain(stmt)
        if isinstance(stmt, t.ShowTables):
            return self._show_tables(stmt)
        if isinstance(stmt, t.ShowSchemas):
            catalog = stmt.catalog or self.session.catalog
            conn = self.catalogs.get(catalog)
            return MaterializedResult(
                ["Schema"], [T.VARCHAR],
                [(s,) for s in conn.metadata.list_schemas()])
        if isinstance(stmt, t.ShowCatalogs):
            return MaterializedResult(
                ["Catalog"], [T.VARCHAR],
                [(c,) for c in self.catalogs.catalogs()])
        if isinstance(stmt, t.ShowColumns):
            return self._show_columns(stmt)
        if isinstance(stmt, t.SetSession):
            self.session.set(str(stmt.name), _literal_value(stmt.value))
            return MaterializedResult(["result"], [T.BOOLEAN], [(True,)])
        if isinstance(stmt, t.ResetSession):
            self.session.properties.pop(str(stmt.name), None)
            return MaterializedResult(["result"], [T.BOOLEAN], [(True,)])
        if isinstance(stmt, t.Use):
            if stmt.catalog is not None:
                self.session.catalog = stmt.catalog.value
            self.session.schema = stmt.schema.value
            return MaterializedResult(["result"], [T.BOOLEAN], [(True,)])
        raise SemanticError(
            f"unsupported statement: {type(stmt).__name__} "
            "(DDL, DML and prepared statements are ROADMAP A10)")

    def _plan(self, query: t.Statement) -> OutputNode:
        plan = LogicalPlanner(self.metadata, self.session).plan(query)
        return optimize(plan, self.metadata, self.session)

    def _run_plan(self, plan: OutputNode) -> MaterializedResult:
        executor = LocalExecutionPlanner(self.metadata, self.session,
                                         self.device)
        # each join of the last query: route, build live rows, probe rows
        self.last_joins = executor.joins
        self.last_query_stats = executor.stats
        self._last_windows = executor.windows
        self.last_lists = executor.lists
        types = [s.type for s in plan.symbols]
        rows: List[Tuple[Any, ...]] = []
        try:
            stream = executor.execute(plan)
            for page in stream.iter_pages():
                n = int(page.num_rows)
                if n == 0:
                    continue
                rows.extend(zip(*(column_values(c, t) for c, t in
                                  zip(page.to_host(n), types))))
        finally:
            # the query's reservations end with it (a nonzero ledger on a
            # finished query is a leak, counted on the pool)
            leaked = executor.memory.close()
            if leaked:
                NODE_POOL.record_leak(leaked)
        return MaterializedResult(list(plan.column_names), types, rows,
                                  row_count=len(rows))

    def _explain(self, stmt: t.Explain) -> MaterializedResult:
        if not isinstance(stmt.statement, t.Query):
            raise SemanticError("EXPLAIN requires a query")
        if stmt.analyze:
            raise SemanticError("EXPLAIN ANALYZE is ROADMAP A10 "
                                "(observability)")
        plan = self._plan(stmt.statement)
        if stmt.explain_type == "DISTRIBUTED":
            from trino_tpu_torch.planner.optimizer import add_exchanges, \
                OptimizerContext, StatsEstimator
            ctx = OptimizerContext(self.metadata, self.session,
                                   StatsEstimator(self.metadata))
            text = _format_fragments(fragment_plan(add_exchanges(plan, ctx)))
        else:
            text = format_plan(plan)
        return MaterializedResult(["Query Plan"], [T.VARCHAR], [(text,)])

    def _show_tables(self, stmt: t.ShowTables) -> MaterializedResult:
        catalog = self.session.catalog
        schema = self.session.schema
        if stmt.schema is not None:
            parts = stmt.schema.parts
            if len(parts) == 2:
                catalog, schema = parts
            else:
                schema = parts[0]
        conn = self.catalogs.get(catalog)
        tables = [n.table for n in conn.metadata.list_tables(schema)]
        if stmt.like:
            import re
            from trino_tpu_torch.expr.functions import like_pattern_to_regex
            rx = re.compile(like_pattern_to_regex(stmt.like))
            tables = [x for x in tables if rx.match(x)]
        return MaterializedResult(["Table"], [T.VARCHAR],
                                  [(x,) for x in tables])

    def _show_columns(self, stmt: t.ShowColumns) -> MaterializedResult:
        qname = self.metadata.resolve_table_name(stmt.table.parts,
                                                 self.session)
        conn = self.catalogs.get(qname.catalog)
        handle = conn.metadata.get_table_handle(qname.schema_table)
        if handle is None:
            raise SemanticError(f"table not found: {qname}")
        meta = conn.metadata.get_table_metadata(handle)
        return MaterializedResult(
            ["Column", "Type"], [T.VARCHAR, T.VARCHAR],
            [(c.name, c.type.display()) for c in meta.columns])


def _literal_value(e: t.Expression):
    if isinstance(e, (t.StringLiteral, t.LongLiteral, t.BooleanLiteral,
                      t.DoubleLiteral)):
        return e.value
    raise SemanticError("SET SESSION value must be a literal")


def _format_fragments(frag, indent: int = 0) -> str:
    pad = " " * indent
    lines = [f"{pad}Fragment {frag.fragment_id} [{frag.partitioning}]"]
    for line in format_plan(frag.root).splitlines():
        lines.append(pad + "  " + line)
    for child in frag.children:
        lines.append(_format_fragments(child, indent + 2))
    return "\n".join(lines)
