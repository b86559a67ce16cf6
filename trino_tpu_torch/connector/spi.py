"""Connector SPI core types.

Reference parity (file:line cites into /root/reference):
- ConnectorMetadata            spi/connector/ConnectorMetadata.java:50
  (applyLimit:888, applyFilter:907 -> apply_filter/apply_limit here)
- ConnectorSplitManager        spi/connector/ConnectorSplitManager.java
- ConnectorPageSource          spi/connector/ConnectorPageSource.java:24
  (getNextPage:59 -> the pages() iterator)
- ConnectorPageSink            spi/connector/ConnectorPageSink.java
- TableStatistics              spi/statistics/TableStatistics.java
- CatalogManager               metadata/CatalogManager.java
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from trino_tpu_torch import types as T
from trino_tpu_torch.page import Page
from trino_tpu_torch.predicate import TupleDomain


@dataclasses.dataclass(frozen=True)
class SchemaTableName:
    schema: str
    table: str

    def __str__(self):
        return f"{self.schema}.{self.table}"


@dataclasses.dataclass(frozen=True)
class ColumnMetadata:
    name: str
    type: T.Type
    hidden: bool = False


@dataclasses.dataclass(frozen=True)
class TableMetadata:
    name: SchemaTableName
    columns: Tuple[ColumnMetadata, ...]
    # CREATE TABLE ... WITH (key = value) properties, evaluated to plain
    # values (the ConnectorTableProperties channel: the lake connector
    # reads partitioned_by/format here; other connectors ignore them)
    properties: Tuple[Tuple[str, object], ...] = ()

    def column_index(self, name: str) -> int:
        for i, c in enumerate(self.columns):
            if c.name == name:
                return i
        raise KeyError(name)


@dataclasses.dataclass(frozen=True)
class ColumnHandle:
    """Opaque per-connector column reference (spi/connector/ColumnHandle)."""

    name: str
    type: T.Type
    ordinal: int


@dataclasses.dataclass(frozen=True)
class ConnectorTableHandle:
    """Table reference + negotiated pushdowns riding through the planner.

    The reference threads pushdown state through connector-specific handle
    types; one generic handle with constraint/limit fields covers the built-in
    connectors here.
    """

    name: SchemaTableName
    constraint: TupleDomain = TupleDomain.all()
    limit: Optional[int] = None
    # Time travel: pinned manifest/snapshot version (`FOR VERSION AS OF`).
    # None = current. Only versioned connectors (the lake) honor it; the
    # planner rejects pins on connectors whose metadata lacks
    # resolve_version support.
    version: Optional[int] = None
    # Delta scan (incremental MV refresh): with `version` = v_to, scan
    # ONLY files added between delta_from and v_to (the manifest-log
    # diff). Never set by SQL — the MV refresher pins it through the
    # planner's scan-pin channel.
    delta_from: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Split:
    """Unit of leaf parallelism (spi/connector/ConnectorSplit).

    `part`/`total_parts` index a row-range partition of the table; `host` is a
    locality hint (mesh coordinate, not hostname, in the TPU build).
    `context` is opaque connector state captured at SPLIT time (the lake
    pins its manifest snapshot here, so every split of one query reads
    ONE committed version even while concurrent writes swap manifests).
    """

    table: ConnectorTableHandle
    part: int
    total_parts: int
    host: Optional[int] = None
    context: Optional[object] = dataclasses.field(default=None,
                                                  compare=False)


@dataclasses.dataclass(frozen=True)
class ColumnStatistics:
    null_fraction: Optional[float] = None
    distinct_count: Optional[float] = None
    min_value: Optional[object] = None
    max_value: Optional[object] = None
    avg_size_bytes: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class TableStatistics:
    row_count: Optional[float] = None
    columns: Dict[str, ColumnStatistics] = dataclasses.field(
        default_factory=dict)

    @staticmethod
    def unknown() -> "TableStatistics":
        return TableStatistics()


class ConnectorMetadata:
    """spi/connector/ConnectorMetadata.java:50."""

    def list_schemas(self) -> List[str]:
        raise NotImplementedError

    def list_tables(self, schema: Optional[str] = None) -> List[SchemaTableName]:
        raise NotImplementedError

    def get_table_handle(self, name: SchemaTableName) -> Optional[ConnectorTableHandle]:
        raise NotImplementedError

    def get_table_metadata(self, handle: ConnectorTableHandle) -> TableMetadata:
        raise NotImplementedError

    def get_column_handles(self, handle: ConnectorTableHandle) -> List[ColumnHandle]:
        meta = self.get_table_metadata(handle)
        return [ColumnHandle(c.name, c.type, i)
                for i, c in enumerate(meta.columns)]

    def apply_filter(self, handle: ConnectorTableHandle,
                     constraint: TupleDomain
                     ) -> Optional[Tuple[ConnectorTableHandle, TupleDomain]]:
        """applyFilter:907 -> (new handle, remaining domain) or None.

        Default: accept the domain as a split-pruning hint but keep the whole
        constraint as 'remaining' so the engine still applies it row-wise.
        """
        return None

    def apply_limit(self, handle: ConnectorTableHandle,
                    limit: int) -> Optional[ConnectorTableHandle]:
        """applyLimit:888 -> new handle or None; limit here is advisory
        (connector may return more rows; engine still enforces)."""
        return None

    def get_table_statistics(self, handle: ConnectorTableHandle) -> TableStatistics:
        return TableStatistics.unknown()

    def estimate_like_selectivity(self, handle: ConnectorTableHandle,
                                  column: str, pattern: str,
                                  escape=None):
        """Fraction of rows matching `column LIKE pattern`, or None when
        unknown (FilterStatsCalculator hook: dictionary-encoded connectors
        can answer exactly from their pools — a LIKE misestimate was the
        round-4 q9 join-order regression)."""
        return None

    # -- writes (spi/connector/ConnectorMetadata beginCreateTable/beginInsert)

    def create_table(self, metadata: TableMetadata, ignore_existing: bool = False):
        raise NotImplementedError("connector does not support CREATE TABLE")

    def drop_table(self, handle: ConnectorTableHandle):
        raise NotImplementedError("connector does not support DROP TABLE")


class ConnectorSplitManager:
    """spi/connector/ConnectorSplitManager.java."""

    def get_splits(self, handle: ConnectorTableHandle,
                   target_splits: int = 1) -> List[Split]:
        raise NotImplementedError


class ConnectorPageSource:
    """spi/connector/ConnectorPageSource.java:24; pages() replaces the
    getNextPage:59 pull loop with a Python iterator of columnar Pages."""

    def pages(self, split: Split, columns: Sequence[ColumnHandle],
              page_capacity: int) -> Iterator[Page]:
        raise NotImplementedError


class WriteTokenLedger:
    """Bounded memory of committed write tokens (the idempotent-sink
    dedup set). A token only needs to outlive its own query's retries,
    so a few thousand most-recent entries is far beyond any live retry
    window — the bound exists so a long-lived serving process under
    sustained write traffic doesn't accrete one token string per write
    forever. Callers hold their own lock."""

    def __init__(self, max_tokens: int = 4096):
        import collections
        self._seen: "collections.OrderedDict" = collections.OrderedDict()
        self.max_tokens = max_tokens

    def commit(self, token) -> bool:
        """True exactly once per token: the first commit wins, replays
        are no-ops."""
        if token in self._seen:
            return False
        self._seen[token] = None
        while len(self._seen) > self.max_tokens:
            self._seen.popitem(last=False)
        return True

    def __contains__(self, token) -> bool:
        return token in self._seen


class ConnectorPageSink:
    """spi/connector/ConnectorPageSink.java — two-phase append target.

    Idempotent-write protocol (the FTE write contract the reference asks
    of connectors before allowing retried writes): a sink created with a
    `write_token` STAGES appended rows under that token and commits them
    atomically in `finish()` — and a token that already committed never
    commits again, so replaying a whole write attempt (QUERY-level
    retry, a fragment re-run after a mid-slice failure) is duplicate-
    free by construction. `abort()` drops the staging of a failed
    attempt. Sinks without a token keep the legacy append-as-you-go
    semantics, and connectors advertise the staged protocol with
    `Connector.idempotent_writes` — the engine only opens retry scopes
    around writes when every target connector declares it."""

    def append_page(self, page: Page):
        raise NotImplementedError

    def finish(self):
        pass

    def abort(self):
        """Drop this attempt's staged rows (failed/abandoned write)."""
        pass


class Connector:
    """One catalog instance (spi/connector/Connector.java)."""

    # True when page_sink() implements the staged write-token protocol
    # (commit-on-finish, token-deduplicated): the engine may then retry
    # write plans — chaos included — without double-write risk
    idempotent_writes = False

    def __init__(self, name: str, metadata: ConnectorMetadata,
                 split_manager: ConnectorSplitManager,
                 page_source: ConnectorPageSource):
        self.name = name
        self.metadata = metadata
        self.split_manager = split_manager
        self.page_source = page_source

    def page_sink(self, handle: ConnectorTableHandle,
                  write_token: Optional[str] = None) -> ConnectorPageSink:
        raise NotImplementedError(
            f"connector {self.name} does not support writes")


class CatalogManager:
    """metadata/CatalogManager.java — catalog name -> Connector registry."""

    def __init__(self):
        self._catalogs: Dict[str, Connector] = {}

    def register(self, catalog: str, connector: Connector):
        self._catalogs[catalog] = connector

    def get(self, catalog: str) -> Connector:
        if catalog not in self._catalogs:
            raise KeyError(f"catalog not found: {catalog}")
        return self._catalogs[catalog]

    def catalogs(self) -> List[str]:
        return sorted(self._catalogs)


def pad_to_capacity(arr, capacity: int, fill):
    """Pad/truncate a host array slice to the page capacity (padding rows sit
    beyond num_rows and are never read)."""
    import numpy as np
    if len(arr) >= capacity:
        return arr[:capacity]
    out = np.full(capacity, fill, dtype=arr.dtype)
    out[:len(arr)] = arr
    return out


def split_range(total_rows: int, part: int, total_parts: int) -> Tuple[int, int]:
    """Row range [start, end) of split `part` of `total_parts` over a table."""
    rows_per = math.ceil(total_rows / total_parts) if total_parts else total_rows
    start = min(part * rows_per, total_rows)
    end = min(start + rows_per, total_rows)
    return start, end
