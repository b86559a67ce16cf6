"""Connector SPI: the contract every data source implements.

Reference parity: core/trino-spi/src/main/java/io/trino/spi/connector/
(ConnectorMetadata.java:50, ConnectorSplitManager, ConnectorPageSource.java:24,
ConnectorPageSink, Plugin.java:33). Same shape in Python: metadata resolution,
split generation, page sources yielding host/device columnar Pages, pushdown
negotiation via TupleDomain (applyFilter:907) and limit (applyLimit:888).
"""

from trino_tpu_torch.connector.spi import (  # noqa: F401
    CatalogManager, ColumnHandle, ColumnMetadata, Connector, ConnectorMetadata,
    ConnectorPageSink, ConnectorPageSource, ConnectorSplitManager,
    ConnectorTableHandle, SchemaTableName, Split, TableMetadata,
    TableStatistics, ColumnStatistics)
