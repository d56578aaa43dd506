"""Serving: the batched greedy engine (:mod:`.engine`), the concurrent
query-serving front door (:mod:`.query_service`), the live streaming
ingest plane (:mod:`.stream`) and the v1 HTTP client (:mod:`.client`).
The service reduces each tick's dirty shards and fences its answers on
the card unless its config asks for the host."""

from .client import QueryClient, ServiceError
from .engine import ServeConfig, ServeEngine
from .query_service import (BudgetExceeded, QueryService, ServiceConfig,
                            SummaryCacheLRU)
from .stream import (DEFAULT_FENCE_QUERY, FenceHub, IngestConfig,
                     StreamIngestor)

__all__ = [
    "ServeConfig", "ServeEngine", "QueryClient", "ServiceError",
    "BudgetExceeded", "QueryService", "ServiceConfig", "SummaryCacheLRU",
    "DEFAULT_FENCE_QUERY", "FenceHub", "IngestConfig", "StreamIngestor",
]
