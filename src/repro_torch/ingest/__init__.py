"""Real profiler ingestion frontend.

Adapters that turn real Nsight Systems / nvprof CUPTI SQLite exports
into the framework's rank DBs and sharded stores — schema sniffing,
bounded rowid-windowed chunked reads (never ``fetchall`` on a large
event table), and ingest-time predicate pushdown compiled from the
declarative :class:`~repro_torch.core.query.Query` form. The synthetic rank
DBs the rest of the package writes are just one more schema the same
adapter reads (``kind == "native"``), so every generation/append path
flows through one front door.
"""

from repro_torch.ingest.cupti_sqlite import (DEFAULT_CHUNK_ROWS, IngestError,
                                             SqliteTraceSource, TraceSchema,
                                             as_trace_source,
                                             rowid_watermark, sniff_schema)

__all__ = [
    "DEFAULT_CHUNK_ROWS", "IngestError", "SqliteTraceSource", "TraceSchema",
    "as_trace_source", "rowid_watermark", "sniff_schema",
]
