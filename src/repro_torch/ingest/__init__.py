"""Real profiler ingestion frontend.

Adapters that turn real Nsight Systems / nvprof CUPTI SQLite exports
into the framework's rank DBs and sharded stores — schema sniffing,
bounded rowid-windowed chunked reads (never ``fetchall`` on a large
event table), and ingest-time predicate pushdown compiled from the
declarative :class:`~repro_torch.core.query.Query` form. The synthetic rank
DBs the rest of the package writes are just one more schema the same
adapter reads (``kind == "native"``), so every generation/append/stream
path flows through one front door.

:mod:`repro_torch.ingest.fixture` writes bit-faithful nvprof- and
Nsight-schema SQLite fixtures from synthetic datasets: ingesting one
must build a store bit-identical to the direct synthetic build.
"""

from repro_torch.ingest.cupti_sqlite import (DEFAULT_CHUNK_ROWS, IngestError,
                                             SqliteTraceSource, TraceSchema,
                                             as_trace_source,
                                             rowid_watermark, sniff_schema)
from repro_torch.ingest.fixture import (append_fixture_rank_db,
                                        write_fixture_dbs,
                                        write_nsys_rank_db,
                                        write_nvprof_rank_db)

__all__ = [
    "DEFAULT_CHUNK_ROWS", "IngestError", "SqliteTraceSource", "TraceSchema",
    "as_trace_source", "rowid_watermark", "sniff_schema",
    "append_fixture_rank_db", "write_fixture_dbs", "write_nsys_rank_db",
    "write_nvprof_rank_db",
]
