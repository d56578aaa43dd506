"""CUPTI SQLite trace sources: schema sniffing + chunked, pushed-down reads.

Real profiler exports come in (at least) three SQLite dialects:

  * **nvprof** — ``CUPTI_ACTIVITY_KIND_CONCURRENT_KERNEL`` (kernel name
    in an INTEGER ``name`` column referencing ``StringTable (_id_,
    value)``), ``CUPTI_ACTIVITY_KIND_MEMCPY``, ``_RUNTIME`` rows, and a
    ``CUPTI_ACTIVITY_KIND_DEVICE`` inventory.
  * **Nsight Systems** — ``CUPTI_ACTIVITY_KIND_KERNEL`` with
    ``shortName`` / ``demangledName`` referencing ``StringIds (id,
    value)`` and a ``TARGET_INFO_GPU`` inventory.
  * **native** — the synthetic rank DBs this repo writes (an
    Nsight-shaped subset plus the ``memoryStall`` metric column).

:func:`sniff_schema` probes ``sqlite_master`` + ``PRAGMA table_info``
once and resolves a :class:`TraceSchema`: which kernel/memcpy tables to
read, which column carries the kernel-name id, which string-table
spelling to demangle through, where the GPU inventory lives. A
:class:`SqliteTraceSource` then reads any of the three dialects into
the same :class:`~repro_torch.core.events.RankTrace` the synthetic path
produces — through the SAME row-to-array conversion
(:func:`~repro_torch.core.events.kernel_rows_to_table`), so a store built
from a profiler export is bit-identical to one built from equivalent
synthetic DBs.

Memory-boundedness: event tables are read in rowid-windowed chunks
(``WHERE rowid > ? ORDER BY rowid LIMIT chunk``) — at most
``chunk_rows`` rows are ever materialized from SQLite at once, never a
``fetchall`` of a 10GB table. Rowid order is flush order, which for
profiler activity buffers (and the repo's own sorted synthetic writes)
is time order per append batch — the same row order append-mode ingest
produces, so chunked reads keep cold rebuilds bit-identical to
streamed stores.

Predicate pushdown: a :class:`~repro_torch.core.query.Query`'s ``time_window``
and ``kernel_names`` predicates compile into WHERE clauses on the
KERNEL reads (from the query's *canonical* form, so the pushed-down
read and the analysis-time row mask agree on semantics — and the
selective store mints the same cache keys). ``ranks`` is pushed one
level up: the generation driver skips whole non-selected source DBs.
Memcpy reads are never filtered — the join window needs every
transfer in the rank's time range — and ``transfer_kinds`` never
pushes down (it is a property of the joined row, not the raw read).
Skipped rows are provable: sources report ``ingest_rows_read`` /
``ingest_rows_skipped`` through the store's ``io_counts``.
"""

from __future__ import annotations

import dataclasses
import os
import sqlite3
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.events import (EventTable, GpuInfo, RankTrace,
                               kernel_rows_to_table, memcpy_rows_to_table)
from repro_torch.core.query import Query

__all__ = ["DEFAULT_CHUNK_ROWS", "IngestError", "TraceSchema",
           "SqliteTraceSource", "as_trace_source", "sniff_schema",
           "rowid_watermark"]

# Bounded-read window: the most rows one cursor fetch materializes.
DEFAULT_CHUNK_ROWS = 65_536

_NATIVE_KERNEL = "CUPTI_ACTIVITY_KIND_KERNEL"
_NVPROF_KERNEL = "CUPTI_ACTIVITY_KIND_CONCURRENT_KERNEL"
_MEMCPY = "CUPTI_ACTIVITY_KIND_MEMCPY"
_RUNTIME = "CUPTI_ACTIVITY_KIND_RUNTIME"
_TARGET_GPU = "TARGET_INFO_GPU"
_NVPROF_DEVICE = "CUPTI_ACTIVITY_KIND_DEVICE"

# the exact native kernel-table column set (events._KERNEL_COLUMNS) —
# anything else with the Nsight table name is a real Nsight export
_NATIVE_KERNEL_COLS = frozenset([
    "start", "end", "deviceId", "streamId", "correlationId", "gridX",
    "blockX", "registersPerThread", "staticSharedMemory", "shortName",
    "memoryStall"])

_REQUIRED_KERNEL_COLS = ("start", "end", "deviceId", "streamId")
_REQUIRED_MEMCPY_COLS = ("start", "end", "deviceId", "streamId",
                         "bytes", "copyKind")


class IngestError(ValueError):
    """A profiler SQLite export this adapter cannot ingest safely —
    not a SQLite database at all, truncated/corrupt pages, no
    recognizable CUPTI kernel table, or a kernel table missing required
    columns. Always raised loudly instead of ingesting a guess."""


@dataclasses.dataclass(frozen=True)
class TraceSchema:
    """One sniffed export's layout — everything a read needs to know.

    Plain frozen data (no connection), so sources carrying it pickle
    cleanly into process-backend generation workers.
    """

    kind: str                            # "native" | "nvprof" | "nsys"
    kernel_table: str
    name_col: Optional[str]              # kernel-name id column, if any
    stall_col: Optional[str]             # memoryStall metric, if present
    memcpy_table: Optional[str]
    string_table: Optional[str]          # "StringIds" | "StringTable"
    string_id_col: str = "id"
    device_table: Optional[str] = None
    device_sm_col: str = "smCount"       # nvprof: "numMultiprocessors"
    device_name_is_ref: bool = False     # name col is a string-table id
    has_runtime: bool = False


def _tables(conn: sqlite3.Connection) -> set:
    return {r[0] for r in conn.execute(
        "SELECT name FROM sqlite_master WHERE type='table'")}


def _columns(conn: sqlite3.Connection, table: str) -> Dict[str, str]:
    """column name -> declared type (upper), in declaration order."""
    return {r[1]: (r[2] or "").upper()
            for r in conn.execute(f"PRAGMA table_info({table})")}


def sniff_schema(path: str) -> TraceSchema:
    """Probe one SQLite export and resolve its :class:`TraceSchema`.

    Raises :class:`IngestError` for anything unreadable or
    unrecognizable — a malformed file must fail here, before any store
    mutation.
    """
    path = os.fspath(path)
    if not os.path.exists(path):
        raise IngestError(f"trace database {path!r} does not exist")
    conn = sqlite3.connect(path)
    try:
        try:
            tables = _tables(conn)
        except sqlite3.DatabaseError as e:
            raise IngestError(
                f"{path!r} is not a readable SQLite database: {e}"
            ) from None

        candidates = [t for t in (_NVPROF_KERNEL, _NATIVE_KERNEL)
                      if t in tables]
        if not candidates:
            raise IngestError(
                f"{path!r} has no CUPTI kernel activity table "
                f"(looked for {_NVPROF_KERNEL} / {_NATIVE_KERNEL}; "
                f"found tables {sorted(tables)})")
        kernel_table = candidates[0]
        if len(candidates) == 2:
            # nvprof writes both; read whichever actually holds rows
            n = conn.execute(
                f"SELECT COUNT(*) FROM {_NVPROF_KERNEL}").fetchone()[0]
            kernel_table = _NVPROF_KERNEL if int(n or 0) else _NATIVE_KERNEL

        k_cols = _columns(conn, kernel_table)
        missing = [c for c in _REQUIRED_KERNEL_COLS if c not in k_cols]
        if missing:
            raise IngestError(
                f"{path!r}: kernel table {kernel_table} is missing "
                f"required column(s) {missing} — truncated or not a "
                "CUPTI activity export")
        name_col = next((c for c in ("shortName", "demangledName", "name")
                         if c in k_cols), None)
        stall_col = "memoryStall" if "memoryStall" in k_cols else None

        memcpy_table = _MEMCPY if _MEMCPY in tables else None
        if memcpy_table is not None:
            m_cols = _columns(conn, memcpy_table)
            m_missing = [c for c in _REQUIRED_MEMCPY_COLS
                         if c not in m_cols]
            if m_missing:
                raise IngestError(
                    f"{path!r}: memcpy table {memcpy_table} is missing "
                    f"required column(s) {m_missing}")

        string_table, string_id_col = None, "id"
        if "StringIds" in tables and "id" in _columns(conn, "StringIds"):
            string_table, string_id_col = "StringIds", "id"
        elif ("StringTable" in tables
              and "_id_" in _columns(conn, "StringTable")):
            string_table, string_id_col = "StringTable", "_id_"

        device_table, device_sm_col, device_name_is_ref = None, "smCount", \
            False
        if _TARGET_GPU in tables:
            device_table, device_sm_col = _TARGET_GPU, "smCount"
        elif _NVPROF_DEVICE in tables:
            device_table, device_sm_col = _NVPROF_DEVICE, \
                "numMultiprocessors"
        if device_table is not None:
            d_cols = _columns(conn, device_table)
            device_name_is_ref = "INT" in d_cols.get("name", "")

        if kernel_table == _NVPROF_KERNEL or string_table == "StringTable":
            kind = "nvprof"
        elif (set(k_cols) == set(_NATIVE_KERNEL_COLS)
              and device_table == _TARGET_GPU):
            kind = "native"
        else:
            kind = "nsys"
        return TraceSchema(
            kind=kind, kernel_table=kernel_table, name_col=name_col,
            stall_col=stall_col, memcpy_table=memcpy_table,
            string_table=string_table, string_id_col=string_id_col,
            device_table=device_table, device_sm_col=device_sm_col,
            device_name_is_ref=device_name_is_ref,
            has_runtime=_RUNTIME in tables)
    finally:
        conn.close()


@dataclasses.dataclass
class SqliteTraceSource:
    """One profiler SQLite export behind the ``TraceSource`` contract.

    Opens a fresh connection per operation and holds only plain data
    between calls — picklable into process-backend workers, safe to
    probe from the streaming tailer thread. ``chunk_rows`` bounds every
    event-table cursor fetch (see module docstring).
    """

    path: str
    schema: TraceSchema
    chunk_rows: int = DEFAULT_CHUNK_ROWS

    @classmethod
    def open(cls, path: Union[str, os.PathLike],
             chunk_rows: int = DEFAULT_CHUNK_ROWS) -> "SqliteTraceSource":
        path = os.path.abspath(os.fspath(path))
        return cls(path=path, schema=sniff_schema(path),
                   chunk_rows=int(chunk_rows))

    # -- SELECT shapes (column order == read_rank_db == the converters) ----
    def _kernel_select(self) -> str:
        s = self.schema
        name = s.name_col if s.name_col is not None else "0"
        stall = s.stall_col if s.stall_col is not None else "0.0"
        return (f"SELECT rowid, start, end, deviceId, streamId, "
                f"{name}, {stall} FROM {s.kernel_table}")

    def _memcpy_select(self) -> str:
        return (f"SELECT rowid, start, end, deviceId, streamId, bytes, "
                f"copyKind FROM {self.schema.memcpy_table}")

    def _connect(self) -> sqlite3.Connection:
        return sqlite3.connect(self.path)

    def _wrap(self, e: sqlite3.DatabaseError) -> IngestError:
        return IngestError(
            f"failed reading trace database {self.path!r} "
            f"(kind={self.schema.kind}): {e}")

    # -- pushdown compilation ----------------------------------------------
    def pushdown_clauses(self, query: Query) -> Tuple[List[str], List]:
        """KERNEL-read WHERE fragments compiled from ``query``'s
        CANONICAL form (sorted/deduped predicate subsets — the same
        normalization the cache keys hash, so two spellings of one
        query push down identically). Only ``time_window`` and
        ``kernel_names`` compile here; ``ranks`` selects whole source
        DBs in the driver and ``transfer_kinds`` never pushes down."""
        c = query.canonical()
        clauses: List[str] = []
        params: List = []
        if c["time_window"] is not None:
            t0, t1 = c["time_window"]
            clauses.append("start >= ? AND start < ?")
            params += [int(t0), int(t1)]
        kn = c["kernel_names"]
        if kn is not None and self.schema.name_col is not None:
            marks = ",".join("?" * len(kn))
            clauses.append(f"{self.schema.name_col} IN ({marks})")
            params += [int(i) for i in kn]
        return clauses, params

    # -- bounded chunked reads ---------------------------------------------
    def _read_chunked(self, conn, select: str, clauses: List[str],
                      params: List, min_rowid: int,
                      to_table) -> Tuple[EventTable, int]:
        """Page one event table by rowid window; never fetches more than
        ``chunk_rows`` rows at once. Returns (table, rows_read)."""
        limit = max(1, int(self.chunk_rows))
        sql = (select + " WHERE "
               + " AND ".join(clauses + ["rowid > ?"])
               + " ORDER BY rowid LIMIT ?")
        parts: List[EventTable] = []
        n_read, last = 0, int(min_rowid)
        while True:
            rows = conn.execute(sql, params + [last, limit]).fetchall()
            if not rows:
                break
            last = int(rows[-1][0])
            parts.append(to_table([r[1:] for r in rows]))
            n_read += len(rows)
            if len(rows) < limit:
                break
        if not parts:
            return to_table([]), 0
        out = parts[0]
        for p in parts[1:]:
            out = out.concat(p)
        return out, n_read

    @staticmethod
    def _range_clauses(start, end, max_rowid) -> Tuple[List[str], List]:
        clauses: List[str] = []
        params: List = []
        if start is not None:
            clauses.append("start >= ? AND start < ?")
            params += [int(start), int(end)]
        if max_rowid is not None:
            clauses.append("rowid <= ?")
            params.append(int(max_rowid))
        return clauses, params

    # -- the TraceSource contract ------------------------------------------
    def read(self, rank: int,
             start: Optional[int] = None,
             end: Optional[int] = None,
             min_rowids: Optional[Tuple[int, int]] = None,
             max_rowids: Optional[Tuple[int, int]] = None,
             pushdown: Optional[Query] = None,
             count: Optional[Callable[[str, int], None]] = None,
             ) -> RankTrace:
        """Read this export into a :class:`RankTrace` — same range /
        watermark semantics as :func:`repro_torch.core.events.read_rank_db`,
        plus optional predicate pushdown on the kernel read.

        ``count`` receives ``("ingest_rows_read", n)`` for every row
        actually fetched and — when pushdown filtered anything —
        ``("ingest_rows_skipped", n)`` for the rows the un-pushed read
        of the same range would have fetched but this one did not
        (counted SQL-side, never materialized).
        """
        base_k, base_kp = self._range_clauses(
            start, end, None if max_rowids is None else max_rowids[0])
        base_m, base_mp = self._range_clauses(
            start, end, None if max_rowids is None else max_rowids[1])
        min_k = int(min_rowids[0]) if min_rowids is not None else 0
        min_m = int(min_rowids[1]) if min_rowids is not None else 0
        push_k, push_kp = ([], [])
        if pushdown is not None:
            push_k, push_kp = self.pushdown_clauses(pushdown)

        conn = self._connect()
        try:
            kernels, k_read = self._read_chunked(
                conn, self._kernel_select(), base_k + push_k,
                base_kp + push_kp, min_k, kernel_rows_to_table)
            if self.schema.memcpy_table is not None:
                memcpys, m_read = self._read_chunked(
                    conn, self._memcpy_select(), base_m, base_mp, min_m,
                    memcpy_rows_to_table)
            else:
                memcpys, m_read = EventTable.empty(), 0
            skipped = 0
            if push_k:
                where = " AND ".join(base_k + ["rowid > ?"])
                total = conn.execute(
                    f"SELECT COUNT(*) FROM {self.schema.kernel_table} "
                    f"WHERE {where}", base_kp + [min_k]).fetchone()[0]
                skipped = max(0, int(total or 0) - k_read)
            gpus = self._read_gpus(conn)
            names = self._kernel_names(conn)
        except sqlite3.DatabaseError as e:
            raise self._wrap(e) from None
        finally:
            conn.close()
        if count is not None:
            count("ingest_rows_read", k_read + m_read)
            if skipped:
                count("ingest_rows_skipped", skipped)
        return RankTrace(rank=rank, kernels=kernels, memcpys=memcpys,
                         gpus=gpus, names=names)

    def count_range(self, start: Optional[int] = None,
                    end: Optional[int] = None,
                    min_rowids: Optional[Tuple[int, int]] = None,
                    max_rowids: Optional[Tuple[int, int]] = None) -> int:
        """How many kernel + memcpy rows an un-pushed :meth:`read` of
        this range would fetch — SQL-side COUNT, zero rows
        materialized. The driver charges this to ``ingest_rows_skipped``
        when a ``ranks`` pushdown skips the whole source."""
        min_k = int(min_rowids[0]) if min_rowids is not None else 0
        min_m = int(min_rowids[1]) if min_rowids is not None else 0
        total = 0
        conn = self._connect()
        try:
            for table, min_r, max_r in (
                    (self.schema.kernel_table, min_k,
                     None if max_rowids is None else max_rowids[0]),
                    (self.schema.memcpy_table, min_m,
                     None if max_rowids is None else max_rowids[1])):
                if table is None:
                    continue
                clauses, params = self._range_clauses(start, end, max_r)
                where = " AND ".join(clauses + ["rowid > ?"])
                n = conn.execute(
                    f"SELECT COUNT(*) FROM {table} WHERE {where}",
                    params + [min_r]).fetchone()[0]
                total += int(n or 0)
        except sqlite3.DatabaseError as e:
            raise self._wrap(e) from None
        finally:
            conn.close()
        return total

    def time_range(self) -> Tuple[int, int]:
        """UNFILTERED ``MIN(start), MAX(end)`` over the kernel table —
        dataset boundaries. Deliberately ignores any pushdown: the
        shard plan of a selective store must match the full store's, so
        the pushed-down build answers its query bit-identically."""
        conn = self._connect()
        try:
            row = conn.execute(
                f"SELECT MIN(start), MAX(end) FROM "
                f"{self.schema.kernel_table}").fetchone()
        except sqlite3.DatabaseError as e:
            raise self._wrap(e) from None
        finally:
            conn.close()
        if row is None or row[0] is None:
            return (0, 1)
        return int(row[0]), int(row[1])

    def rowid_hi(self) -> Tuple[int, int]:
        """(max kernel rowid, max memcpy rowid) — the append/stream
        watermark, dialect-aware (nvprof's ``_id_`` PRIMARY KEY aliases
        rowid, so profiler appends keep growing it monotonically)."""
        conn = self._connect()
        try:
            k = conn.execute(f"SELECT MAX(rowid) FROM "
                             f"{self.schema.kernel_table}").fetchone()[0]
            m = 0
            if self.schema.memcpy_table is not None:
                m = conn.execute(
                    f"SELECT MAX(rowid) FROM "
                    f"{self.schema.memcpy_table}").fetchone()[0]
        except sqlite3.DatabaseError as e:
            raise self._wrap(e) from None
        finally:
            conn.close()
        return (int(k or 0), int(m or 0))

    def kernel_names(self) -> Dict[int, str]:
        """Kernel-name id -> raw (mangled) name string.

        The whole string table, minus GPU-inventory name refs when the
        device table indexes into the shared table (real nvprof), plus
        a ``kernel_{id}`` fallback for every id the kernel rows
        reference that the string table is missing — name plumbing
        never KeyErrors on a lossy export. Demangling stays a display
        concern (the trace diff's kernel-name normalization); the
        manifest keeps raw strings so fixture ingests stay
        bit-identical to native builds."""
        conn = self._connect()
        try:
            return self._kernel_names(conn)
        except sqlite3.DatabaseError as e:
            raise self._wrap(e) from None
        finally:
            conn.close()

    def _kernel_names(self, conn) -> Dict[int, str]:
        s = self.schema
        names: Dict[int, str] = {}
        if s.string_table is not None:
            names = {int(r[0]): str(r[1]) for r in conn.execute(
                f"SELECT {s.string_id_col}, value FROM {s.string_table}")}
        if s.device_table is not None and s.device_name_is_ref:
            for (nid,) in conn.execute(
                    f"SELECT DISTINCT name FROM {s.device_table}"):
                if nid is not None:
                    names.pop(int(nid), None)
        if s.name_col is not None:
            for (nid,) in conn.execute(
                    f"SELECT DISTINCT {s.name_col} FROM {s.kernel_table}"):
                if nid is not None and int(nid) not in names:
                    names[int(nid)] = f"kernel_{int(nid)}"
        return names

    def _read_gpus(self, conn) -> List[GpuInfo]:
        s = self.schema
        if s.device_table is None:
            return []
        cols = _columns(conn, s.device_table)

        def sel(name, default):
            return name if name in cols else str(default)

        empty_str = "''"
        rows = conn.execute(
            f"SELECT {sel('id', 0)}, {sel('name', empty_str)}, "
            f"{sel('globalMemoryBandwidth', 0)}, "
            f"{sel('globalMemorySize', 0)}, {sel(s.device_sm_col, 0)}, "
            f"{sel('computeCapabilityMajor', 8)}, "
            f"{sel('computeCapabilityMinor', 0)} "
            f"FROM {s.device_table}").fetchall()
        strings: Dict[int, str] = {}
        if s.device_name_is_ref and s.string_table is not None:
            strings = {int(r[0]): str(r[1]) for r in conn.execute(
                f"SELECT {s.string_id_col}, value FROM {s.string_table}")}

        def gpu_name(v):
            if s.device_name_is_ref:
                return strings.get(int(v or 0), f"gpu_{int(v or 0)}")
            return str(v)

        return [GpuInfo(id=int(r[0] or 0), name=gpu_name(r[1]),
                        bandwidth=int(r[2] or 0), memory=int(r[3] or 0),
                        sm_count=int(r[4] or 0), cc_major=int(r[5] or 8),
                        cc_minor=int(r[6] or 0)) for r in rows]


def as_trace_source(source, chunk_rows: Optional[int] = None,
                    ) -> SqliteTraceSource:
    """Resolve a path-or-source to a :class:`SqliteTraceSource`.

    The ``TraceSource`` seam every generation/append/stream entry point
    funnels through: plain paths (synthetic rank DBs AND real profiler
    exports — the sniffer decides) and pre-built sources (custom
    ``chunk_rows``, tests) are interchangeable. Passing an explicit
    source preserves its chunking; ``chunk_rows`` only applies when a
    path is being opened."""
    if isinstance(source, SqliteTraceSource):
        return source
    return SqliteTraceSource.open(
        source, chunk_rows=(DEFAULT_CHUNK_ROWS if chunk_rows is None
                            else int(chunk_rows)))


# abspath -> sniffed schema; layouts are immutable for a live export
# (profilers append rows, they do not migrate tables), so one sniff per
# path amortizes across the streaming tailer's O(attached) polls
_SCHEMA_CACHE: Dict[str, TraceSchema] = {}


def rowid_watermark(path: Union[str, os.PathLike]) -> Tuple[int, int]:
    """Dialect-aware ``(kernel_rowid, memcpy_rowid)`` high-water probe —
    the streaming tailer's per-poll primitive. Sniffs each path once
    and caches the schema (cache entries only land on a successful
    sniff, so a not-yet-created export is re-probed next poll)."""
    ap = os.path.abspath(os.fspath(path))
    schema = _SCHEMA_CACHE.get(ap)
    if schema is None:
        schema = sniff_schema(ap)
        _SCHEMA_CACHE[ap] = schema
    return SqliteTraceSource(path=ap, schema=schema).rowid_hi()
