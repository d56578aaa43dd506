"""CUPTI-shaped trace event model.

The paper ingests NVIDIA Nsight profiler output stored as SQLite databases,
one per *profiling rank*, with (at least) three tables:

  - ``CUPTI_ACTIVITY_KIND_KERNEL``  : kernel launches (timestamps, device,
    stream, resource usage, stall metrics)
  - ``CUPTI_ACTIVITY_KIND_MEMCPY``  : memory transfers (timestamps, bytes,
    copyKind H2D/D2H/D2D/P2P, device, stream)
  - ``TARGET_INFO_GPU``             : static GPU properties

We reproduce that schema faithfully (real SQLite files via :mod:`sqlite3`),
plus a struct-of-arrays in-memory representation (`EventTable`) that the
vectorised/JAX/Pallas layers consume, plus a synthetic workload generator
that writes valid databases with *injected ground-truth anomalies* so the
pipeline's detections are testable.

Timestamps are int64 nanoseconds, as in CUPTI.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sqlite3
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# --- CUPTI memcpy copyKind codes (subset; matches CUpti_ActivityMemcpyKind).
COPY_UNKNOWN = 0
COPY_H2D = 1
COPY_D2H = 2
COPY_H2A = 3
COPY_A2H = 4
COPY_D2D = 8
COPY_P2P = 10

COPY_KIND_NAMES = {
    COPY_UNKNOWN: "UNKNOWN",
    COPY_H2D: "HtoD",
    COPY_D2H: "DtoH",
    COPY_H2A: "HtoA",
    COPY_A2H: "AtoH",
    COPY_D2D: "DtoD",
    COPY_P2P: "PtoP",
}

KERNEL_TABLE = "CUPTI_ACTIVITY_KIND_KERNEL"
MEMCPY_TABLE = "CUPTI_ACTIVITY_KIND_MEMCPY"
GPU_TABLE = "TARGET_INFO_GPU"
STRING_TABLE = "StringIds"   # Nsight's id -> kernel-name string table

_KERNEL_COLUMNS = [
    ("start", "INTEGER"),          # ns
    ("end", "INTEGER"),            # ns
    ("deviceId", "INTEGER"),
    ("streamId", "INTEGER"),
    ("correlationId", "INTEGER"),
    ("gridX", "INTEGER"),
    ("blockX", "INTEGER"),
    ("registersPerThread", "INTEGER"),
    ("staticSharedMemory", "INTEGER"),
    ("shortName", "INTEGER"),      # name id
    ("memoryStall", "REAL"),       # ns the kernel was stalled on memory
]

_MEMCPY_COLUMNS = [
    ("start", "INTEGER"),
    ("end", "INTEGER"),
    ("deviceId", "INTEGER"),
    ("streamId", "INTEGER"),
    ("correlationId", "INTEGER"),
    ("bytes", "INTEGER"),
    ("copyKind", "INTEGER"),
]

_GPU_COLUMNS = [
    ("id", "INTEGER"),
    ("name", "TEXT"),
    ("globalMemoryBandwidth", "INTEGER"),  # bytes/s
    ("globalMemorySize", "INTEGER"),
    ("smCount", "INTEGER"),
    ("computeCapabilityMajor", "INTEGER"),
    ("computeCapabilityMinor", "INTEGER"),
]


@dataclasses.dataclass
class EventTable:
    """Struct-of-arrays view of one table (kernel or memcpy events)."""

    start: np.ndarray            # int64 ns
    end: np.ndarray              # int64 ns
    device: np.ndarray           # int32
    stream: np.ndarray           # int32
    # kernel-only fields are zero for memcpy rows and vice versa
    memory_stall: np.ndarray     # float32 ns (kernels)
    bytes: np.ndarray            # int64 (memcpys)
    copy_kind: np.ndarray        # int32 (memcpys)
    name_id: np.ndarray          # int32 (kernels)
    kind: np.ndarray             # int32: 0 kernel, 1 memcpy

    def __len__(self) -> int:
        return int(self.start.shape[0])

    @property
    def duration(self) -> np.ndarray:
        return (self.end - self.start).astype(np.float64)

    def sort_by_start(self) -> "EventTable":
        order = np.argsort(self.start, kind="stable")
        return self.take(order)

    def take(self, idx: np.ndarray) -> "EventTable":
        return EventTable(**{
            f.name: getattr(self, f.name)[idx]
            for f in dataclasses.fields(self)
        })

    def select(self, mask: np.ndarray) -> "EventTable":
        return self.take(np.nonzero(mask)[0])

    def concat(self, other: "EventTable") -> "EventTable":
        return EventTable(**{
            f.name: np.concatenate([getattr(self, f.name),
                                    getattr(other, f.name)])
            for f in dataclasses.fields(self)
        })

    def to_columns(self) -> Dict[str, np.ndarray]:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    @staticmethod
    def from_columns(cols: Dict[str, np.ndarray]) -> "EventTable":
        return EventTable(**{f.name: np.asarray(cols[f.name])
                             for f in dataclasses.fields(EventTable)})

    @staticmethod
    def empty() -> "EventTable":
        z64 = np.zeros((0,), np.int64)
        z32 = np.zeros((0,), np.int32)
        return EventTable(start=z64, end=z64.copy(),
                          device=z32, stream=z32.copy(),
                          memory_stall=np.zeros((0,), np.float32),
                          bytes=z64.copy(), copy_kind=z32.copy(),
                          name_id=z32.copy(), kind=z32.copy())


@dataclasses.dataclass
class GpuInfo:
    id: int
    name: str
    bandwidth: int        # bytes/s
    memory: int           # bytes
    sm_count: int
    cc_major: int = 8
    cc_minor: int = 0


@dataclasses.dataclass
class RankTrace:
    """One profiling rank's trace: kernels + memcpys + GPU inventory.

    ``names`` maps kernel ``name_id`` -> demangle-worthy kernel name
    string (the ``StringIds`` table ``shortName`` references in Nsight
    exports). Empty for traces read from DBs that predate the table.
    """

    rank: int
    kernels: EventTable
    memcpys: EventTable
    gpus: List[GpuInfo]
    names: Dict[int, str] = dataclasses.field(default_factory=dict)

    def time_range(self) -> Tuple[int, int]:
        """Dataset boundaries, defined by *kernel* timestamps (per paper)."""
        if len(self.kernels) == 0:
            return (0, 1)
        return (int(self.kernels.start.min()), int(self.kernels.end.max()))


# ---------------------------------------------------------------------------
# SQLite I/O (faithful to the paper's storage format)
# ---------------------------------------------------------------------------

def _create_schema(conn: sqlite3.Connection) -> None:
    k_cols = ", ".join(f"{n} {t}" for n, t in _KERNEL_COLUMNS)
    m_cols = ", ".join(f"{n} {t}" for n, t in _MEMCPY_COLUMNS)
    g_cols = ", ".join(f"{n} {t}" for n, t in _GPU_COLUMNS)
    conn.execute(f"CREATE TABLE IF NOT EXISTS {KERNEL_TABLE} ({k_cols})")
    conn.execute(f"CREATE TABLE IF NOT EXISTS {MEMCPY_TABLE} ({m_cols})")
    conn.execute(f"CREATE TABLE IF NOT EXISTS {GPU_TABLE} ({g_cols})")
    conn.execute(f"CREATE TABLE IF NOT EXISTS {STRING_TABLE} "
                 "(id INTEGER PRIMARY KEY, value TEXT)")
    conn.execute(
        f"CREATE INDEX IF NOT EXISTS idx_kernel_start ON {KERNEL_TABLE}(start)")
    conn.execute(
        f"CREATE INDEX IF NOT EXISTS idx_memcpy_start ON {MEMCPY_TABLE}(start)")


def _insert_events(conn: sqlite3.Connection, trace: RankTrace) -> None:
    """INSERT one trace's kernel + memcpy rows (shared by fresh writes
    and append mode; rowids keep growing monotonically on append)."""
    k = trace.kernels
    rows = zip(k.start.tolist(), k.end.tolist(), k.device.tolist(),
               k.stream.tolist(), range(len(k)),
               np.ones(len(k), np.int64).tolist(),
               np.full(len(k), 128, np.int64).tolist(),
               np.full(len(k), 32, np.int64).tolist(),
               np.zeros(len(k), np.int64).tolist(),
               k.name_id.tolist(), k.memory_stall.tolist())
    conn.executemany(
        f"INSERT INTO {KERNEL_TABLE} VALUES (?,?,?,?,?,?,?,?,?,?,?)", rows)
    m = trace.memcpys
    rows = zip(m.start.tolist(), m.end.tolist(), m.device.tolist(),
               m.stream.tolist(), range(len(m)),
               m.bytes.tolist(), m.copy_kind.tolist())
    conn.executemany(
        f"INSERT INTO {MEMCPY_TABLE} VALUES (?,?,?,?,?,?,?)", rows)


def _insert_names(conn: sqlite3.Connection, names: Dict[int, str]) -> None:
    if not names:
        return
    conn.execute(f"CREATE TABLE IF NOT EXISTS {STRING_TABLE} "
                 "(id INTEGER PRIMARY KEY, value TEXT)")
    conn.executemany(
        f"INSERT OR REPLACE INTO {STRING_TABLE} VALUES (?,?)",
        [(int(i), str(n)) for i, n in sorted(names.items())])


def write_rank_db(path: str, trace: RankTrace) -> None:
    """Write one profiling rank's trace as an Nsight-shaped SQLite DB."""
    if os.path.exists(path):
        os.remove(path)
    conn = sqlite3.connect(path)
    try:
        _create_schema(conn)
        _insert_events(conn, trace)
        conn.executemany(
            f"INSERT INTO {GPU_TABLE} VALUES (?,?,?,?,?,?,?)",
            [(g.id, g.name, g.bandwidth, g.memory, g.sm_count,
              g.cc_major, g.cc_minor) for g in trace.gpus])
        _insert_names(conn, trace.names)
        conn.commit()
    finally:
        conn.close()


def append_rank_db(path: str, trace: RankTrace) -> None:
    """Append ``trace``'s kernel/memcpy rows to an EXISTING rank DB —
    the profiler growth model (the GPU inventory is static and left
    alone). Appended rows get fresh, larger rowids, which is what the
    append-mode ingest watermark keys on. The string table is upserted:
    a growing run can introduce new kernel name ids."""
    conn = sqlite3.connect(path)
    try:
        _insert_events(conn, trace)
        _insert_names(conn, trace.names)
        conn.commit()
    finally:
        conn.close()


def _read_query(conn: sqlite3.Connection, query: str,
                params: Sequence = ()) -> List[tuple]:
    cur = conn.execute(query, params)
    return cur.fetchall()


def kernel_rows_to_table(rows: Sequence[tuple]) -> EventTable:
    """Convert kernel rows ``(start, end, deviceId, streamId, name_id,
    memory_stall)`` to an :class:`EventTable` — THE conversion every
    reader shares (``read_rank_db`` and the profiler-ingest adapter), so
    a store built through either path is bit-identical: one float64
    matrix pass, then per-column casts. Converting chunk-by-chunk and
    concatenating yields the same bits (casts are elementwise)."""
    if not len(rows):
        return EventTable.empty()
    a = np.asarray(rows, dtype=np.float64)
    n = a.shape[0]
    return EventTable(
        start=a[:, 0].astype(np.int64), end=a[:, 1].astype(np.int64),
        device=a[:, 2].astype(np.int32), stream=a[:, 3].astype(np.int32),
        memory_stall=a[:, 5].astype(np.float32),
        bytes=np.zeros(n, np.int64), copy_kind=np.zeros(n, np.int32),
        name_id=a[:, 4].astype(np.int32), kind=np.zeros(n, np.int32))


def memcpy_rows_to_table(rows: Sequence[tuple]) -> EventTable:
    """Convert memcpy rows ``(start, end, deviceId, streamId, bytes,
    copyKind)`` to an :class:`EventTable` (see
    :func:`kernel_rows_to_table` for the bit-identity contract)."""
    if not len(rows):
        return EventTable.empty()
    a = np.asarray(rows, dtype=np.float64)
    n = a.shape[0]
    return EventTable(
        start=a[:, 0].astype(np.int64), end=a[:, 1].astype(np.int64),
        device=a[:, 2].astype(np.int32), stream=a[:, 3].astype(np.int32),
        memory_stall=np.zeros(n, np.float32),
        bytes=a[:, 4].astype(np.int64),
        copy_kind=a[:, 5].astype(np.int32),
        name_id=np.zeros(n, np.int32), kind=np.ones(n, np.int32))


def read_rank_db(path: str, rank: int,
                 start: Optional[int] = None,
                 end: Optional[int] = None,
                 min_rowids: Optional[Tuple[int, int]] = None,
                 max_rowids: Optional[Tuple[int, int]] = None) -> RankTrace:
    """Read a rank DB, optionally restricted to a [start, end) time range
    and/or to rows APPENDED after a previous ingest.

    The range restriction is executed as an indexed SQL range query — this
    is the paper's per-shard extraction primitive. ``min_rowids`` /
    ``max_rowids`` are append-mode watermarks: ``(kernel_rowid,
    memcpy_rowid)`` high-water marks from :func:`table_rowid_hi`; only
    rows with ``min < rowid <= max`` are returned. Profilers append rows,
    so this selects exactly the events added between the two watermarks —
    regardless of their timestamps (late flushes below the covered time
    range included), with no duplicates. The upper bound matters on a
    LIVE db: it pins the read to the watermark the caller is about to
    record, so rows appended mid-read are left for the next ingest
    instead of being skipped forever.
    """
    conn = sqlite3.connect(path)
    try:
        clauses, params = [], []
        if start is not None:
            clauses.append("start >= ? AND start < ?")
            params += [int(start), int(end)]
        k_clauses, m_clauses = list(clauses), list(clauses)
        k_params, m_params = list(params), list(params)
        if min_rowids is not None:
            k_clauses.append("rowid > ?")
            k_params.append(int(min_rowids[0]))
            m_clauses.append("rowid > ?")
            m_params.append(int(min_rowids[1]))
        if max_rowids is not None:
            k_clauses.append("rowid <= ?")
            k_params.append(int(max_rowids[0]))
            m_clauses.append("rowid <= ?")
            m_params.append(int(max_rowids[1]))

        def _where(cl):
            return (" WHERE " + " AND ".join(cl)) if cl else ""

        k_rows = _read_query(
            conn,
            f"SELECT start, end, deviceId, streamId, shortName, memoryStall"
            f" FROM {KERNEL_TABLE}{_where(k_clauses)}", k_params)
        m_rows = _read_query(
            conn,
            f"SELECT start, end, deviceId, streamId, bytes, copyKind"
            f" FROM {MEMCPY_TABLE}{_where(m_clauses)}", m_params)
        g_rows = _read_query(
            conn,
            f"SELECT id, name, globalMemoryBandwidth, globalMemorySize,"
            f" smCount, computeCapabilityMajor, computeCapabilityMinor"
            f" FROM {GPU_TABLE}")
        try:
            s_rows = _read_query(conn,
                                 f"SELECT id, value FROM {STRING_TABLE}")
        except sqlite3.OperationalError:
            s_rows = []          # pre-string-table DB: ids stay numeric
    finally:
        conn.close()

    gpus = [GpuInfo(id=int(r[0]), name=str(r[1]), bandwidth=int(r[2]),
                    memory=int(r[3]), sm_count=int(r[4]),
                    cc_major=int(r[5]), cc_minor=int(r[6])) for r in g_rows]
    return RankTrace(rank=rank, kernels=kernel_rows_to_table(k_rows),
                     memcpys=memcpy_rows_to_table(m_rows), gpus=gpus,
                     names={int(r[0]): str(r[1]) for r in s_rows})


def read_kernel_names(path: str) -> Dict[int, str]:
    """The kernel-name string table of one rank DB, tolerating both
    profiler spellings: Nsight Systems' ``StringIds (id, value)`` (also
    the native synthetic schema) and nvprof's ``StringTable (_id_,
    value)``. ``{}`` when the DB predates both tables (older stores keep
    working, with numeric fallback names downstream)."""
    conn = sqlite3.connect(path)
    try:
        for table, id_col in ((STRING_TABLE, "id"),
                              ("StringTable", "_id_")):
            try:
                rows = _read_query(
                    conn, f"SELECT {id_col}, value FROM {table}")
            except sqlite3.OperationalError:
                continue
            return {int(r[0]): str(r[1]) for r in rows}
    finally:
        conn.close()
    return {}


def table_rowid_hi(path: str) -> Tuple[int, int]:
    """(max kernel rowid, max memcpy rowid) — the append-mode ingest
    watermark. sqlite assigns monotonically increasing rowids to appended
    rows, so everything a profiler adds later satisfies ``rowid > hi``."""
    conn = sqlite3.connect(path)
    try:
        k = conn.execute(
            f"SELECT MAX(rowid) FROM {KERNEL_TABLE}").fetchone()[0]
        m = conn.execute(
            f"SELECT MAX(rowid) FROM {MEMCPY_TABLE}").fetchone()[0]
    finally:
        conn.close()
    return (int(k or 0), int(m or 0))


def kernel_time_range_db(path: str) -> Tuple[int, int]:
    """MIN(start), MAX(end) over the kernel table — dataset boundaries."""
    conn = sqlite3.connect(path)
    try:
        row = conn.execute(
            f"SELECT MIN(start), MAX(end) FROM {KERNEL_TABLE}").fetchone()
    finally:
        conn.close()
    if row is None or row[0] is None:
        return (0, 1)
    return int(row[0]), int(row[1])


# ---------------------------------------------------------------------------
# Synthetic workload generator (ground-truth anomalies injected)
# ---------------------------------------------------------------------------

_KERNEL_FAMILIES = [
    "gemm", "flash_attention_fwd", "flash_attention_bwd", "layer_norm",
    "softmax", "reduce_sum", "elementwise_add", "dropout",
    "embedding_lookup", "conv2d_winograd", "transpose_tiled",
    "all_reduce_ring", "rms_norm", "rotary_embedding", "cross_entropy",
    "adamw_step", "scatter_add", "gather_nd", "topk_select",
    "histogram_bincount", "im2col",
]


def synthetic_kernel_names(n_names: int = 64,
                           variant: int = 0) -> Dict[int, str]:
    """Deterministic, realistic kernel names for synthetic ``name_id``s.

    Spelling styles cycle across ids: Itanium-mangled template
    instantiations, Triton-style names with arg-specialization + hash
    suffixes, plain SASS-style names, and demangled C++ templates.
    ``variant`` perturbs only the *specialization* parts (template
    arguments, Triton suffixes) while keeping the base kernel identity —
    two stores generated with different variants exercise the fuzzy
    cross-store matcher end to end (the plain style is variant-invariant
    and covers the exact-match fast path).
    """
    names: Dict[int, str] = {}
    for i in range(n_names):
        fam = _KERNEL_FAMILIES[i % len(_KERNEL_FAMILIES)]
        style = (i // len(_KERNEL_FAMILIES)) % 4
        if style == 0:
            width = 128 << (variant % 3)
            base = f"{fam}_kernel"
            names[i] = f"_Z{len(base)}{base}ILi{width}ELi4EfEvPfPKfS1_i"
        elif style == 1:
            h = (0x9E3779B9 * (i + 1) + 0x85EBCA6B * (variant + 1))
            names[i] = (f"triton_{fam}_kernel_0d1d2d3de4de"
                        f"_{h & 0xFFFFFFFF:08x}")
        elif style == 2:
            names[i] = f"sm80_xmma_{fam}_f16f16_f32_128x128_nn"
        else:
            width = 256 << (variant % 2)
            names[i] = (f"void {fam}_kernel<float, {width}>"
                        "(float*, float const*, int)")
    return names


@dataclasses.dataclass
class SyntheticSpec:
    """Knobs for a Table-1-shaped synthetic dataset."""

    n_ranks: int = 4
    kernels_per_rank: int = 20_000
    memcpys_per_rank: int = 2_500        # paper ratio ~ 842054 : 107045
    n_gpus: int = 4
    n_streams: int = 8
    duration_s: float = 120.0
    # Injected anomalies: windows where memory stalls spike across ranks
    # (Fig 1a) and H2D/D2H ping-pong bursts dominate (Fig 1b).
    n_anomaly_windows: int = 3
    anomaly_width_s: float = 2.0
    anomaly_stall_scale: float = 12.0
    pingpong_fraction: float = 0.75
    seed: int = 0
    # kernel-name spelling variant (see :func:`synthetic_kernel_names`):
    # same base kernels, different mangling/specialization suffixes —
    # what two builds of the same application look like to a profiler
    name_variant: int = 0


@dataclasses.dataclass
class SyntheticDataset:
    traces: List[RankTrace]
    anomaly_windows: np.ndarray   # (n_windows, 2) int64 ns, ground truth
    spec: SyntheticSpec


def generate_synthetic(spec: SyntheticSpec) -> SyntheticDataset:
    rng = np.random.default_rng(spec.seed)
    t0 = 1_700_000_000_000_000_000  # epoch-ish ns origin
    dur = int(spec.duration_s * 1e9)

    # Ground-truth anomaly windows, shared across ranks ("co-occurring
    # sustained memory stalls across multiple ranks", §4).
    centers = rng.uniform(0.15, 0.85, size=spec.n_anomaly_windows) * dur
    half = int(spec.anomaly_width_s * 1e9 / 2)
    windows = np.stack([centers.astype(np.int64) - half,
                        centers.astype(np.int64) + half], axis=1) + t0
    windows = windows[np.argsort(windows[:, 0])]
    names = synthetic_kernel_names(64, variant=spec.name_variant)

    traces = []
    for rank in range(spec.n_ranks):
        nk = spec.kernels_per_rank
        # Kernel launches: Poisson-ish arrivals over the run.
        starts = np.sort(rng.uniform(0, dur, size=nk)).astype(np.int64) + t0
        base_dur = rng.lognormal(mean=10.5, sigma=0.6, size=nk)  # ~36 µs
        durations = base_dur.astype(np.int64) + 1_000
        device = rng.integers(0, spec.n_gpus, size=nk).astype(np.int32)
        stream = rng.integers(0, spec.n_streams, size=nk).astype(np.int32)
        name_id = rng.integers(0, 64, size=nk).astype(np.int32)

        # Memory-stall metric: baseline ~8% of duration, spiking inside
        # anomaly windows (bandwidth contention), with rank-correlated noise.
        stall = 0.08 * durations * rng.uniform(0.5, 1.5, size=nk)
        in_window = np.zeros(nk, dtype=bool)
        for w0, w1 in windows:
            in_window |= (starts >= w0) & (starts < w1)
        stall[in_window] *= spec.anomaly_stall_scale * rng.uniform(
            0.8, 1.3, size=int(in_window.sum()))
        kernels = EventTable(
            start=starts, end=starts + durations,
            device=device, stream=stream,
            memory_stall=stall.astype(np.float32),
            bytes=np.zeros(nk, np.int64),
            copy_kind=np.zeros(nk, np.int32),
            name_id=name_id, kind=np.zeros(nk, np.int32))

        nm = spec.memcpys_per_rank
        m_starts = np.sort(rng.uniform(0, dur, size=nm)).astype(np.int64) + t0
        m_bytes = (2 ** rng.integers(10, 24, size=nm)).astype(np.int64)
        m_dur = (m_bytes / 12e9 * 1e9).astype(np.int64) + 2_000  # ~12 GB/s eff
        # Direction mix: ping-pong (H2D/D2H alternating) dominates, D2D sparse
        # — exactly the Fig-1b finding the pipeline must recover.
        kinds = np.where(
            rng.random(nm) < spec.pingpong_fraction,
            np.where(np.arange(nm) % 2 == 0, COPY_H2D, COPY_D2H),
            np.where(rng.random(nm) < 0.85, COPY_H2D, COPY_D2D),
        ).astype(np.int32)
        # Ping-pong bursts concentrate inside anomaly windows.
        for w0, w1 in windows:
            burst = int(0.05 * nm)
            bs = rng.uniform(w0, w1, size=burst).astype(np.int64)
            b_bytes = (2 ** rng.integers(12, 18, size=burst)).astype(np.int64)
            b_dur = (b_bytes / 6e9 * 1e9).astype(np.int64) + 2_000
            b_kind = np.where(np.arange(burst) % 2 == 0,
                              COPY_H2D, COPY_D2H).astype(np.int32)
            m_starts = np.concatenate([m_starts, bs])
            m_bytes = np.concatenate([m_bytes, b_bytes])
            m_dur = np.concatenate([m_dur, b_dur])
            kinds = np.concatenate([kinds, b_kind])
        nm_t = m_starts.shape[0]
        memcpys = EventTable(
            start=m_starts, end=m_starts + m_dur,
            device=rng.integers(0, spec.n_gpus, size=nm_t).astype(np.int32),
            stream=rng.integers(0, spec.n_streams, size=nm_t).astype(np.int32),
            memory_stall=np.zeros(nm_t, np.float32),
            bytes=m_bytes, copy_kind=kinds,
            name_id=np.zeros(nm_t, np.int32),
            kind=np.ones(nm_t, np.int32)).sort_by_start()

        gpus = [GpuInfo(id=g, name="NVIDIA A100-SXM4-40GB",
                        bandwidth=1_555_000_000_000,
                        memory=40 * 2**30, sm_count=108)
                for g in range(spec.n_gpus)]
        traces.append(RankTrace(rank=rank, kernels=kernels,
                                memcpys=memcpys, gpus=gpus, names=names))
    return SyntheticDataset(traces=traces, anomaly_windows=windows, spec=spec)


def inject_slowdown(ds: SyntheticDataset, factor: float,
                    name_ids: Sequence[int]) -> SyntheticDataset:
    """Ground-truth regression injector for the diff engine: scale the
    duration and memory stall of every kernel whose ``name_id`` is in
    ``name_ids`` by ``factor`` (other kernels untouched). A dataset pair
    (clean, injected) is what the ``trace-regression`` CI workflow and
    the diff tests/benchmarks compare."""
    ids = np.asarray(sorted(set(int(i) for i in name_ids)), np.int32)
    traces = []
    for tr in ds.traces:
        k = tr.kernels
        hit = np.isin(k.name_id, ids)
        dur = (k.end - k.start).astype(np.float64)
        new_end = np.where(hit, k.start + (dur * factor).astype(np.int64),
                           k.end)
        new_stall = np.where(hit, k.memory_stall * factor, k.memory_stall)
        traces.append(RankTrace(
            rank=tr.rank,
            kernels=dataclasses.replace(
                k, end=new_end.astype(np.int64),
                memory_stall=new_stall.astype(np.float32)),
            memcpys=tr.memcpys, gpus=tr.gpus, names=tr.names))
    return SyntheticDataset(traces=traces,
                            anomaly_windows=ds.anomaly_windows,
                            spec=ds.spec)


def truncate_trace(trace: RankTrace, t_cutoff: int) -> RankTrace:
    """Events fully contained before ``t_cutoff`` — an earlier snapshot of
    a growing profiler DB. Used by the append-mode tests/benches: write
    the truncated traces, build the store, ``append_rank_db`` the
    :func:`trace_remainder` onto the same DB paths, then ``run_append``
    ingests only the delta. Events spanning the cutoff stay in the
    remainder (not split), so the snapshot's kernel time range never
    leaks past ``t_cutoff``."""
    return RankTrace(
        rank=trace.rank,
        kernels=trace.kernels.select(trace.kernels.end <= t_cutoff),
        memcpys=trace.memcpys.select(trace.memcpys.end <= t_cutoff),
        gpus=trace.gpus, names=trace.names)


def trace_remainder(trace: RankTrace, t_cutoff: int) -> RankTrace:
    """Complement of :func:`truncate_trace`: the events a growing
    profiler run flushes AFTER the ``t_cutoff`` snapshot (events spanning
    the cutoff included — they flush once they end)."""
    return RankTrace(
        rank=trace.rank,
        kernels=trace.kernels.select(trace.kernels.end > t_cutoff),
        memcpys=trace.memcpys.select(trace.memcpys.end > t_cutoff),
        gpus=trace.gpus, names=trace.names)


def write_synthetic_dbs(ds: SyntheticDataset, out_dir: str) -> List[str]:
    """Write one SQLite DB per rank (paper layout) + ground-truth JSON."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for tr in ds.traces:
        p = os.path.join(out_dir, f"rank{tr.rank}.sqlite")
        write_rank_db(p, tr)
        paths.append(p)
    with open(os.path.join(out_dir, "ground_truth.json"), "w") as f:
        json.dump({"anomaly_windows": ds.anomaly_windows.tolist(),
                   "spec": dataclasses.asdict(ds.spec)}, f, indent=2)
    return paths
