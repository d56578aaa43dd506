"""Phase 1 — data generation (paper §3, "Data generation").

Per paper: "Our pipeline identifies essential SQLite3 tables and extracts
kernel timestamps to define dataset boundaries. We evenly partition the full
time range into N non-overlapping shards, each binning kernel executions by
timestamp. ... Each rank independently processes its assigned shards and
saves query results into consistently named parquet files."

This module implements, per rank:

  1. boundary extraction (``MIN(start), MAX(end)`` over the kernel table),
  2. one contiguous indexed SQL range query per rank (block partitioning) —
     or N/P scattered queries (cyclic, for the benchmark comparison),
  3. the KERNEL <- MEMCPY <- GPU *left join* that produces the paper's 93M
     joined entities (Table 1): each kernel row is joined with every memcpy
     overlapping a +/- window on the same device, then with the GPU row,
  4. shard files written to the TraceStore ("parquet").

The join is vectorised (searchsorted range probe on the time-sorted memcpy
table) instead of a row-at-a-time SQL loop — same result, columnar layout.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .events import EventTable, RankTrace
from .query import Query
from .sharding import (ShardPlan, assignment, contiguous_rank_range,
                       owner_of_shards)
from .tracestore import StoreManifest, TraceStore

# Columns each shard file carries: one row per JOINED (kernel x memcpy)
# entity, plus unjoined kernels (left join semantics -> memcpy cols zeroed).
SHARD_COLUMNS = [
    "k_start", "k_end", "k_device", "k_stream", "k_name", "k_stall",
    "m_start", "m_bytes", "m_kind", "m_duration",
    "g_bandwidth", "g_sm_count",
    "joined",          # 1 if a memcpy matched, 0 for left-join null row
    "src_rank",        # profiling rank this row came from
]


@dataclasses.dataclass
class GenerationConfig:
    interval_ns: int = 1_000_000_000          # paper default: 1 s bins
    n_shards: Optional[int] = None            # default: derived from interval
    partitioning: str = "block"               # paper's choice
    join_window_ns: int = 1_000_000           # memcpy overlap window (+/-)
    join_cap: int = 8                         # max memcpys joined per kernel
    # Ingest-time predicate pushdown: a Query (or its to_spec() dict —
    # the form survives a dataclasses.asdict round-trip through process
    # workers) whose time_window / kernel_names compile into SQL WHERE
    # clauses and whose ranks skip whole source DBs. Pushdown is an IO
    # optimization: analysis re-applies the same predicates row-wise, so
    # the selective store answers that query identically to a full one.
    pushdown: Optional[object] = None
    chunk_rows: Optional[int] = None          # rowid-page size for reads


@dataclasses.dataclass
class GenerationReport:
    """``rows_per_table`` counts the raw rows the rank queries actually
    extracted (the analyzed [t_start, t_end) range — for KERNEL that is
    the whole table since kernels define the range).

    ``ingest_rows_read`` / ``ingest_rows_skipped`` mirror the
    TraceStore io_counts of the same names: event rows fetched from the
    source DBs vs. rows a pushdown predicate excluded SQL-side.

    ``workers`` holds one record per rank task of the pipeline's rank
    pool (pid, whether CUDA was initialised in it, peak RSS in KiB);
    empty when the ranks ran in-process."""

    n_shards: int
    n_ranks: int
    t_start: int
    t_end: int
    rows_per_table: Dict[str, int]
    joined_rows: int
    seconds: float
    ingest_rows_read: int = 0
    ingest_rows_skipped: int = 0
    workers: List[Dict[str, Any]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class AppendReport:
    """What one append-mode ingest did: how far the plan grew, which
    pre-existing shards received rows (and are now dirty for the
    incremental aggregator), and how many joined rows arrived."""

    n_shards: int                 # total shards after the append
    n_new_shards: int             # shards past the old t_end
    dirty_shards: List[int]       # pre-existing shard indices extended
    appended_rows: int            # joined rows ingested by this append
    t_start: int
    t_end: int                    # new plan end
    seconds: float
    recovered: bool = False       # True when this run first rolled an
    #                               interrupted append forward


# append_intent.json format: version 2 journals carry the full staged
# commit (staged shard list + the complete post-append manifest) and can
# be rolled FORWARD; anything else is a pre-staged-engine journal whose
# partial shard mutations are unrecoverable and must be refused.
APPEND_JOURNAL_VERSION = 2


def recover_append(out_dir: str) -> bool:
    """Roll an interrupted append FORWARD from its intent journal.

    A version-2 journal is written only after every staged shard file is
    durably on disk, so recovery is pure replay: publish each surviving
    ``.stage`` file (shards the interrupted run already renamed replay
    as no-ops), write the journaled post-append manifest, drop the
    journal. The rows of the interrupted run land exactly once — the
    recovered manifest's watermarks exclude them from the next read.

    Returns False when there is nothing to recover (no journal), True
    after a successful roll-forward. Raises :class:`ValueError` for a
    journal the staged-commit engine cannot replay (written by the
    pre-staged engine, or corrupt): such a store may hold partially
    ingested rows with no record of which — regenerate or restore it.
    """
    store = TraceStore(out_dir)
    intent = os.path.join(out_dir, "append_intent.json")
    if not os.path.exists(intent):
        return False
    try:
        with open(intent) as f:
            journal = json.load(f)
    except (OSError, json.JSONDecodeError):
        journal = None
    if (not isinstance(journal, dict)
            or journal.get("version") != APPEND_JOURNAL_VERSION
            or "staged_shards" not in journal
            or "manifest" not in journal):
        raise ValueError(
            "a previous append was interrupted mid-way (append_intent."
            "json present) and its journal predates the staged-commit "
            "engine — the store may hold partially ingested rows and "
            "the watermark was not advanced, so retrying would "
            "double-ingest them; regenerate or restore the store")
    for s in journal["staged_shards"]:
        store.commit_staged_shard(int(s))
    store.write_manifest(StoreManifest.from_json(journal["manifest"]))
    os.remove(intent)
    # orphan stage files outside the journaled list were never part of
    # the committed append — drop them
    store.discard_staged_shards()
    return True


def _resolve_sources(db_paths: Sequence,
                     cfg: Optional[GenerationConfig] = None) -> List:
    """Resolve each element of ``db_paths`` — a filesystem path to any
    supported CUPTI SQLite dialect (native synthetic, nvprof, Nsight
    Systems) or an already-constructed TraceSource — into a TraceSource.
    Imported lazily: the core layer must not depend on :mod:`repro_torch.ingest`
    at module scope (ingest imports core)."""
    from repro_torch.ingest.cupti_sqlite import as_trace_source
    chunk = cfg.chunk_rows if cfg is not None else None
    return [as_trace_source(p, chunk_rows=chunk) for p in db_paths]


def _pushdown_query(pushdown) -> Optional[Query]:
    """Normalize ``GenerationConfig.pushdown`` (Query | spec dict | None)
    into a Query. Dicts arrive two ways: a user-written ``to_spec()``
    form, or the full-field dict ``dataclasses.asdict`` produces when the
    config crosses a process-pool boundary — both construct cleanly."""
    if pushdown is None or isinstance(pushdown, Query):
        return pushdown
    if isinstance(pushdown, dict):
        return Query(**pushdown)
    raise TypeError(
        f"pushdown must be a Query or its spec dict, got {type(pushdown)!r}")


def union_kernel_names(db_paths: Sequence) -> Dict[str, str]:
    """Union of every source's kernel-name table, JSON-manifest shaped
    (``{str(name_id): name}``). Conflicting spellings for one id resolve
    last-DB-wins — profiling ranks of one run share a build, so real
    conflicts do not arise. Accepts paths or TraceSources."""
    names: Dict[str, str] = {}
    for src in _resolve_sources(db_paths):
        names.update({str(i): n for i, n in src.kernel_names().items()})
    return names


def global_time_range(db_paths: Sequence) -> Tuple[int, int]:
    """Dataset boundaries = union of per-source kernel time ranges (paper
    §3). Deliberately UNFILTERED by any pushdown predicate so a selective
    store's shard plan matches the full store's — cache keys and shard
    indices stay comparable across the two."""
    lo, hi = None, None
    for src in _resolve_sources(db_paths):
        a, b = src.time_range()
        lo = a if lo is None else min(lo, a)
        hi = b if hi is None else max(hi, b)
    if lo is None or hi is None or hi <= lo:
        raise ValueError("no kernel rows found; cannot define boundaries")
    return int(lo), int(hi)


def window_left_join(kernels: EventTable, memcpys: EventTable,
                     gpu_bandwidth: Dict[int, int],
                     gpu_sm: Dict[int, int],
                     window_ns: int, cap: int,
                     src_rank: int) -> Dict[str, np.ndarray]:
    """KERNEL <- MEMCPY <- GPU left join, vectorised.

    A kernel joins every memcpy on the SAME device whose start lies within
    ``[k_start - window, k_end + window)``, capped at ``cap`` matches (the
    explosion factor of Table 1 is ``1 + E[matches]``).  Kernels with no
    match emit one null-extended row (left-join semantics).
    """
    nk = len(kernels)
    if nk == 0:
        return {c: np.zeros((0,), np.float64) for c in SHARD_COLUMNS}

    m_sorted = memcpys.sort_by_start()
    ms = m_sorted.start

    lo = np.searchsorted(ms, kernels.start - window_ns, side="left")
    hi = np.searchsorted(ms, kernels.end + window_ns, side="right")
    n_match = np.minimum(hi - lo, cap)

    # Row expansion: kernel i contributes max(1, n_match[i]) output rows.
    out_counts = np.maximum(n_match, 1)
    offsets = np.concatenate([[0], np.cumsum(out_counts)])
    total = int(offsets[-1])

    k_idx = np.repeat(np.arange(nk), out_counts)
    # position of each output row within its kernel's match list
    pos = np.arange(total) - offsets[k_idx]
    m_idx = lo[k_idx] + pos
    valid = pos < n_match[k_idx]            # false -> left-join null row
    m_idx = np.where(valid, np.minimum(m_idx, max(len(m_sorted) - 1, 0)), 0)

    # device must also match; demote mismatches to null rows (still capped).
    if len(m_sorted) > 0:
        same_dev = m_sorted.device[m_idx] == kernels.device[k_idx]
        valid = valid & same_dev
    else:
        valid = np.zeros(total, dtype=bool)

    def mcol(arr, default=0):
        if len(m_sorted) == 0:
            return np.full(total, default, arr.dtype if hasattr(arr, "dtype")
                           else np.float64)
        return np.where(valid, arr[m_idx], default)

    bw = np.vectorize(lambda d: gpu_bandwidth.get(int(d), 0))(
        kernels.device[k_idx]) if nk else np.zeros(total)
    sm = np.vectorize(lambda d: gpu_sm.get(int(d), 0))(
        kernels.device[k_idx]) if nk else np.zeros(total)

    m_dur = (mcol(m_sorted.end) - mcol(m_sorted.start)).astype(np.float64)
    return {
        "k_start": kernels.start[k_idx].astype(np.float64),
        "k_end": kernels.end[k_idx].astype(np.float64),
        "k_device": kernels.device[k_idx].astype(np.float64),
        "k_stream": kernels.stream[k_idx].astype(np.float64),
        "k_name": kernels.name_id[k_idx].astype(np.float64),
        "k_stall": kernels.memory_stall[k_idx].astype(np.float64),
        "m_start": mcol(m_sorted.start).astype(np.float64),
        "m_bytes": mcol(m_sorted.bytes).astype(np.float64),
        "m_kind": mcol(m_sorted.copy_kind, -1).astype(np.float64),
        "m_duration": m_dur,
        "g_bandwidth": np.asarray(bw, np.float64),
        "g_sm_count": np.asarray(sm, np.float64),
        "joined": valid.astype(np.float64),
        "src_rank": np.full(total, src_rank, np.float64),
    }


def _concat_columns(parts: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    if not parts:
        return {c: np.zeros((0,), np.float64) for c in SHARD_COLUMNS}
    return {c: np.concatenate([p[c] for p in parts]) for c in SHARD_COLUMNS}


def generate_rank(rank: int, db_paths: Sequence[str], plan: ShardPlan,
                  shard_ids: np.ndarray, store: TraceStore,
                  cfg: GenerationConfig,
                  contiguous: bool = True) -> Dict[str, int]:
    """One rank's generation work: query its shards, join, write shard files.

    With block partitioning the rank issues ONE contiguous range query per
    source DB (``contiguous=True``); with cyclic it issues one query per
    shard — the overhead difference the paper's Fig 1c measures.

    Returns ``{"joined", "KERNEL", "MEMCPY", "GPU", "ingest_rows_read",
    "ingest_rows_skipped"}`` row counts for this rank's time range. Rank
    queries are half-open ``[lo, hi)`` over disjoint ranges, so
    KERNEL/MEMCPY counts sum exactly across ranks — the driver builds its
    Table-1 inventory from these instead of re-reading every DB. The GPU
    table is static and fully read by every query; it is counted only
    once per rank (drivers take the max across ranks). Ingest counters
    are mirrored into ``store.io_counts`` AND returned, so process-backend
    drivers (which hold a different store object per worker) can still
    sum them.
    """
    counts = {"joined": 0, "KERNEL": 0, "MEMCPY": 0, "GPU": 0,
              "ingest_rows_read": 0, "ingest_rows_skipped": 0}
    if len(shard_ids) == 0:
        return counts
    sources = _resolve_sources(db_paths, cfg)
    pushdown = _pushdown_query(cfg.pushdown)
    # ``ranks`` pushes down one level above the SQL clauses: a source DB
    # whose rank index is excluded is never opened for event rows — its
    # in-range rows are charged to ingest_rows_skipped via a COUNT.
    push_ranks = (None if pushdown is None or pushdown.ranks is None
                  else {int(r) for r in pushdown.ranks})
    first_query = True

    def _ingest_count(name: str, n: int = 1) -> None:
        counts[name] += int(n)
        store._count(name, int(n))

    def _process_range(t_lo: int, t_hi: int, ids: np.ndarray) -> None:
        nonlocal first_query
        parts = []
        for src, source in enumerate(sources):
            if push_ranks is not None and src not in push_ranks:
                skipped = source.count_range(start=t_lo, end=t_hi)
                if skipped:
                    _ingest_count("ingest_rows_skipped", skipped)
                continue
            tr = source.read(rank=src, start=t_lo, end=t_hi,
                             pushdown=pushdown, count=_ingest_count)
            counts["KERNEL"] += len(tr.kernels)
            counts["MEMCPY"] += len(tr.memcpys)
            if first_query:
                counts["GPU"] += len(tr.gpus)
            bw = {g.id: g.bandwidth for g in tr.gpus}
            sm = {g.id: g.sm_count for g in tr.gpus}
            parts.append(window_left_join(
                tr.kernels, tr.memcpys, bw, sm,
                cfg.join_window_ns, cfg.join_cap, src_rank=src))
        first_query = False
        cols = _concat_columns(parts)
        # bin rows into shards by kernel start timestamp
        sid = plan.shard_of(cols["k_start"].astype(np.int64))
        for s in ids:
            mask = sid == s
            shard_cols = {c: cols[c][mask] for c in SHARD_COLUMNS}
            store.write_shard(int(s), shard_cols)
            counts["joined"] += int(mask.sum())

    if contiguous:
        t_lo, t_hi = contiguous_rank_range(plan, shard_ids)
        _process_range(t_lo, t_hi, shard_ids)
    else:
        for s in shard_ids:
            t_lo, t_hi = plan.shard_bounds(int(s))
            _process_range(t_lo, t_hi, np.asarray([s]))
    return counts


def generation_manifest_extra(sources: Sequence,
                              cfg: GenerationConfig) -> Dict:
    """Manifest ``extra`` block shared by :func:`run_generation` and the
    pipeline's concurrent driver. Watermarks are snapshotted AFTER the
    rank reads (callers invoke this post-generation), matching the
    quiescent-source assumption documented on :func:`run_generation`."""
    pushdown = _pushdown_query(cfg.pushdown)
    extra = {"interval_ns": cfg.interval_ns,
             "join_window_ns": cfg.join_window_ns,
             "join_cap": cfg.join_cap,
             "kernel_names": union_kernel_names(sources),
             "db_paths": [s.path for s in sources],
             "db_rowid_hi": {s.path: list(s.rowid_hi()) for s in sources},
             "source_kinds": {s.path: s.schema.kind for s in sources}}
    if pushdown is not None:
        # to_spec(), not canonical(): from_spec round-trips the former
        # (canonical() adds a "version" key from_spec rejects). Appends
        # re-apply this recorded predicate so the store stays coherent.
        extra["ingest_pushdown"] = pushdown.to_spec()
    return extra


def run_generation(db_paths: Sequence, out_dir: str,
                   n_ranks: int, cfg: Optional[GenerationConfig] = None,
                   store: Optional[TraceStore] = None) -> GenerationReport:
    """Full phase-1 driver (sequential loop over ranks; the process/MPI
    backend in :mod:`repro_torch.core.pipeline` runs ranks concurrently).

    ``db_paths`` elements may be filesystem paths to any supported CUPTI
    SQLite dialect (native synthetic, nvprof, Nsight Systems export) or
    pre-built TraceSources. Pass ``store`` to observe ingest io_counts on
    a caller-owned TraceStore instance.

    The initial generation assumes QUIESCENT source DBs (the paper's
    post-mortem model): the append watermarks are recorded after the
    rank reads, so rows added DURING generation would be skipped. Growth
    after generation is the supported path — ingest it with
    :func:`run_append`, whose bounded reads are live-writer safe."""
    cfg = cfg or GenerationConfig()
    t0 = time.perf_counter()
    sources = _resolve_sources(db_paths, cfg)
    lo, hi = global_time_range(sources)
    if cfg.n_shards is not None:
        plan = ShardPlan(lo, hi, cfg.n_shards)
    else:
        plan = ShardPlan.from_interval(lo, hi, cfg.interval_ns)

    store = store if store is not None else TraceStore(out_dir)
    ranks = assignment(plan.n_shards, n_ranks, cfg.partitioning)
    rank_counts = [generate_rank(
        r, sources, plan, ranks[r], store, cfg,
        contiguous=(cfg.partitioning == "block"))
        for r in range(n_ranks)]
    joined = sum(c["joined"] for c in rank_counts)

    owner = owner_of_shards(plan.n_shards, n_ranks, cfg.partitioning)
    store.write_manifest(StoreManifest(
        t_start=plan.t_start, t_end=plan.t_end, n_shards=plan.n_shards,
        n_ranks=n_ranks, partitioning=cfg.partitioning,
        columns=SHARD_COLUMNS, shard_owner=owner.tolist(),
        extra=generation_manifest_extra(sources, cfg)))

    # Table-1 style inventory, assembled from the rank workers' own range
    # queries (no second pass over the DBs).
    rows = {"KERNEL": sum(c["KERNEL"] for c in rank_counts),
            "MEMCPY": sum(c["MEMCPY"] for c in rank_counts),
            "GPU": max((c["GPU"] for c in rank_counts), default=0)}
    return GenerationReport(
        n_shards=plan.n_shards, n_ranks=n_ranks,
        t_start=plan.t_start, t_end=plan.t_end,
        rows_per_table=rows, joined_rows=joined,
        seconds=time.perf_counter() - t0,
        ingest_rows_read=sum(
            c.get("ingest_rows_read", 0) for c in rank_counts),
        ingest_rows_skipped=sum(
            c.get("ingest_rows_skipped", 0) for c in rank_counts))


def run_append(db_paths: Sequence, out_dir: str,
               cfg: Optional[GenerationConfig] = None,
               max_new_shards: int = 100_000,
               store: Optional[TraceStore] = None) -> AppendReport:
    """Append-mode ingest: extend an EXISTING store with new trace data
    instead of regenerating it.

    Two sources of new data, handled uniformly:

      * a DB already in the manifest whose file has GROWN — re-queried by
        ROWID watermark (``rowid > db_rowid_hi`` recorded at the last
        ingest), which selects exactly the rows appended since then:
        duplicate-free and loss-free even when a late flush lands below
        the already-covered time range (those rows extend their existing
        shards and dirty them). Stores generated before watermarks were
        recorded cannot be appended to safely and are rejected loudly.
      * a brand-new DB path (a late-arriving profiling rank) — queried in
        full; its rows landing in existing shards EXTEND those shard
        files (read + concat + atomic rewrite), marking exactly those
        shards dirty for the incremental aggregator.

    The plan is re-derived with :meth:`ShardPlan.extended_to`, so existing
    shard boundaries (and files) are untouched; shards past the old
    ``t_end`` are new files. Join parameters come from the manifest so
    appended rows join identically to the original generation, ACROSS
    the ingest boundary included: a memcpy look-back query re-fetches
    pre-watermark transfers within ``join_window_ns`` of the new
    kernels' time range, so a newly appended kernel joins memcpys
    ingested by a previous batch exactly as a from-scratch generation
    would (the symmetric direction — an already-committed kernel row
    gaining a newly appended memcpy match — would mean rewriting
    committed rows and is not attempted). New shards are owned
    round-robin in the manifest; the pre-existing owner prefix is
    immutable history. The final manifest write garbage-collects stale
    summaries once (``TraceStore.gc_stale``).

    Crash safety: the append is a STAGED COMMIT. Phase 1 (prepare)
    materializes every extended/new shard's full future contents under
    ``.stage`` siblings — invisible to readers, nothing published, no
    watermark moved; a crash here leaves only orphan stage files that
    the next append discards and re-reads from the source DBs. Phase 2
    opens with the intent journal (``append_intent.json``, version 2):
    the staged shard list plus the complete post-append manifest. From
    that write on the append is COMMITTED — each staged shard is
    published by one atomic rename (+ per-shard partial invalidation),
    then the journaled manifest lands and the journal is removed. A
    crash anywhere in phase 2 is rolled FORWARD by
    :func:`recover_append` (run automatically by the next
    ``run_append``): surviving stage files are renamed (already-
    published shards replay as no-ops), the journaled manifest is
    written, and the journal cleared — exactly-once ingest, never a
    double-read of the interrupted rows. Journals from the pre-staged
    engine (no version-2 stage list) cannot be rolled forward and are
    refused loudly, as before.
    """
    cfg = cfg or GenerationConfig()
    t0 = time.perf_counter()
    store = store if store is not None else TraceStore(out_dir)
    intent = os.path.join(out_dir, "append_intent.json")
    was_recovered = False
    if os.path.exists(intent):
        # roll the interrupted append forward (raises for journals the
        # staged-commit engine cannot replay), then ingest as usual —
        # the recovered watermarks exclude already-published rows
        was_recovered = recover_append(out_dir)
    else:
        # orphans from a preparer that died BEFORE journaling: their
        # rows were never published, so just drop the stage files
        store.discard_staged_shards()
    man = store.read_manifest()
    if "db_paths" not in man.extra or "db_rowid_hi" not in man.extra:
        raise ValueError(
            "store manifest records no ingest watermarks (generated by a "
            "pre-append engine) — appending would re-ingest or drop rows "
            "silently; regenerate the store once to make it appendable")
    old_plan = ShardPlan(man.t_start, man.t_end, man.n_shards)
    window = int(man.extra.get("join_window_ns", cfg.join_window_ns))
    cap = int(man.extra.get("join_cap", cfg.join_cap))
    all_dbs = [os.path.abspath(p) for p in man.extra["db_paths"]]
    rowid_hi = {os.path.abspath(k): v
                for k, v in man.extra["db_rowid_hi"].items()}
    source_kinds = dict(man.extra.get("source_kinds", {}))
    # A selective store re-applies ITS OWN recorded pushdown on every
    # append — cfg.pushdown is ignored here, because mixing predicates
    # across appends would leave a store that answers no single query
    # coherently. Full stores (no recorded predicate) append everything.
    pd_spec = man.extra.get("ingest_pushdown")
    pushdown = Query.from_spec(pd_spec) if pd_spec else None
    push_ranks = (None if pushdown is None or pushdown.ranks is None
                  else {int(r) for r in pushdown.ranks})

    parts = []
    hi = man.t_end                      # plan end from INGESTED rows only
    for source in _resolve_sources(db_paths, cfg):
        ap = source.path
        # snapshot the NEW watermark before reading: rows a live profiler
        # appends mid-read stay above it and are picked up by the NEXT
        # append instead of being skipped forever
        wm_new = source.rowid_hi()
        known = ap in all_dbs
        src = all_dbs.index(ap) if known else len(all_dbs)
        wm = rowid_hi.get(ap) if known else None
        if known and wm is None:
            raise ValueError(
                f"no ingest watermark recorded for known DB {ap!r} — "
                "regenerate the store to make it appendable")
        if not known:
            all_dbs.append(ap)
        source_kinds[ap] = source.schema.kind
        if push_ranks is not None and src not in push_ranks:
            # rank excluded by the recorded pushdown: never read events,
            # but still advance the watermark (charging the in-range rows
            # to the skipped counter) so later appends stay bounded
            skipped = source.count_range(
                min_rowids=tuple(wm) if wm else None, max_rowids=wm_new)
            if skipped:
                store._count("ingest_rows_skipped", skipped)
            rowid_hi[ap] = list(wm_new)
            continue
        if known:
            tr = source.read(rank=src, min_rowids=(wm[0], wm[1]),
                             max_rowids=wm_new, pushdown=pushdown,
                             count=store._count)
            # Memcpy LOOK-BACK: a kernel appended THIS round may overlap
            # transfers ingested by a PREVIOUS batch (rowid <= wm) within
            # ``join_window_ns`` of the ingest boundary — re-fetch exactly
            # those (time-bounded, rowid-capped: the kernel cap of 0 keeps
            # old kernels out) so cross-batch matches are joined instead
            # of silently dropped. Old kernels are never re-joined, so no
            # duplicate rows can arise; the symmetric gap (an old kernel
            # joining a NEWLY appended memcpy) would require rewriting
            # committed rows and remains out of scope.
            if len(tr.kernels) and wm[1] > 0:
                look = source.read(
                    rank=src,
                    start=int(tr.kernels.start.min()) - window,
                    end=int(tr.kernels.end.max()) + window,
                    max_rowids=(0, wm[1]), count=store._count)
                if len(look.memcpys):
                    tr = RankTrace(rank=tr.rank, kernels=tr.kernels,
                                   memcpys=look.memcpys.concat(tr.memcpys),
                                   gpus=tr.gpus)
        else:
            tr = source.read(rank=src, max_rowids=wm_new,
                             pushdown=pushdown, count=store._count)
        if len(tr.kernels) and int(tr.kernels.start.min()) < man.t_start:
            raise ValueError(
                f"DB {ap!r} holds kernels before the store's t_start "
                f"({int(tr.kernels.start.min())} < {man.t_start}) — the "
                "plan only extends FORWARD (boundaries are immutable); "
                "regenerate to cover an earlier time range")
        rowid_hi[ap] = list(wm_new)
        if len(tr.kernels):
            hi = max(hi, int(tr.kernels.end.max()))
        bw = {g.id: g.bandwidth for g in tr.gpus}
        sm = {g.id: g.sm_count for g in tr.gpus}
        parts.append(window_left_join(tr.kernels, tr.memcpys, bw, sm,
                                      window, cap, src_rank=src))

    # the plan extends exactly as far as the rows ingested THIS round —
    # deriving it from an unbounded range query would race a live writer
    plan = old_plan.extended_to(hi)
    if plan.n_shards - man.n_shards > max_new_shards:
        # one clock-skewed/corrupt far-future row would otherwise
        # materialize a shard FILE per interval up to its timestamp
        raise ValueError(
            f"append would create {plan.n_shards - man.n_shards} new "
            f"shards (> max_new_shards={max_new_shards}) — a far-future "
            "timestamp in the appended rows? Inspect the data or raise "
            "max_new_shards explicitly")
    cols = _concat_columns(parts)
    sid = plan.shard_of(cols["k_start"].astype(np.int64))
    # ---- phase 1: PREPARE — stage every future shard, publish nothing
    dirty: List[int] = []
    appended = 0
    staged: List[int] = []
    for s in (np.unique(sid).tolist() if len(sid) else []):
        mask = sid == s
        new_cols = {c: cols[c][mask] for c in SHARD_COLUMNS}
        if store.has_shard(int(s)):
            old_cols = store.read_shard(int(s))
            new_cols = {c: np.concatenate([old_cols[c], new_cols[c]])
                        for c in SHARD_COLUMNS}
            if s < man.n_shards:
                dirty.append(int(s))
        store.stage_shard(int(s), new_cols)
        staged.append(int(s))
        appended += int(mask.sum())
    # every new shard index gets a file, empty ones included — same
    # layout as a fresh generation
    for s in range(man.n_shards, plan.n_shards):
        if s not in staged and not store.has_shard(s):
            store.stage_shard(
                s, {c: np.zeros((0,), np.float64) for c in SHARD_COLUMNS})
            staged.append(int(s))

    owner = list(man.shard_owner) + [
        int(i % max(man.n_ranks, 1))
        for i in range(man.n_shards, plan.n_shards)]
    extra = dict(man.extra)
    extra["db_paths"] = all_dbs
    extra["db_rowid_hi"] = rowid_hi
    extra["source_kinds"] = source_kinds
    # refresh the name table: appended rows can introduce new name ids
    extra["kernel_names"] = {**dict(extra.get("kernel_names", {})),
                             **union_kernel_names(db_paths)}
    new_man = StoreManifest(
        t_start=plan.t_start, t_end=plan.t_end, n_shards=plan.n_shards,
        n_ranks=man.n_ranks, partitioning=man.partitioning,
        columns=man.columns, shard_owner=owner, extra=extra)
    # ---- phase 2: JOURNAL + COMMIT — from the journal write on, the
    # append is committed: every staged rename below is idempotent and
    # recover_append can replay the rest after a crash at ANY point
    TraceStore._atomic_write(intent, json.dumps({
        "version": APPEND_JOURNAL_VERSION,
        "staged_shards": staged,
        "manifest": new_man.to_json(),
        "old_t_end": man.t_end, "new_t_end": plan.t_end,
        "old_watermarks": man.extra["db_rowid_hi"],
        "new_watermarks": rowid_hi}, indent=2).encode())
    for s in staged:
        store.commit_staged_shard(s)
    store.write_manifest(new_man)
    os.remove(intent)                    # append fully committed
    return AppendReport(
        n_shards=plan.n_shards,
        n_new_shards=plan.n_shards - man.n_shards,
        dirty_shards=sorted(dirty), appended_rows=appended,
        t_start=plan.t_start, t_end=plan.t_end,
        seconds=time.perf_counter() - t0, recovered=was_recovered)
