"""Concurrent query-serving front door over the declarative Query API.

The paper's promise is low-latency exploration integrated into
automated workflows; the library alone is one-caller-at-a-time. This
module puts the Query engine behind a small HTTP service
(``ThreadingHTTPServer`` — one handler thread per connection) with the
properties a shared analysis plane needs:

Admission batching (one fused plan per tick)
    Requests arriving within a ``tick_ms`` window are drained into ONE
    :class:`~repro_torch.core.query.QueryPlan` and executed as a single fused
    ``execute_plan`` — every dirty shard file read once for ALL
    concurrent users' lanes, clean shards served from the consolidated
    per-shard partial packs. Each response carries the provenance a
    client (and the CI smoke leg) can assert on: ``fused_width`` (how
    many lanes rode the tick's plan) and ``batched_fused`` (width > 1).

Pipelined ticks (bounded overlap)
    With ``pipeline_depth > 1`` the single tick worker becomes a THREE
    stage pipeline: an admission thread keeps draining tick windows
    while earlier ticks execute (tick N+1 admits, compiles and begins
    its summary probes / clean-lane loads while tick N's scan is still
    running, up to ``pipeline_depth`` ticks in flight — a semaphore
    backpressures admission past that); execution runs on a
    depth-sized executor whose dirty-shard scans fan out over the
    service-lifetime :class:`~repro_torch.core.aggregation.ScanPool` (its
    single pack-writer thread serializes EVERY pack append across all
    in-flight ticks, so the pack read-modify-write contract and
    io_counts stay valid); and ONE commit thread serializes the
    bookkeeping tail — LRU touches/evictions, service counters, and
    releasing each request's ``done`` event. Summary writes are
    per-file atomic (tmp+rename) with distinct keys guaranteed by the
    in-flight dedup below, so concurrent ticks never write the same
    summary.

Per-key in-flight dedup
    Two overlapping ticks never compute the same canonical query twice:
    at admission each query keys into an in-flight slot table by
    ``(cache_key, interval_ns)``; a tick OWNS the slots it creates
    (they ride its fused plan) and BORROWS slots an earlier in-flight
    tick is already computing, waiting on the owner's result and
    re-rendering it for its own caller (exact: the canonical key pins
    the reducer suite and predicate set, and rendering permutes to the
    borrower's metric order). Deadlock-free by construction: a borrowed
    slot's owner was admitted earlier, and the executor holds exactly
    ``pipeline_depth`` workers for at most ``pipeline_depth``
    uncommitted ticks, so the owner is always running or finished.
    Borrowed answers are marked ``inflight_hit`` in the response.

Shared summary cache + byte-budgeted LRU eviction
    All ticks execute against one :class:`TraceStore` instance, so
    every user shares the on-disk ``summary_*.npz`` cache AND the
    in-process pack cache. After each tick the commit stage touches the
    tick's summary keys and, when the store exceeds
    ``summary_budget_bytes``, deletes least-recently-used summary files
    — but NEVER a key registered by ANY in-flight tick (widened from
    "current tick" when ticks began to overlap), so a result is never
    evicted between being computed and being read back.

Pack LRU (partial-pack byte budget)
    ``pack_budget_bytes`` extends the same byte-budget discipline to
    the per-shard partial packs: when pack bytes exceed the budget the
    commit stage walks packs least-recently-touched first, compacting
    stale entries out first (``compact_pack``) and dropping the whole
    pack only if still over budget — never touching a pack referenced
    by an in-flight tick's shard set. Packs are derived data: eviction
    costs at most one rescan of that shard.

Per-request budget
    ``max_cells_per_request`` bounds the estimated result size
    (bins x metrics x reducer state width, summed over the request's
    queries) BEFORE admission; an oversized request — e.g. a 1 ms
    re-binning of a day-long trace — is rejected with HTTP 413 instead
    of stalling every other user's tick while it allocates.

Ingest ticks (the streaming plane's writer)
    :mod:`repro_torch.serve.stream` schedules live append-mode ingest as a
    SECOND TICK KIND through this same pipeline: an ingest tick runs
    solo (never fused with query lanes), executes the staged-commit
    ``run_append`` and then the plane's fence queries as owned lanes
    against the extended store, and its commit hands the tick to
    ``StreamIngestor.on_commit`` — watermark advance, fence-state
    diffing and event publication all happen on the single commit
    thread, the serialization point every other cross-tick write
    already funnels through.

Backend and device
    ``ServiceConfig.backend`` picks the dirty-shard producer of every
    tick: ``"torch"`` (the default) reduces the dirty shards' rows on
    ``ServiceConfig.device`` through the ``binstats_flat`` and
    ``histbin_flat`` kernels, ``"serial"`` scans them exactly on the
    host. On both, each rendered fence and each ingest tick's fence diff
    runs the ``iqr`` kernel on ``ServiceConfig.device``. The device
    defaults to ``"cuda"``: a config naming the card on a machine without
    one raises when it is built. A kernel that fails inside a tick fails
    that tick (HTTP 500); nothing retries on a plain version.

Run it (on the card; ``--device cpu`` keeps every step on the host):

  PYTHONPATH=src python -m repro_torch.serve.query_service --store DIR \\
      [--backend torch|serial] [--device cuda|cpu] \\
      [--port 8321] [--tick-ms 10] [--workers 4] \\
      [--summary-budget-mb 256] [--pack-budget-mb 0] \\
      [--attach rank0.sqlite rank1.sqlite] [--poll-ms 25]

The HTTP surface is versioned under ``/v1/``::

  POST /v1/query          JSON body: one Query spec object or a list
                          run as one request ->
                          {"results": [...], "tick": {...}}
  POST /v1/ingest/attach  {"db_paths": [...]} — tail rank DBs (starts
                          the ingest plane on first use)
  POST /v1/ingest/detach  {"db_paths": [...]}
  GET  /v1/stream/fences  fence-event subscription: long-poll cursor
                          (?since=SEQ&timeout_s=S -> {"events",
                          "next_since"}) or SSE with
                          ``Accept: text/event-stream``
  GET  /v1/stats          service + ingest counters
  GET  /v1/healthz        liveness probe

  curl -s localhost:8321/v1/query -d '[{"metrics": ["k_stall"],
      "group_by": "m_kind"}]'

Every error answers the SAME envelope — HTTP status plus
``{"error": {"code", "message", "detail"}}`` with machine-readable
codes (``bad_request``, ``budget_exceeded`` 413, ``tick_timeout`` 503,
``no_ingest_plane`` 409, ``not_found`` 404). The legacy unversioned
routes (``/query``, ``/stats``, ``/healthz``) keep answering as
aliases of their v1 successors, stamped with a ``Deprecation: true``
header and a ``Link: <...>; rel="successor-version"`` pointer.

Response: ``{"results": [...], "tick": {"fused_width": N,
"batched_fused": bool, "evicted": E, "inflight_hits": H, ...}}`` —
per-query group/metric moment summaries plus the engine's execution
provenance. A request whose tick dies or overruns
``request_timeout_s`` gets HTTP 503 with code ``tick_timeout``
(handlers never block past the deadline). ``GET /v1/stats`` exposes
service counters — ticks, fused widths, per-tick latency percentiles
(p50/p95/p99 off a log2-bucket
:class:`~repro_torch.core.reducers.QuantileSketch`, bounded memory under
sustained load), scan-worker utilization, eviction counts, the
store's io_counts and (when the ingest plane is up) the streaming
provenance: rows ingested, dirty shards, event-to-fence latency
percentiles.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Set, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from repro_torch.core.aggregation import ScanPool
from repro_torch.device import resolve_device
from repro_torch.core.anomaly import report_for_query
from repro_torch.core.generation import run_append
from repro_torch.core.query import Query, QueryPlan
from repro_torch.core.reducers import N_BUCKETS, QuantileSketch, bucket_of
from repro_torch.core.tracestore import (TraceStore, pack_filename,
                                   summary_filename)
from repro_torch.serve.stream import IngestConfig, StreamIngestor

# moment state width per (bin, group, metric) cell; the quantile sketch
# rides N_BUCKETS more — the per-request budget estimates with these
_MOMENT_WIDTH = 5


class BudgetExceeded(ValueError):
    """Request rejected by the per-request result-size budget (413)."""


class _Server(ThreadingHTTPServer):
    # a concurrent burst is the service's whole point: don't reset
    # connections off the default listen backlog of 5
    request_queue_size = 128
    daemon_threads = True


@dataclasses.dataclass
class ServiceConfig:
    tick_ms: float = 10.0                # admission-batch window
    backend: str = "torch"               # serial | torch
    device: str = "cuda"                 # torch reduction + IQR fences
    max_cells_per_request: int = 50_000_000
    summary_budget_bytes: Optional[int] = 256 * 1024 * 1024
    pack_budget_bytes: Optional[int] = None   # None/0 = unbounded
    request_timeout_s: float = 120.0     # handler wait on its tick
    # scan threads per fused plan (the service-lifetime ScanPool):
    # 0 = one per CPU, 1 = inline scan (appends still ride the pool's
    # single pack-writer so overlapping ticks stay serialized)
    scan_workers: int = 0
    # max ticks in flight: 1 = the sequential pre-pipeline loop
    # (admit -> execute -> commit, one tick at a time), N > 1 overlaps
    # tick N+1's admission/probes with tick N's scan
    pipeline_depth: int = 4
    host: str = "127.0.0.1"
    port: int = 8321
    # streaming ingest plane knobs, used when the plane is brought up
    # (ensure_ingestor / POST /v1/ingest/attach); None = defaults
    ingest: Optional[IngestConfig] = None

    def __post_init__(self):
        if self.backend not in ("serial", "torch"):
            raise ValueError(f"unknown backend {self.backend!r} "
                             "(serial | torch)")
        resolve_device(self.device)


@dataclasses.dataclass
class _Pending:
    """One admitted request riding the next tick. ``kind="query"`` is a
    client request; ``kind="ingest"`` is the streaming plane's append
    tick — its ``queries`` are the plane's fence queries, executed on
    the post-append store."""

    queries: List[Query]
    kind: str = "query"
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    results: Optional[List[Dict]] = None
    tick_info: Optional[Dict] = None
    # (http_status, error_code, message) — the v1 error envelope triple
    error: Optional[Tuple[int, str, str]] = None
    # ingest-tick payload
    ingest_paths: Optional[List[str]] = None
    t_detect: float = 0.0               # event-to-fence latency anchor
    max_new_shards: int = 100_000


class _Slot:
    """In-flight dedup slot: one canonical query being computed by the
    tick that owns it; overlapping ticks borrow the slot and wait on
    ``event`` instead of recomputing."""

    __slots__ = ("key", "owner_seq", "event", "qr", "summary_key",
                 "error")

    def __init__(self, key, owner_seq: int) -> None:
        self.key = key
        self.owner_seq = owner_seq
        self.event = threading.Event()
        self.qr = None                       # owner's QueryResult
        self.summary_key: Optional[str] = None
        self.error: Optional[Tuple[int, str, str]] = None


@dataclasses.dataclass
class _Tick:
    """One admission batch moving through the pipeline stages."""

    seq: int
    batch: List[_Pending]
    flat: List[Tuple[Query, _Slot]]      # every query, admission order
    owned: List[Tuple[Query, _Slot]]     # slots this tick computes
    borrowed: int                        # queries riding other ticks
    t_admit: float
    shards: Set[int] = dataclasses.field(default_factory=set)
    release_sem: bool = False            # pipelined ticks hold a permit
    kind: str = "query"                  # "query" | "ingest"
    ingest: Optional[Dict] = None        # append provenance (exec stage)
    ingest_error: Optional[str] = None
    tick_info: Optional[Dict] = None     # filled at commit


class _ByteBudgetLRU:
    """Shared skeleton of the two byte-budgeted caches: per-key recency
    plus an in-flight registry — keys registered by ANY in-flight tick
    are immune to eviction until that tick commits and unregisters."""

    def __init__(self, budget_bytes: Optional[int]) -> None:
        self.budget = budget_bytes
        self._order: "collections.OrderedDict" = collections.OrderedDict()
        self._inflight: Dict[int, set] = {}
        self._reg_lock = threading.Lock()
        self.evictions = 0

    def register(self, tick_seq: int, keys) -> None:
        """Pin ``keys`` against eviction while tick ``tick_seq`` is in
        flight (called from the executor stage, BEFORE the scan)."""
        with self._reg_lock:
            self._inflight[tick_seq] = set(keys)

    def unregister(self, tick_seq: int) -> None:
        with self._reg_lock:
            self._inflight.pop(tick_seq, None)

    def immune(self) -> set:
        with self._reg_lock:
            out: set = set()
            for keys in self._inflight.values():
                out |= keys
            return out

    def touch(self, keys) -> None:
        """Mark ``keys`` most-recently-used (commit stage, single
        writer)."""
        for k in keys:
            self._order.pop(k, None)
            self._order[k] = True

    def _sync_order(self, sizes: Dict) -> None:
        """Adopt out-of-band keys at the cold end, forget deleted."""
        for k in sizes:
            if k not in self._order:
                self._order[k] = True
                self._order.move_to_end(k, last=False)
        for k in list(self._order):
            if k not in sizes:
                self._order.pop(k)


class SummaryCacheLRU(_ByteBudgetLRU):
    """Byte-budgeted LRU over the on-disk summary store.

    Recency is tracked per summary KEY (touched once per tick that
    reads or writes it); eviction deletes ``summary_{key}.npz`` files
    least-recently-used first until the store fits the budget, skipping
    every key registered by ANY in-flight tick (a tick's own results
    are never evicted before the requester reads them, no matter how
    many ticks overlap). Summary files that appear out of band (another
    process, a pre-existing store) are adopted at the cold end of the
    order. Evicting a summary is always safe: it is derived data,
    recomputable from shards/partials at the cost of one scan."""

    def __init__(self, store: TraceStore,
                 budget_bytes: Optional[int]) -> None:
        super().__init__(budget_bytes)
        self.store = store

    def evict(self) -> int:
        """Delete LRU summary files until the store fits the budget.
        Returns how many were evicted (0 when unbudgeted or within).
        Commit-stage only (single caller at a time)."""
        if not self.budget:
            return 0
        sizes: Dict[str, int] = {}
        for k in self.store.summary_keys():
            try:
                sizes[k] = os.path.getsize(
                    os.path.join(self.store.root, summary_filename(k)))
            except OSError:
                pass
        self._sync_order(sizes)
        total = sum(sizes.values())
        immune = self.immune()
        evicted = 0
        for k in list(self._order):
            if total <= self.budget:
                break
            if k in immune:
                continue                 # in-flight tick reads this key
            try:
                os.remove(os.path.join(self.store.root,
                                       summary_filename(k)))
            except FileNotFoundError:
                pass
            total -= sizes[k]
            self._order.pop(k)
            evicted += 1
        self.evictions += evicted
        return evicted


class PackCacheLRU(_ByteBudgetLRU):
    """Byte budget over the per-shard partial packs (``pack_*.bin``).

    When total pack bytes exceed the budget, packs are visited
    least-recently-touched first: stale entries are compacted out
    first (:meth:`~repro_torch.core.tracestore.TraceStore.compact_pack` —
    the cheap reclaim), and a pack still needed over budget is dropped
    whole (``clear_partials``). A pack whose shard index is registered
    by ANY in-flight tick is never touched — an executing scan may be
    mid-read or about to append to it. Packs are derived data: the
    cost of a wrong eviction is one rescan of that shard, never a
    wrong answer."""

    def __init__(self, store: TraceStore,
                 budget_bytes: Optional[int]) -> None:
        super().__init__(budget_bytes)
        self.store = store
        self.compactions = 0

    def evict(self) -> int:
        """Compact-then-drop LRU packs until within budget; returns the
        number of packs removed. Commit-stage only."""
        if not self.budget:
            return 0
        sizes = self.store.pack_sizes()
        self._sync_order(sizes)
        total = sum(sizes.values())
        if total <= self.budget:
            return 0
        immune = self.immune()
        evicted = 0
        for idx in list(self._order):
            if total <= self.budget:
                break
            if idx in immune:
                continue             # referenced by an in-flight tick
            if self.store.compact_pack(idx):
                self.compactions += 1
                try:
                    new_size = os.path.getsize(os.path.join(
                        self.store.root, pack_filename(idx)))
                except OSError:
                    new_size = 0
                total -= sizes[idx] - new_size
                sizes[idx] = new_size
                if total <= self.budget:
                    break
            if sizes[idx]:
                self.store.clear_partials(idx)
                total -= sizes[idx]
            self._order.pop(idx)
            evicted += 1
        self.evictions += evicted
        return evicted


class QueryService:
    """Pipelined admission-batching Query front door (module docstring).

    ``submit`` is the transport-free core (the HTTP handler and the
    in-process bench/tests call it directly): validate + budget-check a
    request, enqueue it, return the :class:`_Pending` whose ``done``
    event fires when its tick commits. ``drain_once`` runs one full
    tick inline (admit -> execute -> commit) for deterministic tests;
    ``start`` spawns the pipeline threads (or the sequential loop at
    ``pipeline_depth=1``). Don't mix ``start()`` with direct
    ``drain_once`` calls — admission is single-consumer."""

    def __init__(self, store_dir: str,
                 cfg: Optional[ServiceConfig] = None) -> None:
        self.cfg = cfg or ServiceConfig()
        self.store = TraceStore(store_dir)
        self.man = self.store.read_manifest()
        self.cache = SummaryCacheLRU(self.store,
                                     self.cfg.summary_budget_bytes)
        self.packs = PackCacheLRU(self.store, self.cfg.pack_budget_bytes)
        self.scan_pool = ScanPool(self.cfg.scan_workers)
        self._depth = max(1, int(self.cfg.pipeline_depth))
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._deferred: Optional[_Pending] = None
        self._stop = threading.Event()
        self._seq = 0
        self.ingestor: Optional[StreamIngestor] = None
        self._ingestor_lock = threading.Lock()
        self._started = False
        self.ingest_requests = 0
        self._inflight: Dict[Tuple, _Slot] = {}
        self._inflight_lock = threading.Lock()
        self._depth_sem = threading.BoundedSemaphore(self._depth)
        self._commit_q: "queue.Queue[Optional[_Tick]]" = queue.Queue()
        self._threads: List[threading.Thread] = []
        self._executor: Optional[ThreadPoolExecutor] = None
        self._server: Optional[ThreadingHTTPServer] = None
        self.ticks = 0
        self.requests = 0
        self.inflight_hits = 0
        # bounded-memory tick telemetry: a deque for the width counters
        # and ONE log2-bucket sketch row for the latency percentiles
        self.widths: "collections.deque" = collections.deque(maxlen=4096)
        self._max_width = 0
        self._lat = QuantileSketch.zeros(1)
        # ticks admitted but not yet committed — the adaptive-admission
        # signal: batching is only worth its latency while one of these
        # is keeping the executor busy
        self._live_ticks = 0
        self._live_lock = threading.Lock()

    # -- admission ---------------------------------------------------------
    def estimate_cells(self, queries: Sequence[Query]) -> int:
        """Result-size estimate (reducer-state cells) for the budget:
        bins x metrics x state width per query, before any shard is
        touched. Group cardinality is unknown pre-scan, so this is the
        G=1 lower bound — generous to requests, strict enough to stop
        the pathological re-binnings the budget exists for."""
        span = max(int(self.man.t_end - self.man.t_start), 1)
        total = 0
        for q in queries:
            bins = (int(self.man.n_shards) if q.interval_ns is None
                    else -(-span // int(q.interval_ns)))
            width = _MOMENT_WIDTH
            if "quantile" in q.canonical_reducers:
                width += N_BUCKETS
            total += bins * len(q.canonical_metrics) * width
        return total

    def submit(self, queries: Sequence[Query]) -> _Pending:
        """Budget-check and enqueue one request for the next tick."""
        queries = list(queries)
        if not queries:
            raise ValueError("empty query batch")
        cells = self.estimate_cells(queries)
        if cells > self.cfg.max_cells_per_request:
            raise BudgetExceeded(
                f"request estimates {cells:,} result cells, over the "
                f"{self.cfg.max_cells_per_request:,} per-request budget")
        pending = _Pending(queries=queries)
        self.requests += 1
        self._queue.put(pending)
        return pending

    def submit_ingest(self, db_paths: Sequence[str],
                      queries: Sequence[Query],
                      t_detect: float = 0.0,
                      max_new_shards: int = 100_000) -> _Pending:
        """Enqueue one INGEST tick: append ``db_paths``' new rows to the
        store, then execute ``queries`` (the plane's fence queries) on
        the extended store — all through the normal admission ->
        executor -> commit pipeline, so ingest interleaves with query
        ticks and commits through the same single writer. Callers
        (the :class:`~repro_torch.serve.stream.StreamIngestor` tailer) must
        not overlap ingest ticks — ``run_append`` journals a staged
        commit and is not self-concurrent."""
        pending = _Pending(
            queries=list(queries), kind="ingest",
            ingest_paths=[os.path.abspath(p) for p in db_paths],
            t_detect=t_detect, max_new_shards=max_new_shards)
        self.ingest_requests += 1
        self._queue.put(pending)
        return pending

    def ensure_ingestor(self,
                        cfg: Optional[IngestConfig] = None
                        ) -> StreamIngestor:
        """The streaming plane, created on first use (``POST
        /v1/ingest/attach`` calls this). Config precedence: explicit
        ``cfg`` > ``ServiceConfig.ingest`` > defaults. The tailer
        thread starts immediately on a running service, else with
        :meth:`start`."""
        with self._ingestor_lock:
            if self.ingestor is None:
                self.ingestor = StreamIngestor(
                    self, cfg or self.cfg.ingest)
                if self._started:
                    self.ingestor.start()
            return self.ingestor

    # -- stage 1: admission (tick window + in-flight dedup) ----------------
    def _collect(self, block_s: float,
                 eager: bool = False) -> Optional[_Tick]:
        """Drain one tick window into a :class:`_Tick`, resolving every
        query against the in-flight slot table: new canonical keys
        become slots OWNED by this tick, keys an earlier in-flight tick
        is computing are BORROWED (never recomputed).

        ``eager`` is the pipelined admission mode: ``tick_ms`` is the
        MAXIMUM batching window, closed early the moment no tick is in
        flight. Waiting out a fixed window only buys fusion width, and
        width is free while the executor is already busy (requests pile
        up behind the running tick anyway — backpressure batching); on
        an idle pipeline the same wait is pure added latency. The
        sequential loop keeps the fixed window — that IS the
        single-worker floor the serve bench measures against.

        An INGEST pending always gets a tick of its own (never fused
        with query requests — its lanes must execute AFTER its append):
        one arriving first becomes the tick immediately; one arriving
        mid-window is deferred to be the NEXT tick and closes the
        current batch."""
        if self._deferred is not None:
            first, self._deferred = self._deferred, None
        else:
            try:
                first = self._queue.get(timeout=block_s)
            except queue.Empty:
                return None
        if first.kind == "ingest":
            return self._make_tick([first], kind="ingest")
        batch = [first]
        now = time.monotonic()
        deadline = now + self.cfg.tick_ms / 1000.0
        # even an eager close lingers ~2ms past the first request: the
        # responses a commit releases trigger a burst of follow-ups that
        # should land in ONE wide tick, not fragment into several
        linger = now + min(self.cfg.tick_ms, 2.0) / 1000.0
        while self._deferred is None:
            now = time.monotonic()
            remaining = deadline - now
            if remaining <= 0:
                break
            if eager and self._live_ticks == 0 and now >= linger:
                break
            try:
                p = self._queue.get(
                    timeout=min(remaining, 0.002) if eager else remaining)
            except queue.Empty:
                if not eager:
                    break
                continue
            if p.kind == "ingest":
                self._deferred = p          # next tick, alone
            else:
                batch.append(p)
        # opportunistic: anything already queued rides along even if it
        # landed just past the deadline
        while self._deferred is None:
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                break
            if p.kind == "ingest":
                self._deferred = p
            else:
                batch.append(p)
        return self._make_tick(batch)

    def _make_tick(self, batch: List[_Pending],
                   kind: str = "query") -> _Tick:
        self._seq += 1
        seq = self._seq
        flat: List[Tuple[Query, _Slot]] = []
        owned: List[Tuple[Query, _Slot]] = []
        borrowed = 0
        with self._inflight_lock:
            for p in batch:
                for q in p.queries:
                    key = (q.cache_key(), q.interval_ns)
                    slot = self._inflight.get(key)
                    if slot is None or kind == "ingest":
                        # an ingest tick always OWNS its fence lanes —
                        # they must be computed on THIS tick's
                        # post-append store, never borrowed from an
                        # earlier (pre-append) tick. The overwritten
                        # map entry is safe: the earlier owner retires
                        # its slot only if the map still points at it
                        slot = _Slot(key, seq)
                        self._inflight[key] = slot
                        owned.append((q, slot))
                    elif slot.owner_seq != seq:
                        borrowed += 1
                    flat.append((q, slot))
        return _Tick(seq=seq, batch=batch, flat=flat, owned=owned,
                     borrowed=borrowed, t_admit=time.monotonic(),
                     kind=kind)

    # -- stage 2: execution (fused plan + borrowed waits + render) ---------
    def _exec_tick(self, tick: _Tick) -> None:
        """Compile + execute the tick's OWNED queries as one fused plan
        (scans fanned over the ScanPool), fill the slots, wait for any
        borrowed slots' owners, render every response body. Runs on the
        executor — up to ``pipeline_depth`` ticks concurrently.

        An ingest tick prepends its append: the staged-commit
        ``run_append`` publishes the extended shards (atomic renames —
        concurrently executing query ticks stay torn-free), THEN the
        fence lanes compile against the refreshed manifest and execute
        like any fused plan, touching only dirty/new shards."""
        if tick.kind == "ingest":
            self._exec_ingest_append(tick)
            if tick.ingest_error is not None:
                err = (500, "ingest_failed", tick.ingest_error)
                for _, slot in tick.owned:
                    slot.error = err
                    slot.event.set()
        try:
            if tick.owned and tick.ingest_error is None:
                qplan = QueryPlan.compile(self.store,
                                          [q for q, _ in tick.owned],
                                          backend=self.cfg.backend,
                                          device=self.cfg.device)
                # pin this tick's summary keys and pack shard set
                # against eviction BEFORE any probe or scan starts
                self.cache.register(
                    tick.seq, [ln.summary_key for ln in qplan.lanes
                               if ln.summary_key])
                for ln in qplan.lanes:
                    tick.shards |= (set(int(s) for s in ln.pruned)
                                    if ln.pruned is not None
                                    else set(range(qplan.n_shard_files)))
                self.packs.register(tick.seq, tick.shards)
                results = qplan.execute(use_cache=True,
                                        pool=self.scan_pool)
                for (q, slot), qr, lane in zip(tick.owned, results,
                                               qplan.lanes):
                    slot.qr = qr
                    slot.summary_key = lane.summary_key
                    slot.event.set()
        except Exception as e:          # noqa: BLE001 — fail the tick,
            err = (500, "internal",                   # not the service
                   f"{type(e).__name__}: {e}")
            for _, slot in tick.owned:
                slot.error = err
                slot.event.set()
        # borrowed slots: wait on their owners (always admitted
        # earlier, so always running or done — never a cycle); a dead
        # owner surfaces as tick_timeout instead of a hung handler
        deadline = time.monotonic() + self.cfg.request_timeout_s
        for _, slot in tick.flat:
            if not slot.event.is_set():
                slot.event.wait(max(0.0, deadline - time.monotonic()))
        off = 0
        for p in tick.batch:
            body: List[Dict] = []
            err = None
            for q, slot in tick.flat[off:off + len(p.queries)]:
                if err is not None:
                    continue
                if not slot.event.is_set():
                    err = (503, "tick_timeout",
                           "tick timed out waiting on an in-flight "
                           "computation")
                elif slot.error is not None:
                    err = slot.error
                else:
                    qr = slot.qr
                    hit = slot.owner_seq != tick.seq
                    if qr.query is not q:
                        qr = dataclasses.replace(qr, query=q)
                    try:
                        rendered = _render_result(qr, self.cfg.device)
                    except Exception as e:  # noqa: BLE001
                        # a fence that fails (a kernel) fails the request
                        err = (500, "internal", f"{type(e).__name__}: {e}")
                        continue
                    if hit:
                        rendered["inflight_hit"] = True
                    body.append(rendered)
            off += len(p.queries)
            if err is not None:
                p.error = err
            else:
                p.results = body

    def _exec_ingest_append(self, tick: _Tick) -> None:
        """The append half of an ingest tick: staged-commit
        ``run_append`` over the pending's DB paths (rowid-bounded reads
        — live-writer safe; an interrupted previous tick rolls forward
        from its intent journal), then refresh the admission
        estimator's manifest. Failures land in ``tick.ingest_error``
        and fail the tick, never the service."""
        pending = tick.batch[0]
        try:
            rep = run_append(pending.ingest_paths, self.store.root,
                             max_new_shards=pending.max_new_shards)
            man = self.store.read_manifest()
            self.man = man              # estimate_cells sees the growth
            tick.ingest = {
                "rows_ingested": int(rep.appended_rows),
                "dirty_shards": [int(s) for s in rep.dirty_shards],
                "n_new_shards": int(rep.n_new_shards),
                "n_shards": int(rep.n_shards),
                "recovered": bool(rep.recovered),
                "append_seconds": round(float(rep.seconds), 6),
                "watermarks": {
                    os.path.abspath(k): [int(x) for x in v]
                    for k, v in man.extra.get("db_rowid_hi", {}).items()},
            }
        except Exception as e:          # noqa: BLE001
            tick.ingest_error = f"{type(e).__name__}: {e}"

    # -- stage 3: commit (single writer) -----------------------------------
    def _commit(self, tick: _Tick) -> None:
        """The single-writer tail every tick funnels through: LRU
        recency + evictions, service counters, in-flight slot retirement
        and the ``done`` events — serialized no matter how many ticks
        overlap, so eviction decisions and io bookkeeping never race."""
        width = len(tick.flat)
        self.ticks += 1
        self.widths.append(width)
        self._max_width = max(self._max_width, width)
        self.inflight_hits += tick.borrowed
        lat_ns = max((time.monotonic() - tick.t_admit) * 1e9, 1.0)
        self._lat.counts[0, int(bucket_of(np.asarray([lat_ns]))[0])] += 1
        keys = sorted({slot.summary_key for _, slot in tick.flat
                       if slot.summary_key})
        self.cache.touch(keys)
        evicted = self.cache.evict()
        self.packs.touch(sorted(tick.shards))
        pack_evicted = self.packs.evict()
        # unregister AFTER evicting: a committing tick's own keys stay
        # immune through its own eviction pass
        self.cache.unregister(tick.seq)
        self.packs.unregister(tick.seq)
        tick_info = {"fused_width": width,
                     "batched_fused": width > 1,
                     "n_requests": len(tick.batch),
                     "inflight_hits": tick.borrowed,
                     "evicted": evicted,
                     "pack_evicted": pack_evicted}
        tick.tick_info = tick_info
        if tick.kind == "ingest":
            tick_info["kind"] = "ingest"
            # fence diff + hub publish BEFORE the done events: a caller
            # whose ingest_once returns has its fence push guaranteed
            # to be subscriber-visible already
            if self.ingestor is not None:
                self.ingestor.on_commit(tick)
            tick_info.setdefault(
                "ingest", tick.ingest
                or {"error": tick.ingest_error})
        for p in tick.batch:
            p.tick_info = tick_info
            p.done.set()
        with self._inflight_lock:
            for _, slot in tick.owned:
                if self._inflight.get(slot.key) is slot:
                    del self._inflight[slot.key]
        if tick.release_sem:
            self._depth_sem.release()

    # -- tick drivers ------------------------------------------------------
    def drain_once(self, block_s: float = 0.1) -> int:
        """Run ONE full tick inline (admit -> execute -> commit).
        Returns the number of requests served (0 = queue stayed empty).
        The sequential loop calls this forever; tests call it directly
        for deterministic batching."""
        tick = self._collect(block_s)
        if tick is None:
            return 0
        self._exec_tick(tick)
        self._commit(tick)
        return len(tick.batch)

    def _pipeline_task(self, tick: _Tick) -> None:
        """Executor-stage wrapper: execute, then hand off to the commit
        thread (commit order is completion order — all writes the order
        could matter for already happened inside execute, serialized by
        the pack-writer / atomic summary renames)."""
        try:
            self._exec_tick(tick)
        finally:
            self._commit_q.put(tick)

    def _admit_loop(self) -> None:
        while not self._stop.is_set():
            tick = self._collect(block_s=0.1, eager=True)
            if tick is None:
                continue
            with self._live_lock:
                self._live_ticks += 1
            # bounded pipeline: block admission (backpressure the
            # queue) rather than grow in-flight ticks without limit
            while not self._depth_sem.acquire(timeout=0.1):
                if self._stop.is_set():
                    for p in tick.batch:
                        p.error = (503, "tick_timeout",
                                   "service stopping")
                        p.done.set()
                    with self._live_lock:
                        self._live_ticks -= 1
                    return
            tick.release_sem = True
            self._executor.submit(self._pipeline_task, tick)

    def _commit_loop(self) -> None:
        while True:
            tick = self._commit_q.get()
            if tick is None:
                return
            self._commit(tick)
            with self._live_lock:
                self._live_ticks -= 1

    def _serial_loop(self) -> None:
        while not self._stop.is_set():
            self.drain_once()

    # -- lifecycle ---------------------------------------------------------
    def start(self, serve_http: bool = True) -> "QueryService":
        if self._depth <= 1:
            self._threads = [threading.Thread(
                target=self._serial_loop, daemon=True,
                name="query-service-tick")]
        else:
            self._executor = ThreadPoolExecutor(
                max_workers=self._depth,
                thread_name_prefix="tick-exec")
            self._threads = [
                threading.Thread(target=self._admit_loop, daemon=True,
                                 name="query-service-admit"),
                threading.Thread(target=self._commit_loop, daemon=True,
                                 name="query-service-commit"),
            ]
        for t in self._threads:
            t.start()
        if serve_http:
            handler = _make_handler(self)
            self._server = _Server((self.cfg.host, self.cfg.port),
                                   handler)
            self.cfg.port = self._server.server_address[1]  # port 0 case
            threading.Thread(target=self._server.serve_forever,
                             daemon=True,
                             name="query-service-http").start()
        self._started = True
        if self.ingestor is not None:
            self.ingestor.start()
        return self

    def stop(self) -> None:
        # tailer first: no new ingest ticks enter a draining pipeline
        if self.ingestor is not None:
            self.ingestor.stop()
        self._started = False
        self._stop.set()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        for t in self._threads:
            if t.name != "query-service-commit":
                t.join(timeout=5.0)
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None
        self._commit_q.put(None)         # after executor drain: FIFO
        for t in self._threads:
            if t.name == "query-service-commit":
                t.join(timeout=5.0)
        self._threads = []
        self.scan_pool.close()

    def stats(self) -> Dict:
        widths = list(self.widths)
        return {
            "ticks": self.ticks,
            "requests": self.requests,
            "max_fused_width": self._max_width,
            "mean_fused_width": (float(np.mean(widths)) if widths
                                 else 0.0),
            "tick_p50_ms": float(self._lat.quantile(0.50)[0]) / 1e6,
            "tick_p95_ms": float(self._lat.quantile(0.95)[0]) / 1e6,
            "tick_p99_ms": float(self._lat.quantile(0.99)[0]) / 1e6,
            "inflight_hits": self.inflight_hits,
            "pipeline_depth": self._depth,
            "scan": self.scan_pool.utilization(),
            "evictions": self.cache.evictions,
            "pack_evictions": self.packs.evictions,
            "pack_compactions": self.packs.compactions,
            "io_counts": dict(self.store.io_counts),
            "ingest_requests": self.ingest_requests,
            "ingest": (self.ingestor.stats()
                       if self.ingestor is not None else None),
        }


def _render_result(qr, device: str = "cuda") -> Dict:
    """JSON-safe answer for one query: per-(group, metric) moment
    summary folded over bins, anomaly count when the query fences, and
    the engine's execution provenance. Renders against ``qr.query`` —
    a borrowed in-flight result re-renders exactly for its own caller
    (the anomaly fence runs on the CALLER's first metric, located by
    name in the shared canonical result, through the ``iqr`` kernel on
    ``device``)."""
    res = qr.result
    g = res.grouped
    groups: Dict[str, Dict] = {}
    if g is not None:
        # (n_bins, G, M) moments folded over the bin axis
        cnt = g.count.sum(axis=0)                       # (G, M)
        tot = g.sum.sum(axis=0)
        with np.errstate(invalid="ignore", divide="ignore"):
            mean = np.where(cnt > 0, tot / np.maximum(cnt, 1), 0.0)
        mn = np.where(cnt > 0, np.min(
            np.where(g.count > 0, g.min, np.inf), axis=0), 0.0)
        mx = np.where(cnt > 0, np.max(
            np.where(g.count > 0, g.max, -np.inf), axis=0), 0.0)
        for gi, gk in enumerate(np.asarray(res.group_keys).ravel()):
            groups[f"{float(gk):g}"] = {
                str(m): {"count": int(cnt[gi, mi]),
                         "mean": float(mean[gi, mi]),
                         "min": float(mn[gi, mi]),
                         "max": float(mx[gi, mi])}
                for mi, m in enumerate(res.metrics)}
    out = {
        "query": qr.query.to_spec(),
        "n_samples": int(res.stats.count.sum()),
        "n_bins": int(res.plan.n_shards),
        "group_by": res.group_by,
        "groups": groups,
        "cache_hit": bool(qr.cache_hit),
        "recomputed_shards": int(qr.recomputed_shards),
        "partial_hits": int(qr.partial_hits),
        "shards_pruned": int(qr.shards_pruned),
        "rows_scanned": int(qr.rows_scanned),
        "rows_filtered": int(qr.rows_filtered),
        "provenance": qr.provenance(),
    }
    if qr.query.anomaly_score != "mean":   # non-default: caller wants a fence
        first = qr.query.metrics[0]
        mi = (list(res.metrics).index(first)
              if first in list(res.metrics) else 0)
        rep = report_for_query(res, qr.query, metric_idx=mi, device=device)
        out["anomalous_bins"] = int(np.asarray(rep.flags).sum())
    return out


# legacy unversioned routes -> their /v1/ successors; served by the same
# handlers but stamped with a ``Deprecation`` header (and a ``Link`` to
# the successor) so clients can migrate on their own schedule
_LEGACY_ROUTES = {"/query": "/v1/query",
                  "/stats": "/v1/stats",
                  "/healthz": "/v1/healthz"}


def _make_handler(service: QueryService):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):   # noqa: D102 — quiet server
            pass

        # -- envelope plumbing -------------------------------------------
        def _route(self) -> Tuple[str, bool, Dict[str, List[str]]]:
            """(v1 path, via-legacy-alias?, query params)."""
            parsed = urlparse(self.path)
            path = parsed.path.rstrip("/") or "/"
            legacy = path in _LEGACY_ROUTES
            return (_LEGACY_ROUTES.get(path, path), legacy,
                    parse_qs(parsed.query))

        def _send(self, code: int, payload: Dict,
                  deprecated: bool = False) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if deprecated:
                path = urlparse(self.path).path.rstrip("/")
                self.send_header("Deprecation", "true")
                self.send_header(
                    "Link", f'<{_LEGACY_ROUTES.get(path, path)}>; '
                            'rel="successor-version"')
            self.end_headers()
            self.wfile.write(body)

        def _fail(self, status: int, code: str, message: str,
                  detail=None, deprecated: bool = False) -> None:
            """The one error shape every route speaks: HTTP status +
            ``{"error": {"code", "message", "detail"}}``."""
            self._send(status, {"error": {"code": code,
                                          "message": message,
                                          "detail": detail}},
                       deprecated=deprecated)

        def _body(self):
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n).decode() if n else ""
            return json.loads(raw) if raw else None

        # -- GET ----------------------------------------------------------
        def do_GET(self):               # noqa: N802 (http.server API)
            path, deprecated, params = self._route()
            if path == "/v1/healthz":
                self._send(200, {"ok": True, "api": "v1",
                                 "ingest": service.ingestor is not None},
                           deprecated=deprecated)
            elif path == "/v1/stats":
                self._send(200, service.stats(), deprecated=deprecated)
            elif path == "/v1/stream/fences":
                self._fences(params)
            else:
                self._fail(404, "not_found", f"no route {self.path}")

        def _fences(self, params) -> None:
            """Fence-event subscription: long-poll cursor by default
            (``?since=SEQ&timeout_s=S`` -> ``{"events", "next_since"}``),
            SSE when the client asks for ``text/event-stream``."""
            ing = service.ingestor
            if ing is None:
                self._fail(409, "no_ingest_plane",
                           "no ingest plane is running — attach rank "
                           "DBs via POST /v1/ingest/attach first")
                return
            try:
                since = int(params.get("since", ["0"])[0])
                timeout_s = min(
                    float(params.get("timeout_s", ["30"])[0]),
                    service.cfg.request_timeout_s)
            except ValueError:
                self._fail(400, "bad_request",
                           "since/timeout_s must be numeric")
                return
            accept = self.headers.get("Accept", "")
            if "text/event-stream" in accept or \
                    params.get("sse", ["0"])[0] in ("1", "true"):
                self._sse(ing, since, timeout_s)
                return
            events = ing.hub.wait_since(since, timeout_s)
            self._send(200, {
                "events": events,
                "next_since": events[-1]["seq"] if events else since})

        def _sse(self, ing, since: int, timeout_s: float) -> None:
            """Server-sent events until ``timeout_s`` elapses or the
            client hangs up; each fence event is one ``data:`` frame
            with its seq as the SSE id (clients resume via ?since=)."""
            self.close_connection = True
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            cursor = since
            deadline = time.monotonic() + timeout_s
            try:
                while (time.monotonic() < deadline
                       and not service._stop.is_set()):
                    for e in ing.hub.wait_since(cursor, timeout_s=1.0):
                        frame = (f"id: {e['seq']}\n"
                                 f"event: {e['kind']}\n"
                                 f"data: {json.dumps(e)}\n\n")
                        self.wfile.write(frame.encode())
                        cursor = e["seq"]
                    self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                pass                     # subscriber went away

        # -- POST ---------------------------------------------------------
        def do_POST(self):              # noqa: N802 (http.server API)
            path, deprecated, _ = self._route()
            if path == "/v1/query":
                self._query(deprecated)
            elif path == "/v1/ingest/attach":
                self._attach()
            elif path == "/v1/ingest/detach":
                self._detach()
            else:
                self._fail(404, "not_found", f"no route {self.path}")

        def _query(self, deprecated: bool) -> None:
            try:
                specs = self._body() or []
                if isinstance(specs, dict):
                    specs = [specs]
                queries = [Query.from_spec(s) for s in specs]
            except (ValueError, TypeError, KeyError) as e:
                self._fail(400, "bad_request", f"bad query spec: {e}",
                           deprecated=deprecated)
                return
            try:
                pending = service.submit(queries)
            except BudgetExceeded as e:
                self._fail(413, "budget_exceeded", str(e),
                           detail={"max_cells":
                                   service.cfg.max_cells_per_request},
                           deprecated=deprecated)
                return
            except ValueError as e:
                self._fail(400, "bad_request", str(e),
                           deprecated=deprecated)
                return
            # bounded wait: a tick worker dying mid-tick (or a scan
            # overrunning the deadline) yields 503/tick_timeout, never
            # a handler thread parked on done.wait() forever
            if not pending.done.wait(service.cfg.request_timeout_s):
                self._fail(503, "tick_timeout", "tick timed out",
                           deprecated=deprecated)
                return
            if pending.error is not None:
                status, code, msg = pending.error
                self._fail(status, code, msg, deprecated=deprecated)
                return
            self._send(200, {"results": pending.results,
                             "tick": pending.tick_info},
                       deprecated=deprecated)

        def _db_paths(self):
            body = self._body()
            if (not isinstance(body, dict)
                    or not isinstance(body.get("db_paths"), list)
                    or not all(isinstance(p, str)
                               for p in body["db_paths"])
                    or not body["db_paths"]):
                raise ValueError(
                    'body must be {"db_paths": ["/path/rank0.sqlite", '
                    '...]}')
            return body["db_paths"]

        def _attach(self) -> None:
            try:
                paths = self._db_paths()
            except ValueError as e:
                self._fail(400, "bad_request", str(e))
                return
            ing = service.ensure_ingestor()
            added = ing.attach(paths)
            self._send(200, {
                "attached": added,
                "tailing": ing.attached(),
                "watermarks": {p: list(w)
                               for p, w in ing.watermarks().items()}})

        def _detach(self) -> None:
            try:
                paths = self._db_paths()
            except ValueError as e:
                self._fail(400, "bad_request", str(e))
                return
            ing = service.ingestor
            if ing is None:
                self._fail(409, "no_ingest_plane",
                           "no ingest plane is running")
                return
            removed = ing.detach(paths)
            self._send(200, {"detached": removed,
                             "tailing": ing.attached()})

    return Handler


def main() -> None:
    ap = argparse.ArgumentParser(
        description="serve the declarative Query API over a trace store")
    ap.add_argument("--store", required=True,
                    help="trace-store directory to serve")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8321)
    ap.add_argument("--tick-ms", type=float, default=10.0,
                    help="admission-batch window (one fused plan/tick)")
    ap.add_argument("--backend", default="torch",
                    choices=["serial", "torch"],
                    help="dirty-shard producer: torch = the kernels on "
                         "--device, serial = the exact host scan")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the torch producer and the IQR fences "
                         "run (cuda raises without a card)")
    ap.add_argument("--workers", type=int, default=4,
                    help="concurrency: scan threads per fused plan AND "
                         "max in-flight ticks (1 = the sequential "
                         "single-worker service)")
    ap.add_argument("--max-cells", type=int, default=50_000_000,
                    help="per-request result-cell budget (HTTP 413)")
    ap.add_argument("--summary-budget-mb", type=float, default=256.0,
                    help="summary-store byte budget for LRU eviction "
                         "(0 = unbounded)")
    ap.add_argument("--pack-budget-mb", type=float, default=0.0,
                    help="partial-pack byte budget for LRU "
                         "compaction/eviction (0 = unbounded)")
    ap.add_argument("--attach", nargs="*", default=[], metavar="DB",
                    help="rank DBs to tail from startup (starts the "
                         "streaming ingest plane)")
    ap.add_argument("--poll-ms", type=float, default=25.0,
                    help="ingest tailer watermark-probe cadence")
    args = ap.parse_args()
    cfg = ServiceConfig(
        tick_ms=args.tick_ms, backend=args.backend, device=args.device,
        max_cells_per_request=args.max_cells,
        summary_budget_bytes=(int(args.summary_budget_mb * 1024 * 1024)
                              or None),
        pack_budget_bytes=(int(args.pack_budget_mb * 1024 * 1024)
                           or None),
        scan_workers=args.workers, pipeline_depth=args.workers,
        host=args.host, port=args.port,
        ingest=IngestConfig(poll_ms=args.poll_ms))
    svc = QueryService(args.store, cfg)
    if args.attach:
        svc.ensure_ingestor().attach(args.attach)
    svc.start()
    print(f"query service on http://{cfg.host}:{cfg.port} "
          f"(store={args.store}, tick={cfg.tick_ms}ms, "
          f"backend={cfg.backend}, device={cfg.device}, "
          f"workers={args.workers}, "
          f"tailing={len(args.attach)} DBs)", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        svc.stop()


if __name__ == "__main__":
    main()
