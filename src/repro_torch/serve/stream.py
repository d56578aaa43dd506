"""Live streaming ingest plane: tail growing rank DBs into the serving
pipeline, push fence transitions to subscribers.

Append-mode ingest (``run_append``) is pull-style: correct and
incremental, but someone has to call it. This module turns it into a
long-running plane riding the query service's tick pipeline:

Tailer (one thread, rowid watermarks)
    :class:`StreamIngestor` polls every attached rank DB's
    ``rowid_watermark`` (dialect-aware: native synthetic DBs and live
    Nsight/nvprof exports alike, schema sniffed once per path) on a
    cadence. The poll is O(attached DBs) sqlite MAX(rowid) probes —
    independent of store size and of how much data each DB holds. Growth past the last-dispatched watermark schedules
    ONE ingest tick; the next poll waits for its commit, so ingest
    ticks never overlap themselves (``run_append`` journals a staged
    commit and must not race its own journal).

Ingest ticks (a new tick kind in the same pipeline)
    An ingest tick flows through the SAME admission -> executor ->
    single-writer commit pipeline as query ticks
    (:mod:`repro_torch.serve.query_service`). Its executor stage first runs
    the staged-commit ``run_append`` (bounded rowid reads are
    live-writer safe; an interrupted previous tick is rolled forward
    from the intent journal, never double-ingested), then compiles and
    executes the plane's FENCE QUERIES as ordinary owned lanes of a
    fused plan against the freshly extended store — partials for clean
    shards all hit, only dirty/new shards are rescanned, so the
    per-tick cost is O(delta), independent of total store size.
    Concurrent query ticks keep executing throughout: shard publishes
    are atomic renames and partials are fingerprint-validated, the
    torn-write discipline the store's stress tests pin.

Fence diffing + push (commit stage, serialized)
    The commit thread — already the single writer for LRU/counters —
    diffs each fence query's anomalous-bin set against the previous
    tick's and publishes a seq-numbered event to the
    :class:`FenceHub` on any transition (bins added/removed) or
    ingest progress. Subscribers ride ``GET /v1/stream/fences`` as a
    long-poll cursor (``?since=seq``) or SSE; the hub keeps a bounded
    ring, so a slow subscriber loses old events, never stalls the
    plane.

Provenance: every ingest tick records ``rows_ingested``,
``dirty_shards`` and ``event_to_fence_ms`` (detection -> fence-commit
latency, the bound the stream bench gates); aggregates are exposed
under ``/v1/stats`` -> ``"ingest"``.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.anomaly import report_for_query
from repro_torch.core.query import Query
from repro_torch.ingest.cupti_sqlite import rowid_watermark
from repro_torch.core.reducers import QuantileSketch, bucket_of

__all__ = ["DEFAULT_FENCE_QUERY", "FenceHub", "IngestConfig",
           "StreamIngestor"]

# fence the paper's headline variability signal by default: per-bin
# stall-time p99 against IQR fences (the quantile reducer is folded in
# by the canonical form)
DEFAULT_FENCE_QUERY = Query(metrics=("k_stall",), anomaly_score="p99")


@dataclasses.dataclass
class IngestConfig:
    """Knobs of the streaming plane (``ServiceConfig.ingest``)."""

    poll_ms: float = 25.0            # tailer watermark-probe cadence
    fence_queries: Tuple[Query, ...] = ()   # () = DEFAULT_FENCE_QUERY
    max_events: int = 1024           # fence-hub ring size
    max_new_shards: int = 100_000    # run_append far-future guard
    ingest_timeout_s: float = 120.0  # tailer wait on one ingest tick
    iqr_k: float = 1.5
    top_k: int = 5


class FenceHub:
    """Seq-numbered bounded event ring with blocking cursors.

    ``publish`` stamps a monotonically increasing ``seq`` (commit-stage
    single writer); ``wait_since`` parks a subscriber until an event
    past its cursor exists (or timeout) — the long-poll/SSE primitive.
    The ring is bounded: a subscriber slower than ``maxlen`` events
    misses the oldest ones (its next poll returns what remains plus a
    fresh cursor) instead of back-pressuring the ingest plane."""

    def __init__(self, maxlen: int = 1024) -> None:
        self._events: "collections.deque" = collections.deque(
            maxlen=max(1, int(maxlen)))
        self._seq = 0
        self._cond = threading.Condition()

    @property
    def seq(self) -> int:
        with self._cond:
            return self._seq

    def publish(self, event: Dict) -> int:
        with self._cond:
            self._seq += 1
            event = dict(event, seq=self._seq)
            self._events.append(event)
            self._cond.notify_all()
            return self._seq

    def events_since(self, since: int) -> List[Dict]:
        with self._cond:
            return [e for e in self._events if e["seq"] > since]

    def wait_since(self, since: int,
                   timeout_s: float = 30.0) -> List[Dict]:
        """Events past the cursor, blocking up to ``timeout_s`` for the
        first one ([] on timeout — the long-poll contract)."""
        with self._cond:
            self._cond.wait_for(lambda: self._seq > int(since),
                                timeout=max(0.0, timeout_s))
            return [e for e in self._events if e["seq"] > int(since)]


class StreamIngestor:
    """The live ingest plane bolted onto one :class:`QueryService`.

    Not constructed directly in normal use —
    ``QueryService.ensure_ingestor()`` (or ``POST /v1/ingest/attach``,
    or ``VariabilityPipeline.stream``) builds and owns one. The
    ingestor never touches the store itself: all mutation happens
    inside ingest ticks executed by the service pipeline, and all
    bookkeeping here is written by the service's single commit thread
    (:meth:`on_commit`)."""

    def __init__(self, service, cfg: Optional[IngestConfig] = None) -> None:
        self.service = service
        self.cfg = cfg or IngestConfig()
        self.fence_queries: Tuple[Query, ...] = (
            tuple(self.cfg.fence_queries) or (DEFAULT_FENCE_QUERY,))
        self.hub = FenceHub(self.cfg.max_events)
        # abspath -> last-DISPATCHED (kernel, memcpy) rowid watermark;
        # advanced by on_commit from the post-append manifest, so a row
        # is only ever counted "new" until the tick covering it commits
        self._paths: Dict[str, Tuple[int, int]] = {}
        self._paths_lock = threading.Lock()
        self._ingest_lock = threading.Lock()   # one ingest in flight
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # counters — commit-stage single writer (on_commit)
        self._fence_state: Dict[str, Tuple[int, ...]] = {}
        self.ingest_ticks = 0
        self.rows_ingested = 0
        self.fence_transitions = 0
        self.new_shards = 0
        self.dirty_shard_count = 0
        self.recoveries = 0
        self.errors = 0
        self.last_ingest: Dict = {}
        self._e2f = QuantileSketch.zeros(1)    # event->fence latency ns

    # -- attach / detach ---------------------------------------------------
    def attach(self, db_paths: Sequence[str]) -> List[str]:
        """Start tailing ``db_paths``. A DB already known to the store
        manifest resumes from its recorded watermark (only rows past it
        count as growth); a brand-new DB starts at rowid 0 and is
        ingested in full by its first tick. Idempotent; returns the
        newly attached abspaths."""
        man = self.service.man
        recorded = {os.path.abspath(k): tuple(int(x) for x in v)
                    for k, v in man.extra.get("db_rowid_hi", {}).items()}
        added: List[str] = []
        with self._paths_lock:
            for p in db_paths:
                ap = os.path.abspath(p)
                if ap in self._paths:
                    continue
                self._paths[ap] = recorded.get(ap, (0, 0))
                added.append(ap)
        return added

    def detach(self, db_paths: Sequence[str]) -> List[str]:
        removed: List[str] = []
        with self._paths_lock:
            for p in db_paths:
                ap = os.path.abspath(p)
                if self._paths.pop(ap, None) is not None:
                    removed.append(ap)
        return removed

    def attached(self) -> List[str]:
        with self._paths_lock:
            return sorted(self._paths)

    def watermarks(self) -> Dict[str, Tuple[int, int]]:
        with self._paths_lock:
            return dict(self._paths)

    # -- tailer ------------------------------------------------------------
    def poll_once(self) -> List[str]:
        """One watermark probe over every attached DB; returns the paths
        grown past their last-dispatched watermark. O(attached), never
        touches the store."""
        grown: List[str] = []
        for ap, last in sorted(self.watermarks().items()):
            if not os.path.exists(ap):
                continue                    # writer hasn't created it yet
            hi = rowid_watermark(ap)
            if int(hi[0]) > last[0] or int(hi[1]) > last[1]:
                grown.append(ap)
        return grown

    def submit(self, t_detect: Optional[float] = None):
        """Enqueue one ingest tick (all attached DBs) and return its
        pending — the deterministic-test entry point (pair with
        ``service.drain_once()``). ``t_detect`` anchors the
        event-to-fence latency clock; defaults to now."""
        if not self.attached():
            raise ValueError("no rank DBs attached to the ingest plane")
        # a writer may have attached a path before creating the file;
        # tick only over what exists (poll_once skips the rest too)
        paths = [p for p in self.attached() if os.path.exists(p)]
        if not paths:
            raise ValueError("no attached rank DB exists on disk yet")
        return self.service.submit_ingest(
            paths, self.fence_queries,
            t_detect=time.monotonic() if t_detect is None else t_detect,
            max_new_shards=self.cfg.max_new_shards)

    def ingest_once(self, t_detect: Optional[float] = None,
                    timeout_s: Optional[float] = None) -> Dict:
        """Submit one ingest tick and wait for its commit (requires the
        service loops running — ``service.start()``); returns the
        tick's ingest provenance. Serialized: a second caller blocks
        until the first tick commits."""
        with self._ingest_lock:
            pending = self.submit(t_detect)
            if not pending.done.wait(
                    timeout_s or self.cfg.ingest_timeout_s):
                raise TimeoutError("ingest tick did not commit in time")
            if pending.error is not None:
                raise RuntimeError(
                    f"ingest tick failed: {pending.error[2]}")
            return (pending.tick_info or {}).get("ingest", {})

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                grown = self.poll_once()
            except Exception:               # noqa: BLE001 — a vanished
                self.errors += 1            # DB must not kill the tailer
                grown = []
            if grown:
                try:
                    self.ingest_once(t_detect=time.monotonic())
                except Exception:           # noqa: BLE001
                    self.errors += 1
                    self._stop.wait(self.cfg.poll_ms / 1000.0)
            else:
                self._stop.wait(self.cfg.poll_ms / 1000.0)

    def start(self) -> "StreamIngestor":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="stream-ingest-tail")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def quiesce(self, timeout_s: float = 30.0) -> bool:
        """Block until every attached DB's rows are committed (no
        growth past the dispatched watermarks) — the bench/test barrier
        before a bit-identity check against a cold rebuild. Drives
        ingest directly, so it works with or without the tailer
        thread running (the per-tick ingest lock serializes them)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if not self.poll_once():
                with self._ingest_lock:     # let an in-flight tick land
                    pass
                if not self.poll_once():
                    return True
            try:
                self.ingest_once(t_detect=time.monotonic(),
                                 timeout_s=max(
                                     0.1, deadline - time.monotonic()))
            except (TimeoutError, RuntimeError):
                return False
        return not self.poll_once()

    # -- commit-stage hook (single writer: the service commit thread) ------
    def on_commit(self, tick) -> None:
        """Fold one committed ingest tick into the plane: advance
        dispatched watermarks, diff fence states, publish to the hub,
        update counters and the event-to-fence sketch. Runs on the
        service's commit thread — the same serialization point as every
        other cross-tick write."""
        pending = tick.batch[0]
        info = dict(tick.ingest or {})
        now = time.monotonic()
        e2f_ms = ((now - pending.t_detect) * 1e3
                  if pending.t_detect else 0.0)
        info["event_to_fence_ms"] = round(e2f_ms, 3)
        self.ingest_ticks += 1
        if tick.ingest_error is not None:
            self.errors += 1
            info["error"] = tick.ingest_error
            self.last_ingest = info
            if tick.tick_info is not None:
                tick.tick_info["ingest"] = info
            return
        self.rows_ingested += int(info.get("rows_ingested", 0))
        self.new_shards += int(info.get("n_new_shards", 0))
        self.dirty_shard_count += len(info.get("dirty_shards", ()))
        if info.get("recovered"):
            self.recoveries += 1
        self._e2f.counts[0, int(bucket_of(
            np.asarray([max(e2f_ms * 1e6, 1.0)]))[0])] += 1
        # advance the dispatched watermarks to what this tick ingested;
        # rows a live writer landed after the tick's snapshot stay
        # above them and trigger the next poll
        wm = info.get("watermarks", {})
        with self._paths_lock:
            for ap, hi in wm.items():
                if ap in self._paths:
                    self._paths[ap] = tuple(int(x) for x in hi)
        try:
            transitions = self._diff_fences(tick)
        except Exception as e:          # noqa: BLE001
            # a fence that fails (a kernel) fails the tick, not the plane
            self.errors += 1
            info["error"] = f"{type(e).__name__}: {e}"
            pending.error = (500, "fence_failed", info["error"])
            self.last_ingest = info
            if tick.tick_info is not None:
                tick.tick_info["ingest"] = info
            return
        self.fence_transitions += len(transitions)
        event = {
            "kind": "fence" if transitions else "ingest",
            "tick_seq": tick.seq,
            "transitions": transitions,
            "ingest": {k: info.get(k) for k in
                       ("rows_ingested", "dirty_shards", "n_new_shards",
                        "recovered", "event_to_fence_ms", "watermarks")},
        }
        if transitions or info.get("rows_ingested", 0) \
                or info.get("recovered"):
            self.hub.publish(event)
        self.last_ingest = info
        if tick.tick_info is not None:
            tick.tick_info["ingest"] = info

    def _diff_fences(self, tick) -> List[Dict]:
        """Anomalous-bin set transitions for every fence query the tick
        computed (owned slots only — a fence must reflect THIS tick's
        post-append store, never a borrowed pre-append result)."""
        out: List[Dict] = []
        for q, slot in tick.owned:
            if (q.anomaly_score == "mean" or slot.error is not None
                    or slot.qr is None):
                continue
            res = slot.qr.result
            first = q.metrics[0]
            mi = (list(res.metrics).index(first)
                  if first in list(res.metrics) else 0)
            rep = report_for_query(res, q, k=self.cfg.iqr_k,
                                   top_k=self.cfg.top_k, metric_idx=mi,
                                   device=self.service.cfg.device)
            bins = tuple(int(i) for i in
                         np.flatnonzero(np.asarray(rep.flags)))
            qk = q.cache_key()
            prev = self._fence_state.get(qk)
            if prev == bins:
                continue
            prev_set = set(prev or ())
            windows = np.asarray(res.plan.boundaries())
            added = sorted(set(bins) - prev_set)
            out.append({
                "query_key": qk,
                "query": q.to_spec(),
                "score": q.anomaly_score,
                "added": added,
                "removed": sorted(prev_set - set(bins)),
                "anomalous": list(bins),
                "windows_ns": [[int(windows[b]), int(windows[b + 1])]
                               for b in added],
                "hi_fence": float(rep.hi_fence),
            })
            self._fence_state[qk] = bins
        return out

    def fence_state(self) -> Dict[str, Tuple[int, ...]]:
        """Current anomalous-bin set per fence query (by cache key)."""
        return dict(self._fence_state)

    def stats(self) -> Dict:
        return {
            "attached": self.attached(),
            "fence_queries": [q.to_spec() for q in self.fence_queries],
            "ingest_ticks": self.ingest_ticks,
            "rows_ingested": self.rows_ingested,
            "dirty_shards": self.dirty_shard_count,
            "new_shards": self.new_shards,
            "fence_transitions": self.fence_transitions,
            "fence_seq": self.hub.seq,
            "recoveries": self.recoveries,
            "errors": self.errors,
            "event_to_fence_p50_ms": float(
                self._e2f.quantile(0.50)[0]) / 1e6,
            "event_to_fence_p95_ms": float(
                self._e2f.quantile(0.95)[0]) / 1e6,
            "event_to_fence_p99_ms": float(
                self._e2f.quantile(0.99)[0]) / 1e6,
            "last_ingest": self.last_ingest,
        }
