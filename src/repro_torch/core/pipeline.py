"""End-to-end two-phase variability pipeline (paper §3) on a torch device.

Backends:
  * ``serial``  — the rank loop in-process and the exact float64 host
    scan of the dirty shards (debugging / tiny traces).
  * ``process`` — one OS process per rank for phase 1 (faithful MPI-rank
    semantics: private address spaces, exchange through shard files, a
    barrier at the phase boundary; ``multiprocessing`` stands in for
    ``mpirun``), and the exact host scan on a work-stealing process pool.
    This is the paper's execution model.
  * ``torch``   — phase 1 on the same rank pool; dirty shards' rows are
    reduced on ``PipelineConfig.device`` by the port's CUDA kernels
    (binstats for the moments, histbin for the quantile sketch); see
    :func:`repro_torch.core.aggregation.compute_lane_partials_torch`.

On every backend phase 3, the IQR fences, runs through the ``iqr`` kernel
on ``PipelineConfig.device``; ranking the flagged bins stays on the host.
The device defaults to ``"cuda"``: a config naming the card on a machine
without one raises when it is built, and never falls back to the CPU.

Rank pool. ``process`` and ``torch`` build shards through one producer,
``_gen_worker`` (the reference's), one task per rank on
``min(n_ranks, usable CPUs)`` worker processes. Workers start from a
``forkserver`` whose server preloads this module: a fresh interpreter,
never a fork of a caller that may hold a CUDA context and live threads
(earlier kernel launches, a query service's executors and ``ScanPool``
threads), and torch is imported once per server rather than once per
worker. A worker never touches CUDA; each reports whether CUDA was
initialised in it, and the call raises if it was. A pool that cannot
start, a worker that dies and a worker that raises each make the call
raise: nothing falls back to the in-process loop. The server, and the
resource tracker started beside it, are stopped and reaped before the
process that started them exits (or by :func:`stop_rank_pool_server`), so
no process of a pool outlives its caller. As with any pool whose
workers do not fork the caller, a script that runs the ``process`` or
``torch`` backend guards its entry with ``if __name__ == "__main__":``.

All backends run the one-pass multi-metric × group-by engine: set
``PipelineConfig.metrics`` / ``group_by`` / ``reducers`` and a single scan
of the shard store yields a (n_bins, n_groups, n_metrics) tensor per
reducer — moments always, plus the quantile sketch when requested.
``anomaly_score`` picks what the IQR fences run on: a moment score
("mean"/"std"/...) or a distribution score ("p99"/"iqr"/...).

Declarative queries. :meth:`VariabilityPipeline.query` runs a BATCH of
:class:`~repro_torch.core.query.Query` objects as ONE fused execution:
shared shard scan with predicates pushed down, per-query reducer lanes
riding the same pass, each result bit-identical to running that query
alone and fenced on its own score spec. :meth:`aggregate` is the
config-shaped adapter over the same engine (``PipelineConfig.to_query``),
so config-style and Query-style analyses share one cache.

Incremental engine. Every backend aggregates through the two-level cache
in :mod:`repro_torch.core.aggregation`: an unchanged store is answered
from the merged summary; a changed store rescans ONLY the dirty/new
shards and merges them with the clean shards' cached partials —
bit-identical to a cold run on the same backend. The backends differ only
in the dirty-shard producer: an in-process loop (serial), the
work-stealing pool below (process), or one batched kernel launch per
reducer (torch). ``serial`` and ``process`` share the exact cache
namespace; torch results live in their own.
:meth:`VariabilityPipeline.append` closes the automated-workflow loop:
append new trace onto an existing store, delta-aggregate in O(dirty
shards), re-fence anomalies.

Scheduling. The process backend's aggregation phase is a work-stealing
chunked queue (small shard chunks taken in completion order), not a static
per-rank block — a straggler shard delays only its own chunk. Partials
are merged in shard-index order regardless of completion order, so the
result is bit-identical to ``serial``.

Trace diff. :meth:`VariabilityPipeline.diff` answers "what got slower
between run A and run B" with one fused kernel-grouped query per store
on the pipeline's backend (:mod:`repro_torch.core.diff`); the finished
report is cached in store B, keyed apart by the lanes' precision so a
float32 device report never answers an exact diff.
:meth:`serve` and :meth:`stream` put a store behind the v1 query service
and the streaming ingest plane (:mod:`repro_torch.serve`) on the same
backend and device.

Process groups. Inside a ``torch.distributed`` group of P > 1 ranks (one
process a rank, set up by the caller), every rank calls the same method on
the same store and gets the same result: phase 1 (``generate``, ``run``,
``append``) runs on rank 0's rank pool while the others wait; phase 2 on
the ``torch`` backend splits each dirty shard's rows across the ranks and
merges their tables (:mod:`repro_torch.core.distributed`); phase 3's
fences run on every rank over the replicated table; rank 0 alone writes
the store (partial packs, summaries, the diff cache), each write followed
by a barrier (:mod:`repro_torch.core.group`). ``serial`` and ``process``,
``serve`` and ``stream`` raise there (ROADMAP.md); nothing falls back to
one rank.

The phases and their timings are reported separately (the paper's Fig 1c
plots Data Generation vs Data Aggregation duration vs #ranks).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import gc
import multiprocessing as mp
import os
import resource
import threading
from multiprocessing import util as mp_util
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from .aggregation import (AggregationResult, ScanPool,
                          compute_lane_partials, DEFAULT_METRIC,
                          DEFAULT_REDUCERS)
from .query import (LanePlan, Query, QueryPlan, QueryResult,
                    diff_cache_key, diff_query, lane_precision)
from .reducers import normalize_reducers
from .anomaly import (IQRReport, anomalous_bins, is_quantile_score,
                      report_for_query, top_variability_bins)
from .group import _world_size, on_rank0, refuse_in_group
from .generation import (AppendReport, GenerationConfig, GenerationReport,
                         _resolve_sources, generate_rank,
                         generation_manifest_extra, global_time_range,
                         run_append, run_generation)
from .sharding import ShardPlan, assignment, owner_of_shards
from .tracestore import StoreManifest, TraceStore


@dataclasses.dataclass
class PipelineConfig:
    n_ranks: int = 4
    backend: str = "torch"                 # serial | process | torch
    device: str = "cuda"                   # torch reduction + IQR fences
    generation: GenerationConfig = dataclasses.field(
        default_factory=GenerationConfig)
    metric: str = DEFAULT_METRIC
    metrics: Optional[Sequence[str]] = None  # multi-metric single pass
    group_by: Optional[str] = None           # shard column, e.g. "k_device"
    reducers: Sequence[str] = DEFAULT_REDUCERS  # statistic suite
    use_summary_cache: bool = True
    agg_interval_ns: Optional[int] = None  # None -> reuse generation bins
    iqr_k: float = 1.5
    top_k: int = 5
    # per-bin score the IQR fences run on: "mean"/"std"/"max"/"sum"
    # (moments) or "p50"/"p95"/"p99"/"iqr" (needs "quantile" in reducers)
    anomaly_score: str = "mean"
    # scan workers for the SERIAL backend's fused dirty-shard scan:
    # 1 = inline (default, the historical behavior), 0 = one per CPU,
    # N > 1 = that many threads. The pool is spawned once per pipeline
    # lifetime (see VariabilityPipeline.scan_pool) and its single
    # pack-writer thread serializes all partial-cache appends; the
    # process and torch backends bring their own parallelism and ignore it.
    scan_workers: int = 1

    def __post_init__(self):
        if self.backend not in ("serial", "process", "torch"):
            raise ValueError(f"unknown backend {self.backend!r} "
                             "(serial | process | torch)")
        resolve_device(self.device)

    @property
    def metric_list(self) -> List[str]:
        return list(self.metrics) if self.metrics else [self.metric]

    @property
    def reducer_suite(self) -> tuple:
        """Normalized suite; a quantile-family ``anomaly_score`` pulls the
        "quantile" reducer in automatically so a self-inconsistent config
        cannot burn a full generate+aggregate before failing in run()."""
        extra = (("quantile",) if is_quantile_score(self.anomaly_score)
                 else ())
        return normalize_reducers(tuple(self.reducers) + extra)

    def to_query(self) -> Query:
        """The declarative Query this config's aggregation settings
        describe — the back-compat shim that makes config-style and
        Query-style analyses share one engine and one cache (the Query's
        canonical form folds the anomaly score's implied reducer in,
        mirroring :attr:`reducer_suite`)."""
        return Query(metrics=tuple(self.metric_list),
                     group_by=self.group_by,
                     reducers=tuple(self.reducers),
                     anomaly_score=self.anomaly_score,
                     interval_ns=self.agg_interval_ns)


@dataclasses.dataclass
class PipelineResult:
    # a full generation's report, or an AppendReport from append()
    generation: Union[GenerationReport, AppendReport]
    aggregation: AggregationResult
    anomalies: IQRReport
    top_variability: np.ndarray
    gen_seconds: float
    agg_seconds: float

    @property
    def anomaly_windows(self) -> np.ndarray:
        return self.anomalies.top_windows


# --- the rank pool (module-level workers, so they pickle by name) ----------

# See the module docstring: a fresh interpreter that imported this module
# once, never a fork of a caller holding a CUDA context or threads.
_START_METHOD = "forkserver"
_PRELOAD = ["repro_torch.core.pipeline"]
# the directory holding the repro_torch package
_IMPORT_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SERVER_LOCK = threading.Lock()
# the pid whose forkserver this module started and will stop, else None
_SERVER_OWNER: Optional[int] = None
_STOP_AT_EXIT = False                 # the exit hook is registered


def _usable_cpus() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:             # no affinity API on this platform
        return os.cpu_count() or 1


def _start_forkserver() -> None:
    """Start the forkserver, if it is not running, able to import this
    package. Some Pythons (3.12.3 among them) start the server without the
    caller's ``sys.path``, only its environment, and drop a preload that
    fails to import: every worker would then import torch itself. So the
    package's root rides ``PYTHONPATH`` while the server starts, and the
    caller's environment is restored before this returns."""
    from multiprocessing import forkserver
    global _SERVER_OWNER, _STOP_AT_EXIT
    with _SERVER_LOCK:
        old = os.environ.get("PYTHONPATH")
        os.environ["PYTHONPATH"] = os.pathsep.join(
            [_IMPORT_ROOT] + ([old] if old else []))
        try:
            forkserver.ensure_running()
            if not _STOP_AT_EXIT:
                # below 0: after the semaphores' finalizers; above -100:
                # before multiprocessing removes the server's socket dir
                mp_util.Finalize(None, stop_rank_pool_server,
                                 exitpriority=-50)
                _STOP_AT_EXIT = True
            _SERVER_OWNER = os.getpid()
        finally:
            if old is None:
                del os.environ["PYTHONPATH"]
            else:
                os.environ["PYTHONPATH"] = old


def stop_rank_pool_server() -> None:
    """Stop the forkserver this process started for its rank pools, and the
    resource tracker started beside it, and wait for both to exit; a later
    pool starts them afresh. Call it with no pool of this process open. It
    also runs at interpreter exit, after multiprocessing's own finalizers
    have released the pools' semaphores, so neither server outlives its
    caller."""
    from multiprocessing import forkserver, resource_tracker
    global _SERVER_OWNER
    with _SERVER_LOCK:
        if _SERVER_OWNER != os.getpid():   # another process's servers
            return
        gc.collect()            # executors caught in cycles free semaphores
        forkserver._forkserver._stop()
        resource_tracker._resource_tracker._stop()
        _SERVER_OWNER = None


def _rank_pool(n_ranks: int) -> concurrent.futures.ProcessPoolExecutor:
    """``min(n_ranks, usable CPUs)`` worker processes. An executor, not a
    ``multiprocessing.Pool``: a worker that dies (killed, or failing to
    start) breaks the executor and the call raises, where a ``Pool``
    would replace the worker and wait forever."""
    ctx = mp.get_context(_START_METHOD)
    if _START_METHOD == "forkserver":
        ctx.set_forkserver_preload(_PRELOAD)
        _start_forkserver()
    return concurrent.futures.ProcessPoolExecutor(
        min(n_ranks, _usable_cpus()), mp_context=ctx)


def _worker_record() -> Dict[str, Any]:
    """Who ran a pool task: its pid, whether CUDA was ever initialised in
    it, and its peak resident set (KiB, shared pages included)."""
    return {"pid": os.getpid(),
            "cuda_initialized": bool(torch.cuda.is_initialized()),
            "max_rss_kib": int(
                resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)}


def _checked(workers: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    touched = sorted({w["pid"] for w in workers if w["cuda_initialized"]})
    if touched:
        raise RuntimeError(f"pool workers {touched} initialised CUDA; a "
                           "rank worker must stay on the host")
    return workers


def _gen_worker(args):
    """One rank's phase 1 in a pool worker: ``(counts, worker record)``."""
    rank, db_paths, plan_tuple, shard_ids, out_dir, cfg_dict = args
    plan = ShardPlan(*plan_tuple)
    cfg = GenerationConfig(**cfg_dict)
    store = TraceStore(out_dir)
    counts = generate_rank(rank, db_paths, plan, np.asarray(shard_ids),
                           store, cfg,
                           contiguous=(cfg.partitioning == "block"))
    return counts, _worker_record()


def _fused_worker(args):
    """One work-queue chunk of the FUSED query batch: each shard file in
    the chunk is read once and every query lane that marked it dirty
    reduces its own metrics/groups/predicates off the shared columns
    (the same :func:`compute_lane_partials` producer the serial backend
    runs, background writer thread included); with a lane ``qkey`` set,
    its partial is atomically persisted as soon as it is produced
    (crash-safe: a dying worker leaves complete cache entries or none).
    Returns ``({lane index -> [ShardPartial]}, worker record)``."""
    store_dir, chunk, lane_specs = args
    store = TraceStore(store_dir)
    lanes = [LanePlan(query=query, plan=ShardPlan(*plan_t),
                      metrics=tuple(metrics), reducers=tuple(reducers),
                      precision="exact", summary_key=None,
                      qkey=qkey or "", pruned=None, shards_pruned=0)
             for plan_t, metrics, reducers, qkey, query in lane_specs]
    parts = dict(compute_lane_partials(store, chunk, lanes, persist=True))
    return parts, _worker_record()


class VariabilityPipeline:
    """Drives phase 1 + phase 2 + anomaly selection over rank SQLite DBs."""

    def __init__(self, cfg: Optional[PipelineConfig] = None):
        self.cfg = cfg or PipelineConfig()
        self._scan_pool: Optional[ScanPool] = None
        # records of the workers of this pipeline's last process-backend
        # scan (see _worker_record); empty until one ran
        self.scan_workers: List[Dict[str, Any]] = []

    @property
    def scan_pool(self) -> Optional[ScanPool]:
        """The pipeline-lifetime :class:`ScanPool` the serial backend's
        fused scans share (``cfg.scan_workers != 1``), created on first
        use — ONE pool per pipeline, never per call, so worker threads
        and the single pack-writer persist across queries/appends.
        ``None`` when the config keeps the inline scan."""
        if self.cfg.backend != "serial" or self.cfg.scan_workers == 1:
            return None
        if self._scan_pool is None:
            self._scan_pool = ScanPool(self.cfg.scan_workers)
        return self._scan_pool

    def close(self) -> None:
        """Release the scan pool's threads (idempotent)."""
        if self._scan_pool is not None:
            self._scan_pool.close()
            self._scan_pool = None

    def __enter__(self) -> "VariabilityPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- process-group checks ------------------------------------------------
    def _check_group(self, what: str) -> None:
        """Inside a group of P > 1 ranks only the torch backend runs."""
        if self.cfg.backend != "torch":
            refuse_in_group(f"{what} on the {self.cfg.backend!r} backend")

    # -- phase 1 -------------------------------------------------------------
    def generate(self, db_paths: Sequence[str], out_dir: str,
                 ) -> GenerationReport:
        """Phase 1 into ``out_dir``. In a group of P > 1 ranks it runs on
        rank 0 (on its rank pool) while the other ranks wait, and every
        rank returns rank 0's report."""
        self._check_group("phase 1")
        return on_rank0(lambda: self._generate(db_paths, out_dir),
                        "phase 1")

    def _generate(self, db_paths: Sequence[str], out_dir: str,
                  ) -> GenerationReport:
        cfg, gen = self.cfg, self.cfg.generation
        t0 = time.perf_counter()
        # one sniff per source here; workers re-resolve from the pickled
        # sources without re-sniffing (pass-through in as_trace_source)
        sources = _resolve_sources(db_paths, gen)
        lo, hi = global_time_range(sources)
        plan = (ShardPlan(lo, hi, gen.n_shards) if gen.n_shards is not None
                else ShardPlan.from_interval(lo, hi, gen.interval_ns))
        store = TraceStore(out_dir)
        rank_shards = assignment(plan.n_shards, cfg.n_ranks,
                                 gen.partitioning)

        workers: List[Dict[str, Any]] = []
        if cfg.backend == "serial":
            rank_counts = [generate_rank(
                r, sources, plan, rank_shards[r], store, gen,
                contiguous=(gen.partitioning == "block"))
                for r in range(cfg.n_ranks)]
        else:
            jobs = [(r, list(sources),
                     (plan.t_start, plan.t_end, plan.n_shards),
                     rank_shards[r].tolist(), out_dir,
                     dataclasses.asdict(gen))
                    for r in range(cfg.n_ranks)]
            with _rank_pool(cfg.n_ranks) as pool:
                out = list(pool.map(_gen_worker, jobs))
            rank_counts = [c for c, _ in out]
            workers = _checked([w for _, w in out])

        owner = owner_of_shards(plan.n_shards, cfg.n_ranks, gen.partitioning)
        from .generation import SHARD_COLUMNS
        store.write_manifest(StoreManifest(
            t_start=plan.t_start, t_end=plan.t_end, n_shards=plan.n_shards,
            n_ranks=cfg.n_ranks, partitioning=gen.partitioning,
            columns=SHARD_COLUMNS, shard_owner=owner.tolist(),
            extra=generation_manifest_extra(sources, gen)))

        # Table-1 inventory straight from the rank workers — the rank range
        # queries partition the kernel/memcpy tables, so their counts sum
        # exactly; no second full read of every DB.
        rows = {"KERNEL": sum(c["KERNEL"] for c in rank_counts),
                "MEMCPY": sum(c["MEMCPY"] for c in rank_counts),
                "GPU": max((c["GPU"] for c in rank_counts), default=0)}
        return GenerationReport(
            n_shards=plan.n_shards, n_ranks=cfg.n_ranks,
            t_start=plan.t_start, t_end=plan.t_end, rows_per_table=rows,
            joined_rows=sum(c["joined"] for c in rank_counts),
            seconds=time.perf_counter() - t0,
            ingest_rows_read=sum(
                c.get("ingest_rows_read", 0) for c in rank_counts),
            ingest_rows_skipped=sum(
                c.get("ingest_rows_skipped", 0) for c in rank_counts),
            workers=workers)

    # -- phase 2 -------------------------------------------------------------
    def aggregate(self, store_dir: str) -> AggregationResult:
        """Incremental phase 2 on EVERY backend — a thin adapter over the
        declarative query engine: the config's metrics/group_by/reducers
        become one :class:`Query` and run through the same fused
        :func:`~repro_torch.core.aggregation.execute_plan` core as
        :meth:`query` (summary hit → done; otherwise only dirty/new
        shards are recomputed and merged with the clean shards' cached
        partials). The backends plug different dirty-shard producers in:
        the exact host scan in-process (serial) or on the work-stealing
        process pool (process), or — torch — one batched kernel launch
        per reducer whose per-shard device partials are cached for the
        next delta."""
        return self._run_queries(store_dir,
                                 [self.cfg.to_query()])[0].result

    def query(self, store_dir: str,
              queries: Sequence[Query]) -> List[QueryResult]:
        """Run a BATCH of declarative queries as one fused execution:
        shared shard scan (each dirty file read once, every query's
        reducer lanes riding the same pass, time-window predicates pushed
        down to shard pruning and row predicates into the scan), per-
        query results split back out with provenance — each bit-identical
        to running that query alone on the same backend. Every result's
        ``anomalies`` is fenced on ITS query's ``anomaly_score`` spec."""
        out = self._run_queries(store_dir, list(queries))
        for qr in out:
            qr.anomalies = report_for_query(qr.result, qr.query,
                                            k=self.cfg.iqr_k,
                                            top_k=self.cfg.top_k,
                                            device=self.cfg.device)
        return out

    def diff(self, store_a: str, store_b: str,
             query: Optional[Query] = None, thresholds=None):
        """Two-store trace diff with a CI-consumable verdict: "what got
        slower between run A and run B, where, and is it bad enough to
        fail the job?" (see :mod:`repro_torch.core.diff`).

        Each store is answered by ONE fused kernel-grouped query
        (:func:`~repro_torch.core.query.diff_query` derived from ``query``
        / the config) on this pipeline's backend and device — a warm
        store serves it from the summary cache with zero shard reads, a
        cold one costs exactly one dirty-shard scan (on the torch
        backend, one ``binstats_flat`` and one ``histbin_flat`` launch);
        the per-store read counts land in the report
        (``shard_reads_a/b``). Alignment, shift scoring and the verdict
        are pure host post-processing of the two results.

        Repeated diffs skip even that: the finished report is persisted
        in a diff-result cache in store B's root
        (``diff_{diff_cache_key}.json``), validated against BOTH stores'
        shard fingerprints, the thresholds and the lanes' precision — an
        unchanged repeat on the same backend loads the report without
        running a single query (``from_cache`` / ``provenance()``), while
        a diff on the other backend recomputes. Disabled along with the
        rest of the caches by ``use_summary_cache=False``.
        """
        from .diff import DiffReport, diff_results
        self._check_group("diff")
        t0 = time.perf_counter()
        base = query if query is not None else self.cfg.to_query()
        dq = diff_query(base)
        key = diff_cache_key(dq, dq)
        cache_path = os.path.join(str(store_b), f"diff_{key}.json")
        fp = None
        if self.cfg.use_summary_cache:
            fp = self._diff_fingerprint(store_a, store_b, thresholds)
            try:
                with open(cache_path) as f:
                    payload = json.load(f)
                if payload.get("store_fingerprint") == fp:
                    rep = DiffReport.from_payload(payload["report"])
                    rep.seconds = time.perf_counter() - t0
                    return rep
            except (OSError, ValueError, KeyError, TypeError):
                pass                   # stale/corrupt cache: recompute
        sides = []
        for sd in (store_a, store_b):
            qplan = QueryPlan.compile(sd, [dq], backend=self.cfg.backend,
                                      n_ranks=self.cfg.n_ranks,
                                      device=self.cfg.device)
            res = qplan.execute(use_cache=self.cfg.use_summary_cache,
                                compute_fn=self._compute_fn(),
                                pool=self.scan_pool)[0]
            names = {int(i): str(n) for i, n in
                     qplan.store.read_manifest().extra.get(
                         "kernel_names", {}).items()}
            sides.append((res, names,
                          int(qplan.store.io_counts["shard_reads"])))
        (res_a, names_a, reads_a), (res_b, names_b, reads_b) = sides
        rep = diff_results(
            res_a.result, res_b.result, metric=base.metrics[0],
            names_a=names_a, names_b=names_b, thresholds=thresholds,
            store_a=str(store_a), store_b=str(store_b),
            key=key,
            shard_reads_a=reads_a, shard_reads_b=reads_b,
            seconds=time.perf_counter() - t0)
        if fp is not None:
            def write():
                tmp = cache_path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump({"store_fingerprint": fp,
                               "report": rep.to_payload()}, f)
                os.replace(tmp, cache_path)
            on_rank0(write, "the diff cache write")  # rank 0 writes
        return rep

    def _diff_fingerprint(self, store_a: str, store_b: str,
                          thresholds) -> Dict:
        """Validity token for one persisted diff report: any shard
        rewrite/append on EITHER store, a different A-store path,
        different thresholds or another lane precision (the backend's
        float32 device path against the exact host path) must miss (the
        report's query identity is already in the cache filename via
        ``diff_cache_key``). The reference's token has no precision; a
        float32 report could answer an exact diff there."""
        return {
            "paths": [os.path.abspath(str(store_a)),
                      os.path.abspath(str(store_b))],
            "shards": [[list(t) for t in
                        TraceStore(s).shard_fingerprint()]
                       for s in (store_a, store_b)],
            "thresholds": (None if thresholds is None
                           else thresholds.to_dict()),
            "precision": lane_precision(self.cfg.backend, _world_size()),
        }

    def _run_queries(self, store_dir: str,
                     queries: Sequence[Query]) -> List[QueryResult]:
        self._check_group("phase 2")
        cfg = self.cfg
        qplan = QueryPlan.compile(store_dir, list(queries),
                                  backend=cfg.backend,
                                  n_ranks=cfg.n_ranks, device=cfg.device)
        return qplan.execute(use_cache=cfg.use_summary_cache,
                             compute_fn=self._compute_fn(),
                             pool=self.scan_pool)

    def _compute_fn(self):
        return self._pool_compute if self.cfg.backend == "process" else None

    def _pool_compute(self, work_items, qplan: QueryPlan, persist: bool):
        """Work-stealing scheduler for the fused dirty-shard scan: the
        (shard, lanes) work list is split into small chunks that idle
        workers take from the executor's shared queue, so a straggler
        chunk — an anomaly-burst shard with 10x the rows — delays only
        itself, not a whole static rank block. Completion order is
        irrelevant: the merge folds partials in shard-index order, so the
        result is bit-identical to the serial backend."""
        self.scan_workers = []
        if not work_items:
            return {}
        lane_specs = [
            ((lane.plan.t_start, lane.plan.t_end, lane.plan.n_shards),
             list(lane.metrics), lane.reducers,
             lane.qkey if persist else None, lane.query)
            for lane in qplan.lanes]
        workers = min(self.cfg.n_ranks, _usable_cpus())
        # ~4 chunks per worker: fine enough to absorb skew, coarse enough
        # to amortize task dispatch
        chunk = max(1, -(-len(work_items) // (workers * 4)))
        jobs = [(qplan.store.root, work_items[i:i + chunk], lane_specs)
                for i in range(0, len(work_items), chunk)]
        out: Dict[int, List] = {}
        records = []
        with _rank_pool(self.cfg.n_ranks) as pool:
            futures = [pool.submit(_fused_worker, job) for job in jobs]
            for fut in concurrent.futures.as_completed(futures):
                res, record = fut.result()
                records.append(record)
                for li, parts in res.items():
                    out.setdefault(li, []).extend(parts)
        self.scan_workers = _checked(records)
        return out

    # -- end to end ----------------------------------------------------------
    def run(self, db_paths: Sequence[str], work_dir: str) -> PipelineResult:
        gen = self.generate(db_paths, work_dir)
        return self._analyze(gen, work_dir)

    def append(self, db_paths: Sequence[str],
               work_dir: str) -> PipelineResult:
        """The automated-workflow loop: append new trace data (grown rank
        DBs and/or late-arriving ones) onto the EXISTING store in
        ``work_dir``, delta-aggregate — clean shards come from the
        partial cache, only dirty/new shard files are rescanned — and
        re-fence the anomalies. End-to-end O(dirty shards); the refreshed
        result is bit-identical to a cold full re-analysis on the same
        backend. In a group of P > 1 ranks the append runs on rank 0
        while the other ranks wait, and the delta runs on every rank."""
        self._check_group("append")
        rep = on_rank0(lambda: run_append(db_paths, work_dir),
                       "phase 1 (append)")
        return self._analyze(rep, work_dir)

    def serve(self, store_dir: str, host: str = "127.0.0.1",
              port: int = 0, serve_http: bool = True, ingest=None,
              **cfg_kw):
        """Put the store behind the versioned v1 HTTP service (see
        :mod:`repro_torch.serve.query_service`) on this pipeline's
        backend and device and return the STARTED
        :class:`~repro_torch.serve.QueryService` (``port=0`` picks a free
        port — read it back from ``svc.cfg.port``; pair with
        ``svc.stop()``). Extra keyword arguments land on
        :class:`~repro_torch.serve.ServiceConfig`; ``ingest`` is an
        optional :class:`~repro_torch.serve.IngestConfig` for the
        streaming plane.

        In a group of P > 1 ranks (torch backend only) every rank calls
        this with the same arguments: rank 0 gets the service (the HTTP
        server, admission, commit), every other rank a follower that
        executes each of rank 0's ticks with it; a follower's ``stop()``
        (or ``join()``) returns once rank 0's ``stop()`` has ended it."""
        from ..serve.query_service import QueryService, ServiceConfig
        self._check_group("serving")
        cfg = ServiceConfig(backend=self.cfg.backend, device=self.cfg.device,
                            host=host, port=port, ingest=ingest, **cfg_kw)
        return QueryService(str(store_dir), cfg).start(
            serve_http=serve_http)

    def stream(self, store_dir: str, db_paths: Sequence[str],
               host: str = "127.0.0.1", port: int = 0,
               serve_http: bool = True, ingest=None, **cfg_kw):
        """:meth:`serve` plus the live streaming ingest plane: the
        returned service is already tailing ``db_paths`` — rank-DB
        growth past the recorded rowid watermarks becomes ingest ticks
        (staged-commit ``run_append`` + delta re-aggregation of the
        fence queries on the pipeline's backend and device), and fence
        transitions stream from ``GET /v1/stream/fences``. Subscribe
        with :class:`~repro_torch.serve.QueryClient`
        (``client.fences(since)``). In a group of P > 1 ranks, as
        :meth:`serve`: the tailer runs on rank 0, and every rank
        executes each ingest tick's fence lanes after rank 0's append."""
        from ..serve.query_service import QueryService, ServiceConfig
        self._check_group("streaming")
        cfg = ServiceConfig(backend=self.cfg.backend, device=self.cfg.device,
                            host=host, port=port, ingest=ingest, **cfg_kw)
        svc = QueryService(str(store_dir), cfg)
        if svc.rank == 0:
            svc.ensure_ingestor().attach(list(db_paths))
        return svc.start(serve_http=serve_http)

    def _analyze(self, gen: Union[GenerationReport, AppendReport],
                 work_dir: str) -> PipelineResult:
        agg = self.aggregate(work_dir)
        bounds = agg.plan.boundaries()
        report = anomalous_bins(agg, k=self.cfg.iqr_k,
                                top_k=self.cfg.top_k, boundaries=bounds,
                                score=self.cfg.anomaly_score,
                                device=self.cfg.device)
        topvar = top_variability_bins(agg.stats)
        return PipelineResult(
            generation=gen, aggregation=agg, anomalies=report,
            top_variability=topvar,
            gen_seconds=gen.seconds, agg_seconds=agg.seconds)
