"""End-to-end two-phase variability pipeline (paper §3) on a torch device.

Backends:
  * ``serial`` — exact float64 host scan of the dirty shards.
  * ``torch``  — dirty shards' rows are reduced on ``PipelineConfig.device``
    by the port's CUDA kernels (binstats for the moments, histbin for the
    quantile sketch); see :func:`repro_torch.core.aggregation.compute_lane_partials_torch`.

On both backends phase 3, the IQR fences, runs through the ``iqr`` kernel
on ``PipelineConfig.device``; ranking the flagged bins stays on the host.
The device defaults to ``"cuda"``: a config naming the card on a machine
without one raises when it is built, and never falls back to the CPU.

Both backends run the one-pass multi-metric × group-by engine: set
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

Incremental engine. Both backends aggregate through the two-level cache
in :mod:`repro_torch.core.aggregation`: an unchanged store is answered
from the merged summary; a changed store rescans ONLY the dirty/new
shards and merges them with the clean shards' cached partials —
bit-identical to a cold run on the same backend.
:meth:`VariabilityPipeline.append` closes the automated-workflow loop:
append new trace onto an existing store, delta-aggregate in O(dirty
shards), re-fence anomalies.

Trace diff. :meth:`VariabilityPipeline.diff` answers "what got slower
between run A and run B" with one fused kernel-grouped query per store
on the pipeline's backend (:mod:`repro_torch.core.diff`); the finished
report is cached in store B, keyed apart by the lanes' precision so a
float32 device report never answers an exact ``serial`` diff.
:meth:`serve` and :meth:`stream` put a store behind the v1 query service
and the streaming ingest plane (:mod:`repro_torch.serve`) on the same
backend and device.

The phases and their timings are reported separately (the paper's Fig 1c
plots Data Generation vs Data Aggregation duration vs #ranks).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from ..device import resolve_device
from .aggregation import (AggregationResult, ScanPool, DEFAULT_METRIC,
                          DEFAULT_REDUCERS)
from .query import (Query, QueryPlan, QueryResult, diff_cache_key,
                    diff_query, lane_precision)
from .reducers import normalize_reducers
from .anomaly import (IQRReport, anomalous_bins, is_quantile_score,
                      report_for_query, top_variability_bins)
from .generation import (AppendReport, GenerationConfig, GenerationReport,
                         _resolve_sources, generate_rank,
                         generation_manifest_extra, global_time_range,
                         run_append, run_generation)
from .sharding import ShardPlan, assignment, owner_of_shards
from .tracestore import StoreManifest, TraceStore


@dataclasses.dataclass
class PipelineConfig:
    n_ranks: int = 4
    backend: str = "torch"                 # serial | torch
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
    # torch backend ignores it.
    scan_workers: int = 1

    def __post_init__(self):
        if self.backend not in ("serial", "torch"):
            raise ValueError(f"unknown backend {self.backend!r} "
                             "(serial | torch)")
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


class VariabilityPipeline:
    """Drives phase 1 + phase 2 + anomaly selection over rank SQLite DBs."""

    def __init__(self, cfg: Optional[PipelineConfig] = None):
        self.cfg = cfg or PipelineConfig()
        self._scan_pool: Optional[ScanPool] = None

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

    # -- phase 1 -------------------------------------------------------------
    def generate(self, db_paths: Sequence[str], out_dir: str,
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

        rank_counts = [generate_rank(
            r, sources, plan, rank_shards[r], store, gen,
            contiguous=(gen.partitioning == "block"))
            for r in range(cfg.n_ranks)]

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
                c.get("ingest_rows_skipped", 0) for c in rank_counts))

    # -- phase 2 -------------------------------------------------------------
    def aggregate(self, store_dir: str) -> AggregationResult:
        """Incremental phase 2 on EVERY backend — a thin adapter over the
        declarative query engine: the config's metrics/group_by/reducers
        become one :class:`Query` and run through the same fused
        :func:`~repro_torch.core.aggregation.execute_plan` core as
        :meth:`query` (summary hit → done; otherwise only dirty/new
        shards are recomputed and merged with the clean shards' cached
        partials). The backends plug different dirty-shard producers in:
        the exact host scan, or — torch — one batched kernel launch per
        reducer whose per-shard device partials are cached for the next
        delta."""
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
            tmp = cache_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"store_fingerprint": fp,
                           "report": rep.to_payload()}, f)
            os.replace(tmp, cache_path)
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
            "precision": lane_precision(self.cfg.backend),
        }

    def _run_queries(self, store_dir: str,
                     queries: Sequence[Query]) -> List[QueryResult]:
        cfg = self.cfg
        qplan = QueryPlan.compile(store_dir, list(queries),
                                  backend=cfg.backend,
                                  n_ranks=cfg.n_ranks, device=cfg.device)
        return qplan.execute(use_cache=cfg.use_summary_cache,
                             pool=self.scan_pool)

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
        backend."""
        rep = run_append(db_paths, work_dir)
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
        streaming plane."""
        from ..serve.query_service import QueryService, ServiceConfig
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
        (``client.fences(since)``)."""
        from ..serve.query_service import QueryService, ServiceConfig
        cfg = ServiceConfig(backend=self.cfg.backend, device=self.cfg.device,
                            host=host, port=port, ingest=ingest, **cfg_kw)
        svc = QueryService(str(store_dir), cfg)
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
