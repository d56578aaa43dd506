"""Declarative query layer — canonical plans, pushdown, multi-query fusion.

The paper's promise is *low-latency exploration* of high-dimensional trace
data, and an exploration session is many questions, not one: different
metric subsets, group columns, time windows, rank / kernel / transfer-kind
filters, asked concurrently over the same store. This module gives that
session a first-class surface:

:class:`Query`
    A frozen, declarative description of one question: metrics, group_by,
    reducer suite, time window, rank subset, kernel-name / transfer-kind
    predicates, anomaly-score spec, optional re-binning interval. Its
    **canonical serialized form** (:meth:`Query.canonical`) is
    order-insensitive in metrics and reducers, folds the anomaly score's
    implied reducer into the suite, and is version-stamped — and its hash
    is THE cache key for summaries and per-shard partials (the
    :class:`~repro_torch.core.tracestore.TraceStore` key methods build their
    blobs from it). ``metrics=("a", "b")`` and ``("b", "a")`` therefore
    share one summary and one partial per shard; the engine always
    computes and caches in canonical metric order and permutes the
    finished tensors back to the caller's order (exact: per-metric
    accumulation is independent, so a permutation is bit-preserving).

:class:`QueryPlan`
    The planner: compiles a *batch* of queries into one fused execution.
    Per query (a *lane*) it resolves the bin plan, canonical metric /
    reducer order, summary + partial cache keys, and pushes the
    time-window predicate down to **shard-range pruning** (only shard
    files whose time span intersects the window are ever read); the
    row predicates (rank / kernel-name / transfer-kind / exact window
    bounds) are pushed into the shard scan as a row mask applied before
    binning. Execution (:func:`repro_torch.core.aggregation.execute_plan`)
    shares ONE read of every needed shard across all lanes — per-query
    reducer lanes ride the same pass — and splits per-query results back
    out with provenance (:class:`QueryResult`: cache hit, shards pruned,
    rows filtered, partial hits).

Predicate semantics match a scan-then-mask oracle exactly: a filtered
aggregation equals an unfiltered aggregation over a store holding only
the mask-passing rows (tested). Rows are kernel-anchored — the time
window and all predicates select *rows* (joined kernel×memcpy entities)
by their kernel columns / transfer kind, and the Fig-1b byte breakdown
is accumulated over the same masked rows. Shard pruning accounts for the
binning clip: the first shard file covers ``(-inf, b1)`` and the last
``[b_{n-1}, +inf)``, because out-of-range timestamps were clipped into
them at generation time.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .group import _world_size
from .reducers import normalize_reducers
from .sharding import ShardPlan

__all__ = [
    "SUMMARY_VERSION", "DEFAULT_METRIC", "Query", "QueryPlan", "LanePlan",
    "QueryResult", "is_quantile_score", "lane_precision",
    "diff_query", "diff_cache_key", "diff_spec", "diff_from_spec",
]

# Bump when the summary/partial payload layout OR the cache-key scheme
# changes; old caches miss gracefully and are swept by gc_stale.
# v2: pluggable reducer suite payloads.
# v3: incremental engine — summaries record ``covered`` fingerprints.
# v4: declarative Query API — keys hash the canonical query form
#     (order-insensitive metrics/reducers, predicates included), and
#     payload tensors are stored in canonical metric order.
SUMMARY_VERSION = 4

DEFAULT_METRIC = "k_stall"            # memory-stall ns — the Fig-1a metric

_PCT_RE = re.compile(r"^p(\d{1,2}(?:\.\d+)?)$")


def is_quantile_score(score: str) -> bool:
    """True for scores answered by the quantile sketch ("pNN" / "iqr")."""
    return score == "iqr" or _PCT_RE.match(score) is not None


def _int_tuple(v) -> Tuple[int, ...]:
    return tuple(int(x) for x in v)


@dataclasses.dataclass(frozen=True)
class Query:
    """One declarative question over a trace store.

    Predicates (all optional, AND-ed together, applied to rows BEFORE
    binning — the scan-then-mask contract):

      ``time_window``     half-open ``[t0, t1)`` ns over ``k_start``;
                          additionally pushed down to shard-range pruning
      ``ranks``           keep rows whose ``src_rank`` is in the subset
      ``kernel_names``    keep rows whose ``k_name`` id is in the subset
      ``transfer_kinds``  keep rows whose ``m_kind`` copyKind code is in
                          the subset (unjoined left-join rows carry -1)

    ``anomaly_score`` does not change the aggregation itself — it names
    the per-bin score later fence passes should run on — but a
    quantile-family score ("p99"/"iqr"/...) pulls the ``"quantile"``
    reducer into the canonical suite so the result can answer it.
    ``interval_ns`` re-bins at a different granularity than the store
    layout (it selects the :class:`~repro_torch.core.sharding.ShardPlan`, which
    is keyed separately — it is NOT part of the canonical query form).
    """

    metrics: Tuple[str, ...] = (DEFAULT_METRIC,)
    group_by: Optional[str] = None
    reducers: Tuple[str, ...] = ("moments",)
    time_window: Optional[Tuple[int, int]] = None
    ranks: Optional[Tuple[int, ...]] = None
    kernel_names: Optional[Tuple[int, ...]] = None
    transfer_kinds: Optional[Tuple[int, ...]] = None
    anomaly_score: str = "mean"
    interval_ns: Optional[int] = None

    def __post_init__(self):
        for f in ("metrics", "reducers"):
            if isinstance(getattr(self, f), str):     # bare-name shorthand
                object.__setattr__(self, f, (getattr(self, f),))
        for f in ("metrics", "reducers", "time_window", "ranks",
                  "kernel_names", "transfer_kinds"):
            v = getattr(self, f)
            if isinstance(v, str):
                raise TypeError(f"{f} must be a sequence of values, "
                                f"got the string {v!r}")
            if v is not None and not isinstance(v, tuple):
                object.__setattr__(self, f, tuple(v))
        if not self.metrics:
            raise ValueError("a Query must name at least one metric")
        if self.time_window is not None:
            t0, t1 = self.time_window
            if int(t1) <= int(t0):
                raise ValueError(f"empty time window {self.time_window!r}")
            object.__setattr__(self, "time_window", (int(t0), int(t1)))

    # -- canonical form ------------------------------------------------------
    @property
    def canonical_metrics(self) -> Tuple[str, ...]:
        """Sorted, de-duplicated metric order — what the engine computes
        and caches in (results are permuted back to ``self.metrics``)."""
        return tuple(sorted(set(self.metrics)))

    @property
    def canonical_reducers(self) -> Tuple[str, ...]:
        """Validated suite in canonical order: ``"moments"`` first (it is
        mandatory), the rest sorted; a quantile-family ``anomaly_score``
        pulls ``"quantile"`` in."""
        extra = (("quantile",) if is_quantile_score(self.anomaly_score)
                 else ())
        suite = normalize_reducers(tuple(self.reducers) + extra)
        return ("moments",) + tuple(sorted(set(suite) - {"moments"}))

    def canonical(self) -> Dict[str, Any]:
        """The version-stamped canonical query blob — the ONLY thing the
        summary/partial cache keys hash (plus plan and precision, which
        live outside the query). Order-insensitive in metrics, reducers
        and every predicate subset; ``anomaly_score`` and ``interval_ns``
        are deliberately absent (the former only implies a reducer, the
        latter only selects the plan)."""
        return {
            "version": SUMMARY_VERSION,
            "metrics": list(self.canonical_metrics),
            "group_by": self.group_by,
            "reducers": list(self.canonical_reducers),
            "time_window": (None if self.time_window is None
                            else list(self.time_window)),
            "ranks": (None if self.ranks is None
                      else sorted(set(_int_tuple(self.ranks)))),
            "kernel_names": (None if self.kernel_names is None
                             else sorted(set(_int_tuple(self.kernel_names)))),
            "transfer_kinds": (None if self.transfer_kinds is None else
                               sorted(set(_int_tuple(self.transfer_kinds)))),
        }

    def canonical_json(self) -> str:
        return json.dumps(self.canonical(), sort_keys=True)

    def cache_key(self) -> str:
        """16-hex digest of the canonical form — the query's identity.
        Stable across processes and platforms (sha256 over sorted-key
        json, no ``hash()`` involvement)."""
        return hashlib.sha256(
            self.canonical_json().encode()).hexdigest()[:16]

    # -- (de)serialization for CLIs / services -------------------------------
    def to_spec(self) -> Dict[str, Any]:
        """Round-trippable plain-dict form (user-facing field order kept,
        defaults omitted)."""
        out: Dict[str, Any] = {"metrics": list(self.metrics)}
        for f in ("group_by", "reducers", "time_window", "ranks",
                  "kernel_names", "transfer_kinds", "anomaly_score",
                  "interval_ns"):
            v = getattr(self, f)
            d = getattr(type(self), "__dataclass_fields__")[f].default
            if v != d:
                out[f] = list(v) if isinstance(v, tuple) else v
        return out

    @classmethod
    def from_spec(cls, spec: Dict[str, Any]) -> "Query":
        unknown = set(spec) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown Query fields {sorted(unknown)}")
        return cls(**spec)

    def to_json(self) -> str:
        return json.dumps(self.to_spec())

    @classmethod
    def from_json(cls, blob: str) -> "Query":
        return cls.from_spec(json.loads(blob))

    # -- predicate pushdown --------------------------------------------------
    @property
    def has_predicates(self) -> bool:
        return any(v is not None for v in (
            self.time_window, self.ranks, self.kernel_names,
            self.transfer_kinds))

    def row_mask(self, cols: Dict[str, np.ndarray]) -> Optional[np.ndarray]:
        """Boolean keep-mask over one shard's rows, or None when this
        query has no predicates (the scan then skips the mask entirely).
        Raises KeyError if a predicate column is missing from the shard
        schema, exactly like a missing metric column."""
        if not self.has_predicates:
            return None
        mask: Optional[np.ndarray] = None

        def land(m, mask=None):
            return m if mask is None else mask & m

        if self.time_window is not None:
            ts = np.asarray(cols["k_start"]).astype(np.int64)
            t0, t1 = self.time_window
            mask = land((ts >= t0) & (ts < t1), mask)
        for col, subset in (("src_rank", self.ranks),
                            ("k_name", self.kernel_names),
                            ("m_kind", self.transfer_kinds)):
            if subset is None:
                continue
            if col not in cols:
                raise KeyError(f"predicate column {col!r} not in shard "
                               f"columns {sorted(cols)}")
            mask = land(np.isin(np.asarray(cols[col]),
                                np.asarray(subset, np.float64)), mask)
        return mask

    def pruned_file_indices(self, file_plan: ShardPlan,
                            ) -> Optional[List[int]]:
        """Shard FILE indices the time window can touch (None = all).

        Pushdown against the store's file layout: only files whose time
        span intersects ``[t0, t1)`` are read. The first file's span is
        open below and the last file's open above, because generation
        clipped out-of-range timestamps into them — so a window entirely
        below ``t_start`` still (correctly) scans file 0."""
        if self.time_window is None:
            return None
        t0, t1 = self.time_window
        edges = file_plan.boundaries()
        keep = []
        for i in range(file_plan.n_shards):
            lo = -np.inf if i == 0 else int(edges[i])
            hi = np.inf if i == file_plan.n_shards - 1 else int(edges[i + 1])
            if t0 < hi and lo < t1:
                keep.append(i)
        return keep


def lane_precision(backend: str, world: int = 1) -> str:
    """The cache namespace a backend's partials, summaries and diff
    reports live in: torch results get their own, never served to (or
    by) the exact host path or another package's float32 one; ``serial``
    and ``process`` share ``"exact"`` (the same bits). A torch partial's
    float32 sums are a function of how its rows were split across the
    ``world`` ranks that reduced them, so a group of P > 1 ranks keeps
    ``"torch-float32-p<P>"`` apart: a delta never merges partials of
    another split, and stays bit-identical to a cold run at its own P
    (the reference's jax namespace is one for every mesh size)."""
    if backend != "torch":
        return "exact"
    return "torch-float32" if world == 1 else f"torch-float32-p{world}"


# -- diff specs (two-store comparison; see repro_torch.core.diff) ----------

def diff_query(base: Query) -> Query:
    """The per-store query a trace diff runs: ``base``'s predicates,
    metrics and binning, re-grouped by kernel name with the quantile
    sketch pulled into the suite (the shift scores are sketch-vs-sketch,
    the mean/p99 deltas come from the same pass). Canonical like any
    Query — when the store already holds this summary, the diff side
    reads zero shards."""
    reducers = tuple(sorted(set(base.reducers) | {"moments", "quantile"}))
    return dataclasses.replace(base, group_by="k_name", reducers=reducers)


def diff_spec(query_a: Query, query_b: Query) -> Dict[str, Any]:
    """Round-trippable plain-dict form of a diff request — the pair of
    per-store specs (CLI/CI surface; see :func:`diff_from_spec`)."""
    return {"a": query_a.to_spec(), "b": query_b.to_spec()}


def diff_from_spec(spec: Dict[str, Any]) -> Tuple[Query, Query]:
    unknown = set(spec) - {"a", "b"}
    if unknown:
        raise ValueError(f"unknown diff-spec fields {sorted(unknown)}")
    return Query.from_spec(spec["a"]), Query.from_spec(spec["b"])


def diff_cache_key(query_a: Query, query_b: Query) -> str:
    """16-hex identity of one diff: the PAIR of canonical per-store query
    forms (ordered — diff(A, B) and diff(B, A) are different questions),
    hashed the same way single-query cache keys are."""
    blob = json.dumps({"diff_version": 1,
                       "a": query_a.canonical(),
                       "b": query_b.canonical()}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


@dataclasses.dataclass
class LanePlan:
    """One query's compiled slot in a fused batch."""

    query: Query
    plan: ShardPlan                      # bin plan (interval_ns applied)
    metrics: Tuple[str, ...]             # canonical compute order
    reducers: Tuple[str, ...]            # canonical suite
    precision: str                       # "exact" | "torch-float32"
    summary_key: Optional[str]           # None once probed under no-cache
    qkey: str                            # per-shard partial-cache key
    pruned: Optional[List[int]]          # file indices to scan (None=all)
    shards_pruned: int                   # how many files pushdown skipped


@dataclasses.dataclass
class QueryResult:
    """One query's answer plus execution provenance."""

    query: Query
    result: Any                          # AggregationResult (user order)
    cache_hit: bool                      # served from the merged summary
    shards_pruned: int                   # files skipped by pushdown
    rows_scanned: int                    # rows read in recomputed shards
    rows_filtered: int                   # of those, dropped by predicates
    recomputed_shards: int               # dirty shard files rescanned
    partial_hits: int                    # clean shards from partial cache
    anomalies: Any = None                # IQRReport (pipeline.query fills)

    def provenance(self) -> str:
        if self.cache_hit:
            return "summary cache hit (0 shard reads)"
        return (f"recomputed {self.recomputed_shards} shard(s), "
                f"{self.partial_hits} partial hit(s), "
                f"{self.shards_pruned} pruned by time window, "
                f"{self.rows_filtered}/{self.rows_scanned} rows filtered")


@dataclasses.dataclass
class QueryPlan:
    """A batch of queries compiled into one fused execution.

    ``compile`` is pure planning (manifest read + key derivation + shard
    pruning); ``execute`` runs the fused engine: per-lane summary probes,
    ONE clean/dirty classification stat pass, one shared scan over the
    union of dirty shards (each file read once, every lane's reducers
    riding the same pass), and per-lane merge + finalize — bit-identical
    to running each query alone, on every backend."""

    store: Any                           # TraceStore
    n_shard_files: int
    file_plan: ShardPlan
    n_ranks: int
    backend: str
    lanes: List[LanePlan]
    device: Any = None                   # torch.device (torch backend)

    @classmethod
    def compile(cls, store, queries: Sequence[Query],
                backend: str = "serial",
                n_ranks: Optional[int] = None,
                device: str = "cuda") -> "QueryPlan":
        """``device`` is where the ``"torch"`` backend reduces dirty
        shards (resolved here: a missing card raises); the exact
        ``"serial"`` and ``"process"`` host paths ignore it."""
        from ..device import resolve_device
        from .tracestore import TraceStore
        if not isinstance(store, TraceStore):
            store = TraceStore(store)
        if backend not in ("serial", "process", "torch"):
            raise ValueError(f"unknown backend {backend!r} "
                             "(serial | process | torch)")
        dev = resolve_device(device) if backend == "torch" else None
        man = store.read_manifest()
        file_plan = ShardPlan(man.t_start, man.t_end, man.n_shards)
        precision = lane_precision(backend, _world_size())
        lanes = []
        for q in queries:
            if not isinstance(q, Query):
                raise TypeError(f"expected Query, got {type(q).__name__}")
            plan = (file_plan if q.interval_ns is None
                    else ShardPlan.from_interval(man.t_start, man.t_end,
                                                 int(q.interval_ns)))
            if plan != file_plan:
                plan_key = (plan.t_start, plan.t_end, plan.n_shards)
            else:
                # interval_ns spelling that re-derives the store's own
                # layout (e.g. the generation interval): mint the
                # manifest plan itself so both spellings share one
                # summary/partial entry, structurally — not just while
                # the two derivations happen to agree numerically
                plan = file_plan
                plan_key = (file_plan.t_start, file_plan.t_end,
                            file_plan.n_shards)
            pruned = q.pruned_file_indices(file_plan)
            lanes.append(LanePlan(
                query=q, plan=plan, metrics=q.canonical_metrics,
                reducers=q.canonical_reducers, precision=precision,
                summary_key=store.summary_key(plan_key, precision=precision,
                                              query=q),
                qkey=store.partial_key(plan_key, precision=precision,
                                       query=q),
                pruned=pruned,
                shards_pruned=(0 if pruned is None
                               else man.n_shards - len(pruned))))
        return cls(store=store, n_shard_files=man.n_shards,
                   file_plan=file_plan,
                   n_ranks=int(n_ranks or man.n_ranks), backend=backend,
                   lanes=lanes, device=dev)

    def execute(self, use_cache: bool = True, compute_fn=None,
                pool=None) -> List[QueryResult]:
        from .aggregation import execute_plan
        return execute_plan(self, use_cache=use_cache,
                            compute_fn=compute_fn, pool=pool)
