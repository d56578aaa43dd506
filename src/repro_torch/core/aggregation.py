"""Phase 2 — data aggregation (paper §3, "Data aggregation").

Per paper: "We begin aggregation by defining a global dictionary with
timestamps as keys and a fixed user-defined duration (interval = 1s by
default). Each rank loads its assigned N/P parquet files, mapping samples to
corresponding time shards. Subsequently, P ranks collaboratively compute
statistical metrics (minimum, maximum, standard deviation) in a round-robin
manner, balancing workload evenly and minimizing contention."

Reducer framework
-----------------
The per-shard statistic is *pluggable*: every driver below is generic over
a suite of mergeable reducers (see :mod:`repro_torch.core.reducers` for the
``zeros / bin_grouped / merge / take_bins / stack_groups / to_payload /
from_payload`` contract). Two reducers ship today:

  * ``"moments"`` — :class:`BinStats` partial moments
    (count, sum, sumsq, min, max); Chan et al.'s pairwise-merge
    formulation, which makes the distributed result EXACTLY equal to the
    serial one (tested). mean/std/var derive from the moments at the end.
  * ``"quantile"`` — :class:`~repro_torch.core.reducers.QuantileSketch`
    log-bucket histograms, merged by pure addition, answering per-bin
    P50/P95/P99 and within-bin IQR with bounded relative error.

Because every merge is associative and commutative, the same round-robin
collaborative reduction (and the torch backend's binstats/histbin CUDA
kernels) serves any suite member; adding a
reducer never forces a second scan of the raw shards.

Multi-metric × group-by engine
------------------------------
One pass over the shards yields a ``(n_bins, n_groups, n_metrics)`` tensor
per reducer: state arrays carry trailing (group, metric) axes and all
merges/derived stats are elementwise, so the same reduction serves one
metric or M metrics × G group keys (kernel id ``k_name``, device
``k_device``, transfer kind ``m_kind``, ...). Per-metric accumulation
order is unchanged whether a metric rides alone or in a batch, so a
multi-metric run is bit-identical to M single-metric runs.

Incremental engine
------------------
The scan itself is split into a per-shard partial producer
(:func:`compute_shard_partial` → :class:`ShardPartial`) and a
suite-generic merge (:func:`rank_partial_from_shards` +
:func:`round_robin_merge`), with TWO cache levels in the
:class:`TraceStore` (see its module docstring for the payload formats):

  * ``summary_{key}.npz`` — the fully merged suite. The payload records
    the ``covered`` shard fingerprints; a repeat query over an UNCHANGED
    store is answered from this O(n_bins) cache without touching shards,
    and a payload written by an older engine version (or covering a
    different store state) is a miss, never a crash.
  * ``pack_{idx}.bin`` — one shard's pre-merge states, ALL queries'
    entries consolidated in one append-friendly pack file. On a
    summary miss, :func:`run_aggregation` classifies each shard clean or
    dirty against its (size, mtime_ns) fingerprint, loads cached partials
    for the clean ones, recomputes ONLY the dirty/new ones, and re-merges
    — so appending one second of trace costs O(dirty shards), not a full
    rescan. Because partials round-trip their arrays exactly and the
    merge order is fixed (shard index within rank, round-robin across
    ranks), the delta result is BIT-IDENTICAL to a cold full aggregation
    on every backend (tested).

The same clean/dirty driver serves BOTH backends. The serial backend
produces exact float64 partials on host (:func:`compute_partials`). The
torch backend produces DEVICE partials
(:func:`compute_lane_partials_torch`): one batched kernel launch per
reducer over the dirty shards' raw events, sliced back into per-shard
post-segment-reduce tensors and cached in a
``precision="torch-float32"`` partial namespace — so after an append the
kernels run only over the appended rows, and clean shards re-enter the
merge as host partials without touching the device.

Declarative query engine
------------------------
Since the Query API (:mod:`repro_torch.core.query`) the clean/dirty driver is
the single-lane special case of :func:`execute_plan`, which runs a
BATCH of declarative queries as one fused execution: per-lane summary
probes, one shared stat pass, one scan over the union of dirty shards
(each file read once — every lane's metrics, groups, reducers and row
predicates ride the same pass via :func:`compute_lane_partials` /
:func:`compute_lane_partials_torch`), then the per-lane merge tail every
driver shares (:func:`_merge_lane`). Cache keys hash the query's
CANONICAL form (order-insensitive metrics/reducers, predicates
included), the engine computes and caches in canonical metric order,
and results are permuted back to the caller's order — so an old-style
``run_aggregation(metrics=...)`` call, a reordered re-query and a
:class:`~repro_torch.core.query.Query` all share one cache entry
bit-identically.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import threading
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

import collections

from .query import (DEFAULT_METRIC, LanePlan, Query, QueryPlan,
                    QueryResult)
from .reducers import (BinStats, QuantileSketch, get_reducer,
                       normalize_reducers)
from .sharding import ShardPlan, assignment, cyclic_assignment
from .tracestore import SUMMARY_VERSION, TraceStore

__all__ = [
    "AggregationResult", "BinStats", "QuantileSketch", "GroupedPartial",
    "Query", "QueryPlan", "QueryResult", "ShardPartial", "bin_samples",
    "bin_samples_grouped", "compute_shard_partial", "compute_partials",
    "ScanPool", "compute_lane_partials", "compute_lane_partials_torch",
    "classify_shards", "execute_plan",
    "rank_partial_from_shards", "load_rank_grouped", "load_rank_partials",
    "round_robin_merge", "run_aggregation", "run_incremental",
    "run_queries", "DEFAULT_METRIC", "STAT_FIELDS",
]

STAT_FIELDS = BinStats.fields

DEFAULT_REDUCERS = ("moments",)

# Pseudo group key used when no group_by column is requested.
_NO_GROUP_KEY = 0.0


def bin_samples(timestamps: np.ndarray, values: np.ndarray,
                plan: ShardPlan) -> BinStats:
    """Map samples to time bins and accumulate partial moments (numpy path).

    The timestamp form of the `binstats` CUDA kernel implements this
    contract in float32 (:func:`repro_torch.kernels.binstats.binstats`).
    """
    n = plan.n_shards
    out = BinStats.zeros(n)
    if timestamps.size == 0:
        return out
    bins = plan.shard_of(timestamps)
    vals = np.asarray(values, np.float64)
    np.add.at(out.count, bins, 1.0)
    np.add.at(out.sum, bins, vals)
    np.add.at(out.sumsq, bins, vals * vals)
    np.minimum.at(out.min, bins, vals)
    np.maximum.at(out.max, bins, vals)
    return out


def bin_samples_grouped(timestamps: np.ndarray, values: np.ndarray,
                        group_ids: np.ndarray, n_groups: int,
                        plan: ShardPlan) -> BinStats:
    """Single-pass grouped multi-metric moment binning (numpy path).

    Kept as the public moments entry point; the generic per-reducer
    accumulate lives on each reducer class (``bin_grouped``).
    """
    return BinStats.bin_grouped(timestamps, values, group_ids, n_groups,
                                plan)


@dataclasses.dataclass
class GroupedPartial:
    """One rank's pre-merge partial: group key -> per-reducer
    (n_bins, n_metrics) states. Keys are discovered locally while
    streaming shards; ranks agree on the global key -> index mapping only
    at densify time, so the raw data is still read exactly once."""

    n_bins: int
    n_metrics: int
    reducers: Tuple[str, ...] = DEFAULT_REDUCERS
    groups: Dict[float, Dict[str, Any]] = dataclasses.field(
        default_factory=dict)

    def add(self, key: float, states: Dict[str, Any]) -> None:
        prev = self.groups.get(key)
        if prev is None:
            self.groups[key] = dict(states)
        else:
            self.groups[key] = {name: prev[name].merge(st)
                                for name, st in states.items()}

    def densify(self, all_keys: Sequence[float]) -> Dict[str, Any]:
        """Expand into dense (n_bins, n_groups, n_metrics) tensors under a
        global key ordering; absent groups hold the merge identity."""
        out: Dict[str, Any] = {}
        for name in self.reducers:
            cls = get_reducer(name)
            empty = cls.zeros(self.n_bins, (self.n_metrics,))
            parts = [self.groups.get(k, {}).get(name, empty)
                     for k in all_keys]
            out[name] = cls.stack_groups(parts)
        return out


@dataclasses.dataclass
class AggregationResult:
    plan: ShardPlan
    metric: str                         # first metric (legacy accessor)
    stats: BinStats                     # 1-D group-merged view, metric 0
    # Pre-merge moment partials for tests/plots. COLD RUNS ONLY: a
    # summary-cache hit (from_cache=True) stores just the merged tensors,
    # so this is empty there — pass use_cache=False when they matter.
    per_rank_stats: List[BinStats]
    copy_kind_bytes: Dict[int, np.ndarray]   # per-bin bytes by memcpy kind
    seconds: float
    metrics: List[str] = dataclasses.field(default_factory=list)
    group_by: Optional[str] = None
    group_keys: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(1))
    grouped: Optional[BinStats] = None  # (n_bins, n_groups, n_metrics)
    from_cache: bool = False
    reducers: Tuple[str, ...] = DEFAULT_REDUCERS
    # merged grouped state per reducer; reduced["moments"] is `grouped`
    reduced: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # incremental-engine provenance: which shard files were actually
    # scanned this run (None = driver predates / bypasses the partial
    # cache), and how many clean shards were served from cached partials.
    recomputed_shards: Optional[List[int]] = None
    partial_hits: int = 0

    def select(self, metric: Union[int, str] = 0,
               group: Optional[float] = None) -> BinStats:
        """1-D per-bin moments for one metric, optionally one group key."""
        if self.grouped is None:
            return self.stats
        sel = self._select_state(self.grouped, metric, group)
        return sel

    def sketch(self, metric: Union[int, str] = 0,
               group: Optional[float] = None) -> QuantileSketch:
        """1-D per-bin quantile sketch for one metric / optional group.

        Requires ``"quantile"`` in the reducer suite (pass
        ``reducers=("moments", "quantile")`` to the aggregation)."""
        sk = self.reduced.get("quantile")
        if sk is None:
            raise KeyError(
                "no quantile sketch in this result — aggregate with "
                "reducers=('moments', 'quantile')")
        return self._select_state(sk, metric, group)

    def _select_state(self, state, metric: Union[int, str],
                      group: Optional[float]):
        j = (self.metrics.index(metric) if isinstance(metric, str)
             else int(metric))
        if group is None:
            return state.merge_groups().select_metric(j)
        keys = np.asarray(self.group_keys)
        hit = np.nonzero(keys == group)[0]
        if hit.size == 0:
            raise KeyError(f"group key {group!r} not in {keys.tolist()}")
        return state.take_group(int(hit[0])).select_metric(j)


def _shard_kind_bytes(cols: Dict[str, np.ndarray], plan: ShardPlan,
                      kind_bytes: Dict[int, np.ndarray]) -> None:
    """Accumulate the Fig-1b transfer-direction breakdown for one shard.

    One fused ``np.bincount`` over (kind, bin) — bitwise-identical to
    the per-kind ``np.add.at`` loop (both accumulate in input order, and
    rows of one kind keep their relative order under the stable grouping
    below) at a fraction of the cost."""
    joined = cols["joined"] > 0
    if not joined.any():
        return
    kb = cols["m_bytes"][joined]
    kk = cols["m_kind"][joined].astype(np.int64)
    kt = cols["m_start"][joined].astype(np.int64)
    kbins = plan.shard_of(kt)
    kinds, kidx = np.unique(kk, return_inverse=True)
    acc = np.bincount(kidx * plan.n_shards + kbins, weights=kb,
                      minlength=len(kinds) * plan.n_shards
                      ).reshape(len(kinds), plan.n_shards)
    for i, kind in enumerate(kinds):
        prev = kind_bytes.setdefault(int(kind), np.zeros(plan.n_shards))
        prev += acc[i]


def _bounded_unique(ids: np.ndarray, bound: int,
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """``np.unique(ids, return_inverse=True)`` for int ids known to lie
    in ``[0, bound)`` — an O(n + bound) occupancy table instead of the
    O(n log n) sort, which matters at fused-batch rates where bin ids
    are uniqued once per (query lane × shard). Returns the same (sorted
    unique values, inverse) contract bit for bit."""
    occ = np.zeros(bound, bool)
    occ[ids] = True
    uniq = np.flatnonzero(occ)
    lookup = np.zeros(bound, np.int64)
    lookup[uniq] = np.arange(len(uniq))
    return uniq, lookup[ids]


# --- per-shard partial producer (the incremental unit of work) -------------

@dataclasses.dataclass
class ShardPartial:
    """One shard's pre-merge reducer states — the incremental engine's
    unit of caching and recomputation. Sparse over the bin axis: ``bins``
    lists the time bins this shard's rows actually touched and every
    reducer state carries (B, G, M[, private]) with B = len(bins), so a
    partial is O(rows-of-one-shard) on disk regardless of plan size.
    ``kind_bytes`` keeps the dense (K, n_bins) Fig-1b byte breakdown (K
    is the handful of memcpy copyKind codes)."""

    idx: int
    n_bins: int
    bins: np.ndarray                     # (B,) int64 bins touched
    group_keys: np.ndarray               # (G,) float64 local group keys
    states: Dict[str, Any]               # reducer name -> (B, G, M, ...)
    kind_keys: np.ndarray                # (K,) int64 copyKind codes
    kind_bytes: np.ndarray               # (K, n_bins) float64
    # max joined m_start in this shard (-1 if none): m_start may overrun
    # the plan end by up to the join window and clip into the top bin, so
    # a partial is only reusable under an APPEND-EXTENDED plan when no
    # m_start reached the old plan end (see _adapt_partial_plan)
    m_start_hi: int = -1
    # scan provenance (transient, NOT serialized — a cache-served partial
    # reports 0/0): rows the shard file held vs rows the query's row
    # predicates let through to the reducers
    rows_seen: int = 0
    rows_kept: int = 0

    def kind_dict(self) -> Dict[int, np.ndarray]:
        return {int(k): self.kind_bytes[i]
                for i, k in enumerate(self.kind_keys)}


def _scan_shard(store: TraceStore, idx: int, plan: ShardPlan,
                metrics: Sequence[str], group_by: Optional[str],
                query: Optional[Query] = None,
                cols: Optional[Dict[str, np.ndarray]] = None,
                ) -> Tuple[ShardPartial, Optional[Tuple[np.ndarray, ...]]]:
    """Read + validate ONE shard and build everything about its partial
    EXCEPT the reducer states — the scaffolding both producers (host
    ``bin_grouped`` scan and torch device reduction) share: touched bins,
    local group keys, transfer-kind bytes, the ``m_start_hi``
    plan-extension guard. ``query`` pushes its row predicates down into
    the scan (the mask is applied to every column BEFORE group discovery,
    binning and the byte breakdown — the scan-then-mask contract), and
    ``cols`` lets the fused multi-query executor share one shard read
    across lanes. Returns ``(partial-with-empty-states, rows)`` where
    ``rows`` is ``None`` for an empty shard, else
    ``(ts, vals (M, N), local_bin, gids)`` for the producer to reduce."""
    if cols is None:
        cols = store.read_shard(int(idx))
    missing = [m for m in metrics if m not in cols]
    if missing:
        raise KeyError(f"metrics {missing} not in shard columns "
                       f"{sorted(cols)}")
    if group_by is not None and group_by not in cols:
        raise KeyError(f"group_by column {group_by!r} not in shard "
                       f"columns {sorted(cols)}")
    rows_seen = int(np.asarray(cols["k_start"]).shape[0])
    rows_kept = rows_seen
    if query is not None:
        mask = query.row_mask(cols)
        if mask is not None:
            # materialize only the columns the rest of the scan touches,
            # through an index vector rather than the boolean mask —
            # boolean fancy-indexing rescans all n rows PER COLUMN,
            # where flatnonzero pays O(n) once and O(kept) per column;
            # at fused-batch rates (every lane × every shard) that
            # difference is a measurable slice of the pass
            sel = np.flatnonzero(mask)
            needed = {"k_start", "joined", "m_bytes", "m_kind", "m_start",
                      *metrics}
            if group_by is not None:
                needed.add(group_by)
            cols = {c: np.asarray(v)[sel] for c, v in cols.items()
                    if c in needed}
            rows_kept = int(sel.size)
    ts = cols["k_start"].astype(np.int64)
    if ts.size == 0:
        # an empty (or fully filtered) shard contributes no rows and NO
        # group keys
        return ShardPartial(
            idx=int(idx), n_bins=plan.n_shards,
            bins=np.zeros(0, np.int64), group_keys=np.zeros(0, np.float64),
            states={}, kind_keys=np.zeros(0, np.int64),
            kind_bytes=np.zeros((0, plan.n_shards)),
            rows_seen=rows_seen, rows_kept=rows_kept), None
    vals = np.stack([np.asarray(cols[m], np.float64) for m in metrics],
                    axis=0)
    if group_by is None:
        keys = np.asarray([_NO_GROUP_KEY])
        gids = np.zeros(len(ts), np.int64)
    else:
        keys, gids = np.unique(np.asarray(cols[group_by], np.float64),
                               return_inverse=True)
    bins, local_bin = _bounded_unique(plan.shard_of(ts), plan.n_shards)
    kind_bytes: Dict[int, np.ndarray] = {}
    _shard_kind_bytes(cols, plan, kind_bytes)
    kinds = sorted(kind_bytes)
    joined = cols["joined"] > 0 if "joined" in cols else np.zeros(0, bool)
    m_start_hi = (int(cols["m_start"][joined].max())
                  if joined.any() else -1)
    sp = ShardPartial(
        idx=int(idx), n_bins=plan.n_shards, bins=bins,
        group_keys=np.asarray(keys, np.float64), states={},
        kind_keys=np.asarray(kinds, np.int64),
        kind_bytes=(np.stack([kind_bytes[k] for k in kinds]) if kinds
                    else np.zeros((0, plan.n_shards))),
        m_start_hi=m_start_hi, rows_seen=rows_seen, rows_kept=rows_kept)
    return sp, (ts, vals, local_bin, gids)


class _TouchedBins:
    """The bin plan ``bin_grouped`` sees for one shard: its touched
    bins, numbered in order (``shard_of`` hands back the rows' local bin
    ids, already computed by the scan)."""

    def __init__(self, n_bins: int, local_bin: np.ndarray) -> None:
        self.n_shards = int(n_bins)
        self._local_bin = local_bin

    def shard_of(self, timestamps: np.ndarray) -> np.ndarray:
        return self._local_bin


def compute_shard_partial(store: TraceStore, idx: int, plan: ShardPlan,
                          metrics: Sequence[str],
                          group_by: Optional[str] = None,
                          reducers: Sequence[str] = DEFAULT_REDUCERS,
                          query: Optional[Query] = None,
                          cols: Optional[Dict[str, np.ndarray]] = None,
                          ) -> ShardPartial:
    """Scan ONE shard file and reduce it: every reducer, metric and group
    in a single pass over the rows. Each reducer's ``bin_grouped``
    accumulates over the shard's touched bins only (the reference
    accumulates over the full dense plan, then slices the touched bins
    out): the same rows reach each cell in the same order, so the result
    is bit-identical, while a fine re-binning grouped by many keys (10 ms
    bins by kernel name) no longer allocates the whole trace's cells for
    every shard. ``query`` pushes row predicates into the scan; ``cols``
    reuses an already-read shard (the fused multi-query pass)."""
    metrics = list(metrics)
    suite = normalize_reducers(reducers)
    sp, rows = _scan_shard(store, idx, plan, metrics, group_by,
                           query=query, cols=cols)
    if rows is None:
        return sp
    ts, vals, local_bin, gids = rows
    local = _TouchedBins(len(sp.bins), local_bin)
    sp.states = {name: get_reducer(name).bin_grouped(
                     ts, vals.T, gids, len(sp.group_keys), local)
                 for name in suite}
    return sp


# --- partial-cache (de)serialization ---------------------------------------

def shard_partial_payload(sp: ShardPartial, plan: ShardPlan,
                          metrics: Sequence[str], group_by: Optional[str],
                          fingerprint: Sequence[int],
                          ) -> Dict[str, np.ndarray]:
    """Flat array dict for one (shard, query) pack entry — the reducer
    ``to_payload`` round trip plus the shard fingerprint it covers."""
    payload = {
        "version": np.asarray(SUMMARY_VERSION, np.int64),
        "t_start": np.asarray(plan.t_start, np.int64),
        "t_end": np.asarray(plan.t_end, np.int64),
        "n_shards": np.asarray(plan.n_shards, np.int64),
        "idx": np.asarray(sp.idx, np.int64),
        "fingerprint": np.asarray(fingerprint, np.int64),
        "metrics": np.asarray(list(metrics)),
        "group_by": np.asarray(group_by or ""),
        "group_keys": np.asarray(sp.group_keys, np.float64),
        "reducers": np.asarray(list(sp.states)),
        "bins": np.asarray(sp.bins, np.int64),
        "kind_keys": sp.kind_keys,
        "kind_bytes": sp.kind_bytes,
        "m_start_hi": np.asarray(sp.m_start_hi, np.int64),
    }
    for state in sp.states.values():
        payload.update(state.to_payload())
    return payload


def shard_partial_from_payload(payload: Dict[str, np.ndarray],
                               ) -> ShardPartial:
    suite = tuple(str(r) for r in payload["reducers"])
    return ShardPartial(
        idx=int(payload["idx"]), n_bins=int(payload["n_shards"]),
        bins=np.asarray(payload["bins"], np.int64),
        group_keys=np.asarray(payload["group_keys"], np.float64),
        states={name: get_reducer(name).from_payload(payload)
                for name in suite},
        kind_keys=np.asarray(payload["kind_keys"], np.int64),
        kind_bytes=np.asarray(payload["kind_bytes"], np.float64),
        m_start_hi=int(payload["m_start_hi"]))


def _adapt_partial_plan(payload: Dict[str, np.ndarray], idx: int,
                        plan: ShardPlan) -> Optional[ShardPartial]:
    """Decode a cached partial if it is valid under ``plan``.

    Exact plan match is always valid. A payload written under a SHORTER
    plan with the same origin and shard width (the append-extension case:
    boundaries are a prefix, ``partial_key`` already guarantees origin +
    width agree) is valid unless any joined ``m_start`` reached the old
    plan end — such values clipped into the old top transfer-kind bin,
    which the extended plan bins differently (``k_start`` never clips:
    the plan always covers it). Reusable partials get their dense
    (K, old_n_bins) byte rows zero-padded out to the current plan.
    Anything else (shrunk plan) is a miss."""
    p_end, p_n = int(payload["t_end"]), int(payload["n_shards"])
    if (p_end, p_n) != (plan.t_end, plan.n_shards):
        if p_n >= plan.n_shards or int(payload["m_start_hi"]) >= p_end:
            return None
    sp = shard_partial_from_payload(payload)
    if sp.kind_bytes.shape[1] < plan.n_shards:
        sp.kind_bytes = np.pad(
            sp.kind_bytes,
            ((0, 0), (0, plan.n_shards - sp.kind_bytes.shape[1])))
    sp.n_bins = plan.n_shards
    return sp


def classify_shards(store: TraceStore, indices: Sequence[int],
                    plan: ShardPlan, metrics: Sequence[str],
                    group_by: Optional[str],
                    reducers: Sequence[str] = DEFAULT_REDUCERS,
                    use_cache: bool = True,
                    stats: Optional[Dict[int, Tuple[int, int, int]]] = None,
                    precision: str = "exact",
                    query: Optional[Query] = None,
                    ) -> Tuple[str, List[ShardPartial], List[int]]:
    """Split the shard universe into (clean partials loaded from cache,
    dirty indices to recompute). A shard is clean iff a cached partial
    exists for this query, its embedded fingerprint matches the shard
    file's current (size, mtime_ns) stat, and its recorded plan is valid
    under the current one (equal, or a prefix of an append-extended plan)
    — so any rewrite, append or engine-version bump dirties exactly the
    shards it touched. ``precision`` picks the partial namespace: the
    host scan's exact float64 partials vs the torch backend's float32
    device partials (they share all the machinery above). ``query``
    carries the canonical form the key is derived from (legacy callers
    omit it and one is built from the metrics/group_by/reducers args);
    a payload whose embedded metric ORDER differs from the expected one
    is a miss — the engine caches in canonical order, and serving a
    same-key payload with a different metric axis would silently
    transpose results."""
    suite = normalize_reducers(reducers)
    qkey = store.partial_key((plan.t_start, plan.t_end, plan.n_shards),
                             metrics, group_by, precision=precision,
                             reducers=suite, query=query)
    clean: List[ShardPartial] = []
    dirty: List[int] = []
    for idx in indices:
        fp = (stats.get(int(idx)) if stats is not None
              else store.stat_shard(idx))
        if fp is None:
            continue                   # vanished between listing and stat
        payload = store.read_partial(idx, qkey) if use_cache else None
        sp = None
        if (payload is not None
                and int(payload.get("version", -1)) == SUMMARY_VERSION
                and np.array_equal(payload["fingerprint"],
                                   np.asarray(fp, np.int64))
                and [str(m) for m in payload["metrics"]] == list(metrics)):
            sp = _adapt_partial_plan(payload, int(idx), plan)
        if sp is not None:
            clean.append(sp)
        else:
            dirty.append(int(idx))
    return qkey, clean, dirty


def compute_partials(store: TraceStore, indices: Sequence[int],
                     plan: ShardPlan, metrics: Sequence[str],
                     group_by: Optional[str],
                     reducers: Sequence[str] = DEFAULT_REDUCERS,
                     qkey: Optional[str] = None,
                     query: Optional[Query] = None) -> List[ShardPartial]:
    """Recompute partials for ``indices`` (one worker's chunk of the
    work queue); with ``qkey`` set, each is atomically persisted to the
    partial cache as soon as it is produced (crash-safe: a dying worker
    leaves complete partials or none, never torn files). ``query``
    pushes row predicates into the scan."""
    out = []
    for idx in indices:
        if not store.has_shard(int(idx)):
            continue
        fp = store.stat_shard(int(idx))
        sp = compute_shard_partial(store, int(idx), plan, metrics,
                                   group_by, reducers, query=query)
        if qkey is not None and fp is not None:
            store.write_partial(int(idx), qkey, shard_partial_payload(
                sp, plan, metrics, group_by, fp))
        out.append(sp)
    return out


class ScanPool:
    """Persistent scan workers + ONE pack writer for fused execution.

    Spawned once per :class:`~repro_torch.core.pipeline.VariabilityPipeline` /
    query-service lifetime (never per call): the scan executor fans the
    dirty-shard union of a fused plan out across ``workers`` threads,
    and the dedicated single-thread ``writer`` serializes EVERY pack
    append issued through the pool — including appends from ticks whose
    plans overlap in a pipelined service — so the pack read-modify-write
    contract of :meth:`~repro_torch.core.tracestore.TraceStore.write_partials`
    holds no matter how many scans are in flight.

    Bit-identity: workers take disjoint ``(shard, [lanes])`` chunks, so
    each :class:`ShardPartial` stays a pure function of its own shard's
    rows, and the merge tail (:func:`rank_partial_from_shards`) folds in
    fixed shard-index order regardless of completion order — a pooled
    scan is bit-identical to the serial one (tested).

    Chunking is work-stealing style, after the process backend: the work
    list splits into ~``workers * 4`` contiguous chunks queued on the
    executor, so a straggler shard delays one small chunk, not an even
    1/workers split. ``busy_s`` / ``tasks`` feed the service's
    utilization counters.
    """

    def __init__(self, workers: int = 0):
        self.workers = int(workers) if workers else (os.cpu_count() or 1)
        if self.workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self._lock = threading.Lock()
        self._scan = None
        self._writer = None
        self._closed = False
        self.busy_s = 0.0
        self.tasks = 0
        self.started_at = time.monotonic()

    @property
    def parallel(self) -> bool:
        return self.workers > 1

    def _executors(self):
        with self._lock:
            if self._closed:
                raise RuntimeError("ScanPool is closed")
            if self._scan is None:
                self._scan = concurrent.futures.ThreadPoolExecutor(
                    max_workers=self.workers,
                    thread_name_prefix="scan-worker")
                self._writer = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="pack-writer")
            return self._scan, self._writer

    def submit_write(self, fn, *args):
        """Queue a pack append on THE single writer thread."""
        _, writer = self._executors()
        return writer.submit(fn, *args)

    def run_chunks(self, fn, chunks: Sequence[Sequence[Any]]) -> list:
        """Run ``fn(chunk)`` across the scan workers; returns results in
        chunk order (completion order never leaks to callers)."""
        scan, _ = self._executors()

        def timed(chunk):
            t0 = time.monotonic()
            try:
                return fn(chunk)
            finally:
                with self._lock:
                    self.busy_s += time.monotonic() - t0
                    self.tasks += 1

        futs = [scan.submit(timed, c) for c in chunks]
        return [f.result() for f in futs]

    def utilization(self) -> dict:
        """Counters for ``/stats``: cumulative busy seconds per worker
        pool vs wall time since pool creation (bounded memory — two
        floats and an int, not per-task lists)."""
        with self._lock:
            wall = max(time.monotonic() - self.started_at, 1e-9)
            return {
                "workers": self.workers,
                "tasks": self.tasks,
                "busy_s": round(self.busy_s, 6),
                "utilization": round(
                    self.busy_s / (wall * self.workers), 6),
            }

    def close(self) -> None:
        with self._lock:
            scan, writer = self._scan, self._writer
            self._scan = self._writer = None
            self._closed = True
        if scan is not None:
            scan.shutdown(wait=True)
        if writer is not None:
            writer.shutdown(wait=True)

    def __enter__(self) -> "ScanPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _scan_lane_items(store: TraceStore,
                     items: Sequence[Tuple[int, Sequence[int]]],
                     lanes: Sequence[LanePlan], persist: bool,
                     submit_write,
                     ) -> Tuple[Dict[int, List[ShardPartial]], list]:
    """Scan one worker's chunk of ``(shard, [lane ids])`` items: each
    shard file is read once, every lane riding it reduces off the shared
    columns, and all lanes' payloads batch into ONE pack append handed
    to ``submit_write`` (the single writer). Returns the chunk's
    ``{lane -> partials}`` plus the pending write futures."""
    fresh: Dict[int, List[ShardPartial]] = collections.defaultdict(list)
    pending = []
    for idx, lane_ids in items:
        if not store.has_shard(int(idx)):
            continue
        fp = store.stat_shard(int(idx))
        cols = store.read_shard(int(idx))
        batch = {}
        for li in lane_ids:
            lane = lanes[li]
            sp = compute_shard_partial(
                store, int(idx), lane.plan, lane.metrics,
                lane.query.group_by, lane.reducers, query=lane.query,
                cols=cols)
            if persist and lane.qkey and fp is not None:
                batch[lane.qkey] = shard_partial_payload(
                    sp, lane.plan, lane.metrics, lane.query.group_by, fp)
            fresh[li].append(sp)
        if batch:
            pending.append(submit_write(store.write_partials,
                                        int(idx), batch))
    return fresh, pending


def compute_lane_partials(store: TraceStore,
                          work_items: Sequence[Tuple[int, Sequence[int]]],
                          lanes: Sequence[LanePlan],
                          persist: bool = True,
                          pool: Optional[ScanPool] = None,
                          ) -> Dict[int, List[ShardPartial]]:
    """The fused multi-query producer (host): every dirty shard file is
    read ONCE and each lane that needs it reduces its own metrics /
    groups / predicates off the shared columns — per-query reducer lanes
    riding one pass. Returns ``{lane index -> [ShardPartial]}``; with
    ``persist``, each partial is atomically written to its lane's
    partial-cache namespace as soon as it is produced.

    Persistence runs on ONE background writer thread, and ALL lanes of a
    shard are batched into one pack operation
    (:meth:`~repro_torch.core.tracestore.TraceStore.write_partials`): pack +
    write syscalls overlap the next shard's scan (both release the GIL),
    an L-lane batch costs one file write instead of L (the syscall floor
    the consolidated packs exist to remove), each pack write stays
    atomic/self-healing, and the single writer serializes against its
    own pack read-modify-write cycle. All futures are drained before
    returning, so callers observe fully persisted partials and any write
    error surfaces here.

    With a parallel ``pool``, the work list splits into disjoint
    contiguous chunks scanned concurrently (shard reads and the numpy
    reductions both release the GIL); appends still funnel through the
    pool's single writer, and since every partial is a pure function of
    its own shard and the merge tail folds in shard-index order, the
    result is bit-identical to the serial scan. With ``pool=None`` (or a
    1-worker pool) the scan runs inline with a call-scoped writer —
    the pre-pool behavior, unchanged."""
    if pool is not None and pool.parallel and len(work_items) > 1:
        n_chunks = min(len(work_items), pool.workers * 4)
        step = -(-len(work_items) // n_chunks)
        chunks = [work_items[i:i + step]
                  for i in range(0, len(work_items), step)]
        outs = pool.run_chunks(
            lambda items: _scan_lane_items(store, items, lanes, persist,
                                           pool.submit_write),
            chunks)
        fresh: Dict[int, List[ShardPartial]] = collections.defaultdict(
            list)
        pending = []
        for chunk_fresh, chunk_pending in outs:
            # chunk order == shard order (contiguous splits of the
            # sorted work list), so per-lane partial lists stay sorted
            for li, sps in chunk_fresh.items():
                fresh[li].extend(sps)
            pending.extend(chunk_pending)
        for f in pending:
            f.result()
        return fresh

    if pool is not None:
        # 1-worker pool: scan inline but keep appends on THE shared
        # writer so concurrent ticks' pack ops stay serialized
        fresh, pending = _scan_lane_items(store, work_items, lanes,
                                          persist, pool.submit_write)
        for f in pending:
            f.result()
        return fresh

    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as writer:
        fresh, pending = _scan_lane_items(store, work_items, lanes,
                                          persist, writer.submit)
        for f in pending:
            f.result()
    return fresh


def _slotwise_device_partition(counts: Sequence[int], n_dev: int,
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """Row -> device assignment that makes each shard's device partial a
    pure function of ITS OWN rows: device d gets rows
    ``[d*n/P, (d+1)*n/P)`` of EVERY slot, not a block of the concatenated
    stream. A block split of the concatenation would cut shard s's rows
    at positions depending on the OTHER shards in the batch — the
    float32 per-device partial sums would differ between a delta run
    (dirty shards only) and a cold run (every shard), breaking the
    bit-identity guarantee.

    ``counts`` are per-slot row counts in concatenation order. Returns
    ``(row_index, valid)`` of length ``P*L`` (L = the largest per-device
    section; shorter sections padded with row 0 marked invalid —
    weight-0 rows are exact no-ops). The reference rounds L up to a
    power of two so its jitted collective is reused across appends; an
    eager torch launch has nothing to reuse, so L is exact here."""
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    sections = []
    for d in range(n_dev):
        chunks = [np.arange(offsets[s] + (d * n) // n_dev,
                            offsets[s] + ((d + 1) * n) // n_dev)
                  for s, n in enumerate(counts)]
        sections.append(np.concatenate(chunks) if chunks
                        else np.zeros(0, np.int64))
    width = max((len(sec) for sec in sections), default=0)
    row = np.zeros(n_dev * width, np.int64)
    valid = np.zeros(n_dev * width, bool)
    for d, sec in enumerate(sections):
        row[d * width:d * width + len(sec)] = sec
        valid[d * width:d * width + len(sec)] = True
    return row, valid


# Host-side figures of the calling thread's last torch producer run, one
# entry per reducer suite batch: rows reduced, segments, and the seconds
# spent building the segment order (read by chip_smoke.py; nothing in the
# engine reads it). Each call builds its own list and each thread keeps
# its own, so overlapping service ticks never clear each other's entries.
_PRODUCER = threading.local()


def producer_stats() -> List[Dict[str, float]]:
    """The record of this thread's last
    :func:`compute_lane_partials_torch` call (empty before the first)."""
    return list(getattr(_PRODUCER, "stats", ()))


def compute_lane_partials_torch(store: TraceStore,
                                work_items: Sequence[Tuple[int,
                                                           Sequence[int]]],
                                lanes: Sequence[LanePlan],
                                device,
                                persist: bool = True,
                                ) -> Dict[int, List[ShardPartial]]:
    """The torch backend's fused dirty-shard producer: ONE batched device
    reduction per reducer over every (query lane × dirty shard) slot's
    raw events, sliced back into per-slot DEVICE partials (the
    post-segment-reduce float32 tensors).

    Each slot contributes a ragged block of the flat segment space — its
    predicate-filtered rows' touched bins × its local group keys — so
    the device cost is proportional to the rows actually reduced, and
    one dispatch per (reducer-suite group, reducer) serves any number of
    shards AND queries (shard files are read once and shared across
    lanes; slots are grouped by suite so a quantile lane never drags
    moments-only lanes' rows through the histogram kernel). Lanes with
    fewer metrics than the widest lane ride the same (M_max, N) value
    matrix zero-padded; per-metric segment reduction is independent, so
    the padding never touches a kept metric's sums.

    Row order is what both bit-identity guarantees (delta vs cold, fused
    batch vs standalone) rest on. Rows are taken slot-wise
    (:func:`_slotwise_device_partition`, one device), then put in a
    stable order by segment within each slot — one stable argsort of the
    concatenated ids, since slots own disjoint, increasing segment
    ranges. The binstats kernel walks each segment's rows in that order,
    so every slot's float32 partial is a fixed-order function of its own
    rows, whatever else is in the batch. The ordered ids, values and
    valid mask are uploaded ONCE per suite and shared by its reducers.

    With ``persist``, each partial lands in its lane's
    ``precision="torch-float32"`` partial namespace stamped with the
    shard fingerprint — the cache a later delta serves clean shards from
    without touching the device.
    """
    import torch

    scans = []          # (lane idx, fingerprint, partial, raw rows)
    for idx, lane_ids in work_items:
        if not store.has_shard(int(idx)):
            continue
        fp = store.stat_shard(int(idx))
        cols = store.read_shard(int(idx))
        for li in lane_ids:
            lane = lanes[li]
            sp, rows = _scan_shard(store, int(idx), lane.plan,
                                   lane.metrics, lane.query.group_by,
                                   query=lane.query, cols=cols)
            scans.append((li, fp, sp, rows))

    # ragged flat segment space: slot k owns segments
    # [off_k, off_k + B_k*G_k) in scan order, one batch per reducer suite
    stats: List[Dict[str, float]] = []
    _PRODUCER.stats = stats
    all_live = [s for s in scans if s[3] is not None]
    groups: Dict[Tuple[str, ...], List] = {}
    for s in all_live:
        groups.setdefault(lanes[s[0]].reducers, []).append(s)
    for suite, live in groups.items():
        m_max = max(len(lanes[li].metrics) for li, _, _, _ in live)
        seg_sizes = [len(sp.bins) * len(sp.group_keys)
                     for _, _, sp, _ in live]
        seg_offs = np.concatenate([[0], np.cumsum(seg_sizes)])
        n_seg = int(seg_offs[-1])
        # segment count rounded up to a 128 multiple, as the reference
        # does: the surplus segments receive no rows and are never sliced
        n_seg_dev = -(-max(n_seg, 1) // 128) * 128
        seg_all = np.concatenate(
            [local_bin * len(sp.group_keys) + gids + seg_offs[k]
             for k, (_, _, sp, (_, _, local_bin, gids))
             in enumerate(live)])
        vals_parts = []
        for _, _, _, rows in live:
            v = rows[1]
            if v.shape[0] < m_max:
                v = np.pad(v, ((0, m_max - v.shape[0]), (0, 0)))
            vals_parts.append(v)
        vals_all = np.concatenate(vals_parts, axis=1)
        row, valid = _slotwise_device_partition(
            [len(rows[0]) for _, _, _, rows in live], 1)
        t_order = time.perf_counter()
        seg_p = seg_all[row].astype(np.int32)
        seg_p[~valid] = 0
        order = np.argsort(seg_p, kind="stable")
        seg_p, row, valid = seg_p[order], row[order], valid[order]
        order_s = time.perf_counter() - t_order
        seg_t = torch.from_numpy(seg_p).to(device)
        vals_t = torch.from_numpy(
            np.ascontiguousarray(vals_all[:, row], np.float32)).to(device)
        valid_t = torch.from_numpy(valid).to(device)
        stats.append({"rows": int(seg_p.shape[0]), "n_seg": n_seg_dev,
                      "metrics": m_max, "order_seconds": order_s})
        reduced = {name: get_reducer(name).device_reduce(
                       seg_t, vals_t, n_seg_dev, device, valid_t)
                   for name in suite}         # (n_seg_dev, M_max, *priv)
        for k, (li, _, sp, _) in enumerate(live):
            lane = lanes[li]
            shape = (len(sp.bins), len(sp.group_keys), m_max)
            sp.states = {
                name: get_reducer(name).from_device_block(
                    reduced[name][seg_offs[k]:seg_offs[k + 1]].reshape(
                        shape + reduced[name].shape[2:])
                    [:, :, :len(lane.metrics)])
                for name in lane.reducers}

    out: Dict[int, List[ShardPartial]] = collections.defaultdict(list)
    batches: Dict[int, Dict] = collections.defaultdict(dict)
    for li, fp, sp, _ in scans:
        lane = lanes[li]
        if persist and lane.qkey and fp is not None:
            batches[sp.idx][lane.qkey] = shard_partial_payload(
                sp, lane.plan, lane.metrics, lane.query.group_by, fp)
        out[li].append(sp)
    # one pack write per shard, all lanes batched — same consolidation
    # as the host producer
    for idx, batch in batches.items():
        store.write_partials(int(idx), batch)
    return out


def rank_partial_from_shards(shard_partials: Sequence[ShardPartial],
                             n_bins: int, n_metrics: int,
                             reducers: Sequence[str] = DEFAULT_REDUCERS,
                             ) -> Tuple[GroupedPartial,
                                        Dict[int, np.ndarray]]:
    """Suite-generic merge of one rank's shard partials (in shard-index
    order, so the merge sequence — and thus every float rounding — is
    independent of which partials came from cache and which were just
    recomputed, the property the bit-identity guarantee rests on).

    Each shard's SPARSE rows are folded in place into one dense state per
    group key (``merge_at``) — O(bins-the-shard-touched) per shard, not
    O(n_bins); without this the merge would rival the raw scan it is
    supposed to replace and the incremental speedup would evaporate."""
    suite = normalize_reducers(reducers)
    groups: Dict[float, Dict[str, Any]] = {}
    kind_parts = []
    for sp in sorted(shard_partials, key=lambda p: p.idx):
        for gi, key in enumerate(sp.group_keys):
            states = groups.get(float(key))
            if states is None:
                states = {name: get_reducer(name).zeros(n_bins,
                                                        (n_metrics,))
                          for name in suite}
                groups[float(key)] = states
            for name in suite:
                states[name].merge_at(sp.bins,
                                      sp.states[name].take_group(gi))
        kind_parts.append(sp.kind_dict())
    partial = GroupedPartial(n_bins=n_bins, n_metrics=n_metrics,
                             reducers=suite, groups=groups)
    return partial, merge_kind_parts(kind_parts)


def load_rank_grouped(store: TraceStore, shard_ids: Sequence[int],
                      plan: ShardPlan, metrics: Sequence[str],
                      group_by: Optional[str] = None,
                      reducers: Sequence[str] = DEFAULT_REDUCERS,
                      ) -> Tuple[GroupedPartial, Dict[int, np.ndarray]]:
    """One rank's aggregation work: produce each shard's partial, merge
    them. Kept as the uncached one-shot form of the split producer/merge
    pair (``compute_shard_partial`` + ``rank_partial_from_shards``)."""
    metrics = list(metrics)
    suite = normalize_reducers(reducers)
    parts = compute_partials(store, [int(s) for s in shard_ids], plan,
                             metrics, group_by, suite)
    return rank_partial_from_shards(parts, plan.n_shards, len(metrics),
                                    suite)


def load_rank_partials(store: TraceStore, shard_ids: Sequence[int],
                       plan: ShardPlan, metric: str = DEFAULT_METRIC,
                       metrics: Optional[Sequence[str]] = None,
                       group_by: Optional[str] = None,
                       ):
    """One rank's aggregation work: load its N/P shard files, bin, reduce.

    Legacy form (``metrics=None``, no ``group_by``) returns
    ``(BinStats(n_bins,), kind_bytes)`` exactly as before. With ``metrics``
    and/or ``group_by`` it returns ``(GroupedPartial, kind_bytes)``.
    """
    if metrics is None and group_by is None:
        partial, kind_bytes = load_rank_grouped(
            store, shard_ids, plan, [metric], None)
        dense = partial.densify([_NO_GROUP_KEY])["moments"]
        return dense.take_group(0).select_metric(0), kind_bytes
    return load_rank_grouped(store, shard_ids, plan,
                             metrics if metrics is not None else [metric],
                             group_by)


def union_group_keys(partials: Sequence[GroupedPartial]) -> List[float]:
    """Global group key ordering every rank densifies against."""
    keys = set()
    for p in partials:
        keys.update(p.groups.keys())
    return sorted(keys) if keys else [_NO_GROUP_KEY]


def round_robin_merge(partials: List[Any], n_bins: int,
                      ) -> Tuple[Any, List[np.ndarray]]:
    """The paper's collaborative round-robin statistic computation.

    Bin ownership is cyclic: rank r owns bins r, r+P, r+2P, ... Every rank
    merges ALL partials for ITS bins only (balanced, contention-free), then
    owned segments are concatenated back into the global result — the
    MPI/file analogue of `psum_scatter` followed by `all_gather`. Generic
    over any registered reducer state (all partials must share one type),
    for 1-D and (n_bins, n_groups, n_metrics) tensors alike.
    """
    P = max(len(partials), 1)
    owned = cyclic_assignment(n_bins, P)
    cls = type(partials[0]) if partials else BinStats
    trailing = partials[0].trailing if partials else ()
    merged = cls.zeros(n_bins, trailing)
    for r in range(P):
        idx = owned[r]
        if idx.size == 0:
            continue
        seg = cls.zeros(idx.size, trailing)
        for p in partials:
            seg = seg.merge(p.take_bins(idx))
        merged.assign_bins(idx, seg)
    return merged, owned


def lookup_summary(store: TraceStore, plan: ShardPlan,
                   metrics: Sequence[str], group_by: Optional[str],
                   t0: float, precision: str = "exact",
                   reducers: Sequence[str] = DEFAULT_REDUCERS,
                   query: Optional[Query] = None,
                   ) -> Tuple[str, Optional["AggregationResult"]]:
    """One cache probe shared by every aggregation driver: returns the
    summary key for this (canonical query, plan, precision) and the
    decoded cached result on a hit (None on a miss). A hit additionally
    requires the payload's ``covered`` shard fingerprints to equal the
    store's CURRENT fingerprint — a summary never outlives a shard
    write — and the payload's metric ORDER to equal the expected one
    (the engine writes canonical order; a same-key payload with a
    different axis order must never be served). A payload whose embedded
    version differs from the running SUMMARY_VERSION — e.g. a file
    written by an older engine — is likewise a miss, not a crash."""
    suite = normalize_reducers(reducers)
    key = store.summary_key((plan.t_start, plan.t_end, plan.n_shards),
                            metrics, group_by, precision=precision,
                            reducers=suite, query=query)
    payload = store.read_summary(key)
    if payload is None or int(payload.get(
            "version", np.asarray(-1))) != SUMMARY_VERSION:
        return key, None
    if [str(m) for m in payload["metrics"]] != list(metrics):
        return key, None
    covered = payload.get("covered")
    now = store.shard_fingerprint_array()
    if covered is None or not np.array_equal(covered, now):
        return key, None
    return key, result_from_summary(payload, time.perf_counter() - t0)


def densify_partials(partials: Sequence[GroupedPartial],
                     ) -> Tuple[List[float], List[Dict[str, Any]]]:
    """Global key union + per-rank dense tensors (the pre-merge step)."""
    all_keys = union_group_keys(partials)
    return all_keys, [p.densify(all_keys) for p in partials]


def finalize_aggregation(store: TraceStore, plan: ShardPlan,
                         metrics: Sequence[str], group_by: Optional[str],
                         all_keys: Sequence[float],
                         dense: List[Dict[str, Any]],
                         kind_parts: Sequence[Dict[int, np.ndarray]],
                         key: Optional[str], t0: float,
                         reducers: Sequence[str] = DEFAULT_REDUCERS,
                         covered: Optional[Sequence[Tuple[int, int, int]]]
                         = None) -> "AggregationResult":
    """Shared tail of every aggregation driver: round-robin merge the
    dense per-rank tensors (per reducer), fold the transfer-kind
    breakdown, build the result, and (when ``key`` is set) persist the
    summary stamped with the shard fingerprints it covers (``covered``
    lets the caller reuse an already-taken stat pass)."""
    suite = normalize_reducers(reducers)
    merged = {name: round_robin_merge([d[name] for d in dense],
                                      plan.n_shards)[0]
              for name in suite}
    kind_bytes = merge_kind_parts(kind_parts)
    result = build_result(plan, metrics, group_by, all_keys, merged,
                          [d["moments"] for d in dense], kind_bytes,
                          time.perf_counter() - t0)
    if key is not None:
        if covered is None:
            covered = store.shard_fingerprint()
        store.write_summary(key, summary_payload(
            plan, metrics, group_by, result.group_keys, merged,
            kind_bytes, covered=covered))
    return result


# --- summary-cache (de)serialization ---------------------------------------

def summary_payload(plan: ShardPlan, metrics: Sequence[str],
                    group_by: Optional[str], group_keys: np.ndarray,
                    merged: Dict[str, Any],
                    kind_bytes: Dict[int, np.ndarray],
                    covered: Sequence[Tuple[int, int, int]] = (),
                    ) -> Dict[str, np.ndarray]:
    kinds = sorted(kind_bytes)
    payload = {
        "version": np.asarray(SUMMARY_VERSION, np.int64),
        "covered": np.asarray(covered, np.int64).reshape(-1, 3),
        "t_start": np.asarray(plan.t_start, np.int64),
        "t_end": np.asarray(plan.t_end, np.int64),
        "n_shards": np.asarray(plan.n_shards, np.int64),
        "metrics": np.asarray(list(metrics)),
        "group_by": np.asarray(group_by or ""),
        "group_keys": np.asarray(group_keys, np.float64),
        "reducers": np.asarray(list(merged)),
        "kind_keys": np.asarray(kinds, np.int64),
        "kind_bytes": (np.stack([kind_bytes[k] for k in kinds])
                       if kinds else np.zeros((0, plan.n_shards))),
    }
    for state in merged.values():
        payload.update(state.to_payload())
    return payload


def result_from_summary(payload: Dict[str, np.ndarray], seconds: float,
                        ) -> AggregationResult:
    plan = ShardPlan(int(payload["t_start"]), int(payload["t_end"]),
                     int(payload["n_shards"]))
    suite = tuple(str(r) for r in payload["reducers"])
    merged = {name: get_reducer(name).from_payload(payload)
              for name in suite}
    metrics = [str(m) for m in payload["metrics"]]
    group_by = str(payload["group_by"]) or None
    kind_bytes = {int(k): payload["kind_bytes"][i]
                  for i, k in enumerate(payload["kind_keys"])}
    grouped = merged["moments"]
    return AggregationResult(
        plan=plan, metric=metrics[0],
        stats=grouped.merge_groups().select_metric(0),
        per_rank_stats=[], copy_kind_bytes=kind_bytes, seconds=seconds,
        metrics=metrics, group_by=group_by,
        group_keys=np.asarray(payload["group_keys"]), grouped=grouped,
        from_cache=True, reducers=suite, reduced=merged,
        recomputed_shards=[])


def merge_kind_parts(kind_parts: Sequence[Dict[int, np.ndarray]],
                     ) -> Dict[int, np.ndarray]:
    kind_bytes: Dict[int, np.ndarray] = {}
    for kp in kind_parts:
        for k, v in kp.items():
            kind_bytes[k] = kind_bytes.get(k, 0) + v
    return kind_bytes


def build_result(plan: ShardPlan, metrics: Sequence[str],
                 group_by: Optional[str], group_keys: Sequence[float],
                 merged: Dict[str, Any], per_rank: List[BinStats],
                 kind_bytes: Dict[int, np.ndarray], seconds: float,
                 ) -> AggregationResult:
    metrics = list(metrics)
    grouped = merged["moments"]
    return AggregationResult(
        plan=plan, metric=metrics[0],
        stats=grouped.merge_groups().select_metric(0),
        per_rank_stats=per_rank, copy_kind_bytes=kind_bytes,
        seconds=seconds, metrics=metrics, group_by=group_by,
        group_keys=np.asarray(group_keys, np.float64), grouped=grouped,
        reducers=tuple(merged), reduced=merged)


def _merge_lane(parts: Sequence[ShardPartial], n_shard_files: int,
                n_ranks: int, plan: ShardPlan, n_metrics: int,
                suite: Sequence[str],
                ) -> Tuple[List[float], List[Dict[str, Any]],
                           List[Dict[int, np.ndarray]]]:
    """The merge tail EVERY driver shares (legacy single-query and fused
    batch alike — one code path is what keeps fused results bit-identical
    to standalone runs): group shard partials by owning rank (block
    assignment over shard FILES), fold each rank's partials in
    shard-index order, densify under the global key union."""
    shard_sets = assignment(n_shard_files, n_ranks, "block")
    rank_of = np.zeros(max(n_shard_files, 1), np.int64)
    for r, ids in enumerate(shard_sets):
        rank_of[ids] = r
    per_rank: List[List[ShardPartial]] = [[] for _ in range(n_ranks)]
    for sp in parts:
        per_rank[int(rank_of[sp.idx])].append(sp)
    partials, kind_parts = [], []
    for ps in per_rank:
        gp, kb = rank_partial_from_shards(ps, plan.n_shards, n_metrics,
                                          suite)
        partials.append(gp)
        kind_parts.append(kb)
    all_keys, dense = densify_partials(partials)
    return all_keys, dense, kind_parts


def _present(result: AggregationResult, lane: LanePlan,
             ) -> AggregationResult:
    """Permute a result computed (or cached) in canonical metric order
    back to the caller's requested order. Exact: each metric's tensors
    were accumulated independently, so reordering the metric axis is a
    pure relabeling — which is why an old-style call and a reordered
    Query can share one cache entry bit-identically."""
    user = list(lane.query.metrics)
    canon = list(lane.metrics)
    if user == canon:
        return result
    perm = np.asarray([canon.index(m) for m in user], np.int64)
    result.reduced = {name: st.take_metrics(perm)
                      for name, st in result.reduced.items()}
    result.grouped = result.reduced["moments"]
    result.stats = result.grouped.merge_groups().select_metric(0)
    result.per_rank_stats = [p.take_metrics(perm)
                             for p in result.per_rank_stats]
    result.metrics = user
    result.metric = user[0]
    return result


def execute_plan(qplan: QueryPlan, use_cache: bool = True,
                 compute_fn=None,
                 pool: Optional[ScanPool] = None) -> List[QueryResult]:
    """Run a compiled query batch as ONE fused execution.

    Per lane: summary probe (a hit answers the query in O(n_bins) with
    zero shard reads). The misses share a single stat pass and a single
    scan over the UNION of their dirty shards — each shard file is read
    once, and every lane needing it reduces its own metric/group/
    predicate selection off the shared columns (host backends) or rides
    the same batched device reduction (torch). Each lane then merges its
    clean cached partials with the fresh ones through the same tail as a
    standalone run — fused results are bit-identical to sequential
    single-query runs on every backend (tested).

    ``compute_fn(work_items, qplan, persist)`` overrides the producer
    (any custom scheduler); the default dispatches
    on ``qplan.backend``. ``pool`` hands the host producer a persistent
    :class:`ScanPool` — dirty shards scan concurrently and pack appends
    ride the pool's single writer; results stay bit-identical to the
    serial scan (ignored by the torch backend and ``compute_fn``).
    """
    t0 = time.perf_counter()
    store = qplan.store
    results: List[Optional[QueryResult]] = [None] * len(qplan.lanes)
    # batch-level dedupe: lanes whose canonical identity coincides
    # (reordered metrics/reducers, equivalent predicates) share ONE
    # computation; followers re-present the leader's canonical result
    # in their own metric order
    leader_of: Dict[Tuple[str, Tuple[int, int, int]], int] = {}
    followers: Dict[int, int] = {}
    raw: Dict[int, AggregationResult] = {}     # canonical-order results
    live: List[int] = []
    for i, lane in enumerate(qplan.lanes):
        ident = (lane.query.cache_key(),
                 (lane.plan.t_start, lane.plan.t_end, lane.plan.n_shards))
        if ident in leader_of:
            followers[i] = leader_of[ident]
            continue
        leader_of[ident] = i
        if use_cache:
            key, cached = lookup_summary(
                store, lane.plan, list(lane.metrics), lane.query.group_by,
                t0, precision=lane.precision, reducers=lane.reducers,
                query=lane.query)
            lane.summary_key = key
            if cached is not None:
                raw[i] = cached
                results[i] = QueryResult(
                    query=lane.query,
                    result=_present(dataclasses.replace(cached), lane),
                    cache_hit=True, shards_pruned=lane.shards_pruned,
                    rows_scanned=0, rows_filtered=0, recomputed_shards=0,
                    partial_hits=0)
                continue
        else:
            lane.summary_key = None
        live.append(i)

    if live:
        # ONE (memoized) stat pass serves every lane's dirty
        # classification AND the summaries' covered fingerprints
        snap = store.shard_stats()
        indices = [i for i in sorted(snap) if i < qplan.n_shard_files]
        stats = {i: snap[i] for i in indices}
        # covered must describe EVERY shard file (stray indices past the
        # manifest count included) to match lookup_summary's live compare
        covered = sorted(snap.values())
        lane_clean: Dict[int, List[ShardPartial]] = {}
        lane_dirty: Dict[int, List[int]] = {}
        work: Dict[int, List[int]] = {}
        for i in live:
            lane = qplan.lanes[i]
            if lane.pruned is None:
                pruned = indices
            else:
                pruned_set = set(lane.pruned)
                pruned = [s for s in indices if s in pruned_set]
            _, clean, dirty = classify_shards(
                store, pruned, lane.plan, list(lane.metrics),
                lane.query.group_by, lane.reducers, use_cache,
                stats=stats, precision=lane.precision, query=lane.query)
            lane_clean[i], lane_dirty[i] = clean, dirty
            for s in dirty:
                work.setdefault(int(s), []).append(i)
        work_items = sorted(work.items())
        if compute_fn is not None:
            fresh = compute_fn(work_items, qplan, use_cache)
        elif qplan.backend == "torch":
            fresh = compute_lane_partials_torch(store, work_items,
                                                qplan.lanes, qplan.device,
                                                persist=use_cache)
        else:
            fresh = compute_lane_partials(store, work_items, qplan.lanes,
                                          persist=use_cache, pool=pool)
        for i in live:
            lane = qplan.lanes[i]
            computed = fresh.get(i, [])
            all_keys, dense, kind_parts = _merge_lane(
                lane_clean[i] + list(computed), qplan.n_shard_files,
                qplan.n_ranks, lane.plan, len(lane.metrics),
                lane.reducers)
            result = finalize_aggregation(
                store, lane.plan, list(lane.metrics), lane.query.group_by,
                all_keys, dense, kind_parts,
                lane.summary_key if use_cache else None, t0,
                reducers=lane.reducers, covered=covered)
            result.recomputed_shards = sorted(
                int(s) for s in lane_dirty[i])
            result.partial_hits = len(lane_clean[i])
            raw[i] = result
            results[i] = QueryResult(
                query=lane.query,
                result=_present(dataclasses.replace(result), lane),
                cache_hit=False, shards_pruned=lane.shards_pruned,
                rows_scanned=sum(sp.rows_seen for sp in computed),
                rows_filtered=sum(sp.rows_seen - sp.rows_kept
                                  for sp in computed),
                recomputed_shards=len(lane_dirty[i]),
                partial_hits=len(lane_clean[i]))
    for j, i in followers.items():
        lane_j = qplan.lanes[j]
        src = results[i]
        results[j] = QueryResult(
            query=lane_j.query,
            result=_present(dataclasses.replace(raw[i]), lane_j),
            cache_hit=src.cache_hit, shards_pruned=lane_j.shards_pruned,
            rows_scanned=src.rows_scanned,
            rows_filtered=src.rows_filtered,
            recomputed_shards=src.recomputed_shards,
            partial_hits=src.partial_hits)
    return results


def run_queries(store: Union[str, TraceStore], queries: Sequence[Query],
                n_ranks: Optional[int] = None, backend: str = "serial",
                use_cache: bool = True,
                pool: Optional[ScanPool] = None,
                device: str = "cuda") -> List[QueryResult]:
    """Compile + execute a batch of declarative queries as one fused
    scan (``serial`` exact host scan, or ``torch`` on ``device``).
    Results come back in query order, each with execution provenance.
    ``pool`` parallelizes the serial backend's dirty-shard scan (see
    :class:`ScanPool`)."""
    qplan = QueryPlan.compile(store, list(queries), backend=backend,
                              n_ranks=n_ranks, device=device)
    return qplan.execute(use_cache=use_cache, pool=pool)


def run_incremental(store: TraceStore, n_shard_files: int, plan: ShardPlan,
                    metrics: Sequence[str], group_by: Optional[str],
                    n_ranks: int, use_cache: bool, key: Optional[str],
                    t0: float,
                    reducers: Sequence[str] = DEFAULT_REDUCERS,
                    compute_fn=None,
                    precision: str = "exact") -> AggregationResult:
    """The incremental core EVERY backend shares: classify shards
    clean/dirty, recompute only the dirty ones (``compute_fn(dirty, qkey)``
    — serial here by default), then
    merge cached + fresh partials per rank in shard order and round-robin
    across ranks. Cold run == incremental run with every shard dirty,
    through the identical merge path — which is why a delta aggregation
    is bit-identical to a cold one (per-shard partials are pure
    functions of each shard's own rows). ``precision`` must match the
    producer ``compute_fn`` wires in so partials land in — and are
    served from — the right namespace.

    Legacy driver note: this entry point computes (and caches) in the
    metric order GIVEN, while cache keys canonicalize that order. A
    non-canonical order still yields correct results — the payload
    metric-order guards in :func:`classify_shards`/:func:`lookup_summary`
    turn any mismatch into a miss — but it will not SHARE cache entries
    with the canonical engine (each side overwrites the other's files).
    Pass metrics sorted, or use :func:`run_queries` /
    :func:`run_aggregation`, which canonicalize for you."""
    mlist = list(metrics)
    suite = normalize_reducers(reducers)
    # ONE (memoized) stat pass serves dirty classification AND the
    # summary's covered fingerprints
    snap = store.shard_stats()
    indices = [i for i in sorted(snap) if i < n_shard_files]
    stats = {i: snap[i] for i in indices}
    qkey, clean, dirty = classify_shards(store, indices, plan, mlist,
                                         group_by, suite, use_cache,
                                         stats=stats, precision=precision)
    if compute_fn is None:
        def compute_fn(idxs, qk):
            return compute_partials(store, idxs, plan, mlist, group_by,
                                    suite, qk)
    computed = list(compute_fn(dirty, qkey if use_cache else None))

    all_keys, dense, kind_parts = _merge_lane(
        clean + computed, n_shard_files, n_ranks, plan, len(mlist), suite)
    # covered must describe EVERY shard file (stray indices past the
    # manifest count included) to match lookup_summary's live compare
    covered = sorted(snap.values())
    result = finalize_aggregation(store, plan, mlist, group_by, all_keys,
                                  dense, kind_parts, key, t0,
                                  reducers=suite, covered=covered)
    result.recomputed_shards = sorted(int(i) for i in dirty)
    result.partial_hits = len(clean)
    return result


# sentinel distinguishing "caller explicitly spelled a legacy kwarg"
# from the defaults — the deprecation path must not fire on bare calls
_LEGACY_UNSET: Any = object()


def run_aggregation(store: Union[str, TraceStore],
                    n_ranks: Optional[int] = None,
                    metric: str = _LEGACY_UNSET,
                    interval_ns: Optional[int] = _LEGACY_UNSET,
                    metrics: Optional[Sequence[str]] = _LEGACY_UNSET,
                    group_by: Optional[str] = _LEGACY_UNSET,
                    use_cache: bool = True,
                    reducers: Sequence[str] = _LEGACY_UNSET,
                    backend: str = "serial",
                    query: Optional[Query] = None,
                    device: str = "cuda",
                    ) -> AggregationResult:
    """Full phase-2 driver — now a thin adapter over the declarative
    query engine: the kwargs are folded into a :class:`Query` and run as
    a single-lane :class:`QueryPlan` (pass ``query=`` directly to skip
    the folding; the remaining query-shaped kwargs are then ignored).
    Old-style and Query-style calls describing the same question share
    cache entries and return bit-identical results.

    ``interval_ns`` may re-bin at a different granularity than generation —
    the "global dictionary with timestamps as keys and a fixed user-defined
    duration" is defined here, independent of the shard layout on disk.

    ``metrics`` (list) and ``group_by`` (a shard column such as ``k_name``,
    ``k_device`` or ``m_kind``) select the one-pass multi-metric grouped
    tensors; ``reducers`` picks the statistic suite (``"moments"`` is
    always included; add ``"quantile"`` for per-bin P50/P95/P99/IQR).

    ``backend`` is ``"serial"`` (exact float64 host scan) or ``"torch"``
    (dirty shards reduced by the CUDA kernels on ``device``, float32 —
    summaries and partials live in their own precision namespace so the
    two producers never serve each other).

    With ``use_cache`` the run is fully incremental ON EVERY BACKEND: an
    unchanged store is answered from the merged summary without touching
    shards, and a store with rewritten/appended shards rescans ONLY
    those (clean shards come from the per-shard partial cache) —
    ``result.recomputed_shards`` / ``partial_hits`` report exactly what
    was read.
    """
    if backend not in ("serial", "torch"):
        raise ValueError(f"unknown backend {backend!r} (serial | torch)")
    legacy = [name for name, v in (("metric", metric),
                                   ("interval_ns", interval_ns),
                                   ("metrics", metrics),
                                   ("group_by", group_by),
                                   ("reducers", reducers))
              if v is not _LEGACY_UNSET]
    if metric is _LEGACY_UNSET:
        metric = DEFAULT_METRIC
    if interval_ns is _LEGACY_UNSET:
        interval_ns = None
    if metrics is _LEGACY_UNSET:
        metrics = None
    if group_by is _LEGACY_UNSET:
        group_by = None
    if reducers is _LEGACY_UNSET:
        reducers = DEFAULT_REDUCERS
    if query is None:
        if legacy:
            warnings.warn(
                f"run_aggregation({', '.join(f'{n}=...' for n in legacy)})"
                " is the legacy spelling — build a repro_torch.core.query.Query"
                " and pass query=... (or use VariabilityPipeline.query);"
                " the folded Query mints an IDENTICAL cache key, so warm"
                " caches stay warm across the migration",
                DeprecationWarning, stacklevel=2)
        mlist = list(metrics) if metrics is not None else [metric]
        if not mlist:
            raise ValueError("metrics must name at least one shard column")
        query = Query(metrics=tuple(mlist), group_by=group_by,
                      reducers=normalize_reducers(reducers),
                      interval_ns=interval_ns)
    return run_queries(store, [query], n_ranks=n_ranks, backend=backend,
                       use_cache=use_cache, device=device)[0].result
