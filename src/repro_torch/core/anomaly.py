"""IQR anomaly detection (paper §3: "we select the top 5 anomalous shards
using the Inter-quartile Range (IQR) method [Whaley 2014]").

Given per-bin statistics, a bin is *anomalous* when its score exceeds the
Tukey upper fence  Q3 + k·IQR  (k = 1.5 by default).  The paper reports the
top-5 anomalous shards; we rank flagged bins by their fence exceedance and
return the top-k.  Also provides the Fig-1b selection: top q% of bins by
variability (std).

Scores come from the aggregation's reducer suite (see
:mod:`repro_torch.core.reducers`):

  * moment scores  — ``"mean" | "std" | "max" | "sum"`` derive from the
    :class:`BinStats` moment tensor (any suite);
  * quantile scores — ``"p50" | "p95" | "p99"`` (any ``"pNN"``) and
    ``"iqr"`` (within-bin Q3-Q1) derive from the
    :class:`~repro_torch.core.reducers.QuantileSketch` log-bucket histograms,
    so they need ``"quantile"`` in the suite. Fencing on ``"p99"`` flags
    bins whose duration *tail* blew up even when the bin mean stayed flat
    — the paper's headline within-bin variability diagnostic.

The detectors accept a 1-D per-bin state, the grouped tensor, or a whole
:class:`~repro_torch.core.aggregation.AggregationResult` (from which the right
reducer state is picked automatically).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.iqr.ops import iqr_fences
from .aggregation import AggregationResult, BinStats
# score-spec parsing lives with the declarative Query (whose canonical
# form folds a quantile score's implied reducer into the suite);
# re-exported here because this is the detector module callers reach for
from .query import Query, _PCT_RE, is_quantile_score  # noqa: F401
from .reducers import SUBDIV, QuantileSketch


def report_for_query(result: AggregationResult, query: Query,
                     k: float = 1.5, top_k: int = 5,
                     metric_idx: int = 0,
                     device: str = "cuda") -> "IQRReport":
    """Fence a query's result on the query's own ``anomaly_score`` spec —
    the detector-side half of the declarative surface (the aggregation
    half already guaranteed the needed reducer is in the suite, because
    the canonical form folds it in)."""
    return anomalous_bins(result, k=k, top_k=top_k,
                          boundaries=result.plan.boundaries(),
                          score=query.anomaly_score, metric_idx=metric_idx,
                          device=device)


def quartiles(x: np.ndarray) -> Tuple[float, float, float]:
    """(Q1, median, Q3) with linear interpolation — matches np.percentile
    (a host helper; the fences themselves run the ``iqr`` kernel)."""
    if x.size == 0:
        return (0.0, 0.0, 0.0)
    q1, q2, q3 = np.percentile(x, [25.0, 50.0, 75.0])
    return float(q1), float(q2), float(q3)


@dataclasses.dataclass
class IQRReport:
    q1: float
    q3: float
    iqr: float
    lo_fence: float
    hi_fence: float
    flags: np.ndarray           # bool (n_bins,) — outside the fences
    scores: np.ndarray          # the per-bin score that was fenced
    top_idx: np.ndarray         # top-k anomalous bin indices, ranked
    top_windows: np.ndarray     # (k, 2) int64 ns — bin time bounds


def iqr_detect(scores: np.ndarray, k: float = 1.5, top_k: int = 5,
               boundaries: Optional[np.ndarray] = None,
               two_sided: bool = False, device: str = "cuda") -> IQRReport:
    """Tukey-fence detection over per-bin scores.

    Q1/Q3, the fences and the flags come from the ``iqr`` kernel on
    ``device`` in float64, rounded as the reference's ``np.percentile``
    rounds them (equal bit for bit); ranking the flagged bins stays on the
    host.
    ``boundaries`` (n_bins+1,) converts flagged bin indices into time
    windows (the paper reports anomalous *shards*, i.e. time intervals).
    """
    scores = np.asarray(scores, np.float64)
    if scores.size == 0:
        return IQRReport(q1=0.0, q3=0.0, iqr=0.0, lo_fence=0.0,
                         hi_fence=0.0, flags=np.zeros(0, bool),
                         scores=scores, top_idx=np.zeros(0, np.int64),
                         top_windows=np.zeros((0, 2), np.int64))
    # Fences are estimated over the *occupied* bins: empty bins score 0 and
    # would otherwise drag Q1/Q3 toward zero on sparse traces. With no
    # occupied bin at all, every bin is fenced (all scores are 0 then).
    occupied = scores != 0.0
    fenced = occupied if occupied.any() else np.ones_like(occupied)
    dev = resolve_device(device)
    out = iqr_fences(
        torch.as_tensor(scores, dtype=torch.float64, device=dev),
        torch.as_tensor(fenced, device=dev), k_factor=k)
    q1, q3, iqr, lo, hi = (float(x) for x in out["stats"][:5].cpu())
    # the kernel flags fenced bins; a bin left out of the fences (score
    # 0) is still flagged when it lies above the upper fence
    flags = (out["flags"].cpu().numpy().astype(bool)
             | (~fenced & (scores > hi)))
    if two_sided:
        flags |= scores < lo

    exceed = np.where(flags, np.abs(scores - np.clip(scores, lo, hi)), -1.0)
    order = np.argsort(-exceed, kind="stable")
    top = order[: min(top_k, int(flags.sum()))]

    if boundaries is not None and top.size:
        wins = np.stack([boundaries[top], boundaries[top + 1]],
                        axis=1).astype(np.int64)
    else:
        wins = np.zeros((top.size, 2), np.int64)
    return IQRReport(q1=q1, q3=q3, iqr=iqr, lo_fence=lo, hi_fence=hi,
                     flags=flags, scores=scores, top_idx=top,
                     top_windows=wins)


def _as_1d(stats: BinStats, metric_idx: int = 0) -> BinStats:
    """Collapse a grouped (n_bins, n_groups, n_metrics) moment tensor to
    the 1-D per-bin view the detectors operate on: merge the group axis
    (every sample is in exactly one group, so this is the ungrouped
    statistic) and select one metric."""
    if stats.count.ndim == 3:
        stats = stats.merge_groups()
    if stats.count.ndim == 2:
        stats = stats.select_metric(metric_idx)
    return stats


def _sketch_1d(sk: QuantileSketch, metric_idx: int = 0) -> QuantileSketch:
    """Same collapse for the quantile sketch: group-merge + one metric."""
    sk = sk.merge_groups()
    if sk.counts.ndim == 3:
        sk = sk.select_metric(metric_idx)
    return sk


def score_values(stats, score: str = "mean",
                 metric_idx: int = 0) -> np.ndarray:
    """Per-bin score vector for any supported score name.

    ``stats`` may be a :class:`BinStats` (1-D or grouped tensor), a
    :class:`QuantileSketch`, or an :class:`AggregationResult` — the last
    carries the whole reducer suite, so both score families work on it.
    """
    m = _PCT_RE.match(score)
    if m or score == "iqr":
        if isinstance(stats, AggregationResult):
            sk = stats.reduced.get("quantile")
            if sk is None:
                raise ValueError(
                    f"score {score!r} needs the quantile sketch — "
                    "aggregate with reducers=('moments', 'quantile')")
        elif isinstance(stats, QuantileSketch):
            sk = stats
        else:
            raise ValueError(
                f"score {score!r} needs a QuantileSketch or an "
                "AggregationResult carrying one, got "
                f"{type(stats).__name__}")
        sk = _sketch_1d(sk, metric_idx)
        return sk.iqr() if score == "iqr" else sk.quantile(
            float(m.group(1)) / 100.0)

    if isinstance(stats, AggregationResult):
        stats = (stats.grouped if stats.grouped is not None
                 else stats.stats)
    if isinstance(stats, QuantileSketch):
        raise ValueError(f"moment score {score!r} cannot be computed "
                         "from a quantile sketch")
    stats = _as_1d(stats, metric_idx)
    if score == "mean":
        return stats.mean
    if score == "std":
        return stats.std
    if score == "max":
        return stats.finite_max()
    if score == "sum":
        return stats.sum
    raise ValueError(f"unknown score {score!r}")


def anomalous_bins(stats, k: float = 1.5, top_k: int = 5,
                   boundaries: Optional[np.ndarray] = None,
                   score: str = "mean", metric_idx: int = 0,
                   device: str = "cuda") -> IQRReport:
    """Paper's detector: IQR fences over a per-bin summary of the metric.

    Accepts 1-D per-bin stats, the grouped multi-metric tensor, a
    quantile sketch, or a whole AggregationResult (``metric_idx`` selects
    which metric to fence). Quantile-family scores (``"p99"``, ``"iqr"``,
    ...) fence on the within-bin duration distribution instead of the bin
    mean — see :func:`score_values` for the full score list."""
    s = score_values(stats, score, metric_idx)
    return iqr_detect(s, k=k, top_k=top_k, boundaries=boundaries,
                      device=device)


def sketch_shift(counts_a: np.ndarray, counts_b: np.ndarray,
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Distribution-shift scores between two quantile-sketch histograms,
    in OCTAVES (doublings of the metric) — the diff engine's core score.

    Both inputs are log2-bucket count tensors with the bucket axis LAST
    (any leading batch axes, broadcast together). Because the sketch
    buckets are uniform in log2 at ``SUBDIV`` buckets per octave, the
    area between the two normalized CDFs *is* the 1-D earth mover's
    distance on the log scale:

      signed  = sum_k (CDF_a[k] - CDF_b[k]) / SUBDIV
              = E_b[log2 x] - E_a[log2 x]   (bucket-midpoint estimate)
      spread  = sum_k |CDF_a[k] - CDF_b[k]| / SUBDIV   (total EMD)

    ``signed > 0`` means distribution B sits higher (slower);
    ``2**signed`` estimates the geometric-mean slowdown ratio, which is
    robust to the heavy tails that wreck arithmetic-mean ratios. The
    unsigned ``spread`` additionally catches reshaped distributions
    whose means cancel (e.g. a bimodal split). Empty histograms on
    either side score 0 — no evidence, no shift.
    """
    a = np.asarray(counts_a, np.float64)
    b = np.asarray(counts_b, np.float64)
    ta = a.sum(axis=-1, keepdims=True)
    tb = b.sum(axis=-1, keepdims=True)
    occupied = (ta[..., 0] > 0) & (tb[..., 0] > 0)
    cdf_a = np.cumsum(a, axis=-1) / np.maximum(ta, 1.0)
    cdf_b = np.cumsum(b, axis=-1) / np.maximum(tb, 1.0)
    d = cdf_a - cdf_b
    signed = np.where(occupied, d.sum(axis=-1) / SUBDIV, 0.0)
    spread = np.where(occupied, np.abs(d).sum(axis=-1) / SUBDIV, 0.0)
    return signed, spread


def top_variability_bins(stats: BinStats, quantile: float = 0.95,
                         metric_idx: int = 0) -> np.ndarray:
    """Fig-1b selection: indices of the top (1-quantile) bins by std."""
    stats = _as_1d(stats, metric_idx)
    std = stats.std
    occ = stats.count > 0
    if not occ.any():
        return np.zeros((0,), np.int64)
    thresh = np.quantile(std[occ], quantile)
    idx = np.nonzero(occ & (std >= thresh))[0]
    return idx[np.argsort(-std[idx], kind="stable")]


def recovered(windows_true: np.ndarray, windows_found: np.ndarray,
              tol_ns: int = 0) -> float:
    """Fraction of ground-truth anomaly windows overlapped by any detection
    (used by the paper-claim validation tests)."""
    if len(windows_true) == 0:
        return 1.0
    hit = 0
    for t0, t1 in np.asarray(windows_true):
        for f0, f1 in np.asarray(windows_found):
            if f0 - tol_ns < t1 and t0 < f1 + tol_ns:
                hit += 1
                break
    return hit / len(windows_true)
