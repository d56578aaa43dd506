"""Device backend for the paper's collaborative analysis, in PyTorch.

The reference backend (``repro.core.distributed``) maps the paper's MPI
ranks onto mesh devices: each device reduces its block of rows, then a
round-robin ``psum_scatter`` + ``all_gather`` (and ``pmin``/``pmax``)
merges the per-device tables. This port runs on one card, so that merge is
the identity (:func:`_collaborative_sum`, :func:`_collaborative_reduce`);
a ``torch.distributed`` group with more than one rank is refused until the
multi-rank merge is ported.

Where the reference calls ``jax.ops.segment_*``, the port calls its own
CUDA kernels on CUDA tensors, and their plain PyTorch versions on CPU
tensors:

  * :func:`binstats_local`, :func:`distributed_binstats_from_bins`,
    :func:`distributed_moments_flat` and the grouped form — the
    ``binstats`` kernel's flat form. On CUDA the rows must be
    segment-ordered (the phase-2 producer orders them; see
    :func:`repro_torch.core.aggregation.compute_lane_partials_torch`);
  * :func:`distributed_histogram_flat` and the grouped form — the
    ``histbin`` kernel's flat form; on CUDA the rows must be
    segment-ordered too (the same ordered upload feeds both reducers);
  * :func:`distributed_binstats` — the ``binstats`` kernel's timestamp
    form (float32 timestamps relative to the trace start);
  * :func:`distributed_iqr` — the ``iqr`` kernel.

Results stay on the input's device; every table keeps the reference's
layout and its ±3.4e38 min/max sentinels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels.binstats.ops import binstats, binstats_flat, disordered
# bucketize: the quantile sketch's float32 log2 bucket, shared with the
# histbin kernel's plain version (re-exported as the reference does)
from ..kernels.histbin.ops import bucketize, histbin_flat  # noqa: F401
from ..kernels.iqr.ops import iqr_fences
from .reducers import N_BUCKETS

STATS = 5   # count, sum, sumsq, min, max


def _world_size() -> int:
    """1 unless a ``torch.distributed`` group is up; more than one rank
    is not supported yet."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        ws = torch.distributed.get_world_size()
        if ws > 1:
            raise NotImplementedError(
                f"the collaborative merge across {ws} ranks is not ported "
                "yet; run at world size 1")
        return ws
    return 1


def _valid_or_all(valid: Optional[torch.Tensor],
                  seg_ids: torch.Tensor) -> torch.Tensor:
    if valid is None:
        return torch.ones(seg_ids.shape, dtype=torch.bool,
                          device=seg_ids.device)
    return valid


def binstats_local(bin_ids: torch.Tensor, values: torch.Tensor,
                   n_bins: int, valid: Optional[torch.Tensor] = None,
                   ) -> torch.Tensor:
    """Per-bin partial moments (n_bins, 5) for one device's samples, or
    (n_metrics, n_bins, 5) for a batched (n_metrics, N) ``values`` matrix
    sharing one ``bin_ids``/``valid`` vector. Bin ids are clipped into
    ``[0, n_bins)``; invalid rows are weightless; empty bins carry the
    ±3.4e38 sentinels. On CUDA tensors ``bin_ids`` must be non-decreasing
    (segment-ordered rows); unordered rows leave a NaN count, read without
    a synchronisation in the call (``kernels.binstats.ops.disordered``)."""
    return binstats_flat(bin_ids, values, n_bins,
                         _valid_or_all(valid, bin_ids))


def merge_stats(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Associative merge of two (..., 5) moment tables."""
    return torch.stack([
        a[..., 0] + b[..., 0],
        a[..., 1] + b[..., 1],
        a[..., 2] + b[..., 2],
        torch.minimum(a[..., 3], b[..., 3]),
        torch.maximum(a[..., 4], b[..., 4]),
    ], dim=-1)


def derive(stats: torch.Tensor) -> dict:
    """(..., 5) moments -> {count, mean, std, min, max} (paper's metrics)."""
    count = stats[..., 0]
    c = torch.clamp_min(count, 1.0)
    mean = stats[..., 1] / c
    var = torch.clamp_min(stats[..., 2] / c - mean * mean, 0.0)
    occupied = count > 0
    zero = torch.zeros_like(count)
    return {
        "count": count,
        "mean": torch.where(occupied, mean, zero),
        "std": torch.where(occupied, torch.sqrt(var), zero),
        "min": torch.where(occupied, stats[..., 3], zero),
        "max": torch.where(occupied, stats[..., 4], zero),
    }


def _collaborative_sum(vals: torch.Tensor, dim: int) -> torch.Tensor:
    """Round-robin additive merge along ``dim`` across ranks: the
    identity at world size 1."""
    _world_size()
    return vals


def _collaborative_reduce(local: torch.Tensor) -> torch.Tensor:
    """Round-robin merge of a (..., n_bins, 5) moment table across ranks
    (sums scattered and gathered, min/max all-reduced): the identity at
    world size 1."""
    _world_size()
    return local


def distributed_binstats_from_bins(bin_ids: torch.Tensor,
                                   values: torch.Tensor, n_bins: int,
                                   valid: Optional[torch.Tensor] = None,
                                   ) -> torch.Tensor:
    """Collaborative moments from precomputed bin ids (exact int64
    binning happens on the host — CUPTI ns timestamps overflow int32; see
    :func:`distributed_binstats` for the on-device float32 variant).

    bin_ids : (N,) int32 bin ids, clipped into ``[0, n_bins)``
    values  : (N,) float32, or (n_metrics, N) sharing the ids
    Returns (n_bins, 5), or (n_metrics, n_bins, 5), on the inputs' device.
    On CUDA tensors the clipped ids must be non-decreasing: unordered
    rows raise ``ValueError`` (the call then waits for the kernel's
    order verdict); they are never sorted here."""
    out = _collaborative_reduce(
        binstats_local(bin_ids, values, n_bins, valid=valid))
    if out.device.type == "cuda" and disordered(out):
        raise ValueError("distributed_binstats_from_bins: bin ids are not "
                         "non-decreasing (rows must be bin-ordered on "
                         "CUDA tensors)")
    return out


def distributed_moments_flat(seg_ids: torch.Tensor, values: torch.Tensor,
                             n_seg: int,
                             valid: Optional[torch.Tensor] = None,
                             ) -> torch.Tensor:
    """Collaborative moments over an arbitrary flat segment space.

    seg_ids : (N,) int32 segment ids in [0, n_seg) — segment-ordered on
              CUDA tensors
    values  : (n_metrics, N) float32 — all metrics share the segment ids
    Returns (n_metrics, n_seg, 5) moments on the inputs' device."""
    local = binstats_local(seg_ids, values, n_seg, valid=valid)
    return _collaborative_reduce(local)


def distributed_histogram_flat(seg_ids: torch.Tensor, values: torch.Tensor,
                               n_seg: int,
                               valid: Optional[torch.Tensor] = None,
                               ) -> torch.Tensor:
    """Collaborative quantile-sketch bucket counts over an arbitrary flat
    segment space: (n_metrics, n_seg, N_BUCKETS) float32 counts. On CUDA
    tensors ``seg_ids`` must be non-decreasing (unordered rows leave NaN
    counts)."""
    local = histbin_flat(seg_ids, values, n_seg,
                         _valid_or_all(valid, seg_ids))
    return _collaborative_sum(local, dim=1)


def distributed_binstats_grouped(bin_ids: torch.Tensor,
                                 group_ids: torch.Tensor,
                                 values: torch.Tensor, n_bins: int,
                                 n_groups: int,
                                 valid: Optional[torch.Tensor] = None,
                                 ) -> torch.Tensor:
    """One-pass multi-metric × group-by moments: the (bin, group) pair is
    fused into one segment id. Returns (n_metrics, n_bins, n_groups, 5).
    On CUDA tensors the fused ids must be non-decreasing."""
    flat = bin_ids * n_groups + group_ids
    out = distributed_moments_flat(flat, values, n_bins * n_groups,
                                   valid=valid)
    return out.reshape(values.shape[0], n_bins, n_groups, STATS)


def distributed_histogram_grouped(bin_ids: torch.Tensor,
                                  group_ids: torch.Tensor,
                                  values: torch.Tensor, n_bins: int,
                                  n_groups: int,
                                  valid: Optional[torch.Tensor] = None,
                                  ) -> torch.Tensor:
    """One-pass multi-metric × group-by bucket counts: returns
    (n_metrics, n_bins, n_groups, N_BUCKETS). On CUDA tensors the fused
    ids must be non-decreasing."""
    flat = bin_ids * n_groups + group_ids
    out = distributed_histogram_flat(flat, values, n_bins * n_groups,
                                     valid=valid)
    return out.reshape(values.shape[0], n_bins, n_groups, N_BUCKETS)


def distributed_binstats(rel_timestamps: torch.Tensor, values: torch.Tensor,
                         total_ns: float, n_bins: int,
                         valid: Optional[torch.Tensor] = None,
                         ) -> torch.Tensor:
    """Fused on-device binning + collaborative moments.

    ``rel_timestamps`` are float32 ns relative to the dataset start; bin =
    floor(rel * n_bins / total) clipped to [0, n_bins). Returns
    (n_bins, 5), or (n_metrics, n_bins, 5) for 2-D ``values``."""
    if valid is None:
        valid = torch.ones(rel_timestamps.shape, dtype=torch.bool,
                           device=rel_timestamps.device)
    local = binstats(rel_timestamps, values, valid, total_ns=total_ns,
                     n_bins=n_bins)
    return _collaborative_reduce(local)


def distributed_iqr(scores: torch.Tensor, k: float = 1.5) -> dict:
    """IQR fences over a per-bin score table (entries equal to 0 are
    unoccupied), through the ``iqr`` kernel. ``flags`` marks every entry
    above the upper fence, occupied or not, as the reference does."""
    s = scores.to(torch.float32).contiguous()
    occupied = s != 0.0
    out = iqr_fences(s, occupied, k_factor=k)
    hi = out["hi_fence"]
    flags = out["flags"].to(torch.bool) | (~occupied & (s > hi))
    return {"q1": out["q1"], "q3": out["q3"], "iqr": out["iqr"],
            "lo_fence": out["lo_fence"], "hi_fence": hi, "flags": flags}


def top_k_anomalies(scores: torch.Tensor, hi_fence: torch.Tensor,
                    top_k: int = 5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ranked top-k fence exceedances: (values, bin indices)."""
    exceed = torch.where(scores > hi_fence, scores - hi_fence,
                         torch.full_like(scores, -float("inf")))
    out = torch.topk(exceed, top_k)
    return out.values, out.indices
