"""Device backend for the paper's collaborative analysis, in PyTorch.

The reference backend (``repro.core.distributed``) maps the paper's MPI
ranks onto mesh devices under one controller: each device reduces its
block of rows, then a round-robin ``psum_scatter`` + ``all_gather`` (and
``pmin``/``pmax``) merges the per-device tables. The port runs one process
a rank (SPMD): every rank calls the same entry point inside the default
``torch.distributed`` process group that its caller set up (``torchrun``,
or ``init_process_group`` with an address, a world size and a rank), and
the merge runs over whatever backend that group has, gloo or NCCL; the
port picks none itself. Without a group, or in a group of one, the merge
is the identity.

The merge across P ranks (:func:`_collaborative_reduce`):

  * the additive channels (count, sum, sumsq; the sketch's bucket
    counts) ride :func:`_collaborative_sum`: the table is padded along
    its segment axis to a multiple of P and cut into P contiguous
    blocks, block r owned by rank r as in the reference's tiled
    ``psum_scatter``; one ``all_to_all_single`` hands each rank the P
    copies of its block, which it adds in ascending rank order with
    plain elementwise adds; one ``all_gather`` rebuilds the table on
    every rank. The library's ``reduce_scatter`` / ``all_reduce(SUM)``
    are not used for these: a ring sums an element in an order that
    depends on the chunk it falls in, chunks depend on the table's
    length, and a shard's segments sit at other offsets in a delta run
    than in a cold one, so its float32 sums would change. Here every
    element is ``b[0] + b[1] + ... + b[P-1]`` wherever it sits;
  * min and max ride ``all_reduce`` MIN and MAX, exact in any order.

The ±3.4e38 sentinels survive both (a sum of zeros, a min or max against
the sentinel), and so does the kernels' order verdict: a NaN count on
any rank lands in the owning rank's sum and is gathered by every rank,
so every rank's ``device_reduce`` raises, and none waits on the others.
gloo takes CUDA tensors for these three collectives (it stages them
through the host itself), so the tables stay on the card between the
kernels and the merge. ``collective_times()`` records the host seconds
of each collective call, waits for slower ranks included.

The process-group plumbing of the pipeline above lives in
:mod:`repro_torch.core.group` (the world size, rank and collective
times are re-exported here): ``on_rank0`` (a store write or phase 1 on
rank 0 alone, every rank waiting for it and raising if it failed) and
``agree`` (every rank raises when the ranks' plans differ, rather than
wait in a collective the others never enter).

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

Each rank passes its own rows; results are replicated on every rank and
stay on the input's device; every table keeps the reference's layout and
its ±3.4e38 min/max sentinels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..kernels.binstats.ops import binstats, binstats_flat, disordered
# bucketize: the quantile sketch's float32 log2 bucket, shared with the
# histbin kernel's plain version (re-exported as the reference does)
from ..kernels.histbin.ops import bucketize, histbin_flat  # noqa: F401
from ..kernels.iqr.ops import iqr_fences
# the process-group plumbing lives in .group (no kernel imports, so the
# engine can import it at module level)
from .group import _rank, _timed, _world_size, collective_times  # noqa: F401
from .reducers import N_BUCKETS

STATS = 5   # count, sum, sumsq, min, max


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
    """Round-robin additive merge along ``dim`` across the group's P
    ranks; the identity at P = 1. ``dim`` is padded to a multiple of P
    and cut into P contiguous blocks, block r owned by rank r; one
    ``all_to_all_single`` brings rank r the P ranks' copies of block r,
    added in ascending rank order; one ``all_gather`` of the owned
    blocks rebuilds the table on every rank. Each element is the same
    fixed-order sum wherever it sits in the table."""
    world = _world_size()
    if world == 1:
        return vals
    n = vals.shape[dim]
    x = vals.movedim(dim, 0)
    blk = -(-n // world)
    if blk * world != n:
        x = torch.cat([x, x.new_zeros((blk * world - n,) + x.shape[1:])])
    x = x.contiguous()
    recv = torch.empty_like(x)
    _timed("all_to_all_single",
           lambda: dist.all_to_all_single(recv, x))
    parts = recv.view((world, blk) + x.shape[1:])
    owned = parts[0]
    for r in range(1, world):
        owned = owned + parts[r]
    owned = owned.contiguous()
    blocks = [torch.empty_like(owned) for _ in range(world)]
    _timed("all_gather", lambda: dist.all_gather(blocks, owned))
    return torch.cat(blocks)[:n].movedim(0, dim).contiguous()


def _collaborative_reduce(local: torch.Tensor) -> torch.Tensor:
    """Round-robin merge of a (..., n_bins, 5) moment table across the
    group's ranks; the identity at P = 1. count, sum and sumsq ride
    :func:`_collaborative_sum` along the bin axis (all metrics in one
    exchange); min and max ride ``all_reduce`` MIN and MAX."""
    if _world_size() == 1:
        return local
    sums = _collaborative_sum(local[..., :3], local.ndim - 2)
    mn = local[..., 3].clone(memory_format=torch.contiguous_format)
    mx = local[..., 4].clone(memory_format=torch.contiguous_format)
    _timed("all_reduce_min",
           lambda: dist.all_reduce(mn, op=dist.ReduceOp.MIN))
    _timed("all_reduce_max",
           lambda: dist.all_reduce(mx, op=dist.ReduceOp.MAX))
    return torch.cat([sums, mn[..., None], mx[..., None]], dim=-1)


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
