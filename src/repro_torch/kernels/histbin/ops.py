"""Per-segment log2-bucket histograms: the CUDA kernel's wrappers and
their plain PyTorch versions.

* :func:`histbin_flat` — counts over an arbitrary flat segment space (the
  quantile reducer's phase-2 path,
  :func:`repro_torch.core.distributed.distributed_histogram_flat`). Ids
  outside ``[0, n_seg)`` and invalid rows are dropped. On a CUDA tensor
  the rows must arrive segment-ordered (``seg`` non-decreasing; ids below
  0 first, ids at or above ``n_seg`` last): one launch counts each block's
  segments in shared memory and writes every cell once. The kernel checks
  the order in the same launch and the call does not wait for it: rows
  out of order leave NaN in every bucket of at least one segment, which
  the caller sees in its own copy of the table (:func:`disordered`);
  ``QuantileSketch.device_reduce`` raises ``ValueError`` on it. The plain
  version takes any order.
* :func:`histbin` — the TPU kernel's own contract: float32 timestamps
  relative to the trace start are binned (and clipped) in-kernel.

Bucket: ``clip(floor(log2(max(v, 1)) * 8), 0, 383)`` in float32, as
:func:`repro_torch.core.distributed.bucketize`. Counts come back as
float32, bucket axis last, ready for ``QuantileSketch(counts=...)``. A
wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel (``repro_torch/csrc/histbin.cu``) through a PyTorch
operator written in C++ (``csrc/ops.cpp``) or raises.
``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from ...core.reducers import N_BUCKETS, SUBDIV, V_FLOOR
# disordered: the order verdict of a flat table, read the same way for
# both kernels (NaN at index 0 of the last axis)
from ..binstats.ops import (_as_2d, _operator, _ts_bins,  # noqa: F401
                            disordered)


def bucketize(values: torch.Tensor) -> torch.Tensor:
    """Quantile-sketch bucket per value, float32 (int64 result). May
    disagree with the float64 host path (``reducers.bucket_of``) on an
    exact bucket edge, within the sketch's error bound."""
    v = values.to(torch.float32).clamp_min(V_FLOOR)
    b = torch.floor(torch.log2(v) * SUBDIV).clamp(0.0, N_BUCKETS - 1)
    return b.to(torch.int64)


def histbin_flat_plain(seg: torch.Tensor, values: torch.Tensor, n_seg: int,
                       valid: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`histbin_flat`, on any device."""
    vals, squeeze = _as_2d(values)
    seg = seg.to(torch.int64)
    keep = valid & (seg >= 0) & (seg < n_seg)
    base = seg[keep] * N_BUCKETS
    buckets = bucketize(vals[:, keep])
    out = torch.stack([
        torch.bincount(base + buckets[j], minlength=n_seg * N_BUCKETS)
        for j in range(vals.shape[0])]).to(torch.float32)
    out = out.reshape(vals.shape[0], n_seg, N_BUCKETS)
    return out[0] if squeeze else out


def histbin_flat(seg: torch.Tensor, values: torch.Tensor, n_seg: int,
                 valid: torch.Tensor) -> torch.Tensor:
    """Per-(metric, segment) bucket counts.

    seg    : (N,) int32 segment ids; on CUDA, segment-ordered
    values : (N,) or (M, N) float32
    valid  : (N,) bool
    Returns (n_seg, 384), or (M, n_seg, 384) for 2-D ``values``. On CUDA
    the call returns without waiting for the kernel; unordered rows show
    as NaN counts (see :func:`disordered`)."""
    if values.device.type == "cuda":
        out = _operator("histbin_flat")(seg, values, n_seg, valid)
        histbin_flat.launches += 1
        return out
    if n_seg < 1:
        raise ValueError(f"n_seg must be >= 1, got {n_seg}")
    if values.device.type == "cpu":
        return histbin_flat_plain(seg, values, n_seg, valid)
    raise ValueError(f"histbin_flat: unsupported device {values.device}")


histbin_flat.launches = 0


def histbin_plain(rel_ts: torch.Tensor, values: torch.Tensor,
                  valid: torch.Tensor, *, total_ns: float,
                  n_bins: int) -> torch.Tensor:
    """Plain version of :func:`histbin`, on any device."""
    return histbin_flat_plain(_ts_bins(rel_ts, total_ns, n_bins), values,
                              n_bins, valid)


def histbin(rel_ts: torch.Tensor, values: torch.Tensor,
            valid: torch.Tensor, *, total_ns: float,
            n_bins: int) -> torch.Tensor:
    """Fused timestamp binning + per-bin bucket counts (the TPU kernel's
    contract, ``repro/kernels/histbin/ops.py::histbin``).

    Returns (n_bins, 384), or (M, n_bins, 384) for 2-D ``values``."""
    if n_bins < 1:
        raise ValueError(f"n_bins must be >= 1, got {n_bins}")
    if values.device.type == "cuda":
        out = _operator("histbin_ts")(rel_ts, values, valid,
                                      float(total_ns), n_bins)
        histbin.launches += 1
        return out
    if values.device.type == "cpu":
        return histbin_plain(rel_ts, values, valid, total_ns=total_ns,
                             n_bins=n_bins)
    raise ValueError(f"histbin: unsupported device {values.device}")


histbin.launches = 0

