"""Per-segment log2-bucket histograms: the CUDA kernel's wrappers and
their plain PyTorch versions.

* :func:`histbin_flat` — counts over an arbitrary flat segment space (the
  quantile reducer's phase-2 path,
  :func:`repro_torch.core.distributed.distributed_histogram_flat`). Rows
  may come in any order; ids outside ``[0, n_seg)`` are dropped.
* :func:`histbin` — the TPU kernel's own contract: float32 timestamps
  relative to the trace start are binned (and clipped) in-kernel.

Bucket: ``clip(floor(log2(max(v, 1)) * 8), 0, 383)`` in float32, as
:func:`repro_torch.core.distributed.bucketize`. Counts come back as
float32, bucket axis last, ready for ``QuantileSketch(counts=...)``. A
wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel (``repro_torch/csrc/histbin.cu``) or raises.
``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...core.reducers import N_BUCKETS, SUBDIV, V_FLOOR
from .. import _build
from .._check import check_tensor, stream_ptr
from ..binstats.ops import _as_2d, _ts_bins


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

    seg    : (N,) int32 segment ids (any order)
    values : (N,) or (M, N) float32
    valid  : (N,) bool
    Returns (n_seg, 384), or (M, n_seg, 384) for 2-D ``values``."""
    if n_seg < 1:
        raise ValueError(f"n_seg must be >= 1, got {n_seg}")
    if values.device.type == "cpu":
        return histbin_flat_plain(seg, values, n_seg, valid)
    if values.device.type != "cuda":
        raise ValueError(f"histbin_flat: unsupported device {values.device}")
    dev = values.device
    vals, squeeze = _as_2d(values)
    check_tensor(vals, "values", torch.float32, 2, dev)
    m, n = vals.shape
    check_tensor(seg, "seg", torch.int32, 1, dev)
    check_tensor(valid, "valid", torch.bool, 1, dev)
    if seg.shape[0] != n or valid.shape[0] != n:
        raise ValueError("seg / valid do not match values")
    lib = _lib()
    out = torch.empty((m, n_seg, N_BUCKETS), dtype=torch.float32,
                      device=dev)
    code = lib.histbin_flat(seg.data_ptr(), vals.data_ptr(),
                            valid.data_ptr(), n, n_seg, m, out.data_ptr(),
                            stream_ptr(dev))
    histbin_flat.launches += 1
    _build.check(code, "histbin_flat")
    return out[0] if squeeze else out


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
    if values.device.type == "cpu":
        return histbin_plain(rel_ts, values, valid, total_ns=total_ns,
                             n_bins=n_bins)
    if values.device.type != "cuda":
        raise ValueError(f"histbin: unsupported device {values.device}")
    dev = values.device
    vals, squeeze = _as_2d(values)
    check_tensor(vals, "values", torch.float32, 2, dev)
    m, n = vals.shape
    check_tensor(rel_ts, "rel_ts", torch.float32, 1, dev)
    check_tensor(valid, "valid", torch.bool, 1, dev)
    if rel_ts.shape[0] != n or valid.shape[0] != n:
        raise ValueError("rel_ts / valid do not match values")
    lib = _lib()
    out = torch.empty((m, n_bins, N_BUCKETS), dtype=torch.float32,
                      device=dev)
    code = lib.histbin_ts(rel_ts.data_ptr(), vals.data_ptr(),
                          valid.data_ptr(), n, n_bins, m,
                          float(np.float32(n_bins / total_ns)),
                          out.data_ptr(), stream_ptr(dev))
    histbin.launches += 1
    _build.check(code, "histbin")
    return out[0] if squeeze else out


histbin.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("histbin")
    if not getattr(lib, "_typed", False):
        p, i, l, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_long,
                      ctypes.c_float)
        lib.histbin_flat.argtypes = [p, p, p, l, i, i, p, p]
        lib.histbin_flat.restype = i
        lib.histbin_ts.argtypes = [p, p, p, l, i, i, f, p, p]
        lib.histbin_ts.restype = i
        lib._typed = True
    return lib
