"""Per-segment moments: the CUDA kernel's wrappers and their plain
PyTorch versions.

Two functions, each with a plain version beside it:

* :func:`binstats_flat` — moments over an arbitrary flat segment space
  (the phase-2 path, :func:`repro_torch.core.distributed.binstats_local`).
  On a CUDA tensor the rows must arrive segment-ordered (``seg``
  non-decreasing once clipped); the kernel walks each segment's rows in
  row order, so each cell is a fixed-order function of its own rows.
* :func:`binstats` — the TPU kernel's own contract: float32 timestamps
  relative to the trace start are binned in-kernel.

Layout and sentinels follow :class:`repro_torch.core.reducers.BinStats`:
the last axis is (count, sum, sumsq, min, max); a segment without valid
rows has min = 3.4e38 and max = -3.4e38. A wrapper given CPU tensors runs
the plain version; given CUDA tensors it launches the kernel (source
``repro_torch/csrc/binstats.cu``) or raises. ``<wrapper>.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from .._check import check_tensor, stream_ptr

POS_CAP = 3.4e38
NEG_CAP = -3.4e38
STATS = 5


def _as_2d(values: torch.Tensor):
    return (values[None, :], True) if values.dim() == 1 else (values, False)


def binstats_flat_plain(seg: torch.Tensor, values: torch.Tensor, n_seg: int,
                        valid: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`binstats_flat`, on any device.

    Segment ids are clipped into ``[0, n_seg)``. Sums use 1-D
    ``index_add_``, which on the CPU adds each segment's rows in row
    order — one fixed order, so equal inputs give bit-equal outputs."""
    vals, squeeze = _as_2d(values.to(torch.float32))
    m, n = vals.shape
    idx = seg.to(torch.int64).clamp(0, n_seg - 1)
    w = valid.to(torch.float32)
    out = torch.empty((m, n_seg, STATS), dtype=torch.float32,
                      device=vals.device)
    count = torch.zeros(n_seg, dtype=torch.float32, device=vals.device)
    count.index_add_(0, idx, w)
    pos = torch.tensor(POS_CAP, dtype=torch.float32, device=vals.device)
    neg = torch.tensor(NEG_CAP, dtype=torch.float32, device=vals.device)
    for j in range(m):
        v = vals[j]
        s = torch.zeros(n_seg, dtype=torch.float32, device=vals.device)
        ss = torch.zeros_like(s)
        s.index_add_(0, idx, v * w)
        ss.index_add_(0, idx, v * v * w)
        mn = torch.full_like(s, POS_CAP).scatter_reduce_(
            0, idx, torch.where(valid, v, pos), "amin")
        mx = torch.full_like(s, NEG_CAP).scatter_reduce_(
            0, idx, torch.where(valid, v, neg), "amax")
        out[j, :, 0] = count
        out[j, :, 1] = s
        out[j, :, 2] = ss
        out[j, :, 3] = torch.where(torch.isfinite(mn), mn, pos)
        out[j, :, 4] = torch.where(torch.isfinite(mx), mx, neg)
    return out[0] if squeeze else out


def binstats_flat(seg: torch.Tensor, values: torch.Tensor, n_seg: int,
                  valid: torch.Tensor) -> torch.Tensor:
    """Per-segment (count, sum, sumsq, min, max).

    seg    : (N,) int32 segment ids; on CUDA, segment-ordered
    values : (N,) or (M, N) float32 — all metrics share ``seg``/``valid``
    valid  : (N,) bool — invalid rows are weightless
    Returns (n_seg, 5), or (M, n_seg, 5) for 2-D ``values``."""
    if n_seg < 1:
        raise ValueError(f"n_seg must be >= 1, got {n_seg}")
    if values.device.type == "cpu":
        return binstats_flat_plain(seg, values, n_seg, valid)
    if values.device.type != "cuda":
        raise ValueError(f"binstats_flat: unsupported device {values.device}")
    dev = values.device
    vals, squeeze = _as_2d(values)
    check_tensor(vals, "values", torch.float32, 2, dev)
    m, n = vals.shape
    check_tensor(seg, "seg", torch.int32, 1, dev)
    check_tensor(valid, "valid", torch.bool, 1, dev)
    if seg.shape[0] != n or valid.shape[0] != n:
        raise ValueError(f"seg {tuple(seg.shape)} / valid "
                         f"{tuple(valid.shape)} do not match values "
                         f"{tuple(vals.shape)}")
    lib = _lib()
    offsets = torch.empty(n_seg + 1, dtype=torch.int32, device=dev)
    err = torch.empty(1, dtype=torch.int32, device=dev)
    out = torch.empty((m, n_seg, STATS), dtype=torch.float32, device=dev)
    code = lib.binstats_flat(seg.data_ptr(), vals.data_ptr(),
                             valid.data_ptr(), n, n_seg, m,
                             offsets.data_ptr(), err.data_ptr(),
                             out.data_ptr(), stream_ptr(dev))
    binstats_flat.launches += 1
    _build.check(code, "binstats_flat")
    if int(err.item()):
        raise ValueError("binstats_flat: rows are not segment-ordered "
                         "(seg must be non-decreasing on CUDA tensors)")
    return out[0] if squeeze else out


binstats_flat.launches = 0


def _ts_bins(rel_ts: torch.Tensor, total_ns: float,
             n_bins: int) -> torch.Tensor:
    """bin = clip(floor(ts * float32(n_bins/total_ns)), 0, n_bins-1), all
    in float32 as the kernel computes it."""
    inv = torch.tensor(np.float32(n_bins / total_ns), dtype=torch.float32,
                       device=rel_ts.device)
    t = (rel_ts.to(torch.float32) * inv).clamp(0.0, float(n_bins - 1))
    return t.to(torch.int32)


def binstats_plain(rel_ts: torch.Tensor, values: torch.Tensor,
                   valid: torch.Tensor, *, total_ns: float,
                   n_bins: int) -> torch.Tensor:
    """Plain version of :func:`binstats`, on any device."""
    return binstats_flat_plain(_ts_bins(rel_ts, total_ns, n_bins), values,
                               n_bins, valid)


def binstats(rel_ts: torch.Tensor, values: torch.Tensor,
             valid: torch.Tensor, *, total_ns: float,
             n_bins: int) -> torch.Tensor:
    """Fused timestamp binning + per-bin moments (the TPU kernel's
    contract, ``repro/kernels/binstats/ops.py::binstats``).

    rel_ts : (N,) float32 ns relative to the dataset start
    values : (N,) or (M, N) float32
    valid  : (N,) bool
    Returns (n_bins, 5), or (M, n_bins, 5) for 2-D ``values``. On CUDA the
    sums ride float atomics, so their rounding depends on arrival order
    (rtol 1e-5 against the plain version); counts, min and max are
    exact."""
    if n_bins < 1:
        raise ValueError(f"n_bins must be >= 1, got {n_bins}")
    if values.device.type == "cpu":
        return binstats_plain(rel_ts, values, valid, total_ns=total_ns,
                              n_bins=n_bins)
    if values.device.type != "cuda":
        raise ValueError(f"binstats: unsupported device {values.device}")
    dev = values.device
    vals, squeeze = _as_2d(values)
    check_tensor(vals, "values", torch.float32, 2, dev)
    m, n = vals.shape
    check_tensor(rel_ts, "rel_ts", torch.float32, 1, dev)
    check_tensor(valid, "valid", torch.bool, 1, dev)
    if rel_ts.shape[0] != n or valid.shape[0] != n:
        raise ValueError("rel_ts / valid do not match values")
    lib = _lib()
    cnt = torch.empty(n_bins, dtype=torch.int32, device=dev)
    out = torch.empty((m, n_bins, STATS), dtype=torch.float32, device=dev)
    code = lib.binstats_ts(rel_ts.data_ptr(), vals.data_ptr(),
                           valid.data_ptr(), n, m, n_bins,
                           float(np.float32(n_bins / total_ns)),
                           cnt.data_ptr(), out.data_ptr(), stream_ptr(dev))
    binstats.launches += 1
    _build.check(code, "binstats")
    return out[0] if squeeze else out


binstats.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("binstats")
    if not getattr(lib, "_typed", False):
        p, i, l, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_long,
                      ctypes.c_float)
        lib.binstats_flat.argtypes = [p, p, p, l, i, i, p, p, p, p]
        lib.binstats_flat.restype = i
        lib.binstats_ts.argtypes = [p, p, p, l, i, i, f, p, p, p]
        lib.binstats_ts.restype = i
        lib._typed = True
    return lib
