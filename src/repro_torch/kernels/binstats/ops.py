"""Per-segment moments: the CUDA kernel's wrappers and their plain
PyTorch versions.

Two functions, each with a plain version beside it:

* :func:`binstats_flat` — moments over an arbitrary flat segment space
  (the phase-2 path, :func:`repro_torch.core.distributed.binstats_local`).
  On a CUDA tensor the rows must arrive segment-ordered (``seg``
  non-decreasing once clipped); each segment's rows are read by a group
  of lanes numbered from the segment's first row and combined in a fixed
  tree, so each cell is a fixed-order function of its own rows. The
  kernel checks the order in the same launch and the call does not wait
  for it: rows out of order leave NaN in the count of at least one cell
  (counts are otherwise exact integers), which the caller sees in its own
  copy of the table. ``BinStats.device_reduce`` raises ``ValueError`` on
  it.
* :func:`binstats` — the TPU kernel's own contract: float32 timestamps
  relative to the trace start are binned in-kernel.

Layout and sentinels follow :class:`repro_torch.core.reducers.BinStats`:
the last axis is (count, sum, sumsq, min, max); a segment without valid
rows has min = 3.4e38 and max = -3.4e38. A wrapper given CPU tensors runs
the plain version; given CUDA tensors it launches the kernel (source
``repro_torch/csrc/binstats.cu``) through a PyTorch operator written in
C++ (``csrc/ops.cpp``: checks, allocation, stream and launch in one call)
or raises. ``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build

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
    Returns (n_seg, 5), or (M, n_seg, 5) for 2-D ``values``. On CUDA the
    call returns without waiting for the kernel; unordered rows show as a
    NaN count (see :func:`disordered`)."""
    if values.device.type == "cuda":
        out = _operator("binstats_flat")(seg, values, n_seg, valid)
        binstats_flat.launches += 1
        return out
    if n_seg < 1:
        raise ValueError(f"n_seg must be >= 1, got {n_seg}")
    if values.device.type == "cpu":
        return binstats_flat_plain(seg, values, n_seg, valid)
    raise ValueError(f"binstats_flat: unsupported device {values.device}")


binstats_flat.launches = 0


def disordered(table) -> bool:
    """Whether a :func:`binstats_flat` or
    :func:`repro_torch.kernels.histbin.histbin_flat` table (a tensor or an
    array) came from rows out of segment order: the kernels leave NaN at
    index 0 of the last axis of at least one cell then (the count; bucket
    0, of which histbin's kernel fills every bucket). Reading a CUDA tensor
    waits for the kernel; read the copy you make anyway."""
    counts = table[..., 0]
    if isinstance(counts, torch.Tensor):
        return bool(torch.isnan(counts).any())
    return bool(np.isnan(counts).any())


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
    exact. A table of ``n_bins * (1 + 4 M) * 4`` bytes up to 227 KB takes
    one launch (one thread-block cluster, private tables in shared
    memory); a larger one three."""
    if values.device.type == "cuda":
        out = _operator("binstats_ts")(rel_ts, values, valid,
                                       float(total_ns), n_bins)
        binstats.launches += 1
        return out
    if n_bins < 1:
        raise ValueError(f"n_bins must be >= 1, got {n_bins}")
    if values.device.type == "cpu":
        return binstats_plain(rel_ts, values, valid, total_ns=total_ns,
                              n_bins=n_bins)
    raise ValueError(f"binstats: unsupported device {values.device}")


binstats.launches = 0
_OPS = {}


def _operator(name: str):
    """The C++ operator ``torch.ops.repro_torch.<name>`` (``csrc/ops.cpp``),
    which checks, allocates, takes the current stream and launches."""
    op = _OPS.get(name)
    if op is None:
        op = _OPS[name] = getattr(_build.operators(), name).default
    return op
