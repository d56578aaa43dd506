"""IQR fences over a per-bin score table: the CUDA kernel's wrapper and
its plain PyTorch version.

Contract (``repro/kernels/iqr``): unoccupied bins take a padding key and
sort to the top; Q1/Q3 interpolate linearly over the ``n_occ =
max(#occupied, 1)`` smallest keys (as ``np.percentile``), with a padding
key read as 0, so a table with no occupied bin has Q1 = Q3 = 0; the
fences are ``Q1 - k·IQR`` and ``Q3 + k·IQR``; ``flags = score > hi &
occupied``. Any ``n >= 1`` is accepted: the kernel pads to a power of two
itself.

Two dtypes, and the arithmetic follows the scores':

* float32 — the TPU kernel's contract: padding key 3.4e38, everything in
  float32. The reference's micro-bench calls this form.
* float64 — the analysis path (:func:`repro_torch.core.anomaly.iqr_detect`),
  whose reference computes the quartiles with ``np.percentile`` in
  float64: padding key +inf, virtual index ``(n_occ - 1)·q``, numpy's
  ``_lerp`` (``b - (b - a)·(1 - t)`` when ``t >= 0.5``), and every product
  and sum rounded on its own. Q1, Q3 and the fences then equal numpy's bit
  for bit.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel (``repro_torch/csrc/iqr.cu``) through a PyTorch
operator written in C++ (``csrc/ops.cpp``) or raises.
``iqr_fences.launches`` counts wrapper calls that launch.
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import _build

POS_CAP = 3.4e38
STAT_NAMES = ("q1", "q3", "iqr", "lo_fence", "hi_fence", "n_occ")


def next_pow2(n: int) -> int:
    """The padded table length: the next power of two >= max(n, 2)."""
    return max(2, 1 << (max(n, 1) - 1).bit_length())


def _result(srt: torch.Tensor, flags: torch.Tensor,
            stats: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``sorted``, ``flags``, ``stats`` and each named stat, a 0-d view of
    ``stats`` (all six from one ``unbind``)."""
    out = {"sorted": srt, "flags": flags, "stats": stats}
    out.update(zip(STAT_NAMES, stats.unbind()))
    return out


def _pct_f32(safe: torch.Tensor, n_occ: torch.Tensor, q: float):
    n = safe.shape[0]
    pos = torch.tensor(q, dtype=torch.float32) * (n_occ - 1.0)
    lo = torch.floor(pos).to(torch.int64).clamp(0, n - 1)
    hi = (lo + 1).clamp(0, n - 1)
    frac = pos - lo.to(torch.float32)
    vlo, vhi = safe[lo], safe[hi]
    return torch.where(n_occ > 1, vlo + frac * (vhi - vlo), vlo)


def _pct_f64(safe: torch.Tensor, n_occ: torch.Tensor, q: float):
    """np.percentile's linear method over the ``n_occ`` smallest keys,
    each operation a separate float64 rounding."""
    pos = (n_occ - 1.0) * q
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.minimum(lo + 1, n_occ.to(torch.int64) - 1)
    t = pos - lo.to(torch.float64)
    a, b = safe[lo], safe[hi]
    d = b - a
    return torch.where(t >= 0.5, b - d * (1.0 - t), a + d * t)


def iqr_fences_plain(scores: torch.Tensor, occupied: torch.Tensor, *,
                     k_factor: float = 1.5) -> Dict[str, torch.Tensor]:
    """Plain version of :func:`iqr_fences`, on any device. float64 scores
    keep float64 arithmetic; any other dtype is cast to float32."""
    f64 = scores.dtype == torch.float64
    dtype = torch.float64 if f64 else torch.float32
    s = scores.to(dtype)
    occ = occupied.to(torch.bool)
    cap = torch.tensor(float("inf") if f64 else POS_CAP, dtype=dtype,
                       device=s.device)
    srt = torch.sort(torch.where(occ, s, cap)).values
    safe = torch.where(srt >= cap, torch.zeros_like(srt), srt)
    n_occ = occ.sum().clamp_min(1).to(dtype)
    pct = _pct_f64 if f64 else _pct_f32
    q1, q3 = pct(safe, n_occ, 0.25), pct(safe, n_occ, 0.75)
    iqr = q3 - q1
    k = torch.tensor(k_factor, dtype=dtype)
    hi_fence = q3 + k * iqr
    lo_fence = q1 - k * iqr
    flags = ((s > hi_fence) & occ).to(torch.int32)
    zero = torch.zeros((), dtype=dtype, device=s.device)
    stats = torch.stack([q1, q3, iqr, lo_fence, hi_fence, n_occ, zero, zero])
    return _result(safe, flags, stats)


def iqr_fences(scores: torch.Tensor, occupied: torch.Tensor, *,
               k_factor: float = 1.5) -> Dict[str, torch.Tensor]:
    """Tukey fences over the occupied entries of a (n,) score table.

    Returns ``sorted`` (n,) (unoccupied entries 0, at the top), ``flags``
    (n,) int32, ``stats`` (8,) = (q1, q3, iqr, lo_fence, hi_fence, n_occ,
    0, 0), and each named stat as a 0-d tensor; ``sorted`` and ``stats``
    in the scores' dtype (float32 or float64; on CUDA any other dtype is
    refused).

    On CUDA the call is one PyTorch operator written in C++
    (``torch.ops.repro_torch.iqr_fences``, ``csrc/ops.cpp``), which checks
    the arguments, allocates the outputs (and, above 16,384 keys, the
    sort's scratch), takes the current stream and launches."""
    if isinstance(scores, torch.Tensor) and scores.device.type == "cuda":
        srt, flags, stats = _operator()(scores, occupied, float(k_factor))
        iqr_fences.launches += 1
        return _result(srt, flags, stats)
    if scores.dim() != 1 or scores.shape[0] < 1:
        raise ValueError(f"scores must be a non-empty (n,) table, got "
                         f"{tuple(scores.shape)}")
    if scores.device.type == "cpu":
        return iqr_fences_plain(scores, occupied, k_factor=k_factor)
    raise ValueError(f"iqr_fences: unsupported device {scores.device}")


iqr_fences.launches = 0
_OP = []


def _operator():
    if not _OP:
        _OP.append(_build.operators().iqr_fences.default)
    return _OP[0]
