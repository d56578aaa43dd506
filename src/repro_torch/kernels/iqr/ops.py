"""IQR fences over a per-bin score table: the CUDA kernel's wrapper and
its plain PyTorch version.

Contract (``repro/kernels/iqr``): unoccupied bins take the key 3.4e38 and
sort to the top; Q1/Q3 interpolate linearly over the ``n_occ =
max(#occupied, 1)`` smallest keys (as ``np.percentile``), with a key of
3.4e38 read as 0, so a table with no occupied bin has Q1 = Q3 = 0; the
fences are ``Q1 - k·IQR`` and ``Q3 + k·IQR``; ``flags = score > hi &
occupied``. Everything is float32. Any ``n >= 1`` is accepted: the kernel
pads to a power of two itself. A wrapper given CPU tensors runs the plain
version; given CUDA tensors it launches the kernel
(``repro_torch/csrc/iqr.cu``) or raises. ``iqr_fences.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .. import _build
from .._check import check_tensor, stream_ptr

POS_CAP = 3.4e38
STAT_NAMES = ("q1", "q3", "iqr", "lo_fence", "hi_fence", "n_occ")


def next_pow2(n: int) -> int:
    """The padded table length: the next power of two >= max(n, 2)."""
    return max(2, 1 << (max(n, 1) - 1).bit_length())


def _result(srt: torch.Tensor, flags: torch.Tensor,
            stats: torch.Tensor) -> Dict[str, torch.Tensor]:
    out = {"sorted": srt, "flags": flags, "stats": stats}
    out.update({name: stats[i] for i, name in enumerate(STAT_NAMES)})
    return out


def iqr_fences_plain(scores: torch.Tensor, occupied: torch.Tensor, *,
                     k_factor: float = 1.5) -> Dict[str, torch.Tensor]:
    """Plain version of :func:`iqr_fences`, on any device."""
    s = scores.to(torch.float32)
    occ = occupied.to(torch.bool)
    n = s.shape[0]
    cap = torch.tensor(POS_CAP, dtype=torch.float32, device=s.device)
    srt = torch.sort(torch.where(occ, s, cap)).values
    safe = torch.where(srt >= cap, torch.zeros_like(srt), srt)
    n_occ = occ.sum().clamp_min(1).to(torch.float32)

    def pct(q: float) -> torch.Tensor:
        pos = torch.tensor(q, dtype=torch.float32) * (n_occ - 1.0)
        lo = torch.floor(pos).to(torch.int64).clamp(0, n - 1)
        hi = (lo + 1).clamp(0, n - 1)
        frac = pos - lo.to(torch.float32)
        vlo, vhi = safe[lo], safe[hi]
        return torch.where(n_occ > 1, vlo + frac * (vhi - vlo), vlo)

    q1, q3 = pct(0.25), pct(0.75)
    iqr = q3 - q1
    k = torch.tensor(k_factor, dtype=torch.float32)
    hi_fence = q3 + k * iqr
    lo_fence = q1 - k * iqr
    flags = ((s > hi_fence) & occ).to(torch.int32)
    zero = torch.zeros((), dtype=torch.float32, device=s.device)
    stats = torch.stack([q1, q3, iqr, lo_fence, hi_fence, n_occ, zero, zero])
    return _result(safe, flags, stats)


def iqr_fences(scores: torch.Tensor, occupied: torch.Tensor, *,
               k_factor: float = 1.5) -> Dict[str, torch.Tensor]:
    """Tukey fences over the occupied entries of a (n,) score table.

    Returns ``sorted`` (n,) float32 (unoccupied entries 0, at the top),
    ``flags`` (n,) int32, ``stats`` (8,) float32 = (q1, q3, iqr,
    lo_fence, hi_fence, n_occ, 0, 0), and each named stat as a 0-d
    tensor."""
    if scores.dim() != 1 or scores.shape[0] < 1:
        raise ValueError(f"scores must be a non-empty (n,) table, got "
                         f"{tuple(scores.shape)}")
    if scores.device.type == "cpu":
        return iqr_fences_plain(scores, occupied, k_factor=k_factor)
    if scores.device.type != "cuda":
        raise ValueError(f"iqr_fences: unsupported device {scores.device}")
    dev = scores.device
    check_tensor(scores, "scores", torch.float32, 1, dev)
    check_tensor(occupied, "occupied", torch.bool, 1, dev)
    n = scores.shape[0]
    if occupied.shape[0] != n:
        raise ValueError("occupied does not match scores")
    if n >= 1 << 30:
        raise ValueError(f"iqr_fences: table of {n} entries is too large")
    lib = _lib()
    n_p = next_pow2(n)
    smem_keys = lib.iqr_smem_max_keys()
    keys = torch.empty(n_p if n_p > smem_keys else 1, dtype=torch.float32,
                       device=dev)
    srt = torch.empty(n, dtype=torch.float32, device=dev)
    flags = torch.empty(n, dtype=torch.int32, device=dev)
    stats = torch.empty(8, dtype=torch.float32, device=dev)
    code = lib.iqr_fences(scores.data_ptr(), occupied.data_ptr(), n, n_p,
                          float(k_factor), keys.data_ptr(), srt.data_ptr(),
                          flags.data_ptr(), stats.data_ptr(),
                          stream_ptr(dev))
    iqr_fences.launches += 1
    _build.check(code, "iqr_fences")
    return _result(srt, flags, stats)


iqr_fences.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("iqr")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.iqr_fences.argtypes = [p, p, i, i, f, p, p, p, p, p]
        lib.iqr_fences.restype = i
        lib.iqr_smem_max_keys.argtypes = []
        lib.iqr_smem_max_keys.restype = i
        lib._typed = True
    return lib
