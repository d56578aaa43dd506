"""Trailing-window rolling mean and std: the CUDA kernel's wrapper and
its plain PyTorch version.

Contract (``repro/kernels/rolling``): ``x`` (N,) is cast to float32;
``out[i, 0]`` is the mean over ``x[max(0, i - window + 1) .. i]`` and
``out[i, 1]`` is ``sqrt(max(E[x^2] - mean^2, 0))`` over the same range,
with ``n_eff = min(i + 1, window)``; any ``window >= 1``. The Pallas
kernel's ``block`` and ``interpret`` arguments tile the TPU and have no
counterpart here. A wrapper given a CPU tensor runs the plain version;
given a CUDA tensor it launches the kernel (``repro_torch/csrc/rolling.cu``,
through the operator of ``csrc/ops.cpp``) or raises.
``rolling_stats.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .. import _build


def _check_args(x: torch.Tensor, window: int) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"x: expected a tensor, got {type(x).__name__}")
    if x.dim() != 1:
        raise ValueError(f"x must be a (N,) series, got {tuple(x.shape)}")
    if x.shape[0] < 1:
        raise ValueError("x is empty: no rolling statistics of 0 values")
    if int(window) != window or window < 1:
        raise ValueError(f"window must be an integer >= 1, got {window}")


def rolling_stats_plain(x: torch.Tensor, *, window: int) -> torch.Tensor:
    """Plain version of :func:`rolling_stats`, on any device.

    The oracle's formula (prefix sums, window = difference of two
    prefixes) with the prefix sums in float64, cast to float32 at the end,
    so it does not carry the float32 drift of one prefix over a long
    series."""
    _check_args(x, window)
    xd = x.to(torch.float32).to(torch.float64)
    n = xd.shape[0]
    zero = xd.new_zeros(1)
    cs = torch.cat([zero, torch.cumsum(xd, 0)])
    cs2 = torch.cat([zero, torch.cumsum(xd * xd, 0)])
    i = torch.arange(n, device=xd.device)
    lo = (i - window + 1).clamp_min(0)
    n_eff = (i + 1).clamp_max(window).to(torch.float64)
    mean = (cs[i + 1] - cs[lo]) / n_eff
    var = ((cs2[i + 1] - cs2[lo]) / n_eff - mean * mean).clamp_min(0.0)
    return torch.stack([mean, var.sqrt()], dim=1).to(torch.float32)


def rolling_stats(x: torch.Tensor, *, window: int) -> torch.Tensor:
    """Trailing-window rolling mean/std: (N,) -> (N, 2) float32.

    On CUDA the call is one PyTorch operator written in C++
    (``torch.ops.repro_torch.rolling_stats``, ``csrc/ops.cpp``), which
    checks the arguments, casts ``x`` to contiguous float32 if it is not,
    allocates the output, takes the current stream and launches."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        if type(window) is not int:
            _check_args(x, window)
            window = int(window)
        out = _operator()(x, window)
        rolling_stats.launches += 1
        return out
    _check_args(x, window)
    if x.device.type == "cpu":
        return rolling_stats_plain(x, window=window)
    raise ValueError(f"rolling_stats: unsupported device {x.device}")


rolling_stats.launches = 0
_OP = []


def _operator():
    if not _OP:
        _OP.append(_build.operators().rolling_stats.default)
    return _OP[0]
