"""Common model primitives: initialisers and norms.

Initialisers draw from an explicit :class:`torch.Generator` on the
target device. Norms compute in float32 and cast back to the input's
dtype, as ``repro/models/layers.py`` does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def truncated_normal(shape: Sequence[int], scale: float, *,
                     generator: torch.Generator,
                     device: torch.device) -> torch.Tensor:
    """``scale`` times a standard normal truncated at ±2, float32."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale)


def dense_init(shape: Sequence[int], fan_in: Optional[int] = None, *,
               generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    fan_in = fan_in if fan_in is not None else shape[0]
    return truncated_normal(shape, 1.0 / np.sqrt(fan_in),
                            generator=generator, device=device)


def embed_init(shape: Sequence[int], *, generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    return truncated_normal(shape, 1.0, generator=generator, device=device)


def rmsnorm_init(dim: int, device: torch.device):
    return {"scale": torch.ones(dim, dtype=torch.float32, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * params["scale"]).to(x.dtype)


def layernorm_init(dim: int, device: torch.device):
    return {"scale": torch.ones(dim, dtype=torch.float32, device=device),
            "bias": torch.zeros(dim, dtype=torch.float32, device=device)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(x.dtype)
