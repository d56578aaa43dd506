"""Common model primitives: initialisers, norms, activations, rotary
position embeddings and the dense FFN.

Initialisers draw from an explicit :class:`torch.Generator` on the
target device, in float32, and return each matrix in the ``dtype`` they
are given as soon as it is drawn. Norms compute in float32 and cast back
to the input's dtype, and RoPE rotates in float32 and casts back, as
``repro/models/layers.py`` does. The FFN's products stay in the input's
dtype.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def truncated_normal(shape: Sequence[int], scale: float, *,
                     generator: Optional[torch.Generator],
                     device: torch.device,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``scale`` times a standard normal truncated at ±2, drawn in float32
    and returned in ``dtype``. Without a generator nothing is drawn: the
    shape alone, as a 0-stride view of one element (no memory)."""
    if generator is None:
        return torch.empty((), dtype=dtype, device=device).expand(
            tuple(shape))
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale).to(dtype)


def dense_init(shape: Sequence[int], fan_in: Optional[int] = None, *,
               generator: torch.Generator, device: torch.device,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    fan_in = fan_in if fan_in is not None else shape[0]
    return truncated_normal(shape, 1.0 / np.sqrt(fan_in),
                            generator=generator, device=device, dtype=dtype)


def embed_init(shape: Sequence[int], *, generator: torch.Generator,
               device: torch.device,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return truncated_normal(shape, 1.0, generator=generator, device=device,
                            dtype=dtype)


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


# --- activations -------------------------------------------------------------

def squared_relu(x: torch.Tensor) -> torch.Tensor:
    """Primer / Nemotron-4 activation: relu(x)^2."""
    r = F.relu(x)
    return r * r


ACTIVATIONS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu's default
    "relu": F.relu,
    "relu2": squared_relu,
}


# --- rotary position embeddings ----------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               rotary_dim: Optional[int] = None,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """Inverse frequencies (float32) for the rotated sub-dimension."""
    rd = rotary_dim or head_dim
    return 1.0 / (theta ** (torch.arange(0, rd, 2, dtype=torch.float32,
                                         device=device) / rd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0,
               rotary_fraction: float = 1.0) -> torch.Tensor:
    """Standard (optionally partial) RoPE.

    x: (..., S, H, head_dim); positions: broadcastable to (..., S).
    ``rotary_fraction < 1`` rotates only the leading fraction of head_dim;
    the tail passes through unchanged."""
    head_dim = x.shape[-1]
    rd = int(head_dim * rotary_fraction)
    rd -= rd % 2
    if rd == 0:
        return x
    inv = rope_freqs(head_dim, theta, rd, x.device)            # (rd/2,)
    ang = positions[..., None].to(torch.float32) * inv      # (..., S, rd/2)
    sin = torch.sin(ang)[..., None, :]                   # (..., S, 1, rd/2)
    cos = torch.cos(ang)[..., None, :]
    r1, r2 = x[..., : rd // 2], x[..., rd // 2:rd]
    out1 = r1 * cos - r2 * sin                                  # float32
    out2 = r2 * cos + r1 * sin
    return torch.cat([out1.to(x.dtype), out2.to(x.dtype), x[..., rd:]],
                     dim=-1)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, sections,
                theta: float = 10000.0) -> torch.Tensor:
    """Qwen2-VL M-RoPE: the head_dim frequency bands are split into
    (temporal, height, width) sections, each rotated by its own position
    id.

    x: (B, S, H, head_dim); positions3: (B, 3, S) integer (t, h, w) ids.
    ``sections`` counts frequencies (pairs) and sums to head_dim / 2 (16,
    24 and 24 for head_dim 128)."""
    head_dim = x.shape[-1]
    if sum(sections) * 2 != head_dim:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not cover "
                         f"head_dim {head_dim}")
    inv = rope_freqs(head_dim, theta, head_dim, x.device)    # (hd/2,)
    # the section of each frequency: 0 = t, 1 = h, 2 = w
    sec = torch.cat([torch.full((n,), i, dtype=torch.long, device=x.device)
                     for i, n in enumerate(sections)])
    pos = positions3.to(x.device).transpose(1, 2).to(torch.float32)
    ang = pos[..., sec] * inv                                # (B, S, hd/2)
    sin = torch.sin(ang)[..., None, :]
    cos = torch.cos(ang)[..., None, :]
    r1, r2 = x[..., : head_dim // 2], x[..., head_dim // 2:]
    out1 = r1 * cos - r2 * sin                                  # float32
    out2 = r2 * cos + r1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


# --- ffn ---------------------------------------------------------------------

def ffn_init(d_model: int, d_ff: int, gated: bool, *,
             generator: torch.Generator, device: torch.device,
             dtype: torch.dtype = torch.float32) -> Dict:
    kw = {"generator": generator, "device": device, "dtype": dtype}
    p = {"w_up": dense_init((d_model, d_ff), **kw),
         "w_down": dense_init((d_ff, d_model), fan_in=d_ff, **kw)}
    if gated:
        p["w_gate"] = dense_init((d_model, d_ff), **kw)
    return p


def ffn_hidden(params, x: torch.Tensor,
               activation: str = "silu") -> torch.Tensor:
    """The FFN's activated hidden units, before ``w_down``."""
    act = ACTIVATIONS[activation]
    dt = x.dtype
    up = x @ params["w_up"].to(dt)
    if "w_gate" in params:
        return act(x @ params["w_gate"].to(dt)) * up
    return act(up)


def ffn_apply(params, x: torch.Tensor,
              activation: str = "silu") -> torch.Tensor:
    return ffn_hidden(params, x, activation) @ params["w_down"].to(x.dtype)
