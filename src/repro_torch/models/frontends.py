"""Input assembly, after ``repro/models/frontends.py``: token embeddings,
the learnable meta-token prefix, and the modality frontend stubs (the
reference's configs specify the transformer backbone only, and the batch
brings precomputed frame or patch embeddings):

  audio (hubert-xlarge): ``frames`` (B, S, frontend_dim), the conv
    feature extractor's outputs, projected to d_model, plus fixed
    sinusoidal positions (the reference's stand-in for HuBERT's conv
    positional encoding);
  vlm (qwen2-vl): ``patches`` (B, S_img, frontend_dim), the vision
    tower's outputs, projected and put before the text's token
    embeddings; M-RoPE's ``positions3`` (B, 3, S_total) cover both spans.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import tp
from .shardrules import ParallelCtx


def sinusoid_positions(s: int, d: int) -> np.ndarray:
    """(s, d) float32: sin on the even columns, cos on the odd ones."""
    pos = np.arange(s)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    out = np.zeros((s, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out


def embed_tokens(params, tokens: torch.Tensor, dtype: torch.dtype,
                 ctx: Optional[ParallelCtx], vocab: int) -> torch.Tensor:
    """The tokens' rows of the embedding table in ``dtype``. Where the
    table is a rank's block of the ``vocab`` rows (vocab-parallel), the
    rank looks up the tokens it owns, zeros the others, and the ordered
    sum over the ranks adds one owner's row to exact zeros."""
    table = params["embed"]["tokens"]
    tok = tokens.to(device=table.device, dtype=torch.long)
    n = table.shape[0]
    if n >= vocab:
        return table[tok].to(dtype)
    local = tok - ctx.tensor_rank * n
    mine = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)].to(dtype)
    return tp.ordered_sum(rows * mine[..., None].to(dtype), ctx)


def _project(params, feats, dtype: torch.dtype) -> torch.Tensor:
    """(B, S, frontend_dim) features -> (B, S, D) in ``dtype``."""
    w = params["frontend_proj"]
    return torch.as_tensor(feats, device=w.device).to(dtype) @ w.to(dtype)


def assemble(cfg, params, batch: Dict, ctx: Optional[ParallelCtx] = None,
             ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Returns (x (B, S_total, D), positions, prefix_len).

    ``positions`` is (1, S_total), or the batch's (B, 3, S_total)
    ``positions3`` for the VLM frontend. ``prefix_len`` counts the
    positions that come before the text (meta tokens and image patches),
    which the head and the loss cut off."""
    dtype = cfg.dtype
    positions = None
    if cfg.frontend == "audio":
        x = _project(params, batch["frames"], dtype)
        pe = torch.from_numpy(sinusoid_positions(x.shape[1], cfg.d_model))
        x = x + pe.to(device=x.device, dtype=dtype)
        prefix = 0
    elif cfg.frontend == "vlm":
        vis = _project(params, batch["patches"], dtype)
        txt = embed_tokens(params, batch["tokens"], dtype, ctx, cfg.vocab)
        x = torch.cat([vis, txt], dim=1)
        positions = torch.as_tensor(batch["positions3"], device=x.device)
        prefix = vis.shape[1]
    elif cfg.frontend == "none":
        x = embed_tokens(params, batch["tokens"], dtype, ctx, cfg.vocab)
        prefix = 0
    else:
        raise ValueError(f"unknown frontend {cfg.frontend!r}")
    if cfg.meta_tokens > 0:
        meta = params["meta_tokens"].to(dtype)
        x = torch.cat([meta[None].expand(x.shape[0], -1, -1), x], dim=1)
        prefix += cfg.meta_tokens
    if positions is None:                      # plain positions
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    return x, positions, prefix
