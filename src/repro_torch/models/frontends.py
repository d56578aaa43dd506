"""Input assembly, after ``repro/models/frontends.py``: token embeddings
plus the learnable meta-token prefix. The audio and VLM frontends come
with the slices of the models that use them (ROADMAP Queue 1)."""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def embed_tokens(params, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    table = params["embed"]["tokens"]
    return table[tokens.to(device=table.device, dtype=torch.long)].to(dtype)


def assemble(cfg, params, batch: Dict,
             ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Returns (x (B, S_total, D), positions (1, S_total), prefix_len):
    ``prefix_len`` counts the meta-token positions that come before the
    text, and the positions count them too."""
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"frontend {cfg.frontend!r} is not ported yet (ROADMAP Queue 1: "
            "the remaining model families)")
    x = embed_tokens(params, batch["tokens"], cfg.dtype)
    prefix = 0
    if cfg.meta_tokens > 0:
        meta = params["meta_tokens"].to(cfg.dtype)
        x = torch.cat([meta[None].expand(x.shape[0], -1, -1), x], dim=1)
        prefix = cfg.meta_tokens
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    return x, positions, prefix
