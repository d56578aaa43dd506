"""Shared helpers for architecture configs, after
``repro/configs/common.py``."""

from __future__ import annotations

from typing import Optional

from ..models.attention import AttnConfig


def gqa(d_model: int, n_heads: int, n_kv: int, head_dim: Optional[int] = None,
        **kw) -> AttnConfig:
    return AttnConfig(d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
                      head_dim=head_dim or d_model // n_heads, **kw)
