"""hymba-1.5b [hybrid] — parallel attention+mamba heads per layer
(arXiv:2411.13676). 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16; 128 learnable meta tokens; SWA everywhere except 3 global
full-attention layers (first / middle / last). Decode keeps a ring of
``SWA_WINDOW`` slots in the SWA layers and the SSM state, so only the 3
global layers carry a full-depth KV cache."""

import torch

from ..models.model import ModelConfig
from ..models.ssm import SSMConfig
from ..models.transformer import LayerSpec
from .common import gqa

SWA_WINDOW = 1024


def _hybrid(d: int, heads: int, kv: int, hd: int, d_ff: int,
            ssm_state: int, window: int, chunk: int = 128) -> LayerSpec:
    return LayerSpec(
        kind="hybrid",
        attn=gqa(d, heads, kv, hd, window=window),
        ssm=SSMConfig(d_model=d, d_state=ssm_state, head_dim=hd,
                      expand=2, n_groups=1, chunk=chunk),
        d_ff=d_ff, activation="silu", gated=True)


def config() -> ModelConfig:
    g = _hybrid(1600, 25, 5, 64, 5504, 16, window=0)
    w = _hybrid(1600, 25, 5, 64, 5504, 16, window=SWA_WINDOW)
    return ModelConfig(
        name="hymba-1.5b", d_model=1600, vocab=32001,
        plan=((g, 1), (w, 14), (g, 1), (w, 15), (g, 1)),
        meta_tokens=128, long_context=True)


def smoke_config() -> ModelConfig:
    g = _hybrid(64, 5, 1, 8, 96, 4, window=0, chunk=8)
    w = _hybrid(64, 5, 1, 8, 96, 4, window=8, chunk=8)
    return ModelConfig(
        name="hymba-smoke", d_model=64, vocab=128,
        plan=((g, 1), (w, 2), (g, 1)),
        meta_tokens=8, long_context=True, dtype=torch.float32,
        loss_chunk=16)
