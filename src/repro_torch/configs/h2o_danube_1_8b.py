"""h2o-danube-1.8b [dense] (arXiv:2401.16818) — llama+mistral mix with
sliding-window attention. 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000, window=4096. SWA ⇒ decode cache is a ring buffer and
long_500k RUNS (O(window) per token)."""

import torch

from ..models.model import ModelConfig
from ..models.transformer import LayerSpec
from .common import gqa

SWA_WINDOW = 4096


def config() -> ModelConfig:
    spec = LayerSpec(
        kind="attn",
        attn=gqa(2560, 32, 8, 80, window=SWA_WINDOW),
        d_ff=6912, activation="silu", gated=True)
    return ModelConfig(
        name="h2o-danube-1.8b", d_model=2560, vocab=32000,
        plan=((spec, 24),), long_context=True)


def smoke_config() -> ModelConfig:
    spec = LayerSpec(
        kind="attn",
        attn=gqa(64, 4, 2, 16, window=8, q_chunk=8, kv_chunk=8),
        d_ff=128, activation="silu", gated=True)
    return ModelConfig(
        name="h2o-danube-smoke", d_model=64, vocab=128,
        plan=((spec, 2),), long_context=True, dtype=torch.float32,
        loss_chunk=16)
