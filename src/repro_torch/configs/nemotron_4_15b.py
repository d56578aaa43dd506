"""nemotron-4-15b [dense] (arXiv:2402.16819). 32L d_model=6144 48H
(GQA kv=8) d_ff=24576 vocab=256000; squared-ReLU MLP (no GLU), partial
RoPE (50%), untied embeddings. Pure full attention ⇒ long_500k SKIPPED."""

import torch

from ..models.model import ModelConfig
from ..models.transformer import LayerSpec
from .common import gqa


def config() -> ModelConfig:
    spec = LayerSpec(
        kind="attn",
        attn=gqa(6144, 48, 8, 128, rope="partial", rotary_fraction=0.5),
        d_ff=24576, activation="relu2", gated=False)
    return ModelConfig(
        name="nemotron-4-15b", d_model=6144, vocab=256000,
        plan=((spec, 32),), tie_embeddings=False)


def smoke_config() -> ModelConfig:
    spec = LayerSpec(
        kind="attn",
        attn=gqa(64, 8, 2, 8, rope="partial", rotary_fraction=0.5,
                 q_chunk=16, kv_chunk=16),
        d_ff=128, activation="relu2", gated=False)
    return ModelConfig(
        name="nemotron-smoke", d_model=64, vocab=128,
        plan=((spec, 2),), tie_embeddings=False, dtype=torch.float32,
        loss_chunk=16)
