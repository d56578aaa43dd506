"""qwen2-vl-7b [vlm] (arXiv:2409.12191). 28L d_model=3584 28H (GQA kv=4)
d_ff=18944 vocab=152064; M-RoPE (t/h/w frequency sections 16/24/24 over
head_dim=128), qkv biases. The vision tower is a STUB: the batch
supplies patch embeddings (B, P, 1280) prepended to the text span.
Full attention ⇒ long_500k SKIPPED."""

import torch

from ..models.model import ModelConfig
from ..models.transformer import LayerSpec
from .common import gqa


def config() -> ModelConfig:
    spec = LayerSpec(
        kind="attn",
        attn=gqa(3584, 28, 4, 128, rope="mrope",
                 mrope_sections=(16, 24, 24), qkv_bias=True),
        d_ff=18944, activation="silu", gated=True)
    return ModelConfig(
        name="qwen2-vl-7b", d_model=3584, vocab=152064,
        plan=((spec, 28),), frontend="vlm", frontend_dim=1280,
        tie_embeddings=False)


def smoke_config() -> ModelConfig:
    spec = LayerSpec(
        kind="attn",
        attn=gqa(64, 4, 2, 16, rope="mrope", mrope_sections=(2, 3, 3),
                 qkv_bias=True, q_chunk=16, kv_chunk=16),
        d_ff=128, activation="silu", gated=True)
    return ModelConfig(
        name="qwen2-vl-smoke", d_model=64, vocab=128,
        plan=((spec, 2),), frontend="vlm", frontend_dim=24,
        tie_embeddings=False, dtype=torch.float32, loss_chunk=16)
