"""stablelm-3b [dense] (hf:stabilityai/stablelm-2 family). 32L d_model=2560
32H (GQA kv=32 ⇒ MHA-equal) d_ff=6912 vocab=50304; partial RoPE (25%),
qkv biases, gated-SiLU MLP. Full attention ⇒ long_500k SKIPPED."""

import torch

from ..models.model import ModelConfig
from ..models.transformer import LayerSpec
from .common import gqa


def config() -> ModelConfig:
    spec = LayerSpec(
        kind="attn",
        attn=gqa(2560, 32, 32, 80, rope="partial", rotary_fraction=0.25,
                 qkv_bias=True),
        d_ff=6912, activation="silu", gated=True)
    return ModelConfig(
        name="stablelm-3b", d_model=2560, vocab=50304,
        plan=((spec, 32),))


def smoke_config() -> ModelConfig:
    spec = LayerSpec(
        kind="attn",
        attn=gqa(64, 4, 4, 16, rope="partial", rotary_fraction=0.25,
                 qkv_bias=True, q_chunk=16, kv_chunk=16),
        d_ff=128, activation="silu", gated=True)
    return ModelConfig(
        name="stablelm-smoke", d_model=64, vocab=128,
        plan=((spec, 2),), dtype=torch.float32, loss_chunk=16)
