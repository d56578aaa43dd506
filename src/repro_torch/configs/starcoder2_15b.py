"""starcoder2-15b [dense] (arXiv:2402.19173). 40L d_model=6144 48H
(GQA kv=4) d_ff=24576 vocab=49152; RoPE, layernorm, non-gated GELU MLP,
untied embeddings. Full attention ⇒ long_500k SKIPPED."""

import torch

from ..models.model import ModelConfig
from ..models.transformer import LayerSpec
from .common import gqa


def config() -> ModelConfig:
    spec = LayerSpec(
        kind="attn",
        attn=gqa(6144, 48, 4, 128, rope="rope"),
        d_ff=24576, activation="gelu", gated=False, norm="layernorm")
    return ModelConfig(
        name="starcoder2-15b", d_model=6144, vocab=49152,
        plan=((spec, 40),), norm="layernorm", tie_embeddings=False)


def smoke_config() -> ModelConfig:
    spec = LayerSpec(
        kind="attn",
        attn=gqa(64, 8, 2, 8, q_chunk=16, kv_chunk=16),
        d_ff=128, activation="gelu", gated=False, norm="layernorm")
    return ModelConfig(
        name="starcoder2-smoke", d_model=64, vocab=128,
        plan=((spec, 2),), norm="layernorm", tie_embeddings=False,
        dtype=torch.float32, loss_chunk=16)
