"""granite-moe-1b-a400m [moe] (hf:ibm-granite/granite-3.0-1b-a400m-base).
24L d_model=1024 16H (GQA kv=8) fine-grained experts d_ff=512, 32 experts
top-8, vocab=49155. Full attention ⇒ long_500k SKIPPED."""

import torch

from ..models.model import ModelConfig
from ..models.moe import MoEConfig
from ..models.transformer import LayerSpec
from .common import gqa


def config() -> ModelConfig:
    spec = LayerSpec(
        kind="attn",
        attn=gqa(1024, 16, 8, 64),
        d_ff=0,
        moe=MoEConfig(d_model=1024, d_ff=512, n_experts=32, top_k=8,
                      capacity_factor=1.25))
    return ModelConfig(
        name="granite-moe-1b-a400m", d_model=1024, vocab=49155,
        plan=((spec, 24),))


def smoke_config() -> ModelConfig:
    spec = LayerSpec(
        kind="attn",
        attn=gqa(64, 4, 2, 16, q_chunk=16, kv_chunk=16),
        d_ff=0,
        moe=MoEConfig(d_model=64, d_ff=16, n_experts=8, top_k=4,
                      capacity_factor=2.0))
    return ModelConfig(
        name="granite-moe-smoke", d_model=64, vocab=128,
        plan=((spec, 2),), dtype=torch.float32, loss_chunk=16)
