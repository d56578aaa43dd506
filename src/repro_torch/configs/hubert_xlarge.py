"""hubert-xlarge [audio] (arXiv:2106.07447) — encoder-only masked-unit
prediction. 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 units;
layernorm, non-gated GELU, non-causal attention, no RoPE (sinusoidal
stand-in for the conv positional encoding). The conv
waveform frontend is a STUB: the batch supplies precomputed frame
embeddings (B, S, 512). Encoder-only ⇒ decode_32k / long_500k SKIPPED."""

import torch

from ..models.model import ModelConfig
from ..models.transformer import LayerSpec
from .common import gqa


def config() -> ModelConfig:
    spec = LayerSpec(
        kind="attn",
        attn=gqa(1280, 16, 16, 80, rope="none", causal=False),
        d_ff=5120, activation="gelu", gated=False, norm="layernorm")
    return ModelConfig(
        name="hubert-xlarge", d_model=1280, vocab=504,
        plan=((spec, 48),), norm="layernorm", causal=False,
        frontend="audio", frontend_dim=512, tie_embeddings=False,
        decode_supported=False)


def smoke_config() -> ModelConfig:
    spec = LayerSpec(
        kind="attn",
        attn=gqa(64, 4, 4, 16, rope="none", causal=False,
                 q_chunk=16, kv_chunk=16),
        d_ff=128, activation="gelu", gated=False, norm="layernorm")
    return ModelConfig(
        name="hubert-smoke", d_model=64, vocab=32,
        plan=((spec, 2),), norm="layernorm", causal=False,
        frontend="audio", frontend_dim=24, tie_embeddings=False,
        decode_supported=False, dtype=torch.float32, loss_chunk=16)
