"""deepseek-v2-236b [moe] (arXiv:2405.04434). 60L d_model=5120, MLA
attention (kv_lora=512, q_lora=1536, rope_dim=64, nope_dim=128,
v_head=128, 128 heads — decode caches only the 512+64 latent, shared
across heads), MoE with 2 shared + 160 routed experts top-6 (expert
d_ff=1536); the FIRST layer uses a dense d_ff=12288 FFN (paper layout).
vocab=102400. Full attention ⇒ long_500k SKIPPED.

The full config holds 235,217,146,880 parameters (438 GiB in bfloat16):
it does not fit one 80 GB card."""

import torch

from ..models.attention import AttnConfig
from ..models.model import ModelConfig
from ..models.moe import MoEConfig
from ..models.transformer import LayerSpec


def _mla(d: int, heads: int, q_lora: int, kv_lora: int, nope: int,
         rope: int, vh: int, **kw) -> AttnConfig:
    return AttnConfig(
        d_model=d, n_heads=heads, n_kv_heads=heads, head_dim=nope + rope,
        q_lora_rank=q_lora, kv_lora_rank=kv_lora, qk_nope_dim=nope,
        qk_rope_dim=rope, v_head_dim=vh, **kw)


def config() -> ModelConfig:
    attn = _mla(5120, 128, 1536, 512, 128, 64, 128)
    dense = LayerSpec(kind="attn", attn=attn, d_ff=12288,
                      activation="silu", gated=True)
    moe = LayerSpec(
        kind="attn", attn=attn, d_ff=0,
        moe=MoEConfig(d_model=5120, d_ff=1536, n_experts=160, top_k=6,
                      n_shared=2, capacity_factor=1.25))
    return ModelConfig(
        name="deepseek-v2-236b", d_model=5120, vocab=102400,
        plan=((dense, 1), (moe, 59)))


def smoke_config() -> ModelConfig:
    attn = _mla(64, 4, 32, 16, 8, 8, 8, q_chunk=16, kv_chunk=16)
    dense = LayerSpec(kind="attn", attn=attn, d_ff=128,
                      activation="silu", gated=True)
    moe = LayerSpec(
        kind="attn", attn=attn, d_ff=0,
        moe=MoEConfig(d_model=64, d_ff=32, n_experts=8, top_k=2,
                      n_shared=1, capacity_factor=2.0))
    return ModelConfig(
        name="deepseek-smoke", d_model=64, vocab=128,
        plan=((dense, 1), (moe, 2)), dtype=torch.float32, loss_chunk=16)
