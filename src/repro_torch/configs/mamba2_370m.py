"""mamba2-370m [ssm] (arXiv:2405.21060) — attention-free SSD. 48L
d_model=1024, ssm_state=128, head_dim=64 (⇒ 32 SSD heads), no FFN
(d_ff=0), vocab=50280. Decode cache = (conv state, SSM state) — O(1) in
context."""

import torch

from ..models.model import ModelConfig
from ..models.ssm import SSMConfig
from ..models.transformer import LayerSpec


def config() -> ModelConfig:
    spec = LayerSpec(
        kind="ssm",
        ssm=SSMConfig(d_model=1024, d_state=128, head_dim=64, expand=2,
                      n_groups=1, chunk=128),
        d_ff=0)
    return ModelConfig(
        name="mamba2-370m", d_model=1024, vocab=50280,
        plan=((spec, 48),), long_context=True)


def smoke_config() -> ModelConfig:
    spec = LayerSpec(
        kind="ssm",
        ssm=SSMConfig(d_model=64, d_state=16, head_dim=8, expand=2,
                      n_groups=1, chunk=8),
        d_ff=0)
    return ModelConfig(
        name="mamba2-smoke", d_model=64, vocab=128,
        plan=((spec, 3),), long_context=True, dtype=torch.float32,
        loss_chunk=16)
