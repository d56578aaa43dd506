"""Layer blocks and the segmented stack, after
``repro/models/transformer.py``.

A model is a sequence of SEGMENTS; each segment is ``count`` structurally
identical layers. The reference stacks a segment's parameters on a
leading axis and runs ``jax.lax.scan``; here a segment is a list of
per-layer parameter dictionaries walked by a Python loop.

Only the ``ssm`` block (pre-norm mamba2 mixer, no FFN) is ported. The
attention and hybrid blocks, MoE and the dense FFN come with the slices
that need them (ROADMAP Queue 1) and raise until then.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from .layers import layernorm, layernorm_init, rmsnorm, rmsnorm_init
from .ssm import SSMConfig, ssm_decode, ssm_forward, ssm_init, ssm_init_cache

MODES = ("train", "prefill", "decode")


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str                        # "attn" | "ssm" | "hybrid"
    attn: Optional[Any] = None
    ssm: Optional[SSMConfig] = None
    moe: Optional[Any] = None
    d_ff: int = 0                    # dense FFN hidden (0 = no dense FFN)
    norm: str = "rmsnorm"            # rmsnorm | layernorm


def check_spec(spec: LayerSpec) -> None:
    """Raise for the block kinds the port does not build yet."""
    if spec.kind in ("attn", "hybrid"):
        raise NotImplementedError(
            f"{spec.kind!r} layers are not ported yet (ROADMAP Queue 1: "
            "the hymba slice adds models/attention.py)")
    if spec.kind != "ssm" or spec.ssm is None:
        raise ValueError(f"layer kind {spec.kind!r} needs an SSMConfig")
    if spec.moe is not None:
        raise NotImplementedError("MoE layers are not ported yet (ROADMAP "
                                  "Queue 1: the remaining model families)")
    if spec.d_ff > 0:
        raise NotImplementedError("the dense FFN is not ported yet (ROADMAP "
                                  "Queue 1: the hymba slice)")


def _norm_init(spec: LayerSpec, d: int, device: torch.device):
    if spec.norm == "layernorm":
        return layernorm_init(d, device)
    return rmsnorm_init(d, device)


def _norm(spec: LayerSpec, p, x):
    return layernorm(p, x) if spec.norm == "layernorm" else rmsnorm(p, x)


# --- single layer -----------------------------------------------------------------

def layer_init(spec: LayerSpec, d_model: int, *,
               generator: torch.Generator, device: torch.device) -> Dict:
    check_spec(spec)
    return {"norm1": _norm_init(spec, d_model, device),
            "ssm": ssm_init(spec.ssm, generator=generator, device=device)}


def layer_forward(params, x: torch.Tensor, spec: LayerSpec,
                  mode: str = "train", cache: Optional[Dict] = None,
                  ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Pre-norm residual layer. Returns (x, new_cache): the prefill cache
    entries, the (in place) updated decode cache, or None in train."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    x_n = _norm(spec, params["norm1"], x)
    if mode == "decode":
        y, c = ssm_decode(params["ssm"], x_n, cache["ssm"], spec.ssm)
    else:
        y, c = ssm_forward(params["ssm"], x_n, spec.ssm)
    return x + y, ({"ssm": c} if mode != "train" else None)


def layer_init_cache(spec: LayerSpec, batch: int, dtype: torch.dtype,
                     device: torch.device) -> Dict:
    check_spec(spec)
    return {"ssm": ssm_init_cache(spec.ssm, batch, dtype, device)}


# --- segments ---------------------------------------------------------------------

def segment_init(spec: LayerSpec, count: int, d_model: int, *,
                 generator: torch.Generator,
                 device: torch.device) -> List[Dict]:
    return [layer_init(spec, d_model, generator=generator, device=device)
            for _ in range(count)]


def segment_forward(params: List[Dict], x: torch.Tensor, spec: LayerSpec,
                    mode: str = "train", caches: Optional[List] = None,
                    ) -> Tuple[torch.Tensor, Optional[List]]:
    """Run a segment's layers in order. Returns (x, per-layer caches),
    the caches None in train."""
    new_caches = []
    for i, layer_p in enumerate(params):
        x, c = layer_forward(layer_p, x, spec, mode,
                             caches[i] if caches is not None else None)
        new_caches.append(c)
    return x, (new_caches if mode != "train" else None)
