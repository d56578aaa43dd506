"""Layer blocks and the segmented stack, after
``repro/models/transformer.py``.

A model is a sequence of SEGMENTS; each segment is ``count`` structurally
identical layers. The reference stacks a segment's parameters on a
leading axis and runs ``jax.lax.scan``; here a segment is a list of
per-layer parameter dictionaries walked by a Python loop.

Block kinds:
  attn    pre-norm attention (+ optional dense FFN / MoE sub-block)
  ssm     pre-norm mamba2 mixer (mamba2: no FFN at all)
  hybrid  hymba: attention and SSM heads run IN PARALLEL on the same
          normed input; per-path output norms + learned gains, averaged.

A layer returns its metrics beside its output (an MoE layer's aux_loss
and dropped share; none for the others), and a segment reduces them over
its layers as the reference's ``_agg_metrics`` does.

A mesh context (:mod:`.shardrules`) reaches every mixer and FFN, whose
parameters are then the rank's (:mod:`.tp`): each layer first gathers
its leaves cut over ``data`` (``tp.gather_fsdp``), and the gathered
blocks go when the layer returns; at T > 1 a layer the layout does not
cover raises (``tp.check_layer``). Decode hands each attention layer
its block of the cache's slots where the layout cuts the length.
Training runs under a context of D data ranks and T tensor ranks: every
collective carries its backward (:mod:`.tp`), each block enters the
whole tensors its rank-local work reads (``tp.enter``), once, and work
every rank does whole (heads T does not divide, a hybrid layer's normed
mean) enters nothing, and under remat
``"full"`` the recompute issues the layer's forward collectives again,
in the same order on every rank (the data axis's gathers among them;
their backward reduce-scatters the gathered leaves' gradients).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .attention import (AttnConfig, attn_decode, attn_forward, attn_init,
                        attn_init_cache)
from .layers import (ffn_hidden, ffn_init, layernorm, layernorm_init,
                     rmsnorm, rmsnorm_init)
from . import tp
from .moe import MoEConfig, moe_forward, moe_init
from .shardrules import ParallelCtx
from .ssm import SSMConfig, ssm_decode, ssm_forward, ssm_init, ssm_init_cache

MODES = ("train", "prefill", "decode")


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str                        # "attn" | "ssm" | "hybrid"
    attn: Optional[AttnConfig] = None
    ssm: Optional[SSMConfig] = None
    moe: Optional[MoEConfig] = None
    d_ff: int = 0                    # dense FFN hidden (0 = no dense FFN)
    activation: str = "silu"
    gated: bool = True
    norm: str = "rmsnorm"            # rmsnorm | layernorm


def _has_attn(spec: LayerSpec) -> bool:
    return spec.kind in ("attn", "hybrid")


def _has_ssm(spec: LayerSpec) -> bool:
    return spec.kind in ("ssm", "hybrid")


def check_spec(spec: LayerSpec) -> None:
    """Raise for an unknown block kind or a missing sub-config."""
    if spec.kind not in ("attn", "ssm", "hybrid"):
        raise ValueError(f"unknown layer kind {spec.kind!r}")
    if _has_attn(spec) and spec.attn is None:
        raise ValueError(f"layer kind {spec.kind!r} needs an AttnConfig")
    if _has_ssm(spec) and spec.ssm is None:
        raise ValueError(f"layer kind {spec.kind!r} needs an SSMConfig")


def _norm_init(spec: LayerSpec, d: int, device: torch.device):
    if spec.norm == "layernorm":
        return layernorm_init(d, device)
    return rmsnorm_init(d, device)


def _norm(spec: LayerSpec, p, x):
    return layernorm(p, x) if spec.norm == "layernorm" else rmsnorm(p, x)


# --- single layer ------------------------------------------------------------

def layer_init(spec: LayerSpec, d_model: int, *,
               generator: torch.Generator, device: torch.device,
               dtype: torch.dtype = torch.float32) -> Dict:
    check_spec(spec)
    kw = {"generator": generator, "device": device, "dtype": dtype}
    p: Dict[str, Any] = {"norm1": _norm_init(spec, d_model, device)}
    if _has_attn(spec):
        p["attn"] = attn_init(spec.attn, **kw)
    if _has_ssm(spec):
        p["ssm"] = ssm_init(spec.ssm, **kw)
    if spec.kind == "hybrid":
        # per-path output norms + learned per-channel gains (hymba fusion)
        p["norm_attn"] = rmsnorm_init(d_model, device)
        p["norm_ssm"] = rmsnorm_init(d_model, device)
        p["gain_attn"] = torch.ones(d_model, dtype=torch.float32,
                                    device=device)
        p["gain_ssm"] = torch.ones(d_model, dtype=torch.float32,
                                   device=device)
    if spec.moe is not None:
        p["norm2"] = _norm_init(spec, d_model, device)
        p["moe"] = moe_init(spec.moe, **kw)
    elif spec.d_ff > 0:
        p["norm2"] = _norm_init(spec, d_model, device)
        p["ffn"] = ffn_init(d_model, spec.d_ff, spec.gated, **kw)
    return p


def _mixer(params, x_n: torch.Tensor, spec: LayerSpec, positions, mode: str,
           cache, cache_index, ctx: Optional[ParallelCtx] = None,
           block: Optional[tp.LengthBlock] = None,
           ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The sequence mixer part of a layer. Returns (y, new cache): the
    prefill cache entries, the (in place) updated decode cache, or None
    in train. ``block`` is the rank's block of the attention cache's
    slots in decode. Each part returns its output whole on every rank
    (a hybrid layer's attention may run replicated, its heads whole,
    beside an SSM on the rank's channels), so the normed mean fuses
    whole tensors; in training the gradients of its norms and gains are
    whole on every rank and summed nowhere."""
    ya = ys = None
    new_cache: Dict[str, Any] = {}
    keep = mode != "train"          # training builds no decode cache
    if _has_attn(spec):
        if mode == "decode":
            ya, new_cache["attn"] = attn_decode(
                params["attn"], x_n, cache["attn"], spec.attn, cache_index,
                ctx, block)
        else:
            ya, new_cache["attn"] = attn_forward(
                params["attn"], x_n, spec.attn, positions, keep, ctx)
    if _has_ssm(spec):
        if mode == "decode":
            ys, new_cache["ssm"] = ssm_decode(params["ssm"], x_n,
                                              cache["ssm"], spec.ssm, ctx)
        else:
            ys, new_cache["ssm"] = ssm_forward(params["ssm"], x_n, spec.ssm,
                                               keep, ctx)
    out = new_cache if keep else None
    if spec.kind != "hybrid":
        return (ya if ys is None else ys), out
    # hybrid (hymba): parallel attention + SSM heads, fused by normed mean
    ya = rmsnorm(params["norm_attn"], ya) * params["gain_attn"].to(ya.dtype)
    ys = rmsnorm(params["norm_ssm"], ys) * params["gain_ssm"].to(ys.dtype)
    return 0.5 * (ya + ys), out


def layer_forward(params, x: torch.Tensor, spec: LayerSpec,
                  positions: Optional[torch.Tensor] = None,
                  mode: str = "train", cache: Optional[Dict] = None,
                  cache_index: Optional[int] = None,
                  ctx: Optional[ParallelCtx] = None,
                  block: Optional[tp.LengthBlock] = None,
                  ) -> Tuple[torch.Tensor, Optional[Dict], Dict]:
    """Pre-norm residual layer (mixer, then the MoE or dense FFN if any).
    Returns (x, new_cache, metrics)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    tp.check_layer(spec, ctx)
    params = tp.gather_fsdp(params, ctx, x.shape[-1])
    metrics: Dict[str, torch.Tensor] = {}
    y, new_cache = _mixer(params, _norm(spec, params["norm1"], x), spec,
                          positions, mode, cache, cache_index, ctx, block)
    x = x + y
    if "moe" in params:
        h, metrics = moe_forward(params["moe"],
                                 _norm(spec, params["norm2"], x), spec.moe,
                                 ctx)
        x = x + h
    elif "ffn" in params:
        # a rank's hidden columns give a partial (the rules keep a d_ff
        # that T does not divide whole, and every rank runs it whole)
        w_down = params["ffn"]["w_down"]
        split = w_down.shape[0] < spec.d_ff
        x_n = _norm(spec, params["norm2"], x)
        h = ffn_hidden(params["ffn"], tp.enter(x_n, ctx) if split else x_n,
                       spec.activation)
        x = x + tp.sum_matmul(h, w_down, ctx, split)
    return x, new_cache, metrics


def layer_init_cache(spec: LayerSpec, batch: int, max_len: int,
                     dtype: torch.dtype, device: torch.device) -> Dict:
    check_spec(spec)
    c: Dict[str, Any] = {}
    if _has_attn(spec):
        c["attn"] = attn_init_cache(spec.attn, batch, max_len, dtype, device)
    if _has_ssm(spec):
        c["ssm"] = ssm_init_cache(spec.ssm, batch, dtype, device)
    return c


# --- segments ----------------------------------------------------------------

def segment_init(spec: LayerSpec, count: int, d_model: int, *,
                 generator: torch.Generator, device: torch.device,
                 dtype: torch.dtype = torch.float32) -> List[Dict]:
    return [layer_init(spec, d_model, generator=generator, device=device,
                       dtype=dtype)
            for _ in range(count)]


REMAT = ("none", "full", "dots")


def _train_layer(layer_p, x, spec, positions, ctx=None):
    x, _, metrics = layer_forward(layer_p, x, spec, positions, "train",
                                  ctx=ctx)
    return x, metrics


def _agg_metrics(ms: List[Dict]) -> Dict:
    """Reduce per-layer metrics: losses sum, the dropped share
    averages."""
    if not ms or not ms[0]:
        return {}
    return {k: (torch.stack([m[k] for m in ms]).mean() if k == "dropped"
                else torch.stack([m[k] for m in ms]).sum())
            for k in ms[0]}


def segment_forward(params: List[Dict], x: torch.Tensor, spec: LayerSpec,
                    positions: Optional[torch.Tensor] = None,
                    mode: str = "train", caches: Optional[List] = None,
                    cache_index: Optional[int] = None, remat: str = "full",
                    ctx: Optional[ParallelCtx] = None,
                    block: Optional[tp.LengthBlock] = None,
                    ) -> Tuple[torch.Tensor, Optional[List], Dict]:
    """Run a segment's layers in order. Returns (x, per-layer caches,
    metrics reduced over the layers), the caches None in train. In
    decode ``block`` is the rank's block of the attention caches' slots
    (the same in every layer of the segment).

    In train mode with ``remat == "full"`` and grad mode on, each layer
    runs under ``torch.utils.checkpoint`` (non-reentrant): backward keeps
    only the layer's input and runs the layer again, as the reference's
    ``jax.checkpoint`` does (``_maybe_remat``). ``"none"`` keeps every
    activation."""
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r} not in {REMAT}")
    if mode == "train":
        if remat == "dots":
            raise NotImplementedError(
                "remat='dots' (save the matmul outputs) is not ported yet "
                "(ROADMAP Queue 1)")
        ms = []
        for layer_p in params:
            if remat == "full" and torch.is_grad_enabled():
                x, m = checkpoint(_train_layer, layer_p, x, spec, positions,
                                  ctx, use_reentrant=False)
            else:
                x, m = _train_layer(layer_p, x, spec, positions, ctx)
            ms.append(m)
        return x, None, _agg_metrics(ms)
    new_caches, ms = [], []
    for i, layer_p in enumerate(params):
        x, c, m = layer_forward(layer_p, x, spec, positions, mode,
                                caches[i] if caches is not None else None,
                                cache_index, ctx, block)
        new_caches.append(c)
        ms.append(m)
    return x, new_caches, _agg_metrics(ms)
