"""The language model: embed → segmented blocks → head, after
``repro/models/model.py``.

Public entry points (functions of (cfg, params, ...)):
  init_params    parameters on the card (or the CPU when asked)
  forward_hidden trunk output
  logits_for     (B, D) -> (B, V) float32 logits of the tied head
  init_cache     decode caches
  prefill        prompt ingestion -> (last-token logits, caches, index)
  decode_step    one-token step -> (logits, caches), caches in place

Parameters are held as the reference's use sites see them: every matrix
(rank >= 2) in ``cfg.dtype``, every vector in float32 (``cast_params``).
The dense projections and the tied head are ``torch.matmul``, as the
reference leaves them to XLA. Training (``loss_fn``, ``chunked_ce``)
comes with the training slice (ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from ..device import resolve_device
from .frontends import assemble, embed_tokens
from .layers import (dense_init, embed_init, layernorm, layernorm_init,
                     rmsnorm, rmsnorm_init)
from .transformer import (LayerSpec, layer_init_cache, segment_forward,
                          segment_init)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    vocab: int
    plan: Tuple[Tuple[LayerSpec, int], ...]
    norm: str = "rmsnorm"              # final norm kind
    tie_embeddings: bool = True
    meta_tokens: int = 0               # hymba learnable prefix
    frontend: str = "none"             # none | audio | vlm
    dtype: torch.dtype = torch.bfloat16
    decode_supported: bool = True      # False: encoder-only

    @property
    def n_layers(self) -> int:
        return sum(c for _, c in self.plan)


# --- init -----------------------------------------------------------------------

def cast_params(params, dtype: torch.dtype):
    """Matrices (rank >= 2) to ``dtype``, vectors to float32."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [cast_params(v, dtype) for v in params]
    return params.to(dtype if params.dim() >= 2 else torch.float32)


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Union[str, torch.device] = "cuda") -> Dict:
    """Random parameters drawn on ``device`` from a ``torch.Generator``
    seeded with ``seed``, cast as :func:`cast_params` says."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    kw = {"generator": gen, "device": dev}
    p: Dict[str, Any] = {
        "embed": {"tokens": embed_init((cfg.vocab, cfg.d_model), **kw)},
        "final_norm": (layernorm_init(cfg.d_model, dev)
                       if cfg.norm == "layernorm"
                       else rmsnorm_init(cfg.d_model, dev)),
    }
    if cfg.meta_tokens > 0:
        p["meta_tokens"] = 0.02 * torch.randn(
            cfg.meta_tokens, cfg.d_model, generator=gen, device=dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init((cfg.d_model, cfg.vocab), **kw)
    p["segments"] = [segment_init(spec, count, cfg.d_model, **kw)
                     for spec, count in cfg.plan]
    return cast_params(p, cfg.dtype)


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, list):
        return sum(param_count(v) for v in params)
    return params.numel()


# --- trunk ----------------------------------------------------------------------

def _final_norm(cfg: ModelConfig, params, x):
    if cfg.norm == "layernorm":
        return layernorm(params["final_norm"], x)
    return rmsnorm(params["final_norm"], x)


def forward_hidden(cfg: ModelConfig, params, batch: Dict,
                   mode: str = "train", caches: Optional[List] = None,
                   ) -> Tuple[torch.Tensor, Optional[List], int]:
    """Trunk forward. Returns (h, new_caches, prefix_len)."""
    x, prefix = assemble(cfg, params, batch)
    new_caches: List[Any] = []
    for i, (spec, _) in enumerate(cfg.plan):
        x, c = segment_forward(params["segments"][i], x, spec, mode,
                               caches[i] if caches is not None else None)
        new_caches.append(c)
    h = _final_norm(cfg, params, x)
    return h, (new_caches if mode != "train" else None), prefix


# --- head -----------------------------------------------------------------------

def _head_weight(cfg: ModelConfig, params) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"]["tokens"]        # (V, D) — used transposed
    return params["lm_head"].T                  # (V, D) view for same path


def _head_scale(cfg: ModelConfig) -> float:
    """Tied heads scale logits by 1/sqrt(D) (Gemma/T5 convention) so the
    N(0,1) embedding table doubles as a sanely-scaled unembedding."""
    return cfg.d_model ** -0.5 if cfg.tie_embeddings else 1.0


def logits_for(cfg: ModelConfig, params, h_last: torch.Tensor,
               ) -> torch.Tensor:
    """(B, D) -> (B, V) float32 logits (decode head)."""
    w = _head_weight(cfg, params)
    return ((h_last * _head_scale(cfg)) @ w.to(h_last.dtype).T).float()


# --- decode ---------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: Union[str, torch.device] = "cuda") -> List:
    """Per-segment lists of per-layer caches. SSM caches are O(1) in
    context; ``max_len`` sizes the attention caches of later slices."""
    dev = resolve_device(device)
    return [[layer_init_cache(spec, batch, dtype, dev) for _ in range(count)]
            for spec, count in cfg.plan]


def prefill(cfg: ModelConfig, params, batch: Dict, max_len: int,
            cache_dtype: torch.dtype = torch.bfloat16,
            ) -> Tuple[torch.Tensor, List, int]:
    """Ingest the prompt. Returns (last-token logits, caches, next_index).

    The SSM layers' prefill caches are already in the decode layout and
    keep the reference's types (conv tails in the model dtype, states in
    float32); ``max_len`` and ``cache_dtype`` size and type the attention
    caches of later slices."""
    h, caches, _ = forward_hidden(cfg, params, batch, "prefill")
    logits = logits_for(cfg, params, h[:, -1])
    return logits, caches, h.shape[1]     # meta/prefix included


def decode_step(cfg: ModelConfig, params, token: torch.Tensor,
                caches: List, index: int) -> Tuple[torch.Tensor, List]:
    """token (B, 1) int at absolute position ``index`` (which the SSM
    layers do not need). Returns ((B, V) logits, caches); the caches are
    updated in place."""
    h = embed_tokens(params, token, cfg.dtype)
    for i, (spec, _) in enumerate(cfg.plan):
        h, caches[i] = segment_forward(params["segments"][i], h, spec,
                                       "decode", caches[i])
    h = _final_norm(cfg, params, h)
    return logits_for(cfg, params, h[:, -1]), caches
