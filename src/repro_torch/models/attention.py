"""Grouped-query and sliding-window attention, prefill and decode, after
``repro/models/attention.py``.

Prefill runs :func:`repro_torch.kernels.flashattn.flash_attention`: on a
CUDA tensor that is the hand-written online-softmax kernel, which visits
only the KV tiles a query tile can see (the visit bound of the
reference's ``chunked_attention``, whose function it computes), and on a
CPU tensor its plain version. Decode is single-token dense attention over
the cache in plain PyTorch, as in the reference; a sliding-window layer
keeps a ring buffer of ``window`` slots (slot = position % window).

Shapes: q (B, S, H, hd), k and v (B, S, Hkv, hd); query head ``h`` reads KV
head ``h // (H // Hkv)``. Projections are ``torch.matmul`` in the model
dtype. Rotary embeddings: standard, partial (the leading fraction of
head_dim) or qwen2-vl's M-RoPE, whose positions are (B, 3, S) (t, h, w)
ids. MLA (deepseek-v2) comes with that model's slice and raises until
then. Mesh and sharding anchors are not part of the port (one card).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from ..kernels.flashattn import flash_attention
from .layers import apply_mrope, apply_rope, dense_init

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope: str = "rope"              # rope | partial | mrope | none
    rope_theta: float = 10000.0
    rotary_fraction: float = 1.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    window: int = 0                 # 0 = full attention; >0 = SWA
    causal: bool = True
    qkv_bias: bool = False          # stablelm-2 / qwen2 style
    # the reference's online-softmax chunk sizes (its XLA path); the
    # port's kernel tiles by 64 and ignores them
    q_chunk: int = 512
    kv_chunk: int = 1024
    # MLA (deepseek-v2) — 0 disables
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0


def check_config(cfg: AttnConfig) -> None:
    """Raise for the attention forms the port does not build yet."""
    if cfg.is_mla:
        raise NotImplementedError(
            "MLA attention is not ported yet: it comes with the MLA slice "
            "(deepseek-v2-236b; ROADMAP Queue 1)")


# --- parameter init ----------------------------------------------------------

def attn_init(cfg: AttnConfig, *, generator: torch.Generator,
              device: torch.device,
              dtype: torch.dtype = torch.float32) -> Dict:
    """Parameters of one attention block: the drawn matrices in
    ``dtype``, the biases in float32 (the model casts them)."""
    check_config(cfg)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = {"generator": generator, "device": device, "dtype": dtype}
    p = {
        "wq": dense_init((d, h, hd), fan_in=d, **kw),
        "wk": dense_init((d, kv, hd), fan_in=d, **kw),
        "wv": dense_init((d, kv, hd), fan_in=d, **kw),
        "wo": dense_init((h, hd, d), fan_in=h * hd, **kw),
    }
    if cfg.qkv_bias:
        f32 = torch.float32
        p["bq"] = torch.zeros(h, hd, dtype=f32, device=device)
        p["bk"] = torch.zeros(kv, hd, dtype=f32, device=device)
        p["bv"] = torch.zeros(kv, hd, dtype=f32, device=device)
    return p


# --- projections -------------------------------------------------------------

def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, D) @ (D, heads, hd) -> (B, S, heads, hd), one matmul."""
    return (x @ w.to(x.dtype).flatten(1)).unflatten(-1, w.shape[1:])


def _project_qkv(params, x: torch.Tensor, cfg: AttnConfig,
                 positions: torch.Tensor):
    dt = x.dtype
    q, k, v = (_heads(x, params[w]) for w in ("wq", "wk", "wv"))
    if "bq" in params:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    if cfg.rope in ("rope", "partial"):
        frac = cfg.rotary_fraction if cfg.rope == "partial" else 1.0
        q = apply_rope(q, positions, cfg.rope_theta, frac)
        k = apply_rope(k, positions, cfg.rope_theta, frac)
    elif cfg.rope == "mrope":                  # positions: (B, 3, S)
        q = apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
    return q, k, v


def _out(params, o: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) @ (H, hd, D) -> (B, S, D)."""
    wo = params["wo"]
    return o.flatten(2) @ wo.to(o.dtype).flatten(0, 1)


# --- prefill / decode --------------------------------------------------------

def attn_forward(params, x: torch.Tensor, cfg: AttnConfig,
                 positions: Optional[torch.Tensor] = None,
                 cache: bool = True,
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Training / prefill forward. Returns (out, cache entries): the
    full-sequence k and v (B, S, Hkv, hd) in the model dtype, or None
    when ``cache`` is False (training keeps no decode cache)."""
    check_config(cfg)
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, cfg, positions)
    out = flash_attention(q, k, v, causal=cfg.causal, window=cfg.window)
    return _out(params, out), ({"k": k, "v": v} if cache else None)


def attn_decode(params, x: torch.Tensor, cache: Dict, cfg: AttnConfig,
                cache_index: int) -> Tuple[torch.Tensor, Dict]:
    """One-token decode against a (possibly ring) KV cache.

    x: (B, 1, D); cache {"k", "v"}: (B, C, Hkv, hd) where C = window for
    SWA or max_len otherwise; ``cache_index`` is the number of positions
    already absorbed (the absolute position of the new token). The cache
    is updated in place and returned."""
    check_config(cfg)
    b = x.shape[0]
    # a decoded token is text: M-RoPE's three ids advance together
    shape = (b, 3, 1) if cfg.rope == "mrope" else (b, 1)
    pos = torch.full(shape, cache_index, dtype=torch.int64, device=x.device)
    q, k, v = _project_qkv(params, x, cfg, pos)

    c = cache["k"].shape[1]
    if cfg.window > 0:
        slot = cache_index % c              # ring buffer (c == window)
    else:
        slot = min(cache_index, c - 1)
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)

    # which cache slots hold real tokens (ring-aware): once the ring has
    # wrapped every slot is live; before that only slots [0, slot]
    idx = torch.arange(c, device=x.device)
    valid = idx <= slot
    if cfg.window > 0 and cache_index >= c:
        valid = torch.ones_like(valid)
    kv_h, hd = k.shape[2], k.shape[3]
    g = cfg.n_heads // kv_h
    ct = torch.promote_types(q.dtype, cache["k"].dtype)
    qg = q.reshape(b, 1, kv_h, g, hd).to(ct)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg,
                     cache["k"].to(ct)).to(torch.float32)
    s = s / math.sqrt(hd)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    vt = torch.promote_types(v.dtype, cache["v"].dtype)
    o = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype).to(vt),
                     cache["v"].to(vt))
    o = o.reshape(b, 1, cfg.n_heads, hd).to(x.dtype)
    return _out(params, o), cache


def attn_init_cache(cfg: AttnConfig, batch: int, max_len: int,
                    dtype: torch.dtype, device: torch.device) -> Dict:
    check_config(cfg)
    c = min(cfg.window, max_len) if cfg.window > 0 else max_len
    shape = (batch, c, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
