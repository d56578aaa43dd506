"""Grouped-query, sliding-window and multi-head latent (MLA) attention,
prefill and decode, after ``repro/models/attention.py``.

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
ids.

MLA (deepseek-v2): queries and keys come from low-rank latents, with a
decoupled RoPE part (``qk_rope_dim``, its key shared by the heads) after
the ``qk_nope_dim`` part, so prefill attends with split head dims: q and k
(B, S, H, nope + rope), v (B, S, H, v_head_dim), through the same kernel.
Its cache holds the normed latent (B, C, kv_lora_rank) and the rotated
rope key (B, C, qk_rope_dim), shared by the heads, and decode runs in the
weight-absorbed latent form, in plain PyTorch, as the reference's does.
With a tensor-parallel context (:mod:`.shardrules`, :mod:`.tp`) the
parameters are the rank's: its H/T query heads and Hkv/T KV heads.
Prefill and decode attend over the rank's heads, by the same code as at
one rank, and add the ranks' ``wo`` partials with one ordered sum
(:func:`repro_torch.models.tp.ordered_sum`). MLA too: a rank computes
the latent and the rope key whole and its H/T heads' queries, keys and
values from them. Heads T does not divide stay whole on every rank
(hymba's 25 and 5 at T = 4), and their output needs no sum. In training
a whole tensor's gradient is summed over the ranks once (``tp.enter``):
``x`` where it enters the rank's heads, and where only the query heads
are the rank's, the whole k and v before the rank keeps the KV heads its
queries read; where every head is whole, nothing is summed.

Where the rules cannot cut the KV heads (or the batch), the cache's
length is cut instead (``cache_specs``), as it is for MLA's latent and
rope key, which have no head dim: each rank holds a block of the slots
(``tp.LengthBlock``). Prefill attends as above and keeps the rank's block
of the whole cache; where the query heads are the rank's and the KV
heads whole, it reads the KV heads its heads span. Decode writes the new
token's entry on the rank whose block holds its slot, takes the softmax
partials of every query head over the rank's slots (the queries gathered
whole where they are the rank's), merges them across the ranks in rank
order (``tp.softmax_merge``) and keeps the rank's heads for ``wo``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from ..kernels.flashattn import flash_attention
from . import tp
from .layers import apply_mrope, apply_rope, dense_init, rmsnorm
from .shardrules import ParallelCtx

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


# --- parameter init ----------------------------------------------------------

def attn_init(cfg: AttnConfig, *, generator: torch.Generator,
              device: torch.device,
              dtype: torch.dtype = torch.float32) -> Dict:
    """Parameters of one attention block: the drawn matrices in
    ``dtype``, the biases in float32 (the model casts them)."""
    if cfg.is_mla:
        return mla_init(cfg, generator=generator, device=device, dtype=dtype)
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


def mla_init(cfg: AttnConfig, *, generator: torch.Generator,
             device: torch.device,
             dtype: torch.dtype = torch.float32) -> Dict:
    """MLA's parameters: the reference's leaves, shapes and fan-ins, the
    two latent norms' scales in float32."""
    d, h = cfg.d_model, cfg.n_heads
    ql, kl = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kw = {"generator": generator, "device": device, "dtype": dtype}
    ones = {"dtype": torch.float32, "device": device}
    return {
        "wq_a": dense_init((d, ql), fan_in=d, **kw),          # down-proj
        "wq_b": dense_init((ql, h, dn + dr), fan_in=ql, **kw),
        "wkv_a": dense_init((d, kl), fan_in=d, **kw),         # latent
        "wk_rope": dense_init((d, dr), fan_in=d, **kw),       # shared rope k
        "wk_b": dense_init((kl, h, dn), fan_in=kl, **kw),     # up-proj K
        "wv_b": dense_init((kl, h, dv), fan_in=kl, **kw),     # up-proj V
        "wo": dense_init((h, dv, d), fan_in=h * dv, **kw),
        "q_norm": {"scale": torch.ones(ql, **ones)},
        "kv_norm": {"scale": torch.ones(kl, **ones)},
    }


# --- projections -------------------------------------------------------------

def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, D) @ (D, heads, hd) -> (B, S, heads, hd), one matmul (any
    trailing shape of ``w``: (D, r) gives (B, S, r))."""
    return (x @ w.to(x.dtype).flatten(1)).unflatten(-1, w.shape[1:])


def _project_qkv(params, x: torch.Tensor, cfg: AttnConfig,
                 positions: torch.Tensor,
                 ctx: Optional[ParallelCtx] = None):
    """q, k and v of the heads ``params`` hold (a rank's, under a
    tensor-parallel ``ctx``: the whole biases are cut to them, and ``x``
    enters the projections that hold the rank's heads, ``tp.enter``;
    whole ones read it as it is)."""
    dt = x.dtype
    xq = tp.enter(x, ctx) if _split_heads(params, cfg) else x
    xkv = xq if params["wk"].shape[1] < cfg.n_kv_heads else x
    q = _heads(xq, params["wq"])
    k, v = _heads(xkv, params["wk"]), _heads(xkv, params["wv"])
    if "bq" in params:
        q = q + tp.local_block(params["bq"], q.shape[2], ctx).to(dt)
        k = k + tp.local_block(params["bk"], k.shape[2], ctx).to(dt)
        v = v + tp.local_block(params["bv"], v.shape[2], ctx).to(dt)
    if cfg.rope in ("rope", "partial"):
        frac = cfg.rotary_fraction if cfg.rope == "partial" else 1.0
        q = apply_rope(q, positions, cfg.rope_theta, frac)
        k = apply_rope(k, positions, cfg.rope_theta, frac)
    elif cfg.rope == "mrope":                  # positions: (B, 3, S)
        q = apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
    return q, k, v


def _out(params, o: torch.Tensor, ctx: Optional[ParallelCtx] = None,
         split: bool = True) -> torch.Tensor:
    """(B, S, H, hd) @ (H, hd, D) -> (B, S, D); where ``params`` hold a
    rank's heads (``split``), the ranks' partials summed
    (``tp.sum_matmul``)."""
    return tp.sum_matmul(o.flatten(2), params["wo"].flatten(0, 1), ctx,
                         split)


def _split_heads(params, cfg: AttnConfig) -> bool:
    """Whether ``params`` hold a rank's share of the query heads (where T
    does not divide them, the rules keep them whole and every rank runs
    them all)."""
    return params["wo"].shape[0] < cfg.n_heads


def _rank_kv(k: torch.Tensor, v: torch.Tensor, hq: int, cfg: AttnConfig,
             ctx: Optional[ParallelCtx]):
    """k and v of the KV heads this rank's ``hq`` query heads read, where
    the rules cut the query heads but keep the KV heads whole (T does not
    divide them): the KV heads the rank's heads span, or one KV head a
    query head where those do not group evenly under them. The whole k
    and v enter (``tp.enter``) before they are cut, so their gradient,
    and ``wk`` / ``wv``'s, is summed once. Otherwise k and v as they
    are."""
    if hq == cfg.n_heads or k.shape[2] < cfg.n_kv_heads:
        return k, v
    k, v = tp.enter(k, ctx), tp.enter(v, ctx)
    g = cfg.n_heads // cfg.n_kv_heads
    heads = [(ctx.tensor_rank * hq + j) // g for j in range(hq)]
    lo, n = heads[0], heads[-1] - heads[0] + 1
    if hq % n == 0 and heads == [lo + j // (hq // n) for j in range(hq)]:
        return k.narrow(2, lo, n), v.narrow(2, lo, n)
    idx = torch.tensor(heads, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _whole_block(length: int) -> tp.LengthBlock:
    return tp.LengthBlock(0, length, length, None)


def _partials(s: torch.Tensor, v: torch.Tensor, eq: str):
    """A block's softmax partials over its last dim of masked float32
    scores ``s``: the max m, the sum l of ``exp(s - m)`` and the sum of
    ``exp(s - m)`` times the float32 values (einsum ``eq``)."""
    m = s.amax(-1)
    e = torch.exp(s - m[..., None])
    return m, e.sum(-1), torch.einsum(eq, e, v.float())


# --- prefill / decode --------------------------------------------------------

def attn_forward(params, x: torch.Tensor, cfg: AttnConfig,
                 positions: Optional[torch.Tensor] = None,
                 cache: bool = True, ctx: Optional[ParallelCtx] = None,
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Training / prefill forward. Returns (out, cache entries): the
    full-sequence k and v (B, S, Hkv, hd) in the model dtype (MLA: its
    latent and rope key), or None when ``cache`` is False (training keeps
    no decode cache). At T > 1 the rank's heads: its query heads' share
    of the output, summed over the ranks, and its KV heads' k and v (all
    of them where T does not divide them; where it divides neither, the
    heads run whole on every rank and nothing is summed)."""
    if cfg.is_mla:
        return mla_forward(params, x, cfg, positions, cache, ctx)
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, cfg, positions, ctx)
    kr, vr = _rank_kv(k, v, q.shape[2], cfg, ctx)
    out = flash_attention(q, kr, vr, causal=cfg.causal, window=cfg.window)
    return _out(params, out, ctx, _split_heads(params, cfg)), (
        {"k": k, "v": v} if cache else None)


def attn_decode(params, x: torch.Tensor, cache: Dict, cfg: AttnConfig,
                cache_index: int, ctx: Optional[ParallelCtx] = None,
                block: Optional[tp.LengthBlock] = None,
                ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode against a (possibly ring) KV cache.

    x: (B, 1, D); cache {"k", "v"}: (B, C, Hkv, hd) where C = window for
    SWA or max_len otherwise (at T > 1 the rank's Hkv/T heads, its
    queries' H/T); ``cache_index`` is the number of positions already
    absorbed (the absolute position of the new token). The cache is
    updated in place and returned.

    Where the layout cuts the cache's length (``block``: the rank's slots
    of the whole C), the mask is worked out in global slots, the new k
    and v are written by the rank whose block holds their slot, the rank
    takes its slots' softmax partials and ``tp.softmax_merge`` merges
    them over the block's axis. Where the KV heads are whole but the
    query heads the rank's, the queries of every head are gathered first
    (exact) and the rank keeps its heads' output for ``wo``."""
    if cfg.is_mla:
        return mla_decode(params, x, cache, cfg, cache_index, ctx, block)
    b = x.shape[0]
    # a decoded token is text: M-RoPE's three ids advance together
    shape = (b, 3, 1) if cfg.rope == "mrope" else (b, 1)
    pos = torch.full(shape, cache_index, dtype=torch.int64, device=x.device)
    q, k, v = _project_qkv(params, x, cfg, pos, ctx)

    blk = block or _whole_block(cache["k"].shape[1])
    c = blk.length
    if cfg.window > 0:
        slot = cache_index % c              # ring buffer (c == window)
    else:
        slot = min(cache_index, c - 1)
    if blk.start <= slot < blk.start + blk.size:
        cache["k"][:, slot - blk.start] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot - blk.start] = v[:, 0].to(cache["v"].dtype)

    # which cache slots hold real tokens (ring-aware): once the ring has
    # wrapped every slot is live; before that only slots [0, slot]
    idx = blk.start + torch.arange(blk.size, device=x.device)
    valid = idx <= slot
    if cfg.window > 0 and cache_index >= c:
        valid = torch.ones_like(valid)
    hq = q.shape[2]
    if hq < cfg.n_heads and cache["k"].shape[2] == cfg.n_kv_heads:
        q = tp.gather_cat(q, 2, ctx, name="queries")
    h, kv_h, hd = q.shape[2], cache["k"].shape[2], cache["k"].shape[3]
    g = h // kv_h
    ct = torch.promote_types(q.dtype, cache["k"].dtype)
    qg = q.reshape(b, 1, kv_h, g, hd).to(ct)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg,
                     cache["k"].to(ct)).to(torch.float32)
    s = s / math.sqrt(hd)
    s = torch.where(valid, s, NEG_INF)
    if blk.axis is None:
        p = torch.softmax(s, dim=-1)
        vt = torch.promote_types(v.dtype, cache["v"].dtype)
        o = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype).to(vt),
                         cache["v"].to(vt))
    else:
        o = tp.softmax_merge(*_partials(s, cache["v"], "bkgqs,bskh->bkgqh"),
                             ctx, blk.axis).permute(0, 3, 1, 2, 4)
    o = o.reshape(b, 1, h, hd).to(x.dtype)
    if h > hq:                  # the rank's heads of the gathered queries
        o = o.narrow(2, ctx.tensor_rank * hq, hq)
    return _out(params, o, ctx, _split_heads(params, cfg)), cache


def attn_init_cache(cfg: AttnConfig, batch: int, max_len: int,
                    dtype: torch.dtype, device: torch.device) -> Dict:
    c = min(cfg.window, max_len) if cfg.window > 0 else max_len
    if cfg.is_mla:
        return {"latent": torch.zeros((batch, c, cfg.kv_lora_rank),
                                      dtype=dtype, device=device),
                "k_rope": torch.zeros((batch, c, cfg.qk_rope_dim),
                                      dtype=dtype, device=device)}
    shape = (batch, c, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# --- MLA (deepseek-v2) -------------------------------------------------------

def _mla_query(params, x: torch.Tensor, cfg: AttnConfig,
               positions: torch.Tensor,
               ctx: Optional[ParallelCtx] = None) -> torch.Tensor:
    """(B, S, H, nope + rope): the up-projected query, RoPE on its rope
    part; the whole query latent enters the rank's heads (``tp.enter``)
    where they are split."""
    dn = cfg.qk_nope_dim
    q_lat = rmsnorm(params["q_norm"], _heads(x, params["wq_a"]))
    if _split_heads(params, cfg):
        q_lat = tp.enter(q_lat, ctx)
    q = _heads(q_lat, params["wq_b"])
    return torch.cat([q[..., :dn], apply_rope(q[..., dn:], positions,
                                              cfg.rope_theta)], dim=-1)


def _mla_latent(params, x: torch.Tensor, cfg: AttnConfig,
                positions: torch.Tensor):
    """The cache entries of x's positions: the normed latent (B, S, kl)
    and the rotated rope key (B, S, rope) that every head shares."""
    latent = rmsnorm(params["kv_norm"], _heads(x, params["wkv_a"]))
    k_rope = apply_rope(_heads(x, params["wk_rope"])[:, :, None, :],
                        positions, cfg.rope_theta)[:, :, 0, :]
    return latent, k_rope


def _mla_out(params, o: torch.Tensor, cfg: AttnConfig,
             ctx: Optional[ParallelCtx]) -> torch.Tensor:
    """``wo`` on the heads ``params`` hold, the ranks' partials summed
    where the rules split the heads (where T does not divide them, every
    rank runs them all and no sum is needed)."""
    return _out(params, o, ctx, _split_heads(params, cfg))


def mla_forward(params, x: torch.Tensor, cfg: AttnConfig,
                positions: Optional[torch.Tensor] = None,
                cache: bool = True, ctx: Optional[ParallelCtx] = None,
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """MLA train / prefill: the latent expanded to per-head keys and
    values, attended with the rope key broadcast over the heads. Returns
    (out, {"latent", "k_rope"} or None); at T > 1 over the rank's heads,
    with the whole latent and rope key."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q = _mla_query(params, x, cfg, positions, ctx)
    latent, k_rope = _mla_latent(params, x, cfg, positions)
    lat, rope = latent, k_rope
    if _split_heads(params, cfg):     # whole tensors into the rank's heads
        lat, rope = tp.enter(latent, ctx), tp.enter(k_rope, ctx)
    k_nope = _heads(lat, params["wk_b"])
    v = _heads(lat, params["wv_b"])
    k = torch.cat([k_nope, rope[:, :, None, :].expand(
        b, s, k_nope.shape[2], cfg.qk_rope_dim)], dim=-1)
    out = flash_attention(q, k, v, causal=cfg.causal, scale=1.0 / math.sqrt(
        cfg.qk_nope_dim + cfg.qk_rope_dim))
    return _mla_out(params, out, cfg, ctx), (
        {"latent": latent, "k_rope": k_rope} if cache else None)


def mla_decode(params, x: torch.Tensor, cache: Dict, cfg: AttnConfig,
               cache_index: int, ctx: Optional[ParallelCtx] = None,
               block: Optional[tp.LengthBlock] = None,
               ) -> Tuple[torch.Tensor, Dict]:
    """Weight-absorbed MLA decode: scores and the weighted sum run in the
    latent space, and W_UV lifts the sum to the heads.

    x: (B, 1, D); cache {"latent": (B, C, kl), "k_rope": (B, C, rope)},
    updated in place at slot ``min(cache_index, C - 1)`` and returned.
    At T > 1 the rank holds its ``block`` of the slots: the absorbed
    queries of every head are gathered (where the rank holds a share of
    the heads), the rank takes its slots' softmax partials in the latent
    space, ``tp.softmax_merge`` merges them, and the rank keeps its
    heads' weighted latent for ``wv_b`` and ``wo``."""
    b, dt = x.shape[0], x.dtype
    dn = cfg.qk_nope_dim
    pos = torch.full((b, 1), cache_index, dtype=torch.int64, device=x.device)
    q = _mla_query(params, x, cfg, pos)
    latent_new, k_rope_new = _mla_latent(params, x, cfg, pos)
    blk = block or _whole_block(cache["latent"].shape[1])
    slot = min(cache_index, blk.length - 1)
    if blk.start <= slot < blk.start + blk.size:
        at = slot - blk.start
        cache["latent"][:, at] = latent_new[:, 0].to(cache["latent"].dtype)
        cache["k_rope"][:, at] = k_rope_new[:, 0].to(cache["k_rope"].dtype)
    latent, k_rope = cache["latent"].to(dt), cache["k_rope"].to(dt)

    # W_UK absorbed into the query: (B, 1, H, kl)
    q_abs = torch.einsum("bshk,lhk->bshl", q[..., :dn],
                         params["wk_b"].to(dt))
    q_rope = q[..., dn:]
    hq = q_abs.shape[2]
    if _split_heads(params, cfg) and blk.axis in ("model", tp.MESH):
        kl = q_abs.shape[-1]        # every head's, one gather
        q_all = tp.gather_cat(torch.cat([q_abs, q_rope], -1), 2, ctx,
                              name="queries")
        q_abs, q_rope = q_all[..., :kl], q_all[..., kl:]
    scores = torch.einsum("bshl,bcl->bshc", q_abs, latent)
    scores = scores + torch.einsum("bshr,bcr->bshc", q_rope, k_rope)
    scores = scores.float() / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    valid = blk.start + torch.arange(blk.size, device=x.device) <= slot
    scores = torch.where(valid, scores, NEG_INF)
    if blk.axis is None:
        mixed = torch.einsum("bshc,bcl->bshl",
                             torch.softmax(scores, dim=-1).to(dt), latent)
    else:
        mixed = tp.softmax_merge(*_partials(scores, latent,
                                            "bshc,bcl->bshl"),
                                 ctx, blk.axis).to(dt)
    if mixed.shape[2] > hq:     # the rank's heads of the gathered queries
        mixed = mixed.narrow(2, ctx.tensor_rank * hq, hq)
    out = torch.einsum("bshl,lhv->bshv", mixed, params["wv_b"].to(dt))
    return _mla_out(params, out, cfg, ctx), cache
