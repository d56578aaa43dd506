"""Mixture-of-Experts layer with sort-based dispatch, after
``repro/models/moe.py``.

No one-hot dispatch product: the token-expert assignments are sorted by
expert and scattered into an (E, C, D) buffer, each expert runs its
dense gated-SiLU FFN on its C slots, and the outputs are gathered back:

  1. route: top-k of the router's float32 softmax (``_route``);
  2. a stable sort of the assignments by expert id, each assignment's
     place within its expert, and a capacity-bounded scatter into the
     buffer; assignments past an expert's capacity drop and are counted
     (``_dispatch``);
  3. the expert products, one batched matmul each (``_expert_ffn``);
  4. each assignment's output weighted by its routing weight and summed
     over the token's k assignments (``_combine``).

Routing, dispatch and combine are plain PyTorch, as the reference leaves
them to XLA outside any Pallas kernel. Each step is deterministic on the
card: the sort is stable (``jnp.argsort`` is), the scatter writes unique
slots (dropped assignments go to one dump row that is cut off), and the
combine sums each token's k contributions in assignment order instead of
adding them into the output by atomics.

With a tensor-parallel context (:mod:`.shardrules`) rank r holds
experts ``[r E/T, (r+1) E/T)`` of the tables (``shard_params``), and
``moe_forward`` takes the reference's branches under the same
conditions:

  * ``ep`` (E and S divisible by T, S >= T: prefill): rank r routes and
    dispatches its sequence block of B * S/T tokens with their own
    capacity, one ``all_to_all`` hands each rank its experts' rows of
    every rank's buffer, a second returns the outputs, the rank combines
    its own tokens, and a gather along S rebuilds the output; the aux
    loss and the dropped share are the ranks' mean (``_moe_ep``);
  * ``replicated`` (E divisible by T, else: decode, and an S that T does
    not divide): every rank routes all the tokens alike, runs only its
    experts' slice of the buffer, and one ordered sum adds the ranks'
    combined partials (``_moe_replicated``);
  * E not divisible by T: every rank holds the whole tables and runs
    ``local``.

The reference's weights-stationary path differs from ``replicated`` only
where a data axis cuts the tables' hidden dim; it comes with the data
axis (ROADMAP Queue 1 item 2b). The shared experts (deepseek) are cut
on their hidden dim by the dense FFN's rules and run column x row
parallel with one ordered sum.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import tp
from .layers import dense_init
from .shardrules import ParallelCtx, tp_size


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                       # per-expert hidden
    n_experts: int
    top_k: int
    n_shared: int = 0               # shared (always-on) experts, fused
    capacity_factor: float = 1.25
    renorm_weights: bool = True     # deepseek renormalizes top-k probs
    router_aux_weight: float = 0.01


def moe_init(cfg: MoEConfig, *, generator: torch.Generator,
             device: torch.device,
             dtype: torch.dtype = torch.float32) -> Dict:
    """The router in float32 (its use site reads it so), the experts'
    matrices in ``dtype``; the reference's fan-ins."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    kw = {"generator": generator, "device": device, "dtype": dtype}
    p = {
        "router": dense_init((d, e), generator=generator, device=device),
        "experts": {
            "w_up": dense_init((e, d, f), **kw),
            "w_gate": dense_init((e, d, f), **kw),
            "w_down": dense_init((e, f, d), fan_in=f, **kw),
        },
    }
    if cfg.n_shared > 0:
        fs = cfg.n_shared * f
        p["shared"] = {"w_up": dense_init((d, fs), **kw),
                       "w_gate": dense_init((d, fs), **kw),
                       "w_down": dense_init((fs, d), fan_in=fs, **kw)}
    return p


def _route(router_w: torch.Tensor, tokens: torch.Tensor, cfg: MoEConfig,
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """tokens (T, D) -> (top_w (T, k) float32, top_i (T, k), aux_loss)."""
    logits = tokens.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.renorm_weights:
        top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balancing loss: E * <f_e, p_e>
    e = cfg.n_experts
    assign = torch.bincount(top_i.reshape(-1), minlength=e).float()
    f_e = assign / assign.sum().clamp_min(1.0)
    aux = e * (f_e * probs.mean(0)).sum()
    return top_w, top_i, aux


def _dispatch(tokens: torch.Tensor, top_i: torch.Tensor, cfg: MoEConfig,
              capacity: int):
    """Sort-based scatter into the (E * C, D) buffer.

    Returns (buf (E, C, D), slot (T*k,), order (T*k,), keep (T*k,)), the
    last three in the sorted order."""
    t, d = tokens.shape
    k, e = cfg.top_k, cfg.n_experts
    flat_e = top_i.reshape(-1)                          # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order].contiguous()
    seg_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos = torch.arange(t * k, device=tokens.device) - seg_start
    slot = sorted_e * capacity + pos
    keep = pos < capacity
    src = order // k                                    # token per assignment
    # one dump row past the E * C slots takes every dropped assignment
    buf = torch.zeros(e * capacity + 1, d, dtype=tokens.dtype,
                      device=tokens.device)
    buf[torch.where(keep, slot, e * capacity)] = tokens[src]
    return buf[:-1].view(e, capacity, d), slot, order, keep


def _expert_ffn(experts, buf: torch.Tensor) -> torch.Tensor:
    """(E, C, D) x (E, D, F) -> (E, C, D) gated-SiLU expert products."""
    dt = buf.dtype
    g = torch.bmm(buf, experts["w_gate"].to(dt))
    u = torch.bmm(buf, experts["w_up"].to(dt))
    return torch.bmm(F.silu(g) * u, experts["w_down"].to(dt))


def _combine(out_buf: torch.Tensor, slot, order, keep, top_w, t: int,
             d: int, k: int) -> torch.Tensor:
    """Gather the expert outputs back and weight-sum each token's k
    assignments: the contributions return to assignment order through
    the inverse of ``order`` and are summed over k, a fixed order."""
    flat = out_buf.reshape(-1, d)
    safe = torch.where(keep, slot, 0)
    w = (top_w.reshape(-1)[order] * keep.float())[:, None].to(flat.dtype)
    contrib = flat[safe] * w
    back = torch.empty_like(contrib)
    back[order] = contrib
    return back.view(t, k, d).sum(1)


def _capacity(tokens_per_shard: int, cfg: MoEConfig) -> int:
    c = int(np.ceil(tokens_per_shard * cfg.top_k / cfg.n_experts
                    * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)         # a multiple of 8


def _moe_local(params, tokens: torch.Tensor, cfg: MoEConfig):
    t, d = tokens.shape
    top_w, top_i, aux = _route(params["router"], tokens, cfg)
    cap = _capacity(t, cfg)
    buf, slot, order, keep = _dispatch(tokens, top_i, cfg, cap)
    out_buf = _expert_ffn(params["experts"], buf)
    out = _combine(out_buf, slot, order, keep, top_w, t, d, cfg.top_k)
    dropped = 1.0 - keep.float().mean()
    return out, aux, dropped


def _moe_ep(params, x: torch.Tensor, cfg: MoEConfig, ctx: ParallelCtx):
    """x (B, S, D), whole on every rank -> (out (B, S, D), aux, dropped):
    the reference's ``_moe_ep_body`` on rank r's sequence block."""
    b, s, d = x.shape
    t, r = ctx.tensor_size, ctx.tensor_rank
    e_loc, n = cfg.n_experts // t, s // t
    tokens = x[:, r * n:(r + 1) * n].reshape(b * n, d)
    top_w, top_i, aux = _route(params["router"], tokens, cfg)
    cap = _capacity(b * n, cfg)
    buf, slot, order, keep = _dispatch(tokens, top_i, cfg, cap)
    # (E, C, D): rows of experts [j E/T, (j+1) E/T) to rank j; received
    # (T, E/T, C, D) in source-rank order -> (E/T, T * C, D)
    mine = tp.all_to_all(buf, ctx).view(t, e_loc, cap, d).transpose(0, 1)
    out_loc = _expert_ffn(params["experts"], mine.reshape(e_loc, t * cap, d))
    # and back: source rank i's C rows to rank i -> (E, C, D)
    out_buf = tp.all_to_all(out_loc.view(e_loc, t, cap, d).transpose(0, 1),
                            ctx).view(cfg.n_experts, cap, d)
    out = _combine(out_buf, slot, order, keep, top_w, b * n, d, cfg.top_k)
    aux, dropped = tp.ordered_mean(torch.stack(
        [aux, 1.0 - keep.float().mean()]), ctx)
    return tp.gather_cat(out.view(b, n, d), 1, ctx), aux, dropped


def _moe_replicated(params, tokens: torch.Tensor, cfg: MoEConfig,
                    ctx: ParallelCtx):
    """tokens (N, D), the same on every rank: the reference's
    ``_moe_replicated_body``."""
    t, d = tokens.shape
    e_loc = cfg.n_experts // ctx.tensor_size
    lo = ctx.tensor_rank * e_loc
    top_w, top_i, aux = _route(params["router"], tokens, cfg)
    cap = _capacity(t, cfg)
    buf, slot, order, keep = _dispatch(tokens, top_i, cfg, cap)
    out_buf = torch.zeros_like(buf)
    out_buf[lo:lo + e_loc] = _expert_ffn(params["experts"],
                                         buf[lo:lo + e_loc])
    out = _combine(out_buf, slot, order, keep, top_w, t, d, cfg.top_k)
    dropped = 1.0 - keep.float().mean()
    return tp.ordered_sum(out, ctx), aux, dropped


def moe_forward(params, x: torch.Tensor, cfg: MoEConfig,
                ctx: Optional[ParallelCtx] = None,
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, D) -> (out (B, S, D), {aux_loss, dropped}), the same on
    every rank.

    Capacity is over the tokens one rank routes: the call's B * S, or
    its sequence block's B * S/T on the ``ep`` path. Shared experts
    (deepseek) run as a dense gated FFN added to the routed output; they
    never enter the dispatch."""
    b, s, d = x.shape
    t = tp_size(ctx)
    if t == 1 or cfg.n_experts % t:
        out, aux, dropped = _moe_local(params, x.reshape(b * s, d), cfg)
    elif s % t == 0 and s >= t:
        out, aux, dropped = _moe_ep(params, x, cfg, ctx)
    else:
        out, aux, dropped = _moe_replicated(params, x.reshape(b * s, d),
                                            cfg, ctx)
    out = out.reshape(b, s, d)
    metrics = {"aux_loss": aux * cfg.router_aux_weight, "dropped": dropped}
    if "shared" in params:
        sh = params["shared"]
        dt = x.dtype
        h = F.silu(x @ sh["w_gate"].to(dt)) * (x @ sh["w_up"].to(dt))
        h = h @ sh["w_down"].to(dt)
        # a rank's hidden columns give a partial (whole where T does not
        # divide the shared hidden dim)
        split = sh["w_down"].shape[0] < cfg.n_shared * cfg.d_ff
        out = out + (tp.ordered_sum(h, ctx) if split else h)
    return out, metrics
