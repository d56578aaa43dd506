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

With a mesh context (:mod:`.shardrules`) rank r of the tensor axis
holds experts ``[r E/T, (r+1) E/T)`` of the tables (``shard_params``),
cut over the data axis as the reference's own expert rules cut them: D,
or under ``inference`` the hidden dim F. Each data rank holds its rows
of the batch (all of them where their number does not divide).
``moe_forward`` takes the reference's branches under the same
conditions and in its order:

  * ``ep`` (E and S divisible by T, S >= T: prefill): rank r routes and
    dispatches its rows' sequence block of B_loc * S/T tokens with their
    own capacity, one ``all_to_all`` hands each rank its experts' rows of
    every rank's buffer, a second returns the outputs, the rank combines
    its own tokens, and a gather along S rebuilds its rows' output
    (``_moe_ep``);
  * stationary (E divisible by T under ``inference``: decode): the
    tokens are gathered over ``data``, every rank routes all of them,
    runs its E/T experts on its F/D slice of the hidden dim, and one
    ordered sum over the whole mesh adds the partials; each data rank
    takes its rows back (``_moe_stationary``, the reference's
    weights-stationary ``_moe_stationary_body``);
  * ``replicated`` (E divisible by T, else: decode, and an S that T does
    not divide): every rank of a data row routes that row's tokens
    alike, runs only its experts' slice of the buffer, and one ordered
    sum over ``model`` adds the ranks' combined partials
    (``_moe_replicated``);
  * T = 1, or E not divisible by T: ``local`` on the whole batch (the
    rows gathered over ``data``, as the reference's partitioner computes
    the global function) with the whole tables.

On ``ep`` and ``replicated`` the aux loss and the dropped share are the
mean over every rank of the mesh, added in rank order (the reference's
``finalize``); on the other two every rank routed all the tokens. The
expert tables are gathered over ``data`` where a branch needs them whole
(``_tables``). On ``replicated`` and the stationary branch a rank's
expert products (its experts, or their F slice) are partials of a sum
over ranks: they come out in float32 and are combined in float32, so
each sum rounds to the activation dtype once. The shared experts (deepseek) are
cut on their hidden dim by the dense FFN's rules and run column x row
parallel with one ordered sum.

In training every collective above carries its backward (:mod:`.tp`),
and the whole tensors that enter a rank's work are entered
(``tp.enter``): on ``ep`` the layer's input and the router, whose
gradients on a rank come from its sequence block alone; on
``replicated`` the tokens and the routing weights as they enter the
rank's experts; the shared experts' input where their hidden dim is
split. The aux loss's ordered mean divides its gradient by the ranks;
on ``replicated``, whose ranks route alike, the aux loss is entered first,
so the T equal copies' gradients add up to the whole. With a data axis
the tables' gathers reduce-scatter their gradients over ``data``; on
``local`` every data rank routes the whole batch (its rows gathered,
``tp.rows_gather``, whose backward adds the data ranks' gradients of
the whole batch) and computes the same aux loss, which
``tp.once`` counts once.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import tp
from .layers import dense_init
from .shardrules import ParallelCtx, dp_size, tp_size


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


def _expert_ffn(experts, buf: torch.Tensor, wide: bool = False
                ) -> torch.Tensor:
    """(E, C, D) x (E, D, F) -> (E, C, D) gated-SiLU expert products;
    ``wide``: the products are a rank's partials of a sum over ranks (its
    experts, or its slice of F), and come out in float32."""
    dt = buf.dtype
    g = torch.bmm(buf, experts["w_gate"].to(dt))
    u = torch.bmm(buf, experts["w_up"].to(dt))
    if wide:
        return tp.matmul_f32(F.silu(g) * u, experts["w_down"])
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


# the (D, F) dims of each expert table
_TABLE_DIMS = {"w_up": (1, 2), "w_gate": (1, 2), "w_down": (2, 1)}


def _tables(experts, cfg: MoEConfig, ctx: Optional[ParallelCtx],
            stationary: bool = False):
    """The rank's expert tables as a branch takes them in: (E/T, D, F)
    whole, or for the stationary branch (E/T, D, F/D) with this data
    rank's block of F. A dim the held layout cuts over ``data`` is
    gathered in data order (exact, one collective for the three); a
    whole F is cut here."""
    n = dp_size(ctx)
    if n == 1:
        return experts
    todo = {}
    for k, w in experts.items():
        d_dim, f_dim = _TABLE_DIMS[k]
        if w.shape[d_dim] < cfg.d_model:
            todo[k] = (w, d_dim)
        elif not stationary and w.shape[f_dim] < cfg.d_ff:
            todo[k] = (w, f_dim)
    out = dict(experts)
    out.update(zip(todo, tp.gather_many(list(todo.values()), ctx)))
    if stationary:
        for k, w in out.items():
            f_dim = _TABLE_DIMS[k][1]
            if w.shape[f_dim] < cfg.d_ff:
                continue
            if cfg.d_ff % n:
                raise ValueError(
                    f"the stationary branch cuts the expert hidden dim "
                    f"{cfg.d_ff} over {n} data ranks, which do not divide "
                    "it (the reference's shard_map refuses it too)")
            f = cfg.d_ff // n
            out[k] = w.narrow(f_dim, ctx.data_rank * f, f)
    return out


def _split(ctx: Optional[ParallelCtx]) -> bool:
    """Whether the data ranks hold different rows of the batch."""
    return dp_size(ctx) > 1 and not ctx.batch_whole


def _moe_ep(params, x: torch.Tensor, cfg: MoEConfig, ctx: ParallelCtx):
    """x (B, S, D), the rank's rows, whole along S on every rank of the
    tensor axis -> (out (B, S, D), aux, dropped): the reference's
    ``_moe_ep_body`` on rank r's sequence block."""
    b, s, d = x.shape
    t, r = ctx.tensor_size, ctx.tensor_rank
    e_loc, n = cfg.n_experts // t, s // t
    # the whole x and router into the rank's sequence block
    tokens = tp.enter(x, ctx)[:, r * n:(r + 1) * n].reshape(b * n, d)
    top_w, top_i, aux = _route(tp.enter(params["router"], ctx), tokens,
                               cfg)
    cap = _capacity(b * n, cfg)
    buf, slot, order, keep = _dispatch(tokens, top_i, cfg, cap)
    # (E, C, D): rows of experts [j E/T, (j+1) E/T) to rank j; received
    # (T, E/T, C, D) in source-rank order -> (E/T, T * C, D)
    mine = tp.all_to_all(buf, ctx).view(t, e_loc, cap, d).transpose(0, 1)
    out_loc = _expert_ffn(_tables(params["experts"], cfg, ctx),
                          mine.reshape(e_loc, t * cap, d))
    # and back: source rank i's C rows to rank i -> (E, C, D)
    out_buf = tp.all_to_all(out_loc.view(e_loc, t, cap, d).transpose(0, 1),
                            ctx).view(cfg.n_experts, cap, d)
    out = _combine(out_buf, slot, order, keep, top_w, b * n, d, cfg.top_k)
    aux, dropped = tp.ordered_mean(torch.stack(
        [aux, 1.0 - keep.float().mean()]), ctx)
    return tp.gather_cat(out.view(b, n, d), 1, ctx), aux, dropped


def _expert_slice(experts, tokens: torch.Tensor, cfg: MoEConfig,
                  ctx: ParallelCtx):
    """Route ``tokens`` (N, D), run the rank's E/T experts of the buffer
    on ``experts`` (whole, or their slice of F) and combine: the rank's
    partial output (N, D) in float32, the aux loss and the dropped share
    of the routing."""
    t, d = tokens.shape
    e_loc = cfg.n_experts // ctx.tensor_size
    lo = ctx.tensor_rank * e_loc
    top_w, top_i, aux = _route(experts["router"], tokens, cfg)
    cap = _capacity(t, cfg)
    # every rank routes alike; the tokens and the weights enter the
    # rank's experts (their gradients there are the rank's partials)
    buf, slot, order, keep = _dispatch(tp.enter(tokens, ctx), top_i, cfg,
                                       cap)
    out_buf = torch.zeros(buf.shape, device=buf.device,
                          dtype=torch.float32)
    out_buf[lo:lo + e_loc] = _expert_ffn(experts["experts"],
                                         buf[lo:lo + e_loc], wide=True)
    out = _combine(out_buf, slot, order, keep, tp.enter(top_w, ctx), t, d,
                   cfg.top_k)
    return out, aux, 1.0 - keep.float().mean()


def _moe_replicated(params, tokens: torch.Tensor, cfg: MoEConfig,
                    ctx: ParallelCtx):
    """tokens (N, D), the rank's rows, the same on every rank of the
    tensor axis: the reference's ``_moe_replicated_body``."""
    out, aux, dropped = _expert_slice(
        {"router": params["router"],
         "experts": _tables(params["experts"], cfg, ctx)}, tokens, cfg, ctx)
    # every rank of a data row routed its tokens alike: the T copies'
    # gradients add up to the row's
    aux, dropped = tp.ordered_mean(tp.enter(torch.stack([aux, dropped]),
                                            ctx), ctx)
    return tp.ordered_sum(out, ctx).to(tokens.dtype), aux, dropped


def _moe_stationary(params, x: torch.Tensor, cfg: MoEConfig,
                    ctx: ParallelCtx):
    """x (B, S, D), the rank's rows: the reference's
    ``_moe_stationary_body`` (weights stay put, tokens replicate). The
    data ranks' rows are gathered, every rank routes all of them with
    capacity over them all, runs its E/T experts on its F/D slice, and
    one ordered sum over the whole mesh adds the partials; the rank
    takes its rows back."""
    b, s, d = x.shape
    whole = tp.rows_gather(x, ctx) if _split(ctx) else x
    out, aux, dropped = _expert_slice(
        {"router": params["router"],
         "experts": _tables(params["experts"], cfg, ctx, stationary=True)},
        whole.reshape(-1, d), cfg, ctx)
    out = tp.ordered_sum(out, ctx, tp.MESH).to(x.dtype).view(-1, s, d)
    return tp.rows_take(out, b, ctx), aux, dropped


def moe_forward(params, x: torch.Tensor, cfg: MoEConfig,
                ctx: Optional[ParallelCtx] = None,
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, D), the rank's rows -> (out (B, S, D), {aux_loss,
    dropped}), the same on every rank of a data row.

    Capacity is over the tokens one rank routes: its rows' B * S on
    ``replicated``, their sequence block's B * S/T on ``ep``, the whole
    batch's on the stationary and ``local`` paths. Shared experts
    (deepseek) run as a dense gated FFN added to the routed output; they
    never enter the dispatch. ``params`` are the layer's as
    ``transformer.layer_forward`` hands them on: the router and the
    shared experts gathered over ``data``, the expert tables as held."""
    b, s, d = x.shape
    t = tp_size(ctx)
    divides = t > 1 and cfg.n_experts % t == 0
    if divides and s % t == 0 and s >= t:
        out, aux, dropped = _moe_ep(params, x, cfg, ctx)
    elif divides and ctx.inference:
        out, aux, dropped = _moe_stationary(params, x, cfg, ctx)
    elif divides:
        out, aux, dropped = _moe_replicated(params, x.reshape(b * s, d),
                                            cfg, ctx)
    else:
        whole = tp.rows_gather(x, ctx) if _split(ctx) else x
        out, aux, dropped = _moe_local(
            {"router": params["router"],
             "experts": _tables(params["experts"], cfg, ctx)},
            whole.reshape(-1, d), cfg)
        out = tp.rows_take(out.view(-1, s, d), b, ctx)
        # every data rank routed the whole batch alike
        aux = tp.once(aux, ctx)
    out = out.reshape(b, s, d)
    metrics = {"aux_loss": aux * cfg.router_aux_weight, "dropped": dropped}
    if "shared" in params:
        sh = params["shared"]
        dt = x.dtype
        # a rank's hidden columns give a partial (whole where T does not
        # divide the shared hidden dim)
        split = sh["w_down"].shape[0] < cfg.n_shared * cfg.d_ff
        xs = tp.enter(x, ctx) if split else x
        h = F.silu(xs @ sh["w_gate"].to(dt)) * (xs @ sh["w_up"].to(dt))
        out = out + tp.sum_matmul(h, sh["w_down"], ctx, split)
    return out, metrics
