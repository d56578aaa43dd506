"""The collectives of tensor parallelism, after ``repro/models/tp.py``.

The reference's mesh path is GSPMD: its partitioner inserts the
collectives that the sharding rules' layout implies, and the explicit
``shard_map`` blocks ``ffn_tp`` / ``attn_tp`` run only under
``ParallelCtx(explicit_tp=True)`` (its §Perf H2; their ``applicable``
conditions, divisible heads and no M-RoPE, were GSPMD-era choices).
PyTorch has no partitioner, so in the port every layer carries the
layout of :mod:`.shardrules` out itself, with the same code at one rank
and at T: it computes on the parameters it holds and adds its partial
output with one of these collectives over the tensor axis's group:

  * :func:`ordered_sum` — the sum of the ranks' partials: one
    ``all_gather`` in the activation dtype (the reference's bf16 psum
    wire), then every rank adds the T blocks in ascending rank order in
    float32 and casts once, so every rank holds the same bits whatever
    order the backend's ring would have used;
  * :func:`gather_cat` — a gather that only concatenates (vocab logits,
    conv channels), exact;
  * :func:`all_to_all` — the MoE's expert-parallel exchange: block j of
    a tensor's leading dim to rank j, the blocks received stacked in
    rank order (16-bit floats on the same ``uint8`` wire, exact);
  * :func:`ordered_mean` — the mean of float32 values over the ranks,
    added in rank order and divided by T (the reference's ``pmean``).

The FFN is column x row parallel with one sum after ``w_down``;
attention (MLA too) runs rank r's query heads ``[r H/T, (r+1) H/T)``
and the KV heads they read, with one sum after ``wo``, whatever its
rotary kind. The MoE's paths are in :mod:`.moe`. Every collective is
the identity at T = 1. :func:`check_layer` refuses, on every rank
alike, the layers this layout does not cover, rather than replicate
them quietly.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from ..core.group import _timed
from .shardrules import ParallelCtx, tp_size

# the queue items that name what waits (ROADMAP.md, Queue 1)
SHARDED_TRAINING = "ROADMAP Queue 1 item 2b"
LENGTH_SHARDED = "ROADMAP Queue 1 item 8"


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it travels: a 16-bit float as a ``uint8`` view of the
    same bytes, which is exact (gloo builds differ in the 16-bit types
    they take; the CPU's here refuses ``int16``). The view doubles the
    last dim only, so a split along the leading dim stays whole rows."""
    x = x.contiguous()
    return x.view(torch.uint8) if x.element_size() == 2 else x


def _gather(x: torch.Tensor, ctx: ParallelCtx, name: str
            ) -> List[torch.Tensor]:
    """The T ranks' ``x`` in rank order (one list-form ``all_gather``)."""
    wire = _wire(x)
    parts = [torch.empty_like(wire) for _ in range(ctx.tensor_size)]
    _timed(name, lambda: dist.all_gather(parts, wire, group=ctx.group))
    return [p.view(x.dtype) for p in parts]


def ordered_sum(x: torch.Tensor, ctx: Optional[ParallelCtx]
                ) -> torch.Tensor:
    """The sum over the tensor axis of every rank's partial ``x``: added
    in ascending rank order in float32, cast once to ``x``'s dtype."""
    if tp_size(ctx) == 1:
        return x
    parts = _gather(x, ctx, "tp_sum")
    acc = parts[0].float()
    for p in parts[1:]:
        acc = acc + p.float()
    return acc.to(x.dtype)


def gather_cat(x: torch.Tensor, dim: int, ctx: Optional[ParallelCtx]
               ) -> torch.Tensor:
    """The ranks' blocks of ``x`` concatenated along ``dim`` in rank
    order."""
    if tp_size(ctx) == 1:
        return x
    return torch.cat(_gather(x, ctx, "tp_gather"), dim=dim)


def ordered_mean(x: torch.Tensor, ctx: Optional[ParallelCtx]
                 ) -> torch.Tensor:
    """The mean over the tensor axis of every rank's float32 ``x``: the T
    values added in ascending rank order, then divided by T, so every
    rank holds the same bits."""
    if tp_size(ctx) == 1:
        return x
    return ordered_sum(x, ctx) / ctx.tensor_size


def all_to_all(x: torch.Tensor, ctx: Optional[ParallelCtx]
               ) -> torch.Tensor:
    """Block j of ``x``'s T equal blocks along dim 0 goes to rank j;
    returns the T blocks this rank receives, stacked along dim 0 in rank
    order (the shape of ``x``). One ``all_to_all_single``."""
    if tp_size(ctx) == 1:
        return x
    wire = _wire(x)
    out = torch.empty_like(wire)
    _timed("tp_all_to_all", lambda: dist.all_to_all_single(
        out, wire, group=ctx.group))
    return out.view(x.dtype)


def local_block(t: torch.Tensor, n: int, ctx: Optional[ParallelCtx],
                dim: int = 0) -> torch.Tensor:
    """This rank's block of ``n`` entries along ``dim`` of a tensor the
    rules keep whole (``bq`` beside a head-split ``wq``, the B and C
    channels beside a channel-split conv); ``t`` itself when it has ``n``
    already."""
    if t.shape[dim] == n:
        return t
    return t.narrow(dim, ctx.tensor_rank * n, n)


def check_layer(spec, ctx: Optional[ParallelCtx]) -> None:
    """Raise for a layer the tensor-parallel layout does not cover at
    T > 1. Every rank sees the same config and mesh, so every rank
    raises alike, before any collective."""
    t = tp_size(ctx)
    if t == 1:
        return
    if spec.kind == "hybrid":
        raise NotImplementedError(
            f"hybrid layers at T = {t}: hymba's attention and SSM heads "
            f"wait for tensor-parallel decode over a length-sharded cache "
            f"({LENGTH_SHARDED})")
    if spec.attn is not None:
        check_attn(spec.attn, ctx)
    if spec.ssm is not None:
        check_ssm(spec.ssm, ctx)


def check_attn(cfg, ctx: Optional[ParallelCtx]) -> None:
    """Raise at T > 1 for KV heads the rules do not split. MLA caches no
    KV heads: its latent and rope key stay whole on every rank, and its
    query heads run whole on every rank where T does not split them."""
    t = tp_size(ctx)
    if t == 1 or cfg.is_mla:
        return
    if cfg.n_heads % t or cfg.n_kv_heads % t:
        raise NotImplementedError(
            f"{cfg.n_heads} query and {cfg.n_kv_heads} KV heads at T = "
            f"{t}: the reference lays such a cache out along its length, "
            f"and decode over a length-sharded cache waits "
            f"({LENGTH_SHARDED})")


def check_ssm(cfg, ctx: Optional[ParallelCtx]) -> None:
    """Raise at T > 1 unless T splits the SSM heads of one group."""
    t = tp_size(ctx)
    if t > 1 and (cfg.n_heads % t or cfg.n_groups > 1):
        raise NotImplementedError(
            f"{cfg.n_heads} SSM heads in {cfg.n_groups} groups at T = {t}:"
            f" the port splits one group's heads evenly ({LENGTH_SHARDED})")

