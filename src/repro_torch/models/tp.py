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
    conv channels), exact.

The FFN is column x row parallel with one sum after ``w_down``;
attention runs rank r's query heads ``[r H/T, (r+1) H/T)`` and the KV
heads they read, with one sum after ``wo``, whatever its rotary kind.
Both collectives are the identity at T = 1. :func:`check_layer`
refuses, on every
rank alike, the layers this layout does not cover, rather than
replicate them quietly.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from ..core.group import _timed
from .shardrules import ParallelCtx, tp_size

# the queue items that name what waits (ROADMAP.md, Queue 1)
SHARDED_TRAINING = "ROADMAP Queue 1 item 2"
LENGTH_SHARDED = "ROADMAP Queue 1 item 8"


def _gather(x: torch.Tensor, ctx: ParallelCtx, name: str
            ) -> List[torch.Tensor]:
    """The T ranks' ``x`` in rank order (one list-form ``all_gather``).
    A 16-bit float travels as a ``uint8`` view of the same bytes, which
    is exact: gloo builds differ in the 16-bit types they take (the
    CPU's here refuses ``int16``)."""
    x = x.contiguous()
    wire = x.view(torch.uint8) if x.element_size() == 2 else x
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
    if spec.moe is not None:
        raise NotImplementedError(
            f"MoE layers at T = {t}: the MoE's mesh paths come with "
            f"sharded training ({SHARDED_TRAINING})")
    if spec.attn is not None:
        check_attn(spec.attn, ctx)
    if spec.ssm is not None:
        check_ssm(spec.ssm, ctx)


def check_attn(cfg, ctx: Optional[ParallelCtx]) -> None:
    """Raise at T > 1 for MLA and for heads the rules do not split."""
    t = tp_size(ctx)
    if t == 1:
        return
    if cfg.is_mla:
        raise NotImplementedError(
            f"MLA at T = {t}: deepseek-v2's MoE layers need the MoE's "
            f"mesh paths first ({SHARDED_TRAINING})")
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

