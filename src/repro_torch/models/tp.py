"""The collectives of the serving mesh, after ``repro/models/tp.py``.

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
    ``all_gather`` in the partials' dtype, then every rank adds the T
    blocks in ascending rank order in float32 and casts once, so every
    rank holds the same bits whatever order the backend's ring would
    have used. The layers hand it float32 partials (:func:`sum_matmul`,
    the MoE's combine; on the card the 16-bit product with a float32
    result, :func:`matmul_f32`), so a sum rounds to the activation dtype
    once where the reference's bf16 psum rounds each partial first;
  * :func:`gather_cat` — a gather that only concatenates (vocab logits,
    conv channels), exact;
  * :func:`all_to_all` — the MoE's expert-parallel exchange: block j of
    a tensor's leading dim to rank j, the blocks received stacked in
    rank order (16-bit floats on the same ``uint8`` wire, exact);
  * :func:`ordered_mean` — the mean of float32 values over the mesh,
    added in rank order and divided by their number (the reference's
    ``pmean``).

The sums run over a named axis (``"model"`` by default, ``"data"``) or
over the whole mesh (``MESH``: one gather over every rank, added in
row-major rank order, where the reference does one psum an axis), the
means over the whole mesh. On the data axis the reference's GSPMD
gathers each FSDP parameter at use; here :func:`gather_fsdp` gathers
one layer's leaves along their ``fsdp`` dims (data order, exact) before
its tensor-parallel code runs, and the MoE gathers its expert tables as
its branch needs (:mod:`.moe`). :func:`rows_gather` / :func:`rows_take`
gather the data ranks' rows of a batch in order and take this rank's
back.

In training every one of them carries its backward (a
``torch.autograd.Function``), Megatron's rule: a tensor every rank
holds whole gets a gradient every rank holds whole and bit-equal.
:func:`ordered_sum`'s backward is the identity; :func:`enter`, the
identity forward where a whole tensor enters work a rank does on its
own block (its heads, channels, experts, vocabulary block or sequence
block), adds the ranks' partial gradients back by an ordered sum (timed
as ``tp_sum_bwd``); :func:`gather_cat`'s backward keeps the rank's own
slice, :func:`all_to_all`'s is the inverse exchange (``tp_all_to_all_bwd``),
and :func:`ordered_mean`'s divides by n. No ring ``all_reduce`` is used:
its order moves with the length, and the ranks' whole leaves would
drift apart. On the card :func:`matmul_f32`'s product has a backward of
its own, the 16-bit products a one-rank step takes.
:func:`gather_many`, :func:`gather_fsdp`, :func:`rows_gather` and
:func:`rows_take` carry none: training with a data axis waits
(ROADMAP Queue 1 item 2c-ii).

The FFN is column x row parallel with one sum after ``w_down``;
attention (MLA too) runs rank r's query heads ``[r H/T, (r+1) H/T)``
and the KV heads they read, with one sum after ``wo``, whatever its
rotary kind. The MoE's paths are in :mod:`.moe`. Every collective is
the identity at T = 1. :func:`check_layer` refuses, on every rank
alike, the layers this layout does not cover, rather than replicate
them quietly.
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..core.group import _timed
from .shardrules import (EXPERT_TABLE, ParallelCtx, _map, dp_size,
                         fsdp_dims, tp_size)

# the queue items that name what waits (ROADMAP.md, Queue 1)
SHARDED_TRAINING = "ROADMAP Queue 1 item 2c-ii"
LENGTH_SHARDED = "ROADMAP Queue 1 item 8"

MESH = "mesh"                 # the axis argument for the whole mesh
_PREFIX = {"model": "tp", "data": "dp", MESH: "mesh"}


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it travels: a 16-bit float as a ``uint8`` view of the
    same bytes, which is exact (gloo builds differ in the 16-bit types
    they take; the CPU's here refuses ``int16``). The view doubles the
    last dim only, so a split along the leading dim stays whole rows."""
    x = x.contiguous()
    return x.view(torch.uint8) if x.element_size() == 2 else x


def _axis(ctx: Optional[ParallelCtx], axis: str) -> Tuple[int, Any]:
    """(ranks, process group) of ``axis`` ("model", "data" or ``MESH``);
    (1, None) without a context. The whole mesh is the default group's
    world (``make_host_mesh``), whose ranks lie row-major."""
    if ctx is None:
        return 1, None
    if axis == "model":
        return ctx.tensor_size, ctx.group
    if axis == "data":
        return ctx.data_size, ctx.data_group
    if axis == MESH:
        return ctx.mesh.size, None
    raise ValueError(f"unknown axis {axis!r}")


def _gather(x: torch.Tensor, ctx: ParallelCtx, name: str,
            axis: str = "model") -> List[torch.Tensor]:
    """The ranks' ``x`` along ``axis`` in rank order (one list-form
    ``all_gather``, timed as ``<axis prefix>_<name>``)."""
    n, grp = _axis(ctx, axis)
    wire = _wire(x)
    parts = [torch.empty_like(wire) for _ in range(n)]
    _timed(f"{_PREFIX[axis]}_{name}",
           lambda: dist.all_gather(parts, wire, group=grp))
    return [p.view(x.dtype) for p in parts]


def _axis_rank(ctx: ParallelCtx, axis: str) -> int:
    """This rank's index along ``axis``."""
    if axis == "model":
        return ctx.tensor_rank
    if axis == "data":
        return ctx.data_rank
    return dist.get_rank()


def _sum(x: torch.Tensor, ctx: ParallelCtx, axis: str,
         name: str = "sum") -> torch.Tensor:
    """The ranks' ``x`` along ``axis`` added in ascending rank order in
    float32, cast once to ``x``'s dtype."""
    parts = _gather(x, ctx, name, axis)
    acc = parts[0].float()
    for p in parts[1:]:
        acc = acc + p.float()
    return acc.to(x.dtype)


class _OrderedSum(torch.autograd.Function):
    """:func:`_sum` forward; the identity backward (every rank's partial
    gets the whole sum's gradient, which every rank holds alike)."""

    @staticmethod
    def forward(fc, x, ctx, axis):
        return _sum(x, ctx, axis)

    @staticmethod
    def backward(fc, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    """The identity forward; backward, the ranks' partial gradients
    added in rank order (:func:`_sum`, timed ``<axis>_sum_bwd``)."""

    @staticmethod
    def forward(fc, x, ctx, axis):
        fc.pctx, fc.axis = ctx, axis
        return x.view_as(x)

    @staticmethod
    def backward(fc, g):
        return _sum(g, fc.pctx, fc.axis, "sum_bwd"), None, None


def ordered_sum(x: torch.Tensor, ctx: Optional[ParallelCtx],
                axis: str = "model") -> torch.Tensor:
    """The sum over ``axis`` of every rank's partial ``x``: added in
    ascending rank order in float32, cast once to ``x``'s dtype. Its
    backward is the identity."""
    if _axis(ctx, axis)[0] == 1:
        return x
    return _OrderedSum.apply(x, ctx, axis)


def gather_max(x: torch.Tensor, ctx: ParallelCtx,
               axis: str = "model") -> torch.Tensor:
    """The elementwise largest of the ranks' ``x`` (exact in any order;
    no gradient), timed as ``<axis>_max``."""
    if _axis(ctx, axis)[0] == 1:
        return x
    return torch.stack(_gather(x.detach(), ctx, "max", axis)).amax(0)


def enter(x: torch.Tensor, ctx: Optional[ParallelCtx],
          axis: str = "model") -> torch.Tensor:
    """``x``, a tensor every rank holds whole, as it enters work each rank
    does on its own block: the identity forward, and backward the
    ranks' partial gradients of ``x`` ordered-summed, so every rank
    holds the whole gradient, bit-equal. Only where the consumer is
    rank-local: a whole consumer already gets the whole gradient."""
    if _axis(ctx, axis)[0] == 1:
        return x
    return _Enter.apply(x, ctx, axis)


class _MatmulF32(torch.autograd.Function):
    """The card's 16-bit product with a float32 result (cuBLAS's
    ``out_dtype``); backward the 16-bit products of the gradient rounded
    to the operands' dtype, as a one-rank 16-bit product's backward
    takes them."""

    @staticmethod
    def forward(fc, a, w):
        fc.save_for_backward(a, w)
        if w.dim() == 3:
            return torch.bmm(a, w, out_dtype=torch.float32)
        return torch.mm(a.reshape(-1, a.shape[-1]), w,
                        out_dtype=torch.float32).view(*a.shape[:-1],
                                                      w.shape[-1])

    @staticmethod
    def backward(fc, g):
        a, w = fc.saved_tensors
        g = g.to(a.dtype)
        ga = gw = None
        if w.dim() == 3:
            if fc.needs_input_grad[0]:
                ga = torch.bmm(g, w.transpose(1, 2))
            if fc.needs_input_grad[1]:
                gw = torch.bmm(a.transpose(1, 2), g)
            return ga, gw
        g2 = g.reshape(-1, g.shape[-1])
        if fc.needs_input_grad[0]:
            ga = (g2 @ w.T).view(a.shape)
        if fc.needs_input_grad[1]:
            gw = a.reshape(-1, a.shape[-1]).T @ g2
        return ga, gw


def matmul_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` (``w`` 2-D, or 3-D batched as ``torch.bmm`` takes it)
    on operands in ``a``'s dtype, with a float32 result: on the card a
    16-bit product runs on the tensor cores and writes float32 (cuBLAS's
    ``out_dtype``), so the partial is not rounded; on the CPU, which has
    no such kernel, the product of the operands widened to float32, the
    same values up to the order of the adds."""
    w = w.to(a.dtype)
    if not (a.is_cuda and a.element_size() == 2):
        return a.float() @ w.float()
    return _MatmulF32.apply(a, w)


def sum_matmul(a: torch.Tensor, w: torch.Tensor,
               ctx: Optional[ParallelCtx], split: bool = True
               ) -> torch.Tensor:
    """``a @ w`` in ``a``'s dtype, where ``w`` holds this rank's rows of
    a row-parallel weight (``split``): each rank's product in float32
    (:func:`matmul_f32`), the partials summed over ``model`` in rank
    order (:func:`ordered_sum`) and cast once, so the sum rounds once, as
    one rank's product does. Where nothing is split, ``a @ w`` itself."""
    if not split or tp_size(ctx) == 1:
        return a @ w.to(a.dtype)
    return ordered_sum(matmul_f32(a, w), ctx).to(a.dtype)


class _GatherCat(torch.autograd.Function):
    """The ranks' blocks concatenated in rank order; backward the rank's
    own slice of the whole gradient."""

    @staticmethod
    def forward(fc, x, dim, ctx, axis, name):
        fc.dim, fc.n = dim, x.shape[dim]
        fc.lo = _axis_rank(ctx, axis) * fc.n
        return torch.cat(_gather(x, ctx, name, axis), dim=dim)

    @staticmethod
    def backward(fc, g):
        return g.narrow(fc.dim, fc.lo, fc.n), None, None, None, None


def gather_cat(x: torch.Tensor, dim: int, ctx: Optional[ParallelCtx],
               axis: str = "model", name: str = "gather") -> torch.Tensor:
    """The ranks' blocks of ``x`` along ``axis`` concatenated along
    ``dim`` in rank order. Its backward keeps the rank's slice: where
    the whole result feeds rank-local work, :func:`enter` it."""
    if _axis(ctx, axis)[0] == 1:
        return x
    return _GatherCat.apply(x, dim, ctx, axis, name)


def ordered_mean(x: torch.Tensor, ctx: Optional[ParallelCtx]
                 ) -> torch.Tensor:
    """The mean over the whole mesh of every rank's float32 ``x``: the
    values added in ascending rank order, then divided by their number,
    so every rank holds the same bits. Backward: the gradient over n (a
    value every rank of a data row holds alike enters first,
    :func:`enter`, so its copies' gradients add up)."""
    n = _axis(ctx, MESH)[0]
    return x if n == 1 else ordered_sum(x, ctx, MESH) / n


def gather_many(items: List[Tuple[torch.Tensor, int]],
                ctx: Optional[ParallelCtx]) -> List[torch.Tensor]:
    """For each ``(x, dim)``, the ranks' blocks of ``x`` over ``data``
    concatenated along ``dim`` in data order: all of them in one
    ``all_gather`` of their bytes (exact, whatever their types, timed as
    ``dp_fsdp``), so a layer's leaves cost one collective."""
    if not items or dp_size(ctx) == 1:
        return [x for x, _ in items]
    flat = [x.contiguous().view(-1).view(torch.uint8) for x, _ in items]
    parts = _gather(torch.cat(flat), ctx, "fsdp", "data")
    out, lo = [], 0
    for (x, dim), f in zip(items, flat):
        hi = lo + f.numel()
        out.append(torch.cat([p[lo:hi].view(x.dtype).view(x.shape)
                              for p in parts], dim=dim))
        lo = hi
    return out


def gather_fsdp(tree, ctx: Optional[ParallelCtx], d_model: int):
    """``tree`` (one layer's parameters, or the leaves outside the
    layers) with every leaf the rules cut over ``data`` gathered whole
    along its ``fsdp`` dim, the data ranks' blocks in data order (exact:
    a concatenation; one collective, :func:`gather_many`). Every ``fsdp``
    dim of these leaves is ``d_model``'s, so a dim is cut where it holds
    fewer; a leaf already whole is returned as it is. The MoE's expert
    tables stay as held (their layout depends on the branch,
    ``moe.moe_forward`` gathers them). The gathered blocks live as long
    as the returned tree."""
    if dp_size(ctx) == 1:
        return tree
    todo = {}

    def find(path, x):
        if re.search(EXPERT_TABLE, path):
            return x
        for dim in fsdp_dims(path, x.dim(), ctx.inference):
            if x.shape[dim] == d_model:
                continue
            if x.shape[dim] * ctx.data_size != d_model:
                raise ValueError(f"{path} {tuple(x.shape)}: dim {dim} is "
                                 f"not d_model {d_model} cut over "
                                 f"{ctx.data_size} data ranks")
            todo[path] = (x, dim)
        return x
    _map(find, tree)
    whole = dict(zip(todo, gather_many(list(todo.values()), ctx)))
    return _map(lambda path, x: whole.get(path, x), tree)


def rows_gather(x: torch.Tensor, ctx: Optional[ParallelCtx]
                ) -> torch.Tensor:
    """Every data rank's rows of ``x`` (its leading dim), stacked in data
    order: the whole batch on every rank."""
    return gather_cat(x, 0, ctx, "data", "rows")


def rows_take(x: torch.Tensor, n: int, ctx: Optional[ParallelCtx]
              ) -> torch.Tensor:
    """This data rank's ``n`` rows of a whole batch ``x`` (the inverse
    of :func:`rows_gather`); ``x`` itself when it has ``n`` rows."""
    if x.shape[0] == n:
        return x
    return x.narrow(0, ctx.data_rank * n, n)


def _exchange(x: torch.Tensor, ctx: ParallelCtx, name: str
              ) -> torch.Tensor:
    wire = _wire(x)
    out = torch.empty_like(wire)
    _timed(name, lambda: dist.all_to_all_single(out, wire,
                                                group=ctx.group))
    return out.view(x.dtype)


class _AllToAll(torch.autograd.Function):
    """:func:`_exchange` forward; backward the inverse exchange, which is
    the same exchange of the gradient (block j received from rank j goes
    back to rank j)."""

    @staticmethod
    def forward(fc, x, ctx):
        fc.pctx = ctx
        return _exchange(x, ctx, "tp_all_to_all")

    @staticmethod
    def backward(fc, g):
        return _exchange(g, fc.pctx, "tp_all_to_all_bwd"), None


def all_to_all(x: torch.Tensor, ctx: Optional[ParallelCtx]
               ) -> torch.Tensor:
    """Block j of ``x``'s T equal blocks along dim 0 goes to rank j;
    returns the T blocks this rank receives, stacked along dim 0 in rank
    order (the shape of ``x``). One ``all_to_all_single``; its backward
    is the inverse exchange."""
    if tp_size(ctx) == 1:
        return x
    return _AllToAll.apply(x, ctx)


def local_block(t: torch.Tensor, n: int, ctx: Optional[ParallelCtx],
                dim: int = 0) -> torch.Tensor:
    """This rank's block of ``n`` entries along ``dim`` of a tensor the
    rules keep whole (``bq`` beside a head-split ``wq``, the B and C
    channels beside a channel-split conv), entered (:func:`enter`): the
    ranks' gradients of their blocks add up to the whole one. ``t``
    itself when it has ``n`` already."""
    if t.shape[dim] == n:
        return t
    return enter(t, ctx).narrow(dim, ctx.tensor_rank * n, n)


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

