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
``torch.autograd.Function``), Megatron's rule on the tensor axis: a
tensor every rank holds whole gets a gradient every rank holds whole and
bit-equal. :func:`ordered_sum`'s backward is the identity; :func:`enter`,
the identity forward where a whole tensor enters work a rank does on its
own block (its heads, channels, experts, vocabulary block or sequence
block), adds the ranks' partial gradients back by an ordered sum (timed
as ``tp_sum_bwd``); :func:`gather_cat`'s backward keeps the rank's own
slice, :func:`all_to_all`'s is the inverse exchange (``tp_all_to_all_bwd``),
and :func:`ordered_mean`'s divides by n. On the data axis each rank's
backward gives the part of a gradient its own rows make, and the parts
add up: :func:`gather_many`'s backward (so :func:`gather_fsdp`'s, the
MoE's tables' and :func:`rows_gather`'s) is a reduce-scatter in data
order, every data rank's gradient of the whole leaf cut into the D
blocks, block j sent to data rank j (one ``all_to_all`` for the call's
leaves, timed ``dp_fsdp_bwd``), the D blocks a rank receives added in
data order in float32 and cast once; :func:`sum_many` adds the gradients
of the leaves no rank cuts over ``data`` the same way after the backward
(``dp_sum_bwd``, ``train.step``); :func:`once` counts once a value every
data rank computes alike. The reference's cross-``data`` reduce is a
bf16 psum in the partitioner's order; here a bf16 gradient is added in
float32 and rounds once, as the tensor axis's sums do. No ring
``all_reduce`` is used: its order moves with the length, and the ranks'
whole leaves would drift apart. On the card :func:`matmul_f32`'s product
has a backward of its own, the 16-bit products a one-rank step takes.

The FFN is column x row parallel with one sum after ``w_down``;
attention (MLA too) runs rank r's query heads ``[r H/T, (r+1) H/T)``
and the KV heads they read, with one sum after ``wo``, whatever its
rotary kind; heads the rules keep whole run whole on every rank, with
no sum. The MoE's paths are in :mod:`.moe`. Every collective is the
identity at T = 1.

Decode over a length-sharded cache: where the rules cannot cut a
cache's KV heads (or its batch) over an axis, ``cache_specs`` cuts its
length there instead, and each rank holds a block of the slots
(:func:`cache_block`). A rank takes the softmax of the new token's
queries over its own slots only, and :func:`softmax_merge` merges the
ranks' partials (the max, the sum of exponentials and the weighted sum
of values, in float32) in rank order: one ``all_gather`` of the three
(timed ``<axis prefix>_softmax``), then every rank rescales and adds
them alike, so every rank holds the same bits. A block with no live
slot has the max ``NEG_INF`` and weighs exactly zero.

In training every layout sums the gradient of a tensor that every rank
holds whole over ``model`` exactly once, where it first enters work a
rank does on its own block; where every rank does the whole work, it
sums nothing, as each rank's gradient is already whole and bit-equal:

  * heads split on both sides: ``x`` enters the projections
    (:func:`enter`), the whole biases are cut by :func:`local_block`;
  * query heads split, KV heads whole (T does not divide them): ``x``
    enters ``wq`` alone; ``wk`` / ``wv`` read it as it is, and k and v
    enter (summed once) before the rank keeps the KV heads its query
    heads read;
  * query and KV heads whole (hymba's 25 and 5 at T = 4): the attention
    runs whole on every rank, nothing is entered and ``wo`` needs no sum;
  * SSM heads split: ``x`` enters ``in_z`` / ``in_x`` / ``in_dt``, the
    gathered B and C channels enter the rank's scan;
  * SSM heads whole (T does not divide them): every rank scans every
    head, ``in_dt`` / ``in_b`` / ``in_c`` read ``x`` as it is, the
    gathered B, C and x channels feed the scan without an entry, and the
    scan's output ``y`` enters (summed once) before the rank keeps its
    block of channels (:func:`local_block`);
  * the normed mean of a hybrid layer, its norms and gains, the meta
    tokens and a whole vocabulary: whole work, no sum.

:func:`check_layer` refuses, on every rank alike, the one layout the
port does not cover, rather than replicate it quietly: SSM heads in
more than one group at T > 1, in serving and in training.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from ..core.group import _timed
from .shardrules import (EXPERT_TABLE, ParallelCtx, _map, dp_size,
                         fsdp_dims, tp_size)

# the queue item that names what waits (ROADMAP.md, Queue 1)
SSM_GROUPS = "ROADMAP Queue 1 item 8c"

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
    return sum_many([x], ctx, axis, name)[0]


def _add_in_order(parts, dtype: torch.dtype, shape) -> torch.Tensor:
    """The ranks' copies of a tensor (flat bytes, in rank order) viewed
    as ``dtype`` and ``shape``, added in float32 in that order and cast
    once to ``dtype``."""
    acc = None
    for p in parts:
        v = p.view(dtype).view(shape).float()
        acc = v if acc is None else acc + v
    return acc.to(dtype)


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


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """``x``'s bytes, flat (``uint8``), whatever its type."""
    return x.contiguous().view(-1).view(torch.uint8)


def _scatter_sum(gs, dims, ctx: ParallelCtx, name: str
                 ) -> List[torch.Tensor]:
    """The reduce-scatter over ``data`` of the whole gradients ``gs``:
    block j of each ``g`` along its ``dims`` entry goes to data rank j
    (one ``all_to_all`` of their bytes, timed ``dp_<name>``), and this
    rank's block is the D blocks it receives added in data order in
    float32, cast once to the gradient's type."""
    n, r = ctx.data_size, ctx.data_rank
    blocks = [[b.contiguous() for b in g.chunk(n, dim)]
              for g, dim in zip(gs, dims)]
    send = torch.cat([_bytes(bl[j]) for j in range(n) for bl in blocks])
    recv = torch.empty_like(send)
    _timed(f"dp_{name}", lambda: dist.all_to_all_single(
        recv, send, group=ctx.data_group))
    seg = recv.numel() // n
    out, lo = [], 0
    for g, bl in zip(gs, blocks):
        hi = lo + bl[r].numel() * bl[r].element_size()
        out.append(_add_in_order([recv[j * seg + lo:j * seg + hi]
                                  for j in range(n)], g.dtype, bl[r].shape))
        lo = hi
    return out


class _GatherMany(torch.autograd.Function):
    """:func:`gather_many`'s forward; backward the reduce-scatter of the
    whole leaves' gradients in data order (:func:`_scatter_sum`)."""

    @staticmethod
    def forward(fc, ctx, name, dims, *xs):
        fc.pctx, fc.name, fc.dims = ctx, name, dims
        flat = [_bytes(x) for x in xs]
        parts = _gather(torch.cat(flat), ctx, name, "data")
        out, lo = [], 0
        for x, dim, f in zip(xs, dims, flat):
            hi = lo + f.numel()
            out.append(torch.cat([p[lo:hi].view(x.dtype).view(x.shape)
                                  for p in parts], dim=dim))
            lo = hi
        return tuple(out)

    @staticmethod
    def backward(fc, *gs):
        return (None, None, None) + tuple(_scatter_sum(
            gs, fc.dims, fc.pctx, f"{fc.name}_bwd"))


def gather_many(items: List[Tuple[torch.Tensor, int]],
                ctx: Optional[ParallelCtx], name: str = "fsdp"
                ) -> List[torch.Tensor]:
    """For each ``(x, dim)``, the ranks' blocks of ``x`` over ``data``
    concatenated along ``dim`` in data order: all of them in one
    ``all_gather`` of their bytes (exact, whatever their types, timed as
    ``dp_<name>``), so a layer's leaves cost one collective. Its backward
    is the reduce-scatter in data order of the whole leaves' gradients,
    one collective too (``dp_<name>_bwd``)."""
    if not items or dp_size(ctx) == 1:
        return [x for x, _ in items]
    return list(_GatherMany.apply(ctx, name, tuple(d for _, d in items),
                                  *(x for x, _ in items)))


def sum_many(xs: List[torch.Tensor], ctx: Optional[ParallelCtx],
             axis: str = "data", name: str = "sum") -> List[torch.Tensor]:
    """Each of ``xs`` summed over ``axis``: one ``all_gather`` of their
    bytes (timed ``<axis prefix>_<name>``), every rank adding the ranks'
    copies in ascending rank order in float32 and casting each sum once
    to its type. No gradient: the step's sum of gradients."""
    if not xs or _axis(ctx, axis)[0] == 1:
        return list(xs)
    flat = [_bytes(x) for x in xs]
    parts = _gather(torch.cat(flat), ctx, name, axis)
    out, lo = [], 0
    for x, f in zip(xs, flat):
        hi = lo + f.numel()
        out.append(_add_in_order([p[lo:hi] for p in parts], x.dtype,
                                 x.shape))
        lo = hi
    return out


class _Once(torch.autograd.Function):
    """The identity forward; backward the gradient over n."""

    @staticmethod
    def forward(fc, x, n):
        fc.n = n
        return x.view_as(x)

    @staticmethod
    def backward(fc, g):
        return g / fc.n, None


def once(x: torch.Tensor, ctx: Optional[ParallelCtx]) -> torch.Tensor:
    """``x``, a value every data rank computes alike from the same inputs
    (the whole batch), counted once in the loss: the identity forward,
    and backward the gradient over D, so the D ranks' parts of the
    gradients, summed over ``data``, add up to one."""
    n = dp_size(ctx)
    return x if n == 1 else _Once.apply(x, n)


def gather_fsdp(tree, ctx: Optional[ParallelCtx], d_model: int):
    """``tree`` (one layer's parameters, or the leaves outside the
    layers) with every leaf the rules cut over ``data`` gathered whole
    along its ``fsdp`` dim, the data ranks' blocks in data order (exact:
    a concatenation; one collective, :func:`gather_many`, whose backward
    is the reduce-scatter). Every ``fsdp`` dim of these leaves is
    ``d_model``'s, so a dim is cut where it holds fewer; a leaf already
    whole is returned as it is. The MoE's expert tables stay as held
    (their layout depends on the branch, ``moe.moe_forward`` gathers
    them). The gathered blocks live as long as the returned tree."""
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
    order: the whole batch on every rank (:func:`gather_many`, timed
    ``dp_rows``). Every data rank's work on the whole batch gives a part
    of the gradient of each rank's rows, so the backward adds the D
    ranks' gradients of the whole batch in data order and keeps this
    rank's rows (``dp_rows_bwd``)."""
    return gather_many([(x, 0)], ctx, "rows")[0]


def rows_take(x: torch.Tensor, n: int, ctx: Optional[ParallelCtx]
              ) -> torch.Tensor:
    """This data rank's ``n`` rows of a whole batch ``x`` (the inverse
    of :func:`rows_gather`); ``x`` itself when it has ``n`` rows. Its
    backward is the narrow's: the rank's rows' gradient, zeros
    elsewhere."""
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


class LengthBlock(NamedTuple):
    """This rank's block of a cache's length: slots ``[start, start +
    size)`` of the whole cache's ``length``, cut over ``axis`` ("model",
    "data" or ``MESH``; None: the rank holds the whole length)."""
    start: int
    size: int
    length: int
    axis: Optional[str]


def cache_block(entry, length: int, ctx: Optional[ParallelCtx]
                ) -> LengthBlock:
    """The rank's block of a cache length of ``length`` slots that
    ``cache_specs`` lays out by ``entry`` (the spec's length entry: None
    or the mesh axes it is cut over). The axes of one rank are left out;
    the block's index is row-major over the rest, as ``shardrules._block``
    orders it, and they merge over "model", "data" or, where the length
    is cut over both, the whole mesh."""
    axes = tuple(a for a in entry or () if ctx.mesh.shape[a] > 1)
    if not axes:
        return LengthBlock(0, length, length, None)
    idx = 0
    for a in axes:
        idx = idx * ctx.mesh.shape[a] + ctx.mesh.coord(a)
    size = length // math.prod(ctx.mesh.shape[a] for a in axes)
    axis = ("model" if axes == ("model",) else
            MESH if "model" in axes else "data")
    return LengthBlock(idx * size, size, length, axis)


def softmax_merge(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                  ctx: Optional[ParallelCtx], axis: Optional[str]
                  ) -> torch.Tensor:
    """The softmax-weighted sum over every rank's block of slots, from
    each rank's float32 partials: ``m`` its masked scores' max, ``l`` the
    sum of ``exp(s - m)`` (both of ``o``'s shape without its last dim)
    and ``o`` the sum of ``exp(s - m) v``. One ``all_gather`` of the
    three over ``axis`` (timed ``<axis prefix>_softmax``); every rank
    then takes the largest max and adds the rescaled partials in
    ascending rank order, so every rank holds the same bits. A block
    with no live slot (``m`` = ``NEG_INF``) weighs ``exp(NEG_INF - m)``,
    exactly zero. Where ``axis`` is None, ``o / l``."""
    if axis is None or _axis(ctx, axis)[0] == 1:
        return o / l[..., None]
    flat = torch.cat([m.reshape(-1), l.reshape(-1), o.reshape(-1)])
    nm = m.numel()
    parts = [(p[:nm].view(m.shape), p[nm:2 * nm].view(m.shape),
              p[2 * nm:].view(o.shape))
             for p in _gather(flat.float(), ctx, "softmax", axis)]
    top = parts[0][0]
    for mr, _, _ in parts[1:]:
        top = torch.maximum(top, mr)
    l_sum = o_sum = None
    for mr, lr, orr in parts:
        w = torch.exp(mr - top)
        l_sum = w * lr if l_sum is None else l_sum + w * lr
        o_sum = w[..., None] * orr if o_sum is None else \
            o_sum + w[..., None] * orr
    return o_sum / l_sum[..., None]


def check_layer(spec, ctx: Optional[ParallelCtx]) -> None:
    """Raise for a layer the tensor-parallel layout does not cover at
    T > 1, in serving and in training. Every rank sees the same config
    and mesh, so every rank raises alike, before any collective."""
    if spec.ssm is not None:
        check_ssm(spec.ssm, ctx)


def check_ssm(cfg, ctx: Optional[ParallelCtx]) -> None:
    """Raise at T > 1 for SSM heads in more than one group. Heads T does
    not divide are scanned whole on every rank."""
    t = tp_size(ctx)
    if t > 1 and cfg.n_groups > 1:
        raise NotImplementedError(
            f"{cfg.n_heads} SSM heads in {cfg.n_groups} groups at T = {t}:"
            f" the port splits one group's heads evenly ({SSM_GROUPS})")
