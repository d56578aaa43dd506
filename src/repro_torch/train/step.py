"""Train step builder: grad-accum microbatching and the bf16 working copy,
sharded state specs, after ``repro/train/step.py``.

Gradient compression: the forward and backward run against the **bf16
working copy** of the weights (``cast_params``), so the gradients are
bf16; master weights, Adam moments and the microbatch accumulator stay
float32 (``compress_grads=False`` keeps float32 end to end).

On a ``(D, T)`` mesh (``make_train_step(cfg, tcfg, mesh)``) each rank
holds its blocks of the master weights and of both moments
(``init_state(..., mesh=)``: the whole tree drawn from the seed, then
the rank's blocks kept by ``shard_params``: the ``fsdp`` dims cut over
``data``, the ``tensor`` dims over ``model``, the expert tables by
expert), is handed the global batch and cuts it as the reference does:
microbatch i holds global rows ``[i B/n, (i+1) B/n)``, and each data
rank takes its block of them (``shard_batch``; all of them where D does
not divide them). It runs the forward on its rows, heads, channels,
experts and vocabulary block, the backward through every collective
(:mod:`repro_torch.models.tp`: the FSDP gathers' backward is a
reduce-scatter over ``data``; a leaf every rank holds whole, in any
layout of the heads, has its whole gradient over ``model`` from the
layers' single ordered sums, so nothing is added over ``model`` after
it), adds the gradients of the leaves no rank cuts over ``data`` over
the data ranks (:func:`batch_grads`), and
updates its own blocks, clipped by the whole model's norm. Every sum
over ``data`` adds the ranks' gradients in data order in float32 and
casts once to the gradient's type: under ``compress_grads`` a bf16
gradient rounds once, where the reference's bf16 psum rounds as its
partitioner's reduction goes. ``state_specs`` is the reference's: the
parameters' and both moments' specs from ``tree_specs``, the step
whole. The reference's ``jit_train_step`` has no counterpart, as there
is no partitioner. Its ``batch_specs`` is
``models.shardrules.batch_specs``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.mesh import Mesh
from ..device import resolve_device
from ..models import tp
from ..models.model import (ModelConfig, cast_params, init_params, loss_fn,
                            param_shapes)
from ..models.shardrules import (ParallelCtx, _items, _map, batch_axes,
                                 dp_size, held_specs, make_ctx,
                                 shard_batch, shard_params, tree_specs)
from .optim import (AdamWConfig, adamw_init, adamw_update, tree_leaves,
                    tree_map, tree_unflatten)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optim: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    grad_accum: int = 1
    compress_grads: bool = True      # bf16 working copy and gradients


def init_state(cfg: ModelConfig, seed: int = 0,
               device: Union[str, torch.device] = "cuda",
               mesh: Optional[Mesh] = None) -> Dict:
    """{step, params (float32 master weights), opt {m, v}} on ``device``,
    the weights drawn from ``seed``; on a mesh the whole tree is drawn,
    then the rank's blocks are kept (``shard_params``) and the moments
    are the blocks'."""
    dev = resolve_device(device)
    params = init_params(cfg, seed, dev, dtype=torch.float32)
    params = shard_params(params, make_ctx(mesh))
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "params": params, "opt": adamw_init(params)}


def state_specs(state, mesh: Mesh) -> Dict:
    """The spec of every leaf of a whole training state, as the
    reference's ``state_specs``: the parameters and both moments by the
    rules (``tree_specs``), the step whole (``()``)."""
    return {"step": (),
            "params": tree_specs(state["params"], mesh),
            "opt": {"m": tree_specs(state["opt"]["m"], mesh),
                    "v": tree_specs(state["opt"]["v"], mesh)}}


def shard_state(state: Dict, ctx: Optional[ParallelCtx]) -> Dict:
    """This rank's blocks of a whole training state: the parameters and
    both moments as ``shard_params`` places them, the step whole."""
    return {"step": state["step"],
            "params": shard_params(state["params"], ctx),
            "opt": {k: shard_params(state["opt"][k], ctx)
                    for k in ("m", "v")}}


def _held(cfg: ModelConfig, mesh: Mesh):
    """The layout each leaf of ``cfg``'s parameters is held in on
    ``mesh`` (``held_specs`` of the whole tree's shapes)."""
    return held_specs(param_shapes(cfg), mesh)


def _cut_axes(entry, mesh: Mesh) -> Tuple[str, ...]:
    """The axes of :mod:`repro_torch.models.tp` a spec entry cuts over:
    ``"data"`` for the batch axes, ``"model"``."""
    if not entry:
        return ()
    return tuple(a for a, hit in (
        ("data", any(b in entry for b in batch_axes(mesh))),
        ("model", "model" in entry)) if hit)


def split_leaves(cfg: ModelConfig, mesh: Mesh) -> List[Tuple[str, ...]]:
    """For each leaf, in tree order: the axes that cut it on ``mesh``,
    of ``("data", "model")``; ``()`` where every rank holds all of it."""
    out = []
    for _, spec in _items(_held(cfg, mesh)):
        axes = {a for e in spec for a in _cut_axes(e, mesh)}
        out.append(tuple(a for a in ("data", "model") if a in axes))
    return out


@torch.no_grad()
def gather_state(cfg: ModelConfig, state: Dict,
                 ctx: Optional[ParallelCtx]) -> Dict:
    """The whole training state from every rank's blocks (the inverse of
    :func:`shard_state`), on every rank: each leaf gathered along each
    dim its spec cuts, over ``data`` or ``model``, in rank order, which
    is exact."""
    if ctx is None or ctx.mesh.size == 1:
        return state
    specs = dict(_items(_held(cfg, ctx.mesh)))

    def whole(path, x):
        for dim, entry in enumerate(specs[path]):
            for axis in _cut_axes(entry, ctx.mesh):
                x = tp.gather_cat(x, dim, ctx, axis, "ckpt")
        return x
    return {"step": state["step"],
            "params": _map(whole, state["params"]),
            "opt": {k: _map(whole, state["opt"][k]) for k in ("m", "v")}}


def whole_template(cfg: ModelConfig, device: torch.device) -> Dict:
    """A whole training state's shapes, types and device without its
    memory (each leaf a 0-stride view of one element): the template a
    checkpoint restores into before a rank keeps its blocks."""
    def empty(m):
        return torch.empty((), dtype=m.dtype, device=device).expand(m.shape)
    params = tree_map(empty, param_shapes(cfg))
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "params": params, "opt": {"m": params, "v": params}}


def batch_to(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (``make_batch``'s) as tensors on
    ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


def working_copy(cfg: ModelConfig, tcfg: TrainConfig, params):
    """The leaves the loss is differentiated against: the ``cast_params``
    copy when compressing, else the master weights themselves (detached
    aliases)."""
    work = cast_params(params, cfg.dtype) if tcfg.compress_grads else params
    return tree_map(lambda p: p.detach().requires_grad_(), work)


def loss_and_grads(cfg: ModelConfig, work, batch: Dict,
                   ctx: Optional[ParallelCtx] = None,
                   ) -> Tuple[torch.Tensor, Dict, List[torch.Tensor]]:
    """(loss, metrics, one gradient a leaf of ``work`` in its dtype);
    under ``ctx``, the rank's blocks' gradients and the whole leaves'
    whole ones."""
    leaves = tree_leaves(work)
    loss, metrics = loss_fn(cfg, work, batch, ctx)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def batch_grads(cfg: ModelConfig, work, batch: Dict,
                ctx: Optional[ParallelCtx],
                cuts: Optional[Sequence[Tuple[str, ...]]],
                ) -> Tuple[torch.Tensor, Dict, List[torch.Tensor]]:
    """:func:`loss_and_grads` of the global ``batch`` on this rank: its
    rows (``shard_batch``), then with D > 1 the gradients of the leaves
    ``cuts`` (:func:`split_leaves`) does not cut over ``data``, which
    every data rank holds a part of, added over ``data`` in data order in
    float32, each cast once to its type (one collective, timed
    ``dp_sum_bwd``). The leaves cut over ``data`` came out of the
    backward summed (the FSDP gathers' reduce-scatter)."""
    rows, rctx = shard_batch(batch, ctx)
    loss, metrics, grads = loss_and_grads(cfg, work, rows, rctx)
    if dp_size(ctx) > 1:
        idx = [i for i, c in enumerate(cuts) if "data" not in c]
        for i, g in zip(idx, tp.sum_many([grads[i] for i in idx], ctx,
                                         "data", "sum_bwd")):
            grads[i] = g
    return loss, metrics, grads


def _microbatches(batch: Dict, n: int) -> List[Dict]:
    """(B, ...) -> n microbatches of B/n rows, in order: microbatch i
    holds global rows ``[i B/n, (i+1) B/n)``, as the reference's
    reshape to (n, B/n, ...) cuts them."""
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} microbatches")
    m = b // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(n)]


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    mesh: Optional[Mesh] = None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics). The state's
    parameters and moments are updated in place; ``batch`` holds tensors
    on the state's device (``batch_to``), the global batch on every rank
    of a ``mesh``, whose state holds the rank's blocks
    (``init_state(..., mesh=)``); each data rank takes its rows of each
    microbatch. Metrics: loss, ce, grad_norm and lr, 0-d tensors, the
    same bits on every rank."""
    ctx = make_ctx(mesh)
    cuts = split_leaves(cfg, mesh) if ctx is not None else None

    def train_step(state, batch):
        params = state["params"]
        work = working_copy(cfg, tcfg, params)
        n = tcfg.grad_accum
        if n <= 1:
            loss, metrics, grads = batch_grads(cfg, work, batch, ctx, cuts)
            grads = [g.float() for g in grads]
        else:
            grads, lsum, ms = None, 0.0, []
            for mb in _microbatches(batch, n):
                loss_i, m_i, g_i = batch_grads(cfg, work, mb, ctx, cuts)
                if grads is None:          # the float32 accumulator
                    grads = [g.float() for g in g_i]
                else:
                    for a, g in zip(grads, g_i):
                        a.add_(g.float())
                del g_i
                lsum = lsum + loss_i
                ms.append(m_i)
            for g in grads:                # in place: no second float32 set
                g.div_(n)
            loss = lsum / n
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        del work
        _, _, stats = adamw_update(tcfg.optim,
                                   tree_unflatten(params, grads),
                                   state["opt"], params, state["step"],
                                   cuts, ctx)
        metrics = dict(metrics)
        metrics.update(stats)
        metrics["loss"] = loss
        state["step"] = state["step"] + 1
        return state, metrics

    return train_step
