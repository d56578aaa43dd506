"""Train step builder: grad-accum microbatching and the bf16 working copy,
after ``repro/train/step.py``.

Gradient compression: the forward and backward run against the **bf16
working copy** of the weights (``cast_params``), so the gradients are
bf16; master weights, Adam moments and the microbatch accumulator stay
float32 (``compress_grads=False`` keeps float32 end to end). On one card
nothing is all-reduced; the option keeps the reference's numbers.

The reference's ``state_specs`` and ``jit_train_step`` lay the state
over a mesh; they come with sharded training (ROADMAP Queue 1 item 2c).
Its ``batch_specs`` is ``models.shardrules.batch_specs``, which serving
uses.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..models.model import ModelConfig, cast_params, init_params, loss_fn
from .optim import (AdamWConfig, adamw_init, adamw_update, tree_leaves,
                    tree_map, tree_unflatten)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optim: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    grad_accum: int = 1
    compress_grads: bool = True      # bf16 working copy and gradients


def init_state(cfg: ModelConfig, seed: int = 0,
               device: Union[str, torch.device] = "cuda") -> Dict:
    """{step, params (float32 master weights), opt {m, v}} on ``device``,
    the weights drawn from ``seed``."""
    dev = resolve_device(device)
    params = init_params(cfg, seed, dev, dtype=torch.float32)
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "params": params, "opt": adamw_init(params)}


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
                   ) -> Tuple[torch.Tensor, Dict, List[torch.Tensor]]:
    """(loss, metrics, one gradient a leaf of ``work`` in its dtype)."""
    leaves = tree_leaves(work)
    loss, metrics = loss_fn(cfg, work, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _microbatches(batch: Dict, n: int) -> List[Dict]:
    """(B, ...) -> n microbatches of B/n rows, in order."""
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} microbatches")
    m = b // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(n)]


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics). The state's
    parameters and moments are updated in place; ``batch`` holds tensors
    on the state's device (``batch_to``). Metrics: loss, ce, grad_norm
    and lr, 0-d tensors."""

    def train_step(state, batch):
        params = state["params"]
        work = working_copy(cfg, tcfg, params)
        n = tcfg.grad_accum
        if n <= 1:
            loss, metrics, grads = loss_and_grads(cfg, work, batch)
            grads = [g.float() for g in grads]
        else:
            grads, lsum, ms = None, 0.0, []
            for mb in _microbatches(batch, n):
                loss_i, m_i, g_i = loss_and_grads(cfg, work, mb)
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
                                   state["opt"], params, state["step"])
        metrics = dict(metrics)
        metrics.update(stats)
        metrics["loss"] = loss
        state["step"] = state["step"] + 1
        return state, metrics

    return train_step
