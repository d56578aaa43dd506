"""AdamW and its schedule, after ``repro/train/optim.py``.

The optimizer state is a pair of trees {m, v} mirroring the parameters:
float32 moments beside float32 master weights. Gradients may arrive in
bfloat16 (the compressed working copy's); the update runs in float32,
under ``torch.no_grad()``, and writes the parameters and moments in
place, where the reference's jitted step donates them, one slice of a
leaf at a time (``row_slices``).

Parameter trees are the port's: dictionaries of tensors, with each
segment a list of per-layer dictionaries. On a ``(D, T)`` mesh each rank
holds its blocks of the weights and of both moments and updates them
alone; only the clipping norm is the whole model's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import tp

Path = Tuple
NO_DECAY = ("scale", "bias", "A_log", "D", "dt_bias", "gain_attn",
            "gain_ssm")


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    clip_norm: float = 1.0


# --- trees -------------------------------------------------------------------

def leaves_with_paths(tree, path: Path = ()) -> Iterator[Tuple[Path,
                                                               torch.Tensor]]:
    """(path, tensor) for every leaf, dictionaries and lists walked in
    order; a path holds dictionary keys and list indices."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_paths(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, path + (i,))
    else:
        yield path, tree


def tree_leaves(tree) -> List[torch.Tensor]:
    return [t for _, t in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_unflatten(template, leaves) -> object:
    """A tree of ``template``'s structure holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


# --- schedule and update -------------------------------------------------------

def cosine_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio*peak, float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    floor = cfg.peak_lr * cfg.min_lr_ratio
    cos = floor + 0.5 * (cfg.peak_lr - floor) * (1 + torch.cos(np.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params) -> Dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def global_norm(tree, cuts: Optional[Sequence[Tuple[str, ...]]] = None,
                ctx=None) -> torch.Tensor:
    """The norm of the whole model's ``tree``. Under a mesh ``ctx``,
    ``cuts`` names for each leaf the axes that cut it (``("model",)``,
    ``("data",)``, both, or none: ``step.split_leaves``): the squares of
    each kind of block are summed on the rank, one gather over the mesh
    brings every rank's three partial sums, and each kind is added over
    the axes that cut it in rank order (the model-cut blocks over data
    row 0's ranks, the data-cut ones over model column 0's, the blocks
    cut over both over every rank); the squares of the leaves every rank
    holds whole are counted once. Every rank gets the same norm, bit for
    bit."""
    sq = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    if cuts is None or ctx is None or ctx.mesh.size == 1:
        return torch.sqrt(sum(sq))
    zero = torch.zeros((), dtype=torch.float32, device=sq[0].device)
    kinds = (("model",), ("data",), ("data", "model"))
    part = torch.stack([sum((q for q, c in zip(sq, cuts) if c == k), zero)
                        for k in kinds])
    whole = sum((q for q, c in zip(sq, cuts) if not c), zero)
    parts = tp._gather(part, ctx, "norm", tp.MESH)
    t = ctx.tensor_size

    def add(ranks, i):
        acc = parts[ranks[0]][i]
        for r in ranks[1:]:
            acc = acc + parts[r][i]
        return acc
    total = add(range(t), 0) + add(range(0, len(parts), t), 1)
    return torch.sqrt(total + add(range(len(parts)), 2) + whole)


def _decay_mask(path: Path) -> bool:
    """Weight decay on matrices only (no norms/biases/gains), by the last
    key of the parameter path."""
    last = path[-1] if path and isinstance(path[-1], str) else ""
    return last not in NO_DECAY


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state: Dict, params,
                 step, cuts: Optional[Sequence[Tuple[str, ...]]] = None,
                 ctx=None) -> Tuple[object, Dict, Dict]:
    """One AdamW step. ``grads`` may be bf16; moments and parameters
    update in float32, in place. Under a mesh ``ctx`` each rank updates
    its own blocks, clipped by the whole model's norm
    (:func:`global_norm` over ``cuts``). Returns (params, state, stats),
    the same objects as given, with stats {grad_norm, lr} as 0-d
    tensors."""
    gnorm = global_norm(grads, cuts, ctx)
    if cfg.clip_norm > 0:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    lr = cosine_lr(cfg, step).to(gnorm.device)
    t = torch.as_tensor(step).to(device=gnorm.device,
                                 dtype=torch.float32) + 1.0
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    for (path, p), g, m, v in zip(leaves_with_paths(params),
                                  tree_leaves(grads),
                                  tree_leaves(state["m"]),
                                  tree_leaves(state["v"])):
        decay = cfg.weight_decay > 0 and _decay_mask(path) and p.dim() >= 2
        for ps, gs, ms, vs in zip(*(row_slices(t) for t in (p, g, m, v))):
            gs = gs.float() * scale
            ms.copy_(cfg.b1 * ms + (1 - cfg.b1) * gs)
            vs.copy_(cfg.b2 * vs + (1 - cfg.b2) * gs * gs)
            u = (ms / bc1) / (torch.sqrt(vs / bc2) + cfg.eps)
            if decay:
                u = u + cfg.weight_decay * ps.float()
            ps.copy_((ps.float() - lr * u).to(ps.dtype))
    return params, state, {"grad_norm": gnorm, "lr": lr}


SLICE = 1 << 24      # elements of a leaf updated at a time


def row_slices(t: torch.Tensor) -> List[torch.Tensor]:
    """Views of ``t`` along its first axis of about ``SLICE`` elements
    each (``t`` itself when it has no axis): the update's float32
    temporaries stay at 64 MB however large a leaf is (nemotron-4-15b's
    embedding and head hold 1.57 B elements each), and its arithmetic,
    element by element, is that of the whole leaf."""
    if t.dim() == 0 or t.numel() <= SLICE:
        return [t]
    rows = max(1, SLICE * t.shape[0] // t.numel())
    return list(t.split(rows))
