"""Carry a parameter tree of the JAX package into the port.

:func:`from_reference` takes ``repro.models.model.init_params``'s tree
with every leaf a numpy array (``jax.tree.map(np.asarray, params)``),
each segment's layers stacked on a leading axis, and returns the port's
parameters for the same :class:`~repro_torch.models.model.ModelConfig`:
the segments unstacked into lists of per-layer dictionaries (a hybrid
layer's ``attn``, ``ssm``, ``ffn``, norms and gains alike), every matrix
in ``cfg.dtype`` (``meta_tokens`` too, as the reference's
``cast_params`` casts it) and every vector in float32 (the types each
reference use site casts to). Nothing of JAX is imported: the input is
numpy.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from ..device import resolve_device
from .model import ModelConfig, cast_params


def _to_torch(tree, device: torch.device):
    if isinstance(tree, Mapping):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)


def _unstack(tree, i: int):
    if isinstance(tree, Mapping):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i]


def from_reference(cfg: ModelConfig, tree: Mapping[str, Any],
                   device: Union[str, torch.device] = "cuda") -> Dict:
    """The port's parameters from the JAX package's numpy tree."""
    dev = resolve_device(device)
    segs = tree["segments"]
    if len(segs) != len(cfg.plan):
        raise ValueError(f"tree has {len(segs)} segments, the config "
                         f"{len(cfg.plan)}")
    out = {k: _to_torch(v, dev) for k, v in tree.items() if k != "segments"}
    out["segments"] = []
    for i, (_, count) in enumerate(cfg.plan):
        stacked = _to_torch(segs[str(i)], dev)
        lead = {int(np.shape(a)[0]) for a in _leaves(segs[str(i)])}
        if lead != {count}:
            raise ValueError(f"segment {i}: leading axes {sorted(lead)}, "
                             f"expected {count} layers")
        out["segments"].append([_unstack(stacked, j) for j in range(count)])
    return cast_params(out, cfg.dtype)


def _leaves(tree):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
