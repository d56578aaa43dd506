"""Carry a parameter tree, or a training state, of the JAX package into
the port and back.

:func:`from_reference` takes ``repro.models.model.init_params``'s tree
with every leaf a numpy array (``jax.tree.map(np.asarray, params)``),
each segment's layers stacked on a leading axis, and returns the port's
parameters for the same :class:`~repro_torch.models.model.ModelConfig`:
the segments unstacked into lists of per-layer dictionaries (a hybrid
layer's ``attn``, ``ssm``, ``ffn``, norms and gains alike, an MoE
layer's ``moe`` with its ``router``, ``experts`` {w_up, w_gate} (E, D, F)
and w_down (E, F, D), and ``shared`` experts), every matrix in
``cfg.dtype`` (``meta_tokens``, ``frontend_proj`` and ``lm_head`` too,
as the reference's ``cast_params`` casts them), every vector and the
router in float32 (the types each reference use site casts to). Nothing
of JAX is imported: the input is numpy.

:func:`state_to_flat` and :func:`state_from_flat` carry a training state
{step, params, opt {m, v}} to and from the reference's flat checkpoint
dictionary (``repro/train/checkpoint.py``): one numpy array a key, the
key the leaf's path joined by ``/`` (``params/segments/0/ssm/in_x``,
``opt/m/embed/tokens``, ``step``), each segment's leaves stacked over its
layers on a leading axis, as the reference's scan layout holds them.
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


# --- the training state and the reference's checkpoint keys ------------------

def _flat_items(tree, prefix: str):
    """(key, tensor or list of per-layer tensors) in the reference's
    flat layout: a list is a model's segments, each a list of layers whose
    leaves stack."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_items(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, list):
        for i, seg in enumerate(tree):
            for rel, _ in _flat_items(seg[0], ""):
                yield f"{prefix}/{i}/{rel}", [_get(layer, rel)
                                              for layer in seg]
    else:
        yield prefix, tree


def _get(tree, rel: str):
    for k in rel.split("/"):
        tree = tree[k]
    return tree


def state_to_flat(state) -> Dict[str, np.ndarray]:
    """The reference's checkpoint dictionary of a port training state (any
    tree of the port's layout): host numpy copies, segments stacked."""
    out = {}
    for key, leaf in _flat_items(state, ""):
        t = torch.stack(leaf) if isinstance(leaf, list) else leaf
        out[key] = t.detach().cpu().numpy()
    return out


def _restored(flat: Mapping[str, np.ndarray], key: str,
              shape) -> np.ndarray:
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    arr = flat[key]
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs "
                         f"model {tuple(shape)}")
    return arr


def state_from_flat(template, flat: Mapping[str, np.ndarray]):
    """A tree of ``template``'s structure, devices and dtypes holding the
    reference-layout ``flat`` arrays; raises KeyError for a missing leaf
    and ValueError for a shape that does not match."""
    def build(tmpl, prefix):
        if isinstance(tmpl, dict):
            return {k: build(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in tmpl.items()}
        if isinstance(tmpl, list):
            return [_segment(seg, f"{prefix}/{i}")
                    for i, seg in enumerate(tmpl)]
        arr = _restored(flat, prefix, tmpl.shape)
        return torch.tensor(arr, device=tmpl.device, dtype=tmpl.dtype)

    def _segment(seg, prefix):
        # one upload a stacked leaf; the layers hold views of it
        stacked = {}
        for rel, first in _flat_items(seg[0], ""):
            arr = _restored(flat, f"{prefix}/{rel}",
                            (len(seg),) + tuple(first.shape))
            stacked[rel] = torch.tensor(arr, device=first.device,
                                        dtype=first.dtype)
        return [_layer(layer, stacked, j) for j, layer in enumerate(seg)]

    def _layer(tmpl, stacked, j, rel=""):
        if isinstance(tmpl, dict):
            return {k: _layer(v, stacked, j, f"{rel}/{k}" if rel else k)
                    for k, v in tmpl.items()}
        return stacked[rel][j]

    return build(template, "")
