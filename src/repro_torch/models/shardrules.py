"""Path-based sharding rules, after ``repro/models/shardrules.py``.

Model init builds plain nested dicts and lists of tensors; nothing in it
names the mesh. This module maps each parameter's PATH and SHAPE to a
spec on a :class:`~repro_torch.core.mesh.Mesh`, the reference's
``PartitionSpec`` as a tuple with one entry per dim: None (whole) or the
tuple of mesh axes the dim is cut over.

  * ``fsdp``   — the batch axes ("pod", "data"): fully sharded weights;
  * ``tensor`` — Megatron tensor parallelism over "model";
  * ``expert`` — expert parallelism over "model" (MoE weight tables).

A mesh axis that does not divide its dim is dropped, as in the
reference (hymba's 25 heads on model = 4 stay whole).

The port's segments are lists of per-layer dicts, so a path reads
``segments/0/3/attn/wq`` where the reference's stacked tree reads
``segments/0/attn/wq`` with a leading layer dim; the rules match the
path's suffix and the shape's trailing dims, so each dim of a layer's
leaf gets the reference's spec.

The port runs the layout of a ``(1, T)`` mesh: T ranks on the tensor
axis, the data axis of one rank (:func:`make_ctx` raises for more, which
waits for sharded training, ROADMAP Queue 1 item 2b). Each rank holds
exactly its slices (:func:`shard_params`; the MoE's expert tables by
expert, see there), and the model's layers carry
the layout out with explicit collectives (:mod:`.tp`): where the
reference leaves the collectives to GSPMD's partitioner, every sum here
is an ordered gather-and-add.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..core.mesh import Mesh

Spec = Tuple[Optional[Tuple[str, ...]], ...]

# Logical axis -> preferred mesh axes (in order; filtered by mesh).
LOGICAL_TO_MESH: Dict[str, Tuple[str, ...]] = {
    "fsdp": ("pod", "data"),
    "batch": ("pod", "data"),
    "tensor": ("model",),
    "expert": ("model",),
    "seq": ("model",),
}

# (path-suffix regex, logical axes per trailing dim). First match wins.
PARAM_RULES: Sequence[Tuple[str, Tuple[Optional[str], ...]]] = (
    # embeddings / unembedding
    (r"embed/tokens$", ("tensor", "fsdp")),          # (V, D)
    (r"lm_head$", ("fsdp", "tensor")),               # (D, V)
    (r"(embed/frontend|frontend_proj)$", (None, "fsdp")),
    (r"meta_tokens$", (None, "fsdp")),               # (M, D)
    # attention (GQA)
    (r"w[qkv]$", ("fsdp", "tensor", None)),          # (D, H, hd)
    (r"wo$", ("tensor", None, "fsdp")),              # (H, hd, D)
    # MLA
    (r"w(q_a|kv_a|k_rope)$", ("fsdp", None)),        # (D, r)
    (r"wq_b$", (None, "tensor", None)),              # (ql, H, dn+dr)
    (r"w[kv]_b$", (None, "tensor", None)),           # (kl, H, d)
    # dense FFN
    (r"w_(up|gate)$", ("fsdp", "tensor")),           # (D, F)
    (r"w_down$", ("tensor", "fsdp")),                # (F, D)
    # MoE expert tables + router
    (r"experts/w_(up|gate)$", ("expert", "fsdp", None)),   # (E, D, F)
    (r"experts/w_down$", ("expert", None, "fsdp")),        # (E, F, D)
    (r"router$", ("fsdp", None)),                    # (D, E)
    # SSM (mamba2): separate per-component projections
    (r"in_(z|x)$", ("fsdp", "tensor")),              # (D, d_inner)
    (r"in_(b|c)$", ("fsdp", None)),                  # (D, G*N)
    (r"in_dt$", ("fsdp", "tensor")),                 # (D, H_ssm)
    (r"out_proj$", ("tensor", "fsdp")),              # (d_inner, D)
    (r"conv_[xbc]/w$", (None, "tensor")),            # (width, channels)
    (r"conv_[xbc]/b$", ("tensor",)),
    (r"(A_log|D|dt_bias)$", ("tensor",)),            # (H_ssm,)
    (r"ssm_norm/scale$", ("tensor",)),               # (d_inner,)
    # norms, biases, gains — replicated
    (r"(scale|bias|gain.*)$", (None,)),
)

def _mesh_axes_for(logical: Optional[str], mesh: Mesh) -> Tuple[str, ...]:
    if logical is None:
        return ()
    prefer = LOGICAL_TO_MESH.get(logical, ())
    return tuple(a for a in prefer if a in mesh.axis_names)


def _fit_axes(dim: int, axes: Tuple[str, ...], mesh: Mesh,
              ) -> Optional[Tuple[str, ...]]:
    """Largest suffix of ``axes`` (dropping leading axes, "pod" first)
    whose product is above 1 and divides ``dim``; None if none does."""
    for start in range(len(axes)):
        cand = axes[start:]
        size = math.prod(mesh.shape[a] for a in cand)
        if size > 1 and dim % size == 0:
            return cand
    return None


def spec_for(path: str, shape: Tuple[int, ...], mesh: Mesh) -> Spec:
    """The spec of one parameter: one entry per dim. Unmatched paths stay
    whole (``()``, as the reference's ``P()``). First match wins, so the
    dense FFN's ``w_(up|gate)$`` / ``w_down$`` shadow the expert tables'
    own rules here as in the reference: ``experts/w_up`` gets its F dim
    cut. :func:`shard_params` holds the tables by expert all the same.
    The reference's ``inference`` rules (the weights-stationary decode
    layout) come with the data axis (ROADMAP Queue 1 item 2b)."""
    for pat, logicals in PARAM_RULES:
        if re.search(pat, path):
            nd, nl = len(shape), len(logicals)
            if nd < nl:       # scalar-ish param matched a wider rule
                continue
            lead = (None,) * (nd - nl)
            spec = []
            for dim, logical in zip(shape[nd - nl:], logicals):
                axes = _mesh_axes_for(logical, mesh)
                spec.append(_fit_axes(dim, axes, mesh) if axes else None)
            return lead + tuple(spec)
    return ()


def _items(tree, prefix: str = ""):
    """(path, leaf) of a tree of dicts and lists (a tuple is a leaf: a
    spec), paths "/"-joined."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _items(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _map(fn, tree, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def tree_specs(params, mesh: Mesh):
    """The spec of every leaf, in ``params``' structure (any leaf with a
    ``shape``: tensors, meta tensors)."""
    return _map(lambda path, x: spec_for(path, tuple(x.shape), mesh),
                params)


def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Mesh axes the global batch shards over."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def tensor_axis(mesh: Mesh) -> Optional[str]:
    return "model" if "model" in mesh.axis_names else None


def _shards(entry, mesh: Mesh) -> int:
    return math.prod(mesh.shape[a] for a in entry) if entry else 1


def shard_shape(shape: Tuple[int, ...], spec: Spec, mesh: Mesh
                ) -> Tuple[int, ...]:
    """The shape of one rank's block of a ``shape`` laid out by
    ``spec``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // _shards(e, mesh) for d, e in zip(shape, spec))


def bytes_per_device(params, mesh: Mesh) -> int:
    """Parameter bytes landing on one rank under the rules."""
    total = 0
    for path, x in _items(params):
        shard = 1
        for entry in spec_for(path, tuple(x.shape), mesh):
            shard *= _shards(entry, mesh)
        total += math.prod(x.shape) * x.dtype.itemsize // max(shard, 1)
    return total


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """Runtime parallelism context threaded through the model code: the
    mesh, the axes of the batch and of tensor parallelism, this rank's
    index along the tensor axis (``tensor_rank``), the axis's size
    (``tensor_size``, T) and its process group.

    None (one rank) disables every collective; the model computes the
    same function either way. The reference's ``explicit_tp`` switch has
    no counterpart: with no partitioner, every layer carries its layout
    out with explicit collectives."""
    mesh: Mesh
    batch: Tuple[str, ...]
    tensor: Optional[str]
    tensor_rank: int = 0
    tensor_size: int = 1
    group: Any = None

    @property
    def batch_size(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.batch)


def make_ctx(mesh: Optional[Mesh]) -> Optional[ParallelCtx]:
    """The context of ``mesh`` for this rank; None without a mesh. A
    mesh whose batch axes hold more than one rank raises: data
    parallelism and FSDP come with sharded training (ROADMAP Queue 1
    item 2b)."""
    if mesh is None:
        return None
    batch, tensor = batch_axes(mesh), tensor_axis(mesh)
    ctx = ParallelCtx(mesh=mesh, batch=batch, tensor=tensor)
    if ctx.batch_size > 1:
        raise NotImplementedError(
            f"mesh {mesh.shape}: the port runs tensor parallelism on a "
            "data axis of one rank; data parallelism and FSDP come with "
            "sharded training (ROADMAP Queue 1 item 2b)")
    if tensor is None:
        return ctx
    return dataclasses.replace(ctx, tensor_rank=mesh.coord(tensor),
                               tensor_size=mesh.shape[tensor],
                               group=mesh.group(tensor))


def tp_size(ctx: Optional[ParallelCtx]) -> int:
    """T: the ranks of the tensor axis (1 without a context)."""
    return ctx.tensor_size if ctx is not None else 1


def cache_specs(caches, mesh: Mesh):
    """The spec of every decode cache leaf, after the reference's
    ``serve/engine.py::cache_specs``, on the port's per-layer caches (no
    leading layer dim): the batch over the batch axes and the KV heads,
    SSM ``state`` heads and ``conv_x`` channels over the tensor axis
    where they divide; ``conv_b`` / ``conv_c`` whole. Where KV heads do
    not divide, the freed axes move to the cache length, as the
    reference lays it out (the port refuses to decode over that,
    ``tp.check_attn``)."""
    baxes = batch_axes(mesh)
    taxes = ("model",) if "model" in mesh.axis_names else ()

    def fit(dim, axes):
        return _fit_axes(dim, axes, mesh) if axes else None

    def spec(path, x):
        name, shape = path.rsplit("/", 1)[-1], tuple(x.shape)
        b_fit = fit(shape[0], baxes)
        if name in ("k", "v"):                 # (B, C, Hkv, hd)
            h_fit = fit(shape[2], taxes)
            c_axes = (() if b_fit else baxes) + (() if h_fit else taxes)
            return (b_fit, fit(shape[1], c_axes), h_fit, None)
        if name in ("latent", "k_rope"):       # (B, C, r)
            c_axes = (() if b_fit else baxes) + taxes
            return (b_fit, fit(shape[1], c_axes), None)
        if name == "state":                    # (B, H, P, N)
            return (b_fit, fit(shape[1], taxes), None, None)
        if name == "conv_x":                   # (B, w - 1, d_inner)
            return (b_fit, None, fit(shape[2], taxes))
        if name in ("conv_b", "conv_c"):
            return (b_fit, None, None)
        return ()
    return _map(spec, caches)


def _block(x: torch.Tensor, spec: Spec, ctx: ParallelCtx) -> torch.Tensor:
    """This rank's contiguous block of ``x`` under ``spec``: a tensor of
    its own where ``spec`` cuts a dim, else ``x`` itself."""
    mesh, whole = ctx.mesh, x
    for dim, entry in enumerate(spec):
        n = _shards(entry, mesh)
        if n == 1:
            continue
        idx = 0
        for a in entry:                  # row-major over the entry's axes
            idx = idx * mesh.shape[a] + mesh.coord(a)
        size = x.shape[dim] // n
        x = x.narrow(dim, idx * size, size)
    return x if x is whole else x.clone()


EXPERT_TABLE = r"experts/w_(up|gate|down)$"


def expert_spec(shape: Tuple[int, ...], mesh: Mesh) -> Spec:
    """The layout :func:`shard_params` gives an MoE expert table (E, D,
    F) or (E, F, D): experts ``[r E/T, (r+1) E/T)`` on tensor rank r,
    the whole table where T does not divide E (the reference's
    ``inference`` rules at data = 1)."""
    return (_fit_axes(shape[0], _mesh_axes_for("expert", mesh), mesh),
            None, None)


def shard_params(params, ctx: Optional[ParallelCtx]):
    """This rank's parameters: the block :func:`spec_for` gives it of
    every sharded leaf, as a tensor of its own (the full tree can be
    freed), and every replicated leaf whole. The counterpart of
    ``device_put(params, tree_shardings(params, mesh))``; without a
    context, ``params`` as they are.

    One departure of layout, not of math: the MoE's expert tables are
    held by expert (:func:`expert_spec`), the layout the reference's
    ``ep`` and ``replicated`` bodies take in (its GSPMD reshards the
    F-cut tables :func:`spec_for` gives into it at every call). Where E
    and F both divide by T a rank holds the same bytes either way, so
    ``bytes_per_device`` still counts them."""
    if ctx is None:
        return params

    def block(path, x):
        spec = (expert_spec(tuple(x.shape), ctx.mesh)
                if re.search(EXPERT_TABLE, path)
                else spec_for(path, tuple(x.shape), ctx.mesh))
        return _block(x, spec, ctx)
    return _map(block, params)
