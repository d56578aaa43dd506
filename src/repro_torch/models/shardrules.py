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

The port serves on a ``(D, T)`` mesh: D ranks on the data axis, T on
the tensor axis. Each rank holds exactly its slices (:func:`shard_params`:
the ``fsdp`` dims cut over ``data``, the ``tensor`` dims over ``model``;
the MoE's expert tables by expert, see there) and its rows of the batch
(:func:`batch_specs`), and the model's layers carry the layout out with
explicit collectives (:mod:`.tp`): each layer's ``fsdp`` leaves are
gathered over ``data`` at use, and where the reference leaves the
collectives to GSPMD's partitioner, every sum here is an ordered
gather-and-add. Training runs on the same ``(D, T)`` meshes, each rank
holding its blocks of the master weights and of both moments as
:func:`shard_params` places them and taking its rows of each
microbatch (:func:`shard_batch`).
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

# The weights-stationary decode layout of the expert tables (the
# reference's §Perf H8): E over "model" and the FFN hidden dim F over the
# batch axes, so decode runs each rank's E/T experts on its F/D slice and
# only token-sized partials are summed. First in the rule list under
# ``inference``, so the dense FFN's rules no longer shadow them.
_INFERENCE_RULES: Sequence[Tuple[str, Tuple[Optional[str], ...]]] = (
    (r"experts/w_(up|gate)$", ("expert", None, "fsdp")),   # (E, D, F)
    (r"experts/w_down$", ("expert", "fsdp", None)),        # (E, F, D)
)

# the expert tables' own rules of PARAM_RULES, which the dense FFN's
# rules shadow in spec_for: the layout shard_params holds them in
_EXPERT_RULES = tuple(r for r in PARAM_RULES if r[0].startswith("experts/"))


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


def _rules(inference: bool):
    return (tuple(_INFERENCE_RULES) + tuple(PARAM_RULES)) if inference \
        else PARAM_RULES


def _logicals(rules, path: str, nd: int
              ) -> Optional[Tuple[Optional[str], ...]]:
    """The logical axes of a leaf's ``nd`` dims under the first rule that
    matches ``path`` and has no more dims than the leaf (stacked leading
    dims None); None where no rule matches."""
    for pat, logicals in rules:
        if re.search(pat, path) and nd >= len(logicals):
            return (None,) * (nd - len(logicals)) + tuple(logicals)
    return None


def _spec(rules, path: str, shape: Tuple[int, ...], mesh: Mesh) -> Spec:
    logicals = _logicals(rules, path, len(shape))
    if logicals is None:
        return ()
    spec = []
    for dim, logical in zip(shape, logicals):
        axes = _mesh_axes_for(logical, mesh)
        spec.append(_fit_axes(dim, axes, mesh) if axes else None)
    return tuple(spec)


def spec_for(path: str, shape: Tuple[int, ...], mesh: Mesh,
             inference: bool = False) -> Spec:
    """The spec of one parameter: one entry per dim. Unmatched paths stay
    whole (``()``, as the reference's ``P()``). First match wins, so the
    dense FFN's ``w_(up|gate)$`` / ``w_down$`` shadow the expert tables'
    own rules here as in the reference: ``experts/w_up`` gets its F dim
    cut (:func:`shard_params` holds the tables by expert all the same).
    ``inference`` puts the reference's ``_INFERENCE_RULES`` first: the
    weights-stationary decode layout of the expert tables."""
    return _spec(_rules(inference), path, shape, mesh)


def fsdp_dims(path: str, nd: int, inference: bool = False
              ) -> Tuple[int, ...]:
    """The dims of an ``nd``-dim leaf at ``path`` whose logical axis is
    ``fsdp`` under the rule :func:`spec_for` matches: d_model's dim in
    every rule but the stationary expert tables' F."""
    logicals = _logicals(_rules(inference), path, nd) or ()
    return tuple(i for i, lg in enumerate(logicals) if lg == "fsdp")


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


def tree_specs(params, mesh: Mesh, inference: bool = False):
    """The spec of every leaf, in ``params``' structure (any leaf with a
    ``shape``: tensors, meta tensors)."""
    return _map(lambda path, x: spec_for(path, tuple(x.shape), mesh,
                                         inference), params)


def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Mesh axes the global batch shards over."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def tensor_axis(mesh: Mesh) -> Optional[str]:
    return "model" if "model" in mesh.axis_names else None


def batch_specs(batch, mesh: Mesh):
    """The spec of every input of a serving batch, after the reference's
    ``train/step.py::batch_specs``: the leading (request) dim over the
    batch axes, or the whole batch where its size does not divide over
    them (a batch of one request on a data axis of two)."""
    axes = batch_axes(mesh)
    size = math.prod(mesh.shape[a] for a in axes)

    def spec(_, x):
        if x.dim() == 0 or not axes or x.shape[0] % size:
            return ()
        return (axes,) + (None,) * (x.dim() - 1)
    return _map(spec, batch)


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
    (``tensor_size``, T) and its process group (``group``); the same of
    the data axis (``data_rank``, ``data_size`` D, ``data_group``);
    ``inference``, the reference's switch to the weights-stationary
    decode layout of the expert tables (:func:`shard_params`,
    ``moe._moe_stationary``); and ``batch_whole``: every data rank holds
    the whole batch, whose requests do not divide over the data ranks
    (:func:`shard_batch` sets it; by default each holds its rows).

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
    data_rank: int = 0
    data_size: int = 1
    data_group: Any = None
    inference: bool = False
    batch_whole: bool = False

    @property
    def batch_size(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.batch)


def make_ctx(mesh: Optional[Mesh], inference: bool = False
             ) -> Optional[ParallelCtx]:
    """The context of ``mesh`` for this rank; None without a mesh. The
    mesh must be this process group's (``make_host_mesh``): a mesh that
    is only a description raises, as does one whose batch axes cut over
    more than one axis ("pod" and "data" both above one rank)."""
    if mesh is None:
        return None
    if mesh.coords is None:
        raise NotImplementedError(
            f"mesh {mesh.shape} is a description: a context runs on its "
            f"{mesh.size} ranks. Lowering a step on a description is the "
            "dry-run's (ROADMAP Queue 1 item 3)")
    batch, tensor = batch_axes(mesh), tensor_axis(mesh)
    cut = [a for a in batch if mesh.shape[a] > 1]
    if len(cut) > 1:
        raise NotImplementedError(
            f"mesh {mesh.shape}: the port cuts the batch over one axis")
    fields: Dict[str, Any] = {"inference": inference}
    if tensor is not None:
        fields.update(tensor_rank=mesh.coord(tensor),
                      tensor_size=mesh.shape[tensor],
                      group=mesh.group(tensor))
    if cut:
        fields.update(data_rank=mesh.coord(cut[0]),
                      data_size=mesh.shape[cut[0]],
                      data_group=mesh.group(cut[0]))
    return ParallelCtx(mesh=mesh, batch=batch, tensor=tensor, **fields)


def tp_size(ctx: Optional[ParallelCtx]) -> int:
    """T: the ranks of the tensor axis (1 without a context)."""
    return ctx.tensor_size if ctx is not None else 1


def dp_size(ctx: Optional[ParallelCtx]) -> int:
    """D: the ranks of the data axis (1 without a context)."""
    return ctx.data_size if ctx is not None else 1


def length_axes(name: str, shape: Tuple[int, ...], mesh: Mesh
                ) -> Tuple[str, ...]:
    """The mesh axes :func:`cache_specs` may cut the length of a cache
    leaf ``name`` of ``shape`` over (the leaf's length is cut over the
    largest suffix of them that divides it): the batch axes where the
    batch does not divide over them, and the tensor axis where the KV
    heads do not (MLA's latent and rope key, which have none: always);
    none for the SSM's leaves."""
    if name not in ("k", "v", "latent", "k_rope"):
        return ()
    baxes = batch_axes(mesh)
    taxes = ("model",) if "model" in mesh.axis_names else ()
    b_cut = baxes and _fit_axes(shape[0], baxes, mesh)
    h_cut = name in ("k", "v") and taxes and _fit_axes(shape[2], taxes,
                                                      mesh)
    return (() if b_cut else baxes) + (() if h_cut else taxes)


def cache_specs(caches, mesh: Mesh):
    """The spec of every decode cache leaf, after the reference's
    ``serve/engine.py::cache_specs``, on the port's per-layer caches (no
    leading layer dim): the batch over the batch axes and the KV heads,
    SSM ``state`` heads and ``conv_x`` channels over the tensor axis
    where they divide; ``conv_b`` / ``conv_c`` whole. Where the batch or
    the KV heads do not divide, the freed axes move to the cache length
    (:func:`length_axes`), as the reference lays it out: each rank holds
    a block of the slots, and decode merges the blocks' softmax partials
    (``tp.softmax_merge``). MLA's latent and rope key are cut along their
    length over the tensor axis (and the batch axes the batch frees)."""
    baxes = batch_axes(mesh)
    taxes = ("model",) if "model" in mesh.axis_names else ()

    def fit(dim, axes):
        return _fit_axes(dim, axes, mesh) if axes else None

    def spec(path, x):
        name, shape = path.rsplit("/", 1)[-1], tuple(x.shape)
        b_fit = fit(shape[0], baxes)
        c_fit = fit(shape[1], length_axes(name, shape, mesh)) \
            if len(shape) > 1 else None
        if name in ("k", "v"):                 # (B, C, Hkv, hd)
            return (b_fit, c_fit, fit(shape[2], taxes), None)
        if name in ("latent", "k_rope"):       # (B, C, r)
            return (b_fit, c_fit, None)
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


def expert_spec(path: str, shape: Tuple[int, ...], mesh: Mesh,
                inference: bool = False) -> Spec:
    """The layout :func:`shard_params` gives an MoE expert table (E, D,
    F) or (E, F, D): experts ``[r E/T, (r+1) E/T)`` on tensor rank r
    (all of them where T does not divide E), and the ``fsdp`` dim over
    the batch axes as the reference's own expert rules cut it: D, or
    under ``inference`` the hidden dim F (``_INFERENCE_RULES``, which
    :func:`spec_for` then gives too)."""
    return _spec(_INFERENCE_RULES if inference else _EXPERT_RULES, path,
                 shape, mesh)


def shard_params(params, ctx: Optional[ParallelCtx]):
    """This rank's parameters: the block :func:`spec_for` (under
    ``ctx.inference``) gives it of every sharded leaf, as a tensor of its
    own (the full tree can be freed), and every replicated leaf whole:
    the ``tensor`` dims cut over ``model``, the ``fsdp`` dims over
    ``data`` in data order. The counterpart of ``device_put(params,
    tree_shardings(params, mesh))``; without a context, ``params`` as
    they are.

    One departure of layout, not of math: the MoE's expert tables are
    held by expert (:func:`expert_spec`), the layout the reference's
    ``ep``, ``replicated`` and stationary bodies take in (its GSPMD
    reshards the F-cut tables :func:`spec_for` gives into it at every
    call). Where E, D and F divide a rank holds the same bytes either
    way, so ``bytes_per_device`` still counts them."""
    if ctx is None:
        return params
    return _map(lambda path, x: _block(x, held_spec(
        path, tuple(x.shape), ctx.mesh, ctx.inference), ctx), params)


def held_spec(path: str, shape: Tuple[int, ...], mesh: Mesh,
              inference: bool = False) -> Spec:
    """The layout :func:`shard_params` holds a leaf in: the expert tables
    by expert (:func:`expert_spec`), every other leaf as
    :func:`spec_for` says."""
    if re.search(EXPERT_TABLE, path):
        return expert_spec(path, shape, mesh, inference)
    return spec_for(path, shape, mesh, inference)


def held_specs(params, mesh: Mesh, inference: bool = False):
    """:func:`held_spec` of every leaf of a whole tree (tensors or meta
    tensors), in its structure."""
    return _map(lambda path, x: held_spec(path, tuple(x.shape), mesh,
                                          inference), params)


def shard_batch(batch, ctx: Optional[ParallelCtx]):
    """(this rank's rows of every input of ``batch``, a dict of tensors
    with the requests on the leading dim; the context to run them under).
    The rows are laid out as :func:`batch_specs` says: the data rank's
    block of the requests, or all of them where their number does not
    divide, and then the context says so (``batch_whole``): every data
    rank computes the whole batch, and :func:`cache_specs` cuts its
    attention caches' length over ``data`` instead (over ``data`` and
    ``model`` where the KV heads do not divide either), each data rank
    holding a block of the slots."""
    if ctx is None or ctx.data_size == 1:
        return batch, ctx
    specs = batch_specs(batch, ctx.mesh)
    rows = {k: _block(v, specs[k], ctx) for k, v in batch.items()}
    whole = any(not specs[k] for k in batch)
    return rows, dataclasses.replace(ctx, batch_whole=whole)
