"""The language model: embed → segmented blocks → head, after
``repro/models/model.py``.

Public entry points (functions of (cfg, params, ...)):
  init_params    parameters on the card (or the CPU when asked)
  param_shapes   the whole tree's shapes and types, nothing drawn
  loss_fn        training loss (chunked CE: the (B, S, V) float32 logits
                 are never held whole) plus the MoE layers' aux losses
  forward_hidden trunk output and the layers' metrics
  logits_for     (B, D) -> (B, V) float32 logits of the head
  init_cache     decode caches
  prefill        prompt ingestion -> (last-token logits, caches, index)
  decode_step    one-token step -> (logits, caches), caches in place

Parameters are held as the reference's use sites see them: every matrix
(rank >= 2) in ``cfg.dtype``, every vector in float32, and the MoE
router in float32, as its use site reads it (``cast_params``); training
keeps float32 master weights and differentiates their ``cast_params``
copy (``repro_torch.train.step``). The dense projections and the head
are ``torch.matmul``, as the reference leaves them to XLA.

Serving entry points take a mesh context ``ctx`` (:mod:`.shardrules`,
None: one rank) with the rank's parameters (``shard_params``) and its
rows of the batch (``shard_batch``): the leaves outside the layers
(embedding, head, frontend, meta tokens) are gathered over ``data``
once a call by ``prefill`` and ``decode_step`` (``_gathered``) and each
layer's at its use (``transformer.layer_forward``), the embedding
and the head are vocab-parallel where the rules split the vocabulary
(the logits gathered along V, so every rank of a data row holds the
same (B, V)), the layers run :mod:`.tp`'s blocks, and the caches hold
the rank's rows and its KV heads, SSM heads and ``conv_x`` channels, and
where ``cache_specs`` cuts an attention cache's length (KV heads or
requests that do not divide, MLA's latent) its block of the slots
(:func:`cache_blocks`; ``decode_step`` then needs ``max_len``).
``loss_fn`` takes the same context in training, on a ``(D, T)`` mesh:
the rank's blocks and its rows, the layers' collectives with their
backward, the loss vocab-parallel where the vocabulary is split and the
mean over the global batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import tp
from .frontends import assemble, embed_tokens
from .layers import (dense_init, embed_init, layernorm, layernorm_init,
                     rmsnorm, rmsnorm_init)
from .shardrules import (ParallelCtx, _items, _map, cache_specs, dp_size,
                         length_axes, shard_shape)
from .transformer import (LayerSpec, layer_init_cache, segment_forward,
                          segment_init)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    vocab: int
    plan: Tuple[Tuple[LayerSpec, int], ...]
    norm: str = "rmsnorm"              # final norm kind
    tie_embeddings: bool = True
    causal: bool = True                # False: encoder-only (hubert)
    meta_tokens: int = 0               # hymba learnable prefix
    frontend: str = "none"             # none | audio | vlm
    frontend_dim: int = 0
    dtype: torch.dtype = torch.bfloat16
    loss_chunk: int = 1024
    remat: str = "full"                # none | full | dots
    # documentation-only flags, as in the reference:
    decode_supported: bool = True      # False: encoder-only
    long_context: bool = False         # sub-quadratic decode at 500k?

    @property
    def n_layers(self) -> int:
        return sum(c for _, c in self.plan)


# --- init -----------------------------------------------------------------------

FLOAT32_LEAVES = ("router",)     # read in float32 at their use sites


def cast_params(params, dtype: torch.dtype):
    """Matrices (rank >= 2) to ``dtype``, vectors and the leaves named in
    ``FLOAT32_LEAVES`` to float32."""
    if isinstance(params, dict):
        return {k: (v.float() if k in FLOAT32_LEAVES
                    else cast_params(v, dtype)) for k, v in params.items()}
    if isinstance(params, list):
        return [cast_params(v, dtype) for v in params]
    return params.to(dtype if params.dim() >= 2 else torch.float32)


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Union[str, torch.device] = "cuda",
                dtype: Optional[torch.dtype] = None) -> Dict:
    """Random parameters drawn on ``device`` from a ``torch.Generator``
    seeded with ``seed``, typed as :func:`cast_params` says for ``dtype``
    (``cfg.dtype`` by default; float32 gives training's master weights).

    Each matrix is drawn in float32 and cast as soon as it is drawn, so
    the peak is the finished tree plus one float32 leaf; the draws come
    in the generator order of drawing the whole float32 tree first."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return _draw(cfg, gen, dev, dtype or cfg.dtype)


def _draw(cfg: ModelConfig, gen: Optional[torch.Generator],
          dev: torch.device, dtype: torch.dtype) -> Dict:
    kw = {"generator": gen, "device": dev, "dtype": dtype}
    p: Dict[str, Any] = {
        "embed": {"tokens": embed_init((cfg.vocab, cfg.d_model), **kw)},
        "final_norm": (layernorm_init(cfg.d_model, dev)
                       if cfg.norm == "layernorm"
                       else rmsnorm_init(cfg.d_model, dev)),
    }
    if cfg.frontend != "none":
        p["frontend_proj"] = dense_init((cfg.frontend_dim, cfg.d_model),
                                        fan_in=cfg.frontend_dim, **kw)
    if cfg.meta_tokens > 0:
        p["meta_tokens"] = (0.02 * torch.randn(
            cfg.meta_tokens, cfg.d_model, generator=gen, device=dev)
        ).to(dtype)
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init((cfg.d_model, cfg.vocab), **kw)
    p["segments"] = [segment_init(spec, count, cfg.d_model, **kw)
                     for spec, count in cfg.plan]
    return cast_params(p, dtype)      # the undrawn biases and norms


def param_shapes(cfg: ModelConfig, dtype: torch.dtype = torch.float32
                 ) -> Dict:
    """The whole parameter tree's shapes and types without its data: each
    matrix a 0-stride view of one element on the CPU (nothing drawn), the
    vectors small tensors. What a rank holding only its blocks reads the
    rules from."""
    return _draw(cfg, None, torch.device("cpu"), dtype)


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, list):
        return sum(param_count(v) for v in params)
    return params.numel()


# --- trunk ----------------------------------------------------------------------

def _final_norm(cfg: ModelConfig, params, x):
    if cfg.norm == "layernorm":
        return layernorm(params["final_norm"], x)
    return rmsnorm(params["final_norm"], x)


def _gathered(cfg: ModelConfig, params, ctx: Optional[ParallelCtx]):
    """``params`` with the leaves outside the layers gathered over
    ``data`` (``tp.gather_fsdp``; the same tree where none is cut)."""
    if ctx is None or ctx.data_size == 1:
        return params
    out = tp.gather_fsdp({k: v for k, v in params.items()
                          if k != "segments"}, ctx, cfg.d_model)
    out["segments"] = params["segments"]
    return out


def forward_hidden(cfg: ModelConfig, params, batch: Dict,
                   mode: str = "train", caches: Optional[List] = None,
                   ctx: Optional[ParallelCtx] = None,
                   ) -> Tuple[torch.Tensor, Optional[List], Dict, int]:
    """Trunk forward. Returns (h, new_caches, metrics, prefix_len); the
    metrics of the segments add up, as in the reference. Under a context
    with a data axis the leaves outside the layers come gathered, as
    :func:`prefill` hands them on; each layer gathers its own."""
    x, positions, prefix = assemble(cfg, params, batch, ctx)
    new_caches: List[Any] = []
    metrics: Dict[str, torch.Tensor] = {}
    for i, (spec, _) in enumerate(cfg.plan):
        x, c, m = segment_forward(params["segments"][i], x, spec, positions,
                                  mode,
                                  caches[i] if caches is not None else None,
                                  remat=cfg.remat, ctx=ctx)
        new_caches.append(c)
        for k, v in m.items():
            metrics[k] = metrics[k] + v if k in metrics else v
    h = _final_norm(cfg, params, x)
    return h, (new_caches if mode != "train" else None), metrics, prefix


# --- head -----------------------------------------------------------------------

def _head_weight(cfg: ModelConfig, params) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"]["tokens"]        # (V, D) — used transposed
    return params["lm_head"].T                  # (V, D) view for same path


def _head_scale(cfg: ModelConfig) -> float:
    """Tied heads scale logits by 1/sqrt(D) (Gemma/T5 convention) so the
    N(0,1) embedding table doubles as a sanely-scaled unembedding."""
    return cfg.d_model ** -0.5 if cfg.tie_embeddings else 1.0


def _chunk_ce(h: torch.Tensor, w_vd: torch.Tensor, labels: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """Masked CE sum of one chunk; its (B, c, V) float32 logits live only
    here."""
    logits = (h @ w_vd.to(h.dtype).T).float()
    lse = torch.logsumexp(logits, dim=-1)
    corr = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return ((lse - corr) * mask).sum()


def _chunk_ce_tp(h: torch.Tensor, w_vd: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor, ctx: ParallelCtx) -> torch.Tensor:
    """:func:`_chunk_ce` where ``w_vd`` is this rank's block of V/T rows:
    the rank's (B, c, V/T) float32 logits, never gathered. The
    log-sum-exp shifts by the largest of the ranks' (B, c) maxima and
    adds their sums of exponentials, the label's logit comes from the
    rank that owns it, both by one ordered sum (identical on every
    rank)."""
    logits = (h @ w_vd.to(h.dtype).T).float()
    n = w_vd.shape[0]
    with torch.no_grad():          # the shift: lse does not depend on it
        top = tp.gather_max(logits.amax(-1), ctx)
    local = labels.long() - ctx.tensor_rank * n
    mine = (local >= 0) & (local < n)
    corr = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    sums = tp.ordered_sum(torch.stack([
        torch.exp(logits - top[..., None]).sum(-1),
        torch.where(mine, corr, 0.0)]), ctx)
    lse = top + torch.log(sums[0])
    return ((lse - sums[1]) * mask).sum()


def chunked_ce(h: torch.Tensor, w_vd: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor, chunk: int,
               ctx: Optional[ParallelCtx] = None,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy without holding the (B, S, V) logits.

    h (B, S, D), w_vd (V, D), labels (B, S) int, mask (B, S) float.
    S is padded to a multiple of ``min(chunk, S)`` as the reference pads
    it, and each chunk's CE runs under ``torch.utils.checkpoint`` when
    grad mode is on: backward keeps h and recomputes one chunk's logits
    at a time. Given ``ctx``, ``w_vd`` is this rank's block of the
    vocabulary (vocab-parallel): each chunk is :func:`_chunk_ce_tp`, and
    ``h`` is entered (``tp.enter``), so the ranks' partial gradients of
    h add up. Returns (sum_ce, sum_mask), float32."""
    b, s, _ = h.shape
    c = min(chunk, s)
    nc = -(-s // c)
    pad = nc * c - s
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    fn, extra = _chunk_ce, ()
    if ctx is not None:
        h, fn, extra = tp.enter(h, ctx), _chunk_ce_tp, (ctx,)
    for i in range(nc):
        sl = slice(i * c, (i + 1) * c)
        args = (h[:, sl], w_vd, labels[:, sl], mask[:, sl]) + extra
        if torch.is_grad_enabled():
            tot = tot + checkpoint(fn, *args, use_reentrant=False)
        else:
            tot = tot + fn(*args)
    return tot, mask.sum()


def loss_fn(cfg: ModelConfig, params, batch: Dict,
            ctx: Optional[ParallelCtx] = None,
            ) -> Tuple[torch.Tensor, Dict]:
    """Mean masked CE plus the MoE layers' aux losses. ``batch`` holds the
    model's inputs (tokens; frames for the audio frontend; patches and
    positions3 for the VLM one), labels (B, S_text) and optionally
    loss_mask (B, S_text); meta-token and patch positions carry no loss.
    Returns (loss, {"ce", "loss"} and the layers' metrics, aux_loss and
    dropped for an MoE model).

    Under a context, ``params`` are the rank's (``shard_params``) and
    ``batch`` its rows (``shard_batch``): the leaves outside the layers
    are gathered over ``data`` (``_gathered``), the loss is
    vocab-parallel where the rules split the vocabulary (the reference's
    §Perf H3: the logits stay on their rank), and the CE is the mean over
    the global batch: each data rank's masked sum and count added over
    ``data`` in rank order before the division (where every data rank
    holds the whole batch, its own mean, counted once, ``tp.once``).
    Every rank computes the same loss, bit for bit."""
    params = _gathered(cfg, params, ctx)
    h, _, metrics, prefix = forward_hidden(cfg, params, batch, "train",
                                           ctx=ctx)
    if prefix:
        h = h[:, prefix:]
    labels = torch.as_tensor(batch["labels"], device=h.device)
    mask = batch.get("loss_mask")
    mask = (torch.ones(labels.shape, dtype=torch.float32, device=h.device)
            if mask is None else
            torch.as_tensor(mask, device=h.device).float())
    w_vd = _head_weight(cfg, params)
    tot, cnt = chunked_ce(h * _head_scale(cfg), w_vd, labels, mask,
                          cfg.loss_chunk,
                          ctx if w_vd.shape[0] < cfg.vocab else None)
    if dp_size(ctx) > 1 and not ctx.batch_whole:
        tot, cnt = tp.ordered_sum(torch.stack([tot, cnt]), ctx, "data")
    ce = tot / cnt.clamp_min(1.0)
    if ctx is not None and ctx.batch_whole:
        ce = tp.once(ce, ctx)
    metrics["ce"] = ce
    loss = ce + metrics["aux_loss"] if "aux_loss" in metrics else ce
    metrics["loss"] = loss
    return loss, metrics


def logits_for(cfg: ModelConfig, params, h_last: torch.Tensor,
               ctx: Optional[ParallelCtx] = None) -> torch.Tensor:
    """(B, D) -> (B, V) float32 logits (decode head); a rank's block of
    the vocabulary's logits, gathered along V, where the head is
    vocab-parallel."""
    w = _head_weight(cfg, params)
    out = ((h_last * _head_scale(cfg)) @ w.to(h_last.dtype).T).float()
    return out if w.shape[0] == cfg.vocab else tp.gather_cat(out, -1, ctx)


# --- decode ---------------------------------------------------------------------

def _whole_batch(rows: int, ctx: Optional[ParallelCtx]) -> int:
    """The requests of the whole batch whose ``rows`` a rank holds."""
    if ctx is None or ctx.batch_whole:
        return rows
    return rows * ctx.data_size


def _whole_cache(spec: LayerSpec, batch: int, max_len: int,
                 dtype: torch.dtype = torch.float32) -> Dict:
    """One layer's whole decode cache as meta tensors (shapes only)."""
    return layer_init_cache(spec, batch, max_len, dtype,
                            torch.device("meta"))


def cache_blocks(cfg: ModelConfig, rows: int, max_len: Optional[int],
                 ctx: Optional[ParallelCtx]) -> List:
    """For each segment, this rank's block of its attention caches'
    length (``tp.LengthBlock``; None for a segment with no attention):
    ``cache_specs`` on the whole caches of the rank's ``rows`` requests
    (their data ranks' too) and ``max_len`` positions. Under a context
    whose caches' length may be cut, ``max_len`` is required (the rank's
    blocks do not tell the whole length); elsewhere it may be None."""
    out = []
    for spec, _ in cfg.plan:
        if spec.attn is None:
            out.append(None)
            continue
        name = "latent" if spec.attn.is_mla else "k"
        whole = _whole_cache(spec, _whole_batch(rows, ctx), max_len or 1)
        leaf = whole["attn"][name]
        if ctx is None or not any(
                ctx.mesh.shape[a] > 1 for a in length_axes(
                    name, tuple(leaf.shape), ctx.mesh)):
            out.append(None)
            continue
        if max_len is None:
            raise ValueError(
                f"{cfg.name} on mesh {ctx.mesh.shape}: the caches' length "
                "may be cut over the ranks; pass max_len")
        entry = cache_specs({name: leaf}, ctx.mesh)[name][1]
        out.append(tp.cache_block(entry, leaf.shape[1], ctx))
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: Union[str, torch.device] = "cuda",
               ctx: Optional[ParallelCtx] = None) -> List:
    """Per-segment lists of per-layer caches sized for ``max_len``
    absolute positions (meta tokens + prompt + generated); under a
    context, the rank's blocks (of its ``batch`` rows) that ``prefill``
    gives, as ``cache_specs`` lays them out."""
    dev = resolve_device(device)
    if ctx is None:
        return [[layer_init_cache(spec, batch, max_len, dtype, dev)
                 for _ in range(count)] for spec, count in cfg.plan]
    out = []
    for spec, count in cfg.plan:
        whole = _whole_cache(spec, _whole_batch(batch, ctx), max_len, dtype)
        specs = dict(_items(cache_specs(whole, ctx.mesh)))
        out.append([_map(lambda path, x: torch.zeros(
            shard_shape(tuple(x.shape), specs[path], ctx.mesh),
            dtype=x.dtype, device=dev), whole) for _ in range(count)])
    return out


def _ring_from_prefill(entry: torch.Tensor, window: int) -> torch.Tensor:
    """Full-sequence prefill K/V (B, S, ...) into the ring layout
    attn_decode expects (slot = position % window)."""
    s = entry.shape[1]
    if s >= window:
        return torch.roll(entry[:, s - window:], shifts=s % window, dims=1)
    return _pad_positions(entry, window)


def _pad_positions(entry: torch.Tensor, length: int) -> torch.Tensor:
    """(B, S, ...) zero-padded along S to ``length``."""
    s = entry.shape[1]
    if s > length:
        raise ValueError(f"{s} prefill positions do not fit a cache of "
                         f"{length}: raise max_len")
    pad = [0, 0] * (entry.dim() - 2) + [0, length - s]
    return F.pad(entry, pad)


def _cache_from_prefill(spec: LayerSpec, pre: Dict, max_len: int,
                        dtype: torch.dtype,
                        block: Optional[tp.LengthBlock] = None) -> Dict:
    """One layer's prefill cache entries (full-sequence) -> its decode
    cache layout: the whole ring or padded cache, then the rank's
    ``block`` of its length where the layout cuts it."""
    out = {}
    if "attn" in pre:
        a = pre["attn"]
        if spec.attn.is_mla:
            out["attn"] = {k: _pad_positions(a[k].to(dtype), max_len)
                           for k in ("latent", "k_rope")}
        elif spec.attn.window > 0:
            w = min(spec.attn.window, max_len)
            out["attn"] = {k: _ring_from_prefill(a[k].to(dtype), w)
                           for k in ("k", "v")}
        else:
            out["attn"] = {k: _pad_positions(a[k].to(dtype), max_len)
                           for k in ("k", "v")}
        if block is not None:
            out["attn"] = {k: v.narrow(1, block.start, block.size).clone()
                           for k, v in out["attn"].items()}
    if "ssm" in pre:
        out["ssm"] = pre["ssm"]        # states are already decode-shaped
    return out


def prefill(cfg: ModelConfig, params, batch: Dict, max_len: int,
            cache_dtype: torch.dtype = torch.bfloat16,
            ctx: Optional[ParallelCtx] = None,
            ) -> Tuple[torch.Tensor, List, int]:
    """Ingest the prompt (``batch`` as :func:`loss_fn` takes it, without
    labels). Returns (last-token logits, caches, next_index).

    ``max_len`` sizes the global attention caches (meta tokens + prompt +
    generated positions); the attention caches take ``cache_dtype``, the
    SSM caches keep the reference's types (conv tails in the model dtype,
    states in float32). Under a context each rank keeps its blocks of
    the caches as ``cache_specs`` lays them out: its rows, heads and
    channels, and its block of the slots where the layout cuts an
    attention cache's length (:func:`cache_blocks`)."""
    params = _gathered(cfg, params, ctx)
    h, pre, _, _ = forward_hidden(cfg, params, batch, "prefill", ctx=ctx)
    blocks = cache_blocks(cfg, h.shape[0], max_len, ctx)
    caches = [[_cache_from_prefill(spec, c, max_len, cache_dtype, blk)
               for c in seg]
              for (spec, _), seg, blk in zip(cfg.plan, pre, blocks)]
    logits = logits_for(cfg, params, h[:, -1], ctx)
    return logits, caches, h.shape[1]     # meta/prefix included


def decode_step(cfg: ModelConfig, params, token: torch.Tensor,
                caches: List, index: int, ctx: Optional[ParallelCtx] = None,
                max_len: Optional[int] = None,
                ) -> Tuple[torch.Tensor, List]:
    """token (B, 1) int at absolute position ``index`` (meta tokens
    counted). Returns ((B, V) logits, caches); the caches are updated in
    place. Under a context, ``token`` holds the rank's rows, and each
    attention layer learns its block of the cache's slots
    (:func:`cache_blocks`) from ``max_len``, the ``max_len`` the caches
    were made for, which a layout that may cut a cache's length
    requires."""
    params = _gathered(cfg, params, ctx)
    blocks = cache_blocks(cfg, token.shape[0], max_len, ctx)
    h = embed_tokens(params, token, cfg.dtype, ctx, cfg.vocab)
    for i, (spec, _) in enumerate(cfg.plan):
        h, caches[i], _ = segment_forward(params["segments"][i], h, spec,
                                          None, "decode", caches[i], index,
                                          ctx=ctx, block=blocks[i])
    h = _final_norm(cfg, params, h)
    return logits_for(cfg, params, h[:, -1], ctx), caches
