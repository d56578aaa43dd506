"""Batched greedy serving engine, after ``repro/serve/engine.py``.

Prefill and decode run eagerly on the engine's device: no compilation
and no CUDA graph (a graph for the decode step is later work). Each step
is timed on the host clock around work that ends in a device
synchronisation and recorded in the paper's trace format.

With a ``mesh`` (``repro_torch.launch.mesh.make_host_mesh(model=T)``,
a ``(world / T, T)`` mesh on ``("data", "model")``), every rank of the
default process group builds the engine on the same full parameters and
calls ``generate`` on the same batch (SPMD, one process a rank). The
engine keeps only the rank's shards (``shard_params``: the ``fsdp``
dims cut over ``data``, gathered at use) and serves its data rank's
rows of the batch (``shard_batch``; all of them where the requests do
not divide over the data ranks), its caches holding those rows and the
blocks ``cache_specs`` gives it. Each layer runs tensor-parallel over
the ``model`` axis (``repro_torch.models.tp``): attention and MLA on the
rank's heads (heads T does not divide whole on every rank), the FFN on
its hidden columns, the SSM on its heads (all of them, on its block of
channels, where T does not divide them), the MoE on its experts (``ep``
in prefill, ``replicated`` in decode, ``repro_torch.models.moe``).
Where the KV heads do not divide over ``model`` or the requests over
``data``, the freed axes cut the attention caches' length: each rank
holds a block of the slots and decode merges the blocks' softmax
partials (``tp.softmax_merge``), so hymba-1.5b serves at T = 4 and a
single request on a data axis of two. The tokens are gathered over
``data`` in order, so every rank returns the whole batch's. A layout the
port does not cover raises in the constructor on every rank, and a batch
that differs between ranks raises in ``generate`` on every rank before
the first collective.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..core.group import agree
from ..device import resolve_device
from ..core.mesh import Mesh
from ..models import tp
from ..models.model import ModelConfig, decode_step, prefill
from ..models.shardrules import make_ctx, shard_batch, shard_params
from ..telemetry import KIND_DECODE, KIND_PREFILL, TelemetryRecorder


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 4096          # absolute positions: meta + prompt + new
    max_new_tokens: int = 32
    cache_dtype: torch.dtype = torch.bfloat16


def _batch_digest(inputs: Dict[str, torch.Tensor]):
    """(key, shape, dtype, sha256 of the bytes) of each input."""
    out = []
    for k in sorted(inputs):
        t = inputs[k].detach().cpu().contiguous()
        out.append((k, tuple(t.shape), str(t.dtype), hashlib.sha256(
            t.view(torch.uint8).numpy().tobytes()).hexdigest()))
    return out


class ServeEngine:
    """Batched greedy decoding over a fixed-shape request batch; on a
    ``mesh``, tensor-parallel across its ranks."""

    def __init__(self, cfg: ModelConfig, params, serve_cfg: ServeConfig,
                 device: Union[str, torch.device] = "cuda",
                 telemetry: Optional[TelemetryRecorder] = None,
                 mesh: Optional[Mesh] = None):
        self.device = resolve_device(device)
        self.cfg, self.scfg, self.mesh = cfg, serve_cfg, mesh
        self.ctx = make_ctx(mesh)
        for spec, _ in cfg.plan:
            tp.check_layer(spec, self.ctx)
        self.params = shard_params(params, self.ctx)
        self.telemetry = telemetry or TelemetryRecorder(device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def generate(self, batch: Dict) -> np.ndarray:
        """Greedy-decode max_new_tokens for each request in the batch;
        ``batch["tokens"]`` is a (B, S) integer array or tensor, and a VLM
        batch also brings ``patches`` (B, P, frontend_dim) and
        ``positions3`` (B, 3, P + S)."""
        inputs = {k: torch.as_tensor(batch[k], device=self.device)
                  for k in ("tokens", "patches", "positions3") if k in batch}
        if self.ctx is not None:        # before any rank can raise alone
            agree("serving batches", _batch_digest(inputs) + [
                self.scfg.max_len, self.scfg.max_new_tokens])
        prefix = self.cfg.meta_tokens
        if "patches" in inputs:
            prefix += inputs["patches"].shape[1]
        tokens = inputs["tokens"]
        need = prefix + tokens.shape[1] + self.scfg.max_new_tokens - 1
        if need > self.scfg.max_len:
            raise ValueError(
                f"max_len {self.scfg.max_len} does not cover {need} "
                f"positions ({prefix} meta and patch + "
                f"{tokens.shape[1]} prompt + {self.scfg.max_new_tokens - 1}"
                " decoded)")
        rows, ctx = shard_batch(inputs, self.ctx)
        with self.telemetry.timed(0, KIND_PREFILL, 0):
            logits, caches, index = prefill(
                self.cfg, self.params, rows, self.scfg.max_len,
                cache_dtype=self.scfg.cache_dtype, ctx=ctx)
            self._sync()
        tok = logits.argmax(-1)[:, None]
        out = [tok]
        for t in range(self.scfg.max_new_tokens - 1):
            # the caches are updated in place (the reference donates them
            # to its jitted decode step for the same effect)
            with self.telemetry.timed(0, KIND_DECODE, t):
                logits, caches = decode_step(self.cfg, self.params, tok,
                                             caches, index + t, ctx,
                                             self.scfg.max_len)
                self._sync()
            tok = logits.argmax(-1)[:, None]
            out.append(tok)
        out = torch.cat(out, dim=1).to(torch.int32)
        if ctx is not None and not ctx.batch_whole:
            out = tp.rows_gather(out, ctx)    # the data ranks' requests
        return out.cpu().numpy()
