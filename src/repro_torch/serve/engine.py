"""Batched greedy serving engine, after ``repro/serve/engine.py``.

Prefill and decode run eagerly on the engine's device: no compilation
and no CUDA graph (a graph for the decode step is later work). Each step
is timed on the host clock around work that ends in a device
synchronisation and recorded in the paper's trace format.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..models.model import ModelConfig, decode_step, prefill
from ..telemetry import KIND_DECODE, KIND_PREFILL, TelemetryRecorder


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 4096          # absolute positions: meta + prompt + new
    max_new_tokens: int = 32
    cache_dtype: torch.dtype = torch.bfloat16


class ServeEngine:
    """Batched greedy decoding over a fixed-shape request batch."""

    def __init__(self, cfg: ModelConfig, params, serve_cfg: ServeConfig,
                 device: Union[str, torch.device] = "cuda",
                 telemetry: Optional[TelemetryRecorder] = None):
        self.device = resolve_device(device)
        self.cfg, self.params = cfg, params
        self.scfg = serve_cfg
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
        with self.telemetry.timed(0, KIND_PREFILL, 0):
            logits, caches, index = prefill(
                self.cfg, self.params, inputs, self.scfg.max_len,
                cache_dtype=self.scfg.cache_dtype)
            self._sync()
        tok = logits.argmax(-1)[:, None]
        out = [tok]
        for t in range(self.scfg.max_new_tokens - 1):
            # the caches are updated in place (the reference donates them
            # to its jitted decode step for the same effect)
            with self.telemetry.timed(0, KIND_DECODE, t):
                logits, caches = decode_step(self.cfg, self.params, tok,
                                             caches, index + t)
                self._sync()
            tok = logits.argmax(-1)[:, None]
            out.append(tok)
        return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()
