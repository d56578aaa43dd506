"""Synthetic data pipeline: deterministic, restart-safe, host-sharded.

Every batch is a pure function of (seed, step, host) via Philox counter
streams, so (i) auto-resume regenerates the EXACT token stream after a
crash without any data-loader state in the checkpoint, and (ii) each host
of a multi-host job materializes only its slice of the global batch.

The synthetic LM stream is Zipf-distributed tokens with short-range
repetition structure (so the loss has signal to minimize), plus the
frontend variants (audio frames / vision patches) the stub archs need.
A background-thread prefetcher overlaps generation with the device step.

A copy of ``repro/data/pipeline.py``: numpy only, the same bytes for
every (seed, step, host). hubert-xlarge takes the audio branch,
qwen2-vl-7b the VLM one, the other configs the LM branch.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np

from ..models.model import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int
    seq: int
    seed: int = 1234
    vlm_patches: int = 64          # vision prefix length for VLM archs
    mask_fraction: float = 0.35    # masked-prediction fraction (audio)


def _rng(cfg: DataConfig, step: int, host: int) -> np.random.Generator:
    return np.random.Generator(
        np.random.Philox(key=cfg.seed, counter=[step, host, 0, 0]))


def _lm_tokens(rng, b: int, s: int, vocab: int) -> np.ndarray:
    """Zipf tokens with local copy structure (learnable bigrams)."""
    base = rng.zipf(1.3, size=(b, s + 1)) % vocab
    # inject determinism: every token at even index repeats 3 ahead
    base[:, 3:][:, ::2] = base[:, :-3][:, ::2]
    return base.astype(np.int32)


def make_batch(model_cfg: ModelConfig, cfg: DataConfig, step: int,
               host: int = 0, n_hosts: int = 1) -> Dict[str, np.ndarray]:
    """One host's slice of the global batch for this step."""
    assert cfg.batch % n_hosts == 0
    b = cfg.batch // n_hosts
    s = cfg.seq
    rng = _rng(cfg, step, host)

    if model_cfg.frontend == "audio":
        frames = rng.normal(0, 1, size=(b, s, model_cfg.frontend_dim)
                            ).astype(np.float32)
        labels = rng.integers(0, model_cfg.vocab, (b, s)).astype(np.int32)
        mask = (rng.random((b, s)) < cfg.mask_fraction).astype(np.float32)
        # make it learnable: frames correlate with their unit label
        frames[..., 0] = labels / model_cfg.vocab
        return {"frames": frames, "labels": labels, "loss_mask": mask}

    if model_cfg.frontend == "vlm":
        p = min(cfg.vlm_patches, s - 1)
        st = s - p
        toks = _lm_tokens(rng, b, st, model_cfg.vocab)
        patches = rng.normal(0, 1, size=(b, p, model_cfg.frontend_dim)
                             ).astype(np.float32)
        total = s + model_cfg.meta_tokens
        pos3 = np.broadcast_to(np.arange(total, dtype=np.int32)[None, None],
                               (b, 3, total)).copy()
        return {"patches": patches, "tokens": toks[:, :-1],
                "labels": toks[:, 1:], "positions3": pos3}

    toks = _lm_tokens(rng, b, s, model_cfg.vocab)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class Prefetcher:
    """Background-thread batch generation (overlaps with device compute)."""

    def __init__(self, model_cfg: ModelConfig, cfg: DataConfig,
                 start_step: int = 0, host: int = 0, n_hosts: int = 1,
                 depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def work():
            step = start_step
            while not self._stop.is_set():
                batch = make_batch(model_cfg, cfg, step, host, n_hosts)
                while not self._stop.is_set():
                    try:
                        self._q.put((step, batch), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        """Stop the worker and wait for it (it notices within 0.1 s)."""
        self._stop.set()
        self._thread.join()
