"""Serving CLI::

    python -m repro_torch.launch.serve --arch <id> [--smoke]
        [--device cuda] [--batch 4] [--prompt-len 32] [--new-tokens 16]
        [--max-len N]

``<id>`` is any decoder of ``repro_torch.configs.ARCH_NAMES``
(hubert-xlarge is encoder-only and has no decode). Batched greedy
generation with telemetry on the card (``--device cpu`` runs the plain
versions on the host). Prompts and weights are random, made from
``--seed``; for qwen2-vl-7b the prompt is a 16 x 16 grid of random patch
embeddings (smoke: 4 x 4) before ``--prompt-len`` text tokens, with
M-RoPE ids (0, row, col) for a patch and (i, i, i) for the text token at
absolute position i, as decode continues them. ``--max-len`` counts
absolute positions (meta tokens + patches + prompt + generated) and
defaults to exactly that many. Prints the generated tokens and the step
times.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np

from ..configs import get_config, get_smoke_config
from ..models.model import ModelConfig
from ..models.model import init_params
from ..serve import ServeConfig, ServeEngine
from ..telemetry import KIND_DECODE, KIND_PREFILL


def vlm_inputs(cfg: ModelConfig, rng: np.random.Generator, batch: int,
               grid: int, prompt_len: int) -> Dict[str, np.ndarray]:
    """Random patch embeddings of a ``grid`` x ``grid`` image and the
    M-RoPE ids of the patches and of ``prompt_len`` text tokens after
    them: (t, h, w) = (0, row, col) for a patch, (i, i, i) for the text
    token at absolute position i, the ids decode gives it."""
    n = grid * grid
    patches = rng.normal(0, 1, (batch, n, cfg.frontend_dim)).astype(
        np.float32)
    rows, cols = np.divmod(np.arange(n), grid)
    txt = np.arange(n, n + prompt_len)
    pos = np.concatenate([np.stack([np.zeros(n, np.int64), rows, cols]),
                          np.stack([txt, txt, txt])], axis=1)
    return {"patches": patches,
            "positions3": np.broadcast_to(pos, (batch, 3, n + prompt_len)
                                          ).copy()}


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=0,
                    help="cache positions (0: meta + prompt + new tokens)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    if not cfg.decode_supported:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode")
    rng = np.random.default_rng(args.seed)
    batch: Dict[str, np.ndarray] = {}
    if cfg.frontend == "vlm":
        batch = vlm_inputs(cfg, rng, args.batch, 4 if args.smoke else 16,
                           args.prompt_len)
    prefix = cfg.meta_tokens + (batch["patches"].shape[1]
                                if "patches" in batch else 0)
    need = prefix + args.prompt_len + args.new_tokens
    params = init_params(cfg, args.seed, args.device)
    engine = ServeEngine(
        cfg, params,
        ServeConfig(max_len=args.max_len or need,
                    max_new_tokens=args.new_tokens,
                    cache_dtype=cfg.dtype), device=args.device)
    batch["tokens"] = rng.integers(0, cfg.vocab,
                                   (args.batch, args.prompt_len))
    toks = engine.generate(batch)
    print(f"generated {toks.shape} on {engine.device}:")
    for row in toks[: min(4, toks.shape[0])]:
        print("  ", row.tolist())
    steps = engine.telemetry.steps
    pre = [(e.end_ns - e.start_ns) / 1e6 for e in steps
           if e.kind == KIND_PREFILL]
    dec = [(e.end_ns - e.start_ns) / 1e6 for e in steps
           if e.kind == KIND_DECODE]
    print(f"prefill {pre[0]:.2f} ms; decode {len(dec)} steps, median "
          f"{np.median(dec) if dec else float('nan'):.2f} ms/token")


if __name__ == "__main__":
    main()
