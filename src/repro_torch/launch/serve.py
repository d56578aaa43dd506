"""Serving CLI::

    python -m repro_torch.launch.serve --arch mamba2-370m|hymba-1.5b
        [--smoke] [--device cuda] [--batch 4] [--prompt-len 32]
        [--new-tokens 16] [--max-len N]

Batched greedy generation with telemetry on the card (``--device cpu``
runs the plain versions on the host). Prompts and weights are random,
made from ``--seed``. ``--max-len`` counts absolute positions (hymba's
meta tokens + prompt + generated) and defaults to exactly that many.
Prints the generated tokens and the step times.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from ..configs import get_config, get_smoke_config
from ..models.model import init_params
from ..serve import ServeConfig, ServeEngine
from ..telemetry import KIND_DECODE, KIND_PREFILL


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
    need = cfg.meta_tokens + args.prompt_len + args.new_tokens
    params = init_params(cfg, args.seed, args.device)
    engine = ServeEngine(
        cfg, params,
        ServeConfig(max_len=args.max_len or need,
                    max_new_tokens=args.new_tokens,
                    cache_dtype=cfg.dtype), device=args.device)
    rng = np.random.default_rng(args.seed)
    toks = engine.generate({"tokens": rng.integers(
        0, cfg.vocab, (args.batch, args.prompt_len))})
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
