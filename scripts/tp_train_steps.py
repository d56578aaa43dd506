#!/usr/bin/env python3
"""``chip_smoke.py``'s tp-train steps alone on one NVIDIA card: the tp
phase's four rank processes with only its training steps, then their
kernels' rows timed as the times phase times them.

    python3 scripts/tp_train_steps.py [--seed 0]

Builds the flashattn and ssd libraries and starts ``TP_RANKS`` processes
of this script on ``cuda:0`` in a gloo group (``chip_smoke._run_ranks``).
Each runs ``chip_smoke.tp_rank`` with the tp phase's serving models
(``TP_SPECS``) and its dp-granite step left out, so only
``TP_TRAIN_SPECS`` run: granite-moe-1b-a400m, mamba2-370m and
hymba-1.5b at full width on ``make_host_mesh(model=4)``, then
granite-moe-1b-a400m on
``make_host_mesh(model=2)`` (dp-train-granite, a (2, 2) mesh), their
depth cut as ``TP_TRAIN_DEPTH_CUTS`` says. The parent applies the
phase's gates (``_check_tp_train``), which print each rank's step ms,
the seconds of each part of the step and its collectives by kind (the
backward's and the data axis's apart), and times
``ssd_fused/tp-train-mamba2``, ``ssd_fused/tp-train-hymba``,
``flash_attention/tp-train-granite``, ``flash_attention/tp-train-hymba``
and ``flash_attention/dp-train-granite`` at the ranks' own calls
(``_ssd_rows``, ``_flash_rows``). Every line names the card and its
power limit. Needs one CUDA card and nvcc; exits non-zero without a
card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    # the flags chip_smoke._run_ranks gives a rank
    for flag, kind in (("--ranks", int), ("--duration", float),
                       ("--collective-rank", int), ("--collective-port", int),
                       ("--collective-dir", str), ("--rank-role", str)):
        ap.add_argument(flag, type=kind, help=argparse.SUPPRESS)
    args = ap.parse_args()
    args.ranks, args.duration = args.ranks or 8, args.duration or 120.0
    import torch
    if not torch.cuda.is_available():
        print("tp_train_steps: no CUDA device", file=sys.stderr)
        return 2
    if args.collective_rank is not None:
        cs.TP_SPECS.clear()                       # no serving models
        cs.dp_serve = lambda *a, **k: ({}, {})     # no dp-granite step
        return cs.tp_rank(args)
    from repro_torch.kernels import _build
    card = cs.phase_card()
    cs.log(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    cs.log(f"build: nvcc seconds {_build.build_all(('flashattn', 'ssd'))}")
    for name in ("flashattn", "ssd"):
        _build.load(name)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    root = tempfile.mkdtemp(prefix="tp_train_steps_")
    seconds = cs._run_ranks(args, root, "tp", cs.TP_RANKS, 500,
                            script=__file__)
    recs = []
    for r in range(cs.TP_RANKS):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    cs.log(f"a backward through torch.mm(..., out_dtype=torch.float32): "
           f"{recs[0]['mm_out_dtype_grad']} [{card}]")
    shapes = {}
    for tag, spec in cs.TP_TRAIN_SPECS.items():
        cs._check_tp_train(recs, tag, card)
        saved = torch.load(os.path.join(root, f"{tag}_calls.pt"))
        for kname in spec["kernels"]:
            c_args, c_kw = saved[next(k for k in saved
                                      if k.startswith(kname))]
            shapes[f"{kname}/{tag}"] = (
                [a.to(dev) if hasattr(a, "to") else a for a in c_args], c_kw)
    cs.log(f"tp-train: {cs.TP_RANKS} ranks on cuda:0 over gloo, "
           f"{seconds:.1f}s [{card}]")
    rows = {}
    cs._ssd_rows(rows, shapes, ("ssd_fused/tp-train-mamba2",
                                "ssd_fused/tp-train-hymba"))
    cs._flash_rows(rows, shapes, ("flash_attention/tp-train-granite",
                                  "flash_attention/tp-train-hymba",
                                  "flash_attention/dp-train-granite"))
    for name, t in rows.items():
        cs.log(f"time {name}: {json.dumps(t, default=str)} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
