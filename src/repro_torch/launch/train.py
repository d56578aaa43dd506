"""Training CLI::

    python -m repro_torch.launch.train --arch ARCH
        [--smoke] [--device cuda] [--steps 100] [--batch 8] [--seq 64]
        [--lr 3e-3] [--grad-accum 1] [--workdir DIR]

``ARCH`` is any of the ten architectures: mamba2-370m, hymba-1.5b,
stablelm-3b, h2o-danube-1.8b, nemotron-4-15b, starcoder2-15b,
granite-moe-1b-a400m, qwen2-vl-7b, hubert-xlarge and deepseek-v2-236b.
Trains on the card (``--device cpu`` runs the plain versions on the
host), after ``repro/launch/train.py``: synthetic data from the pipeline
(audio frames and a loss mask for hubert-xlarge, image patches and
M-RoPE positions for qwen2-vl-7b), AdamW, periodic asynchronous
checkpoints with auto-resume from ``--workdir``, and the straggler
monitor on the run's own step telemetry. A full config must fit the card
at 20 B a parameter of training state (the 15 B models and
deepseek-v2-236b do not; ``--smoke`` fits anywhere).
``--production-mesh`` trains on the reference's (16, 16) mesh: run in
each of the 256 processes of a default process group (started by the
caller, or from the ``torchrun`` environment), and raises a
``ValueError`` on a group of another size; it takes all ten
architectures, heads that T does not divide included. Training on any
``(D, T)`` mesh is ``Trainer(..., mesh=make_host_mesh(model=T))`` in
each rank's process.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence

import torch.distributed as dist

from ..configs import ARCH_NAMES, get_config, get_smoke_config
from ..core.group import _world_size
from ..data.pipeline import DataConfig
from ..device import resolve_device
from ..train import AdamWConfig, RunConfig, TrainConfig, Trainer
from .mesh import PRODUCTION, make_production_mesh


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=ARCH_NAMES,
                    help="one of the ten architectures")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--production-mesh", action="store_true",
                    help="train on the (16, 16) mesh of a 256-rank group")
    args = ap.parse_args(argv)
    mesh = None
    if args.production_mesh:
        if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
            dist.init_process_group("gloo")
        need = PRODUCTION[0] * PRODUCTION[1]
        if _world_size() != need:
            raise ValueError(
                f"--production-mesh: the {PRODUCTION} mesh takes a process "
                f"group of {need} ranks, and this one has {_world_size()}")
        mesh = make_production_mesh()
        if args.device == "cuda" and "LOCAL_RANK" in os.environ:
            args.device = f"cuda:{os.environ['LOCAL_RANK']}"
    device = resolve_device(args.device)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    tcfg = TrainConfig(
        optim=AdamWConfig(peak_lr=args.lr, warmup_steps=args.steps // 10,
                          total_steps=args.steps),
        grad_accum=args.grad_accum)
    dcfg = DataConfig(batch=args.batch, seq=args.seq)
    rcfg = RunConfig(steps=args.steps, workdir=args.workdir,
                     ckpt_every=max(args.steps // 2, 1),
                     monitor_every=max(args.steps // 4, 1))
    trainer = Trainer(cfg, tcfg, dcfg, rcfg, device=device, mesh=mesh)
    res = trainer.run(progress=lambda i, m: print(
        f"step {i}: loss={float(m['loss']):.4f} "
        f"gnorm={float(m['grad_norm']):.3f}"))
    last = res["losses"][-1] if res["losses"] else float("nan")
    print(f"final loss {last:.4f} on {device}; "
          f"telemetry -> {res['telemetry_dir']}")


if __name__ == "__main__":
    main()
