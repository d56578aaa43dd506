"""Training loop: data prefetch, the train step, telemetry, checkpoints,
auto-resume and the straggler monitor's hooks, after
``repro/train/trainer.py``.

Everything runs on ``device`` (the card by default): the step's kernels
(``ssd`` in every SSM and hybrid layer, ``flashattn`` in every attention
and hybrid layer, MLA's included), and the monitor's fences on the
``iqr`` kernel. Each step is timed by
``TelemetryRecorder.timed`` around work that ends by reading the loss
back, which waits for the device.

With ``mesh`` (``make_host_mesh(model=T)``: world / T data ranks and T
tensor ranks) every rank of the group runs this loop, holding its blocks
of the state (``step.init_state``). Every rank builds each step's global
batch, as the reference's single controller does (the pipeline's host
0 of 1; ``RunConfig.host`` and ``n_hosts`` keep their meaning for the
telemetry and for a run without a mesh), and the step takes the data
rank's rows of each microbatch. A checkpoint gathers each leaf whole in
rank order over both axes (exact, ``step.gather_state``) and rank 0
writes it: the file a one-rank run writes, so a run checkpointed on any
mesh resumes on any other (restore reads the whole state and keeps the
rank's blocks). Rank 0 alone writes ``metrics.jsonl`` and the telemetry
DBs; the monitor's checkpoint action is rank 0's, which every rank
follows.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from typing import Callable, Dict, Optional, Union

import torch

from ..core import group
from ..core.mesh import Mesh
from ..data.pipeline import DataConfig, Prefetcher
from ..device import resolve_device
from ..models.model import ModelConfig
from ..models.shardrules import make_ctx
from ..telemetry import (KIND_CKPT, KIND_TRAIN, StragglerMonitor,
                         TelemetryRecorder)
from .checkpoint import CheckpointManager
from .step import (TrainConfig, batch_to, gather_state, init_state,
                   make_train_step, shard_state, whole_template)


@dataclasses.dataclass
class RunConfig:
    steps: int = 100
    ckpt_every: int = 50               # <= 0: write no checkpoint at all
    monitor_every: int = 25
    log_every: int = 10
    workdir: str = os.path.join(tempfile.gettempdir(), "repro_torch_run")
    resume: bool = True
    async_ckpt: bool = True
    host: int = 0
    n_hosts: int = 1


class Trainer:
    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 data_cfg: DataConfig, run_cfg: RunConfig, seed: int = 0,
                 device: Union[str, torch.device] = "cuda",
                 mesh: Optional[Mesh] = None):
        self.device = resolve_device(device)
        self.mcfg, self.tcfg = model_cfg, train_cfg
        self.dcfg, self.rcfg = data_cfg, run_cfg
        self.seed = seed
        self.mesh, self.ctx = mesh, make_ctx(mesh)
        # the rank that writes the run's files
        self.lead = self.ctx is None or group._rank() == 0
        os.makedirs(run_cfg.workdir, exist_ok=True)
        self.ckpt = CheckpointManager(
            os.path.join(run_cfg.workdir, "ckpt"))
        self.telemetry = TelemetryRecorder(n_hosts=run_cfg.n_hosts,
                                           device=self.device)
        self.monitor = StragglerMonitor(on_action=self._on_monitor_action,
                                        device=self.device)
        self._log_path = os.path.join(run_cfg.workdir, "metrics.jsonl")
        self._monitor_actions = []
        self._want_ckpt = False

    def _on_monitor_action(self, action: str, report) -> None:
        self._monitor_actions.append((action, report))
        if action != "checkpoint":
            return
        if self.ctx is None:
            # protect progress immediately when variability spikes
            self.ckpt.save(self._state, int(self._state["step"]),
                           blocking=False)
        else:       # a save takes every rank: they follow rank 0's verdict
            self._want_ckpt = True

    def _save(self, state, step: int, blocking: bool) -> None:
        """Every rank gathers the whole state; rank 0 writes it."""
        whole = gather_state(self.mcfg, state, self.ctx)
        if self.lead:
            self.ckpt.save(whole, step, blocking=blocking)

    def _restore(self):
        if self.ctx is None:
            return self.ckpt.restore(init_state(self.mcfg, self.seed,
                                                self.device))
        whole = self.ckpt.restore(whole_template(self.mcfg, self.device))
        return shard_state(whole, self.ctx)

    def _log(self, step: int, metrics: Dict) -> None:
        row = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        with open(self._log_path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def run(self, progress: Optional[Callable[[int, Dict], None]] = None,
            ) -> Dict:
        r = self.rcfg
        start_step = 0
        if r.resume and self.ckpt.latest_step() is not None:
            state = self._restore()
            start_step = int(state["step"])
        else:
            state = init_state(self.mcfg, self.seed, self.device, self.mesh)

        step_fn = make_train_step(self.mcfg, self.tcfg, self.mesh)
        # on a mesh every rank builds the global batch
        host, n_hosts = (0, 1) if self.ctx is not None else (r.host,
                                                             r.n_hosts)
        prefetch = Prefetcher(self.mcfg, self.dcfg, start_step=start_step,
                              host=host, n_hosts=n_hosts)
        losses, saved = [], None
        try:
            for i in range(start_step, r.steps):
                t_wait0 = time.time_ns()
                _, batch = next(prefetch)
                stall_ns = time.time_ns() - t_wait0    # input-wait stall
                with self.telemetry.timed(r.host, KIND_TRAIN, i,
                                          stall_ns=stall_ns):
                    state, metrics = step_fn(state,
                                             batch_to(batch, self.device))
                    loss = float(metrics["loss"])      # waits for the device
                self._state = state
                losses.append(loss)
                if (i + 1) % r.log_every == 0:
                    if self.lead:
                        self._log(i, metrics)
                    if progress is not None:
                        progress(i, metrics)
                if r.ckpt_every > 0 and (i + 1) % r.ckpt_every == 0:
                    with self.telemetry.timed(r.host, KIND_CKPT, i):
                        self._save(state, i + 1, not r.async_ckpt)
                    saved = i + 1
                if (i + 1) % r.monitor_every == 0:
                    self._want_ckpt = False
                    self.monitor.analyze(self.telemetry)
                    if self.ctx is not None and group.broadcast(
                            self._want_ckpt):
                        self._save(state, int(state["step"]), False)
        finally:
            prefetch.close()
            self.ckpt.wait()

        # the final state, unless this run's last periodic save holds it
        if r.ckpt_every > 0 and saved != r.steps:
            self._save(state, r.steps, True)
        trace_dir = os.path.join(r.workdir, "telemetry")
        if self.lead:
            self.telemetry.write_dbs(trace_dir)
        return {"state": state, "losses": losses,
                "telemetry_dir": trace_dir,
                "monitor_actions": self._monitor_actions}
