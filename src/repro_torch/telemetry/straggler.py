"""Straggler / variability monitor — the paper's technique as an ONLINE
fault-tolerance subsystem.

Exactly the paper's phase-2 machinery (time-binned moments + IQR fences),
pointed at the framework's own step telemetry:

  * per-HOST detection: a host whose mean step time exceeds the Tukey
    upper fence across hosts is a straggler (hardware rot, thermal
    throttle, noisy neighbour) → candidate for replacement/rebalancing;
  * per-WINDOW detection: time bins whose cross-host stall metric spikes
    (co-occurring slowdowns — the paper's Fig-1a finding) → global events
    (checkpoint stalls, network congestion) rather than single bad hosts.

Actions escalate: warn → checkpoint-now (protect progress before a
suspected failure) → rebalance (re-shard away from the straggler). The
monitor only ever consumes O(n_bins) statistics — raw events stay on
their host, the paper's core scalability property.

A copy of ``repro/telemetry/straggler.py`` with an explicit ``device``:
both fences run ``core.anomaly.iqr_detect`` there, which on the card is
the ``iqr`` kernel in float64 (equal to the reference's numpy fences bit
for bit); the binning (``bin_samples``) stays numpy, as in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from ..core.aggregation import bin_samples
from ..core.anomaly import iqr_detect
from ..core.sharding import ShardPlan
from ..device import resolve_device

from .recorder import TelemetryRecorder

ACTION_NONE = "none"
ACTION_WARN = "warn"
ACTION_CHECKPOINT = "checkpoint"
ACTION_REBALANCE = "rebalance"


@dataclasses.dataclass
class StragglerReport:
    straggler_hosts: List[int]
    host_means_ns: np.ndarray
    hi_fence_ns: float
    anomalous_windows: np.ndarray       # (k, 2) ns
    action: str


@dataclasses.dataclass
class MonitorConfig:
    iqr_k: float = 1.5
    top_k: int = 5
    interval_ns: int = 1_000_000_000
    # escalation thresholds (fraction of hosts flagged)
    warn_frac: float = 0.0
    ckpt_frac: float = 0.05
    rebalance_frac: float = 0.15


class StragglerMonitor:
    def __init__(self, cfg: Optional[MonitorConfig] = None,
                 on_action: Optional[Callable[[str, StragglerReport],
                                              None]] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg or MonitorConfig()
        self.on_action = on_action
        self.device = resolve_device(device)

    def analyze(self, rec: TelemetryRecorder) -> StragglerReport:
        cfg = self.cfg
        # --- per-host IQR over mean step durations -------------------------
        means = np.array([
            rec.step_durations(h).mean() if len(rec.step_durations(h))
            else 0.0
            for h in range(rec.n_hosts)])
        rep = iqr_detect(means, k=cfg.iqr_k, top_k=rec.n_hosts,
                         device=self.device)
        stragglers = [int(i) for i in np.nonzero(rep.flags)[0]]

        # --- per-window IQR over the binned stall metric --------------------
        windows = np.zeros((0, 2), np.int64)
        if rec.steps:
            starts = np.array([e.start_ns for e in rec.steps], np.int64)
            durs = np.array([e.end_ns - e.start_ns for e in rec.steps],
                            np.float64)
            t0, t1 = int(starts.min()), int(starts.max()) + 1
            plan = ShardPlan.from_interval(t0, t1, cfg.interval_ns)
            stats = bin_samples(starts, durs, plan)
            win = iqr_detect(stats.mean, k=cfg.iqr_k, top_k=cfg.top_k,
                             boundaries=plan.boundaries(),
                             device=self.device)
            windows = win.top_windows

        frac = len(stragglers) / max(rec.n_hosts, 1)
        if frac > cfg.rebalance_frac:
            action = ACTION_REBALANCE
        elif frac > cfg.ckpt_frac:
            action = ACTION_CHECKPOINT
        elif stragglers or len(windows):
            action = ACTION_WARN
        else:
            action = ACTION_NONE

        report = StragglerReport(
            straggler_hosts=stragglers, host_means_ns=means,
            hi_fence_ns=rep.hi_fence, anomalous_windows=windows,
            action=action)
        if self.on_action is not None and action != ACTION_NONE:
            self.on_action(action, report)
        return report
