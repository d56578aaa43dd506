"""Telemetry: the framework profiles ITSELF in the paper's trace format.

Every train/serve step on every host becomes a CUPTI-KERNEL-shaped event
(start/end ns, "device" = host id, memory_stall := time the step spent
blocked outside device compute — input wait, checkpoint stalls); data
movement (host input feed, checkpoint writes) becomes MEMCPY-shaped
events. Traces serialize to the exact SQLite schema of core.events, so the
paper's two-phase pipeline (generation → aggregation → IQR) runs on the
framework's own logs unchanged — the closed loop that turns the paper's
offline analysis into an ONLINE straggler/variability monitor at scale
(one profiling rank per host; 1000+ nodes ⇒ 1000+ rank DBs, which is
exactly the regime the sharded pipeline exists for).

The GPU inventory of each trace describes the device the recorder was
given, as ``torch.cuda.get_device_properties`` reports it.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..core.events import (COPY_H2D, EventTable, GpuInfo, RankTrace,
                           write_rank_db)
from ..device import resolve_device

KIND_TRAIN = 0
KIND_PREFILL = 1
KIND_DECODE = 2
KIND_CKPT = 3
KIND_DATA = 4


@dataclasses.dataclass
class StepEvent:
    host: int
    start_ns: int
    end_ns: int
    kind: int               # KIND_*
    stall_ns: float         # blocked-on-input/io time inside the step
    step: int


def gpu_info(device: torch.device, gpu_id: int = 0) -> GpuInfo:
    """The trace's inventory row for ``device``: name, memory, SM count and
    compute capability from the CUDA properties (the properties carry no
    memory bandwidth, so it is 0); a CPU has a row of zeros."""
    if device.type != "cuda":
        return GpuInfo(id=gpu_id, name="cpu", bandwidth=0, memory=0,
                       sm_count=0, cc_major=0, cc_minor=0)
    props = torch.cuda.get_device_properties(device)
    return GpuInfo(id=gpu_id, name=props.name, bandwidth=0,
                   memory=int(props.total_memory),
                   sm_count=int(props.multi_processor_count),
                   cc_major=int(props.major), cc_minor=int(props.minor))


class TelemetryRecorder:
    """In-memory event log; one logical 'profiling rank' per host."""

    def __init__(self, n_hosts: int = 1,
                 device: Union[str, torch.device] = "cuda"):
        self.n_hosts = n_hosts
        self.device = resolve_device(device)
        self.steps: List[StepEvent] = []
        self.copies: List[Dict] = []        # memcpy-shaped rows

    # -- recording ---------------------------------------------------------
    def record_step(self, host: int, start_ns: int, end_ns: int,
                    kind: int, stall_ns: float, step: int) -> None:
        self.steps.append(StepEvent(host, start_ns, end_ns, kind,
                                    stall_ns, step))

    def record_copy(self, host: int, start_ns: int, end_ns: int,
                    nbytes: int, direction: int = COPY_H2D) -> None:
        self.copies.append(dict(host=host, start=start_ns, end=end_ns,
                                bytes=nbytes, kind=direction))

    def timed(self, host: int, kind: int, step: int,
              stall_ns: float = 0.0) -> "_Timed":
        """Context manager: times a step and records it."""
        return _Timed(self, host, kind, step, stall_ns)

    # -- export to the paper's trace format ---------------------------------
    def rank_trace(self, host: int) -> RankTrace:
        ev = [e for e in self.steps if e.host == host]
        n = len(ev)
        kernels = EventTable(
            start=np.array([e.start_ns for e in ev], np.int64),
            end=np.array([e.end_ns for e in ev], np.int64),
            device=np.full(n, host, np.int32),
            stream=np.array([e.kind for e in ev], np.int32),
            memory_stall=np.array([e.stall_ns for e in ev], np.float32),
            bytes=np.zeros(n, np.int64),
            copy_kind=np.zeros(n, np.int32),
            name_id=np.array([e.step for e in ev], np.int32),
            kind=np.zeros(n, np.int32))
        cp = [c for c in self.copies if c["host"] == host]
        m = len(cp)
        memcpys = EventTable(
            start=np.array([c["start"] for c in cp], np.int64),
            end=np.array([c["end"] for c in cp], np.int64),
            device=np.full(m, host, np.int32),
            stream=np.zeros(m, np.int32),
            memory_stall=np.zeros(m, np.float32),
            bytes=np.array([c["bytes"] for c in cp], np.int64),
            copy_kind=np.array([c["kind"] for c in cp], np.int32),
            name_id=np.zeros(m, np.int32),
            kind=np.ones(m, np.int32))
        gpus = [gpu_info(self.device, host)]
        return RankTrace(rank=host, kernels=kernels.sort_by_start(),
                         memcpys=memcpys.sort_by_start(), gpus=gpus)

    def write_dbs(self, out_dir: str) -> List[str]:
        """One Nsight-shaped SQLite DB per host (paper layout)."""
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for h in range(self.n_hosts):
            p = os.path.join(out_dir, f"rank{h}.sqlite")
            write_rank_db(p, self.rank_trace(h))
            paths.append(p)
        return paths

    def step_durations(self, host: Optional[int] = None) -> np.ndarray:
        ev = [e for e in self.steps
              if (host is None or e.host == host)]
        return np.array([(e.end_ns - e.start_ns) for e in ev], np.float64)


class _Timed:
    def __init__(self, rec: TelemetryRecorder, host: int, kind: int,
                 step: int, stall_ns: float):
        self.rec, self.host, self.kind = rec, host, kind
        self.step, self.stall_ns = step, stall_ns

    def __enter__(self):
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.rec.record_step(self.host, self.t0, time.time_ns(),
                             self.kind, self.stall_ns, self.step)
