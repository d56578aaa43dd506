"""The port's straggler monitor against the JAX package's on the CPU.

The four straggler cases of ``tests/test_telemetry.py`` run on the port;
then both monitors read the same step events, and the straggler hosts,
the host means, the upper fence (float64, bit for bit: the port's
``iqr_detect`` equals ``np.percentile``), the anomalous windows and the
action must be equal. The telemetry a port trainer writes runs through
the port's pipeline.
"""

import numpy as np
import pytest
import torch

from repro.telemetry import MonitorConfig as RefMonitorConfig
from repro.telemetry import StragglerMonitor as RefStragglerMonitor
from repro.telemetry import TelemetryRecorder as RefTelemetryRecorder
from repro_torch.configs import get_smoke_config
from repro_torch.core import (GenerationConfig, PipelineConfig,
                              VariabilityPipeline, recovered)
from repro_torch.data import DataConfig
from repro_torch.telemetry import (ACTION_CHECKPOINT, ACTION_NONE,
                                   KIND_TRAIN, MonitorConfig,
                                   StragglerMonitor, TelemetryRecorder)
from repro_torch.train import RunConfig, TrainConfig, Trainer

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size tensors gain nothing from torch's intra-op threads, and
    in a loaded parallel run those threads wait on each other: a
    mamba2-smoke trainer took 77 s instead of 6 with the CPUs busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _synthetic_run(n_hosts=8, steps=60, slow_host=3, slow_factor=4.0,
                   stall_window=(20, 25), recorder=None, seed=None):
    """tests/test_telemetry.py's run; with ``seed``, each step's duration
    also carries up to 5% of seeded jitter."""
    rec = recorder or TelemetryRecorder(n_hosts=n_hosts, device=CPU)
    rng = np.random.default_rng(seed) if seed is not None else None
    t = 1_000_000_000_000
    step_ns = 50_000_000
    for i in range(steps):
        for h in range(n_hosts):
            d = step_ns
            if h == slow_host:
                d = int(step_ns * slow_factor)
            if rng is not None:
                d = int(d * (1 + 0.05 * rng.random()))
            stall = d * 0.02            # baseline input-wait jitter
            if stall_window[0] <= i < stall_window[1]:
                d = int(d * 3)
                stall = d * 0.8
            rec.record_step(h, t, t + d, KIND_TRAIN, stall, i)
        t += int(step_ns * 1.1)
    return rec


def test_straggler_host_flagged():
    rep = StragglerMonitor(device=CPU).analyze(_synthetic_run())
    assert 3 in rep.straggler_hosts
    assert rep.action != ACTION_NONE


def test_healthy_run_not_flagged():
    rec = _synthetic_run(slow_factor=1.0, stall_window=(0, 0))
    rep = StragglerMonitor(device=CPU).analyze(rec)
    assert rep.straggler_hosts == []
    assert rep.action == ACTION_NONE


def test_anomalous_windows_found():
    rep = StragglerMonitor(MonitorConfig(interval_ns=200_000_000),
                           device=CPU).analyze(_synthetic_run())
    assert len(rep.anomalous_windows) > 0


def test_action_escalation():
    fired = []
    mon = StragglerMonitor(
        MonitorConfig(ckpt_frac=0.05, rebalance_frac=0.5),
        on_action=lambda a, r: fired.append(a), device=CPU)
    rep = mon.analyze(_synthetic_run(n_hosts=8, slow_host=2))
    assert rep.action in ("checkpoint", "warn")
    assert fired and fired[0] == rep.action


SCENARIOS = {
    "slow-host": dict(),
    "healthy": dict(slow_factor=1.0, stall_window=(0, 0)),
    "stall-only": dict(slow_factor=1.0),
    "jitter-3x": dict(slow_factor=3.0, seed=11),
    "many-hosts": dict(n_hosts=40, slow_host=17, seed=5, steps=30),
    "one-host": dict(n_hosts=1, slow_host=0, seed=2),
}


@pytest.mark.parametrize("interval_ns", [1_000_000_000, 200_000_000])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_monitor_equals_reference(name, interval_ns):
    kw = SCENARIOS[name]
    n_hosts = kw.get("n_hosts", 8)
    rec = _synthetic_run(**kw)
    rec_r = _synthetic_run(**kw, recorder=RefTelemetryRecorder(n_hosts))
    fired, fired_r = [], []
    rep = StragglerMonitor(MonitorConfig(interval_ns=interval_ns),
                           on_action=lambda a, r: fired.append(a),
                           device=CPU).analyze(rec)
    rep_r = RefStragglerMonitor(RefMonitorConfig(interval_ns=interval_ns),
                                on_action=lambda a, r: fired_r.append(a)
                                ).analyze(rec_r)
    assert rep.straggler_hosts == rep_r.straggler_hosts
    np.testing.assert_array_equal(rep.host_means_ns, rep_r.host_means_ns)
    assert rep.hi_fence_ns == rep_r.hi_fence_ns          # bit for bit
    np.testing.assert_array_equal(rep.anomalous_windows,
                                  rep_r.anomalous_windows)
    assert rep.action == rep_r.action and fired == fired_r


def test_monitor_takes_an_explicit_device():
    assert StragglerMonitor(device=CPU).device == torch.device("cpu")
    with pytest.raises(ValueError):
        StragglerMonitor(device="mps")


def test_trainer_checkpoints_at_once_on_the_checkpoint_action(tmp_path):
    cfg = get_smoke_config("mamba2-370m")
    tr = Trainer(cfg, TrainConfig(), DataConfig(batch=2, seq=8),
                 RunConfig(steps=1, workdir=str(tmp_path)), device=CPU)
    from repro_torch.train import init_state
    tr._state = init_state(cfg, device=CPU)
    tr._state["step"] += 5
    tr._on_monitor_action(ACTION_CHECKPOINT, None)
    tr.ckpt.wait()
    assert tr.ckpt.all_steps() == [5]
    assert tr._monitor_actions[0][0] == ACTION_CHECKPOINT


def test_telemetry_exports_paper_format_and_pipeline_runs(tmp_path):
    """tests/test_telemetry.py's round trip on the port: telemetry ->
    Nsight-shaped SQLite -> the port's two-phase pipeline -> anomalous
    windows recover the injected stall."""
    rec = _synthetic_run(n_hosts=4, steps=80, stall_window=(30, 36))
    dbs = rec.write_dbs(str(tmp_path / "traces"))
    assert len(dbs) == 4
    pipe = VariabilityPipeline(PipelineConfig(
        n_ranks=2, backend="serial", device=CPU,
        generation=GenerationConfig(interval_ns=100_000_000)))
    res = pipe.run(dbs, str(tmp_path / "store"))
    t0 = min(e.start_ns for e in rec.steps if e.step == 30)
    t1 = max(e.end_ns for e in rec.steps if e.step == 35)
    frac = recovered(np.asarray([[t0, t1]]), res.anomaly_windows,
                     tol_ns=2_000_000_000)
    assert frac == 1.0


def test_trainer_telemetry_runs_through_the_pipeline(tmp_path):
    """A port trainer's own step telemetry (one host) goes through the
    port's pipeline: every step event becomes a row."""
    cfg = get_smoke_config("mamba2-370m")
    res = Trainer(cfg, TrainConfig(), DataConfig(batch=2, seq=8),
                  RunConfig(steps=6, ckpt_every=100, monitor_every=3,
                            workdir=str(tmp_path / "run")),
                  device=CPU).run()
    dbs = [str(tmp_path / "run" / "telemetry" / "rank0.sqlite")]
    out = VariabilityPipeline(PipelineConfig(
        n_ranks=1, backend="serial", device=CPU,
        generation=GenerationConfig(interval_ns=10_000_000))).run(
            dbs, str(tmp_path / "store"))
    assert res["telemetry_dir"] == str(tmp_path / "run" / "telemetry")
    assert out.generation.rows_per_table["KERNEL"] == 6
    assert out.generation.joined_rows == 6
    assert out.aggregation.stats.count.sum() == 6
    assert np.isfinite(out.anomalies.scores).all()
