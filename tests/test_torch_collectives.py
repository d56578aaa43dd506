"""The port's merge across ranks (world size > 1) on gloo on the CPU,
against the JAX package's P-device mesh.

Every multi-process case runs this file as its rank processes
(``python tests/test_torch_collectives.py <rank> <world> <port> <dir>``),
each in a gloo group with a 60 s timeout, under a subprocess timeout; the
three groups (P = 2, 3 and 4) and the reference start together. The
reference runs in one subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
tests/test_distributed.py does, its mesh the first P of those devices.

- P = 2, 3, 4: ``distributed_moments_flat`` and
  ``distributed_histogram_flat`` with rank r passing row block r (256
  segments, which 3 does not divide) against the reference's on a
  P-device mesh: counts, min, max and bucket counts exact, sums rtol
  1e-5; every rank's table equal to rank 0's bit for bit.
- P = 3: the merge adds the ranks' blocks in rank order bit for bit; the
  kernels' order verdict (NaN) on one rank makes every rank's
  ``device_reduce`` raise; a divergent query and a divergent set of slots
  each make every rank raise.
- P = 4: ``distributed_binstats`` on the reference test's case; the
  pipeline (phase 1 on rank 0's pool, the append, the delta, a cold rerun,
  a fused batch, a diff) on the torch backend: delta == cold and fused ==
  standalone bit for bit, equal to the P = 1 run and to the reference's
  jax backend on 4 devices (counts, min, max exact, sums rtol 1e-5); the
  host backends raise (serving and streaming across ranks:
  tests/test_torch_serve_group.py).
"""

import datetime
import json
import os
import shutil
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
RTOL = 1e-5
METRICS = ("k_stall", "m_duration", "m_bytes")
SUITE = ("moments", "quantile")
STAT_FIELDS = ("count", "sum", "sumsq", "min", "max")
WORLDS = (2, 3, 4)
N_ROWS, N_SEG = 2400, 256              # rows split evenly by 2, 3 and 4
GROUP_TIMEOUT_S = 60
SPEC = dict(n_ranks=2, kernels_per_rank=3000, memcpys_per_rank=500,
            duration_s=30.0, n_anomaly_windows=2, seed=5)
CUT_S = 22
_NS = 1_000_000_000


# --- inputs -----------------------------------------------------------------

def _flat_inputs():
    rng = np.random.default_rng(25)
    seg = np.sort(rng.integers(0, N_SEG, N_ROWS)).astype(np.int32)
    vals = rng.lognormal(3.0, 2.0, (2, N_ROWS)).astype(np.float32)
    valid = rng.random(N_ROWS) > 0.1
    rng = np.random.default_rng(0)     # tests/test_distributed.py's case
    ts = rng.uniform(0, 1e9, 4096).astype(np.float32)
    bvals = rng.normal(10, 3, 4096).astype(np.float32)
    return dict(seg=seg, vals=vals, valid=valid, ts=ts, bvals=bvals)


def _cfg(port, backend="torch"):
    return port.PipelineConfig(n_ranks=2, backend=backend, device="cpu",
                               metrics=METRICS, group_by="m_kind",
                               reducers=SUITE, anomaly_score="p99")


def _mixed_queries(port, store):
    man = port.TraceStore(store).read_manifest()
    edges = port.ShardPlan(man.t_start, man.t_end,
                           man.n_shards).boundaries()
    return [
        port.Query(metrics=("k_stall",), group_by="m_kind"),
        port.Query(metrics=("m_duration", "m_bytes"), group_by="m_kind",
                   transfer_kinds=(1, 2)),
        port.Query(metrics=("k_stall", "m_duration"), reducers=SUITE,
                   ranks=(0,)),
        port.Query(metrics=("m_bytes",),
                   time_window=(int(edges[1]), int(edges[5]))),
    ]


def _agg_arrays(res, anomalies=None):
    out = {f: getattr(res.grouped, f) for f in STAT_FIELDS}
    out["quantile"] = res.reduced["quantile"].counts
    out["group_keys"] = np.asarray(res.group_keys)
    if anomalies is not None:
        out["flags"] = anomalies.flags
        out["top_windows"] = anomalies.top_windows
    return out


def _agg_bitwise(a, b):
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(getattr(a.grouped, f),
                                      getattr(b.grouped, f))
    np.testing.assert_array_equal(a.reduced["quantile"].counts,
                                  b.reduced["quantile"].counts)


def _cleared_copy(port, src, dst):
    shutil.copytree(src, dst)
    cs = port.TraceStore(dst)
    cs.clear_summaries()
    cs.clear_partials()


# --- the rank processes -----------------------------------------------------

def _rank_main(rank, world, port_no, work):
    import torch.distributed as dist

    import repro_torch.core as port
    from repro_torch.core import distributed as D

    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port_no}", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    checks, arrays = {}, {}

    def check(name, fn):
        try:
            fn()
            checks[name] = "ok"
        except Exception as e:         # noqa: BLE001 - reported to pytest
            checks[name] = f"{type(e).__name__}: {e}"

    inp = dict(np.load(os.path.join(work, "flat_inputs.npz")))
    blk = slice(rank * N_ROWS // world, (rank + 1) * N_ROWS // world)
    seg = torch.from_numpy(inp["seg"][blk])
    vals = torch.from_numpy(inp["vals"][:, blk])
    valid = torch.from_numpy(inp["valid"][blk])
    arrays["moments"] = D.distributed_moments_flat(
        seg, vals, N_SEG, valid=valid).numpy()
    arrays["hist"] = D.distributed_histogram_flat(
        seg, vals, N_SEG, valid=valid).numpy()
    checks["world"] = ("ok" if D._world_size() == world and
                       D._rank() == rank else "wrong world or rank")

    if world == 3:
        _rank_order_and_divergence(rank, world, work, port, D, check)
    if world == 4:
        n = inp["ts"].shape[0]
        tb = slice(rank * n // world, (rank + 1) * n // world)
        arrays["binstats"] = D.distributed_binstats(
            torch.from_numpy(inp["ts"][tb]),
            torch.from_numpy(inp["bvals"][tb]), 1e9, 64).numpy()
        arrays.update(_pipeline(rank, work, port, dist, check))
    np.savez(os.path.join(work, f"p{world}_rank{rank}.npz"), **arrays)
    with open(os.path.join(work, f"p{world}_rank{rank}.json"), "w") as f:
        json.dump(checks, f)
    port.pipeline.stop_rank_pool_server()
    dist.destroy_process_group()


def _rank_order_and_divergence(rank, world, work, port, D, check):
    # each element's three ranks' values: their float32 sum depends on the
    # order of the adds ((1 + 1e8) - 1e8 = 0, (-1e8 + 1e8) + 1 = 1)
    trip = np.asarray([(1.0, 1e8, -1e8), (3.0, -1e8, 1e8), (0.5, 1e8, -1e8),
                       (1e-3, 1.0, -1.0), (7.0, 1e8, -1e8),
                       (1e8, 1.0, -1e8), (2.0, 3.0, 4.0)], np.float32)
    table = np.stack([trip, trip[:, ::-1], trip * 3], axis=1)  # (7, 3, P)
    x = torch.from_numpy(np.ascontiguousarray(table[None, ..., rank]))
    got = D._collaborative_sum(x, 1)

    def rank_order():
        fwd, rev = table[..., 0], table[..., world - 1]
        for r in range(1, world):
            fwd = fwd + table[..., r]
            rev = rev + table[..., world - 1 - r]
        assert (fwd != rev).any()      # the case tells the orders apart
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy()[0], fwd)
    check("rank_order", rank_order)

    # the kernels' order verdict (a NaN count, NaN in bucket 0) on rank 1
    # alone must reach every rank's merged table, so every rank raises
    from repro_torch.core.reducers import BinStats, QuantileSketch
    inp = dict(np.load(os.path.join(work, "flat_inputs.npz")))
    blk = slice(rank * N_ROWS // world, (rank + 1) * N_ROWS // world)
    rows = (inp["seg"][blk], inp["vals"][:, blk], inp["valid"][blk])
    for reducer, name in ((BinStats, "binstats_flat"),
                          (QuantileSketch, "histbin_flat")):
        real = getattr(D, name)

        def on_rank1(seg, vals, n_seg, valid, real=real):
            out = real(seg, vals, n_seg, valid)
            if rank == 1:
                out[..., 7, 0] = float("nan")
            return out

        def verdict(reducer=reducer):
            try:
                reducer.device_reduce(rows[0], rows[1], N_SEG, "cpu",
                                      rows[2])
            except ValueError as e:
                assert "segment-ordered" in str(e), e
                return
            raise AssertionError("device_reduce did not raise")
        setattr(D, name, on_rank1)
        try:
            check(f"nan_verdict_{name}", verdict)
        finally:
            setattr(D, name, real)

    store = os.path.join(work, "diverge_store")
    q = port.Query(metrics=("k_stall",) if rank != 1
                   else ("k_stall", "m_duration"), group_by="m_kind")

    def divergent_query():
        port.run_queries(store, [q], backend="torch", device="cpu")
    check("divergent_query", divergent_query)

    qplan = port.QueryPlan.compile(
        store, [port.Query(metrics=("k_stall",), group_by="m_kind")],
        backend="torch", device="cpu")
    work_items = [(i, [0]) for i in port.TraceStore(store).shard_indices()]
    if rank == 1:
        work_items = work_items[:-1]

    def divergent_slots():
        port.compute_lane_partials_torch(qplan.store, work_items,
                                         qplan.lanes, torch.device("cpu"),
                                         persist=False)
    check("divergent_slots", divergent_slots)


def _pipeline(rank, work, port, dist, check):
    ds = port.generate_synthetic(port.SyntheticSpec(**SPEC))
    cutoff = _cutoff(ds)
    paths = [os.path.join(work, "dbs", f"rank{tr.rank}.sqlite")
             for tr in ds.traces]
    store = os.path.join(work, "store")
    pipe = port.VariabilityPipeline(_cfg(port))
    first = pipe.run(paths, store)     # phase 1 on rank 0's pool
    if rank == 0:
        for tr, p in zip(ds.traces, paths):
            port.append_rank_db(p, port.trace_remainder(tr, cutoff))
    dist.barrier()
    delta = pipe.append(paths, store)
    if rank == 0:
        for name in ("cold", "p1", "fused") + tuple(
                f"solo{k}" for k in range(4)):
            _cleared_copy(port, store, os.path.join(work, name))
    dist.barrier()
    cold = port.run_aggregation(os.path.join(work, "cold"),
                                query=pipe.cfg.to_query(),
                                backend="torch", device="cpu")
    queries = _mixed_queries(port, store)
    fused = pipe.query(os.path.join(work, "fused"), queries)
    solos = [pipe.query(os.path.join(work, f"solo{k}"), [q])[0]
             for k, q in enumerate(queries)]
    rep = pipe.diff(os.path.join(work, "cold"), store)
    again = pipe.diff(os.path.join(work, "cold"), store)

    def delta_eq_cold():
        assert first.aggregation.recomputed_shards
        assert delta.aggregation.partial_hits > 0
        assert delta.aggregation.recomputed_shards
        assert cold.partial_hits == 0
        _agg_bitwise(delta.aggregation, cold)
    check("delta_eq_cold", delta_eq_cold)

    def fused_eq_standalone():
        for q, qf, solo in zip(queries, fused, solos):
            assert not qf.cache_hit and not solo.cache_hit
            for f in STAT_FIELDS:
                np.testing.assert_array_equal(
                    getattr(solo.result.grouped, f),
                    getattr(qf.result.grouped, f))
            if "quantile" in q.canonical_reducers:
                np.testing.assert_array_equal(
                    solo.result.reduced["quantile"].counts,
                    qf.result.reduced["quantile"].counts)
            np.testing.assert_array_equal(solo.anomalies.scores,
                                          qf.anomalies.scores)
    check("fused_eq_standalone", fused_eq_standalone)

    def diff_cached():
        assert rep.verdict == "pass" and not rep.from_cache
        assert again.from_cache
    check("diff_cached", diff_cached)

    def raises(fn):
        try:
            fn()
        except RuntimeError as e:
            assert "ROADMAP.md" in str(e), e
            return
        raise AssertionError("did not raise")
    check("raise_serial", lambda: raises(
        lambda: port.VariabilityPipeline(_cfg(port, "serial")).aggregate(
            store)))
    check("raise_process", lambda: raises(
        lambda: port.VariabilityPipeline(_cfg(port, "process")).aggregate(
            store)))
    return {f"delta_{k}": v for k, v in
            _agg_arrays(delta.aggregation, delta.anomalies).items()}


def _cutoff(ds):
    t0 = int(ds.traces[0].kernels.start.min())
    return (t0 // _NS) * _NS + CUT_S * _NS


# --- the reference on a P-device mesh (a subprocess) ------------------------

REFERENCE = """
import os, sys
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'
os.environ['JAX_PLATFORMS'] = 'cpu'
sys.path.insert(0, {src!r})
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
import repro.core as ref
from repro.core.distributed import (distributed_binstats,
                                    distributed_histogram_flat,
                                    distributed_moments_flat)
work = {work!r}
inp = dict(np.load(os.path.join(work, 'flat_inputs.npz')))
out = {{}}
for p in {worlds!r}:
    mesh = Mesh(np.asarray(jax.devices()[:p]), ('data',))
    args = (jnp.asarray(inp['seg']), jnp.asarray(inp['vals']), {n_seg})
    kw = dict(valid=jnp.asarray(inp['valid']))
    out['moments_p%d' % p] = np.asarray(
        distributed_moments_flat(*args, mesh, **kw))
    out['hist_p%d' % p] = np.asarray(
        distributed_histogram_flat(*args, mesh, **kw))
out['binstats_p4'] = np.asarray(distributed_binstats(
    jnp.asarray(inp['ts']), jnp.asarray(inp['bvals']), 1e9, 64,
    Mesh(np.asarray(jax.devices()), ('data',))))
ds = ref.generate_synthetic(ref.SyntheticSpec(**{spec!r}))
t0 = int(ds.traces[0].kernels.start.min())
cutoff = (t0 // {ns}) * {ns} + {cut} * {ns}
paths = [os.path.join(work, 'ref_dbs', 'rank%d.sqlite' % tr.rank)
         for tr in ds.traces]
cfg = ref.PipelineConfig(n_ranks=2, backend='jax', metrics={metrics!r},
                         group_by='m_kind', reducers={suite!r},
                         anomaly_score='p99')
pipe = ref.VariabilityPipeline(cfg)
store = os.path.join(work, 'ref_store')
pipe.run(paths, store)
for tr, p in zip(ds.traces, paths):
    ref.append_rank_db(p, ref.trace_remainder(tr, cutoff))
res = pipe.append(paths, store)
host = ref.run_aggregation(store, query=cfg.to_query(), backend='serial')
for tag, agg in (('jax', res.aggregation), ('serial', host)):
    for f in {fields!r}:
        out['%s_%s' % (tag, f)] = getattr(agg.grouped, f)
    out['%s_quantile' % tag] = agg.reduced['quantile'].counts
    out['%s_group_keys' % tag] = np.asarray(agg.group_keys)
out['jax_flags'] = res.anomalies.flags
out['jax_top_windows'] = res.anomalies.top_windows
np.savez(os.path.join(work, 'reference.npz'), **out)
print('OK')
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """All three groups and the reference, started together; returns the
    work directory, every rank's checks and arrays, the reference's
    arrays and the P = 1 torch run on the same grown store."""
    import repro_torch.core as port

    work = str(tmp_path_factory.mktemp("collectives"))
    np.savez(os.path.join(work, "flat_inputs.npz"), **_flat_inputs())
    ds = port.generate_synthetic(port.SyntheticSpec(**SPEC))
    cutoff = _cutoff(ds)
    for sub in ("dbs", "ref_dbs"):
        os.makedirs(os.path.join(work, sub))
        for tr in ds.traces:
            port.write_rank_db(os.path.join(work, sub, f"rank{tr.rank}.sqlite"),
                               port.truncate_trace(tr, cutoff))
    port.run_generation([os.path.join(work, "dbs", f"rank{tr.rank}.sqlite")
                         for tr in ds.traces],
                        os.path.join(work, "diverge_store"), n_ranks=2)
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    ref_code = textwrap.dedent(REFERENCE).format(
        src=SRC, work=work, worlds=WORLDS, n_seg=N_SEG, spec=SPEC,
        ns=_NS, cut=CUT_S, metrics=METRICS, suite=SUITE,
        fields=STAT_FIELDS)
    procs = [("reference", subprocess.Popen(
        [sys.executable, "-c", ref_code], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True))]
    for world in WORLDS:
        port_no = _free_port()
        for rank in range(world):
            procs.append((f"p{world} rank {rank}", subprocess.Popen(
                [sys.executable, __file__, str(rank), str(world),
                 str(port_no), work], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
    deadline = time.monotonic() + 3 * GROUP_TIMEOUT_S
    failed = []
    for name, p in procs:
        try:
            out, err = p.communicate(
                timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            failed.append(f"{name}: timed out\n{err[-3000:]}")
            continue
        if p.returncode != 0:
            failed.append(f"{name}: exit {p.returncode}\n{err[-3000:]}")
    assert not failed, "\n".join(failed)

    checks, arrays = {}, {}
    for world in WORLDS:
        for rank in range(world):
            stem = os.path.join(work, f"p{world}_rank{rank}")
            with open(stem + ".json") as f:
                checks[world, rank] = json.load(f)
            arrays[world, rank] = dict(np.load(stem + ".npz"))
    reference = dict(np.load(os.path.join(work, "reference.npz")))
    p1 = port.run_aggregation(os.path.join(work, "p1"),
                              query=_cfg(port).to_query(), backend="torch",
                              device="cpu")
    return work, checks, arrays, reference, p1


def _assert_checks(checks, name, worlds=WORLDS):
    bad = {key: c[name] for key, c in checks.items()
           if key[0] in worlds and c.get(name) != "ok"}
    assert not bad, bad


def _assert_moments_close(got, want):
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1:3], want[..., 1:3], rtol=RTOL)
    np.testing.assert_array_equal(got[..., 3:5], want[..., 3:5])


# --- the tests --------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_moments_flat_matches_reference_mesh(runs, world):
    _, checks, arrays, reference, _ = runs
    _assert_checks(checks, "world", (world,))
    got = arrays[world, 0]["moments"]
    assert got.shape == (2, N_SEG, 5)
    _assert_moments_close(got, reference[f"moments_p{world}"])
    for rank in range(1, world):      # replicated bit for bit
        np.testing.assert_array_equal(arrays[world, rank]["moments"], got)


@pytest.mark.parametrize("world", WORLDS)
def test_histogram_flat_matches_reference_mesh(runs, world):
    _, _, arrays, reference, _ = runs
    got = arrays[world, 0]["hist"]
    np.testing.assert_array_equal(got, reference[f"hist_p{world}"])
    for rank in range(1, world):
        np.testing.assert_array_equal(arrays[world, rank]["hist"], got)


def test_distributed_binstats_matches_reference_at_p4(runs):
    _, _, arrays, reference, _ = runs
    got = arrays[4, 0]["binstats"]
    assert got.shape == (64, 5) and got[:, 0].sum() == 4096
    _assert_moments_close(got, reference["binstats_p4"])
    for rank in range(1, 4):
        np.testing.assert_array_equal(arrays[4, rank]["binstats"], got)


def test_merge_adds_blocks_in_rank_order(runs):
    _assert_checks(runs[1], "rank_order", (3,))


@pytest.mark.parametrize("kernel", ["binstats_flat", "histbin_flat"])
def test_order_verdict_on_one_rank_raises_on_every_rank(runs, kernel):
    _assert_checks(runs[1], f"nan_verdict_{kernel}", (3,))


@pytest.mark.parametrize("what", ["divergent_query", "divergent_slots"])
def test_divergent_plan_raises_on_every_rank(runs, what):
    checks = runs[1]
    for rank in range(3):
        msg = checks[3, rank][what]
        assert msg.startswith("RuntimeError") and "differ" in msg, msg


def test_delta_equals_cold_bitwise_at_p4(runs):
    _assert_checks(runs[1], "delta_eq_cold", (4,))


def test_fused_equals_standalone_at_p4(runs):
    _assert_checks(runs[1], "fused_eq_standalone", (4,))


def test_diff_at_p4_loads_rank0s_cache(runs):
    _assert_checks(runs[1], "diff_cached", (4,))


def test_p4_equals_p1(runs):
    _, _, arrays, _, p1 = runs
    got = arrays[4, 0]
    np.testing.assert_array_equal(got["delta_group_keys"], p1.group_keys)
    np.testing.assert_array_equal(got["delta_count"], p1.grouped.count)
    for f in ("min", "max"):
        np.testing.assert_array_equal(got[f"delta_{f}"],
                                      getattr(p1.grouped, f))
    for f in ("sum", "sumsq"):
        np.testing.assert_allclose(got[f"delta_{f}"],
                                   getattr(p1.grouped, f), rtol=RTOL)
    np.testing.assert_array_equal(got["delta_quantile"],
                                  p1.reduced["quantile"].counts)
    for rank in range(1, 4):
        for k, v in got.items():
            np.testing.assert_array_equal(arrays[4, rank][k], v)


def test_p4_equals_reference_jax_on_four_devices(runs):
    from test_torch_cuda import assert_hist_close

    _, _, arrays, ref, _ = runs
    got = arrays[4, 0]
    np.testing.assert_array_equal(got["delta_group_keys"],
                                  ref["jax_group_keys"])
    np.testing.assert_array_equal(got["delta_count"], ref["jax_count"])
    occ = ref["jax_count"] > 0
    for f in ("min", "max"):
        np.testing.assert_array_equal(
            np.where(occ, got[f"delta_{f}"], 0.0),
            np.where(occ, ref[f"jax_{f}"], 0.0))
    for f in ("sum", "sumsq"):
        np.testing.assert_allclose(got[f"delta_{f}"], ref[f"jax_{f}"],
                                   rtol=RTOL)
    # the m_bytes sketch is judged by the exact host path: XLA's float32
    # log2 puts exact powers of two one bucket low (see
    # tests/test_torch_pipeline.py)
    assert_hist_close(got["delta_quantile"][..., :2, :],
                      ref["jax_quantile"][..., :2, :])
    np.testing.assert_array_equal(got["delta_quantile"][..., 2, :],
                                  ref["serial_quantile"][..., 2, :])
    np.testing.assert_array_equal(got["delta_flags"], ref["jax_flags"])
    np.testing.assert_array_equal(got["delta_top_windows"],
                                  ref["jax_top_windows"])


@pytest.mark.parametrize("what", ["serial", "process"])
def test_host_backends_and_serving_raise_at_p4(runs, what):
    _assert_checks(runs[1], f"raise_{what}", (4,))


def test_world_size_one_without_a_group():
    from repro_torch.core import distributed as D
    from repro_torch.core.group import agree, on_rank0
    from repro_torch.core.query import lane_precision

    assert D._world_size() == 1 and D._rank() == 0
    x = torch.arange(12, dtype=torch.float32).reshape(2, 6)
    assert D._collaborative_sum(x, 1) is x
    assert D._collaborative_reduce(x) is x
    assert on_rank0(lambda: 7, "a step") == 7
    agree("nothing", [1])
    assert lane_precision("torch") == "torch-float32"
    assert lane_precision("torch", 4) == "torch-float32-p4"
    assert lane_precision("serial", 4) == "exact"


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
               sys.argv[4])
