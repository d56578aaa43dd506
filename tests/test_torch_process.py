"""The port's ``process`` backend (one OS process per rank for phase 1, a
work-stealing process pool for the exact host scan) against the JAX
package's ``process`` backend and the port's own ``serial``, on the CPU
(``device="cpu"``: the fences take the ``iqr`` kernel's plain version).

Every comparison is bitwise: the shard files byte for byte, every moment
field, the sketch counts, the Fig-1b byte breakdown, the fence flags, top
bins and fences. Beside them: delta == cold and append == cold on
``process``, the work queue on shards of very uneven size, fused ==
standalone, the diff, an ingest-fixture DB, multi-metric and group-by
configurations, the partial cache the workers fill, the query service and
its CLI, no fallback when a pool fails, a pool started while a
``ScanPool`` thread is alive in the parent, and the pool's servers ending
with the process that started them.
"""

import concurrent.futures
import filecmp
import os
import shutil
import subprocess
import sys
import threading
from multiprocessing import forkserver, resource_tracker

import numpy as np
import pytest

import repro.core as ref
import repro_torch.core as port
from repro_torch.core import pipeline as port_pipeline
from repro_torch.core.aggregation import ScanPool
from repro_torch.core.query import QueryPlan
from repro_torch.ingest.fixture import write_fixture_dbs
from repro_torch.serve.query_service import (QueryService, ServiceConfig,
                                             build_parser)

METRICS = ("k_stall", "m_duration", "m_bytes")
SUITE = ("moments", "quantile")
STAT_FIELDS = ("count", "sum", "sumsq", "min", "max")
_NS = 1_000_000_000


def _cfg(pkg, backend, **kw):
    extra = {"device": "cpu"} if pkg is port else {}
    kw = {"n_ranks": 2, "metrics": METRICS, "group_by": "k_device",
          "reducers": SUITE, "anomaly_score": "p99", **kw}
    return pkg.PipelineConfig(backend=backend, **extra, **kw)


def _shard_names(store):
    n = port.TraceStore(store).read_manifest().n_shards
    return [f"shard_{s:06d}.npz" for s in range(n)]


def assert_shards_equal(a, b):
    names = _shard_names(a)
    assert names == _shard_names(b)
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert match == names and not mismatch and not errors


def assert_agg_equal(a, b):
    """Two aggregations bit for bit (either package's result)."""
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(getattr(a.grouped, f),
                                      getattr(b.grouped, f))
    np.testing.assert_array_equal(a.group_keys, b.group_keys)
    assert set(a.reduced) == set(b.reduced)
    if "quantile" in a.reduced:
        np.testing.assert_array_equal(a.reduced["quantile"].counts,
                                      b.reduced["quantile"].counts)
    assert set(a.copy_kind_bytes) == set(b.copy_kind_bytes)
    for k in a.copy_kind_bytes:
        np.testing.assert_array_equal(a.copy_kind_bytes[k],
                                      b.copy_kind_bytes[k])


def assert_anomalies_equal(a, b):
    for f in ("flags", "top_idx", "top_windows", "scores"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.q1, a.q3, a.lo_fence, a.hi_fence) == \
        (b.q1, b.q3, b.lo_fence, b.hi_fence)


def _assert_workers_on_host(gen, n_ranks):
    assert len(gen.workers) == n_ranks
    assert not any(w["cuda_initialized"] for w in gen.workers)


# --- the reference's process backend against the port's ---------------------

@pytest.fixture(scope="module")
def runs(small_dataset, tmp_path_factory):
    """The same DBs through the reference's ``process`` backend and the
    port's ``process`` and ``serial`` backends."""
    _, paths = small_dataset
    work = tmp_path_factory.mktemp("port_process")
    pipes = {"ref": ref.VariabilityPipeline(_cfg(ref, "process")),
             "process": port.VariabilityPipeline(_cfg(port, "process")),
             "serial": port.VariabilityPipeline(_cfg(port, "serial"))}
    return work, {k: p.run(paths, str(work / k)) for k, p in pipes.items()}


def test_shard_files_equal_reference_process(runs):
    work, res = runs
    assert_shards_equal(str(work / "ref"), str(work / "process"))
    assert res["process"].generation.joined_rows == \
        res["ref"].generation.joined_rows
    _assert_workers_on_host(res["process"].generation, 2)


@pytest.mark.parametrize("other", ["ref", "serial"])
def test_process_aggregation_and_anomalies_exact(runs, other):
    _, res = runs
    assert_agg_equal(res["process"].aggregation, res[other].aggregation)
    assert_anomalies_equal(res["process"].anomalies, res[other].anomalies)


def test_process_plan_is_exact_and_shares_the_serial_cache(runs, tmp_path):
    """A ``process`` plan never resolves a device (the default ``"cuda"``
    is not touched on a machine without one), mints ``"exact"`` lanes,
    and a ``serial`` query after a ``process`` one is a summary hit."""
    work, _ = runs
    store = str(tmp_path / "s")
    shutil.copytree(str(work / "serial"), store)
    port.TraceStore(store).clear_summaries()
    port.TraceStore(store).clear_partials()
    q = port.Query(metrics=("k_stall",), group_by="m_kind")
    plan = QueryPlan.compile(store, [q], backend="process")
    assert plan.device is None
    assert [ln.precision for ln in plan.lanes] == ["exact"]
    first = port.VariabilityPipeline(_cfg(port, "process")).query(store, [q])
    assert not first[0].cache_hit
    again = port.run_queries(store, [q], backend="serial", device="cpu")[0]
    assert again.cache_hit
    assert_agg_equal(again.result, first[0].result)


@pytest.mark.parametrize("partitioning,n_ranks",
                         [("block", 1), ("block", 3), ("cyclic", 3)])
def test_process_equals_serial_across_rank_layouts(small_dataset, tmp_path,
                                                   partitioning, n_ranks):
    """One process per rank at other rank counts and the cyclic layout:
    the shard files and the result equal ``serial``'s at the same
    layout, and the workers never touch CUDA."""
    _, paths = small_dataset
    gen = port.GenerationConfig(partitioning=partitioning)
    out = {}
    for backend in ("serial", "process"):
        pipe = port.VariabilityPipeline(_cfg(port, backend, n_ranks=n_ranks,
                                             generation=gen))
        out[backend] = pipe.run(paths, str(tmp_path / backend))
        if backend == "process":
            assert pipe.scan_workers
            assert not any(w["cuda_initialized"] for w in pipe.scan_workers)
    assert_shards_equal(str(tmp_path / "serial"), str(tmp_path / "process"))
    _assert_workers_on_host(out["process"].generation, n_ranks)
    assert_agg_equal(out["process"].aggregation, out["serial"].aggregation)
    assert_anomalies_equal(out["process"].anomalies,
                           out["serial"].anomalies)


@pytest.mark.parametrize("kw", [
    {"metrics": None, "group_by": None, "reducers": ("moments",),
     "anomaly_score": "mean"},
    {"group_by": "k_device", "reducers": ("moments",),
     "anomaly_score": "mean"},
    {"group_by": "m_kind", "anomaly_score": "iqr"},
], ids=["default", "multimetric", "quantile_iqr"])
def test_process_equals_serial_multimetric_and_group_by(small_dataset,
                                                        tmp_path, kw):
    """The reference's multi-metric, group-by and quantile-score cases
    (tests/test_multimetric.py) on the port: process == serial exactly,
    caches off."""
    _, paths = small_dataset
    out = {b: port.VariabilityPipeline(
        _cfg(port, b, use_summary_cache=False, **kw)).run(
            paths, str(tmp_path / b)) for b in ("serial", "process")}
    assert_agg_equal(out["process"].aggregation, out["serial"].aggregation)
    assert_anomalies_equal(out["process"].anomalies,
                           out["serial"].anomalies)


# --- delta, append and the work queue on process ---------------------------

@pytest.fixture(scope="module")
def trace():
    ds = port.generate_synthetic(port.SyntheticSpec(
        n_ranks=2, kernels_per_rank=3000, memcpys_per_rank=400,
        duration_s=30.0, n_anomaly_windows=2, seed=11))
    t0 = int(ds.traces[0].kernels.start.min())
    return ds, (t0 // _NS) * _NS + 22 * _NS


@pytest.fixture
def grown(trace, tmp_path):
    """Rank DBs cut at the cut-off, their store built by the process
    backend, and ``grow()`` that appends the rest to the DBs."""
    ds, cutoff = trace
    paths = [str(tmp_path / f"rank{tr.rank}.sqlite") for tr in ds.traces]
    for tr, p in zip(ds.traces, paths):
        port.write_rank_db(p, port.truncate_trace(tr, cutoff))
    store = str(tmp_path / "store")
    pipe = port.VariabilityPipeline(_cfg(port, "process"))
    pipe.run(paths, store)

    def grow():
        for tr, p in zip(ds.traces, paths):
            port.append_rank_db(p, port.trace_remainder(tr, cutoff))
    return pipe, store, paths, grow


def _cold(pipe, store, tmp_path):
    cold_dir = str(tmp_path / "cold")
    shutil.copytree(store, cold_dir)
    cs = port.TraceStore(cold_dir)
    cs.clear_summaries()
    cs.clear_partials()
    cold = pipe.aggregate(cold_dir)
    assert cold.partial_hits == 0
    return cold


@pytest.mark.parametrize("how", ["delta", "append"])
def test_process_delta_and_append_equal_cold(grown, tmp_path, how):
    pipe, store, paths, grow = grown
    grow()
    if how == "append":
        got = pipe.append(paths, store).aggregation
    else:
        port.run_append(paths, store)
        got = pipe.aggregate(store)
    assert got.partial_hits > 0 and got.recomputed_shards
    assert_agg_equal(got, _cold(pipe, store, tmp_path))


def _skewed_store(root):
    """12 shard files, two of them 100x their neighbours (the reference's
    straggler store, tests/test_incremental.py)."""
    rng = np.random.default_rng(5)
    store = port.TraceStore(root)
    n_shards = 12
    plan = port.ShardPlan(0, n_shards * 1_000_000, n_shards)
    for s in range(n_shards):
        lo, hi = plan.shard_bounds(s)
        n = 20_000 if s in (3, 7) else 200
        store.write_shard(s, {
            "k_start": rng.integers(lo, hi, n).astype(np.float64),
            "k_stall": rng.normal(100, 25, n),
            "m_duration": rng.lognormal(8, 1, n),
            "m_bytes": rng.integers(0, 1 << 20, n).astype(np.float64),
            "m_kind": rng.choice([1.0, 2.0, 8.0], n),
            "m_start": rng.integers(lo, hi, n).astype(np.float64),
            "joined": rng.integers(0, 2, n).astype(np.float64),
            "k_device": rng.integers(0, 4, n).astype(np.float64),
        })
    store.write_manifest(port.StoreManifest(
        t_start=0, t_end=plan.t_end, n_shards=n_shards, n_ranks=3,
        partitioning="block", columns=[], shard_owner=[0] * n_shards))
    return store


def test_workqueue_equals_serial_on_skew(tmp_path):
    store = _skewed_store(str(tmp_path / "skew"))
    out = {}
    for backend in ("serial", "process"):
        cfg = _cfg(port, backend, n_ranks=3, group_by="m_kind",
                   use_summary_cache=False)
        out[backend] = port.VariabilityPipeline(cfg).aggregate(store.root)
    assert_agg_equal(out["serial"], out["process"])


def test_workqueue_workers_populate_partial_cache(tmp_path):
    """With the cache on, pool workers persist the partials they compute;
    a follow-up serial run finds every shard clean."""
    store = _skewed_store(str(tmp_path / "skew2"))
    cfg = _cfg(port, "process", n_ranks=3, reducers=("moments",),
               anomaly_score="mean", group_by="m_kind")
    port.VariabilityPipeline(cfg).aggregate(store.root)
    assert len(store.partial_names()) == 12
    store.clear_summaries()
    fresh = port.TraceStore(store.root)
    res = port.run_queries(fresh, [cfg.to_query()], n_ranks=3,
                           device="cpu")[0]
    assert res.partial_hits == 12 and res.recomputed_shards == 0
    assert fresh.io_counts["shard_reads"] == 0


def test_fused_batch_equals_standalone_on_process(runs, tmp_path):
    work, _ = runs
    man = port.TraceStore(str(work / "serial")).read_manifest()
    edges = port.ShardPlan(man.t_start, man.t_end,
                           man.n_shards).boundaries()
    queries = [
        port.Query(metrics=("k_stall", "m_duration"), group_by="m_kind"),
        port.Query(metrics=("m_bytes",), reducers=SUITE,
                   anomaly_score="p95", ranks=(0,)),
        port.Query(metrics=("k_stall",), group_by="k_device",
                   time_window=(int(edges[2]), int(edges[9])),
                   transfer_kinds=(1, 2), interval_ns=100_000_000),
    ]
    pipe = port.VariabilityPipeline(_cfg(port, "process"))
    fused_dir = str(tmp_path / "fused")
    shutil.copytree(str(work / "serial"), fused_dir)
    port.TraceStore(fused_dir).clear_summaries()
    port.TraceStore(fused_dir).clear_partials()
    fused = pipe.query(fused_dir, queries)
    for q, qf in zip(queries, fused):
        assert not qf.cache_hit
        solo_dir = str(tmp_path / f"solo_{q.cache_key()}")
        shutil.copytree(str(work / "serial"), solo_dir)
        port.TraceStore(solo_dir).clear_summaries()
        port.TraceStore(solo_dir).clear_partials()
        solo = pipe.query(solo_dir, [q])[0]
        assert not solo.cache_hit
        assert_agg_equal(solo.result, qf.result)
        np.testing.assert_array_equal(solo.anomalies.scores,
                                      qf.anomalies.scores)


# --- diff and ingest ---------------------------------------------------------

def test_process_diff_equals_serial(tmp_path):
    common = dict(n_ranks=2, kernels_per_rank=4000, memcpys_per_rank=400,
                  duration_s=20.0, n_anomaly_windows=2, seed=7)
    ds_a = port.generate_synthetic(port.SyntheticSpec(**common))
    ds_c = port.inject_slowdown(port.generate_synthetic(
        port.SyntheticSpec(**common, name_variant=1)), 1.5, (3, 24, 45))
    reps = {}
    for backend in ("serial", "process"):
        stores = []
        for tag, ds in (("a", ds_a), ("c", ds_c)):
            dbs = port.write_synthetic_dbs(
                ds, str(tmp_path / f"dbs_{backend}_{tag}"))
            store = str(tmp_path / f"store_{backend}_{tag}")
            port.VariabilityPipeline(_cfg(port, backend)).generate(dbs, store)
            stores.append(store)
        pipe = port.VariabilityPipeline(port.PipelineConfig(
            n_ranks=2, backend=backend, device="cpu"))
        reps[backend] = pipe.diff(*stores)
        assert not reps[backend].from_cache
    proc, serial = reps["process"], reps["serial"]
    assert proc.verdict == serial.verdict == "regressed"
    assert [g.name_a for g in proc.groups] == \
        [g.name_a for g in serial.groups]
    for f in ("shift_octaves", "mean_ratio", "p99_ratio", "geo_ratio"):
        np.testing.assert_array_equal([getattr(g, f) for g in proc.groups],
                                      [getattr(g, f) for g in serial.groups])


@pytest.mark.parametrize("flavor", ["nvprof", "nsys"])
def test_fixture_ingest_through_process(tmp_path, flavor):
    """The process backend pickles the resolved trace sources into its
    rank workers: a store from an nvprof or Nsight fixture equals the
    ``serial`` store byte for byte, and the workers' ingest counters
    reach the report."""
    ds = port.generate_synthetic(port.SyntheticSpec(
        n_ranks=2, kernels_per_rank=2000, memcpys_per_rank=300,
        duration_s=12.0, seed=11))
    paths = write_fixture_dbs(ds, str(tmp_path / flavor), flavor=flavor)
    reps = {b: port.VariabilityPipeline(_cfg(port, b)).generate(
        paths, str(tmp_path / f"store_{b}")) for b in ("serial", "process")}
    assert reps["process"].ingest_rows_read == \
        reps["serial"].ingest_rows_read > 0
    assert_shards_equal(str(tmp_path / "store_serial"),
                        str(tmp_path / "store_process"))


# --- the query service -------------------------------------------------------

def test_process_service_answers_as_serial(runs, tmp_path):
    work, _ = runs
    requests = [[{"metrics": ["k_stall"], "group_by": "m_kind"}],
                [{"metrics": ["k_stall", "m_bytes"], "group_by": "k_device",
                  "reducers": ["moments", "quantile"],
                  "anomaly_score": "p99", "interval_ns": 100_000_000}],
                [{"metrics": ["m_duration"], "ranks": [1]}]]
    answers = {}
    for backend in ("serial", "process"):
        store = str(tmp_path / backend)
        shutil.copytree(str(work / "serial"), store)
        port.TraceStore(store).clear_summaries()
        port.TraceStore(store).clear_partials()
        svc = QueryService(store, ServiceConfig(backend=backend,
                                                device="cpu", tick_ms=1.0))
        try:
            out = []
            for specs in requests:
                p = svc.submit([port.Query.from_spec(s) for s in specs])
                assert svc.drain_once(block_s=0.0) == 1
                assert p.error is None, p.error
                out.append(p.results)
        finally:
            svc.stop()
        answers[backend] = out
    assert answers["process"] == answers["serial"]
    assert build_parser().parse_args(
        ["--store", "s", "--backend", "process"]).backend == "process"
    with pytest.raises(ValueError, match="serial | process | torch"):
        ServiceConfig(backend="jax", device="cpu")


# --- no fallback; the start-method rule --------------------------------------

def _no_inprocess_loop(monkeypatch):
    """Make the parent's in-process rank loop fail loudly if reached."""
    def fallback(*args, **kwargs):
        raise AssertionError("phase 1 fell back to the in-process loop")
    monkeypatch.setattr(port_pipeline, "generate_rank", fallback)


def test_worker_that_raises_makes_the_call_raise(small_dataset, tmp_path,
                                                 monkeypatch):
    """A rank worker fails (its pushdown spec names no metric, which only
    the worker parses): the call raises the worker's error, and the
    parent never runs the ranks itself."""
    _, paths = small_dataset
    _no_inprocess_loop(monkeypatch)
    gen = port.GenerationConfig(pushdown={"metrics": []})
    pipe = port.VariabilityPipeline(_cfg(port, "process", generation=gen))
    with pytest.raises(ValueError, match="at least one metric") as err:
        pipe.generate(paths, str(tmp_path / "store"))
    assert isinstance(err.value.__cause__,
                      concurrent.futures.process._RemoteTraceback)


def test_pool_that_cannot_start_makes_the_call_raise(small_dataset,
                                                     tmp_path, monkeypatch):
    _, paths = small_dataset
    _no_inprocess_loop(monkeypatch)

    def broken(n_ranks):
        raise OSError("no processes left")
    monkeypatch.setattr(port_pipeline, "_rank_pool", broken)
    for backend in ("process", "torch"):
        pipe = port.VariabilityPipeline(_cfg(port, backend))
        with pytest.raises(OSError, match="no processes left"):
            pipe.generate(paths, str(tmp_path / backend))


def test_worker_that_dies_breaks_the_pool(tmp_path):
    """A worker that exits mid-task (as one killed by the kernel would)
    raises in the parent instead of hanging the call."""
    with port_pipeline._rank_pool(2) as pool:
        fut = pool.submit(os._exit, 3)
        with pytest.raises(concurrent.futures.process.BrokenProcessPool):
            fut.result(timeout=120)


def test_pool_starts_while_a_scan_pool_thread_is_alive(small_dataset,
                                                       tmp_path):
    """The start-method rule: workers come from a fresh server, never a
    fork of this (threaded) process, so a rank pool started while a
    ScanPool thread of the parent is busy completes, and its shards equal
    the in-process loop's."""
    _, paths = small_dataset
    release = threading.Event()
    with ScanPool(2) as scan:
        holder = threading.Thread(
            target=scan.run_chunks, args=(lambda c: release.wait(60), [[0]]))
        holder.start()
        try:
            got = port.VariabilityPipeline(_cfg(port, "torch")).run(
                paths, str(tmp_path / "pooled"))
            assert any(t.name.startswith("scan-worker") and t.is_alive()
                       for t in threading.enumerate())
        finally:
            release.set()
            holder.join(timeout=60)
        assert not holder.is_alive()
    _assert_workers_on_host(got.generation, 2)
    port.run_generation(paths, str(tmp_path / "inproc"), n_ranks=2)
    assert_shards_equal(str(tmp_path / "inproc"), str(tmp_path / "pooled"))


# --- the pool's servers end with their caller --------------------------------

# Starts a rank pool, runs two tasks on it, prints the pids of the
# forkserver and the resource tracker, and exits.
_POOL_CALLER = """
import json
from multiprocessing import forkserver, resource_tracker
from repro_torch.core import pipeline
with pipeline._rank_pool(2) as pool:
    assert list(pool.map(abs, [-1, -2])) == [1, 2]
print(json.dumps([forkserver._forkserver._forkserver_pid,
                  resource_tracker._resource_tracker._pid]))
"""


def _running(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def test_pool_servers_are_stopped_before_their_caller_exits(tmp_path):
    """A script that ran a rank pool leaves no process behind: the
    forkserver and the resource tracker are stopped and reaped before it
    exits, not left to notice its exit later. Output goes to a file, so
    waiting for the script does not wait for whoever holds its stdout."""
    out = tmp_path / "out.txt"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [port_pipeline._IMPORT_ROOT, os.environ.get("PYTHONPATH", "")])}
    with open(out, "w") as fh:
        proc = subprocess.Popen([sys.executable, "-c", _POOL_CALLER],
                                stdout=fh, env=env)
        assert proc.wait(timeout=300) == 0
    pids = [int(p) for p in out.read_text().strip("[]\n").split(",")]
    assert all(pids)
    assert not [pid for pid in pids if _running(pid)]


def test_stopped_pool_server_starts_again():
    """stop_rank_pool_server reaps this process's servers, and the next
    pool starts them afresh."""
    with port_pipeline._rank_pool(2) as pool:
        assert list(pool.map(abs, [-3, -4])) == [3, 4]
    server = forkserver._forkserver._forkserver_pid
    tracker = resource_tracker._resource_tracker._pid
    port_pipeline.stop_rank_pool_server()
    assert forkserver._forkserver._forkserver_pid is None
    assert resource_tracker._resource_tracker._pid is None
    assert not _running(server) and not _running(tracker)
    with port_pipeline._rank_pool(2) as pool:
        assert list(pool.map(abs, [-5, -6])) == [5, 6]
    assert forkserver._forkserver._forkserver_pid not in (None, server)
