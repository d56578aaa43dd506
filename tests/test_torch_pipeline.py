"""The port's whole slice (phase 1 shards, phase-2 device reduction,
phase-3 fences) against the JAX package, on the CPU.

Tolerances as in tests/test_torch_kernels.py: shard files bitwise; counts
and min/max exact; float32 sums rtol 1e-5; sketch totals exact with at
most 0.1% of rows one bucket over; anomaly flags and windows equal. On
the torch backend itself the reference's bit-identities must hold: a
delta after an append equals a cold run, and a fused query batch equals
each query run alone. Torch results live in their own cache namespace.
"""

import dataclasses
import shutil

import numpy as np
import pytest

import repro.core as ref
import repro_torch.core as port
from repro_torch.core.query import QueryPlan
from repro_torch.core.tracestore import shard_filename
from test_torch_cuda import RTOL, assert_hist_close

METRICS = ("k_stall", "m_duration", "m_bytes")
SUITE = ("moments", "quantile")
STAT_FIELDS = ("count", "sum", "sumsq", "min", "max")
_NS = 1_000_000_000


def _cfg(pkg, backend, **kw):
    extra = {"device": "cpu"} if pkg is port else {}
    return pkg.PipelineConfig(n_ranks=2, backend=backend, metrics=METRICS,
                              group_by="k_device", reducers=SUITE,
                              anomaly_score="p99", **extra, **kw)


def assert_agg_close(got, want, host):
    """The port's float32 device aggregation against the JAX backend's
    (``want``) on METRICS, with the exact host result ``host`` as the
    judge of the m_bytes sketch: XLA's float32 log2 returns a hair under
    the integer at exact powers of two, so the JAX device path puts the
    8192- and 32768-byte copies one bucket low, where the host path and
    the port put them on the bucket edge (ROADMAP, Queue 3)."""
    g, w = got.grouped, want.grouped
    np.testing.assert_array_equal(got.group_keys, want.group_keys)
    np.testing.assert_array_equal(g.count, w.count)
    occ = w.count > 0
    for f in ("min", "max"):
        np.testing.assert_array_equal(np.where(occ, getattr(g, f), 0.0),
                                      np.where(occ, getattr(w, f), 0.0))
    for f in ("sum", "sumsq"):
        np.testing.assert_allclose(getattr(g, f), getattr(w, f), rtol=RTOL)
    counts = got.reduced["quantile"].counts
    assert_hist_close(counts[..., :2, :],
                      want.reduced["quantile"].counts[..., :2, :])
    np.testing.assert_array_equal(counts[..., 2, :],
                                  host.reduced["quantile"].counts[..., 2, :])


def assert_agg_equal(a, b):
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(getattr(a.grouped, f),
                                      getattr(b.grouped, f))
    np.testing.assert_array_equal(a.group_keys, b.group_keys)
    np.testing.assert_array_equal(a.reduced["quantile"].counts,
                                  b.reduced["quantile"].counts)
    assert set(a.copy_kind_bytes) == set(b.copy_kind_bytes)
    for k in a.copy_kind_bytes:
        np.testing.assert_array_equal(a.copy_kind_bytes[k],
                                      b.copy_kind_bytes[k])


@pytest.fixture(scope="module")
def both_runs(small_dataset, tmp_path_factory):
    """The same DBs through the JAX backend of the reference and the
    torch backend of the port."""
    _, paths = small_dataset
    work = tmp_path_factory.mktemp("port_vs_jax")
    runs = {"jax": ref.VariabilityPipeline(_cfg(ref, "jax")),
            "serial": ref.VariabilityPipeline(_cfg(ref, "serial")),
            "torch": port.VariabilityPipeline(_cfg(port, "torch"))}
    return work, {k: p.run(paths, str(work / k)) for k, p in runs.items()}


def test_synthetic_data_identical_to_reference():
    spec = dict(n_ranks=2, kernels_per_rank=300, memcpys_per_rank=50,
                duration_s=5.0, seed=3)
    a = ref.generate_synthetic(ref.SyntheticSpec(**spec))
    b = port.generate_synthetic(port.SyntheticSpec(**spec))
    np.testing.assert_array_equal(a.anomaly_windows, b.anomaly_windows)
    for ta, tb in zip(a.traces, b.traces):
        for table in ("kernels", "memcpys"):
            for f in dataclasses.fields(getattr(ta, table)):
                np.testing.assert_array_equal(
                    getattr(getattr(ta, table), f.name),
                    getattr(getattr(tb, table), f.name))


def test_shard_files_bitwise_equal(both_runs):
    work, res = both_runs
    torch_res = res["torch"]
    idx = port.TraceStore(str(work / "torch")).shard_indices()
    assert idx == ref.TraceStore(str(work / "jax")).shard_indices()
    assert len(idx) == torch_res.generation.n_shards
    for i in idx:
        with open(work / "jax" / shard_filename(i), "rb") as fa, \
                open(work / "torch" / shard_filename(i), "rb") as fb:
            assert fa.read() == fb.read()


def test_port_matches_jax_backend(both_runs):
    _, res = both_runs
    assert_agg_close(res["torch"].aggregation, res["jax"].aggregation,
                     res["serial"].aggregation)
    a, b = res["torch"].anomalies, res["jax"].anomalies
    np.testing.assert_array_equal(a.flags, b.flags)
    np.testing.assert_array_equal(a.top_idx, b.top_idx)
    np.testing.assert_array_equal(a.top_windows, b.top_windows)
    np.testing.assert_allclose([a.q1, a.q3, a.hi_fence],
                               [b.q1, b.q3, b.hi_fence], rtol=RTOL)


def test_port_answers_a_store_written_by_the_reference(both_runs):
    work, res = both_runs
    q = port.Query(metrics=METRICS, group_by="k_device", reducers=SUITE)
    got = port.run_aggregation(str(work / "jax"), query=q, backend="torch",
                               device="cpu")
    assert not got.from_cache          # never JAX's float32 entries
    assert_agg_close(got, res["jax"].aggregation, res["serial"].aggregation)


# --- bit-identities on the torch backend -----------------------------------

@pytest.fixture(scope="module")
def trace():
    """A synthetic trace and a cut-off 30 s into it."""
    ds = port.generate_synthetic(port.SyntheticSpec(
        n_ranks=2, kernels_per_rank=4000, memcpys_per_rank=600,
        duration_s=40.0, n_anomaly_windows=2, seed=11))
    t0 = int(ds.traces[0].kernels.start.min())
    return ds, (t0 // _NS) * _NS + 30 * _NS


@pytest.fixture
def grown(trace, tmp_path):
    """Rank DBs cut at the cut-off and their store; ``grow()`` appends
    the rest of the trace to the DBs (not yet to the store)."""
    ds, cutoff = trace
    paths = [str(tmp_path / f"rank{tr.rank}.sqlite") for tr in ds.traces]
    for tr, p in zip(ds.traces, paths):
        port.write_rank_db(p, port.truncate_trace(tr, cutoff))
    store = str(tmp_path / "store")
    port.run_generation(paths, store, n_ranks=2)

    def grow():
        for tr, p in zip(ds.traces, paths):
            port.append_rank_db(p, port.trace_remainder(tr, cutoff))
    return store, paths, grow


def _cold(store, query):
    cs = port.TraceStore(store)
    cs.clear_summaries()
    cs.clear_partials()
    return port.run_queries(cs, [query], backend="torch", device="cpu")[0]


def test_torch_delta_bit_identical_to_cold(grown, tmp_path):
    store, paths, grow = grown
    q = port.Query(metrics=METRICS[:2], group_by="m_kind", reducers=SUITE)
    port.run_queries(store, [q], backend="torch", device="cpu")  # warm
    grow()
    port.run_append(paths, store)
    fresh = port.TraceStore(store)
    delta = port.run_queries(fresh, [q], backend="torch", device="cpu")[0]
    assert not delta.cache_hit and delta.partial_hits > 0
    assert fresh.io_counts["shard_reads"] < fresh.read_manifest().n_shards
    cold_dir = str(tmp_path / "cold")
    shutil.copytree(store, cold_dir)
    cold = _cold(cold_dir, q)
    assert cold.partial_hits == 0
    assert_agg_equal(delta.result, cold.result)


def test_pipeline_append_bit_identical_to_cold(grown, tmp_path):
    store, paths, grow = grown
    pipe = port.VariabilityPipeline(_cfg(port, "torch"))
    pipe.aggregate(store)                      # warm partials pre-append
    grow()
    res = pipe.append(paths, store)
    assert res.aggregation.partial_hits > 0
    cold_dir = str(tmp_path / "cold")
    shutil.copytree(store, cold_dir)
    cold = _cold(cold_dir, pipe.cfg.to_query())
    assert_agg_equal(res.aggregation, cold.result)


def _mixed_queries(store):
    man = port.TraceStore(store).read_manifest()
    edges = port.ShardPlan(man.t_start, man.t_end, man.n_shards).boundaries()
    return [
        port.Query(metrics=("k_stall",), group_by="m_kind"),
        port.Query(metrics=("m_duration", "m_bytes"), group_by="m_kind",
                   transfer_kinds=(1, 2)),
        port.Query(metrics=("k_stall", "m_duration"), reducers=SUITE,
                   ranks=(0,)),
        port.Query(metrics=("m_bytes",),
                   time_window=(int(edges[1]), int(edges[5]))),
    ]


def test_fused_batch_equals_standalone_torch(grown, tmp_path):
    store = grown[0]
    queries = _mixed_queries(store)
    pipe = port.VariabilityPipeline(_cfg(port, "torch"))
    fused_dir = str(tmp_path / "fused")
    shutil.copytree(store, fused_dir)
    fused = pipe.query(fused_dir, queries)
    assert not any(qr.cache_hit for qr in fused)
    for k, (q, qf) in enumerate(zip(queries, fused)):
        solo_dir = str(tmp_path / f"solo{k}")
        shutil.copytree(store, solo_dir)
        solo = pipe.query(solo_dir, [q])[0]
        for f in STAT_FIELDS:
            np.testing.assert_array_equal(getattr(solo.result.grouped, f),
                                          getattr(qf.result.grouped, f))
        if "quantile" in q.canonical_reducers:
            np.testing.assert_array_equal(
                solo.result.reduced["quantile"].counts,
                qf.result.reduced["quantile"].counts)
        np.testing.assert_array_equal(solo.anomalies.scores,
                                      qf.anomalies.scores)


# --- cache namespaces -------------------------------------------------------

def test_torch_entries_never_serve_exact_or_jax(grown):
    store = grown[0]
    spec = dict(metrics=METRICS[:2], group_by="m_kind")
    q, q_ref = port.Query(**spec), ref.Query(**spec)
    first = port.run_aggregation(store, query=q, backend="torch",
                                 device="cpu")
    assert not first.from_cache
    again = port.run_aggregation(store, query=q, backend="torch",
                                 device="cpu")
    assert again.from_cache                     # torch reuses its own entry
    plan = QueryPlan.compile(store, [q], backend="torch", device="cpu")
    assert plan.lanes[0].precision == "torch-float32"
    exact = port.run_aggregation(store, query=q, backend="serial")
    assert not exact.from_cache and exact.partial_hits == 0
    ref_jax = ref.run_aggregation(store, query=q_ref, backend="jax")
    assert not ref_jax.from_cache and ref_jax.partial_hits == 0
    ref_exact = ref.run_aggregation(store, query=q_ref)
    assert ref_exact.from_cache                 # the port's serial entry
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(getattr(exact.grouped, f),
                                      getattr(ref_exact.grouped, f))


# --- the producer's host record under overlapping calls ---------------------

def test_producer_records_stay_whole_across_overlapping_calls(grown):
    """Two torch producer calls in two threads, the second running
    entirely between the first's end and its read: each thread reads
    its own call's record (rows, segments, metrics), never the other's."""
    import threading

    from repro_torch.core.aggregation import (compute_lane_partials_torch,
                                              producer_stats)
    store = port.TraceStore(grown[0])
    n = store.read_manifest().n_shards
    jobs = {"a": (port.Query(metrics=METRICS, group_by="k_device",
                             reducers=SUITE), range(0, n // 3)),
            "b": (port.Query(metrics=METRICS[:1]), range(n // 3, n))}

    def run(name):
        q, shards = jobs[name]
        plan = QueryPlan.compile(store, [q], backend="torch", device="cpu")
        compute_lane_partials_torch(store, [(s, [0]) for s in shards],
                                    plan.lanes, plan.device, persist=False)

    def shape(record):
        return [{k: v for k, v in r.items() if k != "order_seconds"}
                for r in record]

    alone = {}
    for name in jobs:
        run(name)
        alone[name] = shape(producer_stats())
    assert alone["a"] != alone["b"] and all(alone.values())

    a_done, b_done = threading.Event(), threading.Event()
    seen, errors = {}, []

    def thread_a():
        try:
            run("a")
            a_done.set()
            assert b_done.wait(60)
            seen["a"] = shape(producer_stats())
        except BaseException as e:       # noqa: BLE001 — reported below
            errors.append(e)
            a_done.set()

    def thread_b():
        try:
            assert a_done.wait(60)
            run("b")
            seen["b"] = shape(producer_stats())
        except BaseException as e:       # noqa: BLE001
            errors.append(e)
        finally:
            b_done.set()

    threads = [threading.Thread(target=thread_a),
               threading.Thread(target=thread_b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors, errors
    assert seen == alone
