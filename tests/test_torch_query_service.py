"""The port's v1 query service (``repro_torch.serve.query_service``)
against the JAX package's, on the CPU.

The reference's service scenarios (tests/test_query_service.py) run on
the port's ``serial`` backend and on ``torch`` with ``device="cpu"``
(the kernels' plain versions). Then one request list goes through a
reference ``serial`` service and a port service on copies of one store:
``serial`` must equal ``serial`` exactly; ``torch`` must give the same
counts, min/max (in float32) and fence flags, with sums within rtol 1e-5.
"""

import json
import os
import shutil
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import repro.serve.query_service as ref_qs
from repro.core import Query as RefQuery
from repro_torch.core import (Query, SyntheticSpec, TraceStore,
                              generate_synthetic, run_generation,
                              run_queries, write_rank_db)
from repro_torch.core.aggregation import ScanPool
from repro_torch.core.tracestore import summary_filename
from repro_torch.serve.query_service import (BudgetExceeded, QueryService,
                                             ServiceConfig)

RTOL = 1e-5
BACKENDS = ("serial", "torch")


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    spec = SyntheticSpec(n_ranks=2, kernels_per_rank=2000,
                         memcpys_per_rank=300, duration_s=20.0, seed=7)
    ds = generate_synthetic(spec)
    root = tmp_path_factory.mktemp("torch_svc_base")
    paths = []
    for tr in ds.traces:
        p = str(root / f"rank{tr.rank}.sqlite")
        write_rank_db(p, tr)
        paths.append(p)
    store_dir = str(root / "store")
    run_generation(paths, store_dir, n_ranks=2)
    return store_dir


@pytest.fixture
def store_dir(base, tmp_path):
    dst = str(tmp_path / "s")
    shutil.copytree(base, dst)
    return dst


def _cfg(backend, **kw):
    return ServiceConfig(backend=backend, device="cpu", **kw)


def _post(port_, specs, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port_}/query",
        data=json.dumps(specs).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_config_defaults_to_the_card():
    fields = ServiceConfig.__dataclass_fields__
    assert fields["backend"].default == "torch"
    assert fields["device"].default == "cuda"
    with pytest.raises(ValueError, match="unknown backend"):
        ServiceConfig(backend="jax", device="cpu")
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServiceConfig()


@pytest.mark.parametrize("backend", BACKENDS)
def test_http_round_trip_matches_direct_run_queries(store_dir, backend):
    svc = QueryService(store_dir, _cfg(backend, tick_ms=5.0, port=0))
    svc.start(serve_http=True)
    try:
        status, body = _post(svc.cfg.port,
                             [{"metrics": ["k_stall"],
                               "group_by": "m_kind"}])
        assert status == 200
        r = body["results"][0]
        direct = run_queries(
            TraceStore(store_dir),
            [Query(metrics=("k_stall",), group_by="m_kind")],
            backend=backend, device="cpu")[0]
        g = direct.result.grouped
        cnt = g.count.sum(axis=0)
        tot = g.sum.sum(axis=0)
        for gi, gk in enumerate(
                np.asarray(direct.result.group_keys).ravel()):
            got = r["groups"][f"{float(gk):g}"]["k_stall"]
            assert got["count"] == int(cnt[gi, 0])
            np.testing.assert_allclose(got["mean"],
                                       tot[gi, 0] / cnt[gi, 0])
        assert r["n_samples"] == int(cnt.sum())
        for f in ("cache_hit", "recomputed_shards", "partial_hits",
                  "shards_pruned", "rows_scanned", "provenance"):
            assert f in r
        status, body = _post(svc.cfg.port,
                             [{"metrics": ["k_stall"],
                               "group_by": "m_kind"}])
        assert status == 200
        assert body["results"][0]["cache_hit"]
    finally:
        svc.stop()


@pytest.mark.parametrize("backend", BACKENDS)
def test_submitted_requests_drain_into_one_fused_plan(store_dir, backend):
    svc = QueryService(store_dir, _cfg(backend, tick_ms=1.0))
    pendings = [
        svc.submit([Query(metrics=("k_stall",), group_by="m_kind")]),
        svc.submit([Query(metrics=("m_duration",), ranks=(0,)),
                    Query(metrics=("m_bytes",), group_by="k_device")]),
        svc.submit([Query(metrics=("k_stall",), group_by="m_kind"),
                    Query(metrics=("k_stall",), anomaly_score="p99")]),
    ]
    assert svc.drain_once(block_s=0.0) == 3
    for p in pendings:
        assert p.done.is_set() and p.error is None
        assert p.tick_info["fused_width"] == 5
        assert p.tick_info["batched_fused"] is True
        assert len(p.results) == len(p.queries)
    assert pendings[2].results[1]["anomalous_bins"] >= 0
    assert svc.stats()["max_fused_width"] == 5
    assert svc.drain_once(block_s=0.0) == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_over_budget_request_is_rejected_413(store_dir, backend):
    svc = QueryService(store_dir, _cfg(
        backend, tick_ms=1.0, max_cells_per_request=100_000, port=0))
    with pytest.raises(BudgetExceeded):
        svc.submit([Query(metrics=("k_stall",), interval_ns=1_000)])
    svc.start(serve_http=True)
    try:
        status, body = _post(svc.cfg.port,
                             [{"metrics": ["k_stall"],
                               "interval_ns": 1000}])
        assert status == 413
        assert body["error"]["code"] == "budget_exceeded"
        assert "budget" in body["error"]["message"]
        assert QueryService(store_dir, _cfg(backend)).store.io_counts[
            "shard_reads"] == 0
    finally:
        svc.stop()


@pytest.mark.parametrize("backend", BACKENDS)
def test_lru_never_evicts_summary_read_within_same_tick(store_dir,
                                                        backend):
    svc = QueryService(store_dir, _cfg(backend, tick_ms=1.0,
                                       summary_budget_bytes=1))
    q_a = Query(metrics=("k_stall",), group_by="m_kind")
    q_b = Query(metrics=("m_duration",), group_by="m_kind")

    p = svc.submit([q_a])
    svc.drain_once(block_s=0.0)
    assert p.error is None and p.tick_info["evicted"] == 0
    keys_after_a = set(svc.store.summary_keys())
    assert len(keys_after_a) == 1

    p = svc.submit([q_b])
    svc.drain_once(block_s=0.0)
    assert p.error is None and p.tick_info["evicted"] == 1
    keys_after_b = set(svc.store.summary_keys())
    assert len(keys_after_b) == 1
    assert keys_after_b != keys_after_a
    (key_b,) = keys_after_b
    assert os.path.exists(os.path.join(svc.store.root,
                                       summary_filename(key_b)))
    # evicting a summary is safe: A recomputes from partials, no rescan
    fresh = TraceStore(store_dir)
    res = run_queries(fresh, [q_a], backend=backend, device="cpu")[0]
    assert res.result.partial_hits > 0
    assert fresh.io_counts["shard_reads"] == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_scan_pool_results_bit_identical_to_inline(store_dir, backend):
    """Cold fused scans handed a 4-worker ScanPool equal the inline
    path's tensors exactly. The serial producer fans its scans over the
    pool; the torch producer ignores it (its work is one device
    reduction per reducer), so the pool runs no task."""
    queries = [Query(metrics=("k_stall",), group_by="m_kind"),
               Query(metrics=("m_duration", "m_bytes"),
                     group_by="m_kind"),
               Query(metrics=("k_stall",), anomaly_score="p99")]
    store = TraceStore(store_dir)
    store.clear_summaries()
    store.clear_partials()
    inline = run_queries(store, queries, backend=backend, device="cpu")
    store.clear_summaries()
    store.clear_partials()
    with ScanPool(4) as pool:
        pooled = run_queries(store, queries, pool=pool, backend=backend,
                             device="cpu")
        util = pool.utilization()
    assert util["workers"] == 4
    assert (util["tasks"] > 0) == (backend == "serial")
    for a, b in zip(inline, pooled):
        assert np.array_equal(a.result.group_keys, b.result.group_keys)
        for name, sa in a.result.reduced.items():
            sb = b.result.reduced[name]
            for f in sa.fields:
                assert np.array_equal(getattr(sa, f), getattr(sb, f))


@pytest.mark.parametrize("backend", BACKENDS)
def test_overlapping_ticks_share_inflight_computation(store_dir, backend,
                                                      monkeypatch):
    started, release = threading.Event(), threading.Event()
    orig = QueryService._exec_tick

    def stalling_exec(self, tick):
        if tick.owned:
            started.set()
            release.wait(10)
        orig(self, tick)

    monkeypatch.setattr(QueryService, "_exec_tick", stalling_exec)
    svc = QueryService(store_dir, _cfg(
        backend, tick_ms=1.0, pipeline_depth=2, scan_workers=1))
    svc.start(serve_http=False)
    try:
        q = Query(metrics=("k_stall",), group_by="m_kind")
        pa = svc.submit([q])
        assert started.wait(5)
        pb = svc.submit([q])
        time.sleep(0.2)
        release.set()
        assert pa.done.wait(10) and pb.done.wait(10)
        assert pa.error is None and pb.error is None
        assert pa.results[0].get("inflight_hit") is None
        assert pb.results[0]["inflight_hit"] is True
        assert pb.results[0]["groups"] == pa.results[0]["groups"]
        assert svc.stats()["inflight_hits"] == 1
    finally:
        release.set()
        svc.stop()


@pytest.mark.parametrize("backend", BACKENDS)
def test_dead_tick_worker_yields_503_tick_timeout(store_dir, backend,
                                                  monkeypatch):
    killed = threading.Event()
    orig = QueryService._pipeline_task

    def dying_task(self, tick):
        if not killed.is_set():
            killed.set()
            return
        orig(self, tick)

    monkeypatch.setattr(QueryService, "_pipeline_task", dying_task)
    svc = QueryService(store_dir, _cfg(
        backend, tick_ms=1.0, pipeline_depth=2, scan_workers=1,
        request_timeout_s=0.5, port=0))
    svc.start(serve_http=True)
    try:
        status, body = _post(svc.cfg.port,
                             [{"metrics": ["k_stall"],
                               "group_by": "m_kind"}], timeout=30)
        assert status == 503
        assert body["error"]["code"] == "tick_timeout"
        status, body = _post(svc.cfg.port,
                             [{"metrics": ["m_bytes"],
                               "group_by": "k_device"}], timeout=30)
        assert status == 200
        assert body["results"][0]["n_samples"] > 0
    finally:
        svc.stop()


@pytest.mark.parametrize("backend", BACKENDS)
def test_pack_budget_evicts_only_committed_ticks_packs(store_dir, backend):
    svc = QueryService(store_dir, _cfg(backend, tick_ms=1.0,
                                       pack_budget_bytes=1))
    q_full = Query(metrics=("k_stall",), group_by="m_kind")
    p = svc.submit([q_full])
    svc.drain_once(block_s=0.0)
    assert p.error is None
    first = p.results[0]
    packs_after_full = set(svc.store.pack_sizes())
    assert packs_after_full
    assert svc.stats()["pack_evictions"] == 0

    man = svc.man
    span = int(man.t_end - man.t_start)
    q_win = Query(metrics=("k_stall",),
                  time_window=(int(man.t_start),
                               int(man.t_start + span // 4)))
    p = svc.submit([q_win])
    svc.drain_once(block_s=0.0)
    assert p.error is None
    assert svc.stats()["pack_evictions"] > 0
    assert set(svc.store.pack_sizes()) < packs_after_full

    svc.store.clear_summaries()
    p = svc.submit([q_full])
    svc.drain_once(block_s=0.0)
    assert p.error is None
    assert p.results[0]["groups"] == first["groups"]
    assert p.results[0]["n_samples"] == first["n_samples"]


def test_failing_kernel_answers_500_and_never_falls_back(store_dir,
                                                         monkeypatch):
    """A kernel that raises inside a tick answers that tick's request
    with HTTP 500 (``internal``), on the scan and on the fence, and no
    plain version answers in its place; the service keeps serving."""
    from repro_torch.core import anomaly, distributed
    calls = {"n": 0}

    def broken(*a, **k):
        calls["n"] += 1
        raise RuntimeError("kernel launch failed")

    svc = QueryService(store_dir, _cfg("torch", tick_ms=1.0, port=0))
    svc.start(serve_http=True)
    try:
        with monkeypatch.context() as m:
            m.setattr(distributed, "binstats_flat", broken)
            status, body = _post(svc.cfg.port,
                                 [{"metrics": ["k_stall"],
                                   "group_by": "m_kind"}])
        assert status == 500 and body["error"]["code"] == "internal"
        assert "kernel launch failed" in body["error"]["message"]
        with monkeypatch.context() as m:
            m.setattr(anomaly, "iqr_fences", broken)
            status, body = _post(svc.cfg.port,
                                 [{"metrics": ["k_stall"],
                                   "anomaly_score": "p99"}])
        assert status == 500 and body["error"]["code"] == "internal"
        assert calls["n"] == 2
        status, body = _post(svc.cfg.port,
                             [{"metrics": ["k_stall"],
                               "anomaly_score": "p99"}])
        assert status == 200
    finally:
        svc.stop()


# --- the port's service against the reference's -----------------------------

REQUESTS = [
    [{"metrics": ["k_stall"]},
     {"metrics": ["k_stall", "m_duration"], "group_by": "k_device"}],
    [{"metrics": ["m_duration"], "group_by": "m_kind",
      "reducers": ["moments", "quantile"], "anomaly_score": "p95"}],
    [{"metrics": ["k_stall"], "group_by": "src_rank",
      "anomaly_score": "p99", "interval_ns": 100_000_000}],
    [{"metrics": ["m_bytes"], "group_by": "k_name",
      "interval_ns": 1_000_000_000},
     {"metrics": ["k_stall"], "anomaly_score": "p99", "ranks": [0]}],
]


def _serve_list(svc, requests, make_query):
    """Each request list through ``submit`` + one ``drain_once`` a
    request (deterministic ticks)."""
    out = []
    for specs in requests:
        p = svc.submit([make_query(s) for s in specs])
        assert svc.drain_once(block_s=0.0) == 1
        assert p.error is None, p.error
        out.append(p.results)
    return out


def _requests_with_window(store_dir):
    man = TraceStore(store_dir).read_manifest()
    span = int(man.t_end - man.t_start)
    win = [int(man.t_start + span // 3), int(man.t_start + 2 * span // 3)]
    return REQUESTS + [[{"metrics": ["k_stall"], "group_by": "m_kind",
                         "time_window": win, "anomaly_score": "p99",
                         "interval_ns": 10_000_000}]]


@pytest.fixture
def three_copies(base, tmp_path):
    out = {}
    for tag in ("ref", "serial", "torch"):
        out[tag] = str(tmp_path / tag)
        shutil.copytree(base, out[tag])
    return out


def test_port_service_answers_as_reference_serial(three_copies):
    requests = _requests_with_window(three_copies["ref"])
    want = _serve_list(
        ref_qs.QueryService(three_copies["ref"],
                            ref_qs.ServiceConfig(tick_ms=1.0)),
        requests, RefQuery.from_spec)
    exact = _serve_list(
        QueryService(three_copies["serial"], _cfg("serial", tick_ms=1.0)),
        requests, Query.from_spec)
    assert exact == want
    dev = _serve_list(
        QueryService(three_copies["torch"], _cfg("torch", tick_ms=1.0)),
        requests, Query.from_spec)
    n_fenced = 0
    for got_list, want_list in zip(dev, want):
        for got, w in zip(got_list, want_list):
            assert got["query"] == w["query"]
            assert got["n_samples"] == w["n_samples"]
            assert got["n_bins"] == w["n_bins"]
            assert got.get("anomalous_bins") == w.get("anomalous_bins")
            n_fenced += "anomalous_bins" in w
            assert set(got["groups"]) == set(w["groups"])
            for gk, per_metric in w["groups"].items():
                for m, cell in per_metric.items():
                    mine = got["groups"][gk][m]
                    assert mine["count"] == cell["count"]
                    for f in ("min", "max"):
                        assert np.float32(mine[f]) == np.float32(cell[f])
                    np.testing.assert_allclose(mine["mean"], cell["mean"],
                                               rtol=RTOL)
    assert n_fenced >= 3
