"""The port's streaming ingest plane and v1 HTTP surface
(``repro_torch.serve.stream``, ``repro_torch.serve.client``) against the
JAX package's, on the CPU.

The reference's stream scenarios (tests/test_stream.py) run on the port's
``torch`` backend with ``device="cpu"`` (the kernels' plain versions;
the first also on ``serial``). The fence push over HTTP is made
race-free: the plane is quiesced first, then every event is read, then a
fresh poll must come back empty. Last, the same growth through
``submit`` + ``drain_once`` in both packages publishes the same fence
events (kind, bins added and removed, rows ingested).
"""

import os
import shutil
import threading
import time
import warnings

import numpy as np
import pytest

import repro.core as ref
import repro.serve as ref_serve
from repro_torch.core import (PipelineConfig, Query, SyntheticSpec,
                              TraceStore, VariabilityPipeline,
                              append_rank_db, generate_synthetic,
                              run_aggregation, run_generation,
                              trace_remainder, truncate_trace,
                              write_rank_db)
from repro_torch.serve import (IngestConfig, QueryClient, QueryService,
                               ServiceConfig, ServiceError)

_NS = 1_000_000_000
SUITE_QUERY = Query(metrics=("k_stall", "m_duration"), group_by="src_rank",
                    reducers=("moments", "quantile"))


@pytest.fixture(scope="module")
def growing():
    """A live profiler run: snapshots at 12 s, the rest arriving later
    in batches at the same DB paths (fresh larger rowids)."""
    spec = SyntheticSpec(n_ranks=2, kernels_per_rank=4000,
                         memcpys_per_rank=500, duration_s=24.0,
                         n_anomaly_windows=2, seed=7)
    ds = generate_synthetic(spec)
    t0 = int(ds.traces[0].kernels.start.min())
    cutoff = (t0 // _NS) * _NS + 12 * _NS
    return ds, cutoff


def _cfg(backend="torch", **kw):
    return ServiceConfig(backend=backend, device="cpu", **kw)


def _snapshot_dbs(ds, cutoff, root):
    db_dir = os.path.join(str(root), "dbs")
    os.makedirs(db_dir, exist_ok=True)
    paths = [os.path.join(db_dir, f"rank{tr.rank}.sqlite")
             for tr in ds.traces]
    for tr, p in zip(ds.traces, paths):
        write_rank_db(p, truncate_trace(tr, cutoff))
    return paths


def _snapshot_store(ds, cutoff, root):
    paths = _snapshot_dbs(ds, cutoff, root)
    store_dir = os.path.join(str(root), "store")
    run_generation(paths, store_dir, n_ranks=2)
    return paths, store_dir


def _grow(ds, paths, lo, hi=None):
    for tr, p in zip(ds.traces, paths):
        batch = (trace_remainder(tr, lo) if hi is None else
                 trace_remainder(truncate_trace(tr, hi), lo))
        append_rank_db(p, batch)


def _assert_identical_to_cold_rebuild(store_dir, paths, root):
    cold = os.path.join(str(root), "cold")
    run_generation(paths, cold, n_ranks=2)
    a = run_aggregation(store_dir, query=SUITE_QUERY)
    b = run_aggregation(cold, query=SUITE_QUERY)
    for f in ("count", "sum", "sumsq", "min", "max"):
        np.testing.assert_array_equal(getattr(a.grouped, f),
                                      getattr(b.grouped, f))
    np.testing.assert_array_equal(a.group_keys, b.group_keys)
    np.testing.assert_array_equal(a.reduced["quantile"].counts,
                                  b.reduced["quantile"].counts)


# --- deterministic ingest ticks (no threads: submit + drain_once) ----------

@pytest.mark.parametrize("backend", ["serial", "torch"])
def test_ingest_tick_rides_pipeline_and_diffs_fences(growing, tmp_path,
                                                     backend):
    ds, cutoff = growing
    paths, store_dir = _snapshot_store(ds, cutoff, tmp_path)
    svc = QueryService(store_dir, _cfg(backend, tick_ms=1.0))
    ing = svc.ensure_ingestor(IngestConfig())
    assert ing.attach(paths) == [os.path.abspath(p) for p in paths]
    assert all(w > (0, 0) for w in ing.watermarks().values())
    assert ing.poll_once() == []

    _grow(ds, paths, cutoff)
    assert sorted(ing.poll_once()) == sorted(ing.attached())
    p = ing.submit(t_detect=time.monotonic())
    assert svc.drain_once(block_s=0.0) == 1
    assert p.error is None
    info = p.tick_info["ingest"]
    assert p.tick_info["kind"] == "ingest"
    assert info["rows_ingested"] > 0
    assert info["dirty_shards"] or info["n_new_shards"]
    assert info["event_to_fence_ms"] > 0.0
    events = ing.hub.events_since(0)
    assert len(events) == 1 and events[0]["kind"] in ("fence", "ingest")
    assert events[0]["ingest"]["rows_ingested"] == info["rows_ingested"]
    assert ing.poll_once() == []

    p2 = ing.submit(t_detect=time.monotonic())
    assert svc.drain_once(block_s=0.0) == 1
    assert p2.error is None
    assert p2.tick_info["ingest"]["rows_ingested"] == 0
    assert ing.hub.events_since(events[0]["seq"]) == []

    st = ing.stats()
    assert st["ingest_ticks"] == 2
    assert st["rows_ingested"] == info["rows_ingested"]
    assert st["event_to_fence_p99_ms"] > 0.0
    _assert_identical_to_cold_rebuild(store_dir, paths, tmp_path)


def test_interrupted_ingest_tick_recovers_via_journal(growing, tmp_path,
                                                      monkeypatch):
    ds, cutoff = growing
    paths, store_dir = _snapshot_store(ds, cutoff, tmp_path)
    svc = QueryService(store_dir, _cfg(tick_ms=1.0))
    ing = svc.ensure_ingestor(IngestConfig())
    ing.attach(paths)
    _grow(ds, paths, cutoff)

    real = TraceStore.commit_staged_shard
    calls = {"n": 0}

    def crashing_commit(self, idx):
        calls["n"] += 1
        if calls["n"] > 1:
            raise RuntimeError("injected crash mid-commit")
        return real(self, idx)

    monkeypatch.setattr(TraceStore, "commit_staged_shard",
                        crashing_commit)
    p = ing.submit(t_detect=time.monotonic())
    assert svc.drain_once(block_s=0.0) == 1
    assert p.error is not None
    assert p.error[0] == 500 and p.error[1] == "ingest_failed"
    assert "injected crash" in p.error[2]
    assert calls["n"] > 1
    intent = os.path.join(store_dir, "append_intent.json")
    assert os.path.exists(intent)
    assert ing.stats()["errors"] == 1

    monkeypatch.setattr(TraceStore, "commit_staged_shard", real)
    p2 = ing.submit(t_detect=time.monotonic())
    assert svc.drain_once(block_s=0.0) == 1
    assert p2.error is None
    info = p2.tick_info["ingest"]
    assert info["recovered"] is True
    assert info["rows_ingested"] == 0
    assert not os.path.exists(intent)
    assert ing.stats()["recoveries"] == 1
    assert ing.poll_once() == []
    _assert_identical_to_cold_rebuild(store_dir, paths, tmp_path)


def test_live_writer_mid_tail_no_duplicate_no_lost_rows(growing,
                                                        tmp_path):
    ds, cutoff = growing
    paths, store_dir = _snapshot_store(ds, cutoff, tmp_path)
    svc = QueryService(store_dir, _cfg(
        tick_ms=1.0, ingest=IngestConfig(poll_ms=5.0)))
    ing = svc.ensure_ingestor()
    ing.attach(paths)
    svc.start(serve_http=False)
    try:
        cuts = [cutoff + k * 3 * _NS for k in range(1, 4)] + [None]

        def writer():
            lo = cutoff
            for hi in cuts:
                _grow(ds, paths, lo, hi)
                lo = hi
                time.sleep(0.02)        # overlap writes with ingests

        t = threading.Thread(target=writer)
        t.start()
        t.join()
        assert ing.quiesce(timeout_s=60.0)
        st = ing.stats()
        assert st["errors"] == 0
        assert st["ingest_ticks"] >= 1
    finally:
        svc.stop()
    _assert_identical_to_cold_rebuild(store_dir, paths, tmp_path)


def test_failing_fence_kernel_fails_the_tick_not_the_plane(growing,
                                                           tmp_path,
                                                           monkeypatch):
    """An ``iqr`` kernel that raises in the commit stage's fence diff
    fails that ingest tick (HTTP 500 triple, ``errors`` counted); the
    next tick fences again, with no plain version in its place."""
    from repro_torch.core import anomaly
    ds, cutoff = growing
    paths, store_dir = _snapshot_store(ds, cutoff, tmp_path)
    svc = QueryService(store_dir, _cfg(tick_ms=1.0))
    ing = svc.ensure_ingestor(IngestConfig())
    ing.attach(paths)
    _grow(ds, paths, cutoff, cutoff + 6 * _NS)
    real = anomaly.iqr_fences

    def broken(*a, **k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(anomaly, "iqr_fences", broken)
    p = ing.submit(t_detect=time.monotonic())
    assert svc.drain_once(block_s=0.0) == 1
    assert p.error is not None
    assert p.error[:2] == (500, "fence_failed")
    assert "kernel launch failed" in p.error[2]
    assert ing.stats()["errors"] == 1
    monkeypatch.setattr(anomaly, "iqr_fences", real)
    _grow(ds, paths, cutoff + 6 * _NS)
    p2 = ing.submit(t_detect=time.monotonic())
    assert svc.drain_once(block_s=0.0) == 1
    assert p2.error is None
    assert ing.poll_once() == []
    _assert_identical_to_cold_rebuild(store_dir, paths, tmp_path)


# --- the v1 HTTP surface ---------------------------------------------------

def _raw_get(port, path):
    import json as _json
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, dict(r.headers), _json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), _json.loads(e.read())


def test_v1_routes_envelope_and_legacy_deprecation(growing, tmp_path):
    ds, cutoff = growing
    paths, store_dir = _snapshot_store(ds, cutoff, tmp_path)
    svc = QueryService(store_dir, _cfg(tick_ms=2.0, port=0)).start()
    c = QueryClient(port=svc.cfg.port)
    try:
        assert c.wait_healthy(timeout_s=10.0)
        assert c.healthz()["api"] == "v1"
        assert c.stats()["ingest"] is None

        r = c.query(Query(metrics=("k_stall",), group_by="m_kind"))
        assert r["n_samples"] > 0

        for path in ("/healthz", "/stats"):
            status, hdr, _ = _raw_get(svc.cfg.port, path)
            assert status == 200
            assert hdr.get("Deprecation") == "true"
            assert "successor-version" in hdr.get("Link", "")
        status, hdr, _ = _raw_get(svc.cfg.port, "/v1/healthz")
        assert status == 200 and "Deprecation" not in hdr

        status, _, body = _raw_get(svc.cfg.port, "/v1/nope")
        assert status == 404
        assert body["error"]["code"] == "not_found"
        with pytest.raises(ServiceError) as ei:
            c.fences(since=0, timeout_s=0.2)
        assert ei.value.status == 409
        assert ei.value.code == "no_ingest_plane"
        with pytest.raises(ServiceError) as ei:
            c.attach([])
        assert ei.value.status == 400
        assert ei.value.code == "bad_request"
        with pytest.raises(ServiceError) as ei:
            c.query({"metrics": ["k_stall"], "interval_ns": "bogus"})
        assert ei.value.code == "bad_request"
    finally:
        svc.stop()


def test_fence_push_received_over_http(growing, tmp_path):
    """``VariabilityPipeline.stream`` serves a store already tailing its
    rank DBs; a live write produces fence events a ``QueryClient``
    reads. Race-free: quiesce first, then read every event, then a
    fresh poll must be empty."""
    ds, cutoff = growing
    paths, store_dir = _snapshot_store(ds, cutoff, tmp_path)
    pipe = VariabilityPipeline(PipelineConfig(n_ranks=2, device="cpu"))
    svc = pipe.stream(store_dir, paths,
                      ingest=IngestConfig(poll_ms=5.0), tick_ms=2.0)
    assert svc.cfg.backend == "torch" and svc.cfg.device == "cpu"
    c = QueryClient(port=svc.cfg.port)
    try:
        assert c.wait_healthy(timeout_s=10.0)
        assert c.healthz()["ingest"] is True
        _grow(ds, paths, cutoff)
        assert svc.ingestor.quiesce(timeout_s=60.0)
        events, since = [], 0
        while True:
            body = c.fences(since=since, timeout_s=0.2)
            if not body["events"]:
                break
            events += body["events"]
            assert body["next_since"] >= body["events"][-1]["seq"]
            since = body["next_since"]
        assert events, "no fence event after quiesce"
        assert all(e["kind"] in ("fence", "ingest") for e in events)
        st = c.stats()["ingest"]
        assert sum(e["ingest"]["rows_ingested"] for e in events) == \
            st["rows_ingested"] > 0
        assert c.fences(since=since, timeout_s=0.2)["events"] == []
        assert st["event_to_fence_p99_ms"] > 0.0
        assert st["errors"] == 0
        out = c.detach(paths)
        assert out["tailing"] == []
    finally:
        svc.stop()
        pipe.close()
    _assert_identical_to_cold_rebuild(store_dir, paths, tmp_path)


# --- legacy argument spellings: warn, but mint identical keys --------------

def test_legacy_metric_args_warn_and_mint_identical_cache_keys(tmp_path):
    store = TraceStore(str(tmp_path))
    q = Query(metrics=("k_stall",), group_by="m_kind",
              reducers=("moments", "quantile"))
    pk = (0, 10, 10)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        legacy_s = store.summary_key(pk, metrics=["k_stall"],
                                     group_by="m_kind",
                                     reducers=("moments", "quantile"))
    with pytest.warns(DeprecationWarning, match="deprecated"):
        legacy_p = store.partial_key(pk, metrics=["k_stall"],
                                     group_by="m_kind",
                                     reducers=("moments", "quantile"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert store.summary_key(pk, query=q) == legacy_s
        assert store.partial_key(pk, query=q) == legacy_p
    # the same keys as the reference's, so stores stay interchangeable
    rq = ref.Query(metrics=("k_stall",), group_by="m_kind",
                   reducers=("moments", "quantile"))
    assert ref.TraceStore(str(tmp_path)).summary_key(pk, query=rq) == \
        legacy_s


def test_legacy_run_aggregation_args_warn_and_match_query(growing,
                                                          tmp_path):
    ds, cutoff = growing
    paths, store_dir = _snapshot_store(ds, cutoff, tmp_path)
    with pytest.warns(DeprecationWarning, match="legacy spelling"):
        a = run_aggregation(store_dir, metric="k_stall")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        b = run_aggregation(store_dir, query=Query(metrics=("k_stall",)))
    np.testing.assert_array_equal(a.stats.count, b.stats.count)
    np.testing.assert_array_equal(a.stats.sum, b.stats.sum)
    assert b.from_cache


# --- the port's plane against the reference's ------------------------------

def _event_digest(ev):
    return (ev["kind"],
            [(t["score"], t["added"], t["removed"])
             for t in ev["transitions"]],
            ev["ingest"]["rows_ingested"],
            ev["ingest"]["dirty_shards"],
            ev["ingest"]["n_new_shards"])


def test_same_growth_publishes_the_same_fence_events(growing, tmp_path):
    """One set of rank DBs, a store each built by its own package's
    phase 1; the same three growth batches through ``submit`` +
    ``drain_once`` in the reference (serial) and the port (torch on the
    CPU) publish the same events: kind, fence bins added and removed,
    rows ingested, dirty and new shards."""
    ds, cutoff = growing
    paths = _snapshot_dbs(ds, cutoff, tmp_path)
    stores = {tag: str(tmp_path / f"store_{tag}") for tag in ("ref", "port")}
    ref.run_generation(paths, stores["ref"], n_ranks=2)
    run_generation(paths, stores["port"], n_ranks=2)
    fences = (Query(metrics=("k_stall",), anomaly_score="p99"),
              Query(metrics=("m_duration",), group_by="m_kind",
                    anomaly_score="p95"))
    ref_fences = tuple(ref.Query.from_spec(q.to_spec()) for q in fences)
    svcs = {
        "ref": ref_serve.QueryService(
            stores["ref"], ref_serve.ServiceConfig(tick_ms=1.0)),
        "port": QueryService(stores["port"], _cfg(tick_ms=1.0))}
    ings = {
        "ref": svcs["ref"].ensure_ingestor(
            ref_serve.IngestConfig(fence_queries=ref_fences)),
        "port": svcs["port"].ensure_ingestor(
            IngestConfig(fence_queries=fences))}
    for ing in ings.values():
        ing.attach(paths)
    lo = cutoff
    for hi in (cutoff + 4 * _NS, cutoff + 8 * _NS, None):
        _grow(ds, paths, lo, hi)
        lo = hi
        for tag in ("ref", "port"):
            p = ings[tag].submit(t_detect=time.monotonic())
            assert svcs[tag].drain_once(block_s=0.0) == 1
            assert p.error is None, (tag, p.error)
    got = [_event_digest(e) for e in ings["port"].hub.events_since(0)]
    want = [_event_digest(e) for e in ings["ref"].hub.events_since(0)]
    assert len(want) == 3 and got == want
    assert any(t for _, t, *_ in want), "no fence transition to compare"
    assert ings["port"].fence_state() == ings["ref"].fence_state()
    shutil.rmtree(stores["ref"])
