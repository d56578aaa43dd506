"""The port's query service and streaming plane in a group of P > 1
ranks, on gloo on the CPU, against the JAX package's ``backend="jax"``
service on as many devices and the port's own P = 1 service.

Every multi-process case runs this file as its rank processes
(``python tests/test_torch_serve_group.py <rank> <world> <port> <dir>``),
each in a gloo group with a 60 s timeout, under a subprocess deadline;
the two groups (P = 2 and 4) and the reference start together. The
reference runs in one subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``: its jax service
sees the first P of those devices, drained with ``drain_once`` (and its
stream with ``ingest_once``'s ``submit`` + ``drain_once``).

In each group every rank calls ``VariabilityPipeline.serve`` (or
constructs the ``QueryService``) on its own copy of the small ``SPEC``
store; rank 0 holds the HTTP port and asks, the other ranks follow.

- (a) HTTP answers at P = 2 and 4 == the reference's jax service on as
  many devices and == the port's P = 1 torch service (counts, min, max,
  flags and sketch counts exact; means rtol 1e-5); the store given to
  the group already holds P = 1's caches, which P recomputes beside.
- (b) a fused tick == each query alone, bit for bit.
- (c) every rank executes the same ticks (descriptor and answer
  digests).
- (d) in-flight borrowing and LRU eviction at ``pipeline_depth=4``
  under a one-byte summary and pack budget: every answer 200 and right.
- (e) a fault on one rank (before and after the execute) fails that
  tick with 500 on rank 0; the next tick answers.
- (f) ``stop()`` on rank 0 ends every follower.
- (g) the stream at P = 4: fence pushes over HTTP; the fence state and
  the fence query's moments and sketch == a cold P = 4 run bitwise, and
  the flags == the reference's jax stream.
- (h) ``serial`` and ``process`` services raise in a group.
"""

import datetime
import json
import os
import shutil
import socket
import subprocess
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
RTOL = 1e-5
WORLDS = (2, 4)
GROUP_TIMEOUT_S = 60
SPEC = dict(n_ranks=2, kernels_per_rank=3000, memcpys_per_rank=500,
            duration_s=30.0, n_anomaly_windows=2, seed=5)
CUT_S = 22
_NS = 1_000_000_000
STAT_FIELDS = ("count", "sum", "sumsq", "min", "max")

# one HTTP request a list; the quantile sketch rides k_stall and
# m_duration lanes
REQUESTS = [
    [{"metrics": ["k_stall"]},
     {"metrics": ["k_stall", "m_duration"], "group_by": "k_device"}],
    [{"metrics": ["m_duration"], "group_by": "m_kind",
      "reducers": ["moments", "quantile"], "anomaly_score": "p95"}],
    [{"metrics": ["k_stall"], "group_by": "src_rank",
      "anomaly_score": "p99", "interval_ns": _NS}],
    [{"metrics": ["m_bytes"], "group_by": "k_name", "interval_ns": _NS},
     {"metrics": ["k_stall"], "anomaly_score": "p99", "ranks": [0]}],
]
FLAT = [s for specs in REQUESTS for s in specs]
CLIENTS = 12                      # (d): each asks FLAT[i % 6] twice


# --- helpers ----------------------------------------------------------------

def _cfg(port, backend="torch"):
    return port.PipelineConfig(n_ranks=2, backend=backend, device="cpu",
                               metrics=("k_stall", "m_duration", "m_bytes"),
                               group_by="m_kind",
                               reducers=("moments", "quantile"),
                               anomaly_score="p99")


def _post(port_no, specs, timeout=GROUP_TIMEOUT_S):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port_no}/v1/query",
        data=json.dumps(specs).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _cutoff(ds):
    t0 = int(ds.traces[0].kernels.start.min())
    return (t0 // _NS) * _NS + CUT_S * _NS


def _result_arrays(results):
    """Moment fields and sketch counts of each result, by query index."""
    out = {}
    for i, qr in enumerate(results):
        for f in STAT_FIELDS:
            out[f"q{i}_{f}"] = getattr(qr.result.stats, f)
        if "quantile" in qr.result.reduced:
            out[f"q{i}_quantile"] = qr.result.reduced["quantile"].counts
    return out


def _assert_answer_close(got, want):
    """Counts, bins and fence flags exactly, min/max in float32, means
    within RTOL."""
    assert got["query"] == want["query"]
    assert (got["n_samples"], got["n_bins"], got.get("anomalous_bins")) \
        == (want["n_samples"], want["n_bins"], want.get("anomalous_bins"))
    assert set(got["groups"]) == set(want["groups"])
    for gk, cells in want["groups"].items():
        for m, cell in cells.items():
            mine = got["groups"][gk][m]
            assert mine["count"] == cell["count"]
            for f in ("min", "max"):
                assert np.float32(mine[f]) == np.float32(cell[f])
            np.testing.assert_allclose(mine["mean"], cell["mean"],
                                       rtol=RTOL)


# --- the rank processes -----------------------------------------------------

def _rank_main(rank, world, port_no, work):
    import torch.distributed as dist

    import repro_torch.core as port
    from repro_torch.serve import QueryService, ServiceConfig

    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port_no}", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    checks, arrays, rec = {}, {}, {"group": {}, "stopped": {}}
    tag = f"p{world}"

    def check(name, fn):
        try:
            fn()
            checks[name] = "ok"
        except Exception as e:         # noqa: BLE001 - reported to pytest
            checks[name] = f"{type(e).__name__}: {e}"

    def finish(case, svc):
        """Stop (rank 0) or wait for rank 0's stop (the others); keep the
        rank's tick digests and the moment its service ended."""
        svc.stop()
        rec["stopped"][case] = time.time()
        rec["group"][case] = svc.stats()["group"]

    pipe = port.VariabilityPipeline(_cfg(port))
    queries = [port.Query.from_spec(s) for s in FLAT]

    # (a), (c), (f): HTTP answers over a store P = 1 already filled
    store = os.path.join(work, f"{tag}_a")
    svc = pipe.serve(store, port=0, tick_ms=2.0, pipeline_depth=4)
    try:
        if rank == 0:
            rec["answers"] = [_post(svc.cfg.port, specs)
                              for specs in REQUESTS]
            rec["repeat"] = [_post(svc.cfg.port, specs)
                             for specs in REQUESTS]
            rec["stats"] = svc.stats()
    finally:
        finish("a", svc)
    res = port.run_queries(store, queries, backend="torch", device="cpu")
    checks["a_cached"] = ("ok" if all(r.cache_hit for r in res)
                          else "a summary of the service is missing")
    arrays.update({f"a_{k}": v for k, v in _result_arrays(res).items()})

    # (b): one fused tick against each query alone, on two bare copies
    bodies = {}
    for case in ("fused", "solo"):
        svc = QueryService(os.path.join(work, f"{tag}_{case}"),
                           ServiceConfig(backend="torch", device="cpu",
                                         tick_ms=1.0))
        if rank > 0:
            svc.start()
        try:
            if rank == 0 and case == "fused":
                pend = [svc.submit([q]) for q in queries]
                served = svc.drain_once(block_s=0.0)
                bodies[case] = [(p.error, p.results, p.tick_info)
                                for p in pend]
                rec["fused_served"] = served
            elif rank == 0:
                bodies[case] = []
                for q in queries:
                    p = svc.submit([q])
                    svc.drain_once(block_s=0.0)
                    bodies[case].append((p.error, p.results, p.tick_info))
        finally:
            finish(case, svc)
    if rank == 0:
        rec["fused"], rec["solo"] = bodies["fused"], bodies["solo"]

    def fused_arrays_equal():
        got = [port.run_queries(os.path.join(work, f"{tag}_{case}"),
                                queries, backend="torch", device="cpu")
               for case in ("fused", "solo")]
        for a, b in zip(*got):
            assert a.cache_hit and b.cache_hit
            for f in STAT_FIELDS:
                np.testing.assert_array_equal(getattr(a.result.stats, f),
                                              getattr(b.result.stats, f))
            np.testing.assert_array_equal(a.result.grouped.sum,
                                          b.result.grouped.sum)
            if "quantile" in a.result.reduced:
                np.testing.assert_array_equal(
                    a.result.reduced["quantile"].counts,
                    b.result.reduced["quantile"].counts)
    check("fused_arrays", fused_arrays_equal)

    # (d): borrowing and eviction at depth 4 under one-byte budgets
    from repro_torch.serve import query_service as qs
    svc_cls = QueryService
    started, release = threading.Event(), threading.Event()
    orig = svc_cls._exec_tick

    def stalling(self, tick):
        if tick.owned and not started.is_set():
            started.set()
            release.wait(GROUP_TIMEOUT_S / 2)
        orig(self, tick)

    if rank == 0:
        svc_cls._exec_tick = stalling
    svc = pipe.serve(os.path.join(work, f"{tag}_d"), port=0, tick_ms=5.0,
                     pipeline_depth=4, summary_budget_bytes=1,
                     pack_budget_bytes=1)
    try:
        if rank == 0:
            pa = svc.submit([queries[2]])
            started.wait(GROUP_TIMEOUT_S / 2)
            pb = svc.submit([queries[2]])
            time.sleep(0.3)
            release.set()
            pa.done.wait(GROUP_TIMEOUT_S)
            pb.done.wait(GROUP_TIMEOUT_S)
            rec["borrow"] = [(p.error, p.results) for p in (pa, pb)]
            svc_cls._exec_tick = orig
            out = [None] * (2 * CLIENTS)

            def ask(i):
                for k in range(2):
                    out[2 * i + k] = _post(svc.cfg.port,
                                           [FLAT[i % len(FLAT)]])

            threads = [threading.Thread(target=ask, args=(i,))
                       for i in range(CLIENTS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            rec["churn"] = out
            rec["churn_stats"] = svc.stats()
            rec["race"] = _eviction_race(svc, port, qs)
    finally:
        svc_cls._exec_tick = orig
        release.set()
        finish("d", svc)

    # (e): a fault on the last rank, before and after the execute
    real_compile = port.QueryPlan.compile        # bound to the class
    real_attrs = {k: port.QueryPlan.__dict__[k]
                  for k in ("compile", "execute")}
    real_execute = real_attrs["execute"]
    calls = {"compile": 0, "execute": 0}

    def compile_(*a, **k):
        calls["compile"] += 1
        if calls["compile"] == 1:
            raise RuntimeError("injected before the execute")
        return real_compile(*a, **k)

    def execute(self, *a, **k):
        out = real_execute(self, *a, **k)
        calls["execute"] += 1
        if calls["execute"] == 1:
            raise RuntimeError("injected after the execute")
        return out

    if rank == world - 1:
        port.QueryPlan.compile = staticmethod(compile_)
        port.QueryPlan.execute = execute
    svc = pipe.serve(os.path.join(work, f"{tag}_e"), port=0, tick_ms=1.0,
                     pipeline_depth=4)
    try:
        if rank == 0:
            rec["fault"] = [_post(svc.cfg.port, [FLAT[i]])
                            for i in (0, 1, 2, 1)]
    finally:
        finish("e", svc)             # a follower's ticks run until here
        for k, v in real_attrs.items():
            setattr(port.QueryPlan, k, v)

    # (h): the host backends' services refuse the group
    def raises(backend, via_pipeline):
        try:
            if via_pipeline:
                port.VariabilityPipeline(_cfg(port, backend)).serve(
                    os.path.join(work, f"{tag}_e"), serve_http=False)
            else:
                QueryService(os.path.join(work, f"{tag}_e"),
                             ServiceConfig(backend=backend, device="cpu"))
        except RuntimeError as e:
            assert "ROADMAP.md" in str(e), e
            return
        raise AssertionError("did not raise")
    for backend in ("serial", "process"):
        check(f"raise_{backend}", lambda b=backend: (raises(b, False),
                                                     raises(b, True)))

    if world == 4:
        arrays.update(_stream(rank, work, port, pipe, rec, finish, dist))
    np.savez(os.path.join(work, f"{tag}_rank{rank}.npz"), **arrays)
    with open(os.path.join(work, f"{tag}_rank{rank}.json"), "w") as f:
        json.dump({"checks": checks, "rec": rec}, f)
    port.pipeline.stop_rank_pool_server()
    dist.destroy_process_group()


def _eviction_race(svc, port, qs):
    """Rank 0 of (d): an eviction timed into a tick's execution. X's
    summary is on the store; tick B (a new query) commits while tick C
    (X) executes: B's eviction is held until 1 s after C's descriptor
    went out, while rank 0 compiles C 2 s late, before it pins C's keys.
    In a group an eviction waits for the executing tick, so C answers
    from X's summary on every rank; an eviction free to run there would
    delete it first."""
    x, y = FLAT[0], {"metrics": ["m_duration"], "group_by": "src_rank"}
    first = _post(svc.cfg.port, [x])          # X's summary, kept
    sent, state = threading.Event(), {"armed": True, "fired": False}
    real = {"broadcast": qs.broadcast, "evict": qs.SummaryCacheLRU.evict,
            "compile": port.QueryPlan.__dict__["compile"]}

    def broadcast(desc=None):
        out = real["broadcast"](desc)
        if desc and x in desc["queries"]:
            sent.set()
        return out

    def evict(self):
        if state["armed"] and not state["fired"]:
            state["fired"] = True
            sent.wait(GROUP_TIMEOUT_S / 4)
            time.sleep(1.0)
        return real["evict"](self)

    def compile_(*a, **k):
        if any(q.to_spec() == x for q in a[1]):
            time.sleep(2.0)
        return real["compile"].__func__(port.QueryPlan, *a, **k)

    qs.broadcast, qs.SummaryCacheLRU.evict = broadcast, evict
    port.QueryPlan.compile = staticmethod(compile_)
    out = [None, None]

    def ask(i, spec):
        out[i] = _post(svc.cfg.port, [spec])
    try:
        tb = threading.Thread(target=ask, args=(0, y))
        tb.start()
        time.sleep(0.1)                       # B admitted first
        ask(1, x)
        tb.join()
    finally:
        qs.broadcast = real["broadcast"]
        qs.SummaryCacheLRU.evict = real["evict"]
        port.QueryPlan.compile = real["compile"]
    return {"first": first, "out": out, "fired": state["fired"],
            "evictions": svc.stats()["evictions"]}


def _stream(rank, work, port, pipe, rec, finish, dist):
    """(g): every rank streams the P = 4 copy of the snapshot store while
    rank 0 grows its DBs; then a cold P = 4 run over a cache-free copy."""
    from repro_torch.serve import DEFAULT_FENCE_QUERY, IngestConfig
    from repro_torch.serve import QueryClient

    dbs = os.path.join(work, "p4_stream_dbs")
    paths = [os.path.join(dbs, f"rank{r}.sqlite")
             for r in range(SPEC["n_ranks"])]
    store = os.path.join(work, "p4_stream_store")
    svc = pipe.stream(store, paths, ingest=IngestConfig(poll_ms=5.0),
                      tick_ms=2.0)
    try:
        if rank == 0:
            ds = port.generate_synthetic(port.SyntheticSpec(**SPEC))
            client = QueryClient(port=svc.cfg.port,
                                 timeout_s=GROUP_TIMEOUT_S)
            for tr, p in zip(ds.traces, paths):
                port.append_rank_db(p, port.trace_remainder(tr, _cutoff(ds)))
            first = client.fences(since=0, timeout_s=GROUP_TIMEOUT_S / 2)
            rec["quiesced"] = svc.ingestor.quiesce(
                timeout_s=GROUP_TIMEOUT_S / 2)
            events, since = list(first["events"]), first["next_since"]
            while True:
                more = client.fences(since=since, timeout_s=0.2)
                if not more["events"]:
                    break
                events += more["events"]
                since = more["next_since"]
            rec["events"] = events
            rec["fence_state"] = {k: list(v) for k, v in
                                  svc.ingestor.fence_state().items()}
            rec["ingest_stats"] = client.stats()["ingest"]
    finally:
        finish("g", svc)
    cold = os.path.join(work, "p4_stream_cold")
    if rank == 0:
        os.makedirs(cold)
        for name in os.listdir(store):
            if name == "manifest.json" or name.startswith("shard_"):
                shutil.copy2(os.path.join(store, name),
                             os.path.join(cold, name))
    dist.barrier()
    want = pipe.query(cold, [DEFAULT_FENCE_QUERY])[0]
    mine = pipe.query(store, [DEFAULT_FENCE_QUERY])[0]
    rec["stream_hits"] = [mine.cache_hit, want.cache_hit]
    out = {"stream_cold_flags": np.asarray(want.anomalies.flags)}
    for tag_, qr in (("stream", mine), ("stream_cold", want)):
        for f in STAT_FIELDS:
            out[f"{tag_}_{f}"] = getattr(qr.result.stats, f)
        out[f"{tag_}_quantile"] = qr.result.reduced["quantile"].counts
    return out


# --- the reference: jax services on P of 4 devices (a subprocess) ------------

REFERENCE = """
import os, sys, json
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'
os.environ['JAX_PLATFORMS'] = 'cpu'
sys.path.insert(0, {src!r})
import jax, numpy as np
import repro.core as ref
import repro.serve as ref_serve
work = {work!r}
requests, flat = {requests!r}, {flat!r}
devices = jax.devices
out, answers = {{}}, {{}}
for p in (2, 4):
    # the jax producer's mesh is every device it is shown: the first p
    jax.devices = lambda *a, p=p, **k: devices(*a, **k)[:p]
    store = os.path.join(work, 'ref_p%d' % p)
    svc = ref_serve.QueryService(store, ref_serve.ServiceConfig(
        backend='jax', tick_ms=1.0))
    answers[p] = []
    for specs in requests:
        pend = svc.submit([ref.Query.from_spec(s) for s in specs])
        assert svc.drain_once(block_s=0.0) == 1
        assert pend.error is None, pend.error
        answers[p].append(pend.results)
    svc.stop()
    res = ref.run_queries(store, [ref.Query.from_spec(s) for s in flat],
                          backend='jax')
    for i, qr in enumerate(res):
        assert qr.cache_hit
        if 'quantile' in qr.result.reduced:
            out['p%d_q%d_quantile' % (p, i)] = \\
                qr.result.reduced['quantile'].counts
        for f in ('count', 'min', 'max', 'sum'):
            out['p%d_q%d_%s' % (p, i, f)] = getattr(qr.result.stats, f)
# the stream at 4 devices: the same growth, one ingest tick
paths = [os.path.join(work, 'ref_stream_dbs', 'rank%d.sqlite' % r)
         for r in range({n_ranks})]
store = os.path.join(work, 'ref_stream_store')
ref.run_generation(paths, store, n_ranks={n_ranks})
svc = ref_serve.QueryService(store, ref_serve.ServiceConfig(
    backend='jax', tick_ms=1.0))
ing = svc.ensure_ingestor()
ing.attach(paths)
ds = ref.generate_synthetic(ref.SyntheticSpec(**{spec!r}))
t0 = int(ds.traces[0].kernels.start.min())
cutoff = (t0 // {ns}) * {ns} + {cut} * {ns}
for tr, path in zip(ds.traces, paths):
    ref.append_rank_db(path, ref.trace_remainder(tr, cutoff))
pend = ing.submit()
assert svc.drain_once(block_s=0.0) == 1 and pend.error is None
state = ing.fence_state()
qr = ref.run_queries(store, [ref_serve.DEFAULT_FENCE_QUERY],
                     backend='jax')[0]
for f in ('count', 'min', 'max', 'sum'):
    out['stream_%s' % f] = getattr(qr.result.stats, f)
svc.stop()
np.savez(os.path.join(work, 'reference.npz'), **out)
with open(os.path.join(work, 'reference.json'), 'w') as f:
    json.dump({{'answers': answers,
               'fence_state': {{k: list(v) for k, v in state.items()}}}}, f)
print('OK')
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _p1_answers(port, store):
    """The port's P = 1 torch service on ``store``: one rendered answer
    a spec of FLAT, and the store left holding P = 1's caches."""
    from repro_torch.serve import QueryService, ServiceConfig
    svc = QueryService(store, ServiceConfig(backend="torch", device="cpu",
                                            tick_ms=1.0))
    out = []
    for specs in REQUESTS:
        p = svc.submit([port.Query.from_spec(s) for s in specs])
        assert svc.drain_once(block_s=0.0) == 1 and p.error is None
        out += p.results
    svc.stop()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both groups and the reference, started together; returns every
    rank's record and arrays, the reference's, and the P = 1 answers."""
    import repro_torch.core as port

    work = str(tmp_path_factory.mktemp("serve_group"))
    ds = port.generate_synthetic(port.SyntheticSpec(**SPEC))
    cutoff = _cutoff(ds)
    for sub in ("dbs", "p4_stream_dbs", "ref_stream_dbs"):
        os.makedirs(os.path.join(work, sub))
        for tr in ds.traces:
            port.write_rank_db(
                os.path.join(work, sub, f"rank{tr.rank}.sqlite"),
                port.truncate_trace(tr, cutoff))
    paths = [os.path.join(work, "dbs", f"rank{tr.rank}.sqlite")
             for tr in ds.traces]
    base = os.path.join(work, "base")
    port.run_generation(paths, base, n_ranks=2)
    port.run_generation(
        [os.path.join(work, "p4_stream_dbs", f"rank{tr.rank}.sqlite")
         for tr in ds.traces],
        os.path.join(work, "p4_stream_store"), n_ranks=2)
    for name in ("p1", "ref_p2", "ref_p4") + tuple(
            f"p{w}_{case}" for w in WORLDS
            for case in ("fused", "solo", "d", "e")):
        shutil.copytree(base, os.path.join(work, name))
    p1 = _p1_answers(port, os.path.join(work, "p1"))
    for w in WORLDS:                   # P = 1's caches ride along
        shutil.copytree(os.path.join(work, "p1"),
                        os.path.join(work, f"p{w}_a"))

    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    ref_code = textwrap.dedent(REFERENCE).format(
        src=SRC, work=work, requests=REQUESTS, flat=FLAT,
        n_ranks=SPEC["n_ranks"], spec=SPEC, ns=_NS, cut=CUT_S)
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
            _, err = p.communicate(
                timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
            failed.append(f"{name}: timed out\n{err[-3000:]}")
            continue
        if p.returncode != 0:
            failed.append(f"{name}: exit {p.returncode}\n{err[-3000:]}")
    assert not failed, "\n".join(failed)

    ranks = {}
    for world in WORLDS:
        for rank in range(world):
            stem = os.path.join(work, f"p{world}_rank{rank}")
            with open(stem + ".json") as f:
                ranks[world, rank] = json.load(f)
            ranks[world, rank]["arrays"] = dict(np.load(stem + ".npz"))
    with open(os.path.join(work, "reference.json")) as f:
        reference = json.load(f)
    reference["arrays"] = dict(np.load(os.path.join(work,
                                                    "reference.npz")))
    return ranks, reference, p1


def _bodies(responses):
    """The answers of a list of (status, body) responses, every one 200."""
    out = []
    for status, body in responses:
        assert status == 200, body
        out += body["results"]
    return out


# --- the tests --------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_http_answers_equal_reference_jax_service(runs, world):
    ranks, reference, _ = runs
    got = _bodies(ranks[world, 0]["rec"]["answers"])
    want = [a for specs in reference["answers"][str(world)] for a in specs]
    assert len(got) == len(want) == len(FLAT)
    for g, w in zip(got, want):
        _assert_answer_close(g, w)
    assert sum("anomalous_bins" in w for w in want) >= 3


@pytest.mark.parametrize("world", WORLDS)
def test_http_answers_equal_p1_torch_service(runs, world):
    ranks, _, p1 = runs
    rec = ranks[world, 0]["rec"]
    for responses in (rec["answers"], rec["repeat"]):
        for g, w in zip(_bodies(responses), p1):
            _assert_answer_close(g, w)


@pytest.mark.parametrize("world", WORLDS)
def test_sketch_counts_and_extrema_equal_reference(runs, world):
    ranks, reference, _ = runs
    got, want = ranks[world, 0]["arrays"], reference["arrays"]
    n = 0
    for i in range(len(FLAT)):
        np.testing.assert_array_equal(got[f"a_q{i}_count"],
                                      want[f"p{world}_q{i}_count"])
        occ = want[f"p{world}_q{i}_count"] > 0
        for f in ("min", "max"):
            np.testing.assert_array_equal(
                np.where(occ, got[f"a_q{i}_{f}"], 0.0),
                np.where(occ, want[f"p{world}_q{i}_{f}"], 0.0))
        np.testing.assert_allclose(got[f"a_q{i}_sum"],
                                   want[f"p{world}_q{i}_sum"], rtol=RTOL)
        if f"a_q{i}_quantile" in got:
            np.testing.assert_array_equal(got[f"a_q{i}_quantile"],
                                          want[f"p{world}_q{i}_quantile"])
            n += 1
    assert n >= 3
    for rank in range(1, world):       # every rank holds the same bits
        for k, v in got.items():
            if k.startswith("a_"):
                np.testing.assert_array_equal(ranks[world, rank]["arrays"][k],
                                              v)


@pytest.mark.parametrize("world", WORLDS)
def test_p_namespace_recomputes_beside_p1_caches(runs, world):
    ranks, _, _ = runs
    rec = ranks[world, 0]["rec"]
    first = _bodies(rec["answers"])
    assert not any(a["cache_hit"] for a in first)
    assert all(a["partial_hits"] == 0 for a in first)
    assert all(a["cache_hit"] for a in _bodies(rec["repeat"]))
    assert ranks[world, 0]["checks"]["a_cached"] == "ok"
    assert rec["stats"]["world_size"] == world


@pytest.mark.parametrize("world", WORLDS)
def test_fused_equals_standalone_bitwise(runs, world):
    ranks, _, _ = runs
    rec = ranks[world, 0]["rec"]
    assert rec["fused_served"] == len(FLAT)
    for (fe, fused, finfo), (se, solo, sinfo) in zip(rec["fused"],
                                                     rec["solo"]):
        assert fe is None and se is None, (fe, se)
        assert finfo["fused_width"] == len(FLAT)
        assert sinfo["fused_width"] == 1
        assert fused == solo
    for rank in range(world):
        assert ranks[world, rank]["checks"]["fused_arrays"] == "ok"


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_executes_the_same_ticks(runs, world):
    ranks, _, _ = runs
    lead = ranks[world, 0]["rec"]["group"]
    assert set(lead) == {"a", "fused", "solo", "d", "e"} | (
        {"g"} if world == 4 else set())
    for case, digests in lead.items():
        assert digests["ticks"] > 0, case
        for rank in range(1, world):
            mine = dict(ranks[world, rank]["rec"]["group"][case])
            assert mine.pop("rank") == rank
            assert mine == {k: v for k, v in digests.items()
                            if k != "rank"}, case
    assert lead["fused"]["ticks"] == 1
    assert lead["solo"]["ticks"] == len(FLAT)


@pytest.mark.parametrize("world", WORLDS)
def test_borrowing_and_eviction_at_depth_4(runs, world):
    ranks, _, p1 = runs
    rec = ranks[world, 0]["rec"]
    (ea, ra), (eb, rb) = rec["borrow"]
    assert ea is None and eb is None, (ea, eb)
    assert ra[0].get("inflight_hit") is None
    assert rb[0]["inflight_hit"] is True and rb[0]["groups"] == ra[0][
        "groups"]
    bodies = _bodies(rec["churn"])
    assert len(bodies) == 2 * CLIENTS
    for i, body in enumerate(bodies):
        _assert_answer_close(body, p1[(i // 2) % len(FLAT)])
    st = rec["churn_stats"]
    assert st["inflight_hits"] >= 1
    assert st["evictions"] > 0 and st["pack_evictions"] > 0
    race = rec["race"]
    assert race["first"][0] == 200 and race["fired"]
    (sb, bb), (sc, bc) = race["out"]
    assert sb == 200 and sc == 200, (bb, bc)
    assert bc["results"][0]["cache_hit"]      # X's summary outlived B
    _assert_answer_close(bc["results"][0], p1[0])
    assert race["evictions"] > st["evictions"]


@pytest.mark.parametrize("world", WORLDS)
def test_fault_on_one_rank_fails_the_tick_everywhere(runs, world):
    ranks, _, p1 = runs
    (s1, b1), (s2, b2), (s3, b3), (s4, b4) = ranks[world, 0]["rec"]["fault"]
    assert s1 == 500 and b1["error"]["code"] == "internal"
    assert b1["error"]["message"] == (f"rank {world - 1}: RuntimeError: "
                                      "injected before the execute")
    assert s2 == 500 and b2["error"]["code"] == "internal"
    assert b2["error"]["message"] == (f"rank {world - 1}: RuntimeError: "
                                      "injected after the execute")
    assert s3 == 200 and s4 == 200
    _assert_answer_close(b3["results"][0], p1[2])
    _assert_answer_close(b4["results"][0], p1[1])


@pytest.mark.parametrize("world", WORLDS)
def test_stop_on_rank0_ends_every_follower(runs, world):
    ranks, _, _ = runs
    for case, t0 in ranks[world, 0]["rec"]["stopped"].items():
        ends = [ranks[world, r]["rec"]["stopped"][case]
                for r in range(1, world)]
        # each follower's stop() returned right after rank 0's, far
        # inside the group's timeout
        assert max(abs(t - t0) for t in ends) < GROUP_TIMEOUT_S / 6, case


def test_stream_at_p4_pushes_fences_and_equals_cold(runs):
    ranks, reference, _ = runs
    from repro_torch.serve import DEFAULT_FENCE_QUERY

    rec = ranks[4, 0]["rec"]
    assert rec["quiesced"] and rec["events"]
    assert sum(e["ingest"]["rows_ingested"] for e in rec["events"]) \
        == rec["ingest_stats"]["rows_ingested"] > 0
    assert rec["ingest_stats"]["errors"] == 0
    state = rec["fence_state"][DEFAULT_FENCE_QUERY.cache_key()]
    for rank in range(4):
        got = ranks[4, rank]
        assert got["rec"]["stream_hits"] == [True, False]
        arr = got["arrays"]
        assert list(np.flatnonzero(arr["stream_cold_flags"])) == state
        for f in STAT_FIELDS + ("quantile",):
            np.testing.assert_array_equal(arr[f"stream_{f}"],
                                          arr[f"stream_cold_{f}"])
    assert state, "no flagged bin to compare"
    assert reference["fence_state"][DEFAULT_FENCE_QUERY.cache_key()] \
        == state
    arr, want = ranks[4, 0]["arrays"], reference["arrays"]
    np.testing.assert_array_equal(arr["stream_count"], want["stream_count"])
    np.testing.assert_allclose(arr["stream_sum"], want["stream_sum"],
                               rtol=RTOL)


@pytest.mark.parametrize("backend", ["serial", "process"])
def test_host_backend_services_raise_in_a_group(runs, backend):
    ranks, _, _ = runs
    bad = {key: r["checks"][f"raise_{backend}"] for key, r in ranks.items()
           if r["checks"][f"raise_{backend}"] != "ok"}
    assert not bad, bad


def test_broadcast_gather_and_stats_without_a_group(tmp_path):
    import repro_torch.core as port
    from repro_torch.core.group import broadcast, gather
    from repro_torch.serve import QueryService, ServiceConfig

    assert broadcast({"seq": 1}) == {"seq": 1}
    assert gather(3) == [3]
    ds = port.generate_synthetic(port.SyntheticSpec(
        n_ranks=2, kernels_per_rank=200, memcpys_per_rank=40,
        duration_s=4.0, seed=1))
    paths = []
    for tr in ds.traces:
        paths.append(str(tmp_path / f"rank{tr.rank}.sqlite"))
        port.write_rank_db(paths[-1], tr)
    port.run_generation(paths, str(tmp_path / "s"), n_ranks=2)
    svc = QueryService(str(tmp_path / "s"),
                       ServiceConfig(backend="serial", device="cpu"))
    st = svc.stats()
    assert st["world_size"] == 1 and st["group"] is None
    assert svc.join(0.0)
    svc.stop()


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
               sys.argv[4])
