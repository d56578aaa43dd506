"""The port's trace diff (``repro_torch.core.diff`` and
``VariabilityPipeline.diff``) against the JAX package, on the CPU.

The reference's diff scenarios (tests/test_diff.py) run through the port
on the ``serial`` backend and on ``torch`` with ``device="cpu"``; the
reference's process-backend case becomes torch against serial. Beside
them: the name matcher equals the reference's over both spelling
variants; the serial report equals the reference's serial report field
for field (apart from ``seconds`` and the store paths); the torch report
agrees with the reference's ``jax`` report (same verdict and ranking,
scores within rtol 1e-5); ``quartiles`` and
``distributed_binstats_from_bins`` equal the reference's; and the diff
cache keeps the float32 and exact reports apart.
"""

import dataclasses
import os
import random
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import jax
import repro.core as ref
import repro_torch.core as port
from repro.core.distributed import (
    distributed_binstats_from_bins as ref_from_bins)
from repro_torch.core.anomaly import quartiles
from repro_torch.core.distributed import distributed_binstats_from_bins
from repro_torch.core.reducers import N_BUCKETS, SUBDIV

RTOL = 1e-5
BACKENDS = ("serial", "torch")
# one kernel family (ids congruent mod 21) across three spelling styles:
# Itanium-mangled, Triton-suffixed, plain SASS-style
SLOW_IDS = (3, 24, 45)
SLOW_FAMILY = "layer_norm"


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The reference's three stores over one workload (one seed),
    generated by the port's phase 1: baseline (name variant 0), a clean
    rebuild (variant 1) and the rebuild with a 1.5x slowdown injected
    into one kernel family."""
    root = tmp_path_factory.mktemp("torch_diff")
    common = dict(n_ranks=2, kernels_per_rank=4000, memcpys_per_rank=400,
                  duration_s=20.0, n_anomaly_windows=2, seed=7)
    ds_a = port.generate_synthetic(port.SyntheticSpec(**common,
                                                      name_variant=0))
    ds_b = port.generate_synthetic(port.SyntheticSpec(**common,
                                                      name_variant=1))
    ds_c = port.inject_slowdown(ds_b, 1.5, SLOW_IDS)
    out = {}
    for tag, ds in (("a", ds_a), ("b", ds_b), ("c", ds_c)):
        dbs = port.write_synthetic_dbs(ds, str(root / f"dbs_{tag}"))
        store = str(root / f"store_{tag}")
        port.run_generation(dbs, store, n_ranks=2)
        out[tag] = store
    return out


def _copies(built, root):
    """Cache-cold copies of the three stores under ``root``."""
    out = {}
    for tag, src in built.items():
        dst = os.path.join(str(root), tag)
        shutil.copytree(src, dst)
        ts = port.TraceStore(dst)
        ts.clear_summaries()
        ts.clear_partials()
        out[tag] = dst
    return out


@pytest.fixture(scope="module")
def stores(built, tmp_path_factory):
    """Module-shared copies, one set per backend."""
    return {b: _copies(built, tmp_path_factory.mktemp(f"shared_{b}"))
            for b in BACKENDS}


@pytest.fixture
def fresh_stores(built, tmp_path):
    return _copies(built, tmp_path)


def _pipe(backend="serial", pkg=port):
    extra = {"device": "cpu"} if pkg is port else {}
    return pkg.VariabilityPipeline(pkg.PipelineConfig(
        n_ranks=2, backend=backend, **extra))


def _drop_diff_cache(store: str) -> None:
    for name in os.listdir(store):
        if name.startswith("diff_") and name.endswith(".json"):
            os.remove(os.path.join(store, name))


# --- fuzzy matcher properties ----------------------------------------------

def test_normalize_strips_specialization_noise():
    cases = {
        "_Z11gemm_kernelILi128ELi4EfEvPfPKfS1_i": "gemm_kernel",
        "_ZN7cutlass6KernelI4GemmEEvNT_6ParamsE": "cutlass::kernel",
        "triton_softmax_kernel_0d1d2d3de4de_9f86d081":
            "triton_softmax_kernel",
        "void rms_norm_kernel<float, 256>(float*, float const*, int)":
            "rms_norm_kernel",
        # a plain name is already canonical (modulo case)
        "sm80_xmma_gemm_f16f16_f32_128x128_nn":
            "sm80_xmma_gemm_f16f16_f32_128x128_nn",
    }
    for name, want in cases.items():
        assert port.normalize_kernel_name(name) == want
        assert ref.normalize_kernel_name(name) == want


@pytest.mark.parametrize("variant", [0, 1])
def test_matcher_equals_reference_over_name_variants(variant):
    """normalize / tokens / match of the port equal the reference's over
    every synthetic spelling of a variant, matched against the other."""
    names = list(port.synthetic_kernel_names(64, variant=variant).values())
    assert names == list(ref.synthetic_kernel_names(
        64, variant=variant).values())
    for n in names:
        assert port.normalize_kernel_name(n) == ref.normalize_kernel_name(n)
        assert port.kernel_name_tokens(n) == ref.kernel_name_tokens(n)
    other = list(port.synthetic_kernel_names(64,
                                             variant=1 - variant).values())
    got = port.match_kernel_names(names, other)
    want = ref.match_kernel_names(names, other)
    assert [dataclasses.astuple(m) for m in got.matches] == \
        [dataclasses.astuple(m) for m in want.matches]
    assert got.unmatched_a == want.unmatched_a
    assert got.unmatched_b == want.unmatched_b


def test_variant_spellings_match_their_base_kernel():
    v0 = port.synthetic_kernel_names(64, variant=0)
    v1 = port.synthetic_kernel_names(64, variant=1)
    res = port.match_kernel_names(list(v0.values()), list(v1.values()))
    assert not res.unmatched_a and not res.unmatched_b
    pair = {m.name_a: m.name_b for m in res.matches}
    assert pair == {v0[i]: v1[i] for i in range(64)}
    vias = {m.via for m in res.matches}
    assert "exact" in vias
    assert "normalized" in vias


def test_unrelated_names_never_cross_match():
    a = ["_Z11gemm_kernelILi128EEvPf",
         "triton_softmax_kernel_0d1d2d3de4de_11aabb22",
         "sm80_xmma_reduce_sum_f16f16_f32_128x128_nn"]
    b = ["_Z16layer_norm_kernelILi256EEvPf",
         "triton_rope_embedding_kernel_0d1d2d3de4de_33ccdd44",
         "void adamw_step_kernel<float, 512>(float*)"]
    res = port.match_kernel_names(a, b)
    assert res.matches == []
    assert res.unmatched_a == sorted(a)
    assert res.unmatched_b == sorted(b)


def test_matching_is_symmetric_and_order_stable():
    v0 = list(port.synthetic_kernel_names(64, variant=0).values())
    v1 = list(port.synthetic_kernel_names(64, variant=1).values())
    fwd = port.match_kernel_names(v0, v1)
    rev = port.match_kernel_names(v1, v0)
    assert {(m.name_a, m.name_b) for m in fwd.matches} == \
        {(m.name_b, m.name_a) for m in rev.matches}
    rng = random.Random(13)
    for _ in range(3):
        sa, sb = list(v0), list(v1)
        rng.shuffle(sa)
        rng.shuffle(sb)
        assert port.match_kernel_names(sa, sb) == fwd


def test_token_fallback_requires_real_overlap():
    res = port.match_kernel_names(["fused_attention_rope_fwd_v2"],
                                  ["fused_rope_attention_fwd"])
    assert len(res.matches) == 1 and res.matches[0].via == "tokens"
    res = port.match_kernel_names(["flash_attention_fwd_kernel"],
                                  ["flash_decode_split_kernel"])
    assert res.matches == []
    assert port.kernel_name_tokens("void kernel<int>(int*)") == frozenset()


# --- sketch shift math, specs, host helpers ---------------------------------

def test_sketch_shift_recovers_bucket_translation():
    rng = np.random.default_rng(0)
    counts = np.zeros(N_BUCKETS)
    idx = rng.integers(40, 200, size=500)
    np.add.at(counts, idx, 1.0)
    for k in (4, 12):
        shifted = np.zeros(N_BUCKETS)
        np.add.at(shifted, idx + k, 1.0)
        signed, spread = port.sketch_shift(counts, shifted)
        assert signed == pytest.approx(k / SUBDIV, abs=1e-9)
        assert spread == pytest.approx(k / SUBDIV, abs=1e-9)
        assert (signed, spread) == ref.sketch_shift(counts, shifted)
        back, _ = port.sketch_shift(shifted, counts)
        assert back == pytest.approx(-k / SUBDIV, abs=1e-9)
    assert port.sketch_shift(counts, np.zeros(N_BUCKETS)) == (0.0, 0.0)


def test_diff_spec_roundtrip_and_key():
    qa = port.Query(metrics=("k_stall",), ranks=(0, 1))
    qb = port.Query(metrics=("k_stall",))
    assert port.diff_from_spec(port.diff_spec(qa, qb)) == (qa, qb)
    with pytest.raises(ValueError):
        port.diff_from_spec({"a": qa.to_spec(), "bogus": 1})
    assert port.diff_cache_key(qa, qb) != port.diff_cache_key(qb, qa)
    assert port.diff_cache_key(port.diff_query(qa), port.diff_query(qb)) \
        == port.diff_cache_key(
            port.diff_query(dataclasses.replace(qa, ranks=(1, 0))),
            port.diff_query(qb))
    # the same identity as the reference's, so caches interoperate
    rqa = ref.Query(metrics=("k_stall",), ranks=(0, 1))
    rqb = ref.Query(metrics=("k_stall",))
    assert port.diff_cache_key(port.diff_query(qa), port.diff_query(qb)) \
        == ref.diff_cache_key(ref.diff_query(rqa), ref.diff_query(rqb))


def test_quartiles_equal_reference():
    from repro.core.anomaly import quartiles as ref_quartiles
    rng = np.random.default_rng(3)
    for x in (np.zeros(0), np.asarray([2.5]), rng.lognormal(10, 1, 999),
              rng.integers(0, 5, 100).astype(np.float64)):
        assert quartiles(x) == ref_quartiles(x)


@pytest.mark.parametrize("n_metrics", [1, 3])
def test_binstats_from_bins_equals_reference(n_metrics):
    """The port's ``distributed_binstats_from_bins`` (the binstats flat
    kernel's plain version on the CPU) against the reference's on a
    one-device mesh, on bin-ordered rows with invalid ones mixed in."""
    rng = np.random.default_rng(n_metrics)
    n, n_bins = 5000, 97
    bins = np.sort(rng.integers(0, n_bins, n)).astype(np.int32)
    vals = rng.lognormal(3, 1, (n_metrics, n)).astype(np.float32)
    valid = rng.random(n) > 0.1
    v = vals[0] if n_metrics == 1 else vals
    got = distributed_binstats_from_bins(
        torch.from_numpy(bins), torch.from_numpy(v), n_bins,
        valid=torch.from_numpy(valid)).numpy()
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    want = np.asarray(ref_from_bins(jnp.asarray(bins), jnp.asarray(v),
                                    n_bins, mesh,
                                    valid=jnp.asarray(valid)))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1:3], want[..., 1:3], rtol=RTOL)
    np.testing.assert_array_equal(got[..., 3:5], want[..., 3:5])


# --- end-to-end verdicts, on both backends ----------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_self_diff_and_clean_rebuild_pass(stores, backend):
    s = stores[backend]
    pipe = _pipe(backend)
    rep = pipe.diff(s["a"], s["a"])
    assert rep.verdict == "pass" and not rep.regressions()
    rep = pipe.diff(s["a"], s["b"])
    assert rep.verdict == "pass"
    assert len(rep.groups) == 64
    assert not rep.unmatched_a and not rep.unmatched_b
    assert all(abs(g.shift_octaves) < 1e-12 for g in rep.groups)
    assert all(g.mean_ratio == pytest.approx(1.0) for g in rep.groups)


@pytest.mark.parametrize("backend", BACKENDS)
def test_injected_slowdown_ranked_top_and_flips_verdict(stores, backend):
    s = stores[backend]
    rep = _pipe(backend).diff(s["a"], s["c"])
    assert rep.verdict == "regressed"
    top = rep.groups[:len(SLOW_IDS)]
    assert all(SLOW_FAMILY in port.normalize_kernel_name(g.name_a)
               for g in top)
    assert {g.name_a for g in rep.regressions()} == {g.name_a for g in top}
    for g in top:
        assert g.geo_ratio == pytest.approx(1.5, rel=0.12)
        assert g.mean_ratio == pytest.approx(1.5, rel=0.05)
        assert g.top_bins and g.top_windows.shape == (len(g.top_bins), 2)
    lax = _pipe(backend).diff(s["a"], s["c"],
                              thresholds=port.DiffThresholds(
                                  mean_ratio=10.0, p99_ratio=10.0,
                                  shift_octaves=5.0))
    assert lax.verdict == "pass"


@pytest.mark.parametrize("backend", BACKENDS)
def test_diff_is_fused_and_warm_diff_reads_zero_shards(fresh_stores,
                                                       backend):
    """Cold = one fused scan per store, summary-warm = zero shard reads,
    repeat = the persisted report loads without running any query."""
    s = fresh_stores
    pipe = _pipe(backend)
    n_shards = port.TraceStore(s["a"]).read_manifest().n_shards
    cold = pipe.diff(s["a"], s["c"])
    assert not cold.from_cache
    assert cold.shard_reads_a == n_shards
    assert cold.shard_reads_b == n_shards
    _drop_diff_cache(s["c"])
    warm = pipe.diff(s["a"], s["c"])
    assert not warm.from_cache
    assert warm.shard_reads_a == 0 and warm.shard_reads_b == 0
    cached = pipe.diff(s["a"], s["c"])
    assert cached.from_cache
    assert "diff-result cache hit" in cached.provenance()
    ra, rw, rc = cold.to_record(), warm.to_record(), cached.to_record()
    for r in (ra, rw, rc):
        for k in ("seconds", "shard_reads_a", "shard_reads_b",
                  "diff_cached"):
            r.pop(k)
    assert ra == rw == rc
    for gw, gc in zip(warm.groups, cached.groups):
        np.testing.assert_array_equal(gw.bin_shift, gc.bin_shift)
        np.testing.assert_array_equal(gw.top_windows, gc.top_windows)


@pytest.mark.parametrize("backend", BACKENDS)
def test_diff_cache_invalidated_by_store_change(fresh_stores, backend):
    s = fresh_stores
    pipe = _pipe(backend)
    first = pipe.diff(s["a"], s["c"])
    assert not first.from_cache
    assert pipe.diff(s["a"], s["c"]).from_cache
    lax = pipe.diff(s["a"], s["c"],
                    thresholds=port.DiffThresholds(mean_ratio=10.0,
                                                   p99_ratio=10.0,
                                                   shift_octaves=5.0))
    assert not lax.from_cache
    ts = port.TraceStore(s["a"])
    ts.write_shard(0, ts.read_shard(0))
    again = pipe.diff(s["a"], s["c"])
    assert not again.from_cache
    assert again.verdict == first.verdict
    assert [g.name_a for g in again.groups] == \
        [g.name_a for g in first.groups]


def test_diff_cache_keeps_float32_and_exact_reports_apart(fresh_stores):
    """A torch (float32) report never answers a serial (exact) diff of
    the same pair, nor the other way round; a repeat on the same backend
    loads its own."""
    s = fresh_stores
    torch_pipe, serial_pipe = _pipe("torch"), _pipe("serial")
    assert not torch_pipe.diff(s["a"], s["c"]).from_cache
    assert torch_pipe.diff(s["a"], s["c"]).from_cache
    exact = serial_pipe.diff(s["a"], s["c"])
    assert not exact.from_cache
    assert serial_pipe.diff(s["a"], s["c"]).from_cache
    assert not torch_pipe.diff(s["a"], s["c"]).from_cache


def test_torch_backend_diff_matches_serial(stores):
    """The reference's process-vs-serial case on the port: the torch
    report has the serial verdict and ranking; its scores agree within
    the float32 tolerance."""
    s = stores["torch"]
    _drop_diff_cache(s["c"])
    dev = _pipe("torch").diff(s["a"], s["c"])
    assert not dev.from_cache
    _drop_diff_cache(stores["serial"]["c"])
    exact = _pipe("serial").diff(stores["serial"]["a"],
                                 stores["serial"]["c"])
    assert not exact.from_cache
    assert dev.verdict == exact.verdict
    assert [g.name_a for g in dev.groups] == [g.name_a for g in exact.groups]
    _assert_scores_close(dev, exact)


@pytest.mark.parametrize("backend", BACKENDS)
def test_record_shape_is_check_bench_consumable(stores, backend):
    s = stores[backend]
    rec = _pipe(backend).diff(s["a"], s["c"]).to_record(smoke=True)
    assert rec["kind"] == "diff" and rec["smoke"] is True
    assert rec["verdict"] in ("pass", "regressed")
    assert rec["matched_groups"] == 64
    assert len(rec["top"]) == 5
    assert rec["top"][0]["regressed"]
    shifts = [t["shift_octaves"] for t in rec["top"]]
    assert shifts == sorted(shifts, reverse=True)


# --- the port against the reference ----------------------------------------

def _assert_scores_close(got, want):
    for g, w in zip(got.groups, want.groups):
        assert (g.name_a, g.name_b, g.matched_via, g.regressed) == \
            (w.name_a, w.name_b, w.matched_via, w.regressed)
        assert (g.count_a, g.count_b) == (w.count_a, w.count_b)
        assert g.top_bins == w.top_bins
        np.testing.assert_array_equal(g.top_windows, w.top_windows)
        for f in ("mean_a", "mean_b", "mean_ratio", "p99_a", "p99_b",
                  "p99_ratio", "shift_octaves", "spread_octaves",
                  "geo_ratio"):
            np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                       rtol=RTOL, atol=1e-12, err_msg=f)
        np.testing.assert_allclose(g.bin_shift, w.bin_shift, rtol=RTOL,
                                   atol=1e-12)


def _payload(rep):
    d = rep.to_payload()
    for k in ("seconds", "store_a", "store_b"):
        d.pop(k)
    return d


@pytest.mark.parametrize("pair", ["ab", "ac"])
def test_serial_report_equals_reference(built, tmp_path, pair):
    """The port's serial report equals the reference's serial report
    field for field, each computed cold on its own copy of the stores."""
    mine = _copies(built, tmp_path / "port")
    theirs = _copies(built, tmp_path / "ref")
    x, y = pair
    got = _pipe("serial").diff(mine[x], mine[y])
    want = _pipe("serial", ref).diff(theirs[x], theirs[y])
    assert not got.from_cache and not want.from_cache
    assert _payload(got) == _payload(want)


def test_torch_report_agrees_with_reference_jax(built, tmp_path):
    """The port's torch report (CPU) against the reference's ``jax``
    backend on the same stores: same verdict and ranked groups, scores
    within rtol 1e-5."""
    mine = _copies(built, tmp_path / "port")
    theirs = _copies(built, tmp_path / "ref")
    got = _pipe("torch").diff(mine["a"], mine["c"])
    want = _pipe("jax", ref).diff(theirs["a"], theirs["c"])
    assert got.verdict == want.verdict == "regressed"
    assert [g.name_a for g in got.groups] == [g.name_a for g in want.groups]
    _assert_scores_close(got, want)
