"""The port's kernel modules against the JAX package on the same inputs.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
those versions against the Pallas kernels (interpret mode, as
tests/test_kernels.py runs them) and the JAX device path, on numpy inputs
made from a seed. Tolerances: counts, min/max and flags exact; float32
sums and fences rtol 1e-5 (summation order differs); histogram totals
per (metric, segment) exact, with a row allowed to move only to an
adjacent bucket (float32 log2 of XLA and of PyTorch may differ by an ulp
on a bucket edge), at most 0.1% of rows.

The CUDA kernels against their plain versions, on the card, are in
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.core import anomaly as ref_anomaly
from repro.core import distributed as ref_dist
from repro.kernels.binstats.ops import binstats as ref_binstats
from repro.kernels.histbin.ops import histbin as ref_histbin
from repro.kernels.iqr.ops import iqr_fences as ref_iqr_fences
from repro_torch.core import anomaly
from repro_torch.core import distributed
from repro_torch.kernels.binstats import (binstats, binstats_flat,
                                          binstats_flat_plain)
from repro_torch.kernels.histbin import histbin, histbin_flat
from repro_torch.kernels.iqr import iqr_fences
from repro_torch.kernels.rolling import rolling_stats
from test_torch_cuda import RTOL, assert_hist_close, assert_moments_close


def _events(seed, n, m, total_ns=1e9, n_seg=None):
    rng = np.random.default_rng(seed)
    ts = rng.uniform(-0.02 * total_ns, 1.02 * total_ns, n).astype(np.float32)
    vals = rng.lognormal(8.0, 2.0, (m, n)).astype(np.float32)
    vals[:, ::17] = rng.uniform(-5, 2, vals[:, ::17].shape)   # floor bucket
    valid = rng.random(n) > 0.1
    seg = (None if n_seg is None
           else rng.integers(0, n_seg, n).astype(np.int32))
    return ts, vals, valid, seg


def _mesh():
    return Mesh(np.asarray(jax.devices()[:1]), ("data",))


# --- binstats ---------------------------------------------------------------

@pytest.mark.parametrize("n,m,n_bins", [(3000, 3, 50), (1, 1, 7),
                                         (2048, 2, 128)])
def test_binstats_ts_matches_pallas(n, m, n_bins):
    ts, vals, valid, _ = _events(0, n, m)
    want = ref_binstats(jnp.asarray(ts), jnp.asarray(vals),
                        jnp.asarray(valid), total_ns=1e9, n_bins=n_bins)
    got = binstats(torch.from_numpy(ts), torch.from_numpy(vals),
                   torch.from_numpy(valid), total_ns=1e9, n_bins=n_bins)
    assert_moments_close(got, want)


def test_binstats_ts_1d_and_all_invalid():
    ts, vals, valid, _ = _events(1, 500, 1)
    got = binstats(torch.from_numpy(ts), torch.from_numpy(vals[0]),
                   torch.zeros(500, dtype=torch.bool), total_ns=1e9,
                   n_bins=9)
    want = ref_binstats(jnp.asarray(ts), jnp.asarray(vals[0]),
                        jnp.zeros(500, bool), total_ns=1e9, n_bins=9)
    assert got.shape == (9, 5)
    assert_moments_close(got, want)


@pytest.mark.parametrize("m,n_seg", [(1, 37), (3, 300)])
def test_binstats_flat_matches_jax_segment_path(m, n_seg):
    _, vals, valid, seg = _events(2, 4000, m, n_seg=n_seg)
    seg[:5] = [-3, n_seg, n_seg + 9, 0, n_seg - 1]    # clipped like JAX
    want = ref_dist.binstats_local(jnp.asarray(seg), jnp.asarray(vals),
                                   n_seg, valid=jnp.asarray(valid))
    got = binstats_flat(torch.from_numpy(seg), torch.from_numpy(vals),
                        n_seg, torch.from_numpy(valid))
    assert_moments_close(got, want)
    moments = distributed.distributed_moments_flat(
        torch.from_numpy(seg), torch.from_numpy(vals), n_seg,
        valid=torch.from_numpy(valid))
    ref = ref_dist.distributed_moments_flat(
        jnp.asarray(seg), jnp.asarray(vals), n_seg, _mesh(),
        valid=jnp.asarray(valid))
    assert_moments_close(moments, ref)


def test_binstats_flat_plain_is_fixed_order():
    """The plain version adds each segment's rows in row order: its sums
    equal a sequential float32 walk bit for bit."""
    _, vals, valid, seg = _events(3, 600, 1, n_seg=5)
    got = binstats_flat_plain(torch.from_numpy(seg),
                              torch.from_numpy(vals[0]), 5,
                              torch.from_numpy(valid)).numpy()
    s = np.zeros(5, np.float32)
    ss = np.zeros(5, np.float32)
    for r in range(600):
        w = np.float32(valid[r])
        s[seg[r]] = s[seg[r]] + vals[0, r] * w
        ss[seg[r]] = ss[seg[r]] + vals[0, r] * vals[0, r] * w
    np.testing.assert_array_equal(got[:, 1], s)
    np.testing.assert_array_equal(got[:, 2], ss)


# --- histbin ----------------------------------------------------------------

@pytest.mark.parametrize("n,m,n_bins", [(3000, 3, 50), (1024, 1, 5)])
def test_histbin_ts_matches_pallas(n, m, n_bins):
    ts, vals, valid, _ = _events(4, n, m)
    want = ref_histbin(jnp.asarray(ts), jnp.asarray(vals),
                       jnp.asarray(valid), total_ns=1e9, n_bins=n_bins)
    got = histbin(torch.from_numpy(ts), torch.from_numpy(vals),
                  torch.from_numpy(valid), total_ns=1e9, n_bins=n_bins)
    assert_hist_close(got, want)


@pytest.mark.parametrize("m,n_seg", [(1, 40), (3, 200)])
def test_histbin_flat_matches_jax_segment_path(m, n_seg):
    _, vals, valid, seg = _events(5, 5000, m, n_seg=n_seg)
    want = ref_dist.distributed_histogram_flat(
        jnp.asarray(seg), jnp.asarray(vals), n_seg, _mesh(),
        valid=jnp.asarray(valid))
    got = distributed.distributed_histogram_flat(
        torch.from_numpy(seg), torch.from_numpy(vals), n_seg,
        valid=torch.from_numpy(valid))
    assert_hist_close(got, want)
    np.testing.assert_array_equal(
        histbin_flat(torch.from_numpy(seg), torch.from_numpy(vals), n_seg,
                     torch.from_numpy(valid)).numpy(), got.numpy())


def test_bucketize_matches_jax():
    _, vals, _, _ = _events(6, 20000, 1)
    got = distributed.bucketize(torch.from_numpy(vals[0])).numpy()
    want = np.asarray(ref_dist.bucketize(jnp.asarray(vals[0])))
    assert np.abs(got - want).max() <= 1
    assert (got != want).mean() <= 1e-3


# --- iqr --------------------------------------------------------------------

def _scores(seed, n, frac_occ=0.8):
    rng = np.random.default_rng(seed)
    s = rng.lognormal(3.0, 0.5, n).astype(np.float32)
    s[rng.random(n) < 0.03] *= 20                      # outliers
    occ = rng.random(n) < frac_occ
    return s, occ


@pytest.mark.parametrize("n", [1, 2, 5, 64, 1000, 4096, 12_000, 16_385])
def test_iqr_fences_matches_pallas(n):
    """The port against the Pallas kernel in interpret mode, up to the
    analysis path's 12,000 scores and one past the card's single-launch
    limit: sorted table, flags and n_occ exact, the fences within RTOL
    (float32 arithmetic in two libraries)."""
    s, occ = _scores(n, n)
    occ[0] = True                      # the Pallas kernel's contract
    want = ref_iqr_fences(jnp.asarray(s), jnp.asarray(occ))
    got = iqr_fences(torch.from_numpy(s), torch.from_numpy(occ))
    for key in ("q1", "q3", "iqr", "lo_fence", "hi_fence"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=RTOL)
    assert float(got["n_occ"]) == float(want["n_occ"])
    np.testing.assert_array_equal(got["flags"].numpy(),
                                  np.asarray(want["flags"]))
    np.testing.assert_array_equal(got["sorted"].numpy(),
                                  np.asarray(want["sorted"]))


def test_iqr_fences_no_occupied_bin_is_zero():
    got = iqr_fences(torch.ones(6), torch.zeros(6, dtype=torch.bool))
    assert got["stats"].tolist() == [0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0]
    assert not got["flags"].any()


def test_iqr_fences_result_mapping():
    """Every key is listed and readable; a named stat is stats[i]; an
    unknown key raises KeyError."""
    s, occ = _scores(3, 100)
    got = iqr_fences(torch.from_numpy(s), torch.from_numpy(occ))
    names = ("q1", "q3", "iqr", "lo_fence", "hi_fence", "n_occ")
    assert list(got) == ["sorted", "flags", "stats", *names]
    assert len(got) == 9 and "q1" in got and "nope" not in got
    for i, name in enumerate(names):
        assert got[name] is got[name]
        assert float(got[name]) == float(got["stats"][i])
    assert dict(got).keys() == set(got)
    with pytest.raises(KeyError):
        got["nope"]


@pytest.mark.parametrize("case", ["sparse", "all_empty", "negative"])
def test_iqr_detect_matches_reference(case):
    rng = np.random.default_rng(8)
    scores = rng.lognormal(2.0, 0.4, 300)
    scores[rng.random(300) < 0.3] = 0.0
    scores[[7, 99, 250]] *= 15
    if case == "all_empty":
        scores[:] = 0.0
    if case == "negative":
        scores = -np.abs(scores)
    bounds = np.arange(301, dtype=np.int64) * 1000
    want = ref_anomaly.iqr_detect(scores, boundaries=bounds)
    got = anomaly.iqr_detect(scores, boundaries=bounds, device="cpu")
    for key in ("q1", "q3", "iqr", "lo_fence", "hi_fence"):
        assert getattr(got, key) == getattr(want, key), key
    np.testing.assert_array_equal(got.flags, want.flags)
    np.testing.assert_array_equal(got.top_idx, want.top_idx)
    np.testing.assert_array_equal(got.top_windows, want.top_windows)


def test_distributed_iqr_matches_reference():
    s, occ = _scores(9, 500)
    s[~occ] = 0.0
    want = ref_dist.distributed_iqr(jnp.asarray(s))
    got = distributed.distributed_iqr(torch.from_numpy(s))
    for key in ("q1", "q3", "iqr", "lo_fence", "hi_fence"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=RTOL)
    np.testing.assert_array_equal(got["flags"].numpy(),
                                  np.asarray(want["flags"]))


def test_wrappers_refuse_other_devices():
    """Off the CPU a wrapper launches its kernel or raises — a tensor on a
    device it has no kernel for is refused, not quietly computed."""
    meta = torch.empty(8, device="meta")
    with pytest.raises(ValueError):
        iqr_fences(meta, torch.empty(8, dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError):
        binstats_flat(torch.empty(8, dtype=torch.int32, device="meta"),
                      meta, 4, torch.empty(8, dtype=torch.bool,
                                           device="meta"))
    with pytest.raises(ValueError):
        rolling_stats(meta, window=4)
