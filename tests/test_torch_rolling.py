"""The port's ``rolling_stats`` against the JAX package on the same inputs.

On the CPU the port's wrapper runs its plain PyTorch version (prefix sums
in float64, cast to float32 at the end). These tests hold it against the
Pallas kernel (interpret mode, as tests/test_kernels.py runs it) and the
oracle ``rolling_ref`` on numpy inputs made from a seed, and against a
per-position numpy computation.

Tolerance on both columns: rtol = 1e-4 and atol = 1e-4 * max(1, max|x|),
the reference's own rtol = atol = 1e-4 (tests/test_kernels.py) scaled for
stall-magnitude values. One exception, a behaviour of the reference: at
window 1 every window holds one value and the exact std is 0, but the
reference forms E[x^2] - mean^2 from float32 prefixes, so its std is the
square root of a rounding residue of a few eps32 * max|x| * sum|x|. There
the port's std is held to 0 within the tolerance above, and the
reference's to the square root of that residue.

The CUDA kernel against the plain version, on the card, is in
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels as port_kernels
from repro.kernels.binstats.ops import binstats as ref_binstats
from repro.kernels.iqr.ops import iqr_fences as ref_iqr_fences
from repro.kernels.rolling.ops import rolling_stats as ref_rolling
from repro_torch.kernels.rolling import rolling_stats, rolling_stats_plain
from test_torch_cuda import RTOL as MOMENTS_RTOL
from test_torch_cuda import assert_moments_close

RTOL = 1e-4
EPS32 = float(np.finfo(np.float32).eps)
CASES = [(64, 8), (500, 32), (1000, 100), (100, 1),     # the reference's
         (1, 1), (5, 16), (1024, 1024), (2049, 64), (3000, 1500),
         (32768, 64)]


def atol(x):
    return 1e-4 * max(1.0, float(np.abs(x).max()))


def port(x, window):
    return rolling_stats(torch.from_numpy(x), window=window).numpy()


def reference(x, window, use_kernel):
    return np.asarray(ref_rolling(jnp.asarray(x), window=window,
                                  use_kernel=use_kernel))


def assert_matches_reference(got, want, x, window):
    assert got.shape == want.shape == (x.shape[0], 2)
    assert got.dtype == np.float32
    tol = atol(x)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=RTOL, atol=tol)
    if window > 1:
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=RTOL,
                                   atol=tol)
        return
    np.testing.assert_allclose(got[:, 1], 0.0, atol=tol)
    ax = np.abs(x.astype(np.float64))
    residue = 4 * EPS32 * ax.max() * ax.sum()
    assert (want[:, 1] <= np.sqrt(residue)).all()


@pytest.mark.parametrize("n,window", CASES)
def test_rolling_matches_pallas_and_oracle(n, window):
    rng = np.random.default_rng(n + window)
    x = rng.normal(0, 2, n).astype(np.float32)
    got = port(x, window)
    for use_kernel in (True, False):
        assert_matches_reference(got, reference(x, window, use_kernel), x,
                                 window)


@pytest.mark.parametrize("n,window", [(32768, 64), (20000, 1024)])
def test_rolling_stall_magnitudes_match_pallas_and_oracle(n, window):
    """lognormal(10, 1) values, like memory-stall durations in ns: the
    oracle's one float32 prefix over the series drifts most here."""
    rng = np.random.default_rng(n)
    x = rng.lognormal(10, 1, n).astype(np.float32)
    got = port(x, window)
    for use_kernel in (True, False):
        assert_matches_reference(got, reference(x, window, use_kernel), x,
                                 window)


@pytest.mark.parametrize("n,window", [(300, 16), (3000, 1500), (100, 1),
                                      (7, 64)])
def test_rolling_matches_numpy_per_position(n, window):
    rng = np.random.default_rng(2)
    x = rng.normal(5, 3, n).astype(np.float32)
    out = port(x, window)
    tol = atol(x)
    for i in sorted({min(window - 1, n - 1), n // 2, n - 1}):
        seg = x[max(0, i - window + 1): i + 1].astype(np.float64)
        np.testing.assert_allclose(out[i, 0], seg.mean(), rtol=RTOL,
                                   atol=tol)
        np.testing.assert_allclose(out[i, 1], seg.std(), rtol=RTOL,
                                   atol=tol)


def test_rolling_refuses_bad_arguments():
    x = torch.ones(10)
    for window in (0, -3):
        with pytest.raises(ValueError, match="window"):
            rolling_stats(x, window=window)
    with pytest.raises(ValueError, match="empty"):
        rolling_stats(torch.zeros(0), window=4)
    with pytest.raises(ValueError, match="series"):
        rolling_stats(torch.ones(2, 5), window=2)
    with pytest.raises(ValueError, match="empty"):
        rolling_stats_plain(torch.zeros(0), window=4)
    # the reference raises on an empty series too (XLA's slice)
    with pytest.raises(TypeError):
        ref_rolling(jnp.zeros((0,), jnp.float32), window=4)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16],
                         ids=["float64", "bfloat16"])
def test_rolling_casts_its_input_to_float32(dtype):
    rng = np.random.default_rng(3)
    x64 = rng.normal(1, 3, 700)
    xt = torch.from_numpy(x64).to(dtype)
    got = rolling_stats(xt, window=50)
    assert got.dtype == torch.float32
    same = rolling_stats(xt.to(torch.float32), window=50)
    assert torch.equal(got, same)
    x32 = xt.to(torch.float32).numpy()
    want = np.asarray(ref_rolling(
        jnp.asarray(x64, jnp.float32 if dtype == torch.float64
                    else jnp.bfloat16), window=50))
    assert_matches_reference(got.numpy(), want, x32, 50)


def test_kernels_package_exports_each_entry_point_and_plain_version():
    for name in ("binstats", "histbin", "iqr_fences", "rolling_stats",
                 "ssd_fused", "flash_attention"):
        assert callable(getattr(port_kernels, name))
        assert callable(getattr(port_kernels, f"{name}_plain"))
        assert hasattr(getattr(port_kernels, name), "launches")
    assert port_kernels.rolling_stats is rolling_stats


def test_micro_bench_calls_match_reference():
    """The calls of the reference's kernel micro-bench
    (benchmarks/kernels_bench.py), with its seed, through the port's entry
    points and the JAX package's: binstats over 65,536 events into 512
    bins, iqr_fences over 4,096 scores, rolling_stats over 32,768 values
    with window 64. Moments: counts, min and max exact, sums rtol 1e-5."""
    rng = np.random.default_rng(0)
    n, n_bins = 65_536, 512
    ts = rng.uniform(0, 1e9, n).astype(np.float32)
    vals = rng.normal(100, 20, n).astype(np.float32)
    valid = np.ones(n, bool)
    got = port_kernels.binstats(torch.from_numpy(ts), torch.from_numpy(vals),
                                torch.from_numpy(valid), total_ns=1e9,
                                n_bins=n_bins)
    want = ref_binstats(jnp.asarray(ts), jnp.asarray(vals),
                        jnp.asarray(valid), total_ns=1e9, n_bins=n_bins)
    assert got.shape == (n_bins, 5)
    assert_moments_close(got, want)

    scores = np.abs(rng.normal(10, 4, 4096)).astype(np.float32)
    occ = scores != 0
    got = port_kernels.iqr_fences(torch.from_numpy(scores),
                                  torch.from_numpy(occ))
    want = ref_iqr_fences(jnp.asarray(scores), jnp.asarray(occ))
    for key in ("q1", "q3", "iqr", "lo_fence", "hi_fence"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=MOMENTS_RTOL)
    np.testing.assert_array_equal(got["flags"].numpy(),
                                  np.asarray(want["flags"]))

    x = rng.normal(0, 1, 32_768).astype(np.float32)
    assert_matches_reference(port(x, 64), reference(x, 64, True), x, 64)
