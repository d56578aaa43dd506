"""The port's phase-3 fences against the reference's, exactly.

``repro.core.anomaly.iqr_detect`` takes Q1 and Q3 with ``np.percentile``
in float64; the port's ``iqr_detect`` takes them from the ``iqr`` kernel's
float64 form (here its plain version, ``device="cpu"``), which rounds
every step as numpy does. Scores are nanosecond durations or per-bin sums
of them: at 1e8 ns a float32 fence is 8 ns coarse and drops windows the
reference reports. Every case asserts equality — Q1, Q3, the IQR, both
fences, the flags, the ranked top bins and their windows — with no
tolerance.
"""

import numpy as np
import pytest
import torch

from repro.core import anomaly as ref_anomaly
from repro_torch.core import anomaly
from repro_torch.kernels.iqr import iqr_fences


def _on_fence(base: np.ndarray, k: float = 1.5, upper: bool = True,
              above: int = 0) -> np.ndarray:
    """``base`` (trimmed to 4m occupied scores) plus one score placed on
    the upper (or lower) fence of the resulting table, or ``above`` float64
    ulps beyond it. With 4m + 1 occupied scores the quartiles sit at the
    integer positions m and 3m, which the new score (beyond Q3, or below
    Q1) does not move, so the fence is known before the score is placed:
    computed here with the reference's own float64 operations."""
    occ = np.flatnonzero(base != 0.0)
    base = np.delete(base, occ[len(occ) - len(occ) % 4:])
    srt = np.sort(base[base != 0.0])
    m = len(srt) // 4
    q1, q3 = (srt[m], srt[3 * m]) if upper else (srt[m - 1], srt[3 * m - 1])
    iqr = q3 - q1
    x = q3 + k * iqr if upper else q1 - k * iqr
    for _ in range(above):
        x = np.nextafter(x, np.inf if upper else -np.inf)
    return np.append(base, x)


def _lognormal_table(seed: int, n: int = 12_000) -> np.ndarray:
    """A per-bin score table of nanosecond sums between 1e6 and 1e8 with
    30% empty bins and a few blown-up windows."""
    rng = np.random.default_rng(seed)
    s = np.clip(rng.lognormal(np.log(1e7), 0.8, n), 1e6, 1e8)
    s[rng.random(n) < 0.3] = 0.0
    s[rng.choice(n, 6, replace=False)] *= 40
    return s


CASES = {
    # the two tables of the fault's report
    "ns_1e8": np.array([1e8, 1e8 + 4, 1e8 + 8, 1e8 + 12, 1e8 + 16,
                        1e8 + 40]),
    "hair_above": np.array([0.1, 0.2, 0.3, 0.4, 0.7 + 1e-9]),
    # a score exactly on the upper fence is not flagged; one ulp above is
    "on_fence": _on_fence(np.arange(1.0, 9.0) * 1e7 + 3.0),
    "ulp_above": _on_fence(np.arange(1.0, 9.0) * 1e7 + 3.0, above=1),
    "lognormal": _lognormal_table(21),
    "lognormal_on_fence": _on_fence(_lognormal_table(22)[:12_000]),
    "lognormal_ulp_above": _on_fence(_lognormal_table(22)[:12_000],
                                     above=1),
}


def _assert_same(got, want):
    for key in ("q1", "q3", "iqr", "lo_fence", "hi_fence"):
        assert getattr(got, key) == getattr(want, key), key
    np.testing.assert_array_equal(got.flags, want.flags)
    np.testing.assert_array_equal(got.top_idx, want.top_idx)
    np.testing.assert_array_equal(got.top_windows, want.top_windows)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_fences_equal_reference(case):
    scores = CASES[case]
    bounds = np.arange(scores.size + 1, dtype=np.int64) * 10_000_000
    want = ref_anomaly.iqr_detect(scores, boundaries=bounds)
    got = anomaly.iqr_detect(scores, boundaries=bounds, device="cpu")
    _assert_same(got, want)


def test_fault_cases_flag_what_float32_drops():
    """The cases above bite: the reference flags a window that the float32
    form of the fences (the TPU kernel's contract, which the port's
    ``iqr_detect`` used before) leaves unflagged."""
    for case, idx in (("ns_1e8", 5), ("hair_above", 4)):
        scores = CASES[case]
        rep = ref_anomaly.iqr_detect(scores)
        assert rep.flags[idx] and idx in rep.top_idx
        f32 = iqr_fences(torch.as_tensor(scores, dtype=torch.float32),
                         torch.as_tensor(scores != 0.0))
        assert not f32["flags"][idx]
    assert not ref_anomaly.iqr_detect(CASES["on_fence"]).flags.any()
    assert ref_anomaly.iqr_detect(CASES["ulp_above"]).flags[-1]


@pytest.mark.parametrize("k", [1.5, 3.0])
def test_two_sided_fences_equal_reference(k):
    rng = np.random.default_rng(23)
    base = 1e7 + rng.normal(0.0, 1e5, 4_001)
    base[:5] = 1e7 - 2e6                     # low outliers
    base[5:8] = 1e7 + 3e6                    # high outliers
    low = _on_fence(base, k=k, upper=False, above=1)
    on_low = _on_fence(base, k=k, upper=False)
    for scores in (base, low, on_low):
        bounds = np.arange(scores.size + 1, dtype=np.int64) * 1000
        want = ref_anomaly.iqr_detect(scores, k=k, boundaries=bounds,
                                      two_sided=True)
        got = anomaly.iqr_detect(scores, k=k, boundaries=bounds,
                                 two_sided=True, device="cpu")
        _assert_same(got, want)
    assert ref_anomaly.iqr_detect(low, k=k, two_sided=True).flags[-1]
    assert not ref_anomaly.iqr_detect(on_low, k=k,
                                      two_sided=True).flags[-1]
