"""The arithmetic order of the one-launch ``binstats_flat`` kernel, emulated
on the CPU, against the port's plain version and the JAX package.

``csrc/binstats.cu``'s ``binstats_seg_kernel`` does not run here, so this
test repeats what it does with numpy float32 arithmetic:

- a group of 8 lanes owns one segment; its first and end row are
  ``lower_bound`` of the segment and of the next over the clipped ids
  (what the block's two binary searches and its pass over the ids give
  for ordered ids);
- lane ``l`` walks rows ``first + l, first + l + 8, ...`` in order, adding
  ``w``, ``x * w`` and ``(x * x) * w`` (each product and sum rounded to
  float32 on its own, as ``__fmul_rn`` / ``__fadd_rn``), min and max over
  its valid rows;
- the lanes combine in an xor tree (offsets 4, 2, 1).

What must hold: the cells stay within rtol 1e-5 of the plain version and
the JAX segment path (counts, min and max exact), and a segment's cells
are bit-equal wherever its rows sit — at another absolute offset, beside
other neighbours (delta == cold). ``test_absolute_lanes_break_delta_cold``
shows why lanes are numbered from the segment's first row.

The order check of the same launch is held here too: binary search is
monotone in its target over any ids, so the blocks' row ranges (32
segments a block) tile the rows in order, and every block's ids stay
among its own segments without stepping down exactly when all ids are
non-decreasing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as ref_dist
from repro_torch.kernels.binstats import binstats_flat_plain
from test_torch_cuda import assert_moments_close

GROUP = 8
POS_CAP = np.float32(3.4e38)
NEG_CAP = np.float32(-3.4e38)


def lower_bound(seg, n_seg, targets):
    """The kernel's binary search, vectorised over targets: the first row
    whose clipped id is >= each target."""
    ids = np.clip(seg, 0, n_seg - 1)
    lo = np.zeros(len(targets), np.int64)
    hi = np.full(len(targets), len(seg), np.int64)
    while (lo < hi).any():
        go = lo < hi
        mid = (lo + hi) >> 1
        left = go & (ids[np.minimum(mid, len(seg) - 1)] < targets)
        lo = np.where(left, mid + 1, lo)
        hi = np.where(go & ~left, mid, hi)
    return lo


def group_emulation(seg, vals, valid, n_seg, first=None, end=None):
    """(M, n_seg, 5) float32 as the kernel computes it. ``first``/``end``
    default to each segment's rows (``lower_bound`` of it and of the
    next); a caller may pass any lane origin (``first``) to model another
    lane numbering."""
    m, n = vals.shape
    bounds = lower_bound(seg, n_seg, np.arange(n_seg + 1))
    first = bounds[:-1] if first is None else first
    end = bounds[1:] if end is None else end
    lane = np.arange(GROUP)
    steps = int(-(-(end - first).max() // GROUP)) if n_seg else 0
    out = np.empty((m, n_seg, 5), np.float32)
    for j in range(m):
        c, s, ss = (np.zeros((n_seg, GROUP), np.float32) for _ in range(3))
        mn = np.full((n_seg, GROUP), POS_CAP)
        mx = np.full((n_seg, GROUP), NEG_CAP)
        for k in range(steps + 1):
            r = first[:, None] + lane + GROUP * k
            live = (r >= first[:, None]) & (r < end[:, None])
            rr = np.clip(r, 0, max(n - 1, 0))
            x = vals[j][rr] if n else np.zeros_like(c)
            ok = live & (valid[rr] if n else False)
            w = ok.astype(np.float32)
            c = np.where(live, c + w, c)
            s = np.where(live, s + x * w, s)
            ss = np.where(live, ss + (x * x) * w, ss)
            mn = np.where(ok, np.minimum(mn, x), mn)
            mx = np.where(ok, np.maximum(mx, x), mx)
        for d in (4, 2, 1):
            c, s, ss = (a + a[:, lane ^ d] for a in (c, s, ss))
            mn = np.minimum(mn, mn[:, lane ^ d])
            mx = np.maximum(mx, mx[:, lane ^ d])
        out[j, :, 0] = c[:, 0]
        out[j, :, 1] = s[:, 0]
        out[j, :, 2] = ss[:, 0]
        out[j, :, 3] = np.where(np.isfinite(mn[:, 0]), mn[:, 0], POS_CAP)
        out[j, :, 4] = np.where(np.isfinite(mx[:, 0]), mx[:, 0], NEG_CAP)
    return out


def _rows(seed, n, m, n_seg, skew=False):
    rng = np.random.default_rng(seed)
    vals = rng.lognormal(8.0, 2.0, (m, n)).astype(np.float32)
    vals[:, ::13] = rng.uniform(-5, 2, vals[:, ::13].shape)
    valid = rng.random(n) > 0.1
    p = rng.dirichlet(np.full(n_seg, 0.05 if skew else 5.0))
    seg = np.sort(rng.choice(n_seg, n, p=p)).astype(np.int32)
    return seg, vals, valid


def _plain(seg, vals, valid, n_seg):
    return binstats_flat_plain(torch.from_numpy(seg), torch.from_numpy(vals),
                               n_seg, torch.from_numpy(valid)).numpy()


@pytest.mark.parametrize("n,m,n_seg,skew", [
    (60_000, 3, 3_000, False),     # ~20 rows a segment, as on Table 1
    (20_000, 1, 400, True),        # skewed: empty and long segments
    (5_000, 2, 1, False),          # one segment holding every row
    (300, 1, 1_000, False),        # mostly empty segments
])
def test_emulation_matches_plain_and_jax(n, m, n_seg, skew):
    seg, vals, valid = _rows(n + n_seg, n, m, n_seg, skew)
    got = group_emulation(seg, vals, valid, n_seg)
    assert_moments_close(got, _plain(seg, vals, valid, n_seg))
    want = ref_dist.binstats_local(jnp.asarray(seg), jnp.asarray(vals),
                                   n_seg, valid=jnp.asarray(valid))
    assert_moments_close(got, want)


def _shift(seg, vals, valid, n_seg, rng, n_pre):
    """The same rows behind ``n_pre`` rows of other segments (ids shifted
    up by 5): another absolute offset and other neighbours."""
    pre = np.sort(rng.integers(0, 5, n_pre)).astype(np.int32)
    seg2 = np.concatenate([pre, seg + 5]).astype(np.int32)
    vals2 = np.concatenate([rng.normal(size=(vals.shape[0], n_pre))
                            .astype(np.float32), vals], axis=1)
    valid2 = np.concatenate([rng.random(n_pre) > 0.5, valid])
    return seg2, vals2, valid2, n_seg + 5


@pytest.mark.parametrize("n_pre", [1, 3, 8, 1001])
def test_cells_do_not_depend_on_absolute_offset(n_pre):
    """delta == cold: a segment's cells are bit-equal wherever its rows
    sit in the batch."""
    seg, vals, valid = _rows(7, 30_000, 2, 1_500, skew=True)
    cold = group_emulation(seg, vals, valid, 1_500)
    rng = np.random.default_rng(n_pre)
    delta = group_emulation(*_shift(seg, vals, valid, 1_500, rng, n_pre))
    np.testing.assert_array_equal(delta[:, 5:], cold)


def test_absolute_lanes_break_delta_cold():
    """Lanes numbered from an absolute row position (lane = row % 8) give
    a segment other bits at another offset: the reason the kernel numbers
    them from the segment's first row."""
    seg, vals, valid = _rows(8, 30_000, 1, 300)
    bounds = lower_bound(seg, 300, np.arange(301))

    def absolute(seg, vals, valid, n_seg, bounds):
        first = bounds[:-1] - bounds[:-1] % GROUP
        return group_emulation(seg, vals, valid, n_seg, first=first,
                               end=bounds[1:])
    cold = absolute(seg, vals, valid, 300, bounds)
    s2, v2, ok2, n2 = _shift(seg, vals, valid, 300,
                             np.random.default_rng(0), 3)
    delta = absolute(s2, v2, ok2, n2, lower_bound(s2, n2, np.arange(n2 + 1)))
    assert not np.array_equal(delta[:, 5:, 1:3], cold[..., 1:3])


def _block_check(seg, n_seg, segs=32):
    """The kernel's order check: whether every block of ``segs``
    segments passes (its rows, from two binary searches, carry only its
    own ids and never step down), and the blocks' row bounds."""
    s0 = np.arange(0, n_seg, segs)
    bounds = lower_bound(seg, n_seg, np.append(s0, n_seg))
    ids = np.clip(seg, 0, n_seg - 1)
    ok = True
    for b, start in enumerate(s0):
        rows = ids[bounds[b]:bounds[b + 1]]
        end = min(start + segs, n_seg)
        ok &= bool(((rows >= start) & (rows < end)).all()
                   and (np.diff(rows) >= 0).all())
    return ok, bounds


def test_order_check_is_complete():
    """The blocks' ranges tile the rows in order over any ids, and every
    block passes exactly when the clipped ids are non-decreasing."""
    rng = np.random.default_rng(9)
    for trial in range(600):
        n, n_seg = int(rng.integers(1, 300)), int(rng.integers(1, 120))
        seg = rng.integers(-3, n_seg + 3, n).astype(np.int32)
        if trial % 3 == 0:
            seg = np.sort(seg)
        elif trial % 3 == 1:
            seg = np.sort(seg)
            i = int(rng.integers(0, n))
            seg[i] = rng.integers(-3, n_seg + 3)      # one row moved
        passes, bounds = _block_check(seg, n_seg)
        assert bounds[0] == 0 and bounds[-1] == n
        assert (np.diff(bounds) >= 0).all()
        ids = np.clip(seg, 0, n_seg - 1)
        assert passes == bool((np.diff(ids) >= 0).all())
