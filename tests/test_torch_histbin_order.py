"""The block plan of the one-launch ``histbin_flat`` kernel, emulated on
the CPU, against the port's plain version and the JAX segment path.

``csrc/histbin.cu``'s ``histbin_seg_kernel`` does not run here, so this
test repeats what it does with numpy:

- the searches run over ids clipped to ``[-1, n_seg]``: ids below 0 lead
  the segment-ordered rows and ids at or above ``n_seg`` trail them;
- a block owns ``SEGS`` consecutive segments; its rows run from
  ``lower_bound`` of its first segment to ``lower_bound`` of the next
  block's, except that the first block starts at row 0 and the last ends
  at row ``n`` (so they own the dropped rows too);
- it counts its valid rows whose id is one of its segments into a table
  and writes every cell of its segments, zeros included;
- it passes its order check when its clipped ids never step down and stay
  among its segments (``-1`` allowed in the first block, ``n_seg`` in the
  last); a block that fails writes NaN into every cell it owns.

What must hold: the blocks' ranges tile the rows in order over any ids
(binary search is monotone in its target); on ordered rows every
segment's total equals the plain version's and the JAX segment path's
exactly, and its buckets agree within the bucket-edge allowance of the
card check (``assert_hist_close``: a row may sit one bucket over where
two float32 ``log2`` evaluations straddle an edge); every block passes
exactly when the clipped ids are non-decreasing. Cases: mostly empty
segments, ids below 0 and at or above ``n_seg``, no valid row, one segment
holding every row, ``n_seg`` not a multiple of ``SEGS``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.core import distributed as ref_dist
from repro_torch.kernels.histbin import bucketize, histbin_flat_plain
from repro_torch.kernels.histbin.ops import disordered
from test_torch_cuda import assert_hist_close

SEGS = 8                     # segments a block (csrc/histbin.cu)
N_BUCKETS = 384


def clip_key(seg, n_seg):
    return np.where(seg < 0, -1, np.where(seg >= n_seg, n_seg, seg))


def lower_bound(keys, targets):
    """The kernel's binary search over (possibly unordered) clipped ids,
    vectorised over targets: the first row whose key is >= each target."""
    n = len(keys)
    lo = np.zeros(len(targets), np.int64)
    hi = np.full(len(targets), n, np.int64)
    while (lo < hi).any():
        go = lo < hi
        mid = (lo + hi) >> 1
        left = go & (keys[np.minimum(mid, max(n - 1, 0))] < targets) \
            if n else np.zeros_like(go)
        lo = np.where(left, mid + 1, lo)
        hi = np.where(go & ~left, mid, hi)
    return lo


def block_ranges(seg, n_seg):
    """(first segment, segment count, first row, end row) of every block."""
    keys = clip_key(seg, n_seg)
    s0 = np.arange(0, n_seg, SEGS)
    nsb = np.minimum(n_seg - s0, SEGS)
    a = lower_bound(keys, s0)
    b = lower_bound(keys, s0 + nsb)
    a[0] = 0
    b[-1] = len(seg)
    return s0, nsb, a, b


def emulate(seg, vals, valid, n_seg):
    """(M, n_seg, 384) float32 as the kernel writes it."""
    keys = clip_key(seg, n_seg)
    m = vals.shape[0]
    buckets = bucketize(torch.from_numpy(vals)).numpy()
    out = np.empty((m, n_seg, N_BUCKETS), np.float32)
    last = len(range(0, n_seg, SEGS)) - 1
    for k, (s0, nsb, a, b) in enumerate(zip(*block_ranges(seg, n_seg))):
        k_lo = -1 if k == 0 else s0
        k_hi = n_seg if k == last else s0 + nsb - 1
        rows = keys[a:b]
        prev = np.concatenate([[k_lo], rows[:-1]])
        bad = bool(((rows < prev) | (rows < k_lo) | (rows > k_hi)).any())
        ids = seg[a:b]
        keep = valid[a:b] & (ids >= s0) & (ids < s0 + nsb)
        for j in range(m):
            table = np.zeros((nsb, N_BUCKETS), np.int64)
            np.add.at(table, (ids[keep] - s0, buckets[j, a:b][keep]), 1)
            out[j, s0:s0 + nsb] = np.nan if bad else table
    return out


def _rows(seed, n, m, n_seg, lo=0, hi=None, invalid=False):
    rng = np.random.default_rng(seed)
    hi = n_seg if hi is None else hi
    seg = np.sort(rng.integers(lo, hi, n)).astype(np.int32)
    vals = rng.lognormal(8.0, 2.0, (m, n)).astype(np.float32)
    vals[:, ::17] = rng.uniform(-5, 2, vals[:, ::17].shape)
    valid = np.zeros(n, bool) if invalid else rng.random(n) > 0.1
    return seg, vals, valid


CASES = {  # n, m, n_seg, id range, all rows invalid
    "table1_like": (60_000, 3, 3_000, None, False),  # ~20 rows a segment
    "empty_segments": (300, 1, 5_000, None, False),
    "out_of_range": (9_000, 2, 300, (-40, 340), False),
    "all_invalid": (999, 2, 30, None, True),
    "one_segment": (20_000, 1, 1, None, False),
    "ragged_blocks": (20_000, 3, 1_003, None, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_emulation_matches_plain_and_jax(case):
    n, m, n_seg, ids, invalid = CASES[case]
    lo, hi = ids or (0, n_seg)
    seg, vals, valid = _rows(n + n_seg, n, m, n_seg, lo, hi, invalid)
    got = emulate(seg, vals, valid, n_seg)
    assert not disordered(got)
    plain = histbin_flat_plain(torch.from_numpy(seg), torch.from_numpy(vals),
                               n_seg, torch.from_numpy(valid)).numpy()
    assert_hist_close(got, plain)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    want = ref_dist.distributed_histogram_flat(
        jnp.asarray(seg), jnp.asarray(vals), n_seg, mesh,
        valid=jnp.asarray(valid))
    assert_hist_close(got, want)


def test_block_ranges_tile_the_rows():
    """Over any ids, the blocks' ranges are non-decreasing and cover
    [0, n) without gaps or overlaps."""
    rng = np.random.default_rng(4)
    for _ in range(300):
        n, n_seg = int(rng.integers(0, 200)), int(rng.integers(1, 60))
        seg = rng.integers(-3, n_seg + 3, n).astype(np.int32)
        _, _, a, b = block_ranges(seg, n_seg)
        assert a[0] == 0 and b[-1] == n
        np.testing.assert_array_equal(a[1:], b[:-1])
        assert (b >= a).all()


def test_order_check_is_complete():
    """Every block passes exactly when the clipped ids are
    non-decreasing: sorted ids, sorted ids with one row moved, and ids in
    no order."""
    rng = np.random.default_rng(9)
    for trial in range(600):
        n, n_seg = int(rng.integers(1, 300)), int(rng.integers(1, 120))
        seg = rng.integers(-3, n_seg + 3, n).astype(np.int32)
        if trial % 3 < 2:
            seg = np.sort(seg)
        if trial % 3 == 1:
            seg[int(rng.integers(0, n))] = rng.integers(-3, n_seg + 3)
        vals = np.ones((1, n), np.float32)
        got = emulate(seg, vals, np.ones(n, bool), n_seg)
        ordered = bool((np.diff(clip_key(seg, n_seg)) >= 0).all())
        assert disordered(got) == (not ordered)


def test_disorder_fills_the_blocks_cells_with_nan():
    """Reversed rows: the blocks that see them write NaN in every bucket
    of their segments, which ``disordered`` reads from bucket 0."""
    seg, vals, valid = _rows(5, 5_000, 2, 200)
    got = emulate(seg[::-1].copy(), vals, valid, 200)
    assert disordered(got)
    nan_cells = np.isnan(got).all(-1)
    assert (np.isnan(got).any(-1) == nan_cells).all()
