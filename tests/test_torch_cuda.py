"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; the
file imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: counts, min/max, flags and the iqr outputs exact; float32
sums rtol 1e-5 (atomics and summation order differ); histogram totals per
(metric, segment) exact, with a row allowed to move only to an adjacent
bucket (float32 log2 of two libraries on a bucket edge), at most 0.1% of
rows. The comparison helpers are shared with the other port tests.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.reducers import BinStats, QuantileSketch
from repro_torch.kernels.binstats import (binstats, binstats_flat,
                                          binstats_flat_plain,
                                          binstats_plain)
from repro_torch.kernels.binstats.ops import _ts_bins, disordered
from repro_torch.kernels.histbin import (histbin, histbin_flat,
                                         histbin_flat_plain, histbin_plain)
from repro_torch.kernels.histbin.ops import disordered as hist_disordered
from repro_torch.kernels.iqr import iqr_fences, iqr_fences_plain

RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel against its plain version")
    return torch.device("cuda")


def assert_moments_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1:3], want[..., 1:3], rtol=RTOL)
    np.testing.assert_array_equal(got[..., 3:5], want[..., 3:5])


def assert_sums_within_summation_bound(got, want, idx, vals, valid,
                                       n_cells):
    """Moments of cells that sum thousands of rows: counts, min and max
    equal the plain version's; each float32 sum lies within the worst-case
    bound of float32 summation in any order, (n_c + 2) * 2^-24 * sum|term|
    over the cell's n_c rows, of the float64 sum of the same terms. (A
    relative tolerance between two float32 sums taken in different orders
    holds for short cells only: the plain version adds in ``index_add_``'s
    order, the kernel in a lane tree or by atomics.)"""
    got = np.asarray(got, np.float64).reshape(-1, n_cells, 5)
    want = np.asarray(want, np.float64).reshape(-1, n_cells, 5)
    np.testing.assert_array_equal(got[..., [0, 3, 4]], want[..., [0, 3, 4]])
    x = np.asarray(vals, np.float64).reshape(-1, len(idx))
    ok = np.asarray(valid, np.float64)
    rows = np.bincount(idx, minlength=n_cells)
    for j in range(x.shape[0]):
        for ch, terms in ((1, x[j] * ok), (2, x[j] * x[j] * ok)):
            exact = np.bincount(idx, weights=terms, minlength=n_cells)
            mass = np.bincount(idx, weights=np.abs(terms), minlength=n_cells)
            bound = (rows + 2) * 2.0 ** -24 * mass
            assert (np.abs(got[j, :, ch] - exact) <= bound).all()


def assert_hist_close(got, want, max_moved=1e-3):
    """Per-(..., segment) totals exact; rows move only to an adjacent
    bucket, and at most ``max_moved`` of them."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.sum(-1), want.sum(-1))
    d = got - want
    moved = np.abs(d).sum() / 2
    # transport cost in buckets equals the moved count iff every moved
    # row went one bucket over
    assert np.abs(np.cumsum(d, axis=-1)).sum() == moved
    assert moved <= max_moved * max(want.sum(), 1.0)


def _events(seed, n, m, n_seg):
    rng = np.random.default_rng(seed)
    ts = rng.uniform(-2e7, 1.02e9, n).astype(np.float32)
    vals = rng.lognormal(8.0, 2.0, (m, n)).astype(np.float32)
    vals[:, ::17] = rng.uniform(-5, 2, vals[:, ::17].shape)
    valid = rng.random(n) > 0.1
    seg = np.sort(rng.integers(0, n_seg, n)).astype(np.int32)
    return ts, vals, valid, seg


def test_binstats_kernels_on_card(cuda):
    ts, vals, valid, seg = _events(10, 70001, 3, 1000)
    t = [torch.from_numpy(x).to(cuda) for x in (ts, vals, valid, seg)]
    got = binstats_flat(t[3], t[1], 1003, t[2])
    want = binstats_flat_plain(t[3], t[1], 1003, t[2])
    assert_moments_close(got.cpu(), want.cpu())
    got = binstats(t[0], t[1], t[2], total_ns=1e9, n_bins=333)
    want = binstats_plain(t[0], t[1], t[2], total_ns=1e9, n_bins=333)
    assert_moments_close(got.cpu(), want.cpu())
    # unordered rows: the kernel's verdict is a NaN count, read from the
    # copy the caller makes; the main path raises on it
    flipped = binstats_flat(t[3].flip(0).contiguous(), t[1], 1003, t[2])
    assert disordered(flipped.cpu()) and not disordered(got.cpu())
    with pytest.raises(ValueError):
        BinStats.device_reduce(t[3].flip(0).contiguous(), t[1], 1003,
                               cuda, t[2])


@pytest.mark.parametrize("n_bins,m", [(1, 1), (512, 1), (4097, 3),
                                      (12_000, 1), (12_000, 3)])
def test_binstats_ts_table_sizes_on_card(cuda, n_bins, m):
    """One bin, the micro call's 512, the largest table one cluster holds
    (4,097 x 3 metrics, 213 KB) and the Table-1 form's 12,000 bins, which
    take the three-launch path."""
    ts, vals, valid, _ = _events(13, 65_536, m, 10)
    t = [torch.from_numpy(x).to(cuda) for x in (ts, vals, valid)]
    got = binstats(t[0], t[1], t[2], total_ns=1e9, n_bins=n_bins)
    want = binstats_plain(t[0], t[1], t[2], total_ns=1e9, n_bins=n_bins)
    if n_bins > 1:
        assert_moments_close(got.cpu(), want.cpu())
    else:                                 # 65,536 rows in one cell
        idx = _ts_bins(t[0], 1e9, n_bins).long().cpu().numpy()
        assert_sums_within_summation_bound(got.cpu(), want.cpu(), idx, vals,
                                           valid, n_bins)


@pytest.mark.parametrize("case", ["one_segment", "empty_segments",
                                  "long_segment", "all_invalid"])
def test_binstats_flat_edges_on_card(cuda, case):
    """One segment holding every row, mostly empty segments, a segment far
    longer than a group's stride, and no valid row."""
    rng = np.random.default_rng(14)
    n, n_seg = {"one_segment": (70_001, 1), "empty_segments": (50, 5000),
                "long_segment": (40_000, 7), "all_invalid": (999, 30)}[case]
    seg = np.sort(rng.integers(0, n_seg, n)).astype(np.int32)
    if case == "long_segment":
        seg[100:39_000] = 3
        seg = np.sort(seg)
    vals = rng.lognormal(8.0, 2.0, (2, n)).astype(np.float32)
    valid = (np.zeros(n, bool) if case == "all_invalid"
             else rng.random(n) > 0.1)
    t = [torch.from_numpy(x).to(cuda) for x in (seg, vals, valid)]
    got = binstats_flat(t[0], t[1], n_seg, t[2])
    assert not disordered(got.cpu())
    want = binstats_flat_plain(t[0], t[1], n_seg, t[2]).cpu()
    if case in ("one_segment", "long_segment"):   # tens of thousands of rows
        assert_sums_within_summation_bound(got.cpu(), want, seg, vals,
                                           valid, n_seg)
    else:
        assert_moments_close(got.cpu(), want)


def _device_ops(fn):
    """The device activities (kernels, memsets, copies) of one call, read
    after a warm-up cycle (a profiler opened cold misses the device
    activity of its first few hundred microseconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            torch.cuda._sleep(2_000_000)       # about 1 ms ahead of the call
            fn()
            torch.cuda.synchronize()
            prof.step()
    return [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and "spin_kernel" not in e.name
            and not e.name.startswith("ProfilerStep")]


def test_binstats_calls_launch_one_kernel(cuda):
    """The micro call of the timestamp form and a flat call are each one
    kernel on the device: no memset, no second kernel."""
    ts, vals, valid, seg = _events(15, 65_536, 1, 512)
    t = [torch.from_numpy(x).to(cuda) for x in (ts, vals, valid, seg)]
    ops = _device_ops(lambda: binstats(t[0], t[1][0], t[2], total_ns=1e9,
                                       n_bins=512))
    assert len(ops) == 1 and "binstats_ts_cluster_kernel" in ops[0], ops
    ops = _device_ops(lambda: binstats_flat(t[3], t[1], 512, t[2]))
    assert len(ops) == 1 and "binstats_seg_kernel" in ops[0], ops


def test_binstats_flat_does_not_wait_for_its_kernel(cuda):
    """The call returns while its kernel still waits behind a queued
    sleep: nothing inside it synchronises."""
    ts, vals, valid, seg = _events(16, 70_001, 3, 1000)
    t = [torch.from_numpy(x).to(cuda) for x in (vals, valid, seg)]
    binstats_flat(t[2], t[0], 1000, t[1])
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    out = binstats_flat(t[2], t[0], 1000, t[1])
    done = torch.cuda.Event()
    done.record()
    assert not done.query()
    torch.cuda.synchronize()
    assert_moments_close(out.cpu(),
                         binstats_flat_plain(t[2], t[0], 1000, t[1]).cpu())


def test_histbin_kernels_on_card(cuda):
    """Both forms against their plain versions; the flat form is one
    kernel a call (no memset, no second kernel), and unordered ids leave
    NaN counts, on which the main path's reducer raises."""
    ts, vals, valid, seg = _events(11, 70001, 3, 1000)
    t = [torch.from_numpy(x).to(cuda) for x in (ts, vals, valid, seg)]
    got = histbin_flat(t[3], t[1], 1000, t[2])
    assert not hist_disordered(got.cpu())
    assert_hist_close(got.cpu(),
                      histbin_flat_plain(t[3], t[1], 1000, t[2]).cpu())
    assert_hist_close(
        histbin(t[0], t[1], t[2], total_ns=1e9, n_bins=77).cpu(),
        histbin_plain(t[0], t[1], t[2], total_ns=1e9, n_bins=77).cpu())
    ops = _device_ops(lambda: histbin_flat(t[3], t[1], 1000, t[2]))
    assert len(ops) == 1 and "histbin_seg_kernel" in ops[0], ops
    flipped = t[3].flip(0).contiguous()
    assert hist_disordered(histbin_flat(flipped, t[1], 1000, t[2]).cpu())
    with pytest.raises(ValueError):
        QuantileSketch.device_reduce(flipped, t[1], 1000, cuda, t[2])


@pytest.mark.parametrize("case", ["one_segment", "empty_segments",
                                  "out_of_range", "all_invalid",
                                  "ragged_block"])
def test_histbin_flat_edges_on_card(cuda, case):
    """One segment holding every row, mostly empty segments, ids below 0
    and at or above n_seg (dropped; they lead and trail the ordered
    rows), no valid row, and n_seg not a multiple of a block's 8
    segments."""
    rng = np.random.default_rng(18)
    n, n_seg = {"one_segment": (70_001, 1), "empty_segments": (50, 5000),
                "out_of_range": (9_000, 300), "all_invalid": (999, 30),
                "ragged_block": (20_000, 1_003)}[case]
    lo, hi = (-40, n_seg + 40) if case == "out_of_range" else (0, n_seg)
    seg = np.sort(rng.integers(lo, hi, n)).astype(np.int32)
    vals = rng.lognormal(8.0, 2.0, (3, n)).astype(np.float32)
    valid = (np.zeros(n, bool) if case == "all_invalid"
             else rng.random(n) > 0.1)
    t = [torch.from_numpy(x).to(cuda) for x in (seg, vals, valid)]
    got = histbin_flat(t[0], t[1], n_seg, t[2]).cpu()
    assert not hist_disordered(got)
    assert_hist_close(got, histbin_flat_plain(t[0], t[1], n_seg,
                                              t[2]).cpu())
    if case == "out_of_range":
        # a row of id -1 after a row of id 0 is disorder
        bad = t[0].clone()
        bad[-1] = -1
        assert hist_disordered(histbin_flat(bad, t[1], n_seg, t[2]).cpu())


def assert_iqr_equal(got, want):
    for key in ("sorted", "flags", "stats"):
        np.testing.assert_array_equal(got[key].cpu().numpy(),
                                      want[key].cpu().numpy())


@pytest.mark.parametrize("n", [1, 2, 3, 4_096, 12_000, 16_384, 16_385,
                               40_000, 120_000])
def test_iqr_kernel_float64_on_card(cuda, n):
    """The float64 form (the analysis path's) equals its plain version
    exactly: one cluster launch up to 16,384 keys, the tile-and-merge path
    above."""
    rng = np.random.default_rng(17)
    s = np.clip(rng.lognormal(np.log(1e7), 0.8, n), 1e6, 1e8)
    occ = rng.random(n) < 0.8
    s_t, o_t = torch.from_numpy(s).to(cuda), torch.from_numpy(occ).to(cuda)
    got = iqr_fences(s_t, o_t)
    assert got["stats"].dtype == torch.float64
    assert_iqr_equal(got, iqr_fences_plain(s_t, o_t))


@pytest.mark.parametrize("n", [1, 1000, 4096, 16384, 32768, 32769, 40000])
def test_iqr_kernel_on_card(cuda, n):
    rng = np.random.default_rng(12)
    s = rng.lognormal(3.0, 0.5, n).astype(np.float32)
    occ = rng.random(n) < 0.8
    s_t, o_t = torch.from_numpy(s).to(cuda), torch.from_numpy(occ).to(cuda)
    assert_iqr_equal(iqr_fences(s_t, o_t), iqr_fences_plain(s_t, o_t))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [6, 12_000, 40_000])
def test_iqr_kernel_edge_tables_on_card(cuda, dtype, n):
    """All scores equal, no occupied bin, ties with negatives and -0.0,
    and the 1e8-ns table of test_torch_fences.py, at one launch and on the
    tile-and-merge path."""
    rng = np.random.default_rng(n)
    ties = rng.integers(-40, 40, n) / 4
    ties[rng.random(n) < 0.05] = -0.0
    tables = [(np.full(n, 7.5), rng.random(n) < 0.8),
              (ties, np.zeros(n, bool)),
              (ties, rng.random(n) < 0.8)]
    if n == 6:
        tables.append((np.array([1e8, 1e8 + 4, 1e8 + 8, 1e8 + 12, 1e8 + 16,
                                 1e8 + 40]), np.ones(6, bool)))
    for s, occ in tables:
        s_t = torch.from_numpy(s).to(cuda, dtype)
        o_t = torch.from_numpy(occ).to(cuda)
        assert_iqr_equal(iqr_fences(s_t, o_t), iqr_fences_plain(s_t, o_t))


def test_iqr_kernel_refuses_bad_arguments(cuda):
    """The operator raises on what the kernel does not take."""
    s = torch.ones(8, device=cuda)
    occ = torch.ones(8, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        iqr_fences(s.to(torch.float16), occ)
    with pytest.raises(ValueError):
        iqr_fences(s, occ[:7])
    with pytest.raises(ValueError):
        iqr_fences(s[::2], occ[:4])
    with pytest.raises(ValueError):
        iqr_fences(s.reshape(2, 4), occ)


SSD_SHAPES = [  # b, s, H, P, G, N, chunk
    (2, 37, 4, 8, 2, 16, 8),         # s not a multiple of chunk, hg = 2
    (1, 64, 2, 16, 1, 32, 16),
    (2, 16, 8, 8, 8, 8, 16),         # G == H
    (1, 300, 32, 64, 1, 128, 128),   # mamba2-370m's P, N and chunk
    (1, 256, 4, 64, 1, 16, 128),     # hymba-1.5b's P, N and chunk
]


def ssd_inputs(seed, b, s, H, P, G, N, dtype=torch.float32,
               bc_dtype=torch.float32, device="cpu"):
    """Model-layout inputs of ``ssd_fused`` from a numpy seed."""
    rng = np.random.default_rng(seed)

    def t(a, dt):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, dt)

    f32 = torch.float32
    return (t(rng.normal(size=(b, s, H, P)), dtype),
            t(rng.uniform(0.01, 0.1, (b, s, H)), f32),
            t(rng.uniform(-1, 1, (H,)), f32),
            t(rng.normal(size=(b, s, G, N)), bc_dtype),
            t(rng.normal(size=(b, s, G, N)), bc_dtype),
            t(rng.normal(size=(H,)), f32))


@pytest.mark.parametrize("shape", SSD_SHAPES, ids=str)
@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ssd_kernel_on_card(cuda, shape, bc_dtype):
    """y and the state within rtol = atol = 1e-4 of the plain version, the
    reference's own tolerance (tests/test_kernels.py): both sum in
    float32, in another order. float32 x runs the CUDA-core kernel."""
    from repro_torch.kernels.ssd import ssd_fused, ssd_fused_plain
    b, s, H, P, G, N, chunk = shape
    args = ssd_inputs(sum(shape), b, s, H, P, G, N, bc_dtype=bc_dtype,
                      device=cuda)
    before = ssd_fused.launches
    before_tc = ssd_fused.wgmma_launches
    yk, hk = ssd_fused(*args, chunk=chunk)
    assert ssd_fused.launches == before + 1
    assert ssd_fused.wgmma_launches == before_tc
    yp, hp = ssd_fused_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    np.testing.assert_allclose(yk.cpu().numpy(), yp.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(hk.cpu().numpy(), hp.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


def _tensor_core_shape(P, N, chunk):
    return chunk == 128 and P % 16 == 0 and P <= 64 and N % 16 == 0 and \
        N <= 128


@pytest.mark.parametrize("shape", SSD_SHAPES + [(2, 333, 3, 64, 3, 48, 128),
                                                (1, 2176, 2, 64, 1, 16, 128)],
                         ids=str)
def test_ssd_kernel_bf16_on_card(cuda, shape):
    """bfloat16 x, B and C (the serving path's types): chunk 128 with P and
    N multiples of 16 runs the tensor-core kernel (counted in
    ``wgmma_launches``), anything else the CUDA-core one. y in bfloat16
    within one rounding step (rtol 2^-7, atol 1e-4) and the float32 state
    within rtol = atol = 1e-4 of the plain version. The added shapes: a
    ragged S with N = 48 (zero-filled to 64) and G == H, and hymba's S."""
    from repro_torch.kernels.ssd import ssd_fused, ssd_fused_plain
    b, s, H, P, G, N, chunk = shape
    bf = torch.bfloat16
    args = ssd_inputs(sum(shape) + 1, b, s, H, P, G, N, dtype=bf,
                      bc_dtype=bf, device=cuda)
    before_tc = ssd_fused.wgmma_launches
    yk, hk = ssd_fused(*args, chunk=chunk)
    assert ssd_fused.wgmma_launches == before_tc + _tensor_core_shape(
        P, N, chunk)
    yp, hp = ssd_fused_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert yk.dtype == bf and hk.dtype == torch.float32
    np.testing.assert_allclose(yk.float().cpu().numpy(),
                               yp.float().cpu().numpy(), rtol=2 ** -7,
                               atol=1e-4)
    np.testing.assert_allclose(hk.cpu().numpy(), hp.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


def test_ssd_kernel_reads_strided_inputs(cuda):
    """x, B and C as views of wider tensors: the tensor-core kernel's
    tensor maps read them through their strides, without copies."""
    from repro_torch.kernels.ssd import ssd_fused, ssd_fused_plain
    bf = torch.bfloat16
    xs, dt, A_log, B, C, D = ssd_inputs(4, 2, 300, 4, 128, 1, 64, dtype=bf,
                                        bc_dtype=bf, device=cuda)
    xs, B, C = xs[..., :64], B[..., :32], C[..., :32]
    assert not xs.is_contiguous()
    before_tc = ssd_fused.wgmma_launches
    yk, hk = ssd_fused(xs, dt, A_log, B, C, D, chunk=128)
    assert ssd_fused.wgmma_launches == before_tc + 1
    yp, hp = ssd_fused_plain(xs, dt, A_log, B, C, D, chunk=128)
    np.testing.assert_allclose(yk.float().cpu().numpy(),
                               yp.float().cpu().numpy(), rtol=2 ** -7,
                               atol=1e-4)
    np.testing.assert_allclose(hk.cpu().numpy(), hp.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


def test_ssd_kernel_refuses_what_it_cannot_take(cuda):
    from repro_torch.kernels.ssd import ssd_fused
    args = ssd_inputs(0, 1, 512, 2, 64, 1, 16, device=cuda)
    with pytest.raises(ValueError, match="chunk"):
        ssd_fused(*args, chunk=256)
    args = ssd_inputs(0, 1, 16, 2, 8, 1, 256, device=cuda)
    with pytest.raises(ValueError, match="d_state"):
        ssd_fused(*args, chunk=16)
    args = ssd_inputs(0, 1, 16, 2, 96, 1, 16, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        ssd_fused(*args, chunk=16)
    args = ssd_inputs(0, 1, 16, 2, 8, 1, 16, device=cuda,
                      bc_dtype=torch.float16)
    with pytest.raises(TypeError):
        ssd_fused(*args, chunk=16)


FLASH_SHAPES = [  # b, s, H, Hkv, hd, causal, window
    (2, 37, 4, 4, 8, True, 0),       # s below one tile, H == Hkv
    (2, 37, 5, 1, 64, True, 8),      # padded query rows see no real key
    (1, 300, 10, 2, 64, True, 16),   # window below a tile, H / Hkv = 5
    (1, 300, 8, 1, 128, False, 0),   # non-causal, H / Hkv = 8, hd 128
    (1, 300, 4, 2, 32, True, 500),   # window above s
    (1, 130, 4, 4, 16, True, 1),     # each query sees only itself
    (1, 1100, 5, 1, 64, True, 1024),  # hymba's heads and window
    (1, 2176, 25, 5, 64, True, 1024),  # one hymba window layer, batch 1
    (1, 2176, 25, 5, 64, True, 0),    # one hymba global layer, batch 1
    (1, 300, 6, 3, 8, False, 0),      # hd 8 zero-filled to 16, 3 key tiles
    (2, 260, 4, 1, 16, True, 100),    # hd 16, window across tile edges
    (1, 300, 32, 8, 80, True, 0),     # hd 80 zero-filled to 128, GQA 32/8
    (1, 4200, 32, 8, 80, True, 4096),  # danube's window, passed by s
    (2, 300, 16, 16, 80, False, 0),   # hubert's heads, non-causal
]


@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_kernel_on_card(cuda, shape, dtype):
    """Within rtol = atol = 2e-4 of the plain version in float32 (the
    reference's own tolerance, tests/test_kernels.py); in bfloat16 both
    round float32 results once, so they differ by at most one rounding
    step (rtol 2^-7). bfloat16 runs the tensor-core kernel, float32 the
    CUDA-core one."""
    from repro_torch.kernels.flashattn import (flash_attention,
                                               flash_attention_plain)
    b, s, H, Hkv, hd, causal, window = shape
    rng = np.random.default_rng(s + H)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, n, hd)).astype(
        np.float32)).to(cuda, dtype) for n in (H, Hkv, Hkv))
    before = flash_attention.launches
    before_tc = flash_attention.wgmma_launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert flash_attention.launches == before + 1
    assert flash_attention.wgmma_launches == before_tc + (
        dtype == torch.bfloat16)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    rtol = 2e-4 if dtype == torch.float32 else 2 ** -7
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=rtol,
                               atol=2e-4)


def test_flash_attention_kernel_reads_strided_inputs(cuda):
    """q, k and v as views of one fused projection (B, S, H + 2 Hkv, hd):
    the tensor-core kernel's tensor maps read them through their strides,
    without copies."""
    from repro_torch.kernels.flashattn import (flash_attention,
                                               flash_attention_plain)
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.normal(size=(2, 200, 7, 64)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    q, k, v = qkv[:, :, :5], qkv[:, :, 5:6], qkv[:, :, 6:]
    assert not q.is_contiguous()
    before_tc = flash_attention.wgmma_launches
    got = flash_attention(q, k, v, window=64)
    assert flash_attention.wgmma_launches == before_tc + 1
    want = flash_attention_plain(q, k, v, window=64)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=2 ** -7,
                               atol=2e-4)


def test_flash_attention_kernel_refuses_what_it_cannot_take(cuda):
    from repro_torch.kernels.flashattn import flash_attention

    def qkv(hd, H=2, Hkv=1, dtype=torch.float32):
        return [torch.zeros(1, 16, n, hd, device=cuda, dtype=dtype)
                for n in (H, Hkv, Hkv)]
    for hd in (136, 12, 256):
        with pytest.raises(ValueError, match="head_dim"):
            flash_attention(*qkv(hd))
    with pytest.raises(TypeError):
        flash_attention(*qkv(64, dtype=torch.float16))
    with pytest.raises(ValueError, match="KV heads"):
        flash_attention(*qkv(64, H=3, Hkv=2))
    _, k, v = qkv(64)
    q = torch.zeros(1, 16, 2, 128, device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="strides"):
        flash_attention(q, k, v)


SPLIT_SHAPES = [  # b, s, H, Hkv, hd, hdv, causal, window
    (1, 300, 8, 8, 192, 128, True, 0),    # deepseek-v2's MLA dims
    (1, 130, 8, 8, 192, 128, True, 0),    # a partial last query tile
    (1, 300, 4, 4, 192, 128, False, 0),   # non-causal
    (2, 333, 8, 2, 192, 128, True, 100),  # grouped heads, a window
    (1, 200, 4, 2, 160, 96, True, 64),    # zero-filled to (192, 128)
    (2, 37, 4, 4, 16, 8, True, 0),        # the smoke deepseek's, (16, 16)
    (1, 300, 4, 4, 128, 64, True, 0),     # v zero-filled to (128, 128)
]


@pytest.mark.parametrize("shape", SPLIT_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_split_head_dims_on_card(cuda, shape, dtype):
    """v's head dim below q and k's (MLA): the output takes v's, the
    launch runs in the smallest instantiation that takes both, and the
    kernel agrees with the plain version as in
    test_flash_attention_kernel_on_card."""
    from repro_torch.kernels.flashattn import (flash_attention,
                                               flash_attention_plain)
    b, s, H, Hkv, hd, hdv, causal, window = shape
    rng = np.random.default_rng(s + hd)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, n, d)).astype(
        np.float32)).to(cuda, dtype)
        for n, d in ((H, hd), (Hkv, hd), (Hkv, hdv)))
    inst = (192, 128) if hd > 128 else (max(hd, 16), max(hd, 16))
    before = flash_attention.instances.get(inst, 0)
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert flash_attention.instances[inst] == before + 1
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and tuple(got.shape) == (b, s, H, hdv)
    rtol = 2e-4 if dtype == torch.float32 else 2 ** -7
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=rtol,
                               atol=2e-4)


def test_flash_attention_kernel_refuses_split_dims_it_cannot_take(cuda):
    """v's head dim above q and k's, and q and k's above 128 with v's
    above 128 or q and k's above 192, have no instantiation."""
    from repro_torch.kernels.flashattn import flash_attention

    def qkv(hd, hdv, dtype):
        return [torch.zeros(1, 16, 2, d, device=cuda, dtype=dtype)
                for d in (hd, hd, hdv)]
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="above"):
            flash_attention(*qkv(64, 128, dtype))
        for hd, hdv in ((192, 136), (192, 192), (200, 128), (256, 128)):
            with pytest.raises(ValueError, match="head_dim"):
                flash_attention(*qkv(hd, hdv, dtype))


def test_mla_block_on_card_against_the_plain_version(cuda, monkeypatch):
    """One deepseek-v2-236b MLA block at full width in bfloat16 (128
    heads, qk 128 + 64, v 128, latents 1,536 and 512) on a prefill of 2 x
    300 tokens: one launch in the (192, 128) instantiation, the output
    within 2^-6 in norm of the same block on the plain attention (a
    rounding step of the attention through the bf16 output projection),
    and the absorbed decode of position 300 within the same of the
    expanded prefill of 301 positions."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flashattn import (flash_attention,
                                               flash_attention_plain)
    from repro_torch.models import attention
    cfg = get_config("deepseek-v2-236b").plan[0][0].attn
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = attention.attn_init(cfg, generator=gen, device=cuda,
                            dtype=torch.bfloat16)
    x = torch.randn(2, 301, cfg.d_model, generator=gen, device=cuda).to(
        torch.bfloat16)
    before = flash_attention.instances.get((192, 128), 0)
    with torch.inference_mode():
        y_k, pre = attention.attn_forward(p, x[:, :300], cfg)
        assert flash_attention.instances[(192, 128)] == before + 1
        y_full, _ = attention.attn_forward(p, x, cfg)
        cache = attention.attn_init_cache(cfg, 2, 304, torch.bfloat16, cuda)
        for key in cache:
            cache[key][:, :300] = pre[key]
        y_d, _ = attention.attn_decode(p, x[:, 300:], cache, cfg, 300)
        monkeypatch.setattr(attention, "flash_attention",
                            flash_attention_plain)
        y_p, _ = attention.attn_forward(p, x[:, :300], cfg)
    torch.cuda.synchronize()
    assert torch.isfinite(y_k).all() and y_k.shape == x[:, :300].shape
    rel = lambda a, b: float((a.float() - b.float()).norm()
                             / b.float().norm())
    assert rel(y_k, y_p) <= 2 ** -6
    assert rel(y_d, y_full[:, 300:]) <= 2 ** -6


ROLLING_SHAPES = [  # n, window
    (1, 1), (5, 16),                 # one value; window above n
    (1000, 100), (1024, 1024),       # window == n == one tile
    (2049, 64),                      # ragged last tile
    (3000, 1500),                    # window above the 1024-output tile
    (100, 1), (32768, 64),           # window 1; the micro-bench's call
]


@pytest.mark.parametrize("shape", ROLLING_SHAPES, ids=str)
@pytest.mark.parametrize("kind", ["normal", "stall"])
def test_rolling_kernel_on_card(cuda, shape, kind):
    """Both columns within rtol = 1e-4 and atol = 1e-4 * max(1, max|x|)
    of the plain version (the reference's rtol = atol = 1e-4, scaled for
    stall-magnitude values); the kernel's float64 prefixes start at each
    tile's halo, the plain version's at the series start."""
    from repro_torch.kernels.rolling import rolling_stats, rolling_stats_plain
    n, window = shape
    rng = np.random.default_rng(n + window)
    x = (rng.normal(0, 1, n) if kind == "normal"
         else rng.lognormal(10, 1, n)).astype(np.float32)
    xt = torch.from_numpy(x).to(cuda)
    before = rolling_stats.launches
    got = rolling_stats(xt, window=window)
    assert rolling_stats.launches == before + 1
    want = rolling_stats_plain(xt, window=window)
    torch.cuda.synchronize()
    assert got.shape == (n, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4,
                               atol=1e-4 * max(1.0, float(np.abs(x).max())))


def test_rolling_kernel_refuses_what_it_cannot_take(cuda):
    from repro_torch.kernels.rolling import rolling_stats
    with pytest.raises(ValueError, match="window"):
        rolling_stats(torch.ones(8, device=cuda), window=0)
    with pytest.raises(ValueError, match="empty"):
        rolling_stats(torch.ones(0, device=cuda), window=4)
    with pytest.raises(ValueError, match="series"):
        rolling_stats(torch.ones(2, 4, device=cuda), window=2)


def test_service_answers_on_the_card(cuda, tmp_path):
    """A ``torch`` query service on the card answers one fenced query
    (one tick through ``submit`` + ``drain_once``) by launching
    ``binstats_flat``, ``histbin_flat`` and ``iqr_fences`` once each, and
    agrees with a ``serial`` service on a copy of the store: counts and
    fence flags exactly, min/max in float32, means within RTOL."""
    import shutil

    from repro_torch.core import (Query, SyntheticSpec, generate_synthetic,
                                  run_generation, write_synthetic_dbs)
    from repro_torch.kernels.binstats import ops as bs
    from repro_torch.kernels.histbin import ops as hb
    from repro_torch.kernels.iqr import ops as iq
    from repro_torch.serve import QueryService, ServiceConfig
    ds = generate_synthetic(SyntheticSpec(
        n_ranks=2, kernels_per_rank=4000, memcpys_per_rank=400,
        duration_s=20.0, n_anomaly_windows=2, seed=7))
    paths = write_synthetic_dbs(ds, str(tmp_path / "dbs"))
    run_generation(paths, str(tmp_path / "store"), n_ranks=2)
    shutil.copytree(tmp_path / "store", tmp_path / "exact")
    q = Query(metrics=("k_stall",), group_by="k_device",
              reducers=("moments", "quantile"), anomaly_score="p99",
              interval_ns=100_000_000)
    answers = {}
    for backend, store in (("torch", "store"), ("serial", "exact")):
        svc = QueryService(str(tmp_path / store),
                           ServiceConfig(backend=backend, tick_ms=1.0))
        fns = (bs.binstats_flat, hb.histbin_flat, iq.iqr_fences)
        before = [f.launches for f in fns]
        p = svc.submit([q])
        assert svc.drain_once(block_s=0.0) == 1
        assert p.error is None, p.error
        launched = [f.launches - b for f, b in zip(fns, before)]
        assert launched == ([1, 1, 1] if backend == "torch" else [0, 0, 1])
        answers[backend] = p.results[0]
    got, want = answers["torch"], answers["serial"]
    assert got["n_samples"] == want["n_samples"]
    assert got["anomalous_bins"] == want["anomalous_bins"]
    for gk, cells in want["groups"].items():
        for m, cell in cells.items():
            mine = got["groups"][gk][m]
            assert mine["count"] == cell["count"]
            for f in ("min", "max"):
                assert np.float32(mine[f]) == np.float32(cell[f])
            np.testing.assert_allclose(mine["mean"], cell["mean"],
                                       rtol=RTOL)


def test_rank_pool_starts_beside_a_cuda_context(cuda, tmp_path):
    """A ``torch`` run leaves the parent holding a CUDA context; the rank
    pool of a ``process`` run started after it completes, its workers
    report that CUDA was never initialised in them, and the two
    backends' shard files are byte-equal."""
    import filecmp

    from repro_torch.core import (PipelineConfig, SyntheticSpec, TraceStore,
                                  VariabilityPipeline, generate_synthetic,
                                  write_synthetic_dbs)
    ds = generate_synthetic(SyntheticSpec(
        n_ranks=2, kernels_per_rank=4000, memcpys_per_rank=400,
        duration_s=20.0, n_anomaly_windows=2, seed=7))
    paths = write_synthetic_dbs(ds, str(tmp_path / "dbs"))
    for backend in ("torch", "process"):
        res = VariabilityPipeline(PipelineConfig(
            n_ranks=2, backend=backend)).run(paths, str(tmp_path / backend))
        assert torch.cuda.is_initialized()
        assert len(res.generation.workers) == 2
        assert not any(w["cuda_initialized"] for w in res.generation.workers)
    n = TraceStore(str(tmp_path / "torch")).read_manifest().n_shards
    names = [f"shard_{s:06d}.npz" for s in range(n)]
    match, mismatch, errors = filecmp.cmpfiles(
        str(tmp_path / "torch"), str(tmp_path / "process"), names,
        shallow=False)
    assert match == names and not mismatch and not errors


# --- training: the kernels under autograd ---------------------------------------

def _cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()).clamp_min(1e-30))


@pytest.mark.parametrize("shape", [(2, 300, 4, 64, 1, 128, 128),
                                   (1, 333, 3, 64, 3, 48, 128),
                                   (2, 37, 4, 8, 2, 16, 8)], ids=str)
def test_ssd_function_on_card(cuda, shape):
    """Under autograd the forward is one kernel launch (the tensor-core
    kernel for the bf16 chunk-128 shapes) and the gradients are autograd
    of the plain version on the same inputs: equal within rtol = atol =
    1e-5 (the same recompute, another run of the same cuBLAS calls)."""
    from repro_torch.kernels.ssd import ssd_fused, ssd_fused_plain
    b, s, H, P, G, N, chunk = shape
    bf = torch.bfloat16 if chunk == 128 else torch.float32
    base = ssd_inputs(sum(shape) + 2, b, s, H, P, G, N, dtype=bf,
                      bc_dtype=bf, device=cuda)
    g_y = torch.randn(b, s, H, P, device=cuda, dtype=bf,
                      generator=torch.Generator(cuda).manual_seed(0))
    grads, before = [], (ssd_fused.launches, ssd_fused.wgmma_launches)
    for fn in (ssd_fused, ssd_fused_plain):
        ins = [t.clone().requires_grad_() for t in base]
        y, _ = fn(*ins, chunk=chunk)
        (y.float() * g_y.float()).sum().backward()
        grads.append([t.grad for t in ins])
    assert ssd_fused.launches == before[0] + 1
    assert ssd_fused.wgmma_launches == before[1] + (chunk == 128)
    for a, b_ in zip(*grads):
        np.testing.assert_allclose(a.float().cpu().numpy(),
                                   b_.float().cpu().numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("case", [(2, 300, 10, 2, 64, True, 128),
                                  (1, 2176, 25, 5, 64, True, 1024),
                                  (1, 200, 4, 4, 32, True, 0)], ids=str)
def test_flash_function_on_card(cuda, case):
    """Under autograd the forward is one tensor-core launch and the
    gradients of q, k and v are autograd of the plain version: equal
    within rtol = atol = 1e-5."""
    from repro_torch.kernels.flashattn import (flash_attention,
                                               flash_attention_plain)
    b, s, H, Hkv, hd, causal, window = case
    gen = torch.Generator(cuda).manual_seed(s)
    bf = torch.bfloat16
    base = [torch.randn(b, s, n, hd, device=cuda, generator=gen).to(bf)
            for n in (H, Hkv, Hkv)]
    g_o = torch.randn(b, s, H, hd, device=cuda, generator=gen).to(bf)
    grads = []
    before = flash_attention.wgmma_launches
    for fn in (flash_attention, flash_attention_plain):
        ins = [t.clone().requires_grad_() for t in base]
        out = fn(*ins, causal=causal, window=window)
        (out.float() * g_o.float()).sum().backward()
        grads.append([t.grad for t in ins])
    assert flash_attention.wgmma_launches == before + 1
    for a, b_ in zip(*grads):
        np.testing.assert_allclose(a.float().cpu().numpy(),
                                   b_.float().cpu().numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("case", [(1, 300, 8, 8, 192, 128, True, 0),
                                  (1, 130, 4, 4, 192, 128, True, 0),
                                  (2, 300, 16, 16, 80, 80, False, 0)],
                         ids=str)
def test_flash_function_split_dims_and_noncausal_on_card(cuda, case):
    """The training calls of MLA (q and k 192, v 128, causal; a partial
    last tile at S = 130) and of hubert (hd 80, non-causal) under
    autograd: one tensor-core launch in the instantiation that takes the
    head dims, and the gradients of q, k and v are autograd of the plain
    version, equal within rtol = atol = 1e-5."""
    from repro_torch.kernels.flashattn import (flash_attention,
                                               flash_attention_plain)
    b, s, H, Hkv, hd, hdv, causal, window = case
    gen = torch.Generator(cuda).manual_seed(s + hd)
    bf = torch.bfloat16
    base = [torch.randn(b, s, n, d, device=cuda, generator=gen).to(bf)
            for n, d in ((H, hd), (Hkv, hd), (Hkv, hdv))]
    g_o = torch.randn(b, s, H, hdv, device=cuda, generator=gen).to(bf)
    grads = []
    before = flash_attention.wgmma_launches
    inst = (192, 128) if hd > 128 else (128, 128)
    n_inst = flash_attention.instances.get(inst, 0)
    for fn in (flash_attention, flash_attention_plain):
        ins = [t.clone().requires_grad_() for t in base]
        out = fn(*ins, causal=causal, window=window)
        assert out.shape == (b, s, H, hdv)
        (out.float() * g_o.float()).sum().backward()
        grads.append([t.grad for t in ins])
    assert flash_attention.wgmma_launches == before + 1
    assert flash_attention.instances[inst] == n_inst + 1
    for a, b_ in zip(*grads):
        np.testing.assert_allclose(a.float().cpu().numpy(),
                                   b_.float().cpu().numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_granite_moe_backward_is_bitwise_deterministic_on_card(cuda):
    """granite-moe-1b-a400m at full width, two of its 24 MoE layers, in
    the bfloat16 working copy: two loss_and_grads of one microbatch of 2
    x 1024 tokens give the same loss, metrics and gradients bit for bit
    (the router, the stable-sort dispatch whose gather reads each token
    k times, the fixed-order combine, their backward under remat, and
    the attention's plain recompute)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.models import model
    from repro_torch.train.step import (TrainConfig, batch_to,
                                        loss_and_grads, working_copy)
    full = get_config("granite-moe-1b-a400m")
    cfg = dataclasses.replace(full, plan=((full.plan[0][0], 2),))
    params = model.init_params(cfg, seed=0, device=cuda)
    batch = batch_to(make_batch(cfg, DataConfig(batch=2, seq=1024), 0),
                     cuda)
    runs = [loss_and_grads(cfg, working_copy(cfg, TrainConfig(), params),
                           batch) for _ in range(2)]
    (l1, m1, g1), (l2, m2, g2) = runs
    assert torch.isfinite(l1) and torch.equal(l1, l2)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    router = [i for i, g in enumerate(g1) if g.dtype == torch.float32
              and g.dim() == 2 and g.shape[1] == 32]
    assert len(router) == 2 and all(bool(g1[i].abs().sum() > 0)
                                    for i in router)
    for a, b_ in zip(g1, g2):
        assert torch.equal(a, b_)


def test_train_step_on_card_against_the_plain_versions(cuda, monkeypatch):
    """A two-layer bf16 hybrid model at tensor-core shapes: loss and
    gradients with the kernels against the same step with the plain
    versions: loss within 0.02, each matrix gradient's cosine >= 0.99
    (bf16 forward outputs differ by a rounding step per layer)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flashattn import flash_attention_plain
    from repro_torch.kernels.ssd import ssd_fused, ssd_fused_plain
    from repro_torch.models import attention, ssm
    from repro_torch.train.step import (TrainConfig, batch_to, init_state,
                                        loss_and_grads, working_copy)
    full = get_config("hymba-1.5b")
    plan = ((full.plan[0][0], 1), (full.plan[1][0], 1))
    cfg = dataclasses.replace(full, plan=plan, vocab=512, meta_tokens=16)
    state = init_state(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 1100))
    batch = batch_to({"tokens": toks[:, :-1], "labels": toks[:, 1:]}, cuda)
    before = ssd_fused.wgmma_launches
    loss_k, _, g_k = loss_and_grads(cfg, working_copy(
        cfg, TrainConfig(), state["params"]), batch)
    assert ssd_fused.wgmma_launches == before + 4     # 2 forward, 2 remat
    monkeypatch.setattr(ssm, "ssd_fused", ssd_fused_plain)
    monkeypatch.setattr(attention, "flash_attention", flash_attention_plain)
    loss_p, _, g_p = loss_and_grads(cfg, working_copy(
        cfg, TrainConfig(), state["params"]), batch)
    assert abs(float(loss_k) - float(loss_p)) < 0.02
    for a, b_ in zip(g_k, g_p):
        assert torch.isfinite(a).all()
        if a.dim() >= 2:
            assert _cosine(a, b_) >= 0.99


def test_granite_moe_layer_on_card_against_the_plain_version(cuda,
                                                             monkeypatch):
    """One granite-moe-1b-a400m layer at full width in bfloat16 (16 heads
    over 8 KV heads of 64, 32 experts of 512, top 8) on a prefill of 2 x
    300 tokens: the attention launches the tensor-core kernel once, and
    the layer agrees with the same layer on the plain attention. Top-k
    routing is discrete, so the plain run takes the kernel run's expert
    choices (each with its own routing weight): at most 2% of the tokens
    would have chosen otherwise, the dropped shares are equal, and the
    outputs agree within 2^-6 in norm (a rounding step of the attention,
    carried through the bfloat16 expert products)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flashattn import (flash_attention,
                                               flash_attention_plain)
    from repro_torch.models import attention, moe
    from repro_torch.models.transformer import layer_forward, layer_init
    spec = get_config("granite-moe-1b-a400m").plan[0][0]
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = layer_init(spec, 1024, generator=gen, device=cuda,
                   dtype=torch.bfloat16)
    x = torch.randn(2, 300, 1024, generator=gen, device=cuda).to(
        torch.bfloat16)
    real_route = moe._route
    chosen, moved = [], []

    def record(w, tokens, cfg):
        out = real_route(w, tokens, cfg)
        chosen.append(out[1])
        return out

    def replay(w, tokens, cfg):
        _, own, aux = real_route(w, tokens, cfg)
        top_i = chosen[0]
        moved.append(int((own.sort(-1).values != top_i.sort(-1).values)
                         .any(-1).sum()))
        top_w = torch.softmax(tokens.float() @ w.float(), -1).gather(
            -1, top_i)
        return top_w / top_w.sum(-1, keepdim=True), top_i, aux

    before = flash_attention.wgmma_launches
    with torch.inference_mode():
        monkeypatch.setattr(moe, "_route", record)
        y_k, cache, m_k = layer_forward(p, x, spec, mode="prefill")
        assert flash_attention.wgmma_launches == before + 1
        monkeypatch.setattr(attention, "flash_attention",
                            flash_attention_plain)
        monkeypatch.setattr(moe, "_route", replay)
        y_p, _, m_p = layer_forward(p, x, spec, mode="prefill")
    torch.cuda.synchronize()
    assert torch.isfinite(y_k).all() and y_k.shape == x.shape
    assert p["moe"]["router"].dtype == torch.float32
    assert moved[0] <= 0.02 * 600
    assert float(m_k["dropped"]) == float(m_p["dropped"])
    err = (y_k.float() - y_p.float()).norm() / y_p.float().norm()
    assert float(err) <= 2 ** -6


# the rank processes of the merge test below: two ranks on the one card,
# over gloo, each holding its own moment table on the card
_MERGE_RANK = """
import datetime, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.core.distributed import _collaborative_reduce
rank, port = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}',
                        rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=60))
torch.cuda.set_device(0)
tables = []
for r in range(2):
    rng = np.random.default_rng(100 + r)
    t = rng.normal(0, 1e4, (3, 1001, 5)).astype(np.float32)
    t[..., 0] = rng.integers(0, 50, (3, 1001))
    t[:, ::7, 3], t[:, ::7, 4] = 3.4e38, -3.4e38     # empty cells
    tables.append(torch.from_numpy(t).cuda())
got = _collaborative_reduce(tables[rank])
assert got.is_cuda and got.shape == (3, 1001, 5)
want = torch.cat([tables[0][..., :3] + tables[1][..., :3],
                  torch.minimum(tables[0][..., 3:4], tables[1][..., 3:4]),
                  torch.maximum(tables[0][..., 4:], tables[1][..., 4:])], -1)
assert torch.equal(got, want), (got - want).abs().max()
dist.destroy_process_group()
print('OK')
"""


def test_collaborative_reduce_two_ranks_on_the_card_bitwise(cuda):
    """``_collaborative_reduce`` over gloo with CUDA tensors in two rank
    processes on one card equals the sums in rank order and the min / max
    bit for bit (1001 bins: not a multiple of 2, so the merge pads)."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = {**os.environ, "PYTHONPATH": src}
    procs = [subprocess.Popen([sys.executable, "-c", _MERGE_RANK, str(r),
                               str(port)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=180)
        assert p.returncode == 0 and "OK" in out, err[-3000:]


# the rank processes of the tensor-parallel test below: two ranks on the
# one card over gloo, each holding its shards of one dense layer at
# danube's widths and of one MoE at granite's (bfloat16)
_TP_RANK = """
import datetime, sys
import torch, torch.distributed as dist
from repro_torch.kernels.flashattn import flash_attention
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import attention, moe, tp, transformer
from repro_torch.models.shardrules import make_ctx, shard_params
rank, port = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}',
                        rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=60))
torch.cuda.set_device(0)
dev, bf = torch.device('cuda', 0), torch.bfloat16
ctx = make_ctx(make_host_mesh(model=2))
gen = torch.Generator(device=dev).manual_seed(0)
cfg = attention.AttnConfig(d_model=2560, n_heads=32, n_kv_heads=8,
                           head_dim=80, window=256)
spec = transformer.LayerSpec(kind='attn', attn=cfg, d_ff=6912)
p = transformer.layer_init(spec, 2560, generator=gen, device=dev, dtype=bf)
x = torch.randn(1, 512, 2560, generator=gen, device=dev).to(bf)
mine = shard_params(p, ctx)
assert mine['attn']['wq'].shape == (2560, 16, 80)
assert mine['attn']['wk'].shape == (2560, 4, 80)
assert mine['ffn']['w_down'].shape == (3456, 2560)
with torch.inference_mode():
    y1, c1 = attention.attn_forward(p['attn'], x, cfg)
    before = flash_attention.wgmma_launches
    y2, c2 = attention.attn_forward(mine['attn'], x, cfg, ctx=ctx)
    assert flash_attention.wgmma_launches == before + 1
    assert torch.equal(c2['k'], c1['k'][:, :, 4 * rank:4 * rank + 4])
    l1, _, _ = transformer.layer_forward(p, x, spec, mode='prefill')
    l2, _, _ = transformer.layer_forward(mine, x, spec, mode='prefill',
                                         ctx=ctx)
    parts = [torch.randn(3, 1001, generator=torch.Generator(
        device=dev).manual_seed(9 + r), device=dev).to(bf) for r in range(2)]
    got = tp.ordered_sum(parts[rank], ctx)
    # granite's MoE with room for every assignment: the ep path (two
    # all_to_alls of bfloat16 rows) and replicated (decode) equal one rank
    mcfg = moe.MoEConfig(d_model=1024, d_ff=512, n_experts=32, top_k=8,
                         capacity_factor=4.0)
    mp = moe.moe_init(mcfg, generator=gen, device=dev, dtype=bf)
    mine_moe = shard_params({'moe': mp}, ctx)['moe']
    assert mine_moe['experts']['w_up'].shape == (16, 1024, 512)
    xm = torch.randn(1, 256, 1024, generator=gen, device=dev).to(bf)
    m1, _ = moe.moe_forward(mp, xm, mcfg)
    m2, met = moe.moe_forward(mine_moe, xm, mcfg, ctx)
    d1, _ = moe.moe_forward(mp, xm[:, :1], mcfg)
    d2, _ = moe.moe_forward(mine_moe, xm[:, :1], mcfg, ctx)
    assert float(met['dropped']) == 0.0
torch.cuda.synchronize()
for a, b in ((y1, y2), (l1, l2), (m1, m2), (d1, d2)):
    err = (a.float() - b.float()).norm() / a.float().norm()
    assert float(err) <= 2 ** -7, float(err)
assert torch.equal(got, (parts[0].float() + parts[1].float()).to(bf))
dist.destroy_process_group()
print('OK')
"""


def test_tp_blocks_two_ranks_on_the_card(cuda):
    """``attn_forward`` (the flash kernel on each rank's 16 query and 4 KV
    heads), ``layer_forward`` (attention and the gated FFN on each
    rank's hidden columns) and ``moe_forward`` (each rank's 16 of 32
    experts, the ``ep`` and ``replicated`` paths, no assignment dropped)
    at T = 2 on cuda:0 over gloo equal the one-rank block (bfloat16: the
    sums add float32 partials in another order than one rank's product,
    so within 2^-7 relative), the prefill cache is the rank's KV heads bit for bit, and
    the ordered sum equals plain float32 adds in rank order bit for
    bit."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = {**os.environ, "PYTHONPATH": src}
    procs = [subprocess.Popen([sys.executable, "-c", _TP_RANK, str(r),
                               str(port)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=180)
        assert p.returncode == 0 and "OK" in out, err[-3000:]
