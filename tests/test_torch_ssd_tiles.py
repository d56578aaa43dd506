"""The arithmetic of the tensor-core SSD kernel, emulated on the CPU,
against the JAX package's SSD scan.

``csrc/ssd.cu``'s ``ssd_wgmma`` does not run here, so this test repeats
its chunk step in float32 PyTorch and holds the result against
``repro.kernels.ssd.ssd_fused`` (its sequential oracle ``ssd_ref``,
``use_kernel=False``) on the same bfloat16-valued inputs:

- chunks of 128 rows, the last one masked with ``dt = 0`` past ``s`` (the
  identity step); ``dtA = dt * -exp(A_log)`` and its inclusive cumsum as
  the producer warp forms it: 4 rows a lane in order, then a warp scan of
  the lane totals, ``cum = (scan - own total) + own prefix``;
- scores ``S = C B^T`` from bfloat16 operands, float32 accumulation;
- ``M = S * 2^(cum2_i - cum2_j) * dt_j`` on the causal triangle, with
  ``cum2 = float32(cum * log2(e))`` (the kernel's ``ex2``), split into
  ``hi = bf16(M)`` and ``lo = bf16(M - hi)``;
- ``Y = (C h_hi^T + C h_lo^T) * exp(cum_i) + M_hi x + M_lo x`` with the
  state ``h`` of the previous chunk split the same way, then
  ``y = Y + D x``, rounded once to bfloat16;
- ``W = dt_j exp(cum_last - cum_j) B``, split, and the float32 state
  ``h = exp(cum_last) h + x^T W_hi + x^T W_lo``.

Each of the three split operands needs its lo part:
``test_single_rounding_breaks_the_tolerance`` drops one at a time and
shows the card's tolerance broken, which is why the kernel issues each
product twice.

Shapes: the serving calls cut in batch and heads only, mamba2-370m
(S 2048, P 64, N 128) and hymba-1.5b (S 2176, P 64, N 16), and a ragged
S = 333 with N = 48 and G == H. Inputs come from numpy seeds. Tolerance:
rtol = atol = 1e-4 (the reference's own) on the emulation's float32 y,
before its rounding, and on the state; the bfloat16 y within one rounding
step of the oracle's (rtol 2^-7, atol 1e-4), as ``chip_smoke.py`` holds
the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ssd_fused as ref_ssd_fused
from test_torch_cuda import ssd_inputs

Q = 128                      # the kernel's chunk (csrc/ssd.cu)
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
TOL = 1e-4
BF16_RTOL = 2 ** -7
BF = torch.bfloat16
# b, s, H, P, G, N
SERVING_CUTS = [(1, 2048, 2, 64, 1, 128),     # mamba2-370m, 2 of 32 heads
                (1, 2176, 2, 64, 1, 16)]      # hymba-1.5b, 2 of 50 heads
RAGGED = (2, 333, 3, 64, 3, 48)


def split(v, keep_lo=True):
    """float32 -> (bf16 hi, bf16 lo) as float32 values."""
    hi = v.to(BF).float()
    return hi, ((v - hi).to(BF).float() if keep_lo else torch.zeros_like(v))


def chunk_cumsum(a):
    """The producer warp's inclusive cumsum of one chunk's 128 values
    (..., 128): 4 consecutive rows a lane, then a Hillis-Steele scan of the
    32 lane totals."""
    v = torch.cumsum(a.reshape(*a.shape[:-1], 32, 4), dim=-1)
    own = v[..., 3]
    tot = own.clone()
    off = 1
    while off < 32:
        tot = tot + torch.nn.functional.pad(tot, (off, 0))[..., :32]
        off *= 2
    return ((tot - own)[..., None] + v).reshape(a.shape)


def emulate(xs, dt, A_log, B, C, D, lo_m=True, lo_h=True, lo_w=True):
    """(y float32 before its rounding, y bfloat16, state float32), as the
    kernel computes them; ``lo_*=False`` drops one lo part."""
    b, s, H, P = xs.shape
    G, N = B.shape[2], B.shape[3]
    nc = -(-s // Q)
    pad = nc * Q - s
    F = torch.nn.functional
    x = F.pad(xs.float(), (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3)
    d = F.pad(dt.float(), (0, 0, 0, pad)).permute(0, 2, 1)  # 0: identity
    Bh = F.pad(B.float(), (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3)
    Ch = F.pad(C.float(), (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3)
    Bh = Bh.repeat_interleave(H // G, 1)
    Ch = Ch.repeat_interleave(H // G, 1)
    A = -torch.exp(A_log.float())
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    h = torch.zeros(b, H, P, N)
    ys = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        X, dc, Bc, Cc = x[:, :, sl], d[:, :, sl], Bh[:, :, sl], Ch[:, :, sl]
        cum = chunk_cumsum(dc * A[None, :, None])
        last = cum[..., -1:]
        S = Cc @ Bc.transpose(-1, -2)
        cum2 = cum * LOG2E
        E = torch.exp2(torch.where(causal, cum2[..., :, None]
                                   - cum2[..., None, :], 0.0))
        M = torch.where(causal, S * E * dc[..., None, :], 0.0)
        h_hi, h_lo = split(h, lo_h)
        Y = (Cc @ h_hi.transpose(-1, -2) + Cc @ h_lo.transpose(-1, -2)) \
            * torch.exp(cum)[..., None]
        m_hi, m_lo = split(M, lo_m)
        Y = Y + m_hi @ X + m_lo @ X
        ys.append(Y + D.float()[None, :, None, None] * X)
        W = (dc * torch.exp(last - cum))[..., None] * Bc
        w_hi, w_lo = split(W, lo_w)
        Xt = X.transpose(-1, -2)
        h = h * torch.exp(last)[..., None] + Xt @ w_hi + Xt @ w_lo
    y = torch.cat(ys, dim=2)[:, :, :s].permute(0, 2, 1, 3)
    return y, y.to(BF), h


def oracle(args):
    """The JAX package's sequential oracle on the same (float32) values."""
    ja = [jnp.asarray(a.float().numpy()) for a in args]
    y, h = ref_ssd_fused(*ja, chunk=Q, use_kernel=False)
    return (torch.from_numpy(np.array(y, np.float32)),
            torch.from_numpy(np.array(h, np.float32)))


def bf16_inputs(shape, seed):
    """ssd_inputs with bfloat16 x, B and C (the serving path's types)."""
    return ssd_inputs(seed, *shape, dtype=BF, bc_dtype=BF)


def excess(got, want, rtol, atol=TOL):
    """max(|got - want| - rtol |want|): within tolerance iff <= atol."""
    return float(((got.double() - want.double()).abs()
                  - rtol * want.double().abs()).max()), atol


@pytest.mark.parametrize("shape", SERVING_CUTS + [RAGGED], ids=str)
def test_emulation_matches_reference(shape):
    args = bf16_inputs(shape, sum(shape))
    y32, ybf, h = emulate(*args)
    yr, hr = oracle(args)
    np.testing.assert_allclose(y32.numpy(), yr.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(h.numpy(), hr.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ybf.float().numpy(),
                               yr.to(BF).float().numpy(), rtol=BF16_RTOL,
                               atol=TOL)


def test_chunk_cumsum_is_a_cumsum():
    """The lane-and-warp scan is an inclusive cumsum (within float32
    rounding of a sequential one)."""
    a = torch.from_numpy(-np.random.default_rng(3).uniform(0, 2, (5, Q))
                         .astype(np.float32))
    np.testing.assert_allclose(chunk_cumsum(a).numpy(),
                               np.cumsum(a.double().numpy(), -1),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("drop", ["m", "h", "w"])
def test_single_rounding_breaks_the_tolerance(drop):
    """One bf16 rounding of M (the intra product's operand), of the state
    h (the inter product's) or of W (the state product's) puts y beyond one
    bfloat16 rounding step of the oracle, and W's the state beyond 1e-4,
    at mamba2's serving shape: each lo part is needed."""
    args = bf16_inputs(SERVING_CUTS[0], 11)
    yr, hr = oracle(args)
    _, ybf, h = emulate(*args, **{f"lo_{drop}": False})
    bad, tol = excess(ybf.float(), yr.to(BF).float(), BF16_RTOL)
    assert bad > 10 * tol
    bad, tol = excess(h, hr, TOL)
    if drop == "w":
        assert bad > tol
    else:
        assert bad <= tol          # h itself stays float32 in registers
