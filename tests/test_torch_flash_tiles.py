"""The arithmetic of the tensor-core attention kernel, emulated on the CPU,
against the JAX package's flash attention.

``csrc/flashattn.cu``'s bfloat16 kernel does not run here, so this test
repeats its arithmetic step by step in float32 PyTorch and holds the
result against ``repro.kernels.flashattn.flash_attention`` (its dense
oracle, ``use_kernel=False``) on the same bfloat16 inputs:

- 128-row query tiles, each split into the two 64-row halves that the
  kernel's two consumer warpgroups own;
- 64-key tiles, visited from the last one a half can see down to the
  first (the visit bound: keys in ``[q0 - window + 1, q_last]`` with a
  window, ``[0, q_last]`` when causal), zero past ``s``;
- scores scaled by ``scale * log2(e)``, masked only on the tiles that
  cross the causal diagonal, the window's lower edge or ``s`` (the
  emulation checks that every other tile has nothing to mask);
- float32 running max and sum, ``exp2``, alpha = p = 0 while a row has
  seen no key;
- P split into two bfloat16 parts, hi = bf16(p) and lo = bf16(p - hi),
  each multiplied by V with float32 accumulation (two P V products);
- one division by ``max(l, 1e-20)`` and one rounding to bfloat16.

P rounded once to bfloat16 breaks the tolerance below (a row whose output
is a small difference of large values keeps the 2^-9 relative error of
each weight): ``test_single_bf16_p_breaks_the_tolerance`` shows it, and
is why the kernel issues the second product.

Shapes: every flash edge shape of ``chip_smoke.py`` and one hymba-1.5b
layer at batch 1 (S = 2,176, 25 query heads over 5 KV heads of 64, window
1,024 and global). At MLA's split head dims (q and k hd, v hdv < hd: the
(192, 128) instantiation's 12-step S = Q K^T and 128-column P V, and the
smoke deepseek's 16 / 8, zero-filled to (16, 16)) the oracle is the
reference's ``chunked_attention``, the function its MLA prefill attends
with (its Pallas wrapper takes one head dim), computed in float32 on the
same bfloat16 inputs and rounded once to bfloat16 as the kernel's output
is. Inputs come from numpy seeds. Tolerance: the card's bfloat16 one,
rtol 2^-7 and atol 2e-4 (tests/test_torch_cuda.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flashattn import flash_attention as ref_flash_attention
from repro.models.attention import chunked_attention

BQ, BK, HALF = 128, 64, 64        # the kernel's tiles (csrc/flashattn.cu)
LOG2E = 1.4426950408889634

# b, s, H, Hkv, hd, causal, window: chip_smoke.py's FLASH_EDGE_SHAPES
EDGE_SHAPES = [(2, 37, 4, 4, 8, True, 0), (2, 37, 5, 1, 64, True, 8),
               (1, 300, 10, 2, 64, True, 16), (1, 300, 8, 1, 128, False, 0),
               (1, 300, 4, 2, 32, True, 500), (1, 130, 4, 4, 16, True, 1),
               (1, 1100, 5, 5, 64, True, 1024)]
HYMBA_SHAPES = [(1, 2176, 25, 5, 64, True, 1024),
                (1, 2176, 25, 5, 64, True, 0)]
# b, s, H, Hkv, hd, hdv, causal, window: chip_smoke.py's split-dim
# FLASH_EDGE_SHAPES
SPLIT_SHAPES = [(1, 300, 8, 8, 192, 128, True, 0),
                (1, 130, 8, 8, 192, 128, True, 0),
                (1, 300, 4, 4, 192, 128, False, 0),
                (1, 200, 4, 2, 160, 96, True, 64),
                (2, 37, 4, 4, 16, 8, True, 0)]


def needs_mask(k0, r_lo, s, causal, window):
    """The kernel's test of whether a key tile at k0 can hide a key from
    one of the 64 rows starting at r_lo."""
    return (k0 + BK > s or (causal and k0 + BK - 1 > r_lo)
            or (window > 0 and r_lo + HALF - 1 - k0 >= window))


def emulate(q, k, v, causal, window, split=True):
    """q (b, s, H, hd), k (b, s, Hkv, hd) and v (b, s, Hkv, hdv), float32
    holding bfloat16 values; returns the kernel's (b, s, H, hdv) output as
    float32 (with ``split=False``, P rounded once instead of split in
    two)."""
    b, s, H, hd = q.shape
    hdv = v.shape[-1]
    g = H // k.shape[2]
    qh = q.permute(0, 2, 1, 3)
    kh = k.repeat_interleave(g, 2).permute(0, 2, 1, 3)
    vh = v.repeat_interleave(g, 2).permute(0, 2, 1, 3)
    n_pad = -(-s // BQ) * BQ
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, n_pad - s))
    qh, kh, vh = pad(qh), pad(kh), pad(vh)
    sl2 = torch.tensor(hd ** -0.5 * LOG2E, dtype=torch.float32)
    out = torch.zeros(b, H, n_pad, hdv)
    for q0 in range(0, s, BQ):
        q_last = min(q0 + BQ - 1, s - 1)
        hi = q_last if causal else s - 1
        lo = max(q0 - window + 1, 0) if window > 0 else 0
        for r_lo in (q0, q0 + HALF):
            rows = torch.arange(r_lo, r_lo + HALF)[:, None]
            qt = qh[:, :, r_lo:r_lo + HALF]
            m = torch.full((b, H, HALF), -math.inf)
            l = torch.zeros(b, H, HALF)
            acc = torch.zeros(b, H, HALF, hdv)
            for k0 in range(hi // BK * BK, lo // BK * BK - 1, -BK):
                sc = (qt @ kh[:, :, k0:k0 + BK].transpose(-1, -2)) * sl2
                cols = torch.arange(k0, k0 + BK)[None, :]
                ok = cols < s
                if causal:
                    ok = ok & (rows >= cols)
                if window > 0:
                    ok = ok & (rows - cols < window)
                if needs_mask(k0, r_lo, s, causal, window):
                    sc = sc.masked_fill(~ok, -math.inf)
                else:
                    assert bool(ok.all()), (k0, r_lo)
                m_new = torch.maximum(m, sc.amax(-1))
                m_use = torch.where(m_new == -math.inf, 0.0, m_new)
                alpha = torch.exp2(m - m_use)
                p = torch.exp2(sc - m_use[..., None])
                l = l * alpha + p.sum(-1)
                vt = vh[:, :, k0:k0 + BK]
                hi_p = p.to(torch.bfloat16).float()
                acc = acc * alpha[..., None] + hi_p @ vt
                if split:
                    acc = acc + (p - hi_p).to(torch.bfloat16).float() @ vt
                m = m_new
            out[:, :, r_lo:r_lo + HALF] = acc / l.clamp_min(1e-20)[..., None]
    return out[:, :, :s].permute(0, 2, 1, 3).to(torch.bfloat16).float()


def reference(q, k, v, causal, window):
    """The JAX package's flash attention (dense oracle) in bfloat16, one
    KV head's group of query heads at a time (it takes equal head
    counts)."""
    H, Hkv = q.shape[2], k.shape[2]
    g = H // Hkv
    bf = lambda a: jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    outs = []
    for j in range(Hkv):
        qj = bf(q[:, :, j * g:(j + 1) * g])
        kj = jnp.repeat(bf(k[:, :, j:j + 1]), g, axis=2)
        vj = jnp.repeat(bf(v[:, :, j:j + 1]), g, axis=2)
        outs.append(np.asarray(ref_flash_attention(
            qj, kj, vj, causal=causal, window=window, use_kernel=False),
            np.float32))
    return np.concatenate(outs, axis=2)


def _case(shape, split=True):
    b, s, H, Hkv, hd, causal, window = shape
    rng = np.random.default_rng(s + H + hd)
    q, k, v = (rng.normal(size=(b, s, n, hd)).astype(np.float32)
               for n in (H, Hkv, Hkv))
    t = lambda a: torch.from_numpy(a).to(torch.bfloat16).float()
    got = emulate(t(q), t(k), t(v), causal, window, split=split)
    return got.numpy(), reference(q, k, v, causal, window)


@pytest.mark.parametrize("shape", EDGE_SHAPES + HYMBA_SHAPES, ids=str)
def test_kernel_arithmetic_matches_reference(shape):
    got, want = _case(shape)
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2e-4)


def test_single_bf16_p_breaks_the_tolerance():
    got, want = _case(EDGE_SHAPES[0], split=False)
    assert (np.abs(got - want) > 2e-4 + 2 ** -7 * np.abs(want)).any()


@pytest.mark.parametrize("shape", SPLIT_SHAPES, ids=str)
def test_split_dims_arithmetic_matches_chunked_attention(shape):
    b, s, H, Hkv, hd, hdv, causal, window = shape
    rng = np.random.default_rng(s + H + hd)
    q, k = (rng.normal(size=(b, s, n, hd)).astype(np.float32)
            for n in (H, Hkv))
    v = rng.normal(size=(b, s, Hkv, hdv)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(torch.bfloat16).float()
    got = emulate(t(q), t(k), t(v), causal, window).numpy()
    want = chunked_attention(*(jnp.asarray(t(a).numpy()) for a in (q, k, v)),
                             causal=causal, window=window, q_chunk=64,
                             kv_chunk=64)
    want = np.asarray(jnp.asarray(want).astype(jnp.bfloat16), np.float32)
    assert got.shape == want.shape == (b, s, H, hdv)
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2e-4)
