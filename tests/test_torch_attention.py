"""The port's attention against the JAX package on the same inputs.

On the CPU ``repro_torch.kernels.flashattn.flash_attention`` runs its
plain version, ``flash_attention_plain``; both are held against the
Pallas kernel (in interpret mode, as tests/test_kernels.py runs it) and
its dense oracle ``flash_attention_ref``, at the reference's own test
cases plus grouped KV heads and a window of one. The attention block, its
ring-buffer decode and the rotary embedding are held against the
reference on parameters carried through ``from_reference``. Inputs come
from numpy seeds. Tolerances: 2e-4 in float32 and 3e-2 in bfloat16 for
the kernel (tests/test_kernels.py's), rtol = atol = 1e-4 for the blocks
(float32 sums in another order), 1e-5 for the rotary embedding in
float32 and one rounding step (2^-7) in bfloat16.

The CUDA kernel against its plain version, on the card, is in
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.kernels.flashattn import flash_attention as ref_flash_attention
from repro.models import attention as ref_attention
from repro.models import layers as ref_layers
from repro.models import model as ref_model
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flashattn import (flash_attention,
                                           flash_attention_plain)
from repro_torch.models import attention, layers, model
from repro_torch.models.convert import from_reference

TOL = 1e-4

# b, s, H, Hkv, hd, causal, window, dtype: tests/test_kernels.py's cases,
# grouped KV heads (H / Hkv = 3 and 5) and a window of one
FLASH_CASES = [
    (2, 100, 3, 3, 16, True, 0, "float32"),
    (2, 64, 3, 3, 16, True, 16, "float32"),
    (2, 80, 3, 3, 16, False, 0, "float32"),
    (2, 96, 3, 3, 16, True, 0, "bfloat16"),
    (2, 50, 6, 2, 16, True, 0, "float32"),
    (1, 70, 5, 1, 8, True, 8, "float32"),
    (2, 40, 4, 2, 16, True, 1, "float32"),
]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _qkv(case):
    b, s, H, Hkv, hd, _, _, dtype = case
    rng = np.random.default_rng(s + H)
    arrs = [rng.normal(size=(b, s, n, hd)).astype(np.float32)
            for n in (H, Hkv, Hkv)]
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return arrs, [torch.from_numpy(a).to(tdt) for a in arrs]


@pytest.mark.parametrize("use_kernel", [True, False], ids=["pallas", "ref"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_attention_matches_reference(case, use_kernel):
    """The port's wrapper (CPU: the plain version) and the plain version
    itself against the Pallas kernel and its oracle; the reference takes
    equal head counts, so its KV heads are repeated first."""
    _, _, H, Hkv, _, causal, window, dtype = case
    (q, k, v), (tq, tk, tv) = _qkv(case)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    rep = lambda a: jnp.repeat(jnp.asarray(a, jdt), H // Hkv, axis=2)
    want = ref_flash_attention(jnp.asarray(q, jdt), rep(k), rep(v),
                               causal=causal, window=window, q_tile=32,
                               kv_tile=32, use_kernel=use_kernel)
    tol = 2e-4 if dtype == "float32" else 3e-2
    for fn in (flash_attention, flash_attention_plain):
        got = fn(tq, tk, tv, causal=causal, window=window)
        assert got.dtype == tq.dtype and got.shape == tq.shape
        _close(got.float(), want, tol)


def test_flash_attention_window_edges():
    """Causal with window 1: each query sees only itself, so the output
    is v; a window past S is full causal attention."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 9, 2, 8))
                                .astype(np.float32)) for _ in range(3))
    out = flash_attention_plain(q, k, v, causal=True, window=1)
    _close(out, v)                         # each query sees only itself
    wide = flash_attention_plain(q, k, v, causal=True, window=100)
    _close(wide, flash_attention_plain(q, k, v, causal=True, window=0))


# b, s, H, Hkv, hd, hdv, causal, window: MLA's split head dims (the smoke
# deepseek's qk 16 / v 8 and deepseek-v2's 192 / 128), non-causal, and
# grouped KV heads with a window
SPLIT_CASES = [
    (2, 37, 4, 4, 16, 8, True, 0),
    (1, 70, 4, 4, 192, 128, True, 0),
    (1, 70, 3, 3, 192, 128, False, 0),
    (2, 50, 6, 2, 24, 16, True, 16),
]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_split_head_dims_match_chunked_attention(case):
    """The wrapper (CPU: the plain version) and the plain version at split
    head dims against the reference's ``chunked_attention``, the function
    its MLA prefill attends with (its Pallas wrapper takes one head dim),
    over 16-position chunks, in float32 within rtol = atol = 1e-5 (sums in
    another order); the default scale is the query and key head dim's."""
    b, s, H, Hkv, hd, hdv, causal, window = case
    rng = np.random.default_rng(s + hd)
    q, k = (rng.normal(size=(b, s, n, hd)).astype(np.float32)
            for n in (H, Hkv))
    v = rng.normal(size=(b, s, Hkv, hdv)).astype(np.float32)
    want = ref_attention.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_chunk=16, kv_chunk=16)
    for fn in (flash_attention, flash_attention_plain):
        got = fn(*map(torch.from_numpy, (q, k, v)), causal=causal,
                 window=window)
        assert tuple(got.shape) == (b, s, H, hdv)
        _close(got, want, 1e-5)


def test_split_head_dims_refuse_a_wider_or_misshapen_v():
    """v's head dim may be smaller than q and k's, never larger, and its
    other dims are k's."""
    q, k = torch.zeros(1, 4, 2, 16), torch.zeros(1, 4, 2, 16)
    for fn in (flash_attention, flash_attention_plain):
        with pytest.raises(ValueError, match="above"):
            fn(q, k, torch.zeros(1, 4, 2, 24))
        with pytest.raises(ValueError, match="differ"):
            fn(q, k, torch.zeros(1, 4, 1, 8))


# --- the attention block -----------------------------------------------------

def _hymba_pair(seed=0):
    cfg_ref = ref_get_smoke_config("hymba-1.5b")
    cfg = get_smoke_config("hymba-1.5b")
    tree = ref_model.init_params(cfg_ref, jax.random.PRNGKey(seed))
    params = from_reference(cfg, jax.tree.map(np.asarray, tree), "cpu")
    return cfg_ref, cfg, tree, params


@pytest.mark.parametrize("segment", [0, 1], ids=["global", "window"])
def test_attn_forward_matches_reference(segment):
    """attn_forward on the smoke hymba's global layer and its window-8
    layer (13 positions: the window is passed), output and cache entries."""
    cfg_ref, cfg, tree, params = _hybrid_layer(segment)
    x = np.random.default_rng(segment).normal(
        size=(2, 13, cfg.d_model)).astype(np.float32)
    y_r, c_r = ref_attention.attn_forward(tree, jnp.asarray(x), cfg_ref)
    y, c = attention.attn_forward(params, torch.from_numpy(x), cfg)
    _close(y, y_r)
    for key in ("k", "v"):
        _close(c[key], c_r[key])


def _hybrid_layer(segment):
    cfg_ref, cfg, tree, params = _hymba_pair()
    spec_r, spec = cfg_ref.plan[segment][0], cfg.plan[segment][0]
    layer_r = jax.tree.map(lambda a: a[0], tree["segments"][str(segment)])
    return spec_r.attn, spec.attn, layer_r["attn"], \
        params["segments"][segment][0]["attn"]


@pytest.mark.parametrize("segment", [0, 1], ids=["global", "window"])
def test_attn_decode_through_a_wrapped_ring_matches_reference(segment):
    """Prefill 13 positions (past the window of 8, so the ring wraps),
    convert the caches with _cache_from_prefill on both sides, then three
    decode steps: outputs and caches."""
    cfg_ref, cfg, tree, params = _hybrid_layer(segment)
    spec_r = ref_get_smoke_config("hymba-1.5b").plan[segment][0]
    spec = get_smoke_config("hymba-1.5b").plan[segment][0]
    rng = np.random.default_rng(10 + segment)
    x = rng.normal(size=(2, 13, cfg.d_model)).astype(np.float32)
    _, pre_r = ref_attention.attn_forward(tree, jnp.asarray(x), cfg_ref)
    _, pre = attention.attn_forward(params, torch.from_numpy(x), cfg)
    max_len = 20
    cache_r = ref_model._cache_from_prefill(
        spec_r, {"attn": jax.tree.map(lambda a: a[None], pre_r)}, max_len,
        jnp.float32)["attn"]
    cache_r = jax.tree.map(lambda a: a[0], cache_r)
    cache = model._cache_from_prefill(spec, {"attn": pre}, max_len,
                                      torch.float32)["attn"]
    want_len = 8 if segment else max_len
    assert tuple(cache["k"].shape) == (2, want_len, 1, 8)
    for key in ("k", "v"):
        _close(cache[key], cache_r[key])
    for t in range(3):
        x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        y_r, cache_r = ref_attention.attn_decode(tree, jnp.asarray(x1),
                                                 cache_r, cfg_ref, 13 + t)
        y, cache = attention.attn_decode(params, torch.from_numpy(x1),
                                         cache, cfg, 13 + t)
        _close(y, y_r)
        for key in ("k", "v"):
            _close(cache[key], cache_r[key])


def test_attn_decode_before_the_ring_wraps_matches_reference():
    """Two decode steps into an empty window-8 cache: only the written
    slots are valid."""
    cfg_ref, cfg, tree, params = _hybrid_layer(1)
    cache_r = ref_attention.attn_init_cache(cfg_ref, 1, 64, jnp.float32)
    cache = attention.attn_init_cache(cfg, 1, 64, torch.float32,
                                      torch.device("cpu"))
    assert tuple(cache["k"].shape) == cache_r["k"].shape == (1, 8, 1, 8)
    rng = np.random.default_rng(4)
    for t in range(2):
        x1 = rng.normal(size=(1, 1, cfg.d_model)).astype(np.float32)
        y_r, cache_r = ref_attention.attn_decode(tree, jnp.asarray(x1),
                                                 cache_r, cfg_ref, t)
        y, cache = attention.attn_decode(params, torch.from_numpy(x1),
                                         cache, cfg, t)
        _close(y, y_r)


# --- rotary embedding --------------------------------------------------------

@pytest.mark.parametrize("fraction", [1.0, 0.5, 0.3], ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_reference(fraction, dtype):
    """Full and partial RoPE at positions past 2,000 (hymba's prefill
    reaches 2,175); bfloat16 rotates in float32 and rounds once."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 11, 3, 16)).astype(np.float32)
    pos = np.arange(2040, 2051)[None, :]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = ref_layers.apply_rope(jnp.asarray(x, jdt), jnp.asarray(pos),
                                 10000.0, fraction)
    got = layers.apply_rope(torch.from_numpy(x).to(tdt),
                            torch.from_numpy(pos), 10000.0, fraction)
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 2 ** -7     # one bf16 rounding
    _close(got.float(), np.asarray(want, np.float32), tol)
    _close(layers.rope_freqs(16, 10000.0, 8),
           ref_layers.rope_freqs(16, 10000.0, 8), 1e-6)

