"""MLA attention and deepseek-v2-236b against the JAX package on the same
weights.

Weights come from the reference's initialisers and cross through
``repro_torch.models.convert.from_reference`` (a single MLA block: its
numpy leaves as they are); inputs come from numpy seeds. Everything runs
in float32 on the CPU, where ``flash_attention`` takes its plain version
at MLA's split head dims (q and k nope + rope, v v_head_dim). MLA's
decode is the weight-absorbed latent form in both packages, a different
float order of the same function as prefill's expanded form, so
prefill(N) + decode is held to prefill(N + 1) at the same tolerance.
Tolerance: rtol = atol = 1e-4 on outputs, logits, caches and losses
(float32 sums in another order; tests/test_torch_models.py's TOL);
generated tokens equal; the MoE's dropped share within 1e-6 (a mean of
per-layer shares, below one assignment in the smallest call).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import make_batch as ref_make_batch
from repro.models import attention as ref_attention
from repro.models import model as ref_model
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import ServeEngine as RefServeEngine
from repro.train.checkpoint import _flatten as ref_flatten
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import DataConfig, make_batch
from repro_torch.models import attention, model
from repro_torch.models.convert import (from_reference, state_from_flat,
                                        state_to_flat)
from repro_torch.serve import ServeConfig, ServeEngine

TOL = 1e-4
ARCH = "deepseek-v2-236b"
MLA_LEAVES = {"wq_a", "wq_b", "wkv_a", "wk_rope", "wk_b", "wv_b", "wo",
              "q_norm", "kv_norm"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors gain nothing from torch's intra-op threads, and in a
    loaded parallel run those threads wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _pair(cfg_ref, cfg, seed=0):
    params_ref = ref_model.init_params(cfg_ref, jax.random.PRNGKey(seed))
    return params_ref, from_reference(
        cfg, jax.tree.map(np.asarray, params_ref), "cpu")


def _smoke(seed=0):
    cfg_ref, cfg = ref_get_smoke_config(ARCH), get_smoke_config(ARCH)
    return (cfg_ref, cfg) + _pair(cfg_ref, cfg, seed)


def _jnp(batch):
    return {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def _close_caches(caches, caches_r):
    for seg, seg_r in zip(caches, caches_r):
        for layer, c in enumerate(seg):
            assert set(c["attn"]) == {"latent", "k_rope"}
            for k, v in c["attn"].items():
                _close(v, seg_r["attn"][k][layer])


# --- the MLA block -----------------------------------------------------------

def _mla_block(seed):
    """The smoke config's MLA attention in both packages and one block's
    parameters (the reference's, and the port's as float32 tensors)."""
    (spec_r, _), _ = ref_get_smoke_config(ARCH).plan
    (spec, _), _ = get_smoke_config(ARCH).plan
    tree = ref_attention.attn_init(jax.random.PRNGKey(seed), spec_r.attn)
    params = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)
    return spec_r.attn, spec.attn, tree, params


def test_mla_forward_decode_and_cache_match_reference():
    """Prefill of 2 x 11 positions: output and the cache entries (the
    normed latent and the rotated rope key, no per-head K/V); the cache
    layout of ``attn_init_cache``; then three absorbed decode steps into
    the prefill's cache padded to 16 slots, outputs and caches."""
    cfg_r, cfg, tree, params = _mla_block(0)
    assert cfg.is_mla and set(params) == MLA_LEAVES
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 11, cfg.d_model)).astype(np.float32)
    y_r, pre_r = ref_attention.attn_forward(tree, jnp.asarray(x), cfg_r)
    y, pre = attention.attn_forward(params, torch.from_numpy(x), cfg)
    _close(y, y_r)
    assert set(pre) == set(pre_r) == {"latent", "k_rope"}
    assert tuple(pre["latent"].shape) == (2, 11, cfg.kv_lora_rank)
    assert tuple(pre["k_rope"].shape) == (2, 11, cfg.qk_rope_dim)
    for key in pre:
        _close(pre[key], pre_r[key])

    cache_r = ref_attention.attn_init_cache(cfg_r, 2, 16, jnp.float32)
    cache = attention.attn_init_cache(cfg, 2, 16, torch.float32,
                                      torch.device("cpu"))
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: v.shape for k, v in cache_r.items()}
    for key in cache:
        cache[key][:, :11] = pre[key]
        cache_r[key] = cache_r[key].at[:, :11].set(pre_r[key])
    for t in range(3):
        x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        y_r, cache_r = ref_attention.attn_decode(
            tree, jnp.asarray(x1), cache_r, cfg_r, jnp.asarray(11 + t))
        y, cache = attention.attn_decode(params, torch.from_numpy(x1),
                                         cache, cfg, 11 + t)
        _close(y, y_r)
        for key in cache:
            _close(cache[key], cache_r[key])


def test_mla_decode_continues_its_prefill():
    """The absorbed decode of position N against the expanded prefill of
    N + 1 positions, in the port: the same function in another float
    order."""
    _, cfg, _, params = _mla_block(1)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 10, cfg.d_model)).astype(np.float32))
    y_full, _ = attention.attn_forward(params, x, cfg)
    _, pre = attention.attn_forward(params, x[:, :-1], cfg)
    cache = attention.attn_init_cache(cfg, 2, 12, torch.float32,
                                      torch.device("cpu"))
    for key in cache:
        cache[key][:, :9] = pre[key]
    y, _ = attention.attn_decode(params, x[:, -1:], cache, cfg, 9)
    _close(y, y_full[:, -1:])


def test_mla_training_forward_keeps_no_cache():
    _, cfg, _, params = _mla_block(2)
    x = torch.zeros(1, 4, cfg.d_model)
    y, cache = attention.attn_forward(params, x, cfg, cache=False)
    assert cache is None and tuple(y.shape) == (1, 4, cfg.d_model)


# --- deepseek's smoke config -------------------------------------------------

def _prompt(cfg, seed, b, s):
    return {"tokens": np.random.default_rng(seed).integers(0, cfg.vocab,
                                                            (b, s))}


def test_prefill_caches_and_decode_match_reference():
    """Prefill of a 13-token prompt through the dense first layer and the
    two MoE layers: last-token logits, the index and every cache (latent
    and rope key, zero past the prompt); then two decode steps, logits and
    caches."""
    cfg_ref, cfg, params_ref, params = _smoke()
    toks = _prompt(cfg, 7, 2, 15)["tokens"]
    lg_r, caches_r, idx_r = ref_model.prefill(
        cfg_ref, params_ref, {"tokens": jnp.asarray(toks[:, :13])},
        max_len=32, cache_dtype=jnp.float32)
    lg, caches, idx = model.prefill(
        cfg, params, {"tokens": torch.from_numpy(toks[:, :13])}, 32,
        torch.float32)
    assert idx == int(idx_r) == 13
    assert tuple(lg.shape) == (2, cfg.vocab)
    _close(lg, lg_r)
    _close_caches(caches, caches_r)
    assert tuple(caches[1][0]["attn"]["latent"].shape) == (2, 32, 16)
    assert not caches[0][0]["attn"]["k_rope"][:, 13:].any()
    for t in (13, 14):
        lg_r, caches_r = ref_model.decode_step(
            cfg_ref, params_ref, jnp.asarray(toks[:, t:t + 1], jnp.int32),
            caches_r, idx_r + t - 13)
        lg, caches = model.decode_step(
            cfg, params, torch.from_numpy(toks[:, t:t + 1]), caches,
            idx + t - 13)
        _close(lg, lg_r)
    _close_caches(caches, caches_r)


def test_decode_continues_a_prefill():
    """prefill(N) + decode == prefill(N + 1) through the whole smoke
    model."""
    _, cfg, _, params = _smoke(seed=2)
    toks = torch.from_numpy(_prompt(cfg, 9, 2, 12)["tokens"])
    lg_full, _, _ = model.prefill(cfg, params, {"tokens": toks}, 32,
                                  torch.float32)
    _, caches, idx = model.prefill(cfg, params, {"tokens": toks[:, :-1]},
                                   32, torch.float32)
    lg, _ = model.decode_step(cfg, params, toks[:, -1:], caches, idx)
    _close(lg, lg_full)


def test_engine_tokens_match_reference():
    cfg_ref, cfg, params_ref, params = _smoke(seed=3)
    batch = _prompt(cfg, 4, 2, 12)
    want = RefServeEngine(cfg_ref, params_ref, RefServeConfig(
        max_len=64, max_new_tokens=6, cache_dtype=jnp.float32)).generate(
        _jnp(batch))
    eng = ServeEngine(cfg, params, ServeConfig(
        max_len=64, max_new_tokens=6, cache_dtype=torch.float32),
        device="cpu")
    np.testing.assert_array_equal(eng.generate(batch), np.asarray(want))


def test_loss_fn_matches_reference():
    """``loss_fn`` on the data pipeline's batch: the CE, the two MoE
    layers' aux loss and their mean dropped share."""
    cfg_ref, cfg, params_ref, params = _smoke(seed=5)
    batch = make_batch(cfg, DataConfig(batch=2, seq=24), 0)
    ref_batch = ref_make_batch(cfg_ref, RefDataConfig(batch=2, seq=24), 0)
    for k in ref_batch:
        np.testing.assert_array_equal(batch[k], ref_batch[k])
    loss_r, m_r = ref_model.loss_fn(cfg_ref, params_ref, _jnp(ref_batch))
    with torch.no_grad():
        loss, m = model.loss_fn(cfg, params, _torch(batch))
    _close(loss, loss_r)
    assert set(m) == set(m_r) >= {"aux_loss", "dropped", "ce", "loss"}
    for k in m_r:
        _close(m[k], m_r[k], 1e-6 if k == "dropped" else TOL)
    assert float(m["aux_loss"]) > 0.0
    _close(m["loss"], float(m["ce"]) + float(m["aux_loss"]))


def test_loss_gradients_flow_through_mla():
    """Autograd through the split-dim attention (the plain recompute on
    the CPU): every MLA leaf of every layer gets a finite, non-zero
    gradient."""
    _, cfg, _, params = _smoke(seed=6)
    batch = _torch(make_batch(cfg, DataConfig(batch=2, seq=16), 1))
    for seg in params["segments"]:
        for layer in seg:
            for v in layer["attn"].values():
                for t in (v.values() if isinstance(v, dict) else [v]):
                    t.requires_grad_(True)
    loss, _ = model.loss_fn(cfg, params, batch)
    loss.backward()
    for seg in params["segments"]:
        for layer in seg:
            for name in ("wq_b", "wk_b", "wv_b", "wk_rope", "wo"):
                g = layer["attn"][name].grad
                assert g is not None and bool(torch.isfinite(g).all())
                assert float(g.abs().max()) > 0.0, name


# --- real widths -------------------------------------------------------------

def test_one_mla_layer_at_real_widths_matches_reference():
    """One attention-only layer of deepseek-v2-236b's MLA at its widths
    (d_model 5120, 128 heads, q_lora 1536, kv_lora 512, qk 128 + 64, v
    128), no MoE and no FFN, the vocabulary cut to 512: prefill of 2 x 9
    tokens, logits and caches, then one decode step."""
    out = []
    for cfg in (ref_get_config(ARCH), get_config(ARCH)):
        (dense, _), _ = cfg.plan
        ref = isinstance(cfg, ref_model.ModelConfig)
        out.append(dataclasses.replace(
            cfg, vocab=512, plan=((dataclasses.replace(dense, d_ff=0), 1),),
            dtype=jnp.float32 if ref else torch.float32))
    cfg_ref, cfg = out
    attn = cfg.plan[0][0].attn
    assert (attn.d_model, attn.n_heads, attn.q_lora_rank,
            attn.kv_lora_rank, attn.qk_nope_dim, attn.qk_rope_dim,
            attn.v_head_dim) == (5120, 128, 1536, 512, 128, 64, 128)
    params_ref, params = _pair(cfg_ref, cfg, seed=8)
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (2, 10))
    lg_r, caches_r, idx_r = ref_model.prefill(
        cfg_ref, params_ref, {"tokens": jnp.asarray(toks[:, :9], jnp.int32)},
        max_len=12, cache_dtype=jnp.float32)
    lg, caches, idx = model.prefill(
        cfg, params, {"tokens": torch.from_numpy(toks[:, :9])}, 12,
        torch.float32)
    _close(lg, lg_r)
    _close_caches(caches, caches_r)
    lg_r, _ = ref_model.decode_step(cfg_ref, params_ref,
                                    jnp.asarray(toks[:, 9:], jnp.int32),
                                    caches_r, idx_r)
    lg, _ = model.decode_step(cfg, params, torch.from_numpy(toks[:, 9:]),
                              caches, idx)
    _close(lg, lg_r)


# --- parameters, checkpoints, the CLI ----------------------------------------

def _sig(t):
    if isinstance(t, dict):
        return {k: _sig(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_sig(v) for v in t]
    return (tuple(t.shape), t.dtype)


def test_init_params_has_the_reference_structure():
    """The port's initialiser builds the converter's tree in bfloat16:
    the MLA leaves with the reference's shapes, the latent norms' scales
    and the router in float32, the shared experts, and the reference's
    parameter count."""
    cfg_ref = ref_get_smoke_config(ARCH)
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype=torch.bfloat16)
    shapes = jax.eval_shape(lambda: ref_model.init_params(
        cfg_ref, jax.random.PRNGKey(0)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    got = model.init_params(cfg, seed=0, device="cpu")
    assert _sig(got) == _sig(from_reference(cfg, zeros, "cpu"))
    assert model.param_count(got) == ref_model.param_count(shapes)
    dense, moe_layer = got["segments"][0][0], got["segments"][1][0]
    a = cfg.plan[0][0].attn
    assert set(dense["attn"]) == MLA_LEAVES and "ffn" in dense
    assert dense["attn"]["wq_b"].shape == (
        a.q_lora_rank, a.n_heads, a.qk_nope_dim + a.qk_rope_dim)
    assert dense["attn"]["wv_b"].dtype == torch.bfloat16
    assert dense["attn"]["kv_norm"]["scale"].dtype == torch.float32
    assert set(moe_layer["moe"]) == {"router", "experts", "shared"}


def test_checkpoint_keys_carry_the_mla_leaves():
    """The reference's flat checkpoint dictionary of the smoke model:
    ``state_to_flat`` of the port's tree gives its keys and arrays (each
    segment's leaves stacked over its layers), and ``state_from_flat``
    reads it back."""
    _, _, params_ref, params = _smoke(seed=9)
    want = ref_flatten({"params": params_ref})
    got = state_to_flat({"params": params})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    for seg in (0, 1):
        for leaf in ("wq_a", "wq_b", "wkv_a", "wk_rope", "wk_b", "wv_b",
                     "wo", "q_norm/scale", "kv_norm/scale"):
            assert f"params/segments/{seg}/attn/{leaf}" in want
    back = state_from_flat({"params": params}, want)["params"]
    assert _sig(back) == _sig(params)
    for seg, seg_b in zip(params["segments"], back["segments"]):
        for layer, layer_b in zip(seg, seg_b):
            for name in MLA_LEAVES - {"q_norm", "kv_norm"}:
                assert torch.equal(layer["attn"][name],
                                   layer_b["attn"][name])


def test_serve_cli_on_the_host(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
          "--prompt-len", "9", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 3) on cpu" in out
    assert "decode 2 steps" in out
