"""The port's model stack against the JAX package on the same weights.

Weights come from the JAX package's ``init_params`` (or ``ssm_init``)
and cross through ``repro_torch.models.convert``; inputs come from numpy
seeds. Everything runs in float32 on the CPU, where the port's SSD scan
and attention take their plain versions. Tolerance: rtol = atol = 1e-4 on
activations, logits and caches (float32 sums in another order; the SSD
scan's own tolerance), unless a test states another. Generated tokens are
equal. mamba2-370m and hymba-1.5b are the architectures ported so far.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import layers as ref_layers
from repro.models import model as ref_model
from repro.models import ssm as ref_ssm
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import ServeEngine as RefServeEngine
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.models import attention, layers, model, ssm
from repro_torch.models.convert import from_reference
from repro_torch.models.transformer import LayerSpec, layer_init
from repro_torch.serve import ServeConfig, ServeEngine

TOL = 1e-4
CPU = torch.device("cpu")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _pair(cfg_ref, cfg, seed=0):
    params_ref = ref_model.init_params(cfg_ref, jax.random.PRNGKey(seed))
    return params_ref, from_reference(cfg, _np_tree(params_ref), "cpu")


def _cut(cfg_ref, cfg, layers):
    """Both configs with depth cut to ``layers`` and float32 compute."""
    (spec_r, _), = cfg_ref.plan
    (spec, _), = cfg.plan
    return (dataclasses.replace(cfg_ref, plan=((spec_r, layers),),
                                dtype=jnp.float32),
            dataclasses.replace(cfg, plan=((spec, layers),),
                                dtype=torch.float32))


def _hymba_cut(cfg_ref, cfg):
    """hymba with depth cut to its first global layer and one window
    layer, float32 compute."""
    plan_r = ((cfg_ref.plan[0][0], 1), (cfg_ref.plan[1][0], 1))
    plan = ((cfg.plan[0][0], 1), (cfg.plan[1][0], 1))
    return (dataclasses.replace(cfg_ref, plan=plan_r, dtype=jnp.float32),
            dataclasses.replace(cfg, plan=plan, dtype=torch.float32))


# --- SSM block --------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["xla-scan", "pallas"])
@pytest.mark.parametrize("groups", [1, 2])
def test_ssm_block_matches_reference(use_pallas, groups):
    """ssm_forward (output and decode cache) and two ssm_decode steps."""
    rng = np.random.default_rng(groups)
    kw = dict(d_model=32, d_state=16, head_dim=8, n_groups=groups, chunk=8)
    cfg_ref = ref_ssm.SSMConfig(use_pallas=use_pallas, **kw)
    cfg = ssm.SSMConfig(**kw)
    p_ref = ref_ssm.ssm_init(jax.random.PRNGKey(groups), cfg_ref)
    p = _torch_tree(_np_tree(p_ref))
    x = rng.normal(size=(2, 20, 32)).astype(np.float32)
    out_r, cache_r = ref_ssm.ssm_forward(p_ref, jnp.asarray(x), cfg_ref)
    out, cache = ssm.ssm_forward(p, torch.from_numpy(x), cfg)
    _close(out, out_r)
    for k in ("conv_x", "conv_b", "conv_c", "state"):
        _close(cache[k], cache_r[k])
    for _ in range(2):
        x1 = rng.normal(size=(2, 1, 32)).astype(np.float32)
        out_r, cache_r = ref_ssm.ssm_decode(p_ref, jnp.asarray(x1), cache_r,
                                            cfg_ref)
        out, cache = ssm.ssm_decode(p, torch.from_numpy(x1), cache, cfg)
        _close(out, out_r)
        for k in ("conv_x", "conv_b", "conv_c", "state"):
            _close(cache[k], cache_r[k])


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 9, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    want = ref_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b))
    got = ssm._causal_conv(*map(torch.from_numpy, (x, w, b)))
    _close(got, want, 1e-5)


# --- whole model on the smoke config ----------------------------------------

def test_prefill_and_decode_match_reference():
    cfg_ref = ref_get_smoke_config("mamba2-370m")
    cfg = get_smoke_config("mamba2-370m")
    params_ref, params = _pair(cfg_ref, cfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 13))
    lg_r, caches_r, idx_r = ref_model.prefill(
        cfg_ref, params_ref, {"tokens": jnp.asarray(toks[:, :-1], jnp.int32)},
        max_len=32, cache_dtype=jnp.float32)
    lg, caches, idx = model.prefill(
        cfg, params, {"tokens": torch.from_numpy(toks[:, :-1])}, max_len=32,
        cache_dtype=torch.float32)
    assert idx == int(idx_r) == 12
    _close(lg, lg_r)
    for layer, c in enumerate(caches[0]):
        for k, v in c["ssm"].items():
            _close(v, caches_r[0]["ssm"][k][layer])
    lg2_r, _ = ref_model.decode_step(cfg_ref, params_ref,
                                     jnp.asarray(toks[:, -1:], jnp.int32),
                                     caches_r, idx_r)
    lg2, _ = model.decode_step(cfg, params, torch.from_numpy(toks[:, -1:]),
                               caches, idx)
    _close(lg2, lg2_r)
    # prefill(N) + decode == prefill(N + 1) in the port itself
    lg_full, _, _ = model.prefill(cfg, params,
                                  {"tokens": torch.from_numpy(toks)}, 32)
    _close(lg2, lg_full)


def test_decode_from_an_empty_cache_matches_reference():
    """init_cache's zero caches (the reference's layout, one dict per
    layer) and two decode steps from them."""
    cfg_ref = ref_get_smoke_config("mamba2-370m")
    cfg = get_smoke_config("mamba2-370m")
    params_ref, params = _pair(cfg_ref, cfg, seed=5)
    caches_r = ref_model.init_cache(cfg_ref, 2, 16, dtype=jnp.float32)
    caches = model.init_cache(cfg, 2, 16, torch.float32, "cpu")
    assert len(caches[0]) == 3
    for k, v in caches[0][0]["ssm"].items():
        assert tuple(v.shape) == caches_r[0]["ssm"][k].shape[1:]
        assert not v.any()
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 2))
    for t in range(2):
        lg_r, caches_r = ref_model.decode_step(
            cfg_ref, params_ref, jnp.asarray(toks[:, t:t + 1], jnp.int32),
            caches_r, t)
        lg, caches = model.decode_step(
            cfg, params, torch.from_numpy(toks[:, t:t + 1]), caches, t)
        _close(lg, lg_r)
    for layer, c in enumerate(caches[0]):
        for k, v in c["ssm"].items():
            _close(v, caches_r[0]["ssm"][k][layer])


def test_engine_tokens_match_reference():
    cfg_ref = ref_get_smoke_config("mamba2-370m")
    cfg = get_smoke_config("mamba2-370m")
    params_ref, params = _pair(cfg_ref, cfg, seed=2)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 12))
    want = RefServeEngine(cfg_ref, params_ref, RefServeConfig(
        max_len=64, max_new_tokens=6, cache_dtype=jnp.float32)).generate(
        {"tokens": jnp.asarray(toks, jnp.int32)})
    eng = ServeEngine(cfg, params, ServeConfig(
        max_len=64, max_new_tokens=6, cache_dtype=torch.float32),
        device="cpu")
    got = eng.generate({"tokens": toks})
    np.testing.assert_array_equal(got, np.asarray(want))
    kinds = [e.kind for e in eng.telemetry.steps]
    assert kinds == [1] + [2] * 5          # KIND_PREFILL, then KIND_DECODE
    assert eng.telemetry.rank_trace(0).gpus[0].name == "cpu"


def test_real_widths_two_layers_match_reference():
    """mamba2-370m's widths (N = 128, P = 64, chunk 128, vocab 50280) with
    depth cut to 2 layers: prefill of 40 tokens."""
    cfg_ref, cfg = _cut(ref_get_config("mamba2-370m"),
                        get_config("mamba2-370m"), 2)
    params_ref, params = _pair(cfg_ref, cfg, seed=4)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (1, 40))
    lg_r, caches_r, _ = ref_model.prefill(
        cfg_ref, params_ref, {"tokens": jnp.asarray(toks, jnp.int32)},
        max_len=64, cache_dtype=jnp.float32)
    lg, caches, _ = model.prefill(cfg, params,
                                  {"tokens": torch.from_numpy(toks)}, 64)
    assert tuple(lg.shape) == (1, 50280)
    _close(lg, lg_r)
    for layer, c in enumerate(caches[0]):
        _close(c["ssm"]["state"], caches_r[0]["ssm"]["state"][layer])


# --- hymba: hybrid layers, attention caches, meta tokens ---------------------

def _hymba_smoke(seed=0):
    cfg_ref = ref_get_smoke_config("hymba-1.5b")
    cfg = get_smoke_config("hymba-1.5b")
    return (cfg_ref, cfg) + _pair(cfg_ref, cfg, seed)


def _close_caches(caches, caches_r):
    for seg, seg_r in zip(caches, caches_r):
        for layer, c in enumerate(seg):
            for part in c:
                for k, v in c[part].items():
                    _close(v, seg_r[part][k][layer])


def test_hymba_prefill_and_decode_match_reference():
    """The smoke hymba (global, 2 window-8 layers, global; 8 meta tokens)
    prefilled with 13 prompt tokens, so the window layers' rings wrap,
    then two decode steps: logits, the index (meta tokens counted) and
    every cache."""
    cfg_ref, cfg, params_ref, params = _hymba_smoke()
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 15))
    lg_r, caches_r, idx_r = ref_model.prefill(
        cfg_ref, params_ref, {"tokens": jnp.asarray(toks[:, :13], jnp.int32)},
        max_len=32, cache_dtype=jnp.float32)
    lg, caches, idx = model.prefill(
        cfg, params, {"tokens": torch.from_numpy(toks[:, :13])}, max_len=32,
        cache_dtype=torch.float32)
    assert idx == int(idx_r) == 8 + 13
    _close(lg, lg_r)
    _close_caches(caches, caches_r)
    assert tuple(caches[1][0]["attn"]["k"].shape) == (2, 8, 1, 8)
    assert tuple(caches[0][0]["attn"]["k"].shape) == (2, 32, 1, 8)
    for t in (13, 14):
        lg_r, caches_r = ref_model.decode_step(
            cfg_ref, params_ref, jnp.asarray(toks[:, t:t + 1], jnp.int32),
            caches_r, idx_r + t - 13)
        lg, caches = model.decode_step(
            cfg, params, torch.from_numpy(toks[:, t:t + 1]), caches,
            idx + t - 13)
        _close(lg, lg_r)
    _close_caches(caches, caches_r)


@pytest.mark.parametrize("prompt", [4, 12])
def test_hymba_decode_continues_a_prefill(prompt):
    """prefill(N) + decode == prefill(N + 1) in the port: the meta-token
    and ring bookkeeping (tests/test_serve.py's contract), before and
    after the window-8 rings wrap (8 meta + 4 or 12 prompt positions)."""
    _, cfg, _, params = _hymba_smoke(1)
    toks = torch.from_numpy(np.random.default_rng(prompt).integers(
        0, cfg.vocab, (2, prompt + 1)))
    lg_full, _, _ = model.prefill(cfg, params, {"tokens": toks}, 64,
                                  torch.float32)
    _, caches, idx = model.prefill(cfg, params, {"tokens": toks[:, :-1]},
                                   64, torch.float32)
    lg, _ = model.decode_step(cfg, params, toks[:, -1:], caches, idx)
    _close(lg, lg_full)


def test_hymba_decode_from_an_empty_cache_matches_reference():
    cfg_ref, cfg, params_ref, params = _hymba_smoke(3)
    caches_r = ref_model.init_cache(cfg_ref, 1, 16, dtype=jnp.float32)
    caches = model.init_cache(cfg, 1, 16, torch.float32, "cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (1, 10))
    for t in range(10):          # past the window: the rings wrap
        lg_r, caches_r = ref_model.decode_step(
            cfg_ref, params_ref, jnp.asarray(toks[:, t:t + 1], jnp.int32),
            caches_r, t)
        lg, caches = model.decode_step(
            cfg, params, torch.from_numpy(toks[:, t:t + 1]), caches, t)
        _close(lg, lg_r)
    _close_caches(caches, caches_r)


def test_hymba_engine_tokens_match_reference():
    cfg_ref, cfg, params_ref, params = _hymba_smoke(2)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 12))
    want = RefServeEngine(cfg_ref, params_ref, RefServeConfig(
        max_len=64, max_new_tokens=6, cache_dtype=jnp.float32)).generate(
        {"tokens": jnp.asarray(toks, jnp.int32)})
    eng = ServeEngine(cfg, params, ServeConfig(
        max_len=64, max_new_tokens=6, cache_dtype=torch.float32),
        device="cpu")
    np.testing.assert_array_equal(eng.generate({"tokens": toks}),
                                  np.asarray(want))
    with pytest.raises(ValueError, match="does not cover"):
        ServeEngine(cfg, params, ServeConfig(max_len=24, max_new_tokens=6),
                    device="cpu").generate({"tokens": toks})


def test_hymba_real_widths_two_layers_match_reference():
    """hymba-1.5b's widths (d_model 1600, 25 heads over 5 KV heads of 64,
    50 SSD heads, d_ff 5504, vocab 32001, 128 meta tokens) with depth cut
    to its first global layer and one window-1024 layer: batch 1, a
    1000-token prompt, so 1,128 positions pass the window."""
    cfg_ref, cfg = _hymba_cut(ref_get_config("hymba-1.5b"),
                              get_config("hymba-1.5b"))
    params_ref, params = _pair(cfg_ref, cfg, seed=6)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (1, 1000))
    lg_r, caches_r, idx_r = ref_model.prefill(
        cfg_ref, params_ref, {"tokens": jnp.asarray(toks, jnp.int32)},
        max_len=1136, cache_dtype=jnp.float32)
    lg, caches, idx = model.prefill(cfg, params,
                                    {"tokens": torch.from_numpy(toks)}, 1136,
                                    torch.float32)
    assert idx == int(idx_r) == 1128
    assert tuple(lg.shape) == (1, 32001)
    _close(lg, lg_r)
    assert tuple(caches[1][0]["attn"]["k"].shape) == (1, 1024, 5, 64)
    for seg in (0, 1):
        for k in ("k", "v"):
            _close(caches[seg][0]["attn"][k], caches_r[seg]["attn"][k][0])
        _close(caches[seg][0]["ssm"]["state"],
               caches_r[seg]["ssm"]["state"][0])


def test_hymba_params_have_the_reference_structure():
    """init_params builds the converter's tree for the bfloat16 hybrid
    plan (attention, SSM, FFN, norms, gains, meta tokens), with the
    reference's parameter count; the converter casts meta_tokens to the
    model dtype as cast_params does."""
    cfg_ref, cfg = _hymba_cut(ref_get_config("hymba-1.5b"),
                              get_config("hymba-1.5b"))
    cfg_ref = dataclasses.replace(cfg_ref, vocab=64)
    cfg = dataclasses.replace(cfg, vocab=64, dtype=torch.bfloat16)
    shapes = jax.eval_shape(lambda: ref_model.init_params(
        cfg_ref, jax.random.PRNGKey(0)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = from_reference(cfg, zeros, "cpu")
    got = model.init_params(cfg, seed=0, device="cpu")

    def sig(t):
        if isinstance(t, dict):
            return {k: sig(v) for k, v in t.items()}
        if isinstance(t, list):
            return [sig(v) for v in t]
        return (tuple(t.shape), t.dtype)
    assert sig(got) == sig(want)
    assert model.param_count(got) == ref_model.param_count(shapes)
    layer = got["segments"][0][0]
    assert set(layer) == {"norm1", "attn", "ssm", "norm_attn", "norm_ssm",
                          "gain_attn", "gain_ssm", "norm2", "ffn"}
    assert layer["attn"]["wq"].shape == (1600, 25, 64)
    assert layer["gain_attn"].dtype == torch.float32
    assert got["meta_tokens"].dtype == want["meta_tokens"].dtype == \
        torch.bfloat16


@pytest.mark.parametrize("activation", ["silu", "gelu", "relu", "relu2"])
@pytest.mark.parametrize("gated", [True, False])
def test_ffn_matches_reference(activation, gated):
    rng = np.random.default_rng(8)
    p_ref = ref_layers.ffn_init(jax.random.PRNGKey(8), 16, 40, gated)
    p = _torch_tree(_np_tree(p_ref))
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    want = ref_layers.ffn_apply(p_ref, jnp.asarray(x), activation)
    _close(layers.ffn_apply(p, torch.from_numpy(x), activation), want)


# --- parameters, configs, layer kinds ----------------------------------------

def test_init_params_has_the_reference_structure():
    """The port's own initialiser builds the tree the converter builds:
    the same keys, shapes and dtypes (matrices in cfg.dtype, vectors in
    float32), here for the bfloat16 full-width layer plan."""
    cfg_ref, cfg = _cut(ref_get_config("mamba2-370m"),
                        get_config("mamba2-370m"), 1)
    cfg_ref = dataclasses.replace(cfg_ref, vocab=64)
    cfg = dataclasses.replace(cfg, vocab=64, dtype=torch.bfloat16)
    shapes = jax.eval_shape(lambda: ref_model.init_params(
        cfg_ref, jax.random.PRNGKey(0)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = from_reference(cfg, zeros, "cpu")
    got = model.init_params(cfg, seed=0, device="cpu")

    def sig(t):
        if isinstance(t, dict):
            return {k: sig(v) for k, v in t.items()}
        if isinstance(t, list):
            return [sig(v) for v in t]
        return (tuple(t.shape), t.dtype)
    assert sig(got) == sig(want)
    assert model.param_count(got) == ref_model.param_count(shapes)
    assert got["segments"][0][0]["ssm"]["in_x"].dtype == torch.bfloat16
    assert got["segments"][0][0]["ssm"]["D"].dtype == torch.float32
    a = model.init_params(cfg, seed=0, device="cpu")
    b = model.init_params(cfg, seed=1, device="cpu")
    assert torch.equal(a["embed"]["tokens"], got["embed"]["tokens"])
    assert not torch.equal(a["embed"]["tokens"], b["embed"]["tokens"])
    emb = got["embed"]["tokens"].float()
    assert float(emb.abs().max()) <= 2.0


# sha256 over (path, dtype, bytes) of every leaf of init_params(smoke
# config, seed 0) on the CPU, taken with the initialiser that drew the
# whole float32 tree before casting it; drawing and casting leaf by leaf
# must not move a bit
SMOKE_PARAM_DIGESTS = {
    ("mamba2-370m", "float32"):
        "f3f21f8435006a4e7f57b2a97d774bf18eee2a1b463248aa6a93d0a6bdcc0c49",
    ("hymba-1.5b", "float32"):
        "a446f4bfd558ea7583ebc3c9cd4f577d1f9abcfce5fe964f1cf0d263806d1220",
    ("mamba2-370m", "bfloat16"):
        "67e72331f107f202104adf29ab9e6f7901ece9b2ccf6d56ab7bbf111eeb0a283",
    ("hymba-1.5b", "bfloat16"):
        "baefe80ff6aae490fa251f59c56500850c52b8c9ae3189d69c78cc92cf1164a1",
}


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("arch,dtype", list(SMOKE_PARAM_DIGESTS), ids=str)
def test_init_params_draws_the_seed_parameters_bit_for_bit(arch, dtype):
    """mamba2's and hymba's smoke parameters, in float32 and cast to
    bfloat16, are the ones the draw-then-cast initialiser gave."""
    import hashlib
    params = model.init_params(get_smoke_config(arch), seed=0, device="cpu",
                               dtype=getattr(torch, dtype))
    h = hashlib.sha256()
    for path, leaf in _leaves(params):
        h.update(path.encode())
        h.update(str(leaf.dtype).encode())
        h.update(leaf.contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest() == SMOKE_PARAM_DIGESTS[(arch, dtype)]


def test_init_params_casts_each_leaf_as_it_is_drawn(monkeypatch):
    """No float32 matrix outlives its draw: every matrix the initialisers
    return is already in the model dtype (the peak is the finished tree
    plus one float32 leaf), and casting a float32 draw gives the same
    tree."""
    cfg = dataclasses.replace(get_smoke_config("hymba-1.5b"),
                              dtype=torch.bfloat16)
    seen = []
    real = layers.truncated_normal

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen.append(out.dtype)
        return out
    monkeypatch.setattr(layers, "truncated_normal", spy)
    got = model.init_params(cfg, seed=3, device="cpu")
    assert seen and set(seen) == {torch.bfloat16}
    monkeypatch.undo()
    want = model.cast_params(model.init_params(cfg, seed=3, device="cpu",
                                               dtype=torch.float32),
                             torch.bfloat16)
    for (p, a), (_, b) in zip(_leaves(got), _leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b), p


def test_converter_refuses_a_tree_of_another_plan():
    cfg_ref = ref_get_smoke_config("mamba2-370m")
    cfg = get_smoke_config("mamba2-370m")
    tree = _np_tree(ref_model.init_params(cfg_ref, jax.random.PRNGKey(0)))
    (spec, _), = cfg.plan
    with pytest.raises(ValueError, match="expected 2 layers"):
        from_reference(dataclasses.replace(cfg, plan=((spec, 2),)), tree,
                       "cpu")
    with pytest.raises(ValueError, match="segments"):
        from_reference(dataclasses.replace(cfg, plan=((spec, 2),) * 2),
                       tree, "cpu")


def _fields(obj, cls):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)}


def test_configs_match_reference():
    """Every field of the model config (but the dtype's type), of each
    segment's LayerSpec and of its SSM, attention and MoE configs, and the
    segment counts, for the full and the smoke config of each
    architecture: the reference's ten, in its order."""
    from repro.configs import ARCH_NAMES as REF_ARCH_NAMES
    from repro_torch.models import moe
    assert ARCH_NAMES == REF_ARCH_NAMES
    assert len(ARCH_NAMES) == 10
    for arch, get, ref_get in (
            (arch, get, ref_get) for arch in ARCH_NAMES
            for get, ref_get in ((get_config, ref_get_config),
                                 (get_smoke_config, ref_get_smoke_config))):
        cfg, ref = get(arch), ref_get(arch)
        shared = [f.name for f in dataclasses.fields(model.ModelConfig)
                  if f.name not in ("plan", "dtype")]
        assert {f: getattr(cfg, f) for f in shared} == \
            {f: getattr(ref, f) for f in shared}
        assert str(cfg.dtype).split(".")[-1] == jnp.dtype(ref.dtype).name
        assert cfg.n_layers == ref.n_layers
        assert [c for _, c in cfg.plan] == [c for _, c in ref.plan]
        for (spec, _), (spec_r, _) in zip(cfg.plan, ref.plan):
            for f in ("kind", "d_ff", "activation", "gated", "norm"):
                assert getattr(spec, f) == getattr(spec_r, f)
            for part, cls in (("ssm", ssm.SSMConfig),
                              ("attn", attention.AttnConfig),
                              ("moe", moe.MoEConfig)):
                mine, theirs = getattr(spec, part), getattr(spec_r, part)
                assert (mine is None) == (theirs is None)
                if mine is not None:
                    assert _fields(mine, cls) == _fields(theirs, cls)
        assert get_config(arch).dtype == torch.bfloat16


_ATTN = attention.AttnConfig(d_model=16, n_heads=2, n_kv_heads=1,
                             head_dim=8)
_SSM = ssm.SSMConfig(d_model=16, d_state=8, head_dim=8, chunk=8)


@pytest.mark.parametrize("spec,err", [
    (LayerSpec(kind="ssm"), ValueError),
    (LayerSpec(kind="hybrid", ssm=_SSM), ValueError),         # no attn
])
def test_unported_layer_kinds_raise(spec, err):
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(err):
        layer_init(spec, 16, generator=gen, device=CPU)


@pytest.mark.parametrize("spec", [
    LayerSpec(kind="attn", attn=_ATTN, d_ff=24),
    LayerSpec(kind="ssm", ssm=_SSM, d_ff=24, gated=False,
              activation="gelu"),
], ids=["attn+ffn", "ssm+ffn"])
def test_layers_that_now_build(spec):
    """Attention blocks and the dense FFN build, with the reference's
    parameter tree."""
    gen = torch.Generator().manual_seed(0)
    p = layer_init(spec, 16, generator=gen, device=CPU)
    assert ("attn" in p) == (spec.kind == "attn")
    assert set(p["ffn"]) == ({"w_up", "w_down", "w_gate"} if spec.gated
                             else {"w_up", "w_down"})
    x = torch.randn(2, 5, 16, generator=gen)
    from repro_torch.models.transformer import layer_forward
    y, cache, metrics = layer_forward(p, x, spec, mode="prefill")
    assert y.shape == x.shape and set(cache) == {spec.kind}
    assert metrics == {}


def test_serve_cli_on_the_host(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "mamba2-370m", "--smoke", "--device", "cpu",
          "--batch", "2", "--prompt-len", "9", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 3) on cpu" in out
    assert "decode 2 steps" in out
