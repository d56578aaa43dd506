"""The port's model stack against the JAX package on the same weights.

Weights come from the JAX package's ``init_params`` (or ``ssm_init``)
and cross through ``repro_torch.models.convert``; inputs come from numpy
seeds. Everything runs in float32 on the CPU, where the port's SSD scan
takes its plain version. Tolerance: rtol = atol = 1e-4 on activations,
logits and caches (float32 sums in another order; the SSD scan's own
tolerance), unless a test states another. Generated tokens are equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import model as ref_model
from repro.models import ssm as ref_ssm
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import ServeEngine as RefServeEngine
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.models import model, ssm
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


def test_configs_match_reference():
    assert ARCH_NAMES == ["mamba2-370m"]
    for get, ref_get in ((get_config, ref_get_config),
                         (get_smoke_config, ref_get_smoke_config)):
        cfg, ref = get("mamba2-370m"), ref_get("mamba2-370m")
        assert (cfg.name, cfg.d_model, cfg.vocab, cfg.n_layers) == \
            (ref.name, ref.d_model, ref.vocab, ref.n_layers)
        (spec, _), = cfg.plan
        (spec_r, _), = ref.plan
        fields = [f.name for f in dataclasses.fields(ssm.SSMConfig)]
        assert {f: getattr(spec.ssm, f) for f in fields} == \
            {f: getattr(spec_r.ssm, f) for f in fields}
    assert get_config("mamba2-370m").dtype == torch.bfloat16
    with pytest.raises(KeyError, match="not ported yet"):
        get_config("hymba-1.5b")


@pytest.mark.parametrize("spec,err", [
    (LayerSpec(kind="attn"), NotImplementedError),
    (LayerSpec(kind="hybrid"), NotImplementedError),
    (LayerSpec(kind="ssm", ssm=ssm.SSMConfig(d_model=16), moe=object()),
     NotImplementedError),
    (LayerSpec(kind="ssm", ssm=ssm.SSMConfig(d_model=16), d_ff=32),
     NotImplementedError),
    (LayerSpec(kind="ssm"), ValueError),
])
def test_unported_layer_kinds_raise(spec, err):
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(err):
        layer_init(spec, 16, generator=gen, device=CPU)


def test_serve_cli_on_the_host(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "mamba2-370m", "--smoke", "--device", "cpu",
          "--batch", "2", "--prompt-len", "9", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 3) on cpu" in out
    assert "decode 2 steps" in out
