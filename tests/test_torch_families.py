"""The seven architectures that came with the MoE layer, M-RoPE and the
frontends, against the JAX package on the same weights: stablelm-3b,
h2o-danube-1.8b, nemotron-4-15b, starcoder2-15b, granite-moe-1b-a400m,
qwen2-vl-7b (the six decoders) and hubert-xlarge (encoder only).

Weights come from the reference's ``init_params`` and cross through
``repro_torch.models.convert.from_reference``; inputs come from numpy
seeds, the VLM's patches and M-RoPE ids from the port's serving CLI
(``launch/serve.py::vlm_inputs``), the audio frames from the data
pipeline. Everything runs in float32 on the CPU, where ``flash_attention``
takes its plain version. Tolerance: rtol = atol = 1e-4 on logits, caches
and losses (float32 sums in another order; tests/test_torch_models.py's
TOL), 1e-5 on M-RoPE in float32 and one rounding step (2^-7) in
bfloat16. Generated tokens are equal, and the MoE's dropped share (a
mean of per-layer shares) equal within 1e-6, below one assignment in
the smallest call (1/160).
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
from repro.models import frontends as ref_frontends
from repro.models import layers as ref_layers
from repro.models import model as ref_model
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import ServeEngine as RefServeEngine
from repro.train.checkpoint import _flatten as ref_flatten
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import DataConfig, make_batch
from repro_torch.launch.serve import vlm_inputs
from repro_torch.models import frontends, layers, model
from repro_torch.models.convert import (from_reference, state_from_flat,
                                        state_to_flat)
from repro_torch.serve import ServeConfig, ServeEngine

TOL = 1e-4
DECODERS = ["stablelm-3b", "h2o-danube-1.8b", "nemotron-4-15b",
            "starcoder2-15b", "granite-moe-1b-a400m", "qwen2-vl-7b"]
GRID = 2                       # the smoke VLM's image: 2 x 2 patches


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors gain nothing from torch's intra-op threads, and in a
    loaded parallel run those threads wait on each other
    (tests/test_torch_train.py measured 77 s against 6)."""
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


def _smoke(arch, seed=0):
    cfg_ref, cfg = ref_get_smoke_config(arch), get_smoke_config(arch)
    return (cfg_ref, cfg) + _pair(cfg_ref, cfg, seed)


def _prompt(cfg, seed, b, s):
    """numpy inputs of a prompt of ``s`` text tokens (after the patches of
    a GRID x GRID image for the VLM)."""
    rng = np.random.default_rng(seed)
    batch = vlm_inputs(cfg, rng, b, GRID, s) if cfg.frontend == "vlm" else {}
    batch["tokens"] = rng.integers(0, cfg.vocab, (b, s))
    return batch


def _jnp(batch):
    return {k: jnp.asarray(v, jnp.int32 if np.issubdtype(
        np.asarray(v).dtype, np.integer) else jnp.float32)
        for k, v in batch.items()}


def _torch(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def _close_caches(caches, caches_r):
    for seg, seg_r in zip(caches, caches_r):
        for layer, c in enumerate(seg):
            for part in c:
                for k, v in c[part].items():
                    _close(v, seg_r[part][k][layer])


# --- M-RoPE and the frontends ------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_matches_reference(dtype):
    """Three different position rows (t, h, w), so each frequency section
    must read its own row: the pipeline's batches give equal rows, which
    would hide a section error. qwen2-vl's sections over head_dim 128."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 9, 3, 128)).astype(np.float32)
    pos = np.stack([rng.integers(0, 50, (2, 9)),
                    rng.integers(100, 400, (2, 9)),
                    rng.integers(1000, 3000, (2, 9))], axis=1)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = ref_layers.apply_mrope(jnp.asarray(x, jdt), jnp.asarray(pos),
                                  (16, 24, 24), 1e6)
    got = layers.apply_mrope(torch.from_numpy(x).to(tdt),
                             torch.from_numpy(pos), (16, 24, 24), 1e6)
    assert got.dtype == tdt
    _close(got.float(), np.asarray(want, np.float32),
           1e-5 if dtype == "float32" else 2 ** -7)
    # a section error would show: rotating by the t row alone differs
    flat = layers.apply_mrope(torch.from_numpy(x),
                              torch.from_numpy(pos[:, [0, 0, 0]]),
                              (16, 24, 24), 1e6)
    assert not torch.allclose(flat, got.float(), atol=1e-2)
    with pytest.raises(ValueError, match="sections"):
        layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                           (16, 24, 16))


@pytest.mark.parametrize("arch", ["hubert-xlarge", "qwen2-vl-7b"])
def test_assemble_matches_reference(arch):
    """The audio frontend (projected frames plus sinusoid positions) and
    the VLM one (projected patches, then the text, with the batch's
    positions3), and the prefix each cuts off before the head."""
    cfg_ref, cfg, params_ref, params = _smoke(arch, seed=1)
    if cfg.frontend == "audio":
        batch = ref_make_batch(cfg_ref, RefDataConfig(2, 12), 0)
    else:
        batch = _prompt(cfg, 1, 2, 7)
    x_r, pos_r, prefix_r = ref_frontends.assemble(cfg_ref, params_ref,
                                                  _jnp(batch))
    x, pos, prefix = frontends.assemble(cfg, params, _torch(batch))
    _close(x, x_r)
    np.testing.assert_array_equal(
        np.broadcast_to(pos.numpy(), np.shape(pos_r)), np.asarray(pos_r))
    assert prefix == prefix_r == (GRID * GRID if cfg.frontend == "vlm"
                                  else 0)
    _close(frontends.sinusoid_positions(10, 8),
           ref_frontends.sinusoid_positions(10, 8), 1e-7)


# --- the six decoders on their smoke configs ---------------------------------

@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_caches_and_decode_match_reference(arch):
    """Prefill of a 13-token prompt (danube's window-8 rings wrap; the
    VLM's 4 patches come first): last-token logits, the index and every
    cache; then two decode steps, logits and caches."""
    cfg_ref, cfg, params_ref, params = _smoke(arch)
    batch = _prompt(cfg, 7, 2, 15)
    prompt = {k: (v[..., :-2] if k in ("tokens", "positions3") else v)
              for k, v in batch.items()}
    lg_r, caches_r, idx_r = ref_model.prefill(
        cfg_ref, params_ref, _jnp(prompt), max_len=32,
        cache_dtype=jnp.float32)
    lg, caches, idx = model.prefill(cfg, params, _torch(prompt), 32,
                                    torch.float32)
    prefix = GRID * GRID if cfg.frontend == "vlm" else 0
    assert idx == int(idx_r) == prefix + 13
    assert tuple(lg.shape) == (2, cfg.vocab)
    _close(lg, lg_r)
    _close_caches(caches, caches_r)
    toks = batch["tokens"]
    for t in (13, 14):
        lg_r, caches_r = ref_model.decode_step(
            cfg_ref, params_ref, jnp.asarray(toks[:, t:t + 1], jnp.int32),
            caches_r, idx_r + t - 13)
        lg, caches = model.decode_step(
            cfg, params, torch.from_numpy(toks[:, t:t + 1]), caches,
            idx + t - 13)
        _close(lg, lg_r)
    _close_caches(caches, caches_r)


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_continues_a_prefill(arch):
    """prefill(N) + decode == prefill(N + 1) in the port: the ring after
    it wraps (danube) and, for the VLM, the M-RoPE ids the serving CLI
    gives the text, (i, i, i) at absolute position i, which decode
    continues."""
    _, cfg, _, params = _smoke(arch, seed=2)
    batch = _torch(_prompt(cfg, 9, 2, 12))
    lg_full, _, _ = model.prefill(cfg, params, batch, 32, torch.float32)
    head = {k: (v[..., :-1] if k in ("tokens", "positions3") else v)
            for k, v in batch.items()}
    _, caches, idx = model.prefill(cfg, params, head, 32, torch.float32)
    lg, _ = model.decode_step(cfg, params, batch["tokens"][:, -1:], caches,
                              idx)
    _close(lg, lg_full)


@pytest.mark.parametrize("arch", DECODERS)
def test_engine_tokens_match_reference(arch):
    """The engines' greedy tokens, the VLM's patches and positions3 passed
    through to prefill; ``max_len`` must cover the patch positions."""
    cfg_ref, cfg, params_ref, params = _smoke(arch, seed=3)
    batch = _prompt(cfg, 4, 2, 12)
    prefix = GRID * GRID if cfg.frontend == "vlm" else 0
    want = RefServeEngine(cfg_ref, params_ref, RefServeConfig(
        max_len=64, max_new_tokens=6, cache_dtype=jnp.float32)).generate(
        _jnp(batch))
    eng = ServeEngine(cfg, params, ServeConfig(
        max_len=64, max_new_tokens=6, cache_dtype=torch.float32),
        device="cpu")
    np.testing.assert_array_equal(eng.generate(batch), np.asarray(want))
    with pytest.raises(ValueError, match="does not cover"):
        ServeEngine(cfg, params, ServeConfig(
            max_len=prefix + 12 + 4, max_new_tokens=6),
            device="cpu").generate(batch)


# --- losses: hubert's encoder forward, granite's aux loss --------------------

@pytest.mark.parametrize("arch", ["hubert-xlarge", "granite-moe-1b-a400m",
                                  "qwen2-vl-7b"])
def test_loss_fn_matches_reference(arch):
    """``loss_fn`` on the data pipeline's batch: hubert's frames batch (no
    tokens, a loss mask, non-causal attention), granite's with the MoE
    layers' aux loss and dropped share, qwen2-vl's patches and text."""
    cfg_ref, cfg, params_ref, params = _smoke(arch, seed=5)
    dcfg = dict(batch=2, seq=24, vlm_patches=4)
    batch = make_batch(cfg, DataConfig(**dcfg), 0)
    ref_batch = ref_make_batch(cfg_ref, RefDataConfig(**dcfg), 0)
    for k in ref_batch:
        np.testing.assert_array_equal(batch[k], ref_batch[k])
    loss_r, m_r = ref_model.loss_fn(cfg_ref, params_ref, _jnp(ref_batch))
    with torch.no_grad():
        loss, m = model.loss_fn(cfg, params, _torch(batch))
    _close(loss, loss_r)
    assert set(m) == set(m_r)
    for k in m_r:
        _close(m[k], m_r[k], 1e-6 if k == "dropped" else TOL)
    if arch.startswith("granite"):
        assert float(m["aux_loss"]) > 0.0
        _close(m["loss"], float(m["ce"]) + float(m["aux_loss"]))


def test_moe_loss_drops_at_a_small_capacity():
    """granite's smoke model with capacity factor 0.5: the layers drop
    assignments, the same share as the reference's, and the loss
    agrees."""
    cfg_ref, cfg = ref_get_smoke_config("granite-moe-1b-a400m"), \
        get_smoke_config("granite-moe-1b-a400m")
    (spec_r, n), = cfg_ref.plan
    (spec, _), = cfg.plan
    cfg_ref = dataclasses.replace(cfg_ref, plan=((dataclasses.replace(
        spec_r, moe=dataclasses.replace(spec_r.moe, capacity_factor=0.5)),
        n),))
    cfg = dataclasses.replace(cfg, plan=((dataclasses.replace(
        spec, moe=dataclasses.replace(spec.moe, capacity_factor=0.5)), n),))
    params_ref, params = _pair(cfg_ref, cfg, seed=6)
    batch = make_batch(cfg, DataConfig(batch=2, seq=24), 1)
    loss_r, m_r = ref_model.loss_fn(cfg_ref, params_ref, _jnp(batch))
    with torch.no_grad():
        loss, m = model.loss_fn(cfg, params, _torch(batch))
    assert float(m["dropped"]) > 0.0
    _close(m["dropped"], m_r["dropped"], 1e-6)
    _close(loss, loss_r)
    _close(m["aux_loss"], m_r["aux_loss"])


# --- real widths, depth cut --------------------------------------------------

def _cut(arch, layers, vocab=None):
    """Both configs at full width with depth cut to ``layers``, float32
    compute, and the vocabulary cut to ``vocab`` when given."""
    out = []
    for cfg in (ref_get_config(arch), get_config(arch)):
        (spec, _), = cfg.plan
        kw = {"vocab": vocab} if vocab else {}
        out.append(dataclasses.replace(
            cfg, plan=((spec, layers),),
            dtype=jnp.float32 if isinstance(cfg, ref_model.ModelConfig)
            else torch.float32, **kw))
    return out


@pytest.mark.parametrize("arch,vocab", [("granite-moe-1b-a400m", None),
                                        ("stablelm-3b", 8192)],
                         ids=["granite-moe-1b-a400m", "stablelm-3b"])
def test_real_widths_two_layers_match_reference(arch, vocab):
    """granite-moe-1b-a400m's widths (d_model 1024, 16 heads over 8 KV
    heads of 64, 32 experts of 512, top 8, vocab 49155) and stablelm-3b's
    (d_model 2560, 32 heads of 80, 25% partial RoPE, qkv biases, d_ff
    6912; its vocabulary cut to 8,192 to keep the test under 2 GB), two
    layers each: prefill of 2 x 40 tokens, logits and caches, one decode
    step; granite's loss with its aux loss and dropped share."""
    cfg_ref, cfg = _cut(arch, 2, vocab)
    params_ref, params = _pair(cfg_ref, cfg, seed=8)
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (2, 41))
    lg_r, caches_r, idx_r = ref_model.prefill(
        cfg_ref, params_ref, {"tokens": jnp.asarray(toks[:, :40], jnp.int32)},
        max_len=48, cache_dtype=jnp.float32)
    lg, caches, idx = model.prefill(
        cfg, params, {"tokens": torch.from_numpy(toks[:, :40])}, 48,
        torch.float32)
    assert tuple(lg.shape) == (2, cfg.vocab)
    _close(lg, lg_r)
    _close_caches(caches, caches_r)
    lg_r, _ = ref_model.decode_step(cfg_ref, params_ref,
                                    jnp.asarray(toks[:, 40:], jnp.int32),
                                    caches_r, idx_r)
    lg, _ = model.decode_step(cfg, params, torch.from_numpy(toks[:, 40:]),
                              caches, idx)
    _close(lg, lg_r)
    if cfg.plan[0][0].moe is not None:
        batch = {"tokens": toks[:, :40], "labels": toks[:, 1:]}
        loss_r, m_r = ref_model.loss_fn(cfg_ref, params_ref, _jnp(batch))
        with torch.no_grad():
            loss, m = model.loss_fn(cfg, params, _torch(batch))
        _close(loss, loss_r)
        _close(m["dropped"], m_r["dropped"], 1e-6)


# --- parameters --------------------------------------------------------------

def _sig(t):
    if isinstance(t, dict):
        return {k: _sig(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_sig(v) for v in t]
    return (tuple(t.shape), t.dtype)


@pytest.mark.parametrize("arch", DECODERS + ["hubert-xlarge"])
def test_init_params_has_the_reference_structure(arch):
    """The port's initialiser builds the converter's tree, in bfloat16:
    keys, shapes, dtypes (the MoE router float32), ``frontend_proj`` and
    ``lm_head`` where the reference has them, and the reference's
    parameter count; on the smoke config, and for granite-moe also at
    full width with one layer and a vocabulary of 64."""
    cfgs = [(ref_get_smoke_config(arch), get_smoke_config(arch))]
    if arch.startswith("granite"):
        cfgs.append(_cut(arch, 1, 64))
    for cfg_ref, cfg in cfgs:
        cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
        shapes = jax.eval_shape(lambda: ref_model.init_params(
            cfg_ref, jax.random.PRNGKey(0)))
        zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                             shapes)
        got = model.init_params(cfg, seed=0, device="cpu")
        assert _sig(got) == _sig(from_reference(cfg, zeros, "cpu"))
        assert model.param_count(got) == ref_model.param_count(shapes)
        assert ("frontend_proj" in got) == (cfg.frontend != "none")
        assert ("lm_head" in got) == (not cfg.tie_embeddings)
        layer = got["segments"][0][0]
        assert ("moe" in layer) == arch.startswith("granite")
        if "moe" in layer:
            e, f = cfg.plan[0][0].moe.n_experts, cfg.plan[0][0].moe.d_ff
            assert layer["moe"]["router"].dtype == torch.float32
            assert layer["moe"]["experts"]["w_down"].shape == (
                e, f, cfg.d_model)
            assert layer["moe"]["experts"]["w_up"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen2-vl-7b"])
def test_checkpoint_keys_carry_the_new_leaves(arch):
    """The reference's flat checkpoint dictionary of a parameter tree with
    MoE leaves (router, experts (E, D, F) / (E, F, D)) or with
    ``frontend_proj`` and ``lm_head``: ``state_to_flat`` of the port's
    tree gives its keys and arrays (each segment's leaves stacked over
    the layers), and ``state_from_flat`` reads it back into the port's
    layout."""
    cfg_ref, cfg, params_ref, params = _smoke(arch, seed=9)
    want = ref_flatten({"params": params_ref})
    got = state_to_flat({"params": params})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    back = state_from_flat({"params": params}, want)["params"]
    for (path, a), (_, b) in zip(_leaves(back), _leaves(params)):
        assert torch.equal(a, b), path
    keys = " ".join(want)
    assert ("experts/w_up" in keys) == arch.startswith("granite")
    assert ("frontend_proj" in keys) == arch.startswith("qwen")


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def test_chip_smoke_parameter_counts_are_the_reference_counts():
    """The counts chip_smoke.py holds each served model to are the
    reference's, by ``jax.eval_shape`` of its ``init_params`` on the full
    config, or on the config cut to the depth chip_smoke.py serves
    (deepseek-v2-236b: its dense layer and 4 MoE layers)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.DEPTH_CUTS == {"deepseek-v2-236b": (1, 4)}
    for arch, n in smoke.PARAM_COUNTS.items():
        cfg = smoke.cut_depth(ref_get_config(arch),
                              smoke.DEPTH_CUTS.get(arch))
        shapes = jax.eval_shape(lambda c=cfg: ref_model.init_params(
            c, jax.random.PRNGKey(0)))
        assert ref_model.param_count(shapes) == n, arch
    full = jax.eval_shape(lambda: ref_model.init_params(
        ref_get_config("deepseek-v2-236b"), jax.random.PRNGKey(0)))
    assert ref_model.param_count(full) == 235_217_146_880


def test_encoder_only_cli_exits():
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit, match="encoder-only"):
        main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "granite-moe-1b-a400m"])
def test_serve_cli_on_the_host(arch, capsys):
    from repro_torch.launch.serve import main
    main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
          "--prompt-len", "9", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 3) on cpu" in out
    assert "decode 2 steps" in out
