"""The port's training stack against the JAX package on the CPU.

Weights and optimizer states come from the JAX package and cross through
``repro_torch.models.convert``; batches come from numpy seeds (the data
pipeline, byte-equal in both packages). The reference's training
differentiates its XLA formulations, so no Pallas kernel is reached on
either side; the port's kernels take their plain versions on the CPU.
Everything runs in float32 (the smoke configs' dtype).

Tolerances: loss and every gradient leaf rtol 1e-4, atol 1e-5 (float32
sums in another order through a few layers); the optimizer's own
arithmetic rtol 1e-6; one train step's first moments rtol 1e-4 and
atol 1e-7 (gradients times 0.1 and the clip factor), second moments
rtol 2e-4 (squares), parameters atol 2e-6 (an update of lr = 1e-3 times
Adam's ratio g / (|g| + eps), at eps = 1e-5: at the default 1e-8 the
ratio of a gradient element near zero turns on differences far below the
gradients' tolerance); the autograd Functions
against autograd of the plain versions exactly (the same arithmetic on
the CPU); checkpoints bit for bit.
"""

import dataclasses
import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.data import pipeline as ref_data
from repro.models import model as ref_model
from repro.train import CheckpointManager as RefCheckpointManager
from repro.train import TrainConfig as RefTrainConfig
from repro.train import make_train_step as ref_make_train_step
from repro.train import optim as ref_optim
from repro.train.checkpoint import _flatten as ref_flatten
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, Prefetcher, make_batch
from repro_torch.kernels.flashattn import ops as flash_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch.train import main as train_main
from repro_torch.models import model
from repro_torch.models.convert import (from_reference, state_from_flat,
                                        state_to_flat)
from repro_torch.train import (AdamWConfig, CheckpointManager, RunConfig,
                               TrainConfig, Trainer, adamw_init,
                               adamw_update, cosine_lr, init_state,
                               make_train_step)
from repro_torch.train.optim import global_norm, tree_unflatten
from repro_torch.train.step import batch_to, loss_and_grads, working_copy

ARCHS = ["mamba2-370m", "hymba-1.5b"]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size tensors gain nothing from torch's intra-op threads, and
    in a loaded parallel run those threads wait on each other: a
    mamba2-smoke trainer took 77 s instead of 6 with the CPUs busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(arch, seq=24, batch=2, seed=3, step=0):
    return ref_data.make_batch(ref_get_smoke_config(arch),
                               ref_data.DataConfig(batch=batch, seq=seq,
                                                   seed=seed), step=step)


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tt(batch):
    return batch_to(batch, CPU)


def _nested(flat):
    """The reference's pytree of a flat checkpoint dictionary."""
    out = {}
    for key, arr in flat.items():
        *path, last = key.split("/")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[last] = jnp.asarray(arr)
    return out


def _ref_state(arch, seed):
    """A reference training state of the smoke config: the port's
    initial state in the reference's layout (the reference's own
    initialiser runs op by op and takes seconds here; its tree structure
    is held to the port's by test_torch_models.py)."""
    return _nested(state_to_flat(init_state(get_smoke_config(arch), seed,
                                            "cpu")))


# --- optimizer ------------------------------------------------------------------

def _opt_inputs(rng, grad_dtype):
    shapes = {"w": (4, 3), "embed": {"tokens": (5, 4)}, "scale": (3,),
              "ssm": {"A_log": (2,), "in_x": (3, 2, 2)}}
    f32 = lambda s: rng.normal(size=s).astype(np.float32)   # noqa: E731
    params = jax.tree.map(f32, shapes, is_leaf=lambda x: isinstance(x,
                                                                    tuple))
    grads = jax.tree.map(lambda p: f32(p.shape), params)
    m = jax.tree.map(lambda p: 0.1 * f32(p.shape), params)
    v = jax.tree.map(lambda p: np.abs(0.01 * f32(p.shape)), params)
    cast = (lambda g: jnp.asarray(g, jnp.bfloat16)) if grad_dtype == "bf16" \
        else jnp.asarray
    tcast = (lambda g: torch.from_numpy(g).to(torch.bfloat16)) \
        if grad_dtype == "bf16" else torch.from_numpy
    ref = (jax.tree.map(jnp.asarray, params), jax.tree.map(cast, grads),
           {"m": jax.tree.map(jnp.asarray, m),
            "v": jax.tree.map(jnp.asarray, v)})
    port = (jax.tree.map(lambda a: torch.from_numpy(a.copy()), params),
            jax.tree.map(tcast, grads),
            {"m": jax.tree.map(lambda a: torch.from_numpy(a.copy()), m),
             "v": jax.tree.map(lambda a: torch.from_numpy(a.copy()), v)})
    return ref, port


@pytest.mark.parametrize("grad_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("clip", [0.0, 1.0, 1e-3])
def test_adamw_update_matches_reference(grad_dtype, clip):
    """Parameters, moments, grad norm and lr after one update at step 7
    (mid-warmup), with weight decay on the matrices only."""
    cfg = dict(peak_lr=0.1, warmup_steps=10, total_steps=100,
               weight_decay=0.1, clip_norm=clip)
    (p_r, g_r, s_r), (p, g, s) = _opt_inputs(np.random.default_rng(1),
                                             grad_dtype)
    new_r, st_r, stats_r = ref_optim.adamw_update(
        ref_optim.AdamWConfig(**cfg), g_r, s_r, p_r, jnp.int32(7))
    new, st, stats = adamw_update(AdamWConfig(**cfg), g, s, p,
                                  torch.tensor(7, dtype=torch.int32))
    assert new is p and st is s                    # updated in place
    for got, want in ((new, new_r), (st["m"], st_r["m"]),
                      (st["v"], st_r["v"])):
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(stats[k]), float(stats_r[k]),
                                   rtol=1e-6)


def test_cosine_lr_matches_reference():
    cfg = dict(peak_lr=1.0, warmup_steps=10, total_steps=100,
               min_lr_ratio=0.1)
    steps = [0, 1, 5, 9, 10, 11, 37, 55, 99, 100, 150]
    want = [float(ref_optim.cosine_lr(ref_optim.AdamWConfig(**cfg),
                                      jnp.int32(s))) for s in steps]
    got = [float(cosine_lr(AdamWConfig(**cfg), torch.tensor(s)))
           for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == 0.0 and abs(got[4] - 1.0) < 1e-6
    assert abs(got[-2] - 0.1) < 1e-3 and got[7] < 1.0


def test_grad_clipping_bounds_update():
    cfg = AdamWConfig(clip_norm=1e-3, weight_decay=0.0)
    params = {"w": torch.ones(4, 4)}
    before = params["w"].clone()
    grads = {"w": 1e6 * torch.ones(4, 4)}
    _, _, stats = adamw_update(cfg, grads, adamw_init(params), params,
                               torch.tensor(0))
    assert float(stats["grad_norm"]) > 1e5
    assert float((params["w"] - before).abs().max()) < 1.0
    assert float(global_norm(grads)) == pytest.approx(4e6)


# --- loss -----------------------------------------------------------------------

def test_chunked_ce_ragged_with_a_partial_mask():
    """S = 37 against chunk 16 (padded to 48), a mask with zeros: the sums
    and the gradients of h and w equal the reference's, and the mean
    equals a dense cross-entropy over the unmasked positions."""
    rng = np.random.default_rng(2)
    b, s, d, v = 2, 37, 8, 11
    h = rng.normal(size=(b, s, d)).astype(np.float32)
    w = rng.normal(size=(v, d)).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.6).astype(np.float32)

    def ref(h_, w_):
        return ref_model.chunked_ce(h_, w_, jnp.asarray(labels),
                                    jnp.asarray(mask), 16)
    (tot_r, cnt_r) = ref(jnp.asarray(h), jnp.asarray(w))
    gh_r, gw_r = jax.grad(lambda a, c: ref(a, c)[0], argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    ht = torch.from_numpy(h).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    tot, cnt = model.chunked_ce(ht, wt, torch.from_numpy(labels),
                                torch.from_numpy(mask), 16)
    tot.backward()
    _close(tot.detach(), tot_r)
    assert float(cnt) == float(cnt_r) == mask.sum()
    _close(ht.grad, gh_r)
    _close(wt.grad, gw_r)
    dense = torch.nn.functional.cross_entropy(
        (torch.from_numpy(h) @ torch.from_numpy(w).T).reshape(-1, v),
        torch.from_numpy(labels).long().reshape(-1), reduction="none")
    _close(tot.detach(), (dense * torch.from_numpy(mask).reshape(-1)).sum())


@pytest.fixture(scope="module")
def ref_grads():
    """The reference's loss and gradients (jitted value_and_grad) for each
    smoke config on one batch, with its parameters."""
    out = {}
    for arch in ARCHS:
        cfg = ref_get_smoke_config(arch)
        params = _ref_state(arch, 0)["params"]
        batch = _batch(arch)
        fn = jax.jit(jax.value_and_grad(
            lambda p, bt, cfg=cfg: ref_model.loss_fn(cfg, p, bt),
            has_aux=True))
        (loss, metrics), grads = fn(params, _jnp(batch))
        out[arch] = (_np(params), batch, float(loss), float(metrics["ce"]),
                     ref_flatten(grads))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference(arch, ref_grads):
    params_r, batch, loss_r, ce_r, grads_r = ref_grads[arch]
    cfg = get_smoke_config(arch)
    params = from_reference(cfg, params_r, "cpu")    # float32 smoke
    work = working_copy(cfg, TrainConfig(), params)
    loss, metrics, grads = loss_and_grads(cfg, work, _tt(batch))
    _close(loss, loss_r)
    _close(metrics["ce"], ce_r)
    got = state_to_flat(tree_unflatten(params, grads))
    assert sorted(got) == sorted(grads_r)
    for k, want in grads_r.items():
        assert got[k].shape == want.shape, k
        _close(got[k], want)


def test_one_train_step_matches_reference():
    """mamba2-smoke: one step from the reference's initial state, in both
    packages, warmup 0 so the update is taken at the peak lr."""
    rcfg = ref_get_smoke_config("mamba2-370m")
    cfg = get_smoke_config("mamba2-370m")
    optim = dict(peak_lr=1e-3, warmup_steps=0, total_steps=10, eps=1e-5)
    batch = _batch("mamba2-370m", batch=4)
    state_r = _ref_state("mamba2-370m", 0)
    state = state_from_flat(init_state(cfg, device="cpu"),
                            ref_flatten(state_r))
    new_r, m_r = jax.jit(ref_make_train_step(
        rcfg, RefTrainConfig(optim=ref_optim.AdamWConfig(**optim))))(
        state_r, _jnp(batch))
    new, m = make_train_step(cfg, TrainConfig(optim=AdamWConfig(**optim)))(
        state, _tt(batch))
    for k in ("loss", "ce", "grad_norm", "lr"):
        _close(m[k], m_r[k])
    got, want = state_to_flat(new), ref_flatten(new_r)
    assert sorted(got) == sorted(want) and int(got["step"]) == 1
    for k, w in want.items():
        if k.startswith("params/"):
            _close(got[k], w, rtol=0, atol=2e-6)
        elif k.startswith("opt/m/"):
            _close(got[k], w, atol=1e-7)
        elif k.startswith("opt/v/"):
            _close(got[k], w, rtol=2e-4, atol=1e-12)


@pytest.mark.parametrize("arch", ARCHS)
def test_grad_accum_two_equals_one(arch):
    """accum=2 over a batch == accum=1 over the same batch: the loss and
    the first moments (the averaged gradient, scaled) agree."""
    cfg = get_smoke_config(arch)
    batch = _tt(_batch(arch, batch=4))
    out = []
    for n in (1, 2):
        state = init_state(cfg, seed=0, device="cpu")
        state, m = make_train_step(cfg, TrainConfig(grad_accum=n))(state,
                                                                   batch)
        out.append((m, state_to_flat(state)))
    (m1, s1), (m2, s2) = out
    _close(m1["loss"], m2["loss"])
    _close(m1["grad_norm"], m2["grad_norm"])
    for k in s1:
        if k.startswith("opt/m/"):
            _close(s1[k], s2[k], atol=1e-8)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_full_equals_none(arch):
    cfg = get_smoke_config(arch)
    params = init_params_f32(cfg)
    batch = _tt(_batch(arch))
    res = []
    for remat in ("full", "none"):
        c = dataclasses.replace(cfg, remat=remat)
        res.append(loss_and_grads(c, working_copy(c, TrainConfig(), params),
                                  batch))
    (l_f, _, g_f), (l_n, _, g_n) = res
    _close(l_f, l_n, rtol=1e-6, atol=0)
    for a, b in zip(g_f, g_n):
        _close(a, b, rtol=1e-6, atol=1e-9)


def init_params_f32(cfg):
    return model.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)


def test_remat_dots_and_unknown_raise():
    cfg = get_smoke_config("mamba2-370m")
    params = init_params_f32(cfg)
    batch = _tt(_batch("mamba2-370m"))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        loss_and_grads(dataclasses.replace(cfg, remat="dots"),
                       working_copy(cfg, TrainConfig(), params), batch)
    with pytest.raises(ValueError, match="remat"):
        loss_and_grads(dataclasses.replace(cfg, remat="some"),
                       working_copy(cfg, TrainConfig(), params), batch)


@pytest.mark.parametrize("arch,remat,per_layer", [
    ("mamba2-370m", "full", 2), ("mamba2-370m", "none", 1),
    ("hymba-1.5b", "full", 2), ("hymba-1.5b", "none", 1)])
def test_kernel_calls_per_microbatch(arch, remat, per_layer, monkeypatch):
    """The dispatch that launches the kernel on the card runs once a layer
    in the forward and once more in the remat recompute, and never in
    backward (the plain recompute there is not a launch); no decode cache
    is built in train mode."""
    calls = {"ssd": 0, "flash": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper
    monkeypatch.setattr(ssd_ops, "_forward", counted("ssd", ssd_ops._forward))
    monkeypatch.setattr(flash_ops, "_forward",
                        counted("flash", flash_ops._forward))
    cfg = dataclasses.replace(get_smoke_config(arch), remat=remat)
    loss_and_grads(cfg, working_copy(cfg, TrainConfig(), init_params_f32(cfg)),
                   _tt(_batch(arch)))
    attn = sum(c for s, c in cfg.plan if s.kind in ("attn", "hybrid"))
    assert calls == {"ssd": per_layer * cfg.n_layers,
                     "flash": per_layer * attn}


def test_train_mode_builds_no_decode_cache():
    cfg = get_smoke_config("hymba-1.5b")
    params = model.init_params(cfg, device="cpu")
    h, caches, _, _ = model.forward_hidden(cfg, params, _tt(_batch(
        "hymba-1.5b")), "train")
    assert caches is None
    from repro_torch.models import attention, ssm
    spec = cfg.plan[0][0]
    x = torch.randn(2, 5, cfg.d_model)
    assert ssm.ssm_forward(params["segments"][0][0]["ssm"], x, spec.ssm,
                           cache=False)[1] is None
    assert attention.attn_forward(params["segments"][0][0]["attn"], x,
                                  spec.attn, cache=False)[1] is None


# --- the autograd Functions -----------------------------------------------------

SSD_GRAD_SHAPES = [  # (b, s, H, P, G, N, chunk): ragged S, G < H, G == H
    (2, 37, 4, 8, 2, 16, 8), (1, 20, 3, 8, 1, 8, 8), (2, 16, 2, 4, 2, 4, 16)]


@pytest.mark.parametrize("shape", SSD_GRAD_SHAPES, ids=str)
@pytest.mark.parametrize("use_state", [False, True])
def test_ssd_function_grads_equal_plain_autograd(shape, use_state):
    b, s, H, P, G, N, chunk = shape
    rng = np.random.default_rng(sum(shape))
    arrays = (rng.normal(size=(b, s, H, P)), rng.uniform(0.01, 0.1, (b, s, H)),
              rng.uniform(-1, 1, H), rng.normal(size=(b, s, G, N)),
              rng.normal(size=(b, s, G, N)), rng.normal(size=H))
    gy = torch.from_numpy(rng.normal(size=(b, s, H, P)).astype(np.float32))
    gs = torch.from_numpy(rng.normal(size=(b, H, P, N)).astype(np.float32))
    res = []
    for fn in (ssd_ops.ssd_fused, ssd_ops.ssd_fused_plain):
        ins = [torch.from_numpy(a.astype(np.float32)).requires_grad_()
               for a in arrays]
        y, state = fn(*ins, chunk=chunk)
        if fn is ssd_ops.ssd_fused:
            assert type(y.grad_fn).__name__ == "_SSDFusedBackward"
        loss = (y * gy).sum() + ((state * gs).sum() if use_state else 0.0)
        loss.backward()
        res.append((y.detach(), state.detach(), [t.grad for t in ins]))
    (y1, s1, g1), (y2, s2, g2) = res
    assert torch.equal(y1, y2) and torch.equal(s1, s2)
    for a, b_ in zip(g1, g2):
        assert a is not None and torch.equal(a, b_)


def test_ssd_function_passes_grads_only_where_asked():
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(                         # noqa: E731
        rng.normal(size=s).astype(np.float32))
    xs, B, C = t(1, 9, 2, 4).requires_grad_(), t(1, 9, 1, 4), t(1, 9, 1, 4)
    dt = torch.full((1, 9, 2), 0.05)
    y, _ = ssd_ops.ssd_fused(xs, dt, torch.zeros(2), B, C, torch.ones(2),
                             chunk=4)
    y.sum().backward()
    assert xs.grad is not None and dt.grad is None and B.grad is None
    with torch.no_grad():
        y, _ = ssd_ops.ssd_fused(xs, dt, torch.zeros(2), B, C, torch.ones(2),
                                 chunk=4)
    assert y.grad_fn is None


FLASH_GRAD_CASES = [  # (b, s, H, Hkv, hd, causal, window)
    (2, 37, 4, 2, 8, True, 0), (1, 29, 5, 1, 8, True, 8),
    (2, 16, 2, 2, 4, False, 0), (1, 21, 6, 3, 8, False, 5)]


@pytest.mark.parametrize("case", FLASH_GRAD_CASES, ids=str)
def test_flash_function_grads_equal_plain_autograd(case):
    b, s, H, Hkv, hd, causal, window = case
    rng = np.random.default_rng(s + H)
    arrays = (rng.normal(size=(b, s, H, hd)), rng.normal(size=(b, s, Hkv, hd)),
              rng.normal(size=(b, s, Hkv, hd)))
    go = torch.from_numpy(rng.normal(size=(b, s, H, hd)).astype(np.float32))
    res = []
    for fn in (flash_ops.flash_attention, flash_ops.flash_attention_plain):
        ins = [torch.from_numpy(a.astype(np.float32)).requires_grad_()
               for a in arrays]
        out = fn(*ins, causal=causal, window=window)
        if fn is flash_ops.flash_attention:
            assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
        (out * go).sum().backward()
        res.append((out.detach(), [t.grad for t in ins]))
    (o1, g1), (o2, g2) = res
    assert torch.equal(o1, o2)
    for a, b_ in zip(g1, g2):
        assert a is not None and torch.equal(a, b_)


def test_flash_plain_leaves_its_inputs_alone():
    """The plain version is out of place (autograd saves what it reads)
    and gives the numbers it gave in place: the reference's dense
    softmax."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 12, 2, 8)).astype(
        np.float32)) for _ in range(3))
    keep = [t.clone() for t in (q, k, v)]
    out = flash_ops.flash_attention_plain(q, k, v, window=4)
    for a, b_ in zip((q, k, v), keep):
        assert torch.equal(a, b_)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * 8 ** -0.5
    i, j = torch.arange(12)[:, None], torch.arange(12)[None, :]
    logits = logits.masked_fill(~((i >= j) & (i - j < 4)), -1e30)
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v)
    _close(out, want, rtol=1e-6, atol=1e-6)


# --- data -----------------------------------------------------------------------

def _lm_cfg(frontend="none"):
    return types.SimpleNamespace(frontend=frontend, frontend_dim=6,
                                 vocab=97, meta_tokens=4)


@pytest.mark.parametrize("frontend", ["none", "audio", "vlm"])
def test_make_batch_is_byte_equal_to_reference(frontend):
    cfg = _lm_cfg(frontend)
    for seed, step, host, n_hosts in ((0, 0, 0, 1), (5, 3, 1, 2),
                                      (1234, 17, 3, 4)):
        a = make_batch(cfg, DataConfig(batch=8, seq=16, seed=seed), step,
                       host, n_hosts)
        b = ref_data.make_batch(cfg, ref_data.DataConfig(batch=8, seq=16,
                                                         seed=seed),
                                step, host, n_hosts)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes()


def test_prefetcher_yields_the_steps_in_order_and_stops():
    cfg = get_smoke_config("mamba2-370m")
    dcfg = DataConfig(batch=2, seq=8, seed=9)
    pre = Prefetcher(cfg, dcfg, start_step=3)
    try:
        for step in (3, 4, 5):
            got_step, batch = next(pre)
            assert got_step == step
            np.testing.assert_array_equal(
                batch["tokens"], make_batch(cfg, dcfg, step)["tokens"])
    finally:
        pre.close()
    assert not pre._thread.is_alive()


# --- checkpoints ----------------------------------------------------------------

def _same_state(a, b):
    fa, fb = state_to_flat(a), state_to_flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_round_trip(arch, tmp_path):
    cfg = get_smoke_config(arch)
    state = init_state(cfg, seed=1, device="cpu")
    state["step"] += 7
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    mgr.save(state, 7)
    restored = mgr.restore(init_state(cfg, seed=2, device="cpu"))
    _same_state(restored, state)
    assert restored["params"]["segments"][-1][-1]["ssm"]["in_x"].dtype == \
        torch.float32


def test_checkpoint_gc_keeps_last_k(tmp_path):
    state = init_state(get_smoke_config("mamba2-370m"), device="cpu")
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(state, s, blocking=s % 2 == 0)
    mgr.wait()
    assert mgr.all_steps() == [3, 4]


def test_checkpoint_shape_mismatch_and_missing_leaf_raise(tmp_path):
    cfg = get_smoke_config("mamba2-370m")
    state = init_state(cfg, device="cpu")
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(state, 1)
    bad = init_state(cfg, device="cpu")
    bad["step"] = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="shape mismatch for step"):
        mgr.restore(bad)
    deeper = init_state(dataclasses.replace(
        cfg, plan=((cfg.plan[0][0], 4),)), device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(deeper)
    extra = init_state(cfg, device="cpu")
    extra["params"]["lm_head"] = torch.zeros(2, 2)
    with pytest.raises(KeyError, match="lm_head"):
        mgr.restore(extra)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(state)


def test_a_failed_asynchronous_write_raises_in_wait(tmp_path, monkeypatch):
    from repro_torch.train import checkpoint
    mgr = CheckpointManager(str(tmp_path / "ck"))

    def broken(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(checkpoint.np, "savez", broken)
    mgr.save(init_state(get_smoke_config("mamba2-370m"), device="cpu"), 1,
             blocking=False)
    with pytest.raises(RuntimeError, match="asynchronous") as err:
        mgr.wait()
    assert isinstance(err.value.__cause__, OSError)
    assert mgr.all_steps() == []
    mgr.wait()                                    # the error is consumed


def _run(arch, workdir, steps, ckpt_every=100):
    cfg = get_smoke_config(arch)
    tcfg = TrainConfig(optim=AdamWConfig(peak_lr=5e-3, warmup_steps=2,
                                         total_steps=steps,
                                         weight_decay=0.0), grad_accum=2)
    rcfg = RunConfig(steps=steps, ckpt_every=ckpt_every, monitor_every=100,
                     log_every=1, workdir=str(workdir))
    return Trainer(cfg, tcfg, DataConfig(batch=4, seq=24), rcfg,
                   device="cpu").run()


def test_async_checkpoint_and_resume_give_the_uninterrupted_losses(tmp_path):
    """Six steps with an asynchronous checkpoint at step 3; a second run
    resumes from that checkpoint alone and gives steps 4-6's losses."""
    full = _run("mamba2-370m", tmp_path / "a", 6, ckpt_every=3)
    ck = tmp_path / "a" / "ckpt"
    assert sorted(os.listdir(ck)) == ["step_000000003", "step_000000006"]
    os.makedirs(tmp_path / "b" / "ckpt")
    shutil.copytree(ck / "step_000000003", tmp_path / "b" / "ckpt" /
                    "step_000000003")
    resumed = _run("mamba2-370m", tmp_path / "b", 6, ckpt_every=3)
    assert len(resumed["losses"]) == 3
    np.testing.assert_allclose(resumed["losses"], full["losses"][3:],
                               rtol=1e-6)
    _same_state(resumed["state"], full["state"])


def test_checkpoints_carry_across_the_two_packages(tmp_path):
    """A reference-written checkpoint restores into the port, and one step
    from it gives the reference's loss; a port-written one restores into
    the reference bit for bit."""
    rcfg = ref_get_smoke_config("mamba2-370m")
    cfg = get_smoke_config("mamba2-370m")
    state_r = _ref_state("mamba2-370m", 3)
    RefCheckpointManager(str(tmp_path / "ref")).save(state_r, 0)
    state = CheckpointManager(str(tmp_path / "ref")).restore(
        init_state(cfg, device="cpu"))
    batch = _batch("mamba2-370m", batch=4, step=5)
    _, m_r = jax.jit(ref_make_train_step(rcfg, RefTrainConfig()))(
        state_r, _jnp(batch))
    state, m = make_train_step(cfg, TrainConfig())(state, _tt(batch))
    _close(m["loss"], m_r["loss"])

    CheckpointManager(str(tmp_path / "port")).save(state, 1)
    back = RefCheckpointManager(str(tmp_path / "port")).restore(
        jax.eval_shape(lambda: state_r))
    want = state_to_flat(state)
    for k, v in ref_flatten(back).items():
        assert np.array_equal(np.asarray(v), want[k]), k
    assert int(back["step"]) == 1


# --- the trainer and its CLI ----------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_decreases(arch, tmp_path):
    """The reference's loss-decreases test on the port's trainer."""
    cfg = get_smoke_config(arch)
    tcfg = TrainConfig(optim=AdamWConfig(peak_lr=5e-3, warmup_steps=3,
                                         total_steps=30, weight_decay=0.0))
    rcfg = RunConfig(steps=25, ckpt_every=100, monitor_every=100,
                     workdir=str(tmp_path / arch))
    ls = Trainer(cfg, tcfg, DataConfig(batch=4, seq=24), rcfg,
                 device="cpu").run()["losses"]
    assert np.isfinite(ls).all()
    assert np.mean(ls[-5:]) < np.mean(ls[:5]), \
        f"{arch} loss did not decrease: {ls[:3]} -> {ls[-3:]}"


def test_trainer_writes_telemetry_and_logs(tmp_path):
    res = _run("hymba-1.5b", tmp_path, 4, ckpt_every=2)
    dbs = sorted(os.listdir(res["telemetry_dir"]))
    assert dbs == ["rank0.sqlite"]
    with open(tmp_path / "metrics.jsonl") as f:
        rows = [line for line in f if line.strip()]
    assert len(rows) == 4 and "grad_norm" in rows[0]
    assert CheckpointManager(str(tmp_path / "ckpt")).all_steps() == [2, 4]


def test_ckpt_every_zero_writes_no_checkpoint(tmp_path):
    """ckpt_every <= 0 (a division by zero in the reference) writes no
    periodic and no final checkpoint."""
    res = _run("mamba2-370m", tmp_path, 2, ckpt_every=0)
    assert len(res["losses"]) == 2
    assert CheckpointManager(str(tmp_path / "ckpt")).all_steps() == []


def test_train_cli_on_the_host(tmp_path, capsys):
    train_main(["--arch", "mamba2-370m", "--smoke", "--device", "cpu",
                "--steps", "4", "--seq", "16", "--batch", "4",
                "--workdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "final loss" in out and "on cpu" in out
    with pytest.raises(ValueError, match="256 ranks, and this one has 1"):
        train_main(["--arch", "mamba2-370m", "--smoke", "--device", "cpu",
                    "--production-mesh"])
