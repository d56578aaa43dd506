"""The port's training stack against the JAX package on the CPU for the
eight families without an SSM layer: stablelm-3b, h2o-danube-1.8b,
nemotron-4-15b, starcoder2-15b, granite-moe-1b-a400m (MoE), qwen2-vl-7b
(VLM patches and M-RoPE), hubert-xlarge (audio frames and a loss mask,
non-causal) and deepseek-v2-236b (MLA and MoE with shared experts), each
at its smoke config.

Weights and optimizer states come from the port's initialiser in the
reference's layout and cross through ``repro_torch.models.convert``;
batches come from the data pipeline (byte-equal in both packages), its
audio and VLM branches included. The reference differentiates its XLA
formulations, so no Pallas kernel is reached on either side; the port's
``flash_attention`` takes its plain version on the CPU. Everything runs
in float32 (the smoke configs' dtype).

The MoE capacity and aux loss are taken per call, and the masked CE
mean per microbatch, so for the MoE families and hubert an accumulated
step differs from a one-call step in the reference itself: the port's
grad_accum 2 is held to the reference's grad_accum 2.

Tolerances as in tests/test_torch_train.py: loss and every gradient leaf
rtol 1e-4, atol 1e-5; one train step's first moments rtol 1e-4 and atol
1e-7, second moments rtol 2e-4, parameters atol 2e-6 (at eps = 1e-5);
the MoE's dropped share within 1e-6 (a mean of per-layer shares, below
one assignment); remat "full" against "none" rtol 1e-6; the autograd
Function against autograd of the plain version exactly; checkpoints bit
for bit.
"""

import dataclasses

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
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.flashattn import ops as flash_ops
from repro_torch.launch.train import main as train_main
from repro_torch.models import model
from repro_torch.models.convert import (from_reference, state_from_flat,
                                        state_to_flat)
from repro_torch.train import (AdamWConfig, CheckpointManager, TrainConfig,
                               init_state, make_train_step)
from repro_torch.train.optim import tree_unflatten
from repro_torch.train.step import batch_to, loss_and_grads, working_copy

FAMILIES = ["stablelm-3b", "h2o-danube-1.8b", "nemotron-4-15b",
            "starcoder2-15b", "granite-moe-1b-a400m", "qwen2-vl-7b",
            "hubert-xlarge", "deepseek-v2-236b"]
MOE = ["granite-moe-1b-a400m", "deepseek-v2-236b"]
# one step at grad_accum 1 for every family; at 2 where an accumulated
# step is not a one-call step (per-call MoE capacity and aux loss, the
# per-microbatch masked CE mean)
STEP_CASES = [(a, 1) for a in FAMILIES] + [
    (a, 2) for a in ("granite-moe-1b-a400m", "hubert-xlarge",
                     "deepseek-v2-236b")]
CPU = torch.device("cpu")
OPTIM = dict(peak_lr=1e-3, warmup_steps=0, total_steps=10, eps=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size tensors gain nothing from torch's intra-op threads, and
    in a loaded parallel run those threads wait on each other
    (tests/test_torch_train.py measured 77 s against 6)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


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
    initial state in the reference's layout (test_torch_families.py and
    test_torch_mla.py hold the two trees' structure to each other)."""
    return _nested(state_to_flat(init_state(get_smoke_config(arch), seed,
                                            "cpu")))


def test_the_batches_take_each_frontend():
    """The data pipeline's audio and VLM branches feed these families:
    frames and a loss mask for hubert, patches and three position rows
    for qwen2-vl."""
    assert sorted(_batch("hubert-xlarge")) == ["frames", "labels",
                                               "loss_mask"]
    vlm = _batch("qwen2-vl-7b")
    assert sorted(vlm) == ["labels", "patches", "positions3", "tokens"]
    assert vlm["positions3"].shape == (2, 3, 24)
    assert vlm["patches"].shape[1] + vlm["tokens"].shape[1] == 24


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_every_gradient_match_reference(arch):
    """The reference's jitted value_and_grad of its loss_fn on the same
    parameters and batch: loss, CE, the MoE metrics and every gradient
    leaf (the router's, the shared experts', MLA's low-rank factors, the
    frontend projection's)."""
    rcfg = ref_get_smoke_config(arch)
    params_r = jax.tree.map(np.asarray, _ref_state(arch, 0)["params"])
    batch = _batch(arch)
    (loss_r, m_r), grads_r = jax.jit(jax.value_and_grad(
        lambda p, bt: ref_model.loss_fn(rcfg, p, bt), has_aux=True))(
        params_r, _jnp(batch))
    cfg = get_smoke_config(arch)
    work = working_copy(cfg, TrainConfig(), from_reference(cfg, params_r,
                                                           "cpu"))
    loss, metrics, grads = loss_and_grads(cfg, work, _tt(batch))
    _close(loss, loss_r)
    assert sorted(metrics) == sorted(m_r)
    for k in ("ce", "aux_loss"):
        if k in m_r:
            _close(metrics[k], m_r[k])
    if "dropped" in m_r:
        _close(metrics["dropped"], m_r["dropped"], rtol=0, atol=1e-6)
    got, want = state_to_flat(tree_unflatten(work, grads)), \
        ref_flatten(grads_r)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        _close(got[k], w)


@pytest.mark.parametrize("arch,accum", STEP_CASES, ids=str)
def test_one_train_step_matches_reference(arch, accum):
    """One step from the reference's state in both packages at the same
    grad_accum over a batch of 4, warmup 0 so the update is taken at the
    peak lr: the metrics (the MoE's aux loss and dropped share averaged
    over the microbatches) and every parameter and moment."""
    rcfg = ref_get_smoke_config(arch)
    cfg = get_smoke_config(arch)
    batch = _batch(arch, batch=4)
    state_r = _ref_state(arch, 0)
    state = state_from_flat(init_state(cfg, device="cpu"),
                            ref_flatten(state_r))
    new_r, m_r = jax.jit(ref_make_train_step(rcfg, RefTrainConfig(
        optim=ref_optim.AdamWConfig(**OPTIM), grad_accum=accum)))(
        state_r, _jnp(batch))
    new, m = make_train_step(cfg, TrainConfig(optim=AdamWConfig(**OPTIM),
                                              grad_accum=accum))(
        state, _tt(batch))
    assert sorted(m) == sorted(m_r)
    for k in m_r:
        if k == "dropped":
            _close(m[k], m_r[k], rtol=0, atol=1e-6)
        else:
            _close(m[k], m_r[k])
    got, want = state_to_flat(new), ref_flatten(new_r)
    assert sorted(got) == sorted(want) and int(got["step"]) == 1
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        if k.startswith("params/"):
            _close(got[k], w, rtol=0, atol=2e-6)
        elif k.startswith("opt/m/"):
            _close(got[k], w, atol=1e-7)
        elif k.startswith("opt/v/"):
            _close(got[k], w, rtol=2e-4, atol=1e-12)


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_full_equals_none(arch):
    """Each layer under torch.utils.checkpoint (the MoE's routing and the
    MLA's latents recomputed in backward) gives the loss and gradients of
    keeping every activation."""
    cfg = get_smoke_config(arch)
    params = model.init_params(cfg, seed=0, device="cpu",
                               dtype=torch.float32)
    batch = _tt(_batch(arch))
    res = []
    for remat in ("full", "none"):
        c = dataclasses.replace(cfg, remat=remat)
        res.append(loss_and_grads(c, working_copy(c, TrainConfig(), params),
                                  batch))
    (l_f, m_f, g_f), (l_n, m_n, g_n) = res
    _close(l_f, l_n, rtol=1e-6, atol=0)
    for k in m_f:
        _close(m_f[k], m_n[k], rtol=1e-6, atol=0)
    for a, b in zip(g_f, g_n):
        _close(a, b, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("remat,per_layer", [("full", 2), ("none", 1)])
def test_flash_launches_per_microbatch(arch, remat, per_layer, monkeypatch):
    """The dispatch that launches the attention kernel on the card runs
    once a layer in the forward and once more in the remat recompute,
    never in backward (the plain recompute there is not a launch)."""
    calls = []

    def counted(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)
    real = flash_ops._forward
    monkeypatch.setattr(flash_ops, "_forward", counted)
    cfg = dataclasses.replace(get_smoke_config(arch), remat=remat)
    loss_and_grads(cfg, working_copy(cfg, TrainConfig(), model.init_params(
        cfg, seed=0, device="cpu", dtype=torch.float32)), _tt(_batch(arch)))
    assert len(calls) == per_layer * cfg.n_layers


@pytest.mark.parametrize("arch", FAMILIES)
def test_checkpoint_round_trip(arch, tmp_path):
    """Every leaf back bit for bit in its own dtype: the float32 master
    weights, moments and router, the int32 step."""
    cfg = get_smoke_config(arch)
    state = init_state(cfg, seed=1, device="cpu")
    state["step"] += 7
    CheckpointManager(str(tmp_path / "ck")).save(state, 7)
    restored = CheckpointManager(str(tmp_path / "ck")).restore(
        init_state(cfg, seed=2, device="cpu"))
    fa, fb = state_to_flat(restored), state_to_flat(state)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k]), k
        assert fa[k].dtype == (np.int32 if k == "step" else np.float32), k
    if arch in MOE:
        moe = restored["params"]["segments"][-1][-1]["moe"]
        assert moe["router"].dtype == torch.float32
        assert ("shared" in moe) == (arch == "deepseek-v2-236b")


@pytest.mark.parametrize("arch", MOE)
def test_checkpoints_carry_across_the_two_packages(arch, tmp_path):
    """A reference-written checkpoint with MoE (and MLA) leaves restores
    into the port, and one step from it gives the reference's loss; a
    port-written one restores into the reference bit for bit."""
    rcfg = ref_get_smoke_config(arch)
    cfg = get_smoke_config(arch)
    state_r = _ref_state(arch, 3)
    RefCheckpointManager(str(tmp_path / "ref")).save(state_r, 0)
    state = CheckpointManager(str(tmp_path / "ref")).restore(
        init_state(cfg, device="cpu"))
    batch = _batch(arch, batch=4, step=5)
    _, m_r = jax.jit(ref_make_train_step(rcfg, RefTrainConfig()))(
        state_r, _jnp(batch))
    state, m = make_train_step(cfg, TrainConfig())(state, _tt(batch))
    _close(m["loss"], m_r["loss"])
    _close(m["aux_loss"], m_r["aux_loss"])

    CheckpointManager(str(tmp_path / "port")).save(state, 1)
    back = RefCheckpointManager(str(tmp_path / "port")).restore(
        jax.eval_shape(lambda: state_r))
    want = state_to_flat(state)
    got = ref_flatten(back)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert np.array_equal(np.asarray(v), want[k]), k
    assert int(back["step"]) == 1


def test_train_cli_trains_an_moe_family_on_the_host(tmp_path, capsys):
    train_main(["--arch", "granite-moe-1b-a400m", "--smoke", "--device",
                "cpu", "--steps", "4", "--seq", "16", "--batch", "4",
                "--grad-accum", "2", "--workdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "final loss" in out and "on cpu" in out
    assert CheckpointManager(str(tmp_path / "ckpt")).all_steps()[-1] == 4


# --- the attention Function with split head dims -----------------------------

SPLIT_GRAD_CASES = [  # (b, s, H, Hkv, hd, hdv, causal, window)
    (2, 29, 4, 4, 24, 16, True, 0), (1, 21, 4, 2, 16, 8, True, 6),
    (2, 17, 2, 2, 24, 16, False, 0)]


@pytest.mark.parametrize("case", SPLIT_GRAD_CASES, ids=str)
def test_flash_function_split_dims_grads_equal_plain_autograd(case):
    """v's head dim below q and k's (MLA's 128 against 192, at small
    sizes): the Function's output and the gradients of q, k and v equal
    autograd of the plain version exactly."""
    b, s, H, Hkv, hd, hdv, causal, window = case
    rng = np.random.default_rng(s + H + hdv)
    arrays = (rng.normal(size=(b, s, H, hd)), rng.normal(size=(b, s, Hkv, hd)),
              rng.normal(size=(b, s, Hkv, hdv)))
    go = torch.from_numpy(rng.normal(size=(b, s, H, hdv)).astype(np.float32))
    res = []
    for fn in (flash_ops.flash_attention, flash_ops.flash_attention_plain):
        ins = [torch.from_numpy(a.astype(np.float32)).requires_grad_()
               for a in arrays]
        out = fn(*ins, causal=causal, window=window, scale=0.3)
        if fn is flash_ops.flash_attention:
            assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
        assert out.shape == (b, s, H, hdv)
        (out * go).sum().backward()
        res.append((out.detach(), [t.grad for t in ins]))
    (o1, g1), (o2, g2) = res
    assert torch.equal(o1, o2)
    for a, b_ in zip(g1, g2):
        assert a is not None and torch.equal(a, b_)


def test_chip_smoke_training_cuts_are_the_reference_counts():
    """The depth cuts chip_smoke.py trains (and deepseek's MoE gradient
    check) hold the reference's parameter counts, by ``jax.eval_shape``
    of its ``init_params`` on the cut config, and each training phase's
    flash instantiation is the smallest that takes its head dims."""
    import importlib.util
    from pathlib import Path

    from repro.configs import get_config as ref_get_config
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cuts = list(smoke.TRAIN_DEPTH_CUTS.items()) + [
        ("deepseek-v2-236b", smoke.DEEPSEEK_MOE_CHECK)]
    for arch, (counts, n) in cuts:
        cfg = smoke.cut_depth(ref_get_config(arch), counts)
        shapes = jax.eval_shape(lambda c=cfg: ref_model.init_params(
            c, jax.random.PRNGKey(0)))
        assert ref_model.param_count(shapes) == n, arch
    assert smoke._train_cfg("deepseek-v2-236b")[0].plan == (
        (get_config("deepseek-v2-236b").plan[0][0], 1),)
    instances = ((16, 16), (32, 32), (64, 64), (128, 128), (192, 128))
    assert sorted(s["arch"] for s in smoke.TRAIN_SPECS.values()) == sorted(
        FAMILIES + ["mamba2-370m", "hymba-1.5b"])
    for tag, sp in smoke.TRAIN_SPECS.items():
        cfg = smoke._train_cfg(sp["arch"])[0]
        attn = [s.attn for s, _ in cfg.plan if s.attn is not None]
        if not attn:
            assert "flash_instance" not in sp, tag
            continue
        hd = attn[0].head_dim
        hdv = attn[0].v_head_dim or hd
        assert sp["flash_instance"] == next(
            i for i in instances if i[0] >= hd and i[1] >= hdv), tag


def test_adamw_update_by_slices_equals_whole_leaves(monkeypatch):
    """The update a slice of a leaf at a time (nemotron-4-15b's head and
    embedding are 1.57 B elements each) gives the whole-leaf update bit
    for bit: a matrix cut into row slices of 7 elements, a 3-d leaf, a
    vector, a 0-d leaf and a transposed (non-contiguous) gradient."""
    from repro_torch.train import optim

    rng = np.random.default_rng(5)
    t = lambda s: torch.from_numpy(                       # noqa: E731
        np.asarray(rng.normal(size=s), np.float32))
    params = {"w": t((9, 4)), "moe": {"w_up": t((3, 5, 2))},
              "scale": t((11,)), "t": t(())}
    grads = {"w": t((4, 9)).T, "moe": {"w_up": t((3, 5, 2))},
             "scale": t((11,)), "t": t(())}
    assert not grads["w"].is_contiguous()
    out = []
    for slice_ in (1 << 24, 7):
        monkeypatch.setattr(optim, "SLICE", slice_)
        p = optim.tree_map(torch.clone, params)
        st = optim.adamw_init(p)
        for step in range(3):
            optim.adamw_update(AdamWConfig(peak_lr=1e-2, warmup_steps=1),
                               grads, st, p, torch.tensor(step))
        out.append((p, st))
    (p1, s1), (p2, s2) = out
    for a, b in zip(optim.tree_leaves([p1, s1["m"], s1["v"]]),
                    optim.tree_leaves([p2, s2["m"], s2["v"]])):
        assert torch.equal(a, b)
    assert len(optim.row_slices(p2["w"])) > 1
