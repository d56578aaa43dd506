"""Training on a (1, T) mesh on gloo on the CPU, against the JAX
package's jitted train step on its (1, T) mesh.

Built as ``tests/test_torch_tp.py`` is: the rank processes run this file
(``python tests/test_torch_tp_train.py rank <rank> <world> <port>
<dir>``) in a gloo group of T = 2 and one of T = 4, each with a 60 s
group timeout, under a subprocess timeout; the reference runs it once
for each T (``python tests/test_torch_tp_train.py reference <dir> <T>``)
on 4 fake devices: ``jit_train_step`` (``jax.jit(make_train_step(cfg,
tcfg, mesh))`` with the state placed by ``state_specs``) and the jitted
gradient of ``loss_fn(..., ctx)`` on a ``("data", "model")`` mesh of
(1, T). All six start together; the initial states (the port's
``init_state``, in the reference's layout) and the batches (the data
pipeline) come from this process as numpy.

- Cases: the smoke configs of stablelm-3b (dense FFN), mamba2-370m (SSM,
  vocab-parallel CE), granite-moe-1b-a400m (``ep``, grad_accum 1 and 2;
  an S that T does not divide: ``replicated``), deepseek-v2-236b (MLA,
  shared experts) at T = 2 and 4, narrow danube and granite variants
  (8 query, 4 KV heads) at T = 4, and the layouts with heads T does not
  divide: hymba-1.5b at T = 2 and 4 (its attention whole on every rank,
  its hybrid layers' norms, gains and meta tokens whole) and with 2 SSM
  heads at T = 4 (the scan whole on every rank), danube at T = 4 (2 KV
  heads whole beside the rank's query heads) and with 6 query and 3 KV
  heads at T = 2 (a rank's query heads read KV heads that do not group
  evenly under them). Each rank's loss, every gradient
  block, ``grad_norm``, and after one step its blocks of the parameters
  and both moments against the same slice of the reference's, at
  ``tests/test_torch_train.py``'s tolerances; every rank's whole leaves'
  gradients, updated leaves, loss and ``grad_norm`` bit-equal to rank
  0's; a rank's parameter and moment bytes equal to
  ``bytes_per_device``.
- The backward's ordered sums (``tp.enter``) are float32 adds in rank
  order, cast once, bit for bit; ``gather_cat``'s backward is the rank's
  slice and ``all_to_all``'s the inverse exchange.
- Checkpoints: mamba2 trained by ``Trainer(..., mesh=)`` at T = 2 gives
  a one-rank run's losses, and its checkpoint the one-rank run's file
  (keys, shapes, values); a run checkpointed at T = 2 resumes at P = 1,
  and one checkpointed at P = 1 resumes at T = 2, with the
  uninterrupted run's losses; rank 0 alone writes ``metrics.jsonl``.
- ``chip_smoke.py``'s tp-train step, run on the CPU at smoke size
  (granite's narrow variant, mamba2 and hymba at T = 4): its P = 1
  yardstick reproduces the mesh run's losses and gradients.
- ``state_specs`` equals the reference's at (1, 2) and (1, 4).
- Training with a data axis is ``tests/test_torch_dp_train.py``'s.

Tolerances: loss and gradients rtol 1e-4, atol 1e-5; after one step
first moments rtol 1e-4, atol 1e-7, second moments rtol 2e-4, parameters
atol 2e-6 (AdamW's eps 1e-5, lr 1e-3), as ``tests/test_torch_train.py``.
"""

import datetime
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from test_torch_tp import (GROUP_TIMEOUT_S, NARROW, ODD_SSM, SRC,
                           _free_port, _narrowed, _nested, _slice)

HERE = os.path.dirname(os.path.abspath(__file__))
WORLDS = (2, 4)
GRANITE, DEEPSEEK = "granite-moe-1b-a400m", "deepseek-v2-236b"
HYMBA, DANUBE = "hymba-1.5b", "h2o-danube-1.8b"
# 6 query and 3 KV heads at T = 2: a rank's 3 query heads read KV heads
# (0, 0, 1) or (1, 2, 2), which do not group evenly (``_rank_kv``'s
# index_select)
UNEVEN = {"attn": {"n_heads": 6, "n_kv_heads": 3}}
OPTIM = dict(peak_lr=1e-3, warmup_steps=0, total_steps=10, eps=1e-5)
# name: (arch, T, fields replaced in both packages' smoke config, grad
# accumulation, batch, sequence)
CASES = {
    "stablelm/2": ("stablelm-3b", 2, None, 1, 2, 24),
    "stablelm/4": ("stablelm-3b", 4, None, 1, 2, 24),
    "mamba2/2": ("mamba2-370m", 2, None, 1, 2, 24),
    "mamba2/4": ("mamba2-370m", 4, None, 1, 2, 24),
    "granite/2": (GRANITE, 2, None, 1, 2, 24),
    "granite-odd-s/2": (GRANITE, 2, None, 1, 2, 25),
    "granite-narrow/4": (GRANITE, 4, NARROW, 1, 2, 24),
    "granite-accum2/4": (GRANITE, 4, NARROW, 2, 4, 24),
    "deepseek/2": (DEEPSEEK, 2, None, 1, 2, 24),
    "deepseek/4": (DEEPSEEK, 4, None, 1, 2, 24),
    "danube-narrow/4": (DANUBE, 4, NARROW, 1, 2, 24),
    # heads T does not divide: hymba's attention whole (5 query heads, 1
    # KV head) beside its 16 SSM heads split, then scanned whole (2 SSM
    # heads at T = 4); danube's 2 KV heads whole beside its 4 query heads
    # split, and 6 query heads over 3 KV heads at T = 2
    "hymba/2": (HYMBA, 2, None, 1, 2, 24),
    "hymba/4": (HYMBA, 4, None, 1, 2, 24),
    "hymba-ssm-odd/4": (HYMBA, 4, ODD_SSM, 1, 2, 24),
    "danube/4": (DANUBE, 4, None, 1, 2, 24),
    "danube-uneven/2": (DANUBE, 2, UNEVEN, 1, 2, 24),
}
# cases drawn from another case's seeds: hymba at T = 4 trains hymba/2's
# initial state on hymba/2's batch
SAME_INPUTS = {"hymba/4": "hymba/2"}
CKPT_ARCH, CKPT_STEPS, CKPT_AT = "mamba2-370m", 4, 2
# chip_smoke.py's tp-train step at smoke size: (arch, fields, sequence)
CARD_CASES = {"tp-train-granite": (GRANITE, NARROW, 24),
              "tp-train-mamba2": ("mamba2-370m", None, 24),
              "tp-train-hymba": (HYMBA, None, 24)}


def _cfg(case, package):
    if package == "port":
        from repro_torch.configs import get_smoke_config
    else:
        from repro.configs import get_smoke_config
    arch, _, fields = CASES[case][:3]
    return _narrowed(get_smoke_config(arch), fields)


def _stem(case):
    return case.replace("/", "_")


def _load(work, name):
    return dict(np.load(os.path.join(work, name)))


def _port_train(n, optim=OPTIM):
    from repro_torch.train import AdamWConfig, TrainConfig
    return TrainConfig(optim=AdamWConfig(**optim), grad_accum=n)


def _run_cfgs(workdir, steps=CKPT_STEPS, ckpt_every=CKPT_AT):
    from repro_torch.data import DataConfig
    from repro_torch.train import RunConfig
    return (DataConfig(batch=2, seq=24, seed=5),
            RunConfig(steps=steps, ckpt_every=ckpt_every, monitor_every=100,
                      log_every=1, workdir=workdir, async_ckpt=False))


def _trainer_losses(workdir, mesh=None, steps=CKPT_STEPS,
                    ckpt_every=CKPT_AT):
    from repro_torch.configs import get_smoke_config
    from repro_torch.train import Trainer
    dcfg, rcfg = _run_cfgs(workdir, steps, ckpt_every)
    res = Trainer(get_smoke_config(CKPT_ARCH), _port_train(1), dcfg, rcfg,
                  seed=7, device="cpu", mesh=mesh).run()
    return res["losses"]


# --- the rank processes -----------------------------------------------------

def _rank_main(rank, world, port_no, work):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.shardrules import make_ctx

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port_no}", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    mesh = make_host_mesh(model=world)
    ctx = make_ctx(mesh)
    arrays, checks = {}, {}
    for case, (_, t, *_) in CASES.items():
        if t == world:
            _train_case(case, mesh, ctx, work, arrays, checks)
    checks["backward_sums"] = _backward_sums(rank, world, ctx)
    if world == 2:
        checks["checkpoint"] = _checkpoints(rank, mesh, work)
    else:
        checks.update(_card_steps(rank))
    np.savez(os.path.join(work, f"t{world}_rank{rank}.npz"), **arrays)
    with open(os.path.join(work, f"t{world}_rank{rank}.json"), "w") as f:
        json.dump(checks, f)
    dist.destroy_process_group()


def _specs_by_key(cfg, mesh):
    """Each reference-layout key's held spec (a stacked segment leaf gets
    a leading None), as JSON lists."""
    from repro_torch.models.model import param_shapes
    from repro_torch.models.shardrules import _items, held_specs
    out = {}
    for path, spec in _items(held_specs(param_shapes(cfg), mesh)):
        parts = path.split("/")
        if parts[0] == "segments":
            path, spec = "/".join(parts[:2] + parts[3:]), (None,) + spec
        out[path] = [list(e) if e else None for e in spec]
    return out


def _train_case(case, mesh, ctx, work, arrays, checks):
    from repro_torch.models.convert import state_from_flat, state_to_flat
    from repro_torch.models.model import param_shapes
    from repro_torch.models.shardrules import _items, bytes_per_device
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train.optim import tree_unflatten
    from repro_torch.train.step import (batch_to, loss_and_grads,
                                        shard_state, working_copy)
    cfg = _cfg(case, "port")
    n = CASES[case][3]
    stem = _stem(case)
    whole = state_from_flat(init_state(cfg, 0, "cpu"),
                            _load(work, f"state_{stem}.npz"))
    state = shard_state(whole, ctx)
    batch = batch_to(_load(work, f"batch_{stem}.npz"), torch.device("cpu"))
    tcfg = _port_train(n)
    if n == 1:
        work_p = working_copy(cfg, tcfg, state["params"])
        loss, _, grads = loss_and_grads(cfg, work_p, batch, ctx)
        arrays[f"{case}/grad_loss"] = loss.numpy()
        for k, v in state_to_flat(tree_unflatten(state["params"],
                                                 grads)).items():
            arrays[f"{case}/grad/{k}"] = v
        del work_p
    held = [sum(x.numel() * x.element_size() for _, x in _items(tree))
            for tree in (state["params"], state["opt"]["m"],
                         state["opt"]["v"])]
    arrays[f"{case}/bytes"] = np.asarray(
        held + [bytes_per_device(param_shapes(cfg), mesh)])
    state, metrics = make_train_step(cfg, tcfg, mesh)(state, batch)
    for k, v in metrics.items():
        arrays[f"{case}/metric/{k}"] = v.numpy()
    for k, v in state_to_flat(state).items():
        arrays[f"{case}/state/{k}"] = v
    checks[f"{case}/specs"] = _specs_by_key(cfg, mesh)


def _backward_sums(rank, world, ctx):
    """``tp.enter``'s backward adds the ranks' bfloat16 partial gradients
    in float32 in rank order and casts once; ``gather_cat``'s backward
    is the rank's slice; ``all_to_all``'s the inverse exchange."""
    from repro_torch.models import tp
    rows = ([1.0, 256.0, -256.0, 3.0], [2.0 ** -8, 1.0, -1.0, 1e4])
    parts = [torch.tensor(rows[r % 2] * 3, dtype=torch.bfloat16)
             for r in range(world)]
    want = parts[0].float()
    for p in parts[1:]:
        want = want + p.float()
    x = torch.zeros(12, dtype=torch.bfloat16, requires_grad=True)
    (tp.enter(x, ctx) * parts[rank]).sum().backward()
    bad = []
    if not torch.equal(x.grad, want.to(torch.bfloat16)):
        bad.append(f"enter: {x.grad} != {want}")
    y = torch.arange(3.0, requires_grad=True)
    w = torch.arange(3.0 * world) + 1.0
    (tp.gather_cat(y, 0, ctx) * w).sum().backward()
    if not torch.equal(y.grad, w[3 * rank:3 * rank + 3]):
        bad.append(f"gather_cat: {y.grad}")
    z = (torch.arange(world * 2.0) + 10 * rank).requires_grad_()
    out = tp.all_to_all(z.view(world, 2), ctx)
    c = torch.arange(world * 2.0).view(world, 2) + 100 * rank
    (out * c).sum().backward()
    # z's block j went to rank j, which weighed it by its c's row `rank`
    want_z = torch.cat([torch.arange(2.0) + 2 * rank + 100 * j
                        for j in range(world)])
    if not torch.equal(z.grad, want_z):
        bad.append(f"all_to_all: {z.grad} != {want_z}")
    return "; ".join(bad) or "ok"


def _checkpoints(rank, mesh, work):
    """mamba2 at T = 2 by ``Trainer(..., mesh=)``: the uninterrupted run
    (rank 0 writes its checkpoints), then a run resumed from the P = 1
    run's step-2 checkpoint."""
    import torch.distributed as dist
    run = os.path.join(work, "ckpt_t2")
    losses = _trainer_losses(run, mesh)
    resumed = os.path.join(work, "ckpt_t2_from_p1")
    if rank == 0:
        _copy_ckpt(os.path.join(work, "ckpt_p1"), resumed, CKPT_AT)
    dist.barrier()
    again = _trainer_losses(resumed, mesh, ckpt_every=0)
    logged = []
    if rank == 0:
        with open(os.path.join(run, "metrics.jsonl")) as f:
            logged = [json.loads(line)["step"] for line in f]
    return {"losses": losses, "resumed": again, "logged": logged}


def _copy_ckpt(run, dst_run, at):
    src = os.path.join(run, "ckpt", f"step_{at:09d}")
    dst = os.path.join(dst_run, "ckpt", f"step_{at:09d}")
    shutil.copytree(src, dst)


def _card_steps(rank):
    """``chip_smoke.tp_train`` on the CPU at smoke size: its gates at
    the float32 tolerances, and (rank 0) its P = 1 yardstick."""
    import chip_smoke
    from repro_torch.configs import get_smoke_config
    out = {}
    for tag, (arch, fields, seq) in CARD_CASES.items():
        cfg = _narrowed(get_smoke_config(arch), fields)
        spec = dict(chip_smoke.TP_TRAIN_SPECS[tag], seq=seq)
        rec, _ = chip_smoke.tp_train(cfg, 0, torch.device("cpu"), spec)
        out[f"card/{tag}"] = rec
    return out


# --- the reference on a (1, T) mesh (a subprocess) -------------------------

def _reference_main(work, world):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.compat import set_mesh
    from repro.models.model import loss_fn
    from repro.models.shardrules import make_ctx, tree_shardings
    from repro.train import TrainConfig
    from repro.train import optim as ref_optim
    from repro.train.checkpoint import _flatten
    from repro.train.step import jit_train_step

    mesh = Mesh(np.asarray(jax.devices()[:world]).reshape(1, world),
                ("data", "model"))
    ctx = make_ctx(mesh)
    out = {}
    with set_mesh(mesh):
        for case, (_, t, _, n, *_) in CASES.items():
            if t != world:
                continue
            cfg = _cfg(case, "reference")
            stem = _stem(case)
            state = jax.tree.map(jnp.asarray, _nested(_load(
                work, f"state_{stem}.npz")))
            batch = {k: jnp.asarray(v) for k, v in
                     _load(work, f"batch_{stem}.npz").items()}
            if n == 1:
                placed = jax.device_put(state["params"], tree_shardings(
                    state["params"], mesh))
                (loss, _), grads = jax.jit(jax.value_and_grad(
                    lambda p, b, cfg=cfg: loss_fn(cfg, p, b, ctx),
                    has_aux=True))(placed, batch)
                out[f"{case}/grad_loss"] = np.asarray(loss)
                for k, v in _flatten(grads).items():
                    out[f"{case}/grad/{k}"] = np.asarray(v)
            tcfg = TrainConfig(optim=ref_optim.AdamWConfig(**OPTIM),
                               grad_accum=n)
            step = jit_train_step(cfg, tcfg, mesh, state, batch)
            new, metrics = step(state, batch)
            for k, v in metrics.items():
                out[f"{case}/metric/{k}"] = np.asarray(v)
            for k, v in _flatten(new).items():
                out[f"{case}/state/{k}"] = np.asarray(v)
    np.savez(os.path.join(work, f"reference_t{world}.npz"), **out)


# --- the fixture ------------------------------------------------------------

def _write_inputs(work):
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.models.convert import state_to_flat
    from repro_torch.train import init_state
    for case in CASES:
        i = list(CASES).index(SAME_INPUTS.get(case, case))
        cfg = _cfg(case, "port")
        _, _, _, _, b, s = CASES[case]
        np.savez(os.path.join(work, f"state_{_stem(case)}.npz"),
                 **state_to_flat(init_state(cfg, i, "cpu")))
        np.savez(os.path.join(work, f"batch_{_stem(case)}.npz"),
                 **make_batch(cfg, DataConfig(batch=b, seq=s, seed=3 + i),
                              0))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both rank groups and the reference, started together (the P = 1
    checkpointed run first: the T = 2 group resumes from it); returns
    every rank's arrays and checks, the reference's arrays and the
    work directory."""
    work = str(tmp_path_factory.mktemp("tp_train"))
    _write_inputs(work)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        p1 = _trainer_losses(os.path.join(work, "ckpt_p1"))
    finally:
        torch.set_num_threads(n)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([SRC, HERE]),
           "JAX_PLATFORMS": "cpu"}
    procs = [(f"reference t{world}", subprocess.Popen(
        [sys.executable, __file__, "reference", work, str(world)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for world in WORLDS]
    for world in WORLDS:
        port_no = _free_port()
        for rank in range(world):
            procs.append((f"t{world} rank {rank}", subprocess.Popen(
                [sys.executable, __file__, "rank", str(rank), str(world),
                 str(port_no), work], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
    deadline = time.monotonic() + 7 * GROUP_TIMEOUT_S
    failed = []
    for name, p in procs:
        try:
            _, err = p.communicate(
                timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
            failed.append(f"{name}: timed out\n{err[-3000:]}")
            continue
        if p.returncode != 0:
            failed.append(f"{name}: exit {p.returncode}\n{err[-3000:]}")
    assert not failed, "\n".join(failed)
    arrays, checks, reference = {}, {}, {}
    for world in WORLDS:
        reference.update(_load(work, f"reference_t{world}.npz"))
        for rank in range(world):
            stem = os.path.join(work, f"t{world}_rank{rank}")
            arrays[world, rank] = dict(np.load(stem + ".npz"))
            with open(stem + ".json") as f:
                checks[world, rank] = json.load(f)
    return arrays, checks, reference, work, p1


def _close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _spec_of(specs, key):
    """A state key's held spec (``params/``, ``opt/m/``, ``opt/v/`` keys
    take their leaf's; ``step`` is whole)."""
    for prefix in ("params/", "opt/m/", "opt/v/"):
        if key.startswith(prefix):
            return specs[key[len(prefix):]]
    return specs.get(key, [])


def _whole(spec):
    return not any(spec)


# --- the tests --------------------------------------------------------------

def _grad_cases():
    return [c for c in CASES if CASES[c][3] == 1]


@pytest.mark.parametrize("case", _grad_cases())
def test_loss_and_gradient_blocks_match_reference_mesh(runs, case):
    arrays, checks, ref, _, _ = runs
    world = CASES[case][1]
    specs = checks[world, 0][f"{case}/specs"]
    keys = [k for k in ref if k.startswith(f"{case}/grad/")]
    assert len(keys) == len(specs)
    for rank in range(world):
        got = arrays[world, rank]
        _close(got[f"{case}/grad_loss"], ref[f"{case}/grad_loss"])
        for key in keys:
            leaf = key[len(f"{case}/grad/"):]
            _close(got[key], _slice(ref[key], specs[leaf], rank, world))


@pytest.mark.parametrize("case", list(CASES))
def test_one_step_matches_reference_mesh(runs, case):
    """loss, ce, grad_norm and lr, then the rank's blocks of the
    parameters and of both moments after the step."""
    arrays, checks, ref, _, _ = runs
    world = CASES[case][1]
    specs = checks[world, 0][f"{case}/specs"]
    prefix = f"{case}/state/"
    keys = [k for k in ref if k.startswith(prefix)]
    assert keys and sorted(keys) == sorted(
        k for k in arrays[world, 0] if k.startswith(prefix))
    for rank in range(world):
        got = arrays[world, rank]
        for k in ("loss", "ce", "grad_norm", "lr"):
            _close(got[f"{case}/metric/{k}"], ref[f"{case}/metric/{k}"])
        for key in keys:
            leaf = key[len(prefix):]
            want = _slice(ref[key], _spec_of(specs, leaf), rank, world)
            if leaf.startswith("params/"):
                _close(got[key], want, rtol=0, atol=2e-6)
            elif leaf.startswith("opt/m/"):
                _close(got[key], want, atol=1e-7)
            elif leaf.startswith("opt/v/"):
                _close(got[key], want, rtol=2e-4, atol=1e-12)
            else:
                np.testing.assert_array_equal(got[key], want)


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_whole_leaves_bit_equal(runs, case):
    """Every rank's loss, metrics, whole leaves' gradients and updated
    whole leaves (parameters and moments) equal rank 0's bit for bit."""
    arrays, checks, _, _, _ = runs
    world = CASES[case][1]
    specs = checks[world, 0][f"{case}/specs"]
    base = arrays[world, 0]
    n = 0
    for key in base:
        if not key.startswith(f"{case}/"):
            continue
        rest = key[len(f"{case}/"):]
        kind, _, leaf = rest.partition("/")
        if kind in ("grad", "state") and not _whole(_spec_of(specs, leaf)):
            continue
        for rank in range(1, world):
            np.testing.assert_array_equal(arrays[world, rank][key],
                                          base[key], err_msg=key)
        n += 1
    assert n > 10


@pytest.mark.parametrize("case", list(CASES))
def test_rank_holds_its_bytes_of_weights_and_moments(runs, case):
    arrays, _, _, _, _ = runs
    world = CASES[case][1]
    for rank in range(world):
        params, m, v, want = arrays[world, rank][f"{case}/bytes"]
        assert params == m == v == want > 0


@pytest.mark.parametrize("world", WORLDS)
def test_backward_sums_are_float32_adds_in_rank_order(runs, world):
    _, checks, _, _, _ = runs
    for rank in range(world):
        assert checks[world, rank]["backward_sums"] == "ok"


def test_trainer_on_the_mesh_gives_one_rank_losses_and_checkpoint(runs):
    """T = 2 against P = 1: the losses, and the step-4 checkpoint file
    (the same keys and shapes; the values at the step tolerances)."""
    _, checks, _, work, p1 = runs
    t2 = [checks[2, r]["checkpoint"] for r in range(2)]
    assert t2[0]["losses"] == t2[1]["losses"]
    _close(t2[0]["losses"], p1)
    assert t2[0]["logged"] == list(range(CKPT_STEPS))
    name = os.path.join("ckpt", f"step_{CKPT_STEPS:09d}", "arrays.npz")
    got = _load(os.path.join(work, "ckpt_t2"), name)
    want = _load(os.path.join(work, "ckpt_p1"), name)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        if k.startswith("params/"):
            _close(got[k], w, rtol=1e-4, atol=1e-5)
        elif k == "step":
            np.testing.assert_array_equal(got[k], w)


def test_checkpoint_at_t2_resumes_at_p1_and_back(runs, tmp_path):
    """The T = 2 run's step-2 checkpoint resumed at P = 1, and the P = 1
    run's resumed at T = 2, give the uninterrupted runs' later losses."""
    _, checks, _, work, p1 = runs
    t2 = checks[2, 0]["checkpoint"]
    _close(t2["resumed"], p1[CKPT_AT:])
    _copy_ckpt(os.path.join(work, "ckpt_t2"), str(tmp_path), CKPT_AT)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        again = _trainer_losses(str(tmp_path), ckpt_every=0)
    finally:
        torch.set_num_threads(n)
    _close(again, t2["losses"][CKPT_AT:])


@pytest.mark.parametrize("world", WORLDS)
def test_state_specs_match_reference(world):
    """``state_specs`` equals the reference's on the smoke states of four
    families at (1, T): the parameters' and both moments' specs by the
    rules, the step whole."""
    import jax
    from jax.sharding import AbstractMesh

    from repro.train.step import state_specs as ref_state_specs
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.mesh import Mesh
    from repro_torch.models.convert import state_to_flat
    from repro_torch.models.shardrules import _items
    from repro_torch.train import init_state
    from repro_torch.train.step import state_specs
    from test_torch_tp import _flat_specs

    def norm(entry):
        if entry is None:
            return None
        return (entry,) if isinstance(entry, str) else tuple(entry)
    port_mesh = Mesh(("data", "model"), {"data": 1, "model": world})
    ref_mesh = AbstractMesh((1, world), ("data", "model"))
    for arch in ("stablelm-3b", "mamba2-370m", GRANITE, DEEPSEEK):
        state = init_state(get_smoke_config(arch), 0, "cpu")
        shapes = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape,
                                                             a.dtype),
                              _nested(state_to_flat(state)))
        want = {k: tuple(norm(e) for e in v) for k, v in
                _flat_specs(ref_state_specs(shapes, ref_mesh)).items()}
        got = dict(_items(state_specs(state, port_mesh)))
        seen = set()
        for path, spec in got.items():
            parts = path.split("/")
            if "segments" in parts:        # the reference's stacked leaf
                i = parts.index("segments")
                path = "/".join(parts[:i + 2] + parts[i + 3:])
                spec = (None,) + tuple(spec) if spec else spec
            assert tuple(spec) == want[path], (arch, path, spec)
            seen.add(path)
        assert seen == set(want), arch


@pytest.mark.parametrize("tag", list(CARD_CASES))
def test_chip_smoke_tp_train_step_computes_the_mesh_function(runs, tag):
    """``chip_smoke.py``'s tp-train step on the CPU at T = 4: every
    rank's losses, grad norms and whole leaves bit-equal, its bytes
    ``bytes_per_device``; rank 0's P = 1 yardstick gives each step's
    loss within 1e-4 and every gradient block a cosine of at least
    1 - 1e-6."""
    _, checks, _, _, _ = runs
    recs = [checks[4, r][f"card/{tag}"] for r in range(4)]
    for rec in recs:
        assert rec["bytes"][0] == rec["bytes"][1] > 0
        assert rec["moment_bytes"] == 2 * rec["bytes"][1]
        for k in ("losses", "grad_norms", "digest"):
            assert rec[k] == recs[0][k], k
        assert rec["finite"]
    y = recs[0]["yardstick"]
    assert len(y["losses"]) == len(recs[0]["losses"]) == 3
    _close(recs[0]["losses"], y["losses"], rtol=0, atol=1e-4)
    assert min(c for c, _ in y["cosines"]) > 1 - 1e-6, y["cosines"]
    assert len(y["cosines"]) == 4


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, ".."))
    if sys.argv[1] == "reference":
        _reference_main(sys.argv[2], int(sys.argv[3]))
    else:
        _rank_main(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                   sys.argv[5])
