"""Training on a mesh with a data axis, on gloo on the CPU, against the
JAX package's jitted train step on its ``("data", "model")`` meshes of
(2, 2) and (4, 1).

Built as ``tests/test_torch_tp_train.py`` is, with one group as
``tests/test_torch_tp_data.py`` has: four rank processes run this file
(``python tests/test_torch_dp_train.py rank <rank> <port> <dir>``) in one
gloo group with a 60 s group timeout, under a subprocess timeout, and
train on both meshes of its 4 ranks, ``make_host_mesh(model=2)`` and
``make_host_mesh(model=1)``; the reference runs once for each mesh
(``python tests/test_torch_dp_train.py reference <dir> <mesh>``) on 4
fake devices: ``jit_train_step`` (``jax.jit(make_train_step(cfg, tcfg,
mesh))`` with the state placed by ``state_specs`` and the batch by
``batch_specs``) and the jitted gradient of ``loss_fn(..., ctx)``. All
six start together; the initial states (the port's ``init_state``, in
the reference's layout) and the global batches (the data pipeline) come
from this process as numpy. Every rank is handed the global batch, and
the step takes the data rank's rows of each microbatch.

- Cases: the smoke configs of stablelm-3b (dense FFN) at (2, 2) and (4,
  1), mamba2-370m (SSM, vocab-parallel CE at T = 2), granite-moe-1b-a400m
  at (2, 2) (``ep``) and at (4, 1) (``local``: every data rank routes
  the whole batch, ``rows_gather`` / ``rows_take``), granite with
  grad_accum 2 (each data rank's rows of each global microbatch), granite
  with B = 1 at (2, 2) (the batch whole on every data rank; against the
  reference's (1, 2) mesh, whose ``ep`` body refuses a batch the data
  axis does not divide), deepseek-v2-236b (MLA, shared experts) and
  hymba-1.5b (FSDP gathers of its meta tokens and hybrid layers, its 5
  query heads and 1 KV head whole at T = 2) at (2, 2). Each rank's loss,
  every gradient block, ``grad_norm``, and after one step its blocks of
  the parameters and both moments against the same block of the
  reference's, at ``tests/test_torch_train.py``'s
  tolerances; every rank's whole leaves' gradients, updated leaves, loss
  and ``grad_norm`` bit-equal to rank 0's, and the data ranks' copies of
  each block cut over ``model`` alone bit-equal; a rank's parameter and
  moment bytes equal to ``bytes_per_device``.
- The backward's sums over ``data`` (``gather_many``'s reduce-scatter,
  ``rows_gather``'s, ``sum_many``) are float32 adds in data order, cast
  once, bit for bit, and ``once`` divides the gradient by D.
- Checkpoints: mamba2 trained by ``Trainer(..., mesh=)`` at (2, 2) gives
  the one-rank run's losses, and its checkpoint the one-rank run's file
  (keys, shapes, values); a run checkpointed at (2, 2) resumes at P = 1,
  and one checkpointed at P = 1 resumes at (4, 1), with the
  uninterrupted runs' losses; rank 0 alone writes ``metrics.jsonl``.
- ``chip_smoke.py``'s dp-train step, run on the CPU at smoke size at (2,
  2): its P = 1 yardstick reproduces the mesh run's losses and
  gradients.
- ``state_specs`` equals the reference's at (2, 2) and (4, 1).

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

from test_torch_tp import GROUP_TIMEOUT_S, SRC, _free_port, _nested
from test_torch_tp_train import (OPTIM, _close, _port_train, _spec_of,
                                 _specs_by_key)

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 4
GRANITE, DEEPSEEK = "granite-moe-1b-a400m", "deepseek-v2-236b"
# mesh name: (data, model)
MESHES = {"2x2": (2, 2), "4x1": (4, 1)}
# name: (arch, mesh, grad accumulation, batch, sequence, the reference's
# mesh where it is another)
CASES = {
    "stablelm/2x2": ("stablelm-3b", "2x2", 1, 2, 24, None),
    "stablelm/4x1": ("stablelm-3b", "4x1", 1, 4, 24, None),
    "mamba2/2x2": ("mamba2-370m", "2x2", 1, 2, 24, None),
    "granite/2x2": (GRANITE, "2x2", 1, 2, 24, None),
    "granite/4x1": (GRANITE, "4x1", 1, 4, 24, None),
    "granite-accum2/2x2": (GRANITE, "2x2", 2, 4, 24, None),
    "granite-b1/2x2": (GRANITE, "2x2", 1, 1, 24, (1, 2)),
    "deepseek/2x2": (DEEPSEEK, "2x2", 1, 2, 24, None),
    "hymba/2x2": ("hymba-1.5b", "2x2", 1, 2, 24, None),
}
CKPT_ARCH, CKPT_STEPS, CKPT_AT = "mamba2-370m", 4, 2
# chip_smoke.py's dp-train step at smoke size: (arch, sequence)
CARD_TAG, CARD_SEQ = "dp-train-granite", 24


def _cfg(case, package):
    if package == "port":
        from repro_torch.configs import get_smoke_config
    else:
        from repro.configs import get_smoke_config
    return get_smoke_config(CASES[case][0])


def _stem(case):
    return case.replace("/", "_")


def _load(work, name):
    return dict(np.load(os.path.join(work, name)))


def _block(a, spec, rank, shape):
    """Rank's block of a whole array ``a`` on a (data, model) mesh of
    ``shape`` under a port spec (JSON lists of axis names)."""
    d, t = shape
    for dim, entry in enumerate(spec):
        for axis, i, n in (("data", rank // t, d), ("model", rank % t, t)):
            if entry and axis in entry:
                size = a.shape[dim] // n
                a = np.take(a, np.arange(i * size, (i + 1) * size), axis=dim)
    return a


def _run_cfgs(workdir, steps, ckpt_every):
    from repro_torch.data import DataConfig
    from repro_torch.train import RunConfig
    return (DataConfig(batch=4, seq=24, seed=5),
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


def _copy_ckpt(run, dst_run, at):
    shutil.copytree(os.path.join(run, "ckpt", f"step_{at:09d}"),
                    os.path.join(dst_run, "ckpt", f"step_{at:09d}"))


# --- the rank processes -----------------------------------------------------

def _rank_main(rank, port_no, work):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port_no}", rank=rank,
        world_size=WORLD,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    arrays, checks = {}, {}
    meshes = {name: make_host_mesh(model=t) for name, (_, t) in
              MESHES.items()}
    for case, (_, name, *_) in CASES.items():
        _train_case(case, meshes[name], work, arrays, checks)
    for name, mesh in meshes.items():
        checks[f"sums/{name}"] = _data_sums(rank, mesh)
    checks["checkpoint"] = _checkpoints(rank, meshes, work)
    checks["card"] = _card_step()
    np.savez(os.path.join(work, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(checks, f)
    dist.destroy_process_group()


def _train_case(case, mesh, work, arrays, checks):
    from repro_torch.models.convert import state_from_flat, state_to_flat
    from repro_torch.models.model import param_shapes
    from repro_torch.models.shardrules import (_items, bytes_per_device,
                                               make_ctx)
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train.optim import tree_unflatten
    from repro_torch.train.step import (batch_grads, batch_to, shard_state,
                                        split_leaves, working_copy)
    cfg = _cfg(case, "port")
    n = CASES[case][2]
    stem = _stem(case)
    ctx = make_ctx(mesh)
    whole = state_from_flat(init_state(cfg, 0, "cpu"),
                            _load(work, f"state_{stem}.npz"))
    state = shard_state(whole, ctx)
    batch = batch_to(_load(work, f"batch_{stem}.npz"), torch.device("cpu"))
    tcfg = _port_train(n)
    if n == 1:
        work_p = working_copy(cfg, tcfg, state["params"])
        loss, _, grads = batch_grads(cfg, work_p, batch, ctx,
                                     split_leaves(cfg, mesh))
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


def _data_sums(rank, mesh):
    """``gather_many``'s backward (the reduce-scatter) and ``sum_many``
    add the data ranks' bfloat16 gradients in float32 in data order and
    cast once; ``rows_gather``'s backward adds the data ranks' whole
    gradients and keeps the rank's rows; ``once`` divides by D."""
    from repro_torch.models import tp
    from repro_torch.models.shardrules import make_ctx
    ctx = make_ctx(mesh)
    d, r = ctx.data_size, ctx.data_rank
    rows = ([1.0, 256.0, -256.0, 3.0], [2.0 ** -8, 1.0, -1.0, 1e4])
    parts = [torch.tensor(rows[j % 2] * 3 * d, dtype=torch.bfloat16)
             for j in range(d)]
    want = parts[0].float()
    for p in parts[1:]:
        want = want + p.float()
    want = want.to(torch.bfloat16)
    bad = []
    # a leaf cut along dim 1, and a float32 one along dim 0, gathered by
    # one call; each data rank's gradient of the whole leaves is its part
    x = torch.zeros(2, 6, dtype=torch.bfloat16, requires_grad=True)
    y = torch.arange(3.0, requires_grad=True)
    gx, gy = tp.gather_many([(x, 1), (y, 0)], ctx)
    w = (torch.arange(3.0 * d) + 1.0) * (r + 1)
    ((gx * parts[r].view(2, 6 * d)).float().sum() + (gy * w).sum()
     ).backward()
    if not torch.equal(x.grad, want.view(2, 6 * d)[:, 6 * r:6 * r + 6]):
        bad.append(f"gather_many: {x.grad}")
    want_y = sum((torch.arange(3.0 * d) + 1.0) * (j + 1) for j in range(d))
    if not torch.equal(y.grad, want_y[3 * r:3 * r + 3]):
        bad.append(f"gather_many float32: {y.grad} != {want_y}")
    got = tp.sum_many([parts[r]], ctx, "data")[0]
    if got.dtype != torch.bfloat16 or not torch.equal(got, want):
        bad.append(f"sum_many: {got} != {want}")
    z = torch.full((1, 2), float(r + 1), requires_grad=True)
    whole = tp.rows_gather(z, ctx)
    (whole * (torch.arange(2.0 * d).view(d, 2) + 1)).sum().backward()
    want_z = d * (torch.arange(2.0 * d).view(d, 2) + 1)[r:r + 1]
    if not torch.equal(z.grad, want_z):
        bad.append(f"rows_gather: {z.grad} != {want_z}")
    u = torch.ones((), requires_grad=True)
    tp.once(u * 3.0, ctx).backward()
    if float(u.grad) != 3.0 / d:
        bad.append(f"once: {u.grad}")
    return "; ".join(bad) or "ok"


def _checkpoints(rank, meshes, work):
    """mamba2 by ``Trainer(..., mesh=)``: the uninterrupted run at (2, 2)
    (rank 0 writes its checkpoints), then a run at (4, 1) resumed from
    the P = 1 run's step-2 checkpoint."""
    import torch.distributed as dist
    run = os.path.join(work, "ckpt_2x2")
    losses = _trainer_losses(run, meshes["2x2"])
    resumed = os.path.join(work, "ckpt_4x1_from_p1")
    if rank == 0:
        _copy_ckpt(os.path.join(work, "ckpt_p1"), resumed, CKPT_AT)
    dist.barrier()
    again = _trainer_losses(resumed, meshes["4x1"], ckpt_every=0)
    logged = []
    if rank == 0:
        with open(os.path.join(run, "metrics.jsonl")) as f:
            logged = [json.loads(line)["step"] for line in f]
    return {"losses": losses, "resumed": again, "logged": logged}


def _card_step():
    """``chip_smoke.tp_train`` with the dp-train step's spec on the CPU
    at granite's smoke config: its gates at the float32 tolerances and
    (rank 0) its P = 1 yardstick."""
    import chip_smoke
    from repro_torch.configs import get_smoke_config
    spec = dict(chip_smoke.TP_TRAIN_SPECS[CARD_TAG], seq=CARD_SEQ)
    rec, _ = chip_smoke.tp_train(get_smoke_config(GRANITE), 0,
                                 torch.device("cpu"), spec)
    return rec


# --- the reference on each mesh (a subprocess) ------------------------------

def _reference_main(work, name):
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

    out = {}
    for case, (_, m, n, _, _, ref_shape) in CASES.items():
        if m != name:
            continue
        shape = ref_shape or MESHES[m]
        mesh = Mesh(np.asarray(jax.devices()[:shape[0] * shape[1]]).reshape(
            shape), ("data", "model"))
        ctx = make_ctx(mesh)
        cfg = _cfg(case, "reference")
        stem = _stem(case)
        state = jax.tree.map(jnp.asarray, _nested(_load(
            work, f"state_{stem}.npz")))
        batch = {k: jnp.asarray(v) for k, v in
                 _load(work, f"batch_{stem}.npz").items()}
        with set_mesh(mesh):
            if n == 1:
                placed = jax.device_put(state["params"], tree_shardings(
                    state["params"], mesh))
                (loss, _), grads = jax.jit(jax.value_and_grad(
                    lambda p, b, cfg=cfg, ctx=ctx: loss_fn(cfg, p, b, ctx),
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
    np.savez(os.path.join(work, f"reference_{name}.npz"), **out)


# --- the fixture ------------------------------------------------------------

def _write_inputs(work):
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.models.convert import state_to_flat
    from repro_torch.train import init_state
    for i, case in enumerate(CASES):
        cfg = _cfg(case, "port")
        _, _, _, b, s, _ = CASES[case]
        np.savez(os.path.join(work, f"state_{_stem(case)}.npz"),
                 **state_to_flat(init_state(cfg, i, "cpu")))
        np.savez(os.path.join(work, f"batch_{_stem(case)}.npz"),
                 **make_batch(cfg, DataConfig(batch=b, seq=s, seed=3 + i),
                              0))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The rank group and both references, started together (the P = 1
    checkpointed run first: the (4, 1) run resumes from it); returns
    every rank's arrays and checks, the reference's arrays, the work
    directory and the P = 1 run's losses."""
    work = str(tmp_path_factory.mktemp("dp_train"))
    _write_inputs(work)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        p1 = _trainer_losses(os.path.join(work, "ckpt_p1"))
    finally:
        torch.set_num_threads(n)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([SRC, HERE]),
           "JAX_PLATFORMS": "cpu"}
    procs = [(f"reference {name}", subprocess.Popen(
        [sys.executable, __file__, "reference", work, name], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for name in MESHES]
    port_no = _free_port()
    for rank in range(WORLD):
        procs.append((f"rank {rank}", subprocess.Popen(
            [sys.executable, __file__, "rank", str(rank), str(port_no),
             work], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
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
    reference = {}
    for name in MESHES:
        reference.update(_load(work, f"reference_{name}.npz"))
    arrays, checks = {}, {}
    for rank in range(WORLD):
        stem = os.path.join(work, f"rank{rank}")
        arrays[rank] = dict(np.load(stem + ".npz"))
        with open(stem + ".json") as f:
            checks[rank] = json.load(f)
    return arrays, checks, reference, work, p1


# --- the tests --------------------------------------------------------------

def _shape(case):
    return MESHES[CASES[case][1]]


def _grad_cases():
    return [c for c in CASES if CASES[c][2] == 1]


@pytest.mark.parametrize("case", _grad_cases())
def test_loss_and_gradient_blocks_match_reference_mesh(runs, case):
    arrays, checks, ref, _, _ = runs
    specs = checks[0][f"{case}/specs"]
    keys = [k for k in ref if k.startswith(f"{case}/grad/")]
    assert len(keys) == len(specs)
    for rank in range(WORLD):
        got = arrays[rank]
        _close(got[f"{case}/grad_loss"], ref[f"{case}/grad_loss"])
        for key in keys:
            leaf = key[len(f"{case}/grad/"):]
            _close(got[key], _block(ref[key], specs[leaf], rank,
                                    _shape(case)))


@pytest.mark.parametrize("case", list(CASES))
def test_one_step_matches_reference_mesh(runs, case):
    """loss, ce, grad_norm and lr, then the rank's blocks of the
    parameters and of both moments after the step."""
    arrays, checks, ref, _, _ = runs
    specs = checks[0][f"{case}/specs"]
    prefix = f"{case}/state/"
    keys = [k for k in ref if k.startswith(prefix)]
    assert keys and sorted(keys) == sorted(
        k for k in arrays[0] if k.startswith(prefix))
    for rank in range(WORLD):
        got = arrays[rank]
        for k in ("loss", "ce", "grad_norm", "lr"):
            _close(got[f"{case}/metric/{k}"], ref[f"{case}/metric/{k}"])
        for key in keys:
            leaf = key[len(prefix):]
            want = _block(ref[key], _spec_of(specs, leaf), rank,
                          _shape(case))
            if leaf.startswith("params/"):
                _close(got[key], want, rtol=0, atol=2e-6)
            elif leaf.startswith("opt/m/"):
                _close(got[key], want, atol=1e-7)
            elif leaf.startswith("opt/v/"):
                _close(got[key], want, rtol=2e-4, atol=1e-12)
            else:
                np.testing.assert_array_equal(got[key], want)


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_whole_leaves_and_model_blocks_bit_equal(runs, case):
    """Every rank's loss, metrics, whole leaves' gradients and updated
    whole leaves (parameters and moments) equal rank 0's bit for bit,
    and every data rank's gradient and updated block of a leaf cut over
    ``model`` alone equal data rank 0's."""
    arrays, checks, _, _, _ = runs
    specs = checks[0][f"{case}/specs"]
    t = _shape(case)[1]
    n_whole = 0
    for key in arrays[0]:
        if not key.startswith(f"{case}/"):
            continue
        rest = key[len(f"{case}/"):]
        kind, _, leaf = rest.partition("/")
        spec = _spec_of(specs, leaf) if kind in ("grad", "state") else []
        axes = {a for e in spec if e for a in e}
        if kind in ("grad", "state") and axes == {"model"}:
            for rank in range(t, WORLD):
                np.testing.assert_array_equal(
                    arrays[rank][key], arrays[rank % t][key], err_msg=key)
        elif not axes:
            for rank in range(1, WORLD):
                np.testing.assert_array_equal(arrays[rank][key],
                                              arrays[0][key], err_msg=key)
            n_whole += 1
    assert n_whole > 10


@pytest.mark.parametrize("case", list(CASES))
def test_rank_holds_its_bytes_of_weights_and_moments(runs, case):
    arrays, _, _, _, _ = runs
    for rank in range(WORLD):
        params, m, v, want = arrays[rank][f"{case}/bytes"]
        assert params == m == v == want > 0


@pytest.mark.parametrize("mesh", list(MESHES))
def test_backward_data_sums_are_float32_adds_in_data_order(runs, mesh):
    _, checks, _, _, _ = runs
    for rank in range(WORLD):
        assert checks[rank][f"sums/{mesh}"] == "ok"


def test_trainer_on_2x2_gives_one_rank_losses_and_checkpoint(runs):
    """(2, 2) against P = 1: the losses, and the step-4 checkpoint file
    (the same keys, shapes and types; the values at the step
    tolerances)."""
    _, checks, _, work, p1 = runs
    runs_ = [checks[r]["checkpoint"] for r in range(WORLD)]
    for r in range(1, WORLD):
        assert runs_[r]["losses"] == runs_[0]["losses"]
    _close(runs_[0]["losses"], p1)
    assert runs_[0]["logged"] == list(range(CKPT_STEPS))
    name = os.path.join("ckpt", f"step_{CKPT_STEPS:09d}", "arrays.npz")
    got = _load(os.path.join(work, "ckpt_2x2"), name)
    want = _load(os.path.join(work, "ckpt_p1"), name)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        if k.startswith("params/"):
            _close(got[k], w, rtol=1e-4, atol=1e-5)
        elif k == "step":
            np.testing.assert_array_equal(got[k], w)


def test_checkpoint_on_2x2_resumes_at_p1_and_p1_on_4x1(runs, tmp_path):
    """The (2, 2) run's step-2 checkpoint resumed at P = 1, and the P = 1
    run's resumed at (4, 1), give the uninterrupted runs' later
    losses."""
    _, checks, _, work, p1 = runs
    for r in range(WORLD):
        _close(checks[r]["checkpoint"]["resumed"], p1[CKPT_AT:])
    _copy_ckpt(os.path.join(work, "ckpt_2x2"), str(tmp_path), CKPT_AT)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        again = _trainer_losses(str(tmp_path), ckpt_every=0)
    finally:
        torch.set_num_threads(n)
    _close(again, checks[0]["checkpoint"]["losses"][CKPT_AT:])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_state_specs_match_reference(mesh):
    """``state_specs`` equals the reference's on the smoke states of four
    families at (2, 2) and (4, 1)."""
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
    shape = MESHES[mesh]
    port_mesh = Mesh(("data", "model"), dict(zip(("data", "model"), shape)))
    ref_mesh = AbstractMesh(shape, ("data", "model"))
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


def test_chip_smoke_dp_train_step_computes_the_mesh_function(runs):
    """``chip_smoke.py``'s dp-train step on the CPU at (2, 2): every
    rank's losses, grad norms and whole leaves bit-equal, the data
    ranks' copies of each model block too, its bytes
    ``bytes_per_device``; rank 0's P = 1 yardstick gives each step's
    loss within 1e-4 and every gradient block a cosine of at least
    1 - 1e-6."""
    _, checks, _, _, _ = runs
    recs = [checks[r]["card"] for r in range(WORLD)]
    for r, rec in enumerate(recs):
        assert rec["mesh"] == [2, 2]
        assert rec["bytes"][0] == rec["bytes"][1] > 0
        assert rec["moment_bytes"] == 2 * rec["bytes"][1]
        for k in ("losses", "grad_norms", "digest"):
            assert rec[k] == recs[0][k], k
        assert rec["model_digest"] == recs[r % 2]["model_digest"]
        assert rec["finite"]
    y = recs[0]["yardstick"]
    assert len(y["losses"]) == len(recs[0]["losses"]) == 3
    _close(recs[0]["losses"], y["losses"], rtol=0, atol=1e-4)
    assert min(c for c, _ in y["cosines"]) > 1 - 1e-6, y["cosines"]
    assert len(y["cosines"]) == WORLD


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, ".."))
    if sys.argv[1] == "reference":
        _reference_main(sys.argv[2], sys.argv[3])
    else:
        _rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
