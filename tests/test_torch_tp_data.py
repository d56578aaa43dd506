"""Serving on a mesh with a data axis, on gloo on the CPU, against the JAX
package's ``("data", "model")`` meshes of (2, 2) and (4, 1).

Built as ``tests/test_torch_tp_moe.py`` is: four rank processes run this
file (``python tests/test_torch_tp_data.py rank <rank> <port> <dir>``)
in one gloo group with a 60 s group timeout, under a subprocess timeout,
and serve on both meshes of its 4 ranks, ``make_host_mesh(model=2)`` and
``make_host_mesh(model=1)``; the reference runs once for each mesh
(``python tests/test_torch_tp_data.py reference <dir> <mesh>``) on 4
fake devices, its parameters placed by ``tree_shardings`` (or by
``tree_specs(..., inference=True)`` for the weights-stationary cases).
All six start together; the weights (the reference's ``moe_init`` /
``init_params``) and the inputs come from this process as numpy.

Each data rank serves its rows of the batch (all of them where the
requests do not divide over the data ranks), so every array a rank
returns is held against its rows of the reference's.

- Layer: ``moe_forward`` against the reference's jitted layer under
  ``make_ctx(mesh)`` / ``make_ctx(mesh, inference=True)``: out,
  ``aux_loss`` and ``dropped`` within 1e-4, on ``ep`` (also under
  ``inference``, whose tables then come in the stationary layout),
  ``replicated``, the stationary branch (S = 1, S = 9, B = 1, deepseek's
  shared experts) and ``local`` at (4, 1); the branch taken; the ranks
  of one data row bit-equal.
- Model: granite-moe, mamba2 and danube's smoke configs at (2, 2) and
  (4, 1): prefill logits, each rank's cache block, 4 decode steps and
  the engines' tokens; granite's 4 decode steps again under
  ``make_ctx(mesh, inference=True)`` over the inference layout (the
  stationary branch at (2, 2), ``local`` at (4, 1)); B = 1 at (2, 2),
  whose batch is whole on every data rank and whose attention caches'
  length is cut over ``data`` (granite's against the reference's (1, 2)
  mesh: its ``ep`` and ``replicated`` bodies refuse a batch the data axis
  does not divide), and hymba's, whose KV head 2 does not divide either,
  so its length is cut over the whole mesh; the ranks of one data row
  bit-equal, every rank's tokens equal, a rank's bytes in both layouts
  equal to ``bytes_per_device``.
- Collectives: ordered sums over ``data`` and over the whole mesh are
  float32 adds in rank order, bit for bit; training under a context of
  more than one rank, which raised here until it was ported, runs and
  gives every rank the same loss (``tests/test_torch_dp_train.py`` holds
  it against the reference).
- Rules: ``spec_for`` / ``tree_specs(..., inference=)`` equal the
  reference's for every leaf of the ten architectures on (2, 2) and
  (16, 16), ``bytes_per_device`` on (2, 2); ``shard_params`` gives each
  rank of (2, 2) the block the rules place there on both axes.
"""

import datetime
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from test_torch_tp import (GROUP_TIMEOUT_S, SRC, TOL, _close, _flat,
                           _flat_specs, _free_port, _nested, _port_dtypes,
                           _port_shapes, _ref_key, _ref_shapes)

WORLD, NEW = 4, 4
GRANITE, DEEPSEEK = "granite-moe-1b-a400m", "deepseek-v2-236b"
MAMBA2, DANUBE = "mamba2-370m", "h2o-danube-1.8b"
HYMBA = "hymba-1.5b"
# mesh name: (data, model)
MESHES = {"2x2": (2, 2), "4x1": (4, 1)}
# name: (arch, mesh, B, S, inference, the branch moe_forward takes); the
# MoE layer's config is the smoke model's last segment's
LAYER_CASES = {
    "granite-ep/2x2": (GRANITE, "2x2", 2, 12, False, "ep"),
    "granite-ep-inference/2x2": (GRANITE, "2x2", 2, 12, True, "ep"),
    "granite-decode/2x2": (GRANITE, "2x2", 2, 1, False, "replicated"),
    "granite-stationary/2x2": (GRANITE, "2x2", 2, 1, True, "stationary"),
    "granite-stationary-s9/2x2": (GRANITE, "2x2", 2, 9, True, "stationary"),
    "granite-stationary-b1/2x2": (GRANITE, "2x2", 1, 1, True, "stationary"),
    "deepseek-ep/2x2": (DEEPSEEK, "2x2", 2, 32, False, "ep"),
    "deepseek-stationary/2x2": (DEEPSEEK, "2x2", 2, 1, True, "stationary"),
    "granite-local/4x1": (GRANITE, "4x1", 4, 12, False, "local"),
    "granite-local-inference/4x1": (GRANITE, "4x1", 4, 1, True, "local"),
}
# name: (arch, mesh, B, S, the reference's mesh where it is another)
MODEL_CASES = {
    "granite/2x2": (GRANITE, "2x2", 2, 12, None),
    "mamba2/2x2": (MAMBA2, "2x2", 2, 12, None),
    "danube/2x2": (DANUBE, "2x2", 2, 12, None),
    "granite-b1/2x2": (GRANITE, "2x2", 1, 12, (1, 2)),
    "mamba2-b1/2x2": (MAMBA2, "2x2", 1, 12, None),
    "danube-b1/2x2": (DANUBE, "2x2", 1, 12, None),
    "hymba-b1/2x2": (HYMBA, "2x2", 1, 12, None),
    "granite/4x1": (GRANITE, "4x1", 4, 12, None),
    "mamba2/4x1": (MAMBA2, "4x1", 4, 12, None),
    "danube/4x1": (DANUBE, "4x1", 4, 12, None),
}
# the model cases whose decode also runs under make_ctx(mesh,
# inference=True), and the branch its MoE layers take there
STATIONARY = {"granite/2x2": "stationary", "granite/4x1": "local"}
BRANCHES = {"_moe_ep": "ep", "_moe_stationary": "stationary",
            "_moe_replicated": "replicated", "_moe_local": "local"}


def _smoke(arch, package):
    if package == "port":
        from repro_torch.configs import get_smoke_config
    else:
        from repro.configs import get_smoke_config
    return get_smoke_config(arch)


def _moe_cfg(case, package):
    return _smoke(LAYER_CASES[case][0], package).plan[-1][0].moe


def _stem(case):
    return case.replace("/", "_")


def _load(work, name):
    return dict(np.load(os.path.join(work, name)))


def _rows(a, b, data, d):
    """Data rank ``data``'s rows of a whole batch array of ``b``
    requests on ``d`` data ranks (all of them where ``d`` does not
    divide ``b``)."""
    if b % d:
        return a
    n = b // d
    return a[data * n:(data + 1) * n]


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
    for name, (_, t) in MESHES.items():
        mesh = make_host_mesh(model=t)
        _layers(name, mesh, work, arrays, checks)
        _models(name, mesh, work, arrays, checks)
        checks[f"sums/{name}"] = _bf16_sums(rank, mesh)
        checks[f"train/{name}"] = _training_runs(mesh)
    checks["dp_serve"] = _dp_serve(rank)
    np.savez(os.path.join(work, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(checks, f)
    dist.destroy_process_group()


class _Spy:
    """Within the block each ``moe`` branch call appends its name to
    ``taken``."""

    def __init__(self):
        self.taken = []

    def __enter__(self):
        from repro_torch.models import moe
        self._real = {name: getattr(moe, name) for name in BRANCHES}

        def spy(name):
            def wrapped(*a):
                self.taken.append(BRANCHES[name])
                return self._real[name](*a)
            return wrapped
        for name in BRANCHES:
            setattr(moe, name, spy(name))
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        for name, fn in self._real.items():
            setattr(moe, name, fn)


def _layers(mesh_name, mesh, work, arrays, checks):
    """``moe_forward`` on the rank's rows and experts for each layer case
    of ``mesh`` (the layer's leaves gathered over ``data`` as
    ``layer_forward`` hands them on), and the branches it took."""
    from repro_torch.models import moe, tp
    from repro_torch.models.shardrules import (make_ctx, shard_batch,
                                               shard_params)

    for case, (_, m, _, _, inference, _) in LAYER_CASES.items():
        if m != mesh_name:
            continue
        stem = _stem(case)
        params = {"moe": _nested({k: torch.as_tensor(v) for k, v in _load(
            work, f"moe_{stem}.npz").items()})}
        x = torch.as_tensor(_load(work, f"x_{stem}.npz")["x"])
        ctx = make_ctx(mesh, inference=inference)
        rows, ctx = shard_batch({"x": x}, ctx)
        cfg = _moe_cfg(case, "port")
        with _Spy() as spy, torch.inference_mode():
            held = tp.gather_fsdp(shard_params(params, ctx), ctx,
                                  cfg.d_model)
            out, met = moe.moe_forward(held["moe"], rows["x"], cfg, ctx)
        arrays[f"{case}/out"] = out.numpy()
        arrays[f"{case}/aux_loss"] = met["aux_loss"].numpy()
        arrays[f"{case}/dropped"] = met["dropped"].numpy()
        checks[f"{case}/branch"] = spy.taken


def _models(mesh_name, mesh, work, arrays, checks):
    """Prefill, each rank's caches, 4 decode steps (and granite's under
    the inference context), the engine's tokens and the held bytes for
    each model case of ``mesh``."""
    from repro_torch.models import model
    from repro_torch.models.convert import from_reference
    from repro_torch.models.shardrules import (_items, bytes_per_device,
                                               make_ctx, shard_batch,
                                               shard_params)
    from repro_torch.serve import ServeConfig, ServeEngine

    for case, (arch, m, b, s, _) in MODEL_CASES.items():
        if m != mesh_name:
            continue
        cfg = _smoke(arch, "port")
        stem = _stem(case)
        params = from_reference(cfg, _nested(_load(
            work, f"params_{stem}.npz")), "cpu")
        inp = {k: torch.as_tensor(v) for k, v in _load(
            work, f"inputs_{stem}.npz").items()}
        rows, ctx = shard_batch({"tokens": inp["tokens"],
                                 "dec": inp["decode_tokens"]},
                                make_ctx(mesh))
        batch, dec = {"tokens": rows["tokens"]}, rows["dec"]
        checks[f"{case}/rows"] = [int(batch["tokens"].shape[0]),
                                  bool(ctx.batch_whole)]
        mine = shard_params(params, ctx)
        held = sum(x.numel() * x.element_size() for _, x in _items(mine))
        max_len = cfg.meta_tokens + s + NEW
        with torch.inference_mode():
            lg, caches, index = model.prefill(cfg, mine, batch, max_len,
                                              torch.float32, ctx)
            arrays[f"{case}/prefill"] = lg.numpy()
            for path, x in _items(caches):
                arrays[f"{case}/cache/{path}"] = x.numpy().copy()
            for i in range(NEW):
                lg, caches = model.decode_step(cfg, mine, dec[:, i:i + 1],
                                               caches, index + i, ctx,
                                               max_len)
                arrays[f"{case}/decode{i}"] = lg.numpy()
            if case in STATIONARY:
                import dataclasses
                inf = dataclasses.replace(ctx, inference=True)
                placed = shard_params(params, inf)
                lg, caches, index = model.prefill(cfg, mine, batch,
                                                  max_len, torch.float32,
                                                  ctx)
                with _Spy() as spy:
                    for i in range(NEW):
                        lg, caches = model.decode_step(
                            cfg, placed, dec[:, i:i + 1], caches,
                            index + i, inf, max_len)
                        arrays[f"{case}/stationary{i}"] = lg.numpy()
                checks[f"{case}/stationary_branch"] = sorted(set(spy.taken))
                arrays[f"{case}/bytes_inference"] = np.asarray(
                    [sum(x.numel() * x.element_size()
                         for _, x in _items(placed)),
                     bytes_per_device(params, mesh)])
        engine = ServeEngine(cfg, params, ServeConfig(
            max_len=max_len, max_new_tokens=NEW, cache_dtype=torch.float32),
            device="cpu", mesh=mesh)
        arrays[f"{case}/tokens"] = engine.generate(
            {"tokens": inp["tokens"]})
        arrays[f"{case}/bytes"] = np.asarray(
            [held, bytes_per_device(params, mesh)])


def _bf16_sums(rank, mesh):
    """Ordered sums of bfloat16 partials over ``data`` and over the whole
    mesh equal float32 adds in rank order, cast once, bit for bit."""
    from repro_torch.models import tp
    from repro_torch.models.shardrules import make_ctx
    ctx = make_ctx(mesh)
    rows = ([1.0, 256.0, -256.0, 3.0], [2.0 ** -8, 1.0, -1.0, 1e4],
            [1e4, 2.0 ** -8, 7.0, -3.0], [-1.0, 5.0, 2.0 ** -7, 256.0])
    parts = [torch.tensor(rows[r] * 3, dtype=torch.bfloat16)
             for r in range(WORLD)]
    t = mesh.shape["model"]
    for axis, members in ((tp.MESH, range(WORLD)),
                          ("data", range(rank % t, WORLD, t))):
        want = None
        for r in members:
            want = parts[r].float() if want is None else want + \
                parts[r].float()
        got = tp.ordered_sum(parts[rank], ctx, axis)
        if got.dtype != torch.bfloat16 or not torch.equal(
                got, want.to(torch.bfloat16)):
            return f"{axis}: {got} != {want}"
    got = tp.rows_gather(torch.full((2, 3), float(rank)), ctx)
    want = torch.cat([torch.full((2, 3), float(r))
                      for r in range(rank % t, WORLD, t)])
    return "ok" if torch.equal(got, want) else f"rows {got} != {want}"


def _training_runs(mesh):
    """The training loss under the mesh's context on the rank's blocks
    and rows; returns its bits (or the error) and the seconds it took."""
    from repro_torch.models import model
    from repro_torch.models.shardrules import (make_ctx, shard_batch,
                                               shard_params)
    cfg = _smoke(GRANITE, "port")
    ctx = make_ctx(mesh)
    params = shard_params(model.init_params(cfg, 0, "cpu"), ctx)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (WORLD, 8)))
    t0 = time.monotonic()
    try:
        rows, rctx = shard_batch({"tokens": tokens, "labels": tokens}, ctx)
        loss, _ = model.loss_fn(cfg, params, rows, rctx)
        msg = f"loss {float(loss).hex()}"
    except (NotImplementedError, RuntimeError) as e:
        msg = f"{type(e).__name__}: {e}"
    return [msg, time.monotonic() - t0]


def _dp_serve(rank):
    """``chip_smoke.py``'s dp-granite step on the CPU at granite's smoke
    config: 2 requests of 12 tokens + 4 new served at (2, 2), 4
    stationary steps under the replicated steps' choices; the branches
    it counts, the bytes, the rows, the stationary gaps and (rank 0) its
    P = 1 yardstick within 1e-4, P = 1's argmax the served tokens."""
    import chip_smoke

    cfg = _smoke(GRANITE, "port")
    host = chip_smoke._serve_batch(cfg, 0, 2, 12)
    spec = dict(model=2, batch=2, prompt=12, new=NEW, steps=NEW)
    rec, _ = chip_smoke.dp_serve(cfg, 0, torch.device("cpu"), host, spec)
    layers = cfg.n_layers
    want = {"branches": {"ep": layers, "replicated": layers * (NEW - 1)},
            "stationary_branches": {"stationary": layers * NEW},
            "rows": 1, "finite": True}
    bad = {k: rec[k] for k, v in want.items() if rec[k] != v}
    if rec["bytes"][0] != rec["bytes"][1] or \
            rec["bytes_inference"][0] != rec["bytes"][1]:
        bad["bytes"] = [rec["bytes"], rec["bytes_inference"]]
    if max(g[0] for g in rec["stationary_gaps"]) > TOL or \
            any(rec["stationary_flips"]):
        bad["stationary"] = [rec["stationary_gaps"],
                             rec["stationary_flips"]]
    if np.asarray(rec["tokens"]).shape != (2, NEW):
        bad["tokens"] = rec["tokens"]
    if rank == 0 and (max(g[0] for g in rec["gaps"]) > TOL
                      or rec["argmax_rows"] != rec["tokens"]
                      or any(rec["flips_prefill"]) or rec["flips_decode"]):
        bad["yardstick"] = {k: rec[k] for k in (
            "gaps", "argmax_rows", "tokens", "flips_prefill",
            "flips_decode")}
    return json.dumps(bad) if bad else "ok"


# --- the reference (a subprocess) -------------------------------------------

def _reference_main(work, mesh_name):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding

    from repro.compat import set_mesh
    from repro.models.model import decode_step
    from repro.models.moe import moe_forward
    from repro.models.shardrules import make_ctx, tree_specs
    from repro.serve import ServeConfig, ServeEngine

    def mesh_of(shape):
        n = shape[0] * shape[1]
        return Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                    ("data", "model"))

    def place(params, mesh, inference=False):
        return jax.device_put(params, jax.tree.map(
            lambda s: NamedSharding(mesh, s),
            tree_specs(params, mesh, inference=inference),
            is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)))

    mesh = mesh_of(MESHES[mesh_name])
    out = {}
    with set_mesh(mesh):
        for case, (_, m, _, _, inference, _) in LAYER_CASES.items():
            if m != mesh_name:
                continue
            cfg = _moe_cfg(case, "reference")
            stem = _stem(case)
            params = jax.tree.map(jnp.asarray, _nested(_load(
                work, f"moe_{stem}.npz")))
            x = jnp.asarray(_load(work, f"x_{stem}.npz")["x"])
            ctx = make_ctx(mesh, inference=inference)
            o, met = jax.jit(lambda p, v, c=ctx, cfg=cfg: moe_forward(
                p, v, cfg, c))(place(params, mesh, inference), x)
            out[f"{case}/out"] = np.asarray(o)
            for k in ("aux_loss", "dropped"):
                out[f"{case}/{k}"] = np.asarray(met[k])
            if LAYER_CASES[case][5] == "stationary":
                o, _ = jax.jit(lambda p, v, cfg=cfg: moe_forward(
                    p, v, cfg, None))(params, x)
                out[f"{case}/local/out"] = np.asarray(o)
    for case, (arch, m, _, s, other) in MODEL_CASES.items():
        if m != mesh_name:
            continue
        cfg = _smoke(arch, "reference")
        stem = _stem(case)
        ref_mesh = mesh_of(other) if other else mesh
        params = jax.tree.map(jnp.asarray, _nested(_load(
            work, f"params_{stem}.npz")))
        inp = _load(work, f"inputs_{stem}.npz")
        batch = {"tokens": jnp.asarray(inp["tokens"])}
        with set_mesh(ref_mesh):
            placed = place(params, ref_mesh)
            eng = ServeEngine(cfg, placed, ServeConfig(
                max_len=cfg.meta_tokens + s + NEW, max_new_tokens=NEW,
                cache_dtype=jnp.float32), mesh=ref_mesh)
            lg, caches, index = eng._prefill(placed, batch)
            out[f"{case}/prefill"] = np.asarray(lg)
            for k, v in _flat({str(i): c for i, c in
                               enumerate(caches)}).items():
                out[f"{case}/cache/{k}"] = v
            for i in range(NEW):
                tok = jnp.asarray(inp["decode_tokens"][:, i:i + 1])
                lg, caches = eng._decode(placed, tok, caches, index + i)
                out[f"{case}/decode{i}"] = np.asarray(lg)
            if case in STATIONARY:
                inf = make_ctx(ref_mesh, inference=True)
                step = jax.jit(lambda p, t, c, i, inf=inf, cfg=cfg:
                               decode_step(cfg, p, t, c, i, inf))
                stationary = place(params, ref_mesh, inference=True)
                _, caches, index = eng._prefill(placed, batch)
                for i in range(NEW):
                    tok = jnp.asarray(inp["decode_tokens"][:, i:i + 1])
                    lg, caches = step(stationary, tok, caches, index + i)
                    out[f"{case}/stationary{i}"] = np.asarray(lg)
            out[f"{case}/tokens"] = eng.generate(batch)
    np.savez(os.path.join(work, f"reference_{mesh_name}.npz"), **out)


# --- the fixture ------------------------------------------------------------

def _write_inputs(work):
    import jax

    from repro.models import model as ref_model
    from repro.models.moe import moe_init

    for i, (case, (_, _, b, s, _, _)) in enumerate(LAYER_CASES.items()):
        cfg = _moe_cfg(case, "reference")
        params = moe_init(jax.random.PRNGKey(i), cfg)
        np.savez(os.path.join(work, f"moe_{_stem(case)}.npz"),
                 **_flat(jax.tree.map(np.asarray, params)))
        rng = np.random.default_rng(400 + i)
        np.savez(os.path.join(work, f"x_{_stem(case)}.npz"),
                 x=rng.normal(size=(b, s, cfg.d_model)).astype(np.float32))
    for i, (case, (arch, _, b, s, _)) in enumerate(MODEL_CASES.items()):
        cfg = _smoke(arch, "reference")
        params = ref_model.init_params(cfg, jax.random.PRNGKey(70 + i))
        np.savez(os.path.join(work, f"params_{_stem(case)}.npz"),
                 **_flat(jax.tree.map(np.asarray, params)))
        rng = np.random.default_rng(500 + i)
        np.savez(os.path.join(work, f"inputs_{_stem(case)}.npz"),
                 tokens=rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
                 decode_tokens=rng.integers(0, cfg.vocab,
                                            (b, NEW)).astype(np.int32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The rank group and the two reference runs, started together;
    returns every rank's arrays and checks and the reference's arrays."""
    work = str(tmp_path_factory.mktemp("tp_data"))
    _write_inputs(work)
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    procs = [(f"reference {name}", subprocess.Popen(
        [sys.executable, __file__, "reference", work, name], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for name in MESHES]
    port_no = _free_port()
    for rank in range(WORLD):
        procs.append((f"rank {rank}", subprocess.Popen(
            [sys.executable, __file__, "rank", str(rank), str(port_no),
             work], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    deadline = time.monotonic() + 3 * GROUP_TIMEOUT_S
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
    for name in MESHES:
        reference.update(np.load(os.path.join(work,
                                              f"reference_{name}.npz")))
    for rank in range(WORLD):
        arrays[rank] = dict(np.load(os.path.join(work, f"rank{rank}.npz")))
        with open(os.path.join(work, f"rank{rank}.json")) as f:
            checks[rank] = json.load(f)
    return arrays, checks, reference


def _coords(mesh_name, rank):
    """(data, model) coordinates of ``rank`` on the named mesh."""
    t = MESHES[mesh_name][1]
    return rank // t, rank % t


# --- the layer --------------------------------------------------------------

@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_moe_layer_matches_reference_mesh(runs, case):
    arrays, _, ref = runs
    _, m, b, *_ = LAYER_CASES[case]
    d = MESHES[m][0]
    for rank in range(WORLD):
        data, _ = _coords(m, rank)
        _close(arrays[rank][f"{case}/out"],
               _rows(ref[f"{case}/out"], b, data, d))
        for k in ("aux_loss", "dropped"):
            _close(arrays[rank][f"{case}/{k}"], ref[f"{case}/{k}"])


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_moe_layer_takes_the_references_branch(runs, case):
    _, checks, _ = runs
    for rank in range(WORLD):
        assert checks[rank][f"{case}/branch"] == [LAYER_CASES[case][5]]


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_moe_layer_data_row_bit_equal(runs, case):
    """The ranks of one data row return the same bits; the aux loss and
    the dropped share are the same on every rank."""
    arrays, _, _ = runs
    m = LAYER_CASES[case][1]
    t = MESHES[m][1]
    for rank in range(WORLD):
        lead = rank - rank % t
        np.testing.assert_array_equal(arrays[rank][f"{case}/out"],
                                      arrays[lead][f"{case}/out"])
        for k in ("aux_loss", "dropped"):
            np.testing.assert_array_equal(arrays[rank][f"{case}/{k}"],
                                          arrays[0][f"{case}/{k}"])


@pytest.mark.parametrize("case", [c for c, v in LAYER_CASES.items()
                                  if v[5] == "stationary"])
def test_stationary_equals_one_device(runs, case):
    """The stationary branch routes every row of the batch with one
    capacity, so a rank's rows equal the reference's one-device layer's,
    and each data rank holds only its rows (all of them at B = 1)."""
    arrays, _, ref = runs
    _, m, b, *_ = LAYER_CASES[case]
    d = MESHES[m][0]
    for rank in range(WORLD):
        data, _ = _coords(m, rank)
        got = arrays[rank][f"{case}/out"]
        _close(got, _rows(ref[f"{case}/local/out"], b, data, d))
        assert got.shape[0] == (b // d if b % d == 0 else b)


# --- the model --------------------------------------------------------------

@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_prefill_and_decode_match_reference_mesh(runs, case):
    arrays, _, ref = runs
    _, m, b, _, _ = MODEL_CASES[case]
    d = MESHES[m][0]
    for rank in range(WORLD):
        data, _ = _coords(m, rank)
        got = arrays[rank]
        _close(got[f"{case}/prefill"], _rows(ref[f"{case}/prefill"], b,
                                             data, d))
        for t in range(NEW):
            _close(got[f"{case}/decode{t}"],
                   _rows(ref[f"{case}/decode{t}"], b, data, d))


@pytest.mark.parametrize("case", list(STATIONARY))
def test_inference_decode_matches_reference_mesh(runs, case):
    """granite's decode under ``make_ctx(mesh, inference=True)`` over the
    inference layout: the reference's ``decode_32k`` step at smoke size,
    on the stationary branch at (2, 2) (``local`` at (4, 1), T = 1)."""
    arrays, checks, ref = runs
    _, m, b, _, _ = MODEL_CASES[case]
    d = MESHES[m][0]
    for rank in range(WORLD):
        data, _ = _coords(m, rank)
        assert checks[rank][f"{case}/stationary_branch"] == [
            STATIONARY[case]]
        for t in range(NEW):
            _close(arrays[rank][f"{case}/stationary{t}"],
                   _rows(ref[f"{case}/stationary{t}"], b, data, d))
        held, want = arrays[rank][f"{case}/bytes_inference"]
        assert held == want > 0


def _mesh_block(whole, spec, coords, shape):
    """A rank's block of a whole numpy array under a port spec on a mesh
    of ``shape`` ({axis: size}) at ``coords`` ({axis: index}): each cut
    dim's block indexed row-major over its entry's axes of more than one
    rank, as ``shardrules._block`` cuts it."""
    for dim, entry in enumerate(spec):
        axes = [a for a in entry or () if shape[a] > 1]
        idx, n = 0, 1
        for a in axes:
            idx, n = idx * shape[a] + coords[a], n * shape[a]
        size = whole.shape[dim] // n
        whole = np.take(whole, np.arange(idx * size, (idx + 1) * size),
                        axis=dim)
    return whole


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_caches_hold_the_ranks_rows_and_heads(runs, case):
    """A rank's cache block equals the reference's whole cache cut by the
    port's ``cache_specs`` on the mesh: to the rank's rows, heads and
    channels, and where the requests do not divide over ``data`` (B = 1),
    to its block of the attention caches' slots over ``data`` (over the
    whole mesh for hymba's KV head, which 2 does not divide either)."""
    from repro_torch.core.mesh import Mesh
    from repro_torch.models.shardrules import cache_specs

    arrays, _, ref = runs
    _, m, b, _, _ = MODEL_CASES[case]
    d, t = MESHES[m]
    shape = {"data": d, "model": t}
    mesh = Mesh(("data", "model"), shape)
    n = 0
    for rank in range(WORLD):
        coords = dict(zip(("data", "model"), _coords(m, rank)))
        for key, block in arrays[rank].items():
            if not key.startswith(f"{case}/cache/"):
                continue
            seg, layer, part, leaf = key.split("/")[-4:]
            whole = ref[f"{case}/cache/{seg}/{part}/{leaf}"][int(layer)]
            spec = cache_specs({leaf: whole}, mesh)[leaf]
            if b % d and leaf in ("k", "v"):
                assert "data" in spec[1], spec
            _close(block, _mesh_block(whole, spec, coords, shape))
            n += 1
    assert n


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_engine_tokens_equal_reference_mesh(runs, case):
    """Every rank returns the whole batch's tokens, the reference's."""
    arrays, _, ref = runs
    for rank in range(WORLD):
        np.testing.assert_array_equal(arrays[rank][f"{case}/tokens"],
                                      ref[f"{case}/tokens"])


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_data_rows_bit_equal_and_hold_their_bytes(runs, case):
    """The ranks of one data row hold the same logits bit for bit; a rank
    holds its rows (all of them at B = 1) and ``bytes_per_device``'s
    parameter bytes."""
    arrays, checks, _ = runs
    _, m, b, _, _ = MODEL_CASES[case]
    d, t = MESHES[m]
    for rank in range(WORLD):
        got, lead = arrays[rank], arrays[rank - rank % t]
        for k in [f"{case}/prefill"] + [f"{case}/decode{i}"
                                        for i in range(NEW)]:
            np.testing.assert_array_equal(got[k], lead[k])
        assert checks[rank][f"{case}/rows"] == (
            [b // d, False] if b % d == 0 else [b, True])
        held, want = got[f"{case}/bytes"]
        assert held == want > 0


# --- collectives and refusals -----------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
def test_ordered_sums_over_data_and_mesh_are_rank_order_adds(runs, mesh):
    _, checks, _ = runs
    for rank in range(WORLD):
        assert checks[rank][f"sums/{mesh}"] == "ok"


@pytest.mark.parametrize("mesh", list(MESHES))
def test_training_on_the_mesh_raises_on_every_rank(runs, mesh):
    """Training under the mesh's context raised until it was ported: it
    now runs, and every rank computes the same loss, bit for bit."""
    _, checks, _ = runs
    for rank in range(WORLD):
        msg, seconds = checks[rank][f"train/{mesh}"]
        assert msg.startswith("loss ") and \
            msg == checks[0][f"train/{mesh}"][0], (rank, msg)
        assert seconds < GROUP_TIMEOUT_S


def test_chip_smoke_dp_step_computes_the_mesh_function(runs):
    """``chip_smoke.py``'s dp-granite step, run on the CPU: its branch
    counts, bytes and rows hold, its stationary steps equal the
    replicated ones and rank 0's P = 1 yardstick reproduces the served
    logits within 1e-4."""
    _, checks, _ = runs
    for rank in range(WORLD):
        assert checks[rank]["dp_serve"] == "ok", (rank,
                                                  checks[rank]["dp_serve"])


# --- the rules on shapes ----------------------------------------------------

def _mesh_pair(shape):
    from jax.sharding import AbstractMesh

    from repro_torch.core.mesh import Mesh
    from repro_torch.launch.mesh import make_production_mesh
    port = make_production_mesh() if shape == (16, 16) else Mesh(
        ("data", "model"), dict(zip(("data", "model"), shape)))
    return port, AbstractMesh(shape, ("data", "model"))


def _norm(entry):
    if entry is None:
        return None
    return (entry,) if isinstance(entry, str) else tuple(entry)


@pytest.mark.parametrize("inference", [False, True],
                         ids=["train", "inference"])
@pytest.mark.parametrize("shape", [(2, 2), (16, 16)],
                         ids=["2x2", "16x16"])
def test_specs_match_reference(shape, inference):
    """``tree_specs(..., inference=)`` equals the reference's for every
    leaf of the ten architectures (under ``inference`` its
    ``_INFERENCE_RULES`` come first and the expert tables' F is cut
    over ``data``; otherwise the dense FFN's rules shadow them)."""
    from repro.models import shardrules as ref_rules
    from repro_torch.configs import ARCH_NAMES, get_config
    from repro_torch.models import shardrules
    port_mesh, ref_mesh = _mesh_pair(shape)
    for arch in ARCH_NAMES:
        ref_shapes = _ref_shapes(arch)
        port = _port_shapes(get_config(arch), ref_shapes)
        ref_specs = {k: tuple(_norm(e) for e in v) for k, v in
                     _flat_specs(ref_rules.tree_specs(
                         ref_shapes, ref_mesh,
                         inference=inference)).items()}
        n = 0
        for path, spec in shardrules._items(shardrules.tree_specs(
                port, port_mesh, inference=inference)):
            parts = path.split("/")
            if parts[0] == "segments":
                want = ref_specs["/".join(parts[:2] + parts[3:])][1:]
            else:
                want = ref_specs[path]
            assert tuple(spec) == want, (arch, path, spec, want)
            n += 1
        assert n


def test_bytes_per_device_matches_reference_2x2():
    import jax

    from repro.models import shardrules as ref_rules
    from repro_torch.configs import ARCH_NAMES, get_config
    from repro_torch.models import shardrules
    port_mesh, ref_mesh = _mesh_pair((2, 2))
    for arch in ARCH_NAMES:
        ref_shapes = _ref_shapes(arch)
        port = _port_shapes(get_config(arch), ref_shapes)
        typed = _port_dtypes(port)
        ref_typed = jax.tree_util.tree_map_with_path(
            lambda p, s: jax.ShapeDtypeStruct(s.shape, typed[_ref_key(p)]),
            ref_shapes)
        assert shardrules.bytes_per_device(port, port_mesh) == \
            ref_rules.bytes_per_device(ref_typed, ref_mesh), arch


def _block_of(a, spec, coords, shape):
    """The block of ``a`` that a reference spec (entries of mesh axis
    names) places at ``coords`` of a mesh of ``shape``."""
    for dim, entry in enumerate(spec):
        for axis in (entry or ()):
            n = a.shape[dim] // shape[axis]
            a = np.take(a, np.arange(coords[axis] * n,
                                     (coords[axis] + 1) * n), axis=dim)
    return a


@pytest.mark.parametrize("inference", [False, True],
                         ids=["train", "inference"])
@pytest.mark.parametrize("arch", [GRANITE, DEEPSEEK, MAMBA2])
def test_shard_params_holds_the_rules_blocks(arch, inference):
    """Each rank of (2, 2) holds the block ``tree_specs(...,
    inference=)`` places on it of every leaf (the ``fsdp`` dims over
    ``data`` in data order, the ``tensor`` dims over ``model``); the
    expert tables by expert, their D (F under ``inference``) over
    ``data`` as the reference's own expert rules cut them; the bytes are
    ``bytes_per_device``'s."""
    import jax
    from jax.sharding import AbstractMesh

    from repro.models import model as ref_model
    from repro.models import shardrules as ref_rules
    from repro_torch.core.mesh import Mesh
    from repro_torch.models.convert import from_reference
    from repro_torch.models.shardrules import (ParallelCtx, _items,
                                               bytes_per_device,
                                               shard_params)

    shape = {"data": 2, "model": 2}
    ref = jax.tree.map(np.asarray, ref_model.init_params(
        _smoke(arch, "reference"), jax.random.PRNGKey(3)))
    specs = _flat_specs(ref_rules.tree_specs(
        ref, AbstractMesh((2, 2), ("data", "model")), inference=inference))
    whole = from_reference(_smoke(arch, "port"), ref, "cpu")
    for rank in range(WORLD):
        coords = {"data": rank // 2, "model": rank % 2}
        mesh = Mesh(("data", "model"), shape, coords=coords)
        ctx = ParallelCtx(mesh=mesh, batch=("data",), tensor="model",
                          tensor_rank=coords["model"], tensor_size=2,
                          data_rank=coords["data"], data_size=2,
                          inference=inference)
        mine = dict(_items(shard_params(whole, ctx)))
        for path, x in _items(whole):
            parts = path.split("/")
            key = path
            if parts[0] == "segments":
                key = "/".join(parts[:2] + parts[3:])
            spec = tuple(_norm(e) for e in specs[key])
            if parts[0] == "segments":
                spec = spec[1:]
            if not inference and parts[-2] == "experts":
                d_dim = 2 if parts[-1] == "w_down" else 1
                spec = tuple(("model",) if i == 0 else ("data",)
                             if i == d_dim else None for i in range(3))
            np.testing.assert_array_equal(
                mine[path].numpy(), _block_of(x.numpy(), spec, coords,
                                              shape), err_msg=path)
        held = sum(x.numel() * x.element_size() for x in mine.values())
        assert held == bytes_per_device(whole, mesh)


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    sys.path.insert(0, os.path.join(SRC, ".."))      # chip_smoke.py
    if sys.argv[1] == "reference":
        _reference_main(sys.argv[2], sys.argv[3])
    else:
        _rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
