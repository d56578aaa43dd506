"""The MoE's expert-parallel mesh paths and MLA at T > 1, on gloo on the
CPU, against the JAX package's (1, T) mesh.

Built as ``tests/test_torch_tp.py`` is: the rank processes run this file
(``python tests/test_torch_tp_moe.py rank <rank> <world> <port> <dir>``)
in a gloo group of T = 2 and one of T = 4, each with a 60 s group
timeout, under a subprocess timeout; the reference runs it once for each
T (``python tests/test_torch_tp_moe.py reference <dir> <T>``) on 4 fake
devices, its parameters placed by ``tree_shardings``. All six start
together; the weights (the reference's ``moe_init`` / ``init_params``)
and the inputs come from this process as numpy.

The reference's ``ep`` path gives each sequence block its own capacity,
so a mesh run can drop assignments a one-device run keeps: the port at T
is held to the reference at the same T, never at one device.

- Layer: ``moe_forward`` at T against the reference's under
  ``make_ctx(mesh)``, jitted: out, ``aux_loss`` and ``dropped`` within
  1e-4, on the ``ep`` branch (S divisible by T), ``replicated`` (S = 1,
  and S = 10 at T = 4), the fallback (6 experts at T = 4: whole tables,
  ``local``), deepseek's shared experts, and deepseek at B = 2, S = 32,
  T = 4, whose blocks drop assignments; the branch each rank takes;
  every rank's out bit-equal to rank 0's.
- Model: granite-moe's smoke config at T = 2, a narrow variant (8 query,
  4 KV heads) at T = 4, and deepseek-v2's at T = 2 and 4: prefill
  logits, 4 decode steps (MLA's absorbed decode: every head's queries
  over the rank's block of the slots, the partials merged, the rank's
  heads lifted by ``wv_b``), the caches (GQA blocks and MLA's latent and
  rope key's length blocks against the reference's slices), the engines'
  tokens; every rank bit-equal; a rank's parameter bytes equal to
  ``bytes_per_device``.
- Layout: ``spec_for`` on the expert tables equals the reference's
  (its dense-FFN rules shadow the expert rules); ``shard_params`` gives
  rank r the rows ``tree_specs(..., inference=True)`` places there at
  data = 1; ``all_to_all`` moves bfloat16 exactly.
"""

import dataclasses
import datetime
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from test_torch_tp import (GROUP_TIMEOUT_S, NARROW, SRC, TOL, _close, _flat,
                           _flat_specs, _free_port, _nested, _slice)

B, NEW = 2, 4
WORLDS = (2, 4)
GRANITE, DEEPSEEK = "granite-moe-1b-a400m", "deepseek-v2-236b"
# an expert count T = 4 does not divide: every rank holds the whole tables
SIX_EXPERTS = {"moe": {"n_experts": 6}}
# name: (arch, T, fields replaced in both packages' smoke config, S, the
# branch moe_forward takes); the MoE layer's config is the smoke model's
LAYER_CASES = {
    "granite-ep/2": (GRANITE, 2, None, 12, "ep"),
    "granite-ep/4": (GRANITE, 4, None, 12, "ep"),
    "granite-decode/4": (GRANITE, 4, None, 1, "replicated"),
    "granite-odd-s/4": (GRANITE, 4, None, 10, "replicated"),
    "granite-six-experts/4": (GRANITE, 4, SIX_EXPERTS, 12, "local"),
    "deepseek-ep/2": (DEEPSEEK, 2, None, 32, "ep"),
    "deepseek-drop/4": (DEEPSEEK, 4, None, 32, "ep"),
    "deepseek-decode/2": (DEEPSEEK, 2, None, 1, "replicated"),
    "deepseek-decode/4": (DEEPSEEK, 4, None, 1, "replicated"),
}
# the case whose sequence blocks drop assignments the whole call keeps
DROPS = "deepseek-drop/4"
# name: (arch, T, fields, prompt length S)
MODEL_CASES = {
    "granite/2": (GRANITE, 2, None, 12),
    "granite-narrow/4": (GRANITE, 4, NARROW, 12),
    "deepseek/2": (DEEPSEEK, 2, None, 32),
    "deepseek/4": (DEEPSEEK, 4, None, 32),
}
# the models whose P = 1 yardstick of chip_smoke.py's tp phase is run
YARDSTICK = ("granite-narrow/4", "deepseek/4")
BRANCHES = {"_moe_ep": "ep", "_moe_replicated": "replicated",
            "_moe_local": "local"}


def _narrowed(cfg, fields):
    """``cfg`` with its layers' fields replaced: "attn" the attention's,
    "moe" the MoE's (in the layers that have one)."""
    if fields is None:
        return cfg
    fields = dict(fields)
    attn, moe = fields.pop("attn", {}), fields.pop("moe", {})

    def spec_of(spec):
        return dataclasses.replace(
            spec, attn=dataclasses.replace(spec.attn, **attn),
            moe=spec.moe and dataclasses.replace(spec.moe, **moe), **fields)
    return dataclasses.replace(cfg, plan=tuple(
        (spec_of(spec), n) for spec, n in cfg.plan))


def _cfg(cases, case, package):
    if package == "port":
        from repro_torch.configs import get_smoke_config
    else:
        from repro.configs import get_smoke_config
    arch, _, fields = cases[case][:3]
    return _narrowed(get_smoke_config(arch), fields)


def _moe_cfg(case, package):
    return _cfg(LAYER_CASES, case, package).plan[-1][0].moe


def _stem(case):
    return case.replace("/", "_")


def _load(work, name):
    return dict(np.load(os.path.join(work, name)))


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
    _layers(world, ctx, work, arrays, checks)
    _models(world, mesh, work, arrays)
    checks["bf16_all_to_all"] = _bf16_all_to_all(rank, world, ctx)
    if world == 4:
        for case in YARDSTICK:
            checks[f"yardstick/{case}"] = _yardstick(rank, mesh, case)
    np.savez(os.path.join(work, f"t{world}_rank{rank}.npz"), **arrays)
    with open(os.path.join(work, f"t{world}_rank{rank}.json"), "w") as f:
        json.dump(checks, f)
    dist.destroy_process_group()


def _layers(world, ctx, work, arrays, checks):
    """``moe_forward`` on the rank's experts for each layer case, and the
    branches it took."""
    from repro_torch.models import moe
    from repro_torch.models.shardrules import shard_params

    for case, (_, t, *_) in LAYER_CASES.items():
        if t != world:
            continue
        stem = _stem(case)
        params = {"moe": _nested({k: torch.as_tensor(v) for k, v in _load(
            work, f"moe_{stem}.npz").items()})}
        x = torch.as_tensor(_load(work, f"x_{stem}.npz")["x"])
        taken = []
        real = {name: getattr(moe, name) for name in BRANCHES}

        def spy(name):
            def wrapped(*a):
                taken.append(BRANCHES[name])
                return real[name](*a)
            return wrapped
        for name in BRANCHES:
            setattr(moe, name, spy(name))
        try:
            with torch.inference_mode():
                out, m = moe.moe_forward(shard_params(params, ctx)["moe"], x,
                                         _moe_cfg(case, "port"), ctx)
        finally:
            for name, fn in real.items():
                setattr(moe, name, fn)
        arrays[f"{case}/out"] = out.numpy()
        arrays[f"{case}/aux_loss"] = m["aux_loss"].numpy()
        arrays[f"{case}/dropped"] = m["dropped"].numpy()
        checks[f"{case}/branch"] = taken


def _models(world, mesh, work, arrays):
    """Prefill, each rank's caches, 4 decode steps and the engine's tokens
    for each model case."""
    from repro_torch.models import model
    from repro_torch.models.convert import from_reference
    from repro_torch.models.shardrules import (_items, bytes_per_device,
                                               make_ctx, shard_params)
    from repro_torch.serve import ServeConfig, ServeEngine

    ctx = make_ctx(mesh)
    for case, (_, t, _, s) in MODEL_CASES.items():
        if t != world:
            continue
        cfg = _cfg(MODEL_CASES, case, "port")
        stem = _stem(case)
        params = from_reference(cfg, _nested(_load(
            work, f"params_{stem}.npz")), "cpu")
        inp = {k: torch.as_tensor(v) for k, v in _load(
            work, f"inputs_{stem}.npz").items()}
        batch = {"tokens": inp["tokens"]}
        mine = shard_params(params, ctx)
        with torch.inference_mode():
            lg, caches, index = model.prefill(cfg, mine, batch, s + NEW,
                                              torch.float32, ctx)
            arrays[f"{case}/prefill"] = lg.numpy()
            for path, x in _items(caches):
                arrays[f"{case}/cache/{path}"] = x.numpy().copy()
            for i in range(NEW):
                tok = inp["decode_tokens"][:, i:i + 1]
                lg, caches = model.decode_step(cfg, mine, tok, caches,
                                               index + i, ctx, s + NEW)
                arrays[f"{case}/decode{i}"] = lg.numpy()
        engine = ServeEngine(cfg, params, ServeConfig(
            max_len=s + NEW, max_new_tokens=NEW, cache_dtype=torch.float32),
            device="cpu", mesh=mesh)
        arrays[f"{case}/tokens"] = engine.generate(batch)
        held = sum(x.numel() * x.element_size()
                   for _, x in _items(engine.params))
        arrays[f"{case}/bytes"] = np.asarray(
            [held, bytes_per_device(params, mesh)])


def _yardstick(rank, mesh, case):
    """``chip_smoke.py``'s P = 1 yardstick of the tp phase on the CPU: a
    1 x 32 prompt served at T = 4 with the expert choices recorded and
    gathered to rank 0, whose ``_tp_yardstick`` (per-block capacity, the
    TP choices replayed, decode teacher-forced) must give the TP logits
    within 1e-4 and the TP tokens as its argmax."""
    import torch.distributed as dist

    import chip_smoke
    from repro_torch.models import model
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.serve import engine as engine_mod

    cfg = _cfg(MODEL_CASES, case, "port")
    s = MODEL_CASES[case][3]
    tokens = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab, (1, s)))
    engine = ServeEngine(cfg, model.init_params(cfg, 0, "cpu"), ServeConfig(
        max_len=s + NEW, max_new_tokens=NEW, cache_dtype=torch.float32),
        device="cpu", mesh=mesh)
    logits, routing = [], chip_smoke._Routing()

    def keep(fn):
        def wrapped(*a, **kw):
            res = fn(*a, **kw)
            logits.append(res[0])
            return res
        return wrapped
    engine_mod.prefill = keep(model.prefill)
    engine_mod.decode_step = keep(model.decode_step)
    try:
        with routing.record():
            out = engine.generate({"tokens": tokens})
    finally:
        engine_mod.prefill = model.prefill
        engine_mod.decode_step = model.decode_step
    every = [None] * 4 if rank == 0 else None
    dist.gather_object(routing.chosen, every, dst=0)
    if rank:
        return "ok"
    got = chip_smoke._tp_yardstick(cfg, 0, torch.device("cpu"),
                                   {"tokens": tokens}, out, logits, every,
                                   s + NEW)
    worst = max(g[0] for g in got["gaps"])
    if worst > TOL or got["argmax_p1"] != out[0].tolist():
        return f"gap {worst}, argmax {got['argmax_p1']} != {out[0]}"
    if any(got["flips_prefill"]) or got["flips_decode"]:
        return f"own choices differ in float32: {got}"
    return "ok"


def _bf16_all_to_all(rank, world, ctx):
    """Block j of each rank's bfloat16 rows reaches rank j, in rank order,
    bit for bit (a uint8 view on the wire)."""
    from repro_torch.models import tp
    vals = torch.tensor([1.0, 2.0 ** -8, 1e4, -3.0], dtype=torch.bfloat16)
    # rows (world, 3, 4): block j of rank r holds r * 16 + j + vals
    send = torch.stack([vals + (rank * 16 + j) for j in range(world)])
    send = send[:, None, :].expand(world, 3, 4)
    want = torch.stack([vals + (r * 16 + rank) for r in range(world)])
    got = tp.all_to_all(send, ctx)
    ok = got.dtype == torch.bfloat16 and got.shape == send.shape and \
        torch.equal(got, want[:, None, :].expand(world, 3, 4))
    return "ok" if ok else f"{got} != {want}"


# --- the reference on a (1, T) mesh (a subprocess) -------------------------

def _reference_main(work, world):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.compat import set_mesh
    from repro.models.moe import moe_forward
    from repro.models.shardrules import make_ctx, tree_shardings
    from repro.serve import ServeConfig, ServeEngine

    mesh = Mesh(np.asarray(jax.devices()[:world]).reshape(1, world),
                ("data", "model"))
    ctx = make_ctx(mesh)
    out = {}
    with set_mesh(mesh):
        for case, (_, t, *_) in LAYER_CASES.items():
            if t != world:
                continue
            cfg = _moe_cfg(case, "reference")
            stem = _stem(case)
            params = jax.tree.map(jnp.asarray, _nested(_load(
                work, f"moe_{stem}.npz")))
            x = jnp.asarray(_load(work, f"x_{stem}.npz")["x"])
            placed = jax.device_put(params, tree_shardings(params, mesh))
            for tag, c in (("", ctx), ("local/", None)):
                o, m = jax.jit(lambda p, v, c=c, cfg=cfg: moe_forward(
                    p, v, cfg, c))(placed if c else params, x)
                out[f"{case}/{tag}out"] = np.asarray(o)
                for k in ("aux_loss", "dropped"):
                    out[f"{case}/{tag}{k}"] = np.asarray(m[k])
        for case, (_, t, _, s) in MODEL_CASES.items():
            if t != world:
                continue
            cfg = _cfg(MODEL_CASES, case, "reference")
            stem = _stem(case)
            params = jax.tree.map(jnp.asarray, _nested(_load(
                work, f"params_{stem}.npz")))
            inp = _load(work, f"inputs_{stem}.npz")
            batch = {"tokens": jnp.asarray(inp["tokens"])}
            placed = jax.device_put(params, tree_shardings(params, mesh))
            eng = ServeEngine(cfg, placed, ServeConfig(
                max_len=s + NEW, max_new_tokens=NEW,
                cache_dtype=jnp.float32), mesh=mesh)
            lg, caches, index = eng._prefill(placed, batch)
            out[f"{case}/prefill"] = np.asarray(lg)
            for k, v in _flat({str(i): c for i, c in
                               enumerate(caches)}).items():
                out[f"{case}/cache/{k}"] = v
            out[f"{case}/cache_specs"] = np.asarray(json.dumps({
                k: [list(e) if isinstance(e, tuple) else
                    ([e] if e else None) for e in spec]
                for k, spec in _flat_specs(_cache_specs(
                    cfg, caches, mesh)).items()}))
            for i in range(NEW):
                tok = jnp.asarray(inp["decode_tokens"][:, i:i + 1])
                lg, caches = eng._decode(placed, tok, caches, index + i)
                out[f"{case}/decode{i}"] = np.asarray(lg)
            out[f"{case}/tokens"] = eng.generate(batch)
    np.savez(os.path.join(work, f"reference_t{world}.npz"), **out)


def _cache_specs(cfg, caches, mesh):
    from repro.serve.engine import cache_specs
    return cache_specs(cfg, caches, mesh)


# --- the fixture ------------------------------------------------------------

def _write_inputs(work):
    import jax

    from repro.models import model as ref_model
    from repro.models.moe import moe_init

    for i, case in enumerate(LAYER_CASES):
        _, _, _, s, _ = LAYER_CASES[case]
        cfg = _moe_cfg(case, "reference")
        params = moe_init(jax.random.PRNGKey(i), cfg)
        np.savez(os.path.join(work, f"moe_{_stem(case)}.npz"),
                 **_flat(jax.tree.map(np.asarray, params)))
        rng = np.random.default_rng(200 + i)
        x = rng.normal(size=(B, s, cfg.d_model))
        if case == DROPS:   # a direction every token shares: the router
            x += rng.normal(size=cfg.d_model)    # favours a few experts
        np.savez(os.path.join(work, f"x_{_stem(case)}.npz"),
                 x=x.astype(np.float32))
    for i, case in enumerate(MODEL_CASES):
        cfg = _cfg(MODEL_CASES, case, "reference")
        s = MODEL_CASES[case][3]
        params = ref_model.init_params(cfg, jax.random.PRNGKey(50 + i))
        np.savez(os.path.join(work, f"params_{_stem(case)}.npz"),
                 **_flat(jax.tree.map(np.asarray, params)))
        rng = np.random.default_rng(300 + i)
        np.savez(os.path.join(work, f"inputs_{_stem(case)}.npz"),
                 tokens=rng.integers(0, cfg.vocab, (B, s)).astype(np.int32),
                 decode_tokens=rng.integers(0, cfg.vocab,
                                            (B, NEW)).astype(np.int32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both rank groups and the two reference runs, started together;
    returns every rank's arrays and checks and the reference's arrays."""
    work = str(tmp_path_factory.mktemp("tp_moe"))
    _write_inputs(work)
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
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
    for world in WORLDS:
        reference.update(np.load(os.path.join(work,
                                              f"reference_t{world}.npz")))
        for rank in range(world):
            stem = os.path.join(work, f"t{world}_rank{rank}")
            arrays[world, rank] = dict(np.load(stem + ".npz"))
            with open(stem + ".json") as f:
                checks[world, rank] = json.load(f)
    return arrays, checks, reference


# --- the layer --------------------------------------------------------------

@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_moe_layer_matches_reference_mesh(runs, case):
    arrays, _, ref = runs
    world = LAYER_CASES[case][1]
    for rank in range(world):
        for k in ("out", "aux_loss", "dropped"):
            _close(arrays[world, rank][f"{case}/{k}"], ref[f"{case}/{k}"])


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_moe_layer_takes_the_references_branch(runs, case):
    _, checks, _ = runs
    world, want = LAYER_CASES[case][1], LAYER_CASES[case][4]
    for rank in range(world):
        assert checks[world, rank][f"{case}/branch"] == [want]


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_moe_layer_ranks_bit_equal(runs, case):
    arrays, _, _ = runs
    world = LAYER_CASES[case][1]
    for rank in range(world):
        for k in ("out", "aux_loss", "dropped"):
            np.testing.assert_array_equal(arrays[world, rank][f"{case}/{k}"],
                                          arrays[world, 0][f"{case}/{k}"])


def test_sequence_blocks_drop_what_one_device_keeps(runs):
    """deepseek at B = 2, S = 32, T = 4: each block's capacity drops
    assignments, so the reference's mesh and one-device outputs differ,
    and the port follows the mesh."""
    arrays, _, ref = runs
    assert float(ref[f"{DROPS}/dropped"]) > 0
    assert float(ref[f"{DROPS}/dropped"]) > float(
        ref[f"{DROPS}/local/dropped"])
    gap = np.abs(ref[f"{DROPS}/out"] - ref[f"{DROPS}/local/out"]).max()
    assert gap > 100 * TOL
    _close(arrays[4, 0][f"{DROPS}/out"], ref[f"{DROPS}/out"])


@pytest.mark.parametrize("case", [c for c, v in LAYER_CASES.items()
                                  if v[4] != "ep"])
def test_replicated_and_local_equal_one_device(runs, case):
    """Where every rank routes all the tokens, capacity is the whole
    call's, as on one device."""
    arrays, _, ref = runs
    world = LAYER_CASES[case][1]
    for k in ("out", "aux_loss", "dropped"):
        _close(arrays[world, 0][f"{case}/{k}"], ref[f"{case}/local/{k}"])


# --- the model --------------------------------------------------------------

@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_prefill_and_decode_match_reference_mesh(runs, case):
    arrays, _, ref = runs
    world = MODEL_CASES[case][1]
    for rank in range(world):
        got = arrays[world, rank]
        _close(got[f"{case}/prefill"], ref[f"{case}/prefill"])
        for t in range(NEW):
            _close(got[f"{case}/decode{t}"], ref[f"{case}/decode{t}"])


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_caches_match_reference(runs, case):
    """A cache block equals its slice of the reference's whole cache under
    ``cache_specs``: a GQA cache's KV heads, and MLA's latent and rope
    key's length (the reference lays them out along the length, and the
    port holds a block of the slots on each rank)."""
    from repro_torch.core.mesh import Mesh
    from repro_torch.models.shardrules import cache_specs

    arrays, _, ref = runs
    world = MODEL_CASES[case][1]
    ref_specs = json.loads(str(ref[f"{case}/cache_specs"]))
    mesh = Mesh(("data", "model"), {"data": 1, "model": world})
    n = 0
    for rank in range(world):
        for key, block in arrays[world, rank].items():
            if not key.startswith(f"{case}/cache/"):
                continue
            seg, layer, part, leaf = key.split("/")[-4:]
            whole = ref[f"{case}/cache/{seg}/{part}/{leaf}"][int(layer)]
            spec = cache_specs({leaf: whole}, mesh)[leaf]
            assert ref_specs[f"{seg}/{part}/{leaf}"] == [None] + [
                list(e) if e else None for e in spec]
            if leaf in ("latent", "k_rope"):
                assert "model" in spec[1], spec
            _close(block, _slice(whole, spec, rank, world))
            n += 1
    assert n


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_engine_tokens_equal_reference_mesh(runs, case):
    arrays, _, ref = runs
    world = MODEL_CASES[case][1]
    for rank in range(world):
        np.testing.assert_array_equal(arrays[world, rank][f"{case}/tokens"],
                                      ref[f"{case}/tokens"])


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_ranks_bit_equal_and_hold_their_bytes(runs, case):
    arrays, _, _ = runs
    world = MODEL_CASES[case][1]
    base = arrays[world, 0]
    for rank in range(world):
        got = arrays[world, rank]
        for k in [f"{case}/prefill", f"{case}/tokens"] + [
                f"{case}/decode{t}" for t in range(NEW)]:
            np.testing.assert_array_equal(got[k], base[k])
        held, want = got[f"{case}/bytes"]
        assert held == want > 0


@pytest.mark.parametrize("case", YARDSTICK)
def test_chip_smoke_yardstick_computes_the_tp_function(runs, case):
    _, checks, _ = runs
    for rank in range(4):
        assert checks[4, rank][f"yardstick/{case}"] == "ok"


@pytest.mark.parametrize("world", WORLDS)
def test_bf16_all_to_all_is_exact(runs, world):
    _, checks, _ = runs
    for rank in range(world):
        assert checks[world, rank]["bf16_all_to_all"] == "ok"


# --- the expert layout ------------------------------------------------------

@pytest.mark.parametrize("arch", [GRANITE, DEEPSEEK])
@pytest.mark.parametrize("t", WORLDS)
def test_expert_specs_match_reference_shadowed_rule(arch, t):
    """``spec_for`` on the expert tables is the reference's: the dense
    FFN's rules match first and cut F, not E."""
    import jax
    from jax.sharding import AbstractMesh

    from repro.configs import get_config as ref_config
    from repro.models import shardrules as ref_rules
    from repro.models.model import init_params
    from repro_torch.core.mesh import Mesh
    from repro_torch.models import shardrules

    shapes = jax.eval_shape(lambda: init_params(ref_config(arch),
                                                jax.random.PRNGKey(0)))
    seg = len(shapes["segments"]) - 1
    experts = shapes["segments"][str(seg)]["moe"]["experts"]
    mesh = Mesh(("data", "model"), {"data": 1, "model": t})
    ref_mesh = AbstractMesh((1, t), ("data", "model"))
    for leaf, cut in (("w_up", 2), ("w_gate", 2), ("w_down", 1)):
        path = f"segments/{seg}/moe/experts/{leaf}"
        shape = experts[leaf].shape
        want = [None] * 3
        want[cut] = ("model",)
        assert tuple(_norm(e) for e in ref_rules.spec_for(
            path, shape, ref_mesh)) == (None, *want)
        assert shardrules.spec_for(
            f"segments/{seg}/0/moe/experts/{leaf}", shape[1:],
            mesh) == tuple(want)


def _norm(entry):
    """A reference spec entry as the port writes it."""
    if entry is None:
        return None
    return (entry,) if isinstance(entry, str) else tuple(entry)


@pytest.mark.parametrize("case", ["granite-ep/2", "granite-ep/4",
                                  "granite-six-experts/4", "deepseek-ep/2",
                                  DROPS])

def test_shard_params_holds_the_expert_block(case):
    """Each rank holds the rows of the expert tables that the reference's
    ``tree_specs(..., inference=True)`` places on it at data = 1 (all of
    them where T does not divide E), the router whole and the shared
    experts cut as ``spec_for`` says; where E divides, the bytes are
    ``bytes_per_device``'s."""
    import jax
    from jax.sharding import AbstractMesh

    from repro.models import shardrules as ref_rules
    from repro.models.moe import moe_init
    from repro_torch.core.mesh import Mesh
    from repro_torch.models.shardrules import (ParallelCtx, _items,
                                               bytes_per_device,
                                               shard_params, spec_for)

    t = LAYER_CASES[case][1]
    n_experts = _moe_cfg(case, "reference").n_experts
    ref = jax.tree.map(np.asarray, moe_init(jax.random.PRNGKey(0),
                                            _moe_cfg(case, "reference")))
    ref_specs = {k: tuple(v) for k, v in _flat_specs(ref_rules.tree_specs(
        ref, AbstractMesh((1, t), ("data", "model")),
        inference=True)).items()}
    whole = {"moe": _nested({k: torch.tensor(v)
                             for k, v in _flat(ref).items()})}
    for r in range(t):
        mesh = Mesh(("data", "model"), {"data": 1, "model": t},
                    coords={"data": 0, "model": r})
        ctx = ParallelCtx(mesh=mesh, batch=("data",), tensor="model",
                          tensor_rank=r, tensor_size=t)
        mine = dict(_items(shard_params(whole, ctx)))
        for path, x in _items(whole):
            key = path[len("moe/"):]
            if key.startswith("experts/"):
                spec = tuple(_norm(e) for e in ref_specs[key])
                assert spec == (("model",) if n_experts % t == 0 else None,
                                None, None)
            else:
                spec = spec_for(path, tuple(x.shape), mesh)
            np.testing.assert_array_equal(
                mine[path].numpy(), _slice(x.numpy(), spec, r, t))
        held = sum(x.numel() * x.element_size() for x in mine.values())
        if n_experts % t == 0:
            assert held == bytes_per_device(whole, mesh)
        else:
            assert held > bytes_per_device(whole, mesh)


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    sys.path.insert(0, os.path.join(SRC, ".."))      # chip_smoke.py
    if sys.argv[1] == "reference":
        _reference_main(sys.argv[2], int(sys.argv[3]))
    else:
        _rank_main(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                   sys.argv[5])
