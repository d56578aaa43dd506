"""Tensor parallelism for serving (world size > 1) on gloo on the CPU,
against the JAX package's (1, T) mesh.

The rank processes run this file (``python tests/test_torch_tp.py rank
<rank> <world> <port> <dir>``), each in a gloo group with a 60 s timeout,
under a subprocess timeout: one group of T = 2 ranks, one of T = 4. The
reference runs this file too, in REF_PARTS processes for each T, each
with a share of the cases (``python tests/test_torch_tp.py reference
<dir> <T> <part>``), with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``: its
GSPMD prefill, decode and engine on a ``("data", "model")`` mesh of the
first T devices, the parameters placed by ``tree_shardings``. All the
processes start together; the weights (the reference's ``init_params``) and the
inputs come from this process as numpy.

- Rules: ``spec_for`` / ``tree_specs`` and ``bytes_per_device`` equal the
  reference's for the ten full configs on (1, 2), (1, 4), (16, 16) and
  (2, 16, 16), on shapes only (``jax.eval_shape``, ``AbstractMesh``).
- T = 2: stablelm, danube, nemotron, starcoder2, qwen2-vl, mamba2 and
  hymba's smoke configs, and stablelm's with an FFN hidden dim of 129
  (the rules keep it whole, and every rank runs it whole); T = 4:
  stablelm's, narrow danube and starcoder2 variants (8 query and 4 KV
  heads), mamba2's (16 SSM heads), danube's (2 KV heads: whole, the
  cache's length cut, the query heads the rank's), hymba's (5 query
  heads, 1 KV head: the attention whole, the cache's length cut) and
  hymba's with SSM head_dim 64 (2 SSM heads 4 does not divide, d_inner
  128 cut across them), and hymba's with a max_len of 64 (the last two
  ranks' blocks of the global caches hold no live slot) and of 25 (4
  does not divide it: the global caches whole, the rings cut). Prefill
  logits, each rank's cache block against the reference cache's slice,
  4 decode steps' logits (on fixed tokens) within 1e-4
  (tests/test_torch_families.py's TOL), the engines' tokens equal, the
  port's ``cache_specs`` equal to the reference's; every rank's logits
  bit-equal to rank 0's, and a rank's parameter bytes equal to
  ``bytes_per_device``.
- A batch that differs between ranks raises on every rank, and does not
  hang. Danube's and hymba's smoke configs at T = 4 and training on a
  mesh with data > 1, which raised here until they were ported, run and
  give every rank the same tokens or loss (serving with a data axis is
  ``tests/test_torch_tp_data.py``'s, training there
  ``tests/test_torch_dp_train.py``'s, the merge itself
  ``tests/test_torch_softmax_merge.py``'s). The MoE and MLA families are
  served on the mesh in ``tests/test_torch_tp_moe.py``.
"""

import dataclasses
import datetime
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
TOL = 1e-4
GROUP_TIMEOUT_S = 60
# reference processes a T, each compiling its share of the cases
REF_PARTS = 2
B, S, NEW, GRID = 2, 12, 4, 2
WORLDS = (2, 4)
NARROW = {"attn": {"n_heads": 8, "n_kv_heads": 4}}
# a hidden dim T = 2 does not divide: the rules keep the FFN whole
ODD_FF = {"d_ff": 129}
# hymba's SSM with 2 heads of 64: 4 does not divide them, and d_inner 128
# is cut into blocks that do not fall on head boundaries
ODD_SSM = {"ssm": {"head_dim": 64}}
# name: (arch, T, layer fields replaced in both packages' smoke config,
# "attn" the attention's)
CASES = {
    "stablelm/2": ("stablelm-3b", 2, None),
    "danube/2": ("h2o-danube-1.8b", 2, None),
    "nemotron/2": ("nemotron-4-15b", 2, None),
    "starcoder2/2": ("starcoder2-15b", 2, None),
    "qwen2-vl/2": ("qwen2-vl-7b", 2, None),
    "mamba2/2": ("mamba2-370m", 2, None),
    "stablelm-odd-ff/2": ("stablelm-3b", 2, ODD_FF),
    "stablelm/4": ("stablelm-3b", 4, None),
    "danube-narrow/4": ("h2o-danube-1.8b", 4, NARROW),
    "starcoder2-narrow/4": ("starcoder2-15b", 4, NARROW),
    "mamba2/4": ("mamba2-370m", 4, None),
    "hymba/2": ("hymba-1.5b", 2, None),
    "hymba/4": ("hymba-1.5b", 4, None),
    "hymba-ssm-odd/4": ("hymba-1.5b", 4, ODD_SSM),
    "danube/4": ("h2o-danube-1.8b", 4, None),
    "hymba-dead-block/4": ("hymba-1.5b", 4, None),
    "hymba-odd-len/4": ("hymba-1.5b", 4, None),
}
# cases whose max_len is longer than their positions need: 64 leaves
# hymba's global caches 16 slots a rank, and ranks 2 and 3 hold none of
# the 24 live ones; 25 is not divided by 4, and the global caches stay
# whole on every rank
EXTRA_LEN = {"hymba-dead-block/4": 40, "hymba-odd-len/4": 1}
# what raises at T = 4, and the words its message must hold; None: it
# raised until it was ported, and now runs, every rank to the same
# tokens or loss
REFUSED = {
    "danube-kv": None, "hymba": None, "data-axis": None,
    "divergent": "differ",
}


def _narrowed(cfg, fields):
    if fields is None:
        return cfg
    fields = dict(fields)
    attn = fields.pop("attn", {})
    ssm = fields.pop("ssm", {})
    return dataclasses.replace(cfg, plan=tuple(
        (dataclasses.replace(
            spec, attn=dataclasses.replace(spec.attn, **attn),
            ssm=dataclasses.replace(spec.ssm, **ssm) if ssm else spec.ssm,
            **fields), n) for spec, n in cfg.plan))


def _port_cfg(case):
    from repro_torch.configs import get_smoke_config
    arch, _, fields = CASES[case]
    return _narrowed(get_smoke_config(arch), fields)


def _ref_cfg(case):
    from repro.configs import get_smoke_config
    arch, _, fields = CASES[case]
    return _narrowed(get_smoke_config(arch), fields)


def _stem(case):
    return case.replace("/", "_")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _nested(flat):
    out = {}
    for key, v in flat.items():
        *parts, leaf = key.split("/")
        d = out
        for p in parts:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def _max_len(cfg, case=None):
    return cfg.meta_tokens + (GRID * GRID if cfg.frontend == "vlm" else 0) \
        + S + NEW + EXTRA_LEN.get(case, 0)


def _slice(a, spec, rank, world):
    """Rank's block of ``a`` under a port spec (only "model" cuts on a
    (1, T) mesh)."""
    for dim, entry in enumerate(spec):
        if entry:
            n = a.shape[dim] // world
            a = np.take(a, np.arange(rank * n, (rank + 1) * n), axis=dim)
    return a


# --- the rank processes -----------------------------------------------------

def _rank_main(rank, world, port_no, work):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model
    from repro_torch.models.convert import from_reference
    from repro_torch.models.shardrules import (_items, bytes_per_device,
                                               cache_specs, make_ctx,
                                               shard_params, shard_shape)
    from repro_torch.models.transformer import layer_init_cache
    from repro_torch.serve import ServeConfig, ServeEngine

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port_no}", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    mesh = make_host_mesh(model=world)
    ctx = make_ctx(mesh)
    checks, arrays = {}, {}
    for case, (_, t, _) in CASES.items():
        if t != world:
            continue
        cfg = _port_cfg(case)
        stem = _stem(case)
        params = from_reference(cfg, _nested(dict(np.load(os.path.join(
            work, f"params_{stem}.npz")))), "cpu")
        inp = {k: torch.as_tensor(v) for k, v in np.load(os.path.join(
            work, f"inputs_{stem}.npz")).items()}
        batch = {k: v for k, v in inp.items() if k != "decode_tokens"}
        max_len = _max_len(cfg, case)
        mine = shard_params(params, ctx)
        with torch.inference_mode():
            lg, caches, index = model.prefill(cfg, mine, batch, max_len,
                                              torch.float32, ctx)
            arrays[f"{case}/prefill"] = lg.numpy()
            for path, x in _items(caches):
                arrays[f"{case}/cache/{path}"] = x.numpy().copy()
            whole = [[layer_init_cache(spec, B, max_len, torch.float32,
                                       torch.device("meta"))
                      for _ in range(n)] for spec, n in cfg.plan]
            specs = dict(_items(cache_specs(whole, mesh)))
            checks[f"{case}/cache_blocks"] = "ok" if {
                p: shard_shape(tuple(x.shape), specs[p], mesh)
                for p, x in _items(whole)} == {
                p: tuple(x.shape) for p, x in _items(caches)} else "shapes"
            arrays[f"{case}/cache_specs"] = np.asarray(json.dumps(
                {p: [list(e) if e else None for e in s]
                 for p, s in specs.items()}))
            checks[f"{case}/blocks"] = model.cache_blocks(cfg, B, max_len,
                                                          ctx)
            for t in range(NEW):
                tok = inp["decode_tokens"][:, t:t + 1]
                lg, caches = model.decode_step(cfg, mine, tok, caches,
                                               index + t, ctx, max_len)
                arrays[f"{case}/decode{t}"] = lg.numpy()
        engine = ServeEngine(cfg, params, ServeConfig(
            max_len=max_len, max_new_tokens=NEW, cache_dtype=torch.float32),
            device="cpu", mesh=mesh)
        arrays[f"{case}/tokens"] = engine.generate(batch)
        held = sum(x.numel() * x.element_size()
                   for _, x in _items(engine.params))
        arrays[f"{case}/bytes"] = np.asarray(
            [held, bytes_per_device(params, mesh)])
    checks["bf16_sum"] = _bf16_sum(rank, world, ctx)
    if world == 4:
        _refusals(rank, mesh, checks)
        checks["chip_hymba"] = _chip_hymba(rank, ctx, work)
    np.savez(os.path.join(work, f"t{world}_rank{rank}.npz"), **arrays)
    with open(os.path.join(work, f"t{world}_rank{rank}.json"), "w") as f:
        json.dump(checks, f)
    dist.destroy_process_group()


def _chip_hymba(rank, ctx, work):
    """``chip_smoke.py``'s checks of its tp-hymba step at smoke size: the
    slots each rank writes in 4 decode steps (``_slot_writes``: a decoded
    position's global slot written by the rank whose block holds it, and
    by no other) and each rank's prefill cache blocks against P = 1's
    slices (``_cache_gaps``, on rank 0: within 1e-5, layer 0's k and v
    bit-equal)."""
    import torch.distributed as dist

    import chip_smoke
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model
    from repro_torch.models.shardrules import _items, shard_params

    cfg = get_smoke_config("hymba-1.5b")
    params = model.init_params(cfg, 0, "cpu")
    tokens = torch.as_tensor(np.random.default_rng(9).integers(
        0, cfg.vocab, (1, S)))
    max_len = cfg.meta_tokens + S + NEW
    mine = shard_params(params, ctx)
    with torch.inference_mode():
        lg, caches, index = model.prefill(cfg, mine, {"tokens": tokens},
                                          max_len, torch.float32, ctx)
        files = [os.path.join(work, f"chip_hymba_rank{r}.pt")
                 for r in range(4)]
        torch.save(caches, files[rank])
        with chip_smoke._slot_writes(writes := []):
            for t in range(NEW):
                lg, caches = model.decode_step(cfg, mine, lg.argmax(-1)[
                    :, None], caches, index + t, ctx, max_len)
    bad = [w for w in writes if w["wrote"] != (
        w["block"][0] <= w["slot"] < sum(w["block"]))]
    mine_global = [w["wrote"] for w in writes if not w["window"]]
    dist.barrier()                  # every rank's file is written
    if bad or mine_global != [rank == 3] * NEW:
        return f"slot writes {writes}"
    if rank:
        return "ok"
    with torch.inference_mode():
        _, whole, _ = model.prefill(cfg, params, {"tokens": tokens},
                                    max_len, torch.float32)
    got = chip_smoke._cache_gaps(whole, files)
    n = len(dict(_items(whole)))
    if max(got["cache_gap"]) > 1e-5 or not all(got["cache_layer0_equal"]) \
            or got["cache_leaves"] != n:
        return f"caches {got}"
    return "ok"


def _bf16_sum(rank, world, ctx):
    """The ordered sum of bfloat16 partials (a uint8 view on the wire)
    equals float32 adds in rank order, cast once, bit for bit."""
    from repro_torch.models import tp
    rows = ([1.0, 256.0, -256.0, 3.0], [2.0 ** -8, 1.0, -1.0, 1e4])
    parts = [torch.tensor(rows[r % 2] * 3, dtype=torch.bfloat16)
             for r in range(world)]
    want = parts[0].float()
    for p in parts[1:]:
        want = want + p.float()
    got = tp.ordered_sum(parts[rank], ctx)
    return "ok" if got.dtype == torch.bfloat16 and torch.equal(
        got, want.to(torch.bfloat16)) else f"{got} != {want}"


def _refusals(rank, mesh, checks):
    """A batch that differs between ranks raises here on every rank;
    danube's and hymba's smoke configs at T = 4 return their tokens, and
    training on a (2, 2) mesh its loss's bits."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model
    from repro_torch.models.shardrules import (make_ctx, shard_batch,
                                               shard_params)
    from repro_torch.serve import ServeConfig, ServeEngine

    # room for hymba's 8 meta tokens
    scfg = ServeConfig(max_len=8 + S + NEW, max_new_tokens=NEW,
                       cache_dtype=torch.float32)
    tokens = np.random.default_rng(0).integers(0, 128, (B, S))

    def engine(arch, m=mesh):
        cfg = get_smoke_config(arch)
        return ServeEngine(cfg, model.init_params(cfg, 0, "cpu"), scfg,
                           device="cpu", mesh=m)

    def train_on(m):
        cfg = get_smoke_config("stablelm-3b")
        ctx = make_ctx(m)
        tokens = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab, (B, S)))
        rows, rctx = shard_batch({"tokens": tokens, "labels": tokens}, ctx)
        loss, _ = model.loss_fn(cfg, shard_params(
            model.init_params(cfg, 0, "cpu"), ctx), rows, rctx)
        return f"loss {float(loss).hex()}"

    def divergent():
        tokens = np.random.default_rng(rank if rank == 1 else 0).integers(
            0, 128, (B, S))
        engine("stablelm-3b").generate({"tokens": tokens})

    def served(arch):
        return f"tokens {engine(arch).generate({'tokens': tokens}).tolist()}"

    cases = {
        "danube-kv": lambda: served("h2o-danube-1.8b"),
        "hymba": lambda: served("hymba-1.5b"),
        "data-axis": lambda: train_on(make_host_mesh(model=2)),
        "divergent": divergent,
    }
    for name, fn in cases.items():
        t0 = time.monotonic()
        try:
            out = fn()
            checks[name] = out if isinstance(out, str) else "did not raise"
        except (NotImplementedError, RuntimeError) as e:
            checks[name] = f"{type(e).__name__}: {e}"
        checks[name + "_s"] = time.monotonic() - t0


# --- the reference on a (1, T) mesh (a subprocess) -------------------------

def _ref_cases(world, part):
    """The cases of T = ``world`` that reference process ``part`` of
    REF_PARTS runs (every REF_PARTS-th, so each process compiles a
    share)."""
    return [c for c in CASES if CASES[c][1] == world][part::REF_PARTS]


def _reference_main(work, world, part):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.compat import set_mesh
    from repro.models.shardrules import tree_shardings
    from repro.serve import ServeConfig, ServeEngine
    from repro.serve.engine import cache_specs

    out = {}
    for case in _ref_cases(world, part):
        t = world
        cfg = _ref_cfg(case)
        stem = _stem(case)
        mesh = Mesh(np.asarray(jax.devices()[:t]).reshape(1, t),
                    ("data", "model"))
        params = jax.tree.map(jnp.asarray, _nested(dict(np.load(
            os.path.join(work, f"params_{stem}.npz")))))
        inp = dict(np.load(os.path.join(work, f"inputs_{stem}.npz")))
        batch = {k: jnp.asarray(v) for k, v in inp.items()
                 if k != "decode_tokens"}
        with set_mesh(mesh):
            placed = jax.device_put(params, tree_shardings(params, mesh))
            eng = ServeEngine(cfg, placed, ServeConfig(
                max_len=_max_len(cfg, case), max_new_tokens=NEW,
                cache_dtype=jnp.float32), mesh=mesh)
            lg, caches, index = eng._prefill(placed, batch)
            out[f"{case}/prefill"] = np.asarray(lg)
            for k, v in _flat({str(i): c for i, c in
                               enumerate(caches)}).items():
                out[f"{case}/cache/{k}"] = v
            specs = cache_specs(cfg, caches, mesh)
            out[f"{case}/cache_specs"] = np.asarray(json.dumps({
                k: [list(e) if isinstance(e, tuple) else
                    ([e] if e else None) for e in spec]
                for k, spec in _flat_specs(specs).items()}))
            for s in range(NEW):
                tok = jnp.asarray(inp["decode_tokens"][:, s:s + 1])
                lg, caches = eng._decode(placed, tok, caches, index + s)
                out[f"{case}/decode{s}"] = np.asarray(lg)
            out[f"{case}/tokens"] = eng.generate(batch)
    np.savez(os.path.join(work, f"reference_t{world}_{part}.npz"), **out)


def _flat_specs(specs):
    import jax
    from jax.sharding import PartitionSpec as P
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, P))[0]
    out = {}
    for path, spec in leaves:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = tuple(spec)
    return out


# --- the fixture ------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_inputs(work):
    import jax

    from repro.models import model as ref_model
    from repro_torch.launch.serve import vlm_inputs

    for i, case in enumerate(CASES):
        cfg_ref, cfg = _ref_cfg(case), _port_cfg(case)
        params = ref_model.init_params(cfg_ref, jax.random.PRNGKey(i))
        np.savez(os.path.join(work, f"params_{_stem(case)}.npz"),
                 **_flat(jax.tree.map(np.asarray, params)))
        rng = np.random.default_rng(100 + i)
        batch = vlm_inputs(cfg, rng, B, GRID, S) \
            if cfg.frontend == "vlm" else {}
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, S))
        batch["decode_tokens"] = rng.integers(0, cfg.vocab, (B, NEW))
        np.savez(os.path.join(work, f"inputs_{_stem(case)}.npz"),
                 **{k: (v.astype(np.int32) if v.dtype.kind == "i" else v)
                    for k, v in batch.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both rank groups and the reference, started together; returns
    every rank's arrays and checks and the reference's arrays."""
    work = str(tmp_path_factory.mktemp("tp"))
    _write_inputs(work)
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    procs = [(f"reference t{world} part {part}", subprocess.Popen(
        [sys.executable, __file__, "reference", work, str(world),
         str(part)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True))
        for world in WORLDS for part in range(REF_PARTS)]
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
        for part in range(REF_PARTS):
            reference.update(np.load(os.path.join(
                work, f"reference_t{world}_{part}.npz")))
        for rank in range(world):
            stem = os.path.join(work, f"t{world}_rank{rank}")
            arrays[world, rank] = dict(np.load(stem + ".npz"))
            with open(stem + ".json") as f:
                checks[world, rank] = json.load(f)
    return arrays, checks, reference


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)


# --- the tests --------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_reference_mesh(runs, case):
    arrays, _, ref = runs
    world = CASES[case][1]
    for rank in range(world):
        got = arrays[world, rank]
        _close(got[f"{case}/prefill"], ref[f"{case}/prefill"])
        for t in range(NEW):
            _close(got[f"{case}/decode{t}"], ref[f"{case}/decode{t}"])


@pytest.mark.parametrize("case", list(CASES))
def test_cache_blocks_match_reference_slices(runs, case):
    """Each rank's cache block equals its slice of the reference's whole
    cache under the port's ``cache_specs``, which equal the reference's
    (its leading layer dim left out)."""
    arrays, _, ref = runs
    world = CASES[case][1]
    specs = json.loads(str(arrays[world, 0][f"{case}/cache_specs"]))
    ref_specs = json.loads(str(ref[f"{case}/cache_specs"]))
    n = 0
    for rank in range(world):
        got = arrays[world, rank]
        for key, block in got.items():
            if not key.startswith(f"{case}/cache/"):
                continue
            seg, layer, part, leaf = key.split("/")[-4:]
            spec = specs[f"{seg}/{layer}/{part}/{leaf}"]
            assert ref_specs[f"{seg}/{part}/{leaf}"] == [None] + spec
            whole = ref[f"{case}/cache/{seg}/{part}/{leaf}"][int(layer)]
            _close(block, _slice(whole, spec, rank, world))
            n += 1
    assert n


@pytest.mark.parametrize("case", list(CASES))
def test_cache_specs_give_the_prefill_cache_blocks(runs, case):
    """The whole cache's shapes cut by ``cache_specs`` are the shapes of
    the rank's prefill cache, leaf for leaf."""
    _, checks, _ = runs
    world = CASES[case][1]
    for rank in range(world):
        assert checks[world, rank][f"{case}/cache_blocks"] == "ok"


@pytest.mark.parametrize("case", list(CASES))
def test_engine_tokens_equal_reference_mesh(runs, case):
    arrays, _, ref = runs
    world = CASES[case][1]
    for rank in range(world):
        np.testing.assert_array_equal(arrays[world, rank][f"{case}/tokens"],
                                      ref[f"{case}/tokens"])


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_bit_equal_and_hold_their_bytes(runs, case):
    arrays, _, _ = runs
    world = CASES[case][1]
    base = arrays[world, 0]
    for rank in range(world):
        got = arrays[world, rank]
        for k in [f"{case}/prefill", f"{case}/tokens"] + [
                f"{case}/decode{t}" for t in range(NEW)]:
            np.testing.assert_array_equal(got[k], base[k])
        held, want = got[f"{case}/bytes"]
        assert held == want > 0


@pytest.mark.parametrize("case", list(EXTRA_LEN))
def test_max_len_cases_lay_out_their_blocks(runs, case):
    """hymba's global caches (its first, third and fifth segments) at
    max_len 64: 16 slots a rank, ranks 2 and 3 holding none of the 20
    prefill and 4 decoded positions; at 25 whole on every rank. Its
    rings (8 slots) are cut into 2 a rank either way."""
    _, checks, _ = runs
    length = _max_len(_port_cfg(case), case)
    for rank in range(4):
        g, w = checks[4, rank][f"{case}/blocks"][:2]
        assert w == [2 * rank, 2, 8, "model"]
        if length % 4:
            assert g == [0, length, length, None]
        else:
            assert g == [16 * rank, 16, 64, "model"]
            assert (g[0] >= 8 + S + NEW) == (rank >= 2)


def test_chip_smoke_hymba_step_checks(runs):
    """``chip_smoke.py``'s tp-hymba checks at smoke size on T = 4: the
    decoded positions' global slots (20-23 of 24) written by rank 3
    alone, and every rank's prefill cache blocks equal to P = 1's
    slices."""
    _, checks, _ = runs
    for rank in range(4):
        assert checks[4, rank]["chip_hymba"] == "ok", checks[4, rank]


@pytest.mark.parametrize("world", WORLDS)
def test_bf16_ordered_sum_is_float32_adds_in_rank_order(runs, world):
    _, checks, _ = runs
    for rank in range(world):
        assert checks[world, rank]["bf16_sum"] == "ok"


@pytest.mark.parametrize("what", list(REFUSED))
def test_uncovered_layouts_raise_on_every_rank(runs, what):
    _, checks, _ = runs
    for rank in range(4):
        msg = checks[4, rank][what]
        if REFUSED[what] is None:       # runs: every rank's result alike
            assert msg.split()[0] in ("loss", "tokens") and \
                msg == checks[4, 0][what], (rank, msg)
        else:
            assert REFUSED[what] in msg, (rank, msg)
        assert checks[4, rank][what + "_s"] < GROUP_TIMEOUT_S


def test_reference_shards_danube_cache_length_at_t4():
    """Why danube's smoke config decodes over length blocks at T = 4: the
    reference puts its 2 KV heads whole and cuts the cache length over
    ``model``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh

    from repro.configs import get_smoke_config
    from repro.models.model import init_cache
    from repro.serve.engine import cache_specs

    cfg = get_smoke_config("h2o-danube-1.8b")
    caches = jax.eval_shape(lambda: init_cache(cfg, B, S + NEW,
                                               jnp.float32))
    spec = cache_specs(cfg, caches, AbstractMesh((1, 4), ("data", "model")))
    k_spec = tuple(spec[0]["attn"]["k"])
    assert "model" in k_spec[2] and k_spec[3] is None, k_spec


# --- the rules on shapes ----------------------------------------------------

MESHES = ((1, 2), (1, 4), (16, 16), (2, 16, 16))


def _meshes(shape):
    from jax.sharding import AbstractMesh

    from repro_torch.core.mesh import Mesh
    from repro_torch.launch.mesh import make_production_mesh
    if len(shape) == 3:
        return (make_production_mesh(multi_pod=True),
                AbstractMesh(shape, ("pod", "data", "model")))
    if shape == (16, 16):
        port = make_production_mesh()
    else:
        port = Mesh(("data", "model"), {"data": 1, "model": shape[1]})
    return port, AbstractMesh(shape, ("data", "model"))


def _port_shapes(cfg, ref_shapes):
    """The port's parameter tree of ``cfg`` as meta tensors, from the
    reference's shapes the way ``convert.from_reference`` builds it."""
    import jax

    from repro_torch.models.convert import _unstack
    from repro_torch.models.model import cast_params
    meta = jax.tree.map(lambda s: torch.empty(
        s.shape, dtype=torch.float32, device="meta"), ref_shapes)
    out = {k: v for k, v in meta.items() if k != "segments"}
    out["segments"] = [[_unstack(meta["segments"][str(i)], j)
                        for j in range(n)]
                       for i, (_, n) in enumerate(cfg.plan)]
    return cast_params(out, cfg.dtype)


def _ref_shapes(arch):
    import jax

    from repro.configs import get_config
    from repro.models import model as ref_model
    return jax.eval_shape(lambda: ref_model.init_params(
        get_config(arch), jax.random.PRNGKey(0)))


def test_port_shapes_are_from_references_tree():
    """The meta tree the rules tests read is ``from_reference``'s tree:
    the same paths, shapes and types on two smoke configs."""
    import jax

    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import model as ref_model
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.convert import from_reference
    from repro_torch.models.shardrules import _items
    for arch in ("granite-moe-1b-a400m", "hymba-1.5b"):
        shapes = jax.eval_shape(lambda a=arch: ref_model.init_params(
            ref_smoke(a), jax.random.PRNGKey(0)))
        cfg = get_smoke_config(arch)
        real = dict(_items(from_reference(cfg, jax.tree.map(
            lambda s: np.zeros(s.shape, np.float32), shapes), "cpu")))
        meta = dict(_items(_port_shapes(cfg, shapes)))
        assert real.keys() == meta.keys()
        for k, v in real.items():
            assert (v.shape, v.dtype) == (meta[k].shape, meta[k].dtype), k


@pytest.mark.parametrize("mesh_shape", MESHES,
                         ids=lambda s: "x".join(map(str, s)))
def test_specs_and_bytes_match_reference(mesh_shape):
    import jax

    from repro.models import shardrules as ref_rules
    from repro_torch.configs import ARCH_NAMES, get_config
    from repro_torch.models import shardrules
    port_mesh, ref_mesh = _meshes(mesh_shape)

    def norm(entry):
        if entry is None:
            return None
        return (entry,) if isinstance(entry, str) else tuple(entry)

    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        ref_shapes = _ref_shapes(arch)
        port = _port_shapes(cfg, ref_shapes)
        ref_specs = {k: tuple(norm(e) for e in v) for k, v in
                     _flat_specs(ref_rules.tree_specs(
                         ref_shapes, ref_mesh)).items()}
        n = 0
        for path, spec in shardrules._items(shardrules.tree_specs(
                port, port_mesh)):
            parts = path.split("/")
            if parts[0] == "segments":  # the reference's stacked leaf
                want = ref_specs["/".join(parts[:2] + parts[3:])]
                want = want[1:] if want else want
            else:
                want = ref_specs[path]
            assert tuple(spec) == want, (arch, path, spec, want)
            n += 1
        assert n
        # the reference's bytes on its tree typed as the port holds it
        # (matrices in cfg.dtype, vectors and the MoE router in float32)
        typed = _port_dtypes(port)
        ref_typed = jax.tree_util.tree_map_with_path(
            lambda p, s: jax.ShapeDtypeStruct(s.shape, typed[_ref_key(p)]),
            ref_shapes)
        assert shardrules.bytes_per_device(port, port_mesh) == \
            ref_rules.bytes_per_device(ref_typed, ref_mesh), arch


def _port_dtypes(port):
    """Each leaf's type in the port's tree, as a jnp type, keyed by the
    reference's path."""
    import jax.numpy as jnp

    from repro_torch.models.shardrules import _items
    to_jnp = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    out = {}
    for path, x in _items(port):
        parts = path.split("/")
        if parts[0] == "segments":
            path = "/".join(parts[:2] + parts[3:])
        out[path] = to_jnp[x.dtype]
    return out


def _ref_key(path):
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def test_production_mesh_is_a_description():
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.models.shardrules import make_ctx
    mesh = make_production_mesh()
    assert mesh.shape == {"data": 16, "model": 16} and mesh.size == 256
    with pytest.raises(RuntimeError, match="256 ranks"):
        mesh.group("model")
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        make_ctx(mesh)
    one = make_host_mesh()        # no process group: one rank
    ctx = make_ctx(one)
    assert one.shape == {"data": 1, "model": 1} and ctx.tensor_size == 1


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(SRC, ".."))      # chip_smoke.py
    if sys.argv[1] == "reference":
        _reference_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    else:
        _rank_main(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                   sys.argv[5])
