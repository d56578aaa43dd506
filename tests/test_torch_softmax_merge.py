"""Decode over a length-sharded cache: the softmax merge across ranks, on
gloo on the CPU, against one rank's decode over the whole cache.

Four rank processes run this file (``python
tests/test_torch_softmax_merge.py rank <rank> <port> <dir>``) in one gloo
group with a 60 s group timeout, under a subprocess timeout, on
``make_host_mesh(model=4)``. Each holds its block of a whole cache drawn
from a seed with numpy (``tp.cache_block`` on the layout ``cache_specs``
gives: 1 KV head, which 4 does not divide, so the length is cut over
``model``) and runs ``attn_decode`` with its block; the one-rank
``attn_decode`` over the whole cache is the yardstick.

- The merged attention equals one rank's within 1e-6 in float32: a
  global cache with the new token in rank 2's block (rank 3's holds no
  live slot), a ring before its wrap (its last two blocks dead) and after
  it, the query heads whole (5 heads) and the rank's (4 heads at T = 4,
  gathered whole for the merge); every rank's output bit-equal.
- A block with no live slot changes no bit: its slots filled with other
  values give the same bits, and the merge of all four ranks' partials
  is the merge of the three live ones, bit for bit; its weight
  ``exp(NEG_INF - m)`` is exactly 0.
- Training with KV heads T does not divide (danube's smoke config) and
  hybrid layers (hymba's) at T = 4 give one rank's loss, and every
  rank's gradient of every whole leaf bit-equal to rank 0's; SSM heads
  in 2 groups at T = 2 raise on every rank, in serving and in training,
  naming ROADMAP Queue 1 item 8c, and none hangs.
- In one process: ``tp.cache_block`` on meshes of (1, 4), (2, 2) and
  (4, 1), and ``model.cache_blocks`` requiring ``max_len`` where a
  layout may cut a length.
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

from test_torch_tp import GROUP_TIMEOUT_S, SRC, _free_port

WORLD = 4
D, HD, B, C = 32, 8, 2, 16
MERGE_TOL = 1e-6
# name: (query heads, window, cache_index); one KV head, C slots
CASES = {
    "global-live-rank2": (5, 0, 9),
    "global-last-slot": (5, 0, 30),
    "ring-before-wrap": (5, C, 6),
    "ring-after-wrap": (5, C, 37),
    "global-heads-cut": (4, 0, 9),
    "ring-heads-cut": (4, C, 21),
}
# the cases whose blocks hold no live slot on some rank, and which
DEAD = {"global-live-rank2": (3,), "ring-before-wrap": (2, 3)}


def _cfg(case):
    from repro_torch.models.attention import AttnConfig
    heads, window, _ = CASES[case]
    return AttnConfig(d_model=D, n_heads=heads, n_kv_heads=1, head_dim=HD,
                      window=window)


def _inputs(case):
    """The layer's parameters, the token's x and the whole cache of
    ``case``, from a seed with numpy (float32)."""
    heads = CASES[case][0]
    rng = np.random.default_rng(sorted(CASES).index(case))

    def draw(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32))
    params = {"wq": draw(D, heads, HD) / D ** 0.5,
              "wk": draw(D, 1, HD) / D ** 0.5,
              "wv": draw(D, 1, HD) / D ** 0.5,
              "wo": draw(heads, HD, D) / (heads * HD) ** 0.5}
    return params, draw(B, 1, D), {"k": draw(B, C, 1, HD),
                                   "v": draw(B, C, 1, HD)}


def _one_rank(case):
    from repro_torch.models.attention import attn_decode
    params, x, cache = _inputs(case)
    with torch.inference_mode():
        out, cache = attn_decode(params, x, cache, _cfg(case),
                                 CASES[case][2])
    return out, cache


# --- the rank processes -----------------------------------------------------

def _rank_main(rank, port_no, work):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import tp
    from repro_torch.models.attention import NEG_INF, attn_decode
    from repro_torch.models.shardrules import (cache_specs, make_ctx,
                                               shard_params)

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port_no}", rank=rank,
        world_size=WORLD,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    ctx = make_ctx(make_host_mesh(model=WORLD))
    arrays, checks = {}, {}
    for case, (_, _, index) in CASES.items():
        cfg = _cfg(case)
        params, x, whole = _inputs(case)
        entry = cache_specs({"k": whole["k"]}, ctx.mesh)["k"][1]
        blk = tp.cache_block(entry, C, ctx)
        checks[f"{case}/block"] = list(blk)
        mine = shard_params({"attn": params}, ctx)["attn"]
        outs, caches = [], []
        # the second pass fills a dead block's slots with other values
        for fill in (None, 7.0):
            cache = {k: v.narrow(1, blk.start, blk.size).clone()
                     for k, v in whole.items()}
            if fill is not None and rank in DEAD.get(case, ()):
                for v in cache.values():
                    v.fill_(fill)
            with torch.inference_mode():
                out, cache = attn_decode(mine, x, cache, cfg, index, ctx,
                                         blk)
            outs.append(out)
            caches.append(cache)
        arrays[f"{case}/out"] = outs[0].numpy()
        arrays[f"{case}/out_filled"] = outs[1].numpy()
        for k, v in caches[0].items():
            arrays[f"{case}/cache/{k}"] = v.numpy()
    checks["dead_merge"] = _dead_merge(rank, ctx, NEG_INF)
    checks.update(_training_layouts())
    checks.update(_ssm_groups())
    np.savez(os.path.join(work, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(checks, f)
    dist.destroy_process_group()


def _dead_merge(rank, ctx, neg_inf):
    """``softmax_merge`` of four ranks' partials, rank 3's from a block
    with no live slot (its max ``NEG_INF``, its sums finite), against the
    merge of ranks 0-2's alone computed here in the same order: the same
    bits. Returns "ok" or what differs."""
    from repro_torch.models import tp
    rng = np.random.default_rng(5)
    parts = []
    for r in range(WORLD):
        m = torch.as_tensor(rng.normal(size=(2, 3)).astype(np.float32))
        l = torch.as_tensor(rng.uniform(1, 4, (2, 3)).astype(np.float32))
        o = torch.as_tensor(rng.normal(size=(2, 3, 5)).astype(np.float32))
        if r == WORLD - 1:
            m = torch.full_like(m, neg_inf)
            l, o = l * 1e3, o * 1e3          # finite values of no weight
        parts.append((m, l, o))
    got = tp.softmax_merge(*parts[rank], ctx, "model")
    top = torch.maximum(torch.maximum(parts[0][0], parts[1][0]),
                        parts[2][0])
    l_sum = o_sum = None
    for m, l, o in parts[:3]:
        w = torch.exp(m - top)
        l_sum = w * l if l_sum is None else l_sum + w * l
        o_sum = w[..., None] * o if o_sum is None else \
            o_sum + w[..., None] * o
    want = o_sum / l_sum[..., None]
    zero = float(torch.exp(parts[-1][0] - top).abs().max())
    if zero != 0.0:
        return f"the dead block's weight is {zero}"
    return "ok" if torch.equal(got, want) else \
        f"max |diff| {float((got - want).abs().max())}"


def _training_layouts():
    """The training loss and its gradient under a T = 4 context for
    danube's smoke config (4 query heads split, 2 KV heads whole) and
    hymba's (hybrid layers, the attention whole): the loss's bits, one
    rank's loss on the whole tree, a digest of the bits of every whole
    leaf's gradient, and the seconds."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model
    from repro_torch.models.shardrules import _items, _map, make_ctx, \
        shard_params

    out = {}
    ctx = make_ctx(make_host_mesh(model=WORLD))
    for name, arch in (("train-danube", "h2o-danube-1.8b"),
                       ("train-hymba", "hymba-1.5b")):
        cfg = get_smoke_config(arch)
        tokens = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab, (2, 8)))
        batch = {"tokens": tokens, "labels": tokens}
        whole = model.init_params(cfg, 0, "cpu", torch.float32)
        t0 = time.monotonic()
        params = _map(lambda _, x: x.clone().requires_grad_(),
                      shard_params(whole, ctx))
        loss, _ = model.loss_fn(cfg, params, batch, ctx)
        loss.backward()
        shapes = {k: v.shape for k, v in _items(whole)}
        grads = [x.grad.flatten() for k, x in _items(params)
                 if x.shape == shapes[k]]
        out[name] = {"loss": float(loss).hex(),
                     "one_rank": float(model.loss_fn(cfg, whole, batch)[0]),
                     "whole_leaves": len(grads),
                     "grads": torch.cat(grads).numpy().tobytes().hex()}
        out[name + "_s"] = time.monotonic() - t0
    return out


def _ssm_groups():
    """hymba's smoke config with its SSM heads in 2 groups at T = 2 (a
    (2, 2) mesh), served and trained: each message (or "did not
    raise")."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model
    from repro_torch.models.shardrules import make_ctx, shard_params
    from repro_torch.serve import ServeConfig, ServeEngine
    from test_torch_tp import _narrowed

    cfg = _narrowed(get_smoke_config("hymba-1.5b"), {"ssm": {"n_groups": 2}})
    mesh = make_host_mesh(model=2)
    params = model.init_params(cfg, 0, "cpu", torch.float32)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)))

    def serve():
        ServeEngine(cfg, params, ServeConfig(max_len=24, max_new_tokens=2),
                    device="cpu", mesh=mesh)

    def train():
        ctx = make_ctx(mesh)
        model.loss_fn(cfg, shard_params(params, ctx),
                      {"tokens": tokens, "labels": tokens}, ctx)
    out = {}
    for name, fn in (("groups-serve", serve), ("groups-train", train)):
        t0 = time.monotonic()
        try:
            fn()
            out[name] = "did not raise"
        except NotImplementedError as e:
            out[name] = f"NotImplementedError: {e}"
        out[name + "_s"] = time.monotonic() - t0
    return out


# --- the fixture ------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' arrays and checks."""
    work = str(tmp_path_factory.mktemp("softmax_merge"))
    env = {**os.environ, "PYTHONPATH": SRC}
    port_no = _free_port()
    procs = [(f"rank {rank}", subprocess.Popen(
        [sys.executable, __file__, "rank", str(rank), str(port_no), work],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for rank in range(WORLD)]
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
    arrays, checks = {}, {}
    for rank in range(WORLD):
        arrays[rank] = dict(np.load(os.path.join(work, f"rank{rank}.npz")))
        with open(os.path.join(work, f"rank{rank}.json")) as f:
            checks[rank] = json.load(f)
    return arrays, checks


# --- the tests --------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_merge_equals_one_rank_decode(runs, case):
    """Every rank's output equals one rank's ``attn_decode`` over the
    whole cache within 1e-6, and the ranks' blocks after the step are
    the one-rank cache's slices (the new k and v written by the rank
    whose block holds the slot, nowhere else)."""
    arrays, checks = runs
    want, cache = _one_rank(case)
    for rank in range(WORLD):
        np.testing.assert_allclose(arrays[rank][f"{case}/out"],
                                   want.numpy(), rtol=MERGE_TOL,
                                   atol=MERGE_TOL)
        start, size, length, axis = checks[rank][f"{case}/block"]
        assert (size, length, axis) == (C // WORLD, C, "model")
        for k, v in cache.items():
            np.testing.assert_array_equal(
                arrays[rank][f"{case}/cache/{k}"],
                v[:, start:start + size].numpy())


@pytest.mark.parametrize("case", list(CASES))
def test_every_rank_gets_the_same_bits(runs, case):
    arrays, _ = runs
    for rank in range(WORLD):
        np.testing.assert_array_equal(arrays[rank][f"{case}/out"],
                                      arrays[0][f"{case}/out"])


@pytest.mark.parametrize("case", list(DEAD))
def test_a_dead_block_changes_no_bit(runs, case):
    """The blocks of ``DEAD[case]`` hold no live slot (their first slot
    is past the new token's and, for the ring, it has not wrapped):
    filling them with other values leaves every rank's output's bits."""
    arrays, checks = runs
    index = CASES[case][2]
    for rank in range(WORLD):
        start = checks[rank][f"{case}/block"][0]
        assert (start > index) == (rank in DEAD[case])
        np.testing.assert_array_equal(arrays[rank][f"{case}/out_filled"],
                                      arrays[rank][f"{case}/out"])


def test_dead_partials_weigh_exactly_zero(runs):
    _, checks = runs
    for rank in range(WORLD):
        assert checks[rank]["dead_merge"] == "ok", checks[rank]


@pytest.mark.parametrize("what", ["train-danube", "train-hymba"])
def test_training_uncovered_layouts_raise_on_every_rank(runs, what):
    """Training where T = 4 does not divide the KV heads (danube) or any
    heads (hymba's hybrid layers), which raised until it was ported: the
    loss equals one rank's, and every rank's gradient of every whole
    leaf is bit-equal to rank 0's."""
    _, checks = runs
    for rank in range(WORLD):
        got = checks[rank][what]
        assert float.fromhex(got["loss"]) == pytest.approx(
            got["one_rank"], rel=1e-6), (rank, got["loss"])
        assert got["whole_leaves"] > 5
        assert got["loss"] == checks[0][what]["loss"]
        assert got["grads"] == checks[0][what]["grads"], rank
        assert checks[rank][what + "_s"] < GROUP_TIMEOUT_S


@pytest.mark.parametrize("what", ["groups-serve", "groups-train"])
def test_ssm_groups_raise_on_every_rank_naming_item_8c(runs, what):
    """SSM heads in 2 groups at T = 2, the one layout the port does not
    cover, raise on every rank alike, in serving and in training, naming
    ROADMAP Queue 1 item 8c, and none hangs."""
    _, checks = runs
    for rank in range(WORLD):
        msg = checks[rank][what]
        assert msg.startswith("NotImplementedError") and \
            "item 8c" in msg, (rank, msg)
        assert msg == checks[0][what]
        assert checks[rank][what + "_s"] < GROUP_TIMEOUT_S


# --- in one process ---------------------------------------------------------

def _ctx(shape, coords):
    from repro_torch.core.mesh import Mesh
    from repro_torch.models.shardrules import ParallelCtx
    axes = ("data", "model")
    mesh = Mesh(axes, dict(zip(axes, shape)), coords=dict(zip(axes, coords)),
                groups={a: None for a in axes})
    return ParallelCtx(mesh=mesh, batch=("data",), tensor="model",
                       tensor_rank=coords[1], tensor_size=shape[1],
                       data_rank=coords[0], data_size=shape[0])


@pytest.mark.parametrize("shape, coords, entry, want", [
    ((1, 4), (0, 2), ("data", "model"), (24, 12, 48, "model")),
    ((1, 4), (0, 3), ("model",), (36, 12, 48, "model")),
    ((1, 4), (0, 1), None, (0, 48, 48, None)),
    ((2, 2), (1, 0), ("data", "model"), (24, 12, 48, "mesh")),
    ((2, 2), (0, 1), ("data", "model"), (12, 12, 48, "mesh")),
    ((2, 2), (1, 1), ("data",), (24, 24, 48, "data")),
    ((2, 2), (1, 1), ("model",), (24, 24, 48, "model")),
    ((4, 1), (3, 0), ("data", "model"), (36, 12, 48, "data")),
], ids=lambda v: str(v).replace(" ", ""))
def test_cache_block_is_the_row_major_block(shape, coords, entry, want):
    """The block's index runs row-major over the entry's axes of more
    than one rank, as ``shardrules._block`` cuts a leaf; its axis is the
    one the merge runs over."""
    from repro_torch.models import tp
    assert tuple(tp.cache_block(entry, 48, _ctx(shape, coords))) == want


def test_cache_blocks_need_max_len_where_a_length_may_be_cut():
    """hymba's KV head at T = 4 and MLA at T = 2 may have their caches'
    length cut: without ``max_len`` ``cache_blocks`` raises; with it,
    the rank's blocks. stablelm's heads divide, and it needs none."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model, tp
    ctx = _ctx((1, 4), (0, 1))
    hymba = get_smoke_config("hymba-1.5b")
    with pytest.raises(ValueError, match="pass max_len"):
        model.cache_blocks(hymba, 2, None, ctx)
    with pytest.raises(ValueError, match="pass max_len"):
        model.cache_blocks(get_smoke_config("deepseek-v2-236b"), 2, None,
                           _ctx((1, 2), (0, 1)))
    assert model.cache_blocks(hymba, 2, 24, ctx) == [
        tp.LengthBlock(6, 6, 24, "model"), tp.LengthBlock(2, 2, 8, "model"),
        tp.LengthBlock(6, 6, 24, "model")]
    stablelm = get_smoke_config("stablelm-3b")
    assert model.cache_blocks(stablelm, 2, None, _ctx((1, 2), (0, 1))) == \
        [None] * len(stablelm.plan)


def test_init_cache_gives_the_prefill_blocks():
    """``init_cache`` under a context gives the rank's blocks of every
    leaf, as ``cache_specs`` lays them out (hymba at T = 4: the length
    of the attention caches, ``conv_x``'s channels and the state's 16
    heads cut, ``conv_b`` / ``conv_c`` whole)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model
    from repro_torch.models.shardrules import _items
    cfg = get_smoke_config("hymba-1.5b")
    got = dict(_items(model.init_cache(cfg, 2, 24, torch.float32, "cpu",
                                       _ctx((1, 4), (0, 1)))))
    assert {k: tuple(v.shape) for k, v in got.items() if k.startswith("0/")
            } == {"0/0/attn/k": (2, 6, 1, 8), "0/0/attn/v": (2, 6, 1, 8),
                  "0/0/ssm/conv_x": (2, 3, 32), "0/0/ssm/conv_b": (2, 3, 4),
                  "0/0/ssm/conv_c": (2, 3, 4),
                  "0/0/ssm/state": (2, 4, 8, 4)}
    assert got["1/0/attn/k"].shape == (2, 2, 1, 8)
    assert got["0/0/ssm/state"].dtype == torch.float32


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    _rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
