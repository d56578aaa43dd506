"""The port's MoE layer against the JAX package on the same weights.

``repro_torch.models.moe`` is a copy of ``repro/models/moe.py``'s local
path (no mesh). The weights come from the reference's ``moe_init`` as
numpy, the tokens from numpy seeds; everything runs in float32 on the
CPU. Configs: granite-moe's smoke MoEConfig (8 experts, top 4, no shared
expert) and deepseek-v2's (8 experts, top 2, one shared expert; the whole
smoke model is in tests/test_torch_mla.py), at their own capacity factor
of 2.0, where every assignment is routed, and
at 0.5, where some drop. Tolerance: rtol = atol = 1e-4 on outputs and
the aux loss (float32 sums in another order); the routing (top-k
indices, slots, kept assignments) and the dropped share are exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as ref_moe
from repro_torch.models import moe

TOL = 1e-4

CONFIGS = {
    "granite": dict(d_model=64, d_ff=16, n_experts=8, top_k=4,
                    capacity_factor=2.0),
    "deepseek": dict(d_model=64, d_ff=32, n_experts=8, top_k=2, n_shared=1,
                     capacity_factor=2.0),
}


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


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def _pair(name, capacity_factor=None, seed=0):
    kw = dict(CONFIGS[name])
    if capacity_factor is not None:
        kw["capacity_factor"] = capacity_factor
    cfg_ref, cfg = ref_moe.MoEConfig(**kw), moe.MoEConfig(**kw)
    p_ref = ref_moe.moe_init(jax.random.PRNGKey(seed), cfg_ref)
    return cfg_ref, cfg, p_ref, _torch_tree(jax.tree.map(np.asarray, p_ref))


def _tokens(b, s, d, seed):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(
        np.float32)


@pytest.mark.parametrize("capacity_factor", [None, 0.5],
                         ids=["ample", "drops"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_moe_forward_matches_reference(name, capacity_factor):
    """Output, aux loss and dropped share of ``moe_forward`` on 2 x 24
    tokens; at the config's own capacity factor nothing drops, at 0.5
    some assignments do, the same ones in both packages."""
    cfg_ref, cfg, p_ref, p = _pair(name, capacity_factor)
    x = _tokens(2, 24, cfg.d_model, 1)
    want, m_ref = ref_moe.moe_forward(p_ref, jnp.asarray(x), cfg_ref)
    got, m = moe.moe_forward(p, torch.from_numpy(x), cfg)
    assert got.shape == (2, 24, cfg.d_model)
    _close(got, want)
    _close(m["aux_loss"], m_ref["aux_loss"])
    assert float(m["dropped"]) == float(m_ref["dropped"])
    if capacity_factor is None:
        assert float(m["dropped"]) == 0.0
    else:
        assert float(m["dropped"]) > 0.0


@pytest.mark.parametrize("name", list(CONFIGS))
def test_routing_and_dispatch_match_reference(name):
    """``_route``'s top-k weights and indices and the aux loss, then
    ``_dispatch``'s stable order, slots, kept flags and buffer at a
    capacity that drops: a tie in expert id keeps the assignment order,
    as ``jnp.argsort`` does."""
    cfg_ref, cfg, p_ref, p = _pair(name, 0.5, seed=3)
    x = _tokens(1, 40, cfg.d_model, 3)[0]
    w_r, i_r, aux_r = ref_moe._route(p_ref["router"], jnp.asarray(x),
                                     cfg_ref)
    w, i, aux = moe._route(p["router"], torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_r))
    _close(w, w_r)
    _close(aux, aux_r)
    cap = moe._capacity(40, cfg)
    assert cap == ref_moe._capacity(40, cfg_ref)
    buf_r, slot_r, order_r, keep_r = ref_moe._dispatch(
        jnp.asarray(x), i_r, cfg_ref, cap)
    buf, slot, order, keep = moe._dispatch(torch.from_numpy(x), i, cfg, cap)
    np.testing.assert_array_equal(order.numpy(), np.asarray(order_r))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(slot_r))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_r))
    assert not keep.all()
    np.testing.assert_array_equal(buf.numpy(), np.asarray(buf_r))


def test_combine_sums_each_token_in_assignment_order():
    """The combine is a fixed-order sum: two runs give the same bits, and
    the result equals a float64 scatter-add of the same contributions to
    float32 rounding."""
    _, cfg, _, p = _pair("granite", 0.5, seed=4)
    x = torch.from_numpy(_tokens(2, 16, cfg.d_model, 4))
    a, _ = moe.moe_forward(p, x, cfg)
    b, _ = moe.moe_forward(p, x, cfg)
    assert torch.equal(a, b)
    tokens = x.reshape(-1, cfg.d_model)
    top_w, top_i, _ = moe._route(p["router"], tokens, cfg)
    cap = moe._capacity(tokens.shape[0], cfg)
    buf, slot, order, keep = moe._dispatch(tokens, top_i, cfg, cap)
    out_buf = moe._expert_ffn(p["experts"], buf).double()
    flat = out_buf.reshape(-1, cfg.d_model)
    w = top_w.reshape(-1)[order].double() * keep.double()
    want = torch.zeros(tokens.shape, dtype=torch.float64).index_add_(
        0, order // cfg.top_k, flat[torch.where(keep, slot, 0)] * w[:, None])
    _close(a.reshape(want.shape), want, 1e-5)


def test_decode_sized_calls_drop_nothing():
    """At decode a call holds one token a request (T = B): the capacity
    floor of 8 slots covers every assignment."""
    cfg = moe.MoEConfig(d_model=64, d_ff=16, n_experts=32, top_k=8)
    assert moe._capacity(4, cfg) == 8
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_init(cfg, generator=gen, device=torch.device("cpu"))
    _, m = moe.moe_forward(p, torch.randn(4, 1, 64, generator=gen), cfg)
    assert float(m["dropped"]) == 0.0


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def test_moe_init_has_the_reference_structure():
    """Keys, shapes and the reference's fan-ins (the experts' up and gate
    matrices scale by the expert count, the leading axis, as the
    reference's ``dense_init`` defaults it); the router stays float32
    when the experts are drawn in bfloat16."""
    for name in CONFIGS:
        cfg_ref = ref_moe.MoEConfig(**CONFIGS[name])
        cfg = moe.MoEConfig(**CONFIGS[name])
        shapes = jax.eval_shape(lambda: ref_moe.moe_init(
            jax.random.PRNGKey(0), cfg_ref))
        p = moe.moe_init(cfg, generator=torch.Generator().manual_seed(0),
                         device=torch.device("cpu"), dtype=torch.bfloat16)
        assert _shapes(p) == _shapes(shapes)
        assert p["router"].dtype == torch.float32
        assert p["experts"]["w_up"].dtype == torch.bfloat16
        e = cfg.n_experts
        assert float(p["experts"]["w_up"].float().abs().max()) <= \
            2.0 / np.sqrt(e) * (1 + 2 ** -7)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_ref)
