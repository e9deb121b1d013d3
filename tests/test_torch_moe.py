"""The MoE layer of the PyTorch port (``repro_torch.models.moe``) against
the reference's ``repro.models.moe``, on the CPU, with the reference's
weights carried across (a copy axis of 1 added):

* values, the load-balance aux loss and every gradient (``jax.grad``
  against autograd, of ``sum(y · r) + aux`` for a fixed random r) within
  2e-5: the four shared / dense-residual cases of ``tests/test_moe.py``
  drop-free, token-choice scatter at capacity factors 1.25 and 0.5 (drops)
  and drop-free, and expert choice;
* routing equal on the reference's own router probabilities: expert
  indices, capacity positions and keep masks (and the gates), expert
  choice's token picks — with a constant router too, where every gate
  ties and ``torch.topk`` picks other experts;
* ``capacity`` over a grid of sizes, factors and expert counts."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as RefArchConfig
from repro.configs.base import MoEConfig as RefMoEConfig
from repro.models import moe as rmoe

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.interop import params_from_numpy
from repro_torch.models import moe
from repro_torch.tree import tree_leaves, tree_map

TOL = 2e-5
D = 32


def _configs(n_experts=4, top_k=2, n_shared=0, dense_residual=False):
    arch = dict(name="t", family="moe", n_layers=1, d_model=D, n_heads=2,
                n_kv_heads=2, d_ff=64, vocab=64)
    m = dict(n_experts=n_experts, top_k=top_k, d_ff_expert=16,
             n_shared=n_shared, dense_residual=dense_residual)
    return (RefArchConfig(**arch, moe=RefMoEConfig(**m)),
            ArchConfig(**arch, moe=MoEConfig(**m)))


def _parity(name, got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=name)
    return float(np.abs(got - want).max())


# (id, config kwargs, (B, S), forward kwargs): the cap of a drop-free case
# is S·top_k, the reference's decode capacity
CASES = [
    ("shared0-dense0", dict(), (2, 8), dict(cap=16)),
    ("shared1", dict(n_shared=1), (2, 8), dict(cap=16)),
    ("dense-residual", dict(dense_residual=True), (2, 8), dict(cap=16)),
    ("shared2-dense-residual", dict(n_shared=2, dense_residual=True), (2, 8),
     dict(cap=16)),
    ("scatter-cf1.25", dict(n_experts=8), (4, 16),
     dict(capacity_factor=1.25)),
    ("scatter-cf0.5-drops", dict(n_experts=8), (4, 16),
     dict(capacity_factor=0.5)),
    ("scatter-drop-free", dict(n_experts=8), (4, 16), dict(cap=32)),
    ("expert-choice", dict(n_experts=4, n_shared=1), (2, 16),
     dict(impl="expert_choice")),
]


@functools.lru_cache(maxsize=None)
def _reference(case_id):
    """The case's configs, the reference's weights, input and cotangent
    (numpy), and its y, aux and gradients (params, x)."""
    _, kw, (b, s), fkw = next(c for c in CASES if c[0] == case_id)
    ref_cfg, cfg = _configs(**kw)
    params = jax.tree_util.tree_map(
        np.asarray, rmoe.moe_init(jax.random.key(7), ref_cfg, jnp.float32))
    rng = np.random.default_rng(len(case_id))
    x = rng.normal(size=(b, s, D)).astype(np.float32)
    r = rng.normal(size=(b, s, D)).astype(np.float32)

    @jax.jit
    def run(p, xx):
        def loss(p, xx):
            y, aux = rmoe.moe_forward(p, ref_cfg, xx, **fkw)
            return jnp.sum(y * r) + aux, (y, aux)
        (_, (y, aux)), grads = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(p, xx)
        return y, aux, grads

    y, aux, grads = run(params, jnp.asarray(x))
    return cfg, fkw, params, x, r, (y, aux, grads)


@pytest.mark.parametrize("case_id", [c[0] for c in CASES])
def test_moe_forward_aux_and_grads_match_the_reference(case_id):
    cfg, fkw, ref_params, x, r, (want_y, want_aux, want_grads) = \
        _reference(case_id)
    params = tree_map(lambda t: t[None].requires_grad_(),
                      params_from_numpy(ref_params))
    xt = torch.from_numpy(x)[None].requires_grad_()
    y, aux = moe.moe_forward(params, cfg, xt, **fkw)
    assert aux.shape == (1,) and aux.dtype == torch.float32
    leaves = tree_leaves(params)
    grads = torch.autograd.grad((y * torch.from_numpy(r)).sum() + aux[0],
                                leaves + [xt])
    err = _parity("y", y[0].detach(), want_y)
    aux_err = _parity("aux", aux[0].detach(), want_aux)
    ref_leaves = jax.tree_util.tree_leaves(want_grads[0])
    grad_err = max(_parity("grad", g[0], w)
                   for g, w in zip(grads[:-1], ref_leaves))
    grad_err = max(grad_err, _parity("grad x", grads[-1][0], want_grads[1]))
    assert float(np.abs(np.asarray(want_y)).max()) > 0
    print(f"PARITY moe_forward {case_id}: y max_abs_err={err:.3g}, aux "
          f"{aux_err:.3g}, grads {grad_err:.3g} tol={TOL}")


@pytest.mark.parametrize("router", ["drawn", "constant"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_routing_equals_the_reference(router, capacity_factor):
    """Indices, positions and keep masks equal (gates within 2e-5) on the
    reference's probabilities; the constant router ties every gate, where
    ``torch.topk`` would pick other experts."""
    ref_cfg, cfg = _configs(n_experts=8)
    params = rmoe.moe_init(jax.random.key(3), ref_cfg, jnp.float32)
    if router == "constant":
        params = dict(params, router=jnp.zeros_like(params["router"]))
    x = jnp.asarray(np.random.default_rng(5).normal(size=(4, 16, D)),
                    jnp.float32)
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x, params["router"]),
                           axis=-1)
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    C = min(rmoe.capacity(16, ref_cfg, capacity_factor), 16 * K)
    _, want = rmoe._dispatch_scatter(probs, x, E, K, C)
    probs_np = np.array(probs)
    got = moe.route_scatter(torch.from_numpy(probs_np)[None], K, C)
    for name, g, w in zip(("expert_idx", "gate_vals", "pos", "keep"), got,
                          want):
        if name == "gate_vals":
            _parity(name, g[0], w)
        else:
            assert np.array_equal(g[0].numpy(), np.asarray(w)), name
    keep = np.asarray(want[3])
    assert keep.any() and (capacity_factor == 1.25 or not keep.all())
    want_p, want_i = jax.lax.top_k(probs.swapaxes(1, 2), min(16, C))
    got_p, got_i = moe.route_expert_choice(torch.from_numpy(probs_np)[None],
                                           C)
    assert np.array_equal(got_i[0].numpy(), np.asarray(want_i))
    _parity("expert choice probs", got_p[0], want_p)
    if router == "constant":
        assert (np.asarray(want[0]) == [0, 1]).all()
        tk = torch.topk(torch.from_numpy(probs_np), K).indices
        assert not np.array_equal(tk.numpy(), np.asarray(want[0]))
    print(f"PARITY moe routing router={router} cf={capacity_factor} C={C}: "
          f"indices, positions, keep masks equal ({int(keep.sum())} of "
          f"{keep.size} kept) tol=exact")


def test_capacity_matches_the_reference_over_a_grid():
    for n_experts, top_k in ((4, 2), (8, 2), (64, 6), (128, 2)):
        ref_cfg, cfg = _configs(n_experts=n_experts, top_k=top_k)
        for tokens in (1, 2, 3, 7, 16, 31, 64, 100, 256, 1000, 4096):
            for factor in (0.5, 1.0, 1.25, 2.0):
                assert (moe.capacity(tokens, cfg, factor)
                        == rmoe.capacity(tokens, ref_cfg, factor)), (
                    n_experts, top_k, tokens, factor)
