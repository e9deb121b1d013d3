"""feel-mlp in the PyTorch port against the reference: loss, gradients
and accuracy from the same (carried-across) weights and data, f32
tolerance 2e-5 (summation order differs between the two frameworks)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fed import feel_model as ref_model

from repro_torch.fed import feel_model
from repro_torch.interop import params_from_numpy, params_to_numpy

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    ref_params = ref_model.init(jax.random.key(3), hidden=16, depth=3,
                                input_dim=32)
    x = rng.normal(size=(24, 32)).astype(np.float32)
    y = rng.integers(0, 10, size=24).astype(np.int32)
    w = (rng.uniform(size=24) < 0.6).astype(np.float32)
    return jax.tree_util.tree_map(np.asarray, ref_params), x, y, w


def test_interop_round_trip_is_exact(case):
    params, *_ = case
    back = params_to_numpy(params_from_numpy(params))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("weighted", [False, True])
def test_loss_and_grads_match_reference(case, weighted):
    params, x, y, w = case
    wt = w if weighted else None
    ref_loss, ref_grads = jax.value_and_grad(ref_model.loss_fn)(
        params, jnp.asarray(x), jnp.asarray(y),
        None if wt is None else jnp.asarray(wt))
    loss, grads = torch.func.grad_and_value(feel_model.loss_fn)(
        params_from_numpy(params), torch.from_numpy(x), torch.from_numpy(y),
        None if wt is None else torch.from_numpy(wt))[::-1]
    np.testing.assert_allclose(float(loss), float(ref_loss), **TOL)
    err = abs(float(loss) - float(ref_loss))
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(grads)),
                    jax.tree_util.tree_leaves(ref_grads)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
        err = max(err, float(np.abs(a - np.asarray(b)).max()))
    print(f"PARITY feel_model loss+grads weighted={weighted}: "
          f"max_abs_err={err:.3g} tol=2e-5")


def test_all_zero_weights_give_zero_loss_and_grads(case):
    params, x, y, _ = case
    zero = torch.zeros(len(y))
    loss, grads = torch.func.grad_and_value(feel_model.loss_fn)(
        params_from_numpy(params), torch.from_numpy(x), torch.from_numpy(y),
        zero)[::-1]
    assert float(loss) == 0.0
    assert all(float(g.abs().max()) == 0.0
               for layer in grads for g in layer.values())


def test_accuracy_and_logits_match_reference(case):
    params, x, y, _ = case
    tp = params_from_numpy(params)
    np.testing.assert_allclose(
        feel_model.apply(tp, torch.from_numpy(x)).numpy(),
        np.asarray(ref_model.apply(params, jnp.asarray(x))), **TOL)
    assert float(feel_model.accuracy(tp, torch.from_numpy(x),
                                     torch.from_numpy(y))) == pytest.approx(
        float(ref_model.accuracy(params, jnp.asarray(x), jnp.asarray(y))))


def test_init_layout_and_device_independence():
    g = lambda: torch.Generator().manual_seed(7)         # noqa: E731
    params = feel_model.init(g(), hidden=16, depth=3, input_dim=32)
    ref = ref_model.init(jax.random.key(0), hidden=16, depth=3,
                         input_dim=32)
    assert [{k: tuple(v.shape) for k, v in layer.items()}
            for layer in params] == [{k: tuple(v.shape)
                                      for k, v in layer.items()}
                                     for layer in ref]
    again = feel_model.init(g(), hidden=16, depth=3, input_dim=32)
    for a, b in zip(params, again):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
