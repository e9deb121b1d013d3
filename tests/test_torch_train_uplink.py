"""The big-model train step with the SBC uplink (``compress_uplink``) in
the PyTorch port against the reference, on the CPU, at the sizes of
``tests/test_torch_train.py`` (reduced qwen1.5-4b, K 2 x slot 2 x 16
tokens, the reference's weights carried across).

* ``sbc_uplink`` on the CPU is bitwise the port's ``compress_dense`` (the
  reference's CPU contract) and updates the gradients and the residual
  in place; against the reference's ``sbc_uplink`` the keep masks are
  equal and the values within 2e-5 (``tests/test_torch_sbc.py``'s bound:
  the group sums are taken in another order).
* ``make_train_step(compress_uplink=True)`` with ``sgd`` and ``momentum``
  over 3 steps: ``loss``, ``total_loss``, ``grad_norm`` and the
  parameters within 1e-4 of the reference's; ``adamw`` teacher-forced
  step by step within 1e-4 (why: ``tests/test_torch_train.py``).
* A reduced mamba2-2.7b compressed momentum step runs, with a finite
  loss and a positive gradient norm (the reference's
  ``test_compress_uplink_step_runs``)."""
import jax
import numpy as np
import pytest
import torch

from repro.compression import sbc as ref_sbc

from repro_torch import optim
from repro_torch.compression import sbc
from repro_torch.configs import get_arch
from repro_torch.fed.train_step import TrainState, make_train_step
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.models import model as tm
from repro_torch.tree import tree_leaves, tree_map

from test_torch_train import (OPTS, RT, adamw_teacher_forced, compare_runs,
                              qwen_setup, run_port, run_reference, to_jax)


def test_sbc_uplink_is_compress_dense_in_place_and_matches_reference():
    """Three leaves of the reduced qwen's shapes."""
    _, _, params, _ = qwen_setup()
    attn = params["layers"]["attn"]
    rng = np.random.default_rng(11)
    grads = {name: rng.normal(size=attn[name].shape).astype(np.float32)
             for name in ("bk", "wo", "wq")}
    resid = tree_map(lambda a: (0.1 * rng.normal(size=a.shape)).astype(
        np.float32), grads)
    g, r = params_from_numpy(grads), params_from_numpy(resid)
    want = sbc.compress_dense(params_from_numpy(grads), 0.005,
                              params_from_numpy(resid))
    out, new_res = sbc.sbc_uplink(g, 0.005, r)
    assert out is g and new_res is r
    for a, b in zip(tree_leaves((out, new_res)), tree_leaves(want)):
        assert torch.equal(a, b)
    ref_out, ref_res = jax.jit(ref_sbc.sbc_uplink, static_argnums=1)(
        to_jax(grads), 0.005, to_jax(resid))
    err = 0.0
    for a, b, keep in zip(tree_leaves(params_to_numpy((out, new_res))),
                          jax.tree_util.tree_leaves((ref_out, ref_res)),
                          [True] * len(tree_leaves(out))
                          + [False] * len(tree_leaves(out))):
        np.testing.assert_allclose(a, np.asarray(b), rtol=2e-5, atol=2e-5)
        if keep:
            np.testing.assert_array_equal(a != 0, np.asarray(b) != 0)
        err = max(err, float(np.abs(a - np.asarray(b)).max()))
    print(f"PARITY sbc_uplink: keep masks equal, max_abs_err={err:.3g} "
          f"tol=2e-5; bitwise compress_dense")
    # no residual: starts from zeros
    out0, res0 = sbc.sbc_uplink(params_from_numpy(grads), 0.005)
    want0 = sbc.compress_dense(params_from_numpy(grads), 0.005)
    for a, b in zip(tree_leaves((out0, res0)), tree_leaves(want0)):
        assert torch.equal(a, b)
    assert len(tree_leaves(out)) == 3


@pytest.mark.parametrize("name", ["momentum", "sgd"])
def test_compressed_train_step_matches_reference(name):
    ref_cfg, cfg, params, batch = qwen_setup()
    make, ref_make = OPTS[name]
    compare_runs(run_reference(ref_cfg, params, batch, ref_make(), True),
                 run_port(cfg, params, batch, make(), True), 1e-4,
                 f"{name} compressed")


def test_compressed_adamw_step_matches_reference_teacher_forced():
    adamw_teacher_forced(True, 1e-4)


def test_compress_uplink_step_runs():
    cfg = get_arch("mamba2-2.7b").reduced()
    params = tm.init(cfg, torch.Generator().manual_seed(0))
    opt = optim.momentum()
    step = make_train_step(cfg, RT, opt, compress_uplink=True,
                           compress_ratio=0.01)
    toks = torch.randint(0, cfg.vocab, (2, 17),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "weights": torch.ones((2, 16))}
    state, metrics = step(TrainState(params, opt.init(params), 0), batch,
                          0.05)
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["grad_norm"]) > 0
    assert state.residual is not None and state.step == 1
