"""The big-model train step of the PyTorch port against the reference, on
the CPU: reduced qwen1.5-4b (2 layers, d_model 256, 4 query / 2 KV heads
of 64, zero-initialized qkv biases set non-zero), K 2 devices x slot 2
of 16-token sequences, the reference's ``init`` weights carried across
through ``interop``.

* ``momentum`` and ``adamw`` (with and without weight decay) over 3
  updates: parameters and state within 1e-6 of the reference's; the
  port's in-place leaf-by-leaf application bitwise its functional one.
* ``make_train_step`` with ``sgd`` and ``momentum`` over 3 steps at
  B_k = (1, 2): ``loss``, ``total_loss``, ``grad_norm`` and the
  parameters within 1e-5 of the reference's jitted step
  (``tests/test_torch_train_uplink.py`` holds the compressed steps).
* ``adamw`` (with and without ``compress_uplink``), teacher-forced step
  by step: each step's ``loss``, ``total_loss`` and ``grad_norm`` within
  1e-5 (1e-4 compressed) of the reference's at the port's parameters,
  and the port's new parameters, state and residual within the same of
  the reference's SBC and AdamW fed the port's own gradients.  Run free,
  the two drift apart beyond that after one step: AdamW's first update
  is lr·g/(|g| + eps), so an element whose gradient is at rounding level
  (|g| ~ eps = 1e-8) moves by up to ±lr on either side of a last-bit
  gap in g (0.044 at lr 0.1 on 26 elements here).
* The step's update is eq. (1)'s combination of per-device gradients
  (the reference's ``test_weighted_step_matches_eq1``).
* ``make_multi_train_step`` is bitwise T single steps and within 1e-5 of
  the reference's scan."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compression import sbc as ref_sbc
from repro.configs import ARCHS as REF_ARCHS
from repro.fed import train_step as ref_ts
from repro.models import model as rm
from repro import optim as ref_optim

from repro_torch import optim
from repro_torch.configs import get_arch
from repro_torch.fed.train_step import (TrainState, apply_in_place,
                                        make_loss_fn, make_multi_train_step,
                                        make_train_step)
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.models.model import Runtime
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

K, SLOT, S = 2, 2, 16
LRS = (0.1, 0.05, 0.02)
RT = Runtime(attn_impl="naive")
REF_RT = rm.Runtime(dtype=jnp.float32, attn_impl="naive")
OPTS = {"sgd": (optim.sgd, ref_optim.sgd),
        "momentum": (optim.momentum, ref_optim.momentum),
        "adamw": (optim.adamw, ref_optim.adamw)}


def qwen_setup(seed=0):
    """(reference config, port config, numpy params with non-zero qkv
    biases, numpy batch at B_k = (1, 2))."""
    ref_cfg = REF_ARCHS["qwen1.5-4b"].reduced()
    cfg = get_arch("qwen1.5-4b").reduced()
    params = jax.tree_util.tree_map(
        np.asarray, rm.init(ref_cfg, jax.random.key(seed)))
    rng = np.random.default_rng(seed + 1)
    attn = params["layers"]["attn"]
    for name in ("bq", "bk", "bv"):
        attn[name] = (0.1 * rng.normal(size=attn[name].shape)).astype(
            np.float32)
    toks = rng.integers(0, cfg.vocab, (K * SLOT, S + 1)).astype(np.int32)
    w = np.zeros((K, SLOT), np.float32)
    w[0, :1] = 1.0                                  # B_0 = 1
    w[1, :2] = 1.0                                  # B_1 = 2
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "weights": np.broadcast_to(w.reshape(-1)[:, None],
                                        (K * SLOT, S)).copy()}
    return ref_cfg, cfg, params, batch


def to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def run_reference(ref_cfg, params, batch, ref_opt, compress, steps=3):
    step = jax.jit(ref_ts.make_train_step(ref_cfg, REF_RT, ref_opt,
                                          compress_uplink=compress))
    p = to_jax(params)
    state = ref_ts.TrainState(p, ref_opt.init(p), jnp.zeros((), jnp.int32))
    metrics = []
    for lr in LRS[:steps]:
        state, m = step(state, to_jax(batch), lr)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def run_port(cfg, params, batch, opt, compress, steps=3):
    step = make_train_step(cfg, RT, opt, compress_uplink=compress)
    p = params_from_numpy(params)
    state = TrainState(p, opt.init(p), 0)
    metrics = []
    for lr in LRS[:steps]:
        state, m = step(state, to_torch(batch), lr)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def compare_runs(ref, port, tol, label):
    (ref_state, ref_m), (state, m) = ref, port
    for a, b in zip(m, ref_m):
        for key in ("loss", "total_loss", "grad_norm"):
            np.testing.assert_allclose(a[key], b[key], rtol=tol, atol=tol,
                                       err_msg=f"{label} {key}")
    err = 0.0
    for a, b in zip(tree_leaves(params_to_numpy(state.params)),
                    jax.tree_util.tree_leaves(ref_state.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol,
                                   err_msg=label)
        err = max(err, float(np.abs(a - np.asarray(b)).max()))
    print(f"PARITY train_step {label}: 3 steps, params max_abs_err="
          f"{err:.3g} tol={tol}")
    assert state.step == 3


@pytest.mark.parametrize("name", ["momentum", "sgd"])
def test_train_step_matches_reference(name):
    ref_cfg, cfg, params, batch = qwen_setup()
    make, ref_make = OPTS[name]
    compare_runs(run_reference(ref_cfg, params, batch, ref_make(), False),
                 run_port(cfg, params, batch, make(), False), 1e-5, name)


def port_grads(cfg, params, batch):
    """The port's gradients of the weighted CE at ``params`` (the same
    autograd call as inside the train step)."""
    leaves = [t.clone().requires_grad_() for t in tree_leaves(params)]
    views = tree_unflatten(params, [t[None] for t in leaves])
    b = {k: v[None] for k, v in to_torch(batch).items()}
    loss = make_loss_fn(cfg, RT)(views, b)[0]
    return tree_unflatten(params, list(torch.autograd.grad(loss, leaves)))


def adamw_teacher_forced(compress: bool, tol: float):
    ref_cfg, cfg, params, batch = qwen_setup()
    opt, ref_opt = optim.adamw(), ref_optim.adamw()
    p = params_from_numpy(params)
    state = TrainState(p, opt.init(p), 0)
    step = make_train_step(cfg, RT, opt, compress_uplink=compress)
    ref_vg = jax.jit(jax.value_and_grad(ref_ts.make_loss_fn(ref_cfg, REF_RT),
                                        has_aux=True))

    def ref_update(g, st, p, res, lr):
        if compress:
            g, res = ref_sbc.compress_dense(g, 0.005, res)
        upd, st = ref_opt.update(g, st, p, lr)
        gnorm = jnp.sqrt(sum(jnp.sum(jnp.square(x))
                             for x in jax.tree_util.tree_leaves(g)))
        return ref_optim.apply_updates(p, upd), st, res, gnorm

    ref_update = jax.jit(ref_update)
    err = 0.0
    for lr in LRS:
        # copies: the step writes into the tensors numpy() would share
        before = tree_map(np.copy, params_to_numpy((state.params,
                                                    state.opt)))
        res = (tree_map(np.copy, params_to_numpy(state.residual))
               if state.residual is not None
               else jax.tree_util.tree_map(np.zeros_like, before[0]))
        grads = params_to_numpy(port_grads(cfg, state.params, batch))
        state, m = step(state, to_torch(batch), lr)
        (total, ce), ref_g = ref_vg(to_jax(before[0]), to_jax(batch))
        new_p, new_st, new_res, ref_norm = ref_update(
            to_jax(grads), to_jax(before[1]), to_jax(before[0]),
            to_jax(res), lr)
        _, _, _, ref_gnorm = ref_update(ref_g, to_jax(before[1]),
                                        to_jax(before[0]), to_jax(res), lr)
        for key, want in (("loss", ce), ("total_loss", total),
                          ("grad_norm", ref_gnorm)):
            np.testing.assert_allclose(float(m[key]), float(want), rtol=tol,
                                       atol=tol, err_msg=key)
        np.testing.assert_allclose(float(m["grad_norm"]), float(ref_norm),
                                   rtol=tol, atol=tol)
        want = (new_p, new_st) + ((new_res,) if compress else ())
        got = (state.params, state.opt) + ((state.residual,) if compress
                                           else ())
        for a, b in zip(tree_leaves(params_to_numpy(got)),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)
            err = max(err, float(np.abs(a - np.asarray(b)).max()))
    print(f"PARITY train_step adamw compress={compress}, teacher-forced: "
          f"3 steps, max_abs_err={err:.3g} tol={tol}")
    assert state.step == 3


def test_adamw_step_matches_reference_teacher_forced():
    adamw_teacher_forced(False, 1e-5)


def _opt_inputs(seed=3):
    rng = np.random.default_rng(seed)
    params = {"a": rng.normal(size=(3, 5)).astype(np.float32),
              "b": [rng.normal(size=(7,)).astype(np.float32)]}
    grads = [jax.tree_util.tree_map(
        lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("name,kw", [
    ("momentum", {}), ("adamw", {}), ("adamw", {"weight_decay": 0.1})])
def test_optimizers_match_reference(name, kw):
    params, grads = _opt_inputs()
    make, ref_make = OPTS[name]
    opt, ref_opt = make(**kw), ref_make(**kw)
    p, rp = params_from_numpy(params), to_jax(params)
    st, rst = opt.init(p), ref_opt.init(rp)
    # the in-place, leaf-by-leaf application on its own copy
    ip = tree_map(torch.clone, p)
    ist = tree_map(torch.clone, st)
    for g, lr in zip(grads, LRS):
        upd, st = opt.update(params_from_numpy(g), st, p, lr)
        p = optim.apply_updates(p, upd)
        rupd, rst = ref_opt.update(to_jax(g), rst, rp, lr)
        rp = ref_optim.apply_updates(rp, rupd)
        apply_in_place(opt, ip, tree_leaves(params_from_numpy(g)), ist, lr)
    for a, b in zip(tree_leaves(params_to_numpy((p, st))),
                    jax.tree_util.tree_leaves((rp, rst))):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)
    for a, b in zip(tree_leaves((ip, ist)), tree_leaves((p, st))):
        assert torch.equal(a, b)
    print(f"PARITY {name}{kw}: 3 updates tol=1e-6; in place bitwise")


def test_weighted_step_matches_eq1():
    """The step with masked weights applies eq. (1)'s combination of the
    two devices' gradients, (1·g_0 + 2·g_1) / 3 (the reference's
    tolerance); the step is in place, so the old parameters are cloned
    first."""
    _, cfg, params, batch = qwen_setup()
    opt = optim.sgd()
    p = params_from_numpy(params)
    old = tree_map(torch.clone, p)
    state, metrics = make_train_step(cfg, RT, opt)(
        TrainState(p, opt.init(p), 0), to_torch(batch), 0.1)
    assert np.isfinite(float(metrics["loss"]))
    assert state.params is p and state.step == 1

    def dev_grad(sl):
        return tree_leaves(port_grads(cfg, old, {k: v[sl] for k, v in
                                                 batch.items()}))

    g0 = dev_grad(slice(0, SLOT))
    g1 = dev_grad(slice(SLOT, 2 * SLOT))
    for new, o, a, b in zip(tree_leaves(state.params), tree_leaves(old),
                            g0, g1):
        np.testing.assert_allclose(((o - new) / 0.1).numpy(),
                                   ((1 * a + 2 * b) / 3.0).numpy(),
                                   atol=5e-5, rtol=5e-3)


def test_multi_train_step_is_single_steps_and_matches_reference_scan():
    ref_cfg, cfg, params, _ = qwen_setup()
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (3, 2, 9)).astype(np.int32)
    batches = {"tokens": toks[..., :-1], "labels": toks[..., 1:],
               "weights": np.ones((3, 2, 8), np.float32)}
    lrs = np.array(LRS, np.float32)
    opt = optim.momentum()
    p = params_from_numpy(params)
    state, metrics = make_multi_train_step(cfg, RT, opt)(
        TrainState(p, opt.init(p), 0), to_torch(batches), lrs)
    assert metrics["loss"].shape == (3,) and state.step == 3
    step = make_train_step(cfg, RT, opt)
    q = params_from_numpy(params)
    seq = TrainState(q, opt.init(q), 0)
    for t in range(3):
        seq, m = step(seq, {k: v[t] for k, v in to_torch(batches).items()},
                      float(lrs[t]))
        assert torch.equal(m["loss"], metrics["loss"][t])
    for a, b in zip(tree_leaves((seq.params, seq.opt)),
                    tree_leaves((state.params, state.opt))):
        assert torch.equal(a, b)
    ref_opt = ref_optim.momentum()
    rp = to_jax(params)
    ref_state, ref_metrics = jax.jit(ref_ts.make_multi_train_step(
        ref_cfg, REF_RT, ref_opt))(
        ref_ts.TrainState(rp, ref_opt.init(rp), jnp.zeros((), jnp.int32)),
        to_jax(batches), jnp.asarray(lrs))
    for key in ("loss", "total_loss", "grad_norm"):
        np.testing.assert_allclose(metrics[key].numpy(),
                                   np.asarray(ref_metrics[key]), rtol=1e-5,
                                   atol=1e-5)
    for a, b in zip(tree_leaves(params_to_numpy(state.params)),
                    jax.tree_util.tree_leaves(ref_state.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)
