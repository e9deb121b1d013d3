"""The transformer family in the PyTorch port against the reference, on
the CPU, with the reference's weights carried across (torch cannot
reproduce ``jax.random``).

* Model forward: logits against ``repro.models.model.forward`` with the
  kernel runtime, 2e-5.
* Per-device gradients: the port's per-device parameter copies under one
  backward against the reference's ``jax.vmap(jax.grad(...))``
  (``model_engine.py:141-146``), 2e-5; a padded device (all-zero
  weights) has an exactly zero gradient.
* One ``_model_period_step`` from an identical carry with compression on:
  2e-5, and the SBC keep masks equal.
* ``Experiment.run`` on a 2-spec grid (ragged K = 4 and 3, 2 seeds, 4
  periods): host ledgers bitwise; losses and accuracies 1e-5 without
  compression and 1e-4 with it (room for an SBC boundary tie, as for
  feel-mlp).
* The same uncompressed grid one period at a time, each period started
  from the reference's own carry: losses and accuracies within 1e-5
  absolute, parameters 2e-5.  Carried over four periods the gap grows
  past 1e-5 absolute (it stays inside ``rtol=atol=1e-5``); the test
  prints it beside the reference's own spread from an init moved by one
  ulp, which is of the same size: the trajectory, not a period step,
  amplifies float32 rounding (RMSNorm after an embedding of scale 0.02).
* Within the port: chunked == monolithic bitwise; a feel-mlp and a
  transformer spec with equal hidden/depth/seed keep the reference's
  ledgers (``bucket_key`` separates the families)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as ref_api
from repro.api import lowering as ref_lowering
from repro.core import DeviceProfile as RefDevice
from repro.data.pipeline import ClassificationData as RefData
from repro.fed import engine as ref_engine
from repro.fed import model_engine as ref_me
from repro.fed.train_step import TrainState as RefTrainState
from repro.fed.train_step import make_loss_fn as ref_make_loss_fn
from repro.models.model import forward as ref_forward
from repro.models.model import init as ref_init
from repro.optim import sgd as ref_sgd

from repro_torch.api import Experiment, ScenarioSpec, SerialExecutor
from repro_torch.api import lowering
from repro_torch.core.latency import DeviceProfile
from repro_torch.data.pipeline import ClassificationData
from repro_torch.fed import engine, model_engine
from repro_torch.fed.train_step import TrainState, make_loss_fn
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.models.model import forward
from repro_torch.optim import sgd
from repro_torch.tree import tree_leaves

TOL = dict(rtol=2e-5, atol=2e-5)
HIDDEN, DEPTH, K, SLOT = 32, 2, 4, 8
tmap = jax.tree_util.tree_map


@pytest.fixture(scope="module")
def case():
    cfg = ref_me.family_arch("transformer", HIDDEN, DEPTH)
    params = tmap(np.asarray, ref_init(cfg, jax.random.key(5)))
    data = RefData.synthetic(n=200, dim=32, seed=1, spread=6.0)
    tok, lab = ref_me.tokenize(data)
    rng = np.random.default_rng(0)
    batch = np.array([8, 3, 5, 0], np.float32)        # last user padded
    xs = {"idx": rng.integers(0, 200, size=(K, SLOT)).astype(np.int32),
          "weight": (np.arange(SLOT)[None, :] < batch[:, None]).astype(
              np.float32),
          "batch": batch, "lr": np.float32(0.3), "aggden": np.float32(0.0),
          "active": np.array([1, 1, 1, 0], np.float32)}
    residual = tmap(lambda p: (rng.normal(size=(K,) + p.shape) * 1e-3)
                    .astype(np.float32), params)
    return cfg, params, tok, lab, data.y, xs, residual


def _batched(tree):
    return params_from_numpy(tmap(lambda a: np.asarray(a)[None], tree))


def _max_err(got, want):
    errs = []
    for a, b in zip(tree_leaves(params_to_numpy(got)),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.reshape(np.shape(b)), np.asarray(b),
                                   **TOL)
        errs.append(float(np.abs(a.reshape(np.shape(b)) - b).max()))
    return max(errs)


def test_model_forward_matches_reference(case):
    cfg, params, tok, *_ = case
    want, _ = ref_forward(cfg, params, jnp.asarray(tok[:6]),
                          rt=ref_me.KERNEL_RT)
    got = forward(model_engine.family_arch("transformer", HIDDEN, DEPTH),
                  _batched(params), torch.from_numpy(tok[:6])[None],
                  rt=model_engine.KERNEL_RT)[0][0]
    live = np.asarray(want)[..., :cfg.vocab]
    np.testing.assert_allclose(got.numpy()[..., :cfg.vocab], live, **TOL)
    np.testing.assert_array_equal(got.numpy()[..., cfg.vocab:],
                                  np.asarray(want)[..., cfg.vocab:])
    print(f"PARITY transformer forward logits: max_abs_err="
          f"{float(np.abs(got.numpy()[..., :cfg.vocab] - live).max()):.3g}"
          f" tol=2e-5")


@pytest.fixture(scope="module")
def ref_grads(case):
    """The reference's per-device gradients (``model_engine.py:141-146``)."""
    cfg, params, tok, lab, _, xs, _ = case
    loss_fn = ref_make_loss_fn(cfg, ref_me.KERNEL_RT)
    t, l_ = tok[xs["idx"]], lab[xs["idx"]]
    wt = np.broadcast_to(xs["weight"][..., None], l_.shape).astype(
        np.float32)

    def dev_grad_loss(p, tk, lk, wk):
        return loss_fn(p, {"tokens": tk, "labels": lk, "weights": wk})[0]

    return jax.jit(jax.vmap(jax.grad(dev_grad_loss),
                            in_axes=(None, 0, 0, 0)))(
        params, jnp.asarray(t), jnp.asarray(l_), jnp.asarray(wt))


def _port_device_grads(params, tok, lab, xs):
    cfg = model_engine.family_arch("transformer", HIDDEN, DEPTH)
    idx = torch.from_numpy(xs["idx"])
    t, l_ = torch.from_numpy(tok)[idx], torch.from_numpy(lab)[idx]
    w = torch.from_numpy(xs["weight"])[..., None].expand(l_.shape)
    return model_engine._device_grads(
        make_loss_fn(cfg, model_engine.KERNEL_RT), _batched(params),
        {"tokens": t, "labels": l_, "weights": w}, K)


def test_per_device_gradients_match_reference_vmap_grad(case, ref_grads):
    cfg, params, tok, lab, _, xs, _ = case
    got = _port_device_grads(params, tok, lab, xs)
    err = _max_err(got, ref_grads)
    for leaf in tree_leaves(got):
        assert leaf.shape[:2] == (1, K)
        assert torch.equal(leaf[0, 3], torch.zeros_like(leaf[0, 3]))
    print(f"PARITY per-device gradients (copies vs vmap(grad)): "
          f"max_abs_err={err:.3g} tol=2e-5; padded device exactly 0")


def _kept(new_res, grad, old_res):
    moved = np.abs(new_res - (grad + old_res))
    return moved > 1e-3 * np.abs(grad + old_res).max()


def test_period_step_matches_reference(case, ref_grads):
    cfg, params, tok, lab, y, xs, residual = case
    test_tok, test_y = tok[:40], y[:40]
    rt, opt = ref_me.KERNEL_RT, ref_sgd()
    step = jax.jit(functools.partial(
        ref_me._model_period_step, cfg, rt, ref_make_loss_fn(cfg, rt), opt,
        True, 0.05))
    (rstate, rres), (rl, ra, rd) = step(
        *map(jnp.asarray, (tok, lab, test_tok, test_y)),
        (RefTrainState(params, opt.init(params), jnp.zeros((), jnp.int32)),
         residual), {k: jnp.asarray(v) for k, v in xs.items()})

    pcfg = model_engine.family_arch("transformer", HIDDEN, DEPTH)
    popt = sgd()
    start = _batched(params)
    pres = _batched(residual)
    state, (loss, acc, decay) = model_engine._model_period_step(
        pcfg, model_engine.KERNEL_RT,
        make_loss_fn(pcfg, model_engine.KERNEL_RT), popt, True, 0.05,
        engine.host_to_device((tok, lab, test_tok, test_y), "cpu"),
        torch.from_numpy(xs["active"])[None],
        TrainState(start, popt.init(start), 0, pres),
        engine.host_to_device({k: np.asarray(xs[k])[None] for k in
                               ("idx", "weight", "batch", "lr", "aggden")}, "cpu"))
    err = max(_max_err(state.params, rstate.params),
              _max_err(state.residual, rres))
    np.testing.assert_allclose(float(loss[0]), float(rl), **TOL)
    np.testing.assert_allclose(float(decay[0]), float(rd), **TOL)
    assert float(acc[0]) == pytest.approx(float(ra))
    # keep masks: a kept value moves its residual off grad + old residual
    # by the group value; a dropped one leaves it there (up to rounding)
    pgrads = _port_device_grads(params, tok, lab, xs)
    for rg, rr0, rr1, pg, pr0, pr1 in zip(
            *map(jax.tree_util.tree_leaves, (ref_grads, residual, rres)),
            *map(tree_leaves, (pgrads, pres, state.residual))):
        np.testing.assert_array_equal(
            _kept(pr1[0].numpy(), pg[0].numpy(), pr0[0].numpy()),
            _kept(np.asarray(rr1), np.asarray(rg), rr0))
        assert 0 < _kept(pr1[0].numpy(), pg[0].numpy(), pr0[0].numpy()).sum(
        ) < pg[0].numel()
    print(f"PARITY transformer _model_period_step compress=True: "
          f"max_abs_err={err:.3g} tol=2e-5; keep masks equal")


# ---------------------------------------------------------------------------
# the whole slice: Experiment.run
# ---------------------------------------------------------------------------


def _reference_init(rows, input_dim, device):
    s = rows[0].spec
    keys = jnp.stack([jax.random.key(r.seed) for r in rows])
    return params_from_numpy(tmap(np.asarray, ref_me.init_params_batch(
        s.model_family, s.hidden, s.depth, keys)), device)


def _fleet(DP, k):
    return tuple(DP(kind="cpu", f_cpu=[0.7e9, 1.4e9, 2.1e9][i % 3])
                 for i in range(k))


def _grid(Spec, DP, **kw):
    kw = dict(dict(hidden=16, depth=2, b_max=8, base_lr=0.1, seeds=(0, 1),
                   compression=0.05, model_family="transformer"), **kw)
    return [Spec(fleet=_fleet(DP, 4), partition="iid", **kw),
            Spec(fleet=_fleet(DP, 3), partition="noniid", **kw)]


@pytest.fixture(scope="module")
def datasets():
    return (ClassificationData.synthetic(n=400, dim=32, seed=0,
                                         spread=6.0).split(80),
            RefData.synthetic(n=400, dim=32, seed=0, spread=6.0).split(80))


@pytest.mark.parametrize("compress,tol", [(False, 1e-5), (True, 1e-4)])
def test_experiment_run_matches_reference(monkeypatch, datasets, compress,
                                          tol):
    monkeypatch.setattr(lowering, "_init_params_batch", _reference_init)
    (data, test), (rdata, rtest) = datasets
    specs = _grid(ScenarioSpec, DeviceProfile, compress=compress)
    ref_specs = _grid(ref_api.ScenarioSpec, RefDevice, compress=compress)
    assert [s.bucket_key() for s in specs] == [s.bucket_key()
                                              for s in ref_specs]
    got = Experiment(data, test, specs, device="cpu").run(4)
    want = ref_api.Experiment(rdata, rtest, ref_specs).run(4)
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_array_equal(got.global_batch, want.global_batch)
    np.testing.assert_allclose(got.losses, want.losses, rtol=tol, atol=tol)
    np.testing.assert_allclose(got.accs, want.accs, rtol=tol, atol=tol)
    print(f"PARITY transformer Experiment.run compress={compress}: losses "
          f"max_abs_err={float(np.abs(got.losses - want.losses).max()):.3g}"
          f", accs {float(np.abs(got.accs - want.accs).max()):.3g} "
          f"tol={tol}")
    assert np.isfinite(got.losses).all()


def test_period_by_period_from_the_reference_carry(datasets):
    (data, test), (rdata, rtest) = datasets
    specs = _grid(ScenarioSpec, DeviceProfile, compress=False)
    ref_specs = _grid(ref_api.ScenarioSpec, RefDevice, compress=False)
    bucket = Experiment(data, test, specs, device="cpu").lower()[0]
    rbucket = ref_lowering.group_rows(ref_specs)[0]
    plan = lowering.plan_bucket(bucket, data, 4)
    rplan = ref_lowering.plan_bucket(rbucket, rdata, 4)
    arrays = model_engine.tokens_to_device(data, test, "cpu")
    kw = dict(model_family="transformer", hidden=16, depth=2,
              compress=False, ratio=0.05)
    params0 = ref_me.init_params_batch(
        "transformer", 16, 2,
        jnp.stack([jax.random.key(r.seed) for r in rbucket.rows]))
    zeros = tmap(lambda p: jnp.zeros((p.shape[0], bucket.k_pad)
                                     + p.shape[1:], p.dtype), params0)

    def port_state(rs):
        return engine.EngineState(
            *(params_from_numpy(tmap(np.asarray, t), "cpu")
              for t in (rs.params, rs.residual)))

    def ref_run(params, residual):
        return np.asarray(ref_me.run_model_trajectory_batch(
            params, residual, rplan.payload["schedules"], rdata, rtest,
            active=rplan.payload["active"], **kw)[2][0])

    rstate = ref_engine.EngineState(params=params0, residual=zeros)
    carried = port_state(rstate)
    step_err, param_err, carried_err = [], [], []
    for p in range(4):
        chunk = [engine.slice_schedule(s, p, p + 1) for s in plan.schedules]
        one, (loss, acc, _) = model_engine.run_model_trajectory_batch(
            port_state(rstate), chunk, arrays, active=plan.active, **kw)
        carried, (closs, _, _) = model_engine.run_model_trajectory_batch(
            carried, chunk, arrays, active=plan.active, **kw)
        rstate, (rloss, racc, _) = ref_me.resume_model_trajectory_batch(
            rstate, [ref_engine.slice_schedule(s, p, p + 1)
                     for s in rplan.payload["schedules"]], rdata, rtest,
            active=rplan.payload["active"], **kw)
        np.testing.assert_allclose(loss.numpy(), rloss, rtol=0, atol=1e-5)
        np.testing.assert_allclose(acc.numpy(), racc, rtol=0, atol=1e-5)
        step_err.append(float(np.abs(loss.numpy() - rloss).max()))
        param_err.append(_max_err(one.params, rstate.params))
        carried_err.append(float(np.abs(closs.numpy() - rloss).max()))
    carried_params = _max_err(carried.params, rstate.params)
    embed_gap = float(np.abs(carried.params["embed"]["table"].numpy()
                             - np.asarray(rstate.params["embed"]["table"])
                             ).max())
    # the reference against itself from an init moved by one ulp
    ulp = np.random.default_rng(0)
    moved = tmap(lambda a: jnp.asarray(np.nextafter(
        np.asarray(a), np.where(ulp.random(a.shape) < 0.5, np.inf,
                                -np.inf).astype(np.float32))), params0)
    spread = np.abs(ref_run(moved, zeros) - ref_run(params0, zeros)).max(0)
    print(f"PARITY transformer periods from the reference carry: "
          f"max_abs_err={max(step_err):.3g} tol=1e-5 abs, params "
          f"{max(param_err):.3g}; carried loss gap by period "
          f"{[f'{e:.3g}' for e in carried_err]}, params {carried_params:.3g}"
          f" (embedding {embed_gap:.3g}); the reference "
          f"from a 1-ulp-moved init {[f'{e:.3g}' for e in spread]}")


def test_chunked_equals_monolithic_bitwise(datasets):
    (data, test), _ = datasets
    specs = _grid(ScenarioSpec, DeviceProfile)
    mono = Experiment(data, test, specs, device="cpu").run(3)
    got = Experiment(data, test, specs, device="cpu").run(
        3, executor=SerialExecutor(chunk_periods=1))
    for f in ("losses", "accs", "times", "global_batch"):
        np.testing.assert_array_equal(getattr(got, f), getattr(mono, f),
                                      err_msg=f)
    print("PARITY transformer chunked (1-period) vs monolithic (CPU): "
          "max_abs_err=0 tol=bitwise")


def test_padded_rows_equal_their_solo_twins(datasets):
    """A K = 3 row padded to the bucket's K = 4 against the same spec run
    alone: ledgers bitwise; losses and accuracies to f32 rounding (padding
    lengthens the row's weighted sums)."""
    (data, test), _ = datasets
    specs = _grid(ScenarioSpec, DeviceProfile)
    both = Experiment(data, test, specs, device="cpu").run(3)
    solo = Experiment(data, test, specs[1:], device="cpu").run(3)
    np.testing.assert_array_equal(both.times[2:], solo.times)
    np.testing.assert_array_equal(both.global_batch[2:], solo.global_batch)
    np.testing.assert_allclose(both.losses[2:], solo.losses, **TOL)
    np.testing.assert_allclose(both.accs[2:], solo.accs, **TOL)
    err = float(np.abs(both.losses[2:] - solo.losses).max())
    print(f"PARITY transformer padded K=3 row vs solo twin (CPU): losses "
          f"max_abs_err={err:.3g} tol=2e-5; ledgers bitwise")


def test_mixed_family_grid_keeps_the_reference_ledgers(datasets):
    """One feel-mlp and one transformer spec with equal hidden, depth and
    seed: two buckets, each planned at its own family's parameter count,
    so the host ledgers are the reference's bitwise (host planning of
    both packages, then the port's run of the same grid)."""
    (data, test), (rdata, rtest) = datasets
    kw = dict(hidden=16, depth=2, b_max=8, seeds=(3,))
    specs = [ScenarioSpec(fleet=_fleet(DeviceProfile, 3), model_family=f,
                          **kw) for f in ("feel_mlp", "transformer")]
    ref_specs = [ref_api.ScenarioSpec(fleet=_fleet(RefDevice, 3),
                                      model_family=f, **kw)
                 for f in ("feel_mlp", "transformer")]
    buckets = Experiment(data, test, specs, device="cpu").lower()
    ref_buckets = ref_lowering.group_rows(ref_specs)
    assert len(buckets) == len(ref_buckets) == 2
    # the plan key carries the family as the reference's does; this only
    # pins that mirror, the buckets already keep the families apart
    assert lowering._plan_key(buckets[0].rows[0]) != lowering._plan_key(
        buckets[1].rows[0])
    plans = [lowering.plan_bucket(b, data, 3) for b in buckets]
    for plan, rb in zip(plans, ref_buckets):
        want = ref_lowering.plan_bucket(rb, rdata, 3)
        np.testing.assert_array_equal(plan.times, want.times)
        np.testing.assert_array_equal(plan.global_batch, want.global_batch)
    assert not np.array_equal(plans[0].times, plans[1].times)
    got = Experiment(data, test, specs, device="cpu").run(3)
    for i, plan in enumerate(plans):
        np.testing.assert_array_equal(got.times[i], plan.times[0])
    assert np.isfinite(got.losses).all()
    print("PARITY mixed feel-mlp + transformer grid ledgers vs reference: "
          "max_abs_err=0 tol=bitwise")
