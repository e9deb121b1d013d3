"""τ > 1 local steps in the port (the paper's §VII extension), held
against the reference on the CPU.

* The τ arm of ``build_schedule`` — τ − 1 more local computations a
  period, the straggler max over participants only, times the faults'
  slowdown — for τ 2 and 3, plain, sampled and faulted, chunked:
  bitwise the reference's float64 ledger.
* One period of the τ > 1 ``_period_step`` from the same carry against
  the reference's: 1e-5 without compression, 1e-4 with it.
* ``Experiment.run`` at τ 2 with the reference's initial weights: ledgers
  bitwise, losses and accuracies 1e-5 (1e-4 compressed).
* Within the port: chunked == monolithic bitwise, and a padded τ row
  against its solo twin."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as ref_api
from repro.core import DeviceProfile as RefDevice
from repro.core import scheduler as ref_scheduler
from repro.data import pipeline as ref_pipeline
from repro.data.pipeline import ClassificationData as RefData
from repro.dynamics import Faults as RefFaults
from repro.fed import engine as ref_engine
from repro.fed import feel_model as ref_model
from repro.topology import Sampling as RefSampling

import repro_torch.api as port_api
from repro_torch.api import Experiment, SerialExecutor, lowering
from repro_torch.core import scheduler
from repro_torch.core.latency import DeviceProfile
from repro_torch.data import pipeline
from repro_torch.data.pipeline import ClassificationData
from repro_torch.dynamics import Faults
from repro_torch.fed import engine
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.topology import Sampling

DIM, HIDDEN, K, SLOT = 32, 16, 4, 8


def _reference_init(rows, input_dim, device):
    per_row = [ref_model.init(jax.random.key(r.seed), r.spec.hidden,
                              depth=r.spec.depth, input_dim=input_dim)
               for r in rows]
    stacked = jax.tree_util.tree_map(
        lambda *a: np.stack([np.asarray(x) for x in a]), *per_row)
    return params_from_numpy(stacked, device)


def _fleet(DP, k):
    """CPUs and GPUs: a GPU's b = 0 floor latency is nonzero, so a
    sampled-out GPU would win an unmasked straggler max."""
    kinds = [dict(kind="cpu", f_cpu=0.7e9), dict(kind="gpu", gpu_t_low=0.5),
             dict(kind="cpu", f_cpu=2.1e9), dict(kind="gpu")]
    return tuple(DP(**kinds[i % 4]) for i in range(k))


WORLDS = {
    "plain": ({}, {}),
    "sampled": ({"sampling": Sampling(size=2)},
                {"sampling": RefSampling(size=2)}),
    "faulted": ({"faults": Faults(slow_prob=0.4, slow_factor=3.0,
                                  drop_prob=0.2, seed=1)},
                {"faults": RefFaults(slow_prob=0.4, slow_factor=3.0,
                                     drop_prob=0.2, seed=1)}),
}


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("tau", [2, 3])
def test_build_schedule_tau_arm_bitwise(tau, world):
    d = pipeline.ClassificationData.synthetic(n=300, dim=8, seed=1)
    fleet, rfleet = _fleet(DeviceProfile, 5), _fleet(RefDevice, 5)
    parts = pipeline.partition_noniid(d.y, 5, seed=1)
    kw, rkw = WORLDS[world]
    sched = scheduler.FeelScheduler(fleet, n_params=999, b_max=12, seed=1,
                                    **kw)
    rsched = ref_scheduler.FeelScheduler(rfleet, n_params=999, b_max=12,
                                         seed=1, **rkw)
    bat = pipeline.FederatedBatcher(parts, 12, 1)
    rbat = ref_pipeline.FederatedBatcher(parts, 12, 1)
    offset = 0.0
    for periods in (4, 2):
        horizon = sched.plan_horizon(periods)
        s = engine.build_schedule(sched, bat, periods, horizon=horizon,
                                  time_offset=offset, local_steps=tau)
        r = ref_engine.build_schedule(rsched, rbat, rfleet, periods, tau,
                                      time_offset=offset)
        for f in ("idx", "weight", "batch", "lr", "times", "global_batch"):
            np.testing.assert_array_equal(getattr(s, f), getattr(r, f),
                                          err_msg=f)
        # τ local steps lengthen every period beyond the one-step ledger
        per_period = np.diff(np.concatenate([[offset], s.times]))
        assert (per_period > horizon.latency).all()
        offset = float(s.times[-1])
    print(f"PARITY build_schedule local_steps={tau} {world}: max_abs_err=0 "
          "(bitwise)")


@pytest.fixture(scope="module")
def step_case():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(120, DIM)).astype(np.float32)
    y = rng.integers(0, 10, size=120).astype(np.int32)
    tx = rng.normal(size=(40, DIM)).astype(np.float32)
    ty = rng.integers(0, 10, size=40).astype(np.int32)
    params = jax.tree_util.tree_map(np.asarray, ref_model.init(
        jax.random.key(1), HIDDEN, depth=3, input_dim=DIM))
    residual = jax.tree_util.tree_map(
        lambda p: (rng.normal(size=(K,) + p.shape) * 0.01).astype(
            np.float32), params)
    batch = np.array([8, 3, 5, 0], np.float32)        # last user inactive
    weight = (np.arange(SLOT)[None, :] < batch[:, None]).astype(np.float32)
    xs = {"idx": rng.integers(0, 120, size=(K, SLOT)).astype(np.int32),
          "weight": weight, "batch": batch, "lr": np.float32(0.2),
          "aggden": np.float32(0.0),
          "active": np.array([1, 1, 1, 0], np.float32)}
    return (x, y, tx, ty), params, residual, xs


@pytest.mark.parametrize("compress,tol", [(False, 1e-5), (True, 1e-4)])
@pytest.mark.parametrize("tau", [2, 3])
def test_tau_period_step_matches_reference(step_case, tau, compress, tol):
    arrays, params, residual, xs = step_case
    (rp, rr), (rl, ra, rd) = ref_engine._period_step(
        *(jnp.asarray(a) for a in arrays), tau, compress, 0.05,
        (params, residual), {k: jnp.asarray(v) for k, v in xs.items()})
    batched = lambda t: jax.tree_util.tree_map(lambda a: a[None], t)  # noqa
    state = engine.EngineState(params_from_numpy(batched(params)),
                               params_from_numpy(batched(residual)))
    txs = engine.host_to_device(
        {k: np.asarray(v)[None] for k, v in xs.items() if k != "active"},
        "cpu")
    state, (loss, acc, decay) = engine._period_step(
        engine.host_to_device(arrays, "cpu"),
        torch.from_numpy(xs["active"][None]), compress, 0.05, state, txs,
        local_steps=tau)
    err = 0.0
    for got, want in ((state.params, rp), (state.residual, rr)):
        for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(got)),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a[0], np.asarray(b), rtol=tol,
                                       atol=tol)
            err = max(err, float(np.abs(a[0] - np.asarray(b)).max()))
    np.testing.assert_allclose(float(loss[0]), float(rl), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(decay[0]), float(rd), rtol=tol,
                               atol=tol)
    assert float(acc[0]) == pytest.approx(float(ra))
    # the inactive user (all-zero weights) uploads an exactly-zero delta
    x = torch.from_numpy(arrays[0][xs["idx"]])[None]
    y = torch.from_numpy(arrays[1][xs["idx"]])[None]
    w = torch.from_numpy(xs["weight"] * xs["active"][:, None])[None]
    dev = [{key: torch.from_numpy(np.broadcast_to(
        layer[key], (1, K) + layer[key].shape).copy()) for key in layer}
        for layer in params]
    delta = engine._local_sgd(dev, x, y, w, torch.tensor([0.2]), tau)
    for layer in delta:
        for leaf in layer.values():
            assert not leaf[0, 3].any() and leaf[0, 0].any()
    print(f"PARITY _period_step local_steps={tau} compress={compress}: "
          f"max_abs_err={err:.3g} tol={tol}")


def _specs(api, DP, **kw):
    kw.setdefault("hidden", HIDDEN)
    kw.setdefault("b_max", 16)
    kw.setdefault("base_lr", 0.1)
    kw.setdefault("compression", 0.05)
    kw.setdefault("seeds", (0, 1))
    return [api.ScenarioSpec(fleet=_fleet(DP, k), partition=p, **kw)
            for k, p in ((4, "iid"), (3, "noniid"))]


@pytest.fixture(scope="module")
def datasets():
    return (ClassificationData.synthetic(n=600, dim=DIM, seed=0,
                                         spread=6.0).split(100),
            RefData.synthetic(n=600, dim=DIM, seed=0, spread=6.0).split(100))


@pytest.mark.parametrize("compress,tol,extra", [
    (False, 1e-5, {}), (True, 1e-4, {}), (False, 1e-5, {"sampling": 2})])
def test_experiment_run_tau_matches_reference(monkeypatch, datasets,
                                              compress, tol, extra):
    monkeypatch.setattr(lowering, "_init_params_batch", _reference_init)
    (data, test), (rdata, rtest) = datasets
    size = extra.get("sampling")
    specs = _specs(port_api, DeviceProfile, local_steps=2,
                   compress=compress,
                   sampling=None if size is None else Sampling(size=size))
    ref_specs = _specs(ref_api, RefDevice, local_steps=2, compress=compress,
                       sampling=None if size is None
                       else RefSampling(size=size))
    assert [s.bucket_key() for s in specs] == [s.bucket_key()
                                              for s in ref_specs]
    got = Experiment(data, test, specs, device="cpu").run(5)
    want = ref_api.Experiment(rdata, rtest, ref_specs).run(5)
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_array_equal(got.global_batch, want.global_batch)
    np.testing.assert_allclose(got.losses, np.asarray(want.losses),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(got.accs, np.asarray(want.accs), rtol=tol,
                               atol=tol)
    print(f"PARITY Experiment.run local_steps=2 compress={compress} "
          f"sampling={size}: losses max_abs_err="
          f"{float(np.abs(got.losses - np.asarray(want.losses)).max()):.3g}"
          f", accs {float(np.abs(got.accs - np.asarray(want.accs)).max()):.3g}"
          f" tol={tol}")


@pytest.mark.parametrize("tau", [2, 3])
def test_tau_chunked_equals_monolithic_bitwise(datasets, tau):
    (data, test), _ = datasets
    specs = _specs(port_api, DeviceProfile, local_steps=tau)
    mono = Experiment(data, test, specs, device="cpu").run(5)
    for chunk in (1, 2):
        got = Experiment(data, test, specs, device="cpu").run(
            5, executor=SerialExecutor(chunk_periods=chunk))
        for f in ("losses", "accs", "times", "global_batch"):
            np.testing.assert_array_equal(getattr(got, f), getattr(mono, f),
                                          err_msg=f"{f} chunk={chunk}")
    print(f"PARITY local_steps={tau} chunked vs monolithic: max_abs_err=0 "
          "(bitwise)")


def test_padded_tau_row_matches_its_solo_twin(datasets):
    (data, test), _ = datasets
    specs = _specs(port_api, DeviceProfile, local_steps=2)
    exp = Experiment(data, test, specs, device="cpu")
    assert len(exp.lower()) == 1 and exp.lower()[0].k_pad == 4
    res = exp.run(4)
    solo = Experiment(data, test, specs[1:], device="cpu").run(4)
    np.testing.assert_array_equal(solo.times, res.times[2:])
    np.testing.assert_array_equal(solo.global_batch, res.global_batch[2:])
    np.testing.assert_allclose(solo.losses, res.losses[2:], rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(solo.accs, res.accs[2:], rtol=2e-5, atol=2e-5)
    print("PARITY local_steps=2 padded K=3 row vs solo: losses max_abs_err="
          f"{float(np.abs(solo.losses - res.losses[2:]).max()):.3g} tol=2e-5")
