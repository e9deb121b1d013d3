"""The port's ``fed/trainer.py`` and ``fed/sweep.py`` against the
reference's, on the same data, fleets and seeds.

* ``FeelSimulation(engine="scan")`` against ``engine="python"`` (the
  per-period loop with a host sync a step) at τ 1 and 2: times bitwise,
  losses and accuracies within the reference's own 1e-5
  (``tests/test_engine.py``), final parameters too.
* Each engine against the reference's same engine, with the reference's
  initial weights carried across: times bitwise, losses within 1e-5
  uncompressed and 1e-4 with SBC (``tests/test_torch_experiment.py``
  says why).
* ``run_seed_batch`` bitwise the port's ``Experiment`` bucket of the same
  rows; ``run_sweep`` and ``run_scheme`` warn, their ledgers are bitwise
  the reference's and their series bitwise the port's ``Experiment``.

Shapes (dim 19, hidden 20, b_max 13) are this module's alone."""
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.core import DeviceProfile as RefDevice
from repro.data.pipeline import ClassificationData as RefData
from repro.fed.trainer import FeelSimulation as RefSimulation
from repro.fed.trainer import run_scheme as ref_run_scheme

from repro_torch.api import Experiment, ScenarioSpec
from repro_torch.core.latency import DeviceProfile
from repro_torch.data.pipeline import ClassificationData
from repro_torch.fed.sweep import run_seed_batch, run_sweep
from repro_torch.fed.trainer import FeelSimulation, run_scheme
from repro_torch.interop import params_from_numpy
from repro_torch.tree import tree_leaves

DIM, HIDDEN, BMAX = 19, 20, 13
TIERS = (0.7e9, 1.4e9, 2.1e9)


def _fleet(DP):
    return [DP(kind="cpu", f_cpu=f) for f in TIERS]


@pytest.fixture(scope="module")
def dataset():
    return ClassificationData.synthetic(n=420, dim=DIM, seed=0,
                                        spread=6.0).split(80)


@pytest.fixture(scope="module")
def ref_dataset():
    return RefData.synthetic(n=420, dim=DIM, seed=0, spread=6.0).split(80)


def _sim(dataset, engine, **kw):
    data, test = dataset
    kw.setdefault("policy", "proposed")
    return FeelSimulation(_fleet(DeviceProfile), data, test,
                          partition="noniid", b_max=BMAX, base_lr=0.15,
                          seed=5, hidden=HIDDEN, engine=engine, device="cpu",
                          **kw)


@pytest.mark.parametrize("policy,local_steps", [("proposed", 1),
                                                ("full", 1),
                                                ("proposed", 2)])
def test_scan_matches_python_loop(dataset, policy, local_steps):
    sim_s = _sim(dataset, "scan", policy=policy, local_steps=local_steps)
    sim_p = _sim(dataset, "python", policy=policy, local_steps=local_steps)
    rs = sim_s.run(9, eval_every=4)
    rp = sim_p.run(9, eval_every=4)
    assert rs.times == rp.times and rs.global_batches == rp.global_batches
    np.testing.assert_allclose(rs.losses, rp.losses, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(rs.accs, rp.accs, atol=1e-5, rtol=1e-5)
    for a, b in zip(tree_leaves(sim_s.params), tree_leaves(sim_p.params)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    print(f"PARITY FeelSimulation scan vs python {policy} tau={local_steps}:"
          f" losses max_abs_err="
          f"{float(np.abs(np.subtract(rs.losses, rp.losses)).max()):.3g} "
          f"tol=1e-5")


@pytest.mark.parametrize("engine", ["scan", "python"])
@pytest.mark.parametrize("compress,tol", [(False, 1e-5), (True, 1e-4)])
def test_each_engine_holds_the_reference(dataset, ref_dataset, engine,
                                         compress, tol):
    rdata, rtest = ref_dataset
    ref = RefSimulation(_fleet(RefDevice), rdata, rtest, partition="noniid",
                        policy="proposed", b_max=BMAX, base_lr=0.15, seed=5,
                        hidden=HIDDEN, engine=engine, compress=compress)
    sim = _sim(dataset, engine, compress=compress)
    sim.params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref.params))
    got, want = sim.run(8, eval_every=3), ref.run(8, eval_every=3)
    assert got.times == want.times
    assert got.global_batches == want.global_batches
    np.testing.assert_allclose(got.losses, want.losses, rtol=tol, atol=tol)
    np.testing.assert_allclose(got.accs, want.accs, rtol=tol, atol=tol)
    # the realized decays fed the same ξ update
    np.testing.assert_allclose(sim.scheduler.xi_est.xi, ref.scheduler.xi_est.xi,
                               rtol=1e-4)
    print(f"PARITY FeelSimulation {engine} compress={compress}: losses "
          f"max_abs_err="
          f"{float(np.abs(np.subtract(got.losses, want.losses)).max()):.3g} "
          f"tol={tol}")


def test_xi_feedback_applied_post_hoc(dataset):
    sim = _sim(dataset, "scan")
    xi0 = sim.scheduler.xi_est.xi
    sim.run(6, eval_every=3)
    assert sim.scheduler.xi_est.xi != xi0


def test_run_seed_batch_is_bitwise_the_experiment_bucket(dataset):
    data, test = dataset
    seeds, periods = (0, 1, 2, 3), 5
    sims = [FeelSimulation(_fleet(DeviceProfile), data, test,
                           partition="iid", policy="proposed", b_max=BMAX,
                           base_lr=0.15, seed=s, hidden=HIDDEN, device="cpu")
            for s in seeds]
    losses, accs, times, gb = run_seed_batch(sims, periods)
    spec = ScenarioSpec(fleet=tuple(_fleet(DeviceProfile)), partition="iid",
                        policy="proposed", b_max=BMAX, base_lr=0.15,
                        hidden=HIDDEN, seeds=seeds)
    res = Experiment(data, test, [spec], device="cpu").run(periods)
    for got, want in ((losses, res.losses), (accs, res.accs),
                      (times, res.times), (gb, res.global_batch)):
        np.testing.assert_array_equal(got, want)
    assert not np.allclose(losses[0], losses[1])
    # the batched rows carried on: each sim holds its row's state
    solo = FeelSimulation(_fleet(DeviceProfile), data, test, partition="iid",
                          policy="proposed", b_max=BMAX, base_lr=0.15,
                          seed=2, hidden=HIDDEN, device="cpu")
    r = solo.run(periods, eval_every=2)
    np.testing.assert_allclose(r.losses, losses[2][[0, 2, 4]], atol=1e-5,
                               rtol=1e-5)
    for a, b in zip(tree_leaves(solo.params), tree_leaves(sims[2].params)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_run_sweep_warns_and_matches_run_seed_batch(dataset):
    data, test = dataset
    with pytest.warns(DeprecationWarning, match="run_sweep is deprecated"):
        sw = run_sweep({"cpu3": _fleet(DeviceProfile)}, data, test,
                       policies=("proposed", "online"), partitions=("iid",),
                       seeds=(0, 1), periods=4, b_max=BMAX, base_lr=0.15,
                       device="cpu")
    assert set(sw) == {"cpu3/iid/proposed", "cpu3/iid/online"}
    cell = sw["cpu3/iid/proposed"]
    sims = [FeelSimulation(_fleet(DeviceProfile), data, test,
                           partition="iid", policy="proposed", b_max=BMAX,
                           base_lr=0.15, seed=s, device="cpu")
            for s in (0, 1)]
    losses, accs, times, gb = run_seed_batch(sims, 4)
    np.testing.assert_array_equal(cell.times, times)
    np.testing.assert_array_equal(cell.global_batch, gb)
    np.testing.assert_array_equal(cell.losses, losses)
    np.testing.assert_array_equal(cell.accs, accs)
    assert np.all(np.isinf(cell.speed(2.0)))       # unreachable => inf
    rr = cell.run_result(seed_i=1, eval_every=2)
    assert len(rr.accs) == len(rr.global_batches) == 3   # periods 0, 2, 3


@pytest.mark.parametrize("scheme", ["individual", "model_fl",
                                    "gradient_fl"])
def test_run_scheme_warns_and_matches(dataset, ref_dataset, scheme):
    """Ledgers bitwise the reference's ``run_scheme``; series bitwise the
    port's ``Experiment`` of the same scheme (the same init: a generator
    seeded with the seed)."""
    data, test = dataset
    rdata, rtest = ref_dataset
    with pytest.warns(DeprecationWarning, match="run_scheme is deprecated"):
        got = run_scheme(scheme, _fleet(DeviceProfile), data, test,
                         "noniid", 6, seed=1, b_max=BMAX, base_lr=0.1,
                         eval_every=2, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = ref_run_scheme(scheme, _fleet(RefDevice), rdata, rtest,
                              "noniid", 6, seed=1, b_max=BMAX, base_lr=0.1,
                              eval_every=2)
    assert got.scheme == want.scheme
    assert got.times == want.times
    assert got.global_batches == want.global_batches
    twin = Experiment(data, test, [ScenarioSpec(
        fleet=tuple(_fleet(DeviceProfile)), scheme=scheme,
        partition="noniid", b_max=BMAX, base_lr=0.1, seeds=(1,))],
        device="cpu").run(6)
    np.testing.assert_array_equal(got.times, twin.times[0, [0, 2, 4, 5]])
    np.testing.assert_array_equal(got.losses, twin.losses[0, [0, 2, 4, 5]])
    np.testing.assert_array_equal(got.accs, twin.accs[0, [0, 2, 4, 5]])
