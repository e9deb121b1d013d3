"""Channel drift, stragglers and dropout, and energy budgets in the
PyTorch port, on the CPU.

Against the reference (the same numpy inputs through ``repro`` under
``JAX_PLATFORMS=cpu`` and through the port):

* the ``FadingProcess`` and ``FaultProcess`` draws, the gain ladder,
  ``uplink_airtime``, ``batch_caps`` and ``energy_spend``: bitwise;
* ``optimize_batch_rows(energy=...)``: bitwise;
* ``FeelScheduler.plan_horizon`` for each policy × each feature (fading,
  faults, energy, identity dynamics, all of them with sampling): bitwise
  in every field, ``participation``, ``energy`` and ``slowdown``
  included;
* the lowering's active mask and energy ledger: bitwise;
* ``grid`` over ``fading=``: the same specs, labels and coordinates;
* the spec's ``TypeError`` and ``ValueError`` rules, and ``bucket_key``;
* ``Experiment.run`` on feel-mlp (each feature) with the reference's
  initial weights: ledgers bitwise, losses and accuracies within 1e-5.

Within the port, all bitwise: identity dynamics equal the static run
(scheduler and ``Experiment.run``), chunked equals monolithic under
drift, stragglers stretch only the ledger, dropout and budget drops mask
participation, and ``BucketRun.energy_ledger`` banks the plan's ledger
chunk by chunk."""
import jax
import numpy as np
import pytest

import repro.api as ref_api
from repro.api import lowering as ref_lowering
from repro.core import DeviceProfile as RefDevice
from repro.core import scheduler as ref_scheduler
from repro.core import solver as ref_solver
from repro.data.pipeline import ClassificationData as RefData
from repro.dynamics import EnergyBudget as RefEnergy
from repro.dynamics import Fading as RefFading
from repro.dynamics import FadingProcess as RefFadingProcess
from repro.dynamics import FaultProcess as RefFaultProcess
from repro.dynamics import Faults as RefFaults
from repro.dynamics import energy as ref_energy
from repro.fed import feel_model as ref_model
from repro.topology import Sampling as RefSampling

import repro_torch.api as port_api
from repro_torch.api import Experiment, ScenarioSpec, SerialExecutor
from repro_torch.api import lowering
from repro_torch.core import DeviceProfile
from repro_torch.core import scheduler, solver
from repro_torch.data.pipeline import ClassificationData
from repro_torch.dynamics import (EnergyBudget, Fading, FadingProcess,
                                  FaultProcess, Faults, batch_caps,
                                  energy_spend, uplink_airtime)
from repro_torch.interop import params_from_numpy
from repro_torch.topology import Sampling, Topology

DIM, HIDDEN, BMAX = 32, 16, 12
FIELDS = ("batch", "tau_up", "tau_down", "lr", "latency", "global_batch",
          "participation", "aggden", "energy", "slowdown")
SERIES = ("losses", "accs", "times", "global_batch")


def _features(F, Fa, E, S):
    """Each feature as keyword arguments of a scheduler or a spec."""
    return {
        "fading": dict(fading=F(states=3, spread=0.8, stickiness=0.7)),
        "faults": dict(faults=Fa(slow_prob=0.3, slow_factor=4.0,
                                 drop_prob=0.3, seed=1)),
        "energy": dict(energy=E(budget_j=0.35)),
        "identity": dict(fading=F(states=3, spread=0.0),
                         faults=Fa(slow_prob=0.0, drop_prob=0.0),
                         energy=E()),
        "all": dict(sampling=S(size=3), fading=F(seed=2),
                    faults=Fa(slow_prob=0.2, drop_prob=0.2),
                    energy=E(budget_j=0.5)),
        "weighted_faults": dict(sampling=S(size=3, weighted=True),
                                faults=Fa(drop_prob=0.25, seed=3)),
    }


PORT = _features(Fading, Faults, EnergyBudget, Sampling)
REF = _features(RefFading, RefFaults, RefEnergy, RefSampling)


def _fleet(DP, k):
    return tuple(DP(kind="cpu" if i % 3 else "gpu",
                    f_cpu=(0.6 + 0.3 * i) * 1e9) for i in range(k))


def _assert_horizons_equal(a, b, msg=""):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f"{msg} {f}"
        if x is not None:
            assert x.dtype == y.dtype, f"{msg} {f}"
            np.testing.assert_array_equal(x, y, err_msg=f"{msg} {f}")


def _sched(**kw):
    """The reference's ``tests/test_dynamics.py`` scheduler: four CPUs."""
    kw.setdefault("devices", tuple(DeviceProfile(kind="cpu",
                                                 f_cpu=(0.6 + 0.3 * i) * 1e9)
                                   for i in range(4)))
    kw.setdefault("n_params", 4000)
    kw.setdefault("b_max", 16)
    kw.setdefault("seed", 3)
    return scheduler.FeelScheduler(**kw)


# ---------------------------------------------------------------------------
# the processes and the energy model against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fading", [
    dict(), dict(states=1), dict(states=4, spread=1.0, stickiness=0.0),
    dict(states=5, spread=0.0, stickiness=0.5, seed=9)])
def test_fading_draws_bitwise_reference(fading):
    port = FadingProcess(Fading(**fading), 6, 11)
    ref = RefFadingProcess(RefFading(**fading), 6, 11)
    np.testing.assert_array_equal(Fading(**fading).gain_ladder(),
                                  RefFading(**fading).gain_ladder())
    mono = FadingProcess(Fading(**fading), 6, 11).draw(7)
    got = [port.draw(3), port.draw(4)]
    for a in got:
        np.testing.assert_array_equal(a, ref.draw(a.shape[0]))
    np.testing.assert_array_equal(mono, np.concatenate(got))
    np.testing.assert_array_equal(port.planning_gain(False),
                                  ref.planning_gain(False))
    np.testing.assert_array_equal(port.planning_gain(True),
                                  ref.planning_gain(True))
    assert str(Fading(**fading)) == str(RefFading(**fading))


@pytest.mark.parametrize("faults", [
    dict(), dict(slow_prob=1.0), dict(slow_prob=0.4, drop_prob=0.3, seed=5),
    dict(slow_prob=0.1, slow_factor=2.5, drop_prob=0.9)])
def test_fault_draws_bitwise_reference(faults):
    port = FaultProcess(Faults(**faults), 5, 11)
    ref = RefFaultProcess(RefFaults(**faults), 5, 11)
    mono = FaultProcess(Faults(**faults), 5, 11).draw(6)
    got = [port.draw(2), port.draw(4)]
    for (s, k) in got:
        rs, rk = ref.draw(s.shape[0])
        np.testing.assert_array_equal(s, rs)
        np.testing.assert_array_equal(k, rk)
    for i in range(2):
        np.testing.assert_array_equal(
            mono[i], np.concatenate([g[i] for g in got]))
    assert set(np.unique(mono[1])) <= {0.0, 1.0}
    assert Faults(**faults).keep_prob == RefFaults(**faults).keep_prob
    assert str(Faults(**faults)) == str(RefFaults(**faults))


@pytest.mark.parametrize("cls,ref_cls,kw", [
    (Fading, RefFading, dict(states=0)), (Fading, RefFading,
                                          dict(spread=-0.1)),
    (Fading, RefFading, dict(stickiness=1.0)),
    (Faults, RefFaults, dict(slow_prob=1.5)),
    (Faults, RefFaults, dict(drop_prob=1.0)),
    (Faults, RefFaults, dict(slow_factor=0.5)),
    (EnergyBudget, RefEnergy, dict(budget_j=0.0)),
    (EnergyBudget, RefEnergy, dict(comp_w=-1.0)),
    (EnergyBudget, RefEnergy, dict(comp_w=0.0, tx_w=0.0))])
def test_value_validation_matches_reference(cls, ref_cls, kw):
    with pytest.raises(ValueError) as got:
        cls(**kw)
    with pytest.raises(ValueError) as want:
        ref_cls(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("energy", [
    dict(budget_j=0.35), dict(budget_j=2.0, comp_w=0.0),
    dict(budget_j=1e-6, tx_w=3.0), dict()])
def test_energy_model_bitwise_reference(energy):
    rng = np.random.default_rng(0)
    tau = rng.uniform(0.0, 0.004, size=(5, 6))
    tau[0, 0] = 0.0
    rates = rng.uniform(1e6, 9e6, size=(5, 6))
    fr = solver.FleetRows.from_devices(_fleet(DeviceProfile, 6), 5)
    rfr = ref_solver.FleetRows.from_devices(_fleet(RefDevice, 6), 5)
    e, re_ = EnergyBudget(**energy), RefEnergy(**energy)
    np.testing.assert_array_equal(
        uplink_airtime(tau, rates, 8e4, 0.01),
        ref_energy.uplink_airtime(tau, rates, 8e4, 0.01))
    np.testing.assert_array_equal(
        batch_caps(e, fr, tau, rates, 8e4, 0.01),
        ref_energy.batch_caps(re_, rfr, tau, rates, 8e4, 0.01))
    t_local = rng.uniform(0.0, 0.3, size=(5, 6))
    np.testing.assert_array_equal(energy_spend(e, t_local, tau),
                                  ref_energy.energy_spend(re_, t_local, tau))


@pytest.mark.parametrize("budget", [0.05, 0.35, 3.0, float("inf")])
def test_optimize_batch_rows_energy_bitwise_reference(budget):
    rng = np.random.default_rng(1)
    rates = rng.uniform(1e6, 6e6, size=(2, 4, 5))
    mask = rng.uniform(size=(4, 5)) > 0.3
    mask[:, 0] = True
    fr = solver.FleetRows.from_devices(_fleet(DeviceProfile, 5),
                                       4).with_mask(mask)
    rfr = ref_solver.FleetRows.from_devices(_fleet(RefDevice, 5),
                                            4).with_mask(mask)
    for devs, rdevs in ((_fleet(DeviceProfile, 5), _fleet(RefDevice, 5)),
                        (fr, rfr)):
        got = solver.optimize_batch_rows(
            devs, rates[0], rates[1], 8e4, 0.01, 0.01, 2.0, 16,
            energy=EnergyBudget(budget_j=budget))
        want = ref_solver.optimize_batch_rows(
            rdevs, rates[0], rates[1], 8e4, 0.01, 0.01, 2.0, 16,
            energy=RefEnergy(budget_j=budget))
        np.testing.assert_array_equal(got, want)
    if budget == float("inf"):                   # the bitwise identity
        np.testing.assert_array_equal(got, solver.optimize_batch_rows(
            fr, rates[0], rates[1], 8e4, 0.01, 0.01, 2.0, 16))


# ---------------------------------------------------------------------------
# the scheduler against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("feature", sorted(PORT))
@pytest.mark.parametrize("policy", ["proposed", "online", "full", "random"])
def test_plan_horizon_dynamics_bitwise_reference(policy, feature):
    port = scheduler.FeelScheduler(_fleet(DeviceProfile, 6), n_params=4000,
                                   policy=policy, b_max=16, seed=3,
                                   **PORT[feature])
    ref = ref_scheduler.FeelScheduler(_fleet(RefDevice, 6), n_params=4000,
                                      policy=policy, b_max=16, seed=3,
                                      **REF[feature])
    assert port.dynamic == ref.dynamic
    for periods in (4, 3, 6):
        _assert_horizons_equal(port.plan_horizon(periods),
                               ref.plan_horizon(periods),
                               f"{policy} {feature}")
    assert port._b_cache == ref._b_cache and port._period == ref._period


def test_dynamic_schedulers_plan_solo_in_the_fused_path():
    def make(mod, DP, feats):
        return [mod.FeelScheduler(_fleet(DP, 4 + i % 2), n_params=900,
                                  b_max=BMAX, seed=i, **feats[f])
                for i, f in enumerate(["fading", "faults", "energy",
                                       "identity", "all"])] + [
            mod.FeelScheduler(_fleet(DP, 5), n_params=900, b_max=BMAX,
                              seed=7)]
    port, ref = make(scheduler, DeviceProfile, PORT), make(
        ref_scheduler, RefDevice, REF)
    assert [s.dynamic for s in port] == [True] * 5 + [False]
    for a, b in zip(scheduler.plan_horizons_batch(port, 5),
                    ref_scheduler.plan_horizons_batch(ref, 5)):
        _assert_horizons_equal(a, b)


# ---------------------------------------------------------------------------
# the scheduler within the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["proposed", "online", "full", "random"])
def test_identity_dynamics_bitwise_static_plan(policy):
    h0 = _sched(policy=policy).plan_horizon(5)
    h1 = _sched(policy=policy, **PORT["identity"]).plan_horizon(5)
    for f in ("batch", "tau_up", "tau_down", "lr", "latency",
              "global_batch"):
        np.testing.assert_array_equal(getattr(h0, f), getattr(h1, f))
    assert h0.energy is None and h0.slowdown is None
    assert h0.participation is None
    np.testing.assert_array_equal(h1.participation, 1.0)
    np.testing.assert_array_equal(h1.slowdown, 1.0)


def test_scheduler_chunked_equals_monolithic_under_drift():
    kw = dict(fading=Fading(states=3, spread=1.2, stickiness=0.9),
              faults=Faults(slow_prob=0.3, drop_prob=0.2, seed=1),
              energy=EnergyBudget(budget_j=1.0))
    mono = _sched(**kw).plan_horizon(6)
    sch = _sched(**kw)
    chunks = [sch.plan_horizon(2) for _ in range(3)]
    for f in ("batch", "tau_up", "latency", "participation", "energy",
              "slowdown"):
        np.testing.assert_array_equal(
            getattr(mono, f),
            np.concatenate([getattr(c, f) for c in chunks]), err_msg=f)


def test_straggler_slowdown_stretches_only_the_ledger():
    h0 = _sched().plan_horizon(5)
    h1 = _sched(faults=Faults(slow_prob=1.0, slow_factor=4.0)
                ).plan_horizon(5)
    np.testing.assert_array_equal(h0.batch, h1.batch)
    assert np.all(h1.slowdown == 4.0)
    assert np.all(h1.latency >= h0.latency)
    assert np.any(h1.latency > h0.latency)


def test_dropout_masks_participation():
    h = _sched(faults=Faults(drop_prob=0.5, seed=2)).plan_horizon(8)
    part = h.participation
    assert set(np.unique(part)) <= {0.0, 1.0}
    assert 0.0 < part.mean() < 1.0
    np.testing.assert_array_equal(h.batch == 0, part == 0.0)
    assert np.all(part.sum(1) >= 1)


def test_energy_budget_sheds_and_respects_ledger():
    h0 = _sched().plan_horizon(5)
    h1 = _sched(energy=EnergyBudget(budget_j=0.35)).plan_horizon(5)
    assert np.all(h1.batch <= h0.batch) and np.any(h1.batch < h0.batch)
    active = h1.participation > 0.5
    assert np.all(h1.energy[active] <= 0.35 + 1e-9)
    assert np.all(h1.energy[~active] == 0.0)
    # a budget nobody can meet soft-floors instead of emptying the round
    h2 = _sched(energy=EnergyBudget(budget_j=1e-6)).plan_horizon(3)
    assert np.all(h2.participation.sum(axis=1) >= 1)


# ---------------------------------------------------------------------------
# the spec against the reference
# ---------------------------------------------------------------------------


def _spec_pair(k=4, **kw):
    """The same keyword arguments through both specs, each exception
    captured."""
    out = []
    for Spec, DP, feats, S in ((ScenarioSpec, DeviceProfile, PORT,
                                Sampling),
                               (ref_api.ScenarioSpec, RefDevice, REF,
                                RefSampling)):
        args = {key: (v(S, feats) if callable(v) else v)
                for key, v in kw.items()}
        try:
            out.append(Spec(fleet=_fleet(DP, k), **args))
        except Exception as exc:            # noqa: BLE001
            out.append(exc)
    return out


@pytest.mark.parametrize("case", [
    dict(sampling=lambda S, f: S(size=2, weighted=True),
         energy=lambda S, f: f["energy"]["energy"]),
    dict(scheme="individual", fading=lambda S, f: f["fading"]["fading"]),
    dict(scheme="model_fl", faults=lambda S, f: f["faults"]["faults"]),
    dict(fading=0.5), dict(faults="x"), dict(energy=1.0),
    dict(sampling=3)])
def test_spec_rules_match_reference(case):
    got, want = _spec_pair(**case)
    assert type(got) is type(want), (got, want)
    assert isinstance(got, (TypeError, ValueError))


def test_spec_accepts_dynamics_and_keys_the_fading_states():
    base = ScenarioSpec(fleet=_fleet(DeviceProfile, 3))
    for feature, kw in PORT.items():
        spec = ScenarioSpec(fleet=_fleet(DeviceProfile, 3), **kw)
        ref = ref_api.ScenarioSpec(fleet=_fleet(RefDevice, 3), **REF[feature])
        assert spec.bucket_key() == ref.bucket_key(), feature
        assert spec.has_dynamics == ref.has_dynamics
    assert not base.has_dynamics
    assert ScenarioSpec(fleet=base.fleet, fading=Fading(states=3)
                        ).bucket_key() != base.bucket_key()
    assert ScenarioSpec(fleet=base.fleet, fading=Fading(states=3, spread=0.2)
                        ).bucket_key() == ScenarioSpec(
        fleet=base.fleet, fading=Fading(states=3, spread=1.4)).bucket_key()
    for kw in ({"faults": Faults(drop_prob=0.3)},
               {"energy": EnergyBudget(budget_j=0.5)},
               {"sampling": Sampling(size=2, weighted=True)}):
        assert ScenarioSpec(fleet=base.fleet, **kw).bucket_key() \
            == base.bucket_key()
    with pytest.raises(ValueError, match="hierarchical"):
        ScenarioSpec(fleet=base.fleet, topology=Topology(cells=2),
                     faults=Faults(drop_prob=0.2))


# ---------------------------------------------------------------------------
# the lowering, the grid and Experiment.run against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def datasets():
    return (ClassificationData.synthetic(n=400, dim=DIM, seed=0,
                                         spread=6.0).split(80),
            RefData.synthetic(n=400, dim=DIM, seed=0, spread=6.0).split(80))


def _specs(Spec, DP, feats, feature):
    kw = dict(hidden=HIDDEN, b_max=BMAX, base_lr=0.1, compression=0.05)
    return [Spec(fleet=_fleet(DP, 5), name="K5", partition="iid",
                 seeds=(0, 1), **kw, **feats[feature]),
            Spec(fleet=_fleet(DP, 4), name="K4", partition="noniid",
                 seeds=(2,), **kw, **feats[feature]),
            Spec(fleet=_fleet(DP, 5), name="K5s", partition="noniid",
                 seeds=(0,), **kw)]


@pytest.mark.parametrize("feature", ["energy", "all"])
def test_lowering_mask_and_energy_ledger_bitwise_reference(datasets,
                                                           feature):
    (data, test), (rdata, _) = datasets
    specs = _specs(ScenarioSpec, DeviceProfile, PORT, feature)
    rspecs = _specs(ref_api.ScenarioSpec, RefDevice, REF, feature)
    buckets = lowering.group_rows(specs)
    rbuckets = ref_lowering.group_rows(rspecs)
    assert [b.key for b in buckets] == [b.key for b in rbuckets]
    bucket, rbucket = buckets[0], rbuckets[0]
    planner = lowering._FeelPlanner(bucket, data)
    rplanner = ref_lowering._FeelPlanner(rbucket, rdata)
    plans = []
    for periods in (3, 2):
        plan, rplan = planner.plan(periods), rplanner.plan(periods)
        plans.append(plan)
        np.testing.assert_array_equal(plan.active, rplan.payload["active"])
        assert plan.energy.dtype == rplan.payload["energy"].dtype
        np.testing.assert_array_equal(plan.energy, rplan.payload["energy"])
        np.testing.assert_array_equal(plan.energy[2, :, 4], 0.0)  # padded
        np.testing.assert_array_equal(plan.times, rplan.times)
        np.testing.assert_array_equal(plan.global_batch, rplan.global_batch)
    # BucketRun banks the same ledger chunk by chunk
    run = lowering.BucketRun(bucket, data, 5, 3,
                             lowering.DeviceData(data, test, "cpu"))
    assert run.energy_ledger is None
    run.run_serial()
    np.testing.assert_array_equal(
        run.energy_ledger, np.concatenate([p.energy for p in plans], 1))


def test_grid_over_fading_matches_reference():
    def make(ns, Spec, DP, F, Fa):
        base = Spec(fleet=_fleet(DP, 4), name="K4", b_max=8, hidden=24)
        return ns.grid(base, fading=[None, F(states=3), F(states=4,
                                                           spread=0.2)],
                       faults=[None, Fa(drop_prob=0.1)])
    study = make(port_api, ScenarioSpec, DeviceProfile, Fading, Faults)
    ref = make(ref_api, ref_api.ScenarioSpec, RefDevice, RefFading,
               RefFaults)
    assert len(study) == len(ref) == 6
    assert [s.label for s in study] == [s.label for s in ref]
    assert study.coord_names == ref.coord_names
    assert repr(study) == repr(ref)
    for s, r in zip(study, ref):
        assert str(s.fading) == str(r.fading)
        assert s.bucket_key() == r.bucket_key()
        assert ({k: (type(v).__name__, str(v))
                 for k, v in study.axis_coords(s).items()}
                == {k: (type(v).__name__, str(v))
                    for k, v in ref.axis_coords(r).items()})
    assert len(Experiment(None, None, study, device="cpu").lower()) == 3


def _reference_init(rows, input_dim, device):
    per_row = [ref_model.init(jax.random.key(r.seed), r.spec.hidden,
                              depth=r.spec.depth, input_dim=input_dim)
               for r in rows]
    stacked = jax.tree_util.tree_map(
        lambda *a: np.stack([np.asarray(x) for x in a]), *per_row)
    return params_from_numpy(stacked, device)


@pytest.mark.parametrize("feature", ["fading", "faults", "energy",
                                     "weighted_faults"])
def test_experiment_run_dynamics_matches_reference(monkeypatch, datasets,
                                                   feature):
    monkeypatch.setattr(lowering, "_init_params_batch", _reference_init)
    (data, test), (rdata, rtest) = datasets
    got = Experiment(data, test, _specs(ScenarioSpec, DeviceProfile, PORT,
                                        feature), device="cpu").run(5)
    want = ref_api.Experiment(rdata, rtest, _specs(
        ref_api.ScenarioSpec, RefDevice, REF, feature)).run(5)
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_array_equal(got.global_batch, want.global_batch)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.accs, want.accs, rtol=1e-5, atol=1e-5)
    print(f"PARITY {feature} Experiment.run: losses max_abs_err="
          f"{float(np.abs(got.losses - want.losses).max()):.3g} tol=1e-5")


# ---------------------------------------------------------------------------
# Experiment.run within the port
# ---------------------------------------------------------------------------


def _spec(k, **kw):
    kw = dict(dict(name=f"K{k}", hidden=HIDDEN, b_max=BMAX, base_lr=0.15,
                   compression=0.05, seeds=(0,)), **kw)
    return ScenarioSpec(fleet=_fleet(DeviceProfile, k), **kw)


def test_identity_dynamics_run_bitwise_static(datasets):
    (data, test), _ = datasets
    static = Experiment(data, test, [_spec(4, seeds=(0, 1))],
                        device="cpu").run(4)
    ident = Experiment(data, test, [_spec(4, seeds=(0, 1),
                                          **PORT["identity"])],
                       device="cpu")
    (bucket,) = ident.lower()
    assert lowering.plan_bucket(bucket, data, 4).active.ndim == 3
    res = ident.run(4)
    for f in SERIES:
        np.testing.assert_array_equal(getattr(static, f), getattr(res, f),
                                      err_msg=f)


def test_chunked_run_equals_monolithic_under_drift(datasets):
    (data, test), _ = datasets
    specs = [_spec(5, seeds=(0, 1), **PORT["all"]),
             _spec(4, **PORT["faults"]), _spec(4, **PORT["energy"])]
    mono = Experiment(data, test, specs, device="cpu").run(5)
    chunked = Experiment(data, test, specs, device="cpu").run(
        5, executor=SerialExecutor(chunk_periods=2))
    for f in SERIES:
        np.testing.assert_array_equal(getattr(mono, f),
                                      getattr(chunked, f), err_msg=f)
