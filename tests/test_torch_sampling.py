"""Per-round participation sampling, K-bands and the ``aggden``
denominator in the PyTorch port, on the CPU.

Against the reference (the same numpy inputs through ``repro`` under
``JAX_PLATFORMS=cpu`` and through the port):

* ``ParticipationSampler`` draws, ``band_width`` / ``split_bands``: bitwise;
* ``FeelScheduler.plan_horizon`` for each policy × each sampling form
  (size, fraction, weighted, full cohort): bitwise in every field,
  ``participation`` and ``aggden`` included; fused ``plan_horizons_batch``
  with sampled rows: bitwise;
* the lowering's time-varying active mask: bitwise;
* ``grid`` over ``sampling=``: the same specs, labels and coordinates;
* ``Experiment.run`` on feel-mlp (size, fraction, weighted) with the
  reference's initial weights: ledgers bitwise, losses and accuracies
  within 1e-5; a weighted-sampled transformer row within 1e-4.

Within the port, all bitwise: full participation equals unsampled,
sampled-out columns are dead, weighted sampling at S = K collapses to
plain, a sampled run chunked equals it monolithic, fused planning equals
solo planning, a banded lowering's ledgers equal the unbanded ones, and
``aggden`` zeros give the pre-``aggden`` step."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as ref_api
from repro.api import lowering as ref_lowering
from repro.core import DeviceProfile as RefDevice
from repro.core import scheduler as ref_scheduler
from repro.data.pipeline import ClassificationData as RefData
from repro.fed import feel_model as ref_model
from repro.fed import model_engine as ref_me
from repro.topology import ParticipationSampler as RefSampler
from repro.topology import Sampling as RefSampling
from repro.topology import band_width as ref_band_width
from repro.topology import split_bands as ref_split_bands

import repro_torch.api as port_api
from repro_torch.api import (Experiment, ScenarioSpec, SerialExecutor,
                             grid, lowering)
from repro_torch.core import DeviceProfile
from repro_torch.core import scheduler
from repro_torch.data.pipeline import ClassificationData
from repro_torch.fed import engine
from repro_torch.interop import params_from_numpy
from repro_torch.topology import (ParticipationSampler, Sampling,
                                  band_width, split_bands)
from repro_torch.tree import tree_leaves

DIM, HIDDEN, BMAX = 32, 16, 12
FIELDS = ("batch", "tau_up", "tau_down", "lr", "latency", "global_batch",
          "participation", "aggden", "energy", "slowdown")
SERIES = ("losses", "accs", "times", "global_batch")
# each sampling form as (port value, reference value)
FORMS = {
    "size": (Sampling(size=3), RefSampling(size=3)),
    "fraction": (Sampling(fraction=0.4, seed=2),
                 RefSampling(fraction=0.4, seed=2)),
    "weighted": (Sampling(size=2, weighted=True),
                 RefSampling(size=2, weighted=True)),
    "full": (Sampling(size=6), RefSampling(size=6)),
}


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


def _assert_bitwise(a, b):
    for f in SERIES:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


# ---------------------------------------------------------------------------
# the stream and the band helpers against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("k", [1, 5, 9])
def test_sampler_draws_bitwise_and_chunk_invariant(form, k):
    samp, rsamp = FORMS[form]
    port, ref = ParticipationSampler(samp, k, 7), RefSampler(rsamp, k, 7)
    mono = ParticipationSampler(samp, k, 7).draw(9)
    got = [port.draw(4), port.draw(5)]
    want = [ref.draw(4), ref.draw(5)]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mono, np.concatenate(got))
    np.testing.assert_array_equal(mono.sum(1),
                                  np.full(9, float(samp.s_of(k))))
    assert str(samp) == str(rsamp)
    assert samp.p_of(k) == rsamp.p_of(k)


def test_sampling_validation_matches_reference():
    for kw in ({}, {"size": 2, "fraction": 0.5}, {"size": 0},
               {"size": True}, {"fraction": 0.0}, {"fraction": 1.5}):
        with pytest.raises(ValueError) as got:
            Sampling(**kw)
        with pytest.raises(ValueError) as want:
            RefSampling(**kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(TypeError, match="weighted"):
        Sampling(size=2, weighted=1)


def test_band_helpers_match_reference():
    ks = (1, 2, 3, 8, 9, 1024, 1025, 10240)
    assert [band_width(k) for k in ks] == [ref_band_width(k) for k in ks]
    with pytest.raises(ValueError):
        band_width(0)

    class R:
        def __init__(self, k):
            self.spec = type("S", (), {"k": k})()

    rows = [R(k) for k in (3, 5, 8, 1024, 2, 700)]
    got, want = split_bands(rows), ref_split_bands(rows)
    assert list(got) == list(want)
    assert all(got[b] == want[b] for b in got)


# ---------------------------------------------------------------------------
# the scheduler against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("policy", ["proposed", "online", "full", "random"])
def test_plan_horizon_sampled_bitwise_reference(policy, form):
    samp, rsamp = FORMS[form]
    port = scheduler.FeelScheduler(_fleet(DeviceProfile, 6), n_params=4000,
                                   policy=policy, b_max=16, seed=3,
                                   sampling=samp)
    ref = ref_scheduler.FeelScheduler(_fleet(RefDevice, 6), n_params=4000,
                                      policy=policy, b_max=16, seed=3,
                                      sampling=rsamp)
    assert port.dynamic == ref.dynamic
    for periods in (4, 3, 6):            # chunk edges off the cadence
        _assert_horizons_equal(port.plan_horizon(periods),
                               ref.plan_horizon(periods), policy)
    assert port._b_cache == ref._b_cache and port._period == ref._period


def test_fused_sampled_planning_bitwise_reference_and_solo():
    def make(mod, DP, S):
        return [mod.FeelScheduler(_fleet(DP, 4 + i), n_params=900,
                                  b_max=BMAX, seed=i, policy=pol,
                                  sampling=None if s is None else S(**s))
                for i, (pol, s) in enumerate([
                    ("proposed", {"size": 2}), ("proposed", None),
                    ("proposed", {"fraction": 0.5, "seed": 1}),
                    ("random", {"size": 3}),
                    ("proposed", {"size": 2, "weighted": True}),
                    ("proposed", {"size": 9})])]
    port = make(scheduler, DeviceProfile, Sampling)
    ref = make(ref_scheduler, RefDevice, RefSampling)
    for periods in (5, 3):
        for a, b in zip(scheduler.plan_horizons_batch(port, periods),
                        ref_scheduler.plan_horizons_batch(ref, periods)):
            _assert_horizons_equal(a, b)
    solo = make(scheduler, DeviceProfile, Sampling)
    fused = make(scheduler, DeviceProfile, Sampling)
    for a, s in zip(scheduler.plan_horizons_batch(fused, 6), solo):
        _assert_horizons_equal(a, s.plan_horizon(6))


# ---------------------------------------------------------------------------
# the scheduler within the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["proposed", "online", "full", "random"])
def test_full_participation_horizon_is_bitwise_unsampled(policy):
    devs = _fleet(DeviceProfile, 6)
    h1 = scheduler.FeelScheduler(devs, n_params=900, policy=policy,
                                 b_max=BMAX).plan_horizon(5)
    h2 = scheduler.FeelScheduler(devs, n_params=900, policy=policy,
                                 b_max=BMAX,
                                 sampling=Sampling(size=6)).plan_horizon(5)
    for f in ("batch", "tau_up", "tau_down", "lr", "latency",
              "global_batch"):
        np.testing.assert_array_equal(getattr(h1, f), getattr(h2, f))
    np.testing.assert_array_equal(h2.participation, 1.0)


@pytest.mark.parametrize("policy", ["proposed", "full"])
def test_sampled_horizon_masks_absentees(policy):
    h = scheduler.FeelScheduler(_fleet(DeviceProfile, 8), n_params=900,
                                policy=policy, b_max=BMAX,
                                sampling=Sampling(size=3)).plan_horizon(6)
    assert h.participation.shape == (6, 8)
    np.testing.assert_array_equal(h.participation.sum(1), np.full(6, 3.0))
    np.testing.assert_array_equal((h.batch > 0).astype(np.float32),
                                  h.participation)
    np.testing.assert_array_equal(h.tau_up[h.participation < 0.5], 0.0)
    np.testing.assert_array_equal(h.global_batch,
                                  h.batch.sum(1).astype(np.int64))
    assert h.aggden is None


def test_weighted_sampling_plans_the_full_fleet():
    """The weighted horizon's allocation is the unsampled plan with the
    absentees zeroed, and aggden is p·Σ over the full-fleet plan."""
    devs = _fleet(DeviceProfile, 6)
    full = scheduler.FeelScheduler(devs, n_params=900, b_max=BMAX,
                                   seed=4).plan_horizon(5)
    w = scheduler.FeelScheduler(devs, n_params=900, b_max=BMAX, seed=4,
                                sampling=Sampling(size=2, weighted=True)
                                ).plan_horizon(5)
    np.testing.assert_array_equal(
        w.batch, np.where(w.participation > 0.5, full.batch, 0))
    np.testing.assert_array_equal(
        w.aggden, (2 / 6) * full.batch.sum(1).astype(np.float64))


def test_sampled_chunked_horizon_bitwise_monolithic():
    def mk():
        return scheduler.FeelScheduler(_fleet(DeviceProfile, 6),
                                       n_params=900, b_max=BMAX, seed=11,
                                       sampling=Sampling(fraction=0.5))
    hm = mk().plan_horizon(8)
    s = mk()
    hc = [s.plan_horizon(5), s.plan_horizon(3)]
    for f in ("batch", "latency", "participation"):
        np.testing.assert_array_equal(
            getattr(hm, f), np.concatenate([getattr(h, f) for h in hc]))


# ---------------------------------------------------------------------------
# the lowering, the grid and Experiment.run against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def datasets():
    return (ClassificationData.synthetic(n=400, dim=DIM, seed=0,
                                         spread=6.0).split(80),
            RefData.synthetic(n=400, dim=DIM, seed=0, spread=6.0).split(80))


def _specs(Spec, DP, S, **kw):
    kw = dict(dict(hidden=HIDDEN, b_max=BMAX, base_lr=0.1,
                   compression=0.05), **kw)
    return [Spec(fleet=_fleet(DP, 5), name="K5", partition="iid",
                 seeds=(0, 1), **kw),
            Spec(fleet=_fleet(DP, 5), name="K5", partition="iid",
                 seeds=(0,), sampling=S(size=2), **kw),
            Spec(fleet=_fleet(DP, 4), name="K4", partition="noniid",
                 seeds=(1,), sampling=S(fraction=0.5, seed=3), **kw),
            Spec(fleet=_fleet(DP, 5), name="K5w", partition="noniid",
                 seeds=(0,), sampling=S(size=3, weighted=True), **kw)]


def test_lowering_active_mask_bitwise_reference(datasets):
    (data, _), (rdata, _) = datasets
    specs = _specs(ScenarioSpec, DeviceProfile, Sampling)
    rspecs = _specs(ref_api.ScenarioSpec, RefDevice, RefSampling)
    (bucket,) = lowering.group_rows(specs)
    (rbucket,) = ref_lowering.group_rows(rspecs)
    assert bucket.key == rbucket.key and bucket.k_pad == rbucket.k_pad
    planner = lowering._FeelPlanner(bucket, data)
    rplanner = ref_lowering._FeelPlanner(rbucket, rdata)
    for periods in (3, 2):
        plan, rplan = planner.plan(periods), rplanner.plan(periods)
        active = rplan.payload["active"]
        assert plan.active.shape == (5, periods, 5)
        assert plan.active.dtype == active.dtype
        np.testing.assert_array_equal(plan.active, active)
        np.testing.assert_array_equal(plan.active[3, :, 4], 0.0)  # padded
        np.testing.assert_array_equal(plan.times, rplan.times)
        for s, r in zip(plan.schedules, rplan.payload["schedules"]):
            for f in ("idx", "weight", "batch", "lr", "times",
                      "global_batch", "aggden"):
                a, b = getattr(s, f), getattr(r, f)
                assert (a is None) == (b is None), f
                if a is not None:
                    np.testing.assert_array_equal(a, b, err_msg=f)
        assert plan.energy is None and "energy" not in rplan.payload


def test_grid_over_sampling_matches_reference():
    def make(ns, Spec, DP, S):
        base = Spec(fleet=_fleet(DP, 4), name="K4", b_max=8, hidden=24)
        return ns.grid(base, sampling=[None, S(size=2),
                                       S(fraction=0.5, weighted=True)],
                       partition=["iid", "noniid"])
    study = make(port_api, ScenarioSpec, DeviceProfile, Sampling)
    ref = make(ref_api, ref_api.ScenarioSpec, RefDevice, RefSampling)
    assert len(study) == len(ref) == 6
    assert [s.label for s in study] == [s.label for s in ref]
    assert study.coord_names == ref.coord_names
    assert repr(study) == repr(ref)
    for s, r in zip(study, ref):
        assert str(s.sampling) == str(r.sampling)
        assert ({k: (type(v).__name__, str(v))
                 for k, v in study.axis_coords(s).items()}
                == {k: (type(v).__name__, str(v))
                    for k, v in ref.axis_coords(r).items()})
    assert len(Experiment(None, None, study, device="cpu").lower()) == 1


def _reference_init(rows, input_dim, device):
    per_row = [ref_model.init(jax.random.key(r.seed), r.spec.hidden,
                              depth=r.spec.depth, input_dim=input_dim)
               for r in rows]
    stacked = jax.tree_util.tree_map(
        lambda *a: np.stack([np.asarray(x) for x in a]), *per_row)
    return params_from_numpy(stacked, device)


def test_experiment_run_sampled_matches_reference(monkeypatch, datasets):
    monkeypatch.setattr(lowering, "_init_params_batch", _reference_init)
    (data, test), (rdata, rtest) = datasets
    specs = _specs(ScenarioSpec, DeviceProfile, Sampling)
    rspecs = _specs(ref_api.ScenarioSpec, RefDevice, RefSampling)
    got = Experiment(data, test, specs, device="cpu").run(5)
    want = ref_api.Experiment(rdata, rtest, rspecs).run(5)
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_array_equal(got.global_batch, want.global_batch)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.accs, want.accs, rtol=1e-5, atol=1e-5)
    print(f"PARITY sampled Experiment.run: losses max_abs_err="
          f"{float(np.abs(got.losses - want.losses).max()):.3g} tol=1e-5")


def _reference_big_init(rows, input_dim, device):
    s = rows[0].spec
    keys = jnp.stack([jax.random.key(r.seed) for r in rows])
    return params_from_numpy(jax.tree_util.tree_map(
        np.asarray, ref_me.init_params_batch(s.model_family, s.hidden,
                                             s.depth, keys)), device)


def test_weighted_sampled_transformer_row_matches_reference(monkeypatch,
                                                            datasets):
    monkeypatch.setattr(lowering, "_init_params_batch", _reference_big_init)
    (data, test), (rdata, rtest) = datasets

    def spec(Spec, DP, S):
        return [Spec(fleet=_fleet(DP, 5), name="K5", partition="iid",
                     seeds=(0,), hidden=16, depth=2, b_max=8, base_lr=0.1,
                     compression=0.05, model_family="transformer",
                     sampling=S(size=2, weighted=True))]
    got = Experiment(data, test, spec(ScenarioSpec, DeviceProfile,
                                      Sampling), device="cpu").run(4)
    want = ref_api.Experiment(rdata, rtest, spec(
        ref_api.ScenarioSpec, RefDevice, RefSampling)).run(4)
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_array_equal(got.global_batch, want.global_batch)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got.accs, want.accs, rtol=1e-4, atol=1e-4)
    print(f"PARITY weighted-sampled transformer Experiment.run: losses "
          f"max_abs_err={float(np.abs(got.losses - want.losses).max()):.3g}"
          f" tol=1e-4")


# ---------------------------------------------------------------------------
# Experiment.run within the port
# ---------------------------------------------------------------------------


def _spec(k, **kw):
    kw = dict(dict(name=f"K{k}", hidden=HIDDEN, b_max=BMAX, base_lr=0.15,
                   compression=0.05, seeds=(0,)), **kw)
    return ScenarioSpec(fleet=_fleet(DeviceProfile, k), **kw)


def test_full_participation_run_bitwise_unsampled(datasets):
    (data, test), _ = datasets
    specs = [_spec(6), _spec(6, sampling=Sampling(size=6)),
             _spec(6, sampling=Sampling(size=2))]
    exp = Experiment(data, test, specs, device="cpu")
    assert len(exp.lower()) == 1             # sampling is not structural
    res = exp.run(5)
    for f in SERIES:
        np.testing.assert_array_equal(getattr(res, f)[0],
                                      getattr(res, f)[1], err_msg=f)
    assert not np.array_equal(res.times[0], res.times[2])


def test_weighted_full_cohort_collapses_to_plain(datasets):
    """At S = K the inclusion probability is 1 and the HT denominator
    equals the executed batch sum: weighted == unweighted bitwise."""
    (data, test), _ = datasets
    runs = [Experiment(data, test, [_spec(
        4, sampling=Sampling(size=4, weighted=w))], device="cpu").run(4)
        for w in (False, True)]
    _assert_bitwise(*runs)
    sub = [Experiment(data, test, [_spec(
        4, sampling=Sampling(size=2, weighted=w))], device="cpu").run(4)
        for w in (False, True)]
    assert not np.array_equal(sub[0].losses, sub[1].losses)


def test_sampled_chunked_run_bitwise_monolithic(datasets):
    (data, test), _ = datasets
    specs = [_spec(5, sampling=Sampling(size=2), seeds=(0, 1)),
             _spec(4, sampling=Sampling(size=3, weighted=True))]
    mono = Experiment(data, test, specs, device="cpu").run(5)
    chunked = Experiment(data, test, specs, device="cpu").run(
        5, executor=SerialExecutor(chunk_periods=2))
    _assert_bitwise(mono, chunked)


def test_sampled_out_columns_are_dead(datasets):
    """Garbage weights and batches in a sampled-out user's schedule
    columns reach no series, parameter or residual."""
    (data, test), _ = datasets
    (bucket,) = lowering.group_rows(
        [_spec(5, sampling=Sampling(size=2), seeds=(3,))])
    plan = lowering.plan_bucket(bucket, data, 4)
    assert plan.active.shape == (1, 4, 5)
    arrays = lowering.DeviceData(data, test, "cpu").features

    def run(schedules):
        params0 = lowering._init_params_batch(bucket.rows, plan.input_dim,
                                              "cpu")
        state = engine.EngineState(params0,
                                   engine.zero_residual(params0, 5))
        return engine.run_trajectory_batch(state, schedules, arrays,
                                           ratio=0.05, active=plan.active)

    clean_state, clean = run(plan.schedules)
    s = plan.schedules[0]
    dead = plan.active[0] < 0.5
    weight, batch = s.weight.copy(), s.batch.copy()
    weight[dead] = 1e6
    batch[dead] = 9.9e5
    state, poisoned = run([replace(s, weight=weight, batch=batch)])
    for a, b in zip(clean, poisoned):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(clean_state.params)
                    + tree_leaves(clean_state.residual),
                    tree_leaves(state.params) + tree_leaves(state.residual)):
        assert torch.equal(a, b)


def test_banded_lowering_matches_unbanded(datasets):
    """bands=True: one bucket per power-of-two band, host ledgers bitwise
    the unbanded run's, series within 1e-5 (a band pads the user axis
    differently from the grid's largest fleet), and the same coords."""
    (data, test), _ = datasets
    specs = [_spec(3, seeds=(0, 1)), _spec(4, sampling=Sampling(size=2)),
             _spec(7)]
    exp = Experiment(data, test, specs, device="cpu")
    buckets = exp.lower(bands=True)
    assert sorted((b.band, b.k_pad) for b in buckets) == [(4, 4), (8, 8)]
    assert [b.k_pad for b in exp.lower()] == [7]
    flat, banded = exp.run(4), exp.run(4, bands=True)
    np.testing.assert_array_equal(flat.times, banded.times)
    np.testing.assert_array_equal(flat.global_batch, banded.global_batch)
    np.testing.assert_allclose(flat.losses, banded.losses, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(flat.accs, banded.accs, rtol=1e-5, atol=1e-5)
    print(f"PARITY banded vs unbanded Experiment.run: losses max_abs_err="
          f"{float(np.abs(flat.losses - banded.losses).max()):.3g} "
          "tol=1e-5, ledgers bitwise")
    for name in ("fleet", "partition", "policy", "seed"):
        assert list(flat.coords[name]) == list(banded.coords[name])
    streamed = list(exp.stream(4, bands=True))
    assert len(streamed) == 2
    _assert_bitwise(streamed[-1], banded)


# ---------------------------------------------------------------------------
# the aggden denominator
# ---------------------------------------------------------------------------


def test_aggregation_weights_fall_back_bitwise_and_fix_the_denominator():
    gen = torch.Generator().manual_seed(0)
    bk = torch.randint(0, 40, (3, 7), generator=gen).float()
    bk[:, 0] = 5.0                           # every row has a survivor
    zero = torch.zeros(3)
    assert torch.equal(engine.aggregation_weights(bk, zero),
                       bk / bk.sum(-1, keepdim=True))
    den = torch.tensor([0.0, 50.0, 7.5])
    w = engine.aggregation_weights(bk, den)
    assert torch.equal(w[0], bk[0] / bk[0].sum())
    assert torch.equal(w[1:], bk[1:] / den[1:, None])


def test_aggden_zeros_give_the_pre_aggden_step(datasets):
    """A schedule whose aggden is all zeros runs bitwise as one without
    aggden; a positive aggden changes the aggregate."""
    (data, test), _ = datasets
    (bucket,) = lowering.group_rows([_spec(4, seeds=(0, 1))])
    plan = lowering.plan_bucket(bucket, data, 3)
    arrays = lowering.DeviceData(data, test, "cpu").features

    def run(schedules):
        params0 = lowering._init_params_batch(bucket.rows, plan.input_dim,
                                              "cpu")
        state = engine.EngineState(params0,
                                   engine.zero_residual(params0, 4))
        return engine.run_trajectory_batch(state, schedules, arrays,
                                           ratio=0.05, active=plan.active)[1]

    assert all(s.aggden is None for s in plan.schedules)
    base = run(plan.schedules)
    zeros = run([replace(s, aggden=np.zeros(3, np.float32))
                 for s in plan.schedules])
    for a, b in zip(base, zeros):
        assert torch.equal(a, b)
    fixed = run([replace(s, aggden=np.full(3, 2.0 * s.batch.sum(1).max(),
                                           np.float32))
                 for s in plan.schedules])
    assert not torch.equal(base[0], fixed[0])
    xs = engine.stack_schedules(plan.schedules, "cpu")
    assert torch.equal(xs["aggden"], torch.zeros(2, 3))
