"""Adaptive local steps (``adapt_tau=``) in the PyTorch port, on the CPU.

Against the reference (the same inputs through ``repro`` under
``JAX_PLATFORMS=cpu`` and through the port):

* ``TauAdapt`` validation and ``__str__``;
* the spec's rules (``replan`` needed, ``local_steps`` among the
  choices, refused on the dev schemes, the big-model families and under
  a topology) with the reference's error types, and ``bucket_key``;
* ``FeelScheduler.recommend_tau`` before and after feedback, from the
  solo and the fused planning path: equal;
* an adaptive bucket teacher-forced chunk by chunk (both planners fed
  the reference's decays): the τ sequence equal and every plan bitwise;
* end to end, each package fed its own decays: the τ sequence equal,
  ``global_batch`` equal, ``times`` within rtol 1e-9, losses and
  accuracies within 1e-4 (compressed).

Within the port: τ changing mid-run, chunk by chunk, is bitwise one
uninterrupted period loop over the same schedules at the same τ
sequence (the carry and the time offset go on unchanged, and the
engine's τ comes from the plan, not the spec)."""
import functools

import numpy as np
import pytest
import torch

import repro.api as ref_api
from repro.api import lowering as ref_lowering
from repro.channels.model import CellConfig as RefCell
from repro.core import DeviceProfile as RefDevice
from repro.core import scheduler as ref_scheduler
from repro.data.pipeline import ClassificationData as RefData
from repro.dynamics import TauAdapt as RefTau
from repro.topology import Topology as RefTopology

from repro_torch.api import Experiment, ScenarioSpec
from repro_torch.api import lowering
from repro_torch.channels.model import CellConfig
from repro_torch.core import DeviceProfile, scheduler
from repro_torch.data.pipeline import ClassificationData
from repro_torch.dynamics import TauAdapt
from repro_torch.fed import engine
from repro_torch.topology import Topology

from test_torch_closed_loop import (PORT_NS, REF_NS, _assert_run_matches,
                                    _decays, _explain, _make_sched,
                                    _reference_init, teacher_forced)

CHOICES = (1, 2, 4)


@pytest.mark.parametrize("choices", [(), (1, 0), (2, 2), (1, True), (1.5,),
                                     [1, 2], (4, 1, 2), None])
def test_tau_adapt_validation_matches_reference(choices):
    def outcome(cls):
        try:
            t = cls() if choices is None else cls(choices=choices)
        except (TypeError, ValueError) as exc:
            return type(exc), str(exc)
        return t.choices, str(t)
    assert outcome(TauAdapt) == outcome(RefTau)


def _outcome(ns, kw):
    """``bucket_key()`` of a spec built in one package, or the type of
    the error it raises."""
    fleet = tuple(ns["DP"](kind="cpu", f_cpu=f * 1e9)
                  for f in [0.7, 1.4, 2.1, 0.7])
    try:
        spec = ns["Spec"](fleet=fleet, **kw(ns))
    except (TypeError, ValueError) as exc:
        return type(exc)
    return spec.bucket_key()


SPECS = dict(DP=DeviceProfile, Spec=ScenarioSpec, Tau=TauAdapt,
             Topology=Topology)
REF_SPECS = dict(DP=RefDevice, Spec=ref_api.ScenarioSpec, Tau=RefTau,
                 Topology=RefTopology)


@pytest.mark.parametrize("kw", [
    lambda ns: dict(replan=2, adapt_tau=ns["Tau"]()),
    lambda ns: dict(replan=2, local_steps=2, adapt_tau=ns["Tau"]((1, 2))),
    lambda ns: dict(adapt_tau=ns["Tau"]((1, 2))),
    lambda ns: dict(replan=2, local_steps=3, adapt_tau=ns["Tau"]((1, 2))),
    lambda ns: dict(replan=2, adapt_tau=object()),
    lambda ns: dict(replan=2, scheme="individual", adapt_tau=ns["Tau"]()),
    lambda ns: dict(replan=2, scheme="gradient_fl", adapt_tau=ns["Tau"]()),
    lambda ns: dict(replan=2, model_family="transformer",
                    adapt_tau=ns["Tau"]()),
    lambda ns: dict(replan=2, model_family="mamba2",
                    adapt_tau=ns["Tau"]()),
    lambda ns: dict(replan=2, topology=ns["Topology"](cells=2),
                    adapt_tau=ns["Tau"]()),
    lambda ns: dict(replan=2, adapt_tau=ns["Tau"]((2, 1)))])
def test_spec_rules_and_bucket_key_match_reference(kw):
    assert _outcome(SPECS, kw) == _outcome(REF_SPECS, kw)


def test_adapt_tau_choices_key_the_bucket():
    """As the reference's ``tests/test_dynamics.py``: the choice set is
    structural (every realized τ is its own device loop shape)."""
    fleet = tuple(DeviceProfile(kind="cpu", f_cpu=f * 1e9)
                  for f in [0.7, 1.4, 2.1])
    adaptive = ScenarioSpec(fleet=fleet, replan=2,
                            adapt_tau=TauAdapt(choices=(1, 2)))
    assert adaptive.bucket_key() != ScenarioSpec(fleet=fleet,
                                                 replan=2).bucket_key()
    assert adaptive.bucket_key()[-2] == (1, 2)
    assert adaptive.has_dynamics


# ---------------------------------------------------------------------------
# recommend_tau, solo and fused, against the reference
# ---------------------------------------------------------------------------


def _scores(s, choices=CHOICES):
    """Each candidate's E(τ) as ``recommend_tau`` scores it (printed
    beside a mismatch)."""
    comp = max(s._last_comp, 0.0)
    comm = max(s._last_lat - comp, 1e-12)
    cap = s.xi_est.decay_cap
    b_bar = float(np.mean(s._b_cache))
    out = {}
    for t in sorted(choices):
        dl = s.xi_est.xi * float(np.sqrt(t * b_bar))
        out[t] = (dl if cap is None else min(dl, cap)) / (comm + t * comp)
    return out


@pytest.mark.parametrize("policy,world", [
    ("proposed", "static"), ("proposed", "sampling"),
    ("proposed", "fading"), ("full", "static"), ("random", "fading")])
def test_recommend_tau_solo_matches_reference(policy, world):
    port = _make_sched(PORT_NS, policy, world)
    ref = _make_sched(REF_NS, policy, world)
    rng = np.random.default_rng(7)
    for cur in CHOICES:                      # no feedback yet: τ stands
        assert port.recommend_tau(CHOICES, cur) == cur == \
            ref.recommend_tau(CHOICES, cur)
    for c in range(3):
        h = port.plan_horizon(4, warm_start=c > 0, closed_loop=True)
        ref.plan_horizon(4, warm_start=c > 0, closed_loop=True)
        for cur in CHOICES:
            got = port.recommend_tau(CHOICES, cur)
            want = ref.recommend_tau(CHOICES, cur)
            assert got == want, (c, cur, _scores(port), _scores(ref))
        if policy != "proposed":             # no B* carry: τ stands
            assert port.recommend_tau(CHOICES, 2) == 2
        d, g = _decays(rng, h.global_batch)
        port.observe_series(d, g)
        ref.observe_series(d, g)


def test_recommend_tau_fused_matches_reference():
    """From the fused path, which computes its comm/comp bookkeeping on
    its padded rows instead of through ``_realize``: equal to the
    reference's fused path."""
    def build(ns):
        return [ns["mod"].FeelScheduler(
            devices=tuple(ns["DP"](kind="gpu", gpu_b_th=8 + 4 * i)
                          for i in range(k)),
            n_params=40000, b_max=16, seed=seed,
            cell_cfg=ns["Cell"](bandwidth_hz=1e5))
            for k, seed in [(4, 1), (5, 2), (3, 3)]]

    port = build(dict(PORT_NS, Cell=CellConfig))
    ref = build(dict(REF_NS, Cell=RefCell))
    rng = np.random.default_rng(5)
    seen = set()
    for c in range(3):
        got = scheduler.plan_horizons_batch(port, 4, warm_start=c > 0,
                                            closed_loop=True)
        ref_scheduler.plan_horizons_batch(ref, 4, warm_start=c > 0,
                                          closed_loop=True)
        for s, r, h in zip(port, ref, got):
            assert (s._last_lat, s._last_comp) == (r._last_lat, r._last_comp)
            for cur in CHOICES:
                tau = s.recommend_tau(CHOICES, cur)
                assert tau == r.recommend_tau(CHOICES, cur), \
                    (c, cur, _scores(s), _scores(r))
                seen.add(tau)
            d, g = _decays(rng, h.global_batch)
            s.observe_series(d, g)
            r.observe_series(d, g)
    assert len(seen) > 1                     # the score really chooses


# ---------------------------------------------------------------------------
# an adaptive bucket against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def datasets():
    return (ClassificationData.synthetic(n=400, dim=32, seed=0,
                                         spread=6.0).split(80),
            RefData.synthetic(n=400, dim=32, seed=0, spread=6.0).split(80))


def _adaptive(Spec, DP, Cell, T, **kw):
    """A communication-bound GPU fleet (a 100 kHz cell, SBC 0.5), where
    the criterion moves τ off 1 after the first chunk."""
    kw = dict(dict(hidden=16, b_max=12, base_lr=0.1, compression=0.5,
                   cell=Cell(bandwidth_hz=1e5), replan=2, local_steps=1,
                   adapt_tau=T(CHOICES)), **kw)
    def fleet(k):
        return tuple(DP(kind="gpu", f_cpu=(0.6 + 0.3 * i) * 1e9)
                     for i in range(k))

    return [Spec(fleet=fleet(4), partition="noniid", seeds=(0, 1), **kw),
            Spec(fleet=fleet(3), partition="iid", seeds=(2,), **kw)]


def _specs():
    return (_adaptive(ScenarioSpec, DeviceProfile, CellConfig, TauAdapt),
            _adaptive(ref_api.ScenarioSpec, RefDevice, RefCell, RefTau))


def test_adaptive_teacher_forced_bitwise_reference(monkeypatch, datasets):
    specs, ref_specs = _specs()
    taus, err = teacher_forced(monkeypatch, datasets, specs, ref_specs, 8,
                               2, 1e-4)
    assert taus[0] == 1 and len(set(taus)) > 1, taus
    print(f"PARITY adaptive τ teacher-forced: τ {taus} equal, plans bitwise;"
          f" decays max_abs_err={err:.3g} tol=1e-4")


def _taus(run, ns_run):
    """Drive a BucketRun serially, recording the τ each chunk ran at."""
    taus = []
    while not run.done:
        ns_run(run)
        taus.append(run._planner._tau)
        run.collect()
    return taus


def test_adaptive_run_end_to_end_matches_reference(monkeypatch, datasets):
    monkeypatch.setattr(lowering, "_init_params_batch", _reference_init)
    (data, test), (rdata, rtest) = datasets
    specs, ref_specs = _specs()
    (bucket,) = lowering.group_rows(specs)
    (rbucket,) = ref_lowering.group_rows(ref_specs)
    run = lowering.BucketRun(bucket, data, 8, 2,
                             lowering.DeviceData(data, test, "cpu"))
    rrun = ref_lowering.BucketRun(rbucket, rdata, rtest, 8, 2)
    taus = _taus(run, lambda r: r.advance())
    rtaus = _taus(rrun, lambda r: r.advance())
    assert taus == rtaus, (taus, rtaus,
                           [_scores(s) for s in run._planner.schedulers],
                           [_scores(s) for s in rrun._planner.schedulers])
    assert len(set(taus)) > 1, taus
    got = Experiment(data, test, specs, device="cpu").run(8)
    want = ref_api.Experiment(rdata, rtest, ref_specs).run(8)
    _assert_run_matches(got, want, 1e-4,
                        f"adaptive τ Experiment.run, τ {taus}",
                        functools.partial(_explain, specs, ref_specs,
                                          datasets, 8, 2))


# ---------------------------------------------------------------------------
# within the port: τ changing mid-run
# ---------------------------------------------------------------------------


def _concat(schedules):
    """One row's chunk schedules as one schedule over the whole run."""
    return engine.Schedule(**{
        f: np.concatenate([getattr(s, f) for s in schedules])
        for f in ("idx", "weight", "batch", "lr", "times", "global_batch")})


def test_tau_change_mid_run_equals_one_period_loop(datasets):
    (data, test), _ = datasets
    specs, _ = _specs()
    (bucket,) = lowering.group_rows(specs)
    arrays = lowering.DeviceData(data, test, "cpu")
    run = lowering.BucketRun(bucket, data, 8, 2, arrays)
    plans = []
    while not run.done:
        plans.append(run.plan_next())
        run.dispatch(plans[-1])
        run.collect()
    losses, accs, times, gb = run.result()
    taus = [p.tau for p in plans]
    assert taus[0] == bucket.rows[0].spec.local_steps == 1
    assert len(set(taus)) > 1, taus
    # the same schedules through one uninterrupted period loop from the
    # same init, τ per period from the plans
    n = len(bucket.rows)
    sched = [_concat([p.schedules[i] for p in plans]) for i in range(n)]
    np.testing.assert_array_equal(np.stack([s.times for s in sched]), times)
    xs = engine.stack_schedules(sched, arrays.device)
    active = engine.normalize_active(bucket.active_mask(), n, 8,
                                     bucket.k_pad, arrays.device)
    params0 = lowering._init_params_batch(bucket.rows, data.x.shape[1],
                                          arrays.device)
    state = engine.EngineState(params0,
                               engine.zero_residual(params0, bucket.k_pad))
    tau_of = np.repeat(taus, [p.times.shape[1] for p in plans])
    out = []
    with torch.no_grad():
        for p in range(8):
            state, series = engine._period_step(
                arrays.features, active[:, p], True, 0.5, state,
                {k: v[:, p] for k, v in xs.items()}, int(tau_of[p]))
            out.append(series)
    loop_losses = np.stack([o[0].numpy() for o in out], axis=1)
    loop_accs = np.stack([o[1].numpy() for o in out], axis=1)
    loop_decays = np.stack([o[2].numpy() for o in out], axis=1)
    np.testing.assert_array_equal(loop_losses, losses)
    np.testing.assert_array_equal(loop_accs, accs)
    np.testing.assert_array_equal(loop_decays, run.realized_decays)
