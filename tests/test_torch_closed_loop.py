"""The closed loop (``replan=``) in the PyTorch port, on the CPU.

Against the reference (the same numpy inputs through ``repro`` under
``JAX_PLATFORMS=cpu`` and through the port), fed the same realized
decays, all bitwise:

* ``optimize_batch_rows`` with ``b_prev`` (finite, NaN, stale and mixed
  hints, with and without ``energy=``) and with ``dl_cap`` (binding,
  unbinding, inf, NaN, 0 and negative caps), and the reference's
  ``test_decay_cap_steers_b_star`` on both packages;
* ``FeelScheduler.plan_horizon(warm_start, closed_loop)`` per policy ×
  {static, sampling, fading, topology} over three chunks with the same
  ``observe_series`` feedback between them: every field, ``_b_cache``,
  the comm/comp bookkeeping and ``recommend_tau``;
* ``plan_horizons_batch`` fused over cold and warm, capped and uncapped
  schedulers;
* ``group_rows(replan=)``: validation, the override and replan twins;
* a teacher-forced chunk-by-chunk run: both planners observe the
  reference's decays; plans bitwise, the port's decays within 1e-5
  (1e-4 compressed).

End to end, each package feeds itself its own decays:
``Experiment.run(replan=2)`` keeps the reference's ``global_batch``,
``times`` within rtol 1e-9, losses and accuracies within 1e-5 (1e-4
compressed), on feel-mlp and on one transformer and one mamba2 row.

Within the port: the ``BucketRun`` guard (``can_advance`` and
``plan_next`` refuse while a closed-loop chunk is in flight) and the
feedback reaching the estimators; ξ-invariance at the reference test's
shapes (closed loop == open loop, series bitwise); ``chunk_periods``
ignored, ``AsyncExecutor`` bitwise ``SerialExecutor`` and padded rows
keeping their solo twins' decisions; ``chunk_lengths``; ``park()`` then
resume bitwise an unparked run."""
import copy
import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
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
from repro.fed import feel_model as ref_model
from repro.fed import model_engine as ref_me
from repro.topology import Sampling as RefSampling
from repro.topology import Topology as RefTopology

from repro_torch.api import (AsyncExecutor, Experiment, ScenarioSpec,
                             SerialExecutor)
from repro_torch.api import lowering
from repro_torch.core import DeviceProfile
from repro_torch.core import scheduler, solver
from repro_torch.data.pipeline import ClassificationData
from repro_torch.dynamics import EnergyBudget, Fading
from repro_torch.interop import params_from_numpy
from repro_torch.topology import Sampling, Topology

DIM, HIDDEN, BMAX = 32, 16, 12
FIELDS = ("batch", "tau_up", "tau_down", "lr", "latency", "global_batch",
          "participation", "cloud", "aggden", "energy", "slowdown")
SERIES = ("losses", "accs", "times", "global_batch")
SCHEDULE = ("idx", "weight", "batch", "lr", "times", "global_batch",
            "aggden")
tmap = jax.tree_util.tree_map


def _fleet(DP, k):
    return tuple(DP(kind="cpu" if i % 3 else "gpu",
                    f_cpu=(0.6 + 0.3 * i) * 1e9) for i in range(k))


def _reference_init(rows, input_dim, device):
    """The reference's initial weights, for either model kind."""
    s = rows[0].spec
    if s.model_family != "feel_mlp":
        keys = jnp.stack([jax.random.key(r.seed) for r in rows])
        return params_from_numpy(tmap(np.asarray, ref_me.init_params_batch(
            s.model_family, s.hidden, s.depth, keys)), device)
    per_row = [ref_model.init(jax.random.key(r.seed), s.hidden,
                              depth=s.depth, input_dim=input_dim)
               for r in rows]
    stacked = tmap(lambda *a: np.stack([np.asarray(x) for x in a]),
                   *per_row)
    return params_from_numpy(stacked, device)


def _assert_horizons_equal(a, b, msg=""):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f"{msg} {f}"
        if x is not None:
            assert x.dtype == y.dtype, f"{msg} {f}"
            np.testing.assert_array_equal(x, y, err_msg=f"{msg} {f}")


def _assert_state_equal(s, r, msg=""):
    """The closed loop's scheduler state: the B* carry, the period, the
    estimator and the adaptive-τ bookkeeping."""
    np.testing.assert_array_equal(np.asarray(s._b_cache, float),
                                  np.asarray(r._b_cache, float),
                                  err_msg=f"{msg} _b_cache")
    assert s._period == r._period, msg
    assert (s.xi_est.xi, s.xi_est.decay_cap) == \
        (r.xi_est.xi, r.xi_est.decay_cap), msg
    assert (s._last_lat, s._last_comp) == (r._last_lat, r._last_comp), msg
    for cur in (1, 2, 4):
        assert s.recommend_tau((1, 2, 4), cur) == \
            r.recommend_tau((1, 2, 4), cur), f"{msg} recommend_tau"


# ---------------------------------------------------------------------------
# optimize_batch_rows(b_prev=, dl_cap=) against the reference
# ---------------------------------------------------------------------------


def _rows_problem(seed=5, m=4, k=5):
    rng = np.random.default_rng(seed)
    fleets = [_fleet(DeviceProfile, k - (i % 2)) for i in range(m)]
    ref_fleets = [_fleet(RefDevice, k - (i % 2)) for i in range(m)]
    up = rng.uniform(2e6, 8e7, size=(m, k))
    down = rng.uniform(2e6, 8e7, size=(m, k))
    xi = rng.uniform(0.02, 0.08, size=m)
    args = (up, down, 0.05 * 64 * 4000.0, 0.01, 0.01, xi, 16)
    return (solver.FleetRows.from_fleets(fleets, k_pad=k),
            ref_solver.FleetRows.from_fleets(ref_fleets, k_pad=k), args)


def _open_b(fr, args):
    return solver.optimize_batch_rows(fr, *args)


@pytest.mark.parametrize("energy", [False, True])
@pytest.mark.parametrize("hint", ["finite", "nan", "stale", "mixed"])
def test_optimize_batch_rows_b_prev_bitwise_reference(hint, energy):
    fr, rfr, args = _rows_problem()
    b_open = _open_b(fr, args)
    b_prev = {"finite": b_open + 3.0,
              "nan": np.full(4, np.nan),
              "stale": np.full(4, 1e6),          # outside every row's range
              "mixed": np.array([b_open[0], np.nan, 1e6, 0.5 * b_open[3]])
              }[hint]
    kw = dict(b_prev=b_prev, n_candidates=33)
    ekw = dict(kw, energy=EnergyBudget(budget_j=0.35)) if energy else kw
    rkw = dict(kw, energy=RefEnergy(budget_j=0.35)) if energy else kw
    got = solver.optimize_batch_rows(fr, *args, **ekw)
    want = ref_solver.optimize_batch_rows(rfr, *args, **rkw)
    np.testing.assert_array_equal(got, want)
    if hint in ("nan", "stale"):        # no usable hint: the full range
        full = solver.optimize_batch_rows(
            fr, *args, n_candidates=33,
            **({"energy": ekw["energy"]} if energy else {}))
        np.testing.assert_array_equal(got, full)


@pytest.mark.parametrize("cap", ["binding", "unbinding", "inf", "nan",
                                 "zero", "negative", "mixed"])
def test_optimize_batch_rows_dl_cap_bitwise_reference(cap):
    fr, rfr, args = _rows_problem(seed=9)
    b_open = _open_b(fr, args)
    xi = args[5]
    knee = xi * np.sqrt(0.5 * b_open)
    caps = {"binding": knee, "unbinding": 10.0 * xi * np.sqrt(b_open),
            "inf": np.full(4, np.inf), "nan": np.full(4, np.nan),
            "zero": np.zeros(4), "negative": np.full(4, -1.0),
            "mixed": np.array([knee[0], np.inf, np.nan, 0.0])}[cap]
    got = solver.optimize_batch_rows(fr, *args, dl_cap=caps)
    want = ref_solver.optimize_batch_rows(rfr, *args, dl_cap=caps)
    np.testing.assert_array_equal(got, want)
    if cap in ("unbinding", "inf", "nan", "zero", "negative"):
        np.testing.assert_array_equal(got, b_open)    # uncapped, bitwise
    if cap == "binding":
        assert (got <= b_open).all() and (got < b_open).any()


@pytest.mark.parametrize("package", ["port", "reference"])
def test_decay_cap_steers_b_star(package):
    """The reference's ``tests/test_chunked.py`` case on each package, and
    the two bitwise: capping the decay credited to a candidate clips B*
    to the knee (cap/ξ)² on a fleet whose uncapped optimum is interior."""
    def run(DP, sv):
        rng = np.random.default_rng(3)
        fleet = tuple(DP(kind="gpu", gpu_t_low=0.02, gpu_slope=5e-4,
                         gpu_b_th=16 + 4 * i) for i in range(4))
        fr = sv.FleetRows.from_fleets([fleet])
        up = rng.uniform(5e7, 3e8, size=(1, 4))
        down = rng.uniform(5e7, 3e8, size=(1, 4))
        s_bits, frame, xi = 0.005 * 64 * 1e6, 0.010, 0.05
        open_b = sv.optimize_batch_rows(fr, up, down, s_bits, frame, frame,
                                        xi, 128)
        lo_sum = fr.lo.sum()
        knee_b = 0.5 * (lo_sum + open_b[0])
        capped = sv.optimize_batch_rows(fr, up, down, s_bits, frame, frame,
                                        xi, 128,
                                        dl_cap=np.array([xi * np.sqrt(
                                            knee_b)]))
        loose = [sv.optimize_batch_rows(fr, up, down, s_bits, frame, frame,
                                        xi, 128, dl_cap=np.array([c]))
                 for c in (10.0 * xi * np.sqrt(open_b[0]), np.inf, np.nan)]
        return open_b, lo_sum, knee_b, capped, loose

    port = run(DeviceProfile, solver)
    ref = run(RefDevice, ref_solver)
    open_b, lo_sum, knee_b, capped, loose = \
        port if package == "port" else ref
    assert open_b[0] > lo_sum + 1                  # interior optimum
    assert capped[0] < open_b[0]
    assert capped[0] <= knee_b * 1.1               # clipped to ~the knee
    for same in loose:
        np.testing.assert_array_equal(open_b, same)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# plan_horizon and plan_horizons_batch, closed loop, against the reference
# ---------------------------------------------------------------------------


def _world(world, ns):
    return {"static": {},
            "sampling": dict(sampling=ns["Sampling"](size=3)),
            "fading": dict(fading=ns["Fading"](states=3, spread=0.8,
                                               stickiness=0.7)),
            "topology": dict(topology=ns["Topology"](cells=2, edges=2,
                                                     agg_every=3))}[world]


PORT_NS = dict(Sampling=Sampling, Fading=Fading, Topology=Topology,
               DP=DeviceProfile, mod=scheduler)
REF_NS = dict(Sampling=RefSampling, Fading=RefFading, Topology=RefTopology,
              DP=RefDevice, mod=ref_scheduler)


def _make_sched(ns, policy, world, seed=3, k=5):
    return ns["mod"].FeelScheduler(
        devices=_fleet(ns["DP"], k), n_params=4000, policy=policy, b_max=16,
        seed=seed, **_world(world, ns))


def _decays(rng, gb):
    """A decay series of a plausible size for ``gb``'s periods; small
    decays make the estimator's cap bind."""
    return rng.uniform(0.0, 0.05, size=len(gb)), gb


@pytest.mark.parametrize("world", ["static", "sampling", "fading",
                                   "topology"])
@pytest.mark.parametrize("policy", ["proposed", "online", "full",
                                    "random"])
def test_plan_horizon_closed_loop_bitwise_reference(policy, world):
    port = _make_sched(PORT_NS, policy, world)
    ref = _make_sched(REF_NS, policy, world)
    rng = np.random.default_rng(11)
    for c in range(3):
        warm = c > 0
        got = port.plan_horizon(5, warm_start=warm, closed_loop=True)
        want = ref.plan_horizon(5, warm_start=warm, closed_loop=True)
        _assert_horizons_equal(got, want, f"chunk {c}")
        _assert_state_equal(port, ref, f"chunk {c}")
        d, g = _decays(rng, want.global_batch)
        port.observe_series(d, g)
        ref.observe_series(d, g)
    _assert_state_equal(port, ref, "after feedback")


def test_closed_loop_cap_moves_b_star_where_it_binds():
    """Small realized decays cap the credited decay below ξ√B for every
    candidate, so the closed loop re-plans a smaller B* than the open
    loop does from the same state (both packages alike, above)."""
    closed = _make_sched(PORT_NS, "proposed", "static")
    opened = _make_sched(PORT_NS, "proposed", "static")
    for s in (closed, opened):
        h = s.plan_horizon(5)
        s.observe_series(np.full(5, 1e-3), h.global_batch)
    gb_closed = closed.plan_horizon(5, closed_loop=True).global_batch
    gb_open = opened.plan_horizon(5).global_batch
    assert gb_closed[0] < gb_open[0]


@pytest.mark.parametrize("mix", ["cold_and_warm", "all_cold", "uncapped"])
def test_plan_horizons_batch_fused_bitwise_reference(mix):
    """Proposed-policy schedulers of several fleet sizes (padded in the
    fused solve), one of them sampled, some warm and capped, some cold:
    the fused closed-loop plan is bitwise the reference's, and so are the
    schedulers' states and ``recommend_tau``."""
    def build(ns):
        out = [ns["mod"].FeelScheduler(
            devices=_fleet(ns["DP"], k), n_params=4000, b_max=16,
            seed=seed, **kw)
            for k, seed, kw in [(5, 1, {}), (4, 2, {}), (5, 3, {}),
                                (3, 4, dict(sampling=ns["Sampling"](
                                    size=2)))]]
        rng = np.random.default_rng(2)
        if mix != "all_cold":
            for i in (0, 2, 3):                  # 1 stays cold
                h = out[i].plan_horizon(5)
                if mix == "cold_and_warm" and i != 2:
                    out[i].observe_series(*_decays(rng, h.global_batch))
        return out

    port, ref = build(PORT_NS), build(REF_NS)
    rng = np.random.default_rng(4)
    for c in range(3):
        got = scheduler.plan_horizons_batch(port, 5, warm_start=True,
                                            closed_loop=True)
        want = ref_scheduler.plan_horizons_batch(ref, 5, warm_start=True,
                                                 closed_loop=True)
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_horizons_equal(g, w, f"chunk {c} scheduler {i}")
            _assert_state_equal(port[i], ref[i], f"chunk {c} sched {i}")
            if mix != "uncapped":
                d, gb = _decays(rng, w.global_batch)
                port[i].observe_series(d, gb)
                ref[i].observe_series(d, gb)


# ---------------------------------------------------------------------------
# the lowering: group_rows(replan=), the BucketRun guard, teacher forcing
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def datasets():
    return (ClassificationData.synthetic(n=400, dim=DIM, seed=0,
                                         spread=6.0).split(80),
            RefData.synthetic(n=400, dim=DIM, seed=0, spread=6.0).split(80))


def _spec(Spec, DP, k=5, **kw):
    kw = dict(dict(name=f"K{k}", hidden=HIDDEN, b_max=BMAX, base_lr=0.1,
                   compression=0.05, seeds=(0,)), **kw)
    return Spec(fleet=_fleet(DP, k), **kw)


def _grid(Spec, DP, **kw):
    return [_spec(Spec, DP, 5, partition="iid", seeds=(0, 1), **kw),
            _spec(Spec, DP, 4, partition="noniid", policy="full",
                  seeds=(2,), **kw),
            _spec(Spec, DP, 5, partition="noniid", scheme="individual",
                  **{k: v for k, v in kw.items() if k != "replan"})]


def _bucket_shape(buckets):
    return [(b.key, b.replan, b.band,
             [(r.seed, r.indices, r.spec.label) for r in b.rows])
            for b in buckets]


@pytest.mark.parametrize("bad", [0, -1, True, 2.5])
def test_group_rows_replan_validation_matches_reference(bad):
    specs = [_spec(ScenarioSpec, DeviceProfile)]
    ref_specs = [_spec(ref_api.ScenarioSpec, RefDevice)]
    with pytest.raises(ValueError, match="replan"):
        lowering.group_rows(specs, replan=bad)
    with pytest.raises(ValueError, match="replan"):
        ref_lowering.group_rows(ref_specs, replan=bad)


def test_group_rows_replan_override_and_twins_match_reference():
    """The override regroups FEEL buckets and leaves dev buckets open
    loop; replan twins (specs differing only in ``replan``) collapse onto
    one row under an override; each row keeps its spec as declared."""
    def build(Spec, DP):
        s = _spec(Spec, DP, partition="iid", policy="full")
        return _grid(Spec, DP) + [replace(s, replan=2), s]

    specs, ref_specs = build(ScenarioSpec, DeviceProfile), \
        build(ref_api.ScenarioSpec, RefDevice)
    for replan in (None, 2, 4):
        got = lowering.group_rows(specs, replan=replan)
        want = ref_lowering.group_rows(ref_specs, replan=replan)
        assert _bucket_shape(got) == _bucket_shape(want), replan
        if replan is not None:
            assert all(b.replan == (None if b.kind == "dev" else replan)
                       for b in got)
    merged = lowering.group_rows(specs, replan=2)
    twins = [r for b in merged for r in b.rows if len(r.indices) == 2]
    assert [r.indices for r in twins] == [(4, 5)]
    assert twins[0].spec.replan == 2              # the first declared spec
    assert len(lowering.group_rows(specs)) == 3   # no override: structural


def test_bucket_run_closed_loop_guard_and_feedback(datasets):
    """``can_advance`` and ``plan_next`` both refuse while a closed-loop
    chunk is in flight; the collected decays reach every row's ξ
    estimator, one scheduler a row."""
    (data, test), _ = datasets
    spec = _spec(ScenarioSpec, DeviceProfile, partition="noniid",
                 seeds=(0, 1))
    (bucket,) = lowering.group_rows([spec], replan=2)
    arrays = lowering.DeviceData(data, test, "cpu")
    run = lowering.BucketRun(bucket, data, 5, 2, arrays)
    assert run.closed_loop and run.can_advance
    plan = run.plan_next()
    with pytest.raises(RuntimeError, match="awaits collection"):
        run.plan_next()                           # planned, not dispatched
    scheds = run._planner.schedulers
    assert len(scheds) == 2                       # one scheduler a row
    xi0 = [s.xi_est.xi for s in scheds]
    run.dispatch(plan)
    assert not run.can_advance
    with pytest.raises(RuntimeError, match="awaits collection"):
        run.plan_next()
    with pytest.raises(RuntimeError, match="awaits collection"):
        run.advance()
    run.collect()
    assert all(a != s.xi_est.xi for a, s in zip(xi0, scheds))
    assert all(s.xi_est.decay_cap is not None for s in scheds)
    assert run.can_advance
    assert run.realized_decays.shape == (2, 2)
    losses, accs, times, gb = run.drain()
    assert losses.shape == (2, 5) and run.realized_decays.shape == (2, 5)
    assert np.all(np.diff(times, axis=1) > 0)
    # the open loop runs ahead and banks no decays
    (open_bucket,) = lowering.group_rows([spec])
    ahead = lowering.BucketRun(open_bucket, data, 5, 2, arrays)
    ahead.advance()
    assert ahead.can_advance
    ahead.drain()
    assert ahead.realized_decays is None


def _plans_equal(plan, rplan, msg):
    np.testing.assert_array_equal(plan.times, rplan.times, err_msg=msg)
    np.testing.assert_array_equal(plan.global_batch, rplan.global_batch,
                                  err_msg=msg)
    np.testing.assert_array_equal(plan.active, rplan.payload["active"],
                                  err_msg=msg)
    assert plan.tau == rplan.payload.get("tau"), msg
    for s, rs in zip(plan.schedules, rplan.payload["schedules"]):
        for f in SCHEDULE:
            a, b = getattr(s, f), getattr(rs, f)
            assert (a is None) == (b is None), f"{msg} {f}"
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=f"{msg} {f}")


def teacher_forced(monkeypatch, datasets, specs, ref_specs, periods,
                   replan, tol):
    """Run both packages chunk by chunk, each planner fed the REFERENCE's
    decays: every plan bitwise, the port's decays within ``tol``.
    Returns the τ sequence and the largest decay error."""
    monkeypatch.setattr(lowering, "_init_params_batch", _reference_init)
    (data, test), (rdata, rtest) = datasets
    (bucket,) = lowering.group_rows(specs, replan=replan)
    (rbucket,) = ref_lowering.group_rows(ref_specs, replan=replan)
    arrays = lowering.DeviceData(data, test, "cpu")
    planner = lowering._FeelPlanner(bucket, data, per_row=True)
    rplanner = ref_lowering._FeelPlanner(rbucket, rdata, per_row=True)
    state = rstate = None
    taus, err = [], 0.0
    for c, p_c in enumerate(lowering.chunk_lengths(periods, replan)):
        plan = planner.plan(p_c, warm_start=c > 0)
        rplan = rplanner.plan(p_c, warm_start=c > 0)
        _plans_equal(plan, rplan, f"chunk {c}")
        for s, rs in zip(planner.schedulers, rplanner.schedulers):
            _assert_state_equal(s, rs, f"chunk {c}")
        taus.append(plan.tau)
        handle = lowering.dispatch_bucket(plan, arrays, state=state)
        rhandle = ref_lowering.dispatch_bucket(rplan, rdata, rtest,
                                               state=rstate)
        state, rstate = handle.state, rhandle.state
        decays, = (d.numpy() for d in handle.decays)  # one shard
        rdecays = np.asarray(rhandle.decays)
        np.testing.assert_allclose(decays, rdecays, rtol=tol, atol=tol)
        err = max(err, float(np.abs(decays - rdecays).max()))
        planner.observe(rdecays, rplan.global_batch)
        rplanner.observe(rdecays, rplan.global_batch)
    return taus, err


@pytest.mark.parametrize("compress,tol", [(False, 1e-5), (True, 1e-4)])
def test_teacher_forced_closed_loop_bitwise_plans(monkeypatch, datasets,
                                                  compress, tol):
    specs = [_spec(ScenarioSpec, DeviceProfile, 5, partition="iid",
                   seeds=(0, 1), compress=compress),
             _spec(ScenarioSpec, DeviceProfile, 4, partition="noniid",
                   seeds=(2,), compress=compress)]
    ref_specs = [_spec(ref_api.ScenarioSpec, RefDevice, 5, partition="iid",
                       seeds=(0, 1), compress=compress),
                 _spec(ref_api.ScenarioSpec, RefDevice, 4,
                       partition="noniid", seeds=(2,), compress=compress)]
    _, err = teacher_forced(monkeypatch, datasets, specs, ref_specs, 7, 2,
                            tol)
    print(f"PARITY closed loop teacher-forced compress={compress}: plans "
          f"bitwise; decays max_abs_err={err:.3g} tol={tol:g}")


def _b_objectives(sched, sv, periods, offset, cands):
    """The selection objective T_pred(B)/min(ξ√B, cap) of each candidate
    B at period ``offset`` of the chunk ``sched`` plans next, as its own
    package (solver module ``sv``) prices it; on a copy, so the
    scheduler is untouched."""
    s = copy.deepcopy(sched)
    s._draw_participation(periods)
    s._draw_dynamics(periods)
    up, down = s.cell.avg_rate_updown_rows(s._dist_km, periods)
    c, n = s.cell.cfg, len(cands)
    xi, dl = s.xi_est.xi, s.xi_est.xi * np.sqrt(np.asarray(cands, float))
    sol = sv.solve_period_rows(
        s.devices, np.repeat(up[offset:offset + 1], n, 0),
        np.repeat(down[offset:offset + 1], n, 0), s.payload_bits,
        c.frame_up_s, c.frame_down_s, xi, np.asarray(cands, float),
        s.b_max)
    cap = s.xi_est.decay_cap
    cap = np.inf if cap is None or not cap > 0 else cap
    return (sol["e_total"] * dl / np.minimum(dl, cap)).tolist()


def _explain(specs, ref_specs, datasets, periods, replan, row, period,
             cands):
    """Replay both closed loops up to the chunk whose B* search set
    ``period``'s batch (each package fed its own decays) and price the
    two packages' candidates there, each in its own package."""
    (data, test), (rdata, rtest) = datasets
    (bucket,) = [b for b in lowering.group_rows(specs, replan=replan)
                 if any(row in r.indices for r in b.rows)]
    (rbucket,) = [b for b in ref_lowering.group_rows(ref_specs,
                                                     replan=replan)
                  if any(row in r.indices for r in b.rows)]
    i = [j for j, r in enumerate(bucket.rows) if row in r.indices][0]
    search = (period // 5) * 5                    # the reopt cadence
    chunk = search // replan
    run = lowering.BucketRun(bucket, data, periods, replan,
                             lowering.DeviceData(data, test, "cpu"))
    rrun = ref_lowering.BucketRun(rbucket, rdata, rtest, periods, replan)
    for _ in range(chunk):
        run.advance()
        run.collect()
        rrun.advance()
        rrun.collect()
    planner = run._planner or lowering._FeelPlanner(bucket, data,
                                                    per_row=True)
    p_c = min(replan, periods - chunk * replan)
    args = (p_c, search - chunk * replan, cands)
    return (f"B candidates {cands} at period {search}: objective in the "
            f"port {_b_objectives(planner.schedulers[i], solver, *args)}, "
            f"in the reference "
            f"{_b_objectives(rrun._planner.schedulers[i], ref_solver, *args)}")


def _assert_run_matches(got, want, tol, label, explain=None):
    """The end-to-end contract: decisions equal, ``times`` within rtol
    1e-9, series within ``tol``.  A decision mismatch names each
    differing (row, period) and the relative gap of the two ledgers, and
    ``explain(row, period, candidates)`` prices the two candidates."""
    diff = np.argwhere(got.global_batch != want.global_batch)
    if len(diff):
        gaps = [(int(r), int(p), int(got.global_batch[r, p]),
                 int(want.global_batch[r, p]),
                 float(abs(got.times[r, p] / want.times[r, p] - 1)))
                for r, p in diff]
        r, p, b, rb, _ = gaps[0]
        why = "" if explain is None else "; " + explain(r, p, [b, rb])
        pytest.fail(f"{label}: B* differs at (row, period, port, "
                    f"reference, times gap) {gaps}{why}")
    np.testing.assert_allclose(got.times, want.times, rtol=1e-9, atol=0)
    np.testing.assert_allclose(got.losses, want.losses, rtol=tol, atol=tol)
    np.testing.assert_allclose(got.accs, want.accs, rtol=tol, atol=tol)
    gap = float(np.abs(got.times / want.times - 1).max())
    print(f"PARITY {label}: global_batch equal, times rel gap {gap:.3g} "
          f"(tol 1e-9), losses max_abs_err="
          f"{float(np.abs(got.losses - want.losses).max()):.3g} tol={tol:g}")


@pytest.mark.parametrize("compress,tol", [(False, 1e-5), (True, 1e-4)])
def test_experiment_run_replan_matches_reference(monkeypatch, datasets,
                                                 compress, tol):
    monkeypatch.setattr(lowering, "_init_params_batch", _reference_init)
    (data, test), (rdata, rtest) = datasets
    specs = _grid(ScenarioSpec, DeviceProfile, compress=compress)
    ref_specs = _grid(ref_api.ScenarioSpec, RefDevice, compress=compress)
    got = Experiment(data, test, specs, device="cpu").run(6, replan=2)
    want = ref_api.Experiment(rdata, rtest, ref_specs).run(6, replan=2)
    _assert_run_matches(got, want, tol,
                        f"Experiment.run(replan=2) compress={compress}",
                        functools.partial(_explain, specs, ref_specs,
                                          datasets, 6, 2))


@pytest.mark.parametrize("family", ["transformer", "mamba2"])
def test_closed_loop_big_model_row_matches_reference(monkeypatch, datasets,
                                                     family):
    """One closed-loop row of each big-model family at a reduced width,
    as ``tests/test_torch_{transformer,mamba2}.py`` build them."""
    monkeypatch.setattr(lowering, "_init_params_batch", _reference_init)
    (data, test), (rdata, rtest) = datasets
    kw = dict(hidden=16, depth=2, b_max=8, base_lr=0.1, seeds=(0,),
              compression=0.05, model_family=family, replan=2)
    fleet = [0.7e9, 1.4e9, 2.1e9, 0.7e9]
    spec = ScenarioSpec(fleet=tuple(DeviceProfile(kind="cpu", f_cpu=f)
                                    for f in fleet), **kw)
    ref_spec = ref_api.ScenarioSpec(fleet=tuple(
        RefDevice(kind="cpu", f_cpu=f) for f in fleet), **kw)
    assert spec.bucket_key() == ref_spec.bucket_key()
    got = Experiment(data, test, [spec], device="cpu").run(4)
    want = ref_api.Experiment(rdata, rtest, [ref_spec]).run(4)
    _assert_run_matches(got, want, 1e-4, f"{family} closed-loop row",
                        functools.partial(_explain, [spec], [ref_spec],
                                          datasets, 4, 2))


# ---------------------------------------------------------------------------
# within the port
# ---------------------------------------------------------------------------


def test_closed_loop_xi_invariance():
    """At the reference test's shapes (three CPUs, dim 28, hidden 40,
    b_max 12): the closed loop re-plans every open-loop decision, and
    its series are bitwise the open loop's; only the ledger floats at
    ulp level."""
    data, test = ClassificationData.synthetic(n=360, dim=28, seed=0,
                                              spread=6.0).split(80)
    fleet = tuple(DeviceProfile(kind="cpu", f_cpu=f * 1e9)
                  for f in [0.7, 1.4, 2.1])
    spec = ScenarioSpec(fleet=fleet, name="chk3", b_max=12, base_lr=0.15,
                        hidden=40, partition="iid", seeds=(0,))
    exp = Experiment(data, test, [spec], device="cpu")
    mono = exp.run(5)
    for closed in (exp.run(5, replan=2),
                   exp.run(5, executor=AsyncExecutor(), replan=2)):
        np.testing.assert_array_equal(mono.global_batch, closed.global_batch)
        np.testing.assert_array_equal(mono.losses, closed.losses)
        np.testing.assert_array_equal(mono.accs, closed.accs)
        np.testing.assert_allclose(mono.times, closed.times, rtol=1e-12)


def test_closed_loop_executors_chunking_and_padding(datasets):
    """A closed-loop bucket chunks at its replan interval whatever
    ``chunk_periods`` says; ``AsyncExecutor`` (plain and capped) is
    bitwise ``SerialExecutor``; a padded row keeps its solo twin's
    decisions (ledger within rtol 1e-9: its decays differ from the
    solo run's in the last float32 digits)."""
    (data, test), _ = datasets
    specs = _grid(ScenarioSpec, DeviceProfile, replan=2)
    exp = Experiment(data, test, specs, device="cpu")
    serial = exp.run(5, executor=SerialExecutor())
    for executor in (SerialExecutor(chunk_periods=3),
                     AsyncExecutor(), AsyncExecutor(max_in_flight=1),
                     AsyncExecutor(chunk_periods=1)):
        got = exp.run(5, executor=executor)
        for f in SERIES:
            np.testing.assert_array_equal(getattr(got, f),
                                          getattr(serial, f),
                                          err_msg=f"{executor} {f}")
    solo = Experiment(data, test, specs[1:2], device="cpu").run(5)
    np.testing.assert_array_equal(solo.global_batch, serial.global_batch[2:3])
    np.testing.assert_allclose(solo.times, serial.times[2:3], rtol=1e-9)
    np.testing.assert_allclose(solo.losses, serial.losses[2:3], rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("periods,chunk", [(7, 3), (6, 2), (5, None),
                                           (4, 9), (5, 0)])
def test_chunk_lengths_match_reference(periods, chunk):
    assert lowering.chunk_lengths(periods, chunk) == \
        ref_lowering.chunk_lengths(periods, chunk)


def test_park_then_resume_bitwise(datasets):
    (data, test), _ = datasets
    spec = _spec(ScenarioSpec, DeviceProfile, partition="noniid",
                 seeds=(0, 1), replan=2)
    (bucket,) = lowering.group_rows([spec])
    arrays = lowering.DeviceData(data, test, "cpu")
    plain = lowering.BucketRun(bucket, data, 6, 2, arrays).run_serial()
    run = lowering.BucketRun(bucket, data, 6, 2, arrays)
    run.advance()
    banked = run.park()
    assert len(banked) == 1 and not run._pending
    assert run.park() == []                       # nothing left in flight
    resumed = run.drain()
    for a, b in zip(plain, resumed):
        np.testing.assert_array_equal(a, b)
