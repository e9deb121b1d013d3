"""The port's per-period host planning is bitwise the reference's: the
channel helpers, the learning-efficiency criterion and the ξ estimator,
Theorems 1–2's closed forms and bounds, the scalar Algorithm 1
(``solve_uplink``, ``solve_downlink``, ``solve_period``), the four
batchsize policies and ``FeelScheduler.plan()``, fed the same inputs and
seeds in one process.  Also the reference's own solver properties
(``tests/test_solver.py``), run on the port."""
import numpy as np
import pytest

from repro.channels import model as ref_channels
from repro.core import baselines as ref_baselines
from repro.core import efficiency as ref_efficiency
from repro.core import scheduler as ref_scheduler
from repro.core import solver as ref_solver
from repro.core.latency import DeviceProfile as RefDevice
from repro.testing.proptest import given, settings, strategies as st

import repro_torch.core as core
from repro_torch.channels import model as channels
from repro_torch.core import baselines, efficiency, scheduler, solver
from repro_torch.core.latency import (DeviceProfile, gradient_bits,
                                      uplink_latency)

FRAME = 0.010
S_BITS = gradient_bits(1_000_000)
SEEDS = (0, 1, 7, 2024)
SOLUTION_FIELDS = {
    "UplinkSolution": ("batch", "tau", "e_up", "mu"),
    "DownlinkSolution": ("tau", "e_down"),
    "PeriodSolution": ("global_batch", "batch", "tau_up", "tau_down",
                       "latency", "efficiency", "e_up", "e_down"),
    "PolicyResult": ("batch", "tau_up", "tau_down", "latency",
                     "global_batch"),
    "PeriodPlan": ("period", "batch", "tau_up", "tau_down", "lr",
                   "predicted_latency", "global_batch", "rates_up",
                   "rates_down"),
}


def _equal(got, want):
    """Bitwise equality of two solution dataclasses of the same name."""
    assert type(got).__name__ == type(want).__name__
    for f in SOLUTION_FIELDS[type(got).__name__]:
        a, b = getattr(got, f), getattr(want, f)
        assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)), f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _fleet(DP, rng, k):
    """A mixed CPU/GPU fleet drawn from ``rng`` (the same draws for both
    packages)."""
    devs = []
    for _ in range(k):
        if rng.integers(2):
            devs.append(DP(kind="cpu", f_cpu=float(rng.uniform(0.3e9, 5e9))))
        else:
            devs.append(DP(kind="gpu",
                           gpu_t_low=float(rng.uniform(0.005, 0.05)),
                           gpu_slope=float(rng.uniform(1e-4, 1e-3)),
                           gpu_b_th=float(rng.integers(4, 64))))
    return devs


def _problem(seed):
    """(port fleet, reference fleet, rates up, rates down) for one seed."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(2, 7))
    state = rng.bit_generator.state
    devs = _fleet(DeviceProfile, rng, k)
    rng.bit_generator.state = state
    ref_devs = _fleet(RefDevice, rng, k)
    return (devs, ref_devs, rng.uniform(10e6, 300e6, size=k),
            rng.uniform(10e6, 300e6, size=k))


# ---------------------------------------------------------------------------
# channel helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits,rate", [(1e6, 1e9), (3, 7.0), (0, 5e8)])
def test_wired_latency_bitwise(bits, rate):
    got = channels.wired_latency(bits, rate)
    assert type(got) is float
    assert got == ref_channels.wired_latency(bits, rate)


@pytest.mark.parametrize("rate", [0, -1.0])
def test_wired_latency_rejects_non_positive_rate(rate):
    with pytest.raises(ValueError, match="positive"):
        channels.wired_latency(1e6, rate)
    with pytest.raises(ValueError, match="positive"):
        ref_channels.wired_latency(1e6, rate)


@pytest.mark.parametrize("seed", SEEDS)
def test_avg_rate_and_sample_rates_bitwise(seed):
    cfg = dict(radius_m=150.0 + 50 * seed % 300, fading_samples=128)
    port = channels.Cell.make(seed, channels.CellConfig(**cfg))
    ref = ref_channels.Cell.make(seed, ref_channels.CellConfig(**cfg))
    for k in (1, 4, 6):                    # successive draws continue
        got, want = port.sample_rates(k), ref.sample_rates(k)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(port.avg_rate(got[0]),
                                      ref.avg_rate(want[0]))


def test_updown_rows_consume_the_stream_like_avg_rate_pairs():
    """One ``avg_rate_updown_rows`` draw equals the per-period (uplink,
    downlink) ``avg_rate`` pairs of ``plan()`` in a second cell."""
    a = channels.Cell.make(5, channels.CellConfig(fading_samples=64))
    b = channels.Cell.make(5, channels.CellConfig(fading_samples=64))
    d = a.drop_users(5)
    np.testing.assert_array_equal(d, b.drop_users(5))
    up, down = a.avg_rate_updown_rows(d, 3)
    for p in range(3):
        np.testing.assert_array_equal(up[p], b.avg_rate(d))
        np.testing.assert_array_equal(down[p], b.avg_rate(d))


# ---------------------------------------------------------------------------
# the learning-efficiency criterion and the ξ estimator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("xi,gb,lat", [(0.05, 128, 0.3), (0.013, 7, 2.5),
                                       (0.2, np.arange(1, 9), 1.0)])
def test_loss_decay_and_learning_efficiency_bitwise(xi, gb, lat):
    np.testing.assert_array_equal(efficiency.loss_decay(xi, gb),
                                  ref_efficiency.loss_decay(xi, gb))
    if np.ndim(gb) == 0:
        got = efficiency.learning_efficiency(xi, gb, lat)
        assert type(got) is float
        assert got == ref_efficiency.learning_efficiency(xi, gb, lat)


@pytest.mark.parametrize("seed", SEEDS)
def test_xi_estimator_update_and_decay_cap_bitwise(seed):
    rng = np.random.default_rng(seed)
    port, ref = efficiency.XiEstimator(), ref_efficiency.XiEstimator()
    assert port.decay_cap is None and ref.decay_cap is None
    decays = list(rng.normal(0.01, 0.02, size=12))
    decays[3] = float("nan")               # ignored
    decays[5] = -0.5                       # clipped at 0
    batches = list(rng.integers(0, 300, size=12))
    batches[7] = 0                         # ignored
    for d, g in zip(decays, batches):
        assert port.update(d, g) == ref.update(d, g)
        assert (port.xi, port._n) == (ref.xi, ref._n)
        np.testing.assert_array_equal(port.delta, ref.delta)
        assert port.decay_cap == ref.decay_cap
    assert port.decay_cap is not None and port._n == 10
    assert port.decay_cap == port.cap_headroom * port.delta


# ---------------------------------------------------------------------------
# Theorems 1–2, Corollaries 1–2 and the scalar Algorithm 1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_closed_forms_and_bounds_bitwise(seed):
    devs, ref_devs, r_up, _ = _problem(seed)
    k = len(devs)
    B = float(np.random.default_rng(seed).uniform(k, 64 * k))
    dl = 0.05 * np.sqrt(B)
    lo, hi = solver.e_up_bounds(B, devs, r_up, S_BITS, FRAME, dl)
    assert (lo, hi) == ref_solver.e_up_bounds(B, ref_devs, r_up, S_BITS,
                                              FRAME, dl)
    for e_up in np.linspace(lo, hi, 5):
        m_lo, m_hi = solver.mu_bounds(e_up, devs, r_up, S_BITS, FRAME, dl,
                                      64)
        assert (m_lo, m_hi) == ref_solver.mu_bounds(
            e_up, ref_devs, r_up, S_BITS, FRAME, dl, 64)
        for mu in (m_lo, 0.5 * (m_lo + m_hi), m_hi):
            for fn, ref_fn in ((solver.batch_closed_form,
                                ref_solver.batch_closed_form),
                               (solver.tau_closed_form,
                                ref_solver.tau_closed_form)):
                np.testing.assert_array_equal(
                    fn(e_up, mu, devs, r_up, S_BITS, FRAME, dl, 64),
                    ref_fn(e_up, mu, ref_devs, r_up, S_BITS, FRAME, dl, 64))


@pytest.mark.parametrize("seed", SEEDS)
def test_solve_uplink_and_downlink_bitwise(seed):
    devs, ref_devs, r_up, r_down = _problem(seed)
    k = len(devs)
    for B in (float(k), 40.0 * k, 128.0 * k - 1):
        dl = 0.05 * np.sqrt(B)
        _equal(solver.solve_uplink(devs, r_up, S_BITS, FRAME, B, dl, 128),
               ref_solver.solve_uplink(ref_devs, r_up, S_BITS, FRAME, B, dl,
                                       128))
        _equal(solver.solve_downlink(devs, r_down, S_BITS, FRAME, dl),
               ref_solver.solve_downlink(ref_devs, r_down, S_BITS, FRAME,
                                         dl))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("B", [None, 100.0])
def test_solve_period_bitwise(seed, B):
    """The golden section over B (60-step cap, the same ``round``) or a
    given B."""
    devs, ref_devs, r_up, r_down = _problem(seed)
    _equal(solver.solve_period(devs, r_up, r_down, S_BITS, FRAME, FRAME,
                               xi=0.05, b_max=128, B=B),
           ref_solver.solve_period(ref_devs, r_up, r_down, S_BITS, FRAME,
                                   FRAME, xi=0.05, b_max=128, B=B))


@pytest.mark.parametrize("seed", SEEDS)
def test_fleet_rows_with_mask_bitwise(seed):
    rng = np.random.default_rng(seed)
    sizes = [int(k) for k in rng.integers(1, 6, size=3)]
    state = rng.bit_generator.state
    fleets = [_fleet(DeviceProfile, rng, k) for k in sizes]
    rng.bit_generator.state = state
    ref_fleets = [_fleet(RefDevice, rng, k) for k in sizes]
    mask = rng.integers(0, 2, size=(3, max(sizes))).astype(float)
    got = solver.FleetRows.from_fleets(fleets).with_mask(mask)
    want = ref_solver.FleetRows.from_fleets(ref_fleets).with_mask(mask)
    for f in ("a", "b", "lo", "t_upd", "is_cpu", "cps", "f_cpu", "g_t_low",
              "g_slope", "g_b_th", "mask"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    ones = solver.FleetRows.from_fleets(fleets)
    np.testing.assert_array_equal(ones.with_mask(1.0).mask, ones.mask)


# the reference's own solver properties (tests/test_solver.py), on the port

def _cpu_fleet(freqs):
    return [DeviceProfile(kind="cpu", f_cpu=f) for f in freqs]


@settings(max_examples=25, deadline=None)
@given(freqs=st.lists(st.floats(0.3e9, 5e9), min_size=2, max_size=8),
       b=st.floats(10, 400), seed=st.integers(0, 1000))
def test_uplink_properties(freqs, b, seed):
    devs = _cpu_fleet(freqs)
    k = len(devs)
    r = np.random.default_rng(seed).uniform(20e6, 200e6, size=k)
    dl = 0.05 * np.sqrt(b)
    b = min(max(b, k), 128 * k)
    sol = solver.solve_uplink(devs, r, S_BITS, FRAME, b, dl, 128)
    assert np.all(sol.batch >= 1 - 1e-9)
    assert np.all(sol.batch <= 128 + 1e-9)
    assert np.all(sol.tau >= -1e-12)
    assert sol.tau.sum() == pytest.approx(FRAME, rel=1e-5)
    t_local = np.array([d.local_grad_latency(x)
                        for d, x in zip(devs, sol.batch)])
    t_up = uplink_latency(S_BITS, sol.tau, FRAME, r)
    assert np.all(t_local + t_up <= dl * sol.e_up * (1 + 1e-4))


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_period_solution_feasible(seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(2, 7))
    devs = _cpu_fleet(rng.uniform(0.5e9, 3e9, size=k))
    r_up = rng.uniform(10e6, 300e6, size=k)
    r_down = rng.uniform(10e6, 300e6, size=k)
    sol = solver.solve_period(devs, r_up, r_down, S_BITS, FRAME, FRAME,
                              xi=0.05, b_max=128)
    assert k <= sol.global_batch <= 128 * k
    assert sol.latency > 0 and np.isfinite(sol.latency)
    assert sol.efficiency > 0


# ---------------------------------------------------------------------------
# the four policies and FeelScheduler.plan()
# ---------------------------------------------------------------------------


def test_policies_dict_matches_reference():
    assert list(baselines.POLICIES) == list(ref_baselines.POLICIES)
    assert core.POLICIES is baselines.POLICIES
    assert scheduler.POLICIES is baselines.POLICIES
    with pytest.raises(ValueError, match="not in"):
        scheduler.FeelScheduler(devices=_cpu_fleet([1e9]), n_params=10,
                                policy="propsed")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("policy", ["online", "full", "random", "proposed"])
def test_policy_bitwise(policy, seed):
    devs, ref_devs, r_up, r_down = _problem(seed)
    rng, ref_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    kw = {"B": 50.0} if policy == "proposed" and seed % 2 else {}
    for _ in range(2):                     # the random policy's stream
        got = baselines.POLICIES[policy](devs, r_up, r_down, S_BITS, FRAME,
                                         FRAME, 64, rng=rng, **kw)
        want = ref_baselines.POLICIES[policy](ref_devs, r_up, r_down, S_BITS,
                                              FRAME, FRAME, 64, rng=ref_rng,
                                              **kw)
        _equal(got, want)
    assert rng.bit_generator.state == ref_rng.bit_generator.state


def test_random_policy_default_rng_bitwise():
    devs, ref_devs, r_up, r_down = _problem(3)
    _equal(baselines.random_batch_policy(devs, r_up, r_down, S_BITS, FRAME,
                                         FRAME, 32),
           ref_baselines.random_batch_policy(ref_devs, r_up, r_down, S_BITS,
                                             FRAME, FRAME, 32))


@pytest.mark.parametrize("seed", (0, 5))
@pytest.mark.parametrize("policy", ["online", "full", "random", "proposed"])
def test_feel_scheduler_plan_sequence_bitwise(policy, seed):
    """Six successive ``plan()`` calls: rates drawn uplink then downlink
    from the cell's stream, the random policy's integers from the
    scheduler's, the proposed policy's B* re-optimized every second
    period and carried in between."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(2, 6))
    state = rng.bit_generator.state
    devs = _fleet(DeviceProfile, rng, k)
    rng.bit_generator.state = state
    ref_devs = _fleet(RefDevice, rng, k)
    kw = dict(n_params=50_000, policy=policy, b_max=32, seed=seed,
              reopt_every=2)
    port = scheduler.FeelScheduler(
        devices=devs, cell_cfg=channels.CellConfig(fading_samples=128), **kw)
    ref = ref_scheduler.FeelScheduler(
        devices=ref_devs,
        cell_cfg=ref_channels.CellConfig(fading_samples=128), **kw)
    for period in range(6):
        got, want = port.plan(), ref.plan()
        _equal(got, want)
        assert got.period == period
        assert isinstance(got, core.PeriodPlan)
        assert got.global_batch == int(got.batch.sum())
    assert port._b_cache == ref._b_cache


def test_plan_and_plan_horizon_draw_one_stream_in_two_shapes():
    """``plan()`` and ``plan_horizon()`` read the same cell stream, so two
    schedulers of one seed agree on their rates, not on interleaving:
    three ``plan()`` periods draw exactly the rates of a three-period
    horizon of the fixed-batch ``full`` policy."""
    kw = dict(devices=_cpu_fleet([0.7e9, 1.4e9, 2.1e9]), n_params=50_000,
              policy="full", b_max=16, seed=4,
              cell_cfg=channels.CellConfig(fading_samples=64))
    a, b = scheduler.FeelScheduler(**kw), scheduler.FeelScheduler(**kw)
    horizon = a.plan_horizon(3)
    plans = [b.plan() for _ in range(3)]
    np.testing.assert_array_equal(horizon.batch,
                                  np.stack([p.batch for p in plans]))
    np.testing.assert_array_equal(horizon.latency,
                                  [p.predicted_latency for p in plans])
