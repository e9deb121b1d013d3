"""Host planning in the PyTorch port is bitwise the reference's: channel
draws, the rows solver, the horizon planners, partitions, the batcher and
the schedule ledgers, fed the same specs and seeds in one process."""
import numpy as np
import pytest

from repro.channels.model import Cell as RefCell, CellConfig as RefCellConfig
from repro.core import DeviceProfile as RefDevice
from repro.core import scheduler as ref_scheduler
from repro.core import solver as ref_solver
from repro.data import pipeline as ref_pipeline
from repro.fed import engine as ref_engine

from repro_torch.channels.model import Cell, CellConfig
from repro_torch.core import scheduler, solver
from repro_torch.core.latency import DeviceProfile
from repro_torch.data import pipeline
from repro_torch.fed import engine

HORIZON_FIELDS = ("batch", "tau_up", "tau_down", "lr", "latency",
                  "global_batch")


def _fleets(DP):
    """Mixed fleets: CPU tiers, a GPU fleet, different sizes."""
    cpu = lambda k: tuple(DP(kind="cpu", f_cpu=[0.7e9, 1.4e9, 2.1e9][i % 3])
                          for i in range(k))
    gpu = tuple(DP(kind="gpu", gpu_slope=s) for s in (4e-4, 5e-4, 6e-4))
    return [cpu(3), cpu(4), gpu]


def _assert_horizons_equal(got, want):
    for f in HORIZON_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


@pytest.mark.parametrize("pad_to", [None, 6])
def test_channel_draws_bitwise(pad_to):
    cfg = dict(radius_m=150.0, fading_samples=256)
    port, ref = Cell.make(3, CellConfig(**cfg)), RefCell.make(
        3, RefCellConfig(**cfg))
    d, rd = port.drop_users(4), ref.drop_users(4)
    np.testing.assert_array_equal(d, rd)
    for _ in range(2):
        for a, b in zip(port.avg_rate_updown_rows(d, 3, pad_to=pad_to),
                        ref.avg_rate_updown_rows(rd, 3, pad_to=pad_to)):
            np.testing.assert_array_equal(a, b)


def test_rows_solver_bitwise():
    rng = np.random.default_rng(0)
    fleets, ref_fleets = _fleets(DeviceProfile), _fleets(RefDevice)
    fr = solver.FleetRows.from_fleets(fleets, k_pad=5)
    rfr = ref_solver.FleetRows.from_fleets(ref_fleets, k_pad=5)
    up = rng.uniform(1e6, 5e7, size=(3, 5))
    down = rng.uniform(1e6, 5e7, size=(3, 5))
    args = (up, down, 3.0e5, 0.01, 0.01)
    for key in ("batch", "tau_up", "tau_down", "latency", "e_total"):
        np.testing.assert_array_equal(
            solver.solve_period_rows(fr, *args, 0.05,
                                     np.array([40., 90., 60.]), 64)[key],
            ref_solver.solve_period_rows(rfr, *args, 0.05,
                                         np.array([40., 90., 60.]), 64)[key])
    np.testing.assert_array_equal(
        solver.optimize_batch_rows(fr, *args, 0.05, 64),
        ref_solver.optimize_batch_rows(rfr, *args, 0.05, 64))
    batch = rng.integers(1, 65, size=(3, 5)).astype(float)
    for a, b in zip(solver.fixed_slot_rows(fr, batch, *args),
                    ref_solver.fixed_slot_rows(rfr, batch, *args)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("policy", ["proposed", "online", "full", "random"])
def test_plan_horizon_bitwise_across_chunks(policy):
    kw = dict(n_params=12_345, policy=policy, b_max=32, base_lr=0.1,
              seed=5)
    port = scheduler.FeelScheduler(_fleets(DeviceProfile)[1], **kw)
    ref = ref_scheduler.FeelScheduler(_fleets(RefDevice)[1], **kw)
    for periods in (4, 3, 6):           # chunk boundaries off the cadence
        _assert_horizons_equal(port.plan_horizon(periods),
                               ref.plan_horizon(periods))
    assert port._b_cache == ref._b_cache and port._period == ref._period


def test_plan_horizons_batch_fuses_mixed_fleets_bitwise():
    def make(mod, DP):
        fl = _fleets(DP)
        return [mod.FeelScheduler(f, n_params=5000, policy=p, b_max=24,
                                  seed=s)
                for (f, p, s) in [(fl[0], "proposed", 0),
                                  (fl[1], "proposed", 1),
                                  (fl[2], "proposed", 2),
                                  (fl[1], "random", 3),
                                  (fl[0], "proposed", 4)]]
    port, ref = make(scheduler, DeviceProfile), make(ref_scheduler,
                                                     RefDevice)
    for periods in (7, 3):
        for a, b in zip(scheduler.plan_horizons_batch(port, periods),
                        ref_scheduler.plan_horizons_batch(ref, periods)):
            _assert_horizons_equal(a, b)
    # fused == per-call planning, within the port
    solo = make(scheduler, DeviceProfile)
    fused = make(scheduler, DeviceProfile)
    for a, s in zip(scheduler.plan_horizons_batch(fused, 6), solo):
        _assert_horizons_equal(a, s.plan_horizon(6))


def test_dataset_partitions_and_batcher_bitwise():
    d = pipeline.ClassificationData.synthetic(n=300, dim=12, seed=2,
                                              spread=5.0)
    rd = ref_pipeline.ClassificationData.synthetic(n=300, dim=12, seed=2,
                                                   spread=5.0)
    np.testing.assert_array_equal(d.x, rd.x)
    np.testing.assert_array_equal(d.y, rd.y)
    parts = [pipeline.partition_iid(300, 4, 7),
             pipeline.partition_noniid(d.y, 4, seed=7)]
    rparts = [ref_pipeline.partition_iid(300, 4, 7),
              ref_pipeline.partition_noniid(rd.y, 4, seed=7)]
    for ps, rps in zip(parts, rparts):
        for a, b in zip(ps, rps):
            np.testing.assert_array_equal(a, b)
        bat = pipeline.FederatedBatcher(ps, slot=16, seed=7)
        rbat = ref_pipeline.FederatedBatcher(rps, slot=16, seed=7)
        for bk in ([16, 3, 9, 1], [100, 0, 5, 16]):
            for a, b in zip(bat.sample(np.array(bk)),
                            rbat.sample(np.array(bk))):
                np.testing.assert_array_equal(a, b)


def test_build_schedule_ledgers_bitwise_and_chunk_seeded():
    d = pipeline.ClassificationData.synthetic(n=200, dim=8, seed=1)
    fleet, rfleet = _fleets(DeviceProfile)[0], _fleets(RefDevice)[0]
    parts = pipeline.partition_noniid(d.y, 3, seed=1)
    sched = scheduler.FeelScheduler(fleet, n_params=999, b_max=12, seed=1)
    rsched = ref_scheduler.FeelScheduler(rfleet, n_params=999, b_max=12,
                                         seed=1)
    bat = pipeline.FederatedBatcher(parts, 12, 1)
    rbat = ref_pipeline.FederatedBatcher(parts, 12, 1)
    offset = 0.0
    for periods in (5, 2):
        s = engine.build_schedule(sched, bat, periods, time_offset=offset)
        r = ref_engine.build_schedule(rsched, rbat, rfleet, periods,
                                      time_offset=offset)
        for f in ("idx", "weight", "batch", "lr", "times", "global_batch"):
            np.testing.assert_array_equal(getattr(s, f), getattr(r, f),
                                          err_msg=f)
        offset = float(s.times[-1])
    padded = engine.pad_schedule(s, 5)
    rpadded = ref_engine.pad_schedule(r, 5)
    for f in ("idx", "weight", "batch", "lr", "times", "global_batch"):
        np.testing.assert_array_equal(getattr(padded, f),
                                      getattr(rpadded, f))
    for f in ("idx", "weight", "batch", "times"):
        np.testing.assert_array_equal(
            getattr(engine.slice_schedule(padded, 1, 2), f),
            getattr(ref_engine.slice_schedule(rpadded, 1, 2), f))
