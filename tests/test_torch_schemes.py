"""The Table-II schemes in the port: ``individual`` and ``model_fl`` (the
per-device-parameter loop) and ``gradient_fl`` (the full-batch policy on
the FEEL loop), held against the reference on the CPU.

* ``DevScheduler`` horizons, with and without participation sampling,
  chunked: bitwise the reference's (indices, times, slots, rates, masks).
* One period of the dev step from the same carry against the
  reference's ``_dev_step``: 1e-5.
* ``Experiment.run`` for each scheme with the reference's initial weights
  carried across: ledgers bitwise, losses and accuracies 1e-5 (1e-4 where
  the rows compress: an SBC boundary tie may fall either way under
  another summation order).
* Within the port: chunked == monolithic bitwise, a padded dev row
  against its solo twin, a sampled-out user's parameters held bitwise,
  the Table-II grid lowering to the reference's buckets and the policy
  coordinate keeping dev rows out of FEEL-policy selections."""
import jax
import numpy as np
import pytest
import torch

import repro.api as ref_api
from repro.api import lowering as ref_lowering
from repro.core import DeviceProfile as RefDevice
from repro.core.scheduler import DevScheduler as RefDevScheduler
from repro.data.pipeline import ClassificationData as RefData
from repro.fed import engine as ref_engine
from repro.fed import feel_model as ref_model
from repro.topology import Sampling as RefSampling

import repro_torch.api as port_api
from repro_torch.api import (Experiment, Sampling, SerialExecutor, grid,
                             lowering)
from repro_torch.core import DevScheduler
from repro_torch.core.latency import DeviceProfile
from repro_torch.data.pipeline import ClassificationData
from repro_torch.fed import engine
from repro_torch.interop import params_from_numpy, params_to_numpy

DIM, HIDDEN = 32, 16
SCHEMES = ("individual", "model_fl", "gradient_fl", "feel")


def _reference_init(rows, input_dim, device):
    per_row = [ref_model.init(jax.random.key(r.seed), r.spec.hidden,
                              depth=r.spec.depth, input_dim=input_dim)
               for r in rows]
    stacked = jax.tree_util.tree_map(
        lambda *a: np.stack([np.asarray(x) for x in a]), *per_row)
    return params_from_numpy(stacked, device)


def _fleet(DP, k):
    return tuple(DP(kind="cpu", f_cpu=[0.7e9, 1.4e9, 2.1e9][i % 3])
                 for i in range(k))


@pytest.fixture(scope="module")
def datasets():
    return (ClassificationData.synthetic(n=600, dim=DIM, seed=0,
                                         spread=6.0).split(100),
            RefData.synthetic(n=600, dim=DIM, seed=0, spread=6.0).split(100))


def _spec(api, DP, k=4, **kw):
    kw.setdefault("hidden", HIDDEN)
    kw.setdefault("b_max", 16)
    kw.setdefault("base_lr", 0.1)
    kw.setdefault("compression", 0.05)
    kw.setdefault("seeds", (0, 1))
    return api.ScenarioSpec(fleet=_fleet(DP, k), **kw)


# ---------------------------------------------------------------------------
# the dev planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("upload", [False, True])
@pytest.mark.parametrize("size", [None, 2])
def test_dev_scheduler_horizons_bitwise(upload, size):
    rng = np.random.default_rng(0)
    parts = [rng.choice(500, size=n, replace=False)
             for n in (40, 70, 12, 90, 33)]
    kw = dict(parts=parts, batch=16, payload_bits=32.0 * 4000,
              upload=upload, seed=3)
    port = DevScheduler(devices=_fleet(DeviceProfile, 5),
                        sampling=None if size is None else Sampling(size=size),
                        **kw)
    ref = RefDevScheduler(devices=_fleet(RefDevice, 5),
                          sampling=None if size is None
                          else RefSampling(size=size), **kw)
    offset = 0.0
    for periods in (3, 2, 4):                    # chunked, offsets seeded
        got = port.plan_horizon(periods, time_offset=offset)
        want = ref.plan_horizon(periods, time_offset=offset)
        offset = want.times[-1]
        for f in ("idx", "times", "tau_up", "tau_down", "rates_up",
                  "rates_down", "participation"):
            a, b = getattr(got, f), getattr(want, f)
            if b is None:
                assert a is None, f
                continue
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    print(f"PARITY DevScheduler upload={upload} size={size}: max_abs_err=0 "
          "(bitwise)")


# ---------------------------------------------------------------------------
# one period of the dev step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("average", [False, True])
def test_dev_step_matches_reference(average):
    k = 4
    rng = np.random.default_rng(1)
    arrays = (rng.normal(size=(120, DIM)).astype(np.float32),
              rng.integers(0, 10, size=120).astype(np.int32),
              rng.normal(size=(40, DIM)).astype(np.float32),
              rng.integers(0, 10, size=40).astype(np.int32))
    params = jax.tree_util.tree_map(np.asarray, ref_model.init(
        jax.random.key(2), HIDDEN, depth=3, input_dim=DIM))
    dev = jax.tree_util.tree_map(
        lambda p: (p[None] + rng.normal(size=(k,) + p.shape) * 0.05)
        .astype(np.float32), params)
    idx = rng.integers(0, 120, size=(k, 16)).astype(np.int32)
    active = np.array([1, 0, 1, 1], np.float32)   # user 1 sampled out
    rdev, (rl, ra) = ref_engine._dev_step(
        *(jax.numpy.asarray(a) for a in arrays), jax.numpy.float32(0.1),
        average, dev, (jax.numpy.asarray(idx), jax.numpy.asarray(active)))
    got, (loss, acc) = engine._dev_step(
        engine.host_to_device(arrays, "cpu"), average, torch.tensor([0.1]),
        params_from_numpy(jax.tree_util.tree_map(lambda a: a[None], dev)),
        torch.from_numpy(idx[None]), torch.from_numpy(active[None]))
    err = 0.0
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(got)),
                    jax.tree_util.tree_leaves(rdev)):
        np.testing.assert_allclose(a[0], np.asarray(b), rtol=1e-5, atol=1e-5)
        err = max(err, float(np.abs(a[0] - np.asarray(b)).max()))
    np.testing.assert_allclose(float(loss[0]), float(rl), rtol=1e-5,
                               atol=1e-5)
    assert float(acc[0]) == pytest.approx(float(ra))
    if not average:                    # the sampled-out copy held still
        for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(got)),
                        jax.tree_util.tree_leaves(dev)):
            np.testing.assert_array_equal(a[0][1], b[1])
    print(f"PARITY _dev_step average={average}: max_abs_err={err:.3g} "
          f"loss_err={abs(float(loss[0]) - float(rl)):.3g} tol=1e-5")


# ---------------------------------------------------------------------------
# Experiment.run against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme,extra", [
    ("individual", {}), ("model_fl", {}), ("gradient_fl", {}),
    ("feel", {}), ("model_fl", {"sampling": 2}),
    ("individual", {"sampling": 2})])
def test_experiment_run_matches_reference(monkeypatch, datasets, scheme,
                                          extra):
    monkeypatch.setattr(lowering, "_init_params_batch", _reference_init)
    (data, test), (rdata, rtest) = datasets
    size = extra.get("sampling")
    specs = [_spec(port_api, DeviceProfile, k, scheme=scheme, partition=p,
                   sampling=None if size is None else Sampling(size=size))
             for k, p in ((4, "iid"), (3, "noniid"))]
    ref_specs = [_spec(ref_api, RefDevice, k, scheme=scheme, partition=p,
                       sampling=None if size is None
                       else RefSampling(size=size))
                 for k, p in ((4, "iid"), (3, "noniid"))]
    assert [s.bucket_key() for s in specs] == [s.bucket_key()
                                              for s in ref_specs]
    got = Experiment(data, test, specs, device="cpu").run(5)
    want = ref_api.Experiment(rdata, rtest, ref_specs).run(5)
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_array_equal(got.global_batch, want.global_batch)
    tol = 1e-4 if scheme in ("feel", "gradient_fl") else 1e-5
    np.testing.assert_allclose(got.losses, np.asarray(want.losses),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(got.accs, np.asarray(want.accs), rtol=tol,
                               atol=tol)
    for name in ("fleet", "partition", "policy", "scheme", "seed"):
        assert list(got.coords[name]) == list(want.coords[name])
    print(f"PARITY Experiment.run scheme={scheme} sampling={size}: losses "
          f"max_abs_err="
          f"{float(np.abs(got.losses - np.asarray(want.losses)).max()):.3g}"
          f", accs {float(np.abs(got.accs - np.asarray(want.accs)).max()):.3g}"
          f" tol={tol}")


def test_table2_grid_lowers_to_the_reference_buckets(datasets):
    (data, _), (rdata, _) = datasets
    study = grid(_spec(port_api, DeviceProfile), scheme=list(SCHEMES),
                 partition=["iid", "noniid"])
    ref_study = ref_api.grid(_spec(ref_api, RefDevice), scheme=list(SCHEMES),
                             partition=["iid", "noniid"])
    got = lowering.group_rows(study)
    want = ref_lowering.group_rows(ref_study)
    assert [b.key for b in got] == [b.key for b in want]
    assert [b.kind for b in got] == [b.kind for b in want] == [
        "dev", "dev", "feel"]
    assert [[(r.spec.label, r.seed, r.indices) for r in b.rows]
            for b in got] == [[(r.spec.label, r.seed, r.indices)
                               for r in b.rows] for b in want]
    plans = [lowering.plan_bucket(b, data, 3) for b in got]
    rplans = [ref_lowering.plan_bucket(b, rdata, 3) for b in want]
    for plan, rplan in zip(plans, rplans):
        np.testing.assert_array_equal(plan.times, rplan.times)
        np.testing.assert_array_equal(plan.global_batch, rplan.global_batch)
        np.testing.assert_array_equal(plan.active, rplan.payload["active"])
        if plan.bucket.kind == "dev":
            np.testing.assert_array_equal(plan.idx, rplan.payload["idx"])
            np.testing.assert_array_equal(plan.lr, rplan.payload["lr"])
    print("PARITY Table-II grid lowering: buckets equal, plans max_abs_err=0 "
          "(bitwise)")


# ---------------------------------------------------------------------------
# within the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", ["individual", "model_fl"])
def test_dev_chunked_equals_monolithic_bitwise(datasets, scheme):
    (data, test), _ = datasets
    specs = [_spec(port_api, DeviceProfile, k, scheme=scheme, partition=p,
                   sampling=s)
             for k, p, s in ((4, "iid", None), (3, "noniid", Sampling(size=2)))]
    mono = Experiment(data, test, specs, device="cpu").run(5)
    for chunk in (1, 2):
        got = Experiment(data, test, specs, device="cpu").run(
            5, executor=SerialExecutor(chunk_periods=chunk))
        for f in ("losses", "accs", "times", "global_batch"):
            np.testing.assert_array_equal(getattr(got, f), getattr(mono, f),
                                          err_msg=f"{f} chunk={chunk}")
    print(f"PARITY {scheme} chunked vs monolithic: max_abs_err=0 (bitwise)")


@pytest.mark.parametrize("scheme", ["individual", "model_fl"])
def test_padded_dev_row_matches_its_solo_twin(datasets, scheme):
    (data, test), _ = datasets
    small = _spec(port_api, DeviceProfile, 3, scheme=scheme)
    big = _spec(port_api, DeviceProfile, 5, scheme=scheme)
    exp = Experiment(data, test, [small, big], device="cpu")
    assert len(exp.lower()) == 1 and exp.lower()[0].k_pad == 5
    res = exp.run(4)
    solo = Experiment(data, test, [small], device="cpu").run(4)
    np.testing.assert_array_equal(solo.times, res.times[:2])
    np.testing.assert_array_equal(solo.global_batch, res.global_batch[:2])
    np.testing.assert_allclose(solo.losses, res.losses[:2], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(solo.accs, res.accs[:2], rtol=1e-5, atol=1e-5)
    print(f"PARITY {scheme} padded K=3 row vs solo: losses max_abs_err="
          f"{float(np.abs(solo.losses - res.losses[:2]).max()):.3g} tol=1e-5")


def test_sampled_out_dev_user_holds_still_bitwise(datasets):
    (data, test), _ = datasets
    spec = _spec(port_api, DeviceProfile, 4, scheme="individual",
                 sampling=Sampling(size=2), seeds=(0,))
    bucket = lowering.group_rows([spec])[0]
    plan = lowering.plan_bucket(bucket, data, 4)
    arrays = engine.dataset_to_device(data, test, "cpu")
    params0 = lowering._init_params_batch(bucket.rows, DIM, "cpu")
    state = engine.EngineState(lowering._broadcast_rows(params0, 4))
    before = state.params
    for p in range(4):
        state, _ = engine.run_dev_trajectory_batch(
            state, plan.idx[:, p:p + 1], plan.lr, arrays, average=False,
            active=plan.active[:, p:p + 1])
        out = plan.active[0, p] < 0.5
        assert out.any() and (~out).any()
        for a, b in zip(before, state.params):
            for key in ("w", "b"):
                assert torch.equal(a[key][0, out], b[key][0, out])
                if key == "w":
                    assert not torch.equal(a[key][0, ~out], b[key][0, ~out])
        before = state.params
    print("PARITY sampled-out individual user over 4 periods: max_abs_err=0 "
          "(bitwise)")


def test_policy_coordinate_excludes_dev_schemes(datasets):
    """As the reference's ``tests/test_api.py``: the dev schemes report
    ``policy="none"``, so a FEEL-policy selection never mixes them in."""
    (data, test), _ = datasets
    specs = [_spec(port_api, DeviceProfile, partition="noniid",
                   scheme=s, seeds=(0,))
             for s in ("feel", "individual", "model_fl", "gradient_fl")]
    res = Experiment(data, test, specs, device="cpu").run(2)
    assert set(res.sel(policy="proposed").coords["scheme"]) == {"feel"}
    assert set(res.sel(policy="none").coords["scheme"]) == {"individual",
                                                            "model_fl"}
    assert set(res.sel(policy="full").coords["scheme"]) == {"gradient_fl"}
