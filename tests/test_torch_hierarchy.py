"""The cell→edge→cloud hierarchy in the port, held against the
reference on the CPU.

* ``Topology``'s helpers (membership, masks, the member matrix with pad
  columns, the cloud cadence in global periods, the backhaul ledger, its
  rules): equal to the reference's.
* ``FeelScheduler(topology=)``'s per-(cell, period) horizon — every
  policy, with and without sampling, chunked — and ``plan_horizons_batch``
  planning it solo: bitwise the reference's.
* One period of ``_hier_period_step`` from the same carry, at τ 1 and 2,
  on cloud and edge rounds: 1e-5 (1e-4 compressed).
* ``Experiment.run`` with ``Topology(cells=2, edges=2, agg_every=3)``
  rows: ledgers bitwise, losses and accuracies 1e-5 (1e-4 compressed).
* Within the port: chunked == monolithic bitwise, a padded hierarchical
  row against its solo twin, and ``Topology(1, 1, 1)`` equal to the flat
  row (the reference's ``test_hier_degenerates_to_flat``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as ref_api
from repro.core import DeviceProfile as RefDevice
from repro.core import scheduler as ref_scheduler
from repro.data.pipeline import ClassificationData as RefData
from repro.fed import engine as ref_engine
from repro.fed import feel_model as ref_model
from repro.topology import Sampling as RefSampling
from repro.topology import Topology as RefTopology

import repro_torch.api as port_api
from repro_torch.api import Experiment, SerialExecutor, lowering
from repro_torch.core import scheduler
from repro_torch.core.latency import DeviceProfile
from repro_torch.data.pipeline import ClassificationData
from repro_torch.fed import engine
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.topology import Sampling, Topology

DIM, HIDDEN, SLOT = 32, 16, 8


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


@pytest.mark.parametrize("cells,edges,agg", [(1, 1, 1), (2, 1, 2),
                                             (3, 2, 3), (4, 4, 1)])
def test_topology_helpers_match_reference(cells, edges, agg):
    t = Topology(cells=cells, edges=edges, agg_every=agg, backhaul_bps=3e8)
    r = RefTopology(cells=cells, edges=edges, agg_every=agg,
                    backhaul_bps=3e8)
    assert t.structural_key() == r.structural_key() and str(t) == str(r)
    for k in (cells, 7):
        np.testing.assert_array_equal(t.cell_of_users(k), r.cell_of_users(k))
        np.testing.assert_array_equal(t.cell_masks(k), r.cell_masks(k))
        for k_pad in (None, k + 3):
            got, want = t.member_matrix(k, k_pad), r.member_matrix(k, k_pad)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t.edge_of_cells(), r.edge_of_cells())
    for offset in (0, 2, 5):
        np.testing.assert_array_equal(t.cloud_rounds(7, offset),
                                      r.cloud_rounds(7, offset))
    assert t.backhaul_roundtrip(1.7e6) == r.backhaul_roundtrip(1.7e6)
    with pytest.raises(ValueError):
        t.cell_of_users(cells - 1)


@pytest.mark.parametrize("kw", [dict(cells=0), dict(edges=3, cells=2),
                                dict(agg_every=True),
                                dict(backhaul_bps=0.0)])
def test_topology_refuses_what_the_reference_refuses(kw):
    with pytest.raises(ValueError):
        RefTopology(**kw)
    with pytest.raises(ValueError):
        Topology(**kw)


@pytest.mark.parametrize("size", [None, 2])
@pytest.mark.parametrize("policy", ["proposed", "online", "full", "random"])
def test_plan_horizon_topo_bitwise(policy, size):
    kw = dict(n_params=5000, policy=policy, b_max=16, seed=2,
              compression=0.01, reopt_every=3)
    port = scheduler.FeelScheduler(
        _fleet(DeviceProfile, 6), topology=Topology(cells=3, edges=2,
                                                    agg_every=2),
        sampling=None if size is None else Sampling(size=size), **kw)
    ref = ref_scheduler.FeelScheduler(
        _fleet(RefDevice, 6), topology=RefTopology(cells=3, edges=2,
                                                   agg_every=2),
        sampling=None if size is None else RefSampling(size=size), **kw)
    for periods in (4, 3, 5):                    # chunked
        got, want = port.plan_horizon(periods), ref.plan_horizon(periods)
        for f in ("batch", "tau_up", "tau_down", "lr", "latency",
                  "global_batch", "participation", "cloud"):
            a, b = getattr(got, f), getattr(want, f)
            if b is None:
                assert a is None, f
                continue
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    if policy == "proposed":
        np.testing.assert_array_equal(port._b_cache, ref._b_cache)
    print(f"PARITY _plan_horizon_topo {policy} size={size}: max_abs_err=0 "
          "(bitwise)")


def test_plan_horizons_batch_plans_topology_solo():
    def make(ns_sched, DP, **kw):
        return [ns_sched.FeelScheduler(_fleet(DP, k), n_params=4000,
                                       b_max=16, seed=s, **kw)
                for k, s in ((4, 0), (5, 1))]
    topo = dict(topology=Topology(cells=2, edges=2, agg_every=2))
    rtopo = dict(topology=RefTopology(cells=2, edges=2, agg_every=2))
    port = make(scheduler, DeviceProfile, **topo) \
        + make(scheduler, DeviceProfile)
    ref = make(ref_scheduler, RefDevice, **rtopo) + make(ref_scheduler,
                                                         RefDevice)
    for periods in (3, 4):
        got = scheduler.plan_horizons_batch(port, periods)
        want = ref_scheduler.plan_horizons_batch(ref, periods)
        for g, w in zip(got, want):
            for f in ("batch", "latency", "lr", "global_batch"):
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
            assert (g.cloud is None) == (w.cloud is None)
            if w.cloud is not None:
                np.testing.assert_array_equal(g.cloud, w.cloud)
    print("PARITY plan_horizons_batch with topology rows: max_abs_err=0 "
          "(bitwise)")


@pytest.fixture(scope="module")
def step_case():
    k, e = 5, 2
    rng = np.random.default_rng(0)
    arrays = (rng.normal(size=(120, DIM)).astype(np.float32),
              rng.integers(0, 10, size=120).astype(np.int32),
              rng.normal(size=(40, DIM)).astype(np.float32),
              rng.integers(0, 10, size=40).astype(np.int32))
    params = jax.tree_util.tree_map(np.asarray, ref_model.init(
        jax.random.key(1), HIDDEN, depth=3, input_dim=DIM))
    params_e = jax.tree_util.tree_map(
        lambda p: (p[None] + rng.normal(size=(e,) + p.shape) * 0.02)
        .astype(np.float32), params)
    residual = jax.tree_util.tree_map(
        lambda p: (rng.normal(size=(k,) + p.shape) * 0.01).astype(
            np.float32), params)
    batch = np.array([8, 3, 0, 5, 0], np.float32)  # user 2 out, 4 padded
    weight = (np.arange(SLOT)[None, :] < batch[:, None]).astype(np.float32)
    xs = {"idx": rng.integers(0, 120, size=(k, SLOT)).astype(np.int32),
          "weight": weight, "batch": batch, "lr": np.float32(0.2),
          "aggden": np.float32(0.0),
          "active": np.array([1, 1, 0, 1, 0], np.float32)}
    member = Topology(cells=2, edges=2).member_matrix(4, k)
    return arrays, params_e, residual, xs, member


@pytest.mark.parametrize("cloud", [0.0, 1.0])
@pytest.mark.parametrize("tau,compress,tol", [
    (1, False, 1e-5), (1, True, 1e-4), (2, False, 1e-5), (2, True, 1e-4)])
def test_hier_period_step_matches_reference(step_case, tau, compress, tol,
                                            cloud):
    arrays, params_e, residual, xs, member = step_case
    (rp, rr), (rl, ra, rd) = ref_engine._hier_period_step(
        *(jnp.asarray(a) for a in arrays), jnp.asarray(member), tau,
        compress, 0.05, (params_e, residual),
        {k: jnp.asarray(v) for k, v in dict(xs, cloud=np.float32(cloud))
         .items()})
    batched = lambda t: jax.tree_util.tree_map(lambda a: a[None], t)  # noqa
    state = engine.EngineState(params_from_numpy(batched(params_e)),
                               params_from_numpy(batched(residual)))
    txs = engine.host_to_device(
        {k: np.asarray(v)[None] for k, v in xs.items() if k != "active"},
        "cpu")
    state, (loss, acc, decay) = engine._hier_period_step(
        engine.host_to_device(arrays, "cpu"),
        torch.from_numpy(member[None]), torch.from_numpy(xs["active"][None]),
        torch.tensor([cloud]), compress, 0.05, tau, state, txs)
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
    if cloud:                                 # the replicas merged
        for leaf in jax.tree_util.tree_leaves(params_to_numpy(state.params)):
            np.testing.assert_array_equal(leaf[0, 0], leaf[0, 1])
    print(f"PARITY _hier_period_step local_steps={tau} compress={compress} "
          f"cloud={cloud}: max_abs_err={err:.3g} tol={tol}")


def _specs(api, DP, T, **kw):
    kw.setdefault("hidden", HIDDEN)
    kw.setdefault("b_max", 16)
    kw.setdefault("base_lr", 0.1)
    kw.setdefault("compression", 0.05)
    kw.setdefault("seeds", (0, 1))
    kw.setdefault("topology", T(cells=2, edges=2, agg_every=3))
    return [api.ScenarioSpec(fleet=_fleet(DP, k), partition=p, **kw)
            for k, p in ((4, "iid"), (3, "noniid"))]


@pytest.fixture(scope="module")
def datasets():
    return (ClassificationData.synthetic(n=600, dim=DIM, seed=0,
                                         spread=6.0).split(100),
            RefData.synthetic(n=600, dim=DIM, seed=0, spread=6.0).split(100))


@pytest.mark.parametrize("compress,tol,extra", [
    (False, 1e-5, {}), (True, 1e-4, {}), (False, 1e-5, {"local_steps": 2}),
    (False, 1e-5, {"sampling": 2}), (True, 1e-4, {"policy": "random"})])
def test_experiment_run_hier_matches_reference(monkeypatch, datasets,
                                               compress, tol, extra):
    monkeypatch.setattr(lowering, "_init_params_batch", _reference_init)
    (data, test), (rdata, rtest) = datasets
    size = extra.pop("sampling", None)
    specs = _specs(port_api, DeviceProfile, Topology, compress=compress,
                   sampling=None if size is None else Sampling(size=size),
                   **extra)
    ref_specs = _specs(ref_api, RefDevice, RefTopology, compress=compress,
                       sampling=None if size is None
                       else RefSampling(size=size), **extra)
    assert [s.bucket_key() for s in specs] == [s.bucket_key()
                                              for s in ref_specs]
    got = Experiment(data, test, specs, device="cpu").run(6)
    want = ref_api.Experiment(rdata, rtest, ref_specs).run(6)
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_array_equal(got.global_batch, want.global_batch)
    np.testing.assert_allclose(got.losses, np.asarray(want.losses),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(got.accs, np.asarray(want.accs), rtol=tol,
                               atol=tol)
    print(f"PARITY Experiment.run topology=c2e2a3 compress={compress} "
          f"{extra} sampling={size}: losses max_abs_err="
          f"{float(np.abs(got.losses - np.asarray(want.losses)).max()):.3g}"
          f", accs {float(np.abs(got.accs - np.asarray(want.accs)).max()):.3g}"
          f" tol={tol}")


def test_hier_chunked_equals_monolithic_bitwise(datasets):
    """The carry is (per-edge replicas, residuals) and the cloud cadence
    counts global periods, so 2-period chunks of agg_every=3 still merge
    on periods 3 and 6."""
    (data, test), _ = datasets
    specs = _specs(port_api, DeviceProfile, Topology,
                   sampling=Sampling(size=2))
    mono = Experiment(data, test, specs, device="cpu").run(6)
    for chunk in (1, 2, 4):
        got = Experiment(data, test, specs, device="cpu").run(
            6, executor=SerialExecutor(chunk_periods=chunk))
        for f in ("losses", "accs", "times", "global_batch"):
            np.testing.assert_array_equal(getattr(got, f), getattr(mono, f),
                                          err_msg=f"{f} chunk={chunk}")
    print("PARITY c2e2a3 chunked vs monolithic: max_abs_err=0 (bitwise)")


def test_padded_hier_row_matches_its_solo_twin(datasets):
    (data, test), _ = datasets
    specs = _specs(port_api, DeviceProfile, Topology)
    exp = Experiment(data, test, specs, device="cpu")
    assert len(exp.lower()) == 1 and exp.lower()[0].k_pad == 4
    plan = lowering.plan_bucket(exp.lower()[0], data, 2)
    assert plan.member.shape == (4, 2, 4) and not plan.member[2:, :, 3].any()
    res = exp.run(4)
    solo = Experiment(data, test, specs[1:], device="cpu").run(4)
    np.testing.assert_array_equal(solo.times, res.times[2:])
    np.testing.assert_array_equal(solo.global_batch, res.global_batch[2:])
    np.testing.assert_allclose(solo.losses, res.losses[2:], rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(solo.accs, res.accs[2:], rtol=2e-5, atol=2e-5)
    print("PARITY c2e2a3 padded K=3 row vs solo: losses max_abs_err="
          f"{float(np.abs(solo.losses - res.losses[2:]).max()):.3g} tol=2e-5")


def test_hier_degenerates_to_flat(datasets):
    """cells = edges = agg_every = 1 routes every user to one replica and
    merges it with itself every period: the allocation is bitwise the
    flat plan, the series equal to float tolerance (another loop)."""
    (data, test), _ = datasets
    t1 = Topology(cells=1, edges=1, agg_every=1, backhaul_bps=1e15)
    flat = Experiment(data, test, _specs(port_api, DeviceProfile, Topology,
                                         topology=None),
                      device="cpu").run(5)
    hier = Experiment(data, test, _specs(port_api, DeviceProfile, Topology,
                                         topology=t1),
                      device="cpu").run(5)
    np.testing.assert_array_equal(flat.global_batch, hier.global_batch)
    np.testing.assert_allclose(flat.losses, hier.losses, atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(flat.accs, hier.accs, atol=1e-5, rtol=1e-5)
    print("PARITY Topology(1, 1, 1) vs flat: losses max_abs_err="
          f"{float(np.abs(flat.losses - hier.losses).max()):.3g} tol=1e-5")
