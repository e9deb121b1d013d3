"""The port's executors on the CPU: ``AsyncExecutor`` (capped or not,
chunked or not) and ``MeshExecutor`` on one device are bitwise equal to
``SerialExecutor`` (over a mesh of two ``cpu`` entries, ledgers bitwise
and losses within 1e-5) — the counterparts of the reference's
``tests/test_api.py`` executor cases — ``AsyncExecutor`` dispatches a
bucket's chunks ahead and collects under its window, a planning error
reaches the caller, and a grid run under each port executor matches the
reference's
``SerialExecutor`` (ledgers bitwise, losses 1e-5 without compression and
1e-4 with it, as ``tests/test_torch_experiment.py``)."""
import jax
import numpy as np
import pytest
import torch

import repro.api as ref_api
from repro.core import DeviceProfile as RefDevice
from repro.data.pipeline import ClassificationData as RefData
from repro.fed import feel_model as ref_model

import repro_torch.api as port_api
from repro_torch.api import (AsyncExecutor, Experiment, MeshExecutor,
                             ScenarioSpec, SerialExecutor, lowering)
from repro_torch.core import DeviceProfile
from repro_torch.data.pipeline import ClassificationData
from repro_torch.interop import params_from_numpy
from repro_torch.launch.mesh import Mesh, make_batch_mesh, pad_batch

DIM, HIDDEN, BMAX = 24, 16, 12
FIELDS = ("losses", "accs", "times", "global_batch")


@pytest.fixture(scope="module")
def dataset():
    full = ClassificationData.synthetic(n=400, dim=DIM, seed=0, spread=6.0)
    return full.split(80)


@pytest.fixture(scope="module")
def fleet():
    return tuple(DeviceProfile(kind="cpu", f_cpu=f * 1e9)
                 for f in [0.7, 1.4, 2.1])


def _spec(fleet, **kw):
    kw.setdefault("name", "cpu3")
    kw.setdefault("b_max", BMAX)
    kw.setdefault("base_lr", 0.15)
    kw.setdefault("hidden", HIDDEN)
    return ScenarioSpec(fleet=fleet, **kw)


def _multibucket_specs(fleet):
    """Three buckets: a FEEL pair (2 cells × 2 seeds), a wider slot, and
    the uncompressed program."""
    return ([_spec(fleet, partition=p, policy="proposed", seeds=(0, 1))
             for p in ("iid", "noniid")]
            + [_spec(fleet, b_max=2 * BMAX, seeds=(0,)),
               _spec(fleet, compress=False, policy="random", seeds=(0,))])


def _bitwise(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


@pytest.fixture(scope="module")
def serial(dataset, fleet):
    data, test = dataset
    exp = Experiment(data, test, _multibucket_specs(fleet), device="cpu")
    assert len(exp.lower()) == 3
    return exp.run(periods=4, executor=SerialExecutor())


# ---------------------------------------------------------------------------
# the reference's executor cases (tests/test_api.py), on the port
# ---------------------------------------------------------------------------


def test_async_executor_bit_identical_to_serial(dataset, fleet, serial):
    data, test = dataset
    exp = Experiment(data, test, _multibucket_specs(fleet), device="cpu")
    done = exp.run(periods=4, executor=AsyncExecutor())
    default = exp.run(periods=4)                  # default == serial
    for got in (done, default):
        _bitwise(got, serial)
    assert serial.n_buckets == done.n_buckets == 3


def test_stream_yields_cumulative_partials(dataset, fleet, serial):
    data, test = dataset
    exp = Experiment(data, test, _multibucket_specs(fleet), device="cpu")
    partials = list(exp.stream(periods=4, executor=AsyncExecutor()))
    assert len(partials) == 3
    assert [p.rows for p in partials] == [4, 5, 6]
    assert [p.complete for p in partials] == [False, False, True]
    _bitwise(partials[-1], serial)
    np.testing.assert_array_equal(partials[0].losses, serial.losses[:4])


def test_mesh_one_device_fallback(dataset, fleet):
    """A one-device mesh (3 rows: ``pad_batch`` is 0) runs the bucket on
    that device: bitwise the plain lowering, lazily built or given."""
    data, test = dataset
    specs = [_spec(fleet, partition="noniid", policy="proposed",
                   seeds=(0, 1, 2)),
             _spec(fleet, b_max=2 * BMAX, seeds=(0,))]
    exp = Experiment(data, test, specs, device="cpu")
    plain = exp.run(periods=4)
    lazy = MeshExecutor()
    _bitwise(exp.run(periods=4, executor=lazy), plain)
    assert lazy.mesh.devices == (torch.device("cpu"),)
    assert lazy.mesh.axis_names == ("batch",)
    assert pad_batch(3, lazy.mesh) == 0
    given_mesh = make_batch_mesh(device="cpu")
    for executor in (MeshExecutor(given_mesh, chunk_periods=3),
                     AsyncExecutor(mesh=given_mesh)):
        _bitwise(exp.run(periods=4, executor=executor), plain)


def test_mesh_executor_rejects_non_batch_mesh(dataset, fleet):
    data, test = dataset
    specs = [_spec(fleet, partition="iid", policy="full", seeds=(0,))]
    mesh = Mesh((torch.device("cpu"),), axis_names=("data", "model"))
    with pytest.raises(ValueError, match="batch"):
        Experiment(data, test, specs, device="cpu").run(
            periods=3, executor=MeshExecutor(mesh))


@pytest.mark.parametrize("executor", [MeshExecutor, AsyncExecutor,
                                      SerialExecutor])
def test_mesh_of_several_devices_shards_rows(dataset, fleet, executor,
                                             serial):
    """A mesh of several devices shards the rows: over two ``cpu``
    entries the three buckets (4, 1 and 1 rows, padded to 4, 2
    and 2) equal the one-device serial run, ledgers bitwise and losses
    within 1e-5 (a shard's products run at another row count).  A mesh of
    another device type is still refused."""
    data, test = dataset
    mesh = Mesh((torch.device("cpu"), torch.device("cpu")))
    assert pad_batch(3, mesh) == 1
    got = Experiment(data, test, _multibucket_specs(fleet),
                     device="cpu").run(periods=4, executor=executor(mesh))
    for f in ("times", "global_batch"):
        np.testing.assert_array_equal(getattr(got, f), getattr(serial, f))
    for f in ("losses", "accs"):
        np.testing.assert_allclose(getattr(got, f), getattr(serial, f),
                                   rtol=0, atol=1e-5, err_msg=f)
    cards = Mesh((torch.device("cuda", 0), torch.device("cuda", 1)))
    with pytest.raises(ValueError, match="device type"):
        Experiment(data, test, _multibucket_specs(fleet),
                   device="cpu").run(periods=4, executor=executor(cards))


def test_mesh_on_another_device_raises(dataset, fleet):
    """The executor does not move the experiment to the mesh's device."""
    data, test = dataset
    specs = [_spec(fleet, partition="iid", policy="full", seeds=(0,))]
    mesh = Mesh((torch.device("cuda", 0),))
    with pytest.raises(ValueError, match="not the experiment's device"):
        Experiment(data, test, specs, device="cpu").run(
            periods=3, executor=MeshExecutor(mesh))


def test_make_batch_mesh_caps_devices():
    assert make_batch_mesh(max_devices=1, device="cpu").size == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_batch_mesh()


def test_async_max_in_flight_validation():
    with pytest.raises(ValueError, match="max_in_flight"):
        AsyncExecutor(max_in_flight=0)
    with pytest.raises(ValueError, match="chunk_periods"):
        AsyncExecutor(chunk_periods=0)
    with pytest.raises(ValueError, match="chunk_periods"):
        MeshExecutor(chunk_periods=0)


@pytest.mark.parametrize("cap,chunk", [(1, None), (2, None), (None, 3),
                                       (1, 3), (2, 1)])
def test_async_max_in_flight_bit_equal(dataset, fleet, serial, cap, chunk):
    """The backlog cap and the chunk size are scheduling policy only:
    every combination is bitwise the serial run."""
    data, test = dataset
    exp = Experiment(data, test, _multibucket_specs(fleet), device="cpu")
    executor = AsyncExecutor(max_in_flight=cap, chunk_periods=chunk)
    _bitwise(exp.run(periods=4, executor=executor), serial)


def test_capped_stream_yields_one_partial_per_bucket(dataset, fleet, serial):
    data, test = dataset
    exp = Experiment(data, test, _multibucket_specs(fleet), device="cpu")
    partials = list(exp.stream(periods=4,
                               executor=AsyncExecutor(max_in_flight=1)))
    assert len(partials) == 3
    _bitwise(partials[-1], serial)


@pytest.mark.parametrize("cap,want", [
    (None, "PDPD" "PDPD" "PDPD" "CC" "CC" "CC"),
    (1, "PDPD" "CC" "PDPD" "CC" "PDPD" "CC"),
    (2, "PDPD" "PDPD" "CC" "PDPD" "CC" "CC")])
def test_async_dispatches_ahead_and_collects_under_the_window(
        dataset, fleet, monkeypatch, cap, want):
    """Every chunk of a bucket is planned and dispatched before its first
    collect; a bucket is collected only when the window is full or at the
    end (P plan, D dispatch, C collect: three buckets of two chunks); the
    timings account for the three phases."""
    data, test = dataset
    events = []
    plan, dispatch = lowering._FeelPlanner.plan, lowering.dispatch_bucket
    collect = lowering.collect_bucket

    def spy(tag, fn):
        def wrapped(*a, **kw):
            events.append(tag)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(lowering._FeelPlanner, "plan", spy("P", plan))
    monkeypatch.setattr(lowering, "dispatch_bucket", spy("D", dispatch))
    monkeypatch.setattr(lowering, "collect_bucket", spy("C", collect))
    executor = AsyncExecutor(max_in_flight=cap, chunk_periods=2)
    Experiment(data, test, _multibucket_specs(fleet), device="cpu").run(
        periods=4, executor=executor)
    assert "".join(events) == want
    assert set(executor.timings) == {"plan", "dispatch", "collect"}
    assert all(t >= 0 for t in executor.timings.values())


@pytest.mark.parametrize("chunk", [None, 2])
def test_planning_exception_reaches_the_caller(dataset, fleet, monkeypatch,
                                               chunk):
    """No fallback: a planner's error stops the run where it happened."""
    data, test = dataset
    calls = []
    plan = lowering._FeelPlanner.plan

    def failing_plan(self, periods):
        calls.append(periods)
        if len(calls) == 3:
            raise FloatingPointError("planner failed")
        return plan(self, periods)

    monkeypatch.setattr(lowering._FeelPlanner, "plan", failing_plan)
    exp = Experiment(data, test, _multibucket_specs(fleet), device="cpu")
    with pytest.raises(FloatingPointError, match="planner failed"):
        exp.run(periods=4, executor=AsyncExecutor(chunk_periods=chunk))
    assert len(calls) == 3                         # nothing planned after


def test_bucket_run_plan_and_dispatch_steps(dataset, fleet, serial):
    """``plan_next`` / ``dispatch`` in turns, and ``drain``, are bitwise
    the serial run; their guards refuse an out-of-order step."""
    data, test = dataset
    exp = Experiment(data, test, _multibucket_specs(fleet), device="cpu")
    arrays = lowering.DeviceData(data, test, exp.device)
    bucket = exp.lower()[0]
    run = lowering.BucketRun(bucket, data, 4, 3, arrays)
    assert run.n_chunks == 2
    plan = run.plan_next()
    with pytest.raises(RuntimeError, match="awaits dispatch"):
        run.advance()
    run.dispatch(plan)
    with pytest.raises(RuntimeError, match="no planned chunk"):
        run.dispatch(plan)
    losses, accs, times, gb = run.drain()
    np.testing.assert_array_equal(losses, serial.losses[:4])
    np.testing.assert_array_equal(times, serial.times[:4])
    with pytest.raises(RuntimeError, match="fully planned"):
        run.plan_next()


# ---------------------------------------------------------------------------
# a grid under each port executor against the reference's SerialExecutor
# ---------------------------------------------------------------------------


def _reference_init(rows, input_dim, device):
    per_row = [ref_model.init(jax.random.key(r.seed), r.spec.hidden,
                              depth=r.spec.depth, input_dim=input_dim)
               for r in rows]
    stacked = jax.tree_util.tree_map(
        lambda *a: np.stack([np.asarray(x) for x in a]), *per_row)
    return params_from_numpy(stacked, device)


def _grid(api, DP):
    base = api.ScenarioSpec(
        fleet=tuple(DP(kind="cpu", f_cpu=[0.7e9, 1.4e9, 2.1e9][i % 3])
                    for i in range(4)),
        name="K4", hidden=16, depth=3, b_max=16, base_lr=0.1, seeds=(0,),
        compression=0.05)
    return api.grid(base, policy=["online", "full", "random", "proposed"],
                    compress=[True, False], partition=["iid", "noniid"])


@pytest.fixture(scope="module")
def reference_grid_run():
    rdata, rtest = RefData.synthetic(n=600, dim=32, seed=0,
                                     spread=6.0).split(100)
    return ref_api.Experiment(rdata, rtest, _grid(ref_api, RefDevice)).run(
        4, executor=ref_api.SerialExecutor())


@pytest.mark.parametrize("executor", [
    SerialExecutor(), AsyncExecutor(), AsyncExecutor(chunk_periods=3),
    AsyncExecutor(max_in_flight=1, chunk_periods=1), MeshExecutor()],
    ids=["serial", "async", "async-chunk3", "async-cap1-chunk1", "mesh"])
def test_grid_matches_reference_under_each_executor(monkeypatch,
                                                    reference_grid_run,
                                                    executor):
    monkeypatch.setattr(lowering, "_init_params_batch", _reference_init)
    data, test = ClassificationData.synthetic(
        n=600, dim=32, seed=0, spread=6.0).split(100)
    study = _grid(port_api, DeviceProfile)
    exp = Experiment(data, test, study, device="cpu")
    assert len(exp.lower()) == 2
    got = exp.run(4, executor=executor)
    want = reference_grid_run
    assert got.rows == want.rows == 16
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_array_equal(got.global_batch, want.global_batch)
    for name in ("fleet", "partition", "policy", "scheme", "seed",
                 "compress"):
        assert list(got.coords[name]) == list(want.coords[name]), name
    for compress, tol in ((False, 1e-5), (True, 1e-4)):
        g, w = got.sel(compress=compress), want.sel(compress=compress)
        np.testing.assert_allclose(g.losses, w.losses, rtol=tol, atol=tol)
        np.testing.assert_allclose(g.accs, w.accs, rtol=tol, atol=tol)
        print(f"PARITY grid under {type(executor).__name__} "
              f"compress={compress}: losses max_abs_err="
              f"{float(np.abs(g.losses - w.losses).max()):.3g} tol={tol}")
    for policy in ("online", "full", "random", "proposed"):
        np.testing.assert_array_equal(got.sel(policy=policy).speed(0.3),
                                      want.sel(policy=policy).speed(0.3))
