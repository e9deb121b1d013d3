"""The PyTorch port's trajectory engine.

* One period step from an identical carry (params, SBC residuals, the
  same schedule) against the reference's ``_period_step``: allclose at
  2e-5 (f32, another summation order).
* Within the port on the CPU, bitwise: a chunked horizon equals the
  monolithic one in every series and ledger, and padded rows equal their
  solo twins in the ledgers (their losses agree to f32 rounding: padding
  changes the length of the weighted sums)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fed import engine as ref_engine
from repro.fed import feel_model as ref_model

from repro_torch.api import Experiment, ScenarioSpec, SerialExecutor
from repro_torch.core.latency import DeviceProfile
from repro_torch.data.pipeline import ClassificationData
from repro_torch.fed import engine
from repro_torch.interop import params_from_numpy, params_to_numpy

TOL = dict(rtol=2e-5, atol=2e-5)
K, SLOT, DIM, HIDDEN = 4, 8, 32, 16


@pytest.fixture(scope="module")
def step_case():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(120, DIM)).astype(np.float32)
    y = rng.integers(0, 10, size=120).astype(np.int32)
    tx = rng.normal(size=(40, DIM)).astype(np.float32)
    ty = rng.integers(0, 10, size=40).astype(np.int32)
    params = jax.tree_util.tree_map(np.asarray, ref_model.init(
        jax.random.key(1), HIDDEN, depth=3, input_dim=DIM))
    residual = jax.tree_util.tree_map(
        lambda p: (rng.normal(size=(K,) + p.shape) * 0.01).astype(
            np.float32), params)
    batch = np.array([8, 3, 5, 0], np.float32)        # last user padded
    weight = (np.arange(SLOT)[None, :] < batch[:, None]).astype(np.float32)
    xs = {"idx": rng.integers(0, 120, size=(K, SLOT)).astype(np.int32),
          "weight": weight, "batch": batch, "lr": np.float32(0.2),
          "aggden": np.float32(0.0),
          "active": np.array([1, 1, 1, 0], np.float32)}
    return (x, y, tx, ty), params, residual, xs


@pytest.mark.parametrize("compress", [False, True])
def test_period_step_matches_reference(step_case, compress):
    arrays, params, residual, xs = step_case
    (rp, rr), (rl, ra, rd) = ref_engine._period_step(
        *(jnp.asarray(a) for a in arrays), 1, compress, 0.05,
        (params, residual), {k: jnp.asarray(v) for k, v in xs.items()})
    batched = lambda t: jax.tree_util.tree_map(lambda a: a[None], t)  # noqa
    state = engine.EngineState(params_from_numpy(batched(params)),
                               params_from_numpy(batched(residual)))
    txs = engine.host_to_device(
        {k: np.asarray(v)[None] for k, v in xs.items()
         if k in ("idx", "weight", "batch", "lr", "aggden")}, "cpu")
    state, (loss, acc, decay) = engine._period_step(
        engine.host_to_device(arrays, "cpu"),
        torch.from_numpy(xs["active"][None]), compress, 0.05, state, txs)
    err = 0.0
    for got, want in ((state.params, rp), (state.residual, rr)):
        for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(got)),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a[0], np.asarray(b), **TOL)
            err = max(err, float(np.abs(a[0] - np.asarray(b)).max()))
    np.testing.assert_allclose(float(loss[0]), float(rl), **TOL)
    err = max(err, abs(float(loss[0]) - float(rl)))
    print(f"PARITY _period_step compress={compress}: max_abs_err={err:.3g} "
          f"tol=2e-5")
    np.testing.assert_allclose(float(decay[0]), float(rd), **TOL)
    assert float(acc[0]) == pytest.approx(float(ra))


def _fleet(k):
    return tuple(DeviceProfile(kind="cpu", f_cpu=[0.7e9, 1.4e9, 2.1e9][i % 3])
                 for i in range(k))


@pytest.fixture(scope="module")
def dataset():
    return ClassificationData.synthetic(n=400, dim=DIM, seed=0,
                                        spread=6.0).split(80)


def _specs(**kw):
    return [ScenarioSpec(fleet=_fleet(k), name=f"K{k}", partition=p,
                         hidden=HIDDEN, b_max=SLOT, seeds=(0, 1), **kw)
            for k in (3, 4) for p in ("iid", "noniid")]


def test_chunked_equals_monolithic_bitwise(dataset):
    data, test = dataset
    mono = Experiment(data, test, _specs(), device="cpu").run(5)
    for chunk in (1, 2, 3):
        got = Experiment(data, test, _specs(), device="cpu").run(
            5, executor=SerialExecutor(chunk_periods=chunk))
        for f in ("losses", "accs", "times", "global_batch"):
            np.testing.assert_array_equal(getattr(got, f), getattr(mono, f),
                                          err_msg=f"{f} chunk={chunk}")


def test_padded_rows_equal_their_solo_twins(dataset):
    data, test = dataset
    specs = _specs()
    grid = Experiment(data, test, specs, device="cpu")
    assert len(grid.lower()) == 1 and grid.lower()[0].k_pad == 4
    res = grid.run(4)
    for i, spec in enumerate(specs):
        solo = Experiment(data, test, [spec], device="cpu").run(4)
        rows = slice(2 * i, 2 * i + 2)
        np.testing.assert_array_equal(solo.times, res.times[rows])
        np.testing.assert_array_equal(solo.global_batch,
                                      res.global_batch[rows])
        np.testing.assert_allclose(solo.losses, res.losses[rows], **TOL)
        np.testing.assert_allclose(solo.accs, res.accs[rows], **TOL)


def test_duplicate_specs_compute_once_and_fan_out(dataset):
    data, test = dataset
    spec = _specs()[0]
    exp = Experiment(data, test, [spec, spec], device="cpu")
    assert [len(r.indices) for b in exp.lower() for r in b.rows] == [2, 2]
    res = exp.run(3)
    np.testing.assert_array_equal(res.losses[:2], res.losses[2:])
    assert list(res.coords["seed"]) == [0, 1, 0, 1]
    parts = list(Experiment(data, test, _specs(), device="cpu").stream(2))
    assert parts[-1].complete and parts[-1].rows == 8
