"""The whole slice: ``Experiment.run`` of the PyTorch port against the
reference's on the same grid, data and seeds, with the reference's
initial weights carried across (torch cannot reproduce ``jax.random``).

Host ledgers (times, global batch) are bitwise equal.  Series:
* ``compress=False``: losses and accuracies agree to 1e-5 — only the f32
  summation order differs between the two frameworks.
* ``compress=True``: 1e-4.  SBC keeps the values at or above a threshold;
  a gradient within rounding of it can fall on the other side under a
  different summation order, and such a boundary tie then changes one
  survivor.  On this grid no tie occurs, and the series agree as closely
  as without compression; the looser bound leaves room for a tie while
  still failing on a wrong survivor set or a wrong group value."""
import jax
import numpy as np
import pytest

import repro.api as ref_api
from repro.core import DeviceProfile as RefDevice
from repro.data.pipeline import ClassificationData as RefData
from repro.fed import feel_model as ref_model

from repro_torch.api import Experiment, ScenarioSpec
from repro_torch.api import lowering
from repro_torch.core.latency import DeviceProfile
from repro_torch.data.pipeline import ClassificationData
from repro_torch.interop import params_from_numpy


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


@pytest.mark.parametrize("compress,tol", [(False, 1e-5), (True, 1e-4)])
def test_experiment_run_matches_reference(monkeypatch, compress, tol):
    monkeypatch.setattr(lowering, "_init_params_batch", _reference_init)
    kw = dict(hidden=16, depth=3, b_max=16, base_lr=0.1, seeds=(0, 1),
              compress=compress, compression=0.05)
    data, test = ClassificationData.synthetic(
        n=600, dim=32, seed=0, spread=6.0).split(100)
    rdata, rtest = RefData.synthetic(n=600, dim=32, seed=0,
                                     spread=6.0).split(100)
    specs = [ScenarioSpec(fleet=_fleet(DeviceProfile, 4), partition="iid",
                          **kw),
             ScenarioSpec(fleet=_fleet(DeviceProfile, 3),
                          partition="noniid", **kw)]
    ref_specs = [ref_api.ScenarioSpec(fleet=_fleet(RefDevice, 4),
                                      partition="iid", **kw),
                 ref_api.ScenarioSpec(fleet=_fleet(RefDevice, 3),
                                      partition="noniid", **kw)]
    assert [s.bucket_key() for s in specs] == [s.bucket_key()
                                              for s in ref_specs]
    got = Experiment(data, test, specs, device="cpu").run(6)
    want = ref_api.Experiment(rdata, rtest, ref_specs).run(6)
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_array_equal(got.global_batch, want.global_batch)
    np.testing.assert_allclose(got.losses, want.losses, rtol=tol, atol=tol)
    np.testing.assert_allclose(got.accs, want.accs, rtol=tol, atol=tol)
    print(f"PARITY Experiment.run compress={compress}: losses max_abs_err="
          f"{float(np.abs(got.losses - want.losses).max()):.3g}, accs "
          f"{float(np.abs(got.accs - want.accs).max()):.3g} tol={tol}")
    for name in ("fleet", "partition", "policy", "scheme", "seed"):
        assert list(got.coords[name]) == list(want.coords[name])
    assert np.isfinite(got.losses).all()
