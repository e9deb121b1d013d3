"""The port's static analysis against the reference's own verdicts.

The reference's ``repro.analysis`` imports on the installed jax only with
two runtime shims, and no file of the reference is edited for them:

1. ``jax.core.ClosedJaxpr``, ``Jaxpr`` and ``Literal`` are set to their
   ``jax.extend.core`` counterparts before ``repro.analysis`` imports;
2. ``taint._Interp._p_jit = taint._Interp._p_pjit``: this jax names the
   ``pjit`` primitive ``jit``, and without a rule every program's one
   top-level equation would be ``taint.unhandled-primitive``.

The reference runs in one subprocess for the module (started first, so
it runs beside the port's probes), so no other test in this worker sees
the shims.  Compared:

* the verdict per program of the four Table-II scheme programs (feel,
  uncompressed gradient_fl, individual, model_fl) and the hierarchy, at
  K 4 traced for one period: both packages certify every one;
* the planted poisoned-padding mutant, in its three forms: both reject;
* ``lint_sources`` over ``src/repro`` by both: findings equal as
  (check, severity, where, detail);
* ``Experiment.run``'s parameter order (``audit`` fourth, as in the
  reference, so ``run(3, None, None, True)`` audits in both).
"""
import inspect
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from repro_torch.analysis import AuditReport, determinism, taint
from repro_torch.analysis.taint import LaneLabel
from repro_torch.api import Experiment, ScenarioSpec, Topology, lowering
from repro_torch.core.latency import DeviceProfile
from repro_torch.data.pipeline import ClassificationData

ROOT = pathlib.Path(__file__).resolve().parents[1]
K = 4
MUTANTS = ("sum", "reshape-sum", "dot")

_COMMON = """
def _fleet(k):
    return tuple(DeviceProfile(kind="cpu", f_cpu=(0.7 + 0.35 * (i % 3)) * 1e9)
                 for i in range(k))


def _spec(k, **kw):
    kw.setdefault("b_max", 12)
    kw.setdefault("base_lr", 0.15)
    kw.setdefault("hidden", 16)
    kw.setdefault("seeds", (0,))
    return ScenarioSpec(fleet=_fleet(k), name=f"K{k}", **kw)


SPECS = [_spec(4, scheme="feel"), _spec(4, scheme="feel", compress=False),
         _spec(4, scheme="individual"), _spec(4, scheme="model_fl"),
         _spec(4, scheme="feel",
               topology=Topology(cells=2, edges=2, agg_every=2))]
full = ClassificationData.synthetic(n=220, dim=12, seed=0, spread=6.0)
data, test = full.split(60)
"""

_REFERENCE = """
import json
import jax
import jax.core
import jax.extend.core
import jax.numpy as jnp
import numpy as np
for name in ("ClosedJaxpr", "Jaxpr", "Literal"):
    setattr(jax.core, name, getattr(jax.extend.core, name))
from repro.analysis import determinism, taint
from repro.analysis.taint import LaneLabel
taint._Interp._p_jit = taint._Interp._p_pjit
from repro.api import ScenarioSpec
from repro.api.lowering import group_rows, plan_bucket, trace_bucket
from repro.core import DeviceProfile
from repro.data.pipeline import ClassificationData
from repro.topology import Topology
""" + _COMMON + """
out = {"verdicts": [], "mutants": {}}
for bucket in group_rows(SPECS):
    traced = trace_bucket(plan_bucket(bucket, data, 1), data, test)
    rep = taint.analyze_jaxpr(traced.closed, traced.in_labels,
                              traced.out_contracts, program="p")
    out["verdicts"].append(
        [repr(bucket.key), rep.ok,
         rep.programs["p"]["n_certified_reductions"]])
for op in ("sum", "reshape-sum", "dot"):
    def poisoned(x, mask, op=op):
        if op == "sum":
            return x.sum(axis=0) / (mask.sum() + 1.0)
        if op == "reshape-sum":
            return x.reshape(-1).sum() / (mask.sum() + 1.0)
        return jnp.dot(jnp.ones(4, np.float32) * 1.0 + 0.0 * mask, x)
    closed = jax.make_jaxpr(poisoned)(np.zeros((4, 3), np.float32),
                                      np.zeros(4, np.float32))
    rep = taint.analyze_jaxpr(closed, [LaneLabel(0), LaneLabel(0, 0.0)])
    out["mutants"][op] = [rep.ok, sorted({f.check for f in rep.errors()})]
out["lint"] = [[f.check, f.severity.value, f.where, f.detail]
               for f in determinism.lint_sources().findings]
print(json.dumps(out))
"""

# the port's SPECS, data and test, from the same source
_NS = dict(ScenarioSpec=ScenarioSpec, DeviceProfile=DeviceProfile,
           ClassificationData=ClassificationData, Topology=Topology)
exec(_COMMON, _NS)
SPECS, data, test = _NS["SPECS"], _NS["data"], _NS["test"]


@pytest.fixture(scope="module")
def verdicts():
    """``(reference, port)``: the reference's subprocess output, and the
    port's per-program verdicts on the same buckets, computed while the
    subprocess runs."""
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "JAX_PLATFORMS": "cpu"})
    port = []
    for bucket in lowering.group_rows(SPECS):
        plan = lowering.plan_bucket(bucket, data, 1)
        report = lowering.audit_bucket_taint(plan, data, test)
        summary = next(v for v in report.programs.values()
                       if v["pass"] == "taint")
        port.append([repr(bucket.key), report.ok,
                     summary["n_certified_reductions"]])
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-3000:]
    return json.loads(stdout.strip().splitlines()[-1]), port


@pytest.mark.parametrize("i", range(5), ids=["feel", "gradient_fl",
                                             "individual", "model_fl",
                                             "hierarchy"])
def test_program_verdict_equals_the_reference(verdicts, i):
    ref, port = verdicts
    assert len(ref["verdicts"]) == len(port) == 5
    (ref_key, ref_ok, ref_n), (key, ok, n) = ref["verdicts"][i], port[i]
    assert key == ref_key
    assert ok == ref_ok is True
    assert n >= 1 and ref_n >= 1


@pytest.mark.parametrize("op", MUTANTS)
def test_planted_mutant_rejected_by_both(verdicts, op):
    def poisoned(x, mask):
        if op == "sum":
            return x.sum(0) / (mask.sum() + 1.0)
        if op == "reshape-sum":
            return x.reshape(-1).sum() / (mask.sum() + 1.0)
        return (torch.ones(K) * 1.0 + 0.0 * mask) @ x
    gm = make_fx(poisoned, tracing_mode="fake")(torch.zeros(K, 3),
                                                torch.zeros(K))
    report = taint.analyze_graph(gm, [LaneLabel(0), LaneLabel(0, 0.0)],
                                 report=AuditReport())
    ref_ok, ref_checks = verdicts[0]["mutants"][op]
    assert not report.ok and not ref_ok
    assert {f.check for f in report.errors()} == set(ref_checks)


def test_lint_over_the_reference_sources_equals_the_reference(verdicts):
    port = determinism.lint_sources(root=ROOT / "src" / "repro")
    got = [[f.check, f.severity.value, f.where, f.detail]
           for f in port.findings]
    assert got == verdicts[0]["lint"]
    assert port.programs["determinism-lint"]["ok"]


def test_run_takes_the_reference_parameter_order():
    from repro.api.experiment import Experiment as RefExperiment
    names = list(inspect.signature(Experiment.run).parameters)
    assert names == list(inspect.signature(RefExperiment.run).parameters)
    assert names[4] == "audit"
