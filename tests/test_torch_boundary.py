"""The PyTorch port's boundaries: it imports neither jax nor any module of
the JAX reference package (its ``topology`` and ``dynamics`` packages are
copies), its spec accepts, keys and refuses the Table-II schemes, τ local
steps, the hierarchy, the closed loop (``replan``) and adaptive local
steps (``adapt_tau``) as the reference's does and type-checks the
time-varying world's fields as the reference does, its entry points
(``Experiment``, ``ExperimentService``, ``FeelSimulation``) run on the
GPU unless the caller asks for the CPU, and its one-device
``MeshExecutor`` dispatches the programs a warm admission then reuses
without a duplicate ledger event."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.api import Experiment, MeshExecutor, ScenarioSpec
from repro_torch.core.latency import DeviceProfile
from repro_torch.data.pipeline import ClassificationData
from repro_torch.fed import engine
from repro_torch.fed.trainer import FeelSimulation
from repro_torch.serve import ExperimentService, ProgramCache
from repro_torch.testing import VirtualClock, no_retrace

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b|from\s+repro\b"
    r"|import\s+msgpack\b|from\s+msgpack\b)", re.MULTILINE)


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    code = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro.")
             or m == "msgpack" or m.startswith("msgpack."))
new = {"repro_torch.serve." + m for m in ("admission", "program_cache",
                                          "scheduler", "service", "stats")}
new |= {"repro_torch.testing." + m for m in ("arrivals", "clock",
                                             "proptest")}
new |= {"repro_torch.serve", "repro_torch.testing", "repro_torch.fed.sweep",
        "repro_torch.fed.trainer"}
new |= {"repro_torch.checkpoint", "repro_torch.checkpoint.ckpt",
        "repro_torch.launch.train", "repro_torch.configs.qwen1p5_4b"}
new |= {"repro_torch.analysis." + m for m in ("audit", "compile_audit",
                                              "determinism", "report",
                                              "taint")}
new |= {"repro_torch.analysis", "repro_torch.kernels.probe",
        "repro_torch.launch.sharding"}
bad += sorted(new - set(names))
print(len(names), bad)
"""
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"}).stdout.split(" ", 1)
    assert int(out[0]) >= 70, out
    assert out[1].strip() == "[]", out


def test_port_sources_and_chip_smoke_name_no_jax_and_no_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "kernel_ab.py",
              ROOT / "executor_ab.py"]
    assert len(files) > 20
    # the copies of the reference's jax-free modules are scanned too
    assert {"topology", "dynamics", "serve", "testing"} <= {
        f.parent.name for f in files}
    offenders = [(str(f.relative_to(ROOT)), m.group(0).strip())
                 for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert offenders == []


def _fleet(k=3):
    return tuple(DeviceProfile(kind="cpu", f_cpu=f * 1e9)
                 for f in [0.7, 1.4, 2.1][:k])


def _spec_outcome(ns, kw):
    """``(bucket_key, effective_policy)`` of a spec built in one package
    from the keyword arguments ``kw(ns)``, or the type of the error it
    raises."""
    fleet = tuple(ns.DeviceProfile(kind="cpu", f_cpu=f * 1e9)
                  for f in [0.7, 1.4, 2.1])
    try:
        spec = ns.ScenarioSpec(fleet=fleet, **kw(ns))
    except (TypeError, ValueError) as exc:
        return type(exc)
    return spec.bucket_key(), spec.effective_policy


@pytest.mark.parametrize("kw", [
    lambda ns: dict(scheme="model_fl"), lambda ns: dict(scheme="individual"),
    lambda ns: dict(scheme="gradient_fl"), lambda ns: dict(local_steps=2),
    lambda ns: dict(topology=object()),
    lambda ns: dict(topology=ns.Topology(cells=2, edges=2, agg_every=3)),
    lambda ns: dict(topology=ns.Topology(cells=4)),
    lambda ns: dict(replan=5), lambda ns: dict(replan=0),
    lambda ns: dict(replan=True),
    lambda ns: dict(replan=5, scheme="individual"),
    lambda ns: dict(adapt_tau=object()),
    lambda ns: dict(adapt_tau=ns.TauAdapt((1, 2))),
    lambda ns: dict(replan=2, adapt_tau=ns.TauAdapt((1, 2))),
    lambda ns: dict(replan=2, local_steps=4, adapt_tau=ns.TauAdapt((1, 2))),
    lambda ns: dict(replan=2, model_family="transformer"),
    lambda ns: dict(replan=2, model_family="transformer",
                    adapt_tau=ns.TauAdapt((1, 2)))])
def test_spec_accepts_what_the_reference_accepts(kw):
    """The Table-II schemes, τ local steps, the hierarchy, the closed
    loop and adaptive local steps: the port's spec keys, labels and
    refuses as the reference's does (``topology=object()`` and
    ``adapt_tau=object()``: ``TypeError``; more cells than users, a
    ``replan`` that is not a positive int or on a dev scheme, ``adapt_tau``
    without ``replan``, with a ``local_steps`` outside its choices or on a
    big-model family: ``ValueError``)."""
    from types import SimpleNamespace

    import repro.api as ref_api
    from repro.core import DeviceProfile as RefDevice
    from repro.dynamics import TauAdapt as RefTau
    from repro.topology import Topology as RefTopology

    from repro_torch.dynamics import TauAdapt
    from repro_torch.topology import Topology
    port = SimpleNamespace(ScenarioSpec=ScenarioSpec,
                           DeviceProfile=DeviceProfile, Topology=Topology,
                           TauAdapt=TauAdapt)
    ref = SimpleNamespace(ScenarioSpec=ref_api.ScenarioSpec,
                          DeviceProfile=RefDevice, Topology=RefTopology,
                          TauAdapt=RefTau)
    assert _spec_outcome(port, kw) == _spec_outcome(ref, kw)


@pytest.mark.parametrize("field", ["sampling", "fading", "faults",
                                   "energy"])
def test_spec_type_checks_the_time_varying_world(field):
    """As the reference's ``ScenarioSpec``: a value of the wrong type for
    a sampling or dynamics field is a ``TypeError``."""
    with pytest.raises(TypeError, match=f"{field}= expects"):
        ScenarioSpec(fleet=_fleet(), **{field: object()})


def test_spec_accepts_the_transformer_family():
    spec = ScenarioSpec(fleet=_fleet(), model_family="transformer")
    assert spec.bucket_key()[-1] == "transformer"
    assert spec.bucket_key() != ScenarioSpec(fleet=_fleet()).bucket_key()


def test_spec_accepts_the_mamba2_family():
    spec = ScenarioSpec(fleet=_fleet(), model_family="mamba2")
    assert spec.bucket_key()[-1] == "mamba2"
    assert spec.bucket_key() != ScenarioSpec(
        fleet=_fleet(), model_family="transformer").bucket_key()
    with pytest.raises(ValueError):               # the reference's rule
        ScenarioSpec(fleet=_fleet(), model_family="mamba2", hidden=10)


@pytest.mark.parametrize("field,value", [
    ("hidden", 10), ("local_steps", 2), ("scheme", "individual"),
    ("scheme", "model_fl")])
def test_spec_rejects_what_the_reference_rejects_for_big_models(field,
                                                                value):
    """As the reference's ``tests/test_model_families.py`` does: a big-model
    family is FEEL-only, one step a period, ``hidden`` divisible by 4."""
    with pytest.raises(ValueError):
        ScenarioSpec(fleet=_fleet(), model_family="transformer",
                     **{field: value})


@pytest.mark.parametrize("field,value", [
    ("scheme", "fedsgd"), ("partition", "dirichlet"), ("policy", "greedy"),
    ("seeds", ()), ("model_family", "cnn")])
def test_spec_rejects_malformed_values(field, value):
    with pytest.raises(ValueError):
        ScenarioSpec(fleet=_fleet(), **{field: value})


def test_experiment_defaults_to_the_gpu_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data, test = ClassificationData.synthetic(n=40, dim=8).split(10)
    spec = ScenarioSpec(fleet=_fleet())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Experiment(data, test, [spec])
    assert Experiment(data, test, [spec], device="cpu").device.type == "cpu"


def test_service_and_simulation_default_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data, test = ClassificationData.synthetic(n=40, dim=8).split(10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ExperimentService(data, test)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FeelSimulation(list(_fleet()), data, test)
    assert ExperimentService(data, test, device="cpu").device.type == "cpu"
    assert FeelSimulation(list(_fleet()), data, test,
                          device="cpu").device.type == "cpu"


def test_mesh_executor_then_warm_admission_records_no_duplicate():
    """The reference's one-device mesh runs a warm program again as new
    (C-ref-8: a duplicate ledger event).  The port's ``MeshExecutor``
    dispatches the very programs the service's admissions reuse: after
    it, a cold-by-index and a warm admission of the same shapes record
    nothing, and the whole ledger holds no duplicate.  Shapes (dim 17,
    b_max 7) are this test's alone."""
    data, test = ClassificationData.synthetic(n=200, dim=17, seed=3,
                                              spread=6.0).split(40)
    spec = ScenarioSpec(fleet=_fleet(), hidden=20, b_max=7, seeds=(0, 1))
    mark = engine.trace_count()
    Experiment(data, test, [spec], device="cpu").run(
        4, executor=MeshExecutor(chunk_periods=2))
    assert engine.trace_count() - mark == 1      # one program, one shape
    svc = ExperimentService(data, test, device="cpu", chunk_periods=2,
                            clock=VirtualClock(),
                            cache=ProgramCache(shared=False))
    with no_retrace():
        for part in ("noniid", "iid"):
            svc.submit(ScenarioSpec(fleet=_fleet(), hidden=20, b_max=7,
                                    partition=part, seeds=(4, 5)),
                       periods=4)
            svc.drain()
    assert svc.stats.cold_admissions == svc.stats.warm_admissions == 1
    assert svc.stats.new_traces == svc.stats.warm_admission_traces == 0
