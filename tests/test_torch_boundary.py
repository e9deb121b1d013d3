"""The PyTorch port's boundaries: it imports neither jax nor any module of
the JAX reference package, its spec rejects what later slices bring, and
its entry point runs on the GPU unless the caller asks for the CPU."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.api import Experiment, ScenarioSpec
from repro_torch.core.latency import DeviceProfile
from repro_torch.data.pipeline import ClassificationData

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b|from\s+repro\b)",
    re.MULTILINE)


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
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
"""
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"}).stdout.split(" ", 1)
    assert int(out[0]) >= 46, out
    assert out[1].strip() == "[]", out


def test_port_sources_and_chip_smoke_name_no_jax_and_no_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "kernel_ab.py"]
    assert len(files) > 20
    offenders = [(str(f.relative_to(ROOT)), m.group(0).strip())
                 for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert offenders == []


def _fleet(k=3):
    return tuple(DeviceProfile(kind="cpu", f_cpu=f * 1e9)
                 for f in [0.7, 1.4, 2.1][:k])


@pytest.mark.parametrize("field,value", [
    ("scheme", "model_fl"), ("scheme", "individual"),
    ("scheme", "gradient_fl"), ("local_steps", 2), ("replan", 5),
    ("sampling", object()), ("topology", object()), ("fading", object()),
    ("faults", object()), ("energy", object()), ("adapt_tau", object())])
def test_spec_rejects_what_later_slices_bring(field, value):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        ScenarioSpec(fleet=_fleet(), **{field: value})


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
