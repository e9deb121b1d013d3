"""Legacy sweep surface (the port of the reference's ``fed/sweep.py``):
``SweepCell`` containers, the seed-batched ``run_seed_batch`` building
block, and the DEPRECATED ``run_sweep`` grid driver (a thin shim over
``repro_torch.api.Experiment``).

New code should declare ``ScenarioSpec`` values and run an
``Experiment``, which lowers the whole grid into one batched device loop
per shape bucket.

    fleets = {"cpu6": [DeviceProfile(kind="cpu", f_cpu=f*1e9) for f in ...]}
    results = run_sweep(fleets, data, test,            # deprecated shim
                        policies=("proposed", "online", "full"),
                        partitions=("iid", "noniid"), seeds=range(8),
                        periods=100)
    results["cpu6/iid/proposed"].speed(0.6)   # (n_seeds,) time-to-accuracy
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from repro_torch.api.experiment import Experiment
from repro_torch.api.results import time_to_target
from repro_torch.api.spec import ScenarioSpec
from repro_torch.core import DeviceProfile
from repro_torch.data.pipeline import ClassificationData
from repro_torch.fed import engine
from repro_torch.fed.trainer import FeelSimulation, RunResult, _eval_points
from repro_torch.tree import tree_map


@dataclass(frozen=True)
class SweepCell:
    """Full per-seed trajectories of one (fleet, partition, policy) cell."""
    name: str                  # "<fleet>/<partition>/<policy>"
    fleet: str
    partition: str
    policy: str
    seeds: Sequence[int]
    losses: np.ndarray         # (n_seeds, periods)
    accs: np.ndarray           # (n_seeds, periods)
    times: np.ndarray          # (n_seeds, periods) cumulative sim seconds
    global_batch: np.ndarray   # (n_seeds, periods)

    def speed(self, target_acc: float) -> np.ndarray:
        """(n_seeds,) simulated time to reach target accuracy (inf never);
        NaN accuracies ("not evaluated this period") never count."""
        return time_to_target(self.accs, self.times, target_acc)

    @property
    def final_acc(self) -> np.ndarray:
        return self.accs[:, -1]

    def run_result(self, seed_i: int = 0, eval_every: int = 10) -> RunResult:
        """Down-convert one seed to the legacy RunResult shape."""
        periods = self.losses.shape[1]
        res = RunResult(scheme=f"feel/{self.policy}")
        for p in _eval_points(periods, eval_every):
            res.losses.append(float(self.losses[seed_i, p]))
            res.accs.append(float(self.accs[seed_i, p]))
            res.times.append(float(self.times[seed_i, p]))
            res.global_batches.append(int(self.global_batch[seed_i, p]))
        return res


def _stack(trees):
    return tree_map(lambda *leaves: torch.stack(leaves), *trees)


def run_seed_batch(sims: Sequence[FeelSimulation], periods: int):
    """Run a batch of same-shape simulations as the rows of one batched
    program (``engine.run_trajectory_batch``).

    All sims must share fleet size, ``b_max``, ``local_steps``,
    ``compress``, data and device — exactly what varying only the seed
    gives you.  Returns (losses, accs, times, global_batch) arrays, seed
    axis leading."""
    schedules = [sim.plan_run(periods) for sim in sims]
    s0 = sims[0]
    state, (losses, accs, decays) = engine.run_trajectory_batch(
        engine.EngineState(_stack([sim.params for sim in sims]),
                           _stack([sim.initial_residual() for sim in sims])),
        schedules, s0.arrays, local_steps=s0.local_steps,
        compress=s0.compress, ratio=s0.scheduler.compression)
    decays = decays.cpu().numpy()
    for i, sim in enumerate(sims):
        sim.params = tree_map(lambda a, i=i: a[i], state.params)
        sim.residuals = tree_map(lambda a, i=i: a[i], state.residual)
        sim.scheduler.observe_series(decays[i], schedules[i].global_batch)
    times = np.stack([s.times for s in schedules])
    gb = np.stack([s.global_batch for s in schedules])
    return losses.cpu().numpy(), accs.cpu().numpy(), times, gb


def run_sweep(fleets: Mapping[str, Sequence[DeviceProfile]],
              data: ClassificationData, test: ClassificationData,
              policies: Sequence[str] = ("proposed",),
              partitions: Sequence[str] = ("noniid",),
              seeds: Sequence[int] = (0,), periods: int = 100,
              b_max: int = 128, base_lr: float = 0.05,
              compress: bool = True, local_steps: int = 1,
              device=None) -> Dict[str, SweepCell]:
    """DEPRECATED grid driver — thin shim over
    ``repro_torch.api.Experiment``.  Returns the reference's
    ``{"fleet/partition/policy": SweepCell}`` mapping."""
    warnings.warn(
        "run_sweep is deprecated; use repro_torch.api.Experiment with "
        "ScenarioSpec values",
        DeprecationWarning, stacklevel=2)
    seeds = tuple(seeds)
    specs = [
        ScenarioSpec(fleet=tuple(devices), name=fleet_name, scheme="feel",
                     partition=partition, policy=policy, compress=compress,
                     b_max=b_max, base_lr=base_lr, local_steps=local_steps,
                     seeds=seeds)
        for fleet_name, devices in fleets.items()
        for partition in partitions
        for policy in policies]
    res = Experiment(data, test, specs, device=device).run(periods)
    results: Dict[str, SweepCell] = {}
    for spec in specs:
        cell = res.sel(fleet=spec.name, partition=spec.partition,
                       policy=spec.effective_policy)
        name = f"{spec.name}/{spec.partition}/{spec.policy}"
        results[name] = SweepCell(
            name=name, fleet=spec.name, partition=spec.partition,
            policy=spec.policy, seeds=seeds, losses=cell.losses,
            accs=cell.accs, times=cell.times, global_batch=cell.global_batch)
    return results
