"""Declarative experiment API: Study grids → bucketed lowering →
pluggable Executor runtimes → streaming Results (the FEEL scheme).

The time-varying world's spec values are exported here beside
:class:`ScenarioSpec`: :class:`Sampling` (``repro_torch.topology``) and
:class:`Fading`, :class:`Faults`, :class:`EnergyBudget`
(``repro_torch.dynamics``)."""
from repro_torch.api.executor import (AsyncExecutor, Executor, MeshExecutor,
                                      SerialExecutor)
from repro_torch.api.experiment import Experiment
from repro_torch.api.results import Results, ResultsBuilder, time_to_target
from repro_torch.api.spec import ScenarioSpec
from repro_torch.api.study import Study, grid
from repro_torch.dynamics import EnergyBudget, Fading, Faults
from repro_torch.topology import Sampling

__all__ = ["AsyncExecutor", "EnergyBudget", "Executor", "Experiment",
           "Fading", "Faults", "MeshExecutor", "Results", "ResultsBuilder",
           "Sampling", "ScenarioSpec", "SerialExecutor", "Study", "grid",
           "time_to_target"]
