"""Declarative experiment API: Study grids → bucketed lowering →
pluggable Executor runtimes → streaming Results (the four Table-II
schemes).

The spec values of the time-varying world and of the hierarchy are
exported here beside :class:`ScenarioSpec`: :class:`Sampling` and
:class:`Topology` (``repro_torch.topology``) and :class:`Fading`,
:class:`Faults`, :class:`EnergyBudget` and :class:`TauAdapt`
(``repro_torch.dynamics``)."""
from repro_torch.api.executor import (AsyncExecutor, Executor, MeshExecutor,
                                      SerialExecutor)
from repro_torch.api.experiment import Experiment
from repro_torch.api.results import Results, ResultsBuilder, time_to_target
from repro_torch.api.spec import ScenarioSpec
from repro_torch.api.study import Study, grid
from repro_torch.dynamics import EnergyBudget, Fading, Faults, TauAdapt
from repro_torch.topology import Sampling, Topology

__all__ = ["AsyncExecutor", "EnergyBudget", "Executor", "Experiment",
           "Fading", "Faults", "MeshExecutor", "Results", "ResultsBuilder",
           "Sampling", "ScenarioSpec", "SerialExecutor", "Study", "TauAdapt",
           "Topology", "grid", "time_to_target"]
