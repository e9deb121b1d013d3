"""Declarative experiment API: Study grids → bucketed lowering →
pluggable Executor runtimes → streaming Results (the FEEL scheme)."""
from repro_torch.api.executor import (AsyncExecutor, Executor, MeshExecutor,
                                      SerialExecutor)
from repro_torch.api.experiment import Experiment
from repro_torch.api.results import Results, ResultsBuilder, time_to_target
from repro_torch.api.spec import ScenarioSpec
from repro_torch.api.study import Study, grid

__all__ = ["AsyncExecutor", "Executor", "Experiment", "MeshExecutor",
           "Results", "ResultsBuilder", "ScenarioSpec", "SerialExecutor",
           "Study", "grid", "time_to_target"]
