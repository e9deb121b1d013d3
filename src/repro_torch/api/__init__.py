"""Declarative experiment API: specs → bucketed lowering → executor →
streaming Results (the FEEL scheme on the feel-mlp model)."""
from repro_torch.api.executor import Executor, SerialExecutor
from repro_torch.api.experiment import Experiment
from repro_torch.api.results import Results, ResultsBuilder, time_to_target
from repro_torch.api.spec import ScenarioSpec

__all__ = ["Executor", "Experiment", "Results", "ResultsBuilder",
           "ScenarioSpec", "SerialExecutor", "time_to_target"]
