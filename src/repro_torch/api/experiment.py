"""The declarative experiment driver: specs in, named Results out.

    from repro_torch.api import Experiment, ScenarioSpec

    specs = [ScenarioSpec(fleet=fleet, name="cpu6", partition=p,
                          seeds=range(8)) for p in ("iid", "noniid")]
    res = Experiment(data, test, specs).run(periods=100)
    res.sel(partition="noniid").speed(0.6)

``run`` lowers the whole grid through ``api.lowering``: rows (spec ×
seed) are deduplicated and grouped into shape-compatible buckets, each
running as ONE batched device loop over its (scenario × seed) rows.
``stream`` yields cumulative partial ``Results`` as each bucket
collects.

The experiment runs on the GPU: ``device=None`` resolves to ``"cuda"``
and raises when CUDA is not available.  Pass ``device="cpu"`` to run the
port's CPU path (the plain versions of the kernels).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.api.executor import Executor, SerialExecutor
from repro_torch.api.lowering import Bucket, DeviceData, group_rows
from repro_torch.api.results import (Results, ResultsBuilder,
                                     assign_row_coords, empty_coords)
from repro_torch.api.spec import ScenarioSpec
from repro_torch.data.pipeline import ClassificationData


def resolve_device(device=None) -> torch.device:
    """``None`` → the GPU, raising when CUDA is not available."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "port's CPU path")
        device = "cuda"
    return torch.device(device)


@dataclass
class Experiment:
    """A family of scenarios over one dataset, lowered bucket by bucket."""
    data: ClassificationData
    test: ClassificationData
    specs: Sequence[ScenarioSpec]
    device: Optional[object] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def lower(self) -> List[Bucket]:
        """The bucketed row plan: which rows share a device loop, in
        execution order."""
        return group_rows(self.specs)

    def run(self, periods: int,
            executor: Optional[Executor] = None) -> Results:
        """Run the whole grid and return the complete ``Results``."""
        builder = None
        for builder in self._collected(periods, executor):
            pass
        return builder.build()

    def stream(self, periods: int, executor: Optional[Executor] = None
               ) -> Iterator[Results]:
        """Yield a cumulative partial ``Results`` after each bucket
        collection (the final yield is the complete result)."""
        for builder in self._collected(periods, executor):
            yield builder.partial()

    def _collected(self, periods: int, executor: Optional[Executor]
                   ) -> Iterator[ResultsBuilder]:
        buckets = self.lower()
        if not buckets:
            raise ValueError("Experiment has no specs")
        if executor is None:
            executor = SerialExecutor()
        arrays = DeviceData(self.data, self.test, self.device)
        builder = ResultsBuilder(coords=self._coords(buckets),
                                 n_rows=self._n_rows(buckets),
                                 n_buckets=len(buckets))
        for bucket, (bl, ba, bt, bg) in executor.execute(
                buckets, self.data, arrays, periods):
            idx = np.array([i for row in bucket.rows
                            for i in row.indices], np.int64)
            take = np.array([j for j, row in enumerate(bucket.rows)
                             for _ in row.indices], np.int64)
            builder.add_rows(idx, bl[take], ba[take], bt[take], bg[take])
            yield builder

    @staticmethod
    def _n_rows(buckets: Sequence[Bucket]) -> int:
        return sum(len(r.indices) for b in buckets for r in b.rows)

    def _coords(self, buckets: Sequence[Bucket]):
        coords = empty_coords(self._n_rows(buckets))
        for bucket in buckets:
            for row in bucket.rows:
                for i in row.indices:
                    assign_row_coords(coords, i, row.spec, row.seed)
        return coords
