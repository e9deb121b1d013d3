"""The declarative experiment driver: specs in, named Results out.

    from repro_torch.api import AsyncExecutor, Experiment, ScenarioSpec, grid

    study = grid(ScenarioSpec(fleet=fleet, name="cpu6", seeds=range(8)),
                 policy=("proposed", "online", "full"),
                 **{"cell.radius_m": [100.0, 200.0, 400.0]})
    res = Experiment(data, test, study).run(periods=100,
                                            executor=AsyncExecutor())
    res.sel(policy="proposed", cell_radius_m=200.0).speed(0.6)

``run`` lowers the whole grid through ``api.lowering``: rows (spec ×
seed) are deduplicated and grouped into shape-compatible buckets, each
running as ONE batched device loop over its (scenario × seed) rows.
*How* buckets are scheduled is the executor's policy (``api.executor``):
serial, pipelined or on a one-device mesh, all bitwise equal in results.
``stream`` yields cumulative partial ``Results`` as each bucket
collects.  ``specs`` may be a :class:`~repro_torch.api.study.Study`: its
swept axes then surface as extra ``Results`` coordinates.  ``replan=R``
closes the Algorithm-1 loop for every FEEL bucket of a run: R-period
chunks, each chunk's realized loss decays fed to the ξ estimators before
the next is planned.  ``audit=True`` adds the static analysis' report
(``Results.audit``).

The experiment runs on the GPU: ``device=None`` resolves to ``"cuda"``
and raises when CUDA is not available.  Pass ``device="cpu"`` to run the
port's CPU path (the plain versions of the kernels).
"""
from __future__ import annotations

from dataclasses import dataclass
from dataclasses import replace as _dc_replace
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.api.executor import Executor, SerialExecutor
from repro_torch.api.lowering import Bucket, DeviceData, group_rows
from repro_torch.api.results import (COORD_NAMES, Results, ResultsBuilder,
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

    def lower(self, replan: Optional[int] = None,
              bands: bool = False) -> List[Bucket]:
        """The bucketed row plan: which rows share a device loop, in
        execution order.  ``replan`` applies the run-level closed-loop
        override and ``bands`` the power-of-two K-band sub-bucketing (see
        :meth:`run`)."""
        return group_rows(self.specs, replan=replan, bands=bands)

    def run(self, periods: int, executor: Optional[Executor] = None,
            replan: Optional[int] = None, audit: bool = False,
            bands: bool = False) -> Results:
        """Run the whole grid and return the complete ``Results``.

        ``replan=R`` turns every FEEL-family bucket closed-loop for this
        run, overriding any ``ScenarioSpec.replan``: horizons run as
        R-period chunks and each chunk's realized loss decays update the
        ξ estimators before the next chunk is planned (Algorithm 1 with
        live feedback).  Dev-scheme buckets have no ξ loop and ignore it.

        ``audit=True`` runs the static-analysis passes after the
        computation (see :mod:`repro_torch.analysis`): the padding-taint
        certificate and graph-hygiene checks over every bucket's program
        (traced by ``lowering.trace_bucket`` under fake tensors — no
        device work and no dispatch-ledger event, but host planning runs
        once more per bucket), the determinism lint, and a dispatch-ledger
        audit scoped to this run proving zero retraces across chunks and
        replan rounds.  The run itself is the normal run, on the card
        through its kernels.  The report attaches as ``Results.audit``;
        error-severity findings raise
        :class:`repro_torch.analysis.AuditError`.  Audit composes with any
        executor — the passes inspect programs and ledgers, not the
        execution schedule.

        ``bands=True`` splits each bucket by power-of-two K band
        (``repro_torch.topology.band_width``), so a mixed-K grid pads each
        row to its band instead of the grid's largest fleet: one device
        loop per band, host ledgers bitwise the unbanded run's."""
        if audit:
            from repro_torch.fed import engine
            mark = len(engine.trace_events())
        builder = None
        for builder in self._collected(periods, executor, replan, bands):
            pass
        res = builder.build()
        if audit:
            report = self._audit(periods, replan, mark, bands=bands)
            res = _dc_replace(res, audit=report)
            report.raise_on_error()
        return res

    def _audit(self, periods: int, replan: Optional[int], mark: int,
               bands: bool = False):
        """The ``run(audit=True)`` pass bundle (see
        :mod:`repro_torch.analysis`)."""
        from repro_torch.analysis import compile_audit, determinism
        from repro_torch.analysis.report import AuditReport
        from repro_torch.api import lowering
        from repro_torch.fed import engine

        report = AuditReport()
        compile_audit.audit_traces(engine.trace_events()[mark:],
                                   label="trace-ledger", report=report)
        for bucket in self.lower(replan=replan, bands=bands):
            plan = lowering.plan_bucket(bucket, self.data, periods)
            lowering.audit_bucket_taint(plan, self.data, self.test, report)
        determinism.lint_sources(report=report)
        return report

    def stream(self, periods: int, executor: Optional[Executor] = None,
               replan: Optional[int] = None,
               bands: bool = False) -> Iterator[Results]:
        """Yield a cumulative partial ``Results`` after each bucket
        collection (the final yield is the complete result)."""
        for builder in self._collected(periods, executor, replan, bands):
            yield builder.partial()

    def _collected(self, periods: int, executor: Optional[Executor],
                   replan: Optional[int] = None,
                   bands: bool = False) -> Iterator[ResultsBuilder]:
        buckets = self.lower(replan=replan, bands=bands)
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
        """Per-output-row coordinate columns: the standard labels plus, for
        Study specs, one column per swept axis (``axis_coords``)."""
        n_rows = self._n_rows(buckets)
        axis_coords = getattr(self.specs, "axis_coords", None)
        extra = [n for n in getattr(self.specs, "coord_names", ())
                 if n not in COORD_NAMES] if axis_coords else []
        coords = empty_coords(n_rows, extra=extra)
        for bucket in buckets:
            for row in bucket.rows:
                axes = axis_coords(row.spec) if axis_coords else {}
                for i in row.indices:
                    assign_row_coords(coords, i, row.spec, row.seed)
                    for name in extra:
                        if name in axes:
                            coords[name][i] = axes[name]
        return coords
