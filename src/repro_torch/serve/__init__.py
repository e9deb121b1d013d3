"""Experiment-as-a-service: streaming scenario arrivals, online
bucketing, a program-cache index, and chunk-granular preemptive
scheduling (the port of the reference's ``serve`` package).

The static :class:`~repro_torch.api.Experiment` answers "run this grid";
this package answers "keep running whatever arrives".  A long-running
:class:`ExperimentService` accepts :class:`~repro_torch.api.ScenarioSpec`
requests over time and streams each request's ``Results`` back chunk by
chunk, built from three serving mechanisms layered on the lowering:

* **online bucketing** (``admission.py``) — arrivals micro-batch into
  program groups keyed on ``spec.bucket_key()`` (the structural rule the
  static lowering buckets on) within a tunable batching window;
* **program-cache index** (``program_cache.py``) — an index over every
  dispatched :func:`~repro_torch.api.lowering.program_key`; repeat bucket
  shapes admit *warm* and record zero new ``TraceEvent``s in the engine's
  ledger (test-enforced);
* **chunk-granular preemption** (``scheduler.py``) — the resumable
  :class:`~repro_torch.api.lowering.BucketRun` makes every chunk boundary
  a preemption point: hot requests take the device from long-horizon
  background runs, which later resume bitwise (suspended runs are just
  parked :class:`~repro_torch.fed.engine.EngineState`).

``stats.py`` carries the counters and latency percentiles.

Naming note: ``launch/serve.py`` is the token-decode driver for the model
zoo — unrelated to this package, which is the FEEL experiment service.
"""
from repro_torch.serve.admission import AdmissionQueue, PendingRequest
from repro_torch.serve.program_cache import ProgramCache
from repro_torch.serve.scheduler import PreemptiveScheduler, ServiceRun
from repro_torch.serve.service import ExperimentService, Ticket
from repro_torch.serve.stats import RequestRecord, ServiceStats

__all__ = ["AdmissionQueue", "ExperimentService", "PendingRequest",
           "PreemptiveScheduler", "ProgramCache", "RequestRecord",
           "ServiceRun", "ServiceStats", "Ticket"]
