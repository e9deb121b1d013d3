"""The experiment service: streaming scenario arrivals in, chunked
results out.

:class:`ExperimentService` is the long-running counterpart of the static
:class:`~repro_torch.api.Experiment`: instead of a grid known up front,
it accepts :class:`~repro_torch.api.ScenarioSpec` requests *over time*
(:meth:`submit` → :class:`Ticket`) and streams each request's results
back chunk by chunk.  The moving parts, each its own module:

* :class:`~repro_torch.serve.admission.AdmissionQueue` — online
  bucketing: compatible arrivals (same ``bucket_key`` + horizon) inside
  the batching window merge into one program micro-batch;
* :class:`~repro_torch.serve.program_cache.ProgramCache` — the index of
  dispatched program keys: admissions whose every chunk program was
  dispatched before are *warm* and must record zero new ``TraceEvent``s
  in the engine's ledger (test-enforced);
* :class:`~repro_torch.serve.scheduler.PreemptiveScheduler` —
  chunk-granular preemption over the resumable
  :class:`~repro_torch.api.lowering.BucketRun`: a long horizon parks at a
  chunk boundary when a hotter request arrives and later resumes
  bitwise (suspended runs are just parked state);
* :class:`~repro_torch.serve.stats.ServiceStats` — counters and latency
  percentiles.

The service is single-threaded and *step-driven*: :meth:`step` performs
due admissions and runs at most one chunk of the hottest active run.
Time comes from an injected clock (``repro_torch.testing.VirtualClock`` /
``WallClock``), so tests drive arrival tapes and measure latency without
a single ``time.sleep``.  It runs on the GPU unless built with
``device="cpu"``; the dataset is uploaded once, as one
:class:`~repro_torch.api.lowering.DeviceData` every admission shares.
Drive it like::

    svc = ExperimentService(data, test, chunk_periods=2, window=0.01)
    t = svc.submit(spec, periods=40)          # returns immediately
    while not t.done:
        svc.step()                            # admit + one chunk
        view = t.partial()                    # complete=False Results
    final = t.result()                        # bitwise the Experiment
                                              # twin of its admission

Not the token-decode driver: ``launch/serve.py`` serves token decoding
for the model-zoo side of the repo; this package is the FEEL experiment
service.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.api import lowering
from repro_torch.api.executor import _check_mesh
from repro_torch.api.experiment import resolve_device
from repro_torch.api.results import Results, assign_row_coords, empty_coords
from repro_torch.api.spec import ScenarioSpec
from repro_torch.fed import engine
from repro_torch.launch.mesh import canonical_device, pad_batch
from repro_torch.serve.admission import AdmissionQueue, PendingRequest
from repro_torch.serve.program_cache import ProgramCache
from repro_torch.serve.scheduler import PreemptiveScheduler, ServiceRun
from repro_torch.serve.stats import RequestRecord, ServiceStats
from repro_torch.testing.clock import WallClock
from repro_torch.topology import band_width

__all__ = ["ExperimentService", "Ticket"]


class Ticket:
    """One submitted request's streaming result surface.

    The service delivers results chunk by chunk as the scheduler runs the
    request's bucket; :meth:`partial` exposes everything delivered so far
    as a ``complete=False`` :class:`~repro_torch.api.results.Results` view
    (the same named-coordinate surface the static API returns — ``sel`` /
    ``speed`` / ``final_acc`` all work mid-stream), and :meth:`result`
    returns the complete view once :attr:`done`.
    """

    def __init__(self, spec: ScenarioSpec, periods: int, priority: int,
                 record: RequestRecord):
        self.spec = spec
        self.periods = periods
        self.priority = priority
        self.record = record
        self.n_rows = len(spec.seeds)
        self._coords = empty_coords(self.n_rows)
        for i, seed in enumerate(spec.seeds):
            assign_row_coords(self._coords, i, spec, seed)
        self._chunks: List[tuple] = []
        self.collected = 0

    @property
    def done(self) -> bool:
        return self.collected >= self.periods

    @property
    def admitted(self) -> bool:
        return self.record.admitted_at is not None

    def _deliver(self, chunk: tuple, p_c: int) -> None:
        self._chunks.append(chunk)
        self.collected += p_c

    def _series(self) -> tuple:
        if not self._chunks:
            z = np.zeros((self.n_rows, 0))
            return z, z, z.astype(np.float64), z.astype(np.int64)
        return tuple(np.concatenate([c[j] for c in self._chunks], axis=1)
                     for j in range(4))

    def partial(self) -> Results:
        """Everything delivered so far (``complete`` flips once the full
        horizon has streamed in; before that, a zero-period view is a
        legitimate selection surface, never an error)."""
        losses, accs, times, gb = self._series()
        return Results(coords=self._coords, losses=losses, accs=accs,
                       times=times, global_batch=gb, n_buckets=1,
                       complete=self.done)

    def result(self) -> Results:
        """The complete per-request ``Results``; raises while chunks are
        still outstanding."""
        if not self.done:
            raise RuntimeError(
                f"request not complete: {self.collected} of "
                f"{self.periods} periods delivered")
        return self.partial()


class ExperimentService:
    """Long-running FEEL experiment service (see module docstring).

    ``chunk_periods`` is the scheduling granularity: horizons execute as
    resumable chunks of this many periods (closed-loop ``replan=`` specs
    chunk at their replan interval instead, exactly like the static
    executors), and every chunk boundary is a preemption point.
    ``window`` / ``max_batch`` tune the admission micro-batcher.
    ``bands=True`` sub-buckets admissions by power-of-two K band
    (``repro_torch.topology.band_width``): requests pad to their band
    instead of whatever fleet happens to share the window, so the
    program-cache key space stays small and recurring across a
    massive-fleet mix.  ``mesh`` is a batch mesh for ``device``
    (``api.executor``'s rule: one device, the service's own and the
    default, or several of its type): an admission's rows are padded
    cyclically to a multiple of the mesh and sharded over it, and its
    program keys name the mesh's devices and the padded row count.
    ``audit=True`` runs the static passes (padding taint + graph
    hygiene, :mod:`repro_torch.analysis`) over every cold admission's
    program before it dispatches — a probe only: no device work and no
    dispatch-ledger event — and keeps their findings in
    :attr:`audit_report`; warm admissions skip the probe.
    Error findings raise :class:`repro_torch.analysis.AuditError` before
    the admission dispatches.
    """

    def __init__(self, data, test, *, device=None, chunk_periods: int = 1,
                 window: float = 0.0, max_batch: Optional[int] = None,
                 clock=None, cache: Optional[ProgramCache] = None,
                 mesh=None, audit: bool = False, bands: bool = False):
        if chunk_periods < 1:
            raise ValueError(
                f"chunk_periods must be >= 1, got {chunk_periods}")
        self.data = data
        self.test = test
        self.device = resolve_device(device)
        self.arrays = lowering.DeviceData(data, test, self.device)
        self.chunk_periods = chunk_periods
        self.clock = clock if clock is not None else WallClock()
        self.cache = cache if cache is not None else ProgramCache()
        self.mesh = _check_mesh(lowering.one_device_mesh(self.arrays)
                                if mesh is None else mesh, self.device)
        self.bands = bands
        self.audit = audit
        self.audit_report = None
        self.stats = ServiceStats()
        self._admission = AdmissionQueue(window=window, max_batch=max_batch)
        self._scheduler = PreemptiveScheduler(stats=self.stats)
        self._seq = 0

    # ---- request surface --------------------------------------------------
    def submit(self, spec: ScenarioSpec, periods: int,
               priority: int = 0,
               deadline: Optional[float] = None) -> Ticket:
        """Enqueue one scenario request; returns its :class:`Ticket`
        immediately (admission happens on a later :meth:`step`, once the
        batching window admits the request's group).  Lower ``priority``
        numbers are hotter — they take the next chunk slot from any
        cooler run already in flight.  ``deadline`` (service-clock
        seconds) makes admission deadline-aware: due groups admit
        tightest-slack first instead of FIFO."""
        if not isinstance(spec, ScenarioSpec):
            raise TypeError(f"submit expects a ScenarioSpec, got "
                            f"{type(spec).__name__}")
        if periods < 1:
            raise ValueError(f"periods must be >= 1, got {periods}")
        if spec.adapt_tau is not None:
            raise ValueError(
                "adaptive local steps (adapt_tau=) compile one program "
                "variant per realized τ, so the admission-time program "
                "key is undecidable; the serving layer rejects such specs")
        now = self.clock.now()
        record = RequestRecord(
            ticket_id=self._seq, label=spec.label, periods=periods,
            priority=priority, submitted_at=now)
        ticket = Ticket(spec, periods, priority, record)
        self.stats.on_submit(record)
        self._admission.push(PendingRequest(
            ticket=ticket, spec=spec, periods=periods, priority=priority,
            submitted_at=now, seq=self._seq,
            band=band_width(spec.k) if self.bands else None,
            deadline=deadline))
        self._seq += 1
        return ticket

    def reset_stats(self) -> ServiceStats:
        """Start a fresh measurement window (e.g. after a warm-up phase):
        replaces :attr:`stats` with a zeroed :class:`ServiceStats`.  The
        program cache, admission queue and active runs are untouched —
        only the counters and latency records restart."""
        self.stats = ServiceStats()
        self._scheduler.stats = self.stats
        return self.stats

    # ---- service loop -----------------------------------------------------
    @property
    def idle(self) -> bool:
        """No queued arrivals and no admitted run with work left."""
        return (self._admission.pending == 0
                and not any(not r.done for r in self._scheduler.active))

    def next_admission_at(self) -> Optional[float]:
        """Earliest clock time a queued group becomes window-due (lets a
        virtual-clock driver jump straight there)."""
        return self._admission.next_due_at()

    def step(self, flush: bool = False) -> bool:
        """One service-loop turn: perform due admissions, then run one
        chunk of the hottest active run.  Returns whether any work
        happened (``False`` = idle at the current clock time).
        ``flush=True`` admits every queued group regardless of the
        batching window (drain semantics)."""
        admitted = self._admit_due(flush=flush)
        return self._run_one_chunk() or admitted

    def drain(self) -> None:
        """Flush the admission queue and run until every ticket is done."""
        while not self.idle:
            self.step(flush=True)

    # ---- internals --------------------------------------------------------
    def _admit_due(self, flush: bool) -> bool:
        groups = self._admission.pop_due(self.clock.now(), flush=flush)
        for group in groups:
            self._admit(group)
        return bool(groups)

    def _admit(self, group: List[PendingRequest]) -> None:
        now = self.clock.now()
        buckets = lowering.group_rows([r.spec for r in group],
                                      bands=self.bands)
        assert len(buckets) == 1, "admission groups on bucket_key"
        bucket = buckets[0]
        chunk = (bucket.replan if bucket.replan is not None
                 else self.chunk_periods)
        periods = group[0].periods
        # rows dispatch padded to the mesh (the reference's n_exec); a key
        # carries the devices the shards run on (a program warm on one
        # device is cold on another)
        n = len(bucket.rows)
        where = tuple(str(canonical_device(d)) for d in self.mesh.devices)
        keys = [where + key for key in
                lowering.bucket_program_keys(bucket,
                                             n + pad_batch(n, self.mesh),
                                             periods, chunk, self.data,
                                             self.test)]
        hits, misses = self.cache.admit(keys)
        self.stats.on_admission([r.ticket.record for r in group], now,
                                hits=hits, misses=misses)
        if self.audit and misses:
            self._audit_cold(bucket, min(chunk, periods))
        run = lowering.BucketRun(bucket, self.data, periods, chunk,
                                 self.arrays, mesh=self.mesh)
        srun = ServiceRun(
            run=run, requests=list(group),
            priority=min(r.priority for r in group),
            seq=min(r.seq for r in group), warm=(misses == 0),
            trace_mark=engine.trace_count())
        # fan-out map: output index -> computed row, then one take per
        # request in its local row order (group_rows flattens the group's
        # specs x seeds in submission order)
        computed_of = {}
        for j, row in enumerate(bucket.rows):
            for i in row.indices:
                computed_of[i] = j
        offset = 0
        for req in group:
            take = np.array([computed_of[offset + l]
                             for l in range(len(req.spec.seeds))], np.int64)
            srun.deliveries.append((req.ticket, take))
            offset += len(req.spec.seeds)
        self._scheduler.add(srun)

    def _audit_cold(self, bucket, chunk_len: int) -> None:
        """The static passes over a cold admission's program (padding
        taint + graph hygiene; a probe only — no device work, no ledger
        event).  Error findings raise before anything dispatches."""
        from repro_torch.analysis.report import AuditReport
        if self.audit_report is None:
            self.audit_report = AuditReport()
        plan = lowering.plan_bucket(bucket, self.data, chunk_len)
        lowering.audit_bucket_taint(plan, self.data, self.test,
                                    self.audit_report)
        self.audit_report.raise_on_error()

    def _run_one_chunk(self) -> bool:
        srun = self._scheduler.pick()
        if srun is None:
            return False
        mark = engine.trace_count()
        if srun.run.can_advance:
            srun.run.advance()
        p_before = srun.run.collected
        chunk = srun.run.collect()
        p_c = srun.run.collected - p_before
        now = self.clock.now()
        records = [r.ticket.record for r in srun.requests]
        self.stats.on_chunk(records, now,
                            traces=engine.trace_count() - mark,
                            warm=srun.warm)
        for ticket, take in srun.deliveries:
            ticket._deliver(tuple(arr[take] for arr in chunk), p_c)
        if srun.done:
            self.stats.on_complete(records, now)
            self._scheduler.remove(srun)
        return True
