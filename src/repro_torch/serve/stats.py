"""Service observability: counters, latency records, percentiles.

One :class:`ServiceStats` per
:class:`~repro_torch.serve.ExperimentService`.  Everything here is plain
host bookkeeping — no device work — and ``to_dict()`` is the JSON
surface of the reference's ``BENCH_serve.json`` schema (a copy of the
reference's module).

Latency conventions (all in service-clock seconds, whatever clock the
service was built with):

* **queue latency** — submit → admission (the online bucketer's
  admit-now-vs-wait-for-batchmates cost);
* **first-result latency** — submit → first chunk of results delivered
  (the streaming surface's time-to-first-byte);
* **result latency** — submit → final chunk delivered (what the p50/p99
  acceptance numbers are computed over).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

__all__ = ["RequestRecord", "ServiceStats"]


@dataclass
class RequestRecord:
    """Lifecycle timestamps of one submitted request (``None`` until the
    corresponding transition happens)."""
    ticket_id: int
    label: str
    periods: int
    priority: int
    submitted_at: float
    admitted_at: Optional[float] = None
    first_result_at: Optional[float] = None
    completed_at: Optional[float] = None

    @property
    def queue_latency(self) -> Optional[float]:
        if self.admitted_at is None:
            return None
        return self.admitted_at - self.submitted_at

    @property
    def first_result_latency(self) -> Optional[float]:
        if self.first_result_at is None:
            return None
        return self.first_result_at - self.submitted_at

    @property
    def result_latency(self) -> Optional[float]:
        if self.completed_at is None:
            return None
        return self.completed_at - self.submitted_at


@dataclass
class ServiceStats:
    """Counters + request records for one service instance."""
    submitted: int = 0
    admitted_requests: int = 0
    admissions: int = 0            # admitted buckets (micro-batches)
    completed: int = 0
    chunks: int = 0                # chunk dispatch+collect cycles run
    preemptions: int = 0           # scheduler switched off an unfinished run
    resumes: int = 0               # a previously-parked run ran again
    cache_hits: int = 0            # program keys admitted already warm
    cache_misses: int = 0          # program keys admitted cold
    warm_admissions: int = 0       # admissions with every program key warm
    cold_admissions: int = 0
    new_traces: int = 0            # TraceEvents recorded across all chunks
    warm_admission_traces: int = 0  # ledger entries charged to warm
    #                                 admissions — the zero-retrace contract
    records: List[RequestRecord] = field(default_factory=list)

    # ---- transitions ------------------------------------------------------
    def on_submit(self, record: RequestRecord) -> None:
        self.submitted += 1
        self.records.append(record)

    def on_admission(self, records, now: float, *, hits: int,
                     misses: int) -> None:
        self.admissions += 1
        self.admitted_requests += len(records)
        self.cache_hits += hits
        self.cache_misses += misses
        if misses == 0:
            self.warm_admissions += 1
        else:
            self.cold_admissions += 1
        for r in records:
            r.admitted_at = now

    def on_chunk(self, records, now: float, *, traces: int,
                 warm: bool) -> None:
        self.chunks += 1
        self.new_traces += traces
        if warm:
            self.warm_admission_traces += traces
        for r in records:
            if r.first_result_at is None:
                r.first_result_at = now

    def on_complete(self, records, now: float) -> None:
        for r in records:
            r.completed_at = now
            self.completed += 1

    # ---- derived ----------------------------------------------------------
    @property
    def cache_hit_rate(self) -> float:
        """Warm fraction of all program keys admitted (0.0 when none)."""
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    def latencies(self, kind: str = "result") -> np.ndarray:
        """Finished ``kind`` latencies (seconds), submission order.
        ``kind``: ``result`` | ``first_result`` | ``queue``."""
        attr = f"{kind}_latency"
        vals = [getattr(r, attr) for r in self.records]
        return np.array([v for v in vals if v is not None], np.float64)

    def percentiles(self, qs=(50.0, 99.0), kind: str = "result") -> Dict:
        lat = self.latencies(kind)
        if not len(lat):
            return {f"p{q:g}": None for q in qs}
        return {f"p{q:g}": float(np.percentile(lat, q)) for q in qs}

    def to_dict(self) -> Dict:
        """The JSON-ready summary (the ``BENCH_serve.json`` schema)."""
        return {
            "submitted": self.submitted,
            "admitted_requests": self.admitted_requests,
            "admissions": self.admissions,
            "completed": self.completed,
            "chunks": self.chunks,
            "preemptions": self.preemptions,
            "resumes": self.resumes,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "cache_hit_rate": self.cache_hit_rate,
            "warm_admissions": self.warm_admissions,
            "cold_admissions": self.cold_admissions,
            "new_traces": self.new_traces,
            "warm_admission_traces": self.warm_admission_traces,
            "latency": self.percentiles((50.0, 90.0, 99.0)),
            "first_result_latency":
                self.percentiles((50.0, 99.0), kind="first_result"),
            "queue_latency": self.percentiles((50.0, 99.0), kind="queue"),
        }
