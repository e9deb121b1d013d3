"""Admission queue + online bucketer.

Arriving :class:`~repro_torch.api.ScenarioSpec` requests micro-batch into
shape-compatible groups *online*: the admission key is exactly
``(spec.bucket_key(), periods)`` — the same structural compatibility rule
the static ``Experiment`` lowering buckets on, plus the horizon length
(rows of one program must run the same number of periods).
Compatible arrivals that land inside the **batching window** merge into
one bucket and cost one program dispatch for the whole group;
the window is the admit-now-vs-wait-for-batchmates knob:

* ``window=0`` — admit immediately (lowest queue latency, no batching);
* ``window=w`` — a group is held until its *oldest* request has waited
  ``w`` seconds (or the group reaches ``max_batch``), so a burst of
  compatible requests amortizes planning and dispatch into one program
  at the price of up to ``w`` seconds of queueing.

Time comes from the service's injected clock, so the window is exactly
testable with a :class:`repro_torch.testing.VirtualClock` (a copy of the
reference's module).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["PendingRequest", "AdmissionQueue"]


@dataclass
class PendingRequest:
    """One queued request: the ticket it answers plus its admission key
    ingredients (``spec`` frozen, ``periods`` the requested horizon).

    ``band`` is the K-band sub-bucketing width when the service runs with
    ``bands=True`` (``repro_torch.topology.band_width`` of the fleet size):
    requests only merge within their band, so a K=8 arrival never admits
    into a K=10240 neighbour's padded program.

    ``deadline`` is an optional service-clock completion target: due
    groups admit in order of *slack* (deadline minus now, tightest
    first), so an urgent late arrival overtakes deadline-less batchmates
    at the admission gate without touching the in-flight preemption
    policy.  ``None`` means no deadline — infinite slack, FIFO among
    themselves (the pre-deadline behaviour, bit-for-bit)."""
    ticket: object
    spec: object
    periods: int
    priority: int
    submitted_at: float
    seq: int                      # global submission order (FIFO ties)
    band: Optional[int] = None
    deadline: Optional[float] = None

    def slack(self, now: float) -> float:
        """Seconds until this request's deadline (+inf when none)."""
        if self.deadline is None:
            return float("inf")
        return self.deadline - now

    @property
    def group_key(self) -> tuple:
        return (self.spec.bucket_key(), self.periods, self.band)


@dataclass
class AdmissionQueue:
    """Online bucketer over the arrival stream (see module doc)."""
    window: float = 0.0
    max_batch: Optional[int] = None
    _groups: Dict[tuple, List[PendingRequest]] = field(default_factory=dict)

    def __post_init__(self):
        if self.window < 0:
            raise ValueError(f"window must be >= 0, got {self.window}")
        if self.max_batch is not None and self.max_batch < 1:
            raise ValueError(
                f"max_batch must be >= 1, got {self.max_batch}")

    @property
    def pending(self) -> int:
        return sum(len(g) for g in self._groups.values())

    def push(self, req: PendingRequest) -> None:
        self._groups.setdefault(req.group_key, []).append(req)

    def _due(self, group: List[PendingRequest], now: float) -> bool:
        if self.max_batch is not None and len(group) >= self.max_batch:
            return True
        return now - group[0].submitted_at >= self.window

    def pop_due(self, now: float,
                flush: bool = False) -> List[List[PendingRequest]]:
        """Remove and return every micro-batch due for admission at
        ``now`` (``flush=True`` ignores the window — drain semantics),
        ordered deadline-aware: micro-batches sort by their tightest
        member's slack (``PendingRequest.slack``), then by oldest member
        — so with no deadlines anywhere the order is exactly the old
        FIFO (every slack is +inf and the seq tiebreak decides).

        ``max_batch`` bounds the micro-batch *size*, not just the
        trigger: a due group larger than ``max_batch`` is sliced into
        consecutive ``max_batch``-sized admissions (submission order),
        which keeps program batch shapes small and *recurring* —
        the repeat-shape property the program cache wins on.  When a
        group reached ``max_batch`` before its window expired, only the
        full slices admit; the remainder keeps waiting for batchmates.
        """
        batches: List[List[PendingRequest]] = []
        for key in list(self._groups):
            group = self._groups[key]
            if flush or self._due(group, now):
                window_due = flush or \
                    now - group[0].submitted_at >= self.window
                cap = self.max_batch or len(group)
                while len(group) >= cap and group:
                    batches.append(group[:cap])
                    group = group[cap:]
                if group and window_due:
                    batches.append(group)
                    group = []
                if group:
                    self._groups[key] = group
                else:
                    del self._groups[key]
        batches.sort(key=lambda g: (min(r.slack(now) for r in g),
                                    g[0].seq))
        return batches

    def next_due_at(self) -> Optional[float]:
        """The earliest service-clock time any queued group becomes due
        by window expiry (``None`` when the queue is empty).  Lets a
        driver with a virtual clock jump straight to the next admission
        instead of polling."""
        if not self._groups:
            return None
        return min(g[0].submitted_at + self.window
                   for g in self._groups.values())
