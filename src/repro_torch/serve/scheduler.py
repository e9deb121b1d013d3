"""Chunk-granular preemptive scheduling over parked :class:`BucketRun`s.

Every horizon runs as a resumable chunked loop with an explicit engine
carry, so a *suspended run is just parked state*: nothing holds the
device between chunks, and the scheduler is free to hand the next chunk
slot to whichever admitted run is hottest.  Preemption therefore costs
nothing semantically (chunked execution is interleaving-invariant; a
preempted-then-resumed run is bitwise its uninterrupted twin,
test-enforced) — the policy here only decides *latency*: a long-horizon
background run yields at its next chunk boundary when a hot request
arrives, instead of holding the device for its whole horizon.

Policy: strict priority (lower number = hotter), FIFO admission order
within a priority level, one chunk per scheduling decision.  A switch
away from an unfinished run counts as a **preemption** (the run is
parked — its in-flight chunks collected and the device fenced via
:meth:`~repro_torch.api.lowering.BucketRun.park`); scheduling a
previously parked run again counts as a **resume**.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.api.lowering import BucketRun

__all__ = ["ServiceRun", "PreemptiveScheduler"]


@dataclass
class ServiceRun:
    """One admitted micro-batch in flight: the resumable
    :class:`~repro_torch.api.lowering.BucketRun` plus its service
    metadata.

    ``requests`` are the admitted :class:`PendingRequest`s in submission
    order; ``deliveries`` holds one ``(ticket, take)`` pair per request —
    ``take`` the computed-row indices, in the ticket's local row order,
    that fan each collected chunk back out to the tickets that asked for
    it (duplicate (spec, seed) pairs across concurrent requests share one
    computed row, exactly like the static ``Experiment`` dedup).
    """
    run: BucketRun
    requests: list
    priority: int
    seq: int                       # admission order (FIFO ties)
    warm: bool                     # every program key was cache-warm
    deliveries: List[tuple] = field(default_factory=list)
    trace_mark: int = 0            # engine ledger length at admission
    parked: bool = False

    @property
    def done(self) -> bool:
        return self.run.done


class PreemptiveScheduler:
    """Priority/FIFO chunk scheduler with preemption accounting."""

    def __init__(self, stats=None):
        self._active: List[ServiceRun] = []
        self._current: Optional[ServiceRun] = None
        self.stats = stats

    @property
    def active(self) -> tuple:
        return tuple(self._active)

    @property
    def current(self) -> Optional[ServiceRun]:
        return self._current

    def add(self, run: ServiceRun) -> None:
        self._active.append(run)

    def pick(self) -> Optional[ServiceRun]:
        """Choose the run that gets the next chunk slot; accounts the
        preemption/resume transitions this choice implies."""
        if not self._active:
            self._current = None
            return None
        chosen = min(self._active, key=lambda r: (r.priority, r.seq))
        prev = self._current
        if prev is not None and prev is not chosen and not prev.done:
            # a hotter run takes the slot: park the incumbent at its
            # chunk boundary (fences in-flight device work; the banked
            # chunks were already streamed at collect time)
            prev.run.park()
            prev.parked = True
            if self.stats is not None:
                self.stats.preemptions += 1
        if chosen.parked:
            chosen.parked = False
            if self.stats is not None:
                self.stats.resumes += 1
        self._current = chosen
        return chosen

    def remove(self, run: ServiceRun) -> None:
        self._active.remove(run)
        if self._current is run:
            self._current = None
