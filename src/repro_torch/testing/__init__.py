"""Test-support utilities shipped with the port (copies of the
reference's ``repro.testing``, reading the port's ledger).

``repro_torch.testing.proptest`` provides the property-testing surface:
the real ``hypothesis`` package when it is installed, or a minimal
API-compatible fallback driver when it is not.

``repro_torch.testing.no_retrace`` is the dispatch-discipline guard: a
context manager asserting exactly how many first dispatches
(``repro_torch.fed.engine.TraceEvent``) a block may record (default
zero).

``repro_torch.testing.clock`` / ``repro_torch.testing.arrivals`` are the
serving layer's determinism fixtures: a manually-advanced
:class:`VirtualClock` (service tests never ``time.sleep``) and seeded
Poisson/burst arrival-process generators.
"""
from __future__ import annotations

import contextlib

from repro_torch.fed import engine
from repro_torch.testing.arrivals import (assign_templates, burst_arrivals,
                                          poisson_arrivals)
from repro_torch.testing.clock import VirtualClock, WallClock

__all__ = ["VirtualClock", "WallClock", "assign_templates",
           "burst_arrivals", "no_retrace", "poisson_arrivals"]


@contextlib.contextmanager
def no_retrace(expect: int = 0):
    """Assert the block records exactly ``expect`` ledger events.

    ``expect=0`` (the default) guards warm paths — chunked resumption,
    replan rounds, warm admissions — where any event is a program
    dispatched at a signature it had already run as if new.  ``expect=n``
    pins a cold path's budget.  On top of the count, the whole process's
    ledger is checked for duplicate (kind, key, signature) events, which
    the count alone can miss when one legitimate cold event masks one
    duplicate.

    Usage::

        with no_retrace():            # warm path: no event allowed
            run.advance()
        with no_retrace(expect=1):    # cold path: exactly one
            exp.run(periods=3)
    """
    before = engine.trace_count()
    yield
    got = engine.trace_count() - before
    assert got == expect, (
        f"expected exactly {expect} ledger event(s) in block, got {got}; "
        f"events: {engine.trace_events()[before:]}")
    seen = {}
    for i, ev in enumerate(engine.trace_events()):
        dup = seen.get(ev)
        assert dup is None, (
            f"duplicate event of {ev.kind} program: event #{i} repeats "
            f"event #{dup}: key={ev.key}")
        seen[ev] = i
