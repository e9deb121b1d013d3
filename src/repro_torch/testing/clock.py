"""Deterministic time sources for the serving layer.

The experiment service (``repro_torch.serve``) never reads ``time.time``
directly: it takes a *clock* object, so service tests are bit-reproducible
and sleep-free — a test advances a :class:`VirtualClock` by hand (or by
measured chunk durations, as ``benchmarks/serve_load.py`` does) instead of
waiting for wall time, and the admission window / latency stamps follow
the injected time exactly.  :class:`WallClock` is the production source.

The only contract is ``now() -> float`` (monotonic seconds).
"""
from __future__ import annotations

import time

__all__ = ["VirtualClock", "WallClock"]


class VirtualClock:
    """Manually-advanced monotonic clock (no relation to wall time).

    ``advance(dt)`` moves time forward by ``dt`` seconds; ``advance_to``
    jumps to an absolute timestamp (no-op when already past it, so
    replaying a sorted arrival tape can never move time backwards).
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance by negative dt ({dt})")
        self._t += float(dt)
        return self._t

    def advance_to(self, t: float) -> float:
        self._t = max(self._t, float(t))
        return self._t


class WallClock:
    """Monotonic wall-clock seconds (``time.perf_counter``), zeroed at
    construction so timestamps read as seconds-since-service-start."""

    def __init__(self):
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._t0
