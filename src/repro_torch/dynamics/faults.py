"""Straggler and dropout fault injection (Prakash et al., 2111.00637).

Two per-user-per-period Bernoulli processes on one dedicated stream:

* **stragglers** — with ``slow_prob`` a user's computation runs
  ``slow_factor`` times slower that period.  Slowdowns are a *ledger*
  effect: they scale the per-user local-computation latency that prices
  the period;
* **dropout** — with ``drop_prob`` a user vanishes for the period: one
  more {0,1} participation mask composed multiplicatively with sampling
  through the same time-varying ``active`` path.

The draw consumes exactly ``2K`` uniforms per period whatever the
probabilities realize: zero-probability faults are the bitwise identity
(slowdown 1.0, keep-mask all ones) and chunked draws equal monolithic
ones.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

__all__ = ["Faults", "FaultProcess"]

# rng stream tag: disjoint from sampling (0x5A17) and fading (0xFAD1)
_STREAM_TAG = 0xFA17


@dataclass(frozen=True)
class Faults:
    """Frozen spec-side value (``ScenarioSpec.faults``).  Value-only for
    bucketing: faults arrive as schedule values and mask data."""
    slow_prob: float = 0.0
    slow_factor: float = 4.0
    drop_prob: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.slow_prob <= 1.0:
            raise ValueError(
                f"slow_prob must be in [0, 1], got {self.slow_prob!r}")
        if not 0.0 <= self.drop_prob < 1.0:
            raise ValueError(
                "drop_prob must be in [0, 1) (a fleet that always drops "
                f"cannot train), got {self.drop_prob!r}")
        if not self.slow_factor >= 1.0:
            raise ValueError(
                f"slow_factor must be >= 1, got {self.slow_factor!r}")

    @property
    def keep_prob(self) -> float:
        """Per-period survival probability (weighted sampling folds this
        into the inclusion probability)."""
        return 1.0 - self.drop_prob

    def __str__(self) -> str:  # readable grid-axis coordinate
        return (f"slow{self.slow_prob:g}x{self.slow_factor:g}"
                f"drop{self.drop_prob:g}@{self.seed}")


class FaultProcess:
    """Seeded straggler/dropout stream for one scenario row."""

    def __init__(self, faults: Faults, k: int, seed: int):
        self.faults = faults
        self.k = k
        self.rng = np.random.default_rng((seed, faults.seed, _STREAM_TAG))

    def draw(self, periods: int) -> Tuple[np.ndarray, np.ndarray]:
        """Realize ``(slowdown, keep)`` for ``periods`` periods:
        ``slowdown`` (P, K) float (1.0 or ``slow_factor``), ``keep``
        (P, K) float {0,1}.  One ``(2, K)`` uniform block per period,
        C-order, so chunked == monolithic."""
        u = self.rng.uniform(size=(periods, 2, self.k))
        slowdown = np.where(u[:, 0] < self.faults.slow_prob,
                            self.faults.slow_factor, 1.0)
        keep = (u[:, 1] >= self.faults.drop_prob).astype(np.float64)
        return slowdown, keep
