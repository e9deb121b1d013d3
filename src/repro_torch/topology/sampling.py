"""Per-round client sampling: S of K users participate each period.

:class:`Sampling` is the frozen spec-side value (``ScenarioSpec.sampling``)
— either a fixed per-period cohort ``size`` S or a ``fraction`` S/K, plus
its own seed.  :class:`ParticipationSampler` is the host-side stream that
realizes it as a *time-varying* participation mask, one ``(periods, K)``
{0,1} block per planned horizon.

Stream discipline (the bitwise contract):

* the sampler owns a dedicated rng stream derived from
  ``(scenario_seed, sampling.seed, _STREAM_TAG)``; it never touches the
  channel stream (``Cell.make(seed)``), the scheduler stream
  (``seed + 1``) or the batcher stream (``seed``), so adding sampling to
  a scenario leaves every other draw bitwise unchanged;
* exactly one cohort permutation is consumed per planned period, so a
  horizon planned in chunks draws the same masks as the monolithic plan;
* channel rates are still drawn for ALL K users every period (the mask
  selects, it does not re-shape the Monte-Carlo draw), and the batcher
  draws the same count whatever the realized batch, so a sampled-out
  period leaves both streams exactly where a participating period would.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

__all__ = ["Sampling", "ParticipationSampler"]

# rng stream tag: keeps the participation stream disjoint from every
# other (seed, ...)-derived stream (see module docstring)
_STREAM_TAG = 0x5A17


@dataclass(frozen=True)
class Sampling:
    """Per-round participation policy: exactly one of ``size`` (fixed S
    users per period) or ``fraction`` (S = ceil(fraction * K)) is set.
    ``size`` larger than the fleet clamps to full participation, so one
    Sampling value can ride a ``users=[...]`` sweep axis unchanged.

    ``weighted=True`` turns on Horvitz-Thompson (1/p) correction of the
    sampled aggregation: the planner allocates batchsizes for the FULL
    fleet (every user has a planned share b̄_k even when absent), and each
    period's cohort aggregates against the fixed denominator p·Σ_all b̄_k
    instead of the realized Σ_cohort b_k, so the estimator's expectation
    equals the full-participation aggregate.  Weights then sum to one
    only in expectation."""
    size: Optional[int] = None
    fraction: Optional[float] = None
    seed: int = 0
    weighted: bool = False

    def __post_init__(self):
        if (self.size is None) == (self.fraction is None):
            raise ValueError(
                "Sampling needs exactly one of size= or fraction=, got "
                f"size={self.size!r} fraction={self.fraction!r}")
        if self.size is not None and (
                not isinstance(self.size, int)
                or isinstance(self.size, bool) or self.size < 1):
            raise ValueError(
                f"sampling size must be a positive int, got {self.size!r}")
        if self.fraction is not None and not 0.0 < self.fraction <= 1.0:
            raise ValueError(
                f"sampling fraction must be in (0, 1], got {self.fraction!r}")
        if not isinstance(self.weighted, bool):
            raise TypeError(
                f"weighted must be a bool, got {self.weighted!r}")

    def s_of(self, k: int) -> int:
        """Cohort size for a K-user fleet (always in ``1..k``)."""
        if self.size is not None:
            return min(self.size, k)
        return min(k, max(1, int(np.ceil(self.fraction * k))))

    def p_of(self, k: int) -> float:
        """Per-user inclusion probability S/K (uniform cohorts)."""
        return self.s_of(k) / k

    def __str__(self) -> str:  # readable grid-axis coordinate
        w = "w" if self.weighted else ""
        if self.size is not None:
            return f"S{self.size}@{self.seed}{w}"
        return f"S{self.fraction:g}K@{self.seed}{w}"


class ParticipationSampler:
    """Seeded per-period cohort stream for one scenario row.

    ``draw(periods)`` returns a ``(periods, k)`` float32 {0,1} mask with
    exactly ``S = sampling.s_of(k)`` ones per row; consecutive calls
    continue the stream (chunked planning equals monolithic planning
    row for row)."""

    def __init__(self, sampling: Sampling, k: int, seed: int):
        self.sampling = sampling
        self.k = k
        self.s = sampling.s_of(k)
        self.rng = np.random.default_rng((seed, sampling.seed, _STREAM_TAG))

    def draw(self, periods: int) -> np.ndarray:
        mask = np.zeros((periods, self.k), np.float32)
        for p in range(periods):
            # one permutation per period, drawn even at S == k, so the
            # stream position depends only on how many periods were
            # planned, never on the cohort size
            mask[p, self.rng.permutation(self.k)[:self.s]] = 1.0
        return mask
