"""Seeded arrival-process generators for the serving layer.

The service benchmarks and tests share these fixtures: a workload is a
sorted array of arrival *times* (seconds on the service clock) zipped
with request templates.  Everything is a pure function of its seed —
``poisson_arrivals(rate, n, seed=7)`` is the same tape on every machine —
so service tests replay identical traffic without a single
``time.sleep`` (drive a :class:`repro_torch.testing.VirtualClock` along
the tape instead).

Cumulative times use the *seeded* cumsum form (``cumsum([[start], gaps])``)
rather than ``cumsum(gaps) + start``: float addition is non-associative
and the repo's ledgers treat the seeded form as the only bit-stable one;
the arrival tapes follow the same discipline, so two tapes differing only
in ``start`` stay exactly translation-consistent.  A copy of the
reference's module: the same numpy draws give the same tapes.
"""
from __future__ import annotations

from itertools import cycle, islice
from typing import Sequence

import numpy as np

__all__ = ["poisson_arrivals", "burst_arrivals", "assign_templates"]


def _seeded_cumsum(start: float, gaps: np.ndarray) -> np.ndarray:
    return np.cumsum(np.concatenate([[float(start)], gaps]))[1:]


def poisson_arrivals(rate: float, n: int, seed: int,
                     start: float = 0.0) -> np.ndarray:
    """``(n,)`` f64 arrival times of a homogeneous Poisson process.

    ``rate`` is arrivals per second (exponential inter-arrival gaps with
    mean ``1/rate``); deterministic per ``seed``.
    """
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(scale=1.0 / rate, size=n)
    return _seeded_cumsum(start, gaps)


def burst_arrivals(bursts: int, size: int, spacing: float,
                   intra: float = 0.0, seed: int = 0,
                   start: float = 0.0) -> np.ndarray:
    """``(bursts * size,)`` f64 times of a bursty process: ``bursts``
    groups ``spacing`` seconds apart, each of ``size`` near-simultaneous
    arrivals ``intra`` seconds apart inside the burst, plus a small
    seeded jitter (±10% of ``intra``, zero when ``intra`` is 0) so two
    bursts never produce byte-identical sub-tapes.
    """
    if bursts < 1 or size < 1:
        raise ValueError(f"bursts and size must be >= 1, got "
                         f"({bursts}, {size})")
    rng = np.random.default_rng(seed)
    times = np.empty(bursts * size, np.float64)
    for b in range(bursts):
        base = start + b * spacing
        offs = np.arange(size) * intra
        if intra > 0:
            offs = offs + rng.uniform(0.0, 0.1 * intra, size=size)
        times[b * size:(b + 1) * size] = base + offs
    return np.sort(times)


def assign_templates(times: np.ndarray,
                     templates: Sequence) -> list:
    """Zip an arrival tape with request templates, round-robin: returns
    ``[(t_0, templates[0]), (t_1, templates[1]), ...]`` cycling through
    ``templates`` — the repeat-shape workload shape the compile cache is
    benchmarked on (every template revisits its bucket shape)."""
    if not len(templates):
        raise ValueError("templates must be non-empty")
    return list(zip(np.asarray(times, np.float64).tolist(),
                    islice(cycle(templates), len(times))))
