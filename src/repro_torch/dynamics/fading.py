"""Block-fading Markov channel drift.

The paper's planner consumes *average* rates, a Monte-Carlo expectation
per period over fast Rayleigh fading.  Real channels also drift on a
slower timescale (shadowing, mobility): this module models that as a
per-user Markov chain over a discrete gain ladder, block-constant within
a period, multiplying the rates that ``Cell.avg_rate_updown_rows``
returns.  The Monte-Carlo stream itself is never touched: drift composes
on top of the fast-fading expectation.

Planner belief vs realized state: ``FadingProcess.draw`` realizes the
per-period gains.  The open-loop planner prices every period with the
horizon's FIRST realized gain (``g0``), the paper's static assumption,
stale from period 2 on and independent of chunking.  The realized
per-period gains always drive the *ledger*: after the solve, the
scheduler re-prices each period at the realized rates, so a stale
allocation pays its true latency.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["Fading", "FadingProcess"]

# rng stream tag: disjoint from sampling (0x5A17) and faults (0xFA17)
_STREAM_TAG = 0xFAD1


@dataclass(frozen=True)
class Fading:
    """Frozen spec-side value (``ScenarioSpec.fading``).

    ``states`` is structural (``bucket_key``): the gain-ladder resolution
    the chain walks.  ``spread`` sets the ladder's log-amplitude
    (``spread=0`` is the bitwise identity: every gain is exactly 1.0),
    ``stickiness`` the per-period probability of holding the current
    state."""
    states: int = 3
    spread: float = 0.6
    stickiness: float = 0.9
    seed: int = 0

    def __post_init__(self):
        if not isinstance(self.states, int) or isinstance(self.states, bool) \
                or self.states < 1:
            raise ValueError(
                f"fading states must be a positive int, got {self.states!r}")
        if not self.spread >= 0.0:
            raise ValueError(
                f"fading spread must be >= 0, got {self.spread!r}")
        if not 0.0 <= self.stickiness < 1.0:
            raise ValueError(
                "fading stickiness must be in [0, 1) (a chain that never "
                f"moves is the static world), got {self.stickiness!r}")

    def gain_ladder(self) -> np.ndarray:
        """Symmetric log-space ladder centered on gain 1.0:
        ``exp(spread * z)`` with ``z`` uniform on [-1, 1]; a one-state
        ladder (or ``spread=0``) is exactly ``1.0`` everywhere."""
        if self.states == 1:
            z = np.zeros(1)
        else:
            z = np.linspace(-1.0, 1.0, self.states)
        return np.exp(self.spread * z)

    def __str__(self) -> str:  # readable grid-axis coordinate
        return (f"F{self.states}x{self.spread:g}"
                f"p{self.stickiness:g}@{self.seed}")


class FadingProcess:
    """Seeded per-user Markov gain stream for one scenario row.

    ``draw(periods)`` consumes exactly one ``(K,)`` uniform block per
    period, whatever the chain does, so the stream position depends only
    on how many periods were planned: chunked horizons realize the same
    gains as monolithic ones."""

    def __init__(self, fading: Fading, k: int, seed: int):
        self.fading = fading
        self.k = k
        self.rng = np.random.default_rng((seed, fading.seed, _STREAM_TAG))
        self._ladder = fading.gain_ladder()
        self._state = None      # (K,) current chain state
        self._g0 = None         # first-ever period's gains (open-loop belief)
        self._latest0 = None    # first period of the latest draw

    def draw(self, periods: int) -> np.ndarray:
        """Realize ``(periods, K)`` multiplicative gains, advancing the
        chain; consecutive calls continue where the last one stopped."""
        n = self.fading.states
        stick = self.fading.stickiness
        states = np.zeros((periods, self.k), np.int64)
        for p in range(periods):
            u = self.rng.uniform(size=self.k)   # ONE block per period
            if self._state is None:
                # initial state from the same uniform block
                s = np.minimum((u * n).astype(np.int64), n - 1)
            else:
                # sticky chain: hold w.p. `stickiness`, else step +/-1
                # (reflecting at the ladder ends); the direction re-uses
                # the residual uniform mass, so one block a period
                v = (u - stick) / (1.0 - stick)
                step = np.where(v < 0.5, -1, 1)
                s = np.where(u < stick, self._state,
                             np.clip(self._state + step, 0, n - 1))
            self._state = s
            states[p] = s
        gains = self._ladder[states]
        if self._g0 is None:
            self._g0 = gains[0].copy()
        self._latest0 = gains[0].copy()
        return gains

    def planning_gain(self, closed_loop: bool) -> np.ndarray:
        """The (K,) belief the planner may price rates with: ``g0`` open
        loop, the current chunk's first realized gain closed loop.  Only
        valid after :meth:`draw`."""
        assert self._latest0 is not None, "planning_gain before draw"
        return self._latest0 if closed_loop else self._g0
