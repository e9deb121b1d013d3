"""Learning-efficiency criterion (paper Definition 1) and the ΔL = ξ√B
global-loss-decay model (eq. 8) with an online ξ estimator.

The √B law comes from keeping gradient-estimate variance constant under the
η ∝ √B learning-rate scaling; ξ is model/task specific, so the trainer
re-estimates it from observed decays (EWMA) each period.

A copy of the reference's numpy module: same arithmetic, same order.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def loss_decay(xi: float, global_batch) -> np.ndarray:
    """eq. (8): ΔL = ξ·√B."""
    return xi * np.sqrt(np.asarray(global_batch, float))


def learning_efficiency(xi: float, global_batch: float, period_latency: float
                        ) -> float:
    """Definition 1: E = ΔL / T."""
    return float(loss_decay(xi, global_batch) / period_latency)


def lr_scale(base_lr: float, global_batch: float, ref_batch: float) -> float:
    """η = η₀·√(B/B_ref) (paper §III-A scaling law)."""
    return base_lr * float(np.sqrt(global_batch / ref_batch))


@dataclass
class XiEstimator:
    """EWMA estimate of ξ from observed per-period loss decays.

    A scalar ξ is decision-inert for Algorithm 1 (the fixed-B allocation
    is ΔL-scale-invariant and the outer argmin of T(B)/(ξ√B) drops ξ), so
    re-estimating it calibrates predicted-efficiency reporting only.

    ``delta`` tracks the realized per-period decay with the same EWMA, and
    :attr:`decay_cap` exposes ``cap_headroom·δ̂`` as a ceiling on the decay
    a closed-loop planner may credit to any candidate B (``None`` until
    feedback arrives: the open-loop model, uncapped).
    """
    xi: float = 0.05
    beta: float = 0.9
    cap_headroom: float = 2.0
    delta: float = field(default=float("nan"))
    _n: int = field(default=0)

    def update(self, observed_decay: float, global_batch: float) -> float:
        if global_batch > 0 and np.isfinite(observed_decay):
            sample = max(observed_decay, 0.0) / np.sqrt(global_batch)
            self.xi = self.beta * self.xi + (1 - self.beta) * sample
            d = max(observed_decay, 0.0)
            self.delta = (d if not np.isfinite(self.delta)
                          else self.beta * self.delta + (1 - self.beta) * d)
            self._n += 1
        return self.xi

    @property
    def decay_cap(self):
        """ΔL ceiling for closed-loop planning, or ``None`` before any
        feedback."""
        if not np.isfinite(self.delta):
            return None
        return self.cap_headroom * self.delta
