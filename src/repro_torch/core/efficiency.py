"""The learning-rate scaling law (paper §III-A) and the online ξ
estimator of the ΔL = ξ√B global-loss-decay model (eq. 8)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def lr_scale(base_lr: float, global_batch: float, ref_batch: float) -> float:
    """η = η₀·√(B/B_ref) (paper §III-A scaling law)."""
    return base_lr * float(np.sqrt(global_batch / ref_batch))


@dataclass
class XiEstimator:
    """EWMA estimate of ξ from observed per-period loss decays.

    A scalar ξ is decision-inert for Algorithm 1 (the fixed-B allocation
    is ΔL-scale-invariant and the outer argmin of T(B)/(ξ√B) drops ξ), so
    re-estimating it calibrates predicted-efficiency reporting only."""
    xi: float = 0.05
    beta: float = 0.9

    def update(self, observed_decay: float, global_batch: float) -> float:
        if global_batch > 0 and np.isfinite(observed_decay):
            sample = max(observed_decay, 0.0) / np.sqrt(global_batch)
            self.xi = self.beta * self.xi + (1 - self.beta) * sample
        return self.xi
