"""Adaptive local steps τ (Wang et al., 1804.05271).

``local_steps`` is a structural knob: τ gradient steps per upload, costing
(τ-1) extra compute rounds a period and crediting a τ·B̄ effective batch.
``TauAdapt`` makes it a *re-planned* knob next to batchsize: at every
closed-loop chunk boundary each scheduler scores each candidate τ with the
learning-efficiency criterion Algorithm 1 optimizes,

    E(τ) = min(ξ·√(τ·B̄), decay_cap) / (t_comm + τ·t_comp),

at the last chunk's realized communication/computation split and the
row's live ξ estimator, and the bucket runs its next chunk at the
bucket-consensus MIN of the rows' best choices.

The candidate set joins ``bucket_key``: only rows that agree on it may
chunk together.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

__all__ = ["TauAdapt"]


@dataclass(frozen=True)
class TauAdapt:
    """Frozen spec-side value (``ScenarioSpec.adapt_tau``): the candidate
    local-step counts the closed loop may re-plan between.  The spec's
    ``local_steps`` is the starting point and must be a member."""
    choices: Tuple[int, ...] = (1, 2, 4)

    def __post_init__(self):
        object.__setattr__(self, "choices", tuple(self.choices))
        if not self.choices:
            raise ValueError("adapt_tau needs at least one choice")
        for c in self.choices:
            if not isinstance(c, int) or isinstance(c, bool) or c < 1:
                raise ValueError(
                    f"adapt_tau choices must be positive ints, got {c!r}")
        if len(set(self.choices)) != len(self.choices):
            raise ValueError(
                f"adapt_tau choices must be distinct, got {self.choices!r}")

    def __str__(self) -> str:  # readable grid-axis coordinate
        return "tau" + "/".join(str(c) for c in self.choices)
