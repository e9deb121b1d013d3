"""Per-user energy budgets (Mo & Xu, 2003.00199's joint comm+comp model).

A period costs user k

    E_k = comp_w · t_local(B_k) + tx_w · t_up(τ_k)            [J]

— compute power against the affine local-latency model plus radio power
against the uplink airtime.  ``EnergyBudget`` caps E_k per period:

* the Algorithm-1 batch search discounts candidate global batchsizes
  whose per-user shares the fleet cannot afford
  (``optimize_batch_rows(energy=...)``);
* after the per-period solve, users are clipped to their affordable
  batch (``B <= cap``); a user that cannot afford even its minimum batch
  **drops** for the period, one more participation mask.  If every
  active user would drop, nobody does (the period runs at the minimum
  batch instead: an empty round would divide by zero in the
  aggregation);
* realized spend (at realized rates and straggler slowdowns) lands in
  the ``energy`` ledger next to latency.

An unreachable budget (the default ``inf``) is the bitwise identity:
caps are +inf, ``min(B, inf) == B``, no one drops, and the candidate
discount is exactly 1.0.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["EnergyBudget", "batch_caps", "energy_spend", "uplink_airtime"]


@dataclass(frozen=True)
class EnergyBudget:
    """Frozen spec-side value (``ScenarioSpec.energy``).  Value-only for
    bucketing: budgeted and unbudgeted scenarios share one device loop
    (the budget reaches the device only through schedule values and
    masks)."""
    budget_j: float = float("inf")   # per-user per-period budget (J)
    comp_w: float = 1.0              # compute power draw (W)
    tx_w: float = 1.0                # radio power draw (W)

    def __post_init__(self):
        if not self.budget_j > 0.0:
            raise ValueError(
                f"budget_j must be positive, got {self.budget_j!r}")
        if not (self.comp_w >= 0.0 and self.tx_w >= 0.0):
            raise ValueError(
                f"power draws must be >= 0, got comp_w={self.comp_w!r} "
                f"tx_w={self.tx_w!r}")
        if self.comp_w == 0.0 and self.tx_w == 0.0:
            raise ValueError("at least one of comp_w/tx_w must be positive")

    def __str__(self) -> str:  # readable grid-axis coordinate
        return f"E{self.budget_j:g}J@{self.comp_w:g}/{self.tx_w:g}"


def uplink_airtime(tau_up, rates_up, s_bits: float, frame_up: float):
    """Per-user uplink airtime s·T_f^U / (τ·R) — the solver's pricing,
    with its operand order, so planning, capping and the realized ledger
    share one formula bitwise."""
    return s_bits * frame_up / (np.maximum(tau_up, 1e-30) * rates_up)


def batch_caps(energy: EnergyBudget, fr, tau_up, rates_up,
               s_bits: float, frame_up: float) -> np.ndarray:
    """Largest affordable batch per user-period under ``energy``.

    Inverts the affine local-latency model against the residual budget
    after the (planned) uplink spend: B_cap = (E − tx·t_up − comp·a) /
    (comp·b).  ``fr`` is a ``FleetRows`` (only its affine coefficient
    arrays ``a``/``b`` are read).  Rows with ``comp_w == 0`` are uncapped
    by compute (+inf unless the radio alone busts the budget)."""
    t_up = uplink_airtime(tau_up, rates_up, s_bits, frame_up)
    residual = energy.budget_j - energy.tx_w * t_up - energy.comp_w * fr.a
    denom = energy.comp_w * fr.b
    with np.errstate(divide="ignore", invalid="ignore"):
        cap = np.where(denom > 0, residual / np.maximum(denom, 1e-30),
                       np.where(residual >= 0, np.inf, -np.inf))
    return cap


def energy_spend(energy: EnergyBudget, t_local, t_up) -> np.ndarray:
    """Realized per-user-period spend (the ledger): compute power against
    the (slowdown-scaled) local latency plus radio power against the
    realized uplink airtime."""
    return energy.comp_w * np.asarray(t_local) + \
        energy.tx_w * np.asarray(t_up)
