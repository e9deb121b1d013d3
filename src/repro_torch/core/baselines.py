"""The paper's batchsize/allocation policies (§VI-C, Figs. 4-5):

  * online   — B_k = 1
  * full     — B_k = B^max
  * random   — B_k ~ U{1..B^max} each period
  * proposed — Theorem 1/2 solution (core.solver)

All non-proposed policies use equal TDMA slots (τ_k = T_f/K), which is what
an allocation-unaware system does.

A copy of the reference's numpy module: same arithmetic, same rng draws.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.latency import (downlink_latency, period_latency,
                                      uplink_latency)
from repro_torch.core.solver import solve_period


@dataclass(frozen=True)
class PolicyResult:
    batch: np.ndarray
    tau_up: np.ndarray
    tau_down: np.ndarray
    latency: float
    global_batch: float


def _fixed_batch_policy(batch, devices, rates_up, rates_down, s_bits,
                        frame_up, frame_down) -> PolicyResult:
    K = len(devices)
    batch = np.asarray(batch, float)
    tau_u = np.full(K, frame_up / K)
    tau_d = np.full(K, frame_down / K)
    t_local = np.array([d.local_grad_latency(b)
                        for d, b in zip(devices, batch)])
    t_up = uplink_latency(s_bits, tau_u, frame_up, rates_up)
    t_down = downlink_latency(s_bits, tau_d, frame_down, rates_down)
    t_upd = np.array([d.update_latency() for d in devices])
    T = period_latency(t_local, t_up, t_down, t_upd)
    return PolicyResult(batch, tau_u, tau_d, T, float(batch.sum()))


def online_policy(devices, rates_up, rates_down, s_bits, frame_up,
                  frame_down, b_max, rng=None) -> PolicyResult:
    return _fixed_batch_policy(np.ones(len(devices)), devices, rates_up,
                               rates_down, s_bits, frame_up, frame_down)


def full_batch_policy(devices, rates_up, rates_down, s_bits, frame_up,
                      frame_down, b_max, rng=None) -> PolicyResult:
    return _fixed_batch_policy(np.full(len(devices), b_max), devices,
                               rates_up, rates_down, s_bits, frame_up,
                               frame_down)


def random_batch_policy(devices, rates_up, rates_down, s_bits, frame_up,
                        frame_down, b_max, rng: Optional[np.random.Generator]
                        = None) -> PolicyResult:
    rng = rng or np.random.default_rng(0)
    batch = rng.integers(1, b_max + 1, size=len(devices))
    return _fixed_batch_policy(batch, devices, rates_up, rates_down, s_bits,
                               frame_up, frame_down)


def proposed_policy(devices, rates_up, rates_down, s_bits, frame_up,
                    frame_down, b_max, xi: float = 0.05, rng=None,
                    B: Optional[float] = None) -> PolicyResult:
    sol = solve_period(devices, rates_up, rates_down, s_bits, frame_up,
                       frame_down, xi, b_max, B=B)
    return PolicyResult(sol.batch, sol.tau_up, sol.tau_down, sol.latency,
                        sol.global_batch)


POLICIES = {
    "online": online_policy,
    "full": full_batch_policy,
    "random": random_batch_policy,
    "proposed": proposed_policy,
}
