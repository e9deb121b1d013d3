"""Scenario dynamics: the time-varying world.

The paper plans in a static world: one channel law, one fleet, one τ for
the whole horizon.  The processes here break that premise one axis at a
time, each as an optional frozen ``ScenarioSpec`` field:

* :class:`Fading` / :class:`FadingProcess` — a seeded block-fading
  Markov chain over a per-user gain ladder that drifts the average rates
  from period to period;
* :class:`Faults` / :class:`FaultProcess` — straggler slowdowns (scale a
  user's computation latency in the ledger) and dropout (one more
  time-varying participation mask, composed multiplicatively with
  sampling through the same ``active`` machinery);
* :class:`EnergyBudget` — per-user per-period energy caps folded into the
  Algorithm-1 batch search (users shed load or drop) and a realized
  energy-spend ledger;
* :class:`TauAdapt` — local steps τ as a knob the closed loop re-plans
  next to batchsize (Wang et al. 1804.05271's adaptive-τ view).

Stream discipline: fading and faults own dedicated rng streams derived
from ``(scenario_seed, spec.seed, tag)`` with tags ``0xFAD1`` / ``0xFA17``,
disjoint from the channel (``Cell.make(seed)``), scheduler (``seed + 1``),
batcher (``seed``) and participation (``0x5A17``) streams, and consume a
FIXED number of variates per planned period, so adding dynamics never
perturbs a pre-existing draw and chunked planning equals monolithic
planning.  Identity parameters (``spread=0``, zero fault probabilities,
an unreachable budget) multiply by exactly 1.0 / clip at +inf and
reproduce the static run bitwise.

A copy of the reference's ``dynamics`` package.
"""
from repro_torch.dynamics.energy import (EnergyBudget, batch_caps,
                                         energy_spend, uplink_airtime)
from repro_torch.dynamics.fading import Fading, FadingProcess
from repro_torch.dynamics.faults import Faults, FaultProcess
from repro_torch.dynamics.tau import TauAdapt

__all__ = [
    "EnergyBudget", "Fading", "FadingProcess", "Faults", "FaultProcess",
    "TauAdapt", "batch_caps", "energy_spend", "uplink_airtime",
]
