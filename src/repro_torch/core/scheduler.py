"""FEEL horizon planner — the paper's technique as a runtime feature.

Each training period: sample the wireless channel → solve 𝒫₁ → emit the
per-device batchsizes (as masks downstream), η = η₀√(B/B_ref) and the
simulated latency ledger.  Baseline policies are drop-in replacements via
``policy=``.

A copy of the reference's static-world planner: :class:`FeelScheduler`
(``plan`` for one period through the ``core.baselines`` policies,
``plan_horizon`` for a whole horizon of the proposed or a fixed-batch
policy) and :func:`plan_horizons_batch`, consuming the same rng streams
in the same order with the same arithmetic, so every plan is bitwise the
reference's.  ``plan`` draws each period's rates with two
``Cell.avg_rate`` calls (uplink, then downlink) and ``plan_horizon`` a
horizon's with one ``avg_rate_updown_rows`` draw, which consume the cell's
stream alike; but the proposed policy searches B* by golden section in
``plan`` and on an integer grid in ``plan_horizon``, and both carry it in
``_b_cache``, so one scheduler serves one of the two paths.
Participation sampling, hierarchies, fading, faults, energy budgets and
closed-loop re-planning are not part of this port yet.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.channels.model import Cell, CellConfig
from repro_torch.core.baselines import POLICIES
from repro_torch.core.efficiency import XiEstimator, lr_scale
from repro_torch.core.latency import DeviceProfile, gradient_bits
from repro_torch.core.solver import (FleetRows, fixed_slot_rows,
                                     optimize_batch_rows, solve_period_rows)


@dataclass(frozen=True)
class PeriodPlan:
    period: int
    batch: np.ndarray            # B_k per device (int)
    tau_up: np.ndarray
    tau_down: np.ndarray
    lr: float
    predicted_latency: float     # seconds (simulated wall-clock)
    global_batch: int
    rates_up: np.ndarray
    rates_down: np.ndarray


@dataclass(frozen=True)
class PlanHorizon:
    """``periods`` stacked period plans — one array per field, leading
    period axis — in the form the trajectory engine consumes."""
    batch: np.ndarray            # (P, K) int
    tau_up: np.ndarray           # (P, K)
    tau_down: np.ndarray         # (P, K)
    lr: np.ndarray               # (P,) float
    latency: np.ndarray          # (P,) predicted seconds per period
    global_batch: np.ndarray     # (P,) int

    @property
    def periods(self) -> int:
        return self.batch.shape[0]


@dataclass
class FeelScheduler:
    devices: Sequence[DeviceProfile]
    n_params: int
    policy: str = "proposed"
    b_max: int = 128
    base_lr: float = 0.05
    ref_batch: float = 128.0
    bits_per_term: int = 64          # d (paper §VI-A)
    compression: float = 0.005       # r (sparse binary compression [24])
    cell: Optional[Cell] = None
    cell_cfg: CellConfig = field(default_factory=CellConfig)
    seed: int = 0
    xi_est: XiEstimator = field(default_factory=XiEstimator)
    reopt_every: int = 5         # outer B* search cadence (channel stats
                                 # are stationary; carried in between)
    _period: int = 0
    _dist_km: Optional[np.ndarray] = None
    _b_cache: Optional[float] = None

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(
                f"policy {self.policy!r} not in {tuple(POLICIES)}")
        if self.cell is None:
            self.cell = Cell.make(self.seed, self.cell_cfg)
        self.rng = np.random.default_rng(self.seed + 1)
        # user positions are fixed for a training run; fading varies per
        # period
        self._dist_km = self.cell.drop_users(len(self.devices))

    @property
    def payload_bits(self) -> float:
        return gradient_bits(self.n_params, self.bits_per_term,
                             self.compression)

    def observe(self, loss_decay: float, global_batch: float):
        """Feed back the realized ΔL to the ξ estimator."""
        self.xi_est.update(loss_decay, global_batch)

    def observe_series(self, loss_decays: Sequence[float],
                       global_batches: Sequence[float]):
        """Post-hoc ξ feedback for a whole trajectory at once (the engine
        runs a horizon open-loop, ξ frozen at its planning-time value)."""
        for d, g in zip(loss_decays, global_batches):
            self.xi_est.update(float(d), float(g))

    def plan_horizon(self, periods: int) -> PlanHorizon:
        """Plan ``periods`` consecutive periods open-loop and stack them.

        Channel fading is re-drawn per period; ξ is frozen at its current
        estimate for the whole horizon.  Successive calls continue the rng
        streams, so N chunked calls equal one monolithic call bitwise."""
        if self.policy == "proposed":
            return self._plan_horizon_proposed(periods)
        return self._plan_horizon_fixed(periods)

    def _plan_horizon_fixed(self, periods: int) -> PlanHorizon:
        """Fixed-batch baselines, whole horizon in one lockstep evaluation:
        one batched interleaved (up, down) channel draw, one (P, K)
        integer block for the random policy, and the equal-slot latency
        math of ``solver.fixed_slot_rows``."""
        c = self.cell.cfg
        K = len(self.devices)
        rates_up, rates_down = self.cell.avg_rate_updown_rows(
            self._dist_km, periods)
        if self.policy == "online":
            batch = np.ones((periods, K))
        elif self.policy == "full":
            batch = np.full((periods, K), float(self.b_max))
        else:                                    # random
            batch = self.rng.integers(
                1, self.b_max + 1, size=(periods, K)).astype(float)
        tau_up, tau_down, latency = fixed_slot_rows(
            self.devices, batch, rates_up, rates_down,
            self.payload_bits, c.frame_up_s, c.frame_down_s)
        ib = np.maximum(np.round(batch).astype(int), 1)
        gb = ib.sum(1)
        self._period += periods
        return PlanHorizon(
            batch=ib, tau_up=tau_up, tau_down=tau_down,
            lr=self.base_lr * np.sqrt(gb / self.ref_batch),
            latency=latency, global_batch=gb.astype(np.int64))

    def _plan_horizon_proposed(self, periods: int) -> PlanHorizon:
        c = self.cell.cfg
        # one batched interleaved (up, down) channel draw
        rates_up, rates_down = self.cell.avg_rate_updown_rows(
            self._dist_km, periods)
        xi = self.xi_est.xi
        # B* re-optimized on the reopt cadence; rows are independent given
        # their rates, so every reopt period solves in one batched call
        reopt = np.array([(self._period + p) % self.reopt_every == 0
                          or (p == 0 and self._b_cache is None)
                          for p in range(periods)])
        B = np.empty(periods)
        carry = self._b_cache
        if reopt.any():
            b_star = optimize_batch_rows(
                self.devices, rates_up[reopt], rates_down[reopt],
                self.payload_bits, c.frame_up_s, c.frame_down_s, xi,
                self.b_max)
            j = 0
            for p in range(periods):
                if reopt[p]:
                    carry = float(b_star[j])
                    j += 1
                B[p] = carry
        else:
            B[:] = carry
        sol = solve_period_rows(self.devices, rates_up, rates_down,
                                self.payload_bits, c.frame_up_s,
                                c.frame_down_s, xi, B, self.b_max)
        self._b_cache = float(B[-1])
        self._period += periods
        batch = np.maximum(np.round(sol["batch"]).astype(int), 1)
        gb = batch.sum(1)
        return PlanHorizon(
            batch=batch, tau_up=sol["tau_up"], tau_down=sol["tau_down"],
            lr=np.array([lr_scale(self.base_lr, g, self.ref_batch)
                         for g in gb], np.float64),
            latency=sol["latency"], global_batch=gb.astype(np.int64))

    def plan(self) -> PeriodPlan:
        """Plan one period: draw the uplink then the downlink rates, solve
        with the policy (the proposed policy re-optimizes B* on the
        ``reopt_every`` cadence and carries it in between)."""
        c = self.cell.cfg
        rates_up = self.cell.avg_rate(self._dist_km)
        rates_down = self.cell.avg_rate(self._dist_km)
        kw = dict(rng=self.rng)
        if self.policy == "proposed":
            kw["xi"] = self.xi_est.xi
            if self._b_cache is not None and self._period % self.reopt_every:
                kw["B"] = self._b_cache
        res = POLICIES[self.policy](
            self.devices, rates_up, rates_down, self.payload_bits,
            c.frame_up_s, c.frame_down_s, self.b_max, **kw)
        if self.policy == "proposed":
            self._b_cache = res.global_batch
        batch = np.maximum(np.round(res.batch).astype(int), 1)
        gb = int(batch.sum())
        plan = PeriodPlan(
            period=self._period, batch=batch, tau_up=res.tau_up,
            tau_down=res.tau_down,
            lr=lr_scale(self.base_lr, gb, self.ref_batch),
            predicted_latency=res.latency, global_batch=gb,
            rates_up=rates_up, rates_down=rates_down)
        self._period += 1
        return plan


def plan_horizons_batch(schedulers: Sequence[FeelScheduler],
                        periods: int) -> List[PlanHorizon]:
    """Plan many schedulers' horizons with proposed-policy rows fused —
    across fleets of any size or composition.

    Bitwise equal to ``[s.plan_horizon(periods) for s in schedulers]``:
    each scheduler's rng streams are consumed in the per-call order, but
    the Algorithm-1 / Theorem-2 bisections of every proposed-policy
    scheduler sharing (payload, frames, b_max, reopt cadence) run as ONE
    lockstep masked rows solve over the flattened (scenario × period)
    axis.  Fleets are padded to the group's max K as
    :class:`~repro_torch.core.solver.FleetRows` (padded columns: rate
    fill, active mask 0, outside every reduction).  Scheduler state
    (``_b_cache``, ``_period``) advances exactly as per call.
    """
    out: List[Optional[PlanHorizon]] = [None] * len(schedulers)
    groups = defaultdict(list)
    for i, s in enumerate(schedulers):
        if s.policy != "proposed":
            out[i] = s.plan_horizon(periods)
        else:
            key = (s.payload_bits, s.cell.cfg.frame_up_s,
                   s.cell.cfg.frame_down_s, s.b_max, s.reopt_every)
            groups[key].append(i)
    for key, idxs in groups.items():
        if len(idxs) == 1:
            out[idxs[0]] = schedulers[idxs[0]].plan_horizon(periods)
            continue
        scheds = [schedulers[i] for i in idxs]
        s0 = scheds[0]
        c = s0.cell.cfg
        M, P = len(scheds), periods
        ks = [len(s.devices) for s in scheds]
        K = max(ks)
        fleet_rows = FleetRows.from_fleets(
            [tuple(s.devices) for s in scheds], k_pad=K)
        rates_up = np.empty((M, P, K))
        rates_down = np.empty((M, P, K))
        for m, s in enumerate(scheds):           # per-scheduler rng streams
            rates_up[m], rates_down[m] = s.cell.avg_rate_updown_rows(
                s._dist_km, P, pad_to=K)
        xi = np.array([s.xi_est.xi for s in scheds])
        reopt = np.array([[(s._period + p) % s.reopt_every == 0
                           or (p == 0 and s._b_cache is None)
                           for p in range(P)] for s in scheds])
        flat_up = rates_up.reshape(M * P, K)
        flat_down = rates_down.reshape(M * P, K)
        flat_fleets = fleet_rows.repeat(P)       # row m*P+p = scheduler m
        xi_rows = np.repeat(xi, P)
        B = np.empty((M, P))
        if reopt.any():
            rf = reopt.reshape(M * P)
            b_star = optimize_batch_rows(
                flat_fleets.take(rf), flat_up[rf], flat_down[rf],
                s0.payload_bits, c.frame_up_s, c.frame_down_s, xi_rows[rf],
                s0.b_max)
            j = 0
            for m, s in enumerate(scheds):
                carry = s._b_cache
                for p in range(P):
                    if reopt[m, p]:
                        carry = float(b_star[j])
                        j += 1
                    B[m, p] = carry
        else:
            for m, s in enumerate(scheds):
                B[m, :] = s._b_cache
        sol = solve_period_rows(flat_fleets, flat_up, flat_down,
                                s0.payload_bits, c.frame_up_s, c.frame_down_s,
                                xi_rows, B.reshape(M * P), s0.b_max)
        # round active batches up to >= 1; padded columns stay exactly 0
        batch = np.where(flat_fleets.active.reshape(M, P, K),
                         np.maximum(np.round(sol["batch"]).astype(int)
                                    .reshape(M, P, K), 1), 0)
        gb = batch.sum(2)
        for m, (i, s) in enumerate(zip(idxs, scheds)):
            s._b_cache = float(B[m, -1])
            s._period += P
            k_m = ks[m]                          # slice back to the true K
            out[i] = PlanHorizon(
                batch=batch[m, :, :k_m],
                tau_up=sol["tau_up"].reshape(M, P, K)[m, :, :k_m],
                tau_down=sol["tau_down"].reshape(M, P, K)[m, :, :k_m],
                lr=np.array([lr_scale(s.base_lr, g, s.ref_batch)
                             for g in gb[m]], np.float64),
                latency=sol["latency"].reshape(M, P)[m],
                global_batch=gb[m].astype(np.int64))
    return out
