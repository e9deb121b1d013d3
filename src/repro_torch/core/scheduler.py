"""FEEL horizon planner — the paper's technique as a runtime feature.

Each training period: sample the wireless channel → solve 𝒫₁ → emit the
per-device batchsizes (as masks downstream), η = η₀√(B/B_ref) and the
simulated latency ledger.  Baseline policies are drop-in replacements via
``policy=``.

A copy of the reference's planner: :class:`FeelScheduler`
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

``plan_horizon`` also plans the time-varying world: per-round
participation sampling (``sampling``), block-fading channel drift
(``fading``), stragglers and dropout (``faults``) and per-user energy
budgets (``energy``).  Each process draws from its own tagged rng stream,
after the participation draw and before the channel draw, so a static
scheduler's streams are untouched by them.  Under a cell→edge→cloud
``topology`` it solves Algorithm 1 per (cell, period) and adds the
backhaul round trip on cloud rounds.

:class:`DevScheduler` plans the per-device-parameter schemes
(``individual``, ``model_fl``): each period's minibatch indices and the
latency ledger of one local epoch (plus the model upload and broadcast
for ``model_fl``), optionally under per-round participation.

The closed loop re-plans chunk by chunk: ``plan_horizon(warm_start=,
closed_loop=)`` narrows the B* grid around the previous chunk's optimum
and caps the decay credited to a candidate at the ξ estimator's
``decay_cap``, and :meth:`FeelScheduler.recommend_tau` scores the
adaptive local-step choices at the last chunk's realized comm/comp split.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.channels.model import Cell, CellConfig
from repro_torch.core.baselines import POLICIES
from repro_torch.core.efficiency import XiEstimator, lr_scale
from repro_torch.core.latency import (DeviceProfile, downlink_latency,
                                      gradient_bits, uplink_latency)
from repro_torch.core.solver import (FleetRows, fixed_slot_rows,
                                     optimize_batch_rows, solve_period_rows)
from repro_torch.dynamics import (EnergyBudget, Fading, FadingProcess,
                                  Faults, FaultProcess)
from repro_torch.dynamics.energy import batch_caps, energy_spend
from repro_torch.topology import ParticipationSampler, Sampling, Topology


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
    period axis — in the form the trajectory engine consumes.

    ``participation`` is the realized per-period user mask (sampling ∧
    dropout ∧ energy drops) when the scheduler samples, faults or has a
    budget (None: everyone takes part every period); ``cloud`` flags the
    cloud-round periods of a :class:`~repro_torch.topology.Topology`
    horizon (None: flat single-tier aggregation); ``aggden`` the
    Horvitz-Thompson fixed aggregation denominator of weighted sampling;
    ``energy`` the realized per-user joules under a budget; ``slowdown``
    the straggler factors under faults."""
    batch: np.ndarray            # (P, K) int
    tau_up: np.ndarray           # (P, K)
    tau_down: np.ndarray         # (P, K)
    lr: np.ndarray               # (P,) float
    latency: np.ndarray          # (P,) predicted seconds per period
    global_batch: np.ndarray     # (P,) int
    participation: Optional[np.ndarray] = None   # (P, K) {0,1}
    cloud: Optional[np.ndarray] = None           # (P,) f32 {0,1}
    aggden: Optional[np.ndarray] = None          # (P,) HT fixed denominator
    energy: Optional[np.ndarray] = None          # (P, K) realized spend (J)
    slowdown: Optional[np.ndarray] = None        # (P, K) straggler factors

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
    sampling: Optional[Sampling] = None    # per-round S-of-K participation
    topology: Optional[Topology] = None    # cell→edge→cloud hierarchy
    fading: Optional[Fading] = None        # block-fading Markov drift
    faults: Optional[Faults] = None        # stragglers + dropout
    energy: Optional[EnergyBudget] = None  # per-user per-period caps
    _period: int = 0
    _dist_km: Optional[np.ndarray] = None
    _b_cache: Optional[float] = None       # topology horizons: (cells,) array

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(
                f"policy {self.policy!r} not in {tuple(POLICIES)}")
        if self.cell is None:
            self.cell = Cell.make(self.seed, self.cell_cfg)
        self.rng = np.random.default_rng(self.seed + 1)
        # user positions are fixed for a training run; fading varies per
        # period.  Under a topology each user's distance is read as the
        # distance to its own cell's base station: the single disc draw
        # is reused, so a topology leaves the channel stream as it is.
        self._dist_km = self.cell.drop_users(len(self.devices))
        k = len(self.devices)
        # participation and dynamics draw from dedicated tagged streams
        # (0x5A17, 0xFAD1, 0xFA17), so they perturb no other draw
        self._participation = (
            None if self.sampling is None else
            ParticipationSampler(self.sampling, k, self.seed))
        self._fading_proc = (
            None if self.fading is None else
            FadingProcess(self.fading, k, self.seed))
        self._faults_proc = (
            None if self.faults is None else
            FaultProcess(self.faults, k, self.seed))
        if self.topology is not None and (
                self.fading is not None or self.faults is not None
                or self.energy is not None):
            raise ValueError(
                "dynamics are not threaded through the hierarchical "
                "per-cell solves")
        # realized comm/comp split of the last planned chunk: the
        # adaptive-τ recommendation's inputs (bookkeeping only)
        self._last_lat: Optional[float] = None
        self._last_comp: Optional[float] = None

    @property
    def dynamic(self) -> bool:
        """True when this scheduler's world is time-varying (or its
        aggregation is importance-weighted): such horizons plan solo in
        :func:`plan_horizons_batch`."""
        return (self.fading is not None or self.faults is not None
                or self.energy is not None
                or (self.sampling is not None and self.sampling.weighted))

    def _draw_participation(self, periods: int) -> Optional[np.ndarray]:
        """The next ``periods`` cohort masks (None when unsampled); one
        draw per planned period, so chunked horizons consume the stream
        as the monolithic plan does."""
        if self._participation is None:
            return None
        return self._participation.draw(periods)

    def _draw_dynamics(self, periods: int):
        """Advance the fading and fault streams by ``periods`` (a fixed
        number of variates per period on each).  Returns ``(gains,
        slowdown, keep)``, each ``(P, K)`` or None."""
        gains = (None if self._fading_proc is None
                 else self._fading_proc.draw(periods))
        slow = keep = None
        if self._faults_proc is not None:
            slow, keep = self._faults_proc.draw(periods)
        return gains, slow, keep

    def _compose_avail(self, part: Optional[np.ndarray],
                       keep: Optional[np.ndarray],
                       periods: int) -> Optional[np.ndarray]:
        """Participation ∧ dropout.  An array whenever faults or a budget
        are *configured* (mask presence is a function of the spec, never
        of realized values, so every chunk lowers alike), None only in
        the static-mask world.  A period nobody would survive keeps its
        cohort instead of starving the aggregation."""
        if keep is None and self.energy is None:
            return part
        base = (np.ones((periods, len(self.devices)))
                if part is None else np.asarray(part, float))
        if keep is None:
            return base
        avail = base * keep
        dead = avail.sum(1) <= 0
        if dead.any():
            avail = np.where(dead[:, None], base, avail)
        return avail

    def _shed_energy(self, batch_f: np.ndarray, avail: np.ndarray,
                     tau_up: np.ndarray, rates_up_p: np.ndarray,
                     periods: int):
        """Budget enforcement after the per-period solve: clip each user
        to the batch it can afford at its uplink slot; a user that cannot
        afford its minimum batch drops for the period, unless that would
        empty the round (then the period runs at the minimum batch).  An
        unreachable budget is the exact identity (``min(B, inf) == B``,
        nobody drops)."""
        c = self.cell.cfg
        fr = FleetRows.from_devices(self.devices, periods)
        cap = batch_caps(self.energy, fr, tau_up, rates_up_p,
                         self.payload_bits, c.frame_up_s)
        floor_cap = np.floor(cap)
        active = avail > 0.5
        drop = active & (floor_cap < fr.lo)
        dead = ~((active & ~drop).any(1))
        drop &= ~dead[:, None]
        batch_f = np.where(drop, 0.0,
                           np.minimum(batch_f, np.maximum(floor_cap, fr.lo)))
        avail = np.where(drop, 0.0, avail)
        return batch_f, avail

    def _realize(self, batch_f: np.ndarray, avail: Optional[np.ndarray],
                 tau_up: np.ndarray, tau_down: np.ndarray,
                 rates_up: np.ndarray, rates_down: np.ndarray,
                 gains: Optional[np.ndarray], slow: Optional[np.ndarray],
                 periods: int):
        """Re-price the horizon at the REALIZED world (per-period fading
        gains, straggler slowdowns, the post-shed cohort), with the
        solver's ledger arithmetic operand for operand: identity dynamics
        give the solver's own latency bitwise.  Returns ``(latency,
        energy)``; ``energy`` is the per-user spend under a budget, else
        None.  Stores the chunk's mean comm/comp split for
        :meth:`recommend_tau`."""
        c = self.cell.cfg
        s = self.payload_bits
        fr = FleetRows.from_devices(self.devices, periods)
        if avail is not None:
            fr = fr.with_mask(avail)
        ru = rates_up if gains is None else rates_up * gains
        rd = rates_down if gains is None else rates_down * gains
        t_local = fr.local_latency(batch_f)
        if slow is not None:
            t_local = t_local * slow
        t_up = s * c.frame_up_s / (np.maximum(tau_up, 1e-30) * ru)
        t_down = s * c.frame_down_s / (np.maximum(tau_down, 1e-30) * rd)
        latency = fr.mmax(t_local + t_up) + fr.mmax(t_down + fr.t_upd)
        energy = None
        if self.energy is not None:
            energy = np.where(fr.active,
                              energy_spend(self.energy, t_local, t_up), 0.0)
        self._last_lat = float(np.mean(latency))
        self._last_comp = float(np.mean(fr.mmax(t_local)))
        return latency, energy

    def recommend_tau(self, choices, current: int) -> int:
        """Score each candidate local-steps count with the paper's
        learning-efficiency criterion at the last chunk's realized
        comm/comp split, E(τ) = min(ξ√(τ·B̄), cap) / (t_comm + τ·t_comp),
        and return the best; ties break toward fewer steps.  Before any
        feedback, and for the fixed policies (no ``_b_cache``), the
        current τ stands."""
        if self._last_lat is None or self._last_comp is None \
                or self._b_cache is None:
            return current
        try:
            b_bar = float(np.mean(self._b_cache))
        except (TypeError, ValueError):
            return current
        comp = max(self._last_comp, 0.0)
        comm = max(self._last_lat - comp, 1e-12)
        cap = self.xi_est.decay_cap
        best, best_e = current, -np.inf
        for t in sorted(choices):
            dl = self.xi_est.xi * float(np.sqrt(t * b_bar))
            if cap is not None:
                dl = min(dl, cap)
            e = dl / (comm + t * comp)
            if e > best_e:
                best, best_e = t, e
        return int(best)

    def _aggden(self, full_batch: np.ndarray) -> Optional[np.ndarray]:
        """Weighted sampling's Horvitz-Thompson fixed denominator
        p·Σ_all b̄_k from the full-fleet plan (None unweighted); dropout
        folds its survival probability into p."""
        if self.sampling is None or not self.sampling.weighted:
            return None
        p_inc = self.sampling.p_of(len(self.devices))
        if self.faults is not None:
            p_inc *= self.faults.keep_prob
        return p_inc * full_batch.sum(1).astype(np.float64)

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

    def plan_horizon(self, periods: int, warm_start: bool = False,
                     closed_loop: bool = False) -> PlanHorizon:
        """Plan ``periods`` consecutive periods open-loop and stack them.

        Channel fading is re-drawn per period; ξ is frozen at its current
        estimate for the whole horizon.  Successive calls continue the rng
        streams, so N chunked calls equal one monolithic call bitwise.
        The closed loop (``api.lowering.BucketRun``) calls this once a
        chunk with ``observe_series`` feedback in between.

        ``warm_start`` narrows the outer B* candidate grid to
        ``[b/2, 2b]`` around the previous solution (``_b_cache``) at 33
        candidates instead of 97.  It changes which candidates are
        evaluated, so only the closed loop turns it on.

        ``closed_loop`` lets the realized decays steer B*: a scalar ξ
        cancels from every Algorithm-1 decision, so the estimator's
        ``decay_cap`` caps the decay credited to a B* candidate, and a
        fading planner prices the chunk at the chain's current gain
        instead of the horizon's first.  Off, the planner is the paper's
        open-loop model.

        The draw order is participation, then dynamics (fading, faults),
        then one interleaved rate draw for all K users: a sampled horizon
        still draws rates, and random-policy batches, for every user.
        With ``topology`` set, Algorithm 1 allocates per cell per period
        and the ledger adds the edge→cloud backhaul on cloud rounds
        (``PlanHorizon.cloud``)."""
        part = self._draw_participation(periods)
        dyn = self._draw_dynamics(periods)
        if self.topology is not None:
            return self._plan_horizon_topo(periods, part, warm_start,
                                           closed_loop)
        if self.policy == "proposed":
            return self._plan_horizon_proposed(periods, warm_start,
                                               closed_loop, part, dyn)
        return self._plan_horizon_fixed(periods, part, dyn, closed_loop)

    def _belief(self, rates_up, rates_down, gains, closed_loop):
        """Rates as the planner prices them under fading: open loop at the
        horizon's first realized gain (the paper's static assumption, and
        chunking-invariant), closed loop at the chain's gain at the chunk
        start.  The ledger is priced at the realized gains by
        ``_realize``."""
        if gains is None:
            return rates_up, rates_down
        pg = self._fading_proc.planning_gain(closed_loop)[None, :]
        return rates_up * pg, rates_down * pg

    def _plan_horizon_fixed(self, periods: int,
                            part: Optional[np.ndarray] = None,
                            dyn=(None, None, None),
                            closed_loop: bool = False) -> PlanHorizon:
        """Fixed-batch baselines, whole horizon in one lockstep evaluation:
        one batched interleaved (up, down) channel draw, one (P, K)
        integer block for the random policy, and the equal-slot latency
        math of ``solver.fixed_slot_rows``.

        ``part`` (cohort masks) and dropout restrict the equal slots to
        the period's cohort; the random policy still draws its full
        (P, K) block first.  A budget sheds load after the slot math, and
        any dynamics re-price the ledger at the realized world."""
        c = self.cell.cfg
        K = len(self.devices)
        gains, slow, keep = dyn
        rates_up, rates_down = self.cell.avg_rate_updown_rows(
            self._dist_km, periods)
        pup, pdown = self._belief(rates_up, rates_down, gains, closed_loop)
        if self.policy == "online":
            batch = np.ones((periods, K))
        elif self.policy == "full":
            batch = np.full((periods, K), float(self.b_max))
        else:                                    # random
            batch = self.rng.integers(
                1, self.b_max + 1, size=(periods, K)).astype(float)
        avail = self._compose_avail(part, keep, periods)
        if avail is None:
            tau_up, tau_down, latency = fixed_slot_rows(
                self.devices, batch, pup, pdown,
                self.payload_bits, c.frame_up_s, c.frame_down_s)
            batch_f = batch
        else:
            fr = FleetRows.from_devices(self.devices,
                                        periods).with_mask(avail)
            tau_up, tau_down, latency = fixed_slot_rows(
                fr, batch * avail, pup, pdown,
                self.payload_bits, c.frame_up_s, c.frame_down_s)
            batch_f = batch * avail
        mask_now = avail
        if self.energy is not None:
            batch_f, mask_now = self._shed_energy(batch_f, mask_now,
                                                  tau_up, pup, periods)
        if mask_now is None:
            ib = np.maximum(np.round(batch).astype(int), 1)
        else:
            ib = np.where(mask_now > 0.5,
                          np.maximum(np.round(batch_f).astype(int), 1), 0)
        # the policy batch is the full-fleet plan here
        aggden = self._aggden(np.maximum(np.round(batch).astype(int), 1))
        energy_led = None
        if gains is not None or slow is not None or self.energy is not None:
            latency, energy_led = self._realize(
                batch_f, mask_now, tau_up, tau_down,
                rates_up, rates_down, gains, slow, periods)
        gb = ib.sum(1)
        self._period += periods
        return PlanHorizon(
            batch=ib, tau_up=tau_up, tau_down=tau_down,
            lr=self.base_lr * np.sqrt(gb / self.ref_batch),
            latency=latency, global_batch=gb.astype(np.int64),
            participation=mask_now, aggden=aggden, energy=energy_led,
            slowdown=slow)

    def _plan_horizon_proposed(self, periods: int, warm_start: bool = False,
                               closed_loop: bool = False,
                               part: Optional[np.ndarray] = None,
                               dyn=(None, None, None)) -> PlanHorizon:
        c = self.cell.cfg
        gains, slow, keep = dyn
        # one batched interleaved (up, down) channel draw, for ALL K users
        # even when sampled (the cohort mask selects)
        rates_up, rates_down = self.cell.avg_rate_updown_rows(
            self._dist_km, periods)
        pup, pdown = self._belief(rates_up, rates_down, gains, closed_loop)
        weighted = self.sampling is not None and self.sampling.weighted
        avail = self._compose_avail(part, keep, periods)
        # no mask keeps the plain devices path; a cohort mask routes
        # through the masked rows solver.  Weighted (Horvitz-Thompson)
        # aggregation plans the FULL fleet instead, so every user owns a
        # planned share for the fixed denominator, and the mask applies
        # only to the executed schedule.
        solve_mask = None if weighted else avail
        rows = (self.devices if solve_mask is None else
                FleetRows.from_devices(self.devices, periods)
                .with_mask(solve_mask))
        xi = self.xi_est.xi
        # B* re-optimized on the reopt cadence; rows are independent given
        # their rates, so every reopt period solves in one batched call
        reopt = np.array([(self._period + p) % self.reopt_every == 0
                          or (p == 0 and self._b_cache is None)
                          for p in range(periods)])
        B = np.empty(periods)
        carry = self._b_cache
        if reopt.any():
            warm = warm_start and self._b_cache is not None
            b_prev = (np.full(int(reopt.sum()), self._b_cache)
                      if warm else None)
            cap = self.xi_est.decay_cap if closed_loop else None
            b_star = optimize_batch_rows(
                rows if solve_mask is None else rows.take(reopt),
                pup[reopt], pdown[reopt],
                self.payload_bits, c.frame_up_s, c.frame_down_s, xi,
                self.b_max, b_prev=b_prev,
                n_candidates=33 if warm else 97,
                dl_cap=(None if cap is None
                        else np.full(int(reopt.sum()), cap)),
                energy=self.energy)
            j = 0
            for p in range(periods):
                if reopt[p]:
                    carry = float(b_star[j])
                    j += 1
                B[p] = carry
        else:
            B[:] = carry
        sol = solve_period_rows(rows, pup, pdown,
                                self.payload_bits, c.frame_up_s,
                                c.frame_down_s, xi, B, self.b_max)
        self._b_cache = float(B[-1])
        self._period += periods
        batch_f = sol["batch"]
        mask_now = avail
        if self.energy is not None:
            batch_f, mask_now = self._shed_energy(batch_f, mask_now,
                                                  sol["tau_up"], pup,
                                                  periods)
        batch = np.maximum(np.round(batch_f).astype(int), 1)
        # the fixed denominator comes from the full-fleet plan, BEFORE the
        # cohort mask zeroes the absentees
        aggden = self._aggden(batch)
        if mask_now is not None:
            batch = np.where(mask_now > 0.5, batch, 0)
        gb = batch.sum(1)
        # the realized-world ledger re-price (and the adaptive-τ
        # bookkeeping); the static world keeps the solver's own latency
        realize = (gains is not None or slow is not None
                   or self.energy is not None or weighted)
        rl, energy_led = self._realize(
            batch_f, mask_now, sol["tau_up"], sol["tau_down"],
            rates_up, rates_down, gains, slow, periods)
        latency = rl if realize else sol["latency"]
        energy_led = energy_led if realize else None
        return PlanHorizon(
            batch=batch, tau_up=sol["tau_up"], tau_down=sol["tau_down"],
            lr=np.array([lr_scale(self.base_lr, g, self.ref_batch)
                         for g in gb], np.float64),
            latency=latency, global_batch=gb.astype(np.int64),
            participation=mask_now, aggden=aggden, energy=energy_led,
            slowdown=slow)

    def _plan_horizon_topo(self, periods: int,
                           part: Optional[np.ndarray],
                           warm_start: bool = False,
                           closed_loop: bool = False) -> PlanHorizon:
        """Hierarchical horizon: Algorithm 1 allocates *within each cell*
        per period (one masked row per (cell, period), cell-major: row
        ``c*P + p``), and cloud-round periods add the edge→cloud backhaul
        round trip to the latency ledger.

        The wireless draws are the flat scenario's: one disc draw, one
        batched rate draw for all K users, so the cell partition enters
        only as a mask on the rows solver.  The period's radio latency is
        the slowest cell's round (cells transmit concurrently); per-user
        arrays recombine by summing the disjoint per-cell rows.

        A cell whose whole cohort is sampled out this period solves a
        dummy problem (its full-cell mask) that is zeroed from every
        output and consumes no rng; the cell's B* carry is not advanced.
        """
        topo = self.topology
        c = self.cell.cfg
        K = len(self.devices)
        C, P = topo.cells, periods
        cloud = topo.cloud_rounds(periods, offset=self._period)
        rates_up, rates_down = self.cell.avg_rate_updown_rows(
            self._dist_km, periods)
        cmask = topo.cell_masks(K)                        # (C, K)
        mask = (cmask[:, None, :] if part is None
                else cmask[:, None, :] * part[None])      # (C, P, K)
        mask = np.broadcast_to(mask, (C, P, K))
        nonempty = mask.sum(2) > 0                        # (C, P)
        solve_mask = np.where(nonempty[:, :, None], mask,
                              np.broadcast_to(cmask[:, None, :],
                                              (C, P, K))).reshape(C * P, K)
        fr = FleetRows.from_devices(self.devices,
                                    C * P).with_mask(solve_mask)
        flat_up = np.broadcast_to(rates_up, (C, P, K)).reshape(C * P, K)
        flat_down = np.broadcast_to(rates_down,
                                    (C, P, K)).reshape(C * P, K)
        if self.policy == "proposed":
            xi = self.xi_est.xi
            carry = (np.full(C, np.nan) if self._b_cache is None
                     else np.asarray(self._b_cache, float).copy())
            base = np.array([(self._period + p) % self.reopt_every == 0
                             for p in range(P)])
            # per-cell B* cadence; a cold cell re-opts at its first
            # non-empty period even off-cadence
            reopt_cp = np.zeros((C, P), bool)
            cold = np.isnan(carry)
            for p in range(P):
                need = nonempty[:, p] & (base[p] | cold)
                reopt_cp[:, p] = need
                cold = cold & ~need
            rf = reopt_cp.reshape(C * P)
            B_cp = np.empty((C, P))
            if rf.any():
                # warm unless every cell is still cold
                warm = warm_start and not np.isnan(carry).all()
                b_prev = (np.repeat(carry, P)[rf] if warm else None)
                cap = self.xi_est.decay_cap if closed_loop else None
                b_star = optimize_batch_rows(
                    fr.take(rf), flat_up[rf], flat_down[rf],
                    self.payload_bits, c.frame_up_s, c.frame_down_s, xi,
                    self.b_max, b_prev=b_prev,
                    n_candidates=33 if warm else 97,
                    dl_cap=(None if cap is None
                            else np.full(int(rf.sum()), cap)))
                j = 0
                for ci in range(C):
                    cur = carry[ci]
                    for p in range(P):
                        if reopt_cp[ci, p]:
                            cur = float(b_star[j])
                            j += 1
                        B_cp[ci, p] = 1.0 if np.isnan(cur) else cur
                    carry[ci] = cur
            else:
                B_cp[:] = np.where(np.isnan(carry), 1.0, carry)[:, None]
            sol = solve_period_rows(fr, flat_up, flat_down,
                                    self.payload_bits, c.frame_up_s,
                                    c.frame_down_s, xi,
                                    B_cp.reshape(C * P), self.b_max)
            bt = np.where(fr.active,
                          np.maximum(np.round(np.nan_to_num(sol["batch"]))
                                     .astype(int), 1), 0)
            tau_u_r, tau_d_r = sol["tau_up"], sol["tau_down"]
            lat_r = sol["latency"]
            self._b_cache = carry
        else:                                    # online / full / random
            if self.policy == "online":
                pol = np.ones((P, K))
            elif self.policy == "full":
                pol = np.full((P, K), float(self.b_max))
            else:
                pol = self.rng.integers(
                    1, self.b_max + 1, size=(P, K)).astype(float)
            batch_rows = np.broadcast_to(pol, (C, P, K)).reshape(C * P, K)
            tau_u_r, tau_d_r, lat_r = fixed_slot_rows(
                fr, batch_rows * solve_mask, flat_up, flat_down,
                self.payload_bits, c.frame_up_s, c.frame_down_s)
            bt = np.where(fr.active,
                          np.maximum(np.round(batch_rows).astype(int), 1),
                          0)
        # recombine: zero the dummy rows, sum disjoint cells per user,
        # barrier (max) across concurrent cells per period
        live = nonempty[:, :, None]
        bt = np.where(live, bt.reshape(C, P, K), 0)
        tau_up = np.where(live, np.nan_to_num(tau_u_r).reshape(C, P, K),
                          0.0).sum(0)
        tau_down = np.where(live, np.nan_to_num(tau_d_r).reshape(C, P, K),
                            0.0).sum(0)
        radio = np.where(nonempty, np.nan_to_num(lat_r).reshape(C, P),
                         0.0).max(0)
        latency = radio + cloud.astype(float) * topo.backhaul_roundtrip(
            self.payload_bits)
        batch = bt.sum(0)                                 # (P, K)
        gb = batch.sum(1)
        if self.policy == "proposed":
            lr = np.array([lr_scale(self.base_lr, g, self.ref_batch)
                           for g in gb], np.float64)
        else:
            lr = self.base_lr * np.sqrt(gb / self.ref_batch)
        self._period += periods
        return PlanHorizon(
            batch=batch, tau_up=tau_up, tau_down=tau_down, lr=lr,
            latency=latency, global_batch=gb.astype(np.int64),
            participation=part, cloud=cloud)

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
                        periods: int, warm_start: bool = False,
                        closed_loop: bool = False) -> List[PlanHorizon]:
    """Plan many schedulers' horizons with proposed-policy rows fused —
    across fleets of any size or composition.

    ``warm_start`` and ``closed_loop`` forward to every solve (see
    :meth:`FeelScheduler.plan_horizon`): in the fused group a cold row's
    hint is NaN and the warm 33-candidate grid is used only if some row
    has a hint; a row without a decay cap gets inf, and caps are passed
    only if some row has one.

    Hierarchical schedulers (``topology``) and dynamic ones
    (``FeelScheduler.dynamic``: fading, faults, a budget or weighted
    sampling) plan solo; unweighted sampling fuses,
    its cohort masks drawn first as ``plan_horizon`` draws them.

    With both flags off, bitwise equal to ``[s.plan_horizon(periods) for
    s in schedulers]`` (the adaptive-τ bookkeeping aside, which the
    fused group computes on its padded rows instead of through
    ``_realize``):
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
        if s.policy != "proposed" or s.topology is not None or s.dynamic:
            # hierarchical horizons solve per (cell, period) with their
            # own reopt bookkeeping: solo, as time-varying worlds
            out[i] = s.plan_horizon(periods, warm_start=warm_start,
                                    closed_loop=closed_loop)
        else:
            key = (s.payload_bits, s.cell.cfg.frame_up_s,
                   s.cell.cfg.frame_down_s, s.b_max, s.reopt_every)
            groups[key].append(i)
    for key, idxs in groups.items():
        if len(idxs) == 1:
            out[idxs[0]] = schedulers[idxs[0]].plan_horizon(
                periods, warm_start=warm_start, closed_loop=closed_loop)
            continue
        scheds = [schedulers[i] for i in idxs]
        s0 = scheds[0]
        c = s0.cell.cfg
        M, P = len(scheds), periods
        ks = [len(s.devices) for s in scheds]
        K = max(ks)
        fleet_rows = FleetRows.from_fleets(
            [tuple(s.devices) for s in scheds], k_pad=K)
        # participation first, as plan_horizon draws it
        parts = [s._draw_participation(P) for s in scheds]
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
        if any(p_m is not None for p_m in parts):
            pm = np.ones((M, P, K))
            for m, p_m in enumerate(parts):
                if p_m is not None:              # pad columns stay 1; the
                    pm[m, :, :ks[m]] = p_m       # fleet mask zeroes them
            flat_fleets = flat_fleets.with_mask(pm.reshape(M * P, K))
        xi_rows = np.repeat(xi, P)
        B = np.empty((M, P))
        if reopt.any():
            rf = reopt.reshape(M * P)
            b_prev = None
            n_cand = 97
            if warm_start:
                # per-scheduler previous-solution hints (NaN = cold row)
                prev = np.repeat(np.array(
                    [np.nan if s._b_cache is None else s._b_cache
                     for s in scheds]), P)[rf]
                if np.isfinite(prev).any():
                    b_prev = prev
                    n_cand = 33
            dl_cap = None
            if closed_loop:
                caps = np.repeat(np.array(
                    [np.inf if s.xi_est.decay_cap is None
                     else s.xi_est.decay_cap for s in scheds]), P)[rf]
                if np.isfinite(caps).any():
                    dl_cap = caps
            b_star = optimize_batch_rows(
                flat_fleets.take(rf), flat_up[rf], flat_down[rf],
                s0.payload_bits, c.frame_up_s, c.frame_down_s, xi_rows[rf],
                s0.b_max, b_prev=b_prev, n_candidates=n_cand,
                dl_cap=dl_cap)
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
        # round active batches up to >= 1; padded columns and sampled-out
        # users stay exactly 0
        batch = np.where(flat_fleets.active.reshape(M, P, K),
                         np.maximum(np.round(sol["batch"]).astype(int)
                                    .reshape(M, P, K), 1), 0)
        gb = batch.sum(2)
        # adaptive-τ bookkeeping (no output depends on it): each
        # scheduler's mean comm/comp split, from the unrounded batches of
        # the padded rows (the reference's arithmetic, not _realize's)
        comp_mp = flat_fleets.mmax(
            flat_fleets.local_latency(sol["batch"])).reshape(M, P)
        lat_mp = sol["latency"].reshape(M, P)
        for m, (i, s) in enumerate(zip(idxs, scheds)):
            s._b_cache = float(B[m, -1])
            s._period += P
            s._last_lat = float(np.mean(lat_mp[m]))
            s._last_comp = float(np.mean(comp_mp[m]))
            k_m = ks[m]                          # slice back to the true K
            out[i] = PlanHorizon(
                batch=batch[m, :, :k_m],
                tau_up=sol["tau_up"].reshape(M, P, K)[m, :, :k_m],
                tau_down=sol["tau_down"].reshape(M, P, K)[m, :, :k_m],
                lr=np.array([lr_scale(s.base_lr, g, s.ref_batch)
                             for g in gb[m]], np.float64),
                latency=sol["latency"].reshape(M, P)[m],
                global_batch=gb[m].astype(np.int64),
                participation=parts[m])
    return out


# ---------------------------------------------------------------------------
# Per-device-parameter schemes (individual / model_fl)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DevHorizon:
    """Pre-planned horizon of the per-device-parameter schemes: everything
    the dev loop consumes, one array per field, leading period axis."""
    idx: np.ndarray              # (P, K, batch) int64 sample indices
    times: np.ndarray            # (P,) cumulative simulated seconds
    tau_up: np.ndarray           # (P, K) equal TDMA slots
    tau_down: np.ndarray         # (P, K)
    rates_up: np.ndarray         # (P, K)
    rates_down: np.ndarray       # (P, K)
    participation: Optional[np.ndarray] = None   # (P, K) f32 {0,1}

    @property
    def periods(self) -> int:
        return self.idx.shape[0]


@dataclass
class DevScheduler:
    """Horizon planner for ``individual`` / ``model_fl``: each period is
    one local epoch at a fixed per-device batch; ``model_fl`` adds the
    model's upload and broadcast over equal TDMA slots (eqs. (10) and
    (11)).  Channel rates come from the batched interleaved (up, down)
    draw the FEEL planner uses."""
    devices: Sequence[DeviceProfile]
    parts: Sequence[np.ndarray]          # per-device index sets
    batch: int                           # fixed per-device batchsize
    payload_bits: float                  # model upload: d·p, uncompressed
    upload: bool                         # model_fl syncs; individual doesn't
    seed: int = 0
    cell: Optional[Cell] = None
    cell_cfg: CellConfig = field(default_factory=CellConfig)
    sampling: Optional[Sampling] = None    # per-round S-of-K participation

    def __post_init__(self):
        if self.cell is None:
            self.cell = Cell.make(self.seed, self.cell_cfg)
        self.rng = np.random.default_rng(self.seed)
        self._dist_km = self.cell.drop_users(len(self.parts))
        self._participation = (
            None if self.sampling is None else
            ParticipationSampler(self.sampling, len(self.parts), self.seed))

    def plan_horizon(self, periods: int,
                     time_offset: float = 0.0) -> DevHorizon:
        """Plan ``periods`` periods.  ``time_offset`` seeds the cumulative
        time axis (the seeded cumsum is the only form bitwise equal to
        the monolithic ledger; 0.0 is the plain cumsum).

        The draw order is the participation masks, then K ``rng.choice``
        index draws a period, then one ``avg_rate_updown_rows``.  With
        ``sampling`` set each period's cohort alone splits the TDMA frame
        (equal slots over S, zero for absent users) and alone enters the
        straggler max; every draw is still made for all K users, so who
        sat out leaves every stream as it is."""
        K = len(self.parts)
        c = self.cell.cfg
        part = (None if self._participation is None
                else self._participation.draw(periods))
        idx = np.empty((periods, K, self.batch), np.int64)
        for p in range(periods):
            idx[p] = np.stack(
                [self.rng.choice(part_k, size=self.batch,
                                 replace=len(part_k) < self.batch)
                 for part_k in self.parts])
        rates_up, rates_down = self.cell.avg_rate_updown_rows(
            self._dist_km, periods)
        # one local epoch per period: ⌈|D_k|/B⌉ minibatch steps
        t_local = np.array([
            d.local_grad_latency(self.batch) * max(1, len(p_k) // self.batch)
            for d, p_k in zip(self.devices, self.parts)])
        if part is None:
            tau_u = np.full((periods, K), c.frame_up_s / K)
            tau_d = np.full((periods, K), c.frame_down_s / K)
        else:
            # float64 cohort sizes: the f32 mask must not demote the slot
            # widths below the unsampled path's precision
            s_p = part.astype(np.float64).sum(1)     # >= 1 per period
            tau_u = np.where(part > 0.5, c.frame_up_s / s_p[:, None], 0.0)
            tau_d = np.where(part > 0.5, c.frame_down_s / s_p[:, None], 0.0)
        if self.upload:
            # absent users get a dummy full-frame slot for the latency
            # math (finite, warning-free) and are then masked out of the
            # straggler max; unsampled, the where keeps tau as it is
            su = np.where(tau_u > 0, tau_u, c.frame_up_s)
            sd = np.where(tau_d > 0, tau_d, c.frame_down_s)
            t_up = uplink_latency(self.payload_bits, su, c.frame_up_s,
                                  rates_up)
            t_down = downlink_latency(self.payload_bits, sd,
                                      c.frame_down_s, rates_down)
            t_upd = np.array([d.update_latency() for d in self.devices])
            up_leg = t_local + t_up
            down_leg = t_down + t_upd
            if part is not None:
                up_leg = np.where(part > 0.5, up_leg, 0.0)
                down_leg = np.where(part > 0.5, down_leg, 0.0)
            per_period = up_leg.max(1) + down_leg.max(1)
        elif part is None:
            per_period = np.full(periods, t_local.max())
        else:
            per_period = np.where(part > 0.5, t_local[None, :], 0.0).max(1)
        times = np.cumsum(np.concatenate([[time_offset], per_period]))[1:]
        return DevHorizon(idx=idx, times=times,
                          tau_up=tau_u, tau_down=tau_d,
                          rates_up=rates_up, rates_down=rates_down,
                          participation=part)
