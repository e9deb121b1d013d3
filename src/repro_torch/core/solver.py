"""Joint batchsize selection + communication resource allocation: the
paper's Algorithm 1 per period, and its lockstep rows form.

Unified affine latency ``t^L_k = a_k + b_k·B_k`` covers both the CPU and
the GPU device scenario; the KKT system of Appendix A then gives

    λ_k* = ρ'_k/ΔL          with  ρ'_k = (1/b_k)/Σ_j(1/b_j)
    B_k*  = clip[(ΔL·E^U − a_k − sqrt(ΔL·s·T_f·μ/(ρ'_k·R_k))) / b_k]
    τ_k*  = (s/R_k) / (ΔL·E^U − a_k − b_k·B_k*) · T_f

(Theorem 1 when a=0, b=1/V_k).  The scalar functions implement Theorem
1's and Theorem 2's closed forms, Corollary 1's and 2's bounds, Algorithm
1's two-dimensional bisection over (E^U*, μ*) (:func:`solve_uplink`),
Theorem 2's downlink bisection (:func:`solve_downlink`) and the outer
golden-section search over the global batch B (:func:`solve_period`).
The ``*_rows`` functions run the same bisections for M independent
periods ("rows") at once, with fixed iteration counts.

A copy of the reference's solver: the same operations in the same order,
so every plan is bitwise the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.latency import (DeviceProfile, downlink_latency,
                                      period_latency, uplink_latency)


@dataclass(frozen=True)
class UplinkSolution:
    batch: np.ndarray          # B_k*
    tau: np.ndarray            # τ_k^U*  (seconds of each frame)
    e_up: float                # E^U* = max_k (t^L+t^U)/ΔL  (reciprocal eff.)
    mu: float


@dataclass(frozen=True)
class DownlinkSolution:
    tau: np.ndarray
    e_down: float


@dataclass(frozen=True)
class PeriodSolution:
    global_batch: float
    batch: np.ndarray
    tau_up: np.ndarray
    tau_down: np.ndarray
    latency: float             # predicted T (s)
    efficiency: float          # predicted E = ΔL/T
    e_up: float
    e_down: float


def _affine(devices: Sequence[DeviceProfile]):
    ab = np.array([d.affine() for d in devices])
    return ab[:, 0], ab[:, 1]


def _rho_prime(b: np.ndarray) -> np.ndarray:
    inv = 1.0 / b
    return inv / inv.sum()


# ---------------------------------------------------------------------------
# Theorem 1 closed forms
# ---------------------------------------------------------------------------


def batch_closed_form(e_up, mu, devices, rates, s_bits, frame, dl,
                      b_max: int) -> np.ndarray:
    """Theorem 1, first line (affine-generalized)."""
    a, b = _affine(devices)
    rho = _rho_prime(b)
    lo = np.array([d.batch_lo() for d in devices], float)
    raw = (dl * e_up - a - np.sqrt(dl * s_bits * frame * mu / (rho * rates))) / b
    return np.clip(raw, lo, b_max)


def tau_closed_form(e_up, mu, devices, rates, s_bits, frame, dl,
                    b_max: int) -> np.ndarray:
    """Theorem 1, second line: slots making every device finish at ΔL·E^U."""
    a, b = _affine(devices)
    bt = batch_closed_form(e_up, mu, devices, rates, s_bits, frame, dl, b_max)
    denom = dl * e_up - a - b * bt
    return np.where(denom > 0,
                    s_bits / rates / np.maximum(denom, 1e-30) * frame,
                    np.inf)


# ---------------------------------------------------------------------------
# Corollary 1 / 2 bounds
# ---------------------------------------------------------------------------


def e_up_bounds(B, devices, rates, s_bits, frame, dl):
    """Corollary 1 (affine-generalized).

    Lower: infinite-memory KKT point.  Upper: equal-share allocation.
    """
    a, b = _affine(devices)
    K = len(devices)
    rho = _rho_prime(b)
    # lower bound: relax batch bounds; E = (Σ-weighted local + comm) / ΔL
    t_comp = (B / (1.0 / b).sum()) + float(np.dot(rho, a))
    t_comm = s_bits * (np.sqrt(rho / rates).sum()) ** 2
    lo = (t_comp + t_comm) / dl
    # upper bound: B_k = B/K, τ_k = T_f/K
    hi = np.max(a + b * (B / K) + K * s_bits / rates) / dl
    return max(lo, 1e-12), max(hi * 1.0000001, lo * 1.001)


def mu_bounds(e_up, devices, rates, s_bits, frame, dl, b_max):
    """Corollary 2 (affine-generalized)."""
    a, b = _affine(devices)
    rho = _rho_prime(b)
    lo_k = np.array([d.batch_lo() for d in devices], float)
    up = (dl * e_up - a - b * lo_k)
    dn = (dl * e_up - a - b * b_max)
    mu_hi = np.max(np.maximum(up, 0.0) ** 2 * rho * rates / (dl * s_bits * frame))
    mu_lo = np.min(np.maximum(dn, 0.0) ** 2 * rho * rates / (dl * s_bits * frame))
    return mu_lo, max(mu_hi, mu_lo + 1e-30)


# ---------------------------------------------------------------------------
# Algorithm 1: two-dimensional search
# ---------------------------------------------------------------------------


def solve_uplink(devices: Sequence[DeviceProfile], rates: np.ndarray,
                 s_bits: float, frame: float, B: float, dl: float,
                 b_max: int, tol: float = 1e-9,
                 iters: int = 200) -> UplinkSolution:
    """Subproblem 𝒫₂ for fixed global batch B (Algorithm 1).

    Inner bisection: μ ↦ ΣB_k(E,μ) is decreasing; find μ with ΣB_k = B.
    Outer bisection: E ↦ Στ_k(E, μ(E)) is decreasing; find E with Στ = T_f.
    """
    rates = np.asarray(rates, float)
    a, b = _affine(devices)

    def batches(e_up, mu):
        return batch_closed_form(e_up, mu, devices, rates, s_bits, frame, dl,
                                 b_max)

    def mu_for(e_up):
        m_lo, m_hi = mu_bounds(e_up, devices, rates, s_bits, frame, dl, b_max)
        m_lo = max(m_lo * 0.5, 0.0)
        m_hi = max(m_hi * 2.0, 1e-30)
        # ΣB_k decreasing in μ
        for _ in range(iters):
            m = 0.5 * (m_lo + m_hi)
            if batches(e_up, m).sum() > B:
                m_lo = m
            else:
                m_hi = m
            if m_hi - m_lo < tol * max(m_hi, 1.0):
                break
        return 0.5 * (m_lo + m_hi)

    def tau_sum(e_up):
        mu = mu_for(e_up)
        bt = batches(e_up, mu)
        denom = dl * e_up - a - b * bt
        tau = np.where(denom > 1e-30, s_bits / rates / denom * frame, np.inf)
        return tau.sum(), mu, bt, tau

    e_lo, e_hi = e_up_bounds(B, devices, rates, s_bits, frame, dl)
    # ensure bracketing: Στ(e_lo) >= T_f >= Στ(e_hi)
    for _ in range(60):
        if tau_sum(e_hi)[0] <= frame:
            break
        e_hi *= 2.0
    for _ in range(iters):
        e_m = 0.5 * (e_lo + e_hi)
        ts, mu, bt, tau = tau_sum(e_m)
        if ts >= frame:
            e_lo = e_m
        else:
            e_hi = e_m
        if (e_hi - e_lo) < tol * e_hi:
            break
    e_star = e_hi
    ts, mu, bt, tau = tau_sum(e_star)
    # normalize slots onto the frame (numerical slack)
    if np.isfinite(tau).all() and tau.sum() > 0:
        tau = tau * (frame / tau.sum())
    return UplinkSolution(batch=bt, tau=tau, e_up=float(e_star), mu=float(mu))


def solve_downlink(devices: Sequence[DeviceProfile], rates: np.ndarray,
                   s_bits: float, frame: float, dl: float,
                   tol: float = 1e-9, iters: int = 200) -> DownlinkSolution:
    """Subproblem 𝒫₃ / Theorem 2: τ_k^D = (s/R)/(ΔL·E^D − t^M) with Στ = T_f."""
    rates = np.asarray(rates, float)
    t_up = np.array([d.update_latency() for d in devices])

    def tau_sum(e_d):
        denom = dl * e_d - t_up
        tau = np.where(denom > 1e-30, s_bits / rates / denom * frame, np.inf)
        return tau, tau.sum()

    e_lo = float(np.max(t_up) / dl) * (1 + 1e-12)
    e_hi = float(np.max(t_up + len(devices) * s_bits / rates) / dl) + 1e-12
    while tau_sum(e_hi)[1] > frame:
        e_hi *= 2.0
    for _ in range(iters):
        e_m = 0.5 * (e_lo + e_hi)
        if tau_sum(e_m)[1] >= frame:
            e_lo = e_m
        else:
            e_hi = e_m
        if (e_hi - e_lo) < tol * e_hi:
            break
    tau, _ = tau_sum(e_hi)
    if np.isfinite(tau).all() and tau.sum() > 0:
        tau = tau * (frame / tau.sum())
    return DownlinkSolution(tau=tau, e_down=float(e_hi))


# ---------------------------------------------------------------------------
# Lockstep rows form: the same bisections for M independent periods at once
# ---------------------------------------------------------------------------


def _profile_cols(devices: Sequence[DeviceProfile]) -> np.ndarray:
    """(10, K) per-device parameter columns (see FleetRows field order)."""
    return np.array([[*d.affine(), d.batch_lo(), d.update_latency(),
                      1.0 if d.kind == "cpu" else 0.0,
                      d.cycles_per_sample, d.f_cpu,
                      d.gpu_t_low, d.gpu_slope, d.gpu_b_th]
                     for d in devices], float).T


@dataclass(frozen=True)
class FleetRows:
    """Per-row device-parameter arrays + active mask for the rows solver.

    Row ``m`` holds one period's fleet: its first ``k_m`` columns are the
    row's true devices; columns beyond are *padding* (cyclic copies of the
    row's own profiles, so every entry is a valid device) with ``mask``
    0.  Latency formulas are evaluated with exactly the arithmetic
    ``DeviceProfile`` uses (same operand order per element), and every
    reduction over the user axis is mask-aware, so a padded row's solution
    is bit-identical to solving its compact fleet alone, and an all-ones
    mask reproduces the shared-fleet solver verbatim (both test-enforced).
    """
    a: np.ndarray          # (M, K) affine intercepts  t^L = a + b·B
    b: np.ndarray          # (M, K) affine slopes
    lo: np.ndarray         # (M, K) batch lower bounds (1 / B_th)
    t_upd: np.ndarray      # (M, K) update latencies
    is_cpu: np.ndarray     # (M, K) bool — which latency branch applies
    cps: np.ndarray        # (M, K) CPU cycles per sample
    f_cpu: np.ndarray      # (M, K) CPU cycles/s
    g_t_low: np.ndarray    # (M, K) GPU t_l
    g_slope: np.ndarray    # (M, K) GPU c
    g_b_th: np.ndarray     # (M, K) GPU B_th
    mask: np.ndarray       # (M, K) {0,1} — 1 marks an active user row

    @classmethod
    def from_fleets(cls, fleets, k_pad: int | None = None) -> "FleetRows":
        """One row per fleet, padded (cyclic profiles, mask 0) to
        ``k_pad`` (default: the longest fleet)."""
        fleets = [tuple(f) for f in fleets]
        widest = max(len(f) for f in fleets)
        if k_pad is None:
            k_pad = widest
        elif k_pad < widest:
            raise ValueError(
                f"k_pad={k_pad} would truncate a {widest}-device fleet")
        mask = np.zeros((len(fleets), k_pad))
        cols = []
        for m, fleet in enumerate(fleets):
            padded = tuple(fleet[i % len(fleet)] for i in range(k_pad))
            cols.append(_profile_cols(padded))
            mask[m, :len(fleet)] = 1.0
        s = np.stack(cols)                        # (M, 10, K)
        return cls(a=s[:, 0], b=s[:, 1], lo=s[:, 2], t_upd=s[:, 3],
                   is_cpu=s[:, 4] > 0.5, cps=s[:, 5], f_cpu=s[:, 6],
                   g_t_low=s[:, 7], g_slope=s[:, 8], g_b_th=s[:, 9],
                   mask=mask)

    @classmethod
    def from_devices(cls, devices: Sequence[DeviceProfile],
                     m: int) -> "FleetRows":
        """One shared fleet broadcast to ``m`` rows, all users active."""
        c = _profile_cols(tuple(devices))
        bc = lambda r: np.broadcast_to(r, (m, c.shape[1]))       # noqa: E731
        return cls(a=bc(c[0]), b=bc(c[1]), lo=bc(c[2]), t_upd=bc(c[3]),
                   is_cpu=bc(c[4] > 0.5), cps=bc(c[5]), f_cpu=bc(c[6]),
                   g_t_low=bc(c[7]), g_slope=bc(c[8]), g_b_th=bc(c[9]),
                   mask=bc(np.ones(c.shape[1])))

    # ---- row bookkeeping --------------------------------------------------
    @property
    def rows(self) -> int:
        return self.a.shape[0]

    @property
    def active(self) -> np.ndarray:
        return self.mask > 0.5

    @property
    def k_active(self) -> np.ndarray:
        """(M,) active-user counts (float)."""
        return self.mask.sum(1)

    def _map(self, fn) -> "FleetRows":
        return FleetRows(**{f: fn(getattr(self, f)) for f in (
            "a", "b", "lo", "t_upd", "is_cpu", "cps", "f_cpu",
            "g_t_low", "g_slope", "g_b_th", "mask")})

    def repeat(self, c: int) -> "FleetRows":
        """Each row repeated ``c`` times consecutively (np.repeat)."""
        return self._map(lambda x: np.repeat(x, c, axis=0))

    def take(self, idx) -> "FleetRows":
        """Row subset (boolean or integer index along axis 0)."""
        return self._map(lambda x: np.asarray(x)[idx])

    def with_mask(self, mask: np.ndarray) -> "FleetRows":
        """Compose a further activity mask (per-round participation, cell
        membership) onto this one.  Multiplicative, so a participation
        mask can never resurrect a padded column, and an all-ones mask is
        a bitwise no-op (``mask * 1.0 == mask``)."""
        extra = np.broadcast_to(np.asarray(mask, float),
                                self.mask.shape)
        return FleetRows(**{f: getattr(self, f) for f in (
            "a", "b", "lo", "t_upd", "is_cpu", "cps", "f_cpu",
            "g_t_low", "g_slope", "g_b_th")}, mask=self.mask * extra)

    # ---- masked reductions / per-element latency --------------------------
    def mmax(self, x: np.ndarray) -> np.ndarray:
        return np.where(self.active, x, -np.inf).max(1)

    def mmin(self, x: np.ndarray) -> np.ndarray:
        return np.where(self.active, x, np.inf).min(1)

    def local_latency(self, batch_rows: np.ndarray) -> np.ndarray:
        """eq. (9) / (26) per element — bitwise the same arithmetic as
        ``DeviceProfile.local_grad_latency`` on each column."""
        batch = np.asarray(batch_rows, float)
        cpu = batch * self.cps / self.f_cpu
        gpu = np.where(batch <= self.g_b_th, self.g_t_low,
                       self.g_slope * (batch - self.g_b_th) + self.g_t_low)
        return np.where(self.is_cpu, cpu, gpu)


def as_fleet_rows(devices, m: int) -> FleetRows:
    """Normalize a ``devices`` argument: pass ``FleetRows`` through,
    broadcast a shared ``DeviceProfile`` sequence to ``m`` rows."""
    if isinstance(devices, FleetRows):
        if devices.rows != m:
            raise ValueError(
                f"FleetRows carries {devices.rows} rows, expected {m}")
        return devices
    return FleetRows.from_devices(devices, m)


def _ssum(x: np.ndarray) -> np.ndarray:
    """Strictly sequential row sum (cumsum), NOT ``np.sum``.

    numpy's pairwise summation changes its association at n = 8 (the
    8-accumulator unroll), so summing a zero-padded row would not be
    bit-equal to summing its compact prefix.  Sequential accumulation is
    invariant to trailing zeros (x + 0.0 == x), which is what makes the
    masked solver bit-identical to per-fleet compact solves — every row
    reduction feeding a bisection branch below must go through this."""
    return np.cumsum(x, axis=1)[:, -1]


def solve_uplink_rows(devices, rates: np.ndarray,
                      s_bits: float, frame: float, B: np.ndarray,
                      dl: np.ndarray, b_max: int, *, inner_iters: int = 42,
                      outer_iters: int = 42, expand_iters: int = 14):
    """Subproblem 𝒫₂ for M rows at once.  rates: (M,K); B, dl: (M,).

    ``devices``: a shared ``DeviceProfile`` sequence or per-row padded
    :class:`FleetRows` — masked columns get zero batchsize and zero slot
    share, and the bisection runs over active users only.

    Returns (batch (M,K), tau (M,K), e_up (M,), mu (M,)).
    """
    rates = np.asarray(rates, float)
    B = np.asarray(B, float)
    dl = np.asarray(dl, float)
    M, K = rates.shape
    fr = as_fleet_rows(devices, M)
    act = fr.active
    a, b, lo_k, ka = fr.a, fr.b, fr.lo, fr.k_active
    inv = np.where(act, 1.0 / b, 0.0)
    rho = inv / _ssum(inv)[:, None]
    # padded columns have rho = 0 exactly; guard their division
    rr = np.where(act, rho * rates, 1.0)
    dle = dl[:, None]

    def batches(e, mu):
        raw = (dle * e[:, None] - a
               - np.sqrt(dle * s_bits * frame * mu[:, None] / rr)) / b
        return np.where(act, np.clip(raw, lo_k, b_max), 0.0)

    def mu_for(e):
        # Corollary 2 bounds, then bisect ΣB_k(μ) = B (decreasing in μ)
        up = dle * e[:, None] - a - b * lo_k
        dn = dle * e[:, None] - a - b * b_max
        scale = rho * rates / (dle * s_bits * frame)
        m_hi = fr.mmax(np.maximum(up, 0.0) ** 2 * scale)
        m_lo = fr.mmin(np.maximum(dn, 0.0) ** 2 * scale)
        m_lo = np.maximum(m_lo * 0.5, 0.0)
        m_hi = np.maximum(m_hi * 2.0, 1e-30)
        for _ in range(inner_iters):
            m = 0.5 * (m_lo + m_hi)
            over = _ssum(batches(e, m)) > B
            m_lo = np.where(over, m, m_lo)
            m_hi = np.where(over, m_hi, m)
        return 0.5 * (m_lo + m_hi)

    def tau_sum(e):
        mu = mu_for(e)
        bt = batches(e, mu)
        denom = dle * e[:, None] - a - b * bt
        tau = np.where(denom > 1e-30,
                       s_bits / rates / np.maximum(denom, 1e-30) * frame,
                       np.inf)
        tau = np.where(act, tau, 0.0)
        return _ssum(tau), mu, bt, tau

    # Corollary 1 bounds + bracket expansion (active users only: the
    # rho/inv factors of padded columns are exactly zero)
    t_comp = B / _ssum(inv) + _ssum(rho * a)
    t_comm = s_bits * (_ssum(np.sqrt(np.where(act, rho / rates, 0.0)))) ** 2
    e_lo = np.maximum((t_comp + t_comm) / dl, 1e-12)
    hi = fr.mmax(a + b * (B[:, None] / ka[:, None])
                 + ka[:, None] * s_bits / rates) / dl
    e_hi = np.maximum(hi * 1.0000001, e_lo * 1.001)
    for _ in range(expand_iters):
        grow = tau_sum(e_hi)[0] > frame
        if not grow.any():
            break
        e_hi = np.where(grow, e_hi * 2.0, e_hi)
    # Στ(E) decreasing: find E with Στ = T_f
    for _ in range(outer_iters):
        e_m = 0.5 * (e_lo + e_hi)
        geq = tau_sum(e_m)[0] >= frame
        e_lo = np.where(geq, e_m, e_lo)
        e_hi = np.where(geq, e_hi, e_m)
    e_star = e_hi
    _, mu, bt, tau = tau_sum(e_star)
    tsum = _ssum(tau)[:, None]
    ok = np.isfinite(tau).all(1, keepdims=True) & (tsum > 0)
    tau = np.where(ok, tau * (frame / np.where(tsum > 0, tsum, 1.0)), tau)
    return bt, tau, e_star, mu


def solve_downlink_rows(devices, rates: np.ndarray,
                        s_bits: float, frame: float, dl: np.ndarray, *,
                        iters: int = 42, expand_iters: int = 14):
    """Theorem 2 for M rows at once (``devices`` as in
    :func:`solve_uplink_rows`).  Returns (tau (M,K), e_down (M,))."""
    rates = np.asarray(rates, float)
    dl = np.asarray(dl, float)
    M = rates.shape[0]
    fr = as_fleet_rows(devices, M)
    act, t_upd, ka = fr.active, fr.t_upd, fr.k_active

    def tau_of(e):
        denom = dl[:, None] * e[:, None] - t_upd
        tau = np.where(denom > 1e-30,
                       s_bits / rates / np.maximum(denom, 1e-30) * frame,
                       np.inf)
        return np.where(act, tau, 0.0)

    e_lo = fr.mmax(t_upd) / dl * (1 + 1e-12)
    e_hi = fr.mmax(t_upd + ka[:, None] * s_bits / rates) / dl + 1e-12
    for _ in range(expand_iters):
        grow = _ssum(tau_of(e_hi)) > frame
        if not grow.any():
            break
        e_hi = np.where(grow, e_hi * 2.0, e_hi)
    for _ in range(iters):
        e_m = 0.5 * (e_lo + e_hi)
        geq = _ssum(tau_of(e_m)) >= frame
        e_lo = np.where(geq, e_m, e_lo)
        e_hi = np.where(geq, e_hi, e_m)
    tau = tau_of(e_hi)
    tsum = _ssum(tau)[:, None]
    ok = np.isfinite(tau).all(1, keepdims=True) & (tsum > 0)
    tau = np.where(ok, tau * (frame / np.where(tsum > 0, tsum, 1.0)), tau)
    return tau, e_hi


def fixed_slot_rows(devices, batch_rows: np.ndarray,
                    rates_up: np.ndarray, rates_down: np.ndarray,
                    s_bits: float, frame_up: float, frame_down: float):
    """Vectorized equal-TDMA-slot policy evaluation for M rows at once.

    The allocation-unaware baselines (online / full / random batchsize) all
    share τ_k = T_f/K; this evaluates their per-period latency ledger for a
    whole horizon in one shot — the rows analog of
    ``baselines._fixed_batch_policy``, bit-identical per row.  ``devices``
    as in :func:`solve_uplink_rows`: with :class:`FleetRows`, K is the
    per-row active count, padded columns get zero slots and stay out of
    the latency barriers.  Returns (tau_up (M,K), tau_down (M,K),
    latency (M,)).
    """
    batch_rows = np.asarray(batch_rows, float)
    fr = as_fleet_rows(devices, batch_rows.shape[0])
    act, ka = fr.active, fr.k_active
    t_local = fr.local_latency(batch_rows)
    tau_u = np.where(act, frame_up / ka[:, None], 0.0)
    tau_d = np.where(act, frame_down / ka[:, None], 0.0)
    t_up = uplink_latency(s_bits, tau_u, frame_up, rates_up)
    t_down = downlink_latency(s_bits, tau_d, frame_down, rates_down)
    latency = fr.mmax(t_local + t_up) + fr.mmax(t_down + fr.t_upd)
    return tau_u, tau_d, latency


def solve_period_rows(devices,
                      rates_up: np.ndarray, rates_down: np.ndarray,
                      s_bits: float, frame_up: float, frame_down: float,
                      xi, B: np.ndarray, b_max: int) -> dict:
    """Vectorized 𝒫₁ inner evaluation: uplink + downlink solutions and the
    predicted eq. (14) latency for M independent periods with given B.

    ``xi`` may be a scalar or an (M,) array (per-row ξ — one row per
    scenario × period when horizons for many scenarios are planned in one
    lockstep call); ``devices`` as in :func:`solve_uplink_rows` — a
    :class:`FleetRows` makes every row's allocation a function of its own
    active users only (padded columns: zero batch, zero τ, outside the
    latency barriers)."""
    B = np.asarray(B, float)
    dl = np.asarray(xi, float) * np.sqrt(B)
    fr = as_fleet_rows(devices, rates_up.shape[0])
    bt, tau_u, e_up, _ = solve_uplink_rows(fr, rates_up, s_bits,
                                           frame_up, B, dl, b_max)
    tau_d, e_down = solve_downlink_rows(fr, rates_down, s_bits,
                                        frame_down, dl)
    t_local = fr.local_latency(bt)
    t_up = s_bits * frame_up / (np.maximum(tau_u, 1e-30) * rates_up)
    t_down = s_bits * frame_down / (np.maximum(tau_d, 1e-30) * rates_down)
    latency = fr.mmax(t_local + t_up) + fr.mmax(t_down + fr.t_upd)
    return {"batch": bt, "tau_up": tau_u, "tau_down": tau_d,
            "latency": latency, "e_total": e_up + e_down}


def optimize_batch_rows(devices,
                        rates_up: np.ndarray, rates_down: np.ndarray,
                        s_bits: float, frame_up: float, frame_down: float,
                        xi, b_max: int,
                        n_candidates: int = 97,
                        b_prev=None, dl_cap=None,
                        energy=None) -> np.ndarray:
    """Outer 𝒫₁ for M rows at once: integer-grid argmin of E^U*+E^D* over B
    (every row and every candidate evaluated in one lockstep solve; B is
    rounded to an integer downstream anyway).

    ``xi``: scalar or (M,) per-row ξ (see :func:`solve_period_rows`).
    With per-row :class:`FleetRows` the candidate grid is per row (its lo
    and hi bounds scale with the row's active users); rows with narrower
    grids repeat their last candidate so the lockstep solve stays
    rectangular — a repeated candidate ties its original and argmin keeps
    the first, so padding never changes a row's argmin.

    ``b_prev`` (optional (M,) array, NaN = no hint) warm-starts a row's
    grid from a previous solution: the candidates span
    ``[b_prev/2, 2·b_prev]`` (clipped to the row's feasible range, falling
    back to the full range when the hint is stale or outside it); the
    closed loop pairs it with a reduced ``n_candidates`` because B* moves
    slowly between consecutive chunks.

    ``dl_cap`` (optional (M,) array, NaN, inf or <= 0 = uncapped) caps the
    loss decay credited to a candidate: the selection objective becomes
    T_pred(B)/min(ξ√B, cap) instead of T_pred(B)/(ξ√B).  A scalar ξ
    cancels from the uncapped argmin, so the cap is the term that makes
    closed-loop feedback decide anything: candidates whose √B
    extrapolation out-promises the realized decay stop being credited and
    B* falls back to the knee (cap/ξ)².  Only the argmin changes; the
    per-B allocation stays the paper's.

    ``energy`` (optional :class:`repro_torch.dynamics.EnergyBudget`, read
    through ``budget_j``/``comp_w``/``tx_w``) discounts candidates the
    fleet cannot afford: each candidate's allocation is clipped to the
    per-user affordable batch (the affine local-latency model inverted
    against the residual budget after the uplink spend) and the objective
    is multiplied by √(ΣB/ΣB_affordable), so a candidate gets √B credit
    only for the batch its users can power.  An unbinding budget
    multiplies every objective by exactly 1.0."""
    M = rates_up.shape[0]
    fr = as_fleet_rows(devices, M)
    lo_rows = _ssum(np.where(fr.active, fr.lo, 0.0))
    hi_rows = fr.k_active * b_max
    if b_prev is not None:
        hint = np.broadcast_to(np.asarray(b_prev, float), (M,))
        ok = np.isfinite(hint) & (hint >= lo_rows) & (hint <= hi_rows)
        lo_rows = np.where(ok, np.maximum(lo_rows, hint / 2.0), lo_rows)
        hi_rows = np.where(ok, np.minimum(hi_rows, hint * 2.0), hi_rows)
    per_row = [np.unique(np.round(np.linspace(lo_rows[m], hi_rows[m],
                                              n_candidates)))
               for m in range(M)]
    C = max(len(c) for c in per_row)
    cand = np.stack([np.concatenate([c, np.full(C - len(c), c[-1])])
                     for c in per_row])           # (M, C)
    xi_rows = np.broadcast_to(np.asarray(xi, float), (M,))
    rup_c = np.repeat(rates_up, C, axis=0)
    frc = fr.repeat(C)
    sol = solve_period_rows(
        frc, rup_c,
        np.repeat(rates_down, C, axis=0), s_bits, frame_up, frame_down,
        np.repeat(xi_rows, C), cand.reshape(-1), b_max)
    obj = sol["e_total"].reshape(M, C)
    if energy is not None:
        t_up = s_bits * frame_up / (np.maximum(sol["tau_up"], 1e-30)
                                    * rup_c)
        residual = (energy.budget_j - energy.tx_w * t_up
                    - energy.comp_w * frc.a)
        with np.errstate(divide="ignore", invalid="ignore"):
            cap = np.where(energy.comp_w * frc.b > 0,
                           residual / np.maximum(energy.comp_w * frc.b,
                                                 1e-30),
                           np.where(residual >= 0, np.inf, -np.inf))
        cap = np.clip(cap, 0.0, float(b_max))
        b_all = _ssum(np.where(frc.active, sol["batch"], 0.0))
        b_aff = _ssum(np.where(frc.active,
                               np.minimum(sol["batch"], cap), 0.0))
        factor = np.sqrt(b_all / np.maximum(b_aff, 1e-30))
        obj = obj * factor.reshape(M, C)
    if dl_cap is not None:
        cap = np.broadcast_to(np.asarray(dl_cap, float), (M,))[:, None]
        cap = np.where(np.isfinite(cap) & (cap > 0), cap, np.inf)
        # e_total = T_pred/ΔL with ΔL = ξ√B; re-denominate by the capped
        # decay so over-promising candidates stop looking efficient
        dl = xi_rows[:, None] * np.sqrt(cand)
        obj = obj * dl / np.minimum(dl, cap)
    best = np.argmin(obj, axis=1)
    return cand[np.arange(M), best]


# ---------------------------------------------------------------------------
# Outer problem: optimize the global batchsize B (𝒫₁)
# ---------------------------------------------------------------------------


def solve_period(devices: Sequence[DeviceProfile],
                 rates_up: np.ndarray, rates_down: np.ndarray,
                 s_bits: float, frame_up: float, frame_down: float,
                 xi: float, b_max: int,
                 B: Optional[float] = None) -> PeriodSolution:
    """Full 𝒫₁: golden-section over B of  E^U*(B) + E^D*(B)  (= T/ΔL)."""
    K = len(devices)

    def objective(Bv):
        dl = xi * np.sqrt(Bv)
        up = solve_uplink(devices, rates_up, s_bits, frame_up, Bv, dl, b_max)
        down = solve_downlink(devices, rates_down, s_bits, frame_down, dl)
        return up.e_up + down.e_down, up, down

    if B is None:
        lo = float(sum(d.batch_lo() for d in devices))
        hi = float(K * b_max)
        phi = (np.sqrt(5) - 1) / 2
        x1 = hi - phi * (hi - lo)
        x2 = lo + phi * (hi - lo)
        f1, f2 = objective(x1)[0], objective(x2)[0]
        for _ in range(60):
            if f1 <= f2:
                hi, x2, f2 = x2, x1, f1
                x1 = hi - phi * (hi - lo)
                f1 = objective(x1)[0]
            else:
                lo, x1, f1 = x1, x2, f2
                x2 = lo + phi * (hi - lo)
                f2 = objective(x2)[0]
            if hi - lo < 1.0:
                break
        B = round(0.5 * (lo + hi))

    total, up, down = objective(float(B))
    dl = xi * np.sqrt(B)
    # predicted wall latency: both subperiods at their equalized finish times
    t_local = np.array([d.local_grad_latency(bk) for d, bk
                        in zip(devices, up.batch)])
    t_up = s_bits * frame_up / (np.maximum(up.tau, 1e-30) * rates_up)
    t_upd = np.array([d.update_latency() for d in devices])
    t_down = s_bits * frame_down / (np.maximum(down.tau, 1e-30) * rates_down)
    T = period_latency(t_local, t_up, t_down, t_upd)
    return PeriodSolution(
        global_batch=float(B), batch=up.batch, tau_up=up.tau,
        tau_down=down.tau, latency=T,
        efficiency=float(dl / T) if T > 0 else 0.0,
        e_up=up.e_up, e_down=down.e_down)
