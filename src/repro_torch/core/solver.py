"""Joint batchsize selection + communication resource allocation, the
lockstep rows form of the paper's Algorithm 1.

Unified affine latency ``t^L_k = a_k + b_k·B_k`` covers both the CPU and
the GPU device scenario; the KKT system of Appendix A then gives

    λ_k* = ρ'_k/ΔL          with  ρ'_k = (1/b_k)/Σ_j(1/b_j)
    B_k*  = clip[(ΔL·E^U − a_k − sqrt(ΔL·s·T_f·μ/(ρ'_k·R_k))) / b_k]
    τ_k*  = (s/R_k) / (ΔL·E^U − a_k − b_k·B_k*) · T_f

(Theorem 1 when a=0, b=1/V_k).  The functions below run Algorithm 1's
two-dimensional bisection over (E^U*, μ*) and Theorem 2's downlink
bisection for M independent periods ("rows") at once, with fixed
iteration counts.

A copy of the reference's rows solver: the same operations in the same
order, so every plan is bitwise the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from repro_torch.core.latency import (DeviceProfile, downlink_latency,
                                      uplink_latency)


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
                        n_candidates: int = 97) -> np.ndarray:
    """Outer 𝒫₁ for M rows at once: integer-grid argmin of E^U*+E^D* over B
    (every row and every candidate evaluated in one lockstep solve; B is
    rounded to an integer downstream anyway).

    ``xi``: scalar or (M,) per-row ξ (see :func:`solve_period_rows`).
    With per-row :class:`FleetRows` the candidate grid is per row (its lo
    and hi bounds scale with the row's active users); rows with narrower
    grids repeat their last candidate so the lockstep solve stays
    rectangular — a repeated candidate ties its original and argmin keeps
    the first, so padding never changes a row's argmin."""
    M = rates_up.shape[0]
    fr = as_fleet_rows(devices, M)
    lo_rows = _ssum(np.where(fr.active, fr.lo, 0.0))
    hi_rows = fr.k_active * b_max
    per_row = [np.unique(np.round(np.linspace(lo_rows[m], hi_rows[m],
                                              n_candidates)))
               for m in range(M)]
    C = max(len(c) for c in per_row)
    cand = np.stack([np.concatenate([c, np.full(C - len(c), c[-1])])
                     for c in per_row])           # (M, C)
    xi_rows = np.broadcast_to(np.asarray(xi, float), (M,))
    sol = solve_period_rows(
        fr.repeat(C), np.repeat(rates_up, C, axis=0),
        np.repeat(rates_down, C, axis=0), s_bits, frame_up, frame_down,
        np.repeat(xi_rows, C), cand.reshape(-1), b_max)
    obj = sol["e_total"].reshape(M, C)
    best = np.argmin(obj, axis=1)
    return cand[np.arange(M), best]
