"""Wireless channel substrate (paper §II-C, §VI-A).

Single-cell network, radius 200 m, BS at the center; path loss
``PL[dB] = 128.1 + 37.6 log10(d[km])`` with Rayleigh small-scale fading;
uplink/downlink Tx power 28 dBm, bandwidth 10 MHz, noise −174 dBm/Hz.
Average rates follow eqs. (5)-(6): R = W·E_h[log2(1 + P|h|²/N0)], estimated
by Monte-Carlo over the fading distribution (the paper's expectation).

A copy of the reference's numpy channel model: same arithmetic, same rng
stream order, so every drawn rate is bitwise the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class CellConfig:
    radius_m: float = 200.0
    bandwidth_hz: float = 10e6         # W
    tx_power_dbm: float = 28.0         # uplink and downlink (paper §VI-A)
    noise_dbm_per_hz: float = -174.0   # N0 density
    frame_up_s: float = 0.010          # T_f^U (LTE)
    frame_down_s: float = 0.010        # T_f^D
    fading_samples: int = 2048


def path_loss_db(dist_km: np.ndarray) -> np.ndarray:
    return 128.1 + 37.6 * np.log10(np.maximum(dist_km, 1e-4))


def wired_latency(bits: float, rate_bps: float) -> float:
    """Deterministic wired-link transfer time (the edge→cloud backhaul of
    a hierarchy: no fading, hence no Monte-Carlo stream)."""
    if rate_bps <= 0:
        raise ValueError(f"wired rate must be positive, got {rate_bps!r}")
    return float(bits) / float(rate_bps)


@dataclass
class Cell:
    cfg: CellConfig
    rng: np.random.Generator

    @classmethod
    def make(cls, seed: int = 0, cfg: CellConfig = CellConfig()):
        return cls(cfg=cfg, rng=np.random.default_rng(seed))

    def drop_users(self, k: int) -> np.ndarray:
        """Uniform positions in the disc; returns distances (km)."""
        r = self.cfg.radius_m * np.sqrt(self.rng.uniform(size=k))
        return np.maximum(r, 1.0) / 1000.0

    def avg_rate(self, dist_km: np.ndarray) -> np.ndarray:
        """eqs. (5)/(6) via Monte-Carlo over Rayleigh fading: one
        ``(S, K)`` draw, bits/s per user."""
        c = self.cfg
        pl = path_loss_db(dist_km)                          # (K,)
        p_rx_dbm = c.tx_power_dbm - pl                      # mean rx power
        noise_dbm = c.noise_dbm_per_hz + 10 * np.log10(c.bandwidth_hz)
        snr_lin = 10 ** ((p_rx_dbm - noise_dbm) / 10)       # (K,)
        h2 = self.rng.exponential(size=(c.fading_samples, len(dist_km)))
        rate = c.bandwidth_hz * np.mean(np.log2(1 + snr_lin[None, :] * h2),
                                        axis=0)
        return rate                                          # bits/s

    def avg_rate_updown_rows(self, dist_km: np.ndarray, periods: int,
                             pad_to: int | None = None):
        """``periods`` consecutive (uplink, downlink) rate draws in ONE rng
        consumption: one ``(P, 2, S, K)`` exponential draw consumes the
        stream exactly like the per-period loop ``up = avg_rate(d); down =
        avg_rate(d)``, since ``Generator`` fills arrays variate by variate
        in C order.

        ``pad_to`` appends padded-user columns for the ragged-fleet
        lowering: the K active users draw exactly as without padding (the
        rng stream is untouched), and each padded column carries the
        deterministic unit-SNR rate W, which the solver's active mask
        keeps out of every result.  Returns (rates_up (P, K'),
        rates_down (P, K')) with K' = ``pad_to`` or K."""
        c = self.cfg
        pl = path_loss_db(dist_km)
        p_rx_dbm = c.tx_power_dbm - pl
        noise_dbm = c.noise_dbm_per_hz + 10 * np.log10(c.bandwidth_hz)
        snr_lin = 10 ** ((p_rx_dbm - noise_dbm) / 10)        # (K,)
        h2 = self.rng.exponential(
            size=(periods, 2, c.fading_samples, len(dist_km)))
        rate = c.bandwidth_hz * np.mean(
            np.log2(1 + snr_lin[None, None, None, :] * h2), axis=2)
        up, down = rate[:, 0], rate[:, 1]                    # bits/s
        if pad_to is not None and pad_to > len(dist_km):
            fill = np.full((periods, pad_to - len(dist_km)), c.bandwidth_hz)
            up = np.concatenate([up, fill], axis=1)
            down = np.concatenate([down, fill], axis=1)
        return up, down

    def sample_rates(self, k: int):
        """Drop K users, return (dist_km, uplink rates, downlink rates)."""
        d = self.drop_users(k)
        up = self.avg_rate(d)
        down = self.avg_rate(d)
        return d, up, down
