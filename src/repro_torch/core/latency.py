"""End-to-end latency models of one FEEL training period (paper §III-B, §V-A).

CPU devices (eq. 9):   t^L = B·C^L / f          (serial)
GPU devices (eq. 26):  t^L = t_ℓ                  for B <= B_th   (data bound)
                             c·(B - B_th) + t_ℓ   for B  > B_th   (compute bound)

Both are affine in B on the region the optimum lives in (Lemma 2), so the
solver works with the unified affine form  t^L = a + b·B  (see solver.py).
"""
from __future__ import annotations

from dataclasses import dataclass
import numpy as np


@dataclass(frozen=True)
class DeviceProfile:
    """One edge device's compute profile."""
    kind: str                       # "cpu" | "gpu"
    # CPU scenario (eq. 9, 12)
    f_cpu: float = 2.0e9            # CPU cycles/s
    cycles_per_sample: float = 4.0e8   # C^L
    cycles_update: float = 2.0e8       # M^C
    # GPU scenario (Assumption 1, eq. 27)
    gpu_t_low: float = 0.02         # t_ℓ  (s)
    gpu_slope: float = 5.0e-4       # c    (s/sample)
    gpu_b_th: int = 16              # B_th
    f_gpu: float = 1.0e13           # FLOP/s
    flops_update: float = 2.0e9     # M^G

    # ---- affine coefficients  t^L = a + b*B on the feasible region --------
    def affine(self):
        if self.kind == "cpu":
            return 0.0, self.cycles_per_sample / self.f_cpu
        a = self.gpu_t_low - self.gpu_slope * self.gpu_b_th
        return a, self.gpu_slope

    def local_grad_latency(self, batch) -> np.ndarray:
        """eq. (9) / (26); vectorized over batch."""
        batch = np.asarray(batch, float)
        if self.kind == "cpu":
            return batch * self.cycles_per_sample / self.f_cpu
        return np.where(batch <= self.gpu_b_th, self.gpu_t_low,
                        self.gpu_slope * (batch - self.gpu_b_th)
                        + self.gpu_t_low)

    def update_latency(self) -> float:
        """eq. (12) / (27)."""
        if self.kind == "cpu":
            return self.cycles_update / self.f_cpu
        return self.flops_update / self.f_gpu

    def batch_lo(self) -> int:
        return 1 if self.kind == "cpu" else self.gpu_b_th

    def speed(self) -> float:
        """Local training speed V_k (paper's indicator, CPU: f/C^L)."""
        a, b = self.affine()
        return 1.0 / b


def uplink_latency(s_bits: float, tau: np.ndarray, frame: float,
                   rate: np.ndarray) -> np.ndarray:
    """eq. (10): t^U = s·T_f / (τ·R)."""
    return s_bits * frame / (np.maximum(tau, 1e-30) * rate)


def downlink_latency(s_bits: float, tau: np.ndarray, frame: float,
                     rate: np.ndarray) -> np.ndarray:
    """eq. (11)."""
    return uplink_latency(s_bits, tau, frame, rate)


def gradient_bits(n_params: int, bits_per_term: int = 64,
                  compression: float = 0.005) -> float:
    """s = r·d·p (paper §III-B)."""
    return compression * bits_per_term * n_params


def period_latency(t_local, t_up, t_down, t_update) -> float:
    """eq. (14): synchronous aggregation barrier + downlink/update barrier."""
    return float(np.max(np.asarray(t_local) + np.asarray(t_up))
                 + np.max(np.asarray(t_down) + np.asarray(t_update)))
