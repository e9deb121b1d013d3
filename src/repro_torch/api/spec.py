"""Declarative scenario specification (port copy of the reference's
``ScenarioSpec``).

A :class:`ScenarioSpec` is everything that defines one experimental cell —
device fleet, wireless cell, data partition, batchsize policy, training
scheme, compression, learning-rate base and the seed set — as one frozen,
hashable value.

This port runs the FEEL scheme with one local step per period, on the
feel-mlp model or the big-model families (``model_family=
"transformer"`` or ``"mamba2"``).  The fields of what later slices bring
stay on the spec so that a spec written for the reference is rejected
with a clear error instead of being run differently: schemes other than
``"feel"``, ``local_steps > 1``, ``replan``, ``sampling``, ``topology``,
``fading``, ``faults``, ``energy`` and ``adapt_tau``.  A big-model family
is validated as the reference validates it (FEEL only, flat, one local
step, ``hidden`` divisible by 4) before any of these.

Two specs share a bucket — one batched device loop — iff
:meth:`ScenarioSpec.bucket_key` matches: slot width (``b_max``),
``local_steps``, ``compress`` and (when compressing) ``compression``,
and the model dims.  The fleet is not structural: rows are padded to the
bucket's max K and an active mask keeps padded users out of every
reduction.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

from repro_torch.channels.model import CellConfig
from repro_torch.core.latency import DeviceProfile
from repro_torch.core.baselines import POLICIES

SCHEMES = ("feel", "gradient_fl", "model_fl", "individual")
MODEL_FAMILIES = ("feel_mlp", "transformer", "mamba2")
# fields whose non-default values later slices of the port bring
_LATER = ("replan", "sampling", "topology", "fading", "faults", "energy",
          "adapt_tau")


@dataclass(frozen=True)
class ScenarioSpec:
    """One cell of the scenario family (the FEEL scheme in this port)."""
    fleet: Tuple[DeviceProfile, ...]
    name: str = ""                       # fleet/cell label for Results axes
    scheme: str = "feel"
    partition: str = "noniid"            # iid | noniid
    policy: str = "proposed"             # online | full | random | proposed
    cell: CellConfig = field(default_factory=CellConfig)
    compress: bool = True
    compression: float = 0.005           # SBC ratio r
    b_max: int = 128
    base_lr: float = 0.05
    local_steps: int = 1
    seeds: Tuple[int, ...] = (0,)
    hidden: int = 256
    depth: int = 3
    replan: Optional[int] = None
    sampling: Optional[object] = None
    topology: Optional[object] = None
    fading: Optional[object] = None
    faults: Optional[object] = None
    energy: Optional[object] = None
    adapt_tau: Optional[object] = None
    model_family: str = "feel_mlp"

    def __post_init__(self):
        object.__setattr__(self, "fleet", tuple(self.fleet))
        object.__setattr__(self, "seeds", tuple(self.seeds))
        if self.scheme not in SCHEMES:
            raise ValueError(f"scheme {self.scheme!r} not in {SCHEMES}")
        if self.partition not in ("iid", "noniid"):
            raise ValueError(f"partition {self.partition!r}")
        if self.policy not in POLICIES:
            raise ValueError(
                f"policy {self.policy!r} not in {tuple(POLICIES)}")
        if not self.seeds:
            raise ValueError("seeds must be non-empty")
        if self.model_family not in MODEL_FAMILIES:
            raise ValueError(
                f"model_family {self.model_family!r} not in {MODEL_FAMILIES}")
        if self.model_family != "feel_mlp":
            if self.is_dev_scheme:
                raise ValueError(
                    "big-model families run the FEEL train step; the "
                    f"{self.scheme!r} scheme keeps per-device MLPs")
            if self.topology is not None:
                raise ValueError(
                    "the hierarchical scan is feel_mlp-only; drop "
                    "topology= or use model_family='feel_mlp'")
            if self.local_steps != 1 or self.adapt_tau is not None:
                raise ValueError(
                    "big-model families take one aggregated step per "
                    "period (local_steps=1, no adapt_tau); the local-SGD "
                    "delta-upload loop is feel_mlp-only")
            if self.hidden % 4 != 0:
                raise ValueError(
                    f"model_family={self.model_family!r} derives its "
                    f"ArchConfig from hidden={self.hidden}, which must be "
                    "divisible by 4 (attention heads / SSM head grouping)")
        if self.scheme != "feel":
            raise NotImplementedError(
                f"scheme {self.scheme!r} is not ported yet; the PyTorch "
                "port runs scheme='feel'")
        if self.local_steps != 1:
            raise NotImplementedError(
                f"local_steps={self.local_steps} is not ported yet; the "
                "PyTorch port takes one local step per period")
        for name in _LATER:
            if getattr(self, name) is not None:
                raise NotImplementedError(
                    f"{name}= is not ported yet; the PyTorch port runs the "
                    "static, flat, open-loop FEEL world")

    @property
    def is_dev_scheme(self) -> bool:
        """True for the per-device-parameter schemes (no gradient fusion)."""
        return self.scheme in ("individual", "model_fl")

    @property
    def k(self) -> int:
        return len(self.fleet)

    @property
    def effective_policy(self) -> str:
        """The batchsize policy the lowering applies (the FEEL scheme's
        own policy)."""
        return self.policy

    @property
    def label(self) -> str:
        base = self.name or f"K{self.k}"
        return f"{base}/{self.partition}/{self.scheme}/{self.effective_policy}"

    def bucket_key(self) -> tuple:
        """Shape-compatibility class: the reference's FEEL-family key,
        whose topology, fading-state and adaptive-τ entries are always
        None in this port."""
        return ("feel", self.b_max, self.local_steps,
                self.compress, self.compression if self.compress else None,
                self.hidden, self.depth, self.replan, None, None, None,
                self.model_family)
