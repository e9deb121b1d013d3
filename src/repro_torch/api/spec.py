"""Declarative scenario specification (port copy of the reference's
``ScenarioSpec``).

A :class:`ScenarioSpec` is everything that defines one experimental cell —
device fleet, wireless cell, data partition, batchsize policy, training
scheme, compression, learning-rate base and the seed set — as one frozen,
hashable value.

This port runs the FEEL scheme with one local step per period, on the
feel-mlp model or the big-model families (``model_family=
"transformer"`` or ``"mamba2"``), in the static world or the
time-varying one: per-round participation ``sampling``
(:class:`~repro_torch.topology.Sampling`), channel drift ``fading``,
stragglers and dropout ``faults`` and per-user ``energy`` budgets
(:mod:`repro_torch.dynamics`), each type-checked and cross-checked as the
reference checks it.  The fields of what later slices bring stay on the
spec so that a spec written for the reference is rejected with a clear
error instead of being run differently: schemes other than ``"feel"``,
``local_steps > 1``, ``replan``, ``topology`` and ``adapt_tau``
(``NotImplementedError``).  The reference's ``TypeError`` and
``ValueError`` rules run first, so a spec the reference refuses is
refused here the same way.

Two specs share a bucket — one batched device loop — iff
:meth:`ScenarioSpec.bucket_key` matches: slot width (``b_max``),
``local_steps``, ``compress`` and (when compressing) ``compression``,
the model dims and the fading chain's state count.  The fleet is not
structural: rows are padded to the bucket's max K and an active mask
keeps padded users out of every reduction.  Sampling, faults, budgets
and a fading chain's gains are values: they reach the device loop as the
time-varying active mask and the schedules.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

from repro_torch.channels.model import CellConfig
from repro_torch.core.latency import DeviceProfile
from repro_torch.core.baselines import POLICIES
from repro_torch.dynamics import EnergyBudget, Fading, Faults
from repro_torch.topology import Sampling

SCHEMES = ("feel", "gradient_fl", "model_fl", "individual")
MODEL_FAMILIES = ("feel_mlp", "transformer", "mamba2")
# fields whose non-default values later slices of the port bring
_LATER = ("replan", "topology", "adapt_tau")


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
    sampling: Optional[Sampling] = None  # per-round S-of-K participation
    topology: Optional[object] = None
    fading: Optional[Fading] = None      # block-fading Markov channel drift
    faults: Optional[Faults] = None      # straggler slowdowns + dropout
    energy: Optional[EnergyBudget] = None  # per-user per-period energy caps
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
        if self.sampling is not None and \
                not isinstance(self.sampling, Sampling):
            raise TypeError(
                f"sampling= expects a repro_torch.topology.Sampling, got "
                f"{type(self.sampling).__name__}")
        for fld, typ in (("fading", Fading), ("faults", Faults),
                         ("energy", EnergyBudget)):
            val = getattr(self, fld)
            if val is not None and not isinstance(val, typ):
                raise TypeError(
                    f"{fld}= expects a repro_torch.dynamics."
                    f"{typ.__name__}, got {type(val).__name__}")
        if self.has_dynamics:
            if self.is_dev_scheme:
                raise ValueError(
                    "dynamics (fading/faults/energy/adapt_tau) act through "
                    f"the FEEL planner; the {self.scheme!r} scheme has no "
                    "planner to perturb")
            if self.topology is not None:
                raise ValueError(
                    "dynamics are not threaded through the hierarchical "
                    "per-cell solves yet; drop topology= or the dynamics "
                    "fields")
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
        if self.sampling is not None and self.sampling.weighted:
            if self.topology is not None:
                raise ValueError(
                    "weighted (1/p) sampling corrects the flat server "
                    "aggregation; the hierarchical path does not support it")
            if self.energy is not None:
                raise ValueError(
                    "weighted (1/p) sampling needs probabilistic "
                    "inclusion; deterministic energy drops break the "
                    "Horvitz-Thompson correction")
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
                    "flat, open-loop FEEL world with one local step")

    @property
    def is_dev_scheme(self) -> bool:
        """True for the per-device-parameter schemes (no gradient fusion)."""
        return self.scheme in ("individual", "model_fl")

    @property
    def has_dynamics(self) -> bool:
        """True when any time-varying-world process is configured."""
        return (self.fading is not None or self.faults is not None
                or self.energy is not None or self.adapt_tau is not None)

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
        """Shape-compatibility class: the reference's FEEL-family key.
        A fading chain's state count is a structural coordinate as in the
        reference; sampling, faults, budgets and the gains are values.
        The topology and adaptive-τ entries are always None in this
        port."""
        return ("feel", self.b_max, self.local_steps,
                self.compress, self.compression if self.compress else None,
                self.hidden, self.depth, self.replan, None,
                None if self.fading is None else self.fading.states,
                None, self.model_family)
