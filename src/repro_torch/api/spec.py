"""Declarative scenario specification (port copy of the reference's
``ScenarioSpec``).

A :class:`ScenarioSpec` is everything that defines one experimental cell —
device fleet, wireless cell, data partition, batchsize policy, Table-II
training scheme, compression, learning-rate base, local-step count and
the seed set — as one frozen, hashable value.

The spec accepts and refuses exactly what the reference's does, with the
reference's error types: the four Table-II schemes (``"feel"`` and
``"gradient_fl"``, the full-batch policy, on the FEEL engine; the
per-device-parameter schemes ``"individual"`` and ``"model_fl"``), the
feel-mlp model at any ``local_steps >= 1`` and under a cell→edge→cloud
``topology`` (:class:`~repro_torch.topology.Topology`), the big-model
families (``model_family="transformer"`` or ``"mamba2"``) at one local
step, per-round participation ``sampling``
(:class:`~repro_torch.topology.Sampling`), channel drift ``fading``,
stragglers and dropout ``faults``, per-user ``energy`` budgets, the
closed loop ``replan`` (the FEEL family's ξ re-plan interval: the horizon
runs as ``replan``-period chunks with the realized loss decays fed back
between them) and adaptive local steps ``adapt_tau``
(:class:`~repro_torch.dynamics.TauAdapt`, re-planned at those chunk
boundaries; it needs ``replan`` and a ``local_steps`` among its
choices).

Two specs share a bucket — one batched device loop — iff
:meth:`ScenarioSpec.bucket_key` matches.  For the dev schemes that is the
scheme, the fixed epoch batch and the model dims; for the FEEL family the
slot width (``b_max``), ``local_steps``, ``compress`` and (when
compressing) ``compression``, the model dims, ``replan`` (a bucket's rows
chunk on the same boundary), the topology's structural key, the fading
chain's state count and the ``adapt_tau`` choice set.  The fleet is
not structural: rows are padded to the bucket's max K and an active mask
keeps padded users out of every reduction.  Sampling, faults, budgets, a
fading chain's gains and a topology's backhaul rate are values: they
reach the device loop as the time-varying active mask and the
schedules.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

from repro_torch.channels.model import CellConfig
from repro_torch.core.latency import DeviceProfile
from repro_torch.core.baselines import POLICIES
from repro_torch.dynamics import EnergyBudget, Fading, Faults, TauAdapt
from repro_torch.topology import Sampling, Topology

SCHEMES = ("feel", "gradient_fl", "model_fl", "individual")
MODEL_FAMILIES = ("feel_mlp", "transformer", "mamba2")
# The dev-family schemes train full local epochs with a fixed per-device
# batch, capped at 64 (the reference's lowering rule).
DEV_EPOCH_BATCH_CAP = 64


@dataclass(frozen=True)
class ScenarioSpec:
    """One cell of the scenario family (all four Table-II schemes)."""
    fleet: Tuple[DeviceProfile, ...]
    name: str = ""                       # fleet/cell label for Results axes
    scheme: str = "feel"                 # feel|gradient_fl|model_fl|individual
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
    replan: Optional[int] = None         # closed-loop ξ re-plan interval
    sampling: Optional[Sampling] = None  # per-round S-of-K participation
    topology: Optional[Topology] = None  # cell→edge→cloud hierarchy
    fading: Optional[Fading] = None      # block-fading Markov channel drift
    faults: Optional[Faults] = None      # straggler slowdowns + dropout
    energy: Optional[EnergyBudget] = None  # per-user per-period energy caps
    adapt_tau: Optional[TauAdapt] = None   # re-planned local-steps knob
    model_family: str = "feel_mlp"       # feel_mlp | transformer | mamba2

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
        if self.replan is not None:
            if self.is_dev_scheme:
                raise ValueError(
                    "replan= is the FEEL family's closed-loop ξ interval; "
                    f"the {self.scheme!r} scheme has no batchsize policy "
                    "to re-plan")
            if not isinstance(self.replan, int) or \
                    isinstance(self.replan, bool) or self.replan < 1:
                raise ValueError(
                    f"replan must be a positive int (periods per "
                    f"closed-loop chunk), got {self.replan!r}")
        if self.sampling is not None and \
                not isinstance(self.sampling, Sampling):
            raise TypeError(
                f"sampling= expects a repro_torch.topology.Sampling, got "
                f"{type(self.sampling).__name__}")
        if self.topology is not None:
            if not isinstance(self.topology, Topology):
                raise TypeError(
                    f"topology= expects a repro_torch.topology.Topology, "
                    f"got {type(self.topology).__name__}")
            if self.is_dev_scheme:
                raise ValueError(
                    "topology= hierarchizes the server aggregation; the "
                    f"{self.scheme!r} scheme keeps per-device parameters "
                    "and has no aggregation tier to split")
            if self.k < self.topology.cells:
                raise ValueError(
                    f"fleet of {self.k} users cannot populate the "
                    f"topology's {self.topology.cells} cells")
        for fld, typ in (("fading", Fading), ("faults", Faults),
                         ("energy", EnergyBudget), ("adapt_tau", TauAdapt)):
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
        if self.adapt_tau is not None:
            if self.replan is None:
                raise ValueError(
                    "adapt_tau= re-plans local steps at closed-loop chunk "
                    "boundaries; set replan= on the spec")
            if self.local_steps not in self.adapt_tau.choices:
                raise ValueError(
                    f"local_steps={self.local_steps} is the starting point "
                    "of the adaptive schedule and must appear in adapt_tau "
                    f"choices {self.adapt_tau.choices!r}")
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
        """The batchsize policy the lowering applies: ``gradient_fl`` is
        the full-batch policy on the FEEL engine; the per-device-parameter
        schemes have none and report ``"none"``, so
        ``Results.sel(policy=...)`` never mixes them into FEEL-policy
        selections."""
        if self.is_dev_scheme:
            return "none"
        return "full" if self.scheme == "gradient_fl" else self.policy

    @property
    def dev_epoch_batch(self) -> int:
        """The dev schemes' fixed per-device batch."""
        return min(self.b_max, DEV_EPOCH_BATCH_CAP)

    @property
    def label(self) -> str:
        base = self.name or f"K{self.k}"
        return f"{base}/{self.partition}/{self.scheme}/{self.effective_policy}"

    def bucket_key(self) -> tuple:
        """Shape-compatibility class, the reference's key.  The dev
        schemes key on the scheme (the FedAvg step is part of the loop),
        the epoch batch and the model dims.  The FEEL family keys on the
        loop's shapes and branches; a topology contributes its
        ``structural_key()`` (``backhaul_bps`` only changes ledger
        values), a fading chain its state count and ``adapt_tau`` its
        choice set, while sampling, faults, budgets and the gains are
        values.  ``replan`` is structural for the FEEL family: a bucket's
        rows chunk on the same boundary, where the feedback lands."""
        if self.is_dev_scheme:
            return ("dev", self.scheme, self.dev_epoch_batch,
                    self.hidden, self.depth)
        topo = (None if self.topology is None
                else self.topology.structural_key())
        return ("feel", self.b_max, self.local_steps,
                self.compress, self.compression if self.compress else None,
                self.hidden, self.depth, self.replan, topo,
                None if self.fading is None else self.fading.states,
                None if self.adapt_tau is None else self.adapt_tau.choices,
                self.model_family)
