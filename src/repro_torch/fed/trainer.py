"""FEEL training loop (paper §II-A five steps) + the Table-II scheme zoo,
the port of the reference's ``fed/trainer.py``.

Simulated wall-clock comes from the core latency models (there is no
radio or edge device); learning is real PyTorch compute on synthetic
data.

Schemes (:func:`run_scheme`, deprecated — prefer
``repro_torch.api.Experiment``):
  feel        — the paper's proposal: scheduler-planned B_k/τ_k, compressed
                gradient aggregation (eq. (1)), η ∝ √B.
  gradient_fl — full-slot batches, equal TDMA slots, compressed grads.
  model_fl    — FedAvg: one local epoch, parameter upload (uncompressed
                payload d·p).
  individual  — no collaboration; models averaged once at the end.

Execution engines (``FeelSimulation.engine``):
  scan   — the default: the whole trajectory is pre-planned into an
           ``engine.Schedule`` and runs as the engine's single-row program
           (``engine.run_trajectory``), with no per-period host transfer.
  python — the reference loop: one period per Python iteration with
           ``float()`` host syncs every step, per-device ``compress_dense``
           with error feedback and eq. (1) weights; it consumes the SAME
           pre-generated schedule, so scan-vs-python is a pure numerics
           regression check and the speed baseline the scan engine is
           measured against.  On CUDA both engines' SBC runs the
           hand-written SBC kernels.

Both engines are open-loop in ξ within a run (the paper's known-constant
treatment); realized decays feed the ξ estimator post-hoc so it still
adapts across successive ``run`` calls.  A simulation runs on the GPU
unless built with ``device="cpu"``.
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch.func import grad, vmap

from repro_torch.api.experiment import resolve_device
from repro_torch.channels.model import Cell, CellConfig
from repro_torch.compression.sbc import compress_dense
from repro_torch.core import DeviceProfile, FeelScheduler
from repro_torch.core.scheduler import DevScheduler
from repro_torch.data.pipeline import (ClassificationData, FederatedBatcher,
                                       partition_iid, partition_noniid)
from repro_torch.fed import engine, feel_model
from repro_torch.fed.engine import EngineState, Schedule, build_schedule
from repro_torch.tree import tree_leaves, tree_map

# per device: the gradient at the global parameters, and at the device's
# own parameters (τ > 1 local steps)
_device_grads = vmap(grad(feel_model.loss_fn), in_dims=(None, 0, 0, 0))
_local_grads = vmap(grad(feel_model.loss_fn))


@dataclass
class RunResult:
    scheme: str
    losses: List[float] = field(default_factory=list)
    accs: List[float] = field(default_factory=list)
    times: List[float] = field(default_factory=list)       # cumulative (s)
    global_batches: List[int] = field(default_factory=list)

    def speed(self, target_acc: float) -> float:
        """Time to reach target accuracy (inf if never).

        NaN accuracies mean "not evaluated at this point" (the python
        engine's non-eval periods) and are skipped explicitly — they can
        neither reach the target nor count against it."""
        for a, t in zip(self.accs, self.times):
            if not math.isnan(a) and a >= target_acc:
                return t
        return float("inf")


def _eval_points(periods: int, eval_every: int) -> List[int]:
    return [p for p in range(periods)
            if p % eval_every == 0 or p == periods - 1]


def _partition(partition: str, data, k: int, seed: int):
    if partition == "iid":
        return partition_iid(len(data.y), k, seed)
    return partition_noniid(data.y, k, seed=seed)


@dataclass
class FeelSimulation:
    devices: Sequence[DeviceProfile]
    data: ClassificationData
    test: ClassificationData
    partition: str = "noniid"            # iid | noniid
    policy: str = "proposed"             # core.baselines key
    compress: bool = True
    b_max: int = 128
    base_lr: float = 0.05
    seed: int = 0
    hidden: int = 256
    depth: int = 3
    local_steps: int = 1                 # τ local updates per period
    engine: str = "scan"                 # scan | python (reference loop)
    cell_cfg: CellConfig = field(default_factory=CellConfig)
    device: Optional[object] = None      # None: the GPU, raising without

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.parts = _partition(self.partition, self.data,
                                len(self.devices), self.seed)
        self.batcher = FederatedBatcher(self.parts, self.b_max, self.seed)
        # a CPU generator seeded with ``seed``, as the lowering's
        # _init_params_batch draws each row's init
        self.params = feel_model.init(
            torch.Generator().manual_seed(self.seed), self.hidden,
            depth=self.depth, input_dim=self.data.x.shape[1],
            device=self.device)
        self.n_params = sum(p.numel() for p in tree_leaves(self.params))
        self.scheduler = FeelScheduler(
            devices=self.devices, n_params=self.n_params, policy=self.policy,
            b_max=self.b_max, base_lr=self.base_lr, seed=self.seed,
            cell_cfg=self.cell_cfg)
        self.residuals = None
        self.arrays = engine.dataset_to_device(self.data, self.test,
                                               self.device)

    # ---- schedule + initial carry (shared by both engines and sweep) -----
    def plan_run(self, periods: int) -> Schedule:
        return build_schedule(self.scheduler, self.batcher, periods,
                              local_steps=self.local_steps)

    def initial_residual(self):
        if self.residuals is not None:
            return self.residuals
        k = self.batcher.k
        return tree_map(lambda p: torch.zeros((k,) + p.shape, dtype=p.dtype,
                                              device=p.device), self.params)

    def run(self, periods: int, eval_every: int = 10) -> RunResult:
        sched = self.plan_run(periods)
        evals = _eval_points(periods, eval_every)
        if self.engine == "python":
            losses, accs, decays = self._run_python(sched, evals)
        else:
            state, series = engine.run_trajectory(
                EngineState(self.params, self.initial_residual()), sched,
                self.arrays, local_steps=self.local_steps,
                compress=self.compress, ratio=self.scheduler.compression)
            self.params, self.residuals = state.params, state.residual
            losses, accs, decays = (s.cpu().numpy() for s in series)
        self.scheduler.observe_series(decays, sched.global_batch)
        res = RunResult(scheme=f"feel/{self.policy}")
        for p in evals:
            res.losses.append(float(losses[p]))
            res.accs.append(float(accs[p]))
            res.times.append(float(sched.times[p]))
            res.global_batches.append(int(sched.global_batch[p]))
        return res

    # ---- the reference loop: one FEEL period (Steps 1-5) per Python
    # iteration, float() host syncs each step -------------------------------
    def _run_python(self, sched: Schedule, evals: Sequence[int]):
        periods = sched.periods
        losses = np.zeros(periods)
        accs = np.full(periods, np.nan)
        decays = np.zeros(periods)
        evals = set(evals)
        _, _, test_x, test_y = self.arrays
        for p in range(periods):
            loss_before, loss_after = self._python_period(
                sched.idx[p], sched.weight[p], sched.batch[p],
                float(sched.lr[p]))
            losses[p] = loss_after
            decays[p] = loss_before - loss_after
            if p in evals:
                accs[p] = float(feel_model.accuracy(self.params, test_x,
                                                    test_y))
        return losses, accs, decays

    @torch.no_grad()
    def _python_period(self, idx, w, bk, lr):
        data_x, data_y = self.arrays[:2]
        idx, w, bk = engine.host_to_device((idx, w, bk), self.device)
        x = data_x[idx]                              # (K, slot, D)
        y = data_y[idx]
        xf, yf, wf = x.reshape(-1, x.shape[-1]), y.reshape(-1), w.reshape(-1)

        loss_before = float(feel_model.loss_fn(self.params, xf, yf, wf))

        if self.local_steps == 1:
            grads = _device_grads(self.params, x, y, w)  # leading K axis
        else:
            k = x.shape[0]
            dev_params = tree_map(lambda a: a.expand((k,) + a.shape),
                                  self.params)
            for _ in range(self.local_steps):
                g = _local_grads(dev_params, x, y, w)
                dev_params = tree_map(lambda p, gg: p - lr * gg,
                                      dev_params, g)
            grads = tree_map(lambda p0, pk: (p0[None] - pk) / lr,
                             self.params, dev_params)
        if self.compress:
            # per-device SBC (each device sparsifies its own upload), as
            # the engine's period step does
            if self.residuals is None:
                self.residuals = tree_map(torch.zeros_like, grads)
            grads, self.residuals = compress_dense(
                grads, self.scheduler.compression, self.residuals,
                batch_dims=1)
        # eq. (1): weighted average by B_k
        wk = bk / bk.sum()
        agg = tree_map(lambda g: torch.tensordot(wk, g, dims=1), grads)
        self.params = tree_map(lambda p_, g: p_ - lr * g, self.params, agg)

        loss_after = float(feel_model.loss_fn(self.params, xf, yf, wf))
        return loss_before, loss_after


# ---------------------------------------------------------------------------
# Table-II scheme comparison (DEPRECATED shim — prefer
# repro_torch.api.Experiment)
# ---------------------------------------------------------------------------


def run_scheme(scheme: str, devices, data: ClassificationData,
               test: ClassificationData, partition: str, periods: int,
               seed: int = 0, b_max: int = 128, base_lr: float = 0.05,
               eval_every: int = 10, device=None) -> RunResult:
    """DEPRECATED: run one Table-II scheme and return its trajectory.

    Thin shim kept for existing callers — ``repro_torch.api.Experiment``
    runs whole scheme grids as bucketed device loops.  The ``individual``
    / ``model_fl`` ledger comes from ``core.scheduler.DevScheduler`` and
    the trajectory from the engine's single-row dev program."""
    warnings.warn(
        "run_scheme is deprecated; use repro_torch.api.Experiment with "
        "ScenarioSpec(scheme=...)",
        DeprecationWarning, stacklevel=2)
    if scheme in ("feel", "proposed"):
        sim = FeelSimulation(devices, data, test, partition=partition,
                             policy="proposed", compress=True, b_max=b_max,
                             base_lr=base_lr, seed=seed, device=device)
        return sim.run(periods, eval_every)
    if scheme == "gradient_fl":
        sim = FeelSimulation(devices, data, test, partition=partition,
                             policy="full", compress=True, b_max=b_max,
                             base_lr=base_lr, seed=seed, device=device)
        r = sim.run(periods, eval_every)
        r.scheme = "gradient_fl"
        return r

    # individual / model_fl: per-device parameter copies; the planner
    # pre-generates indices and the latency ledger, the device runs one
    # loop
    device = resolve_device(device)
    k = len(devices)
    parts = _partition(partition, data, k, seed)
    p0 = feel_model.init(torch.Generator().manual_seed(seed),
                         input_dim=data.x.shape[1], device=device)
    dev_params = tree_map(
        lambda a: a[None].expand((k,) + a.shape).contiguous(), p0)
    n_params = sum(p.numel() for p in tree_leaves(p0))
    batch = min(b_max, 64)
    sched = DevScheduler(
        devices=devices, parts=parts, batch=batch,
        # payload: parameters, uncompressed (model-based FL uploads the model)
        payload_bits=32.0 * n_params, upload=(scheme == "model_fl"),
        seed=seed, cell=Cell.make(seed))
    horizon = sched.plan_horizon(periods)

    _, (losses, accs) = engine.run_dev_trajectory(
        EngineState(dev_params), horizon.idx, base_lr,
        engine.dataset_to_device(data, test, device),
        average=(scheme == "model_fl"))
    losses = losses.cpu().numpy()
    accs = accs.cpu().numpy()

    res = RunResult(scheme=scheme)
    for period in _eval_points(periods, eval_every):
        res.losses.append(float(losses[period]))
        res.accs.append(float(accs[period]))
        res.times.append(float(horizon.times[period]))
        res.global_batches.append(batch * k)
    return res
