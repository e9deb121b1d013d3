"""ScenarioSpec → batched device loop, in three phases.

``group_rows(...)`` flattens the (spec × seed) grid of an experiment into
shape-compatible buckets (``ScenarioSpec.bucket_key``); duplicate
(spec, seed) occurrences collapse onto one computed row whose
``Row.indices`` fan the result back out.  Each bucket then runs as ONE
batched device loop over its rows via three phases:

* :func:`plan_bucket` — host only (numpy): channel Monte-Carlo draws,
  Algorithm-1 bisections (``core.scheduler.plan_horizons_batch``, rows
  fused into one lockstep solve), horizon dedup across rows that are
  scheduler-identical modulo partition/base_lr (``_plan_key``), batcher
  sampling, the cumulative latency ledger.
* :func:`dispatch_bucket` — init the rows' parameters (fresh run) and
  enqueue ``engine.run_trajectory_batch`` (feel-mlp) or
  ``model_engine.run_model_trajectory_batch`` (the transformer family)
  over the (scenario × seed) rows;
  CUDA work is asynchronous, so this returns before the device finishes.
* :func:`collect_bucket` — wait for the device values and return host
  ``(losses, accs, times, global_batch)`` series, one row per computed row.

Per-row rng streams (partitioner, batcher, scheduler channel draws) are
consumed in exactly the reference's order, so the host ledgers are bitwise
the reference's.  Fleet size is not structural: planning runs at each
row's true K, then schedules are zero-padded to the bucket's ``k_pad`` and
a per-row ``active`` mask keeps padded users out of every reduction.

:class:`BucketRun` runs the same phases per chunk of ``chunk`` periods,
carrying the planner's rng streams and time offsets and the engine's
:class:`~repro_torch.fed.engine.EngineState` between chunks; a chunked run
is bitwise equal to the monolithic one.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field, replace
from functools import cached_property
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.api.spec import ScenarioSpec
from repro_torch.core.scheduler import FeelScheduler, plan_horizons_batch
from repro_torch.data.pipeline import (FederatedBatcher, partition_iid,
                                       partition_noniid)
from repro_torch.fed import engine, feel_model, model_engine
from repro_torch.tree import tree_map


@dataclass(frozen=True)
class Row:
    """One computed (spec, seed) pair of a bucket's row axis; ``indices``
    are the experiment-output rows it feeds (more than one when a spec
    was declared twice)."""
    spec: ScenarioSpec
    seed: int
    indices: Tuple[int, ...]


@dataclass
class Bucket:
    """All rows sharing one ``bucket_key`` → one batched device loop.
    Rows may carry fleets of different sizes, padded to :attr:`k_pad`."""
    key: tuple
    rows: List[Row]

    @property
    def k_pad(self) -> int:
        return max(r.spec.k for r in self.rows)

    def active_mask(self) -> np.ndarray:
        """(n, k_pad) f32 {0,1}: row r's first ``spec.k`` users active."""
        mask = np.zeros((len(self.rows), self.k_pad), np.float32)
        for i, r in enumerate(self.rows):
            mask[i, :r.spec.k] = 1.0
        return mask


def group_rows(specs: Sequence[ScenarioSpec]) -> List[Bucket]:
    """Flatten specs × seeds into rows, grouped into first-seen-order
    buckets by shape compatibility; duplicate (spec, seed) pairs collapse
    onto one row carrying every output index."""
    entries: Dict[tuple, List[list]] = {}
    seen: Dict[tuple, list] = {}
    index = 0
    for spec in specs:
        key = spec.bucket_key()
        for seed in spec.seeds:
            if (spec, seed) in seen:
                seen[(spec, seed)].append(index)
            else:
                entry = [spec, seed, [index]]
                seen[(spec, seed)] = entry[2]
                entries.setdefault(key, []).append(entry)
            index += 1
    return [Bucket(key=key, rows=[Row(spec=s, seed=sd, indices=tuple(ix))
                                  for s, sd, ix in rows])
            for key, rows in entries.items()]


@dataclass
class DeviceData:
    """An experiment's dataset on the device, in each form a bucket's
    engine reads — features for feel-mlp (``engine.dataset_to_device``),
    token sequences for the big-model families
    (``model_engine.tokens_to_device``) — each uploaded once, at first
    use."""
    data: object
    test: object
    device: object

    @cached_property
    def features(self) -> tuple:
        return engine.dataset_to_device(self.data, self.test, self.device)

    @cached_property
    def tokens(self) -> tuple:
        return model_engine.tokens_to_device(self.data, self.test,
                                             self.device)


def _partition(spec: ScenarioSpec, data, seed: int):
    if spec.partition == "iid":
        return partition_iid(len(data.y), spec.k, seed)
    return partition_noniid(data.y, spec.k, seed=seed)


def _n_params(spec: ScenarioSpec, input_dim: int, classes: int = 10) -> int:
    if spec.model_family != "feel_mlp":
        # the big-model families price the uplink at the true parameter
        # count of the derived ArchConfig
        return model_engine.family_n_params(spec.model_family, spec.hidden,
                                            spec.depth)
    dims = [input_dim] + [spec.hidden] * (spec.depth - 1) + [classes]
    return sum(i * o + o for i, o in zip(dims[:-1], dims[1:]))


def _init_params_batch(rows: Sequence[Row], input_dim: int, device):
    """Row-batched initial params: each row draws its model's init
    (``feel_model.init``, or ``models.model.init`` for a big-model
    family) from a CPU generator seeded with its seed, so a row's weights
    do not depend on the device or on its bucket neighbours."""
    spec = rows[0].spec
    if spec.model_family != "feel_mlp":
        return model_engine.init_params_batch(
            spec.model_family, spec.hidden, spec.depth,
            [r.seed for r in rows], device)
    per_row = [feel_model.init(torch.Generator().manual_seed(r.seed),
                               spec.hidden, depth=spec.depth,
                               input_dim=input_dim)
               for r in rows]
    return tree_map(lambda *leaves: torch.stack(leaves).to(device),
                    *per_row)


def _plan_key(r: Row) -> tuple:
    """Scheduler identity modulo ``base_lr``: rows with equal keys consume
    identical rng streams and produce identical horizons (the partition
    only affects the batcher, base_lr only rescales the lr row), so the
    lowering plans each unique key once.  ``model_family`` is part of the
    key as in the reference's; ``bucket_key`` already keeps the families
    in separate buckets, so it changes no plan."""
    s = r.spec
    return (s.fleet, s.effective_policy, s.b_max, s.compression, s.cell,
            s.hidden, s.depth, r.seed, s.model_family)


def _rescale_lr(horizon, base_lr: float, ref_batch: float):
    """Per-row lr row for a shared horizon: η = η₀·√(B/B_ref), identical
    to what a scheduler constructed with this base_lr would emit."""
    return replace(horizon, lr=base_lr * np.sqrt(
        horizon.global_batch / ref_batch))


@dataclass
class BucketPlan:
    """Phase-1 output: host ledgers (one row per computed row) and the
    padded schedules + active mask the dispatch phase feeds the device."""
    bucket: Bucket
    input_dim: int
    times: np.ndarray            # (n, P) cumulative simulated seconds
    global_batch: np.ndarray     # (n, P) int64
    schedules: list
    active: np.ndarray           # (n, k_pad) f32


@dataclass
class BucketHandle:
    """Phase-2 output: in-flight device series + finished host ledgers,
    and the engine carry after this dispatch."""
    bucket: Bucket
    losses: torch.Tensor         # (n, P) on the device
    accs: torch.Tensor           # (n, P) on the device
    times: np.ndarray
    global_batch: np.ndarray
    state: engine.EngineState


class _FeelPlanner:
    """Host planning state for one bucket, resumable chunk by chunk: one
    scheduler — and one planned horizon — per unique ``_plan_key``.
    Successive ``plan()`` calls continue every rng stream and time
    offset, so N chunked plans are bitwise equal to one monolithic plan."""

    def __init__(self, bucket: Bucket, data):
        rows = bucket.rows
        self.bucket = bucket
        self.input_dim = data.x.shape[1]
        n_params = _n_params(rows[0].spec, self.input_dim)
        self.schedulers: List[FeelScheduler] = []
        self._sched_of: List[int] = []
        unique: Dict[tuple, int] = {}
        for r in rows:
            key = _plan_key(r)
            if key not in unique:
                unique[key] = len(self.schedulers)
                self.schedulers.append(FeelScheduler(
                    devices=r.spec.fleet, n_params=n_params,
                    policy=r.spec.effective_policy, b_max=r.spec.b_max,
                    base_lr=r.spec.base_lr, compression=r.spec.compression,
                    cell_cfg=r.spec.cell, seed=r.seed))
            self._sched_of.append(unique[key])
        self.batchers = [
            FederatedBatcher(_partition(r.spec, data, r.seed),
                             r.spec.b_max, r.seed) for r in rows]
        self._offsets = np.zeros(len(rows))

    def plan(self, periods: int) -> BucketPlan:
        planned = plan_horizons_batch(self.schedulers, periods)
        schedules = []
        for i, r in enumerate(self.bucket.rows):
            sched = self.schedulers[self._sched_of[i]]
            horizon = planned[self._sched_of[i]]
            if r.spec.base_lr != sched.base_lr:
                horizon = _rescale_lr(horizon, r.spec.base_lr,
                                      sched.ref_batch)
            s = engine.build_schedule(sched, self.batchers[i], periods,
                                      horizon=horizon,
                                      time_offset=float(self._offsets[i]))
            self._offsets[i] = s.times[-1]
            schedules.append(engine.pad_schedule(s, self.bucket.k_pad))
        return BucketPlan(
            bucket=self.bucket, input_dim=self.input_dim,
            times=np.stack([s.times for s in schedules]),
            global_batch=np.stack([s.global_batch for s in schedules]),
            schedules=schedules, active=self.bucket.active_mask())


def plan_bucket(bucket: Bucket, data, periods: int) -> BucketPlan:
    """Host-side planning for one bucket (no device work)."""
    return _FeelPlanner(bucket, data).plan(periods)


def dispatch_bucket(plan: BucketPlan, arrays: DeviceData,
                    state=None) -> BucketHandle:
    """Enqueue one planned bucket's device loop (the reference's
    ``_dispatch_feel``): the feel-mlp engine, or the big-model engine for
    a ``model_family`` bucket.  ``state`` resumes a previous chunk's carry
    (``None``: fresh init params and zero residuals)."""
    spec0 = plan.bucket.rows[0].spec
    if state is None:
        params0 = _init_params_batch(plan.bucket.rows, plan.input_dim,
                                     arrays.device)
        state = engine.EngineState(
            params0, engine.zero_residual(params0, plan.bucket.k_pad))
    if spec0.model_family != "feel_mlp":
        state, (losses, accs, _) = model_engine.run_model_trajectory_batch(
            state, plan.schedules, arrays.tokens,
            model_family=spec0.model_family, hidden=spec0.hidden,
            depth=spec0.depth, compress=spec0.compress,
            ratio=spec0.compression, active=plan.active)
    else:
        state, (losses, accs, _) = engine.run_trajectory_batch(
            state, plan.schedules, arrays.features, compress=spec0.compress,
            ratio=spec0.compression, active=plan.active)
    return BucketHandle(bucket=plan.bucket, losses=losses, accs=accs,
                        times=plan.times, global_batch=plan.global_batch,
                        state=state)


def collect_bucket(handle: BucketHandle):
    """Wait for the bucket's device values; returns ``(losses, accs,
    times, global_batch)`` — (n, P) host arrays, one row per computed row."""
    return (handle.losses.cpu().numpy(), handle.accs.cpu().numpy(),
            handle.times, handle.global_batch)


@dataclass
class BucketRun:
    """Chunked, resumable execution of one bucket: the horizon splits into
    ``chunk``-period pieces, each planned (host), dispatched (device, with
    the engine carry threaded through) and collected in turn.

    :meth:`advance` plans and dispatches the next chunk without waiting
    for the device, so the host plans chunk *c+1* while the device runs
    chunk *c*; :meth:`collect` waits for the oldest chunk in flight.  Any
    chunk size, and any interleaving of the two, is bitwise equal to the
    monolithic three-phase path."""
    bucket: Bucket
    data: object
    periods: int
    chunk: int
    arrays: DeviceData
    planned: int = 0
    collected: int = 0
    _planner: object = None
    _state: object = None
    _pending: deque = field(default_factory=deque)
    _chunks: list = field(default_factory=list)

    def __post_init__(self):
        if self.chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {self.chunk}")
        self.chunk = min(self.chunk, self.periods)
        self._planner = _FeelPlanner(self.bucket, self.data)

    @property
    def done(self) -> bool:
        return self.collected >= self.periods

    @property
    def can_advance(self) -> bool:
        return self.planned < self.periods

    def advance(self) -> None:
        """Plan and dispatch the next chunk (host work + async enqueue)."""
        if not self.can_advance:
            raise RuntimeError("cannot advance: horizon fully dispatched")
        p_c = min(self.chunk, self.periods - self.planned)
        handle = dispatch_bucket(self._planner.plan(p_c), self.arrays,
                                 state=self._state)
        self.planned += p_c
        self._state = handle.state
        self._pending.append((p_c, handle))

    def collect(self) -> tuple:
        """Wait for the oldest chunk in flight and bank its host series;
        returns that chunk's ``(losses, accs, times, global_batch)``."""
        if not self._pending:
            raise RuntimeError("no chunk in flight to collect")
        p_c, handle = self._pending.popleft()
        chunk = collect_bucket(handle)
        self._chunks.append(chunk)
        self.collected += p_c
        return chunk

    def result(self):
        """The full-horizon ``(losses, accs, times, global_batch)``."""
        if not self.done:
            raise RuntimeError(
                f"bucket not fully collected: {self.collected} of "
                f"{self.periods} periods")
        return tuple(np.concatenate([c[j] for c in self._chunks], axis=1)
                     for j in range(4))

    def run_serial(self):
        """Strictly plan → dispatch → collect one chunk at a time."""
        while not self.done:
            self.advance()
            self.collect()
        return self.result()
