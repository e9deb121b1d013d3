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
  sampling, the cumulative latency ledger; for a dev-scheme bucket
  (``individual`` / ``model_fl``) one ``core.scheduler.DevScheduler`` a
  row instead.
* :func:`dispatch_bucket` — init the rows' parameters (fresh run) and
  enqueue the bucket's device loop over the (scenario × seed) rows:
  ``engine.run_trajectory_batch`` (feel-mlp, any ``local_steps``),
  ``engine.run_hier_trajectory_batch`` (feel-mlp under a ``topology``),
  ``engine.run_dev_trajectory_batch`` (the dev schemes) or
  ``model_engine.run_model_trajectory_batch`` (the big-model families);
  CUDA work is asynchronous, so this returns before the device finishes.
* :func:`collect_bucket` — wait for the device values and return host
  ``(losses, accs, times, global_batch)`` series, one row per computed row.

Per-row rng streams (partitioner, batcher, scheduler channel draws) are
consumed in exactly the reference's order, so the host ledgers are bitwise
the reference's.  Fleet size is not structural: planning runs at each
row's true K, then schedules are zero-padded to the bucket's ``k_pad`` and
a per-row ``active`` mask keeps padded users out of every reduction.
When a row samples, faults or has an energy budget, the mask is
time-varying, (n, P, k_pad): each period's realized cohort, padded
columns exactly 0.  ``group_rows(..., bands=True)`` splits a bucket by
the power-of-two band of its rows' K, each band padded to its width.

:class:`BucketRun` runs the same phases per chunk of ``chunk`` periods,
carrying the planner's rng streams and time offsets and the engine's
:class:`~repro_torch.fed.engine.EngineState` between chunks; a chunked run
is bitwise equal to the monolithic one.  Its planning step touches no
torch, so a pipelined executor plans the next chunk while the card still
runs what the current one enqueued.

Dispatch runs over a batch mesh (``launch.mesh.make_batch_mesh``, or a
:class:`~repro_torch.launch.mesh.Mesh` whose devices repeat one device;
without one, the single device of the data): :func:`dispatch_bucket`
pads the bucket's n rows cyclically to a multiple of the mesh
(``pad_batch``, the reference's ``_pad_rows``), cuts them into
``mesh.size`` contiguous shards, and enqueues shard i on ``devices[i]``
against a copy of the data sets there (:meth:`DeviceData.on`), shard
after shard with no sync between them; :func:`collect_bucket` gathers
the shards in order and slices back to n.  A mesh of one device is one
shard of every row, the bucket's own plan.  Planning never sees the
mesh: host ledgers are the unsharded run's.

Because planning happens between chunks, a bucket whose specs set
``replan=`` (or run under ``Experiment.run(replan=)``) closes the
Algorithm-1 loop: chunk *c*'s realized loss decays are copied to the host
and feed each row's ξ estimator (``observe_series``) before chunk *c+1*
is planned, on a warm B* grid with the estimator's decay cap.  Closed-loop
rows each own their scheduler (realized decays are per trajectory, so the
``_plan_key`` horizon dedup does not apply), and an ``adapt_tau`` bucket
runs each chunk at the rows' consensus (minimum) recommended τ.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field, replace
from functools import cached_property
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.api.spec import ScenarioSpec
from repro_torch.core.scheduler import (DevScheduler, FeelScheduler,
                                        plan_horizons_batch)
from repro_torch.data.pipeline import (FederatedBatcher, partition_iid,
                                       partition_noniid)
from repro_torch.fed import engine, feel_model, model_engine
from repro_torch.launch.mesh import Mesh, canonical_device, pad_batch
from repro_torch.topology import band_width
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
    Rows may carry fleets of different sizes, padded to :attr:`k_pad`:
    the largest K, or the power-of-two ``band`` when the lowering
    sub-buckets by K band.  ``replan`` is the bucket's closed-loop ξ
    interval (None: open loop), from the rows' specs or a run-level
    override; executors run such a bucket in ``replan``-period chunks."""
    key: tuple
    rows: List[Row]
    replan: Optional[int] = None
    band: Optional[int] = None

    @property
    def kind(self) -> str:
        return self.key[0]      # "feel" | "dev"

    @property
    def k_pad(self) -> int:
        if self.band is not None:
            return self.band
        return max(r.spec.k for r in self.rows)

    def active_mask(self) -> np.ndarray:
        """(n, k_pad) f32 {0,1}: row r's first ``spec.k`` users active."""
        mask = np.zeros((len(self.rows), self.k_pad), np.float32)
        for i, r in enumerate(self.rows):
            mask[i, :r.spec.k] = 1.0
        return mask


def group_rows(specs: Sequence[ScenarioSpec],
               replan: Optional[int] = None,
               bands: bool = False) -> List[Bucket]:
    """Flatten specs × seeds into rows, grouped into first-seen-order
    buckets by shape compatibility; duplicate (spec, seed) pairs collapse
    onto one row carrying every output index.

    ``replan`` overrides every FEEL-family spec's own ``replan`` for this
    lowering (``Experiment.run(replan=)``: one knob for a whole grid).
    Dev-scheme specs have no ξ loop and keep open-loop execution, so a
    mixed grid accepts the override.  Rows are deduplicated and grouped
    on the spec as executed (specs differing only in ``replan`` are one
    trajectory under an override); each row keeps its spec as declared.

    ``bands=True`` further splits each bucket by the power-of-two K band
    (:func:`~repro_torch.topology.band_width`) of its rows: one bucket per
    band, padded to the band width instead of the grid's largest fleet.
    Host ledgers are bitwise the unbanded lowering's (no row's plan
    depends on its neighbours' padding)."""
    if replan is not None and (not isinstance(replan, int)
                               or isinstance(replan, bool) or replan < 1):
        raise ValueError(
            f"replan must be a positive int (periods per closed-loop "
            f"chunk), got {replan!r}")
    entries: Dict[tuple, List[list]] = {}
    seen: Dict[tuple, list] = {}
    replans: Dict[tuple, Optional[int]] = {}
    index = 0
    for spec in specs:
        if spec.is_dev_scheme:
            eff, eff_spec = None, spec
        else:
            eff = spec.replan if replan is None else replan
            eff_spec = (spec if eff == spec.replan
                        else replace(spec, replan=eff))
        key = eff_spec.bucket_key()
        band = band_width(eff_spec.k) if bands else None
        replans[key] = eff
        for seed in spec.seeds:
            if (eff_spec, seed) in seen:
                seen[(eff_spec, seed)].append(index)
            else:
                entry = [spec, seed, [index]]
                seen[(eff_spec, seed)] = entry[2]
                entries.setdefault((key, band), []).append(entry)
            index += 1
    return [Bucket(key=key, rows=[Row(spec=s, seed=sd, indices=tuple(ix))
                                  for s, sd, ix in rows],
                   replan=replans[key], band=band)
            for (key, band), rows in entries.items()]


@dataclass
class DeviceData:
    """An experiment's dataset on the device, in each form a bucket's
    engine reads — features for feel-mlp (``engine.dataset_to_device``),
    token sequences for the big-model families
    (``model_engine.tokens_to_device``) — each uploaded once, at first
    use.  :meth:`on` gives the same data on another device of a batch
    mesh, one copy a device."""
    data: object
    test: object
    device: object
    _copies: dict = field(default_factory=dict, repr=False)

    def on(self, device) -> "DeviceData":
        """This data on ``device``: itself on its own device, else a copy
        made at the first call for that device and kept."""
        device = canonical_device(device)
        if device == canonical_device(self.device):
            return self
        if device not in self._copies:
            self._copies[device] = DeviceData(self.data, self.test, device)
        return self._copies[device]

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
    lowering plans each unique key once.  Sampling and the dynamics
    processes are part of the key: they change the plan.
    So is the topology (the per-cell solves and the backhaul ledger).
    ``adapt_tau`` and ``model_family`` are part of the key as in the
    reference's; ``bucket_key`` already keeps them in separate buckets, so
    they change no plan."""
    s = r.spec
    return (s.fleet, s.effective_policy, s.b_max, s.compression, s.cell,
            s.hidden, s.depth, r.seed, s.sampling, s.topology, s.fading,
            s.faults, s.energy, s.adapt_tau, s.model_family)


def _rescale_lr(horizon, base_lr: float, ref_batch: float):
    """Per-row lr row for a shared horizon: η = η₀·√(B/B_ref), identical
    to what a scheduler constructed with this base_lr would emit."""
    return replace(horizon, lr=base_lr * np.sqrt(
        horizon.global_batch / ref_batch))


@dataclass
class BucketPlan:
    """Phase-1 output: host ledgers (one row per computed row) and what
    the dispatch phase feeds the device.

    A FEEL bucket carries the padded ``schedules``; a hierarchical one
    also the (n, E, k_pad) user→edge ``member`` one-hot
    (``Topology.member_matrix``, padded users in no edge) and the (n, P)
    ``cloud`` flags.  A dev bucket carries ``idx`` (n, P, k_pad, batch)
    and the per-row ``lr`` (n,) instead of schedules.  ``active`` is the
    static (n, k_pad) padding mask, or (n, P, k_pad) when a row sampled,
    faulted or has a budget; ``energy`` the host-only per-user joules
    ledger when a row has a budget (padded columns and unbudgeted rows
    exactly 0), else None; ``tau`` the local-step count an ``adapt_tau``
    bucket runs this chunk at (None: the spec's ``local_steps``)."""
    bucket: Bucket
    input_dim: int
    times: np.ndarray            # (n, P) cumulative simulated seconds
    global_batch: np.ndarray     # (n, P) int64
    schedules: Optional[list]
    active: np.ndarray           # (n, k_pad) or (n, P, k_pad) f32
    energy: Optional[np.ndarray] = None   # (n, P, k_pad) joules
    member: Optional[np.ndarray] = None   # (n, E, k_pad) f32, hierarchy
    cloud: Optional[np.ndarray] = None    # (n, P) f32 {0,1}, hierarchy
    idx: Optional[np.ndarray] = None      # (n, P, k_pad, batch), dev
    lr: Optional[np.ndarray] = None       # (n,) f32, dev
    tau: Optional[int] = None             # adaptive buckets' chunk τ


@dataclass
class BucketHandle:
    """Phase-2 output: in-flight device series + finished host ledgers,
    and the engine carry after this dispatch.  ``decays`` (FEEL buckets)
    are the realized per-period loss decays, the closed loop's ξ
    feedback.  Each device series is a tuple of the batch mesh's shards,
    (n_pad / size, P) tensors in shard order, and ``state`` a tuple of
    the shards' carries; on one device, one shard of all n rows."""
    bucket: Bucket
    losses: tuple                # shards of (n_pad, P), on their devices
    accs: tuple
    times: np.ndarray
    global_batch: np.ndarray
    state: tuple                 # an engine.EngineState a shard
    energy: Optional[np.ndarray] = None   # (n, P, k_pad) host joules
    decays: Optional[tuple] = None        # shards of (n_pad, P), feel


class _FeelPlanner:
    """Host planning state for one FEEL bucket, resumable chunk by chunk.

    ``per_row=False`` (open loop): one scheduler — and one planned
    horizon — per unique ``_plan_key``.  Successive ``plan()`` calls
    continue every rng stream and time offset, so N chunked plans are
    bitwise equal to one monolithic plan.

    ``per_row=True`` (closed loop): every row owns its scheduler and ξ
    estimator, since realized decays are per trajectory.  ``observe()``
    lands chunk *c*'s decays before ``plan()`` produces chunk *c+1*."""

    def __init__(self, bucket: Bucket, data, per_row: bool = False):
        rows = bucket.rows
        self.bucket = bucket
        self.per_row = per_row
        self.input_dim = data.x.shape[1]
        n_params = _n_params(rows[0].spec, self.input_dim)

        def make_scheduler(r: Row) -> FeelScheduler:
            return FeelScheduler(
                devices=r.spec.fleet, n_params=n_params,
                policy=r.spec.effective_policy, b_max=r.spec.b_max,
                base_lr=r.spec.base_lr, compression=r.spec.compression,
                cell_cfg=r.spec.cell, seed=r.seed,
                sampling=r.spec.sampling, topology=r.spec.topology,
                fading=r.spec.fading, faults=r.spec.faults,
                energy=r.spec.energy)

        self.schedulers: List[FeelScheduler] = []
        self._sched_of: List[int] = []
        unique: Dict[tuple, int] = {}
        for i, r in enumerate(rows):
            key = i if per_row else _plan_key(r)
            if key not in unique:
                unique[key] = len(self.schedulers)
                self.schedulers.append(make_scheduler(r))
            self._sched_of.append(unique[key])
        self.batchers = [
            FederatedBatcher(_partition(r.spec, data, r.seed),
                             r.spec.b_max, r.seed) for r in rows]
        self._offsets = np.zeros(len(rows))
        # adaptive local steps: the bucket-consensus τ the next chunk
        # runs at (the spec's local_steps until feedback has landed)
        self._tau = rows[0].spec.local_steps

    def plan(self, periods: int, warm_start: bool = False) -> BucketPlan:
        rows = self.bucket.rows
        k_pad = self.bucket.k_pad
        adapt = rows[0].spec.adapt_tau
        tau = None
        if adapt is not None:
            # τ shapes the device loop, so the bucket agrees on one a
            # chunk: the MIN of the rows' recommendations (never more
            # local compute than the most communication-starved row wants)
            tau = min(s.recommend_tau(adapt.choices, self._tau)
                      for s in self.schedulers)
            self._tau = tau
        # per_row IS the closed loop: the decay cap steers B* only once
        # rows own their estimators (and only after feedback has landed)
        planned = plan_horizons_batch(self.schedulers, periods,
                                      warm_start=warm_start,
                                      closed_loop=self.per_row)
        schedules, parts, clouds, energies = [], [], [], []
        for i, r in enumerate(rows):
            sched = self.schedulers[self._sched_of[i]]
            horizon = planned[self._sched_of[i]]
            if r.spec.base_lr != sched.base_lr:
                horizon = _rescale_lr(horizon, r.spec.base_lr,
                                      sched.ref_batch)
            parts.append(horizon.participation)
            clouds.append(horizon.cloud)
            energies.append(horizon.energy)
            s = engine.build_schedule(
                sched, self.batchers[i], periods, horizon=horizon,
                time_offset=float(self._offsets[i]),
                local_steps=r.spec.local_steps if tau is None else tau)
            self._offsets[i] = s.times[-1]
            schedules.append(engine.pad_schedule(s, k_pad))
        # the static (n, k_pad) padding mask, unless a row's cohort varies
        # by period: then an (n, P, k_pad) mask, padded columns exactly 0
        active = self.bucket.active_mask()
        if any(p is not None for p in parts):
            active = np.repeat(active[:, None, :], periods, axis=1)
            for i, (r, p) in enumerate(zip(rows, parts)):
                if p is not None:
                    active[i, :, :r.spec.k] = p
        energy = None
        if any(e is not None for e in energies):
            energy = np.zeros((len(rows), periods, k_pad))
            for i, (r, e) in enumerate(zip(rows, energies)):
                if e is not None:
                    energy[i, :, :r.spec.k] = e
        member = cloud = None
        if rows[0].spec.topology is not None:   # structural: all rows agree
            member = np.stack([r.spec.topology.member_matrix(r.spec.k, k_pad)
                               for r in rows])
            cloud = np.stack(clouds).astype(np.float32)
        return BucketPlan(
            bucket=self.bucket, input_dim=self.input_dim,
            times=np.stack([s.times for s in schedules]),
            global_batch=np.stack([s.global_batch for s in schedules]),
            schedules=schedules, active=active, energy=energy,
            member=member, cloud=cloud, tau=tau)

    def observe(self, decays: np.ndarray, global_batch: np.ndarray):
        """Feed one collected chunk's realized per-period loss decays,
        (n, P_c) row-major, into each row's ξ estimator."""
        assert self.per_row, "closed-loop feedback needs per-row schedulers"
        for i, s in enumerate(self.schedulers):
            s.observe_series(decays[i], global_batch[i])


class _DevPlanner:
    """Host planning state for one dev-scheme bucket, resumable chunk by
    chunk: one :class:`~repro_torch.core.scheduler.DevScheduler` a row,
    its rng streams and time offset carried between ``plan()`` calls.
    No ξ loop: ``per_row`` is accepted and ignored, and there is no
    ``observe``."""

    def __init__(self, bucket: Bucket, data, per_row: bool = False):
        rows = bucket.rows
        spec0 = rows[0].spec
        self.bucket = bucket
        self.input_dim = data.x.shape[1]
        self.batch = spec0.dev_epoch_batch
        n_params = _n_params(spec0, self.input_dim)
        self.schedulers = [
            DevScheduler(
                devices=r.spec.fleet, parts=_partition(r.spec, data, r.seed),
                batch=self.batch,
                # model-based FL uploads the raw parameters: d·p bits
                payload_bits=32.0 * n_params,
                upload=(r.spec.scheme == "model_fl"),
                seed=r.seed, cell_cfg=r.spec.cell,
                sampling=r.spec.sampling)
            for r in rows]
        self._offsets = np.zeros(len(rows))

    def plan(self, periods: int, warm_start: bool = False) -> BucketPlan:
        rows = self.bucket.rows
        k_pad = self.bucket.k_pad
        horizons = []
        for i, s in enumerate(self.schedulers):
            h = s.plan_horizon(periods, time_offset=float(self._offsets[i]))
            self._offsets[i] = h.times[-1]
            horizons.append(h)
        # rows plan at their true K; padded users read index 0 and the
        # active mask keeps them out of every update and mean
        idx = np.zeros((len(rows), periods, k_pad, self.batch), np.int64)
        for i, (r, h) in enumerate(zip(rows, horizons)):
            idx[i, :, :r.spec.k] = h.idx
        active = self.bucket.active_mask()
        gb = [np.full(periods, self.batch * r.spec.k, np.int64)
              for r in rows]
        if any(h.participation is not None for h in horizons):
            active = np.repeat(active[:, None, :], periods, axis=1)
            for i, (r, h) in enumerate(zip(rows, horizons)):
                if h.participation is not None:
                    active[i, :, :r.spec.k] = h.participation
                    gb[i] = (self.batch
                             * h.participation.astype(np.int64).sum(1))
        return BucketPlan(
            bucket=self.bucket, input_dim=self.input_dim,
            times=np.stack([h.times for h in horizons]),
            global_batch=np.stack(gb), schedules=None, active=active,
            idx=idx, lr=np.array([r.spec.base_lr for r in rows],
                                 np.float32))


def _make_planner(bucket: Bucket, data, per_row: bool = False):
    cls = _FeelPlanner if bucket.kind == "feel" else _DevPlanner
    return cls(bucket, data, per_row=per_row)


def plan_bucket(bucket: Bucket, data, periods: int) -> BucketPlan:
    """Host-side planning for one bucket (no device work)."""
    return _make_planner(bucket, data).plan(periods)


def chunk_lengths(periods: int, chunk: Optional[int]) -> Tuple[int, ...]:
    """The per-chunk period counts a ``chunk``-chunked horizon dispatches:
    ``chunk_lengths(7, 3) == (3, 3, 1)`` (``None``: one monolithic
    chunk)."""
    if chunk is None:
        return (periods,)
    chunk = min(max(1, chunk), periods)
    out = [chunk] * (periods // chunk)
    if periods % chunk:
        out.append(periods % chunk)
    return tuple(out)


def program_key(bucket: Bucket, n_rows: int, periods: int,
                data, test) -> tuple:
    """Hashable identity of the engine program one dispatch runs, and of
    the signature it runs at: the reference's tuple.  Equal keys dispatch
    one program at one signature (a warm dispatch records no
    ``engine.TraceEvent``); different keys may still share one — the key
    over-approximates, never the reverse.  ``bucket.key`` carries every
    static knob of the engine's program constructors (scheme, slot width,
    τ, compression and its ratio, model dims, topology, fading states);
    the rest of the signature is ``n_rows`` (the row axis as dispatched),
    ``k_pad``, the chunk's period count and the dataset's shapes, from
    which the feature and token forms of
    :class:`DeviceData` both follow.  Dtypes never vary: everything
    crosses ``engine.host_to_device``."""
    return (bucket.key, int(n_rows), bucket.k_pad, int(periods),
            tuple(data.x.shape), tuple(data.y.shape),
            tuple(test.x.shape), tuple(test.y.shape))


def bucket_program_keys(bucket: Bucket, n_rows: int, periods: int,
                        chunk: Optional[int], data, test) -> Tuple[tuple, ...]:
    """Every distinct :func:`program_key` a ``chunk``-chunked run of this
    bucket dispatches (first-use order): one per distinct chunk length."""
    out = []
    for p_c in chunk_lengths(periods, chunk):
        key = program_key(bucket, n_rows, p_c, data, test)
        if key not in out:
            out.append(key)
    return tuple(out)


def _broadcast_rows(params, n: int):
    """Row-batched leaves (R, ...) → (R, n, ...): every copy starts from
    its row's parameters."""
    return tree_map(lambda a: a[:, None].expand(
        (a.shape[0], n) + a.shape[1:]).contiguous(), params)


def _take_rows(plan: BucketPlan, take: np.ndarray) -> BucketPlan:
    """The plan of the rows ``take`` (indices into the bucket's rows, in
    order, repeats allowed), padded to the bucket's ``k_pad``: the plan
    itself when ``take`` is every row in order."""
    bucket = plan.bucket
    if np.array_equal(take, np.arange(len(bucket.rows))):
        return plan

    def rows(a):
        return None if a is None else a[take]
    # band pins the shard's k_pad to the whole bucket's
    sub = replace(bucket, rows=[bucket.rows[j] for j in take],
                  band=bucket.k_pad)
    return replace(plan, bucket=sub, times=plan.times[take],
                   global_batch=plan.global_batch[take],
                   schedules=(None if plan.schedules is None
                              else [plan.schedules[j] for j in take]),
                   active=plan.active[take], energy=rows(plan.energy),
                   member=rows(plan.member), cloud=rows(plan.cloud),
                   idx=rows(plan.idx), lr=rows(plan.lr))


def shard_rows(n: int, mesh) -> list:
    """The row indices of each of ``mesh``'s shards: the n rows padded
    cyclically to a multiple of the mesh (the reference's ``_pad_rows``,
    valid when the mesh is larger than the bucket) and cut into
    ``mesh.size`` contiguous pieces."""
    wrap = np.arange(n + pad_batch(n, mesh)) % n
    return np.split(wrap, mesh.size)


def one_device_mesh(arrays: DeviceData) -> Mesh:
    """The batch mesh of ``arrays``' one device."""
    return Mesh((torch.device(arrays.device),))


def dispatch_bucket(plan: BucketPlan, arrays: DeviceData, state=None,
                    mesh=None) -> BucketHandle:
    """Enqueue one planned bucket's device loop over a batch ``mesh``
    (None: :func:`one_device_mesh`): shard i of :func:`shard_rows` on
    ``mesh.devices[i]``, against ``arrays.on`` it, the shards enqueued
    back to back.  ``state`` resumes a previous dispatch's carries, one a
    shard."""
    mesh = one_device_mesh(arrays) if mesh is None else mesh
    states = (None,) * mesh.size if state is None else state
    handles = [_dispatch(_take_rows(plan, take), arrays.on(device), st)
               for take, device, st in zip(shard_rows(len(plan.bucket.rows),
                                                      mesh),
                                           mesh.devices, states)]

    def shards(name):
        series = tuple(getattr(h, name) for h in handles)
        return None if series[0] is None else series
    return BucketHandle(bucket=plan.bucket, losses=shards("losses"),
                        accs=shards("accs"), times=plan.times,
                        global_batch=plan.global_batch,
                        state=shards("state"), energy=plan.energy,
                        decays=shards("decays"))


def _dispatch(plan: BucketPlan, arrays: DeviceData,
              state=None) -> BucketHandle:
    """Enqueue one shard's device loop: the dev loop for a dev
    bucket (the reference's ``_dispatch_dev``); else, as the reference's
    ``_dispatch_feel``, the hierarchical loop under a topology, the
    big-model engine for a ``model_family`` bucket, or the flat feel-mlp
    loop, at the plan's ``tau`` when an adaptive bucket set one.
    ``state`` resumes a previous chunk's carry (``None``: fresh init
    params — broadcast over the devices of a dev row and over the edge
    replicas of a hierarchical row — and zero residuals)."""
    spec0 = plan.bucket.rows[0].spec
    k_pad = plan.bucket.k_pad
    if plan.bucket.kind == "dev":
        if state is None:
            params0 = _init_params_batch(plan.bucket.rows, plan.input_dim,
                                         arrays.device)
            state = engine.EngineState(_broadcast_rows(params0, k_pad))
        state, (losses, accs) = engine.run_dev_trajectory_batch(
            state, plan.idx, plan.lr, arrays.features,
            average=(spec0.scheme == "model_fl"), active=plan.active)
        return BucketHandle(bucket=plan.bucket, losses=losses, accs=accs,
                            times=plan.times,
                            global_batch=plan.global_batch, state=state)
    if state is None:
        params0 = _init_params_batch(plan.bucket.rows, plan.input_dim,
                                     arrays.device)
        residual0 = engine.zero_residual(params0, k_pad)
        if plan.member is not None:
            params0 = _broadcast_rows(params0, plan.member.shape[1])
        state = engine.EngineState(params0, residual0)
    local_steps = spec0.local_steps if plan.tau is None else plan.tau
    if plan.member is not None:
        state, (losses, accs, decays) = engine.run_hier_trajectory_batch(
            state, plan.member, plan.cloud, plan.schedules,
            arrays.features, compress=spec0.compress,
            ratio=spec0.compression, active=plan.active,
            local_steps=local_steps)
    elif spec0.model_family != "feel_mlp":
        state, (losses, accs, decays) = \
            model_engine.run_model_trajectory_batch(
                state, plan.schedules, arrays.tokens,
                model_family=spec0.model_family, hidden=spec0.hidden,
                depth=spec0.depth, compress=spec0.compress,
                ratio=spec0.compression, active=plan.active)
    else:
        state, (losses, accs, decays) = engine.run_trajectory_batch(
            state, plan.schedules, arrays.features, compress=spec0.compress,
            ratio=spec0.compression, active=plan.active,
            local_steps=local_steps)
    return BucketHandle(bucket=plan.bucket, losses=losses, accs=accs,
                        times=plan.times, global_batch=plan.global_batch,
                        state=state, energy=plan.energy, decays=decays)


# ---------------------------------------------------------------------------
# phase 2b: probe (trace the bucket's program without running it — the
# static analysis' entry point)
# ---------------------------------------------------------------------------


@dataclass
class TracedBucket:
    """One bucket program traced for inspection, with taint labels.

    ``graph`` is the aten graph (a ``torch.fx.GraphModule``) of one period
    of the exact program the dispatch phase runs, each kernel one stand-in
    node (``kernels.probe``); ``in_labels`` / ``out_contracts`` are the
    padding-taint annotations aligned with its flattened inputs / outputs
    (see :mod:`repro_torch.analysis.taint`); ``premise`` lists the ways
    the program breaks the induction's premise (empty: it holds);
    ``seconds`` is the probe's host time.  Built by :func:`trace_bucket`.
    """
    program: str
    graph: object                # torch.fx.GraphModule
    in_labels: list
    out_contracts: dict
    bucket: Bucket
    periods: int
    premise: list
    seconds: float


def trace_bucket(plan: BucketPlan, data, test) -> TracedBucket:
    """Trace one planned bucket's device program to a labeled aten graph.

    Mirrors :func:`dispatch_bucket`'s argument assembly exactly (fresh
    state), then traces the program with ``make_fx`` under fake tensors
    instead of running it: nothing runs on the card, and the program runs
    under ``engine.suspend_trace_count`` so the probe records nothing in
    the dispatch ledger.  Inside ``kernels.probe.probing`` each kernel is
    one stand-in node, so neither a kernel nor its plain version runs, and
    the graph is the card's op for op.  The fake tensors live on the CPU:
    with every kernel a stand-in, the program's graph does not depend on
    the device (the wrappers' device preconditions — head dims, 16-byte
    alignment — are the run's to check).

    **One period, by induction.**  The program is a Python loop over
    periods, so its trace grows with the horizon; the probe traces the
    program at P = 1 and the certificate covers any horizon by induction,
    as the reference's covers chunks.  Premise: each period slices the
    period-axis inputs (``xs``, ``active``, the hierarchy's ``cloud``,
    the dev loop's ``idx``) at p and runs the same body on the carry.
    :attr:`TracedBucket.premise` checks it on the graph: every use of a
    period-axis input is ``select(·, 1, 0)``, and the carry leaves come
    out with the shapes and dtypes they went in with.  Step: the carry's
    output contracts are the next period's input labels — the SBC
    residual ``Known(0)`` on padded lanes, the global parameters (and the
    hierarchy's per-edge replicas) free of any user lane — and the next
    period's slices carry the same labels.  So period p + 1 starts from
    the labels period p was certified under, and the cost of the trace
    does not grow with the horizon.

    The labels state the padded-lane facts the schedule construction
    guarantees:

    * FEEL: ``residual0`` and ``active`` hold exact zeros on padded
      lanes; ``idx``/``weight``/``batch`` padded lanes are *variant* —
      deliberately weaker than ``pad_schedule`` provides, so the
      certificate also covers hand-built (garbage) schedules and rests
      only on the program's own ``w*=active`` / ``bk*=active`` masking;
      the hierarchy's ``member`` columns of padded users are zero too;
    * dev: per-device params are variant on padded lanes, ``active`` is
      zero; the program's masked means must do all the work.
    """
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.utils import _pytree as pytree

    from repro_torch.analysis.taint import NO_LABEL, LaneLabel, OutContract
    from repro_torch.kernels import probe

    t0 = time.perf_counter()
    bucket = plan.bucket
    rows = bucket.rows
    spec0 = rows[0].spec
    k_pad = bucket.k_pad
    n = len(rows)
    periods = plan.times.shape[1]
    local_steps = spec0.local_steps if plan.tau is None else plan.tau
    name = f"{bucket.key}/P{periods}"
    if bucket.band is not None:
        name += f"/B{bucket.band}"
    if plan.tau is not None:
        name += f"/T{local_steps}"
    cpu = torch.device("cpu")
    arrays = DeviceData(data, test, cpu)
    # period 0 of a time-varying (n, P, K) mask; a static (n, K) one as is
    active = engine.normalize_active(
        plan.active[:, :1] if np.ndim(plan.active) == 3 else plan.active,
        n, 1, k_pad, cpu)
    params0 = _init_params_batch(rows, plan.input_dim, cpu)

    def label(tree, lab):
        return pytree.tree_map(lambda _: lab, tree)

    data_labels = (NO_LABEL,) * 4
    if bucket.kind == "dev":
        dev_params0 = _broadcast_rows(params0, k_pad)
        idx = engine.host_to_device(plan.idx[:, :1], cpu)
        lr = engine.host_to_device(plan.lr, cpu)
        fn = engine.dev_trajectory_program(
            average=(spec0.scheme == "model_fl"))
        args = (dev_params0, idx, lr, active, *arrays.features)
        labels = (label(dev_params0, LaneLabel(1, "variant")),
                  LaneLabel(2), NO_LABEL, LaneLabel(2, 0.0), *data_labels)
        periodic = (label(dev_params0, False), True, False, True,
                    *(False,) * 4)
        n_carry = len(pytree.tree_leaves(dev_params0))
        contracts = {}
    else:
        residual0 = engine.zero_residual(params0, k_pad)
        xs = engine.stack_schedules(
            [engine.slice_schedule(s, 0, 1) for s in plan.schedules], cpu)
        xs_labels = {key: LaneLabel(2) if key in ("idx", "weight", "batch")
                     else NO_LABEL for key in xs}
        compress, ratio = spec0.compress, spec0.compression
        res_labels = label(residual0, LaneLabel(1, 0.0))
        if plan.member is not None:
            # member's padded-user columns are all-zero one-hots — the
            # monoid identity of the routing contraction — and active's
            # padded lanes are zero; per-edge replicas are global values
            # (no user lane), so NO_LABEL
            n_edges = plan.member.shape[1]
            params0 = _broadcast_rows(params0, n_edges)
            cloud = engine.host_to_device(plan.cloud[:, :1], cpu)
            fn = engine.hier_trajectory_program(local_steps, compress,
                                                ratio, n_edges)
            member = engine.host_to_device(plan.member, cpu)
            args = (params0, residual0, member, active, cloud, xs,
                    *arrays.features)
            labels = (label(params0, NO_LABEL), res_labels,
                      LaneLabel(2, 0.0), LaneLabel(2, 0.0), NO_LABEL,
                      xs_labels, *data_labels)
            periodic = (label(params0, False), label(residual0, False),
                        False, True, True, label(xs, True), *(False,) * 4)
        else:
            if spec0.model_family != "feel_mlp":
                fn = model_engine.model_trajectory_program(
                    spec0.model_family, spec0.hidden, spec0.depth,
                    compress, ratio)
                data_args = arrays.tokens
            else:
                fn = engine.trajectory_program(local_steps, compress, ratio)
                data_args = arrays.features
            args = (params0, residual0, active, xs, *data_args)
            labels = (label(params0, NO_LABEL), res_labels,
                      LaneLabel(2, 0.0), xs_labels, *data_labels)
            periodic = (label(params0, False), label(residual0, False),
                        True, label(xs, True), *(False,) * 4)
        # outputs: (params, residual, (losses, accs, decays)): the carry's
        # contracts are the next period's labels
        n_leaves = len(pytree.tree_leaves(params0))
        n_carry = 2 * n_leaves
        contracts = {i: OutContract(axis=None) for i in range(n_leaves)}
        contracts.update({n_leaves + i: OutContract(axis=1, value=0.0)
                          for i in range(n_leaves)})
    with engine.suspend_trace_count(), probe.probing(), torch.no_grad():
        gm = make_fx(fn, tracing_mode="fake")(*args)
    # the trace records ops whose values reach no output (a view taken
    # only for its numel); they compute nothing the program returns
    gm.graph.eliminate_dead_code()
    premise = _period_premise(gm, pytree.tree_leaves(periodic), n_carry)
    return TracedBucket(program=name, graph=gm,
                        in_labels=pytree.tree_leaves(labels),
                        out_contracts=contracts, bucket=bucket,
                        periods=periods, premise=premise,
                        seconds=time.perf_counter() - t0)


def _period_premise(gm, periodic: Sequence[bool], n_carry: int) -> list:
    """How a one-period trace breaks the induction's premise: a
    period-axis input used other than as its period-0 slice, or a carry
    leaf whose shape or dtype changes."""
    from torch.utils import _pytree as pytree

    select = torch.ops.aten.select.int
    placeholders = [node for node in gm.graph.nodes
                    if node.op == "placeholder"]
    out = []
    for node, is_periodic in zip(placeholders, periodic):
        for user in node.users if is_periodic else ():
            if user.target is not select or tuple(user.args[1:]) != (1, 0):
                out.append(f"{node.name}: period-axis input used by "
                           f"{user.target} {user.args[1:]}, not as its "
                           "period slice select(1, 0)")
    output = next(node for node in gm.graph.nodes if node.op == "output")
    outs = pytree.tree_leaves(output.args[0])
    for i, (node, o) in enumerate(zip(placeholders[:n_carry],
                                      outs[:n_carry])):
        a, b = node.meta["val"], o.meta["val"]
        if a.shape != b.shape or a.dtype != b.dtype:
            out.append(f"carry leaf {i} ({node.name}) enters as "
                       f"{tuple(a.shape)} {a.dtype} and leaves as "
                       f"{tuple(b.shape)} {b.dtype}")
    return out


def audit_bucket_taint(plan: BucketPlan, data, test, report=None, *,
                       prefix: str = ""):
    """Run the padding-taint and graph-hygiene passes over one planned
    bucket's program: the per-bucket step of ``Experiment.run(audit=True)``,
    ``ExperimentService(audit=True)`` and the audit CLI.  A broken
    induction premise is a ``taint.induction-premise`` error.  The
    program's taint summary gains ``periods_traced`` and
    ``probe_seconds``; ``prefix`` goes before the program's name (the
    CLI's grid label)."""
    from repro_torch.analysis import compile_audit, taint
    from repro_torch.analysis.report import AuditReport, Severity

    if report is None:
        report = AuditReport()
    traced = trace_bucket(plan, data, test)
    program = prefix + traced.program
    for text in traced.premise:
        report.add("taint.induction-premise", Severity.ERROR,
                   f"{program}:premise", text)
    taint.analyze_graph(traced.graph, traced.in_labels,
                        traced.out_contracts, program=program, report=report)
    report.programs[program].update(periods_traced=1,
                                    probe_seconds=traced.seconds)
    compile_audit.audit_graph_hygiene(traced.graph, program=program,
                                      report=report)
    return report


def _to_host(series: tuple, n: int) -> np.ndarray:
    """A device series' shards gathered to the host in shard order and
    sliced back to the bucket's n rows: an (n, P) array."""
    return np.concatenate([s.cpu().numpy() for s in series])[:n]


def collect_bucket(handle: BucketHandle):
    """Wait for the bucket's device values; returns ``(losses, accs,
    times, global_batch)`` — (n, P) host arrays, one row per computed row."""
    n = len(handle.bucket.rows)
    return (_to_host(handle.losses, n), _to_host(handle.accs, n),
            handle.times, handle.global_batch)


@dataclass
class BucketRun:
    """Chunked, resumable execution of one bucket: the horizon splits into
    ``chunk``-period pieces, each planned (host), dispatched (device, with
    the engine carry threaded through) and collected in turn.

    * :meth:`plan_next` plans the next chunk: host work only (numpy, no
      torch call), so an executor may run it off the caller's thread — one
      thread at a time, in chunk order, which consumes every rng stream
      exactly as a serial run does.  The planner itself is built at the
      first plan.
    * :meth:`dispatch` enqueues a planned chunk on the caller's thread
      without waiting for the device; chunks are dispatched in the order
      they were planned.
    * :meth:`advance` is the two in one; :meth:`collect` waits for the
      oldest chunk in flight.  In a closed-loop bucket (``bucket.replan``,
      FEEL kind) ``collect`` also copies the chunk's realized decays to
      the host and feeds them to every row's ξ estimator, and chunks
      after the first are planned on a warm grid.
    * :attr:`can_advance` is the scheduling guard: a closed-loop bucket
      must collect chunk *c* before it plans chunk *c+1* (the feedback is
      the point; ``plan_next`` refuses too), while an open-loop bucket may
      run ahead as far as it likes.

    ``seconds`` sums the host clock spent in each of the three.
    ``mesh`` is the executor's batch mesh (None:
    :func:`one_device_mesh`).

    With ξ frozen (open loop) any chunk size, and any interleaving of the
    three, is bitwise equal to the monolithic three-phase path."""
    bucket: Bucket
    data: object
    periods: int
    chunk: int
    arrays: DeviceData
    mesh: object = None
    planned: int = 0
    dispatched: int = 0
    collected: int = 0
    _planner: object = None
    _state: object = None
    _pending: deque = field(default_factory=deque)
    _chunks: list = field(default_factory=list)
    _decays: list = field(default_factory=list)
    _energy: list = field(default_factory=list)
    seconds: dict = field(default_factory=lambda: dict.fromkeys(
        ("plan", "dispatch", "collect"), 0.0))

    def __post_init__(self):
        if self.chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {self.chunk}")
        self.chunk = min(self.chunk, self.periods)
        if self.mesh is None:
            self.mesh = one_device_mesh(self.arrays)
        self.closed_loop = (self.bucket.replan is not None
                            and self.bucket.kind == "feel")

    @property
    def n_chunks(self) -> int:
        return -(-self.periods // self.chunk)

    @property
    def done(self) -> bool:
        return self.collected >= self.periods

    @property
    def can_advance(self) -> bool:
        """Whether the next chunk can be planned and dispatched now,
        without a collect first."""
        if self.dispatched >= self.periods:
            return False
        return not (self.closed_loop and self._pending)

    def plan_next(self) -> BucketPlan:
        """Plan the next chunk (host only)."""
        if self.planned >= self.periods:
            raise RuntimeError("cannot plan: horizon fully planned")
        if self.closed_loop and self.planned > self.collected:
            raise RuntimeError(
                "cannot plan: a closed-loop chunk awaits collection")
        t0 = time.perf_counter()
        if self._planner is None:
            self._planner = _make_planner(self.bucket, self.data,
                                          per_row=self.closed_loop)
        p_c = min(self.chunk, self.periods - self.planned)
        # closed-loop chunks after the first re-plan on a warm B* grid
        if self.closed_loop and self.planned > 0:
            plan = self._planner.plan(p_c, warm_start=True)
        else:
            plan = self._planner.plan(p_c)
        self.planned += p_c
        self.seconds["plan"] += time.perf_counter() - t0
        return plan

    def dispatch(self, plan: BucketPlan) -> None:
        """Enqueue a planned chunk's device loop (async on CUDA), resuming
        the previous chunk's engine carry."""
        if self.dispatched >= self.planned:
            raise RuntimeError("no planned chunk awaits dispatch")
        t0 = time.perf_counter()
        handle = dispatch_bucket(plan, self.arrays, state=self._state,
                                 mesh=self.mesh)
        # the carry lives on in the next chunk; a handle in flight keeps
        # only its series
        self._state, handle.state = handle.state, None
        p_c = plan.times.shape[1]
        self._pending.append((p_c, handle))
        self.dispatched += p_c
        self.seconds["dispatch"] += time.perf_counter() - t0

    def advance(self) -> None:
        """Plan and dispatch the next chunk (host work + async enqueue)."""
        if not self.can_advance:
            raise RuntimeError(
                "cannot advance: horizon fully dispatched, or a "
                "closed-loop chunk awaits collection")
        if self.planned != self.dispatched:
            raise RuntimeError("cannot advance: a planned chunk awaits "
                               "dispatch")
        self.dispatch(self.plan_next())

    def collect(self) -> tuple:
        """Wait for the oldest chunk in flight and bank its host series
        (closed loop: and feed its realized decays to the ξ estimators);
        returns that chunk's ``(losses, accs, times, global_batch)``."""
        if not self._pending:
            raise RuntimeError("no chunk in flight to collect")
        t0 = time.perf_counter()
        p_c, handle = self._pending.popleft()
        chunk = collect_bucket(handle)
        if self.closed_loop:
            decays = _to_host(handle.decays, len(self.bucket.rows))
            self._decays.append(decays)
            self._planner.observe(decays, handle.global_batch)
        self._chunks.append(chunk)
        if handle.energy is not None:
            self._energy.append(handle.energy)
        self.collected += p_c
        self.seconds["collect"] += time.perf_counter() - t0
        return chunk

    def park(self) -> list:
        """Suspend the run at the current chunk boundary: collect every
        chunk in flight (returned oldest first, so a caller can still
        stream them) and fence the engine carry (a CUDA synchronize of
        each device the run uses; a no-op on the CPU).  Resuming a parked
        run with plain :meth:`advance` is bitwise equal to never having
        parked."""
        banked = []
        while self._pending:
            banked.append(self.collect())
        if self._state is not None:
            for device in {canonical_device(d) for d in self.mesh.devices}:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
        return banked

    @property
    def realized_decays(self) -> Optional[np.ndarray]:
        """(n, collected) realized per-period loss decays banked so far
        (closed-loop runs only; None open loop)."""
        if not self._decays:
            return None
        return np.concatenate(self._decays, axis=1)

    @property
    def energy_ledger(self) -> Optional[np.ndarray]:
        """(n, collected, k_pad) per-user joules spent per period, banked
        chunk by chunk (None unless the bucket's specs set an
        ``EnergyBudget``).  A host ledger like ``times``: it never
        reaches the device."""
        if not self._energy:
            return None
        return np.concatenate(self._energy, axis=1)

    def result(self):
        """The full-horizon ``(losses, accs, times, global_batch)``."""
        if not self.done:
            raise RuntimeError(
                f"bucket not fully collected: {self.collected} of "
                f"{self.periods} periods")
        return tuple(np.concatenate([c[j] for c in self._chunks], axis=1)
                     for j in range(4))

    def run_serial(self):
        """Strictly plan → dispatch → collect one chunk at a time (the
        reference schedule)."""
        while not self.done:
            self.advance()
            self.collect()
        return self.result()

    def drain(self):
        """Finish the bucket with maximal plan-ahead: dispatch whatever
        the closed-loop guard admits, collect otherwise.  Returns
        :meth:`result`."""
        while not self.done:
            while self.can_advance:
                self.advance()
            self.collect()
        return self.result()
