"""Structured sweep results with named scenario axes.

A :class:`Results` is a flat table: one row per realized (scenario, seed)
pair, one column block per trajectory series (period-major).  Row
coordinates — ``fleet``, ``partition``, ``policy``, ``scheme``, ``seed`` —
are first-class, so reductions and selections are label-driven instead of
string-key parsing:

    res = Experiment(data, test, specs).run(periods=100)
    res.sel(policy="proposed", partition="noniid").speed(0.6)
    res.sel(partition="iid").final_acc.mean()

The label coordinates are conveniences and need not be unique: two specs
differing only in, say, ``base_lr`` or ``b_max`` share every label.  The
``spec`` coordinate is the precise one — it holds the originating
:class:`ScenarioSpec` itself, so ``res.sel(spec=my_spec)`` always
isolates exactly one scenario's seed rows, and :meth:`Results.cells`
groups by it (never merging distinct scenarios, whatever their labels).

Experiments built from a :func:`repro_torch.api.study.grid` additionally
carry one coordinate per swept axis (dotted geometry axes sanitized:
``cell.radius_m`` → ``cell_radius_m``; the fleet-size axis ``users``
surfaces as ``num_users``), so ``res.sel(cell_radius_m=200.0)`` selects an
operating point without any string parsing, and :meth:`Results.unique`
walks an axis in declaration order.

:class:`ResultsBuilder` assembles a ``Results`` incrementally from
per-bucket chunks as executors collect them — there is no preallocated
full block, and :meth:`ResultsBuilder.partial` exposes the rows collected
so far (the streaming surface behind ``Experiment.stream``).

NaN accuracies mean "not evaluated at this period"; :func:`time_to_target`
masks them explicitly before comparing, so an unevaluated period never
counts as a miss *or* a hit and no invalid-compare warnings leak.

A copy of the reference's results module (pure numpy).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Mapping, Tuple

import numpy as np

COORD_NAMES = ("fleet", "partition", "policy", "scheme", "seed", "spec")


def empty_coords(n_rows: int, extra=()) -> Dict[str, np.ndarray]:
    """Allocate the per-row coordinate columns for ``n_rows`` output rows:
    the standard :data:`COORD_NAMES` plus any ``extra`` names."""
    coords = {name: np.empty(n_rows, object)
              for name in (*COORD_NAMES, *extra)}
    coords["seed"] = np.empty(n_rows, np.int64)
    return coords


def assign_row_coords(coords: Dict[str, np.ndarray], i: int,
                      spec, seed: int) -> None:
    """Fill output row ``i``'s standard coordinates from its originating
    spec — the single definition of how a ``ScenarioSpec`` labels a row."""
    coords["fleet"][i] = spec.name or f"K{spec.k}"
    coords["partition"][i] = spec.partition
    coords["policy"][i] = spec.effective_policy
    coords["scheme"][i] = spec.scheme
    coords["seed"][i] = seed
    coords["spec"][i] = spec


def time_to_target(accs, times, target_acc: float):
    """Simulated seconds until accuracy first reaches ``target_acc``.

    ``accs``/``times``: (..., periods).  NaN accuracies are masked out
    before the comparison (explicitly "not evaluated", never "failed"),
    and rows that never reach the target return ``inf``.
    """
    accs = np.asarray(accs, float)
    times = np.asarray(times, float)
    hit = np.where(np.isnan(accs), False, accs >= target_acc)
    return np.where(hit, times, np.inf).min(axis=-1)


@dataclass(frozen=True)
class Results:
    """Named-axis sweep output: (row, period) series + per-row coords."""
    coords: Mapping[str, np.ndarray]   # each (rows,): COORD_NAMES keys
    losses: np.ndarray                 # (rows, periods)
    accs: np.ndarray                   # (rows, periods)
    times: np.ndarray                  # (rows, periods) cumulative seconds
    global_batch: np.ndarray           # (rows, periods)
    n_buckets: int = 1                 # compiled programs this run lowered to
    complete: bool = True              # False for streamed partials
    audit: object = None               # AuditReport when run(audit=True)

    @property
    def rows(self) -> int:
        return self.losses.shape[0]

    @property
    def periods(self) -> int:
        return self.losses.shape[1]

    @property
    def final_acc(self) -> np.ndarray:
        return self.accs[:, -1]

    @property
    def final_loss(self) -> np.ndarray:
        return self.losses[:, -1]

    def speed(self, target_acc: float) -> np.ndarray:
        """(rows,) simulated time to reach ``target_acc`` (inf if never)."""
        return time_to_target(self.accs, self.times, target_acc)

    def sel(self, **coords) -> "Results":
        """Filter rows by coordinate value(s): scalars or collections.

        ``res.sel(policy="proposed", seed=(0, 1))``

        A tuple ``want`` against a tuple-valued coordinate (e.g. a swept
        ``seeds`` axis, whose values are seed tuples) matches by
        *equality*, not membership — ``sel(seeds=(0, 1))`` selects the
        rows swept with exactly that seed set; wrap it in a list
        (``sel(seeds=[(0, 1), (2, 3)])``) for membership.

        Fails loudly instead of returning silently-empty selections: an
        unknown coordinate name raises ``KeyError``, and a value that
        matches no row of its own column (out-of-grid — e.g. a radius
        that was never swept, a typo'd policy) raises ``ValueError``.  An
        empty *intersection* of individually-valid values is still a
        legitimate (empty) selection — and so is any no-match selection
        on a streamed *partial* (``complete=False``): a valid value whose
        bucket simply hasn't collected yet must not crash the stream
        consumer, so partials return the empty selection instead of
        raising.
        """
        mask = np.ones(self.rows, bool)
        for name, want in coords.items():
            if name not in self.coords:
                raise KeyError(f"unknown coordinate {name!r}; "
                               f"have {tuple(self.coords)}")
            col = self.coords[name]
            if isinstance(want, tuple) and \
                    any(isinstance(c, tuple) for c in col):
                here = np.array([c == want for c in col], bool)
            elif isinstance(want, (list, tuple, set, frozenset,
                                   np.ndarray)):
                here = np.array([c in want for c in col], bool)
            else:
                here = np.asarray(col == want, bool)
            if not here.any() and self.complete:
                raise ValueError(
                    f"sel({name}={want!r}) matches no row: value not in "
                    f"this Results' {name!r} coordinate "
                    f"(have {tuple(dict.fromkeys(col.tolist()))!r})")
            mask &= here
        return Results(
            coords={k: v[mask] for k, v in self.coords.items()},
            losses=self.losses[mask], accs=self.accs[mask],
            times=self.times[mask], global_batch=self.global_batch[mask],
            n_buckets=self.n_buckets, complete=self.complete,
            audit=self.audit)

    def unique(self, name: str) -> Tuple:
        """Unique values of one coordinate, first-seen (row) order —
        e.g. ``res.unique("num_users")`` walks a swept K axis."""
        if name not in self.coords:
            raise KeyError(f"unknown coordinate {name!r}; "
                           f"have {tuple(self.coords)}")
        out: List[object] = []
        for v in self.coords[name]:
            if v not in out:
                out.append(v)
        return tuple(out)

    def cells(self) -> Iterator[Tuple[Dict[str, object], "Results"]]:
        """Iterate unique (fleet, partition, policy, scheme) cells in row
        order, yielding (labels, seed-rows Results)."""
        seen = []
        keys = list(zip(*(self.coords[n].tolist()
                          for n in COORD_NAMES if n != "seed")))
        for key in keys:
            if key in seen:
                continue
            seen.append(key)
            labels = dict(zip((n for n in COORD_NAMES if n != "seed"), key))
            yield labels, self.sel(**labels)


@dataclass
class ResultsBuilder:
    """Incremental per-bucket :class:`Results` assembly.

    Executors collect buckets one at a time (possibly long after
    dispatch); the builder accumulates each bucket's rows as a chunk —
    no full-experiment block is preallocated — and can produce a
    :meth:`partial` ``Results`` of everything collected so far at any
    point.  ``coords`` holds the full experiment's per-row coordinates
    (cheap host values, known at lowering time); chunk rows address into
    them by output index.
    """
    coords: Mapping[str, np.ndarray]   # full-length (n_rows,) per coord
    n_rows: int
    n_buckets: int
    _chunks: List[tuple] = field(default_factory=list)

    def add_rows(self, indices, losses, accs, times, global_batch) -> None:
        """Add one collected bucket's rows (already fanned out to output
        indices — ``len(indices)`` rows per series)."""
        self._chunks.append((np.asarray(indices, np.int64),
                             np.asarray(losses), np.asarray(accs),
                             np.asarray(times), np.asarray(global_batch)))

    @property
    def collected_rows(self) -> int:
        return sum(len(c[0]) for c in self._chunks)

    def partial(self) -> Results:
        """A ``Results`` of every row collected so far, in output-index
        order (equals the complete result once all buckets are in)."""
        if not self._chunks:
            raise ValueError("no buckets collected yet")
        idx = np.concatenate([c[0] for c in self._chunks])
        order = np.argsort(idx, kind="stable")
        sel = idx[order]
        stack = [np.concatenate([c[j] for c in self._chunks])[order]
                 for j in range(1, 5)]
        return Results(
            coords={k: v[sel] for k, v in self.coords.items()},
            losses=stack[0], accs=stack[1], times=stack[2],
            global_batch=stack[3], n_buckets=self.n_buckets,
            complete=self.collected_rows == self.n_rows)

    def build(self) -> Results:
        """The complete ``Results``; raises if any bucket is missing."""
        if self.collected_rows != self.n_rows:
            raise ValueError(
                f"incomplete collection: {self.collected_rows} of "
                f"{self.n_rows} rows")
        return self.partial()
