"""Study grids: product-expansion sweeps over any ``ScenarioSpec`` field.

``grid(base, **axes)`` expands a base spec along named axes into a
:class:`Study` — a deduplicated, ordered sequence of ``ScenarioSpec``
values that an ``Experiment`` accepts directly, plus the per-spec axis
coordinates that :class:`repro_torch.api.results.Results` carries so swept
values are selectable without string parsing:

    study = grid(base,
                 policy=["proposed", "full"],
                 **{"cell.radius_m": [100.0, 200.0, 400.0]})
    res = Experiment(data, test, study).run(periods=100)
    res.sel(cell_radius_m=200.0, policy="proposed").speed(0.6)

Axis kinds
----------
* **field axis** — the name is a ``ScenarioSpec`` field
  (``policy=[...]``, ``b_max=[...]``, ``seeds=[(0, 1), (2, 3)]``);
* **dotted axis** — the name paths into a nested frozen-dataclass field,
  e.g. ``cell.radius_m`` / ``cell.bandwidth_hz`` / ``cell.tx_power_dbm``
  sweep the wireless :class:`~repro_torch.channels.model.CellConfig` geometry
  (pass via ``**{"cell.radius_m": [...]}``).  The Results coordinate name
  is the dotted path with ``.`` → ``_``;
* **labeled axis** — the value is a mapping ``{label: {field: value,
  ...}}`` bundling several (possibly dotted) field updates under one
  coordinate label, for paired knobs that are one conceptual axis:
  ``model={"resnet_stand_in": dict(hidden=256, depth=3), ...}``;
* **users axis** — fleet size/composition as a first-class sweep (the
  paper's "impact of number of users" knob).  ``users=[4, 8, 16]``
  resizes the base fleet to each K — truncating, or extending by cycling
  the base profiles round-robin — while ``users={label: fleet}`` sweeps
  explicit (heterogeneous) fleets.  The Results coordinate is
  ``num_users`` (the swept K, or the label for explicit fleets):
  ``res.sel(num_users=8)``.  Fleet size is *not* structural
  (``spec.bucket_key``): the whole K-sweep lowers into the same padded
  bucket as the base spec, one compiled program.

Expansion is the full cartesian product in axis-declaration order.
Expanded specs get auto-derived labels: ``name`` gains a ``key=value``
suffix per axis that the row label does not already carry (partition /
scheme / policy are label fields already).  Specs that expand identical
(duplicate axis values) are deduplicated, first combination wins —
``Experiment`` additionally dedupes identical (spec, seed) rows at
``lower()`` time, so a Study never pays twice for one trajectory.

A copy of the reference's study module: the same expansion, labels,
deduplication and rejections — a policy swept over a scheme that reports
another policy (``gradient_fl``'s ``"full"``, the dev schemes' ``"none"``)
does not survive to its coordinate and is refused.
"""
from __future__ import annotations

from dataclasses import fields, is_dataclass, replace
from typing import Dict, List, Mapping, Sequence, Set, Tuple

from itertools import combinations, product

from repro_torch.api.results import COORD_NAMES
from repro_torch.api.spec import ScenarioSpec

# axis names whose values the row label already shows (spec.label builds
# from name/partition/scheme/effective_policy) — no name suffix for these
_LABEL_FIELDS = ("name", "partition", "scheme", "policy")
# the only COORD_NAMES collisions allowed: plain field axes whose built-in
# Results coordinate carries the swept value verbatim (checked per
# expanded spec below — "policy" surfaces as effective_policy, which drops
# the swept value on dev/gradient_fl schemes).  Anything else (labeled
# axes named "fleet"/"policy"/…, a plain "fleet" sweep whose built-in
# coordinate holds the spec *name*) would silently never match a sel() on
# the declared axis — rejected at grid() time instead.
_PASSTHROUGH_COORDS = {
    "partition": lambda s: s.partition,
    "scheme": lambda s: s.scheme,
    "policy": lambda s: s.effective_policy,
}
# axes whose Results coordinate carries a different name than the axis
# (the ``users`` axis writes the ``fleet`` field; its swept value — K or
# an explicit-fleet label — surfaces as ``num_users``)
_COORD_RENAMES = {"users": "num_users"}


def _coord_name(axis: str) -> str:
    return _COORD_RENAMES.get(axis, axis.replace(".", "_"))


def _resize_fleet(fleet: Tuple, k: int) -> Tuple:
    """The ``users=[K, ...]`` resize rule: truncate to the first K
    profiles, or extend by cycling the base profiles round-robin."""
    if not isinstance(k, int) or isinstance(k, bool) or k < 1:
        raise ValueError(
            f"users axis: fleet size must be a positive int, got {k!r} "
            f"(use users={{label: fleet}} for explicit fleets)")
    return tuple(fleet[i % len(fleet)] for i in range(k))


def _users_choices(base: ScenarioSpec, values):
    """Normalize a ``users`` axis into (coord, {'fleet': fleet}) choices."""
    if isinstance(values, Mapping):
        choices = []
        for label, fl in values.items():
            fl = tuple(fl)
            if not fl:
                raise ValueError(
                    f"users axis: fleet for {label!r} is empty")
            choices.append((label, {"fleet": fl}))
        return choices
    return [(k, {"fleet": _resize_fleet(base.fleet, k)}) for k in values]


def _field_names(obj) -> Tuple[str, ...]:
    return tuple(f.name for f in fields(obj))


def _check_path(base: ScenarioSpec, path: str) -> None:
    """Validate a (possibly dotted) field path against the spec layout."""
    obj = base
    parts = path.split(".")
    for i, part in enumerate(parts):
        names = _field_names(obj)
        if part not in names:
            raise ValueError(
                f"axis {path!r}: {type(obj).__name__} has no field "
                f"{part!r}; valid fields: {names}")
        if i < len(parts) - 1:
            obj = getattr(obj, part)
            if not is_dataclass(obj):
                raise ValueError(
                    f"axis {path!r}: field {part!r} is not a nested "
                    f"dataclass, cannot path into it")


def _apply_updates(base: ScenarioSpec,
                   updates: Mapping[str, object]) -> ScenarioSpec:
    """``dataclasses.replace`` through dotted paths (one nesting level —
    the spec layout is flat apart from ``cell``)."""
    top: Dict[str, object] = {}
    nested: Dict[str, Dict[str, object]] = {}
    for path, value in updates.items():
        if "." in path:
            head, leaf = path.split(".", 1)
            nested.setdefault(head, {})[leaf] = value
        else:
            top[path] = value
    for head, sub in nested.items():
        top[head] = replace(getattr(base, head), **sub)
    return replace(base, **top)


def _fmt(value) -> str:
    if isinstance(value, float):
        return f"{value:g}"
    return str(value)


class Study(Sequence):
    """An expanded grid: ordered deduplicated specs + axis coordinates.

    Behaves as a ``Sequence[ScenarioSpec]`` (so ``Experiment(data, test,
    study)`` just works); additionally exposes the swept axes so the
    experiment can attach them to ``Results`` as named coordinates.
    """

    def __init__(self, base: ScenarioSpec,
                 axes: Mapping[str, Tuple[object, ...]],
                 specs: Sequence[ScenarioSpec],
                 coords: Mapping[ScenarioSpec, Mapping[str, object]]):
        self.base = base
        self.axes = dict(axes)             # axis name -> swept values/labels
        self._specs = tuple(specs)
        self._coords = dict(coords)

    # ---- Sequence protocol -------------------------------------------------
    def __len__(self) -> int:
        return len(self._specs)

    def __getitem__(self, i):
        return self._specs[i]

    def __iter__(self):
        return iter(self._specs)

    def __repr__(self) -> str:
        ax = ", ".join(f"{k}×{len(v)}" for k, v in self.axes.items())
        return f"Study({len(self._specs)} specs; axes: {ax or 'none'})"

    # ---- coordinate surface (consumed by Experiment) -----------------------
    @property
    def specs(self) -> Tuple[ScenarioSpec, ...]:
        return self._specs

    @property
    def coord_names(self) -> Tuple[str, ...]:
        """Sanitized Results coordinate names, axis-declaration order."""
        return tuple(_coord_name(name) for name in self.axes)

    def axis_coords(self, spec: ScenarioSpec) -> Mapping[str, object]:
        """The swept-axis values that produced ``spec`` (sanitized keys)."""
        return self._coords.get(spec, {})


def grid(base: ScenarioSpec, **axes) -> Study:
    """Expand ``base`` along ``axes`` into a deduplicated :class:`Study`.

    See the module docstring for axis kinds; dotted geometry axes are
    passed via ``**{"cell.radius_m": [...]}``.
    """
    # normalize: axis name -> list of (coord_value, {path: value}) choices
    normalized: Dict[str, List[Tuple[object, Dict[str, object]]]] = {}
    touched: Dict[str, Set[str]] = {}    # axis -> field paths it writes
    for name, values in axes.items():
        coord = _coord_name(name)
        if coord in COORD_NAMES and not (
                coord == name and name in _PASSTHROUGH_COORDS
                and not isinstance(values, Mapping)):
            raise ValueError(
                f"axis {name!r}: Results has a built-in {coord!r} "
                f"coordinate that would not carry the swept values — "
                f"rename the axis (e.g. a labeled axis "
                f"'{name}s={{label: {{field: value}}}}')")
        if name == "users":
            choices = _users_choices(base, values)
            touched[name] = {"fleet"}
        elif isinstance(values, Mapping):
            for label, updates in values.items():
                if not isinstance(updates, Mapping):
                    raise ValueError(
                        f"labeled axis {name!r}: value for {label!r} must "
                        f"be a mapping of field updates")
                for path in updates:
                    _check_path(base, path)
            choices = [(label, dict(updates))
                       for label, updates in values.items()]
            touched[name] = {p for upd in values.values() for p in upd}
        else:
            _check_path(base, name)
            choices = [(v, {name: v}) for v in values]
            touched[name] = {name}
        if not choices:
            raise ValueError(f"axis {name!r} has no values")
        normalized[name] = choices
    for (a, pa), (b, pb) in combinations(touched.items(), 2):
        clash = [(p, q) for p in pa for q in pb
                 if p == q or p.startswith(q + ".")
                 or q.startswith(p + ".")]
        if clash:
            raise ValueError(
                f"axes {a!r} and {b!r} both write field "
                f"{clash[0][0]!r}/{clash[0][1]!r}: overlapping axes would "
                f"silently override each other — make the axes disjoint")

    specs: List[ScenarioSpec] = []
    coords: Dict[ScenarioSpec, Dict[str, object]] = {}
    for combo in product(*normalized.values()):
        updates: Dict[str, object] = {}
        for _, upd in combo:
            updates.update(upd)
        spec = _apply_updates(base, updates)
        for name, (coord, _) in zip(normalized, combo):
            getter = _PASSTHROUGH_COORDS.get(name)
            if getter is not None and getter(spec) != coord:
                raise ValueError(
                    f"axis {name!r}: value {coord!r} does not survive to "
                    f"the Results {name!r} coordinate (scheme "
                    f"{spec.scheme!r} reports {getter(spec)!r}) — the "
                    f"swept rows would be unselectable; restrict the "
                    f"{name!r} axis to specs that honour it")
        suffix = [f"{name.split('.')[-1]}={_fmt(coord)}"
                  for name, (coord, _) in zip(normalized, combo)
                  if name not in _LABEL_FIELDS]
        if suffix:
            stem = spec.name or f"K{spec.k}"
            spec = replace(spec, name="/".join([stem] + suffix))
        if spec in coords:
            continue                       # duplicate combination: keep first
        specs.append(spec)
        coords[spec] = {_coord_name(name): coord
                        for name, (coord, _) in zip(normalized, combo)}
    return Study(base=base, axes={n: tuple(c for c, _ in ch)
                                  for n, ch in normalized.items()},
                 specs=specs, coords=coords)
