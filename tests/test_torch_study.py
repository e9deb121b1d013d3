"""Study grids in the port: every case of the reference's
``tests/test_study.py``, with the port's ``grid`` held against the
reference's on the same base spec — each expanded spec's fields, its
label and its axis coordinates — and the port's ``Experiment`` run over
the grids on the CPU.

Both refuse a grid whose swept policy does not survive to its
coordinate (a dev scheme's ``"none"``, ``gradient_fl``'s ``"full"``)."""
from dataclasses import fields, is_dataclass
from math import prod
from types import SimpleNamespace

import numpy as np
import pytest

import repro.api as ref_api
from repro.api import lowering as ref_lowering
from repro.channels.model import CellConfig as RefCell
from repro.core import DeviceProfile as RefDevice
from repro.data.pipeline import ClassificationData as RefData
from repro.testing.proptest import given, settings, strategies as st

import repro_torch.api as port_api
from repro_torch.api import AsyncExecutor, Experiment, Study, grid, lowering
from repro_torch.api.results import Results
from repro_torch.channels.model import CellConfig
from repro_torch.core import DeviceProfile
from repro_torch.data.pipeline import ClassificationData

DIM = 16
PORT = SimpleNamespace(api=port_api, DP=DeviceProfile, Cell=CellConfig)
REF = SimpleNamespace(api=ref_api, DP=RefDevice, Cell=RefCell)


@pytest.fixture(scope="module")
def dataset():
    full = ClassificationData.synthetic(n=260, dim=DIM, seed=0, spread=6.0)
    return full.split(60)


def _fleet(ns=PORT):
    return tuple(ns.DP(kind="cpu", f_cpu=f * 1e9) for f in [0.7, 2.1])


def _base(ns=PORT, **kw):
    kw.setdefault("name", "cpu2")
    kw.setdefault("policy", "full")
    kw.setdefault("b_max", 8)
    kw.setdefault("hidden", 24)
    # uncompressed payload: geometry must visibly move the comm latency
    kw.setdefault("compression", 1.0)
    return ns.api.ScenarioSpec(fleet=_fleet(ns), **kw)


def _plain(v):
    """A package-free value of a spec, profile, cell or coordinate."""
    if is_dataclass(v):
        return (type(v).__name__,) + tuple(_plain(getattr(v, f.name))
                                           for f in fields(v))
    if isinstance(v, tuple):
        return tuple(_plain(x) for x in v)
    return v


def _same_study(study, ref_study):
    """The port's expansion equals the reference's: specs (fields and
    labels) in order, coordinate names, axes and per-spec coordinates."""
    assert isinstance(study, Study)
    assert len(study) == len(ref_study)
    assert [_plain(s) for s in study] == [_plain(s) for s in ref_study]
    assert [s.label for s in study] == [s.label for s in ref_study]
    assert study.coord_names == ref_study.coord_names
    assert _plain(tuple(study.axes.items())) == _plain(
        tuple(ref_study.axes.items()))
    for s, r in zip(study, ref_study):
        assert _plain(tuple(study.axis_coords(s).items())) == _plain(
            tuple(ref_study.axis_coords(r).items()))
    assert repr(study) == repr(ref_study)


def _both(axes_of, **base_kw):
    """Expand the same axes over both packages' bases; check them equal
    and return the port's study."""
    study = grid(_base(PORT, **base_kw), **axes_of(PORT))
    _same_study(study, ref_api.grid(_base(REF, **base_kw), **axes_of(REF)))
    return study


# ---------------------------------------------------------------------------
# expansion mechanics
# ---------------------------------------------------------------------------


def test_grid_product_expansion_and_coords():
    base = _base()
    study = _both(lambda ns: {"partition": ["iid", "noniid"],
                              "cell.radius_m": [100.0, 300.0]})
    assert len(study) == 4                        # full product
    assert study.coord_names == ("partition", "cell_radius_m")
    got = [(s.partition, s.cell.radius_m) for s in study]
    assert got == [("iid", 100.0), ("iid", 300.0),
                   ("noniid", 100.0), ("noniid", 300.0)]
    for s in study:
        coords = study.axis_coords(s)
        assert coords["partition"] == s.partition
        assert coords["cell_radius_m"] == s.cell.radius_m
        assert s.cell.bandwidth_hz == base.cell.bandwidth_hz
    assert study[0].name == "cpu2/radius_m=100"


def test_grid_labeled_axis_bundles_fields():
    study = _both(lambda ns: {"model": {"big": dict(hidden=48, depth=3),
                                        "small": dict(hidden=16, depth=2)},
                              "base_lr": [0.1, 0.2]})
    assert len(study) == 4
    big = [s for s in study if study.axis_coords(s)["model"] == "big"]
    assert all(s.hidden == 48 and s.depth == 3 for s in big)
    assert {study.axis_coords(s)["base_lr"] for s in big} == {0.1, 0.2}
    assert big[0].name.startswith("cpu2/model=big/base_lr=0.1")


def test_grid_dedupes_identical_expansions():
    study = _both(lambda ns: {"policy": ["full", "full", "online"]})
    assert len(study) == 2
    assert [s.policy for s in study] == ["full", "online"]


@pytest.mark.parametrize("explicit", [False, True])
def test_grid_users_axis_resizes_or_takes_fleets(explicit):
    """``users=[K]`` truncates or cycles the base fleet; ``users={label:
    fleet}`` takes explicit fleets; both surface as ``num_users``."""
    def axes(ns):
        fl = _fleet(ns)
        return ({"users": {"a": fl + fl[:1], "b": fl[1:]}} if explicit
                else {"users": [1, 2, 3, 5]})
    study = _both(axes)
    assert study.coord_names == ("num_users",)
    assert [s.k for s in study] == ([3, 1] if explicit else [1, 2, 3, 5])


@pytest.mark.parametrize("axes_of,exc,match", [
    (lambda ns, b: {"not_a_field": [1, 2]}, ValueError, "no field"),
    (lambda ns, b: {"cell.not_a_knob": [1.0]}, ValueError, "no field"),
    (lambda ns, b: {"b_max.deep": [1]}, ValueError,
     "not a nested dataclass"),
    (lambda ns, b: {"policy": []}, ValueError, "no values"),
    # axis values still go through ScenarioSpec validation
    (lambda ns, b: {"policy": ["propsed"]}, ValueError, "policy"),
    # coordinate-name collisions with built-in Results coords
    (lambda ns, b: {"fleet": [b.fleet]}, ValueError, "built-in"),
    (lambda ns, b: {"policy": {"a": dict(hidden=16)}}, ValueError,
     "built-in"),
    # overlapping axes would silently override each other
    (lambda ns, b: {"hidden": [16, 32],
                    "model": {"small": dict(hidden=16, depth=2)}},
     ValueError, "overlapping"),
    (lambda ns, b: {"cell": [ns.Cell()], "cell.radius_m": [100.0]},
     ValueError, "overlapping"),
    (lambda ns, b: {"users": [0]}, ValueError, "positive int"),
    (lambda ns, b: {"users": {"none": ()}}, ValueError, "empty"),
    (lambda ns, b: {"model": {"m": 3}}, ValueError, "mapping"),
], ids=["no-field", "dotted-no-field", "not-nested", "no-values",
        "bad-policy", "builtin-fleet", "builtin-labeled-policy",
        "overlap-field-labeled", "overlap-cell", "users-zero",
        "users-empty-fleet", "labeled-not-mapping"])
def test_grid_rejects_bad_axes(axes_of, exc, match):
    for ns in (PORT, REF):
        base = _base(ns)
        with pytest.raises(exc, match=match):
            ns.api.grid(base, **axes_of(ns, base))


def test_grid_passes_through_label_axes():
    assert len(_both(lambda ns: {"partition": ["iid", "noniid"],
                                 "policy": ["full", "online"]})) == 4


@pytest.mark.parametrize("ns", [REF, PORT], ids=["reference", "port"])
def test_grid_refuses_unported_schemes(ns):
    """A policy swept over a scheme that reports another policy (the dev
    schemes' ``"none"``, ``gradient_fl``'s ``"full"``) does not survive to
    its coordinate: the reference and the port refuse the grid alike."""
    with pytest.raises(ValueError, match="does not survive"):
        ns.api.grid(_base(ns), scheme=["feel", "individual"],
                    policy=["proposed", "online"])
    with pytest.raises(ValueError, match="does not survive"):
        ns.api.grid(_base(ns, scheme="gradient_fl"), policy=["proposed"])


def test_tuple_valued_axis_selects_by_equality(dataset):
    data, test = dataset
    study = _both(lambda ns: {"seeds": [(0, 1), (2, 3)]})
    res = Experiment(data, test, study, device="cpu").run(periods=2)
    assert res.rows == 4
    one = res.sel(seeds=(0, 1))
    assert one.rows == 2 and set(one.coords["seed"]) == {0, 1}
    both = res.sel(seeds=[(0, 1), (2, 3)])
    assert both.rows == 4
    assert res.sel(seed=(0, 2)).rows == 2


# ---------------------------------------------------------------------------
# geometry sweeps: coordinates, planning monotonicity, plan-key hygiene
# ---------------------------------------------------------------------------


def _lowered_coords(study_port, study_ref):
    """Both packages' lowered buckets (row specs and seeds) and Results
    coordinate columns, with no device work."""
    exp = Experiment(None, None, study_port, device="cpu")
    ref = ref_api.Experiment(None, None, study_ref)
    buckets, ref_buckets = exp.lower(), ref.lower()
    assert [[(_plain(r.spec), r.seed, r.indices) for r in b.rows]
            for b in buckets] == [[(_plain(r.spec), r.seed, r.indices)
                                   for r in b.rows] for b in ref_buckets]
    coords, ref_coords = exp._coords(buckets), ref._coords(ref_buckets)
    assert list(coords) == list(ref_coords)
    for name in coords:
        assert [_plain(v) for v in coords[name]] == [
            _plain(v) for v in ref_coords[name]], name
    return buckets


def test_geometry_grid_single_experiment_with_coords(dataset):
    data, test = dataset
    axes = lambda ns: {"policy": ["full", "online"],             # noqa: E731
                       "cell.radius_m": [100.0, 400.0]}
    study = _both(axes, seeds=(0, 1))
    _lowered_coords(study, ref_api.grid(_base(REF, seeds=(0, 1)),
                                        **axes(REF)))
    exp = Experiment(data, test, study, device="cpu")
    assert len(exp.lower()) == 1                  # geometry never splits
    res = exp.run(periods=3)
    assert res.rows == 8
    assert "cell_radius_m" in res.coords
    sub = res.sel(cell_radius_m=400.0, policy="full")
    assert sub.rows == 2
    assert all(s.cell.radius_m == 400.0 for s in sub.coords["spec"])
    by_spec = res.sel(spec=sub.coords["spec"][0])
    np.testing.assert_array_equal(by_spec.losses, sub.losses)


@pytest.mark.parametrize("field,values,sign", [
    ("cell.radius_m", [100.0, 200.0, 400.0, 800.0], 1),
    ("cell.bandwidth_hz", [5e6, 10e6, 40e6], -1)])
def test_radius_and_bandwidth_move_horizons_monotonically(dataset, field,
                                                          values, sign):
    """Larger radius → longer planned communication, more bandwidth →
    shorter; the plan is bitwise the reference's."""
    data, _ = dataset
    study = grid(_base(seeds=(0,)), **{field: values})
    ref_study = ref_api.grid(_base(REF, seeds=(0,)), **{field: values})
    [bucket] = _lowered_coords(study, ref_study)
    plan = lowering.plan_bucket(bucket, data, periods=4)
    [ref_bucket] = ref_api.Experiment(None, None, ref_study).lower()
    rdata, _ = RefData.synthetic(n=260, dim=DIM, seed=0,
                                 spread=6.0).split(60)
    ref_plan = ref_lowering.plan_bucket(ref_bucket, rdata, periods=4)
    np.testing.assert_array_equal(plan.times, ref_plan.times)
    np.testing.assert_array_equal(plan.global_batch, ref_plan.global_batch)
    finals = plan.times[:, -1]                    # rows follow study order
    assert np.all(sign * np.diff(finals) > 0), finals


def test_distinct_geometries_never_share_plan_key():
    cells = [CellConfig(), CellConfig(radius_m=400.0),
             CellConfig(bandwidth_hz=20e6), CellConfig(tx_power_dbm=20.0),
             CellConfig(frame_up_s=0.02)]
    rows = [lowering.Row(spec=_base(cell=c), seed=0, indices=(i,))
            for i, c in enumerate(cells)]
    keys = {lowering._plan_key(r) for r in rows}
    assert len(keys) == len(cells)
    assert lowering._plan_key(rows[0]) == lowering._plan_key(
        lowering.Row(spec=_base(), seed=0, indices=(9,)))


def test_geometry_sweep_values_match_per_cell_runs(dataset):
    data, test = dataset
    radii = [120.0, 500.0]
    study = grid(_base(seeds=(0,)), **{"cell.radius_m": radii})
    res = Experiment(data, test, study, device="cpu").run(
        periods=3, executor=AsyncExecutor())
    for radius in radii:
        solo = Experiment(data, test,
                          [_base(cell=CellConfig(radius_m=radius),
                                 seeds=(0,))], device="cpu").run(periods=3)
        cell = res.sel(cell_radius_m=radius)
        np.testing.assert_array_equal(cell.times, solo.times)
        np.testing.assert_array_equal(cell.global_batch, solo.global_batch)
        np.testing.assert_allclose(cell.losses, solo.losses, atol=1e-6)
        np.testing.assert_allclose(cell.accs, solo.accs, atol=1e-6)


# ---------------------------------------------------------------------------
# bucket-key hygiene for the compression ablation grid
# ---------------------------------------------------------------------------


def test_compress_off_merges_ratios_into_one_bucket(dataset):
    data, test = dataset
    axes = lambda ns: {"compression": [0.01, 0.1],              # noqa: E731
                       "compress": [True, False]}
    study = _both(axes, seeds=(0,))
    buckets = _lowered_coords(study, ref_api.grid(_base(REF, seeds=(0,)),
                                                  **axes(REF)))
    assert len(buckets) == 3                      # 2 on-ratios + 1 off
    res = Experiment(data, test, study, device="cpu").run(periods=3)
    off = res.sel(compress=False)
    t_small = off.sel(compression=0.01).times[0, -1]
    t_big = off.sel(compression=0.1).times[0, -1]
    assert t_big > t_small                        # payload moved the ledger


# ---------------------------------------------------------------------------
# property tests: grid expand -> Results.sel round-trip, against the
# reference's expansion, and the fail-loudly sel contract
# ---------------------------------------------------------------------------

_AXIS_POOL = ("b_max", "base_lr", "cell.radius_m", "users", "compression")


def _draw_axes(rng, n_axes):
    """A random axis dict: distinct fields, unique values per axis."""
    picks = rng.choice(len(_AXIS_POOL), size=n_axes, replace=False)
    axes = {}
    for i in picks:
        name = _AXIS_POOL[i]
        n_vals = int(rng.integers(1, 4))
        if name == "b_max":
            vals = sorted(int(x) for x in rng.choice(
                np.arange(8, 65), size=n_vals, replace=False))
        elif name == "base_lr":
            vals = [round(float(x), 3) for x in rng.choice(
                np.linspace(0.01, 0.3, 30), size=n_vals, replace=False)]
        elif name == "cell.radius_m":
            vals = [float(x) for x in rng.choice(
                np.arange(100.0, 900.0, 50.0), size=n_vals, replace=False)]
        elif name == "users":
            vals = sorted(int(x) for x in rng.choice(
                np.arange(2, 9), size=n_vals, replace=False))
        else:                                      # compression
            vals = [round(float(x), 4) for x in rng.choice(
                np.linspace(0.001, 0.2, 40), size=n_vals, replace=False)]
        axes[name] = vals
    return axes


def _coords_results(study, ref_study):
    """A Results over the study's real lowered coordinates (no device
    work, zero series), after checking them against the reference's."""
    buckets = _lowered_coords(study, ref_study)
    exp = Experiment(None, None, study, device="cpu")
    coords = exp._coords(buckets)
    n = exp._n_rows(buckets)
    z = np.zeros((n, 3))
    return Results(coords=coords, losses=z, accs=z, times=z,
                   global_batch=z, n_buckets=len(buckets))


@settings(deadline=None)
@given(seed=st.integers(0, 100_000), n_axes=st.integers(1, 3))
def test_grid_sel_roundtrip_property(seed, n_axes):
    rng = np.random.default_rng(seed)
    axes = _draw_axes(rng, n_axes)
    study = grid(_base(seeds=(0, 1)), **axes)
    ref_study = ref_api.grid(_base(REF, seeds=(0, 1)), **axes)
    _same_study(study, ref_study)
    assert len(study) == prod(len(v) for v in axes.values())
    res = _coords_results(study, ref_study)
    assert res.rows == 2 * len(study)
    for name, values in axes.items():
        coord = "num_users" if name == "users" else name.replace(".", "_")
        assert res.unique(coord) == tuple(values)
        total = 0
        for v in values:
            sub = res.sel(**{coord: v})
            assert set(sub.coords[coord]) == {v}
            total += sub.rows
        assert total == res.rows
    spec = study[int(rng.integers(len(study)))]
    sub = res.sel(**dict(study.axis_coords(spec)))
    assert sub.rows == 2
    assert set(sub.coords["spec"]) == {spec}


@settings(deadline=None)
@given(seed=st.integers(0, 100_000))
def test_sel_fails_loudly_property(seed):
    rng = np.random.default_rng(seed)
    axes = _draw_axes(rng, int(rng.integers(1, 3)))
    study = grid(_base(), **axes)
    res = _coords_results(study, ref_api.grid(_base(REF), **axes))
    with pytest.raises(KeyError):
        res.sel(definitely_not_a_coordinate=1)
    for name, values in axes.items():
        coord = "num_users" if name == "users" else name.replace(".", "_")
        with pytest.raises(ValueError, match="matches no row"):
            res.sel(**{coord: -12345})
        with pytest.raises(ValueError, match="matches no row"):
            res.sel(**{coord: [-12345, -54321]})
    with pytest.raises(ValueError, match="matches no row"):
        res.sel(policy="not-a-policy")
    with pytest.raises(ValueError, match="matches no row"):
        res.sel(seed=99999)
    first = next(iter(axes))
    coord = "num_users" if first == "users" else first.replace(".", "_")
    v = axes[first][0]
    sub = res.sel(**{coord: v})
    assert set(sub.coords[coord]) == {v}
