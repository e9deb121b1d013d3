"""The mesh half of ``launch`` and the batch mesh over several devices,
against the reference, on the CPU.

* The sharding rules, leaf for leaf: the port's eight functions
  (``params_shardings`` of ``param_spec``, ``state_shardings`` and
  ``state_shardings_zero1`` of a momentum ``TrainState``,
  ``batch_shardings`` of train_4k's and prefill_32k's ``input_specs``,
  ``cache_shardings`` / ``decode_input_shardings`` of decode_32k's, and
  ``logits_sharding``, ``param_spec_for`` under them all) equal the
  reference's for every assigned arch at full width, on the 16 × 16, the
  2 × 16 × 16 and the (1, 1) host mesh.  The reference runs on a
  stand-in mesh with ``NamedSharding`` bypassed, as its own
  ``tests/test_sharding.py`` does.
* The reference's sharding tests, ported; ``shard_shape`` on an uneven
  dim; ``place`` on the host mesh (the same storage), on an abstract mesh
  and on several devices without a world's ``DeviceMesh`` (raises; a
  world's mesh is ``tests/test_torch_distributed.py``'s).
* The batch mesh: the reference's ``test_mesh_multi_device_sharding``
  case in-process on a mesh of 8 ``cpu`` entries (``MeshExecutor``,
  ``AsyncExecutor(mesh=)`` capped and not; a ragged FEEL bucket and a
  dev bucket, both smaller than the mesh) against the reference's plain
  run with its weights (times bitwise, losses and accuracies 1e-5), and
  an ``ExperimentService(mesh=)`` admission that pads.
* ``run_pair(..., multi_pod=True)`` and ``perf --multi-pod`` on the CPU
  at the reduced size: ``mesh``, ``argument_bytes_per_device``, and
  ``zero1`` lowering it on a train shape.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as ref_api
import repro.launch.sharding as ref_shd
from repro.configs import ARCHS as REF_ARCHS
from repro.core import DeviceProfile as RefDevice
from repro.data.pipeline import ClassificationData as RefData
from repro.fed import feel_model as ref_model
from repro.fed import train_step as ref_ts
from repro.models import model as rm
from repro.models.layers import padded_vocab
from repro.optim import momentum as ref_momentum

from repro_torch.api import (AsyncExecutor, Experiment, MeshExecutor,
                             ScenarioSpec, lowering)
from repro_torch.configs import ARCHS, ASSIGNED, SHAPES
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.latency import DeviceProfile
from repro_torch.data.pipeline import ClassificationData
from repro_torch.fed import train_step as ts
from repro_torch.interop import params_from_numpy
from repro_torch.launch import dryrun, perf
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import (Mesh, NamedSharding, P, data_axes,
                                     data_size, make_host_mesh,
                                     make_production_mesh, pad_batch)
from repro_torch.models import model as tm
from repro_torch.optim import momentum
from repro_torch.serve import ExperimentService
from repro_torch.testing import VirtualClock, no_retrace
from repro_torch.tree import keystr, tree_leaves, tree_leaves_with_path

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "host": {"data": 1, "model": 1}}


class _StandIn:
    """The reference's rules read only ``shape`` and ``axis_names``."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _port_mesh(key):
    if key == "host":
        return make_host_mesh("cpu")
    return make_production_mesh(multi_pod=(key == "2x16x16"))


@pytest.fixture
def ref_rules(monkeypatch):
    monkeypatch.setattr(ref_shd, "NamedSharding", lambda mesh, spec: spec)
    return ref_shd


def _ref_list(tree):
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
    return [(jax.tree_util.keystr(p), tuple(s)) for p, s in
            jax.tree_util.tree_leaves_with_path(tree, is_leaf=is_spec)]


def _port_list(tree):
    return [(keystr(p), tuple(s.spec)) for p, s in tree_leaves_with_path(tree)]


@functools.lru_cache(maxsize=None)
def _specs(name):
    """Both packages' full-width specs of ``name``, built once a module:
    params, the momentum train state, and each shape's inputs."""
    cfg, ref_cfg = ARCHS[name], REF_ARCHS[name]
    params, ref_params = tm.param_spec(cfg), rm.param_spec(ref_cfg)
    state = ts.TrainState(params, momentum().init(params), 0)
    ref_state = jax.eval_shape(lambda: ref_ts.TrainState(
        ref_params, ref_momentum().init(ref_params),
        jnp.zeros((), jnp.int32)))
    inputs = {s: ts.input_specs(cfg, SHAPES[s], tm.Runtime())
              for s in ("train_4k", "prefill_32k", "decode_32k")}
    ref_inputs = {s: ref_ts.input_specs(ref_cfg, SHAPES[s], rm.Runtime())
                  for s in inputs}
    return (params, state, inputs), (ref_params, ref_state, ref_inputs)


# ---------------------------------------------------------------------------
# the rules, leaf for leaf, against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ASSIGNED)
def test_rules_equal_the_reference_leaf_for_leaf(name, ref_rules):
    (params, state, inputs), (ref_params, ref_state, ref_inputs) = \
        _specs(name)
    cfg = ARCHS[name]
    for key, shape in MESHES.items():
        mesh, ref_mesh = _port_mesh(key), _StandIn(shape)
        pairs = [
            (shd.params_shardings(mesh, params),
             ref_rules.params_shardings(ref_mesh, ref_params)),
            (shd.state_shardings(mesh, state),
             ref_rules.state_shardings(ref_mesh, ref_state)),
            (shd.state_shardings_zero1(mesh, state),
             ref_rules.state_shardings_zero1(ref_mesh, ref_state))]
        for s in ("train_4k", "prefill_32k"):
            pairs.append((shd.batch_shardings(mesh, inputs[s]),
                          ref_rules.batch_shardings(ref_mesh, ref_inputs[s])))
        dec, ref_dec = inputs["decode_32k"], ref_inputs["decode_32k"]
        pairs.append((shd.cache_shardings(mesh, dec["cache"]),
                      ref_rules.cache_shardings(ref_mesh, ref_dec["cache"])))
        pairs.append((shd.decode_input_shardings(mesh, dec),
                      ref_rules.decode_input_shardings(ref_mesh, ref_dec)))
        nd = 4 if cfg.n_codebooks > 1 else 3
        for batch in (1, 32, 128):
            # the padded vocab divides 16; the raw one may not (mamba2's)
            for vocab in (padded_vocab(cfg.vocab), cfg.vocab):
                got = shd.logits_sharding(mesh, nd, batch, vocab)
                want = ref_rules.logits_sharding(ref_mesh, nd, batch, vocab)
                assert tuple(got.spec) == tuple(want), (key, batch, vocab)
        n_sharded = 0
        for got, want in pairs:
            got_list, want_list = _port_list(got), _ref_list(want)
            assert got_list == want_list, (name, key)
            n_sharded += sum(any(a is not None for a in s)
                             for _, s in got_list)
        assert n_sharded > 0, (name, key)


# ---------------------------------------------------------------------------
# the reference's tests/test_sharding.py, on the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host():
    return make_host_mesh("cpu")


def test_data_axes(host):
    assert data_axes(host) == ("data",)
    multi = make_production_mesh(multi_pod=True)
    assert data_axes(multi) == ("pod", "data") and data_size(multi) == 32
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.abstract and multi.size == 512
    assert make_production_mesh().axis_names == ("data", "model")
    assert host.shape == {"data": 1, "model": 1}
    assert host.devices == (torch.device("cpu"),)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_rules_cover_all_leaves(arch, host):
    spec = tm.param_spec(ARCHS[arch].reduced())
    for (path, leaf), (_, s) in zip(
            tree_leaves_with_path(spec),
            tree_leaves_with_path(shd.params_shardings(host, spec))):
        parts = tuple(s.spec)
        assert len(parts) <= leaf.dim(), (path, parts, leaf.shape)
        for d, ax in enumerate(parts):
            if ax is not None:
                assert leaf.shape[d] >= 1


def test_projection_rules_hit_expected_dims(host):
    # wq: (L, d, H*hd) -> shard last
    assert shd.param_spec_for("['layers']['attn']['wq']",
                              (40, 2560, 2560), host) == P(None, None,
                                                           "model")
    # wo: (L, H*hd, d) -> shard -2
    assert shd.param_spec_for("['layers']['attn']['wo']",
                              (40, 2560, 2560), host) == P(None, "model",
                                                           None)
    # experts w_gate: (L, E, d, f) -> shard E
    assert shd.param_spec_for("['layers']['moe']['experts']['w_gate']",
                              (35, 128, 7168, 4864), host) == \
        P(None, "model", None, None)
    # norms replicate
    assert shd.param_spec_for("['layers']['ln1']['scale']",
                              (40, 2560), host) == P()
    # embed table: (pv, d) -> shard vocab
    assert shd.param_spec_for("['embed']['table']",
                              (151936, 2560), host) == P("model", None)


def test_cache_shardings_ctx_dim(host):
    cfg = ARCHS["qwen1.5-4b"].reduced()
    sh = shd.cache_shardings(host, tm.cache_spec(cfg, 4, 64, tm.Runtime()))
    assert tuple(sh["k"].spec)[2] == "model"     # ctx (flash-decode style)
    assert tuple(sh["pos"].spec) == ()


def test_zero1_shards_opt_only(host):
    pspec = tm.param_spec(ARCHS["qwen1.5-4b"].reduced())
    st = ts.TrainState(pspec, momentum().init(pspec), 0)
    sh = shd.state_shardings_zero1(host, st)
    base = shd.state_shardings(host, st)
    n_extra = 0
    for (p1, a), (_, b) in zip(tree_leaves_with_path(sh),
                               tree_leaves_with_path(base)):
        ka = keystr(p1)
        if ka.startswith("[<flat index 1>]"):
            if tuple(a.spec) != tuple(b.spec):
                n_extra += 1
                assert any(ax == "data" or (isinstance(ax, tuple)
                                            and "data" in ax)
                           for ax in a.spec if ax)
        else:
            assert tuple(a.spec) == tuple(b.spec), ka
    assert n_extra > 0


def test_logits_sharding_divisibility():
    mesh = make_production_mesh()
    # batch 1 not divisible by 16 -> replicated; vocab 100 not divisible
    s = shd.logits_sharding(mesh, 3, batch=1, vocab=100)
    assert tuple(s.spec) == (None, None, None)
    s2 = shd.logits_sharding(mesh, 3, batch=32, vocab=128)
    assert tuple(s2.spec)[0] == "data" and tuple(s2.spec)[-1] == "model"
    s3 = shd.logits_sharding(make_production_mesh(multi_pod=True), 3,
                             batch=64, vocab=128)
    assert tuple(s3.spec)[0] == ("pod", "data")


def test_shard_shape_rounds_an_uneven_dim_up():
    """arctic's 56 query heads over the 16-way model axis: GSPMD pads to
    64, so a device holds 4 (3.5 rounded up); a dim over (pod, data)
    splits 32 ways."""
    mesh = make_production_mesh(multi_pod=True)
    heads = NamedSharding(mesh, P(None, None, "model", None))
    assert heads.shard_shape((35, 4, 56, 128)) == (35, 4, 4, 128)
    batch = NamedSharding(mesh, P(("pod", "data"), None))
    assert batch.shard_shape((128, 4096)) == (4, 4096)
    assert NamedSharding(mesh, P()).shard_shape((7, 3)) == (7, 3)
    # arctic's params, per device, sum to no more than the whole
    cfg = ARCHS["arctic-480b"]
    pspec = tm.param_spec(cfg)
    sh = shd.params_shardings(mesh, pspec)
    whole = sum(t.numel() for t in tree_leaves(pspec))
    per = sum(int(np.prod(s.shard_shape(tuple(t.shape))))
              for t, s in zip(tree_leaves(pspec), tree_leaves(sh)))
    assert 0 < per < whole / 8


def test_place_on_the_host_mesh_keeps_the_storage(host):
    cfg = ARCHS["qwen1.5-4b"].reduced()
    params = tm.init(cfg, torch.Generator().manual_seed(0))
    state = ts.TrainState(params, momentum().init(params), 0)
    placed = shd.place(state, shd.state_shardings_zero1(host, state))
    assert placed.step == 0 and placed.residual is None
    for a, b in zip(tree_leaves(placed.params) + tree_leaves(placed.opt),
                    tree_leaves(params) + tree_leaves(state.opt)):
        assert a is b
    with pytest.raises(NotImplementedError, match="abstract mesh"):
        shd.place(params, shd.params_shardings(make_production_mesh(),
                                               params))
    two = Mesh((torch.device("cpu"),) * 2, ("data", "model"), (2, 1))
    with pytest.raises(NotImplementedError, match="several devices"):
        shd.place(params, shd.params_shardings(two, params))


# ---------------------------------------------------------------------------
# the batch mesh over several devices (the reference's
# tests/test_api.py::test_mesh_multi_device_sharding, in-process)
# ---------------------------------------------------------------------------


EIGHT = Mesh((torch.device("cpu"),) * 8)
PERIODS = 2


def _mesh_specs(SS, DP):
    fleet = tuple(DP(kind="cpu", f_cpu=f * 1e9) for f in (0.7, 2.1))
    wide = fleet + (DP(kind="cpu", f_cpu=1.4e9),)
    specs = [SS(fleet=fleet, partition=p, policy="full", b_max=8,
                base_lr=0.15, hidden=32, seeds=(0,))
             for p in ("iid", "noniid")]
    specs.append(SS(fleet=wide, name="K3", partition="iid", policy="full",
                    b_max=8, base_lr=0.15, hidden=32,
                    seeds=(0,)))        # ragged row: padded K2 -> K3
    specs.append(SS(fleet=fleet, scheme="individual", b_max=8, hidden=32,
                    seeds=(0,)))
    return specs


def _reference_init(rows, input_dim, device):
    per_row = [ref_model.init(jax.random.key(r.seed), r.spec.hidden,
                              depth=r.spec.depth, input_dim=input_dim)
               for r in rows]
    stacked = jax.tree_util.tree_map(
        lambda *a: np.stack([np.asarray(x) for x in a]), *per_row)
    return params_from_numpy(stacked, device)


@pytest.fixture(scope="module")
def reference_plain():
    rdata, rtest = RefData.synthetic(n=300, dim=24, seed=0,
                                     spread=6.0).split(60)
    return ref_api.Experiment(rdata, rtest, _mesh_specs(
        ref_api.ScenarioSpec, RefDevice)).run(periods=PERIODS)


@pytest.fixture
def port_data(monkeypatch):
    monkeypatch.setattr(lowering, "_init_params_batch", _reference_init)
    return ClassificationData.synthetic(n=300, dim=24, seed=0,
                                        spread=6.0).split(60)


def _close(got, want, tol=1e-5):
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_array_equal(got.global_batch, want.global_batch)
    np.testing.assert_allclose(got.losses, want.losses, rtol=0, atol=tol)
    np.testing.assert_allclose(got.accs, want.accs, rtol=0, atol=tol)
    return float(np.abs(got.losses - want.losses).max())


@pytest.mark.parametrize("executor,rerun", [
    (MeshExecutor(EIGHT), True), (AsyncExecutor(mesh=EIGHT), False),
    (AsyncExecutor(mesh=EIGHT, max_in_flight=1), False)],
    ids=["mesh", "async", "async-cap1"])
def test_mesh_multi_device_sharding(reference_plain, port_data, executor,
                                    rerun):
    """Sharded == plain: a ragged FEEL bucket (two fleet sizes padded into
    one program) and a dev bucket, both smaller than the 8-entry mesh;
    under ``MeshExecutor`` a warm re-run records no ledger event (the
    programs and shards do not depend on the executor)."""
    data, test = port_data
    exp = Experiment(data, test, _mesh_specs(ScenarioSpec, DeviceProfile),
                     device="cpu")
    assert [len(b.rows) for b in exp.lower()] == [3, 1]
    assert pad_batch(3, EIGHT) == 5
    err = _close(exp.run(periods=PERIODS, executor=executor),
                 reference_plain)
    if rerun:
        with no_retrace():
            _close(exp.run(periods=PERIODS, executor=executor),
                   reference_plain)
    print(f"PARITY batch mesh of 8 cpu entries, {type(executor).__name__}"
          f": losses max_abs_err={err:.3g} tol=1e-5")


def test_mesh_shards_rows_contiguously():
    assert [list(t) for t in lowering.shard_rows(3, EIGHT)] == \
        [[0], [1], [2], [0], [1], [2], [0], [1]]
    two = Mesh((torch.device("cpu"),) * 2)
    assert [list(t) for t in lowering.shard_rows(5, two)] == \
        [[0, 1, 2], [3, 4, 0]]


def test_service_pads_an_admission_to_the_mesh(port_data, reference_plain):
    """Three FEEL rows on the 8-entry mesh admit at 8 rows (the
    reference's ``n_exec``); a second admission of two of them (the
    ragged K3 row among them, so K pads alike) pads to the same keys and
    is warm; tickets equal the reference's plain run."""
    data, test = port_data
    specs = _mesh_specs(ScenarioSpec, DeviceProfile)
    svc = ExperimentService(data, test, device="cpu", mesh=EIGHT,
                            chunk_periods=1, clock=VirtualClock())
    tickets = [svc.submit(s, periods=PERIODS) for s in specs[:3]]
    svc.drain()
    bucket, = lowering.group_rows(specs[:3])
    keys = lowering.bucket_program_keys(bucket, 8, PERIODS, 1, data, test)
    assert all(("cpu",) * 8 + key in svc.cache for key in keys)
    for i, t in enumerate(tickets):
        got = t.result()
        np.testing.assert_array_equal(got.times,
                                      reference_plain.times[i:i + 1])
        for f in ("losses", "accs"):
            np.testing.assert_allclose(getattr(got, f),
                                       getattr(reference_plain, f)[i:i + 1],
                                       rtol=0, atol=1e-5, err_msg=f)
    with no_retrace():
        warm = [svc.submit(s, periods=PERIODS)
                for s in (specs[0], specs[2])]
        svc.drain()
    assert svc.stats.to_dict()["cache_hit_rate"] == 0.5
    for got, want in zip(warm, (tickets[0], tickets[2])):
        np.testing.assert_array_equal(got.result().losses,
                                      want.result().losses)


# ---------------------------------------------------------------------------
# the drivers' multi_pod
# ---------------------------------------------------------------------------


SMALL = {"train_4k": ShapeConfig("train_4k", 32, 256, "train"),
         "decode_32k": ShapeConfig("decode_32k", 64, 128, "decode")}


@pytest.fixture
def reduced_pairs(monkeypatch):
    for mod in (dryrun, perf):
        monkeypatch.setattr(mod, "get_arch", lambda n: ARCHS[n].reduced())
        monkeypatch.setattr(mod, "get_shape", SMALL.__getitem__)


def test_run_pair_sizes_on_the_multi_pod_mesh(reduced_pairs, tmp_path):
    """``perf --multi-pod`` runs baseline and zero1 through ``run_pair``:
    both rows on the 2 x 16 x 16 mesh with one chip, zero1's arguments a
    device below baseline's and equal to ``sharded_arguments``' of the
    uncut pair; without ``multi_pod`` a row is on the 16 x 16 mesh."""
    cfg = ARCHS["qwen1.5-4b"].reduced()
    rt = dryrun.runtime_for(cfg, SMALL["train_4k"], multi_pod=True)
    assert rt.moe_shard_axes == ("pod", "data")
    assert perf.build("zero1", cfg, SMALL["train_4k"],
                      multi_pod=True)[0] == rt
    out = tmp_path / "rows.jsonl"
    perf.main(["--arch", "qwen1.5-4b", "--shape", "train_4k", "--device",
               "cpu", "--variants", "baseline,zero1", "--layers", "1",
               "--multi-pod", "--out", str(out)])
    rows = {r["variant"]: r for r in map(json.loads,
                                         out.read_text().splitlines())}
    for row in rows.values():
        assert row["mesh"] == "2x16x16" and row["chips"] == 1, row
        per = row["memory"]["argument_bytes_per_device"]
        assert 0 < per < row["memory"]["argument_bytes"] * 256
    assert (rows["zero1"]["memory"]["argument_bytes_per_device"]
            < rows["baseline"]["memory"]["argument_bytes_per_device"])
    # the sizing is the uncut pair's: momentum state, params, the batch
    mesh = make_production_mesh(multi_pod=True)
    sized = dryrun.sharded_arguments(cfg, SMALL["train_4k"], rt, mesh,
                                     zero1=True)
    assert (sized["argument_bytes_per_device"]
            == rows["zero1"]["memory"]["argument_bytes_per_device"])
    assert 0 < sized["sharded_leaves"] <= sized["leaves"]
    row = dryrun.run_pair("qwen1.5-4b", "decode_32k", device="cpu",
                          layers=1, repeats=1)
    assert row["mesh"] == "16x16"
    assert 0 < row["memory"]["argument_bytes_per_device"]
