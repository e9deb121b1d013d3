"""The sharded step over a mesh of several devices against the reference,
on the CPU: one 4-rank ``gloo`` world (``repro_torch.testing.
distributed``), spawned once for the module, whose ranks import ``torch``
and ``repro_torch`` only; this process runs the reference in JAX
meanwhile and compares.

* Placement: every leaf of a reduced qwen, a reduced deepseek and a
  reduced mamba2 — parameters, a momentum train state under
  ``state_shardings`` and ``state_shardings_zero1``, the batch and the
  decode cache — placed on the (2, 2) ``("data", "model")`` and the (2,
  1, 2) ``("pod", "data", "model")`` meshes has local shapes equal to
  ``shard_shape`` (no leaf is ragged at these sizes) and gathers back
  bitwise.
* The sharded train step against the reference's ``make_train_step``
  over 3 steps (losses 1e-5, parameters 2e-5, the MoE load-balance term
  1e-5): qwen under baseline, ZeRO-1, ``seq_parallel`` and
  ``gqa_expand`` on (2, 2), deepseek's MoE layer with ``moe_shard_axes``
  on both meshes, mamba2 (the mixer on each rank's heads: its
  in-projection split off the head boundaries, the norm's sum over
  ``"model"``) under baseline, ZeRO-1 and ``seq_parallel`` and zamba2
  (the mixer and the shared attention block) under ZeRO-1 on (2, 2).
  The mixers' ``D``, ``dt_bias`` and ``conv_b``, constants at init, are
  drawn at random here, so a head or channel out of place shows.
* Prefill logits and 12 decode steps (the caches' sequence split over
  ``"model"``, so the steps past slot 8 merge two parts; mamba2's and
  zamba2's conv caches split on their channels and SSM caches on their
  heads) against the reference, with the final caches: 2e-5; and qwen
  under a window of 8 at CTX 16, whose ring of 8 slots splits 4 + 4, so
  the 12 steps wrap past slot 8 over both parts.
* ZeRO-1's measured argument bytes a device equal ``sharded_arguments``'
  at the mesh, and its step's collectives hold the reduce-scatter and the
  extra all-gathers the baseline's lack.
* ``ssd_on_local_heads`` alone against the whole scan: B and C of one
  group (a copy for each rank) and of two (split), y and every gradient;
  groups that ``"model"`` does not divide raise.
* ``run_pair(mesh=...)`` with no world raises; on a mesh its kernel
  FLOPs count one card's rows and heads (or part of the cache).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.fed import train_step as ref_ts
from repro.models import model as rm
from repro.optim import momentum as ref_momentum

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.interop import params_to_numpy
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.models import mamba2 as m2
from repro_torch.models import model as tm
from repro_torch.testing.distributed import LR, World, sharded_jobs

QWEN, DEEPSEEK = "qwen1.5-4b", "deepseek-v2-lite-16b"
MAMBA, ZAMBA = "mamba2-2.7b", "zamba2-7b"
QWEN_W = "qwen1.5-4b:window8"      # qwen under a window of 8 slots
WINDOW = {QWEN_W: 8}
B, S, CTX, STEPS = 4, 16, 16, 12
PLANS = {
    QWEN: {(2, 2): {"place": True, "train": ["baseline", "zero1",
                                             "seq_parallel", "gqa_expand"],
                    "serve": True, "collectives": True},
           (2, 1, 2): {"place": True}},
    DEEPSEEK: {(2, 2): {"place": True, "train": ["moe"], "serve": True},
               (2, 1, 2): {"place": True, "train": ["moe"]}},
    MAMBA: {(2, 2): {"place": True, "train": ["baseline", "zero1",
                                              "seq_parallel"],
                     "serve": True, "ssd_heads": True},
            (2, 1, 2): {"place": True}},
    ZAMBA: {(2, 2): {"train": ["zero1"], "serve": True}},
    QWEN_W: {(2, 2): {"serve": True, "window": WINDOW[QWEN_W]}},
}


def _arch(name):
    return name.split(":")[0]


def _ref_rt(name):
    return rm.Runtime(dtype=jnp.float32, attn_impl="naive",
                      window=WINDOW.get(name))


def _inputs(name, seed):
    """Weights in the reference's layout (drawn by the port's init, which
    is quicker here than the reference's; qkv biases non-zero, and the
    mixers' D, dt_bias and conv_b drawn), a batch with eq. (1) weights, a
    zero cache of CTX slots (a ring of the window's under one) and STEPS
    decode tokens."""
    arch = _arch(name)
    ref_cfg = REF_ARCHS[arch].reduced()
    params = params_to_numpy(tm.init(ARCHS[arch].reduced(),
                                     torch.Generator().manual_seed(seed)))
    rng = np.random.default_rng(seed + 1)
    layers = params["layers"]
    for part, keys, scale, base in (("attn", ("bq", "bk", "bv"), 0.1, 0.0),
                                    ("mixer", ("conv_b", "dt_bias"), 0.5,
                                     0.0),
                                    ("mixer", ("D",), 0.5, 1.0)):
        for k in keys:
            if k in layers.get(part, {}):
                t = layers[part][k]
                layers[part][k] = (base + scale * rng.normal(
                    size=t.shape)).astype(np.float32)
    vocab = ref_cfg.vocab
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    w = np.repeat(np.array([1.0, 1.0, 1.0, 0.0], np.float32)[:, None], S,
                  axis=1)
    w[1, S // 2:] = 0.0
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "weights": w}
    cache = params_to_numpy(tm.init_cache(
        ARCHS[arch].reduced(), B, CTX, tm.Runtime(window=WINDOW.get(name)),
        device="cpu"))
    serve = {"cache": cache,
             "tokens": rng.integers(0, vocab, (STEPS, B, 1)).astype(
                 np.int32)}
    return ref_cfg, params, batch, serve


def _reference(ref_cfg, params, batch, serve, train: bool,
               rt=None) -> dict:
    out = {}
    rt = rt or _ref_rt("")
    to_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    if train:
        opt = ref_momentum(0.9)
        step = jax.jit(ref_ts.make_train_step(ref_cfg, rt, opt))
        p = to_jax(params)
        state = ref_ts.TrainState(p, opt.init(p), jnp.zeros((), jnp.int32))
        losses, aux = [], []
        for _ in range(3):
            state, m = step(state, to_jax(batch), LR)
            losses.append(float(m["loss"]))
            aux.append(float(m["total_loss"] - m["loss"]))
        out["train"] = {"loss": np.array(losses), "aux": np.array(aux),
                        "params": jax.tree_util.tree_map(np.asarray,
                                                         state.params)}
    prefill = jax.jit(ref_ts.make_prefill_step(ref_cfg, rt))
    out["prefill"] = np.asarray(prefill(to_jax(params),
                                        {"tokens": batch["tokens"]}))
    dec = jax.jit(lambda p, c, t: rm.decode_step(ref_cfg, p, c, t, rt=rt))
    cache, steps = to_jax(serve["cache"]), []
    for tok in serve["tokens"]:
        logits, cache = dec(to_jax(params), cache, jnp.asarray(tok))
        steps.append(np.asarray(logits))
    out["decode"] = np.stack(steps)
    out["cache"] = jax.tree_util.tree_map(np.asarray, cache)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the world's results by arch, the reference's by arch)."""
    inputs = {name: _inputs(name, i) for i, name in enumerate(PLANS)}
    jobs = {name: (ARCHS[_arch(name)].reduced(), params, batch, serve,
                   PLANS[name])
            for name, (_, params, batch, serve) in inputs.items()}
    init = tmp_path_factory.mktemp("world") / "rendezvous"
    world = World(sharded_jobs, (jobs,), world=4, init_file=str(init),
                  timeout=240.0)
    try:
        ref = {name: _reference(*inputs[name], train=any(
                   "train" in c for c in PLANS[name].values()),
                   rt=_ref_rt(name))
               for name in PLANS}
    finally:
        got = world.result()
    return got, ref


def _close(what, got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)
    return float(np.abs(got - want).max()) if got.size else 0.0


def _tree_gap(what, got, want, tol):
    leaves = jax.tree_util.tree_leaves_with_path(want)
    gap = 0.0
    for path, w in leaves:
        g = got
        for k in path:
            g = g[k.key]
        gap = max(gap, _close(f"{what} {jax.tree_util.keystr(path)}", g, w,
                              tol))
    return gap


@pytest.mark.parametrize("name", [QWEN, DEEPSEEK, MAMBA])
@pytest.mark.parametrize("mesh", ["2x2", "2x1x2"])
def test_placement_matches_shard_shape_and_gathers_bitwise(runs, name, mesh):
    got, _ = runs
    rep = got[name][(mesh, "place")]
    for tree, r in rep.items():
        assert r["leaves"] > 0, tree
        assert r["not_bitwise"] == [], (tree, r["not_bitwise"])
        assert r["ragged"] == [], (tree, r["ragged"])
    print(f"PARITY place {name} {mesh}: "
          + ", ".join(f"{t} {r['leaves']} leaves" for t, r in rep.items())
          + "; none ragged, all bitwise")


TRAIN_CASES = [(QWEN, "2x2", v) for v in ("baseline", "zero1",
                                          "seq_parallel", "gqa_expand")] + [
    (DEEPSEEK, "2x2", "moe"), (DEEPSEEK, "2x1x2", "moe")] + [
    (MAMBA, "2x2", v) for v in ("baseline", "zero1", "seq_parallel")] + [
    (ZAMBA, "2x2", "zero1")]


@pytest.mark.parametrize("name,mesh,variant", TRAIN_CASES)
def test_sharded_train_step_matches_reference(runs, name, mesh, variant):
    got, ref = runs
    g, r = got[name][(mesh, "train", variant)], ref[name]["train"]
    loss = _close(f"{name} {variant} loss", g["loss"], r["loss"], 1e-5)
    aux = _close(f"{name} {variant} aux", g["aux"], r["aux"], 1e-5)
    params = _tree_gap(f"{name} {variant} params", g["params"], r["params"],
                       2e-5)
    if name == DEEPSEEK:
        assert min(r["aux"]) > 0          # the MoE term is in the loss
    print(f"PARITY sharded train {name} {mesh} {variant}: 3 steps, loss "
          f"{loss:.3g} (tol 1e-5), aux {aux:.3g} (1e-5), params "
          f"{params:.3g} (2e-5); "
          f"{got[name]['seconds'][(mesh, variant)]:.1f} s in the world")


@pytest.mark.parametrize("name", list(PLANS))
def test_sharded_prefill_and_decode_match_reference(runs, name):
    got, ref = runs
    g, r = got[name][("2x2", "serve")], ref[name]
    pre = _close(f"{name} prefill", g["prefill"], r["prefill"], 2e-5)
    dec = _close(f"{name} decode", g["decode"], r["decode"], 2e-5)
    cache = _tree_gap(f"{name} cache", g["cache"], r["cache"], 2e-5)
    assert int(g["cache"]["pos"]) == STEPS
    print(f"PARITY sharded serve {name} 2x2: prefill {pre:.3g}, {STEPS} "
          f"decode steps {dec:.3g}, caches {cache:.3g} (tol 2e-5)")


def test_ssd_on_local_heads_matches_the_whole_scan(runs):
    """The SSD scan on each rank's rows and heads (``ssd_on_local_heads``)
    against the scan of the whole tensors, y and every gradient: B and C
    of one group handed in as a copy for each rank (the copies' gradients
    summed) and of two groups split over ``"model"`` (2e-5); groups that
    ``"model"`` does not divide raise."""
    got, _ = runs
    r = got[MAMBA][("2x2", "ssd_heads")]
    assert r["raises"]
    for g in (1, 2):
        assert r[g] <= 2e-5, (g, r[g])
    print(f"PARITY ssd_on_local_heads 2x2: one group {r[1]:.3g}, two "
          f"groups {r[2]:.3g} (tol 2e-5); undivided groups raise")


def test_zero1_bytes_and_collectives(runs):
    got, _ = runs
    c = got[QWEN][("2x2", "collectives")]
    base, zero1 = c[False], c[True]
    cfg = ARCHS[QWEN].reduced()
    shape = ShapeConfig("train_test", S, B, "train")
    mesh = Mesh((), ("data", "model"), (2, 2))
    for z, r in ((False, base), (True, zero1)):
        sized = dryrun.sharded_arguments(cfg, shape, tm.Runtime(), mesh,
                                         zero1=z)
        assert r["local_bytes"] == sized["argument_bytes_per_device"]
    assert zero1["local_bytes"] < base["local_bytes"]
    assert "reduce_scatter_tensor" in zero1["by_op"]
    assert "reduce_scatter_tensor" not in base["by_op"]
    assert (zero1["count"].get("all_gather_into_tensor", 0)
            > base["count"].get("all_gather_into_tensor", 0))
    assert base["by_op"]["all_reduce"] > zero1["by_op"]["all_reduce"]
    for name in PLANS:
        print(f"PARITY world {name}: seconds a case " + ", ".join(
            f"{m} {c} {t:.1f}" for (m, c), t in got[name]["seconds"].items()))
    print(f"PARITY zero1 2x2: arguments a device {zero1['local_bytes']} vs "
          f"{base['local_bytes']} bytes (sized alike); collectives "
          f"{zero1['by_op']} vs {base['by_op']}")


def test_run_pair_on_a_mesh_without_a_world_raises():
    with pytest.raises(RuntimeError, match="no torch.distributed world"):
        dryrun.run_pair(QWEN, "decode_32k", device="cpu", layers=1,
                        batch=2, mesh="2x2")



def test_kernel_flops_count_what_one_card_launches():
    """On a mesh the dry run counts a kernel's products at the rows and
    heads (or part of the cache) one card launches it on: B3 and B3′ at
    its rows and H / m heads, B4 at its rows and heads, B5 at 1 / m of
    the visible (head, slot) pairs; the one-card counts are unchanged."""
    from repro_torch.launch import cost
    ssm, gqa = ARCHS[MAMBA], ARCHS[QWEN]
    shape = ShapeConfig("train_test", 4096, 2, "train")
    rt = tm.Runtime()
    _, H, _ = m2.dims(ssm)
    s = ssm.ssm
    launches = {"ssd_scan_fwd": 128, "ssd_scan_bwd": 64}
    one = dryrun._kernel_flops(ssm, shape, rt, launches, 0)
    card = dryrun._kernel_flops(ssm, shape, rt, launches, 0, rows=1,
                                split=2)
    assert one["ssd_scan_fwd"] == 128 * cost.ssd_flops(2, 4096, H,
                                                       s.head_dim, s.d_state)
    assert card["ssd_scan_fwd"] == 128 * cost.ssd_flops(1, 4096, H // 2,
                                                        s.head_dim, s.d_state)
    assert card["ssd_scan_bwd"] == card["ssd_scan_fwd"]
    dec = dataclasses.replace(shape, global_batch=8, mode="decode")
    one = dryrun._kernel_flops(gqa, dec, rt, {"flash_decode": 40,
                                              "flash_attention_fwd": 40},
                               8192)
    card = dryrun._kernel_flops(gqa, dec, rt, {"flash_decode": 40,
                                               "flash_attention_fwd": 40},
                                8192, rows=4, split=2)
    assert card["flash_decode"] * 4 == one["flash_decode"]
    assert card["flash_attention_fwd"] == 40 * cost.attention_flops(
        4, 4096, gqa.n_heads // 2, gqa.hd(), True, None)
