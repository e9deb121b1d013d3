"""SSM, hybrid and bf16 training in the PyTorch port against the reference,
on the CPU, at the reduced configs (2 layers, d_model 256).

* The train step's loss and every gradient leaf in bf16 under the
  production runtime (``runtime_for``: blockwise attention, remat) on
  mamba2-2.7b and zamba2-7b, and under ``attn_impl="pallas"`` (the flash
  kernels' plain versions) on zamba2-7b and qwen1.5-4b, against the
  reference's bf16 from the same bf16 weights: the loss within 2e-2, each
  leaf's largest gap within twice the reference's own bf16-vs-f32 gap at
  that leaf, and the mean gap over every gradient element below the
  reference's own (a port that computed a layer in float32 would sit at
  that gap, not under it).  The reference's own gap reaches 4.3 % of a
  leaf's largest magnitude (mamba2's ``D``), so a bound of 2e-2 of it
  would refuse the reference itself; the port's reaches 1.34 times the
  reference's at a leaf (zamba2's shared attention under "pallas").
  Every gradient leaf has its parameter's dtype, and the SSD backward
  (and the attention backward under "pallas") receives bf16 inputs with
  a float32 dt: a layer left in float32 hides under the bound.
* In float32 under "pallas": the loss and every gradient within 2e-5 of
  the reference at mamba2's d_state 128 (the backward's N 128) and at
  zamba2's head dim 112.
* ``launch.dryrun.run_pair(..., "train_4k", device="cpu")`` takes its
  train step on both SSM archs at reduced size (it raised before the
  backward took bf16).
* B3′'s unit partition (a group's (head, p) rows cut into head blocks of
  128 rows where it has more than 512 / 256 / 128 at N <= 16 / 32 / 128,
  each unit's dB and dC summed in unit order) mirrored in float32 by
  :func:`unit_bwd` over ``test_torch_ssd_dual.dual_bwd``, against the
  float64 plain backward, at N 128 with 8 units and at N 64 over two
  groups of 3, within 1e-4 (the backward's contract)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.fed import train_step as ref_ts
from repro.models import model as rm

from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.fed import train_step as ts
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.launch import dryrun
from repro_torch.models import model as tm
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

from test_torch_ssd_dual import _inputs as dual_inputs
from test_torch_ssd_dual import dual_bwd

BF16_TOL, F32_TOL = 2e-2, 2e-5
B, S = 2, 32


@functools.lru_cache(maxsize=None)
def _setup(name, **over):
    """(reference config, port config, the reference's float32 draw as
    numpy, a batch) at the reduced size with ``over`` replaced."""
    ref_cfg, cfg = REF_ARCHS[name].reduced(), get_arch(name).reduced()
    if "d_state" in over:
        ref_cfg = dataclasses.replace(ref_cfg, ssm=dataclasses.replace(
            ref_cfg.ssm, d_state=over["d_state"]))
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, d_state=over["d_state"]))
    if "head_dim" in over:
        ref_cfg = dataclasses.replace(ref_cfg, head_dim=over["head_dim"])
        cfg = dataclasses.replace(cfg, head_dim=over["head_dim"])
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(rm.init, static_argnums=(0,))(
            ref_cfg, jax.random.key(3)))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "weights": rng.uniform(size=(B, S)).astype(np.float32)}
    return ref_cfg, cfg, params, batch


@functools.lru_cache(maxsize=None)
def _reference(name, impl, dtype, remat, **over):
    """The reference's loss and gradients (as float32 numpy) in ``dtype``
    from its float32 draw cast leaf by leaf, and the cast weights."""
    ref_cfg, _, f32, batch = _setup(name, **over)
    dt = getattr(jnp, dtype)
    rt = rm.Runtime(dtype=dt, attn_impl=impl, block_q=512, remat=remat)
    params = jax.tree_util.tree_map(lambda a, spec: jnp.asarray(a).astype(
        spec.dtype), f32, rm.param_spec(ref_cfg, dt))
    loss_fn = ref_ts.make_loss_fn(ref_cfg, rt)
    (_, loss), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return (float(loss), [np.asarray(g.astype(jnp.float32))
                          for g in jax.tree_util.tree_leaves(grads)],
            params)


def _port(name, ref_params, rt, **over):
    """The port's loss and gradients from the reference's weights (their
    dtype kept), and the gradients' dtypes against the parameters'."""
    _, cfg, _, batch = _setup(name, **over)
    params = tree_map(lambda a: torch.from_numpy(np.array(
        a, np.float32)).to(getattr(torch, a.dtype.name)), ref_params)
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    stacked = tree_map(lambda t: t[None], tree_unflatten(params, leaves))
    copy = {k: torch.from_numpy(v)[None] for k, v in batch.items()}
    total = ts.make_loss_fn(cfg, rt)(stacked, copy)[0]   # CE: no MoE aux
    grads = torch.autograd.grad(total, leaves)
    assert [g.dtype for g in grads] == [p.dtype for p in leaves]
    return float(total.detach()), [g.float().numpy() for g in grads]


def _spy(monkeypatch, module, name, seen):
    real = getattr(module, name)

    def spy(*args, **kw):
        seen.append(tuple(a.dtype for a in args[:2]))
        return real(*args, **kw)

    monkeypatch.setattr(module, name, spy)


BF16_CASES = [("mamba2-2.7b", "blockwise"), ("zamba2-7b", "blockwise"),
              ("zamba2-7b", "pallas"), ("qwen1.5-4b", "pallas")]


@pytest.mark.parametrize("name,impl", BF16_CASES)
def test_bf16_loss_and_grads_match_the_reference(name, impl, monkeypatch):
    want_loss, want, ref_params = _reference(name, impl, "bfloat16", True)
    # the reference's own float32 step (blockwise: in float32 its
    # attention variants agree to ~1e-6, far under a bf16 gap)
    own_loss, own, _ = _reference(name, "blockwise", "float32", True)
    cfg = _setup(name)[1]
    rt = dataclasses.replace(dryrun.runtime_for(cfg, ShapeConfig(
        "train_4k", S, B, "train")), attn_impl=impl)
    ssd_seen, attn_seen = [], []
    _spy(monkeypatch, kssd, "ssd_scan_bwd", ssd_seen)
    _spy(monkeypatch, kfa, "flash_attention_bwd_dq", attn_seen)
    loss, got = _port(name, ref_params, rt)
    gaps = [np.abs(g - w) for g, w in zip(got, want)]
    own_gaps = [np.abs(o - w) for o, w in zip(own, want)]
    ratio = max(g.max() / max(o.max(), 1e-30)
                for g, o in zip(gaps, own_gaps))
    rel = max(g.max() / max(np.abs(w).max(), 1e-30)
              for g, w in zip(gaps, want))
    worst, own_worst = max(g.max() for g in gaps), max(g.max()
                                                      for g in own_gaps)
    mean = np.concatenate([g.ravel() for g in gaps]).mean()
    own_mean = np.concatenate([g.ravel() for g in own_gaps]).mean()
    print(f"PARITY {cfg.name} bf16 train step impl={impl}: loss "
          f"{abs(loss - want_loss):.3g} (own bf16 vs f32 "
          f"{abs(own_loss - want_loss):.3g}), gradients max_abs_err="
          f"{worst:.3g} mean {mean:.3g} (own {own_worst:.3g}, mean "
          f"{own_mean:.3g}); a leaf's largest gap at most {rel:.3g} of its "
          f"largest |value| and {ratio:.3g} times the reference's own")
    assert abs(loss - want_loss) <= BF16_TOL
    for i, (gap, own_gap) in enumerate(zip(gaps, own_gaps)):
        assert gap.max() <= 2 * own_gap.max(), i
    assert mean < own_mean
    if cfg.ssm is not None:
        assert ssd_seen and set(ssd_seen) == {(torch.bfloat16,
                                               torch.float32)}
    assert bool(attn_seen) == (impl == "pallas")
    assert set(attn_seen) <= {(torch.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("name,over", [("mamba2-2.7b", {"d_state": 128}),
                                       ("zamba2-7b", {"head_dim": 112})])
def test_f32_grads_at_full_width_state_and_head_dim(name, over):
    want_loss, want, ref_params = _reference(name, "naive", "float32", False,
                                             **over)
    loss, got = _port(name, ref_params, tm.Runtime(attn_impl="pallas"),
                      **over)
    np.testing.assert_allclose(loss, want_loss, rtol=F32_TOL, atol=F32_TOL)
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=str(i))
        err = max(err, float(np.abs(g - w).max()))
    print(f"PARITY {name}-smoke {over} f32 train step (pallas): loss "
          f"{abs(loss - want_loss):.3g}, grads max_abs_err={err:.3g} "
          f"tol={F32_TOL}")


def test_run_pair_trains_both_ssm_archs_on_the_cpu(monkeypatch):
    monkeypatch.setattr(dryrun, "get_arch", lambda n: ARCHS[n].reduced())
    monkeypatch.setattr(dryrun, "get_shape", {"train_4k": ShapeConfig(
        "train_4k", S, 256, "train")}.__getitem__)
    for name in ("mamba2-2.7b", "zamba2-7b"):
        row = dryrun.run_pair(name, "train_4k", device="cpu", repeats=1)
        assert row["dtype"] == "bfloat16" and row["runtime"]["remat"] == \
            "True"
        assert row["reduced"] == {"global_batch": [256, 1]}
        assert np.isfinite(row["loss"]) and row["launches"] == {}


def _plan(h, p, g, n):
    """``csrc/ssd_scan.cu::bwd_plan``: (heads a head block, head blocks a
    unit, units a group)."""
    hg = h // g
    heads = 16 // (p // 8) if p >= 8 else 16
    most = 512 if n <= 16 else 256 if n <= 32 else 128
    bpu = max(1, most // (heads * p))
    return heads, bpu, -(-(-(-hg // heads)) // bpu)


def unit_bwd(x, dt, A, Bm, Cm, dy):
    """The backward by the kernel's units: each unit the algorithm of
    ``dual_bwd`` over its heads of its group, dB and dC summed over a
    group's units in unit order (float32, from zero), as
    ``ssd_dbc_reduce_kernel`` sums them."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    hg = h // g
    heads, bpu, units = _plan(h, p, g, n)
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dA = torch.empty_like(A)
    dBm, dCm = torch.zeros_like(Bm), torch.zeros_like(Cm)
    for gi in range(g):
        grp = slice(gi, gi + 1)
        for u in range(units):
            h0 = gi * hg + u * bpu * heads
            hs = slice(h0, min(gi * hg + hg, h0 + bpu * heads))
            ux, uddt, udA, udB, udC = dual_bwd(
                x[:, :, hs], dt[:, :, hs], A[:, hs], Bm[:, :, grp],
                Cm[:, :, grp], dy[:, :, hs])
            dx[:, :, hs], ddt[:, :, hs], dA[:, hs] = ux, uddt, udA
            dBm[:, :, grp] += udB
            dCm[:, :, grp] += udC
    return dx, ddt, dA, dBm, dCm


@pytest.mark.parametrize("case", [
    (1, 2, 40, 16, 64, 1, 128),     # N 128: 8 units of 2 heads of 64
    (1, 2, 33, 24, 32, 2, 64),      # N 64: 2 groups of 3 units of 4 heads
])
def test_unit_partition_backward_is_within_1e_4_of_float64(case):
    copies, per, s, h, p, g, n = case
    assert _plan(h, p, g, n)[2] > 1
    ins, dy = dual_inputs(copies, per, s, h, p, g, n, seed=1)
    got = unit_bwd(*ins, dy)
    exact = kssd.ssd_scan_bwd_plain(*(t.double() for t in ins), dy.double(),
                                    chunk=s)
    worst = 0.0
    for name, a, ex in zip(("dx", "ddt", "dA", "dBm", "dCm"), got, exact):
        torch.testing.assert_close(a.double(), ex, rtol=1e-4, atol=1e-4,
                                   msg=lambda m: f"{name}: {m}")
        worst = max(worst, float(((a.double() - ex).abs()
                                  / (1e-4 + 1e-4 * ex.abs())).max()))
    print(f"PARITY ssd bwd unit partition B={copies * per} S={s} H={h} "
          f"P={p} G={g} N={n} ({_plan(h, p, g, n)[2]} units a group): "
          f"worst {worst:.3f} of the 1e-4 tolerance vs float64")
