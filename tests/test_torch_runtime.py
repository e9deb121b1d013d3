"""The production runtime in the PyTorch port against the reference, on
the CPU.

* ``Runtime`` has the reference's fields and defaults (but
  ``attn_impl``); ``runtime_for``, ``model_flops`` and every variant of
  ``perf.build`` equal the reference's for every ported arch × shape —
  the reference's ``launch.dryrun`` and ``launch.perf`` are imported in
  one subprocess, since both set ``XLA_FLAGS`` to 512 host devices at
  import.
* ``param_spec`` (f32, bf16) at full width and ``cache_spec`` and
  ``input_specs`` (f32, bf16, a window) equal the reference's
  ``eval_shape`` leaf for leaf.
* ``remat`` and ``remat_attn`` leave the logits and every gradient
  bitwise unchanged (dense GQA, MoE + MLA, hybrid; chunked attention);
  ``gqa_expand`` the logits and the loss, and the gradients within 2e-5:
  a KV head's gradient sums its group's heads in another order.
  ``remat`` is refused under ``torch.func``.
* The bf16 forward and loss hold against the reference's bf16 within
  2e-2: the logits' largest gap within 2e-2 of their largest magnitude
  (bf16 keeps 8 bits), the loss within 2e-2; and the logits' largest
  and mean gaps under the reference's own bf16-vs-f32 gaps, which a port
  computing in float32 would meet exactly.  The two packages round
  after every operation, but their elementwise functions (``silu``,
  ``softmax``) differ in the last bit, so the gap is not near zero;
  the ``PARITY`` line gives it.  The MoE case's router is zero, which
  pins every top-k choice; a drawn router is compared on the tokens
  whose routing margin is well above bf16 rounding (a choice within
  rounding of a tie flips with the least change in its input and moves
  the token's output by O(1)).
* Under bf16 every product the port dispatches outside the SSD scan
  reads bf16 values (as every product of the reference's does), and the
  scan reads bf16 x, B and C with a float32 dt, as the reference's.
* ``launch.cost`` counts a product at 2·M·N·K and a loop body times its
  trips; ``launch.dryrun`` and ``launch.perf`` run on the CPU at a
  reduced config."""
import collections
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ARCHS as REF_ARCHS
from repro.fed import train_step as ref_ts
from repro.models import model as rm

from repro_torch.configs import ARCHS, ASSIGNED, SHAPES, get_arch
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.fed import train_step as ts
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.launch import cost, dryrun, perf
from repro_torch.models import cache_spec, param_spec
from repro_torch.models import model as tm
from repro_torch.models import moe as moe_mod
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

NAMES = sorted(ASSIGNED)
VARIANTS = ("baseline", "flashjnp", "blockwise", "seq_parallel",
            "no_remat", "remat_attn", "opt_bf16", "zero1", "cap1.0",
            "expert_choice", "gqa_expand", "window4096", "blockq256",
            "flashjnp+seq_parallel", "remat_attn+opt_bf16+zero1")
BF16_TOL = 2e-2
B, S = 2, 32


def _spec_list(tree):
    return [(tuple(x.shape), str(x.dtype).split(".")[-1])
            for x in jax.tree_util.tree_leaves(tree)]


def _port_list(tree):
    leaves = tree_leaves(tree)
    assert all(t.device.type == "meta" for t in leaves)
    return [(tuple(t.shape), str(t.dtype).split(".")[-1]) for t in leaves]


def _plain(value):
    """A runtime field's value as JSON gives it back."""
    if isinstance(value, (torch.dtype, jnp.dtype)) or value in (
            jnp.float32, jnp.bfloat16):
        return str(value).split(".")[-1].replace("'>", "")
    return list(value) if isinstance(value, tuple) else value


def _fields(rt):
    return {f.name: _plain(getattr(rt, f.name))
            for f in dataclasses.fields(rt)}


def test_runtime_has_the_reference_fields_and_defaults():
    got, want = _fields(tm.Runtime()), _fields(rm.Runtime())
    assert list(got) == list(want)
    assert got.pop("attn_impl") == "pallas"
    want.pop("attn_impl")
    assert got == want
    assert _fields(tm.SMOKE_RT) == _fields(rm.SMOKE_RT)


_REFERENCE_DRIVERS = r"""
import dataclasses, functools, json, sys
import jax
import jax.numpy as jnp
from repro.configs import ARCHS, SHAPES
from repro.configs.base import ArchConfig
from repro.launch import dryrun, perf
ArchConfig.param_count = functools.cache(ArchConfig.param_count)

def plain(v):
    if isinstance(v, tuple):
        return list(v)
    if v in (jnp.float32, jnp.bfloat16):
        return jnp.dtype(v).name
    return v

out = {}
for name in json.loads(sys.argv[1]):
    cfg = ARCHS[name]
    for s, shape in SHAPES.items():
        row = {"model_flops": dryrun.model_flops(cfg, shape)}
        for variant in json.loads(sys.argv[2]):
            rt, opt, zero1 = perf.build(variant, cfg, shape)
            state = None if opt is None else jnp.dtype(jax.eval_shape(
                opt.init, {"w": jax.ShapeDtypeStruct((2,), jnp.float32)}
            )["w"].dtype).name
            row[variant] = [{f.name: plain(getattr(rt, f.name))
                             for f in dataclasses.fields(rt)}, state, zero1]
        row["runtime_for"] = row["baseline"][0]
        out[f"{name} {s}"] = row
print(json.dumps(out))
"""


@functools.lru_cache(maxsize=None)
def _reference_drivers():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH", "")) if p)
    out = subprocess.run([sys.executable, "-c", _REFERENCE_DRIVERS,
                          json.dumps(NAMES), json.dumps(VARIANTS)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_runtime_for_model_flops_and_perf_build_match_the_reference(
        monkeypatch):
    # model_flops counts the parameters on the meta device: once an arch
    monkeypatch.setattr(ArchConfig, "param_count",
                        functools.cache(ArchConfig.param_count))
    want = _reference_drivers()
    for name in NAMES:
        cfg = get_arch(name)
        for s, shape in SHAPES.items():
            ref = want[f"{name} {s}"]
            assert _fields(dryrun.runtime_for(cfg, shape)) == \
                ref["runtime_for"], (name, s)
            assert dryrun.model_flops(cfg, shape) == ref["model_flops"]
            for variant in VARIANTS:
                rt, opt, zero1 = perf.build(variant, cfg, shape)
                state = None if opt is None else str(
                    opt.init({"w": torch.zeros(2)})["w"].dtype).split(".")[-1]
                assert [_fields(rt), state, zero1] == ref[variant], (
                    name, s, variant)
    with pytest.raises(ValueError, match="unknown knob"):
        perf.build("nope", get_arch(NAMES[0]), SHAPES["train_4k"])


@pytest.mark.parametrize("name", NAMES)
def test_param_spec_matches_the_reference(name):
    for dtype, ref_dtype in ((torch.float32, jnp.float32),
                             (torch.bfloat16, jnp.bfloat16)):
        got = param_spec(get_arch(name), dtype)
        want = rm.param_spec(REF_ARCHS[name], ref_dtype)
        assert _port_list(got) == _spec_list(want), (name, dtype)


@pytest.mark.parametrize("name", NAMES)
def test_cache_and_input_specs_match_the_reference(name):
    cfg, ref_cfg = get_arch(name), REF_ARCHS[name]
    windows = (None, 16) if cfg.n_heads and cfg.attn_kind == "gqa" else (
        None,)
    for dtype, ref_dtype in ((torch.float32, jnp.float32),
                             (torch.bfloat16, jnp.bfloat16)):
        for window in windows:
            rt = tm.Runtime(dtype=dtype, window=window)
            ref_rt = rm.Runtime(dtype=ref_dtype, window=window)
            assert _port_list(cache_spec(cfg, 2, 64, rt)) == _spec_list(
                rm.cache_spec(ref_cfg, 2, 64, ref_rt)), (dtype, window)
            for shape in ("train_4k", "decode_32k"):
                got = ts.input_specs(cfg, SHAPES[shape], rt)
                want = ref_ts.input_specs(ref_cfg, SHAPES[shape], ref_rt)
                assert _port_list(got) == _spec_list(want), (shape, dtype)


@functools.lru_cache(maxsize=None)
def _reduced(name):
    """The reduced config, its parameters (f32, seed 3) and a batch."""
    cfg = get_arch(name).reduced()
    params = tm.init(cfg, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "weights": rng.uniform(size=(B, S)).astype(np.float32)}
    return cfg, params, batch


def _logits_and_grads(name, rt):
    cfg, params, batch = _reduced(name)
    leaves = [t.detach().clone().requires_grad_()
              for t in tree_leaves(params)]
    stacked = tree_map(lambda t: t[None], tree_unflatten(params, leaves))
    copy = {k: torch.from_numpy(v)[None] for k, v in batch.items()}
    logits, _ = tm.forward(cfg, stacked, copy["tokens"], rt=rt)
    total = ts.make_loss_fn(cfg, rt)(stacked, copy)[0]
    return logits.detach(), total.detach(), torch.autograd.grad(total,
                                                                leaves)


@pytest.mark.parametrize("knob", ["remat", "remat_attn", "gqa_expand"])
@pytest.mark.parametrize("name", ["qwen1.5-4b", "deepseek-v2-lite-16b",
                                  "zamba2-7b"])
def test_remat_and_gqa_expand_leave_the_step_unchanged(name, knob):
    base = tm.Runtime(attn_impl="blockwise", block_q=8)
    want = _logits_and_grads(name, base)
    got = _logits_and_grads(name, dataclasses.replace(base, **{knob: True}))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for g, w in zip(got[2], want[2]):
        if knob == "gqa_expand":
            torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5)
        else:
            assert torch.equal(g, w)


def test_remat_is_refused_under_torch_func():
    cfg, params, batch = _reduced("qwen1.5-4b")
    rt = tm.Runtime(attn_impl="blockwise", block_q=8, remat=True)
    tokens = torch.from_numpy(batch["tokens"])[None]

    def logits_sum(stacked):
        return tm.forward(cfg, stacked, tokens, rt=rt)[0].sum()

    stacked = tree_map(lambda t: t[None], params)
    with pytest.raises(ValueError, match="torch.func"):
        torch.func.grad(logits_sum)(stacked)


BF16_NAMES = ["qwen1.5-4b", "deepseek-v2-lite-16b", "zamba2-7b"]


def _dot_flops(jaxpr, mult=1, out=None):
    """2·M·N·K FLOPs of every ``dot_general`` of a jaxpr, by the dtype of
    its operands, a scan body's counted times its length."""
    out = collections.Counter() if out is None else out
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (contract, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval
            k = int(np.prod([lhs.shape[i] for i in contract]))
            n = int(np.prod(eqn.outvars[0].aval.shape))
            out[jnp.dtype(lhs.dtype).name] += 2 * n * k * mult
        trips = eqn.params.get("length", 1) if eqn.primitive.name == "scan" \
            else 1
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    _dot_flops(sub, mult * trips, out)
    return out


@functools.lru_cache(maxsize=None)
def _reference_bf16(name, zero_router=True, capacity_factor=1.25):
    """The reference on the reduced config at f32 and bf16 (its bf16
    parameters are its float32 draw cast leaf by leaf): logits and loss
    of each, the bf16 parameters, and the FLOPs of the bf16 forward's
    products by operand dtype."""
    ref_cfg = REF_ARCHS[name].reduced()
    _, _, batch = _reduced(name)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    f32_params = jax.jit(rm.init, static_argnums=(0,))(ref_cfg,
                                                       jax.random.key(3))
    if zero_router and "moe" in f32_params["layers"]:
        moe = f32_params["layers"]["moe"]
        moe["router"] = jnp.zeros_like(moe["router"])
    out = {}
    for dt in (jnp.float32, jnp.bfloat16):
        ref_rt = rm.Runtime(dtype=dt, attn_impl="blockwise",
                            capacity_factor=capacity_factor)
        ref_params = jax.tree_util.tree_map(
            lambda a, spec: a.astype(spec.dtype), f32_params,
            rm.param_spec(ref_cfg, dt))
        loss_fn = ref_ts.make_loss_fn(ref_cfg, ref_rt)

        def logits_and_loss(p, bt):
            return (rm.forward(ref_cfg, p, bt["tokens"], rt=ref_rt)[0],
                    loss_fn(p, bt)[0])

        logits, total = jax.jit(logits_and_loss)(ref_params, jbatch)
        out[jnp.dtype(dt).name] = (np.asarray(logits.astype(jnp.float32))[
            ..., :ref_cfg.vocab], float(total))
    dots = _dot_flops(jax.make_jaxpr(lambda p, t: rm.forward(
        ref_cfg, p, t, rt=ref_rt)[0])(ref_params, jbatch["tokens"]).jaxpr)
    return out, ref_params, dict(dots)


def _port_bf16(name, ref_params, with_loss=True, **rt_kw):
    """The port's bf16 logits (N = 1 dropped, float32, true vocab) and loss
    (or None) from the reference's bf16 parameters."""
    cfg, _, batch = _reduced(name)
    params = tree_map(lambda a: torch.from_numpy(np.array(
        a, np.float32)).to(getattr(torch, a.dtype.name))[None], ref_params)
    rt = tm.Runtime(dtype=torch.bfloat16, attn_impl="blockwise",
                    block_q=512, **rt_kw)
    copy = {k: torch.from_numpy(v)[None] for k, v in batch.items()}
    logits, _ = tm.forward(cfg, params, copy["tokens"], rt=rt)
    assert logits.dtype == torch.bfloat16
    loss = (float(ts.make_loss_fn(cfg, rt)(params, copy)[0]) if with_loss
            else None)
    return logits[0].float().numpy()[..., :cfg.vocab], loss


def _gaps(got, want, own):
    """(max, mean) |got - want| beside the same of |own - want|."""
    d, o = np.abs(got - want), np.abs(own - want)
    return (float(d.max()), float(d.mean())), (float(o.max()),
                                               float(o.mean()))


@pytest.mark.parametrize("name", BF16_NAMES)
def test_bf16_forward_and_loss_match_the_reference(name):
    out, ref_params, _ = _reference_bf16(name)
    (want, want_loss), (own, own_loss) = out["bfloat16"], out["float32"]
    got, loss = _port_bf16(name, ref_params)
    gap, own_gap = _gaps(got, want, own)
    scale = float(np.abs(want).max())
    print(f"PARITY {name}-smoke bf16 forward: logits max_abs_err="
          f"{gap[0]:.3g} mean {gap[1]:.3g} of max |logit| {scale:.3g} (the "
          f"reference's own bf16 vs f32 {own_gap[0]:.3g}, mean "
          f"{own_gap[1]:.3g}), loss {abs(loss - want_loss):.3g} (own "
          f"{abs(own_loss - want_loss):.3g}) tol={BF16_TOL}")
    assert gap[0] <= BF16_TOL * scale
    assert abs(loss - want_loss) <= BF16_TOL
    # closer to the reference's bf16 than its own float32 run is: a port
    # that computed in float32 gives the reference's f32 logits back
    assert gap[0] < own_gap[0] and gap[1] < own_gap[1]


class _Products(TorchDispatchMode):
    """The products PyTorch dispatches (``mm``, ``bmm``, ``addmm``,
    ``baddbmm``) as 2·M·N·K FLOPs by the kind of their operands:
    ``bfloat16`` where both hold bf16 values (bf16 tensors, or float32
    ones that bf16 represents exactly, as the reference's bf16 products
    accumulating in float32 read them), else ``float32``; under
    ``scan`` while the SSD scan's plain version runs."""
    PRODUCTS = ("mm", "bmm", "addmm", "baddbmm")

    def __init__(self):
        super().__init__()
        self.flops = collections.Counter()
        self.where = "model"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in self.PRODUCTS:
            a, b = args[1:3] if name.startswith(("addmm", "baddbmm")) \
                else args[:2]
            bf16 = all(t.dtype == torch.bfloat16 or torch.equal(
                t, t.bfloat16().float()) for t in (a, b))
            kind = "bfloat16" if bf16 else "float32"
            self.flops[(self.where, kind)] += 2 * out.numel() * a.shape[-1]
        return out


@pytest.mark.parametrize("name", BF16_NAMES)
def test_bf16_forward_runs_its_products_in_bf16(name, monkeypatch):
    """Under bf16 every product of the port's forward reads bf16 values,
    as every product of the reference's does but the SSD scan's, which
    both run in float32 on bf16 x, B and C and a float32 dt."""
    _, ref_params, ref_dots = _reference_bf16(name)
    products = _Products()
    scans = []
    plain = kssd.ssd_reference

    def scan(x, dt, *rest):
        scans.append((x.dtype, dt.dtype))
        products.where = "scan"
        try:
            return plain(x, dt, *rest)
        finally:
            products.where = "model"

    monkeypatch.setattr(kssd, "ssd_reference", scan)
    with products:
        _port_bf16(name, ref_params, with_loss=False)
    flops = dict(products.flops)
    print(f"PARITY {name}-smoke bf16 products: port {flops}, reference "
          f"{ref_dots}")
    assert flops.get(("model", "float32"), 0) == 0
    assert flops[("model", "bfloat16")] >= ref_dots["bfloat16"]
    if get_arch(name).ssm is None:
        assert not scans and "float32" not in ref_dots
    else:
        assert scans and set(scans) == {(torch.bfloat16, torch.float32)}
        assert flops[("scan", "float32")] > 0 and ref_dots["float32"] > 0


def test_bf16_moe_routing_matches_the_reference(monkeypatch):
    """deepseek-v2-lite-16b's drawn router in bf16: the logits of the
    tokens whose routing margin (the k-th largest router logit over the
    next, in float32) is at least 0.02 against the reference's bf16, as
    the test above.  The margin must exceed four times the largest move
    bf16 makes in a router logit (the port's bf16 against its float32,
    the softmax's shift taken out), so that no such choice flips; a
    choice inside bf16 rounding of a tie may flip in either run and move
    its token by O(1), so those tokens are left out.  The MoE layer is
    the last, so a flip moves no other token, and capacity 2.0 drops no
    choice."""
    name, margin = "deepseek-v2-lite-16b", 0.02
    out, ref_params, _ = _reference_bf16(name, zero_router=False,
                                         capacity_factor=2.0)
    (want, _), (own, _) = out["bfloat16"], out["float32"]
    cfg = get_arch(name).reduced()
    assert cfg.moe.first_dense_layers == cfg.n_layers - 1
    logits = []
    route = moe_mod.route_scatter

    def spy(probs, K, C):
        logits.append(torch.log(probs.float())[0])
        return route(probs, K, C)

    monkeypatch.setattr(moe_mod, "route_scatter", spy)
    f32 = tree_map(lambda a: torch.from_numpy(np.array(a, np.float32))[None],
                   ref_params)
    tm.forward(cfg, f32, torch.from_numpy(_reduced(name)[2]["tokens"])[None],
               rt=tm.Runtime(attn_impl="blockwise", block_q=512,
                             capacity_factor=2.0))
    got, _ = _port_bf16(name, ref_params, with_loss=False,
                        capacity_factor=2.0)
    monkeypatch.undo()
    moved = logits[1] - logits[0]
    noise = float((moved - moved.mean(-1, keepdim=True)).abs().max())
    top = torch.topk(logits[0], cfg.moe.top_k + 1, dim=-1).values
    robust = (top[..., -2] - top[..., -1] >= margin).numpy()
    gap, own_gap = _gaps(got[robust], want[robust], own[robust])
    print(f"PARITY {name}-smoke bf16 forward, drawn router: "
          f"{int(robust.sum())} of {robust.size} tokens with a routing "
          f"margin >= {margin} (bf16 moves a router logit by at most "
          f"{noise:.3g}): logits max_abs_err={gap[0]:.3g} mean "
          f"{gap[1]:.3g} (the reference's own bf16 vs f32 {own_gap[0]:.3g}, "
          f"mean {own_gap[1]:.3g})")
    assert 4 * noise < margin and robust.mean() >= 0.5
    assert gap[0] < own_gap[0] and gap[1] < own_gap[1]


def test_cost_counts_products_and_loops():
    a, w = torch.randn(64, 128), torch.randn(128, 32)
    _, c = cost.count(lambda: a @ w)
    assert c.flops == 2 * 64 * 128 * 32 and c.by_op == {"aten.mm": c.flops}
    ws = torch.randn(6, 64, 64)

    def looped(x):
        for i in range(6):
            x = torch.relu(x @ ws[i])
        return x

    _, lc = cost.count(looped, torch.randn(32, 64))
    assert lc.flops == 6 * 2 * 32 * 64 * 64
    x = torch.randn(32, 64, requires_grad=True)
    _, bc = cost.count(lambda: torch.autograd.grad((x @ ws[0]).sum(), x))
    assert bc.flops == 2 * (2 * 32 * 64 * 64)     # forward + dX
    assert cost.visible_pairs(4096) == 4096 * 4097 // 2
    assert cost.visible_pairs(10, window=3) == 6 + 7 * 3
    assert cost.attention_flops(1, 8, 2, 4) == 4 * 2 * 4 * 36


SMALL = {"train_4k": ShapeConfig("train_4k", 32, 256, "train"),
         "prefill_32k": ShapeConfig("prefill_32k", 64, 32, "prefill"),
         "decode_32k": ShapeConfig("decode_32k", 64, 128, "decode"),
         "long_500k": ShapeConfig("long_500k", 128, 1, "decode")}


@pytest.fixture
def reduced_pairs(monkeypatch):
    monkeypatch.setattr(dryrun, "get_arch", lambda n: ARCHS[n].reduced())
    monkeypatch.setattr(dryrun, "get_shape", SMALL.__getitem__)
    monkeypatch.setattr(perf, "get_arch", lambda n: ARCHS[n].reduced())
    monkeypatch.setattr(perf, "get_shape", SMALL.__getitem__)


def test_dryrun_and_perf_run_on_the_cpu(reduced_pairs, capsys):
    perf.main(["--arch", "qwen1.5-4b", "--shape", "train_4k", "--device",
               "cpu", "--variants", "baseline,remat_attn,no_remat,opt_bf16",
               "--layers", "1"])
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("[perf]")]
    assert len(lines) == 4 and not any("FAIL" in line for line in lines)
    assert all("Δflops" in line for line in lines[1:])
    row = dryrun.run_pair("zamba2-7b", "decode_32k", device="cpu",
                          repeats=1)
    assert row["reduced"] == {"global_batch": [128, 4]}
    assert row["device"] == "cpu" and row["mfu"] is None
    assert row["memory"]["peak_bytes"] is None
    assert row["counted_flops"] > 0 and row["launches"] == {}
    assert row["model_flops_total"] == dryrun.model_flops(
        ARCHS["zamba2-7b"].reduced(), dataclasses.replace(
            SMALL["decode_32k"], global_batch=4))
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "mamba2-2.7b", "--shape", "prefill_32k",
                     "--device", "cpu"])
    assert done.value.code == 0
    assert "1/1 OK" in capsys.readouterr().out
