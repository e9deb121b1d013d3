"""qwen1.5-4b and the training driver of the PyTorch port against the
reference, on the CPU.

* Reduced qwen1.5-4b (qkv biases set non-zero, the reference's weights
  carried across): ``forward`` logits and per-token ``decode_step``
  logits within 2e-5 of the reference's, under ``attn_impl="naive"`` and
  ``"pallas"`` (the kernels' plain versions on the CPU); the prefill
  step is the forward of one parameter set, bitwise.
* ``TokenData.synthetic`` is bitwise the reference's.
* ``input_specs`` gives the reference's shapes and dtypes for train,
  prefill and decode (with and without a window) at full width, on the
  ``meta`` device.
* ``launch.train.main(["--device", "cpu", ...])`` against the
  reference's ``main`` with the reference's init carried in: the plans
  equal (both schedulers fed the reference's loss decays, as the
  closed-loop tests do: a last-bit gap in a loss could flip a later
  B_k), the losses within 1e-4, and its ``--ckpt`` file read by the
  reference's ``restore_state``; without ``--device`` it raises when
  CUDA is absent."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as ref_ckpt
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.data.pipeline import TokenData as RefTokenData
from repro.fed import train_step as ref_ts
from repro.launch import train as ref_train
from repro.models import model as rm
from repro.optim import momentum as ref_momentum

from repro_torch.configs import SHAPES, get_arch
from repro_torch.data.pipeline import TokenData
from repro_torch.fed.train_step import input_specs, make_prefill_step
from repro_torch.interop import params_from_numpy
from repro_torch.launch import train
from repro_torch.models import model as tm
from repro_torch.tree import tree_leaves, tree_map

from test_torch_train import qwen_setup

TOL = 2e-5


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_qwen_forward_and_decode_match_reference(impl):
    ref_cfg, cfg, params, batch = qwen_setup()
    toks = batch["tokens"][:2, :12]
    ref_rt = rm.Runtime(dtype=jnp.float32, attn_impl="naive")
    rt = tm.Runtime(attn_impl=impl)
    p = params_from_numpy(params)
    ref_p = jax.tree_util.tree_map(jnp.asarray, params)
    want, _ = rm.forward(ref_cfg, ref_p, jnp.asarray(toks), rt=ref_rt)
    got = tm.forward(cfg, tree_map(lambda t: t[None], p),
                     torch.from_numpy(toks)[None], rt=rt)[0][0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    err = float(np.abs(got.numpy() - np.asarray(want)).max())
    prefill = make_prefill_step(cfg, rt)(p, {"tokens": torch.from_numpy(
        toks)})
    assert torch.equal(prefill, got)
    cache = tm.init_cache(cfg, 2, 12, rt)
    ref_cache = rm.init_cache(ref_cfg, 2, 12, ref_rt)
    step = jax.jit(lambda c, t: rm.decode_step(ref_cfg, ref_p, c, t,
                                               rt=ref_rt))
    for t in range(12):
        logits, cache = tm.decode_step(cfg, p, cache,
                                       torch.from_numpy(toks[:, t:t + 1]),
                                       rt=rt)
        ref_logits, ref_cache = step(ref_cache, jnp.asarray(toks[:, t:t + 1]))
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   rtol=TOL, atol=TOL)
        err = max(err, float(np.abs(logits.numpy()
                                    - np.asarray(ref_logits)).max()))
    print(f"PARITY qwen1.5-4b-smoke {impl} forward + 12 decode steps: "
          f"max_abs_err={err:.3g} tol={TOL}")


def test_qwen_init_adds_zero_biases_and_draws_nothing_more():
    cfg = get_arch("qwen1.5-4b").reduced()
    plain = dataclasses.replace(cfg, qkv_bias=False)
    with_bias = tm.init(cfg, torch.Generator().manual_seed(0))
    without = tm.init(plain, torch.Generator().manual_seed(0))
    attn = with_bias["layers"]["attn"]
    for name, heads in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                        ("bv", cfg.n_kv_heads)):
        assert attn.pop(name).equal(torch.zeros(cfg.n_layers,
                                                heads * cfg.hd()))
    for a, b in zip(tree_leaves(with_bias), tree_leaves(without)):
        assert torch.equal(a, b)


def test_token_data_is_bitwise_the_reference():
    got = TokenData.synthetic(n=64, seq=8, vocab=37, seed=3).tokens
    want = RefTokenData.synthetic(n=64, seq=8, vocab=37, seed=3).tokens
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _spec_list(tree):
    return [(tuple(x.shape), str(x.dtype).split(".")[-1])
            for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("arch,shape,window", [
    ("qwen1.5-4b", "train_4k", None), ("qwen1.5-4b", "prefill_32k", None),
    ("qwen1.5-4b", "decode_32k", None), ("mistral-nemo-12b", "decode_32k",
                                         4096),
    ("mamba2-2.7b", "long_500k", None)])
def test_input_specs_match_reference(arch, shape, window):
    cfg, ref_cfg = get_arch(arch), REF_ARCHS[arch]
    got = input_specs(cfg, SHAPES[shape], tm.Runtime(window=window))
    want = ref_ts.input_specs(ref_cfg, REF_SHAPES[shape],
                              rm.Runtime(dtype=jnp.float32, window=window))
    assert all(t.device.type == "meta" for t in tree_leaves(got))
    got_list = [(tuple(t.shape), str(t.dtype).split(".")[-1])
                for t in tree_leaves(got)]
    assert got_list == _spec_list(want)
    assert dataclasses.asdict(SHAPES[shape]) == dataclasses.asdict(
        REF_SHAPES[shape])


def _recording(module, monkeypatch, plans, decays, forced=None):
    """Record the driver's plans and observed loss decays; with
    ``forced``, feed its scheduler those decays instead of its own."""
    base = module.FeelScheduler

    class Recording(base):
        def plan(self):
            plan = super().plan()
            plans.append((tuple(int(b) for b in plan.batch), plan.lr,
                          plan.global_batch, plan.predicted_latency))
            return plan

        def observe(self, decay, global_batch):
            decays.append(decay)
            if forced is not None:
                decay = forced[len(decays) - 1]
            return super().observe(decay, global_batch)

    monkeypatch.setattr(module, "FeelScheduler", Recording)


def _losses(final, decays):
    """Every step's loss from the last one and the observed decays."""
    out = [final]
    for d in reversed(decays):
        out.insert(0, out[0] + d)
    return np.array(out)


def test_train_main_matches_reference(monkeypatch, tmp_path, capsys):
    argv = ["--steps", "3", "--devices", "2", "--slot", "2", "--seq", "16"]
    ref_cfg = REF_ARCHS["qwen1.5-4b"].reduced()
    ref_params = rm.init(ref_cfg, jax.random.key(0))
    carried = jax.tree_util.tree_map(np.asarray, ref_params)
    monkeypatch.setattr(train, "init",
                        lambda cfg, gen: params_from_numpy(carried))
    ref_plans, ref_decays, plans, decays = [], [], [], []
    _recording(ref_train, monkeypatch, ref_plans, ref_decays)
    _recording(train, monkeypatch, plans, decays, forced=ref_decays)
    ref_final = ref_train.main(argv + ["--ckpt", str(tmp_path / "r.ckpt")])
    ref_out = capsys.readouterr().out
    path = str(tmp_path / "p.ckpt")
    final = train.main(argv + ["--device", "cpu", "--ckpt", path])
    out = capsys.readouterr().out
    assert plans == ref_plans and len(plans) == 3
    np.testing.assert_allclose(_losses(final, decays),
                               _losses(ref_final, ref_decays), rtol=1e-4,
                               atol=1e-4)
    # the same lines, the wall clock aside
    strip = lambda text: [line.split(" wall=")[0].replace(  # noqa: E731
        str(tmp_path / "r.ckpt"), path) for line in text.splitlines()]
    assert len(strip(out)) == len(strip(ref_out)) == 6
    assert strip(out)[0] == strip(ref_out)[0]
    opt_like = ref_momentum(0.9).init(ref_params)
    step, p, o, _ = ref_ckpt.restore_state(path, ref_params, opt_like)
    assert step == 3
    assert jax.tree_util.tree_structure(p) == jax.tree_util.tree_structure(
        ref_params)
    for a, b in zip(jax.tree_util.tree_leaves(p),
                    jax.tree_util.tree_leaves(ref_ckpt.restore_state(
                        str(tmp_path / "r.ckpt"), ref_params,
                        opt_like)[1])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)


def test_train_main_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1"])
