"""The MLA and MoE families in the PyTorch port against the reference, on
the CPU, at the reduced configs (2 layers, d_model 256, 4 experts).

* minicpm3-4b (dense, MLA with q-LoRA), deepseek-v2-lite-16b (MoE: a
  dense layer 0, one MoE layer with a shared expert; MLA without q-LoRA)
  and arctic-480b (MoE with the dense residual FFN; GQA of 4 over 2):
  configs field for field (``reduced()`` too), init trees with the
  shapes of the reference's ``param_spec`` (``dense0``, the experts
  stacked (L, E, ...)) carried across and back exactly; ``param_count``
  and ``active_param_count`` at full width equal to the reference's.
* With the reference's weights carried across through ``interop``:
  ``forward`` logits and aux, the loss (CE + aux, and the CE) and every
  gradient within 2e-5, under ``attn_impl="naive"`` and ``"pallas"``
  (arctic: the kernels' plain versions here; MLA: refused on both sides,
  ROADMAP caveat C-ref-10).
* ``init_cache`` equal to the reference's (``ckv`` for MLA), and 12
  decode steps: logits, caches and ``pos`` within 2e-5.
* ``input_specs`` equal to the reference's at every shape.
* ``launch.serve.main`` and ``launch.train.main`` on reduced
  deepseek-v2-lite-16b on the CPU; the training driver against the
  reference's with its init carried in: plans equal (both schedulers fed
  the reference's loss decays), losses within 1e-4."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.fed import train_step as ref_ts
from repro.launch import train as ref_train
from repro.models import model as rm

from repro_torch.configs import SHAPES, get_arch
from repro_torch.fed import train_step as ts
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.launch import serve, train
from repro_torch.models import model as tm
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

from test_torch_launch_train import _losses, _recording

TOL = 2e-5
B, S, STEPS = 2, 32, 12
NAMES = ("minicpm3-4b", "deepseek-v2-lite-16b", "arctic-480b")


def _as_dict(cfg):
    return {k: v for k, v in dataclasses.asdict(cfg).items()
            if v is not None}


def _parity(name, got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=name)
    return float(np.abs(got - want).max()) if got.size else 0.0


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(reference config, port config, reference params as numpy) at the
    reduced size."""
    ref_cfg, cfg = REF_ARCHS[name].reduced(), get_arch(name).reduced()
    ref_params = jax.tree_util.tree_map(
        np.asarray, rm.init(ref_cfg, jax.random.key(3)))
    return ref_cfg, cfg, ref_params


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "weights": rng.uniform(size=(B, S)).astype(np.float32)}


@pytest.mark.parametrize("name", NAMES)
def test_configs_and_init_trees_match_the_reference(name):
    assert _as_dict(get_arch(name)) == _as_dict(REF_ARCHS[name])
    ref_cfg, cfg, ref_params = _setup(name)
    assert _as_dict(cfg) == _as_dict(ref_cfg)
    got = tm.init(cfg, torch.Generator().manual_seed(0))
    spec = rm.param_spec(ref_cfg)
    assert ([tuple(t.shape) for t in tree_leaves(got)]
            == [tuple(x.shape) for x in jax.tree_util.tree_leaves(spec)])
    assert sorted(got) == sorted(spec)
    assert ("dense0" in got) == (name == "deepseek-v2-lite-16b")
    back = params_to_numpy(params_from_numpy(ref_params))
    for a, b in zip(tree_leaves(back),
                    jax.tree_util.tree_leaves(ref_params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", NAMES)
def test_param_and_active_counts_match_the_reference_at_full_width(name):
    cfg, ref_cfg = get_arch(name), REF_ARCHS[name]
    assert cfg.param_count() == ref_cfg.param_count()
    assert cfg.active_param_count() == ref_cfg.active_param_count()


@functools.lru_cache(maxsize=None)
def _reference_forward(name):
    """The reference's logits, aux, loss (CE + aux, CE) and gradients."""
    ref_cfg, cfg, ref_params = _setup(name)
    batch = _batch(cfg)
    ref_rt = rm.Runtime(dtype=jnp.float32, attn_impl="naive")
    loss_fn = ref_ts.make_loss_fn(ref_cfg, ref_rt)

    @jax.jit
    def reference(params, batch):
        logits, aux = rm.forward(ref_cfg, params, batch["tokens"],
                                 rt=ref_rt)
        (total, ce), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, batch)
        return logits, aux, total, ce, grads

    return batch, reference(ref_params,
                            {k: jnp.asarray(v) for k, v in batch.items()})


@pytest.mark.parametrize("impl", ["naive", "pallas"])
@pytest.mark.parametrize("name", NAMES)
def test_forward_loss_and_grads_match_the_reference(name, impl):
    ref_cfg, cfg, ref_params = _setup(name)
    rt = tm.Runtime(attn_impl=impl)
    params = params_from_numpy(ref_params)
    tokens = torch.from_numpy(_batch(cfg)["tokens"])[None]
    if cfg.attn_kind == "mla" and impl == "pallas":
        with pytest.raises(ValueError, match="C-ref-10"):
            tm.forward(cfg, tree_map(lambda t: t[None], params), tokens,
                       rt=rt)
        with pytest.raises((TypeError, ValueError)):
            rm.forward(ref_cfg, ref_params, jnp.asarray(tokens[0].numpy()),
                       rt=rm.Runtime(dtype=jnp.float32, attn_impl="pallas"))
        return
    batch, (want, want_aux, ref_total, ref_ce, ref_grads) = \
        _reference_forward(name)
    copy = {k: torch.from_numpy(v)[None] for k, v in batch.items()}
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    stacked = tree_map(lambda t: t[None], tree_unflatten(params, leaves))
    logits, aux = tm.forward(cfg, stacked, copy["tokens"], rt=rt)
    total, ce = ts._total_and_ce(cfg, rt)(stacked, copy)
    assert torch.equal(ts.make_loss_fn(cfg, rt)(stacked, copy), total)
    grads = torch.autograd.grad(total[0], leaves)
    err = _parity("logits", logits[0].detach(), want)
    aux_err = _parity("aux", aux[0].detach(), want_aux)
    assert (float(want_aux) > 0) == (cfg.family == "moe")
    loss_err = max(_parity("total", total[0].detach(), ref_total),
                   _parity("ce", ce[0].detach(), ref_ce))
    grad_err = max(_parity("grad", g, r) for g, r in zip(
        grads, jax.tree_util.tree_leaves(ref_grads)))
    print(f"PARITY {cfg.name} forward impl={impl}: logits max_abs_err="
          f"{err:.3g}, aux {aux_err:.3g}, loss {loss_err:.3g}, grads "
          f"{grad_err:.3g} tol={TOL}")


@functools.lru_cache(maxsize=None)
def _reference_decode(name):
    ref_cfg, cfg, ref_params = _setup(name)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, STEPS))
    step = jax.jit(lambda p, c, t: rm.decode_step(ref_cfg, p, c, t))
    cache = rm.init_cache(ref_cfg, B, STEPS)
    first = jax.tree_util.tree_map(np.asarray, cache)
    logits = []
    for t in range(STEPS):
        out, cache = step(ref_params, cache,
                          jnp.asarray(toks[:, t:t + 1], jnp.int32))
        logits.append(np.asarray(out))
    return toks, first, logits, jax.tree_util.tree_map(np.asarray, cache)


@pytest.mark.parametrize("impl", ["pallas", "naive"])
@pytest.mark.parametrize("name", NAMES)
def test_init_cache_and_decode_match_the_reference(name, impl):
    _, cfg, ref_params = _setup(name)
    toks, ref_first, ref_logits, ref_cache = _reference_decode(name)
    cache = tm.init_cache(cfg, B, STEPS)
    assert sorted(cache) == sorted(ref_first)
    assert ("ckv" in cache) == (cfg.attn_kind == "mla")
    for key, value in params_to_numpy(cache).items():
        assert value.dtype == ref_first[key].dtype, key
        assert np.array_equal(value, ref_first[key]), key
    params = params_from_numpy(ref_params)
    serve_step = ts.make_serve_step(cfg, tm.Runtime(attn_impl=impl))
    err = 0.0
    for t in range(STEPS):
        got, cache = serve_step(params, cache,
                                torch.from_numpy(toks[:, t:t + 1]))
        err = max(err, _parity(f"logits {t}", got, ref_logits[t]))
    assert int(cache["pos"]) == int(ref_cache["pos"]) == STEPS
    cache_err = max(_parity(key, value, ref_cache[key])
                    for key, value in params_to_numpy(cache).items())
    print(f"PARITY decode_step {cfg.name} {STEPS} tokens impl={impl}: "
          f"logits max_abs_err={err:.3g}, caches {cache_err:.3g} tol={TOL}")


@pytest.mark.parametrize("name", NAMES)
def test_input_specs_match_the_reference(name):
    for shape in SHAPES:
        got = ts.input_specs(get_arch(name), SHAPES[shape], tm.Runtime())
        want = ref_ts.input_specs(REF_ARCHS[name], REF_SHAPES[shape],
                                  rm.Runtime(dtype=jnp.float32))
        assert all(t.device.type == "meta" for t in tree_leaves(got))
        assert sorted(got) == sorted(want), shape
        assert [(tuple(t.shape), str(t.dtype).split(".")[-1])
                for t in tree_leaves(got)] == [
            (tuple(x.shape), str(x.dtype).split(".")[-1])
            for x in jax.tree_util.tree_leaves(want)], shape


def test_serve_and_train_main_match_the_reference(monkeypatch, capsys):
    name = "deepseek-v2-lite-16b"
    rate = serve.main(["--arch", name, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "5", "--gen", "3", "--ctx", "8"])
    assert rate > 0
    out = capsys.readouterr().out
    assert f"[serve] {name}-smoke: batch=2" in out and "(CPU)" in out
    argv = ["--arch", name, "--steps", "3", "--devices", "2", "--slot", "2",
            "--seq", "16"]
    # the reference's driver draws its init from seed 0: carried across
    carried = jax.tree_util.tree_map(np.asarray, rm.init(
        REF_ARCHS[name].reduced(), jax.random.key(0)))
    monkeypatch.setattr(train, "init",
                        lambda cfg, gen: params_from_numpy(carried))
    ref_plans, ref_decays, plans, decays = [], [], [], []
    _recording(ref_train, monkeypatch, ref_plans, ref_decays)
    _recording(train, monkeypatch, plans, decays, forced=ref_decays)
    ref_final = ref_train.main(argv)
    capsys.readouterr()
    final = train.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert plans == ref_plans and len(plans) == 3
    got, want = _losses(final, decays), _losses(ref_final, ref_decays)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert f"[train] {name}-smoke:" in out and "[train] done" in out
    print(f"PARITY launch.train.main {name}-smoke 3 steps: plans equal, "
          f"losses max_abs_err={float(np.abs(got - want).max()):.3g} "
          f"tol=1e-4")
