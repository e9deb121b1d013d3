"""Token decode in the PyTorch port against the reference, on the CPU.

* The arch registry: the port's ``mistral-nemo-12b`` and ``mamba2-2.7b``
  are the reference's configs field for field, ``reduced()`` too; the
  reference's other architectures are refused as not ported.
* ``init_cache`` shapes and dtypes equal the reference's.
* ``decode_step`` over 12 tokens (32 with a window of 8), with the
  reference's ``init`` parameters carried across through ``interop``:
  per-token logits and the final caches within 2e-5 of the reference's
  ``decode_step``, ``pos`` equal, under ``attn_impl="pallas"`` (the
  flash-decode kernel's plain version on the CPU) and ``"naive"`` — for
  reduced mistral-nemo-12b (with and without a window), reduced
  mamba2-2.7b, and the ``pos >= ctx`` clamp of a cache without a window
  (reference caveat C-ref-6).
* Decode agrees with the port's own full-sequence ``forward`` (2e-3 in
  log-softmax, the reference's ``tests/test_models.py`` bound).
* ``launch.serve.main`` runs at reduced size on the CPU and returns a
  positive rate; without ``--device`` it raises when CUDA is absent.
* ``init`` fills its stacked layers in place and keeps the CPU stream."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import ASSIGNED as REF_ASSIGNED
from repro.configs import get_arch as ref_get_arch
from repro.models import model as rm

from repro_torch.configs import ARCHS, ASSIGNED, get_arch
from repro_torch.fed.train_step import make_serve_step
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.launch import serve
from repro_torch.models import model as tm
from repro_torch.tree import tree_leaves, tree_map

TOL = 2e-5
B = 2

# (arch, attn_window, tokens, ctx): the reduced configs, a window of 8 over
# 32 tokens (a ring buffer of 8 slots wrapping four times), and 12 tokens
# into a cache of 8 slots without a window (the clamp, C-ref-6)
CASES = [("mistral-nemo-12b", None, 12, 12),
         ("mistral-nemo-12b", 8, 32, 32),
         ("mamba2-2.7b", None, 12, 12),
         ("mistral-nemo-12b", None, 12, 8)]
CASE_IDS = ["dense", "dense-window8", "ssm", "dense-clamp"]


def _configs(name, window):
    ref_cfg, cfg = ref_get_arch(name).reduced(), get_arch(name).reduced()
    if window is not None:
        ref_cfg = dataclasses.replace(ref_cfg, attn_window=window)
        cfg = dataclasses.replace(cfg, attn_window=window)
    return ref_cfg, cfg


def _tokens(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, n))


def _as_dict(cfg):
    d = dataclasses.asdict(cfg)
    return {k: v for k, v in d.items() if v is not None}


@pytest.mark.parametrize("name", sorted(ASSIGNED))
def test_configs_equal_the_reference(name):
    assert _as_dict(get_arch(name)) == _as_dict(ref_get_arch(name))
    assert (_as_dict(get_arch(name).reduced())
            == _as_dict(ref_get_arch(name).reduced()))
    for cfg in (get_arch(name), get_arch(name).reduced()):
        tm._require_ported(cfg)                      # runs what it returns


def test_registry_refuses_what_is_not_ported():
    """The registry is the reference's (feel-mlp included, field for
    field); the decoder stack refuses family "mlp", whose model is
    ``fed.feel_model``."""
    assert set(ARCHS) == set(REF_ARCHS)
    assert ASSIGNED == REF_ASSIGNED
    assert _as_dict(get_arch("feel-mlp")) == _as_dict(ref_get_arch("feel-mlp"))
    with pytest.raises(NotImplementedError, match=r"fed\.feel_model"):
        tm.init(get_arch("feel-mlp"), torch.Generator().manual_seed(0))
    with pytest.raises(KeyError):
        get_arch("gpt-5")


@pytest.mark.parametrize("name,window,n,ctx", CASES, ids=CASE_IDS)
def test_init_cache_matches_the_reference(name, window, n, ctx):
    ref_cfg, cfg = _configs(name, window)
    want = rm.init_cache(ref_cfg, B, ctx)
    got = tm.init_cache(cfg, B, ctx)
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)
        assert not got[key].any()


@pytest.mark.parametrize("impl", ["pallas", "naive"])
@pytest.mark.parametrize("name,window,n,ctx", CASES, ids=CASE_IDS)
def test_decode_step_matches_the_reference(name, window, n, ctx, impl):
    ref_cfg, cfg = _configs(name, window)
    ref_params = rm.init(ref_cfg, jax.random.key(1))
    params = params_from_numpy(ref_params)
    toks = _tokens(cfg, n)
    step = jax.jit(lambda p, c, t: rm.decode_step(ref_cfg, p, c, t))
    ref_cache = rm.init_cache(ref_cfg, B, ctx)
    cache = tm.init_cache(cfg, B, ctx)
    serve_step = make_serve_step(cfg, tm.Runtime(attn_impl=impl))
    err = 0.0
    for t in range(n):
        want, ref_cache = step(ref_params, ref_cache,
                               jnp.asarray(toks[:, t:t + 1]))
        got, cache = serve_step(params, cache,
                                torch.from_numpy(toks[:, t:t + 1]))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
        err = max(err, float(np.abs(got.numpy() - np.asarray(want)).max()))
    assert int(cache["pos"]) == int(ref_cache["pos"]) == n
    assert cache["pos"].dtype == torch.int32
    cache_err = 0.0
    for key, value in params_to_numpy(cache).items():
        np.testing.assert_allclose(value, np.asarray(ref_cache[key]),
                                   rtol=TOL, atol=TOL)
        cache_err = max(cache_err, float(np.abs(
            value - np.asarray(ref_cache[key])).max()))
    print(f"PARITY decode_step {cfg.name} window={window} ctx={ctx} "
          f"{n} tokens impl={impl}: logits max_abs_err={err:.3g}, caches "
          f"{cache_err:.3g} tol={TOL}")


@pytest.mark.parametrize("name,window,n", [c[:3] for c in CASES[:3]],
                         ids=CASE_IDS[:3])
def test_decode_matches_the_full_sequence_forward(name, window, n):
    _, cfg = _configs(name, window)
    params = tm.init(cfg, torch.Generator().manual_seed(2))
    toks = torch.from_numpy(_tokens(cfg, n, seed=3))
    full = tm.forward(cfg, tree_map(lambda t: t[None], params),
                      toks[None])[0][0]
    cache = tm.init_cache(cfg, B, n)
    steps = []
    for t in range(n):
        logits, cache = tm.decode_step(cfg, params, cache, toks[:, t:t + 1])
        steps.append(logits)
    dec = torch.cat(steps, dim=1)
    fv = torch.log_softmax(full[..., :cfg.vocab], -1)
    dv = torch.log_softmax(dec[..., :cfg.vocab], -1)
    err = float((fv - dv).abs().max())
    assert err < 2e-3
    print(f"PARITY decode vs forward {cfg.name} window={window}: "
          f"log-softmax max_abs_err={err:.3g} tol=2e-3")


def test_init_fills_the_stacked_layers_with_the_same_stream():
    """In-place layer filling draws what drawing every layer and stacking
    drew: a CPU generator's parameters are unchanged (an audio model's
    tables and heads drawn one a codebook, a hybrid's shared block last,
    a MoE model's dense blocks first, its experts drawn into their
    slots)."""
    for name in ASSIGNED:
        cfg = get_arch(name).reduced()
        got = tm.init(cfg, torch.Generator().manual_seed(5))
        gen = torch.Generator().manual_seed(5)

        def per_codebook(draw):
            if cfg.n_codebooks == 1:
                return draw()
            return torch.stack([draw() for _ in range(cfg.n_codebooks)])

        want = {"embed": {"table": per_codebook(lambda: tm.embedding_init(
                    gen, cfg.vocab, cfg.d_model)["table"])},
                "lm_head": per_codebook(lambda: tm.dense_init(
                    gen, cfg.d_model, tm.padded_vocab(cfg.vocab))),
                "final_norm": tm.rmsnorm_init(cfg.d_model)}
        nd = cfg.moe.first_dense_layers if cfg.moe is not None else 0
        if nd:
            dense0 = [tm._dense_layer_init(gen, cfg, torch.float32)
                      for _ in range(nd)]
            want["dense0"] = tree_map(lambda *ls: torch.stack(ls), *dense0)
        layers = [tm._LAYER_INIT[cfg.family](gen, cfg, torch.float32)
                  for _ in range(cfg.n_layers - nd)]
        want["layers"] = tree_map(lambda *ls: torch.stack(ls), *layers)
        if cfg.family == "hybrid":
            want["shared_attn"] = tm._dense_layer_init(gen, cfg,
                                                       torch.float32)
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(a, b)


def test_interop_carries_a_decode_cache_across_and_back():
    ref_cfg, cfg = _configs("mamba2-2.7b", None)
    ref_params = rm.init(ref_cfg, jax.random.key(4))
    ref_cache = rm.init_cache(ref_cfg, B, 4)
    for t in range(3):
        _, ref_cache = rm.decode_step(ref_cfg, ref_params, ref_cache,
                                      jnp.full((B, 1), t, jnp.int32))
    cache = params_from_numpy(ref_cache)
    assert cache["pos"].shape == () and int(cache["pos"]) == 3
    back = params_to_numpy(cache)
    for key in ref_cache:
        assert np.array_equal(back[key], np.asarray(ref_cache[key]))
    # the carried cache decodes on where the reference's left off
    params = params_from_numpy(ref_params)
    tok = np.full((B, 1), 7)
    want, _ = rm.decode_step(ref_cfg, ref_params, ref_cache,
                             jnp.asarray(tok))
    got, cache = tm.decode_step(cfg, params, cache, torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("name", sorted(ASSIGNED))
def test_serve_main_runs_on_the_cpu(name, capsys):
    rate = serve.main(["--arch", name, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "6", "--gen", "4", "--ctx", "16"])
    assert rate > 0
    out = capsys.readouterr().out
    assert f"[serve] {name}-smoke: batch=2" in out and "(CPU)" in out
    assert "sample continuation" in out


def test_serve_main_defaults_to_the_gpu_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--gen", "1", "--prompt-len", "1"])
