"""Multi-head latent attention and the attention variants of the PyTorch
port (``repro_torch.models.attention``) against the reference's
``repro.models.attention``, on the CPU, with the reference's weights
carried across (a copy axis of 1 added), within 2e-5:

* ``mla_forward`` with and without q-LoRA (minicpm3-4b's and
  deepseek-v2-lite-16b's reduced MLA), its output and every gradient,
  under naive, blockwise (chunked) and flashjnp attention (S 32 under
  blocks of 8: chunks run; flashjnp's 512-key block does not divide S,
  so it falls back to chunks as the reference's);
* ``attend_chunked`` and ``attend_flashjnp`` on GQA inputs (group 2)
  causal, windowed and not causal, at blocks that divide S and that do
  not (the fallbacks), and MLA's head dims where the reference runs;
* 12 ``mla_decode`` steps against the reference's, outputs and the
  ``ckv`` cache, with a cache of 8 slots: steps 8-11 clamp to the last
  slot, as ``dynamic_update_slice`` does;
* the refusals of ROADMAP caveat C-ref-10: MLA's v head dim differs from
  q's, so the kernel route (``impl="pallas"``) and the flash double loop
  (when both blocks divide S) raise ``ValueError`` where the reference
  fails too."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import attention as ra

from repro_torch.configs import get_arch
from repro_torch.interop import params_from_numpy
from repro_torch.models import attention as ta
from repro_torch.tree import tree_leaves, tree_map

TOL = 2e-5
B, S, STEPS, CTX = 2, 32, 12, 8
MLA_ARCHS = ("minicpm3-4b", "deepseek-v2-lite-16b")     # q-LoRA, none


def _parity(name, got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=name)
    return float(np.abs(got - want).max())


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(reference config, port config, the reference's MLA weights as
    numpy, x (B, S, d)) at the reduced size."""
    ref_cfg, cfg = REF_ARCHS[name].reduced(), get_arch(name).reduced()
    params = jax.tree_util.tree_map(
        np.asarray, ra.mla_init(jax.random.key(11), ref_cfg, jnp.float32))
    x = np.random.default_rng(2).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)
    return ref_cfg, cfg, params, x


@functools.lru_cache(maxsize=None)
def _reference_forward(name, impl):
    ref_cfg, _, params, x = _setup(name)
    r = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)
    pos = jnp.arange(S)

    @jax.jit
    def run(p):
        def loss(p):
            out = ra.mla_forward(p, ref_cfg, jnp.asarray(x), pos, impl=impl)
            return jnp.sum(out * r), out
        (_, out), grads = jax.value_and_grad(loss, has_aux=True)(p)
        return out, grads

    return r, run(params)


@pytest.mark.parametrize("impl", ["naive", "blockwise", "flashjnp"])
@pytest.mark.parametrize("name", MLA_ARCHS)
def test_mla_forward_and_grads_match_the_reference(name, impl):
    _, cfg, ref_params, x = _setup(name)
    r, (want, want_grads) = _reference_forward(name, impl)
    assert ("w_dq" in ref_params) == bool(cfg.mla.q_lora_rank)
    params = tree_map(lambda t: t[None].requires_grad_(),
                      params_from_numpy(ref_params))
    out = ta.mla_forward(params, cfg, torch.from_numpy(x)[None], impl=impl,
                         block_q=8)
    grads = torch.autograd.grad((out * torch.from_numpy(r)).sum(),
                                tree_leaves(params))
    err = _parity("mla out", out[0].detach(), want)
    grad_err = max(_parity("grad", g[0], w) for g, w in zip(
        grads, jax.tree_util.tree_leaves(want_grads)))
    print(f"PARITY mla_forward {cfg.name} impl={impl}: out max_abs_err="
          f"{err:.3g}, grads {grad_err:.3g} tol={TOL}")


def _qkv(sq, hq, hkv, hd, hd_v=None, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, sq, hq, hd)).astype(np.float32),
            rng.normal(size=(B, sq, hkv, hd)).astype(np.float32),
            rng.normal(size=(B, sq, hkv, hd_v or hd)).astype(np.float32))


# (variant, S, blocks (block_q, block_k), causal, window, head dims (hd,
# hd_v)): blocks that divide S, that do not (the fallbacks), MLA's dims
VARIANTS = [
    ("chunked", 32, (8, None), True, None, (16, 16)),
    ("chunked", 32, (8, None), True, 5, (16, 16)),
    ("chunked", 32, (8, None), False, None, (16, 16)),
    ("chunked", 30, (8, None), True, None, (16, 16)),
    ("chunked", 32, (8, None), True, None, (48, 32)),
    ("flashjnp", 32, (8, 16), True, None, (16, 16)),
    ("flashjnp", 32, (8, 16), True, 5, (16, 16)),
    ("flashjnp", 32, (16, 8), False, None, (16, 16)),
    ("flashjnp", 32, (8, 12), True, None, (16, 16)),
    ("flashjnp", 32, (8, 12), True, None, (48, 32)),
    ("flashjnp", 1024, (256, 512), True, None, (16, 16)),
]


@pytest.mark.parametrize(
    "variant,s,blocks,causal,window,dims", VARIANTS,
    ids=[f"{v}-S{s}-b{b[0]}x{b[1]}-{'c' if c else 'nc'}-w{w}-hd{d[0]}"
         for v, s, b, c, w, d in VARIANTS])
def test_attention_variants_match_the_reference(variant, s, blocks, causal,
                                                window, dims):
    q, k, v = _qkv(s, 4, 2, *dims, seed=s)
    pos = np.arange(s)
    bq, bk = blocks
    kw = dict(causal=causal, window=window, block_q=bq)
    if variant == "flashjnp":
        kw["block_k"] = bk
    ref_fn = getattr(ra, f"attend_{variant}")
    want = ref_fn(*map(jnp.asarray, (q, k, v, pos, pos)), **kw)
    got = getattr(ta, f"attend_{variant}")(
        *map(torch.from_numpy, (q, k, v, pos, pos)), **kw)
    err = _parity(f"attend_{variant}", got, want)
    print(f"PARITY attend_{variant} S={s} blocks={blocks} causal={causal} "
          f"window={window} hd={dims}: max_abs_err={err:.3g} tol={TOL}")


@pytest.mark.parametrize("name", MLA_ARCHS)
def test_mla_decode_and_ckv_cache_match_the_reference(name):
    ref_cfg, cfg, ref_params, x = _setup(name)
    m = cfg.mla
    width = m.kv_lora_rank + m.qk_rope_head_dim
    ref_cache = jnp.zeros((B, CTX, width), jnp.float32)
    cache = torch.zeros((B, CTX, width))
    step = jax.jit(lambda p, xx, c, pos: ra.mla_decode(p, ref_cfg, xx, c,
                                                       pos))
    params = tree_map(lambda t: t[None], params_from_numpy(ref_params))
    err = cache_err = 0.0
    for t in range(STEPS):
        xt = x[:, t % S:t % S + 1]
        want, ref_cache = step(ref_params, jnp.asarray(xt), ref_cache,
                               jnp.asarray(t, jnp.int32))
        got = ta.mla_decode(params, cfg, torch.from_numpy(xt)[None], cache,
                            torch.tensor(t, dtype=torch.int32))
        err = max(err, _parity(f"mla_decode {t}", got[0], want))
        cache_err = max(cache_err, _parity(f"ckv {t}", cache, ref_cache))
    print(f"PARITY mla_decode {cfg.name} {STEPS} steps, ckv of {CTX} slots "
          f"(pos >= ctx clamps): out max_abs_err={err:.3g}, ckv "
          f"{cache_err:.3g} tol={TOL}")


@pytest.mark.parametrize("impl", ["pallas", "flashjnp"])
def test_mla_head_dims_refused_where_the_reference_fails(impl):
    """C-ref-10: q's head dim (nope + rope, 48) is not v's (32).  Under
    the kernel route, and under flashjnp once both blocks divide S (S 512
    at its default blocks), the reference fails on a reshape; the port
    raises ValueError naming the caveat."""
    s = 512 if impl == "flashjnp" else 16
    q, k, v = _qkv(s, 4, 4, 48, 32, seed=1)
    pos = np.arange(s)
    with pytest.raises((TypeError, ValueError)):
        ra.attend(*map(jnp.asarray, (q, k, v, pos, pos)), impl=impl)
    with pytest.raises(ValueError, match="C-ref-10"):
        ta.attend(*map(torch.from_numpy, (q, k, v, pos, pos)), impl=impl)
    # the other impls run MLA's dims, as the reference's do
    for other in ("naive", "auto", "blockwise"):
        got = ta.attend(*map(torch.from_numpy, (q, k, v, pos, pos)),
                        impl=other)
        want = ra.attend(*map(jnp.asarray, (q, k, v, pos, pos)), impl=other)
        _parity(f"attend {other}", got, want)
