"""Attention in the PyTorch port against the reference, on the CPU.

* The plain forward (``flash_attention_fwd_plain``, what the forward
  kernel is held against on the card) against the reference's Pallas
  kernel run in interpret mode, at S ∈ {16, 64} with blocks 16 and 64:
  causal, sliding window and non-causal; and against the reference's
  ``ops.flash_attention`` with grouped-query heads.  2e-5.
* The plain backward (``flash_attention_bwd_plain``, from the saved row
  log-sum-exp) and ``ops.flash_attention``'s autograd on the CPU against
  ``jax.vjp`` of the reference's CPU path (``attention_ref`` after its
  GQA expansion) and against torch autograd of the plain forward.  2e-5.
* The ``attend`` switch: ``pallas`` and ``naive`` agree.

The reference's kernel asserts ``S % block == 0``; the port's kernels
take any S, so a ragged S = 20 is held against the oracle alone."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.flash_attention import flash_attention_bhsd

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models.attention import attend

TOL = 2e-5


def _parity(name, got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    return float(np.abs(got - want).max())


def _inputs(b, s, hq, hkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, s, h, hd)).astype(np.float32)
                 for h in (hq, hkv, hkv))


MASKS = [(True, None), (True, 8), (False, None), (False, 12)]


@pytest.mark.parametrize("s,block", [(16, 16), (64, 16), (64, 64)])
@pytest.mark.parametrize("causal,window", MASKS)
def test_plain_forward_matches_pallas_kernel_interpret(s, block, causal,
                                                       window):
    q, k, v = _inputs(2, s, 2, 2, 16, seed=s)
    bhsd = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3).reshape(  # noqa
        4, s, 16))
    want = flash_attention_bhsd(bhsd(q), bhsd(k), bhsd(v), causal=causal,
                                window=window, block_q=block,
                                block_k=block, interpret=True)
    o, lse = fa.flash_attention_fwd_plain(*map(torch.from_numpy, (q, k, v)),
                                          causal=causal, window=window)
    got = o.numpy().transpose(0, 2, 1, 3).reshape(4, s, 16)
    err = _parity("fwd", got, want)
    assert lse.shape == (2, 2, s) and torch.isfinite(lse).all()
    print(f"PARITY attention fwd plain vs pallas interpret S={s} "
          f"block={block} causal={causal} window={window}: "
          f"max_abs_err={err:.3g} tol={TOL}")


GQA = [(2, 16, 4, 2, 16, True, None), (1, 32, 4, 1, 8, True, 8),
       (2, 20, 6, 3, 8, False, None), (2, 16, 4, 4, 16, False, 5)]


@pytest.mark.parametrize("b,s,hq,hkv,hd,causal,window", GQA)
def test_forward_and_backward_match_reference_ops(b, s, hq, hkv, hd, causal,
                                                  window):
    q, k, v = _inputs(b, s, hq, hkv, hd, seed=hq + s)
    do = np.random.default_rng(7).normal(size=q.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda *a: ref_ops.flash_attention(
        *a, causal=causal, window=window), *map(jnp.asarray, (q, k, v)))
    want_grads = vjp(jnp.asarray(do))

    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = ops.flash_attention(*leaves, causal=causal, window=window)
    got_grads = torch.autograd.grad(got, leaves, torch.from_numpy(do))
    auto = torch.autograd.grad(fa.flash_attention_fwd_plain(
        *leaves, causal=causal, window=window)[0], leaves,
        torch.from_numpy(do))
    o, lse = fa.flash_attention_fwd_plain(*map(torch.from_numpy, (q, k, v)),
                                          causal=causal, window=window)
    plain = fa.flash_attention_bwd_plain(
        *map(torch.from_numpy, (q, k, v)), o, lse, torch.from_numpy(do),
        causal=causal, window=window)
    errs = [_parity("fwd", got.detach(), want)]
    for g, p, a, w in zip(got_grads, plain, auto, want_grads):
        errs.append(_parity("bwd vs jax.vjp", g, w))
        errs.append(_parity("bwd plain vs jax.vjp", p, w))
        errs.append(_parity("bwd vs torch autograd", g, a))
    print(f"PARITY attention fwd+bwd GQA {hq}/{hkv} S={s} causal={causal} "
          f"window={window}: max_abs_err={max(errs):.3g} tol={TOL}")


def test_attend_switch_pallas_equals_naive():
    """On the CPU the kernel route is the plain forward, bitwise naive;
    flashjnp, blockwise and auto (the reference's variants) fall back to
    naive at S 24 under their blocks, bitwise; an unknown impl raises."""
    q, k, v = map(torch.from_numpy, _inputs(2, 24, 4, 2, 8, seed=3))
    a = attend(q, k, v, window=6, impl="pallas")
    b = attend(q, k, v, window=6, impl="naive")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    for impl in ("flashjnp", "blockwise", "auto"):
        torch.testing.assert_close(attend(q, k, v, window=6, impl=impl), b,
                                   rtol=0, atol=0)
    with pytest.raises(ValueError):
        attend(q, k, v, impl="mosaic")


def test_wrappers_check_their_inputs_on_the_cpu():
    q, k, v = map(torch.from_numpy, _inputs(1, 8, 4, 3, 8))
    with pytest.raises(ValueError):                  # 4 heads over 3
        fa.flash_attention_fwd(q, k, v)
    q, k, v = map(torch.from_numpy, _inputs(1, 8, 4, 2, 8))
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, k, v, window=0)
    o, lse = fa.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError):                  # lse of the wrong shape
        fa.flash_attention_bwd_dq(q, k, v, o, lse[:, :2], q)
    assert fa.flash_attention_fwd.launches == 0      # plain on the CPU
