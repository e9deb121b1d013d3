"""Flash decode in the PyTorch port against the reference, on the CPU.

* The plain version (``flash_decode_plain``, what the kernel is held
  against on the card), the kernel wrapper on a CPU tensor and
  ``ops.flash_decode`` against the reference's ``decode_attention_ref``
  and its Pallas kernel run in interpret mode, on the reference's
  kernel-test grid: (ctx, block_s, pos) ∈ {(256, 64, 100), (512, 128,
  511), (128, 128, 0)} × {float32, bfloat16}.  2e-5 / 2e-2.
* The ring buffer (``window``): pos 1000 ≫ ctx, and pos < ctx.
* The GQA wrapper at (B 2, ctx 128, Hq 8, Hkv 2, hd 64) against the
  reference's ``ops.flash_decode`` (its jnp path and its kernel in
  interpret mode); the port resolves the groups by index.
* A ctx that is not a multiple of the reference's block (the port's
  kernel takes any ctx; the reference's kernel asserts it), against the
  oracle alone; and ``pos`` as a device tensor."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels.flash_decode import flash_decode_bhd

from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops
from repro_torch.kernels import ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _parity(got, want, tol):
    got = np.asarray(torch.as_tensor(got).float() if isinstance(
        got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    return float(np.abs(got - want).max())


def _bhd(bh, ctx, hd, seed):
    """q (BH, 1, hd), k, v (BH, ctx, hd) as numpy float32."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(bh, 1, hd)).astype(np.float32),
            rng.normal(size=(bh, ctx, hd)).astype(np.float32),
            rng.normal(size=(bh, ctx, hd)).astype(np.float32))


def _both(arrays, dtype):
    """The same values as jax arrays and as torch tensors of ``dtype``
    (bfloat16 rounds to nearest even in both)."""
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _model_layout(q, k, v):
    """(BH, 1, hd) / (BH, ctx, hd) → the port's (B, 1, Hq, hd) and (B, ctx,
    Hkv, hd) with B = BH and one head (g = 1)."""
    return q[:, :, None, :], k[:, :, None, :], v[:, :, None, :]


@pytest.mark.parametrize("ctx,block_s,pos", [(256, 64, 100), (512, 128, 511),
                                             (128, 128, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_oracle_and_pallas_kernel_interpret(ctx, block_s, pos,
                                                          dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_bhd(4, ctx, 64, seed=ctx + pos),
                                       dtype)
    kernel = flash_decode_bhd(jq, jk, jv, pos, block_s=block_s,
                              interpret=True)
    oracle = ref_ref.decode_attention_ref(jq, jk, jv, pos)
    mq, mk, mv = _model_layout(tq, tk, tv)
    tol = TOL[dtype]
    errs = []
    for got in (fd.flash_decode_plain(mq, mk, mv, pos)[:, :, 0],
                fd.flash_decode(mq, mk, mv, pos)[:, :, 0],
                ops.flash_decode(mq, mk, mv, torch.tensor(pos))[:, :, 0],
                ref.decode_attention_ref(tq, tk, tv, pos)):
        assert got.dtype == tq.dtype
        errs += [_parity(got, kernel, tol), _parity(got, oracle, tol)]
    assert fd.flash_decode.launches == 0             # plain on the CPU
    print(f"PARITY flash_decode plain vs decode_attention_ref and pallas "
          f"interpret ctx={ctx} block={block_s} pos={pos} {dtype}: "
          f"max_abs_err={max(errs):.3g} tol={tol}")


@pytest.mark.parametrize("ctx,window,pos,block_s", [
    (128, 128, 1000, 64),        # the reference's ring-buffer test
    (128, 64, 50, 32),           # pos < ctx: slots past pos never written
    (64, 64, 63, 64),            # the ring's last slot, about to wrap
    (128, 48, 300, 128)])        # window shorter than the ring
def test_ring_buffer_window_matches_reference(ctx, window, pos, block_s):
    (jq, jk, jv), (tq, tk, tv) = _both(_bhd(2, ctx, 64, seed=pos),
                                       "float32")
    kernel = flash_decode_bhd(jq, jk, jv, pos, window=window,
                              block_s=block_s, interpret=True)
    oracle = ref_ref.decode_attention_ref(jq, jk, jv, pos, window=window)
    got = fd.flash_decode(*_model_layout(tq, tk, tv), torch.tensor(
        pos, dtype=torch.int32), window=window)[:, :, 0]
    err = max(_parity(got, kernel, 2e-5), _parity(got, oracle, 2e-5))
    print(f"PARITY flash_decode ring buffer ctx={ctx} window={window} "
          f"pos={pos}: max_abs_err={err:.3g} tol=2e-05")


def test_gqa_wrapper_matches_reference_ops():
    b, ctx, hq, hkv, hd, pos = 2, 128, 8, 2, 64, 64
    rng = np.random.default_rng(11)
    q = rng.normal(size=(b, 1, hq, hd)).astype(np.float32)
    k = rng.normal(size=(b, ctx, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, ctx, hkv, hd)).astype(np.float32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_ref = ref_ops.flash_decode(jq, jk, jv, pos)
    want_kernel = ref_ops.flash_decode(jq, jk, jv, pos, interpret=True,
                                       block_s=64)
    got = ops.flash_decode(*map(torch.from_numpy, (q, k, v)),
                           torch.tensor(pos, dtype=torch.int32))
    assert got.shape == (b, 1, hq, hd)
    err = max(_parity(got, want_ref, 2e-5), _parity(got, want_kernel, 2e-5))
    print(f"PARITY flash_decode GQA {hq}/{hkv} vs reference ops: "
          f"max_abs_err={err:.3g} tol=2e-05")


@pytest.mark.parametrize("ctx,pos,window", [(100, 99, None), (100, 40, None),
                                            (100, 250, 100), (37, 30, 16)])
def test_ctx_not_a_multiple_of_the_block(ctx, pos, window):
    (jq, jk, jv), (tq, tk, tv) = _both(_bhd(3, ctx, 128, seed=ctx),
                                       "float32")
    oracle = ref_ref.decode_attention_ref(jq, jk, jv, pos, window=window)
    got = fd.flash_decode(*_model_layout(tq, tk, tv), pos,
                          window=window)[:, :, 0]
    err = _parity(got, oracle, 2e-5)
    print(f"PARITY flash_decode ragged ctx={ctx} pos={pos} window={window}: "
          f"max_abs_err={err:.3g} tol=2e-05")


def test_visible_slots_floor_the_ring_modulo():
    """Slots past pos in a ring that has not wrapped hold no key: the
    floored modulo puts them at negative positions (a truncating modulo
    would make them visible)."""
    vis = fd.visible_slots(torch.tensor(5, dtype=torch.int32), 8, 8, "cpu")
    assert vis.tolist() == [True] * 6 + [False] * 2
    vis = fd.visible_slots(torch.tensor(13, dtype=torch.int32), 8, 4, "cpu")
    # positions 10..13 live in slots 2..5
    assert vis.tolist() == [False, False, True, True, True, True, False,
                            False]
    assert fd.visible_slots(3, 8, None, "cpu").tolist() == [True] * 4 + [
        False] * 4


def test_wrapper_checks_its_inputs_on_the_cpu():
    q = torch.zeros((2, 1, 6, 64))
    k = torch.zeros((2, 16, 4, 64))
    with pytest.raises(ValueError):                  # 6 heads over 4
        fd.flash_decode(q, k, k, 0)
    with pytest.raises(ValueError):                  # two query tokens
        fd.flash_decode(torch.zeros((2, 2, 8, 64)), k, k, 0)
    with pytest.raises(ValueError):
        fd.flash_decode(torch.zeros((2, 1, 8, 64)), k, k, 0, window=0)
    with pytest.raises(ValueError):                  # mixed dtypes
        fd.flash_decode(torch.zeros((2, 1, 8, 64)), k.bfloat16(), k, 0)
    with pytest.raises(ValueError):                  # pos of two elements
        fd.flash_decode(torch.zeros((2, 1, 8, 64)), k, k,
                        torch.tensor([1, 2]))
    assert fd.flash_decode.launches == 0
