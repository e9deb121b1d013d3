"""The SSD scan in the PyTorch port against the reference, on the CPU.

* The plain forward (``ssd_scan_fwd_plain``, what the forward kernel is
  held against on the card) against the reference's oracle
  (``repro.kernels.ref.ssd_ref``, 2e-5) and its Pallas kernel run in
  interpret mode (the reference's own 3e-4), at the reference's kernel
  test shapes (``tests/test_kernels.py``) and at the mamba2 family's
  shape (H 64, P 8, G 1, N 16, chunk 4, S 12 and 16).  It is also held
  at 2e-5 against the same scan in float64.  At S = 256 the reference's
  own float32 result strays from the float64 scan at a few elements by
  more than half that tolerance; the 2e-5 comparison with ``ssd_ref``
  covers every element where ``ssd_ref`` is within half the tolerance of
  the float64 scan, and the test prints how many are left out (at most
  0.1 %) and how far ``ssd_ref`` itself is from the float64 scan.
* The plain forward against the literal per-token recurrence and
  against itself at another chunk size (the chunked form is exact).
* The plain backward (``ssd_scan_bwd_plain``) and ``ops.ssd``'s autograd
  against ``jax.vjp`` of the reference's ``ssd_reference`` (vmapped over
  parameter copies for a per-copy A of shape (copies, H)) and against
  torch autograd of the plain forward, 1e-4.
* The wrappers refuse what they do not take, on the CPU too; the
  backward in bf16 (dt float32) computes there, each gradient in its
  input's type, within 2e-2 of ``jax.vjp`` of the reference in bf16."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as ref_kernels
from repro.kernels.ssd_scan import ssd_scan as ref_ssd_scan
from repro.models.mamba2 import ssd_reference as ref_ssd_reference

from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ks
from repro_torch.kernels.ref import ssd_ref
from repro_torch.models.mamba2 import ssd_reference

SHAPES = [  # (B, S, H, P, G, N, chunk)
    (2, 128, 4, 32, 2, 16, 32),
    (1, 64, 2, 64, 1, 32, 16),
    (2, 256, 8, 32, 4, 64, 64),
    (1, 128, 4, 32, 4, 16, 128),     # single chunk
    (1, 16, 64, 8, 1, 16, 4),        # the mamba2 family's shape
    (1, 12, 64, 8, 1, 16, 4),
]


def _inputs(b, s, h, p, g, n, copies=1, seed=0):
    """x, dt (softplus of a normal), A (copies, H) negative, Bm, Cm as the
    reference's kernel tests draw them, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.logaddexp(rng.normal(size=(b, s, h)), 0).astype(np.float32)
    A = (-np.exp(rng.normal(size=(copies, h)) * 0.3)).astype(np.float32)
    Bm = (rng.normal(size=(b, s, g, n)) * 0.5).astype(np.float32)
    Cm = (rng.normal(size=(b, s, g, n)) * 0.5).astype(np.float32)
    return x, dt, A, Bm, Cm


def _parity(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    return float(np.abs(got - want).max())


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SHAPES)
def test_plain_forward_matches_reference_oracle_and_pallas_interpret(
        b, s, h, p, g, n, chunk):
    x, dt, A, Bm, Cm = _inputs(b, s, h, p, g, n)
    args = tuple(map(torch.from_numpy, (x, dt, A[0], Bm, Cm)))
    got = ks.ssd_scan_fwd_plain(*args, chunk=chunk)
    exact = ks.ssd_scan_fwd_plain(*(a.double() for a in args),
                                  chunk=chunk).numpy()
    err_exact = _parity(got, exact, 2e-5)
    ins = tuple(map(jnp.asarray, (x, dt, A[0], Bm, Cm)))
    want = np.asarray(ref_kernels.ssd_ref(*ins, chunk=chunk))
    ref_sound = np.abs(want - exact) <= 1e-5 + 1e-5 * np.abs(exact)
    assert ref_sound.mean() > 0.999
    err_ref = _parity(got.numpy()[ref_sound], want[ref_sound], 2e-5)
    err_kernel = _parity(got, ref_ssd_scan(*ins, chunk=chunk,
                                           interpret=True), 3e-4)
    assert torch.equal(ssd_ref(*args, chunk=chunk), got)
    print(f"PARITY ssd fwd plain B={b} S={s} H={h} P={p} G={g} N={n} "
          f"chunk={chunk}: vs float64 scan max_abs_err={err_exact:.3g} "
          f"tol=2e-5; vs ssd_ref max_abs_err={err_ref:.3g} tol=2e-5 "
          f"(all-element max {float(np.abs(got.numpy() - want).max()):.3g};"
          f" {int((~ref_sound).sum())} elements where ssd_ref, itself "
          f"{float(np.abs(want - exact).max()):.3g} from the float64 scan, "
          f"is beyond 1e-5 of it); vs pallas interpret "
          f"max_abs_err={err_kernel:.3g} tol=3e-4")


def _recurrence(x, dt, A, Bm, Cm):
    """The literal per-token recurrence in float64: h_t = exp(dt_t A)
    h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t."""
    b, s, h, p = x.shape
    rep = h // Bm.shape[2]
    state = np.zeros((b, h, p, Bm.shape[3]))
    ys = []
    for t in range(s):
        decay = np.exp(dt[:, t] * A)
        bt = np.repeat(Bm[:, t], rep, axis=1)
        ct = np.repeat(Cm[:, t], rep, axis=1)
        state = (state * decay[:, :, None, None] + dt[:, t, :, None, None]
                 * x[:, t, :, :, None] * bt[:, :, None, :])
        ys.append(np.einsum("bhpn,bhn->bhp", state, ct))
    return np.stack(ys, axis=1)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [(1, 64, 2, 8, 1, 4, 16),
                                               (2, 16, 64, 8, 1, 16, 4)])
def test_plain_forward_matches_recurrence_and_other_chunks(b, s, h, p, g, n,
                                                           chunk):
    x, dt, A, Bm, Cm = _inputs(b, s, h, p, g, n, seed=3)
    args = tuple(map(torch.from_numpy, (x, dt, A[0], Bm, Cm)))
    got = ks.ssd_scan_fwd_plain(*args, chunk=chunk)
    err_seq = _parity(got, _recurrence(*(a.astype(np.float64) for a in
                                         (x, dt, A[0], Bm, Cm))), 2e-5)
    err_chunk = _parity(got, ks.ssd_scan_fwd_plain(*args, chunk=s), 2e-5)
    print(f"PARITY ssd fwd plain S={s} chunk={chunk}: vs per-token "
          f"recurrence max_abs_err={err_seq:.3g}, vs chunk={s} "
          f"max_abs_err={err_chunk:.3g} tol=2e-5")


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,copies", [
    (2, 32, 4, 16, 2, 8, 8, 1),
    (4, 16, 64, 8, 1, 16, 4, 2),           # the family shape, per-copy A
    (6, 24, 4, 8, 2, 16, 8, 3),
    (2, 64, 2, 32, 1, 32, 16, 2),
])
def test_plain_backward_matches_jax_vjp_and_torch_autograd(b, s, h, p, g, n,
                                                           chunk, copies):
    x, dt, A, Bm, Cm = _inputs(b, s, h, p, g, n, copies=copies, seed=b + s)
    dy = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)

    def per_copy(t):
        return jnp.asarray(t).reshape((copies, b // copies) + t.shape[1:])

    def ref_y(x_, dt_, A_, B_, C_):     # the reference vmapped over copies
        return jax.vmap(lambda *a: ref_ssd_reference(*a, chunk)[0])(
            x_, dt_, A_, B_, C_)

    _, vjp = jax.vjp(ref_y, *map(per_copy, (x, dt)), jnp.asarray(A),
                     *map(per_copy, (Bm, Cm)))
    want = [np.asarray(w).reshape(a.shape) for w, a in
            zip(vjp(per_copy(dy)), (x, dt, A, Bm, Cm))]

    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, Bm,
                                                            Cm)]
    got = torch.autograd.grad(ops.ssd(*leaves, chunk=chunk), leaves,
                              torch.from_numpy(dy))
    auto = torch.autograd.grad(ssd_reference(*leaves, chunk)[0], leaves,
                               torch.from_numpy(dy))
    plain = ks.ssd_scan_bwd_plain(*map(torch.from_numpy, (x, dt, A, Bm, Cm,
                                                          dy)), chunk=chunk)
    errs = []
    for gr, pl, au, w in zip(got, plain, auto, want):
        errs.append(_parity(gr, w, 1e-4))
        errs.append(_parity(pl, w, 1e-4))
        errs.append(_parity(gr, au, 1e-4))
    assert got[2].shape == (copies, h)
    print(f"PARITY ssd bwd plain B={b} S={s} H={h} P={p} G={g} N={n} "
          f"chunk={chunk} copies={copies}: vs jax.vjp and torch autograd "
          f"max_abs_err={max(errs):.3g} tol=1e-4")


def test_wrappers_refuse_what_they_do_not_take_on_the_cpu():
    x, dt, A, Bm, Cm = map(torch.from_numpy, _inputs(2, 12, 4, 8, 2, 16))
    with pytest.raises(ValueError):                  # S % chunk
        ks.ssd_scan_fwd(x, dt, A[0], Bm, Cm, chunk=8)
    with pytest.raises(ValueError):                  # 3 copies of A, B = 2
        ks.ssd_scan_fwd(x, dt, A.repeat(3, 1), Bm, Cm, chunk=4)
    with pytest.raises(ValueError):                  # H % G
        ks.ssd_scan_fwd(x, dt, A[0], Bm[:, :, :1].repeat(1, 1, 3, 1),
                        Cm[:, :, :1].repeat(1, 1, 3, 1), chunk=4)
    # the bf16 backward (x, Bm, Cm, dy in bf16, dt in float32) computes on
    # the CPU and matches jax.vjp of the reference's scan in bf16: each
    # gradient in its input's type, within bf16's 2e-2
    bx, bbm, bcm, bdy = (t.bfloat16() for t in (x, Bm, Cm, x.flip(1)))
    got = ks.ssd_scan_bwd(bx, dt, A[0], bbm, bcm, bdy, chunk=4)
    _, vjp = jax.vjp(lambda *a: ref_ssd_reference(*a, 4)[0],
                     *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                       if t.dtype == torch.bfloat16 else jnp.asarray(
                           t.numpy()) for t in (bx, dt, A[0], bbm, bcm)))
    want = vjp(jnp.asarray(bdy.float().numpy()).astype(jnp.bfloat16))
    for name, gr, w, like in zip(("dx", "ddt", "dA", "dBm", "dCm"), got,
                                 want, (bx, dt, A[0], bbm, bcm)):
        assert gr.dtype == like.dtype and gr.shape == like.shape, name
        w = np.asarray(w.astype(jnp.float32))
        scale = max(1.0, float(np.abs(w).max()))
        err = float(np.abs(gr.float().numpy() - w).max())
        assert err <= 2e-2 * scale, (name, err, scale)
    y = ks.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=4)
    assert y.shape == x.shape
    assert ks.ssd_scan_fwd.launches == ks.ssd_scan_bwd.launches == 0


def test_token_stride_reads_channel_slices():
    """x, Bm and Cm as slices of one (B, S, CH) tensor (the conv output)
    take their token stride; a transposed tensor is refused."""
    conv = torch.randn(3, 8, 4 * 8 + 2 * 16)
    xs = conv[..., :32].reshape(3, 8, 4, 8)
    bm = conv[..., 32:48].reshape(3, 8, 1, 16)
    assert ks._token_stride("t", "x", xs) == 64
    assert ks._token_stride("t", "Bm", bm) == 64
    assert ks._token_stride("t", "x", xs.contiguous()) == 32
    with pytest.raises(ValueError):
        ks._token_stride("t", "x", xs.transpose(2, 3))
