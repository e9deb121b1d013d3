"""SBC in the PyTorch port against the reference.

* The plain versions of the port's ``sbc_stats`` / ``sbc_apply`` against
  the reference's Pallas kernels run in interpret mode.
* The port's exact-top-k ``sbc_compress`` against the reference's
  ``ops.sbc_compress(interpret=True)`` and ``sbc_tensor(exact=True)``.
* ``compress_dense`` with error feedback: the bisection threshold is
  bitwise the reference's, so identical inputs give identical keep masks;
  values agree to 2e-5 (the group sums are taken in another order).

Edge cases as in the reference's kernel tests: all-zero, tiny (k = 1),
and ties at the threshold.  On the CPU the wrappers run their plain
versions; the CUDA kernels are held against them on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compression import sbc as ref_sbc
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels.sbc import sbc_apply as ref_apply
from repro.kernels.sbc import sbc_stats as ref_stats

from repro_torch.compression import sbc
from repro_torch.kernels import ops, ref
from repro_torch.kernels.sbc import (sbc_apply, sbc_apply_plain, sbc_stats,
                                     sbc_stats_plain)

TOL = dict(rtol=2e-5, atol=2e-5)

EDGE = {
    "zeros": np.zeros(512, np.float32),
    "tiny": np.array([0.1, -5.0, 0.2], np.float32),
    "ties": np.array([2.0, -2.0, 2.0, -2.0, 1.0, -1.0, 0.5, 0.0],
                     np.float32),
}


def _segments(seed=0, s=5, n=700):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(s, n)) * np.linspace(0.1, 2.0, n)).astype(
        np.float32)
    x[1] = 0.0                                   # an all-zero segment
    x[2, ::7] = 1.5                              # ties at a threshold
    x[2, 3::7] = -1.5
    return x


def _pad(row, block):
    return np.pad(row, (0, (-len(row)) % block))


def test_plain_stats_and_apply_match_reference_kernels_interpret():
    x = _segments()
    thr = np.array([0.9, 0.0, 1.5, 3.0, 0.2], np.float32)
    stats = sbc_stats(torch.from_numpy(x), torch.from_numpy(thr)).numpy()
    scalars = np.stack([thr, np.linspace(0.5, 1.0, 5, dtype=np.float32),
                        -np.linspace(0.2, 0.7, 5, dtype=np.float32)], -1)
    scalars[3, 1] = 0.0                          # a dropped group
    out, res = sbc_apply(torch.from_numpy(x), torch.from_numpy(scalars))
    err = 0.0
    for i in range(len(x)):
        xp = jnp.asarray(_pad(x[i], 256))
        want = np.asarray(ref_stats(xp, jnp.asarray(thr[i:i + 1]),
                                    block=256, interpret=True))[0]
        np.testing.assert_array_equal(stats[i, 2:], want[2:])    # counts
        np.testing.assert_allclose(stats[i, :2], want[:2], rtol=1e-6)
        err = max(err, float(np.abs(stats[i, :2] - want[:2]).max()))
        want_out = np.asarray(ref_apply(xp, jnp.asarray(scalars[i]),
                                        block=256, interpret=True))
        np.testing.assert_array_equal(out[i].numpy(),
                                      want_out[:x.shape[1]])
    np.testing.assert_array_equal(res.numpy(), x - out.numpy())
    print(f"PARITY sbc_stats plain vs reference interpret: sums "
          f"max_abs_err={err:.3g} rtol=1e-6, counts equal; sbc_apply equal")


@pytest.mark.parametrize("name", sorted(EDGE))
def test_edge_cases_match_reference(name):
    g = EDGE[name]
    ratio = 0.25 if name == "ties" else 0.01
    want = np.asarray(ref_ref.sbc_ref(jnp.asarray(g), ratio))
    np.testing.assert_array_equal(
        np.asarray(ref_ops.sbc_compress(jnp.asarray(g), ratio, block=8,
                                        interpret=True)), want)
    np.testing.assert_allclose(
        ops.sbc_compress(torch.from_numpy(g), ratio).numpy(), want,
        atol=1e-7)
    np.testing.assert_allclose(
        ref.sbc_ref(torch.from_numpy(g), ratio).numpy(), want, atol=1e-7)


@pytest.mark.parametrize("n,ratio,seed", [(32, 0.1, 0), (333, 0.03, 1),
                                          (2048, 0.005, 2), (1000, 0.05, 3)])
def test_exact_compress_matches_reference_composition(n, ratio, seed):
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=n) * np.linspace(0.1, 2.0, n)).astype(np.float32)
    want = np.asarray(ref_ops.sbc_compress(jnp.asarray(g), ratio, block=256,
                                           interpret=True))
    got = ops.sbc_compress(torch.from_numpy(g), ratio).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    print(f"PARITY sbc_compress n={n}: max_abs_err="
          f"{float(np.abs(got - want).max()):.3g} tol=2e-5")
    np.testing.assert_allclose(
        sbc.sbc_tensor(torch.from_numpy(g), ratio, exact=True).numpy(),
        np.asarray(ref_sbc.sbc_tensor(jnp.asarray(g), ratio, exact=True)),
        **TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bisection_threshold_is_bitwise_the_reference(seed):
    x = _segments(seed)
    mag = np.abs(x)
    for k in (1, 4, 35):
        got = sbc.topk_threshold_bisect(torch.from_numpy(mag), k).numpy()
        want = np.stack([np.asarray(ref_sbc.topk_threshold_bisect(
            jnp.asarray(m), k)) for m in mag])
        np.testing.assert_array_equal(got, want)


def _tree(rng, lead=()):
    shapes = [(32, 16), (16,), (16, 10), (10,)]
    return [{"w": rng.normal(size=lead + shapes[i]).astype(np.float32),
             "b": rng.normal(size=lead + shapes[i + 1]).astype(np.float32)}
            for i in (0, 2)]


def _to_torch(tree):
    return [{k: torch.from_numpy(v) for k, v in layer.items()}
            for layer in tree]


@pytest.mark.parametrize("ratio", [0.005, 0.05])
def test_compress_dense_error_feedback_matches_reference(ratio):
    rng = np.random.default_rng(4)
    grads, residual = _tree(rng, (2, 3)), _tree(rng, (2, 3))
    for layer in residual:
        for k in layer:
            layer[k] *= 0.1
    approx, new_res = sbc.compress_dense(_to_torch(grads), ratio,
                                         _to_torch(residual), batch_dims=2)
    step = jax.vmap(jax.vmap(lambda g, r: ref_sbc.compress_dense(g, ratio,
                                                                 r)))
    ref_approx, ref_res = step(grads, residual)
    err = 0.0
    for got, want in ((approx, ref_approx), (new_res, ref_res)):
        for a, b in zip(jax.tree_util.tree_leaves(
                [{k: v.numpy() for k, v in l.items()} for l in got]),
                jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a, np.asarray(b), **TOL)
            err = max(err, float(np.abs(a - np.asarray(b)).max()))
    print(f"PARITY compress_dense ratio={ratio}: max_abs_err={err:.3g} "
          f"tol=2e-5, keep masks equal")
    for a, b in zip(jax.tree_util.tree_leaves(
            [{k: v.numpy() for k, v in l.items()} for l in approx]),
            jax.tree_util.tree_leaves(ref_approx)):
        np.testing.assert_array_equal(a != 0, np.asarray(b) != 0)
    # one upload alone equals its segment in the batched call
    solo, _ = sbc.compress_dense(
        _to_torch([{k: v[1, 2] for k, v in l.items()} for l in grads]),
        ratio,
        _to_torch([{k: v[1, 2] for k, v in l.items()} for l in residual]))
    for a, b in zip(solo, approx):
        for k in a:
            assert torch.equal(a[k], b[k][1, 2])


def test_compress_dense_equals_bisection_oracle_per_upload():
    rng = np.random.default_rng(5)
    grads = _tree(rng, (4,))
    approx, res = sbc.compress_dense(_to_torch(grads), 0.05, batch_dims=1)
    for layer, out_layer, res_layer in zip(grads, approx, res):
        for k in layer:
            for d in range(4):
                want = sbc.sbc_tensor(torch.from_numpy(layer[k][d]), 0.05,
                                      exact=False)
                np.testing.assert_array_equal(
                    out_layer[k][d].numpy() != 0, want.numpy() != 0)
                np.testing.assert_allclose(out_layer[k][d].numpy(),
                                           want.numpy(), **TOL)
            np.testing.assert_array_equal(
                res_layer[k].numpy(), layer[k] - out_layer[k].numpy())


def test_wrappers_take_the_plain_version_on_cpu_and_check_operands():
    x = torch.from_numpy(_segments())
    thr = torch.full((5,), 0.5)
    before = (sbc_stats.launches, sbc_apply.launches)
    assert torch.equal(sbc_stats(x, thr), sbc_stats_plain(x, thr))
    sc = torch.stack([thr, thr, -thr], -1)
    for a, b in zip(sbc_apply(x, sc), sbc_apply_plain(x, sc)):
        assert torch.equal(a, b)
    assert (sbc_stats.launches, sbc_apply.launches) == before
    with pytest.raises(ValueError):
        sbc_stats(x.double(), thr)
    with pytest.raises(ValueError):
        sbc_stats(x, thr[:3])
    with pytest.raises(ValueError):
        sbc_apply(x.t(), sc)
    with pytest.raises(ValueError):
        sbc_apply(x, torch.stack([thr, thr, -thr], 0).t())   # not contiguous
    with pytest.raises(ValueError):
        sbc_stats(x.to("meta"), thr.to("meta"))


def test_compressed_bits_is_the_papers_payload_model():
    assert sbc.compressed_bits(855_050) == ref_sbc.compressed_bits(855_050)
    assert [sbc.n_keep(n, 0.005) for n in
            (786_432, 256, 65_536, 256, 2_560, 10)] == [3932, 1, 328, 1,
                                                       13, 1]
