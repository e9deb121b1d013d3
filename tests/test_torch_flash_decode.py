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
  oracle alone; and ``pos`` as a device tensor.
* A ring cut into parts, as decode against a ring split over cards
  runs it (``off`` and ``ring``): each part's output and log-sum-exp
  merged by the latter give the whole ring's output within 2e-5 (bf16:
  2e-2) and the reference oracle's, at a ring of 64 under windows 64 and
  24, pos 10 (parts past it empty), 63, 64 (the wrap) and 200, in 2 and
  4 parts; ``off`` 0 with the part's own length is bitwise the call
  without them.
* The CUDA kernel's partition, mirrored in float32 (:func:`split_decode`):
  32-slot tiles in contiguous runs, each an online softmax, merged in run
  order, with empty runs.  It is held against the oracle and the Pallas
  kernel in interpret mode at the cases above, at the tile boundaries
  (pos 31, 32, 33) and where pos leaves runs empty.  2e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels.flash_decode import flash_decode_bhd

from repro_torch.kernels import build
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops
from repro_torch.kernels import ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TILE = 32           # slots of a tile (csrc kTile)
NEG_INF = -1e30


def split_decode(q, k, v, pos: int, window, splits: int):
    """o (B, 1, Hq, hd) by ``csrc/flash_decode.cu``'s partition, in float32:
    the visible slots 0 .. min(pos, ctx - 1) cut into 32-slot tiles and the
    tiles into ``splits`` contiguous runs of ceil(tiles / splits), each run
    an online softmax over its tiles (scores scaled by 1/sqrt(hd), masked
    slots no weight), then every run's (acc, m, l) merged in run order:
    M = max m_s, L = sum l_s e^(m_s - M), o = sum acc_s e^(m_s - M) /
    max(L, 1e-30).  A run with no visible tile keeps m = -1e30, l = 0."""
    b, _, hq, hd = q.shape
    ctx, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.float().reshape(b, hkv, g, hd)
    kf, vf = k.float(), v.float()
    vis = fd.visible_slots(pos, ctx, window, "cpu")
    n_valid = max(0, min(pos + 1, ctx))
    n_tiles = -(-n_valid // TILE)
    per = -(-n_tiles // splits)
    runs = []
    for r in range(splits):
        m = torch.full((b, hkv, g, 1), NEG_INF)
        l = torch.zeros((b, hkv, g, 1))
        acc = torch.zeros((b, hkv, g, hd))
        begin = min(r * per, n_tiles)
        for t in range(begin, min(begin + per, n_tiles)):
            sl = slice(t * TILE, min((t + 1) * TILE, n_valid))
            s = torch.einsum("bkgd,bskd->bkgs", qg, kf[:, sl])
            s = torch.where(vis[sl], s * (1.0 / hd ** 0.5),
                            torch.tensor(NEG_INF))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.where(vis[sl], torch.exp(s - m_new), torch.tensor(0.0))
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + torch.einsum("bkgs,bskd->bkgd", p, vf[:, sl])
            m = m_new
        if begin == n_tiles:                         # an empty run
            assert bool((m == NEG_INF).all()) and not l.any()
        runs.append((acc, m, l))
    mx = torch.full((b, hkv, g, 1), NEG_INF)
    for _, m, _ in runs:
        mx = torch.maximum(mx, m)
    num = torch.zeros((b, hkv, g, hd))
    den = torch.zeros((b, hkv, g, 1))
    for acc, m, l in runs:                           # run order
        w = torch.exp(m - mx)
        num = num + acc * w
        den = den + l * w
    o = num / torch.clamp(den, min=1e-30)
    return o.reshape(b, 1, hq, hd).to(q.dtype)


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


RING, RING_POS = 64, (10, 63, 64, 200)


def merge_parts(parts):
    """The parts' (o (B, 1, Hq, hd), lse (B, Hq)) merged by their
    log-sum-exp, as decode against a cache split over cards merges
    them."""
    lse = torch.stack([lse for _, lse in parts])
    w = torch.exp(lse - lse.amax(0))                       # (parts, B, Hq)
    num = sum(o.float() * wi[:, None, :, None] for (o, _), wi in zip(parts, w))
    return (num / w.sum(0)[:, None, :, None]).to(parts[0][0].dtype)


def _whole_ring(q, k, v, pos, window):
    """The plain version's arithmetic with no ``off`` or ``ring``, written
    out (the ring's slot i holds position pos - ((pos - i) mod ctx))."""
    b, _, hq, hd = q.shape
    ctx, hkv = k.shape[1], k.shape[2]
    idx = torch.arange(ctx)
    key_pos = pos - ((pos - idx) % ctx)
    vis = (key_pos >= 0) & (key_pos <= pos) & (key_pos > pos - window)
    qg = q.float().reshape(b, hkv, hq // hkv, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * (1.0 / hd ** 0.5)
    s = torch.where(vis, s, NEG_INF)
    o = torch.einsum("bkgs,bskd->bkgd", torch.softmax(s, dim=-1), v.float())
    return o.reshape(b, 1, hq, hd).to(q.dtype), torch.logsumexp(
        s, dim=-1).reshape(b, hq)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("window", [RING, 24])
def test_ring_parts_merge_to_the_whole_ring(window, parts, dtype):
    tol = TOL[dtype]
    c = RING // parts
    errs = [0.0, 0.0]
    for pos in RING_POS:
        (jq, jk, jv), (tq, tk, tv) = _both(
            _bhd(6, RING, 64, seed=pos + parts), dtype)
        q, k, v = (t.reshape((2, 3) + t.shape[1:]).transpose(1, 2)
                   .contiguous() for t in (tq, tk, tv))     # Hq = Hkv = 3
        p = torch.tensor(pos, dtype=torch.int32)
        whole, whole_lse = _whole_ring(q, k, v, pos, window)
        for call in (fd.flash_decode_plain, fd.flash_decode, ops.flash_decode):
            o, lse = call(q, k, v, p, window=window, lse=True, off=0,
                          ring=RING)
            assert torch.equal(o, whole) and torch.equal(lse, whole_lse)
            got = merge_parts([call(
                q, k[:, i * c:(i + 1) * c].contiguous(),
                v[:, i * c:(i + 1) * c].contiguous(), p, window=window,
                lse=True, off=i * c, ring=RING) for i in range(parts)])
            errs[0] = max(errs[0], _parity(got, whole.float(), tol))
        oracle = ref_ref.decode_attention_ref(jq, jk, jv, pos, window=window)
        errs[1] = max(errs[1], _parity(
            got.transpose(1, 2).reshape(6, 1, 64), oracle, tol))
        if pos < c:                       # the parts past pos are empty
            o, lse = fd.flash_decode_plain(q, k[:, c:2 * c], v[:, c:2 * c],
                                           p, window=window, lse=True,
                                           off=c, ring=RING)
            assert not o.any() and bool((lse < -1e29).all())
    print(f"PARITY flash_decode ring of {RING} in {parts} parts window="
          f"{window} {dtype} pos {RING_POS}: merged vs whole ring "
          f"max_abs_err={errs[0]:.3g}, vs oracle {errs[1]:.3g} tol={tol}")


SPLITS = (1, 3, 6, 32)


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("ctx,block_s,pos,window", [
    (256, 64, 100, None), (512, 128, 511, None), (128, 128, 0, None),
    (128, 64, 1000, 128), (128, 32, 50, 64), (64, 64, 63, 64),
    (128, 128, 300, 48),
    (256, 64, 31, None), (256, 64, 32, None), (256, 64, 33, None),  # seams
    (256, 64, 200, None),           # 7 tiles: at 32 runs, 25 are empty
    (128, 64, 40, 128)])            # a ring that has not wrapped
def test_split_partition_matches_oracle_and_pallas_interpret(
        ctx, block_s, pos, window, splits):
    (jq, jk, jv), (tq, tk, tv) = _both(
        _bhd(3, ctx, 64, seed=ctx + pos + splits), "float32")
    kernel = flash_decode_bhd(jq, jk, jv, pos, window=window,
                              block_s=block_s, interpret=True)
    oracle = ref_ref.decode_attention_ref(jq, jk, jv, pos, window=window)
    got = split_decode(*_model_layout(tq, tk, tv), pos, window,
                       splits)[:, :, 0]
    err = max(_parity(got, kernel, 2e-5), _parity(got, oracle, 2e-5))
    print(f"PARITY flash_decode split partition splits={splits} ctx={ctx} "
          f"pos={pos} window={window}: max_abs_err={err:.3g} tol=2e-05")


@pytest.mark.parametrize("pos", [31, 32, 33, 191])
def test_split_partition_gqa_matches_reference_ops(pos):
    """g 4 over 2 KV heads of 128, the decode cell's group size; pos 191 is
    the decode cell's last position, one tile a run at 6 runs."""
    b, ctx, hq, hkv, hd = 2, 256, 8, 2, 128
    rng = np.random.default_rng(pos)
    q = rng.normal(size=(b, 1, hq, hd)).astype(np.float32)
    k = rng.normal(size=(b, ctx, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, ctx, hkv, hd)).astype(np.float32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_ref = ref_ops.flash_decode(jq, jk, jv, pos)
    want_kernel = ref_ops.flash_decode(jq, jk, jv, pos, interpret=True,
                                       block_s=64)
    errs = []
    for splits in SPLITS:
        got = split_decode(*map(torch.from_numpy, (q, k, v)), pos, None,
                           splits)
        errs += [_parity(got, want_ref, 2e-5), _parity(got, want_kernel,
                                                        2e-5)]
    print(f"PARITY flash_decode split partition GQA {hq}/{hkv} pos={pos}: "
          f"max_abs_err={max(errs):.3g} tol=2e-05")


@pytest.mark.parametrize("hq,hkv,hd", [(4, 4, 112), (48, 1, 128)])
@pytest.mark.parametrize("pos", [31, 32, 33, 191])
def test_split_partition_new_shapes_match_reference_ops(hq, hkv, hd, pos):
    """Head dim 112 over MHA heads (zamba2-7b's shared block) and g 48 over
    one KV head (granite-34b's MQA).  The kernel's column split at hd 112
    (28 lanes of 4 columns) sums each column over the slots in the same
    tile and run order as at hd 128, so :func:`split_decode`, which keeps
    that order per column, models it unchanged."""
    b, ctx = 2, 256
    rng = np.random.default_rng(pos + hd)
    q = rng.normal(size=(b, 1, hq, hd)).astype(np.float32)
    k = rng.normal(size=(b, ctx, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, ctx, hkv, hd)).astype(np.float32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = ref_ops.flash_decode(jq, jk, jv, pos)
    errs = [_parity(split_decode(*map(torch.from_numpy, (q, k, v)), pos,
                                 None, splits), want, 2e-5)
            for splits in SPLITS]
    print(f"PARITY flash_decode split partition {hq}/{hkv} hd={hd} "
          f"pos={pos}: max_abs_err={max(errs):.3g} tol=2e-05")


def test_ptxas_report_reads_registers_and_spills():
    """The build report the card's resources test reads: each entry
    function's registers and spills, by its mangled name."""
    name = "_ZN12_GLOBAL__N_113decode_kernelIfLi128ELi1EEEvPKT_"
    log = (f"ptxas info    : 0 bytes gmem\n"
           f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
           f"ptxas info    : Function properties for {name}\n"
           f"    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill "
           f"loads\n"
           f"ptxas info    : Used 96 registers, used 1 barriers, 400 bytes "
           f"cmem[0]\n")
    assert build.ptxas_report(log) == {
        name: {"spill_stores": 8, "spill_loads": 4, "registers": 96}}
    assert build.ptxas_report("") == {}
