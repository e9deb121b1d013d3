"""The Mamba-2 block — SSD, state-space duality (port of the reference's
``models/mamba2.py``, the train path).

Every apply function takes a stack of N parameter copies and activations
``(N, B, S, d)`` (:mod:`.layers`): the projections are batched GEMMs, the
depthwise causal conv has per-copy weights ``(N, d_conv, CH)``, and the
decay rates ``A = -exp(A_log)`` are per copy, ``(N, H)``.  The scan
itself flattens the copy axis into the batch — ``(N·B, S, H, P)`` — and
goes through :func:`repro_torch.kernels.ops.ssd` (the SSD kernels on
CUDA, their plain versions on the CPU).

:func:`ssd_reference` is the chunked SSD scan (intra-chunk quadratic
block plus the inter-chunk state recurrence), the oracle of the kernels.
:func:`mamba2_decode` is the one-token step over one parameter set (a
copy axis of 1): the rolling conv window and the per-head SSM state
recurrence, both caches updated in place.

On a mesh over a ``torch.distributed`` world (DTensors placed by the
sharding rules: ``in_proj`` split on its columns and ``out_proj`` on its
rows over ``"model"``, the rest whole) each rank runs the mixer on its
heads.  The in-projection's split does not fall on head boundaries, so
its columns are all-gathered and each rank takes its heads' z, x and dt
and the B and C its heads read (:func:`_forward_sharded`); the conv runs
on the rank's channels, the scan on its heads (B3 and B3′ through
:func:`repro_torch.models.sharded.ssd_on_local_heads`), the gated
RMSNorm sums its squares over ``"model"`` (it normalises over all of
d_in), and the out-projection's partial sum goes back to the residual.
At decode the caches are split too, ``conv`` on its channels (not on
head boundaries) and ``ssm`` on its heads: each rank rolls its channels
of the window and steps its heads' state in place, and the conv outputs
are all-gathered between the two (:func:`_decode_sharded`).  On one card
none of this runs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import sharded
from repro_torch.models.layers import (_per_copy, dense_init, linear,
                                       rmsnorm, rmsnorm_init, scaled_normal)


def dims(cfg: ArchConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    conv_ch = d_in + 2 * s.n_groups * s.d_state
    return d_in, n_heads, conv_ch


def mamba2_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32):
    """One mixer's parameters, drawn in_proj, conv_w, out_proj from
    ``gen`` on its device (the reference's shapes and scales); ``A_log =
    log(linspace(1, 16, H))`` (computed on the CPU), ``D = 1`` and
    ``dt_bias = 0`` as in the reference."""
    s = cfg.ssm
    d_in, H, conv_ch = dims(cfg)
    proj_out = 2 * d_in + 2 * s.n_groups * s.d_state + H   # z, x, B, C, dt
    dev = gen.device
    in_proj = dense_init(gen, cfg.d_model, proj_out, dtype)
    conv_w = scaled_normal(gen, (s.d_conv, conv_ch), 0.1, dtype)
    out_proj = dense_init(gen, d_in, cfg.d_model, dtype)
    return {"in_proj": in_proj,
            "conv_w": conv_w,
            "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
            "A_log": torch.log(torch.linspace(1.0, 16.0, H,
                                              dtype=torch.float32)).to(dev),
            "D": torch.ones((H,), dtype=torch.float32, device=dev),
            "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
            "norm": rmsnorm_init(d_in, dtype, dev),
            "out_proj": out_proj}


def _split_proj(cfg: ArchConfig, proj):
    """``(z, xbc, dt)`` views of the in-projection; xbc holds the conv
    channels (x, B, C)."""
    s = cfg.ssm
    d_in, H, _ = dims(cfg)
    gn = s.n_groups * s.d_state
    return torch.split(proj, [d_in, d_in + 2 * gn, H], dim=-1)


def _causal_conv(w, b, xbc):
    """Depthwise causal conv per copy: w (N, W, CH), b (N, CH), xbc (N, B,
    S, CH) → silu(conv + b), summed tap by tap in the reference's order."""
    W, S = w.shape[1], xbc.shape[-2]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    out = sum(pad[..., i:i + S, :] * _per_copy(w[:, i], xbc)
              for i in range(W))
    return F.silu(out + _per_copy(b, xbc))


def segsum(a):
    """Stable 'segment sum': out[..., i, j] = sum_{j<k<=i} a[..., k]."""
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=a.device))
    return out.masked_fill(~mask, -torch.inf)


def per_sequence_A(A, batch: int):
    """Decay rates per sequence, (B, H): A is (H,), shared by every
    sequence, or (n_copies, H), copy c owning ``B / n_copies``
    consecutive sequences."""
    if A.dim() == 1:
        return A.expand(batch, A.shape[0])
    if batch % A.shape[0]:
        raise ValueError(f"{batch} sequences do not split over "
                         f"{A.shape[0]} copies of A")
    return A.repeat_interleave(batch // A.shape[0], dim=0)


def ssd_reference(x, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD scan.

    x: (B, S, H, P)   dt: (B, S, H)   A: (H,) or (n_copies, H), negative
    decay rates (:func:`per_sequence_A`)   Bm, Cm: (B, S, G, N), H % G == 0.
    Returns y (B, S, H, P) in x's dtype and the final state (B, H, P, N).
    Computes in float32 (float64 for float64 inputs, a finer oracle).
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = S // chunk
    rep = H // G
    work = torch.promote_types(x.dtype, torch.float32)

    def ch(t):  # (B, S, ...) -> (B, nc, chunk, ...) in the working type
        return t.to(work).reshape((Bsz, nc, chunk) + t.shape[2:])

    xc, dtc, Bc, Cc = ch(x), ch(dt), ch(Bm), ch(Cm)
    # broadcast groups to heads
    Bh = Bc.repeat_interleave(rep, dim=3)                 # (B,nc,l,H,N)
    Ch_ = Cc.repeat_interleave(rep, dim=3)

    dA = dtc * per_sequence_A(A.to(work), Bsz)[:, None, None, :]
    dA_cum = torch.cumsum(dA, dim=2)                      # within chunk
    # intra-chunk (diagonal block): y = (C B^T ∘ L) (dt x)
    Lmat = torch.exp(segsum(dA.movedim(-1, -2)))          # (B,nc,H,l,l)
    scores = torch.einsum("bclhn,bcshn->bchls", Ch_, Bh)
    xdt = xc * dtc[..., None]                             # (B,nc,l,H,P)
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores * Lmat, xdt)

    # chunk states: S_c = sum_s exp(dA_end - dA_cum_s) B_s (dt x)_s
    decay_out = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)  # (B,nc,l,H)
    states = torch.einsum("bclhn,bclh,bclhp->bchpn", Bh, decay_out, xdt)

    # inter-chunk recurrence, emitting the state entering each chunk
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])          # (B,nc,H)
    carry = torch.zeros((Bsz, H, P, N), dtype=work, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                # (B,nc,H,P,N)

    # off-diagonal contribution: C_t exp(dA_cum_t) state_in
    y_off = torch.einsum("bclhn,bclh,bchpn->bclhp", Ch_, torch.exp(dA_cum),
                         prev_states)
    y = (y_diag + y_off).reshape(Bsz, S, H, P)
    return y.to(x.dtype), carry


def _scan_inputs(cfg: ArchConfig, proj, conv_w, conv_b, dt_bias, h: int):
    """The scan's inputs from an in-projection of ``h`` heads: proj (N, B,
    S, ·) holds z and x of those heads, the B and C columns of the groups
    they read and their dt, in that order.  Returns z (N, B, S, h·P), xs
    (N·B, S, h, P) and Bm, Cm (N·B, S, g, N) — views of the causal
    conv's output (conv_w (N, W, ch), conv_b (N, ch) over those
    channels) — and dt (N·B, S, h) float32 after its bias and softplus."""
    s = cfg.ssm
    n, b, S, _ = proj.shape
    d = h * s.head_dim
    gn = (proj.shape[-1] - 2 * d - h) // 2
    z, xbc, dt = torch.split(proj, [d, d + 2 * gn, h], dim=-1)
    xbc = _causal_conv(conv_w, conv_b, xbc)
    # views of the conv output (row stride ch), no copies
    xs, Bm, Cm = torch.split(xbc, [d, gn, gn], dim=-1)
    xs = xs.reshape(n * b, S, h, s.head_dim)
    Bm = Bm.reshape(n * b, S, -1, s.d_state)
    Cm = Cm.reshape(n * b, S, -1, s.d_state)
    # softplus as the reference's jax.nn.softplus: logaddexp(x, 0)
    dt = dt.float() + _per_copy(dt_bias, dt)
    dt = torch.logaddexp(dt, torch.zeros_like(dt)).reshape(n * b, S, h)
    return z, xs, dt, Bm, Cm


def _gated(D, y, xs, z):
    """``(y + D·x) ∘ silu(z)``, (N, B, S, h·P), over h heads: y and xs
    (N·B, S, h, P), D (N, h), z (N, B, S, h·P)."""
    n, b, S, _ = z.shape
    h = D.shape[-1]
    y = y.reshape(n, b, S, h, -1)
    y = y + xs.reshape(y.shape) * D.reshape(n, 1, 1, h, 1).to(y.dtype)
    return y.reshape(z.shape) * F.silu(z)


def _local_split(cfg: ArchConfig, m: int):
    """The split of the mixer over a ``"model"`` axis of ``m``: ``(heads,
    in_spans, ch_spans)``, a rank's heads and the functions of ``(r, m)``
    that give rank r's (start, length) spans of the in-projection's
    columns (its z, x, the B and C of the groups its heads read, its dt)
    and of the conv's channels (its x, B and C).  Raises ``ValueError``
    where a group's heads would straddle ranks."""
    s = cfg.ssm
    d_in, H, _ = dims(cfg)
    G, N = s.n_groups, s.d_state
    if H % m or not (G % m == 0 or m % G == 0):
        raise ValueError(
            f"{cfg.name}: the Mamba-2 mixer's {H} heads in {G} groups on a "
            f"'model' axis of {m}: each rank's heads must read whole groups")
    h, g = H // m, max(1, G // m)
    d, gn = h * s.head_dim, G * N

    def ch_spans(r, m, at=0):
        g0 = r * G // m           # the first group rank r's heads read
        return [(at + r * d, d), (at + d_in + g0 * N, g * N),
                (at + d_in + gn + g0 * N, g * N)]

    def in_spans(r, m):
        return ([(r * d, d)] + ch_spans(r, m, d_in)
                + [(2 * d_in + 2 * gn + r * h, h)])

    return h, in_spans, ch_spans


def mamba2_forward(params, cfg: ArchConfig, x):
    """Full-sequence train path of N copies: x (N, B, S, d) → same.  On
    DTensors (x whole over ``"model"``) see :func:`_forward_sharded`."""
    if sharded.is_dtensor(x):
        return _forward_sharded(params, cfg, x)
    # the kernels' module imports this one for its oracle: import late
    from repro_torch.kernels import ops
    _, H, _ = dims(cfg)
    proj = linear(x, params["in_proj"])
    z, xs, dt, Bm, Cm = _scan_inputs(cfg, proj, params["conv_w"],
                                     params["conv_b"], params["dt_bias"], H)
    A = -torch.exp(params["A_log"])                        # (N, H)
    # dt stays float32 under bf16, as the reference's scan reads it
    y = ops.ssd(xs, dt, A, Bm, Cm, chunk=min(cfg.ssm.chunk, x.shape[2]))
    y = rmsnorm(params["norm"], _gated(params["D"], y, xs, z))
    return linear(y, params["out_proj"])


def _forward_sharded(params, cfg: ArchConfig, x):
    """The train path on a mesh, each rank on its heads: the in-projection
    (split over ``"model"`` on its columns, off the head boundaries) is
    all-gathered and each rank takes its heads' z, x and dt columns and
    the B and C columns of the groups they read
    (:func:`sharded.take_spans`; the gradient is reduce-scattered back to
    the projection's split), so its product is one batched GEMM a rank
    with no redundant columns but B and C; the causal conv and dt's
    softplus run on the rank's channels and heads, the scan on its heads
    (:func:`sharded.ssd_on_local_heads`, B and C as the groups of its own
    heads: a group that several ranks read is a copy on each), then the
    gate and the gated RMSNorm over all of d_in, whose mean of squares
    is summed across ranks by an explicit all-reduce of a (N, B, S)
    float32 partial (DTensor's own norm moved the activations between
    placements in the backward); the out-projection, split on its rows
    as the heads are, gives a partial sum over ``"model"``.  Each step
    runs through ``local_map`` on the ranks' rows (those of x) or in
    DTensor's own operations."""
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    rows = sharded.sharded_axes(x, 1)
    m = sharded.axis_size(x, sharded.MODEL)
    h, in_spans, ch_spans = _local_split(cfg, m)
    w = params["in_proj"]
    w = sharded.take_spans(sharded.pin(w, sharded.with_model(
        w, sharded.Replicate())), in_spans, -1)
    cw = sharded.take_spans(params["conv_w"], ch_spans, -1)
    cb = sharded.take_spans(params["conv_b"], ch_spans, -1)
    proj = linear(x, w)                                   # (N, B, S, m·p)

    def per_head(t, grad=False):
        # split on its last dim as the heads are; the gradient of a
        # parameter read by the rank's rows alone is a partial sum over them
        return sharded.placements(t, {t.dim() - 1: sharded.MODEL},
                                  partial=rows if grad else ())

    dtb = sharded.pin(params["dt_bias"], per_head(params["dt_bias"]))
    D = sharded.pin(params["D"], per_head(params["D"]))
    scale = params["norm"]["scale"]
    scale = sharded.pin(scale, per_head(scale))
    zpl = sharded.placements(x, {1: rows, 3: sharded.MODEL})
    hpl = sharded.placements(x, {0: rows, 2: sharded.MODEL})
    z, xs, dt, Bm, Cm = local_map(
        lambda *a: _scan_inputs(cfg, *a, h),
        out_placements=(list(zpl),) + (list(hpl),) * 4,
        in_placements=(zpl, per_head(cw), per_head(cb), per_head(dtb)),
        in_grad_placements=(zpl, per_head(cw, True), per_head(cb, True),
                            per_head(dtb, True)),
        device_mesh=mesh)(proj, cw, cb, dtb)
    A = -torch.exp(params["A_log"])                        # (N, H)
    y = sharded.ssd_on_local_heads(xs, dt, A, Bm, Cm, rows=rows,
                                   chunk=min(cfg.ssm.chunk, x.shape[2]))
    across = _across(m, mesh)

    def gated_norm(D, y, xs, z, scale):
        return rmsnorm({"scale": scale}, _gated(D, y, xs, z), across=across)

    y = local_map(gated_norm, out_placements=list(zpl),
                  in_placements=(per_head(D), hpl, hpl, zpl,
                                 per_head(scale)),
                  in_grad_placements=(per_head(D, True), hpl, hpl, zpl,
                                      per_head(scale, True)),
                  device_mesh=mesh)(D, y, xs, z, scale)
    return linear(y, params["out_proj"])


def _across(m: int, mesh):
    """The gated RMSNorm's mean of squares over a rank's 1/m of d_in to
    the whole's: a 1/m share of it summed over ``"model"``."""
    if m == 1:
        return None
    return lambda ms: sharded.model_sum(ms / m, mesh)


def _conv_step(w, b, state, xbc):
    """One token through the rolling conv window of some channels: state
    (B, d_conv-1, ch) updated in place, xbc (1, B, ch), w (d_conv, ch), b
    (ch) → silu(conv + b), (B, ch)."""
    win = torch.cat([state, xbc[0, :, None, :]], dim=1)        # (B, W, ch)
    conv = F.silu(torch.einsum("bwc,wc->bc", win, w) + b)
    state.copy_(win[:, 1:])
    return conv


def _ssm_step(params, cfg: ArchConfig, conv, dt, z, ssm_state, h0: int,
              dtype):
    """The SSM state step of the heads ``h0 ..`` (those of ``ssm_state``
    (B, h, P, N) float32, updated in place): conv (B, CH) every channel's
    conv output, dt (B, H) and z (1, B, d_in) every head's.  Returns the
    gated y of those heads, (1, B, 1, h·P) in ``dtype``."""
    s = cfg.ssm
    d_in, H, _ = dims(cfg)
    b, h = conv.shape[0], ssm_state.shape[1]
    heads = slice(h0, h0 + h)
    gn = s.n_groups * s.d_state
    xs, Bm, Cm = torch.split(conv, [d_in, gn, gn], dim=-1)
    xs = xs.reshape(b, H, s.head_dim)[:, heads].float()
    rep = H // s.n_groups
    Bh = Bm.reshape(b, s.n_groups, s.d_state).float().repeat_interleave(
        rep, dim=1)[:, heads]                              # (B, h, N)
    Ch_ = Cm.reshape(b, s.n_groups, s.d_state).float().repeat_interleave(
        rep, dim=1)[:, heads]

    # softplus as the reference's jax.nn.softplus: logaddexp(x, 0)
    dt = dt.float()[:, heads] + params["dt_bias"][0][heads]    # (B, h)
    dt = torch.logaddexp(dt, torch.zeros_like(dt))
    A = -torch.exp(params["A_log"][0][heads])
    dA = torch.exp(dt * A[None, :])
    upd = torch.einsum("bh,bhp,bhn->bhpn", dt, xs, Bh)
    ssm_state.mul_(dA[:, :, None, None]).add_(upd)
    y = torch.einsum("bhpn,bhn->bhp", ssm_state, Ch_)
    y = y + xs * params["D"][0][heads][None, :, None]
    y = y.reshape(1, b, 1, h * s.head_dim).to(dtype)
    cols = slice(h0 * s.head_dim, (h0 + h) * s.head_dim)
    return y * F.silu(z[:, :, None, cols])


def mamba2_decode(params, cfg: ArchConfig, x, conv_state, ssm_state):
    """One-token step of one parameter set (leaves with a copy axis of 1):
    x (1, B, 1, d); conv_state (B, d_conv-1, CH) and ssm_state (B, H, P,
    N) float32, both updated in place (the reference returns new ones).
    Returns y (1, B, 1, d).  On DTensor caches see
    :func:`_decode_sharded`."""
    proj = linear(x[:, :, 0], params["in_proj"])          # (1, B, ·)
    if sharded.is_dtensor(conv_state):
        return _decode_sharded(params, cfg, x, proj, conv_state, ssm_state)
    z, xbc, dt = _split_proj(cfg, proj)
    conv = _conv_step(params["conv_w"][0], params["conv_b"][0], conv_state,
                      xbc)
    y = _ssm_step(params, cfg, conv, dt[0], z, ssm_state, 0, x.dtype)
    y = rmsnorm(params["norm"], y)
    return linear(y, params["out_proj"])


def _decode_sharded(params, cfg: ArchConfig, x, proj, conv_state,
                    ssm_state):
    """The one-token step against DTensor caches placed by
    ``cache_shardings``: rows over the data axes, ``conv`` (B, W-1, CH)
    split on its channels and ``ssm`` (B, H, P, N) on its heads over
    ``"model"`` where they divide.  The in-projection's output (B rows)
    is all-gathered over ``"model"``; each rank rolls its channels of the
    conv window in place and the conv outputs are all-gathered (both a
    few KB); each rank steps the SSM state of its heads in place, and
    the gated RMSNorm (its mean of squares summed over ``"model"``) and
    the row-split out-projection run as in the train path
    (:func:`_forward_sharded`)."""
    from torch.distributed.tensor.experimental import local_map
    mesh = conv_state.device_mesh
    rows = sharded.sharded_axes(conv_state, 0)
    split_ch = bool(sharded.sharded_axes(conv_state, 2))
    split_h = bool(sharded.sharded_axes(ssm_state, 1))
    proj = sharded.pin(proj, sharded.placements(proj, {1: rows}))
    ypl = sharded.placements(proj, {1: rows, 3: sharded.MODEL} if split_h
                             else {1: rows})
    m = sharded.axis_size(ssm_state, sharded.MODEL) if split_h else 1
    scale = params["norm"]["scale"]
    scale = sharded.pin(scale, sharded.placements(
        scale, {1: sharded.MODEL} if split_h else {}))
    names = ("conv_w", "conv_b", "dt_bias", "A_log", "D", "scale")

    def body(proj, conv_state, ssm_state, *leaves):
        p = dict(zip(names, leaves))
        r = sharded.model_rank(mesh)[0]
        z, xbc, dt = _split_proj(cfg, proj)
        c = conv_state.shape[-1]
        at = r * c if split_ch else 0
        conv = _conv_step(p["conv_w"][0].narrow(-1, at, c),
                          p["conv_b"][0].narrow(-1, at, c), conv_state,
                          xbc.narrow(-1, at, c))
        if split_ch:
            conv = sharded.model_gather(conv, -1, mesh)
        h0 = r * ssm_state.shape[1] if split_h else 0
        y = _ssm_step(p, cfg, conv, dt[0], z, ssm_state, h0, x.dtype)
        return rmsnorm(p, y, across=_across(m, mesh))

    leaves = [params[k] for k in names[:-1]] + [scale]
    y = local_map(body, out_placements=list(ypl),
                  in_placements=(proj.placements, conv_state.placements,
                                 ssm_state.placements,
                                 *(t.placements for t in leaves)),
                  device_mesh=mesh)(proj, conv_state, ssm_state, *leaves)
    return linear(y, params["out_proj"])
