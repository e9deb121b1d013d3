"""Placements pinned inside a step whose tensors are DTensors: the port's
counterpart of the reference's ``with_sharding_constraint`` and of the
parts GSPMD partitions by hand.

On a mesh over a ``torch.distributed`` world
(:func:`repro_torch.launch.mesh.make_device_mesh`) the parameters,
optimizer state, batch and cache are DTensors
(:func:`repro_torch.launch.sharding.place`), and DTensor's sharding
propagation inserts the collectives of the step's dense products.  The
rest is pinned here, as the reference pins it:

* :func:`pin` redistributes a DTensor to given placements and its
  gradient to given ones (the residual stream's sequence sharding under
  ``seq_parallel``; the Megatron pair around a tensor-parallel sub-block:
  :func:`tp_in` before its column-parallel products, :func:`tp_out` on
  its row-parallel output);
* :func:`on_local_heads` runs attention (the flash kernels, or any impl)
  through ``local_map`` on each rank's batch rows and heads;
* :func:`ssd_on_local_heads` runs the Mamba-2 SSD scan (B3 forward, B3′
  backward) through ``local_map`` on each rank's rows and heads, with
  the groups' B and C that those heads read, and :func:`take_spans`
  gives each rank its own columns of a replicated tensor (the mixer's
  in-projection, which its sharding rule splits off its head
  boundaries);
* :func:`model_rank`, :func:`model_reduce`, :func:`model_sum` and
  :func:`model_gather` serve the bodies that ``local_map`` runs with
  explicit collectives over ``"model"`` (the MoE layer, decode against a
  sequence-split cache, the Mamba-2 mixer's gated RMSNorm and its step
  on split conv and SSM caches).

A plain tensor passes through every function here unchanged, so every
one-card path is untouched.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

MODEL = "model"


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def axis_names(x) -> tuple:
    return tuple(x.device_mesh.mesh_dim_names)


def axis_size(x, name: str) -> int:
    """The size of ``x``'s mesh along ``name`` (1 when it has no such
    axis)."""
    names = axis_names(x)
    return x.device_mesh.size(names.index(name)) if name in names else 1


def sharded_axes(x, dim: int) -> tuple:
    """The mesh axes along which ``x`` is split on ``dim``."""
    return tuple(n for n, p in zip(axis_names(x), x.placements)
                 if isinstance(p, Shard) and p.dim == dim)


def placements(x, dims: dict, partial=()) -> tuple:
    """Placements over ``x``'s mesh: ``Shard(d)`` on each axis of size
    above one named for ``d`` in ``dims`` (an axis name or a tuple of
    them), ``Partial()`` on the axes in ``partial``, ``Replicate()``
    elsewhere."""
    names = axis_names(x)
    out = [Replicate()] * len(names)
    sizes = x.device_mesh.mesh.shape
    for d, axes in dims.items():
        for a in (axes,) if isinstance(axes, str) else axes:
            # an axis of size one (or left out of the mesh) splits nothing
            if a in names and sizes[names.index(a)] > 1:
                out[names.index(a)] = Shard(d)
    for a in partial:
        if a in names:
            out[names.index(a)] = Partial()
    return tuple(out)


def _for_grad(pl) -> tuple:
    return tuple(Replicate() if isinstance(p, Partial) else p for p in pl)


class _Pin(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return x.redistribute(x.device_mesh, fwd)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.bwd), None, None


def pin(x, fwd, grad=None):
    """``x`` redistributed to the placements ``fwd``, its gradient to
    ``grad`` (default: ``x``'s own, a partial sum taken whole); a plain
    tensor passes."""
    if not is_dtensor(x):
        return x
    return _Pin.apply(x, tuple(fwd),
                      tuple(grad) if grad is not None
                      else _for_grad(x.placements))


def with_model(x, placement) -> tuple:
    """``x``'s placements with the ``"model"`` axis's replaced."""
    names = axis_names(x)
    pl = list(_for_grad(x.placements))
    if MODEL in names:
        pl[names.index(MODEL)] = placement
    return tuple(pl)


def tp_in(x):
    """The input of a tensor-parallel sub-block, or the residual stream
    after the vocab-split embedding: whole over ``"model"`` (an all-gather
    of the sequence under ``seq_parallel``, an all-reduce of the
    embedding's partial sum), its gradient — a partial sum from the
    column-parallel products — summed back to ``x``'s placements (an
    all-reduce, or a reduce-scatter onto the sequence)."""
    if not is_dtensor(x) or MODEL not in axis_names(x):
        return x
    return pin(x, with_model(x, Replicate()))


def tp_out(y, like):
    """A sub-block's output ``y`` (a partial sum over ``"model"`` after
    its row-parallel product) in ``like``'s placements, the residual
    stream's."""
    if not is_dtensor(y):
        return y
    return pin(y, _for_grad(like.placements))


def on_local_heads(fn, q, k, v, rows: tuple):
    """``fn(q, k, v) -> o`` on each rank's batch rows and heads: q (B, S,
    Hq, hd), k and v (B, S, Hkv, ·) are pinned to rows (dim 0) over the
    axes ``rows`` and heads (dim 2) over ``"model"``, and ``fn`` runs on
    the local tensors through ``local_map``.  A query group and its KV
    head must sit on one rank: raises ``ValueError`` where ``"model"``
    does not divide both head counts, rather than gather."""
    from torch.distributed.tensor.experimental import local_map
    m = axis_size(q, MODEL)
    hq, hkv = q.shape[2], k.shape[2]
    if hq % m or hkv % m:
        raise ValueError(
            f"attention over {hq} query and {hkv} KV heads on a 'model' "
            f"axis of {m}: a query group and its KV head must sit on one "
            "rank (Runtime.gqa_expand repeats the KV heads first)")
    dims = {0: rows}
    if MODEL in axis_names(q):
        dims[2] = MODEL
    pl = placements(q, dims)
    q, k, v = (pin(t, pl) for t in (q, k, v))

    def local(q, k, v):
        # DTensor views its gradients by the global shape: hand them back
        # contiguous (the plain attention's einsums give strided ones)
        return fn(*(_ContiguousGrad.apply(t) for t in (q, k, v)))

    return local_map(local, out_placements=list(pl), in_placements=(pl,) * 3,
                     device_mesh=q.device_mesh)(q, k, v)


def ssd_on_local_heads(x, dt, A, Bm, Cm, *, chunk: int, rows: tuple = ()):
    """:func:`repro_torch.kernels.ops.ssd` (y (B, S, H, P)) on each rank's
    batch rows and heads: x (B, S, H, P) and dt (B, S, H) are pinned to
    rows (dim 0) over the axes ``rows`` and heads (dim 2) over
    ``"model"``, A ((H,) or (copies, H)) to the same heads, and Bm and Cm
    (B, S, G, N) to the rows and to groups over ``"model"``, each rank
    holding the groups its own heads read.  A group whose heads several
    ranks share comes in as a copy on each (the Mamba-2 mixer takes each
    rank's groups from its in-projection; which groups those are is
    :func:`repro_torch.models.mamba2._local_split`'s rule).  The scan runs
    on the local tensors through ``local_map``.  Raises ``ValueError``
    where ``"model"`` does not divide both H and G, rather than gather.
    Plain tensors go straight to the kernel's wrapper."""
    from repro_torch.kernels import ops
    if not is_dtensor(x):
        return ops.ssd(x, dt, A, Bm, Cm, chunk=chunk)
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    m = axis_size(x, MODEL)
    h, g = x.shape[2], Bm.shape[2]
    if h % m or g % m:
        raise ValueError(
            f"the SSD scan over {h} heads in {g} groups on a 'model' axis "
            f"of {m}: 'model' must divide both, each rank holding the "
            "groups its heads read (a group that several ranks read as a "
            "copy on each)")
    hpl = placements(x, {0: rows, 2: MODEL})
    apl = placements(A, {A.dim() - 1: MODEL})
    agpl = placements(A, {A.dim() - 1: MODEL}, partial=rows)
    bpl = placements(Bm, {0: rows, 2: MODEL})
    x, dt = pin(x, hpl), pin(dt, placements(dt, {0: rows, 2: MODEL}))
    A = pin(A, apl)
    Bm, Cm = pin(Bm, bpl), pin(Cm, bpl)

    def local(*ts):
        return ops.ssd(*(_ContiguousGrad.apply(t) for t in ts), chunk=chunk)

    return local_map(local, out_placements=list(hpl),
                     in_placements=(hpl, dt.placements, apl, bpl, bpl),
                     in_grad_placements=(hpl, dt.placements, agpl, bpl,
                                         bpl),
                     device_mesh=mesh)(x, dt, A, Bm, Cm)


def take_spans(t, spans, dim: int):
    """Each rank's columns of ``t`` (whole over ``"model"``) along
    ``dim``: ``spans(r, m)`` gives rank r's (start, length) spans, which
    are concatenated in order, so the result is split on ``dim`` over
    ``"model"``, rank r's part being its spans.  Its gradient to ``t`` is
    a partial sum over ``"model"`` (a span that several ranks take sums
    their parts).  Adjacent spans are joined, so a rank whose spans are
    all of ``t`` takes ``t`` itself (a view).  A plain tensor takes rank 0
    of 1's spans."""
    def take(t, r, m):
        joined = []
        for a, n in spans(r, m):
            if joined and joined[-1][0] + joined[-1][1] == a:
                joined[-1] = (joined[-1][0], joined[-1][1] + n)
            else:
                joined.append((a, n))
        parts = [t.narrow(dim, a, n) for a, n in joined]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim)

    if not is_dtensor(t):
        return take(t, 0, 1)
    from torch.distributed.tensor.experimental import local_map
    mesh = t.device_mesh
    split = axis_size(t, MODEL) > 1   # an axis of one splits nothing
    out, grad = ((Shard(dim % t.dim()), Partial()) if split
                 else (Replicate(), Replicate()))
    return local_map(lambda t: take(t, *model_rank(mesh)),
                     out_placements=list(with_model(t, out)),
                     in_placements=(t.placements,),
                     in_grad_placements=(with_model(t, grad),),
                     device_mesh=mesh)(t)


class _ContiguousGrad(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def model_rank(mesh) -> tuple:
    """``(rank along "model", its size)`` of this process in ``mesh`` (a
    ``DeviceMesh``)."""
    names = tuple(mesh.mesh_dim_names)
    if MODEL not in names:
        return 0, 1
    i = names.index(MODEL)
    return mesh.get_local_rank(i), mesh.size(i)


def model_gather(t, dim: int, mesh):
    """Every rank's ``t`` along ``"model"`` concatenated on ``dim`` in rank
    order: DTensor's own all-gather of a ``Shard(dim)`` tensor (the one
    every redistribution to ``Replicate()`` runs, whatever the torch calls
    it; counted by :func:`repro_torch.launch.cost.count_sharded`)."""
    sub = mesh[MODEL]
    if sub.size() == 1:
        return t
    return DTensor.from_local(t.contiguous(), sub, [Shard(dim % t.dim())],
                              run_check=False).full_tensor()


class _ModelSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return model_reduce(t, "sum", mesh)

    @staticmethod
    def backward(ctx, g):
        return model_reduce(g.contiguous(), "sum", ctx.mesh), None


def model_sum(t, mesh):
    """``t`` summed over the ``"model"`` axis of ``mesh``, differentiably:
    each rank's gradient is the sum of every rank's gradient of the sum
    (an all-reduce each way), for a sum that each rank goes on to use on
    its own part."""
    return _ModelSum.apply(t, mesh)


def model_reduce(t, op: str, mesh):
    """``t`` reduced (``"sum"`` or ``"max"``) over the ``"model"`` axis of
    ``mesh`` (a functional all-reduce, counted by
    :func:`repro_torch.launch.cost.count_sharded`)."""
    from torch.distributed import _functional_collectives as fc
    names = tuple(mesh.mesh_dim_names)
    group = mesh.get_group(names.index(MODEL))
    if dist.get_world_size(group) == 1:
        return t
    return fc.wait_tensor(fc.all_reduce(t, op, group))
