"""Placements pinned inside a step whose tensors are DTensors: the port's
counterpart of the reference's ``with_sharding_constraint`` and of the
parts GSPMD partitions by hand.

On a mesh over a ``torch.distributed`` world
(:func:`repro_torch.launch.mesh.make_device_mesh`) the parameters,
optimizer state, batch and cache are DTensors
(:func:`repro_torch.launch.sharding.place`), and DTensor's sharding
propagation inserts the collectives of the step's dense products.  Four
things are pinned here, as the reference pins them:

* :func:`pin` redistributes a DTensor to given placements and its
  gradient to given ones (the residual stream's sequence sharding under
  ``seq_parallel``; the Megatron pair around a tensor-parallel sub-block:
  :func:`tp_in` before its column-parallel products, :func:`tp_out` on
  its row-parallel output);
* :func:`on_local_heads` runs attention (the flash kernels, or any impl)
  through ``local_map`` on each rank's batch rows and heads;
* :func:`model_rank` and :func:`model_reduce` serve the bodies that
  ``local_map`` runs with explicit collectives over ``"model"`` (the MoE
  layer, decode against a sequence-split cache).

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
