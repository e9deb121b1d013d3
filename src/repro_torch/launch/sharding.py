"""Sharding rules for parameters, optimizer state, batches and caches
(port of the reference's ``launch/sharding.py``, its rules copied).

Baseline layout: tensor-parallel over ``model`` (attention heads and
projections, FFN hidden, experts, vocab), batch over the data axes
(× pod), small tensors replicated.  Uneven dims (arctic's 56 heads) take
GSPMD's implicit padding (:meth:`NamedSharding.shard_shape` rounds up).
A dimension is sharded only when doing so is sane (dim >= axis size or
explicitly allowed uneven).

The rules read only ``mesh.shape`` and ``mesh.axis_names`` and a leaf's
key path (:func:`repro_torch.tree.keystr`, the reference's
``jax.tree_util.keystr``) and shape, so on an abstract production mesh
(:func:`~repro_torch.launch.mesh.make_production_mesh`) they give the
reference's specs leaf for leaf, and per-device sizes through
``shard_shape``.  :func:`place` applies a tree of shardings: on a mesh
of one device it puts every leaf whole on that device; on a mesh over a
``torch.distributed`` world (:func:`~repro_torch.launch.mesh.
make_device_mesh`, one process a device) it makes DTensors with the
spec's placements (:meth:`NamedSharding.placements`), each rank keeping
its shard, so the step's operations insert the collectives that GSPMD
inserts for the reference.  Where a rule shards a dimension its axes do
not divide, DTensor's shards are ragged (``torch.chunk``'s) while
``shard_shape`` pads.  :func:`place_zeros` makes an optimizer's initial
(zero) state straight into its shards, :func:`gather` the full tensors
back.
"""
from __future__ import annotations

import re

import torch

from repro_torch.launch.mesh import NamedSharding, P, data_axes
from repro_torch.tree import keystr, tree_map, tree_map_with_path

__all__ = ["P", "NamedSharding", "param_spec_for", "params_shardings",
           "state_shardings", "state_shardings_zero1", "batch_shardings",
           "cache_shardings", "decode_input_shardings", "logits_sharding",
           "place", "place_zeros", "gather"]


def _axis_size(mesh, name) -> int:
    return mesh.shape[name]


def _spec_shard_dim(ndim: int, dim: int, axis="model") -> P:
    parts = [None] * ndim
    parts[dim] = axis
    return P(*parts)


# each rule: (path regex, function(shape)->dim to shard on "model" | None)
_PARAM_RULES = [
    # embeddings / unembeddings: shard the (padded) vocab dim
    (r"embed.*table", lambda s: len(s) - 2),
    (r"lm_head", lambda s: len(s) - 1),
    # attention projections
    (r"attn.*(wq|wk|wv|w_q|w_uq|w_uk|w_uv)'?\]?$", lambda s: len(s) - 1),
    (r"attn.*(wo)'?\]?$", lambda s: len(s) - 2),
    (r"attn.*(bq|bk|bv)'?\]?$", lambda s: len(s) - 1),
    # low-rank MLA down-projections & norms: small -> replicate
    (r"attn.*(w_dkv|w_dq|w_kr|kv_norm|q_norm)", lambda s: None),
    # dense FFN
    (r"(ffn|shared|dense)'?\]\['w_(gate|up)", lambda s: len(s) - 1),
    (r"(ffn|shared|dense)'?\]\['w_down", lambda s: len(s) - 2),
    # MoE experts: expert-parallel over the expert dim
    (r"experts.*w_(gate|up|down)", lambda s: len(s) - 3),
    (r"router", lambda s: None),
    # mamba2 mixer
    (r"mixer'?\]\['in_proj", lambda s: len(s) - 1),
    (r"mixer'?\]\['out_proj", lambda s: len(s) - 2),
]


def param_spec_for(path: str, shape, mesh) -> P:
    msize = _axis_size(mesh, "model")
    for pat, dimfn in _PARAM_RULES:
        if re.search(pat, path):
            dim = dimfn(shape)
            if dim is None or dim < 0:
                return P()
            size = shape[dim]
            # shard when >= axis (uneven allowed: GSPMD pads), else replicate
            if size >= msize:
                return _spec_shard_dim(len(shape), dim)
            return P()
    return P()  # norms, biases, scalars, conv, A_log, D, router, ...


def _ndim(leaf) -> int:
    return len(getattr(leaf, "shape", ()))


def params_shardings(mesh, params_spec):
    def one(path, leaf):
        spec = param_spec_for(keystr(path), tuple(leaf.shape), mesh)
        return NamedSharding(mesh, spec)

    return tree_map_with_path(one, params_spec)


def state_shardings(mesh, state_spec):
    """TrainState(params, opt, step): opt leaves inherit the param rules
    (their tree paths embed the param path), step/scalars replicate."""
    def one(path, leaf):
        if _ndim(leaf) == 0:
            return NamedSharding(mesh, P())
        spec = param_spec_for(keystr(path), tuple(leaf.shape), mesh)
        return NamedSharding(mesh, spec)

    return tree_map_with_path(one, state_spec)


def state_shardings_zero1(mesh, state_spec):
    """ZeRO-1 variant: OPTIMIZER leaves are additionally sharded over the
    data axes on their largest not-yet-sharded divisible dim (params keep
    the TP layout)."""
    daxes = data_axes(mesh)
    dsize = 1
    for a in daxes:
        dsize *= _axis_size(mesh, a)
    dspec = daxes if len(daxes) > 1 else daxes[0]

    def one(path, leaf):
        p = keystr(path)
        if _ndim(leaf) == 0:
            return NamedSharding(mesh, P())
        shape = tuple(leaf.shape)
        spec = param_spec_for(p, shape, mesh)
        if p.startswith("[<flat index 1>]"):     # TrainState.opt subtree
            parts = list(spec) + [None] * (len(shape) - len(spec))
            cands = sorted(range(len(shape)), key=lambda d: -shape[d])
            for d in cands:
                if parts[d] is None and shape[d] % dsize == 0:
                    parts[d] = dspec
                    break
            spec = P(*parts)
        return NamedSharding(mesh, spec)

    return tree_map_with_path(one, state_spec)


# ---------------------------------------------------------------------------
# batch / cache shardings
# ---------------------------------------------------------------------------


def _batch_spec(mesh, shape, *, model_dims=()) -> P:
    """Shard dim 0 over the data axes when divisible; given ``model_dims``
    additionally shard that dim over 'model' when divisible."""
    daxes = data_axes(mesh)
    dsize = 1
    for a in daxes:
        dsize *= _axis_size(mesh, a)
    parts: list = [None] * len(shape)
    if shape and shape[0] % dsize == 0 and shape[0] > 0:
        parts[0] = daxes if len(daxes) > 1 else daxes[0]
    msize = _axis_size(mesh, "model")
    for d in model_dims:
        if d < len(shape) and shape[d] % msize == 0 and shape[d] >= msize:
            parts[d] = "model"
    return P(*parts)


def batch_shardings(mesh, batch_spec):
    """For train/prefill input dicts: tokens/labels/weights/prefix."""
    def one(path, leaf):
        return NamedSharding(mesh, _batch_spec(mesh, tuple(leaf.shape)))

    return tree_map_with_path(one, batch_spec)


def cache_shardings(mesh, cache_spec):
    """Decode cache: dim 0 is the layer stack; dim 1 the batch; shard the
    head-ish dim over 'model' when divisible."""
    def one(path, leaf):
        p = keystr(path)
        shape = tuple(leaf.shape)
        if _ndim(leaf) <= 1:                     # pos
            return NamedSharding(mesh, _batch_spec(mesh, shape))
        daxes = data_axes(mesh)
        dsize = 1
        for a in daxes:
            dsize *= _axis_size(mesh, a)
        msize = _axis_size(mesh, "model")
        parts: list = [None] * len(shape)
        if shape[1] % dsize == 0:
            parts[1] = daxes if len(daxes) > 1 else daxes[0]
        if "'k'" in p or "'v'" in p:             # (L,B,ctx,Hkv,hd)
            # sequence-sharded KV cache (flash-decode style): the ctx dim
            # is always a multiple of the axis
            if shape[2] % msize == 0:
                parts[2] = "model"
            elif shape[3] % msize == 0:
                parts[3] = "model"
        elif "'ckv'" in p:                        # (L,B,ctx,width)
            if shape[2] % msize == 0:
                parts[2] = "model"
        elif "'ssm'" in p:                        # (L,B,H,P,N)
            if shape[2] % msize == 0:
                parts[2] = "model"
        elif "'conv'" in p:                       # (L,B,W,CH)
            if shape[3] % msize == 0:
                parts[3] = "model"
        return NamedSharding(mesh, P(*parts))

    return tree_map_with_path(one, cache_spec)


def decode_input_shardings(mesh, specs):
    """{"cache": ..., "tokens": (B,1)}"""
    return {
        "cache": cache_shardings(mesh, specs["cache"]),
        "tokens": NamedSharding(mesh, _batch_spec(
            mesh, tuple(specs["tokens"].shape))),
    }


def logits_sharding(mesh, ndim: int, batch: int, vocab: int
                    ) -> NamedSharding:
    """(B, S, V) / (B, S, ncb, V): batch over data, vocab over model —
    each only when divisible."""
    daxes = data_axes(mesh)
    dsize = 1
    for a in daxes:
        dsize *= _axis_size(mesh, a)
    parts: list = [None] * ndim
    if batch % dsize == 0:
        parts[0] = daxes if len(daxes) > 1 else daxes[0]
    if vocab % _axis_size(mesh, "model") == 0:
        parts[-1] = "model"
    return NamedSharding(mesh, P(*parts))


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def _mesh_of(path, sharding):
    """The sharding's mesh, refused where nothing can be placed on it."""
    mesh = sharding.mesh
    if mesh.abstract:
        raise NotImplementedError(
            f"placing {keystr(path) or 'a leaf'} on the abstract mesh "
            f"{mesh.shape}: it has no devices; size with NamedSharding."
            "shard_shape, or place on a mesh over a world "
            "(launch.mesh.make_device_mesh) or on one device "
            "(launch.mesh.make_host_mesh)")
    if mesh.device_mesh is None and len(mesh.devices) != 1:
        raise NotImplementedError(
            f"placing {keystr(path) or 'a leaf'} on a mesh of "
            f"{mesh.shape} over several devices needs its torch."
            "distributed DeviceMesh: build it with launch.mesh."
            "make_device_mesh over an initialised world, one process a "
            "device")
    return mesh


def _local_device(mesh) -> torch.device:
    dm = mesh.device_mesh
    return mesh.devices[dm.get_rank() if dm is not None else 0]


def place(tree, shardings):
    """Put every tensor leaf of ``tree`` where its sharding (a tree of
    :class:`NamedSharding` of the same structure) says; a non-tensor leaf
    (a step count) passes through.

    On a mesh of one device that is the whole leaf on that device: a leaf
    already there is returned as it is (no copy, the same storage).  On a
    mesh over a world each leaf becomes a DTensor with the spec's
    placements: every rank holds the same leaf (drawn from the same seed)
    and keeps its own shard, with no communication (a full-depth
    deepseek-v2-lite-16b's bf16 leaves, 31 GB, fit a card beside their
    shards), and a replicated leaf keeps its storage.
    Raises ``NotImplementedError`` on an abstract mesh, or on a mesh of
    several devices without a ``DeviceMesh``."""
    def one(path, leaf, sharding):
        mesh = _mesh_of(path, sharding)
        if not isinstance(leaf, torch.Tensor):
            return leaf
        leaf = leaf.to(_local_device(mesh))
        if mesh.device_mesh is None:
            return leaf
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(leaf, mesh.device_mesh,
                                 sharding.placements(), src_data_rank=None)

    return tree_map_with_path(one, tree, shardings)


def place_zeros(spec, shardings):
    """Zeros of each leaf's shape and dtype of ``spec`` (tensors on any
    device, e.g. ``meta``: an optimizer's initial state drawn from the
    parameters' spec), placed as :func:`place` would place them, each
    rank allocating only its shard."""
    def one(path, leaf, sharding):
        mesh = _mesh_of(path, sharding)
        if not isinstance(leaf, torch.Tensor):
            return leaf
        if mesh.device_mesh is None:
            return torch.zeros(leaf.shape, dtype=leaf.dtype,
                               device=_local_device(mesh))
        from torch.distributed.tensor import zeros
        return zeros(tuple(leaf.shape), dtype=leaf.dtype,
                     device_mesh=mesh.device_mesh,
                     placements=sharding.placements())

    return tree_map_with_path(one, spec, shardings)


def gather(tree):
    """Every DTensor leaf of ``tree`` as its full tensor (a collective:
    every rank calls it); other leaves pass through."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)
