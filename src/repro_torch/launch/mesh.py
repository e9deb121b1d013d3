"""Meshes: devices (or, for a production mesh, none) along named axes
(port of the reference's ``launch/mesh.py``).

A :class:`Mesh` is a plain value — axis names, their sizes in order
(``mesh.shape[name]``, as the sharding rules read it) and a tuple of
``torch.device`` — built from a function, so importing this module
touches no device.  Three kinds are built here:

* **Production meshes** (:func:`make_production_mesh`): ``("data",
  "model")`` at 16 × 16, or ``("pod", "data", "model")`` at 2 × 16 × 16
  with ``multi_pod``.  They are *abstract*: they hold no devices, since
  256 cards are not there.  They size the sharding rules
  (:mod:`.sharding`) from one host, as the reference's dry run does on
  forced host devices.
* **The host mesh** (:func:`make_host_mesh`): (1, 1) over one device
  with the production axis names; the dry-run driver places its step's
  tensors through it.
* **A device mesh over a world** (:func:`make_device_mesh`): the
  production axis names at a small shape (2 × 2, or 2 × 1 × 2 with a
  ``"pod"`` axis) over the ranks of an initialised ``torch.distributed``
  world (:func:`init_world`), one process a device: rank r on
  ``cuda:r`` modulo the cards it sees under NCCL, on the CPU under
  ``gloo``.  It carries its ``torch.distributed`` ``DeviceMesh`` (without
  the axes of size one, which split nothing), on which
  :func:`~repro_torch.launch.sharding.place` makes DTensors.
* **The sweep-batch mesh** (:func:`make_batch_mesh`): a flat ``"batch"``
  axis over devices, on which the executors shard the flattened
  (scenario × seed) axis of a bucket (rows padded cyclically to a
  multiple of the mesh, :func:`pad_batch`).  Its devices may repeat one
  device: several entries of ``cpu`` stand in for the reference's
  forced host devices.

:class:`P` and :class:`NamedSharding` are plain values as well: a
partition spec (one entry a dimension: an axis name, a tuple of names,
or None) and its mesh.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist


class P(tuple):
    """A partition spec, as the reference's ``PartitionSpec``: one entry a
    leading dimension — an axis name, a tuple of names (the dimension
    split over their product), or None (replicated); dimensions past the
    end are replicated.  Compares as the tuple of its entries."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "P" + tuple.__repr__(self)


@dataclass(frozen=True)
class Mesh:
    """Devices along named axes.  ``axis_sizes`` defaults to
    ``len(devices)`` along the first axis and 1 along the others; an
    *abstract* mesh has sizes and no devices.  ``device_mesh`` is the
    ``torch.distributed`` ``DeviceMesh`` of a mesh over a world's ranks
    (:func:`make_device_mesh`), else None."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("batch",)
    axis_sizes: Optional[Tuple[int, ...]] = None
    device_mesh: Any = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.axis_sizes is None:
            object.__setattr__(self, "axis_sizes", (len(self.devices),) + (
                1,) * (len(self.axis_names) - 1))
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"axes {self.axis_names} with sizes "
                             f"{self.axis_sizes}")
        if self.devices and math.prod(self.axis_sizes) != len(self.devices):
            raise ValueError(f"a mesh of {self.axis_sizes} over "
                             f"{len(self.devices)} devices")

    @property
    def shape(self) -> dict:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def abstract(self) -> bool:
        return not self.devices


@dataclass(frozen=True)
class NamedSharding:
    """A leaf's partition ``spec`` over ``mesh``'s axes."""
    mesh: Mesh
    spec: P

    def shard_shape(self, shape) -> tuple:
        """The per-device shape of a leaf of ``shape``: each dimension
        over the product of its axes' sizes, rounded up where it does not
        divide (GSPMD pads an uneven dimension, as arctic's 56 heads over
        16)."""
        out = list(shape)
        for d, axes in enumerate(self.spec):
            if axes is None:
                continue
            names = axes if isinstance(axes, tuple) else (axes,)
            ways = math.prod(self.mesh.shape[a] for a in names)
            out[d] = -(-out[d] // ways)
        return tuple(out)

    def placements(self) -> tuple:
        """The spec as DTensor placements, one a dimension of the mesh's
        ``DeviceMesh``: ``Shard(d)`` on each axis that dimension d is
        split over (a tuple of axes, as ``("pod", "data")``, shards d on
        each of them, the first the major, as the reference orders them),
        ``Replicate()`` on the others.  An axis of size one splits
        nothing: it takes ``Replicate()``, or the ``DeviceMesh`` leaves it
        out."""
        from torch.distributed.tensor import Replicate, Shard
        names = tuple(self.mesh.device_mesh.mesh_dim_names)
        out = [Replicate()] * len(names)
        for d, axes in enumerate(self.spec):
            if axes is None:
                continue
            axes = axes if isinstance(axes, tuple) else (axes,)
            order = [self.mesh.axis_names.index(a) for a in axes]
            if order != sorted(order):
                raise ValueError(f"spec {self.spec}: axes {axes} out of "
                                 f"the mesh's order {self.mesh.axis_names}")
            for a in axes:
                if a in names and self.mesh.shape[a] > 1:
                    out[names.index(a)] = Shard(d)
        return tuple(out)


def canonical_device(device) -> torch.device:
    """``device`` with a CUDA index filled in (``cuda`` is the current
    card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16×16 = 256 chips a pod; 2 pods = 512 chips when ``multi_pod``.
    Abstract: no devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh((), axes, shape)


def make_host_mesh(device="cuda") -> Mesh:
    """A (1, 1) mesh over one device, with the production axis names.
    Raises when CUDA is asked for and not available."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available for a host mesh; "
                           "pass device='cpu' for the CPU")
    return Mesh((canonical_device(device),), ("data", "model"), (1, 1))


def init_world(backend: Optional[str] = None, *,
               init_method: Optional[str] = None,
               rank: Optional[int] = None,
               world_size: Optional[int] = None) -> int:
    """Join (or find) the ``torch.distributed`` world and return its size.

    The rank and world size come from the arguments or from ``RANK`` and
    ``WORLD_SIZE``, the rendezvous from ``init_method`` or from
    ``MASTER_ADDR`` and ``MASTER_PORT`` (given by hand, or by ``torchrun
    --standalone``).  Raises ``RuntimeError`` when they are absent: it
    never makes a one-rank world on its own.  ``backend`` defaults to
    NCCL where CUDA is available, else ``gloo``; under NCCL the rank's
    card (``cuda:rank`` modulo the cards it sees) becomes the current
    one."""
    if dist.is_initialized():
        return dist.get_world_size()
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    missing = [name for name, v in (("RANK", rank),
                                    ("WORLD_SIZE", world_size)) if v is None]
    if init_method is None:
        missing += [n for n in ("MASTER_ADDR", "MASTER_PORT")
                    if n not in os.environ]
    if missing:
        raise RuntimeError(
            f"no torch.distributed world: {', '.join(missing)} not set; "
            "run under torchrun --standalone --nproc-per-node N, or set "
            "RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size)
    return world_size


def make_device_mesh(shape, axes=("data", "model")) -> Mesh:
    """A mesh of ``shape`` along ``axes`` over every rank of the
    initialised world (:func:`init_world`), row-major: rank r at
    ``cuda:r`` modulo the cards a process sees under NCCL, or at ``cpu``
    under ``gloo``.  Raises when no world is initialised or its size is
    not the mesh's."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a device mesh of {shape} needs an initialised torch."
            "distributed world (launch.mesh.init_world)")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of {shape} over a world of {world}")
    if dist.get_backend() == "nccl":
        cards = torch.cuda.device_count()
        devices = tuple(torch.device("cuda", r % cards) for r in range(world))
        kind = "cuda"
    else:
        devices, kind = (torch.device("cpu"),) * world, "cpu"
    # an axis of size one splits nothing: the DeviceMesh leaves it out
    # (each of its dimensions multiplies DTensor's propagation work),
    # unless every axis is of size one
    kept = [(n, a) for n, a in zip(shape, axes) if n > 1] or list(
        zip(shape, axes))
    dm = init_device_mesh(kind, tuple(n for n, _ in kept),
                          mesh_dim_names=tuple(a for _, a in kept))
    return Mesh(devices, axes, shape, dm)


def parse_mesh(text: str, multi_pod: bool = False):
    """``"2x2"`` → ``((2, 2), ("data", "model"))``; with ``multi_pod`` a
    three-part ``"2x1x2"`` → ``("pod", "data", "model")``."""
    shape = tuple(int(n) for n in text.lower().split("x"))
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if len(shape) != len(axes):
        raise ValueError(f"mesh {text!r} must have {len(axes)} parts "
                         f"({'x'.join(axes)})")
    return shape, axes


def data_axes(mesh) -> tuple:
    """Every axis that carries the batch (all but ``"model"``)."""
    return tuple(n for n in mesh.axis_names if n != "model")


def data_size(mesh) -> int:
    out = 1
    for n in data_axes(mesh):
        out *= mesh.shape[n]
    return out


def make_batch_mesh(max_devices: Optional[int] = None,
                    device: str = "cuda") -> Mesh:
    """1-D mesh over (up to ``max_devices``) CUDA devices, or over the CPU
    when ``device`` is ``"cpu"``.  Raises when CUDA is asked for and not
    available."""
    if torch.device(device).type == "cpu":
        devs = [torch.device("cpu")]
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available for a batch mesh; pass "
                "device='cpu' for the CPU")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if max_devices is not None:
        devs = devs[:max_devices]
    return Mesh(tuple(devs), ("batch",))


def batch_sharding(mesh) -> NamedSharding:
    """Leading axis split over ``"batch"``, remaining dims replicated."""
    return NamedSharding(mesh, P("batch"))


def replicated_sharding(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_batch(n: int, mesh: Mesh) -> int:
    """Rows to append so a length-``n`` batch axis divides the mesh."""
    return (-n) % mesh.size


def ensure_batch_mesh(mesh) -> Mesh:
    """Validate a sweep mesh: the executors place the flattened
    (scenario × seed) axis on a ``"batch"`` axis, so a mesh without one
    (e.g. the production meshes above) fails here."""
    if "batch" not in getattr(mesh, "axis_names", ()):
        raise ValueError(
            f"expected a 1-D sweep mesh with a 'batch' axis "
            f"(launch.mesh.make_batch_mesh); got axes "
            f"{getattr(mesh, 'axis_names', ())!r}")
    return mesh
