"""The sweep-batch mesh: a flat ``"batch"`` axis over devices, on which an
executor would shard the flattened (scenario × seed) axis of a bucket.

A port of the reference's sweep-mesh helpers (``make_batch_mesh``,
``ensure_batch_mesh``, ``pad_batch``).  The mesh is a plain value — axis
names and a tuple of ``torch.device`` — built from a function, so
importing this module touches no device.  One device is the only layout
the executors run today (the bucket runs on that device); sharding the
batch axis over several cards waits for a multi-card path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class Mesh:
    """Devices along named axes (a 1-D ``("batch",)`` mesh for sweeps)."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("batch",)

    @property
    def size(self) -> int:
        return len(self.devices)


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


def pad_batch(n: int, mesh: Mesh) -> int:
    """Rows to append so a length-``n`` batch axis divides the mesh."""
    return (-n) % mesh.size


def ensure_batch_mesh(mesh) -> Mesh:
    """Validate a sweep mesh: the executors place the flattened
    (scenario × seed) axis on a ``"batch"`` axis, so a mesh without one
    fails here."""
    if "batch" not in getattr(mesh, "axis_names", ()):
        raise ValueError(
            f"expected a 1-D sweep mesh with a 'batch' axis "
            f"(launch.mesh.make_batch_mesh); got axes "
            f"{getattr(mesh, 'axis_names', ())!r}")
    return mesh
