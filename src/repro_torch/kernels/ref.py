"""Plain oracles of the kernels' compositions (the allclose targets)."""
from repro_torch.compression.sbc import sbc_tensor as sbc_ref  # noqa: F401
