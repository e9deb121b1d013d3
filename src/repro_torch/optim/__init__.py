"""Optimizers (port of the reference's ``repro.optim``): plain SGD, the
paper's Step 5."""
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, apply_updates, sgd)
