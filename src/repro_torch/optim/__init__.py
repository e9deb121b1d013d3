"""Optimizers (port of the reference's ``repro.optim``): plain SGD (the
paper's Step 5), SGD with momentum and AdamW."""
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adamw, apply_updates, momentum, sgd)
