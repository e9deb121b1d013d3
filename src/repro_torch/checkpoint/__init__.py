"""Checkpoints of parameter trees (port of the reference's
``repro.checkpoint``), in the reference's file format."""
from repro_torch.checkpoint.ckpt import (restore, restore_state, save,
                                         save_state)

__all__ = ["save", "restore", "save_state", "restore_state"]
