"""Weights carried across between the reference's numpy arrays and the
port's tensors.

The reference draws its initial weights with ``jax.random``, a stream
torch cannot reproduce; parity checks give both packages the same init
by converting the reference's parameter trees — feel-mlp's list of
``{"w", "b"}``, or the nested dicts of a transformer or a mamba2 model
(``layers.mixer.{in_proj, conv_w, A_log, ...}``), with or without a
leading row axis, the audio and hybrid families' trees with their
codebook axis (``embed.table`` (n_cb, pv, d), ``lm_head`` (n_cb, d, pv))
and their ``shared_attn`` block, and the MoE family's with its dense
blocks (``dense0``) and stacked experts (``layers.moe.experts.*``, (L,
E, ...)) — through these two functions.  The same two carry a decode
parameter set (the reference's ``init`` tree, stacked layers and no copy
axis: the port's decode layout) and a decode cache (``pos``, ``k``/``v``,
MLA's ``ckv`` and ``conv``/``ssm``, the port's :func:`init_cache`
layout) across and back: the layouts are the reference's, so only the
arrays change hands.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map


def params_from_numpy(tree, device="cpu"):
    """A tree of numpy (or array-like) leaves → tensors on ``device``."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def params_to_numpy(params):
    """The inverse of :func:`params_from_numpy`."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)
