"""Architecture configs (port copy of the reference's ``configs/base.py``).

An :class:`ArchConfig` is a frozen description of one decoder model; the
big-model FEEL families derive theirs from a spec's ``(hidden, depth)``
(``fed.model_engine.family_arch``).  The fields are the reference's, so
a config written for it reads the same.  ``models.model.init`` and
``forward`` run the ``dense`` family and the ``ssm`` family (an
:class:`SSMConfig` with ``attn_kind="none"``), and refuse the values that
select parts not ported (MoE, MLA, hybrid, codebooks, VLM prefix, qkv
bias, the GELU FFN, another ``norm_eps``, an SSM on a dense model).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 SSD block."""
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                  # query heads; 0 => attention-free
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 => d_model // n_heads
    qkv_bias: bool = False
    ffn_kind: str = "swiglu"      # swiglu | mlp (2-matrix GELU)
    rope_theta: float = 10_000.0
    attn_kind: str = "gqa"        # gqa | mla | none
    attn_window: Optional[int] = None   # sliding-window attention (tokens)
    moe: Optional[object] = None
    mla: Optional[object] = None
    ssm: Optional[SSMConfig] = None
    hybrid_every: int = 0
    n_codebooks: int = 1
    vlm_prefix: int = 0
    norm_eps: float = 1e-5
    source: str = ""

    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    def param_count(self) -> int:
        """Exact parameter count of the model the port instantiates: the
        sizes of its init's leaves (the reference counts the same shapes
        through ``jax.eval_shape``)."""
        import torch
        from repro_torch.models.model import init
        from repro_torch.tree import tree_leaves
        params = init(self, torch.Generator())
        return sum(t.numel() for t in tree_leaves(params))
