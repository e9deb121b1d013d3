"""Architecture configs (port copy of the reference's ``configs/base.py``).

An :class:`ArchConfig` is a frozen description of one decoder model; the
big-model FEEL families derive theirs from a spec's ``(hidden, depth)``
(``fed.model_engine.family_arch``).  The fields are the reference's, so
a config written for it reads the same.  ``models.model.init`` and
``forward`` run the ``dense`` family (SwiGLU or the 2-matrix GELU
``ffn_kind="mlp"``), ``vlm`` (a ``vlm_prefix``), ``audio``
(``n_codebooks``), ``ssm`` (an :class:`SSMConfig` with
``attn_kind="none"``), ``hybrid`` (an SSM and ``hybrid_every``) and
``moe`` (a :class:`MoEConfig`), with multi-head latent attention
(``attn_kind="mla"`` and an :class:`MLAConfig`) in the dense and MoE
families, and refuse the values that select parts not ported (another
``norm_eps``, a field of one family on another).
:meth:`ArchConfig.reduced` is the reference's CPU-smoke variant of the
same family (2 layers, d_model 256), for tests.  A :class:`ShapeConfig`
is one (sequence length, global batch, mode) input shape of the
reference's dry-run contract (:data:`SHAPES`), which
``fed.train_step.input_specs`` turns into abstract inputs.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # shared (always-on) experts, DeepSeek style
    dense_residual: bool = False  # Arctic: dense FFN in parallel with MoE
    first_dense_layers: int = 0   # DeepSeek: layer 0 is a dense FFN
    router_noise: float = 0.0
    load_balance_coef: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2 / MiniCPM3)."""
    kv_lora_rank: int
    q_lora_rank: Optional[int]
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


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
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
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
        sizes of its init's leaves, drawn on the ``meta`` device, so no
        memory is allocated (the reference counts the same shapes through
        ``jax.eval_shape``)."""
        from repro_torch.models.model import MetaGenerator, init
        from repro_torch.tree import tree_leaves

        params = init(self, MetaGenerator())
        return sum(t.numel() for t in tree_leaves(params))

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k only + shared)."""
        if self.moe is None:
            return self.param_count()
        total = self.param_count()
        m = self.moe
        moe_layers = self.n_layers - m.first_dense_layers
        per_expert = 3 * self.d_model * m.d_ff_expert
        inactive = moe_layers * (m.n_experts - m.top_k) * per_expert
        return total - inactive

    def reduced(self) -> "ArchConfig":
        """CPU smoke variant: same family/wiring, tiny dims (the
        reference's ``reduced``)."""
        kw = dict(
            name=self.name + "-smoke",
            n_layers=2,
            d_model=256,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=512,
            vocab=min(self.vocab, 512),
            head_dim=64 if self.n_heads else 0,
            attn_window=(min(self.attn_window, 64) if self.attn_window
                         else None),
            hybrid_every=1 if self.hybrid_every else 0,
            vlm_prefix=16 if self.vlm_prefix else 0,
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(self.moe.top_k, 2),
                d_ff_expert=128,
                n_shared=min(self.moe.n_shared, 1),
                first_dense_layers=min(self.moe.first_dense_layers, 1),
            )
        if self.mla is not None:
            kw["mla"] = MLAConfig(
                kv_lora_rank=64,
                q_lora_rank=64 if self.mla.q_lora_rank else None,
                qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
            )
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=32, chunk=32)
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                     # train | prefill | decode


SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,   32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",  524_288,    1, "decode"),
}


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]
