"""zamba2-7b — Mamba-2 backbone with one shared attention block
[arXiv:2411.15242].

81 Mamba-2 layers (d_model 3584, state 64) in 9 segments of 9; after each
segment ONE shared attention + SwiGLU block (32 heads of 112, MHA, d_ff
14336) runs with the same weights.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    head_dim=112,
    ssm=SSMConfig(d_state=64, head_dim=64),
    hybrid_every=9,
    source="arXiv:2411.15242",
)
