"""mamba2-2.7b — attention-free SSD state-space model [arXiv:2405.21060].

64L, d_model 2560, d_state 128, expand 2 (d_inner 5120, 80 SSD heads of
head_dim 64), vocab 50280.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    attn_kind="none",
    ssm=SSMConfig(d_state=128, head_dim=64),
    source="arXiv:2405.21060",
)
