"""granite-34b — dense llama-arch code model [arXiv:2405.04324].

88L, d_model 6144, 48 Q heads, GQA kv=1 (MQA), d_ff 24576, vocab 49152,
the GPT-BigCode 2-matrix GELU MLP (``ffn_kind="mlp"``).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    head_dim=128,
    ffn_kind="mlp",
    source="arXiv:2405.04324",
)
