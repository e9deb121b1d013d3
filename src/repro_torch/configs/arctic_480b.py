"""arctic-480b — dense-MoE hybrid [hf:Snowflake/snowflake-arctic-base].

35L, d_model 7168, 56 Q heads (GQA kv=8), 128 routed experts top-2
(expert d_ff 4864) with a dense residual FFN in parallel; 7 query heads
share a KV head.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,                     # dense residual FFN width
    vocab=32000,
    head_dim=128,
    moe=MoEConfig(
        n_experts=128,
        top_k=2,
        d_ff_expert=4864,
        dense_residual=True,
    ),
    source="hf:Snowflake/snowflake-arctic-base",
)
