"""deepseek-v2-lite-16b — MLA + fine-grained MoE [arXiv:2405.04434].

27L, d_model 2048, 16 heads, MLA kv_lora=512 (no q_lora in Lite),
MoE: 64 routed experts top-6 + 2 shared, expert d_ff 1408; layer 0 dense
(d_ff 10944).  These are V2-Lite's numbers (the full V2-236B routes over
160 experts).
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,                    # dense layer-0 FFN width
    vocab=102400,
    attn_kind="mla",
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=None,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        d_ff_expert=1408,
        n_shared=2,
        first_dense_layers=1,
    ),
    source="arXiv:2405.04434",
)
