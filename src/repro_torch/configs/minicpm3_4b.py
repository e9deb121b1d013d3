"""minicpm3-4b — dense with MLA [hf:openbmb/MiniCPM3-4B].

62L, d_model 2560, 40 heads, MLA (kv_lora 256, q_lora 768, qk_nope 64,
qk_rope 32, v_head 64), d_ff 6400, vocab 73448 (padded to 73472, a multiple of
128; padded logits masked).
"""
from repro_torch.configs.base import ArchConfig, MLAConfig

CONFIG = ArchConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab=73448,
    attn_kind="mla",
    mla=MLAConfig(
        kv_lora_rank=256,
        q_lora_rank=768,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
    ),
    source="hf:openbmb/MiniCPM3-4B",
)
