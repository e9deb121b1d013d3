"""mistral-nemo-12b — dense, 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407].

40L, d_model 5120, 32 Q heads (head_dim 128), GQA kv=8, d_ff 14336,
vocab 131072 (Tekken tokenizer).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=131072,
    head_dim=128,
    rope_theta=1_000_000.0,
    source="hf:mistralai/Mistral-Nemo-Base-2407",
)
