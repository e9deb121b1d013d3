"""musicgen-large — decoder-only over EnCodec tokens [arXiv:2306.05284].

48L, d_model 2048, 32 heads (MHA), d_ff 8192, vocab 2048 per codebook,
4 EnCodec codebooks.  The EnCodec frontend is a stub, as in the
reference: inputs are codec token ids (B, S, 4); the model sums the
codebooks' embeddings and has one LM head a codebook.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=2048,
    head_dim=64,
    n_codebooks=4,
    source="arXiv:2306.05284",
)
