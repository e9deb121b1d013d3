"""llava-next-mistral-7b — VLM, Mistral-7B backbone with an anyres
vision prefix [hf:llava-hf/llava-v1.6-mistral-7b-hf].

32L, d_model 4096, 32 heads (GQA kv=8), d_ff 14336, vocab 32000.  The
vision tower and projector are a stub, as in the reference: the caller
gives pre-projected patch embeddings (up to 2880 = 5 tiles of 24 x 24),
which replace the first positions of the text.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    head_dim=128,
    vlm_prefix=2880,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
