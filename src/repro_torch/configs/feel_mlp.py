"""feel-mlp — the paper's own experiment-scale classifier.

The paper trains CIFAR-10 models; offline the system uses an MLP over
3072-dim (32x32x3) synthetic inputs with 10 classes:
3072 → 256 → 256 → 10 (855 050 parameters).

:data:`CONFIG` is the reference registry's entry for it, field for
field.  Family ``"mlp"`` runs in :mod:`repro_torch.fed.feel_model`, not
in the decoder stack of ``models.model``, which refuses it.
"""
from repro_torch.configs.base import ArchConfig

INPUT_DIM = 3072
HIDDEN = 256
DEPTH = 3
CLASSES = 10

CONFIG = ArchConfig(
    name="feel-mlp",
    family="mlp",
    n_layers=DEPTH,
    d_model=HIDDEN,     # hidden width
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=CLASSES,      # classes
    attn_kind="none",
    source="paper §VI (CIFAR-10 class task, synthetic stand-in)",
)
