"""feel-mlp — the paper's own experiment-scale classifier.

The paper trains CIFAR-10 models; offline the system uses an MLP over
3072-dim (32x32x3) synthetic inputs with 10 classes:
3072 → 256 → 256 → 10 (855 050 parameters).
"""

INPUT_DIM = 3072
HIDDEN = 256
DEPTH = 3
CLASSES = 10
