"""Launch drivers (port of the reference's ``launch``): ``train``, the
FEEL training driver of the transformer zoo; ``serve``, the batched
token-decode driver; and ``mesh``, the sweep-batch mesh of the
experiment executors."""
