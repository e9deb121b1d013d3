"""Launch drivers (port of the reference's ``launch``): ``serve``, the
batched token-decode driver, and ``mesh``, the sweep-batch mesh of the
experiment executors."""
