"""Launch drivers (port of the reference's ``launch``): ``serve``, the
batched token-decode driver."""
