"""Decoder models of the big-model FEEL families (port of the reference's
``repro.models``): the dense transformer family and the mamba2 (SSM)
family, with the reference's ``param_spec`` and ``cache_spec`` (shapes
and dtypes on the ``meta`` device)."""
from repro_torch.models.model import cache_spec, param_spec  # noqa: F401
