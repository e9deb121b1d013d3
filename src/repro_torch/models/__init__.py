"""Decoder models of the big-model FEEL families (port of the reference's
``repro.models``): the dense transformer family."""
