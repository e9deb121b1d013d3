"""PyTorch/CUDA port of the FEEL system (``repro``'s counterpart).

The package mirrors ``repro``'s layout module for module.  Host planning
(channel Monte-Carlo, Algorithm 1, the batcher) is a numpy copy whose
ledgers are bitwise the reference's; the device trajectory is PyTorch,
with the SBC uplink-compression pair as hand-written CUDA kernels
(``kernels/csrc/sbc.cu``).  It imports ``torch`` and ``numpy`` only —
never ``jax`` and no module of ``repro``.

Entry point: :class:`repro_torch.api.Experiment`, which runs on the GPU
unless the caller passes ``device="cpu"``.
"""
