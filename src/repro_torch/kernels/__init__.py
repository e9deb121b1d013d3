"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version.  Sources live in ``csrc/``; :mod:`.build` compiles them
with ``nvcc`` at first use and binds them with ``ctypes``."""
