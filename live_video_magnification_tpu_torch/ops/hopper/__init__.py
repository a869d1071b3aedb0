"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version. Sources are in ``csrc/``; ``_build.py`` compiles them at first
use."""
