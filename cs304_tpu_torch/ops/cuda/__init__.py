"""Wrappers of the hand-written CUDA kernels (csrc/), the counterpart of the
JAX package's ops/pallas. Each wrapper sends a CPU tensor to its plain
PyTorch version and launches its kernel on a CUDA tensor (or raises), and
counts its launches in ``<wrapper>.launches``."""
