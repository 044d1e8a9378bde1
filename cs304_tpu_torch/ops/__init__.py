"""Tensor ops of the port. Kernel wrappers live in ``ops/cuda``."""
