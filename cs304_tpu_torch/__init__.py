"""PyTorch + CUDA port of cs304_tpu for one NVIDIA H100.

The batched continuous decoder (raw audio -> 39-dim MFCC -> full-covariance
Gaussian emissions -> composite Viterbi -> word labels) runs on tensors; its
three kernels (quadratic-form emissions, scan-free trellis forward and
backtrace) are hand-written CUDA C++ under ``csrc/``, built with nvcc at first
use. CPU tensors take each kernel's plain PyTorch version.

This package imports neither ``jax`` nor ``cs304_tpu``; the JAX package is
the reference it is tested against.
"""
from .device import fp32_exact, resolve_device

__all__ = ["fp32_exact", "resolve_device"]
