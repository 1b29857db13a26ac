"""Kernel layer: hand-written CUDA kernels with their plain PyTorch versions."""

from . import resample

__all__ = ["resample"]
