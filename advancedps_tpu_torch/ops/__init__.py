"""Kernel layer: hand-written CUDA kernels with their plain PyTorch versions."""

from . import resample, threefry

__all__ = ["resample", "threefry"]
