"""Kernel layer: hand-written CUDA kernels with their plain PyTorch versions."""

from . import levy, resample, threefry

__all__ = ["levy", "resample", "threefry"]
