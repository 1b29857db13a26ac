"""Probability distributions (PyTorch port of ``advancedps_tpu/distributions.py``).

This slice ports ``Normal``.  A distribution is a light value of tensors, made
afresh at every step from the model's buffers (``Normal(a·x + b, q)``), so it is
a plain class and not an ``nn.Module``.  ``scale`` is the standard deviation.
"""

from __future__ import annotations

import math

import torch

from .rng import StepRng

__all__ = ["Normal"]

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


class Normal:
    """Gaussian with mean ``loc`` and standard deviation ``scale`` (broadcasting)."""

    def __init__(self, loc, scale):
        self.loc = torch.as_tensor(loc, dtype=torch.float32)
        self.scale = torch.as_tensor(scale, dtype=torch.float32, device=self.loc.device)

    @property
    def batch_shape(self) -> torch.Size:
        return torch.broadcast_shapes(self.loc.shape, self.scale.shape)

    def sample(self, generator: torch.Generator, sample_shape=()) -> torch.Tensor:
        """Draw with a ``torch.Generator`` (used by :func:`~advancedps_tpu_torch.ssm.simulate`)."""
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        shape = tuple(sample_shape) + tuple(self.batch_shape)
        eps = torch.randn(shape, generator=generator, dtype=torch.float32,
                          device=generator.device)
        return self.loc + self.scale * eps.to(self.loc.device)

    def sample_rng(self, rng: StepRng, draw: int = 0) -> torch.Tensor:
        """Positional draw: element ``i`` is a pure function of
        ``(rng.key, draw, rng.gids[i])``."""
        return self.loc + self.scale * rng.normal(draw)

    def log_prob(self, x) -> torch.Tensor:
        z = (x - self.loc) / self.scale
        return -0.5 * z * z - torch.log(self.scale) - _HALF_LOG_2PI
