"""Resampling (PyTorch port of ``advancedps_tpu/resampling.py``, main-path part).

Resamplers share the signature ``resampler(key, weights, n) -> int32[n]`` with
normalised ``weights``.  This slice ports systematic resampling and the ESS gate.
The sweep does not call :func:`resample_systematic` itself: it recognises it and
runs the same draw through the kernels of :mod:`advancedps_tpu_torch.ops.resample`
(extents, decode, move), which agree with this searchsorted form up to ±1
boundary flips in float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from . import rng as rngmod

__all__ = [
    "resample_systematic",
    "DEFAULT_RESAMPLER",
    "ResampleWithESSThreshold",
    "effective_sample_size",
]


def _inverse_cdf(weights: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
    """``idx_i = j`` iff ``u_i ∈ [cum_{j-1}, cum_j)``, clamped to the last index
    (a float cumsum may end slightly below 1)."""
    cdf = torch.cumsum(weights, 0)
    idx = torch.searchsorted(cdf, us, right=True)
    return torch.clamp(idx, 0, weights.shape[0] - 1).to(torch.int32)


def resample_systematic(key: rngmod.Key, weights: torch.Tensor, n: int) -> torch.Tensor:
    """Systematic resampling: one shared uniform, positions ``(u + k) / n``."""
    u = rngmod.uniform(key)
    us = (u + torch.arange(n, dtype=weights.dtype, device=weights.device)) / n
    return _inverse_cdf(weights, us)


DEFAULT_RESAMPLER = resample_systematic


def effective_sample_size(weights: torch.Tensor) -> torch.Tensor:
    """ESS = 1 / Σ wᵢ² of normalised weights."""
    return 1.0 / torch.sum(torch.square(weights))


@dataclass(frozen=True)
class ResampleWithESSThreshold:
    """Resample with ``resampler`` iff ESS ≤ ``threshold · n``."""

    resampler: Callable = DEFAULT_RESAMPLER
    threshold: float = 0.5

    def __call__(self, key, weights, n):
        return self.resampler(key, weights, n)

    def should_resample(self, weights, n):
        return effective_sample_size(weights) <= self.threshold * n
