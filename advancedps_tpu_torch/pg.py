"""Particle Gibbs (PG) and PG with ancestor sampling (PGAS) (PyTorch port of
``advancedps_tpu/pg.py``).

One PG(AS) iteration is one conditional SMC sweep: the retained trajectory
rides in slot ``N−1``, reading its stored states instead of sampling and
surviving every resampling; then a new retained trajectory is drawn ∝ the
final weights and reconstructed through the genealogy
(:func:`~advancedps_tpu_torch.inference.step_pg`).

PGAS defaults to resampling at every step (threshold 1.0).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from .smc import _build_gated_resampler

__all__ = ["PG", "PGAS", "PGState", "PGSample"]


class PG:
    """Particle Gibbs sampler config."""

    ancestor_sampling = False

    def __init__(self, n_particles: int, resampler=None, threshold=None):
        self.n_particles = int(n_particles)
        self.resampler = _build_gated_resampler(resampler, threshold)

    def __repr__(self):
        return (
            f"{type(self).__name__}(n_particles={self.n_particles}, "
            f"resampler={self.resampler})"
        )


class PGAS(PG):
    """PG with ancestor sampling; defaults to always-resample (threshold 1.0)."""

    ancestor_sampling = True

    def __init__(self, n_particles: int, resampler=None, threshold=None):
        if resampler is None and threshold is None:
            threshold = 1.0
        super().__init__(n_particles, resampler, threshold)


@dataclass
class PGState:
    """Chain state: the retained trajectory ``[T, ...]``."""

    trajectory: Any


@dataclass
class PGSample:
    """One chain draw, or a chain's draws stacked on a leading axis:
    ``trajectory`` ``[T, ...]`` (``[n_iterations, T, ...]``) and
    ``log_evidence`` scalar (``[n_iterations]``)."""

    trajectory: Any
    log_evidence: torch.Tensor
