"""SSM sweep kernel + the SMC sampler (PyTorch port of ``advancedps_tpu/smc.py``).

:class:`SSMKernel` runs all particles at once: transition sample, observation
score and weight update are elementwise tensor ops over the particle axis.
The reference slot of a conditional sweep reads its state from the retained
trajectory through :func:`~advancedps_tpu_torch.engine.inject_ref`.  This
port covers the Markov, vectorized branch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from .engine import SweepKernel, inject_ref
from .resampling import DEFAULT_RESAMPLER, ResampleWithESSThreshold
from .ssm import TracedSSM

__all__ = ["SSMKernel", "SMC", "SMCSample"]


class SSMKernel(SweepKernel):
    """Drives the sweep engine over a :class:`~advancedps_tpu_torch.ssm.TracedSSM`
    with Markov, vectorized components; ``state = x`` with shape ``[N]``."""

    def __init__(self, ssm: TracedSSM):
        if not ssm.model.markov:
            raise NotImplementedError(
                "non-Markovian dynamics belong to the models slice of the port"
            )
        for part in (ssm.prior, ssm.dynamics, ssm.observation):
            if not part.vectorized:
                raise NotImplementedError(
                    f"{type(part).__name__} is not vectorized; per-particle-key "
                    "sampling belongs to a later slice of the port"
                )
        self.ssm = ssm

    @property
    def num_steps(self) -> int:
        return self.ssm.num_steps

    def _obs_logw(self, t, x):
        return self.ssm.observation.log_prob(t, x, self.ssm.observations[t])

    def init(self, rng, ref0, ref_mask):
        x0 = self.ssm.prior.distribution().sample_rng(rng)
        x0 = inject_ref(ref_mask, ref0, x0)
        return x0, self._obs_logw(0, x0)

    def step(self, t, rng, state, ref_t, ref_mask):
        x_new = self.ssm.dynamics.distribution(t, state).sample_rng(rng)
        x_new = inject_ref(ref_mask, ref_t, x_new)
        return x_new, self._obs_logw(t, x_new)

    def snapshot(self, state):
        return state

    def transition_logprob(self, t, state, ref_t):
        return self.ssm.dynamics.distribution(t, state).log_prob(ref_t)


def _build_gated_resampler(resampler, threshold):
    """The reference's convenience constructors:

    * neither given              → systematic @ ESS 0.5
    * threshold only             → systematic @ threshold
    * resampler fn only          → that resampler, every step
    * resampler + threshold      → that resampler @ threshold
    """
    if isinstance(resampler, ResampleWithESSThreshold):
        return resampler
    if resampler is None and threshold is None:
        return ResampleWithESSThreshold()
    if resampler is None:
        return ResampleWithESSThreshold(DEFAULT_RESAMPLER, float(threshold))
    if isinstance(resampler, float) and threshold is None:
        return ResampleWithESSThreshold(DEFAULT_RESAMPLER, resampler)
    if threshold is None:
        return ResampleWithESSThreshold(resampler, float("inf"))
    return ResampleWithESSThreshold(resampler, float(threshold))


class SMC:
    """Sequential Monte Carlo sampler config."""

    def __init__(self, n_particles: int, resampler=None, threshold=None):
        self.n_particles = int(n_particles)
        self.resampler = _build_gated_resampler(resampler, threshold)

    def __repr__(self):
        return f"SMC(n_particles={self.n_particles}, resampler={self.resampler})"


@dataclass
class SMCSample:
    """``trajectories`` ``[T, N, ...]`` (all weighted particle paths through the
    genealogy, or ``None``), ``weights`` normalised ``[N]``, ``log_evidence``
    scalar, ``diagnostics`` with per-step ``ess`` and ``resampled``."""

    trajectories: Any
    weights: torch.Tensor
    log_evidence: torch.Tensor
    diagnostics: Any = None
