"""SSM sweep kernel + the SMC sampler (PyTorch port of ``advancedps_tpu/smc.py``).

:class:`SSMKernel` runs all particles at once.  A vectorized component is one
batched call over the particle axis (the positional counted draw for the
prior and the dynamics); a component written for one particle runs under
:func:`torch.func.vmap` over the particles, each drawing with its own key
(:meth:`~advancedps_tpu_torch.rng.StepRng.particle_keys`, positional in the
global id), as the JAX package ``vmap``s it.  The reference slot of a
conditional sweep reads its state from the retained trajectory through
:func:`~advancedps_tpu_torch.engine.inject_ref`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch.func import vmap

from .engine import SweepKernel, inject_ref
from .resampling import DEFAULT_RESAMPLER, ResampleWithESSThreshold
from .ssm import History, TracedSSM

__all__ = ["SSMKernel", "SMC", "SMCSample"]


class SSMKernel(SweepKernel):
    """Drives the sweep engine over a :class:`~advancedps_tpu_torch.ssm.TracedSSM`.

    State layout:

    * Markov dynamics: ``state = x`` with shape ``[N, ...]``;
    * non-Markovian dynamics (``needs_history``): ``state = (x, buf)`` with
      ``buf`` the ``[N, T, ...]`` history handed to the dynamics as a
      :class:`~advancedps_tpu_torch.ssm.History`.  Step ``t`` writes
      ``buf[:, t]`` in place (a functional update would copy ``[N, T, ...]``
      a step); the snapshot, and so the reference trajectory, is ``x``.

    Non-Markov dynamics always draw with per-particle keys, as in the JAX
    package; ``vectorized`` dynamics then build their law once for the batch
    of histories (the GP-SSM factors its kernel matrix once a step) and draw
    it key by key (:meth:`~advancedps_tpu_torch.distributions.Distribution.sample_keyed`),
    the others run per particle under ``vmap``.  Both give the same draws.
    """

    def __init__(self, ssm: TracedSSM):
        self.ssm = ssm

    @property
    def num_steps(self) -> int:
        return self.ssm.num_steps

    @property
    def _markov(self) -> bool:
        return self.ssm.model.markov

    def _obs_logw(self, t, x):
        obs = self.ssm.observation
        y_t = self.ssm.observations[t]
        if obs.vectorized:
            return obs.log_prob(t, x, y_t)
        return vmap(lambda xi: obs.log_prob(t, xi, y_t))(x)

    def init(self, rng, ref0, ref_mask):
        prior = self.ssm.prior
        if prior.vectorized:
            x0 = prior.distribution().sample_rng(rng)
        else:
            x0 = vmap(prior.sample)(rng.particle_keys())
        x0 = inject_ref(ref_mask, ref0, x0)
        logw = self._obs_logw(0, x0)
        if self._markov:
            return x0, logw
        # new_zeros of x0: under vmap over chains the buffer is each chain's own.
        buf = x0.new_zeros((x0.shape[0], self.num_steps) + tuple(x0.shape[1:]))
        buf[:, 0] = x0
        return (x0, buf), logw

    def step(self, t, rng, state, ref_t, ref_mask):
        dyn = self.ssm.dynamics
        if self._markov:
            if dyn.vectorized:
                x_new = dyn.distribution(t, state).sample_rng(rng)
            else:
                x_new = vmap(lambda k, x: dyn.sample(k, t, x))(rng.particle_keys(), state)
            x_new = inject_ref(ref_mask, ref_t, x_new)
            return x_new, self._obs_logw(t, x_new)
        x_prev, buf = state
        keys = rng.particle_keys()
        if dyn.vectorized:
            x_new = dyn.distribution(t, x_prev, History(buf, t)).sample_keyed(keys)
        else:
            x_new = vmap(lambda k, x, b: dyn.sample(k, t, x, History(b, t)))(keys, x_prev, buf)
        x_new = inject_ref(ref_mask, ref_t, x_new)
        buf[:, t] = x_new
        return (x_new, buf), self._obs_logw(t, x_new)

    def snapshot(self, state):
        return state if self._markov else state[0]

    def transition_logprob(self, t, state, ref_t):
        dyn = self.ssm.dynamics
        if self._markov:
            if dyn.vectorized:
                return dyn.distribution(t, state).log_prob(ref_t)
            return vmap(lambda x: dyn.log_prob(t, x, ref_t))(state)
        x_prev, buf = state
        if dyn.vectorized:
            return dyn.distribution(t, x_prev, History(buf, t)).log_prob(ref_t)
        return vmap(lambda x, b: dyn.log_prob(t, x, ref_t, History(b, t)))(x_prev, buf)


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
