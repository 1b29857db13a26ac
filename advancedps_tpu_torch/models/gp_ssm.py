"""Gaussian-process state-space model (PyTorch port of
``advancedps_tpu/models/gp_ssm.py``), non-Markovian.

The latent process is a zero-mean GP over time indices, conditioned at each
step on the whole past trajectory, with a stochastic-volatility observation
``y_t ~ N(0, exp(x_t/2))``.  The dynamics receive a
:class:`~advancedps_tpu_torch.ssm.History` and run masked GP regression with
fixed shapes: with ``m_i = 1[i < t]`` the kernel matrix over all T time points
becomes ``K̃ = m mᵀ ∘ K + diag(1 − m) + jitter·I``, identity outside the
active block, so one Cholesky factor of a ``[T, T]`` matrix serves the step.

``K̃`` depends on the step only, not on the particle, and the predictive mean
is a bilinear form: ``k*ᵀ K̃⁻¹ x = (K̃⁻¹ k*)ᵀ x``.  So each step solves once,
``w = K̃⁻¹ k*`` (a ``[T]`` right-hand side, shared by every particle), and
each history's mean is the dot product of its ``t`` active values with
``w[:t]``.  The batch ``[N, T]`` is read through the strided view
``states[..., :t]`` (row stride T): nothing ``[N, T]``-sized is made, and the
rows from ``length`` on, which the :class:`~advancedps_tpu_torch.ssm.History`
contract leaves undefined, are never read.  A ``vmap`` of a per-particle
regression would instead broadcast the ``[T, T]`` factor to every particle
(40 GB at N = 1M, T = 100).  Each particle still draws with its own key (the
sweep's :meth:`~advancedps_tpu_torch.distributions.Distribution.sample_keyed`),
so the draws are the JAX package's.
"""

from __future__ import annotations

import torch
from torch import nn

from ..distributions import Normal
from ..ssm import History, LatentDynamics, StateSpaceModel
from .lgssm import GaussianPrior, _buffers
from .stochastic_volatility import StochasticVolatilityObservation

__all__ = ["SqExponentialKernel", "GPDynamics", "gp_ssm"]


class SqExponentialKernel(nn.Module):
    """k(i, j) = variance · exp(−(i−j)² / (2ℓ²))."""

    def __init__(self, lengthscale=1.0, variance=1.0):
        super().__init__()
        _buffers(self, lengthscale=lengthscale, variance=variance)

    def forward(self, a, b):
        d = (a[..., :, None] - b[..., None, :]) / self.lengthscale
        return self.variance * torch.exp(-0.5 * d * d)


class GPDynamics(LatentDynamics):
    """GP-posterior transition over time indices, conditioned on the history.
    ``num_steps`` fixes the buffer length T."""

    needs_history = True
    vectorized = True

    def __init__(self, num_steps: int, kernel: SqExponentialKernel = None, jitter: float = 1e-6):
        super().__init__()
        self.num_steps = int(num_steps)
        self.kernel = SqExponentialKernel() if kernel is None else kernel
        self.jitter = float(jitter)

    def distribution(self, step, state, history: History):
        T = self.num_steps
        dev = self.kernel.variance.device
        times = torch.arange(T, dtype=torch.float32, device=dev)
        now = torch.full((1,), float(step), dtype=torch.float32, device=dev)
        m = (times < step).to(torch.float32)  # [T] active-past mask
        K = self.kernel(times, times)
        eye = torch.eye(T, dtype=torch.float32, device=dev)
        K_masked = K * m[:, None] * m[None, :] + torch.diag(1.0 - m) + self.jitter * eye
        chol = torch.linalg.cholesky(K_masked)  # once a step, for every particle

        k_star = self.kernel(times, now)[:, 0] * m
        v = torch.linalg.solve_triangular(chol, k_star[:, None], upper=False)[:, 0]
        # The mean k*ᵀ K̃⁻¹ x is wᵀ x with w = K̃⁻¹ k* = L⁻ᵀ v, solved once a step
        # for every particle; each history is read over its t active columns
        # through a strided view, with nothing copied.
        w = torch.linalg.solve_triangular(chol.mT, v[:, None], upper=True)[:, 0]
        mean = history.states[..., :step] @ w[:step]
        var = self.kernel(now, now)[0, 0] - v @ v
        var = torch.clamp(var, min=self.jitter)
        return Normal(mean, torch.sqrt(var))


def gp_ssm(num_steps: int, lengthscale=1.0, variance=1.0, prior_sigma=1.0) -> StateSpaceModel:
    return StateSpaceModel(
        prior=GaussianPrior(mu=0.0, sigma=prior_sigma),
        dynamics=GPDynamics(num_steps=num_steps,
                            kernel=SqExponentialKernel(lengthscale=lengthscale, variance=variance)),
        observation=StochasticVolatilityObservation(),
    )
