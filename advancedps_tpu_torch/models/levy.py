"""Lévy-driven Langevin SSM (PyTorch port of ``advancedps_tpu/models/levy.py``).

The reference simulates a Gamma-process jump path with a loop whose length
depends on the data.  Here, as in the JAX package, a fixed budget of K
candidate jumps is drawn and masked:

* arrival times ``t_k``: cumulative sums of Exp(1/rate) gaps;
* jump sizes ``x_k = 1 / (β (exp(t_k / C) − 1))``, decreasing in ``t_k``;
* thinning acceptance ``u_k < (1 + β x_k)·exp(−β x_k)``;
* truncation mask ``x_k ≥ tol``.

Langevin transition: state ``[x, ẋ]`` with ``exp(A dt) = [[1, (e^{θdt}−1)/θ],
[0, e^{θdt}]]`` and a jump-driven MvNormal mean and covariance; observation
``N(x, σ_e)`` on the first component.

The dynamics are conditionally Gaussian given a random jump path, so they have
no law to hand the sweep: :meth:`LevyLangevinDynamics.sample` draws the path
with the particle's key and :meth:`LevyLangevinDynamics.log_prob` scores with a
fresh path from a key shared by all particles, ``fold_in(key(score_seed),
step)`` (a random-weight PGAS ancestor draw, as the JAX package and the
reference do).  A step draws 3·K key-based values a particle.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import random as rnd
from .. import rng as rngmod
from ..distributions import MvNormal, Normal
from ..ssm import LatentDynamics, ObservationProcess, StatePrior, StateSpaceModel
from .lgssm import _buffers

__all__ = ["GammaProcess", "LevyPrior", "LevyLangevinDynamics", "LevyObservation", "levy_ssm"]


class GammaProcess(nn.Module):
    """Gamma process (C, β) with truncation tolerance and a fixed jump budget."""

    def __init__(self, C=1.0, beta=1.0, tol: float = 1e-10, max_jumps: int = 64):
        super().__init__()
        _buffers(self, C=C, beta=beta)
        self.tol = float(tol)
        self.max_jumps = int(max_jumps)

    def simulate(self, key, rate, start, finish):
        """``(jumps [K], times [K], mask [K])`` on ``[start, finish)``."""
        key = rnd.key_tensor(key, self.C.device)
        k_arr, k_acc, k_t = rnd.split(key, 3)
        K = self.max_jumps
        gaps = rnd.exponential(k_arr, (K,)) / rate
        ts = torch.cumsum(gaps, -1)
        x = 1.0 / (self.beta * (torch.exp(ts / self.C) - 1.0))
        prob = (1.0 + self.beta * x) * torch.exp(-self.beta * x)
        accept = rnd.uniform(k_acc, (K,)) < prob
        mask = accept & (x >= self.tol)
        times = rnd.uniform(k_t, (K,), minval=start, maxval=finish)
        return x, times, mask


class LevyPrior(StatePrior):
    vectorized = True

    def __init__(self, mu, cov):
        super().__init__()
        _buffers(self, mu=mu, cov=cov)

    def distribution(self):
        return MvNormal(self.mu, self.cov)


class LevyLangevinDynamics(LatentDynamics):
    """Langevin dynamics driven by a Gamma-process subordinator: ``theta``
    mean reversion, ``dt`` step size, ``mu_w``/``sigma_w`` the jump marks'
    Gaussian."""

    def __init__(self, dt=0.5, theta=-0.5, mu_w=0.0, sigma_w=1.0, process: GammaProcess = None,
                 jitter: float = 1e-6, score_seed: int = 7):
        super().__init__()
        _buffers(self, dt=dt, theta=theta, mu_w=mu_w, sigma_w=sigma_w)
        self.process = GammaProcess() if process is None else process
        self.jitter = float(jitter)
        self.score_seed = int(score_seed)

    def _expm(self, dt):
        f = torch.exp(self.theta * dt)
        return torch.stack([torch.stack([torch.ones_like(f), (f - 1.0) / self.theta]),
                            torch.stack([torch.zeros_like(f), f])])

    def _meancov(self, key, step):
        dt = self.dt
        start = (step - 1) * dt
        finish = step * dt
        jumps, times, mask = self.process.simulate(key, dt, start, finish)
        # f_k = exp(A (t_end − t_k)) L with L = [0, 1]
        f = torch.exp(self.theta * (finish - times))  # [K]
        fts = torch.stack([(f - 1.0) / self.theta, f], dim=-1)  # [K, 2]
        # The mask selects where the JAX package multiplies by it: a first
        # arrival gap of exactly 0 (a uniform of 0, 2⁻²³ a draw) makes an
        # infinite, rejected jump, and 0·∞ would make the step NaN.  Where the
        # jump is finite the two are the same bits.
        m = mask[:, None]
        zero = torch.zeros((), dtype=fts.dtype, device=fts.device)
        mu = torch.sum(torch.where(m, fts * self.mu_w * jumps[:, None], zero), dim=0)
        cov = torch.einsum("ki,kj->ij", torch.where(m, fts * jumps[:, None], zero), fts) \
            * (self.sigma_w ** 2)
        return mu, cov + self.jitter * torch.eye(2, dtype=cov.dtype, device=cov.device)

    def _dist(self, key, step, state):
        mu, cov = self._meancov(key, step)
        mean = self._expm(self.dt) @ state + mu
        return MvNormal(mean, cov)

    def sample(self, key, step, state, history=None):
        """A jump path from the particle's key, then the Gaussian draw."""
        k_path, k_noise = rnd.split(rnd.key_tensor(key, self.dt.device))
        return self._dist(k_path, step, state).sample(k_noise)

    def log_prob(self, step, state, x, history=None):
        """Scored with the path of the step's shared key."""
        k_score = rngmod.fold_in(rngmod.key(self.score_seed), step)
        return self._dist(k_score, step, state).log_prob(x)

    def distribution(self, step, state, history=None):
        raise NotImplementedError(
            "LevyLangevinDynamics is conditionally Gaussian given a random jump "
            "path; use sample()/log_prob()"
        )


class LevyObservation(ObservationProcess):
    """``y_t ~ N(H·x_t, σ_e)`` with ``H = [1, 0]``."""

    vectorized = True

    def __init__(self, sigma_e=1.0):
        super().__init__()
        _buffers(self, sigma_e=sigma_e)

    def distribution(self, step, state):
        return Normal(state[..., 0], self.sigma_e)


def levy_ssm(dt=0.5, theta=-0.5, sigma_e=1.0, C=1.0, beta=1.0, mu_w=0.0, sigma_w=1.0,
             max_jumps=64) -> StateSpaceModel:
    return StateSpaceModel(
        prior=LevyPrior(mu=torch.zeros(2), cov=torch.eye(2)),
        dynamics=LevyLangevinDynamics(dt=dt, theta=theta, mu_w=mu_w, sigma_w=sigma_w,
                                      process=GammaProcess(C=C, beta=beta, max_jumps=max_jumps)),
        observation=LevyObservation(sigma_e=sigma_e),
    )
