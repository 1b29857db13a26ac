"""Linear-Gaussian state-space models (PyTorch port of ``advancedps_tpu/models/lgssm.py``).

Prior ``N(mu, sigma)``, dynamics ``N(a·x + b, q)``, observation ``N(h·x, r)``,
all standard-deviation parameterised.  Parameters are float32 buffers.
"""

from __future__ import annotations

import math

import torch

from ..distributions import Normal
from ..ssm import LatentDynamics, ObservationProcess, StatePrior, StateSpaceModel

__all__ = [
    "GaussianPrior",
    "LinearGaussianDynamics",
    "LinearGaussianObservation",
    "LinearGaussianSSM",
    "stationary_lgssm",
]


def _buffers(module, **params):
    for name, value in params.items():
        module.register_buffer(name, torch.as_tensor(value, dtype=torch.float32))


class GaussianPrior(StatePrior):
    vectorized = True

    def __init__(self, mu=0.0, sigma=1.0):
        super().__init__()
        _buffers(self, mu=mu, sigma=sigma)

    def distribution(self):
        return Normal(self.mu, self.sigma)


class LinearGaussianDynamics(LatentDynamics):
    vectorized = True

    def __init__(self, a=1.0, b=0.0, q=1.0):
        super().__init__()
        _buffers(self, a=a, b=b, q=q)

    def distribution(self, step, state):
        return Normal(self.a * state + self.b, self.q)


class LinearGaussianObservation(ObservationProcess):
    vectorized = True

    def __init__(self, h=1.0, r=1.0):
        super().__init__()
        _buffers(self, h=h, r=r)

    def distribution(self, step, state):
        return Normal(self.h * state, self.r)


def LinearGaussianSSM(x0, sigma0, a, b, q, h, r) -> StateSpaceModel:
    return StateSpaceModel(
        prior=GaussianPrior(mu=x0, sigma=sigma0),
        dynamics=LinearGaussianDynamics(a=a, b=b, q=q),
        observation=LinearGaussianObservation(h=h, r=r),
    )


def stationary_lgssm(a, q, r) -> StateSpaceModel:
    """Random-walk model with the stationary prior ``N(0, sqrt(q²/(1−a²)))``."""
    sigma0 = math.sqrt(q * q / (1.0 - a * a))
    return LinearGaussianSSM(0.0, sigma0, a, 0.0, q, 1.0, r)
