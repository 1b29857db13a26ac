"""Stochastic-volatility SSM (PyTorch port of
``advancedps_tpu/models/stochastic_volatility.py``):

    x_0 ~ N(0, q);  x_t ~ N(a·x_{t-1}, q);  y_t ~ N(0, exp(x_t / 2)).

The reference's nonlinear Particle Gibbs benchmark; its PGAS chain holds the
update-rate contract (≈ 1 − 1/N a step).
"""

from __future__ import annotations

import torch

from ..distributions import Normal
from ..ssm import ObservationProcess, StateSpaceModel
from .lgssm import GaussianPrior, LinearGaussianDynamics

__all__ = ["StochasticVolatilityObservation", "stochastic_volatility_ssm"]


class StochasticVolatilityObservation(ObservationProcess):
    vectorized = True

    def distribution(self, step, state):
        return Normal(0.0, torch.exp(state / 2.0))


def stochastic_volatility_ssm(a, q) -> StateSpaceModel:
    return StateSpaceModel(
        prior=GaussianPrior(mu=0.0, sigma=q),
        dynamics=LinearGaussianDynamics(a=a, b=0.0, q=q),
        observation=StochasticVolatilityObservation(),
    )
