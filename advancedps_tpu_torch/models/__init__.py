from .gp_ssm import GPDynamics, SqExponentialKernel, gp_ssm
from .levy import GammaProcess, LevyLangevinDynamics, LevyObservation, LevyPrior, levy_ssm
from .lgssm import (
    GaussianPrior,
    LinearGaussianDynamics,
    LinearGaussianObservation,
    LinearGaussianSSM,
    stationary_lgssm,
)
from .stochastic_volatility import StochasticVolatilityObservation, stochastic_volatility_ssm

__all__ = [
    "GaussianPrior",
    "LinearGaussianDynamics",
    "LinearGaussianObservation",
    "LinearGaussianSSM",
    "stationary_lgssm",
    "StochasticVolatilityObservation",
    "stochastic_volatility_ssm",
    "GammaProcess",
    "LevyLangevinDynamics",
    "LevyPrior",
    "LevyObservation",
    "levy_ssm",
    "GPDynamics",
    "SqExponentialKernel",
    "gp_ssm",
]
