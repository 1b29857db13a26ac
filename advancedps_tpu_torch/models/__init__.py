from .lgssm import (
    GaussianPrior,
    LinearGaussianDynamics,
    LinearGaussianObservation,
    LinearGaussianSSM,
    stationary_lgssm,
)

__all__ = [
    "GaussianPrior",
    "LinearGaussianDynamics",
    "LinearGaussianObservation",
    "LinearGaussianSSM",
    "stationary_lgssm",
]
