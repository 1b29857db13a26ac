"""advancedps_tpu_torch — the PyTorch and CUDA port of ``advancedps_tpu``.

This slice carries the bootstrap-SMC main path: the positional counter-based
RNG, the ``Normal`` distribution, the state-space-model DSL with the
linear-Gaussian models, systematic resampling under the ESS gate, the sweep
engine and the SMC entry points.  Resampling runs through hand-written CUDA kernels
(:mod:`advancedps_tpu_torch.ops.resample`) on CUDA tensors and through their
plain PyTorch versions on CPU tensors.

Quick start::

    import torch
    import advancedps_tpu_torch as apt

    model = apt.models.stationary_lgssm(a=0.9, q=0.32, r=1.0)
    _, ys = apt.simulate(torch.Generator().manual_seed(0), model, 100)
    smc = apt.sample(apt.rng.key(1), apt.TracedSSM(model, ys), apt.SMC(100_000),
                     device="cuda")
"""

from . import convert, distributions, models, ops, rng, utils
from .convert import key_from_words, traced_ssm_from_numpy
from .distributions import Normal
from .engine import SweepKernel, SweepResult, lineages, reconstruct, sweep
from .inference import make_kernel, sample, sample_smc
from .resampling import (
    DEFAULT_RESAMPLER,
    ResampleWithESSThreshold,
    effective_sample_size,
    resample_systematic,
)
from .smc import SMC, SMCSample, SSMKernel
from .ssm import (
    LatentDynamics,
    ObservationProcess,
    StatePrior,
    StateSpaceModel,
    TracedSSM,
    simulate,
)

__version__ = "0.1.0"
