"""advancedps_tpu_torch — the PyTorch and CUDA port of ``advancedps_tpu``.

It carries bootstrap SMC, PG and PGAS over the state-space-model DSL: the
positional counter-based RNG and the key-based samplers of ``jax.random``
(:mod:`~advancedps_tpu_torch.random`), the twelve distributions, the
linear-Gaussian, stochastic-volatility, Lévy and GP-SSM models (components
vectorized or per particle, Markov or with a history), the systematic,
stratified, multinomial and residual schemes under the ESS gate, the sweep
engine with tree-shaped particle states, reference trajectories and ancestor
sampling, the SMC and PG entry points, generic programs
(:class:`GenericModel`), chain checkpoints (:mod:`~advancedps_tpu_torch.utils`)
and a multi-device layer whose meshes may span processes
(:mod:`~advancedps_tpu_torch.parallel`).  Resampling runs through hand-written CUDA
kernels (:mod:`advancedps_tpu_torch.ops.resample`) on CUDA tensors and
through their plain PyTorch versions on CPU tensors.  Every entry point runs
on the GPU unless the caller passes ``device="cpu"``; without a CUDA device a
call that names no device raises.

Quick start::

    import torch
    import advancedps_tpu_torch as apt

    model = apt.models.stationary_lgssm(a=0.9, q=0.32, r=1.0)
    _, ys = apt.simulate(torch.Generator().manual_seed(0), model, 100)
    traced = apt.TracedSSM(model, ys)
    smc = apt.sample(apt.rng.key(1), traced, apt.SMC(100_000))  # on the GPU
    chain = apt.sample(apt.rng.key(2), traced, apt.PGAS(100_000), 10,
                       trajectory_storage="replay")
    cpu = apt.sample(apt.rng.key(1), traced, apt.SMC(4096), device="cpu")

    def program(ctx):                       # a generic program: PG and SMC
        x = ctx.sample(apt.Normal(0.0, 1.0), name="x")
        ctx.observe(apt.Normal(x, 0.5), 0.7)
    pg = apt.sample(apt.rng.key(3), apt.GenericModel(program), apt.PG(1000), 10)
"""

from . import convert, distributions, generic, models, ops, random, rng, utils
from .convert import key_from_words, model_from_numpy, traced_ssm_from_numpy
from .distributions import (
    Bernoulli,
    Beta,
    Categorical,
    Dirac,
    Distribution,
    Exponential,
    Gamma,
    LogNormal,
    MvNormal,
    Normal,
    Poisson,
    StudentT,
    Uniform,
)
from .engine import (
    SweepKernel,
    SweepResult,
    inject_ref,
    lineages,
    reconstruct,
    replay_trajectory,
    sweep,
)
from .generic import GenericModel, GenericSSMKernel, observe, sample_site
from .inference import make_kernel, sample, sample_pg, sample_smc, step_pg
from .pg import PG, PGAS, PGSample, PGState
from .resampling import (
    DEFAULT_RESAMPLER,
    ResampleWithESSThreshold,
    as_gated_resampler,
    effective_sample_size,
    multinomial_spacings,
    randcat,
    randcat_gumbel,
    resample_multinomial,
    resample_residual,
    resample_stratified,
    resample_systematic,
    stratified_extents,
)
from .smc import SMC, SMCSample, SSMKernel
from .ssm import (
    History,
    LatentDynamics,
    ObservationProcess,
    StatePrior,
    StateSpaceModel,
    TracedSSM,
    simulate,
)

__version__ = "0.1.0"
