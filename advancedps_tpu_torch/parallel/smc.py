"""Sharded SMC driver — the multi-device counterpart of
:func:`advancedps_tpu_torch.inference.sample_smc` (PyTorch port of
``advancedps_tpu/parallel/smc.py``)."""

from __future__ import annotations

import torch

from .. import rng as rngmod
from ..engine import reconstruct
from ..smc import SMC, SMCSample
from .mesh import PARTICLE_AXIS, ParticleMesh
from .sharded import sharded_sweep

__all__ = ["sharded_sample_smc"]


def sharded_sample_smc(
    key: rngmod.Key,
    kernel,
    sampler: SMC,
    mesh: ParticleMesh,
    axis: str = PARTICLE_AXIS,
    store_states: bool = True,
    exchange: str = "auto",
) -> SMCSample:
    """One sharded SMC sweep returning the single-device driver's
    :class:`SMCSample`: weighted trajectories (joined on the mesh's first
    device), log-evidence and per-step ESS / resampled diagnostics.
    ``store_states=False`` skips the ``[T, N, ...]`` snapshots; ``exchange``
    selects the state exchange
    (:func:`~advancedps_tpu_torch.parallel.sharded.sweep_shard_body`)."""
    res = sharded_sweep(
        key, kernel, sampler.n_particles, sampler.resampler, mesh,
        store_states=store_states, axis=axis, exchange=exchange,
    )
    trajectories = None
    if res.states is not None:
        trajectories = reconstruct(res.states, res.ancestors, None)
    return SMCSample(
        trajectories=trajectories,
        weights=torch.softmax(res.log_weights, 0),
        log_evidence=res.log_evidence,
        diagnostics={"ess": res.ess, "resampled": res.resampled},
    )
