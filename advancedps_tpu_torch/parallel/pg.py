"""Sharded PG / PGAS drivers (PyTorch port of ``advancedps_tpu/parallel/pg.py``).

A conditional SMC sweep over the sharded engine, then the retained-trajectory
draw ∝ the final weights, as in :func:`advancedps_tpu_torch.inference.step_pg`;
the chain state (:class:`~advancedps_tpu_torch.pg.PGState`) is the same, so
chains can move between sharded and single-device runs.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import rng as rngmod
from .._tree import tree_stack
from ..engine import reconstruct, replay_trajectory
from ..pg import PG, PGSample, PGState
from ..resampling import randcat_gumbel
from .mesh import PARTICLE_AXIS, ParticleMesh
from .sharded import sharded_sweep

__all__ = ["reconstruct_one_sharded", "sharded_step_pg", "sharded_sample_pg"]


#: The trajectory ``[T, ...]`` through the genealogy that ends in slot
#: ``index``, from ``states [T, N, ...]`` and ``ancestors [T, N]`` as the sharded
#: sweep returns them (the shards joined in order).  The JAX package contracts
#: a one-hot weight over the sharded particle axis; exactly one weight of that
#: contraction is nonzero, so the single-device reconstruction, which reads the
#: owner's row, gives the same values.
reconstruct_one_sharded = reconstruct


def sharded_step_pg(
    key: rngmod.Key,
    kernel,
    sampler: PG,
    mesh: ParticleMesh,
    state: Optional[PGState] = None,
    axis: str = PARTICLE_AXIS,
    trajectory_storage: str = "dense",
    exchange: str = "auto",
):
    """One sharded PG(AS) iteration.  Returns ``(PGSample, PGState)``.

    ``trajectory_storage="replay"`` keeps only the ``[T, N]`` ancestors and
    re-samples the retained trajectory along its lineage from the positional
    RNG (:func:`~advancedps_tpu_torch.engine.replay_trajectory`, one particle,
    on the mesh's first device); ``exchange`` selects the state exchange.
    """
    if trajectory_storage not in ("dense", "replay"):
        raise ValueError(f"unknown trajectory_storage {trajectory_storage!r}")
    replay = trajectory_storage == "replay"
    ref = None if state is None else state.trajectory
    res = sharded_sweep(
        key, kernel, sampler.n_particles, sampler.resampler, mesh,
        ref=ref,
        ancestor_sampling=sampler.ancestor_sampling and ref is not None,
        store_states=not replay,
        axis=axis,
        exchange=exchange,
    )
    idx = randcat_gumbel(rngmod.step_key(key, rngmod.DRAW, 0), res.log_weights)
    if replay:
        traj = replay_trajectory(key, kernel, res.ancestors, idx, ref=ref)
    else:
        traj = reconstruct_one_sharded(res.states, res.ancestors, idx)
    return PGSample(trajectory=traj, log_evidence=res.log_evidence), PGState(trajectory=traj)


def sharded_sample_pg(
    key: rngmod.Key,
    kernel,
    sampler: PG,
    mesh: ParticleMesh,
    n_iterations: int,
    axis: str = PARTICLE_AXIS,
    trajectory_storage: str = "dense",
    exchange: str = "auto",
) -> PGSample:
    """A sharded PG(AS) chain: iteration ``i`` uses ``fold_in(key, i)`` and
    the first runs without a reference, as
    :func:`~advancedps_tpu_torch.inference.sample_pg`.  Returns the stacked
    :class:`PGSample` (``trajectory [n_iterations, T, ...]``,
    ``log_evidence [n_iterations]``)."""
    if n_iterations < 1:
        raise ValueError(f"n_iterations must be >= 1, got {n_iterations}")
    samples, st = [], None
    for i in range(n_iterations):
        smp, st = sharded_step_pg(rngmod.fold_in(key, i), kernel, sampler, mesh, st, axis,
                                  trajectory_storage, exchange)
        samples.append(smp)
    return PGSample(
        trajectory=tree_stack([s.trajectory for s in samples]),
        log_evidence=torch.stack([s.log_evidence for s in samples]),
    )
