"""Independent chains (PyTorch port of ``advancedps_tpu/parallel/chains.py``).

Chain ``i`` draws from ``fold_in(key, i)``, so its results do not depend on
where it runs.  :func:`sample_chains` and :func:`smc_ensemble` run the chains
on one device as one batch along a leading chain axis (the batch of keys
:func:`~advancedps_tpu_torch.rng.chain_keys`, handed to the drivers of
:mod:`~advancedps_tpu_torch.inference`), one set of launches a step for all of
them, as the JAX package ``vmap``s them.  :func:`sharded_chains_pg` runs chains on the rows of a
:class:`~advancedps_tpu_torch.parallel.mesh.ChainParticleMesh`, each chain's
particles sharded along its row; the rows share nothing, and one controller
runs them in turn.
"""

from __future__ import annotations

import torch

from .. import rng as rngmod
from ..inference import sample_pg, sample_smc
from ..pg import PG, PGSample
from ..smc import SMC, SMCSample
from .mesh import CHAIN_AXIS, PARTICLE_AXIS, ChainParticleMesh
from .pg import sharded_step_pg

__all__ = ["sample_chains", "smc_ensemble", "sharded_chains_pg"]


def sample_chains(key: rngmod.Key, model, sampler: PG, n_iterations: int, n_chains: int,
                  trajectory_storage: str = "dense", device=None) -> PGSample:
    """``n_chains`` independent PG(AS) chains on ``device`` (None: the GPU).  Returns stacked
    samples with a leading chain axis: ``trajectory [n_chains, n_iterations,
    T, ...]``, ``log_evidence [n_chains, n_iterations]``.  Chain ``i`` is
    ``sample_pg(fold_in(key, i), ...)``; all run as one batch."""
    return sample_pg(rngmod.chain_keys(key, n_chains), model, sampler, n_iterations,
                     trajectory_storage, device)


def smc_ensemble(key: rngmod.Key, model, sampler: SMC, n_runs: int,
                 store_states: bool = True, device=None) -> SMCSample:
    """``n_runs`` independent SMC sweeps on ``device`` (None: the GPU), e.g.
    for the variance of the log-evidence, stacked on a leading run axis.  Run
    ``i`` is ``sample_smc(fold_in(key, i), ...)``; all run as one batch."""
    return sample_smc(rngmod.chain_keys(key, n_runs), model, sampler, store_states, device)


def sharded_chains_pg(
    key: rngmod.Key,
    kernel,
    sampler: PG,
    mesh: ChainParticleMesh,
    n_chains: int,
    n_iterations: int,
    chain_axis: str = CHAIN_AXIS,
    axis: str = PARTICLE_AXIS,
    exchange: str = "allgather",
):
    """``n_chains`` PG(AS) chains on a ``(chains, particles)`` mesh: the
    chains split into contiguous blocks, block ``r`` on row ``r``, each
    iteration a sharded sweep over its row (:func:`sharded_step_pg`, dense
    storage).  Chain ``i``'s iteration ``j`` uses ``fold_in(fold_in(key, i),
    j)``, as :func:`sample_chains`.

    ``exchange`` must stay ``"allgather"``, as in the JAX package, where the
    neighbour exchange's ``ppermute`` under a per-chain gate would deadlock
    the rendezvous of all devices.  (One controller cannot deadlock; the
    check keeps the API the same.)

    Returns ``(trajectories [n_chains, n_iterations, T, ...],
    log_evidence [n_chains, n_iterations])``.
    """
    if exchange != "allgather":
        raise ValueError(
            "sharded_chains_pg supports exchange='allgather' only: the "
            "neighbour exchange cannot sit under the per-chain resample gate"
        )
    n_rows = mesh.shape[chain_axis]
    n_shards = mesh.shape[axis]
    n = sampler.n_particles
    if n % n_shards:
        raise ValueError(f"n_particles={n} not divisible by mesh axis {axis}={n_shards}")
    if n_chains % n_rows:
        raise ValueError(f"n_chains={n_chains} not divisible by mesh axis {chain_axis}={n_rows}")
    per_row = n_chains // n_rows
    trajs, log_zs = [], []
    for i in range(n_chains):
        row = mesh.rows[i // per_row]
        chain_key = rngmod.fold_in(key, i)
        st, chain_t, chain_z = None, [], []
        for j in range(n_iterations):
            smp, st = sharded_step_pg(rngmod.fold_in(chain_key, j), kernel, sampler, row, st,
                                      axis, "dense", exchange)
            chain_t.append(smp.trajectory)
            chain_z.append(smp.log_evidence)
        trajs.append(torch.stack(chain_t))
        log_zs.append(torch.stack(chain_z))
    return torch.stack(trajs), torch.stack(log_zs)
