"""The multi-device layer: particle meshes (in one process, or spanning
processes after :func:`init_distributed`), the sharded sweep and its drivers
(PyTorch port of ``advancedps_tpu/parallel``)."""

from .mesh import (
    CHAIN_AXIS,
    PARTICLE_AXIS,
    chain_particle_mesh,
    init_distributed,
    particle_mesh,
    shard_along,
)
from .chains import sample_chains, sharded_chains_pg, smc_ensemble
from .pg import reconstruct_one_sharded, sharded_sample_pg, sharded_step_pg
from .sharded import sharded_sweep
from .smc import sharded_sample_smc

__all__ = [
    "CHAIN_AXIS",
    "PARTICLE_AXIS",
    "chain_particle_mesh",
    "init_distributed",
    "particle_mesh",
    "shard_along",
    "sharded_sweep",
    "sharded_sample_smc",
    "sharded_step_pg",
    "sharded_sample_pg",
    "reconstruct_one_sharded",
    "sample_chains",
    "sharded_chains_pg",
    "smc_ensemble",
]
