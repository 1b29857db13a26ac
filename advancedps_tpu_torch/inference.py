"""Sampling entry points (PyTorch port of ``advancedps_tpu/inference.py``).

* :func:`sample_smc` — one SMC sweep (weighted trajectories + log-evidence);
* :func:`step_pg` / :func:`sample_pg` — one / many PG(AS) iterations;
* :func:`sample` — the entry point that dispatches on the sampler type and
  takes structured (:class:`TracedSSM`) and generic (:class:`GenericModel`)
  models alike.

Each takes a :class:`~advancedps_tpu_torch.rng.KeyBatch` of C keys in place
of a key and then runs C independent chains as one batch (one set of launches
a step, see :mod:`~advancedps_tpu_torch.engine`), every result with a leading
chain axis; chain ``c`` is the call with ``key.key(c)``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import rng as rngmod
from ._device import resolve_device
from ._tree import tree_stack
from .engine import SweepKernel, reconstruct, replay_trajectory, sweep
from .generic import GenericModel, GenericSSMKernel
from .pg import PG, PGSample, PGState
from .resampling import randcat_gumbel
from .rng import Key, KeyBatch
from .smc import SMC, SMCSample, SSMKernel
from .ssm import TracedSSM

__all__ = ["make_kernel", "sample_smc", "step_pg", "sample_pg", "sample"]


def make_kernel(model) -> SweepKernel:
    """Model → sweep kernel.  A :class:`SweepKernel` passes through unchanged."""
    if isinstance(model, SweepKernel):
        return model
    if isinstance(model, TracedSSM):
        return SSMKernel(model)
    if isinstance(model, GenericModel):
        return GenericSSMKernel(model)
    raise TypeError(
        f"cannot build a sweep kernel for {type(model).__name__}; expected "
        "TracedSSM, GenericModel, or a SweepKernel implementation"
    )


def _on_device(model, device):
    """A model that is an ``nn.Module`` (a :class:`TracedSSM`) is moved to
    ``device`` with ``.to`` (in place, as for any module)."""
    if isinstance(model, torch.nn.Module):
        model = model.to(device)
    return model


def sample_smc(key: Key, model, sampler: SMC, store_states: bool = True,
               device=None) -> SMCSample:
    """One SMC sweep on ``device`` (None: the GPU); for a :class:`KeyBatch`
    of C keys, C sweeps as one batch, stacked on a leading run axis."""
    device = resolve_device(device)
    model = _on_device(model, device)
    res = sweep(
        key, make_kernel(model), sampler.n_particles, sampler.resampler,
        store_states=store_states, device=device,
    )
    trajectories = (
        reconstruct(res.states, res.ancestors, None) if res.states is not None else None
    )
    return SMCSample(
        trajectories=trajectories,
        weights=torch.softmax(res.log_weights, -1),
        log_evidence=res.log_evidence,
        diagnostics={"ess": res.ess, "resampled": res.resampled},
    )


def step_pg(key: Key, model, sampler: PG, state: Optional[PGState] = None,
            trajectory_storage: str = "dense", device=None):
    """One PG / PGAS iteration on ``device`` (None: the GPU): a conditional sweep on
    ``state``'s trajectory (a plain sweep when ``state`` is None), then a new
    retained trajectory drawn ∝ the final weights.  Returns
    ``(PGSample, PGState)``.

    ``trajectory_storage``:

    * ``"dense"`` — the sweep stores ``[T, N, ...]`` snapshots and the retained
      trajectory is gathered through the genealogy;
    * ``"replay"`` — the sweep stores only the ``[T, N]`` ancestors and the
      retained trajectory is re-sampled along its lineage from the positional
      RNG (:func:`~advancedps_tpu_torch.engine.replay_trajectory`): the same
      genealogy and draws, states equal up to float reordering, and memory
      O(T·N) instead of O(T·N·D).  Structured models only.

    A :class:`GenericModel` takes PG with dense storage: ancestor sampling
    needs transition densities, and its state is its whole record of values.

    For a :class:`KeyBatch` of C keys, C chains' iterations as one batch:
    ``state``'s trajectory and the results have a leading chain axis.
    """
    if trajectory_storage not in ("dense", "replay"):
        raise ValueError(f"unknown trajectory_storage {trajectory_storage!r}")
    replay = trajectory_storage == "replay"
    device = resolve_device(device)
    kernel = make_kernel(_on_device(model, device))
    if sampler.ancestor_sampling and isinstance(model, GenericModel):
        raise TypeError(
            "PGAS requires transition densities — only structured state-space "
            "models support ancestor sampling (reference: update_ref! dispatches "
            "on SSMTrace, AdvancedPS.jl src/pgas.jl:113)"
        )
    if replay and isinstance(model, GenericModel):
        raise TypeError(
            "trajectory_storage='replay' needs per-step snapshots; generic "
            "models carry their whole variable record as state — use 'dense'"
        )
    ref = None if state is None else state.trajectory
    res = sweep(
        key, kernel, sampler.n_particles, sampler.resampler,
        ref=ref,
        ancestor_sampling=sampler.ancestor_sampling and ref is not None,
        store_states=not replay,
        device=device,
    )
    # Retained-trajectory draw ∝ final weights, by Gumbel-max (a device
    # tensor: no host sync).
    draw_key = rngmod.step_key(key, rngmod.DRAW, 0)
    if isinstance(key, KeyBatch):
        draw_key = draw_key.to(device).column()
    idx = randcat_gumbel(draw_key, res.log_weights)
    if replay:
        traj = replay_trajectory(key, kernel, res.ancestors, idx, ref=ref)
    else:
        traj = reconstruct(res.states, res.ancestors, idx)
    return PGSample(trajectory=traj, log_evidence=res.log_evidence), PGState(trajectory=traj)


def sample_pg(key: Key, model, sampler: PG, n_iterations: int,
              trajectory_storage: str = "dense", device=None) -> PGSample:
    """Run a PG(AS) chain of ``n_iterations`` on ``device`` (None: the GPU): iteration ``i``
    uses the key ``fold_in(key, i)``, and the first runs without a reference.
    Returns the stacked :class:`PGSample`: ``trajectory [n_iterations, T, ...]``,
    ``log_evidence [n_iterations]`` (a tree-shaped trajectory stacked leaf by
    leaf).

    The chain is a Python loop over iterations.  The JAX package's
    ``jit_chain`` (the chain as one compiled ``lax.scan``) has no counterpart
    here: PyTorch runs eagerly.

    For a :class:`KeyBatch` of C keys, C chains as one batch, chain ``c``'s
    iteration ``i`` keyed ``fold_in(key.key(c), i)``: ``trajectory
    [C, n_iterations, T, ...]``, ``log_evidence [C, n_iterations]``.
    """
    if n_iterations < 1:
        raise ValueError(f"n_iterations must be >= 1, got {n_iterations}")
    samples = []
    st = None
    for i in range(n_iterations):
        smp, st = step_pg(rngmod.fold_in(key, i), model, sampler, st,
                          trajectory_storage, device)
        samples.append(smp)
    axis = 1 if isinstance(key, KeyBatch) else 0
    return PGSample(
        trajectory=tree_stack([s.trajectory for s in samples], axis),
        log_evidence=torch.stack([s.log_evidence for s in samples], axis),
    )


def sample(key: Key, model, sampler, n_iterations: Optional[int] = None,
           device=None, **kwargs):
    """``sample(key, model, SMC(n), device=...)`` → :class:`SMCSample`;
    ``sample(key, model, PG(n), n_iterations, device=...)`` → stacked
    :class:`PGSample` (keyword ``trajectory_storage``, see :func:`step_pg`).
    ``device`` None means the GPU; ``"cpu"`` runs the plain versions."""
    if isinstance(sampler, SMC):
        if n_iterations is not None:
            raise ValueError("SMC draws one weighted population; n_iterations must be None")
        return sample_smc(key, model, sampler, device=device, **kwargs)
    if isinstance(sampler, PG):
        if n_iterations is None:
            raise ValueError("PG/PGAS require n_iterations")
        return sample_pg(key, model, sampler, n_iterations, device=device, **kwargs)
    raise TypeError(f"unknown sampler {type(sampler).__name__}")
