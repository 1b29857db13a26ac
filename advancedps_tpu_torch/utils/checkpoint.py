"""Checkpoint and resume for PG(AS) chains (PyTorch port of
``advancedps_tpu/utils/checkpoint.py``).

A chain's resumable state is small: the retained trajectory (a tensor or a
tree of tensors), the chain key and the iteration counter.  All randomness is
positional in the key, so a chain resumed from a checkpoint continues
exactly as the uninterrupted run would.

:func:`save_chain` writes the three with ``torch.save``;
:func:`restore_chain` loads them with ``torch.load(weights_only=True)``, and
also reads the ``.npz`` file the JAX package's ``save_chain`` writes, which
carries a JAX chain across to the port.  The JAX package's orbax directory
format has no counterpart here.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from .._tree import tree_map, tree_stack
from ..pg import PGSample, PGState
from ..rng import Key, fold_in

__all__ = ["ChainCheckpoint", "save_chain", "restore_chain", "resume_chain"]


class ChainCheckpoint(NamedTuple):
    """Everything needed to resume a PG(AS) chain deterministically."""

    trajectory: Any  # retained trajectory [T, ...], a tensor or a tree of them
    key: Key  # chain key (positional randomness ⇒ full reproducibility)
    iteration: int  # iterations done: the next one draws from fold_in(key, iteration)

    @property
    def state(self) -> PGState:
        return PGState(trajectory=self.trajectory)


def save_chain(path: str, state: PGState, key: Key, iteration: int) -> None:
    """Write a chain checkpoint to ``path`` with ``torch.save``: the
    trajectory (moved to the CPU, so the file loads on any machine), the
    key's two words and the iteration."""
    torch.save({
        "trajectory": tree_map(lambda a: a.detach().cpu(), state.trajectory),
        "key": [int(key.k0), int(key.k1)],
        "iteration": int(iteration),
    }, path)


def restore_chain(path: str, device=None) -> ChainCheckpoint:
    """Load a chain checkpoint onto ``device`` (None: the GPU): one written by
    :func:`save_chain`, or a ``.npz`` file written by the JAX package's
    ``save_chain`` (its trajectory, its key's ``key_data`` words, its
    iteration)."""
    device = resolve_device(device)
    if str(path).endswith(".npz"):
        with np.load(path) as data:
            trajectory = torch.from_numpy(np.array(data["trajectory"]))
            words = np.asarray(data["key"]).reshape(-1)
            iteration = int(data["iteration"])
    else:
        payload = torch.load(path, map_location="cpu", weights_only=True)
        trajectory, words, iteration = (payload["trajectory"], payload["key"],
                                        int(payload["iteration"]))
    if len(words) != 2:
        raise ValueError(f"a chain key has two words, the checkpoint holds {len(words)}")
    return ChainCheckpoint(
        trajectory=tree_map(lambda a: a.to(device), trajectory),
        key=Key(int(words[0]), int(words[1])),
        iteration=iteration,
    )


def resume_chain(path: str, model, sampler, n_more: int, device=None,
                 trajectory_storage: str = "dense"):
    """Restore a checkpoint and continue the chain for ``n_more`` iterations
    on ``device`` (None: the GPU): iteration ``i`` draws from
    ``fold_in(key, i)``, as :func:`~advancedps_tpu_torch.inference.sample_pg`
    does, so the result is what the uninterrupted chain gives.  Returns
    ``(stacked PGSample, PGState, iterations done)``."""
    from ..inference import step_pg

    ck = restore_chain(path, device)
    st = ck.state
    samples = []
    for i in range(ck.iteration, ck.iteration + n_more):
        smp, st = step_pg(fold_in(ck.key, i), model, sampler, st, trajectory_storage, device)
        samples.append(smp)
    stacked = PGSample(trajectory=tree_stack([s.trajectory for s in samples]),
                       log_evidence=torch.stack([s.log_evidence for s in samples]))
    return stacked, st, ck.iteration + n_more
