"""Sampling entry points (PyTorch port of ``advancedps_tpu/inference.py``, SMC part).

``sample(key, model, SMC(n), device=...)`` runs one bootstrap sweep.  PG and
PGAS belong to the PGAS slice of the port; generic programs to a later one.
"""

from __future__ import annotations

from typing import Optional

import torch

from .engine import SweepKernel, reconstruct, sweep
from .rng import Key
from .smc import SMC, SMCSample, SSMKernel
from .ssm import TracedSSM

__all__ = ["make_kernel", "sample_smc", "sample"]


def make_kernel(model) -> SweepKernel:
    """Model → sweep kernel.  A :class:`SweepKernel` passes through unchanged."""
    if isinstance(model, SweepKernel):
        return model
    if isinstance(model, TracedSSM):
        return SSMKernel(model)
    raise TypeError(
        f"cannot build a sweep kernel for {type(model).__name__}; expected "
        "TracedSSM or a SweepKernel implementation (generic programs belong to "
        "a later slice of the port)"
    )


def sample_smc(key: Key, model, sampler: SMC, store_states: bool = True,
               device="cpu") -> SMCSample:
    """One SMC sweep on ``device``.  A :class:`TracedSSM` is moved there with
    ``.to(device)`` (in place, as for any ``nn.Module``)."""
    if isinstance(model, torch.nn.Module):
        model = model.to(device)
    res = sweep(
        key, make_kernel(model), sampler.n_particles, sampler.resampler,
        store_states=store_states, device=device,
    )
    trajectories = (
        reconstruct(res.states, res.ancestors, None) if res.states is not None else None
    )
    return SMCSample(
        trajectories=trajectories,
        weights=torch.softmax(res.log_weights, 0),
        log_evidence=res.log_evidence,
        diagnostics={"ess": res.ess, "resampled": res.resampled},
    )


def sample(key: Key, model, sampler, n_iterations: Optional[int] = None,
           device="cpu", **kwargs):
    """``sample(key, model, SMC(n), device=...)`` → :class:`SMCSample`."""
    if isinstance(sampler, SMC):
        if n_iterations is not None:
            raise ValueError("SMC draws one weighted population; n_iterations must be None")
        return sample_smc(key, model, sampler, device=device, **kwargs)
    raise NotImplementedError(
        f"sampler {type(sampler).__name__} is not ported: PG and PGAS belong to "
        "the PGAS slice of the port"
    )
