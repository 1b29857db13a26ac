"""The particle sweep engine (PyTorch port of ``advancedps_tpu/engine.py``).

One sweep is a Python loop over time with all particles dense on the device.
Each step is

    one (max, Σe, Σe²) reduction → ESS gate → resample (B1 extents, B2 decode,
    B3 move kernels) → propagate + score → log-evidence bookkeeping

Genealogy is a dense ``[T, N]`` int32 ancestor matrix; trajectories are
reconstructed afterwards by a backward pass (:func:`lineages`).

The ESS gate is a host-side ``if``: reading the gate costs one device-to-host
synchronisation per step.  (The JAX package keeps it on the device with
``lax.cond``.)

Conditional sweeps — a reference trajectory and PGAS ancestor sampling — belong
to the PGAS slice of the port and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from . import rng as rngmod
from .ops import resample as ops
from .resampling import ResampleWithESSThreshold, resample_systematic

__all__ = ["SweepKernel", "SweepResult", "sweep", "lineages", "reconstruct"]


class SweepKernel:
    """Protocol the sweep engine drives, vectorised over the particle axis
    (leading dim ``N``):

    * ``num_steps`` — number of observations ``T``.
    * ``init(rng, ref0, ref_mask) -> (state, logw[N])`` — sample initial
      latents and score ``y_0``; ``rng`` is a :class:`~advancedps_tpu_torch.rng.StepRng`.
    * ``step(t, rng, state, ref_t, ref_mask) -> (state, logw[N])`` — one
      transition + observation score.  ``state`` is a float32 ``[N]`` or
      ``[N, D]`` tensor; resampling moves its rows.
    * ``snapshot(state) -> [N, ...] | None`` — the per-step value recorded for
      trajectory reconstruction.

    ``ref0``/``ref_t``/``ref_mask`` are always ``None`` in this slice: reference
    trajectories belong to the PGAS slice of the port.
    """

    num_steps: int

    def init(self, rng, ref0, ref_mask):
        raise NotImplementedError

    def step(self, t, rng, state, ref_t, ref_mask):
        raise NotImplementedError

    def snapshot(self, state):
        return None


@dataclass
class SweepResult:
    """Everything one sweep produces.

    ``log_evidence`` — Del Moral estimator ``Σ_t (logZ_after − logZ_before)``.
    ``log_weights`` — final unnormalised log-weights ``[N]``.
    ``states`` — stacked per-step snapshots ``[T, N, ...]`` (or ``None``).
    ``ancestors`` — ``[T, N]`` int32 parent slots (``ancestors[0]`` is the identity).
    ``final_state`` — kernel state after the last step.
    ``ess`` / ``resampled`` — per-step diagnostics ``[T]``.
    """

    log_evidence: torch.Tensor
    log_weights: torch.Tensor
    states: Any
    ancestors: torch.Tensor
    final_state: Any
    ess: torch.Tensor
    resampled: torch.Tensor


@torch.no_grad()
def sweep(
    key: rngmod.Key,
    kernel: SweepKernel,
    n_particles: int,
    resampler: ResampleWithESSThreshold,
    ref: Any = None,
    ancestor_sampling: bool = False,
    store_states: bool = True,
    device="cpu",
) -> SweepResult:
    """Run one bootstrap particle sweep on ``device``.

    ``kernel``'s tensors must already lie on ``device``.  Resampling is
    systematic, gated at ``ESS ≤ threshold · n``.
    """
    if ref is not None or ancestor_sampling:
        raise NotImplementedError(
            "conditional sweeps (reference trajectory, ancestor sampling) "
            "belong to the PGAS slice of the port"
        )
    if resampler.resampler is not resample_systematic:
        raise NotImplementedError(
            f"resampler {getattr(resampler.resampler, '__name__', resampler.resampler)!r}: "
            "only systematic resampling is ported; the other schemes belong to "
            "a later slice of the port"
        )
    device = torch.device(device)
    n = n_particles
    T = kernel.num_steps
    gids = torch.arange(n, device=device)

    rng0 = rngmod.StepRng(rngmod.step_key(key, rngmod.INIT, 0), gids)
    state, logw = kernel.init(rng0, None, None)

    snap0 = kernel.snapshot(state)
    do_store = store_states and snap0 is not None
    states = None
    if do_store:
        states = torch.empty((T,) + tuple(snap0.shape), dtype=snap0.dtype, device=device)
        states[0] = snap0

    iota = torch.arange(n, dtype=torch.int32, device=device)
    ancestors = torch.empty((T, n), dtype=torch.int32, device=device)
    ancestors[0] = iota
    ess_all = torch.empty(T, dtype=torch.float32, device=device)
    ess_all[0] = float(n)
    resampled = [False] * T

    ln_n = torch.log(torch.tensor(float(n), dtype=torch.float32, device=device))
    always_resample = float(resampler.threshold) >= 1.0
    # Log-evidence (Del Moral): each step adds logsumexp(logw_after) −
    # logsumexp(logw_before).  ``logw_before`` is the previous step's weights
    # (no resample) or zeros (resample ⇒ log n), so ``pending`` carries the
    # base to subtract once the next reduction is available, and one
    # (max, Σe, Σe²) family per step feeds the evidence, the ESS gate and the
    # extents.
    log_z = ln_n * 0.0
    pending = ln_n

    for t in range(1, T):
        m = torch.max(logw)
        e = torch.exp(logw - m)
        s1 = torch.sum(e)
        s2 = torch.sum(e * e)
        lse = m + torch.log(s1)
        log_z = log_z + (lse - pending)

        ess = (s1 * s1) / s2
        ess_all[t] = ess
        do_rs = always_resample or bool(ess <= resampler.threshold * n)

        if do_rs:
            u = rngmod.uniform(rngmod.step_key(key, rngmod.RESAMPLE, t))
            f = ops.extents_from_logw(logw, m, s1, u, n)
            anc, state = ops.resample_move(ops.decode_ancestors(f, n), state)
            ancestors[t] = anc
            pending = ln_n
        else:
            ancestors[t] = iota
            pending = lse
        resampled[t] = do_rs

        rng_t = rngmod.StepRng(rngmod.step_key(key, rngmod.PROPAGATE, t), gids)
        state, score = kernel.step(t, rng_t, state, None, None)
        # After a resample the weights restart at 0, so the new weights are the score.
        logw = score if do_rs else logw + score
        if do_store:
            states[t] = kernel.snapshot(state)

    log_z = log_z + (torch.logsumexp(logw, 0) - pending)

    return SweepResult(
        log_evidence=log_z,
        log_weights=logw,
        states=states,
        ancestors=ancestors,
        final_state=state,
        ess=ess_all,
        resampled=torch.tensor(resampled, device=device),
    )


def lineages(ancestors: torch.Tensor) -> torch.Tensor:
    """``lineage[t, i]`` = the slot at time ``t`` of the particle that occupies
    slot ``i`` at the final time (backward pass over the genealogy)."""
    T, n = ancestors.shape
    out = torch.empty_like(ancestors)
    idx = torch.arange(n, dtype=ancestors.dtype, device=ancestors.device)
    out[T - 1] = idx
    for t in range(T - 1, 0, -1):
        idx = ancestors[t][idx.long()]
        out[t - 1] = idx
    return out


def reconstruct(states: torch.Tensor, ancestors: torch.Tensor, index: Optional[int]):
    """Trajectories through the genealogy: ``index`` None → all N ``[T, N, ...]``;
    a slot ``index`` → ``[T, ...]`` by a backward walk carrying one slot."""
    T = ancestors.shape[0]
    steps = torch.arange(T, device=ancestors.device)
    if index is None:
        return states[steps[:, None], lineages(ancestors).long()]
    idx = torch.as_tensor(index, dtype=torch.long, device=ancestors.device)
    slots = [idx]
    for t in range(T - 1, 0, -1):
        idx = ancestors[t, idx].long()
        slots.append(idx)
    return states[steps, torch.stack(slots[::-1])]
