"""The particle sweep engine (PyTorch port of ``advancedps_tpu/engine.py``).

One sweep is a Python loop over time with all particles dense on the device.
Each step is

    one (max, Σe, Σe²) reduction → ESS gate → resample → propagate + score →
    log-evidence bookkeeping

Genealogy is a dense ``[T, N]`` int32 ancestor matrix; trajectories are
reconstructed afterwards by a backward pass (:func:`lineages`), or re-sampled
along one lineage from the positional RNG (:func:`replay_trajectory`).

Resampling with systematic, stratified or multinomial runs as monotone extents
through the kernels of :mod:`advancedps_tpu_torch.ops.resample`:

* systematic: B1 extents;
* stratified: B6 scaled prefix ``c = n·cdf``, then :func:`stratified_extents`;
* multinomial: sorted uniforms by exponential spacings, B6 prefix sums ``S``,
  B6 thresholds ``cdf·S_n``, B7 (or B8) merge-count;

then the decode and move of :func:`~advancedps_tpu_torch.ops.resample.resample_move_f`
(B4, B2 + B3, or B5 + a gather, by ``ops.resample.MOVE_VERSION``).  Any other
resampler (residual, or a user's) returns its ancestors and the state is
gathered by them.

The particle state is a tensor or a tree of tensors (a tuple, list or dict,
each leaf with leading axis N), as the JAX engine moves any pytree: the
``(x, history)`` of a non-Markov model, a record of variables.  A firing
decodes once and moves every leaf (float32 and int32 leaves through the
kernels, others gathered); snapshots and the reference trajectory are trees
of the snapshot's structure.

Conditional sweeps (PG/PGAS): the reference trajectory occupies slot ``N−1``,
reads its stored state instead of sampling (:func:`inject_ref`), and survives
every resampling: the other ``N−1`` ancestors are drawn from all ``N`` weights.
With ancestor sampling the reference slot's ancestor is drawn ∝
``w_i · f_t(x^ref_t | x^i_{t−1})`` by Gumbel-max, from the state and weights
before the move.

The ESS gate is a host-side ``if``: reading the gate costs one device-to-host
synchronisation per step, except with ``threshold ≥ 1`` (every step
resamples, the PGAS default), where the gate is not read.  (The JAX package
keeps it on the device with ``lax.cond``.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from . import _tree, rng as rngmod
from ._device import resolve_device
from ._tree import tree_at, tree_map, tree_rows, tree_stack
from .ops import resample as ops
from .resampling import (
    ResampleWithESSThreshold,
    multinomial_spacings,
    randcat_gumbel,
    resample_multinomial,
    resample_stratified,
    resample_systematic,
    stratified_extents,
)

__all__ = [
    "SweepKernel",
    "SweepResult",
    "sweep",
    "inject_ref",
    "lineages",
    "reconstruct",
    "replay_trajectory",
]

#: Schemes whose draw reduces to monotone extents and runs through the kernels.
_FUSED_SCHEMES = {
    resample_systematic: "systematic",
    resample_stratified: "stratified",
    resample_multinomial: "multinomial",
}


class SweepKernel:
    """Protocol the sweep engine drives, vectorised over the particle axis
    (leading dim ``N``):

    * ``num_steps`` — number of observations ``T``.
    * ``init(rng, ref0, ref_mask) -> (state, logw[N])`` — sample initial
      latents (slot ``N−1`` reads ``ref0`` when a reference is present) and
      score ``y_0``; ``rng`` is a :class:`~advancedps_tpu_torch.rng.StepRng`.
    * ``step(t, rng, state, ref_t, ref_mask) -> (state, logw[N])`` — one
      transition + observation score.  ``state`` is a tensor or a tree of
      tensors (tuple, list or dict), each leaf with leading axis ``N``;
      resampling moves its rows.
    * ``snapshot(state) -> [N, ...] | None`` — the per-step value (a tensor or
      a tree) recorded for trajectory reconstruction; a reference trajectory
      is a series of these, ``[T, ...]`` leaf by leaf.
    * ``transition_logprob(t, state, ref_t) -> [N]`` — density of moving from
      each particle's state to ``ref_t``; needed by PGAS only.
    """

    num_steps: int

    def init(self, rng, ref0, ref_mask):
        raise NotImplementedError

    def step(self, t, rng, state, ref_t, ref_mask):
        raise NotImplementedError

    def snapshot(self, state):
        return None

    def transition_logprob(self, t, state, ref_t):
        raise NotImplementedError(
            "ancestor sampling (PGAS) requires transition densities; "
            "this kernel does not provide them"
        )


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


def inject_ref(ref_mask, ref_val, vals):
    """Slot ``N−1`` (where ``ref_mask`` is true) takes the reference value
    instead of its own: a ``where``, so the read stays inside the step.
    ``vals`` a tensor or tree with leading axis N, ``ref_val`` the matching
    value or tree for one particle."""
    if ref_mask is None or ref_val is None:
        return vals

    def one(v, r):
        m = ref_mask.reshape(ref_mask.shape + (1,) * (v.dim() - 1))
        return torch.where(m, torch.as_tensor(r, dtype=v.dtype, device=v.device), v)

    return tree_map(one, vals, ref_val)


def _fused_extents(scheme, rs_key, logw, m, s1, n_resample):
    """Nondecreasing int32 extents ``[M]`` of the scheme's draw of
    ``n_resample`` positions, through the kernels."""
    if scheme == "systematic":
        return ops.extents_from_logw(logw, m, s1, rngmod.uniform(rs_key), n_resample)
    if scheme == "stratified":
        c = ops.scaled_prefix_from_logw(logw, m, n_resample / s1)
        return stratified_extents(rs_key, c, n_resample)
    # multinomial: sorted uniforms S_k / S_n by exponential spacings; the
    # extent of j counts the S_k below cdf_j · S_n.
    g = multinomial_spacings(rs_key, n_resample, device=logw.device)
    S = ops.prefix_sum(g)
    thr = ops.scaled_prefix_from_logw(logw, m, S[n_resample] / s1)
    return ops.count_le_sorted_auto(S[:n_resample], thr)


@torch.no_grad()
def sweep(
    key: rngmod.Key,
    kernel: SweepKernel,
    n_particles: int,
    resampler: ResampleWithESSThreshold,
    ref: Any = None,
    ancestor_sampling: bool = False,
    store_states: bool = True,
    device=None,
) -> SweepResult:
    """Run one particle sweep on ``device`` (None: the GPU): bootstrap SMC,
    or conditional SMC when ``ref`` (a ``[T, ...]`` trajectory) is given.

    ``kernel``'s tensors must already lie on ``device``.  Resampling is gated
    at ``ESS ≤ threshold · n``.
    """
    n = n_particles
    T = kernel.num_steps
    has_ref = ref is not None
    if ancestor_sampling and not has_ref:
        raise ValueError("ancestor_sampling requires a reference trajectory")
    device = resolve_device(device)
    gids = torch.arange(n, device=device)
    ref_mask = None
    if has_ref:
        ref = _tree.as_reference(ref, device)
        ref_mask = gids == (n - 1)
    # With a reference, n − 1 positions are drawn and slot n − 1 keeps the
    # reference.
    n_resample = n - 1 if has_ref else n
    scheme = _FUSED_SCHEMES.get(resampler.resampler)

    rng0 = rngmod.StepRng(rngmod.step_key(key, rngmod.INIT, 0), gids)
    state, logw = kernel.init(rng0, tree_at(ref, 0), ref_mask)

    snap0 = kernel.snapshot(state)
    do_store = store_states and snap0 is not None
    states = None

    def store(t, snap):
        def put(buf, s):
            buf[t] = s
        tree_map(put, states, snap)

    if do_store:
        states = tree_map(lambda s: torch.empty((T,) + tuple(s.shape), dtype=s.dtype,
                                                device=device), snap0)
        store(0, snap0)

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
            rs_key = rngmod.step_key(key, rngmod.RESAMPLE, t)
            if has_ref:
                # The reference slot's ancestor, from the state and weights
                # before the move: n − 1 (PG), or drawn ∝ w_i·f_t(ref_t | x_i)
                # (PGAS).  A device tensor: no host sync.
                if ancestor_sampling:
                    anc_logw = logw + kernel.transition_logprob(t, state, tree_at(ref, t))
                    anc_key = rngmod.step_key(key, rngmod.ANCESTOR, t)
                    ref_anc = randcat_gumbel(anc_key, anc_logw, gids).reshape(1)
                else:
                    ref_anc = iota[n - 1:]
                ref_row = tree_rows(state, ref_anc)
            if scheme is not None:
                f = _fused_extents(scheme, rs_key, logw, m, s1, n_resample)
                # With a reference, slot n − 1 decodes past the drawn
                # population (ancestor M clipped to M − 1; row 0, or row
                # M − 1 under move version 0) and is overwritten with the
                # reference row in place.
                anc, state_rs = ops.resample_move_f(f, state, n, guard_n=n_resample)
                if has_ref:
                    anc[n - 1:] = ref_anc

                    def put_ref(mv, r):
                        mv[n - 1:] = r
                    tree_map(put_ref, state_rs, ref_row)
            else:
                anc = resampler.resampler(rs_key, e / s1, n_resample)
                if has_ref:
                    anc = torch.cat([anc, ref_anc])
                state_rs = tree_rows(state, anc.long())
            state = state_rs
            ancestors[t] = anc
            pending = ln_n
        else:
            ancestors[t] = iota
            pending = lse
        resampled[t] = do_rs

        rng_t = rngmod.StepRng(rngmod.step_key(key, rngmod.PROPAGATE, t), gids)
        state, score = kernel.step(t, rng_t, state, tree_at(ref, t), ref_mask)
        # After a resample the weights restart at 0, so the new weights are the score.
        logw = score if do_rs else logw + score
        if do_store:
            store(t, kernel.snapshot(state))

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


def _lineage_slots(ancestors: torch.Tensor, index) -> torch.Tensor:
    """``[T]`` int64 slots of the lineage that ends in slot ``index`` (an int
    or a one-element tensor, read on the device): a backward walk carrying
    one slot, with no host sync."""
    T = ancestors.shape[0]
    idx = torch.as_tensor(index, device=ancestors.device).reshape(1).long()
    slots = [idx]
    for t in range(T - 1, 0, -1):
        idx = ancestors[t].index_select(0, idx).long()
        slots.append(idx)
    return torch.cat(slots[::-1])


def reconstruct(states, ancestors: torch.Tensor, index: Optional[int]):
    """Trajectories through the genealogy (``states`` a tensor or tree of
    ``[T, N, ...]`` leaves): ``index`` None → all N ``[T, N, ...]``; a slot
    ``index`` (int or one-element tensor) → ``[T, ...]``."""
    T = ancestors.shape[0]
    steps = torch.arange(T, device=ancestors.device)
    if index is None:
        lin = lineages(ancestors).long()
        return tree_map(lambda s: s[steps[:, None], lin], states)
    slots = _lineage_slots(ancestors, index)
    return tree_map(lambda s: s[steps, slots], states)


@torch.no_grad()
def replay_trajectory(key, kernel: SweepKernel, ancestors: torch.Tensor, index, ref=None):
    """The retained trajectory without stored states: walk ``ancestors`` back
    to the slot ``s_t`` the lineage of final slot ``index`` held at each step,
    then re-run the kernel forward with one particle whose id at step ``t`` is
    ``s_t``.

    All sweep randomness is positional in ``(key, stream, step, id)``, so the
    replay draws what the sweep drew for that lineage; ``key`` and ``ref``
    must be the sweep's own.  O(T) work and memory instead of ``[T, N, ...]``
    snapshots; the states equal the sweep's up to float reordering between
    one-element and N-element elementwise kernels.
    """
    T, n = ancestors.shape
    has_ref = ref is not None
    slots = _lineage_slots(ancestors, index)
    if has_ref:
        ref = _tree.as_reference(ref, ancestors.device)

    def mask_of(g):
        return (g == n - 1) if has_ref else None

    g = slots[0:1]
    rng0 = rngmod.StepRng(rngmod.step_key(key, rngmod.INIT, 0), g)
    state, _ = kernel.init(rng0, tree_at(ref, 0), mask_of(g))
    snap = kernel.snapshot(state)
    if snap is None:
        raise ValueError("replay requires a kernel with per-step snapshots")
    snaps = [snap]
    for t in range(1, T):
        g = slots[t:t + 1]
        rng_t = rngmod.StepRng(rngmod.step_key(key, rngmod.PROPAGATE, t), g)
        state, _ = kernel.step(t, rng_t, state, tree_at(ref, t), mask_of(g))
        snaps.append(kernel.snapshot(state))
    return tree_map(lambda s: s[:, 0], tree_stack(snaps))
