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

Independent chains run as one batch when the key is a
:class:`~advancedps_tpu_torch.rng.KeyBatch` of C keys: every tensor gains a
leading chain axis, the kernel's calls run under :func:`torch.func.vmap` over
it (the JAX package ``vmap``s the whole sampler), the reductions are taken
over the last axis, and the resampling kernels take the chain axis, so a
step is one set of launches for all C chains.  The gate reads a ``[C]`` flag
vector once a step; a step on which no chain fires launches no resampling
kernel, and on a step where some do, the kernels run over all C and the
chains that do not fire keep their rows, weights and identity ancestors by a
``where``, as JAX's ``vmap`` of ``lax.cond`` does.  Chain ``c`` draws what
the one-chain sweep with ``keys.key(c)`` draws, and its kernels compute
bitwise what they compute there; its sweep is bitwise that sweep where torch
reduces a row of ``[C, N]`` in the order it reduces an ``[N]`` vector.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch.func import vmap

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
    "ChainBatchError",
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
    key,
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

    ``key`` a :class:`~advancedps_tpu_torch.rng.KeyBatch` of C keys runs C
    independent sweeps as one batch (see the module notes): ``ref`` then has
    a leading chain axis, and so has every field of the result
    (``ancestors [C, T, N]``, ``states`` leaves ``[C, T, N, ...]``).
    """
    if isinstance(key, rngmod.KeyBatch):
        return _sweep_chains(key, kernel, n_particles, resampler, ref, ancestor_sampling,
                             store_states, device)
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


class ChainBatchError(RuntimeError):
    """A kernel's call cannot run under ``vmap`` over the chain axis."""


def _chain_map(name: str, fn, in_dims):
    """``fn`` under :func:`torch.func.vmap` over the chain axis; an error of
    ``vmap`` (an op with no batching rule it can run, a host read or Python
    branch on a chain's value, an in-place write of a chain's value into a
    shared tensor) is raised as :class:`ChainBatchError` naming ``name``."""
    mapped = vmap(fn, in_dims=in_dims)

    def call(*args):
        try:
            return mapped(*args)
        except RuntimeError as e:
            if isinstance(e, ChainBatchError) or "vmap" not in str(e):
                raise
            raise ChainBatchError(
                f"{name} is not vmap-safe, so chains cannot run as one batch over it: {e}"
            ) from e

    return call


def _chain_rows(tree, idx):
    """Row ``idx[c]`` of chain ``c`` of every leaf ``[C, N, ...]``: ``[C, ...]``."""
    def one(a):
        return a[torch.arange(a.shape[0], device=a.device), idx.long()]
    return tree_map(one, tree)


def _chain_where(flags, new, old):
    """Leaf by leaf, chain ``c``'s ``new`` where ``flags[c]``, else its ``old``."""
    def one(a, b):
        return torch.where(flags.reshape(flags.shape + (1,) * (a.dim() - 1)), a, b)
    return tree_map(one, new, old)


#: The streams a batched sweep derives step keys for, in the key table's order.
_TABLE_TAGS = (rngmod.INIT, rngmod.PROPAGATE, rngmod.RESAMPLE, rngmod.ANCESTOR)


def _key_table(keys: rngmod.KeyBatch, n_steps: int, device):
    """The step keys of every stream of :data:`_TABLE_TAGS`, step and chain,
    and the systematic offsets, derived on the host in one tensor cipher and
    copied to ``device`` in one copy.  Returns ``(table, host)``: ``table``
    int64 ``[3, S, T, C]`` on ``device`` (words 0 and 1, and the float32 bits
    of ``jax.random.uniform`` of each key), ``host`` the words on the host."""
    k0, k1 = rngmod.step_key_table(keys.to("cpu"), _TABLE_TAGS, n_steps)
    b0, b1 = rngmod.threefry2x32(k0, k1, 0, 0)
    table = torch.stack([k0, k1, rngmod._unit_of_bits(b0, b1)]).to(device)
    return table, (k0, k1)


def _table_keys(table, tag: int, t: int) -> rngmod.KeyBatch:
    s = _TABLE_TAGS.index(tag)
    return rngmod.KeyBatch(table[0, s, t], table[1, s, t])


def _fused_extents_chains(scheme, rs: rngmod.KeyBatch, u, logw, m, s1, n_resample):
    """:func:`_fused_extents` for C chains: ``rs`` the chains' resampling keys
    ``[C]``, ``u`` their systematic offsets; int32 ``[C, M]``."""
    if scheme == "systematic":
        return ops.extents_from_logw_chains(logw, m, s1, u, n_resample)
    col = rs.column()
    if scheme == "stratified":
        c = ops.scaled_prefix_from_logw_chains(logw, m, n_resample / s1)
        return stratified_extents(col, c, n_resample)
    g = -torch.log1p(-rngmod.pos_uniform(col, torch.arange(n_resample + 1,
                                                           device=logw.device)))
    S = ops.prefix_sum_chains(g)
    thr = ops.scaled_prefix_from_logw_chains(logw, m, S[:, n_resample] / s1)
    # B7 (or B8) once a chain.
    return torch.stack([ops.count_le_sorted_auto(S[c, :n_resample], thr[c])
                        for c in range(logw.shape[0])])


def _snapshot_fn(kernel, state):
    """The kernel's snapshot under ``vmap`` over chains, or None for a kernel
    that records none (asked of chain 0's state)."""
    if kernel.snapshot(tree_map(lambda a: a[0], state)) is None:
        return None
    return _chain_map("kernel.snapshot", kernel.snapshot, (0,))


def _sweep_chains(keys, kernel, n, resampler, ref, ancestor_sampling, store_states, device):
    """:func:`sweep` over the chain batch ``keys``."""
    C = len(keys)
    T = kernel.num_steps
    has_ref = ref is not None
    if ancestor_sampling and not has_ref:
        raise ValueError("ancestor_sampling requires a reference trajectory")
    device = resolve_device(device)
    gids = torch.arange(n, device=device)
    ref_mask = None
    ref_dim = None
    if has_ref:
        ref = _tree.as_reference(ref, device)
        ref_mask = gids == (n - 1)
        ref_dim = 0
    n_resample = n - 1 if has_ref else n
    scheme = _FUSED_SCHEMES.get(resampler.resampler)
    table, host_words = _key_table(keys, T, device)
    offsets = table[2, _TABLE_TAGS.index(rngmod.RESAMPLE)].to(torch.int32).view(
        torch.float32) - 1.0  # [T, C]

    def ref_at(t):
        return None if ref is None else tree_map(lambda a: a[:, t], ref)

    def init(a, b, r0):
        return kernel.init(rngmod.StepRng(rngmod.KeyBatch(a, b), gids), r0, ref_mask)

    k = _table_keys(table, rngmod.INIT, 0)
    state, logw = _chain_map("kernel.init", init, (0, 0, ref_dim))(k.k0, k.k1, ref_at(0))

    snap_fn = _snapshot_fn(kernel, state)
    do_store = store_states and snap_fn is not None
    states = None
    if do_store:
        snap0 = snap_fn(state)
        states = tree_map(lambda s: torch.empty((C, T) + tuple(s.shape[1:]), dtype=s.dtype,
                                                device=device), snap0)

        def store(t, snap):
            def put(buf, v):
                buf[:, t] = v
            tree_map(put, states, snap)
        store(0, snap0)

    iota = torch.arange(n, dtype=torch.int32, device=device)
    chains = torch.arange(C, device=device)
    ancestors = torch.empty((C, T, n), dtype=torch.int32, device=device)
    ancestors[:, 0] = iota
    ess_all = torch.empty((C, T), dtype=torch.float32, device=device)
    ess_all[:, 0] = float(n)
    resampled = torch.zeros((C, T), dtype=torch.bool)

    ln_n = torch.log(torch.tensor(float(n), dtype=torch.float32, device=device))
    always_resample = float(resampler.threshold) >= 1.0
    log_z = ln_n * 0.0
    pending = ln_n
    tlp = _chain_map("kernel.transition_logprob",
                     lambda st, r, t: kernel.transition_logprob(t, st, r), (0, 0, None))

    for t in range(1, T):
        m = torch.amax(logw, -1)
        e = torch.exp(logw - m[:, None])
        s1 = torch.sum(e, -1)
        s2 = torch.sum(e * e, -1)
        lse = m + torch.log(s1)
        log_z = log_z + (lse - pending)

        ess = (s1 * s1) / s2
        ess_all[:, t] = ess
        if always_resample:
            flags, host_flags = None, torch.ones(C, dtype=torch.bool)
        else:
            flags = ess <= resampler.threshold * n
            host_flags = flags.cpu()  # the step's one read of the gate
            if bool(host_flags.all()):
                flags = None  # every chain fires: nothing to keep
        fire = bool(host_flags.any())

        if fire:
            if has_ref:
                if ancestor_sampling:
                    anc_logw = logw + tlp(state, ref_at(t), t)
                    ak = _table_keys(table, rngmod.ANCESTOR, t).column()
                    ref_anc = randcat_gumbel(ak, anc_logw, gids)
                else:
                    ref_anc = torch.full((C,), n - 1, dtype=torch.int32, device=device)
                ref_row = _chain_rows(state, ref_anc)
            if scheme is not None:
                f = _fused_extents_chains(scheme, _table_keys(table, rngmod.RESAMPLE, t),
                                          offsets[t], logw, m, s1, n_resample)
                anc, state_rs = ops.resample_move_f_chains(f, state, n, guard_n=n_resample)
                if has_ref:
                    anc[:, n - 1] = ref_anc

                    def put_ref(mv, r):
                        mv[:, n - 1] = r
                    tree_map(put_ref, state_rs, ref_row)
            else:
                # A resampler with no kernel form: once a chain, with its host key.
                s = _TABLE_TAGS.index(rngmod.RESAMPLE)
                rows = []
                for c in range(C):
                    rk = rngmod.Key(int(host_words[0][s, t, c]), int(host_words[1][s, t, c]))
                    a = resampler.resampler(rk, e[c] / s1[c], n_resample)
                    rows.append(torch.cat([a, ref_anc[c:c + 1]]) if has_ref else a)
                anc = torch.stack(rows)
                state_rs = tree_map(lambda a: a[chains[:, None], anc.long()], state)
            if flags is None:
                state = state_rs
                ancestors[:, t] = anc
                pending = ln_n
            else:
                state = _chain_where(flags, state_rs, state)
                ancestors[:, t] = torch.where(flags[:, None], anc, iota)
                pending = torch.where(flags, ln_n, lse)
        else:
            ancestors[:, t] = iota
            pending = lse
        resampled[:, t] = host_flags

        def step(a, b, st, r, t=t):
            return kernel.step(t, rngmod.StepRng(rngmod.KeyBatch(a, b), gids), st, r, ref_mask)

        k = _table_keys(table, rngmod.PROPAGATE, t)
        state, score = _chain_map("kernel.step", step, (0, 0, 0, ref_dim))(
            k.k0, k.k1, state, ref_at(t))
        # After a resample the weights restart at 0, so the new weights are the score.
        if not fire:
            logw = logw + score
        elif flags is None:
            logw = score
        else:
            logw = torch.where(flags[:, None], score, logw + score)
        if do_store:
            store(t, snap_fn(state))

    log_z = log_z + (torch.logsumexp(logw, -1) - pending)

    return SweepResult(
        log_evidence=log_z,
        log_weights=logw,
        states=states,
        ancestors=ancestors,
        final_state=state,
        ess=ess_all,
        resampled=resampled.to(device),
    )


def lineages(ancestors: torch.Tensor) -> torch.Tensor:
    """``lineage[t, i]`` = the slot at time ``t`` of the particle that occupies
    slot ``i`` at the final time (backward pass over the genealogy).  For
    chains' ancestors ``[C, T, N]``, ``lineage[c, t, i]`` chain by chain."""
    T, n = ancestors.shape[-2:]
    out = torch.empty_like(ancestors)
    idx = torch.arange(n, dtype=ancestors.dtype, device=ancestors.device)
    idx = idx.expand(ancestors.shape[:-2] + (n,))
    out[..., T - 1, :] = idx
    for t in range(T - 1, 0, -1):
        idx = ancestors[..., t, :].gather(-1, idx.long())
        out[..., t - 1, :] = idx
    return out


def _lineage_slots(ancestors: torch.Tensor, index) -> torch.Tensor:
    """``[T]`` int64 slots of the lineage that ends in slot ``index`` (an int
    or a one-element tensor, read on the device): a backward walk carrying
    one slot, with no host sync.  For chains' ancestors ``[C, T, N]`` and
    ``index [C]``, ``[C, T]``."""
    T = ancestors.shape[-2]
    lead = ancestors.shape[:-2]
    idx = torch.as_tensor(index, device=ancestors.device).reshape(lead + (1,)).long()
    slots = [idx]
    for t in range(T - 1, 0, -1):
        idx = ancestors[..., t, :].gather(-1, idx).long()
        slots.append(idx)
    return torch.cat(slots[::-1], dim=-1)


def reconstruct(states, ancestors: torch.Tensor, index: Optional[int]):
    """Trajectories through the genealogy (``states`` a tensor or tree of
    ``[T, N, ...]`` leaves): ``index`` None → all N ``[T, N, ...]``; a slot
    ``index`` (int or one-element tensor) → ``[T, ...]``.  For chains
    (``ancestors [C, T, N]``, leaves ``[C, T, N, ...]``, ``index [C]``) the
    same with a leading chain axis."""
    T = ancestors.shape[-2]
    steps = torch.arange(T, device=ancestors.device)
    if ancestors.dim() == 3:
        ch = torch.arange(ancestors.shape[0], device=ancestors.device)
        if index is None:
            lin = lineages(ancestors).long()
            return tree_map(lambda s: s[ch[:, None, None], steps[None, :, None], lin], states)
        slots = _lineage_slots(ancestors, index)
        return tree_map(lambda s: s[ch[:, None], steps[None, :], slots], states)
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

    For a chain batch (``key`` a :class:`~advancedps_tpu_torch.rng.KeyBatch`,
    ``ancestors [C, T, N]``, ``index [C]``, ``ref`` with a chain axis) the C
    one-particle replays run as one batch under ``vmap``, ``[C, 1]`` a step;
    returns ``[C, T, ...]``.
    """
    if isinstance(key, rngmod.KeyBatch):
        return _replay_chains(key, kernel, ancestors, index, ref)
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


def _replay_chains(keys, kernel, ancestors, index, ref):
    """:func:`replay_trajectory` for a chain batch."""
    C, T, n = ancestors.shape
    device = ancestors.device
    has_ref = ref is not None
    slots = _lineage_slots(ancestors, index)  # [C, T]
    ref_dim = None
    if has_ref:
        ref = _tree.as_reference(ref, device)
        ref_dim = 0
    table, _ = _key_table(keys, T, device)

    def ref_at(t):
        return None if ref is None else tree_map(lambda a: a[:, t], ref)

    def mask_of(g):
        return (g == n - 1) if has_ref else None

    def init(a, b, g, r0):
        return kernel.init(rngmod.StepRng(rngmod.KeyBatch(a, b), g), r0, mask_of(g))[0]

    k = _table_keys(table, rngmod.INIT, 0)
    state = _chain_map("kernel.init", init, (0, 0, 0, ref_dim))(
        k.k0, k.k1, slots[:, 0:1], ref_at(0))
    snap_fn = _snapshot_fn(kernel, state)
    if snap_fn is None:
        raise ValueError("replay requires a kernel with per-step snapshots")
    snaps = [snap_fn(state)]
    for t in range(1, T):
        def step(a, b, g, st, r, t=t):
            return kernel.step(t, rngmod.StepRng(rngmod.KeyBatch(a, b), g), st, r,
                               mask_of(g))[0]

        k = _table_keys(table, rngmod.PROPAGATE, t)
        state = _chain_map("kernel.step", step, (0, 0, 0, 0, ref_dim))(
            k.k0, k.k1, slots[:, t:t + 1], state, ref_at(t))
        snaps.append(snap_fn(state))
    return tree_map(lambda *xs: torch.stack(xs, dim=1)[:, :, 0], *snaps)
