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
moved by them (:func:`~advancedps_tpu_torch.ops.resample.move_by_ancestors`:
B3 for the 32-bit leaves, a gather for the others).

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

While a :mod:`torch.profiler` session records, a sweep marks its set-up, each
step's weights, gate, resampling (or identity ancestors) and propagate +
score, and its close with ``aps.*`` spans (:mod:`~advancedps_tpu_torch.tracing`).

One loop serves one chain and a batch of chains: a
:class:`~advancedps_tpu_torch.rng.KeyBatch` of C keys runs C independent
sweeps as one batch, every tensor with a leading chain axis.  The step's
arithmetic runs over the last axis, so ``[N]`` and ``[C, N]`` share it; a
layout (:class:`_OneChain`, :class:`_ChainBatch`) holds what differs: the step
keys (folded on the host, or read from a key table built once), the kernel's
calls (under :func:`torch.func.vmap` over the chains, as the JAX package
``vmap``s the whole sampler), the gate's read (a ``[C]`` flag vector once a
step), the resampling kernels (those with the chain axis, one set of launches
for all C) and a user's resampler, which takes a
:class:`~advancedps_tpu_torch.rng.Key` and so runs once a chain.  A step on
which no chain fires launches no resampling kernel; on one where some do,
the others keep their rows, weights and identity ancestors by a ``where``, as
JAX's ``vmap`` of ``lax.cond`` does.  Chain ``c`` draws what the one-chain
sweep with ``keys.key(c)`` draws, bitwise that sweep where torch reduces a
row of ``[C, N]`` in the order it reduces an ``[N]`` vector.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch.func import vmap

from . import _tree, rng as rngmod, tracing
from ._device import resolve_device
from ._tree import tree_at, tree_map, tree_rows, tree_stack
from .ops import resample as ops
from .resampling import (
    ResampleWithESSThreshold,
    multinomial_spacings,
    randcat_gumbel,
    resample_multinomial,
    resample_residual,
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
    "propagate_rng",
]

#: Schemes whose draw reduces to monotone extents and runs through the kernels.
_FUSED_SCHEMES = {
    resample_systematic: "systematic",
    resample_stratified: "stratified",
    resample_multinomial: "multinomial",
}


def propagate_rng(key, t: int, gids) -> rngmod.StepRng:
    """The :class:`~advancedps_tpu_torch.rng.StepRng` of the propagate stream
    at step ``t``, as the sweep builds it: ``key`` a
    :class:`~advancedps_tpu_torch.rng.Key` or a
    :class:`~advancedps_tpu_torch.rng.KeyBatch`.  A profiler of a step calls
    this rather than building its own."""
    return rngmod.StepRng(rngmod.step_key(key, rngmod.PROPAGATE, t), gids)


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


def _fused_extents(scheme, rs_key, logw, m, s1, n_resample, u=None):
    """Nondecreasing int32 extents ``[M]`` of the scheme's draw of
    ``n_resample`` positions, through the kernels; for C chains (``logw [C,
    N]``, ``rs_key`` a key column, ``u`` the systematic offsets ``[C]``)
    ``[C, M]``, through the kernels with the chain axis."""
    chains = logw.dim() == 2
    if scheme == "systematic":
        if chains:
            return ops.extents_from_logw_chains(logw, m, s1, u, n_resample)
        return ops.extents_from_logw(logw, m, s1, rngmod.uniform(rs_key), n_resample)
    prefix = ops.scaled_prefix_from_logw_chains if chains else ops.scaled_prefix_from_logw
    if scheme == "stratified":
        return stratified_extents(rs_key, prefix(logw, m, n_resample / s1), n_resample)
    # multinomial: sorted uniforms S_k / S_n by exponential spacings; the
    # extent of j counts the S_k below cdf_j · S_n.
    g = multinomial_spacings(rs_key, n_resample, device=logw.device)
    S = (ops.prefix_sum_chains if chains else ops.prefix_sum)(g)
    thr = prefix(logw, m, S[..., n_resample] / s1)
    # B7 (or B8) once for all chains, on the rows of S as they lie.
    count = ops.count_le_sorted_auto_chains if chains else ops.count_le_sorted_auto
    return count(S[..., :n_resample], thr)


def _reduce_weights(logw):
    """A step's one reduction family over the last axis of ``logw`` (``[N]`` or
    ``[C, N]``): the max ``m``, ``e = exp(logw − m)``, ``Σe`` and ``Σe²``."""
    # One chain keeps torch.max, the all-reduce it has always launched.
    m = torch.max(logw) if logw.dim() == 1 else torch.amax(logw, -1)
    e = torch.exp(logw - m.unsqueeze(-1))
    return m, e, torch.sum(e, -1), torch.sum(e * e, -1)


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


def _chain_where(flags, new, old):
    """Leaf by leaf, chain ``c``'s ``new`` where ``flags[c]``, else its ``old``;
    ``new`` where ``flags`` is None (every chain fires)."""
    if flags is None:
        return new

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


class _OneChain:
    """One sweep: step keys folded on the host, the kernel called as it is,
    the gate one host ``bool``."""

    lead = ()
    all_fire, no_fire = True, False
    move = "resample_move_f"
    rows = staticmethod(tree_rows)

    def __init__(self, key, kernel, ref, n_steps, device):
        self.key, self.kernel, self.ref = key, kernel, ref

    def step_key(self, tag, t):
        return rngmod.step_key(self.key, tag, t)

    def offset(self, t):
        return None  # drawn from the resampling key, where the scheme needs one

    def init(self, gids, ref_mask):
        rng0 = rngmod.StepRng(self.step_key(rngmod.INIT, 0), gids)
        return self.kernel.init(rng0, tree_at(self.ref, 0), ref_mask)

    def step(self, t, gids, ref_mask, state):
        return self.kernel.step(t, propagate_rng(self.key, t, gids), state,
                                tree_at(self.ref, t), ref_mask)

    def transition_logprob(self, t, state):
        return self.kernel.transition_logprob(t, state, tree_at(self.ref, t))

    def snapshots(self, state, store: bool):
        """``(the kernel's snapshot, that of state)``, or Nones where nothing is stored."""
        snap = self.kernel.snapshot(state)
        return (self.kernel.snapshot, snap) if store and snap is not None else (None, None)

    def gate(self, ess, limit):
        """``(the step's record, whether a chain fires, the flags where only some do)``."""
        fire = bool(ess <= limit)
        return fire, fire, None

    def resample(self, resampler, rs_key, t, e, s1, n):
        return resampler(rs_key, e / s1, n)


class _ChainBatch:
    """C sweeps as one batch: step keys from the key table, the kernel under
    ``vmap`` over the chains, the gate read once a step for all C."""

    move = "resample_move_f_chains"

    def __init__(self, keys, kernel, ref, n_steps, device):
        C = len(keys)
        self.kernel, self.ref, self.lead = kernel, ref, (C,)
        self.all_fire, self.no_fire = [True] * C, [False] * C
        self.table, self.host = _key_table(keys, n_steps, device)
        s = _TABLE_TAGS.index(rngmod.RESAMPLE)
        self.offsets = self.table[2, s].to(torch.int32).view(torch.float32) - 1.0  # [T, C]

    def step_key(self, tag, t):
        return _table_keys(self.table, tag, t).column()

    def offset(self, t):
        return self.offsets[t]

    def _ref_at(self, t):
        return None if self.ref is None else tree_map(lambda a: a[:, t], self.ref)

    def _map(self, name, fn, tag, t, gids, ref_mask, *rest):
        """``fn(rng, ref_t, ref_mask, *rest)`` under ``vmap``, a chain's ids and
        mask its own in a replay (``[C, 1]``), shared in a sweep."""
        def call(a, b, g, r, msk, *rest):
            return fn(rngmod.StepRng(rngmod.KeyBatch(a, b), g), r, msk, *rest)

        g = 0 if gids.dim() == 2 else None
        dims = (0, 0, g, None if self.ref is None else 0, None if ref_mask is None else g)
        k = _table_keys(self.table, tag, t)
        return _chain_map(name, call, dims + (0,) * len(rest))(
            k.k0, k.k1, gids, self._ref_at(t), ref_mask, *rest)

    def init(self, gids, ref_mask):
        return self._map("kernel.init", self.kernel.init, rngmod.INIT, 0, gids, ref_mask)

    def step(self, t, gids, ref_mask, state):
        return self._map("kernel.step", lambda rng, r, msk, st: self.kernel.step(
            t, rng, st, r, msk), rngmod.PROPAGATE, t, gids, ref_mask, state)

    def transition_logprob(self, t, state):
        return _chain_map("kernel.transition_logprob",
                          lambda st, r: self.kernel.transition_logprob(t, st, r), (0, 0))(
            state, self._ref_at(t))

    def snapshots(self, state, store: bool):
        # Asked of chain 0's state whether the kernel records a snapshot.
        if self.kernel.snapshot(tree_map(lambda a: a[0], state)) is None or not store:
            return None, None
        snap = _chain_map("kernel.snapshot", self.kernel.snapshot, (0,))
        return snap, snap(state)

    def gate(self, ess, limit):
        flags = ess <= limit
        host = flags.cpu().tolist()  # the step's one read of the gate
        if all(host):
            return host, True, None  # every chain fires: nothing to keep
        return host, any(host), flags

    @staticmethod
    def rows(state, idx):
        return tree_map(lambda a: ops._rows_of(a, idx), state)

    def resample(self, resampler, rs_key, t, e, s1, n):
        if resampler is resample_residual:
            # One draw for all chains, from their keys on the device.
            return resampler(rs_key, e / s1[:, None], n)
        # A user's resampler takes a Key: once a chain, with its host key.
        s = _TABLE_TAGS.index(rngmod.RESAMPLE)
        return torch.stack([resampler(
            rngmod.Key(int(self.host[0][s, t, c]), int(self.host[1][s, t, c])),
            e[c] / s1[c], n) for c in range(self.lead[0])])


def _layout(key, kernel, ref, n_steps, device):
    """The chain axis, decided once: a batch for a ``KeyBatch``, else one chain."""
    batch = isinstance(key, rngmod.KeyBatch)
    return (_ChainBatch if batch else _OneChain)(key, kernel, ref, n_steps, device)


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
    span = tracing.spans()
    with span("aps.setup"):
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
        lay = _layout(key, kernel, ref, T, device)
        lead = lay.lead

        def ix(i):  # index i of the axis after the chain axis (time, or slot)
            return (slice(None),) * len(lead) + (i,)

        state, logw = lay.init(gids, ref_mask)
        snapshot, snap0 = lay.snapshots(state, store_states)
        states = None

        def put(tree, i, vals):  # leaf by leaf, tree[ix(i)] = vals
            def one(buf, v):
                buf[ix(i)] = v
            tree_map(one, tree, vals)

        if snapshot is not None:
            states = tree_map(lambda s: torch.empty(lead + (T,) + s.shape[len(lead):],
                                                    dtype=s.dtype, device=device), snap0)
            put(states, 0, snap0)

        iota = torch.arange(n, dtype=torch.int32, device=device)
        ancestors = torch.empty(lead + (T, n), dtype=torch.int32, device=device)
        ancestors[ix(0)] = iota
        ess_all = torch.empty(lead + (T,), dtype=torch.float32, device=device)
        ess_all[ix(0)] = float(n)
        resampled = [lay.no_fire] * T

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
        with span("aps.weights"):
            m, e, s1, s2 = _reduce_weights(logw)
            lse = m + torch.log(s1)
            log_z = log_z + (lse - pending)

            ess = (s1 * s1) / s2
            ess_all[ix(t)] = ess
        if always_resample:
            record, fire, flags = lay.all_fire, True, None
        else:
            with span("aps.gate"):
                record, fire, flags = lay.gate(ess, resampler.threshold * n)

        if fire:
            with span("aps.resample"):
                rs_key = lay.step_key(rngmod.RESAMPLE, t)
                if has_ref:
                    # The reference slot's ancestor ([1], or [C, 1]), from the
                    # state and weights before the move: n − 1 (PG), or drawn
                    # ∝ w_i·f_t(ref_t | x_i) (PGAS).  A device tensor: no host sync.
                    if ancestor_sampling:
                        anc_logw = logw + lay.transition_logprob(t, state)
                        ref_anc = randcat_gumbel(lay.step_key(rngmod.ANCESTOR, t), anc_logw,
                                                 gids).unsqueeze(-1)
                    else:
                        ref_anc = iota[n - 1:].expand(lead + (1,))
                    ref_row = lay.rows(state, ref_anc)
                if scheme is not None:
                    f = _fused_extents(scheme, rs_key, logw, m, s1, n_resample,
                                       lay.offset(t))
                    # With a reference, slot n − 1 decodes past the drawn
                    # population (ancestor M clipped to M − 1; row 0, or row
                    # M − 1 under move version 0) and is overwritten with the
                    # reference row in place.
                    anc, state_rs = getattr(ops, lay.move)(f, state, n, guard_n=n_resample)
                    if has_ref:
                        anc[ix(slice(n - 1, None))] = ref_anc
                        put(state_rs, slice(n - 1, None), ref_row)
                else:
                    anc = lay.resample(resampler.resampler, rs_key, t, e, s1, n_resample)
                    anc = anc.to(torch.int32)
                    if has_ref:
                        anc = torch.cat([anc, ref_anc], -1)
                    _, state_rs = ops.move_by_ancestors(anc, state)
                state = _chain_where(flags, state_rs, state)
                ancestors[ix(t)] = _chain_where(flags, anc, iota)
                pending = _chain_where(flags, ln_n, lse)
        else:
            with span("aps.keep"):
                ancestors[ix(t)] = iota
                pending = lse
        resampled[t] = record

        with span("aps.propagate_score"):
            state, score = lay.step(t, gids, ref_mask, state)
            # After a resample the weights restart at 0, so the new weights are the score.
            if not fire:
                logw = logw + score
            elif flags is None:
                logw = score
            else:
                logw = torch.where(flags[:, None], score, logw + score)
            if snapshot is not None:
                put(states, t, snapshot(state))

    with span("aps.close"):
        log_z = log_z + (torch.logsumexp(logw, -1) - pending)
        return SweepResult(
            log_evidence=log_z,
            log_weights=logw,
            states=states,
            ancestors=ancestors,
            final_state=state,
            ess=ess_all,
            # The host's records, [T] or [T, C], as [T] or [C, T] on the device.
            resampled=torch.tensor(resampled).movedim(0, -1).contiguous().to(device),
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
    if index is None:
        slots = lineages(ancestors).long()
    else:
        slots = _lineage_slots(ancestors, index)
    # An arange over each leading axis (the chains', the steps') against the slots.
    device = ancestors.device
    grid = [torch.arange(size, device=device).reshape((-1,) + (1,) * (slots.dim() - i - 1))
            for i, size in enumerate(ancestors.shape[:-1])]
    return tree_map(lambda s: s[(*grid, slots)], states)


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
    T, n = ancestors.shape[-2:]
    slots = _lineage_slots(ancestors, index)
    if ref is not None:
        ref = _tree.as_reference(ref, ancestors.device)
    lay = _layout(key, kernel, ref, T, ancestors.device)

    def ids(t):  # step t's particle ids ([1], or [C, 1]) and reference mask
        g = slots[..., t:t + 1]
        return g, (g == n - 1) if ref is not None else None

    state, _ = lay.init(*ids(0))
    snapshot, snap0 = lay.snapshots(state, True)
    if snapshot is None:
        raise ValueError("replay requires a kernel with per-step snapshots")
    snaps = [snap0]
    for t in range(1, T):
        state, _ = lay.step(t, *ids(t), state)
        snaps.append(snapshot(state))
    k = len(lay.lead)
    return tree_map(lambda s: s.select(k + 1, 0), tree_stack(snaps, k))
