"""Sharded particle sweep (PyTorch port of ``advancedps_tpu/parallel/sharded.py``).

The particles are split into K shards of L = N/K along a
:class:`~advancedps_tpu_torch.parallel.mesh.ParticleMesh`.  One controller
runs each step on every shard in turn, then the collectives, as JAX's
``shard_map`` does:

* Global ids ``k·L + arange(L)`` key every draw, so propagation does not
  depend on the layout.
* One (max, Σe, Σe²) family per step — a :func:`pmax` and one :func:`psum` of
  the shards' float32 partial sums — feeds the ESS gate, the log-evidence
  increment (with the carried ``pending`` base) and the extents.  The gate is
  a host ``if``, as in the port's engine.  Summed in another order than the
  single-device sweep's ``torch.sum``, Σe may differ from it by an ulp; the
  systematic extents then move by one at the positions within that ulp of a
  stratum boundary, and the two sweeps follow different (equally valid)
  particle systems from that firing on.
* On a firing, one of three exchanges moves the state:

  - ``"allgather"``: every shard gathers the log-weights and the state and
    decodes its window ``[k·L, k·L + L)`` of the whole population's extents
    (B1, or B6-B8 for stratified and multinomial, then the windowed decode +
    move); a residual or user resampler draws all ancestors and gathers.
  - ``"neighbor"`` (systematic only): systematic ancestors are monotone, so
    when no shard's boundary extent strays more than one shard, shard k's
    owners lie in shards k−1, k, k+1.  Each shard stitches its local extents
    to the replicated boundary extents ``fb``, two :func:`ppermute` calls
    ship the neighbours' extents and rows, and the decode + move runs over
    those 3L rows: O(L·D) per shard instead of O(N·D).
  - ``"auto"`` (the default): the neighbour exchange when a K-scalar
    predicate on ``fb`` holds (one host read per firing), else the
    all-gather.  Exact either way.

* The state may be a tree of tensors, as in the engine: every collective
  that moves it runs leaf by leaf, and the decode + move of a window moves
  every leaf after one decode.  Per-particle keys fold the global id, so a
  component sampled particle by particle draws what it draws in the
  single-device sweep.
* The reference particle of a conditional sweep occupies the last slot of
  the last shard.  Its PGAS ancestor is a local Gumbel argmax per shard, then
  a :func:`pmax` of the value and a :func:`pmin` of the global id (ties to the
  smallest id, as one argmax over all N).

With K logical shards on one card the per-step kernels launch K times; the
sharded sweep is then slower than the single-device one, and serves to check
the exchange.  Shards on distinct cards run the same code.

On a mesh that spans processes (:func:`~advancedps_tpu_torch.parallel.mesh.init_distributed`)
each rank runs only its local shards (``mesh.local``, their global shard
numbers), the per-shard lists below hold those, and the collectives gather
across the ranks and fold in shard order: every rank computes the same
replicated values, takes the same host decisions from them, and returns the
whole result (:meth:`~advancedps_tpu_torch.parallel.mesh.ParticleMesh.join`).
The sweep is then bitwise the one-process K-shard sweep.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any

import torch

from .. import _tree, rng as rngmod
from .._tree import tree_at, tree_flatten, tree_map, tree_rows, tree_unflatten
from ..engine import _FUSED_SCHEMES, SweepResult, _fused_extents
from ..ops import resample as ops
from ..resampling import ResampleWithESSThreshold
from .mesh import PARTICLE_AXIS, ParticleMesh, all_gather, pmax, pmin, ppermute, psum

__all__ = ["sharded_sweep", "sweep_shard_body"]

EXCHANGES = ("auto", "allgather", "neighbor")


def _kernel_on(kernel, device):
    """A deep copy of ``kernel`` with its module and tensor attributes moved
    to ``device``."""
    k = copy.deepcopy(kernel)
    for name, val in vars(k).items():
        if isinstance(val, (torch.nn.Module, torch.Tensor)):
            setattr(k, name, val.to(device))
    return k


def _replicas(kernel, devices):
    """The kernel for each shard: ``kernel`` itself on the first shard's
    device (where its tensors must lie), a copy on any other device."""
    copies = {devices[0]: kernel}
    for d in devices:
        if d not in copies:
            copies[d] = _kernel_on(kernel, d)
    return [copies[d] for d in devices]


def _leafwise(collective, mesh, trees, *args, **kwargs):
    """A collective over the shards' trees of one structure, leaf by leaf
    (one call of the collective for a tensor)."""
    flat = [tree_flatten(t) for t in trees]
    structure = flat[0][1]
    per_leaf = [collective(mesh, [f[0][i] for f in flat], *args, **kwargs)
                for i in range(len(flat[0][0]))]
    return [tree_unflatten(structure, [leaf[k] for leaf in per_leaf]) for k in range(len(trees))]


@dataclass
class _Shards:
    """What every step of one sharded sweep reads.  The lists hold this
    process's shards, in the order of ``mesh.local``."""

    mesh: ParticleMesh
    kernels: list  # one per local shard
    gids: list  # int64 [L] global ids per local shard
    refs: list  # the reference trajectory per local shard, or None
    masks: list  # the reference slot's mask per local shard, or None
    n: int
    L: int
    n_resample: int

    @property
    def has_ref(self) -> bool:
        return self.refs[0] is not None

    @property
    def holds_last(self) -> bool:
        """Whether this process holds the last shard, the reference slot's."""
        return self.mesh.local[-1] == self.mesh.size - 1


def _draw_ref_anc(sh: _Shards, key, t, states, logws, ancestor_sampling: bool):
    """The reference slot's ancestor, replicated: n − 1 (PG), or the Gumbel
    argmax of ``logw + log f_t(ref_t | x)`` over all shards (PGAS)."""
    mesh = sh.mesh
    if not ancestor_sampling:
        return [torch.tensor(sh.n - 1, dtype=torch.int32, device=d) for d in mesh.devices]
    anc_key = rngmod.step_key(key, rngmod.ANCESTOR, t)
    best, values = [], []
    for i in range(len(mesh.local)):
        alw = logws[i] + sh.kernels[i].transition_logprob(t, states[i], tree_at(sh.refs[i], t))
        u = rngmod.pos_uniform(anc_key, sh.gids[i])
        z = alw - torch.log(-torch.log(u))  # randcat_gumbel's expression
        li = torch.argmax(z)
        best.append(sh.gids[i][li].to(torch.int32))
        values.append(z[li])
    vmax = pmax(mesh, values)
    cands = [torch.where(v == vm, b, torch.full_like(b, sh.n))
             for v, vm, b in zip(values, vmax, best)]
    return pmin(mesh, cands)


def _apply_ref(sh: _Shards, local_anc, moved, ref_anc, ref_row):
    """Overwrite the reference slot (global n − 1: the last slot of the last
    shard, the last local one of the process that holds it) with the retained
    ancestor draw and its pre-move row."""
    local_anc[-1][sh.L - 1] = ref_anc[-1]

    def put(mv, r):
        mv[sh.L - 1] = r[0]
    tree_map(put, moved[-1], ref_row)


def _exchange_allgather(sh: _Shards, rs_key, resampler, scheme, states, logws, es, ms, s1s,
                        ref_anc):
    """Replicate the log-weights (or weights) and the state, O(N·D) per
    shard, and decode and move each shard's window of the whole population."""
    mesh, L, nr = sh.mesh, sh.L, sh.n_resample
    mesh.exchanges["allgather"] += 1
    local_anc, moved = [], []
    if scheme is not None:
        logw_all = all_gather(mesh, logws)
        state_all = _leafwise(all_gather, mesh, states)
        for i, k in enumerate(mesh.local):
            f = _fused_extents(scheme, rs_key, logw_all[i], ms[i], s1s[i], nr)
            a, mv = ops.resample_move_window_fext(f, state_all[i], nr, k * L, L)
            local_anc.append(a)
            moved.append(mv)
        if sh.has_ref and sh.holds_last:
            ref_row = tree_rows(state_all[-1], ref_anc[-1].reshape(1))
            _apply_ref(sh, local_anc, moved, ref_anc, ref_row)
        return local_anc, moved
    e_all = all_gather(mesh, es)
    state_all = _leafwise(all_gather, mesh, states)
    for i in range(len(mesh.local)):
        anc = resampler.resampler(rs_key, e_all[i] / s1s[i], nr)
        if sh.has_ref:
            anc = torch.cat([anc, ref_anc[i].reshape(1)])
        a = anc[sh.gids[i]]
        local_anc.append(a)
        moved.append(tree_rows(state_all[i], a))
    return local_anc, moved


def _neighbours_suffice(fb, K: int, L: int) -> bool:
    """Every shard k's owners lie in shards k−1, k, k+1.  Right: the owner of
    k's last slot lies before row (k+2)·L ⟸ ``fb[k+1] ≥ (k+1)·L``.  Left: the
    rows before (k−1)·L are consumed by slot k·L ⟸ ``fb[k−2] ≤ k·L``."""
    ok_right = all(fb[i + 1] >= (i + 1) * L for i in range(K - 1))
    ok_left = all(fb[i] <= (i + 2) * L for i in range(K - 2))
    return ok_right and ok_left


def _exchange_neighbor(sh: _Shards, u, states, es, s1s, prefix, fb, ref_anc):
    """O(L·D) per shard: stitch the local extents to the boundary extents
    ``fb``, ship the neighbours' extents and rows by two ring shifts each, and
    decode and move over the 3L rows."""
    mesh, L, nr, K = sh.mesh, sh.L, sh.n_resample, sh.mesh.size
    mesh.exchanges["neighbor"] += 1
    f_loc = []
    for i, k in enumerate(mesh.local):
        # B1's formula with the float64 prefix offset by the shards before
        # this one, so the extents agree with the all-gather exchange; then
        # clip, set the last extent to fb[k] and take the running max, so
        # the stitched extents are nondecreasing across shards and each
        # shard's last one is bitwise fb[k].
        p = torch.cumsum(es[i], 0, dtype=torch.float64)
        if k:
            p = p + prefix[i][k - 1]
        f = torch.minimum(ops.extents_from_prefix(p, s1s[i], u, nr), fb[i][k])
        if k:
            f = torch.maximum(f, fb[i][k - 1])
        f[L - 1] = fb[i][k]
        f_loc.append(torch.cummax(f, 0).values)
    f_left, f_right = ppermute(mesh, f_loc, 1), ppermute(mesh, f_loc, -1)
    s_left, s_right = _leafwise(ppermute, mesh, states, 1), _leafwise(ppermute, mesh, states, -1)
    local_anc, moved = [], []
    for i, k in enumerate(mesh.local):
        # Ring wrap: shard 0's left block is consumed (extent 0), shard K−1's
        # right block lies past every drawn slot (extent nr).
        fl = torch.zeros_like(f_loc[i]) if k == 0 else f_left[i]
        fr = torch.full_like(f_loc[i], nr) if k == K - 1 else f_right[i]
        f_ext = torch.cat([fl, f_loc[i], fr])
        state_ext = tree_map(lambda *parts: torch.cat(parts), s_left[i], states[i], s_right[i])
        a, mv = ops.resample_move_window_fext(f_ext, state_ext, nr, k * L, L)
        local_anc.append(torch.clamp((k - 1) * L + a, 0, sh.n - 1))
        moved.append(mv)
    if sh.has_ref:
        # One global row, exactly: every shard offers its clipped candidate
        # row and the owner's is taken from the K-row gather.
        cands = [tree_rows(states[i], torch.clamp(ref_anc[i] - k * L, 0, L - 1).reshape(1))
                 for i, k in enumerate(mesh.local)]
        rows = _leafwise(all_gather, mesh, cands)
        if sh.holds_last:
            ref_row = tree_rows(rows[-1], (ref_anc[-1] // L).reshape(1))
            _apply_ref(sh, local_anc, moved, ref_anc, ref_row)
    return local_anc, moved


def _resample(sh: _Shards, key, t, resampler, scheme, exchange, ancestor_sampling, states,
              logws, es, ms, s1s):
    """One firing: the reference ancestor, then the exchange."""
    mesh, K, nr = sh.mesh, sh.mesh.size, sh.n_resample
    rs_key = rngmod.step_key(key, rngmod.RESAMPLE, t)
    ref_anc = _draw_ref_anc(sh, key, t, states, logws, ancestor_sampling) if sh.has_ref else None
    if exchange == "allgather" or scheme != "systematic" or K < 2:
        return _exchange_allgather(sh, rs_key, resampler, scheme, states, logws, es, ms, s1s,
                                   ref_anc)
    u = rngmod.uniform(rs_key)
    # K scalars: the shards' weight sums, in float64 as B1's prefix is → the
    # boundary extent fb[k] of each shard's last row, by B1's formula.
    sums = all_gather(mesh, [e.sum(dtype=torch.float64) for e in es], tiled=False)
    prefix = [torch.cumsum(s, 0) for s in sums]
    fb = []
    for p, s1 in zip(prefix, s1s):
        b = ops.extents_from_prefix(p, s1, u, nr)
        b[K - 1] = nr
        fb.append(b)
    if exchange == "auto" and not _neighbours_suffice(fb[0].tolist(), K, sh.L):
        return _exchange_allgather(sh, rs_key, resampler, scheme, states, logws, es, ms, s1s,
                                   ref_anc)
    return _exchange_neighbor(sh, u, states, es, s1s, prefix, fb, ref_anc)


@torch.no_grad()
def sweep_shard_body(
    key: rngmod.Key,
    kernel,
    ref: Any,
    *,
    n: int,
    L: int,
    resampler: ResampleWithESSThreshold,
    mesh: ParticleMesh,
    ancestor_sampling: bool = False,
    store_states: bool = True,
    exchange: str = "auto",
):
    """The sharded sweep on every local shard of ``mesh`` in lockstep, ``L`` =
    n/K particles per shard.

    ``exchange`` picks the state exchange on a firing (module docstring):
    ``"auto"``, ``"allgather"``, or ``"neighbor"``, the neighbour exchange
    without the predicate's fallback, which gives wrong results where a
    firing's owners leave the neighbour window (for tests of the collective
    footprint).  Only systematic resampling has the neighbour exchange.

    Returns ``(states, logws, log_z, snaps, ancs, ess, resampled)``: lists
    over the local shards of the final state and log-weights ``[L, ...]``,
    the snapshots ``[T, L, ...]`` (or None) and global ancestor ids
    ``[T, L]`` (row 0 the shard's own ids); the log-evidence and ``ess [T]``
    on the first local shard's device; ``resampled`` a list of T bools.
    """
    if exchange not in EXCHANGES:
        raise ValueError(f"unknown exchange {exchange!r}")
    K = mesh.size
    if n != K * L:
        raise ValueError(f"n={n} is not {K} shards of {L}")
    T = kernel.num_steps
    has_ref = ref is not None
    devs = mesh.devices
    gids = [torch.arange(k * L, (k + 1) * L, device=d) for k, d in zip(mesh.local, devs)]
    nl = len(devs)
    refs, masks = [None] * nl, [None] * nl
    if has_ref:
        refs = [_tree.as_reference(ref, d) for d in devs]
        masks = [g == n - 1 for g in gids]
    # With a reference, n − 1 positions are drawn and slot n − 1 keeps it.
    sh = _Shards(mesh, _replicas(kernel, devs), gids, refs, masks, n, L,
                 n - 1 if has_ref else n)
    scheme = _FUSED_SCHEMES.get(resampler.resampler)

    init_key = rngmod.step_key(key, rngmod.INIT, 0)
    states, logws = [], []
    for i in range(nl):
        s, lw = sh.kernels[i].init(rngmod.StepRng(init_key, gids[i]), tree_at(refs[i], 0),
                                   masks[i])
        states.append(s)
        logws.append(lw)

    snaps = None

    def store(i, t, snap):
        def put(buf, s):
            buf[t] = s
        tree_map(put, snaps[i], snap)

    if store_states and sh.kernels[0].snapshot(states[0]) is not None:
        snaps = []
        for i in range(nl):
            s0 = sh.kernels[i].snapshot(states[i])
            snaps.append(tree_map(lambda a, d=devs[i]: torch.empty((T,) + tuple(a.shape),
                                                                   dtype=a.dtype, device=d), s0))
            store(i, 0, s0)
    ancs = [torch.empty((T, L), dtype=torch.int32, device=d) for d in devs]
    for i in range(nl):
        ancs[i][0] = gids[i]
    ess_all = torch.empty(T, dtype=torch.float32, device=devs[0])
    ess_all[0] = float(n)
    resampled = [False] * T

    # Log-evidence as in the engine: each step adds lse − pending, where
    # pending is log n after a firing and the previous lse otherwise.
    ln_n = torch.log(torch.tensor(float(n), dtype=torch.float32, device=devs[0]))
    log_z = ln_n * 0.0
    pending = ln_n
    always_resample = float(resampler.threshold) >= 1.0

    for t in range(1, T):
        ms = pmax(mesh, [torch.max(lw) for lw in logws])
        es = [torch.exp(lw - m) for lw, m in zip(logws, ms)]
        # One length-2 psum of the float32 (Σe, Σe²), as the JAX package has.
        s12 = psum(mesh, [torch.stack([torch.sum(e), torch.sum(e * e)]) for e in es])
        s1s = [s[0] for s in s12]
        lse = ms[0] + torch.log(s1s[0])
        log_z = log_z + (lse - pending)
        ess = (s1s[0] * s1s[0]) / s12[0][1]
        ess_all[t] = ess
        do_rs = always_resample or bool(ess <= resampler.threshold * n)

        if do_rs:
            local_anc, states = _resample(sh, key, t, resampler, scheme, exchange,
                                          ancestor_sampling, states, logws, es, ms, s1s)
            pending = ln_n
        else:
            local_anc = gids
            pending = lse
        resampled[t] = do_rs

        prop_key = rngmod.step_key(key, rngmod.PROPAGATE, t)
        for i in range(nl):
            ancs[i][t] = local_anc[i]
            s, score = sh.kernels[i].step(t, rngmod.StepRng(prop_key, gids[i]), states[i],
                                          tree_at(refs[i], t), masks[i])
            states[i] = s
            # After a firing the weights restart at 0: the new weights are the score.
            logws[i] = score if do_rs else logws[i] + score
            if snaps is not None:
                store(i, t, sh.kernels[i].snapshot(s))

    # Close the pending base with the final weights' log-sum-exp.
    mf = pmax(mesh, [torch.max(lw) for lw in logws])
    sf = psum(mesh, [torch.sum(torch.exp(lw - m)) for lw, m in zip(logws, mf)])
    log_z = log_z + (mf[0] + torch.log(sf[0]) - pending)
    return states, logws, log_z, snaps, ancs, ess_all, resampled


def sharded_sweep(
    key: rngmod.Key,
    kernel,
    n_particles: int,
    resampler: ResampleWithESSThreshold,
    mesh: ParticleMesh,
    ref: Any = None,
    ancestor_sampling: bool = False,
    store_states: bool = True,
    axis: str = PARTICLE_AXIS,
    exchange: str = "auto",
) -> SweepResult:
    """Sharded counterpart of :func:`advancedps_tpu_torch.engine.sweep`.

    ``n_particles`` must divide evenly by the mesh's ``axis`` size;
    ``kernel``'s tensors must lie on the mesh's first (local) device.
    Returns a :class:`SweepResult` whose per-particle tensors join the shards
    in order on the first local device (the counterpart of JAX's sharded
    global arrays); on a mesh that spans processes every rank returns the
    whole result.  ``exchange`` selects the state exchange
    (:func:`sweep_shard_body`).
    """
    n = n_particles
    K = mesh.shape[axis]
    if n % K:
        raise ValueError(f"n_particles={n} not divisible by mesh axis {axis}={K}")
    if ancestor_sampling and ref is None:
        raise ValueError("ancestor_sampling requires a reference trajectory")
    states, logws, log_z, snaps, ancs, ess, resampled = sweep_shard_body(
        key, kernel, ref, n=n, L=n // K, resampler=resampler, mesh=mesh,
        ancestor_sampling=ancestor_sampling, store_states=store_states, exchange=exchange,
    )
    dev = mesh.devices[0]

    def joined(xs, dim=0):
        return tree_map(lambda *parts: mesh.join(parts, dim), *xs)

    return SweepResult(
        log_evidence=log_z,
        log_weights=joined(logws),
        states=None if snaps is None else joined(snaps, 1),
        ancestors=joined(ancs, 1),
        final_state=joined(states),
        ess=ess,
        resampled=torch.tensor(resampled, device=dev),
    )
