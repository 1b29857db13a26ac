"""Generic-program front-end (PyTorch port of ``advancedps_tpu/generic.py``).

A model is an ordinary Python function ``f(ctx)`` that calls
``ctx.sample(dist[, name])`` and ``ctx.observe(dist, value)`` in a static
order: the same capability as the reference's Libtask extension, which runs
arbitrary programs as copyable coroutines, delivered as trace once, execute
many:

* At build time the function runs once, eagerly, for one particle on the CPU
  (:class:`_TracerCtx`), to discover every sample site (shape, dtype, and
  segment: the index of the observe that follows it) and the number of
  observes T.  That run's values are discarded.
* Step ``t`` of a sweep runs the program for all particles at once, under
  :func:`torch.func.vmap` over ``(keys, values, is_ref)``: sites of earlier
  segments read their stored values, segment-``t`` sites draw
  ``dist.sample(fold_in(particle_key, s))`` for site ``s``, later sites are
  zeros, and only the ``t``-th observe adds to the log-weight.  The
  segment is a Python dispatch on the engine's integer ``t``, where the JAX
  package ``lax.switch``es.
* The state is a dense ``[N, S]`` float32 matrix of every site's value; the
  snapshot is the state itself, so a PG trajectory is ``[T, S]`` and its
  last row holds every site.  Sites after the last observe (segment T) are
  drawn during step T−1, so trajectories hold them too.

There is no dead-code elimination in eager PyTorch: where XLA keeps only
segment ``t``'s dependency cone, step ``t`` here runs the program up to the
``t``-th observe (the reads of earlier sites and the program's arithmetic on
them are real launches), so a T-step program costs O(T²) launches a sweep.
Step ``t < T − 1`` stops the program at its ``t``-th observe: draws are
positional in the site index, so stopping changes no draw.  The last step,
and the build trace, run the whole program and check its alignment.

A program whose sample/observe structure depends on sampled values is
rejected with the reference's diagnosis: at trace time when the number of
observes comes out wrong, and under ``vmap`` when a Python ``if`` reads a
particle's value.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch.func import vmap

from . import random as rnd
from . import rng as rngmod
from .engine import SweepKernel, inject_ref

__all__ = ["GenericModel", "GenericSSMKernel", "observe", "sample_site"]


class _TraceError(RuntimeError):
    pass


_MISALIGNED = (
    "mis-aligned execution traces: the model's sample/observe structure depends on "
    "sampled values (e.g. a random number of observations). The posterior for such "
    "models is not well-defined — make the number and order of sample/observe "
    "statements deterministic. (Reference guard: AdvancedPS.jl, "
    "src/container.jl:291-299.)"
)

#: Words of the errors ``vmap`` raises where the program branches on a
#: particle's value: a Python ``if`` on a batched tensor ("... data-dependent
#: control flow") or ``.item()`` on one ("... calling .item() ...").
_VMAP_DATA_DEPENDENT = ("data-dependent control flow", ".item()")


class _StopSegment(BaseException):
    """Raised at the observe that ends a step's part of the program.  A
    ``BaseException``, so that a program's own ``except Exception`` does not
    swallow it."""


@dataclasses.dataclass(frozen=True)
class _Site:
    name: str
    shape: tuple
    dtype: Any
    segment: int  # index of the observe that follows this site
    offset: int  # position in the flat value vector
    size: int


def _value_on(value, device):
    return value.to(device) if isinstance(value, torch.Tensor) else value


class _TracerCtx:
    """Eager, single-run context used once at model build to discover the
    structure; it runs on the CPU and its values are discarded."""

    device = torch.device("cpu")

    def __init__(self, key: rngmod.Key):
        self._key = key
        self.sites = []
        self.n_observes = 0
        self._offset = 0

    def sample(self, dist, name: Optional[str] = None):
        s = len(self.sites)
        val = torch.as_tensor(dist.to(self.device).sample(rngmod.fold_in(self._key, s)))
        size = val.numel()
        self.sites.append(_Site(name=name or f"site_{s}", shape=tuple(val.shape),
                                dtype=val.dtype, segment=self.n_observes,
                                offset=self._offset, size=size))
        self._offset += size
        return val

    def observe(self, dist, value):
        self.n_observes += 1
        return dist.to(self.device).log_prob(_value_on(value, self.device))


class _SegmentCtx:
    """The context for one particle and one segment ``t`` (a Python int).

    ``mode='sample'``: segment-``t`` sites draw fresh values (stored);
    earlier segments read their stored values; later sites are zeros (they
    run after the ``t``-th observe, so they cannot feed it).  Sites after the
    last observe (segment T) are drawn in the final segment T−1.
    ``mode='score'``: every live site reads its stored value; only the
    ``t``-th observe's log-density is evaluated.
    ``mode='step'``: the fused form the sweep kernel runs: one pass draws
    segment-``t``'s sites and scores the ``t``-th observe.  The per-particle
    ``is_ref`` makes the reference slot keep its (injected) stored value
    instead of the fresh draw, by a ``where``, so every particle runs the
    same code and the draw is still made.

    Every distribution and observed tensor the program hands over is brought
    onto the device of ``values`` first.  ``stop`` ends the program at the
    ``t``-th observe (:class:`_StopSegment`).
    """

    def __init__(self, model, t: int, key, values, mode, is_ref=None, stop: bool = False):
        self.model = model
        self.t = t
        self.key = key
        self.values_out = values
        self.mode = mode
        self.is_ref = is_ref
        self.stop = stop
        self.device = values.device
        # The log-weight starts at 0; the same zero is every other observe's
        # value.
        self._zero = torch.zeros((), dtype=values.dtype, device=self.device)
        self.logw = self._zero
        self._site_idx = 0
        self._obs_idx = 0

    def _read(self, site):
        flat = self.values_out[site.offset:site.offset + site.size]
        return flat.reshape(site.shape).to(site.dtype)

    def sample(self, dist, name: Optional[str] = None):
        s = self._site_idx
        self._site_idx += 1
        if s >= len(self.model.sites):
            raise _TraceError(_MISALIGNED)
        site = self.model.sites[s]
        seg = min(site.segment, self.model.num_steps - 1)
        if seg < self.t:
            return self._read(site)
        if seg > self.t:
            return torch.zeros(site.shape, dtype=site.dtype, device=self.device)
        if self.mode == "score":
            return self._read(site)
        fresh = dist.to(self.device).sample(rnd.fold_in(self.key, s))
        fresh = torch.as_tensor(fresh).to(site.dtype).reshape(site.shape)
        if self.mode == "step":
            # The reference slot keeps its injected value; the others take the draw.
            fresh = torch.where(self.is_ref, self._read(site), fresh)
        v = self.values_out
        # Built anew, never written in place: ``values`` is vmap's input.
        self.values_out = torch.cat([v[:site.offset],
                                     fresh.reshape(site.size).to(v.dtype),
                                     v[site.offset + site.size:]])
        return fresh

    def observe(self, dist, value):
        o = self._obs_idx
        self._obs_idx += 1
        if o >= self.model.num_steps:
            raise _TraceError(_MISALIGNED)
        if o != self.t:
            return self._zero
        lp = dist.to(self.device).log_prob(_value_on(value, self.device))
        lp = torch.sum(torch.as_tensor(lp).to(self.logw.dtype))  # batched observes sum
        self.logw = self.logw + lp
        if self.stop:
            raise _StopSegment
        return lp


# Module-level forms of the context methods (``AdvancedPS.observe``).
def observe(ctx, dist, value):
    return ctx.observe(dist, value)


def sample_site(ctx, dist, name=None):
    return ctx.sample(dist, name)


class GenericModel:
    """A probabilistic program with a static sample/observe structure.

    ``fn(ctx)`` is any Python callable using ``ctx.sample(dist[, name])`` and
    ``ctx.observe(dist, value)`` with the package's distributions; the
    number of observes is the sweep length T.  Under the sweep ``fn`` runs
    for all particles at once under :func:`torch.func.vmap`: no ``.item()``,
    no Python ``if`` on a sampled value, no in-place write to a value it did
    not make.  Parameters may be Python numbers or tensors on any device.
    """

    def __init__(self, fn: Callable, seed: int = 0):
        self.fn = fn
        tracer = _TracerCtx(rngmod.key(seed))
        fn(tracer)
        self.sites = tuple(tracer.sites)
        self.num_steps = tracer.n_observes
        self.flat_size = sum(s.size for s in self.sites)
        if self.num_steps == 0:
            raise ValueError("generic model must contain at least one observe")

    # -- interpretation ----------------------------------------------------
    def _stops_early(self, t: int) -> bool:
        """Whether segment ``t``'s run ends at its ``t``-th observe: every
        step but the last, whose run reaches the trailing sites."""
        return t < self.num_steps - 1

    def _run_segment(self, t: int, key, values, mode: str, is_ref=None):
        ctx = _SegmentCtx(self, t, key, values, mode, is_ref, self._stops_early(t))
        try:
            self.fn(ctx)
        except _StopSegment:
            return ctx
        except RuntimeError as e:
            if "vmap" in str(e) and any(w in str(e) for w in _VMAP_DATA_DEPENDENT):
                raise _TraceError(_MISALIGNED) from e
            raise
        if ctx._site_idx != len(self.sites) or ctx._obs_idx != self.num_steps:
            raise _TraceError(_MISALIGNED)
        return ctx

    def run_sample(self, t, key, values):
        """One particle: draw segment-``t``'s sites; returns the new value
        vector."""
        return self._run_segment(int(t), key, values, "sample").values_out

    def run_score(self, t, values):
        """One particle: read the stored values; returns observe ``t``'s
        log-weight."""
        return self._run_segment(int(t), None, values, "score").logw

    def run_step(self, t, key, values, is_ref):
        """One particle, fused: draw segment ``t``'s sites and score observe
        ``t`` in one pass; returns ``(values_out, logw)``.  ``is_ref`` (a
        bool) makes the reference slot keep its injected values."""
        ctx = self._run_segment(int(t), key, values, "step", is_ref)
        return ctx.values_out, ctx.logw

    # -- value decoding ----------------------------------------------------
    def decode(self, values: torch.Tensor) -> dict:
        """Flat value vector (or stacked batch ``[..., S]``) → name → tensor,
        each site in its own shape and dtype."""
        values = torch.as_tensor(values)
        out = {}
        for s in self.sites:
            flat = values[..., s.offset:s.offset + s.size]
            out[s.name] = flat.reshape(tuple(values.shape[:-1]) + s.shape).to(s.dtype)
        return out


class GenericSSMKernel(SweepKernel):
    """Sweep-engine kernel over a :class:`GenericModel`.

    State = the dense value matrix ``[N, S]``; snapshot = the matrix itself,
    so a retained PG trajectory is the ``[T, S]`` stack and its last row holds
    every site's value.  Resampling moves its rows as any ``[N, D]`` state.

    PGAS is unsupported: ancestor sampling needs transition densities, which
    only the structured SSM path provides (the reference's ``update_ref!``
    dispatches on ``SSMTrace`` only).
    """

    def __init__(self, model: GenericModel):
        self.model = model

    @property
    def num_steps(self) -> int:
        return self.model.num_steps

    def _advance(self, t: int, rng, values, ref_mask):
        """Segment ``t`` for every particle: the reference row is injected
        before the pass, and its segment-``t`` sites keep it through the
        per-particle ``is_ref`` select."""
        is_ref = (ref_mask if ref_mask is not None
                  else torch.zeros(values.shape[0], dtype=torch.bool, device=values.device))
        return vmap(lambda k, v, r: self.model.run_step(t, k, v, r))(
            rng.particle_keys(), values, is_ref)

    def init(self, rng, ref0, ref_mask):
        values = torch.zeros((rng.n, self.model.flat_size), dtype=torch.float32,
                             device=rng.gids.device)
        return self._advance(0, rng, inject_ref(ref_mask, ref0, values), ref_mask)

    def step(self, t, rng, state, ref_t, ref_mask):
        return self._advance(t, rng, inject_ref(ref_mask, ref_t, state), ref_mask)

    def snapshot(self, state):
        return state
