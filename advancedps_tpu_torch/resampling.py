"""Resampling schemes (PyTorch port of ``advancedps_tpu/resampling.py``).

Resamplers share the signature ``resampler(key, weights, n) -> int32[n]`` with
normalised ``weights``.  Each is one vectorised expression over the particle
axis: ``cumsum`` of the weights plus a ``searchsorted``; a uniform ``u_i``
selects ``j`` iff ``u_i ∈ [cum_{j-1}, cum_j)``.  Uniforms are positional
(:func:`advancedps_tpu_torch.rng.pos_uniform`), so the same key gives the JAX
package's uniforms bit for bit.

The sweep does not call systematic, stratified or multinomial itself: it
recognises them and runs the same draw as monotone extents through the
kernels of :mod:`advancedps_tpu_torch.ops.resample` (:func:`stratified_extents`
and :func:`multinomial_spacings` below build those extents), which agree with
the searchsorted forms here up to ±1 boundary flips in float32.  Fused
multinomial draws its uniforms already sorted, a different random variable
with the same offspring law.  Residual resampling has no kernel form and runs
as written here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from . import random as rnd
from . import rng as rngmod
from ._device import resolve_device

__all__ = [
    "randcat",
    "randcat_gumbel",
    "resample_systematic",
    "resample_stratified",
    "resample_multinomial",
    "resample_residual",
    "stratified_extents",
    "multinomial_spacings",
    "DEFAULT_RESAMPLER",
    "ResampleWithESSThreshold",
    "as_gated_resampler",
    "effective_sample_size",
]


def _inverse_cdf(weights: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
    """``idx_i = j`` iff ``u_i ∈ [cum_{j-1}, cum_j)``, clamped to the last index
    (a float cumsum may end slightly below 1)."""
    cdf = torch.cumsum(weights, 0)
    idx = torch.searchsorted(cdf, us, right=True)
    return torch.clamp(idx, 0, weights.shape[0] - 1).to(torch.int32)


def randcat(key, weights: torch.Tensor) -> torch.Tensor:
    """One categorical draw by CDF inversion of ``jax.random.uniform(key)``
    (0-dim int32): JAX's ``randcat``, bitwise for the same key and weights
    but where the two float32 ``cumsum``s differ."""
    u = rnd.uniform(key, device=weights.device)
    return _inverse_cdf(weights, u.reshape(1))[0]


def randcat_gumbel(key: rngmod.Key, log_weights: torch.Tensor, gids=None) -> torch.Tensor:
    """One categorical draw ∝ ``exp(log_weights)`` by the Gumbel-max trick:
    a 0-dim int32 tensor on ``log_weights``' device (no host sync).

    The Gumbel of element ``i`` is a pure function of ``(key, gids[i])``, and
    ``torch.argmax`` breaks ties at the first occurrence, as ``jnp.argmax``.
    A uniform of 0 gives a Gumbel of −inf and excludes its slot from this
    draw, an O(2^-24) perturbation.

    For chains, ``key`` is a :class:`~advancedps_tpu_torch.rng.KeyBatch` of
    words ``[C, 1]`` and ``log_weights`` ``[C, N]``: one draw a row, ``[C]``,
    row ``c`` that of chain ``c``'s key.
    """
    if gids is None:
        gids = torch.arange(log_weights.shape[-1], device=log_weights.device)
    u = rngmod.pos_uniform(key, gids)
    z = log_weights - torch.log(-torch.log(u))
    return torch.argmax(z, dim=-1).to(torch.int32)


def resample_systematic(key: rngmod.Key, weights: torch.Tensor, n: int) -> torch.Tensor:
    """Systematic resampling: one shared uniform, positions ``(u + k) / n``."""
    u = rngmod.uniform(key)
    us = (u + torch.arange(n, dtype=weights.dtype, device=weights.device)) / n
    return _inverse_cdf(weights, us)


def stratified_extents(key: rngmod.Key, c: torch.Tensor, n: int) -> torch.Tensor:
    """Stratified extents ``f_j = #{k : (k + u_k)/n ≤ cdf_j}`` from the scaled
    CDF ``c = n·cdf``: ``f_j = ⌊c_j⌋ + [u_{⌊c_j⌋} ≤ c_j − ⌊c_j⌋]``, the
    boundary stratum's uniform evaluated positionally at its index (one
    cipher evaluation per particle, no gather).  Nondecreasing for
    nondecreasing ``c``.
    """
    c = torch.clamp(c, 0.0, float(n))
    kj = torch.clamp(torch.floor(c), max=float(n - 1))
    ku = rngmod.pos_uniform(key, kj.to(torch.int32))
    f = torch.where(c >= float(n), float(n), kj + (ku <= c - kj).to(c.dtype))
    return f.to(torch.int32)


def resample_stratified(key: rngmod.Key, weights: torch.Tensor, n: int) -> torch.Tensor:
    """Stratified resampling: position ``k`` draws ``(k + u_k)/n`` with its own
    positional uniform ``u_k``, the same uniforms :func:`stratified_extents`
    reads."""
    k = torch.arange(n, device=weights.device)
    u = rngmod.pos_uniform(key, k).to(weights.dtype)
    us = (u + k.to(weights.dtype)) / n
    return _inverse_cdf(weights, us)


def multinomial_spacings(key: rngmod.Key, n: int, device=None) -> torch.Tensor:
    """``n + 1`` positional Exp(1) gaps ``−log1p(−u)``: the ``n`` sorted
    uniforms are ``S_k / S_n`` for the inclusive prefix sums ``S`` of these
    gaps (Devroye 1986, §V.3), on ``device`` (None: the GPU).  The fused
    multinomial path's draw."""
    u = rngmod.pos_uniform(key, torch.arange(n + 1, device=resolve_device(device)))
    return -torch.log1p(-u)


def resample_multinomial(key: rngmod.Key, weights: torch.Tensor, n: int) -> torch.Tensor:
    """Multinomial resampling: ``n`` iid categorical draws from positional
    uniforms."""
    us = rngmod.pos_uniform(key, torch.arange(n, device=weights.device)).to(weights.dtype)
    return _inverse_cdf(weights, us)


def resample_residual(key: rngmod.Key, weights: torch.Tensor, n: int) -> torch.Tensor:
    """Residual resampling: ``floor(n·w_i)`` deterministic copies of particle
    ``i``, the remaining slots multinomial on the residual weights.

    With ``c = cumsum(floor(n·w))`` the deterministic copies take the slots
    ``k < c[-1]``, slot ``k`` holding ``searchsorted(c, k, right)``; the
    count of copies is a mask, not a shape.
    """
    scaled = n * weights
    floors = torch.floor(scaled)
    residuals = scaled - floors
    counts_cdf = torch.cumsum(floors, 0)
    n_det = counts_cdf[-1]

    slots = torch.arange(n, dtype=weights.dtype, device=weights.device)
    det_idx = torch.searchsorted(counts_cdf, slots, right=True)
    det_idx = torch.clamp(det_idx, 0, weights.shape[0] - 1).to(torch.int32)

    res_total = torch.sum(residuals)
    # Guard the fully deterministic case (all residuals zero).
    safe = torch.where(res_total > 0, res_total, torch.ones_like(res_total))
    res_idx = resample_multinomial(key, residuals / safe, n)
    return torch.where(slots < n_det, det_idx, res_idx)


DEFAULT_RESAMPLER = resample_systematic


def effective_sample_size(weights: torch.Tensor) -> torch.Tensor:
    """ESS = 1 / Σ wᵢ² of normalised weights."""
    return 1.0 / torch.sum(torch.square(weights))


@dataclass(frozen=True)
class ResampleWithESSThreshold:
    """Resample with ``resampler`` iff ESS ≤ ``threshold · n``."""

    resampler: Callable = DEFAULT_RESAMPLER
    threshold: float = 0.5

    def __call__(self, key, weights, n):
        return self.resampler(key, weights, n)

    def should_resample(self, weights, n):
        return effective_sample_size(weights) <= self.threshold * n


def as_gated_resampler(resampler) -> ResampleWithESSThreshold:
    """A bare resampler function as an always-on gated resampler (threshold
    inf: ESS ≤ inf·N always holds)."""
    if isinstance(resampler, ResampleWithESSThreshold):
        return resampler
    return ResampleWithESSThreshold(resampler=resampler, threshold=float("inf"))
