"""Probability distributions (PyTorch port of ``advancedps_tpu/distributions.py``).

A distribution is a light value of tensors, made afresh at every step from the
model's buffers (``Normal(a·x + b, q)``), so it is a plain class and not an
``nn.Module``.  Parameters follow ``Distributions.jl`` as in the JAX package:
``Normal(loc, scale)`` with ``scale`` the standard deviation,
``Gamma(concentration, scale)``, ``Exponential(scale)``, ``Beta(a, b)``,
``Uniform(low, high)``, ``Bernoulli(p)`` on {0, 1}, ``Categorical(probs)``
over {0, …, K−1}, ``Poisson(rate)``, ``LogNormal(loc, scale)``,
``StudentT(df, loc, scale)``, ``MvNormal(loc, cov)`` with a dense covariance
and ``Dirac(value)``.  Parameters broadcast: ``Normal(x[N], q)`` is a batch
of N laws and ``log_prob(y)`` is ``[N]``.

Every distribution draws three ways, as in the JAX package:

* :meth:`Distribution.sample` ``(key, sample_shape)`` with a key
  (:mod:`advancedps_tpu_torch.random`; ``jax.random``'s draws);
* :meth:`Distribution.sample_positional` ``(key, gids)`` and
  :meth:`Distribution.sample_rng` ``(rng, draw)``: element ``i`` a pure
  function of ``(key, draw, gids[i])``, the sweep's path.  The families with
  an inverse or a transform draw from counters directly (one cipher block an
  element); the rest fold one key per id and draw from it
  (:meth:`Distribution.sample_keyed`).

Parameters are float32 tensors on the device of the first parameter that is a
tensor (a Python number goes there too).
"""

from __future__ import annotations

import copy
import math

import torch
from torch.func import vmap

from . import random as rnd
from . import rng as rngmod

__all__ = [
    "Distribution",
    "Normal",
    "MvNormal",
    "Bernoulli",
    "Gamma",
    "Beta",
    "Uniform",
    "Exponential",
    "Poisson",
    "Categorical",
    "LogNormal",
    "StudentT",
    "Dirac",
]

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _tensor(v, dtype, device):
    """``v`` as a tensor of ``dtype`` on ``device``.  A Python number is
    filled in on the device: ``as_tensor`` would copy it from the host and
    wait for the device to drain its queue first."""
    if isinstance(v, (bool, int, float)) and device is not None:
        return torch.full((), v, dtype=dtype, device=device)
    return torch.as_tensor(v, dtype=dtype, device=device)


def _params(*values, dtype=torch.float32):
    """``values`` as tensors of ``dtype`` on the device of the first tensor
    among them (the CPU if none is)."""
    device = next((v.device for v in values if isinstance(v, torch.Tensor)), None)
    return [_tensor(v, dtype, device) for v in values]


class Distribution:
    """Base class.  A family lists its parameter names in ``_fields`` and
    implements ``batch_shape``, :meth:`sample` and :meth:`log_prob`."""

    #: Names of the parameters, in the order ``__init__`` takes them.
    _fields: tuple = ()
    #: Shape of one event; () for scalar distributions.
    event_shape: tuple = ()

    def __init__(self, *values):
        for name, value in zip(self._fields, _params(*values)):
            setattr(self, name, value)

    @property
    def batch_shape(self) -> tuple:
        return tuple(torch.broadcast_shapes(*(getattr(self, f).shape for f in self._fields)))

    @property
    def _device(self) -> torch.device:
        return getattr(self, self._fields[0]).device

    def to(self, device) -> "Distribution":
        """This law with its parameters on ``device``: a shallow copy (the
        parameters that lie there already are shared; the others are copied,
        without waiting only where the copy goes to the card: a copy to the
        CPU must have landed before the CPU reads it)."""
        out = copy.copy(self)
        to_card = torch.device(device).type == "cuda"
        for f in self._fields:
            setattr(out, f, getattr(self, f).to(device, non_blocking=to_card))
        return out

    def sample(self, key, sample_shape=()):
        raise NotImplementedError

    def log_prob(self, x):
        raise NotImplementedError

    def _full_shape(self, sample_shape) -> tuple:
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        return tuple(sample_shape) + tuple(self.batch_shape)

    def _broadcast_batch(self, n: int) -> dict:
        """Every parameter with a leading batch axis of ``n``: as it is where
        it has one, broadcast where it has not."""
        out = {}
        for f in self._fields:
            leaf = getattr(self, f)
            if not (leaf.dim() >= 1 and leaf.shape[0] == n):
                leaf = torch.broadcast_to(leaf, (n,) + tuple(leaf.shape))
            out[f] = leaf
        return out

    def sample_keyed(self, keys: torch.Tensor):
        """Element ``i`` drawn as ``sample(keys[i])`` draws it for batch
        element ``i``: ``keys`` an int64 ``[n, 2]`` batch, the batch shape
        ``()`` (one law for all) or ``(n,)``.  A ``vmap`` of :meth:`sample`,
        as the JAX package's per-key path."""
        n = keys.shape[0]
        bs = tuple(self.batch_shape)
        if bs == ():
            return vmap(lambda k: self.sample(k))(keys)
        if bs != (n,):
            raise ValueError(f"sample_keyed needs batch_shape () or ({n},); got {bs}")
        cls = type(self)
        return vmap(lambda k, p: cls(**p).sample(k))(keys, self._broadcast_batch(n))

    def sample_positional(self, key: rngmod.Key, gids: torch.Tensor):
        """Batched draw where element ``i`` is a pure function of
        ``(key, gids[i])``, never of the batch layout.  This fallback folds
        one key per id (``fold_in(key, gids[i])``) and draws from it; the
        families with an inverse or a transform draw from counters instead."""
        return self.sample_keyed(rngmod.fold_in_ids(key, gids))

    def sample_rng(self, rng: rngmod.StepRng, draw: int = 0):
        """Positional draw from a :class:`~advancedps_tpu_torch.rng.StepRng`:
        element ``i`` a pure function of ``(rng.key, draw, rng.gids[i])``.
        This fallback is :meth:`sample_positional` (which takes no ``draw``,
        as in the JAX package)."""
        return self.sample_positional(rng.key, rng.gids)

    def _key_device(self, key):
        return self._device if isinstance(key, rngmod.Key) else key.device


class Normal(Distribution):
    """Gaussian with mean ``loc`` and standard deviation ``scale``."""

    _fields = ("loc", "scale")

    def __init__(self, loc, scale):
        super().__init__(loc, scale)

    def sample(self, key, sample_shape=()):
        eps = rnd.normal(key, self._full_shape(sample_shape), self._key_device(key))
        return self.loc + self.scale * eps

    def sample_generator(self, generator: torch.Generator, sample_shape=()):
        """Draw with a ``torch.Generator`` (``torch.randn``), as
        :func:`~advancedps_tpu_torch.ssm.simulate` does when given one."""
        eps = torch.randn(self._full_shape(sample_shape), generator=generator,
                          dtype=torch.float32, device=generator.device)
        return self.loc + self.scale * eps.to(self.loc.device)

    def sample_positional(self, key, gids):
        return self.loc + self.scale * rngmod.pos_normal(key, gids)

    def sample_rng(self, rng, draw: int = 0):
        return self.loc + self.scale * rng.normal(draw)

    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        return -0.5 * z * z - torch.log(self.scale) - _HALF_LOG_2PI

    @property
    def mean(self):
        return torch.broadcast_to(self.loc, self.batch_shape)

    @property
    def variance(self):
        return torch.broadcast_to(self.scale * self.scale, self.batch_shape)


class MvNormal(Distribution):
    """Multivariate Gaussian with dense covariance: ``loc`` ``[..., D]``,
    ``cov`` ``[..., D, D]`` (per-particle parameters score in one call)."""

    _fields = ("loc", "cov")

    def __init__(self, loc, cov):
        super().__init__(loc, cov)

    @property
    def event_shape(self):
        return (self.loc.shape[-1],)

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(self.loc.shape[:-1], self.cov.shape[:-2]))

    @property
    def _chol(self):
        return torch.linalg.cholesky(self.cov)

    def _affine(self, eps):
        return self.loc + torch.einsum("...ij,...j->...i", self._chol, eps)

    def sample(self, key, sample_shape=()):
        shape = self._full_shape(sample_shape) + self.event_shape
        return self._affine(rnd.normal(key, shape, self._key_device(key)))

    def sample_positional(self, key, gids):
        return self._affine(rngmod.pos_normals(key, gids, self.event_shape[0]))

    def log_prob(self, x):
        d = self.event_shape[0]
        chol = self._chol
        diff = _tensor(x, torch.float32, self.loc.device) - self.loc
        z = torch.linalg.solve_triangular(chol, diff[..., None], upper=False)[..., 0]
        half_logdet = torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), -1)
        return -0.5 * torch.sum(z * z, -1) - half_logdet - d * _HALF_LOG_2PI

    @property
    def mean(self):
        return self.loc


class Bernoulli(Distribution):
    """Bernoulli over {0, 1} with success probability ``p`` (float draws)."""

    _fields = ("p",)

    def __init__(self, p):
        super().__init__(p)

    def sample(self, key, sample_shape=()):
        shape = self._full_shape(sample_shape)
        return rnd.bernoulli(key, self.p, shape, self._key_device(key)).to(torch.float32)

    def sample_positional(self, key, gids):
        return (rngmod.pos_uniform(key, gids) < self.p).to(torch.float32)

    def sample_rng(self, rng, draw: int = 0):
        return (rng.uniform(draw) < self.p).to(torch.float32)

    def log_prob(self, x):
        x = _tensor(x, torch.float32, self.p.device)
        # xlogy-style, so that p ∈ {0, 1} scores exactly.
        return torch.xlogy(x, self.p) + torch.special.xlog1py(1.0 - x, -self.p)

    @property
    def mean(self):
        return torch.broadcast_to(self.p, self.batch_shape)


#: Attempts of the positional Marsaglia–Tsang gamma (JAX
#: ``_GAMMA_MT_ATTEMPTS``): each accepts with probability ≥ 0.951, so the
#: miss mass after 4 is ≤ 5.8e-6 a draw, which takes ``d = α' − 1/3``.
GAMMA_MT_ATTEMPTS = 4
_GAMMA_KEY_TAG = 0x6A33A  # stream separator of the positional gamma


def _mt_stream_key(key: rngmod.Key, family: int, draw: int) -> rngmod.Key:
    """A rejection sampler's stream key: folded with the tag and family, then
    the draw, so its attempt slots meet no other site's raw-key stream."""
    return rngmod.fold_in(rngmod.fold_in(key, _GAMMA_KEY_TAG + family), draw)


def _gamma_positional(key: rngmod.Key, gids, alpha, attempts: int = GAMMA_MT_ATTEMPTS):
    """Gamma(alpha, 1), element ``i`` a pure function of ``(key, gids[i])``:
    attempt ``k`` takes the positional normal of draw ``2k`` and uniform of
    draw ``2k + 1``, the boost the uniform of draw ``2·attempts``."""
    alpha = torch.broadcast_to(torch.as_tensor(alpha, dtype=torch.float32, device=gids.device),
                               gids.shape)
    return rnd.marsaglia_tsang(
        alpha,
        lambda k: rngmod.pos_normal(key, gids, 2 * k),
        lambda k: rngmod.pos_uniform(key, gids, 2 * k + 1),
        lambda: rngmod.pos_uniform(key, gids, 2 * attempts),
        attempts,
    )


class Gamma(Distribution):
    """Gamma with shape ``concentration`` and **scale** (mean = concentration·scale)."""

    _fields = ("concentration", "scale")

    def __init__(self, concentration, scale):
        super().__init__(concentration, scale)

    def sample(self, key, sample_shape=()):
        shape = self._full_shape(sample_shape)
        g = rnd.gamma(key, torch.broadcast_to(self.concentration, shape), shape,
                      self._key_device(key))
        return g * self.scale

    def sample_positional(self, key, gids):
        """Counted Marsaglia–Tsang on the key folded with a fixed tag, so its
        draw slots 0 … 2K meet no other distribution's raw-key stream."""
        g = _gamma_positional(rngmod.fold_in(key, _GAMMA_KEY_TAG), gids, self.concentration)
        return g * self.scale

    def sample_rng(self, rng, draw: int = 0):
        g = _gamma_positional(rngmod.fold_in(rng.key, _GAMMA_KEY_TAG + draw), rng.gids,
                              self.concentration)
        return g * self.scale

    def log_prob(self, x):
        a, s = self.concentration, self.scale
        x = _tensor(x, torch.float32, a.device)
        return (a - 1.0) * torch.log(x) - x / s - torch.lgamma(a) - a * torch.log(s)

    @property
    def mean(self):
        return torch.broadcast_to(self.concentration * self.scale, self.batch_shape)


def _betaln(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


class Beta(Distribution):
    _fields = ("a", "b")

    def __init__(self, a, b):
        super().__init__(a, b)

    def sample(self, key, sample_shape=()):
        shape = self._full_shape(sample_shape)
        return rnd.beta(key, torch.broadcast_to(self.a, shape), torch.broadcast_to(self.b, shape),
                        shape, self._key_device(key))

    def sample_positional(self, key, gids):
        """``B(a, b) = G_a / (G_a + G_b)`` from two positional gammas on
        distinct stream keys."""
        ga = _gamma_positional(_mt_stream_key(key, 1, 0), gids, self.a)
        gb = _gamma_positional(_mt_stream_key(key, 1, 1), gids, self.b)
        return ga / (ga + gb)

    def sample_rng(self, rng, draw: int = 0):
        ga = _gamma_positional(_mt_stream_key(rng.key, 1, 2 * draw), rng.gids, self.a)
        gb = _gamma_positional(_mt_stream_key(rng.key, 1, 2 * draw + 1), rng.gids, self.b)
        return ga / (ga + gb)

    def log_prob(self, x):
        x = _tensor(x, torch.float32, self.a.device)
        return ((self.a - 1.0) * torch.log(x) + (self.b - 1.0) * torch.log1p(-x)
                - _betaln(self.a, self.b))

    @property
    def mean(self):
        return torch.broadcast_to(self.a / (self.a + self.b), self.batch_shape)


class Uniform(Distribution):
    _fields = ("low", "high")

    def __init__(self, low, high):
        super().__init__(low, high)

    def sample(self, key, sample_shape=()):
        u = rnd.uniform(key, self._full_shape(sample_shape), device=self._key_device(key))
        return self.low + u * (self.high - self.low)

    def sample_positional(self, key, gids):
        return self.low + rngmod.pos_uniform(key, gids) * (self.high - self.low)

    def sample_rng(self, rng, draw: int = 0):
        return self.low + rng.uniform(draw) * (self.high - self.low)

    def log_prob(self, x):
        x = _tensor(x, torch.float32, self.low.device)
        inside = (x >= self.low) & (x <= self.high)
        return torch.where(inside, -torch.log(self.high - self.low), -math.inf)

    @property
    def mean(self):
        return torch.broadcast_to(0.5 * (self.low + self.high), self.batch_shape)


class Exponential(Distribution):
    """Exponential with **scale** (mean = scale), as ``Distributions.jl``."""

    _fields = ("scale",)

    def __init__(self, scale):
        super().__init__(scale)

    def sample(self, key, sample_shape=()):
        e = rnd.exponential(key, self._full_shape(sample_shape), self._key_device(key))
        return e * self.scale

    def sample_positional(self, key, gids):
        return -torch.log1p(-rngmod.pos_uniform(key, gids)) * self.scale

    def sample_rng(self, rng, draw: int = 0):
        return -torch.log1p(-rng.uniform(draw)) * self.scale

    def log_prob(self, x):
        x = _tensor(x, torch.float32, self.scale.device)
        return torch.where(x >= 0, -x / self.scale - torch.log(self.scale), -math.inf)

    @property
    def mean(self):
        return torch.broadcast_to(self.scale, self.batch_shape)


#: Cap of the counted Poisson walk (never reached for λ below 87).
_POISSON_WALK_CAP = 65536
_FLT_TINY = 1.1754943508222875e-38


class Poisson(Distribution):
    _fields = ("rate",)

    def __init__(self, rate):
        super().__init__(rate)

    def sample(self, key, sample_shape=()):
        shape = self._full_shape(sample_shape)
        return rnd.poisson(key, torch.broadcast_to(self.rate, shape), shape,
                           self._key_device(key)).to(torch.float32)

    def sample_positional(self, key, gids):
        """Counted inverse CDF from one positional uniform: walk
        ``p_{k+1} = p_k·λ/(k+1)`` while some element's running CDF is at or
        below its uniform and its pmf term is a normal float32 (XLA flushes
        the smaller ones to 0 on the CPU; the walk reads that
        on the host once a term: ``max(λ) + O(√λ)`` terms).  Where some
        ``exp(−λ)`` falls below float32's normal range (λ ≳ 87) the whole batch takes the
        per-id key path instead, as in the JAX package."""
        r = torch.broadcast_to(self.rate, gids.shape)
        u = rngmod.pos_uniform(key, gids)
        p = torch.exp(-r)
        # Below float32's smallest normal, as XLA flushes it to 0 on the CPU.
        if not bool((p >= _FLT_TINY).all()):
            return Distribution.sample_positional(self, key, gids)
        csum = p
        kout = torch.zeros_like(u)
        k = 0
        while k < _POISSON_WALK_CAP:
            live = (u >= csum) & (p >= _FLT_TINY)
            if not bool(live.any()):
                break
            kout = torch.where(live, float(k + 1), kout)
            p = p * r / float(k + 1)
            csum = csum + p
            k += 1
        return kout

    def log_prob(self, x):
        r = self.rate
        x = _tensor(x, torch.float32, r.device)
        return torch.xlogy(x, r) - r - torch.lgamma(x + 1.0)

    @property
    def mean(self):
        return torch.broadcast_to(self.rate, self.batch_shape)


class Categorical(Distribution):
    """Categorical over {0, …, K−1} with probabilities ``probs[..., K]``
    (unnormalised allowed)."""

    _fields = ("probs",)

    def __init__(self, probs):
        super().__init__(probs)

    @property
    def batch_shape(self):
        return tuple(self.probs.shape[:-1])

    def sample(self, key, sample_shape=()):
        shape = self._full_shape(sample_shape)
        return rnd.categorical(key, torch.log(self.probs), shape=shape,
                               device=self._key_device(key))

    def sample_positional(self, key, gids):
        """Inverse CDF from one positional uniform scaled by the total mass:
        ``#{k : cdf_k ≤ u}`` over the first K−1 entries (int32)."""
        cdf = torch.cumsum(self.probs, -1)
        u = rngmod.pos_uniform(key, gids) * cdf[..., -1]
        return torch.sum((u[..., None] >= cdf[..., :-1]).to(torch.int32), -1, dtype=torch.int32)

    def log_prob(self, x):
        idx = torch.as_tensor(x, device=self.probs.device).long()
        probs = torch.broadcast_to(self.probs, idx.shape + self.probs.shape[-1:])
        return torch.log(torch.gather(probs, -1, idx[..., None])[..., 0])

    @property
    def mean(self):
        k = torch.arange(self.probs.shape[-1], dtype=torch.float32, device=self.probs.device)
        return torch.sum(self.probs * k, -1)


class LogNormal(Distribution):
    _fields = ("loc", "scale")

    def __init__(self, loc, scale):
        super().__init__(loc, scale)

    def _normal(self):
        return Normal(self.loc, self.scale)

    def sample(self, key, sample_shape=()):
        return torch.exp(self._normal().sample(key, sample_shape))

    def sample_positional(self, key, gids):
        return torch.exp(self._normal().sample_positional(key, gids))

    def sample_rng(self, rng, draw: int = 0):
        return torch.exp(self._normal().sample_rng(rng, draw))

    def log_prob(self, x):
        logx = torch.log(_tensor(x, torch.float32, self.loc.device))
        return self._normal().log_prob(logx) - logx

    @property
    def mean(self):
        return torch.exp(self.loc + 0.5 * self.scale * self.scale)


class StudentT(Distribution):
    _fields = ("df", "loc", "scale")

    def __init__(self, df, loc, scale):
        super().__init__(df, loc, scale)

    def sample(self, key, sample_shape=()):
        shape = self._full_shape(sample_shape)
        t = rnd.t(key, torch.broadcast_to(self.df, shape), shape, self._key_device(key))
        return self.loc + self.scale * t

    def sample_positional(self, key, gids):
        return self._t_positional(key, gids, 0)

    def sample_rng(self, rng, draw: int = 0):
        return self._t_positional(rng.key, rng.gids, draw)

    def _t_positional(self, key, gids, draw: int):
        """``t = z / sqrt(chi2 / df)`` with a positional normal and a
        positional chi-square (``2·Gamma(df/2)``), on two stream keys."""
        z = rngmod.pos_normal(_mt_stream_key(key, 2, 2 * draw), gids)
        chi2 = 2.0 * _gamma_positional(_mt_stream_key(key, 2, 2 * draw + 1), gids, 0.5 * self.df)
        t = z / torch.sqrt(torch.clamp(chi2, min=1e-38) / self.df)
        return self.loc + self.scale * t

    def log_prob(self, x):
        df, scale = self.df, self.scale
        z = (_tensor(x, torch.float32, df.device) - self.loc) / scale
        return (torch.lgamma(0.5 * (df + 1.0)) - torch.lgamma(0.5 * df)
                - 0.5 * torch.log(df * math.pi) - torch.log(scale)
                - 0.5 * (df + 1.0) * torch.log1p(z * z / df))


class Dirac(Distribution):
    """Point mass at ``value`` (a clamped or known state); keeps its dtype."""

    _fields = ("value",)

    def __init__(self, value):
        value = torch.as_tensor(value)
        # float64 becomes float32, as JAX's arrays with 64-bit types off.
        self.value = value.float() if value.dtype == torch.float64 else value

    def sample(self, key, sample_shape=()):
        return torch.broadcast_to(self.value, self._full_shape(sample_shape))

    def sample_positional(self, key, gids):
        n = gids.shape[0]
        v = self.value
        target = v.shape if (v.dim() >= 1 and v.shape[0] == n) else (n,) + tuple(v.shape)
        return torch.broadcast_to(v, target)

    def log_prob(self, x):
        x = torch.as_tensor(x, device=self.value.device)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return torch.where(x == self.value, zero, -math.inf)

    @property
    def mean(self):
        return self.value
