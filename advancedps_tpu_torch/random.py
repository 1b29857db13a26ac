"""Key-based samplers: the counterparts of ``jax.random`` for one key or a
batch of keys.

A key is a :class:`~advancedps_tpu_torch.rng.Key` (two host integers) or an
int64 tensor ``[..., 2]`` of uint32 words, a batch of keys when it has more
than one dimension (what :func:`~advancedps_tpu_torch.rng.particle_keys`
gives).  A sampler given a batch of keys ``[B..., 2]`` and a sample ``shape``
returns ``[B..., *shape]``, each key's draws exactly what that key alone
draws.  With a :class:`Key`, ``device`` says where the draws are made (None:
the GPU); with a tensor, they are made on its device.  Parameters broadcast
against ``[B..., *shape]``; with a batch of keys, name ``shape`` (the shape
of one key's draw).

Every function is safe under :func:`torch.func.vmap`: no host read, no
branch on a tensor's value, no in-place write to a tensor it did not make.
That is how a model's per-particle component draws with its particle's key
(``vmap`` over :meth:`~advancedps_tpu_torch.rng.StepRng.particle_keys`), as
the JAX package ``vmap``s ``jax.random``.

Parity with ``jax.random`` (``jax_threefry_partitionable``, the default):

* :func:`split`, :func:`fold_in`, :func:`bits`, :func:`uniform`,
  :func:`bernoulli` and :func:`categorical` are bitwise JAX's: element ``i``
  of a draw of ``shape`` is the cipher at counter ``(0, i)`` (``split``: its
  two words; ``bits``: their xor).
* :func:`normal` is ``√2 · erfinv(u)`` with XLA's float32 erfinv polynomial
  ported here (:func:`erfinv`); ``torch.erfinv`` is up to 91 ulps from it.
  :func:`exponential` is ``−log1p(−u)``.  Both within a few ulps of JAX's,
  the rest being the two libraries' ``log1p`` and ``sqrt``.
* :func:`gamma`, :func:`beta`, :func:`t` and :func:`poisson` are rejection
  samplers in JAX (a ``while_loop`` to the first acceptance).  Here each runs
  a fixed number of attempts side by side (no loop whose end depends on the
  data), so their draws are not JAX's; they are held to the laws by KS and
  frequency tests.  An element that no attempt accepts takes a fixed value
  (the gamma's ``d = α − 1/3``, the Poisson's ``⌊λ⌋``), with probability
  under 1e-10 a draw.
"""

from __future__ import annotations

import math

import torch

from . import rng as rngmod
from ._device import resolve_device
from .rng import Key

__all__ = [
    "key_tensor",
    "split",
    "fold_in",
    "bits",
    "uniform",
    "erfinv",
    "normal",
    "exponential",
    "bernoulli",
    "categorical",
    "gamma",
    "beta",
    "t",
    "poisson",
    "marsaglia_tsang",
    "GAMMA_ATTEMPTS",
    "POISSON_ATTEMPTS",
]

_MASK = 0xFFFFFFFF
_ULP_OF_ONE = 2.0 ** -23  # float32 spacing in [1, 2)
_SQRT2 = 1.4142135381698608  # float32 √2, as np.array(np.sqrt(2), float32)
_TINY = 1.1754943508222875e-38  # float32 smallest normal
_FLT_MAX = 3.4028234663852886e38
_LO = -0.9999999403953552  # nextafter(-1, 0) in float32

#: Attempts the key-based gamma runs side by side: each accepts with
#: probability ≥ 0.951, so none accepts with probability ≤ 0.049⁸ ≈ 3e-11.
GAMMA_ATTEMPTS = 8
#: Attempts of the key-based Poisson's transformed rejection (λ ≥ 10): each
#: accepts with probability ≥ 0.89, so none does with probability ≤ 0.11¹⁶.
POISSON_ATTEMPTS = 16
#: Terms of the key-based Poisson's inverse CDF (λ < 10): P(X ≥ 64) < 1e-30.
_POISSON_TERMS = 64


def key_tensor(key, device=None) -> torch.Tensor:
    """``key`` as an int64 tensor ``[..., 2]``: a :class:`Key` on ``device``
    (None: the GPU), a tensor as it is."""
    if isinstance(key, Key):
        return torch.tensor([key.k0, key.k1], dtype=torch.int64, device=resolve_device(device))
    return key


def _words(key, ndim: int):
    """The key words, shaped to broadcast against a draw of ``ndim`` dims."""
    if isinstance(key, Key):
        return key.k0, key.k1
    tail = (1,) * ndim
    return (key[..., 0].reshape(key.shape[:-1] + tail),
            key[..., 1].reshape(key.shape[:-1] + tail))


def _device_of(key, device):
    return resolve_device(device) if isinstance(key, Key) else key.device


def _shape(shape) -> tuple:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _blocks(key, shape, device):
    """The two cipher words at counters ``(0, i)``, ``i`` the flat index of
    each element of ``shape``."""
    shape = _shape(shape)
    k0, k1 = _words(key, len(shape))
    n = math.prod(shape)
    if n >= 1 << 32:
        raise ValueError(f"a draw of {n} elements needs a counter wider than 32 bits")
    iota = torch.arange(n, dtype=torch.int64, device=_device_of(key, device)).reshape(shape)
    return rngmod.threefry2x32(k0, k1, 0, iota)


def split(key, num: int = 2):
    """``jax.random.split``: ``num`` new keys, key ``i`` the two cipher words
    at counter ``(0, i)``.  A :class:`Key` gives a tuple of :class:`Key`
    (host integers); a tensor ``[..., 2]`` gives ``[..., num, 2]``."""
    if isinstance(key, Key):
        return tuple(Key(*rngmod.threefry2x32(key.k0, key.k1, 0, i)) for i in range(num))
    b0, b1 = _blocks(key, (num,), None)
    return torch.stack([b0, b1], dim=-1)


def fold_in(key, data):
    """``jax.random.fold_in``: the cipher at counter ``(0, data)``.  A
    :class:`Key` with an int gives a :class:`Key`; with a tensor of ids, the
    batch ``ids.shape + (2,)``; a tensor key gives ``[..., 2]``."""
    if isinstance(key, Key):
        if isinstance(data, torch.Tensor):
            return rngmod.fold_in_ids(key, data)
        return rngmod.fold_in(key, data)
    k0, k1 = key[..., 0], key[..., 1]
    d = data & _MASK if isinstance(data, torch.Tensor) else int(data) & _MASK
    b0, b1 = rngmod.threefry2x32(k0, k1, 0, d)
    return torch.stack([b0, b1], dim=-1)


def bits(key, shape=(), device=None) -> torch.Tensor:
    """``jax.random.bits`` (uint32): ``b0 ^ b1`` at counter ``(0, i)``, as
    int64 values in ``[0, 2**32)``."""
    b0, b1 = _blocks(key, shape, device)
    return b0 ^ b1


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def uniform(key, shape=(), minval=0.0, maxval=1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform`` (float32): the top 23 bits of :func:`bits` as
    the mantissa of a float in ``[1, 2)``, minus 1, then
    ``max(minval, f·(maxval − minval) + minval)``.

    XLA contracts the multiply-add into one fused multiply-add, so it is
    taken here in float64 (the product of two float32 values is exact there)
    and rounded to float32 once: JAX's bits but where the float64 sum itself
    lands on a float32 rounding tie.  ``[0, 1)`` needs no arithmetic."""
    # (1 + m·2⁻²³) − 1 for the 23-bit mantissa m: exactly m·2⁻²³.
    f = (bits(key, shape, device) >> 9).to(torch.float32) * _ULP_OF_ONE
    if isinstance(minval, (int, float)) and isinstance(maxval, (int, float)) \
            and minval == 0 and maxval == 1:
        return f
    lo, hi = _f32(minval, f), _f32(maxval, f)
    fused = (f.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, fused)


#: XLA's float32 erfinv (Giles, "Approximating the erfinv function", GPU
#: Computing Gems 2011): degree-8 polynomials in ``w − 2.5`` (``w < 5``) and
#: ``√w − 3`` (``w ≥ 5``), ``w = −log1p(−x²)``; highest degree first.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 ``erfinv`` by XLA's polynomial (``ErfInv32``), each operation
    rounded on its own; ``±1`` gives ``±FLT_MAX``, as XLA's does."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, c_lt, c_ge) + p * w
    return torch.where(x.abs() == 1.0, x * _FLT_MAX, p * x)


def normal(key, shape=(), device=None) -> torch.Tensor:
    """``jax.random.normal`` (float32): ``√2 · erfinv(u)`` with ``u``
    uniform on ``[nextafter(−1, 0), 1)``."""
    return _SQRT2 * erfinv(uniform(key, shape, _LO, 1.0, device))


def exponential(key, shape=(), device=None) -> torch.Tensor:
    """``jax.random.exponential`` (float32): ``−log1p(−u)``."""
    return -torch.log1p(-uniform(key, shape, device=device))


def _batch_shape(shape, *params) -> tuple:
    """The draw's shape: ``shape``, or the parameters' broadcast shape."""
    if shape is not None:
        return _shape(shape)
    return tuple(torch.broadcast_shapes(*(torch.as_tensor(p).shape for p in params)))


def bernoulli(key, p, shape=None, device=None) -> torch.Tensor:
    """``jax.random.bernoulli``: ``uniform(key, shape) < p`` (bool)."""
    u = uniform(key, _batch_shape(shape, p), device=device)
    return u < _f32(p, u)


def categorical(key, logits, axis: int = -1, shape=None, device=None) -> torch.Tensor:
    """``jax.random.categorical``: the argmax along ``axis`` of ``logits``
    plus Gumbel noise ``−log(−log(uniform(key, ·, tiny, 1)))`` (int32; ties
    to the first index, as ``jnp.argmax``)."""
    logits = torch.as_tensor(logits, dtype=torch.float32)
    nd = logits.dim()
    ax = axis % nd
    batch = logits.shape[:ax] + logits.shape[ax + 1:]
    shape = tuple(batch) if shape is None else _shape(shape)
    prefix = shape[:len(shape) - len(batch)]
    full = list(shape[len(shape) - len(batch):])
    full.insert(ax, logits.shape[ax])
    g = -torch.log(-torch.log(uniform(key, prefix + tuple(full), _TINY, 1.0, device)))
    return torch.argmax(g + logits.to(g.device), dim=ax - nd).to(torch.int32)


def marsaglia_tsang(alpha, normal_of, uniform_of, boost_uniform, attempts: int,
                    log_space: bool = False):
    """Gamma(alpha, 1) by Marsaglia and Tsang (2000) with ``attempts``
    attempts side by side: attempt ``k`` takes ``normal_of(k)`` and
    ``uniform_of(k)``, the first accepted attempt is the draw, and an element
    none accepts takes ``d = α' − 1/3``.  ``α < 1`` is boosted:
    ``Gamma(α) = Gamma(α + 1) · U^(1/α)`` with ``U = boost_uniform()``.
    With ``log_space`` the log of the draw is returned (no underflow for
    small ``α``).  The counted samplers of
    :mod:`~advancedps_tpu_torch.distributions` and :func:`gamma` share it."""
    boost = alpha < 1.0
    a_eff = torch.where(boost, alpha + 1.0, alpha)
    d = a_eff - (1.0 / 3.0)
    c = 1.0 / torch.sqrt(9.0 * d)
    accepted = torch.zeros_like(d, dtype=torch.bool)
    out = d
    for k in range(attempts):
        x = normal_of(k)
        u = uniform_of(k)
        one_cx = 1.0 + c * x
        v = one_cx * one_cx * one_cx
        pos = v > 0
        # log(u): u = 0 gives −inf, a rejection.
        ok = pos & (torch.log(u) < 0.5 * x * x + d - d * v
                    + d * torch.log(torch.where(pos, v, torch.ones_like(v))))
        out = torch.where(ok & ~accepted, d * v, out)
        accepted = accepted | ok
    ub = boost_uniform()
    if log_space:
        return torch.log(out) + torch.where(boost, torch.log(ub) / alpha, torch.zeros_like(out))
    # U^(1/α) as exp(log(U)/α); U = 0 gives 0, a valid tail draw.
    return out * torch.where(boost, torch.exp(torch.log(torch.clamp(ub, min=1e-38)) / alpha),
                             torch.ones_like(out))


def _param(key, a, shape, device):
    """A parameter broadcast to the draw's full shape (the batch of keys,
    then ``shape``, or the parameter's own shape), and that ``shape``."""
    shape = _batch_shape(shape, a)
    a = torch.as_tensor(a, dtype=torch.float32, device=_device_of(key, device))
    lead = key.shape[:-1] if isinstance(key, torch.Tensor) else ()
    return torch.broadcast_to(a, lead + shape), shape


def _gamma(key, a, shape, device, log_space: bool):
    alpha, shape = _param(key, a, shape, device)
    ks = split(key, 2 * GAMMA_ATTEMPTS + 1)
    return marsaglia_tsang(alpha, lambda k: normal(_nth(ks, 2 * k), shape, device),
                           lambda k: uniform(_nth(ks, 2 * k + 1), shape, device=device),
                           lambda: uniform(_nth(ks, 2 * GAMMA_ATTEMPTS), shape, device=device),
                           GAMMA_ATTEMPTS, log_space)


def gamma(key, a, shape=None, device=None) -> torch.Tensor:
    """Gamma(a, 1) (float32), bounded-attempt Marsaglia–Tsang on keys split
    from ``key`` (not JAX's draws; see the module docstring)."""
    return _gamma(key, a, shape, device, log_space=False)


def _pair(key):
    """The two halves of ``split(key)``."""
    if isinstance(key, Key):
        return split(key)
    ks = split(key)
    return ks[..., 0, :], ks[..., 1, :]


def _nth(keys, i: int):
    """Key ``i`` of what :func:`split` gave."""
    return keys[i] if isinstance(keys, tuple) else keys[..., i, :]


def beta(key, a, b, shape=None, device=None) -> torch.Tensor:
    """Beta(a, b) as ``G_a / (G_a + G_b)`` from two gammas on the two halves
    of ``split(key)``, in log space as JAX takes them."""
    shape = _batch_shape(shape, a, b)
    ka, kb = _pair(key)
    la = _gamma(ka, a, shape, device, log_space=True)
    lb = _gamma(kb, b, shape, device, log_space=True)
    top = torch.maximum(la, lb)
    ea, eb = torch.exp(la - top), torch.exp(lb - top)
    return ea / (ea + eb)


def t(key, df, shape=None, device=None) -> torch.Tensor:
    """Student's t with ``df`` degrees of freedom: ``n · sqrt((df/2) / g)``
    with ``n`` normal and ``g`` Gamma(df/2) on the two halves of
    ``split(key)``, as JAX takes them."""
    shape = _batch_shape(shape, df)
    kn, kg = _pair(key)
    n = normal(kn, shape, device)
    half = torch.as_tensor(df, dtype=torch.float32, device=n.device) / 2.0
    g = gamma(kg, half, shape, device)
    return n * torch.sqrt(half / g)


def poisson(key, lam, shape=None, device=None) -> torch.Tensor:
    """Poisson(lam) (int32, as JAX's).  For ``λ < 10`` the inverse CDF of one uniform
    over :data:`_POISSON_TERMS` terms; for ``λ ≥ 10`` Hörmann's transformed
    rejection (PTRS, as JAX's) with :data:`POISSON_ATTEMPTS` attempts side by
    side, on keys split from ``key``."""
    lam, shape = _param(key, lam, shape, device)
    k_u, k_rej = _pair(key)
    # Inverse CDF: the count of terms whose running CDF is at or below u.
    u = uniform(k_u, shape, device=device)
    ks = torch.arange(_POISSON_TERMS, dtype=torch.float32, device=u.device)
    small = torch.where(lam < 10.0, lam, torch.zeros_like(lam))[..., None]
    logp = torch.xlogy(ks, small) - small - torch.lgamma(ks + 1.0)
    cdf = torch.cumsum(torch.exp(logp), dim=-1)
    by_cdf = (cdf <= u[..., None]).sum(dim=-1)
    # Transformed rejection for the large rates.
    big = torch.where(lam < 10.0, torch.full_like(lam, 1e5), lam)
    log_lam = torch.log(big)
    b = 0.931 + 2.53 * torch.sqrt(big)
    a = -0.059 + 0.02483 * b
    inv_alpha = 1.1239 + 1.1328 / (b - 3.4)
    v_r = 0.9277 - 3.6224 / (b - 2.0)
    ks_rej = split(k_rej, 2 * POISSON_ATTEMPTS)
    out = torch.floor(big)
    accepted = torch.zeros_like(big, dtype=torch.bool)
    for i in range(POISSON_ATTEMPTS):
        uu = uniform(_nth(ks_rej, 2 * i), shape, device=device) - 0.5
        v = uniform(_nth(ks_rej, 2 * i + 1), shape, device=device)
        us = 0.5 - uu.abs()
        k = torch.floor((2.0 * a / us + b) * uu + big + 0.43)
        s = torch.log(v * inv_alpha / (a / (us * us) + b))
        tt = -big + k * log_lam - torch.lgamma(k + 1.0)
        accept = ((us >= 0.07) & (v <= v_r)) | (~((k < 0) | ((us < 0.013) & (v > us))) & (s <= tt))
        out = torch.where(accept & ~accepted, k, out)
        accepted = accepted | accept
    draw = torch.where(lam < 10.0, by_cdf.to(out.dtype), out)
    return torch.where(lam == 0.0, torch.zeros_like(draw), draw).to(torch.int32)
