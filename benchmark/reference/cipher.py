"""Threefry-2x32 (Salmon et al., SC'11) and the draws built on it, written out
for the reference.

The sweep's randomness is positional: the draw of particle ``i`` at step
``t`` of stream ``tag`` is a Threefry block under the step key
``fold_in(fold_in(key, tag), t)``.  Words are int64 tensors (or Python ints)
holding uint32 values.  These are the definitions the JAX package fixes
(``jax.random`` with ``jax_threefry_partitionable``); nothing here calls the
program.
"""

from __future__ import annotations

import math
import struct

import torch

MASK = 0xFFFFFFFF
ROT = (13, 15, 26, 6, 17, 29, 16, 24)
PARITY = 0x1BD11BDA

# Stream tags of one sweep.
PROPAGATE, RESAMPLE, INIT = 0, 1, 4

_TWO_PI = 2.0 * math.pi
_SQRT2 = 1.4142135381698608  # float32 sqrt(2)
_LO = -0.9999999403953552  # nextafter(-1, 0) in float32
_FLT_MAX = 3.4028234663852886e38
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _rotl(x, r):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, c0, c1):
    """The two output words of the 20-round cipher of key ``(k0, k1)`` at
    counter ``(c0, c1)``; ints or broadcasting int64 tensors."""
    ks = (k1, k0 ^ k1 ^ PARITY, k0)
    x0 = (c0 + k0) & MASK
    x1 = (c1 + k1) & MASK
    for i in range(5):
        for r in ROT[:4] if i % 2 == 0 else ROT[4:]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[i % 3]) & MASK
        x1 = (x1 + ks[(i + 1) % 3] + (i + 1)) & MASK
    return x0, x1


def key(seed: int):
    """The key of a whole-number seed: words ``(seed >> 32, seed & MASK)``."""
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed must be in [0, 2**64), got {seed}")
    return seed >> 32, seed & MASK


def fold_in(k, data: int):
    return threefry2x32(k[0], k[1], 0, int(data) & MASK)


def step_key(k, tag: int, t: int):
    return fold_in(fold_in(k, tag), t)


def uniform_scalar(k) -> float:
    """The float32 uniform of a key: the top 23 bits of ``b0 ^ b1`` at
    counter ``(0, 0)`` as a mantissa in ``[1, 2)``, minus 1 (exact)."""
    b0, b1 = threefry2x32(k[0], k[1], 0, 0)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    return struct.unpack("<f", struct.pack("<I", bits))[0] - 1.0


def _unit24(bits):
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def normal_paired(k, ids: torch.Tensor) -> torch.Tensor:
    """One N(0, 1) float32 draw an id: ids ``2p`` and ``2p + 1`` take the two
    Box-Muller outputs of the block at counter ``(0, p)``."""
    g = ids.to(torch.int64)
    b0, b1 = threefry2x32(k[0], k[1], torch.zeros_like(g), g >> 1)
    u1, u2 = _unit24(b0), _unit24(b1)
    r = torch.sqrt(-2.0 * torch.log1p(-u1))
    theta = _TWO_PI * u2
    return torch.where((g & 1) == 0, r * torch.cos(theta), r * torch.sin(theta))


def particle_keys(k, ids: torch.Tensor):
    """``fold_in(k, ids[i])`` for every id: two int64 word tensors."""
    return threefry2x32(k[0], k[1], 0, ids.to(torch.int64))


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv by Giles' polynomial, as XLA evaluates it."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, c_lt, c_ge) + p * w
    return torch.where(x.abs() == 1.0, x * _FLT_MAX, p * x)


def normal_keyed(k0: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    """``jax.random.normal`` of shape ``()`` under each key ``(k0[i], k1[i])``:
    ``sqrt(2) * erfinv(u)``, ``u`` uniform on ``[nextafter(-1, 0), 1)`` from
    ``b0 ^ b1`` at counter ``(0, 0)``; the affine map in float64, rounded once."""
    b0, b1 = threefry2x32(k0, k1, 0, 0)
    f = ((b0 ^ b1) >> 9).to(torch.float32) * (2.0 ** -23)
    lo = torch.tensor(_LO, dtype=torch.float32, device=f.device)
    span = torch.tensor(1.0, dtype=torch.float32, device=f.device) - lo
    u = torch.maximum(lo, (f.double() * span.double() + lo.double()).float())
    return _SQRT2 * _erfinv(u)
