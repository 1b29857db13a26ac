"""The keyed draws of ``jax.random`` (``jax_threefry_partitionable``), written
out for the reference on the cipher of :mod:`benchmark.reference.cipher`.

A key is a pair of int64 word tensors ``(k0, k1)`` of one shape (uint32
values), a batch of keys.  Element ``i`` of a draw of ``n`` values under a
key is the cipher at counter ``(0, i)``: ``split`` keeps both words as a new
key, ``bits`` their xor.  The float conversions are the definitions the JAX
package fixes; nothing here calls the program.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import cipher

_ULP_OF_ONE = 2.0 ** -23  # float32 spacing in [1, 2)
_TWO_PI = 2.0 * math.pi


def split(k, num: int) -> list:
    """``num`` keys from each key of the batch: key ``i`` the two words at
    counter ``(0, i)``."""
    return [cipher.threefry2x32(k[0], k[1], 0, i) for i in range(num)]


def threefry_wide(k, n: int):
    """The two words of :func:`cipher.threefry2x32` of each key at counters
    ``(0, 0 .. n-1)``, ``[..., n]`` each (int64 holding uint32 values).

    The same 20 rounds on int32 tensors, for draws ``n`` wide: int32 addition
    wraps modulo 2^32 as the cipher's masked sums do, and each right shift is
    masked to its low bits, so it is logical.  Half the bytes of the int64
    words and no mask after a sum: the reference's ``[N, 64]`` draws at 2M
    particles are bound by the memory traffic of these passes."""
    k0, k1 = k[0][..., None].to(torch.int32), k[1][..., None].to(torch.int32)
    ks = (k1, k0 ^ k1 ^ cipher.PARITY, k0)
    x0 = k0
    x1 = torch.arange(n, dtype=torch.int32, device=k0.device) + k1
    for i in range(5):
        for r in cipher.ROT[:4] if i % 2 == 0 else cipher.ROT[4:]:
            x0 = x0 + x1
            x1 = ((x1 << r) | ((x1 >> (32 - r)) & ((1 << r) - 1))) ^ x0
        x0 = x0 + ks[i % 3]
        x1 = x1 + (ks[(i + 1) % 3] + (i + 1))
    return x0.to(torch.int64) & cipher.MASK, x1.to(torch.int64) & cipher.MASK


def bits(k, n: int) -> torch.Tensor:
    """``[..., n]`` uint32 draws (int64): ``b0 ^ b1`` at counters ``(0, 0 .. n-1)``."""
    b0, b1 = threefry_wide(k, n)
    return b0 ^ b1


def uniform(k, n: int, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """``[..., n]`` float32 uniforms: the top 23 bits of :func:`bits` as the
    mantissa of a float in ``[1, 2)``, minus 1 (exact); then
    ``max(lo, f (hi - lo) + lo)`` with the multiply-add taken in float64 and
    rounded once, as XLA fuses it.  ``lo`` and ``hi`` are rounded to float32."""
    f = (bits(k, n) >> 9).to(torch.float32) * _ULP_OF_ONE
    if lo == 0.0 and hi == 1.0:
        return f
    lo32 = torch.tensor(lo, dtype=torch.float32, device=f.device)
    hi32 = torch.tensor(hi, dtype=torch.float32, device=f.device)
    fused = (f.double() * (hi32 - lo32).double() + lo32.double()).float()
    return torch.maximum(lo32, fused)


def exponential(k, n: int) -> torch.Tensor:
    """``[..., n]`` Exp(1) draws (float32): ``-log1p(-u)``."""
    return -torch.log1p(-uniform(k, n))


def normal(k, n: int) -> torch.Tensor:
    """``[..., n]`` N(0, 1) draws (float32): ``sqrt(2) erfinv(u)``, ``u``
    uniform on ``[nextafter(-1, 0), 1)``, the erfinv XLA's polynomial."""
    return cipher._SQRT2 * cipher._erfinv(uniform(k, n, cipher._LO, 1.0))


def normal_pairs(k, ids: torch.Tensor) -> torch.Tensor:
    """``[..., 2]`` N(0, 1) draws (float32) an id: the two Box-Muller outputs
    of the block at counter ``(0, id)``, each unit the word's top 24 bits."""
    b0, b1 = cipher.threefry2x32(k[0], k[1], 0, ids.to(torch.int64))
    u1, u2 = cipher._unit24(b0), cipher._unit24(b1)
    r = torch.sqrt(-2.0 * torch.log1p(-u1))
    theta = _TWO_PI * u2
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], -1)
