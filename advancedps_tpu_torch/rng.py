"""Counter-based key discipline (PyTorch port of ``advancedps_tpu/rng.py``).

All randomness of a sweep is a pure function of position: the draw of particle
``i`` at step ``t`` of stream ``tag`` is a Threefry-2x32 block evaluated with the
step key ``fold_in(fold_in(sweep_key, tag), t)`` and the counter ``(draw, i)``.
The generator is therefore an explicit :class:`Key` of two uint32 words, not a
``torch.Generator``, and every function here is bitwise equal to the JAX
package for the same key words (``jax.random.key(s)`` has words ``(0, s)``).

Key arithmetic (``fold_in``, ``step_key``, the scalar :func:`uniform`) runs on
host integers, so deriving a step key never touches the device.  Per-particle
draws run the cipher on int64 tensors masked to 32 bits: torch's uint32
coverage is thin, on CUDA too.  Components that are sampled particle by
particle get one key per particle (:func:`particle_keys`), an int64 tensor of
two words each, and draw from it with :mod:`advancedps_tpu_torch.random`.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass

import torch

from ._device import resolve_device

__all__ = [
    "PROPAGATE",
    "RESAMPLE",
    "ANCESTOR",
    "DRAW",
    "INIT",
    "Key",
    "key",
    "fold_in",
    "step_key",
    "uniform",
    "threefry2x32",
    "pos_uniform_pair",
    "pos_uniform",
    "pos_normal_pair",
    "pos_normal",
    "pos_normals",
    "fold_in_ids",
    "particle_keys",
    "StepRng",
]

# Stream tags: disjoint randomness streams within one sweep.
PROPAGATE = 0  # latent transition sampling
RESAMPLE = 1  # ancestor-index draws (resampling)
ANCESTOR = 2  # PGAS reference-ancestor draw
DRAW = 3  # final retained-trajectory draw (PG/PGAS)
INIT = 4  # initial-state sampling

_MASK = 0xFFFFFFFF
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)  # Threefry-2x32 rotation schedule
_PARITY = 0x1BD11BDA  # Skein/Threefry key-schedule parity constant


@dataclass(frozen=True)
class Key:
    """A Threefry key: two uint32 words, as ``jax.random.key_data`` gives them."""

    k0: int
    k1: int

    def __post_init__(self):
        for w in (self.k0, self.k1):
            if not 0 <= int(w) <= _MASK:
                raise ValueError(f"key words must be uint32, got {self.k0}, {self.k1}")


def key(seed: int) -> Key:
    """The key ``jax.random.key(seed)`` makes: words ``(seed >> 32, seed & 0xFFFFFFFF)``."""
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed must be in [0, 2**64), got {seed}")
    return Key(seed >> 32, seed & _MASK)


def _rotl(x, r):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, c0, c1, rounds: int = 20):
    """Threefry-2x32 block cipher (Salmon et al., SC'11).

    Works on Python ints and on int64 tensors alike; every value stays in
    ``[0, 2**32)``.  ``(k0, k1)`` key words, ``(c0, c1)`` counter words
    (broadcastable).  Returns the two output words.
    """
    ks0, ks1 = k0, k1
    ks2 = ks0 ^ ks1 ^ _PARITY
    x0 = (c0 + ks0) & _MASK
    x1 = (c1 + ks1) & _MASK
    ks = (ks1, ks2, ks0)
    for i in range(rounds // 4):
        for r in _ROT[:4] if i % 2 == 0 else _ROT[4:]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[i % 3]) & _MASK
        x1 = (x1 + ks[(i + 1) % 3] + (i + 1)) & _MASK
    return x0, x1


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in``: the cipher of ``k`` at counter ``(0, data)``."""
    return Key(*threefry2x32(k.k0, k.k1, 0, int(data) & _MASK))


def step_key(k: Key, tag: int, t: int) -> Key:
    """Key for stream ``tag`` at sweep step ``t``."""
    return fold_in(fold_in(k, tag), t)


def uniform(k: Key) -> float:
    """The float32 scalar ``jax.random.uniform(k)`` as a Python float.

    ``b0 ^ b1`` at counter ``(0, 0)``; its top 23 bits become the mantissa of
    a float in ``[1, 2)``, minus 1.  The subtraction is exact in float32.
    """
    b0, b1 = threefry2x32(k.k0, k.k1, 0, 0)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    return struct.unpack("<f", struct.pack("<I", bits))[0] - 1.0


def _as_counter(gids: torch.Tensor) -> torch.Tensor:
    return gids.to(torch.int64) & _MASK


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 → float32 in [0, 1) with 24-bit resolution: ``(bits >> 8) · 2^-24``."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def pos_uniform_pair(k: Key, gids: torch.Tensor, draw: int = 0):
    """Two U[0,1) streams; element ``i`` a pure function of ``(k, draw, gids[i])``."""
    c1 = _as_counter(gids)
    b0, b1 = threefry2x32(k.k0, k.k1, torch.full_like(c1, int(draw) & _MASK), c1)
    return _bits_to_unit(b0), _bits_to_unit(b1)


def pos_uniform(k: Key, gids: torch.Tensor, draw: int = 0) -> torch.Tensor:
    """One U[0,1) draw per id, paired layout: ids ``2p`` and ``2p+1`` take the
    two words of the block at counter ``p``."""
    g = gids.to(torch.int64)
    u0, u1 = pos_uniform_pair(k, g >> 1, draw)
    return torch.where((g & 1) == 0, u0, u1)


_TWO_PI = 2.0 * math.pi


def pos_normal_pair(k: Key, gids: torch.Tensor, draw: int = 0):
    """Two N(0,1) draws per id by Box–Muller on one Threefry block."""
    u1, u2 = pos_uniform_pair(k, gids, draw)
    # 1 - u1 ∈ (0, 1]: the log argument is never 0.
    r = torch.sqrt(-2.0 * torch.log1p(-u1))
    theta = _TWO_PI * u2
    return r * torch.cos(theta), r * torch.sin(theta)


def pos_normal(k: Key, gids: torch.Tensor, draw: int = 0) -> torch.Tensor:
    """One N(0,1) draw per id, paired layout: ids ``2p`` and ``2p+1`` share the
    block at counter ``p`` and take its two Box–Muller outputs."""
    g = gids.to(torch.int64)
    z0, z1 = pos_normal_pair(k, g >> 1, draw)
    return torch.where((g & 1) == 0, z0, z1)


def pos_normals(k: Key, gids: torch.Tensor, d: int, draw0: int = 0) -> torch.Tensor:
    """``[n, d]`` N(0,1) draws: element ``(i, j)`` a pure function of
    ``(k, draw0 + j // 2, gids[i])``, consecutive columns taking the two
    Box–Muller outputs of one block."""
    cols = []
    for j in range(0, d, 2):
        z0, z1 = pos_normal_pair(k, gids, draw0 + j // 2)
        cols.append(z0)
        if j + 1 < d:
            cols.append(z1)
    return torch.stack(cols, dim=-1)


def fold_in_ids(k: Key, ids: torch.Tensor) -> torch.Tensor:
    """``fold_in(k, ids[i])`` for every id, as a batch of keys: an int64
    tensor ``ids.shape + (2,)`` of uint32 words (``jax.random.key_data`` of
    ``vmap(fold_in)``)."""
    b0, b1 = threefry2x32(k.k0, k.k1, 0, _as_counter(ids))
    return torch.stack([b0, b1], dim=-1)


def particle_keys(k: Key, tag: int, t: int, n: int, device=None) -> torch.Tensor:
    """``[n, 2]`` keys, one per particle slot for stream ``tag`` at step
    ``t``: ``fold_in(step_key(k, tag, t), i)`` for ``i < n``, on ``device``
    (None: the GPU)."""
    return fold_in_ids(step_key(k, tag, t), torch.arange(n, device=resolve_device(device)))


@dataclass(frozen=True)
class StepRng:
    """Per-(stream, step) randomness handed to a sweep kernel: ``key`` is
    already folded with (tag, t); ``gids`` are the global particle ids.

    The counted draws (:meth:`uniform`, :meth:`normal`, :meth:`normal_pair`,
    :meth:`normals`) are the vectorized components' path; :meth:`particle_keys`
    gives one key per particle for components sampled particle by particle.
    Both are positional in the global id."""

    key: Key
    gids: torch.Tensor

    def particle_keys(self) -> torch.Tensor:
        """``[n, 2]`` keys ``fold_in(key, gids[i])``."""
        return fold_in_ids(self.key, self.gids)

    def uniform(self, draw: int = 0) -> torch.Tensor:
        return pos_uniform(self.key, self.gids, draw)

    def normal(self, draw: int = 0) -> torch.Tensor:
        return pos_normal(self.key, self.gids, draw)

    def normal_pair(self, draw: int = 0):
        return pos_normal_pair(self.key, self.gids, draw)

    def normals(self, d: int) -> torch.Tensor:
        return pos_normals(self.key, self.gids, d)

    @property
    def n(self) -> int:
        return self.gids.shape[0]
