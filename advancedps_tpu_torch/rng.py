"""Counter-based key discipline (PyTorch port of ``advancedps_tpu/rng.py``).

All randomness of a sweep is a pure function of position: the draw of particle
``i`` at step ``t`` of stream ``tag`` is a Threefry-2x32 block evaluated with the
step key ``fold_in(fold_in(sweep_key, tag), t)`` and the counter ``(draw, i)``.
The generator is therefore an explicit :class:`Key` of two uint32 words, not a
``torch.Generator``, and every function here is bitwise equal to the JAX
package for the same key words (``jax.random.key(s)`` has words ``(0, s)``).

Key arithmetic (``fold_in``, ``step_key``, the scalar :func:`uniform`) runs on
host integers, so deriving a step key never touches the device.  Every draw
on tensors goes through :mod:`advancedps_tpu_torch.ops.threefry`: on the card
one CUDA kernel a draw computes the uint32 cipher, the unit conversion and
Box–Muller, as XLA fuses them for the JAX package; on the CPU its plain
version runs the cipher on int64 tensors masked to 32 bits.  Words and ids
are int64 tensors of uint32 values.  Components that are sampled particle by
particle get one key per particle (:func:`particle_keys`), an int64 tensor of
two words each, and draw from it with :mod:`advancedps_tpu_torch.random`.

Independent chains run as one batch: a :class:`KeyBatch` holds the words of
many keys as int64 tensors, and every function here that takes a key takes
one, its words broadcast against the ids (words ``[C, 1]`` against ids
``[N]`` give ``[C, N]`` draws, row ``c`` bitwise what chain ``c``'s
:class:`Key` draws).  :func:`chain_keys` makes the batch ``fold_in(key, c)``
and :func:`step_key_table` derives a sweep's step keys for every stream, step
and chain in one tensor cipher on the host (:func:`uniform` of those keys
gives the systematic offsets).
Under :func:`torch.func.vmap` over the chain axis a :class:`StepRng` carries
one chain's words as 0-dim tensors, so a model's draws are those of its chain.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import torch

from ._device import resolve_device
from .ops import threefry as _tf

__all__ = [
    "PROPAGATE",
    "RESAMPLE",
    "ANCESTOR",
    "DRAW",
    "INIT",
    "Key",
    "KeyBatch",
    "key",
    "chain_keys",
    "step_key_table",
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


@dataclass(frozen=True)
class Key:
    """A Threefry key: two uint32 words, as ``jax.random.key_data`` gives them."""

    k0: int
    k1: int

    def __post_init__(self):
        for w in (self.k0, self.k1):
            if not 0 <= int(w) <= _MASK:
                raise ValueError(f"key words must be uint32, got {self.k0}, {self.k1}")


@dataclass(frozen=True)
class KeyBatch:
    """Threefry keys as int64 tensors of uint32 words, ``k0`` and ``k1`` of one
    shape: a batch of chains' keys (``[C]``), shaped to broadcast against ids
    (``[C, 1]``), or one chain's words under ``vmap`` (0-dim).  The sweep
    makes no host read of words on the card."""

    k0: torch.Tensor
    k1: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.k0.device

    def __len__(self) -> int:
        return self.k0.shape[0]

    def key(self, c: int) -> Key:
        """Chain ``c``'s key as host integers (a device-to-host read)."""
        return Key(int(self.k0[c]), int(self.k1[c]))

    def to(self, device) -> "KeyBatch":
        return KeyBatch(self.k0.to(device), self.k1.to(device))

    def column(self) -> "KeyBatch":
        """Words ``[C, 1]``: broadcast against ids ``[N]`` to ``[C, N]``."""
        return KeyBatch(self.k0[..., None], self.k1[..., None])


def key(seed: int) -> Key:
    """The key ``jax.random.key(seed)`` makes: words ``(seed >> 32, seed & 0xFFFFFFFF)``."""
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed must be in [0, 2**64), got {seed}")
    return Key(seed >> 32, seed & _MASK)


def threefry2x32(k0, k1, c0, c1, rounds: int = 20):
    """Threefry-2x32 block cipher (Salmon et al., SC'11).

    ``(k0, k1)`` key words, ``(c0, c1)`` counter words: Python ints, or int64
    tensors that broadcast (values in ``[0, 2**32)``).  Returns the two output
    words, as ints or as int64 tensors of the broadcast shape.  Host words run
    the cipher on the host; tensors take
    :func:`advancedps_tpu_torch.ops.threefry.threefry2x32`, one kernel on the
    card (20 rounds only) and its plain version on the CPU.
    """
    if any(isinstance(x, torch.Tensor) for x in (k0, k1, c0, c1)):
        return _tf.threefry2x32(k0, k1, c0, c1, rounds)
    return _tf.threefry2x32_ref(k0, k1, c0, c1, rounds)


def fold_in(k, data: int):
    """``jax.random.fold_in``: the cipher of ``k`` at counter ``(0, data)``.
    A :class:`KeyBatch` folds every key of the batch with ``data``."""
    if isinstance(k, KeyBatch):
        return KeyBatch(*threefry2x32(k.k0, k.k1, 0, int(data) & _MASK))
    return Key(*threefry2x32(k.k0, k.k1, 0, int(data) & _MASK))


def step_key(k, tag: int, t: int):
    """Key for stream ``tag`` at sweep step ``t``."""
    return fold_in(fold_in(k, tag), t)


def _unit_of_bits(b0, b1):
    """``jax.random.uniform``'s float of the words ``(b0, b1)``, as an int64
    tensor of float32 bits."""
    return ((b0 ^ b1) >> 9) | 0x3F800000


def uniform(k):
    """The float32 scalar ``jax.random.uniform(k)`` as a Python float; for a
    :class:`KeyBatch`, a float32 tensor of the batch's shape.

    ``b0 ^ b1`` at counter ``(0, 0)``; its top 23 bits become the mantissa of
    a float in ``[1, 2)``, minus 1.  The subtraction is exact in float32.
    """
    b0, b1 = threefry2x32(k.k0, k.k1, 0, 0)
    bits = _unit_of_bits(b0, b1)
    if isinstance(k, KeyBatch):
        return bits.to(torch.int32).view(torch.float32) - 1.0
    return struct.unpack("<f", struct.pack("<I", bits))[0] - 1.0


def chain_keys(k: Key, n_chains: int) -> KeyBatch:
    """The batch ``fold_in(k, c)`` for ``c < n_chains`` (on the CPU): JAX's
    ``vmap(lambda i: fold_in(key, i))(arange(n_chains))``."""
    w = fold_in_ids(k, torch.arange(n_chains))
    return KeyBatch(w[:, 0].contiguous(), w[:, 1].contiguous())


def step_key_table(keys: KeyBatch, tags, n_steps: int):
    """Every step key of a sweep at once: words ``[len(tags), n_steps, C]``,
    entry ``(s, t, c)`` the words of ``step_key(keys[c], tags[s], t)``, from
    one tensor cipher on the keys' device (the host, for a batch from
    :func:`chain_keys`).  Returns ``(k0, k1)``."""
    tag = torch.tensor([int(g) & _MASK for g in tags], dtype=torch.int64,
                       device=keys.device)[:, None]
    a0, a1 = threefry2x32(keys.k0[None, :], keys.k1[None, :], 0, tag)  # [S, C]
    t = torch.arange(n_steps, dtype=torch.int64, device=keys.device)[None, :, None]
    return threefry2x32(a0[:, None, :], a1[:, None, :], 0, t)


def pos_uniform_pair(k: Key, gids: torch.Tensor, draw: int = 0):
    """Two U[0,1) streams; element ``i`` a pure function of ``(k, draw, gids[i])``."""
    return _tf.pos_uniform(k.k0, k.k1, gids, draw, pair=True)


def pos_uniform(k: Key, gids: torch.Tensor, draw: int = 0) -> torch.Tensor:
    """One U[0,1) draw per id, paired layout: ids ``2p`` and ``2p+1`` take the
    two words of the block at counter ``p``."""
    return _tf.pos_uniform(k.k0, k.k1, gids, draw)


def pos_normal_pair(k: Key, gids: torch.Tensor, draw: int = 0):
    """Two N(0,1) draws per id by Box–Muller on one Threefry block."""
    return _tf.pos_normal(k.k0, k.k1, gids, draw, pair=True)


def pos_normal(k: Key, gids: torch.Tensor, draw: int = 0) -> torch.Tensor:
    """One N(0,1) draw per id, paired layout: ids ``2p`` and ``2p+1`` share the
    block at counter ``p`` and take its two Box–Muller outputs."""
    return _tf.pos_normal(k.k0, k.k1, gids, draw)


def pos_normals(k: Key, gids: torch.Tensor, d: int, draw0: int = 0) -> torch.Tensor:
    """``[n, d]`` N(0,1) draws: element ``(i, j)`` a pure function of
    ``(k, draw0 + j // 2, gids[i])``, consecutive columns taking the two
    Box–Muller outputs of one block."""
    return _tf.pos_normals(k.k0, k.k1, gids, d, draw0)


def fold_in_ids(k: Key, ids: torch.Tensor) -> torch.Tensor:
    """``fold_in(k, ids[i])`` for every id, as a batch of keys: an int64
    tensor ``ids.shape + (2,)`` of uint32 words (``jax.random.key_data`` of
    ``vmap(fold_in)``)."""
    return _tf.threefry2x32(k.k0, k.k1, 0, ids.to(torch.int64), stacked=True)


def particle_keys(k: Key, tag: int, t: int, n: int, device=None) -> torch.Tensor:
    """``[n, 2]`` keys, one per particle slot for stream ``tag`` at step
    ``t``: ``fold_in(step_key(k, tag, t), i)`` for ``i < n``, on ``device``
    (None: the GPU)."""
    return fold_in_ids(step_key(k, tag, t), torch.arange(n, device=resolve_device(device)))


@dataclass(frozen=True)
class StepRng:
    """Per-(stream, step) randomness handed to a sweep kernel: ``key`` is
    already folded with (tag, t); ``gids`` are the global particle ids.
    ``key`` may be a :class:`KeyBatch` whose words broadcast against
    ``gids``: under a ``vmap`` over chains, one chain's 0-dim words.

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
