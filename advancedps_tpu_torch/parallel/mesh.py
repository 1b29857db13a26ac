"""Particle meshes and their collectives (PyTorch port of
``advancedps_tpu/parallel/mesh.py``).

JAX's ``shard_map`` runs one controller over K devices.  The port keeps that
single-controller model: a :class:`ParticleMesh` is an ordered list of K shard
devices, and one Python process runs each step of the sharded sweep on every
shard in turn (lockstep), then the collectives.  A device may repeat, so K
logical shards can sit on one card, as JAX's virtual CPU devices do.

The collectives are plain functions over a list of per-shard tensors, one
per shard in shard order, and return one result per shard: :func:`pmax`,
:func:`pmin`, :func:`psum`, :func:`all_gather`, :func:`ppermute` and
:func:`axis_index`.  They combine in shard order, so a result does not depend
on where the shards lie, and a tensor crosses devices by ``.to`` only where
two shards' devices differ.  The mesh counts each collective by kind, with
the elements each shard puts in: the counterpart of reading the collectives
off a jaxpr.

A mesh spanning processes (``init_distributed`` over ``torch.distributed``)
is not part of the port yet.
"""

from __future__ import annotations

from collections import Counter
from typing import Sequence, Union

import torch

from .._device import resolve_device

__all__ = [
    "PARTICLE_AXIS",
    "CHAIN_AXIS",
    "ParticleMesh",
    "ChainParticleMesh",
    "particle_mesh",
    "chain_particle_mesh",
    "shard_along",
    "pmax",
    "pmin",
    "psum",
    "all_gather",
    "ppermute",
    "axis_index",
]

PARTICLE_AXIS = "p"
CHAIN_AXIS = "c"

Device = Union[str, torch.device]


class ParticleMesh:
    """K shards along the particle axis, each on a torch device.

    ``calls[kind]`` counts the collectives of each kind run on this mesh,
    ``elements[kind]`` the elements the shards put into them and
    ``largest[kind]`` the most one shard put into one call; ``exchanges``
    counts the resampling firings of the sharded sweep by the exchange that
    ran (``"allgather"`` or ``"neighbor"``).  :meth:`reset_counts` sets all
    to zero.
    """

    def __init__(self, devices: Sequence[Device]):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        self.reset_counts()

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {PARTICLE_AXIS: self.size}

    def reset_counts(self):
        self.calls = Counter()
        self.elements = Counter()
        self.largest = Counter()
        self.exchanges = Counter()

    def _count(self, kind: str, xs):
        if len(xs) != self.size:
            raise ValueError(f"{kind}: {len(xs)} tensors for a mesh of {self.size} shards")
        sizes = [x.numel() for x in xs]
        self.calls[kind] += 1
        self.elements[kind] += sum(sizes)
        self.largest[kind] = max(self.largest[kind], max(sizes))

    def replicate(self, x: torch.Tensor) -> list:
        """``x`` on every shard's device (the same tensor where it lies already)."""
        return [x.to(d) for d in self.devices]

    def __repr__(self):
        return f"ParticleMesh({[str(d) for d in self.devices]})"


class ChainParticleMesh:
    """``n_chains`` rows of particle meshes: independent chains along the
    chain axis, each chain's particles sharded along its row."""

    def __init__(self, rows: Sequence[ParticleMesh]):
        self.rows = tuple(rows)
        if not self.rows or len({r.size for r in self.rows}) != 1:
            raise ValueError("a chain mesh needs rows of one size")

    @property
    def shape(self) -> dict:
        return {CHAIN_AXIS: len(self.rows), PARTICLE_AXIS: self.rows[0].size}

    def __repr__(self):
        return f"ChainParticleMesh({list(self.rows)})"


def _devices(count: int, device) -> list:
    """``count`` devices from one device (repeated; None: the GPU) or a
    sequence of them."""
    if device is None or isinstance(device, (str, torch.device)):
        return [resolve_device(device)] * count
    devices = list(device)
    if len(devices) < count:
        raise ValueError(f"{count} shards need {count} devices, got {len(devices)}")
    return devices[:count]


def particle_mesh(n_shards: int, device=None) -> ParticleMesh:
    """1-D mesh of ``n_shards`` shards on ``device`` (one device, repeated:
    ``n_shards`` logical shards on it; None means the GPU) or on a sequence
    of devices."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return ParticleMesh(_devices(n_shards, device))


def chain_particle_mesh(n_chains: int, n_particle_shards: int, device=None) -> ChainParticleMesh:
    """2-D mesh: ``n_chains`` rows of ``n_particle_shards`` shards, on one
    device (None: the GPU) or on a sequence of ``n_chains · n_particle_shards`` devices in
    row order."""
    if n_chains < 1 or n_particle_shards < 1:
        raise ValueError("a chain mesh needs n_chains >= 1 and n_particle_shards >= 1")
    devices = _devices(n_chains * n_particle_shards, device)
    k = n_particle_shards
    return ChainParticleMesh([ParticleMesh(devices[i * k:(i + 1) * k]) for i in range(n_chains)])


def shard_along(mesh: ParticleMesh, x: torch.Tensor) -> list:
    """Split ``x`` along its leading axis into the mesh's K shards, each on
    its shard's device (the counterpart of the JAX ``shard_along`` sharding)."""
    if x.shape[0] % mesh.size:
        raise ValueError(f"leading axis {x.shape[0]} not divisible by {mesh.size} shards")
    return [c.to(d) for c, d in zip(torch.chunk(x, mesh.size), mesh.devices)]


def _fold(mesh: ParticleMesh, kind: str, xs, op) -> list:
    mesh._count(kind, xs)
    acc = xs[0]
    for x in xs[1:]:
        acc = op(acc, x.to(acc.device))
    return mesh.replicate(acc)


def pmax(mesh: ParticleMesh, xs) -> list:
    """Elementwise max over the shards, replicated."""
    return _fold(mesh, "pmax", xs, torch.maximum)


def pmin(mesh: ParticleMesh, xs) -> list:
    """Elementwise min over the shards, replicated."""
    return _fold(mesh, "pmin", xs, torch.minimum)


def psum(mesh: ParticleMesh, xs) -> list:
    """Elementwise sum over the shards, added in shard order, replicated."""
    return _fold(mesh, "psum", xs, torch.add)


def all_gather(mesh: ParticleMesh, xs, tiled: bool = True) -> list:
    """The shards' tensors joined in shard order along a leading axis
    (``tiled``: concatenated; else stacked on a new axis), replicated."""
    mesh._count("all_gather", xs)
    dev = mesh.devices[0]
    parts = [x.to(dev) for x in xs]
    return mesh.replicate(torch.cat(parts) if tiled else torch.stack(parts))


def ppermute(mesh: ParticleMesh, xs, shift: int) -> list:
    """Ring shift: shard ``k`` receives shard ``k − shift``'s tensor (``shift``
    1 from the left neighbour, −1 from the right), wrapping around."""
    mesh._count("ppermute", xs)
    k = mesh.size
    return [xs[(i - shift) % k].to(mesh.devices[i]) for i in range(k)]


def axis_index(mesh: ParticleMesh) -> range:
    """Each shard's index along the particle axis."""
    return range(mesh.size)
