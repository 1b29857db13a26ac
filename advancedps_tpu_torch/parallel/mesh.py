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

A mesh may also span processes, one rank each (:func:`init_distributed` over
``torch.distributed``: NCCL on the card, gloo on the CPU).  Once a process
group is up, :func:`particle_mesh` splits its K shards in contiguous blocks
across the ranks, and each rank holds and runs only its own: the per-shard
lists the collectives take and return hold the rank's local shards
(``mesh.local``, their global shard numbers).  A collective ``all_gather``s
the local tensors across the ranks and folds them **in shard order** on every
rank (not by ``all_reduce``, whose order the backend chooses), so every rank
holds the same bits, and a sweep over R processes is bitwise the
one-process K-shard sweep.  :func:`ppermute` sends only the tensors that
cross a rank boundary.  The host decisions taken from replicated values (the
ESS gate, the exchange's choice) are then the same on every rank, as they
must be: a rank that branched differently would hang its collective.  A
chain mesh (:func:`chain_particle_mesh`) stays one process's.

The cross-card NCCL path is unverified: the machine it was built on has one
GPU, where one NCCL rank holds all K shards.
"""

from __future__ import annotations

from collections import Counter
from typing import Sequence, Union

import torch
import torch.distributed as dist

from .._device import resolve_device

__all__ = [
    "init_distributed",
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

    With ``spans_processes`` False (one controller) ``devices`` names all K
    shards.  With it True (a process group is up), ``devices`` names this
    rank's shards, one block of K / R of them for each of the R ranks, and
    ``local`` gives their global shard numbers.

    ``calls[kind]`` counts the collectives of each kind run on this mesh,
    ``elements[kind]`` the elements the local shards put into them and
    ``largest[kind]`` the most one shard put into one call; ``exchanges``
    counts the resampling firings of the sharded sweep by the exchange that
    ran (``"allgather"`` or ``"neighbor"``).  :meth:`reset_counts` sets all
    to zero.
    """

    def __init__(self, devices: Sequence[Device], spans_processes: bool = False):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        self.spans_processes = spans_processes
        self.rank, self.world = ((dist.get_rank(), dist.get_world_size()) if spans_processes
                                 else (0, 1))
        per_rank = len(self.devices)
        self.local = range(self.rank * per_rank, (self.rank + 1) * per_rank)
        self.reset_counts()

    @property
    def size(self) -> int:
        return len(self.devices) * self.world

    @property
    def shape(self) -> dict:
        return {PARTICLE_AXIS: self.size}

    def owner(self, shard: int) -> int:
        """The rank that holds global shard ``shard``."""
        return shard // len(self.devices)

    def reset_counts(self):
        self.calls = Counter()
        self.elements = Counter()
        self.largest = Counter()
        self.exchanges = Counter()

    def _count(self, kind: str, xs):
        if len(xs) != len(self.local):
            raise ValueError(f"{kind}: {len(xs)} tensors for {len(self.local)} local shards")
        sizes = [x.numel() for x in xs]
        self.calls[kind] += 1
        self.elements[kind] += sum(sizes)
        self.largest[kind] = max(self.largest[kind], max(sizes))

    def replicate(self, x: torch.Tensor) -> list:
        """``x`` on every local shard's device (the same tensor where it lies already)."""
        return [x.to(d) for d in self.devices]

    def _across_ranks(self, x: torch.Tensor) -> list:
        """``x`` of every rank, in rank order (the same shape on each)."""
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
        bufs = [torch.empty_like(wire) for _ in range(self.world)]
        dist.all_gather(bufs, wire)
        return [b.to(x.dtype) for b in bufs]

    def gathered(self, xs) -> list:
        """The K shards' tensors (one of each shard, the same shape), in
        shard order, on this rank: ``xs`` as they are in one process, the
        local ones of every rank gathered across a process group."""
        if not self.spans_processes:
            return list(xs)
        dev = self.devices[0]
        blocks = self._across_ranks(torch.stack([x.to(dev) for x in xs]))
        return [part for block in blocks for part in block.unbind(0)]

    def join(self, parts, dim: int = 0) -> torch.Tensor:
        """The local shards' ``parts`` joined in shard order along ``dim`` on
        the first local device; across processes, gathered so that every rank
        holds the whole (the counterpart of a replicated output)."""
        dev = self.devices[0]
        local = torch.cat([p.to(dev) for p in parts], dim)
        if not self.spans_processes:
            return local
        return torch.cat(self._across_ranks(local), dim)

    def __repr__(self):
        where = f", rank {self.rank} of {self.world}" if self.spans_processes else ""
        return f"ParticleMesh({[str(d) for d in self.devices]}{where})"


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


def _spans_processes() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_distributed(coordinator_address: str, num_processes: int, process_id: int,
                     local_device_ids=None, device=None) -> None:
    """Join this process, as rank ``process_id`` of ``num_processes``, into a
    process group started at ``coordinator_address`` (``host:port`` or
    ``tcp://host:port``), one rank per process.

    ``device`` None means the GPU: the rank takes the card
    ``local_device_ids[0]`` (default ``process_id`` modulo the cards it
    sees) as its current device and the backend is NCCL.  ``device="cpu"``
    makes a gloo group on the CPU.  Afterwards :func:`particle_mesh` builds
    meshes whose shards are split across the ranks, and the sharded sweeps
    run on them unchanged.  Cross-card NCCL is unverified: the port was
    built on a machine with one GPU, where it ran as one NCCL rank.
    """
    if _spans_processes():
        raise RuntimeError("a torch.distributed process group is already initialised")
    dev = resolve_device(device)
    if dev.type == "cuda":
        ids = list(local_device_ids) if local_device_ids is not None else [
            process_id % torch.cuda.device_count()]
        if len(ids) != 1:
            raise ValueError(f"one rank drives one card; got local_device_ids={ids}")
        torch.cuda.set_device(ids[0])
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    address = coordinator_address if "://" in coordinator_address else (
        f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=address, world_size=num_processes,
                            rank=process_id)


def particle_mesh(n_shards: int, device=None) -> ParticleMesh:
    """1-D mesh of ``n_shards`` shards on ``device`` (one device, repeated:
    ``n_shards`` logical shards on it; None means the GPU) or on a sequence
    of devices.

    Under a process group (:func:`init_distributed`) the shards are split in
    contiguous blocks across the R ranks: this rank's ``n_shards / R``
    shards lie on ``device`` (None: its current card) or on a sequence of
    that many devices."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if not _spans_processes():
        return ParticleMesh(_devices(n_shards, device))
    world = dist.get_world_size()
    if n_shards % world:
        raise ValueError(f"{n_shards} shards do not split evenly across {world} processes")
    if device is None or isinstance(device, (str, torch.device)):
        device = resolve_device(device)
        if device.type == "cuda" and device.index is None:  # the rank's own card
            device = torch.device("cuda", torch.cuda.current_device())
    return ParticleMesh(_devices(n_shards // world, device), spans_processes=True)


def chain_particle_mesh(n_chains: int, n_particle_shards: int, device=None) -> ChainParticleMesh:
    """2-D mesh: ``n_chains`` rows of ``n_particle_shards`` shards, on one
    device (None: the GPU) or on a sequence of ``n_chains · n_particle_shards`` devices in
    row order.  Its rows are this process's, under a process group too."""
    if n_chains < 1 or n_particle_shards < 1:
        raise ValueError("a chain mesh needs n_chains >= 1 and n_particle_shards >= 1")
    devices = _devices(n_chains * n_particle_shards, device)
    k = n_particle_shards
    return ChainParticleMesh([ParticleMesh(devices[i * k:(i + 1) * k]) for i in range(n_chains)])


def shard_along(mesh: ParticleMesh, x: torch.Tensor) -> list:
    """Split ``x`` along its leading axis into the mesh's K shards and keep
    the local ones, each on its shard's device (the counterpart of the JAX
    ``shard_along`` sharding)."""
    if x.shape[0] % mesh.size:
        raise ValueError(f"leading axis {x.shape[0]} not divisible by {mesh.size} shards")
    chunks = torch.chunk(x, mesh.size)
    return [chunks[k].to(d) for k, d in zip(mesh.local, mesh.devices)]


def _fold(mesh: ParticleMesh, kind: str, xs, op) -> list:
    mesh._count(kind, xs)
    parts = mesh.gathered(xs)
    acc = parts[0]
    for x in parts[1:]:
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
    parts = [x.to(dev) for x in mesh.gathered(xs)]
    return mesh.replicate(torch.cat(parts) if tiled else torch.stack(parts))


def ppermute(mesh: ParticleMesh, xs, shift: int) -> list:
    """Ring shift: shard ``k`` receives shard ``k − shift``'s tensor (``shift``
    1 from the left neighbour, −1 from the right), wrapping around.  Across
    processes only the tensors that cross a rank boundary travel, point to
    point; each rank's sends and receives are posted in the order of the
    receiving shard, so the two sides of every pair of ranks match."""
    mesh._count("ppermute", xs)
    k, lo = mesh.size, mesh.local.start
    out, ops = [None] * len(xs), []
    for g in sorted(mesh.local, key=lambda g: (g + shift) % k):
        dest = (g + shift) % k
        if mesh.owner(dest) != mesh.rank:
            ops.append(dist.P2POp(dist.isend, xs[g - lo].contiguous(), mesh.owner(dest)))
    for g in mesh.local:
        src = (g - shift) % k
        if mesh.owner(src) == mesh.rank:
            out[g - lo] = xs[src - lo].to(mesh.devices[g - lo])
        else:
            out[g - lo] = torch.empty_like(xs[g - lo])
            ops.append(dist.P2POp(dist.irecv, out[g - lo], mesh.owner(src)))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def axis_index(mesh: ParticleMesh) -> range:
    """Each local shard's index along the particle axis."""
    return mesh.local
