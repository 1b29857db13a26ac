"""Positional Threefry-2x32: the fused draws of ``advancedps_tpu/rng.py``.

The JAX package's cipher is plain uint32 arithmetic that XLA fuses, with the
unit conversion and Box–Muller, into the step's kernel.  Here each draw is
one hand-written CUDA kernel from ``csrc/threefry.cu`` (built at first use by
:mod:`._build`):

* :func:`threefry2x32` — both cipher words of ``(k0, k1)`` at counter
  ``(c0, c1)``, as int64 values in ``[0, 2**32)``; ``stacked`` gives them as
  one ``[..., 2]`` tensor of keys (``rng.fold_in_ids``);
* :func:`pos_uniform` — ``rng.pos_uniform``, or ``pos_uniform_pair`` with
  ``pair=True``;
* :func:`pos_normal` — ``rng.pos_normal``, or ``pos_normal_pair`` with
  ``pair=True``;
* :func:`pos_normals` — ``rng.pos_normals``, ``[..., d]``.

Key words and counters are each a Python int or an int64 tensor, ids an
int32 or int64 tensor; tensors broadcast against each other, so a chain
batch's words ``[C, 1]`` against ids ``[N]`` give ``[C, N]`` in one launch.
Every tensor operand is read as its low 32 bits, the mask of
``rng._as_counter``.

Each wrapper takes its plain PyTorch version (``*_ref``, beside it, the int64
emulation the port ran before) only when its tensors lie on the CPU.  On a
CUDA tensor it launches the kernel or raises; nothing falls back.  Each counts
its launches in its ``launches`` attribute; :data:`KERNEL_WRAPPERS` holds them,
apart from the resampling kernels' tuple, whose counts are per firing.

Every wrapper is safe under :func:`torch.func.vmap`: a call with a batched
operand goes through an ``autograd.Function`` whose batching rule moves the
mapped dimension of each batched operand to the front of the output, so a
``vmap`` over C chains' key words (``engine._sweep_chains``) or over particle
keys (``random.py``'s samplers) is one launch for the whole batch, as JAX's
``vmap`` of the cipher is one fused kernel.  A call with none calls the entry
directly, without the Function's dispatch.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .resample import _on_cpu, _ptr, _raise_on, _stream

__all__ = [
    "threefry2x32",
    "threefry2x32_ref",
    "pos_uniform",
    "pos_uniform_ref",
    "pos_normal",
    "pos_normal_ref",
    "pos_normals",
    "pos_normals_ref",
    "ROUNDS",
    "MAX_DIMS",
    "KERNEL_WRAPPERS",
    "reset_launch_counts",
]

#: The rounds the kernels run (the JAX package's and Random123's default).
ROUNDS = 20
#: Dimensions of the output an operand may walk after the wrapper collapses
#: them (``aps_threefry_max_dims``).
MAX_DIMS = 6
#: Column pairs one launch of :func:`pos_normals` takes (the grid's second axis).
_MAX_PAIRS = 65535

_MASK = 0xFFFFFFFF
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)  # Threefry-2x32 rotation schedule
_PARITY = 0x1BD11BDA  # Skein/Threefry key-schedule parity constant
_TWO_PI = 2.0 * math.pi


# ---------------------------------------------------------------------------
# Plain versions: the cipher on int64 tensors masked to 32 bits
# ---------------------------------------------------------------------------


def _rotl(x, r):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32_ref(k0, k1, c0, c1, rounds: int = ROUNDS):
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


def _as_counter(ids: torch.Tensor) -> torch.Tensor:
    return ids.to(torch.int64) & _MASK


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 → float32 in [0, 1) with 24-bit resolution: ``(bits >> 8) · 2^-24``."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _uniform_pair_ref(k0, k1, ids, draw):
    c1 = _as_counter(ids)
    b0, b1 = threefry2x32_ref(k0, k1, torch.full_like(c1, int(draw) & _MASK), c1)
    return _bits_to_unit(b0), _bits_to_unit(b1)


def _normal_pair_ref(k0, k1, ids, draw):
    u1, u2 = _uniform_pair_ref(k0, k1, ids, draw)
    # 1 - u1 ∈ (0, 1]: the log argument is never 0.
    r = torch.sqrt(-2.0 * torch.log1p(-u1))
    theta = _TWO_PI * u2
    return r * torch.cos(theta), r * torch.sin(theta)


def _paired_layout(pair_fn, k0, k1, ids, draw):
    """Ids ``2p`` and ``2p + 1`` take the two values of the block at counter ``p``."""
    g = ids.to(torch.int64)
    v0, v1 = pair_fn(k0, k1, g >> 1, draw)
    return torch.where((g & 1) == 0, v0, v1)


def pos_uniform_ref(k0, k1, ids, draw: int = 0, pair: bool = False):
    """Plain :func:`pos_uniform`."""
    if pair:
        return _uniform_pair_ref(k0, k1, ids, draw)
    return _paired_layout(_uniform_pair_ref, k0, k1, ids, draw)


def pos_normal_ref(k0, k1, ids, draw: int = 0, pair: bool = False):
    """Plain :func:`pos_normal`."""
    if pair:
        return _normal_pair_ref(k0, k1, ids, draw)
    return _paired_layout(_normal_pair_ref, k0, k1, ids, draw)


def pos_normals_ref(k0, k1, ids, d: int, draw0: int = 0):
    """Plain :func:`pos_normals`."""
    cols = []
    for j in range(0, d, 2):
        z0, z1 = _normal_pair_ref(k0, k1, ids, draw0 + j // 2)
        cols.append(z0)
        if j + 1 < d:
            cols.append(z1)
    return torch.stack(cols, dim=-1)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check_word(x, name: str):
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.int64:
            raise TypeError(f"{name} must be int64, got {x.dtype}")
    elif not isinstance(x, int):
        raise TypeError(f"{name} must be an int or an int64 tensor, got {type(x).__name__}")


def _check_ids(ids):
    if not isinstance(ids, torch.Tensor):
        raise TypeError(f"ids must be a tensor, got {type(ids).__name__}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"ids must be int32 or int64, got {ids.dtype}")


def _check_int(x, name: str):
    if not isinstance(x, int):
        raise TypeError(f"{name} must be an int, got {type(x).__name__}")


def _geometry(shape, operands):
    """The flat geometry of ``csrc/threefry.cu`` (``[ndim, sizes, each
    operand's strides]``) for an output of ``shape``: dimensions of size 1
    dropped, neighbours that every tensor operand walks contiguously merged."""
    strides = [(0,) * len(shape) if not isinstance(o, torch.Tensor)
               else o.stride() if o.shape == shape else o.expand(shape).stride()
               for o in operands]
    dims = [(size, [s[d] for s in strides]) for d, size in enumerate(shape) if size != 1]
    merged = []
    for size, strides in dims:
        if merged:
            outer, outer_strides = merged[-1]
            if all(s_out == s * size for s_out, s in zip(outer_strides, strides)):
                merged[-1] = (outer * size, strides)
                continue
        merged.append((size, strides))
    merged = merged or [(1, [0] * len(operands))]
    if len(merged) > MAX_DIMS:
        raise ValueError(f"the operands walk {len(merged)} dimensions of the output "
                         f"{tuple(shape)}, the kernels at most {MAX_DIMS}")
    flat = [len(merged), *(size for size, _ in merged),
            *(strides[k] for k in range(len(operands)) for _, strides in merged)]
    return (ctypes.c_int64 * len(flat))(*flat)


def _operand(x):
    """An operand's pointer and scalar value, as the C entries take them."""
    if isinstance(x, torch.Tensor):
        return _ptr(x), 0
    return None, int(x) & _MASK


def _batched(*operands) -> bool:
    """Whether an operand is a functorch-wrapped tensor (a ``vmap``'s batched
    one), which only the Functions' batching rules can read."""
    return any(isinstance(x, torch.Tensor) and torch._C._functorch.is_functorch_wrapped_tensor(x)
               for x in operands)


def _launch(entry: str, wrapper, device, n: int, geom, *args):
    lib = _build.library()
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(n, geom, *args, _stream(device))
    _raise_on(rc, entry[4:])
    wrapper.launches += 1


def _front(in_dims, args):
    """The batched operands of a ``vmap`` rule with their mapped dimension
    moved to the front and a 1 inserted for every dimension they lack of the
    unbatched output, so that everything broadcasts to ``[B, *output]``."""
    logical = [a.shape if d is None else a.shape[:d] + a.shape[d + 1:]
               for a, d in zip(args, in_dims) if isinstance(a, torch.Tensor)]
    rank = len(torch.broadcast_shapes(*logical))
    out = []
    for a, d in zip(args, in_dims):
        if d is not None:
            a = a.movedim(d, 0)
            a = a[(slice(None),) + (None,) * (rank - a.dim() + 1)]
        out.append(a)
    return out


def _shape(tensors) -> torch.Size:
    """The broadcast shape of ``tensors`` (one tensor's own, without the
    broadcast's host cost)."""
    return tensors[0].shape if len(tensors) == 1 else torch.broadcast_shapes(
        *(t.shape for t in tensors))


def _threefry(k0, k1, c0, c1, stacked: bool):
    tensors = [x for x in (k0, k1, c0, c1) if isinstance(x, torch.Tensor)]
    if _on_cpu(*tensors):
        b0, b1 = threefry2x32_ref(k0, k1, c0, c1)
        return torch.stack([b0, b1], dim=-1) if stacked else (b0, b1)
    shape = _shape(tensors)
    out = torch.empty(shape + (2,) if stacked else (2,) + shape, dtype=torch.int64,
                      device=tensors[0].device)
    n = math.prod(shape)
    if n:
        operands = (k0, k1, c0, c1)
        _launch("aps_threefry2x32", threefry2x32, out.device, n,
                _geometry(shape, operands), *(v for o in operands for v in _operand(o)),
                int(stacked), _ptr(out))
    return out if stacked else (out[0], out[1])


class _Threefry(torch.autograd.Function):
    @staticmethod
    def forward(k0, k1, c0, c1, stacked):
        return _threefry(k0, k1, c0, c1, stacked)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, k0, k1, c0, c1, stacked):
        out = _threefry_call(*_front(in_dims[:4], (k0, k1, c0, c1)), stacked)
        return out, (0 if stacked else (0, 0))


def _threefry_call(k0, k1, c0, c1, stacked: bool):
    if _batched(k0, k1, c0, c1):
        return _Threefry.apply(k0, k1, c0, c1, stacked)
    return _threefry(k0, k1, c0, c1, stacked)


def threefry2x32(k0, k1, c0, c1, rounds: int = ROUNDS, stacked: bool = False):
    """Threefry-2x32 of key words ``(k0, k1)`` at counter ``(c0, c1)``: each
    a Python int or an int64 tensor, at least one a tensor; the tensors
    broadcast.  Returns the two words as int64 tensors of values in
    ``[0, 2**32)``, or with ``stacked`` one tensor ``[..., 2]``.  One launch
    on the card (``aps_threefry2x32``)."""
    if rounds != ROUNDS:
        raise ValueError(f"the kernel runs {ROUNDS} rounds, got rounds={rounds}")
    for name, x in (("k0", k0), ("k1", k1), ("c0", c0), ("c1", c1)):
        _check_word(x, name)
    if not any(isinstance(x, torch.Tensor) for x in (k0, k1, c0, c1)):
        raise TypeError("threefry2x32 needs a tensor operand; host words take threefry2x32_ref")
    return _threefry_call(k0, k1, c0, c1, bool(stacked))


def _positional(kind: str, k0, k1, ids, draw: int, pair: bool):
    ref, wrapper, entry = {"uniform": (pos_uniform_ref, pos_uniform, "aps_pos_uniform"),
                           "normal": (pos_normal_ref, pos_normal, "aps_pos_normal")}[kind]
    tensors = [x for x in (k0, k1, ids) if isinstance(x, torch.Tensor)]
    if _on_cpu(*tensors):
        return ref(k0, k1, ids, draw, pair)
    shape = _shape(tensors)
    out = torch.empty((2,) + shape if pair else shape, dtype=torch.float32, device=ids.device)
    n = math.prod(shape)
    if n:
        _launch(entry, wrapper, out.device, n, _geometry(shape, (k0, k1, ids)),
                *_operand(k0), *_operand(k1), _ptr(ids), int(ids.dtype == torch.int64),
                int(draw) & _MASK, int(pair), _ptr(out))
    return (out[0], out[1]) if pair else out


class _Positional(torch.autograd.Function):
    @staticmethod
    def forward(kind, k0, k1, ids, draw, pair):
        return _positional(kind, k0, k1, ids, draw, pair)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, kind, k0, k1, ids, draw, pair):
        out = _positional_call(kind, *_front(in_dims[1:4], (k0, k1, ids)), draw, pair)
        return out, ((0, 0) if pair else 0)


def _positional_call(kind: str, k0, k1, ids, draw: int, pair: bool):
    if _batched(k0, k1, ids):
        return _Positional.apply(kind, k0, k1, ids, draw, pair)
    return _positional(kind, k0, k1, ids, draw, pair)


def _check_positional(k0, k1, ids, draw):
    _check_word(k0, "k0")
    _check_word(k1, "k1")
    _check_ids(ids)
    _check_int(draw, "draw")


def pos_uniform(k0, k1, ids, draw: int = 0, pair: bool = False):
    """U[0, 1) float32 draws, element ``i`` a pure function of the key words,
    ``draw`` and ``ids[i]``.  By default the paired layout of
    ``rng.pos_uniform`` (ids ``2p`` and ``2p + 1`` take the two words of the
    block at counter ``(draw, p)``); with ``pair``, both words of the block at
    ``(draw, ids[i])`` as two tensors (``rng.pos_uniform_pair``).  The key
    words broadcast against ``ids``.  One launch on the card
    (``aps_pos_uniform``)."""
    _check_positional(k0, k1, ids, draw)
    return _positional_call("uniform", k0, k1, ids, draw, bool(pair))


def pos_normal(k0, k1, ids, draw: int = 0, pair: bool = False):
    """N(0, 1) float32 draws by Box–Muller on the blocks :func:`pos_uniform`
    reads: the paired layout of ``rng.pos_normal`` by default, both outputs of
    each id's block with ``pair`` (``rng.pos_normal_pair``).  One launch on
    the card (``aps_pos_normal``)."""
    _check_positional(k0, k1, ids, draw)
    return _positional_call("normal", k0, k1, ids, draw, bool(pair))


def _normals(k0, k1, ids, d, draw0):
    tensors = [x for x in (k0, k1, ids) if isinstance(x, torch.Tensor)]
    if _on_cpu(*tensors):
        return pos_normals_ref(k0, k1, ids, d, draw0)
    shape = _shape(tensors)
    out = torch.empty(shape + (d,), dtype=torch.float32, device=ids.device)
    n = math.prod(shape)
    if n:
        _launch("aps_pos_normals", pos_normals, out.device, n,
                _geometry(shape, (k0, k1, ids)), *_operand(k0), *_operand(k1), _ptr(ids),
                int(ids.dtype == torch.int64), d, int(draw0) & _MASK, _ptr(out))
    return out


class _Normals(torch.autograd.Function):
    @staticmethod
    def forward(k0, k1, ids, d, draw0):
        return _normals(k0, k1, ids, d, draw0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, k0, k1, ids, d, draw0):
        return _normals_call(*_front(in_dims[:3], (k0, k1, ids)), d, draw0), 0


def _normals_call(k0, k1, ids, d: int, draw0: int):
    if _batched(k0, k1, ids):
        return _Normals.apply(k0, k1, ids, d, draw0)
    return _normals(k0, k1, ids, d, draw0)


def pos_normals(k0, k1, ids, d: int, draw0: int = 0):
    """``[..., d]`` N(0, 1) float32 draws (``rng.pos_normals``): element
    ``(i, j)`` from the block at counter ``(draw0 + j // 2, ids[i])``,
    columns ``2p`` and ``2p + 1`` its two Box–Muller outputs.  One launch on
    the card (``aps_pos_normals``)."""
    _check_positional(k0, k1, ids, draw0)
    _check_int(d, "d")
    if not 1 <= d <= 2 * _MAX_PAIRS:
        raise ValueError(f"d must be in [1, {2 * _MAX_PAIRS}], got {d}")
    return _normals_call(k0, k1, ids, d, draw0)


#: Every wrapper that launches a kernel, each with its ``launches`` count.
KERNEL_WRAPPERS = (threefry2x32, pos_uniform, pos_normal, pos_normals)


def reset_launch_counts():
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


reset_launch_counts()
