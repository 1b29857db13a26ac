"""Systematic-resampling kernels: the counterpart of ``advancedps_tpu/ops/pallas_resample.py``.

Three kernels carry the resampling step of the bootstrap sweep:

* B1 :func:`extents_from_logw` — log-weights to nondecreasing int32 extents
  ``f_j = clip(ceil(n·cumsum(exp(logw − m))/s1 − u), 0, n)``;
* B2 :func:`decode_ancestors` — extents to ancestors
  ``anc[k] = #{j : f_j ≤ k}``;
* B3 :func:`resample_move` — particle rows moved by ancestor, bitwise, with
  slots past the drawn population set to 0.

Each wrapper takes its plain PyTorch version (``*_ref``, beside it) only when
its tensors lie on the CPU.  On a CUDA tensor it launches the hand-written
kernel from ``csrc/resample.cu`` (built at first use by :mod:`._build`) or
raises; nothing falls back.  Each wrapper counts its kernel launches in its
``launches`` attribute.  The kernels' design notes are in the CUDA source.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

__all__ = [
    "extents_from_logw",
    "extents_from_logw_ref",
    "decode_ancestors",
    "decode_ancestors_ref",
    "resample_move",
    "resample_move_ref",
    "reset_launch_counts",
]

#: Extents are computed in float32; larger counts are not exact there.
MAX_N = 1 << 24


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def extents_from_logw_ref(logw, m, s1, u: float, n: int) -> torch.Tensor:
    """``cummax(clip(ceil(n·(prefix·(1/s1)) − u), 0, n))`` in float32, with
    ``prefix = cumsum(exp(logw − m))`` summed in float64 and rounded once."""
    inv_s1 = 1.0 / s1
    prefix = torch.cumsum(torch.exp(logw - m), 0, dtype=torch.float64).to(torch.float32)
    cdf = prefix * inv_s1
    f = torch.clamp(torch.ceil(n * cdf - u), 0, n).to(torch.int32)
    return torch.cummax(f, 0).values


def decode_ancestors_ref(f, n_out: int, guard: Optional[int] = None) -> torch.Tensor:
    """``searchsorted(f, arange(n_out), right=True)`` with ``f[-1]`` read as
    ``guard`` (``n_out`` if not given); ``f`` itself is not written."""
    last = torch.full((1,), n_out if guard is None else guard, dtype=f.dtype, device=f.device)
    f_guarded = torch.cat([f[:-1], last])
    k = torch.arange(n_out, dtype=f.dtype, device=f.device)
    return torch.searchsorted(f_guarded, k, right=True).to(torch.int32)


def resample_move_ref(anc, v):
    """``(min(anc, M−1), v[anc])`` with rows of slots where ``anc == M`` set to 0."""
    m = v.shape[0]
    anc_clipped = torch.clamp(anc, max=m - 1)
    moved = v[anc_clipped.long()]
    past = (anc >= m).reshape((-1,) + (1,) * (v.dim() - 1))
    moved = torch.where(past, torch.zeros((), dtype=v.dtype, device=v.device), moved)
    return anc_clipped, moved


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndims=(1,)):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() not in ndims:
        raise ValueError(f"{name} must have {' or '.join(map(str, ndims))} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors, False for CUDA tensors on one device; raises on
    anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors lie on different devices: {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(rc: int, what: str):
    if rc != 0:
        msg = _build.library().aps_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def extents_from_logw(logw, m, s1, u: float, n: int) -> torch.Tensor:
    """B1: systematic extents straight from unnormalised log-weights.

    ``m`` = max(logw) and ``s1`` = Σ exp(logw − m) are float32 scalars on
    ``logw``'s device (the sweep's reduction already has both); ``u`` is the
    stratum offset and ``n`` the number of positions drawn.  Returns int32
    ``[M]``, nondecreasing bitwise.  The prefix is summed in double and rounded
    to float32 once, as in the plain version; the two may still differ by ±1
    where double rounding straddles a float32 rounding boundary.
    """
    _check(logw, "logw", torch.float32)
    for name, s in (("m", m), ("s1", s1)):
        _check(s, name, torch.float32, ndims=(0,))
    if not 0 <= n < MAX_N:
        raise ValueError(f"n must be in [0, 2**24), got {n}")
    if _on_cpu(logw, m, s1):
        return extents_from_logw_ref(logw, m, s1, u, n)
    f = torch.empty(logw.shape, dtype=torch.int32, device=logw.device)
    if logw.numel() == 0:
        return f
    lib = _build.library()
    ntiles = -(-logw.numel() // lib.aps_extents_tile_size())
    dscratch = torch.empty(2 * ntiles, dtype=torch.float64, device=logw.device)
    iscratch = torch.empty(2 * ntiles, dtype=torch.int32, device=logw.device)
    with torch.cuda.device(logw.device):
        rc = lib.aps_extents_from_logw(
            _ptr(logw), logw.numel(), _ptr(m), _ptr(s1), float(u), int(n),
            _ptr(dscratch), _ptr(iscratch), _ptr(f), _stream(logw.device),
        )
    _raise_on(rc, "extents_from_logw")
    extents_from_logw.launches += 1
    return f


def decode_ancestors(f, n_out: int, guard: Optional[int] = None) -> torch.Tensor:
    """B2: ``anc[k] = #{j : f_j ≤ k}`` for ``k < n_out`` — int32 in ``[0, M]``.

    ``f`` is nondecreasing int32 ``[M]``; its last entry is read as ``guard``
    (``n_out`` if not given), which covers float undershoot of the last
    extent and, with ``guard < n_out``, leaves the slots from ``guard`` on
    past the drawn population (``anc == M``).
    """
    _check(f, "f", torch.int32)
    if f.numel() == 0:
        raise ValueError("f must not be empty")
    if _on_cpu(f):
        return decode_ancestors_ref(f, n_out, guard)
    anc = torch.empty(n_out, dtype=torch.int32, device=f.device)
    if n_out == 0:
        return anc
    lib = _build.library()
    with torch.cuda.device(f.device):
        rc = lib.aps_decode_ancestors(
            _ptr(f), f.numel(), int(n_out if guard is None else guard), int(n_out),
            _ptr(anc), _stream(f.device),
        )
    _raise_on(rc, "decode_ancestors")
    decode_ancestors.launches += 1
    return anc


def resample_move(anc, v):
    """B3: move particle rows by ancestor.

    ``anc`` int32 ``[n]`` with values in ``[0, M]``; ``v`` float32 ``[M]`` or
    ``[M, D]``, contiguous.  Returns ``(anc clipped to M−1, moved)`` where
    ``moved[k]`` is a bitwise copy of ``v[anc[k]]``, or 0 where
    ``anc[k] == M``.
    """
    _check(anc, "anc", torch.int32)
    _check(v, "v", torch.float32, ndims=(1, 2))
    if v.shape[0] == 0:
        raise ValueError("v must hold at least one row")
    if _on_cpu(anc, v):
        return resample_move_ref(anc, v)
    n_out = anc.shape[0]
    out = torch.empty((n_out,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
    anc_clipped = torch.empty_like(anc)
    if n_out == 0:
        return anc_clipped, out
    d = 1 if v.dim() == 1 else v.shape[1]
    lib = _build.library()
    with torch.cuda.device(v.device):
        rc = lib.aps_move_rows(
            _ptr(anc), n_out, v.shape[0], _ptr(v), d, _ptr(out), _ptr(anc_clipped),
            _stream(v.device),
        )
    _raise_on(rc, "resample_move")
    resample_move.launches += 1
    return anc_clipped, out


KERNEL_WRAPPERS = (extents_from_logw, decode_ancestors, resample_move)


def reset_launch_counts():
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


reset_launch_counts()
