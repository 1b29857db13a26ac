"""Resampling kernels: the counterpart of ``advancedps_tpu/ops/pallas_resample.py``.

Systematic resampling runs three kernels per firing:

* B1 :func:`extents_from_logw` — log-weights to nondecreasing int32 extents
  ``f_j = clip(ceil(n·cumsum(exp(logw − m))/s1 − u), 0, n)``;
* B2 :func:`decode_ancestors` — extents to ancestors
  ``anc[k] = #{j : f_j ≤ k}``;
* B3 :func:`resample_move` — particle rows moved by ancestor, bitwise, with
  slots past the drawn population set to 0.

Stratified and multinomial resampling reach the same B2/B3 through extents
built from two more primitives:

* B6 :func:`scaled_prefix_from_logw` and :func:`prefix_sum` — the float32
  scaled prefix ``(Σ_{i≤j} e_i)·scale`` with ``e = exp(x − m)`` or ``x``,
  bitwise nondecreasing;
* B7 :func:`count_le_sorted_bs` and B8 :func:`count_le_sorted` — the sorted
  merge-count ``out[j] = #{k : s_k ≤ t_j}``, by binary search and by merge
  path; :func:`count_le_sorted_auto` picks one (:data:`COUNT_LE_SORTED`).

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
    "scaled_prefix_from_logw",
    "prefix_sum",
    "scaled_prefix_ref",
    "count_le_sorted_bs",
    "count_le_sorted",
    "count_le_sorted_ref",
    "count_le_sorted_auto",
    "COUNT_LE_SORTED",
    "KERNEL_WRAPPERS",
    "reset_launch_counts",
]

#: Extents are computed in float32; larger counts are not exact there.
MAX_N = 1 << 24

#: Which merge-count :func:`count_le_sorted_auto` runs: ``"bs"`` (B7, binary
#: search; the default, as in the JAX package) or ``"merge"`` (B8, merge
#: path).  The JAX package chooses by the ``APS_DECODE`` environment variable;
#: here it is set in code.
COUNT_LE_SORTED = "bs"


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


def scaled_prefix_ref(x, m, scale, use_exp: bool) -> torch.Tensor:
    """``cummax(fl32(cumsum(e)) · scale)`` with ``e = exp(x − m)`` (float32)
    or ``x``, the prefix summed in float64 and rounded once; ``scale`` None
    means 1.  For nonnegative summands the running max changes nothing."""
    e = torch.exp(x - m) if use_exp else x
    p = torch.cumsum(e, 0, dtype=torch.float64).to(torch.float32)
    if scale is not None:
        p = p * scale
    return torch.cummax(p, 0).values


def count_le_sorted_ref(s, t) -> torch.Tensor:
    """``#{k : s_k ≤ t_j}`` for each ``t_j``: ``searchsorted(s, t, right=True)``."""
    return torch.searchsorted(s, t, right=True).to(torch.int32)


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
    ntiles = -(-logw.numel() // lib.aps_prefix_tile_size())
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


def _scaled_prefix(wrapper, x, m, scale, use_exp: bool) -> torch.Tensor:
    """B6 on ``x``'s device: the plain version on the CPU, else the kernel,
    counted on ``wrapper``."""
    tensors = (x,) + tuple(s for s in (m, scale) if s is not None)
    if _on_cpu(*tensors):
        return scaled_prefix_ref(x, m, scale, use_exp)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _build.library()
    ntiles = -(-x.numel() // lib.aps_prefix_tile_size())
    dscratch = torch.empty(2 * ntiles, dtype=torch.float64, device=x.device)
    fscratch = torch.empty(2 * ntiles, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.aps_scaled_prefix(
            _ptr(x), x.numel(), int(use_exp), _ptr(m) if use_exp else None,
            _ptr(scale) if scale is not None else None,
            _ptr(dscratch), _ptr(fscratch), _ptr(out), _stream(x.device),
        )
    _raise_on(rc, wrapper.__name__)
    wrapper.launches += 1
    return out


def scaled_prefix_from_logw(logw, m, scale) -> torch.Tensor:
    """B6: ``(Σ_{i≤j} exp(logw_i − m)) · scale`` as float32 ``[M]``, bitwise
    nondecreasing.

    ``m`` (max of ``logw``) and ``scale`` are float32 scalars on ``logw``'s
    device: ``n/s1`` gives stratified's ``c = n·cdf``, ``S_n/s1`` gives
    multinomial's merge thresholds.  The prefix is summed in double and
    rounded to float32 once, then multiplied by ``scale``, as in the plain
    version; the two may differ by an ulp where double rounding straddles a
    float32 rounding boundary.
    """
    _check(logw, "logw", torch.float32)
    for name, s in (("m", m), ("scale", scale)):
        _check(s, name, torch.float32, ndims=(0,))
    return _scaled_prefix(scaled_prefix_from_logw, logw, m, scale, use_exp=True)


def prefix_sum(x) -> torch.Tensor:
    """B6 without the exponential or the scale: the inclusive prefix sum of
    float32 ``x``, summed in double and rounded once, bitwise nondecreasing
    (for inputs with negative entries, the running max of the prefix, as in
    the TPU kernel)."""
    _check(x, "x", torch.float32)
    return _scaled_prefix(prefix_sum, x, None, None, use_exp=False)


def _count_le(wrapper, kernel_name: str, s, t) -> torch.Tensor:
    """B7/B8: the plain version on the CPU, else the named kernel, counted on
    ``wrapper``."""
    _check(s, "s", torch.float32)
    _check(t, "t", torch.float32)
    if s.numel() >= 1 << 31:
        raise ValueError(f"s must hold fewer than 2**31 values, got {s.numel()}")
    if _on_cpu(s, t):
        return count_le_sorted_ref(s, t)
    out = torch.empty(t.shape, dtype=torch.int32, device=t.device)
    if t.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(t.device):
        rc = getattr(lib, kernel_name)(
            _ptr(s), s.numel(), _ptr(t), t.numel(), _ptr(out), _stream(t.device)
        )
    _raise_on(rc, wrapper.__name__)
    wrapper.launches += 1
    return out


def count_le_sorted_bs(s, t) -> torch.Tensor:
    """B7: ``out[j] = #{k : s_k ≤ t_j}`` as int32, one binary search over the
    nondecreasing float32 ``s`` per threshold ``t_j``."""
    return _count_le(count_le_sorted_bs, "aps_count_le_sorted_bs", s, t)


def count_le_sorted(s, t) -> torch.Tensor:
    """B8: the same counts as :func:`count_le_sorted_bs` by a merge path over
    ``s`` and ``t``, both nondecreasing: equal tiles of the merged order,
    balanced under any skew of the thresholds."""
    return _count_le(count_le_sorted, "aps_count_le_sorted", s, t)


def count_le_sorted_auto(s, t) -> torch.Tensor:
    """The merge-count the sweep uses: B7 unless :data:`COUNT_LE_SORTED` is
    ``"merge"``."""
    if COUNT_LE_SORTED not in ("bs", "merge"):
        raise ValueError(f"COUNT_LE_SORTED must be 'bs' or 'merge', got {COUNT_LE_SORTED!r}")
    return (count_le_sorted if COUNT_LE_SORTED == "merge" else count_le_sorted_bs)(s, t)


#: Every wrapper that launches a kernel, each with its ``launches`` count.
KERNEL_WRAPPERS = (
    extents_from_logw, decode_ancestors, resample_move,
    scaled_prefix_from_logw, prefix_sum, count_le_sorted_bs, count_le_sorted,
)


def reset_launch_counts():
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


reset_launch_counts()
