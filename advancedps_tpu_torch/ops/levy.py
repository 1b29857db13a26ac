"""The Lévy dynamics' jump path, its mean and covariance, as one CUDA kernel.

:meth:`~advancedps_tpu_torch.models.levy.LevyLangevinDynamics._meancov` takes
:func:`meancov` where the path key lies on a CUDA device: one launch of
``aps_levy_meancov`` (``csrc/levy.cu``, built at first use by :mod:`._build`)
computes each key's Gamma-process path (arrivals, sizes, thinning, times),
its mean ``[2]`` and its covariance ``[2, 2]`` in registers and shared
memory, in place of the plain chain's ~100 PyTorch launches over ``[N, K]``.
On any other device the model keeps that chain
(``LevyLangevinDynamics._meancov_plain``): it is the plain version the CPU
tests hold against the JAX package, and the kernel is bitwise it on the card.

The kernel reproduces PyTorch's order of summation for the arrivals' cumsum,
which depends on how many rows the chain's ``[rows, K]`` tensor has: the
rows are the keys of the call (all ``vmap`` levels together), and
:func:`scan_chunk` gives the order.  The wrapper counts its launches in
``meancov.launches``.

Safe under :func:`torch.func.vmap`: a batched key goes through an
``autograd.Function`` whose batching rule runs every key of the batch (over
particles, and over chains of that) in one launch; a call with none
launches directly.  The model's parameters must not be batched.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .resample import _ptr, _raise_on, _stream
from .threefry import _batched

__all__ = ["meancov", "scan_chunk", "MAX_JUMPS", "KERNEL_WRAPPERS", "reset_launch_counts"]

#: Candidates a path may hold in the kernel (``aps_levy_max_jumps``).
MAX_JUMPS = 64
_MASK = 0xFFFFFFFF


def scan_chunk(rows: int, row_size: int) -> int:
    """The columns of one chunk of PyTorch's cumsum over the last dimension of
    ``rows`` rows of ``row_size`` (``tensor_kernel_scan_innermost_dim``):
    ``2 << get_log_num_threads_x_inner_scan(rows, row_size)``, whose
    arithmetic is uint32's; 0 for a single row, which PyTorch scans with CUB."""
    if rows == 1:
        return 0
    log_x = (row_size - 1).bit_length()
    log_y = (rows - 1).bit_length()
    log_x = (((log_x - log_y) & _MASK) + 9) & _MASK
    return 2 << min(max(4, log_x // 2), 9)


def _check(key, params, step, jumps, tol, jitter):
    if not isinstance(key, torch.Tensor) or key.dtype != torch.int64:
        raise TypeError(f"the path keys must be an int64 tensor, got "
                        f"{getattr(key, 'dtype', type(key).__name__)}")
    if key.dim() < 1 or key.shape[-1] != 2:
        raise ValueError(f"the path keys must be [..., 2] words, got {tuple(key.shape)}")
    for name, p in params.items():
        if not isinstance(p, torch.Tensor) or p.dtype != torch.float32 or p.numel() != 1:
            raise TypeError(f"{name} must be a float32 tensor of one value, got "
                            f"{getattr(p, 'dtype', type(p).__name__)} "
                            f"{tuple(getattr(p, 'shape', ()))}")
    if not isinstance(step, int) or isinstance(step, bool):
        raise TypeError(f"step must be an int, got {type(step).__name__}")
    if not isinstance(jumps, int) or not 1 <= jumps <= MAX_JUMPS:
        raise ValueError(f"the kernel holds 1 to {MAX_JUMPS} candidate jumps, got {jumps}")
    for name, v in (("tol", tol), ("jitter", jitter)):
        if not isinstance(v, float):
            raise TypeError(f"{name} must be a float, got {type(v).__name__}")
    devices = {key.device, *(p.device for p in params.values())}
    if len(devices) != 1 or key.device.type != "cuda":
        raise ValueError(f"the kernel runs on one CUDA device, got {sorted(map(str, devices))}")


def _meancov(key, step, dt, theta, c, beta, mu_w, sigma_w, tol, jitter, jumps):
    batch = key.shape[:-1]
    rows = math.prod(batch)
    mu = torch.empty(batch + (2,), dtype=torch.float32, device=key.device)
    cov = torch.empty(batch + (2, 2), dtype=torch.float32, device=key.device)
    if rows == 0:
        return mu, cov
    if rows >= 1 << 31:
        raise ValueError(f"{rows} path keys: the kernel takes fewer than 2**31")
    flat = key.reshape(rows, 2)
    lib = _build.library()
    with torch.cuda.device(key.device):
        rc = lib.aps_levy_meancov(
            rows, _ptr(flat), flat.stride(0), flat.stride(1),
            *(_ptr(p) for p in (dt, theta, c, beta, mu_w, sigma_w)),
            step, jumps, ctypes.c_float(tol), ctypes.c_float(jitter),
            scan_chunk(rows, jumps), _ptr(mu), _ptr(cov), _stream(key.device))
    _raise_on(rc, "levy_meancov")
    meancov.launches += 1
    return mu, cov


class _MeanCov(torch.autograd.Function):
    @staticmethod
    def forward(key, step, dt, theta, c, beta, mu_w, sigma_w, tol, jitter, jumps):
        return _meancov(key, step, dt, theta, c, beta, mu_w, sigma_w, tol, jitter, jumps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, key, *rest):
        if any(d is not None for d in in_dims[1:]):
            raise ValueError("the Lévy kernel takes a batch of keys, not of the model's "
                             "parameters")
        return _meancov_call(key.movedim(in_dims[0], 0), *rest), (0, 0)


def _meancov_call(key, *rest):
    if _batched(key):
        return _MeanCov.apply(key, *rest)
    return _meancov(key, *rest)


def meancov(key, step: int, dt, theta, c, beta, mu_w, sigma_w, tol: float, jitter: float,
            jumps: int):
    """``(mu [..., 2], cov [..., 2, 2])`` of the jump path of each path key
    ``key [..., 2]`` (int64 words on a CUDA device) at ``step``: the Gamma
    process ``(c, beta)`` with ``jumps`` candidates and truncation ``tol``
    over ``[(step − 1) dt, step dt)``, the Langevin drift ``theta`` and the
    marks' ``mu_w``, ``sigma_w``, ``jitter`` on the covariance's diagonal.
    The parameters are float32 tensors of one value on the keys' device, read
    there by the kernel.  One launch (``aps_levy_meancov``)."""
    params = {"dt": dt, "theta": theta, "c": c, "beta": beta, "mu_w": mu_w, "sigma_w": sigma_w}
    _check(key, params, step, jumps, tol, jitter)
    return _meancov_call(key, step, dt, theta, c, beta, mu_w, sigma_w, tol, jitter, jumps)


#: Every wrapper that launches a kernel, each with its ``launches`` count.
KERNEL_WRAPPERS = (meancov,)


def reset_launch_counts():
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


reset_launch_counts()
