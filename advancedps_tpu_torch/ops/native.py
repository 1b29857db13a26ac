"""The native single-core C++ bootstrap sweep: the baseline of the benchmarks.

``cpp/resampling.cpp::aps_lgssm_sweep`` is a sequential bootstrap particle
filter for the scalar LGSSM (adaptive systematic resampling), the stand-in for
a compiled single-process sweep loop.  This module compiles that source with
``g++ -O2 -shared -fPIC`` into ``advancedps_tpu_torch/_build/`` (the file name
carries a hash of the source, so an edited source is rebuilt) and binds it with
ctypes.  A missing compiler or a failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np

from ._build import BUILD_DIR

__all__ = ["SOURCE", "N_BASELINE", "library", "lgssm_sweep", "native_baseline_rate"]

SOURCE = Path(__file__).resolve().parents[2] / "cpp" / "resampling.cpp"
GXX_FLAGS = ("-O2", "-shared", "-fPIC")
#: Particles of the baseline's sweeps: its throughput is linear in N.
N_BASELINE = 100_000

_F32P = ctypes.POINTER(ctypes.c_float)


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libaps_native_{h.hexdigest()[:16]}.so"


@functools.cache
def library() -> ctypes.CDLL:
    """The compiled baseline, built unless the library for the source's hash
    exists."""
    if not SOURCE.exists():
        raise RuntimeError(f"the native baseline's source {SOURCE} is missing")
    so = _library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = ["g++", *GXX_FLAGS, "-o", tmp, str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError:
            os.unlink(tmp)
            raise RuntimeError("g++ not found: the native baseline cannot be built") from None
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    lib = ctypes.CDLL(str(so))
    i64, f32 = ctypes.c_int64, ctypes.c_float
    lib.aps_lgssm_sweep.argtypes = [_F32P, _F32P, _F32P, _F32P, i64, i64, f32, f32, f32, f32, f32]
    lib.aps_lgssm_sweep.restype = ctypes.c_double
    return lib


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def lgssm_sweep(obs, init_noise, step_noise, res_uniforms, n: int, a: float, q: float,
                r: float, sigma0: float, ess_threshold: float = 0.5) -> float:
    """One sequential bootstrap sweep of ``n`` particles over ``obs [T]``;
    returns the log-evidence.  ``init_noise [n]`` and ``step_noise [(T−1)·n]``
    are standard normals, ``res_uniforms [T]`` the systematic offsets."""
    obs, init_noise, step_noise, res_uniforms = map(
        _f32, (obs, init_noise, step_noise, res_uniforms))
    T = obs.shape[0]
    if init_noise.size != n or step_noise.size != (T - 1) * n or res_uniforms.size != T:
        raise ValueError(
            f"noise sizes {init_noise.size}, {step_noise.size}, {res_uniforms.size} do not "
            f"fit n={n}, T={T}"
        )
    ptr = [x.ctypes.data_as(_F32P) for x in (obs, init_noise, step_noise, res_uniforms)]
    return float(library().aps_lgssm_sweep(*ptr, n, T, a, q, r, sigma0, ess_threshold))


def native_baseline_rate(ys, a: float, q: float, r: float, sigma0: float,
                         n: int = N_BASELINE) -> float:
    """Particle-steps/s of the native sweep over ``ys`` at ``n`` particles:
    the best of 3 runs, since one run on a shared host is noisy (±30%)."""
    ys = _f32(ys)
    T = ys.shape[0]
    rng = np.random.default_rng(0)
    init_noise = rng.standard_normal(n).astype(np.float32)
    step_noise = rng.standard_normal((T - 1) * n).astype(np.float32)
    res_u = rng.random(T).astype(np.float32)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        lgssm_sweep(ys, init_noise, step_noise, res_u, n, a, q, r, sigma0)
        best = min(best, time.perf_counter() - t0)
    return n * T / best
