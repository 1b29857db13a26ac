"""Plain reference and frozen simulator of the ``lgssm`` configuration.

State ``x [C, N]``; prior ``N(0, sigma0)`` with ``sigma0 = q / sqrt(1 - a^2)``,
dynamics ``x_t = a x_{t-1} + q e_t``, score ``log N(y_t; x_t, r)``.  The
draws are the positional normals of :mod:`benchmark.reference.cipher`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import cipher

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def simulate(cfg) -> np.ndarray:
    """The observations ``y [T]`` (float32) from ``cfg["data_seed"]``."""
    a, q, r, T = cfg["a"], cfg["q"], cfg["r"], cfg["num_steps"]
    g = np.random.default_rng(cfg["data_seed"])
    x = g.normal(0.0, q / math.sqrt(1.0 - a * a))
    ys = np.empty(T)
    for t in range(T):
        if t:
            x = a * x + q * g.normal()
        ys[t] = x + r * g.normal()
    return ys.astype(np.float32)


def _score(cfg, x, y):
    z = (y - x) / cfg["r"]
    return -0.5 * z * z - (math.log(cfg["r"]) + _HALF_LOG_2PI)


def init(cfg, k, ids, y0, dtype):
    """``(state, logw)`` at step 0 under the key words ``k`` (each ``[C, 1]``)."""
    sigma0 = cfg["q"] / math.sqrt(1.0 - cfg["a"] ** 2)
    x = (sigma0 * cipher.normal_paired(k, ids)).to(dtype)
    return x, _score(cfg, x, y0)


def step(cfg, t, k, ids, x, y, dtype):
    x = cfg["a"] * x + cfg["q"] * cipher.normal_paired(k, ids).to(dtype)
    return x, _score(cfg, x, y)


def move(x, anc):
    """Rows ``anc [C, N]`` of ``x [C, N]``."""
    return torch.gather(x, 1, anc)


def step_work(cfg, n: int) -> dict:
    """The essential work of one particle-step for ``step_mfu``: the state
    read and written, the score written, the weight read and written and the
    ancestor written (4 bytes each), and half a cipher block (79 int32
    operations; the paired layout shares a block between two particles)."""
    return {"bytes": 4 * (2 + 1 + 2 + 1) * n, "flops": 0, "int_ops": 79 * n // 2}


def row_words(cfg) -> int:
    """32-bit words a resampling moves a particle."""
    return 1
