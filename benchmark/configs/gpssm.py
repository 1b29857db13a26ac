"""Plain reference and frozen simulator of the ``gpssm`` configuration.

State ``(x [C, N], history [C, N, T])``.  Step ``t`` draws ``x_t`` from the
posterior of a zero-mean GP over the time indices ``0 .. t-1`` (kernel
``variance * exp(-(i - j)^2 / (2 lengthscale^2))`` plus ``jitter`` on the
diagonal), the observation scores ``log N(y_t; 0, exp(x_t / 2))``.  The
regression is written over the active block ``0 .. t-1`` alone.  Step 0
draws the prior with positional normals; step ``t`` draws each particle
with its own key ``fold_in(step key, id)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import cipher

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _kernel(cfg, a, b):
    d = (a[:, None] - b[None, :]) / cfg["lengthscale"]
    return cfg["variance"] * np.exp(-0.5 * d * d) if isinstance(a, np.ndarray) else \
        cfg["variance"] * torch.exp(-0.5 * d * d)


def simulate(cfg) -> np.ndarray:
    """The observations ``y [T]`` (float32) from ``cfg["data_seed"]``, the GP
    path drawn in float64."""
    T = cfg["num_steps"]
    g = np.random.default_rng(cfg["data_seed"])
    xs = np.empty(T)
    xs[0] = cfg["prior_sigma"] * g.normal()
    for t in range(1, T):
        past = np.arange(t, dtype=np.float64)
        K = _kernel(cfg, past, past) + cfg["jitter"] * np.eye(t)
        ks = _kernel(cfg, past, np.array([float(t)]))[:, 0]
        w = np.linalg.solve(K, ks)
        var = max(cfg["variance"] - ks @ w, cfg["jitter"])
        xs[t] = w @ xs[:t] + math.sqrt(var) * g.normal()
    ys = np.exp(xs / 2.0) * g.normal(size=T)
    return ys.astype(np.float32)


def _score(x, y):
    return -0.5 * y * y * torch.exp(-x) - 0.5 * x - _HALF_LOG_2PI


def init(cfg, k, ids, y0, dtype):
    T = cfg["num_steps"]
    x = (cfg["prior_sigma"] * cipher.normal_paired(k, ids)).to(dtype)
    hist = torch.zeros(x.shape + (T,), dtype=dtype, device=x.device)
    hist[..., 0] = x
    return (x, hist), _score(x, y0)


def step(cfg, t, k, ids, state, y, dtype):
    """The GP regression over the ``t`` past values of every history, in
    float32 (a lower ``dtype`` is rounded to on the way in and out: the
    factor and the solve have no bfloat16 form)."""
    _, hist = state
    dev = hist.device
    times = torch.arange(t + 1, dtype=torch.float32, device=dev)
    past, now = times[:t], times[t:]
    K = _kernel(cfg, past, past) + cfg["jitter"] * torch.eye(t, device=dev)
    chol = torch.linalg.cholesky(K)
    ks = _kernel(cfg, past, now)  # [t, 1]
    rows = hist[..., :t].reshape(-1, t).float()
    alpha = torch.cholesky_solve(rows.T.contiguous(), chol)  # [t, C*N]
    mean = (ks[:, 0] @ alpha).reshape(hist.shape[:-1])
    v = torch.linalg.solve_triangular(chol, ks, upper=False)[:, 0]
    var = torch.clamp(cfg["variance"] - v @ v, min=cfg["jitter"])
    k0, k1 = cipher.particle_keys(k, ids)
    eps = cipher.normal_keyed(k0, k1)
    x = (mean + torch.sqrt(var) * eps).to(dtype)
    hist[..., t] = x
    return (x, hist), _score(x, y)


def move(state, anc):
    x, hist = state
    rows = torch.gather(hist, 1, anc[..., None].expand(-1, -1, hist.shape[-1]))
    return torch.gather(x, 1, anc), rows


def step_work(cfg, n: int) -> dict:
    """One particle-step's essential work for ``step_mfu``, averaged over the
    sweep's steps.  Step ``t``'s mean is ``(K_t^-1 k_t)^T x_{0:t-1}``: one
    ``[t]`` solve a step, shared by every particle, then a dot product over
    the particle's ``t`` past values, ``2 t`` FLOPs and ``t`` words read, on
    average ``(T - 1) / 2`` of them over the ``T`` steps.  Besides: the new
    value and its score written, the state, the weight and the ancestor (4
    bytes each); the shared factor, ``T^2`` FLOPs a step at most; two cipher
    blocks a particle (its key and its draw, 79 int32 operations each).  The
    port's ``[t, N]`` solve of every history is not essential work."""
    T = cfg["num_steps"]
    past = (T - 1) / 2
    return {"bytes": 4 * (past + 2 + 2 + 2 + 1) * n, "flops": 2 * past * n + T * T,
            "int_ops": 2 * 79 * n}


def row_words(cfg) -> int:
    return 1 + cfg["num_steps"]
