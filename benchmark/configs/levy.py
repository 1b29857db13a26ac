"""Plain reference and frozen simulator of the ``levy`` configuration: the
Lévy-driven Langevin SSM of AdvancedPS.jl ``examples/levy-ssm/script.jl``.

State ``x [C, N, 2]`` (position and velocity).  Step ``t`` covers
``[(t - 1) dt, t dt]``: a Gamma process ``(C, beta)`` gives a jump path by its
series (arrival times ``t_k``, cumulative Exp gaps of mean ``1 / dt``; sizes
``x_k = 1 / (beta (exp(t_k / C) - 1))``, kept where a uniform falls below
``(1 + beta x_k) exp(-beta x_k)``; each at a uniform time ``tau_k`` of the
interval), and with ``f_k = exp(A (t dt - tau_k)) L = [(e_k - 1) / theta, e_k]``,
``e_k = exp(theta (t dt - tau_k))``, the new state is drawn from
``N(exp(A dt) x + mu_w sum_k x_k f_k, sigma_w^2 sum_k x_k f_k f_k^T)``;
the observation scores ``log N(y_t; x_t[0], sigma_e)``.

The reference (:func:`init`, :func:`step`, :func:`move`) draws as the
program does, key by key: the prior's pair of normals from the block at
counter ``(0, id)`` of the step key; at step ``t`` the particle's key
``fold_in(step key, id)``, split into the path's and the noise's keys, the
path's split into the arrivals', the thinning's and the times' keys, each
drawing ``K`` values (:mod:`benchmark.reference.keyed`).  It writes the path
over ``[C, N, K]`` in one pass.  Its departures from the script, all the
program's:

* a fixed budget of ``K = max_jumps`` candidate arrivals in place of the
  script's loop until a kept jump falls below ``tol``; the jumps past it are
  smaller still than the ``K``-th, which lies below ``tol`` (the CPU tests
  check it on seeded draws);
* the truncation masks the jumps below ``tol`` (the script keeps the last,
  which ends its loop), and arrivals start at 0 (the script's at ``tol``);
* the mask selects where the JAX package multiplies by it: an arrival gap of
  exactly 0 makes an infinite jump, rejected, which a product would turn into
  NaN;
* ``jitter I`` is added to the covariance before its factor.

:func:`simulate` keeps to the script itself, in float64: the loop of jumps
with no budget, the state starting at 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import cipher, keyed

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _f32(v) -> float:
    """``v`` as the program's float32 buffer holds it."""
    return float(np.float32(v))


def _expm64(theta: float, dt: float) -> np.ndarray:
    f = math.exp(theta * dt)
    return np.array([[1.0, (f - 1.0) / theta], [0.0, f]])


def gamma_path(g: np.random.Generator, cfg, start: float, finish: float):
    """The script's ``simulate(rng, process, dt, start, finish, tol)`` in
    float64: ``(jumps, times, arrivals)``, ``arrivals`` the candidates drawn
    until a kept jump fell below ``tol``."""
    beta, C, tol, rate = cfg["beta"], cfg["C"], cfg["tol"], cfg["dt"]
    jumps, last, t, arrivals = [], math.inf, tol, 0
    while not last < tol:
        t += g.exponential(1.0 / rate)
        arrivals += 1
        xi = 1.0 / (beta * (math.exp(t / C) - 1.0))
        if g.uniform() < (1.0 + beta * xi) * math.exp(-beta * xi):
            jumps.append(xi)
            last = xi
    return np.array(jumps), g.uniform(start, finish, size=len(jumps)), arrivals


def simulate(cfg) -> np.ndarray:
    """The observations ``y [T]`` (float32) from ``cfg["data_seed"]``: the
    script's loop over ``T`` times ``dt`` apart, the state from 0."""
    T, dt, theta = cfg["num_steps"], cfg["dt"], cfg["theta"]
    g = np.random.default_rng(cfg["data_seed"])
    expm = _expm64(theta, dt)
    x = np.zeros(2)
    ys = np.empty(T)
    for i in range(T):
        if i:
            finish = i * dt
            jumps, times, _ = gamma_path(g, cfg, finish - dt, finish)
            e = np.exp(theta * (finish - times))
            ft = np.stack([(e - 1.0) / theta, e], -1)
            mu = (ft * cfg["mu_w"] * jumps[:, None]).sum(0)
            cov = (ft[:, :, None] * ft[:, None, :] * jumps[:, None, None]).sum(0) \
                * cfg["sigma_w"] ** 2
            chol = np.linalg.cholesky(cov + cfg["jitter"] * np.eye(2))
            x = expm @ x + mu + chol @ g.normal(size=2)
        ys[i] = x[0] + cfg["sigma_e"] * g.normal()
    return ys.astype(np.float32)


def _score(cfg, x, y):
    z = (y - x[..., 0]) / _f32(cfg["sigma_e"])
    log_sigma = float(torch.log(torch.tensor(cfg["sigma_e"], dtype=torch.float32)))
    return -0.5 * z * z - log_sigma - _HALF_LOG_2PI


def init(cfg, k, ids, y0, dtype):
    """``(state, logw)`` at step 0 under the key words ``k`` (each ``[C, 1]``):
    the prior ``N(0, I)``."""
    x = keyed.normal_pairs(k, ids).to(dtype)
    return x, _score(cfg, x, y0)


def jump_path(cfg, t, key):
    """Step ``t``'s jump path under the path keys ``key`` (words ``[C, N]``):
    ``(sizes, mask, times)``, each ``[C, N, K]``."""
    K = cfg["max_jumps"]
    dt = torch.tensor(cfg["dt"], dtype=torch.float32)
    start, finish = float((t - 1) * dt), float(t * dt)
    beta, C = _f32(cfg["beta"]), _f32(cfg["C"])
    k_arr, k_acc, k_t = keyed.split(key, 3)
    arrivals = torch.cumsum(keyed.exponential(k_arr, K) / _f32(cfg["dt"]), -1)
    sizes = 1.0 / (beta * (torch.exp(arrivals / C) - 1.0))
    prob = (1.0 + beta * sizes) * torch.exp(-beta * sizes)
    mask = (keyed.uniform(k_acc, K) < prob) & (sizes >= cfg["tol"])
    return sizes, mask, keyed.uniform(k_t, K, start, finish)


def step(cfg, t, k, ids, x, y, dtype):
    """The jump path, its mean and covariance, the factor and the draw in
    float32 (a lower ``dtype`` is rounded to on the way in and out: the
    factor has no bfloat16 form), the score in ``dtype``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = torch.tensor(cfg["dt"], dtype=torch.float32)
    theta, finish = _f32(cfg["theta"]), float(t * dt)
    k_path, k_noise = keyed.split(cipher.particle_keys(k, ids), 2)
    sizes, mask, times = jump_path(cfg, t, k_path)
    e = torch.exp(theta * (finish - times))
    ft = torch.stack([(e - 1.0) / theta, e], -1)  # [C, N, K, 2]
    m = mask[..., None]
    mu = torch.sum(torch.where(m, ft * _f32(cfg["mu_w"]) * sizes[..., None], 0.0), -2)
    weighted = torch.where(m, ft * sizes[..., None], 0.0)
    cov = torch.einsum("...ki,...kj->...ij", weighted, ft) * _f32(cfg["sigma_w"]) ** 2
    cov = cov + cfg["jitter"] * torch.eye(2, device=cov.device)
    f = torch.exp(theta * dt)
    expm = torch.tensor([[1.0, float((f - 1.0) / theta)], [0.0, float(f)]], device=x.device)
    # A [2, 2] by each state as the program's vmap of ``expm @ x`` takes it: one
    # product of A with the states as columns.
    xs = x.float().reshape(-1, 2)
    mean = torch.mm(expm, xs.T).T.reshape(x.shape) + mu
    eps = keyed.normal(k_noise, 2)
    x = (mean + torch.einsum("...ij,...j->...i", torch.linalg.cholesky(cov), eps)).to(dtype)
    return x, _score(cfg, x, y)


def move(x, anc):
    """Rows ``anc [C, N]`` of ``x [C, N, 2]``."""
    return torch.gather(x, 1, anc[..., None].expand(-1, -1, x.shape[-1]))


def step_work(cfg, n: int) -> dict:
    """One particle-step's essential work for ``step_mfu``, a lower bound.

    Cipher: ``3 K`` uniform words (the arrivals, the thinning and the times)
    at two words a block, ``3 K / 2`` blocks; the particle's key, the two
    splits' five keys and the noise's normal pair, 7 more; 79 int32
    operations a block.  Float32: 20 FLOPs a candidate (the arrival's sum and
    unit, the size, the thinning, the time's exponential and its two factor
    coordinates, the four products of the covariance's terms and their
    sums), counting an exponential or a logarithm as one.  Bytes: the state
    read and written (two words each), the score written, the weight read
    and written and the ancestor written, 4 bytes a word."""
    K = cfg["max_jumps"]
    return {"bytes": 4 * (2 + 2 + 1 + 2 + 1) * n, "flops": 20 * K * n,
            "int_ops": 79 * (3 * K // 2 + 7) * n}


def row_words(cfg) -> int:
    """32-bit words a resampling moves a particle."""
    return cfg["state_dim"]
