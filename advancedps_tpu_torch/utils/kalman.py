"""Exact Kalman filter and RTS smoother for the scalar LGSSM, in float64 — the
log-evidence and posterior anchors.

Port of ``advancedps_tpu/utils/kalman.py``::

    x_0 ~ N(mu0, sigma0²),  x_t = a·x_{t-1} + b + N(0, q²),  y_t = h·x_t + N(0, r²)

with ``y_0`` observed on ``x_0``.  ``q, r, sigma0`` are standard deviations.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["KalmanResult", "kalman_filter", "kalman_smoother"]


class KalmanResult(NamedTuple):
    means: torch.Tensor  # [T] filtering means  E[x_t | y_{0:t}]
    variances: torch.Tensor  # [T] filtering variances
    log_likelihood: torch.Tensor  # scalar  log p(y_{0:T-1})


def kalman_filter(ys, a, b, q, h, r, mu0, sigma0) -> KalmanResult:
    """Exact filter in float64 on the host (T scalar steps)."""
    ys = torch.as_tensor(ys).detach().to("cpu", torch.float64).tolist()
    qq, rr = q * q, r * r

    def update(pred_mean, pred_var, y):
        s = h * h * pred_var + rr  # innovation variance
        k = pred_var * h / s  # Kalman gain
        innov = y - h * pred_mean
        ll = -0.5 * (math.log(2.0 * math.pi) + math.log(s) + innov * innov / s)
        return pred_mean + k * innov, (1.0 - k * h) * pred_var, ll

    mean, var, ll = update(mu0, sigma0 * sigma0, ys[0])
    means, variances = [mean], [var]
    for y in ys[1:]:
        mean, var, step_ll = update(a * mean + b, a * a * var + qq, y)
        ll += step_ll
        means.append(mean)
        variances.append(var)
    f64 = torch.float64
    return KalmanResult(
        torch.tensor(means, dtype=f64), torch.tensor(variances, dtype=f64),
        torch.tensor(ll, dtype=f64),
    )


def kalman_smoother(ys, a, b, q, h, r, mu0, sigma0) -> KalmanResult:
    """Exact RTS smoother in float64 on the host: per-step ``E[x_t | y_{0:T-1}]``
    and smoothing variances, with the filter's log-likelihood.  PG/PGAS
    retained trajectories are marginally distributed as this smoothing law."""
    filt = kalman_filter(ys, a, b, q, h, r, mu0, sigma0)
    fm, fv = filt.means.tolist(), filt.variances.tolist()
    qq = q * q
    means, variances = [fm[-1]], [fv[-1]]
    for t in range(len(fm) - 2, -1, -1):
        pred_mean = a * fm[t] + b
        pred_var = a * a * fv[t] + qq
        g = fv[t] * a / pred_var
        means.append(fm[t] + g * (means[-1] - pred_mean))
        variances.append(fv[t] + g * g * (variances[-1] - pred_var))
    f64 = torch.float64
    return KalmanResult(
        torch.tensor(means[::-1], dtype=f64), torch.tensor(variances[::-1], dtype=f64),
        filt.log_likelihood,
    )
