"""Host-PPL adapter: driving SMC and PGAS for an external model (PyTorch).

The PyTorch port's counterpart of ``examples/host_ppl_adapter.py``.  The
port's integration surface for a host probabilistic-programming language is
the :class:`~advancedps_tpu_torch.engine.SweepKernel` protocol: ``MiniPPL``
below knows nothing of the package (its own callables, variance-parameterised
Gaussians), an adapter of a few lines maps it onto the protocol, and
``make_kernel`` hands it to every driver unchanged: SMC, PGAS, and an ensemble
of SMC runs batched on a chain axis (the adapter's per-particle ``vmap`` then
runs inside the ``vmap`` over chains).  The results are held against the exact
Kalman filter and RTS smoother.

Run:  python examples/torch/host_ppl_adapter.py [--n 200] [--iters 40] [--device cuda]
"""

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.func import vmap  # noqa: E402

import advancedps_tpu_torch as apt  # noqa: E402
from advancedps_tpu_torch import random as rnd  # noqa: E402
from advancedps_tpu_torch._device import resolve_device  # noqa: E402
from advancedps_tpu_torch.parallel import smc_ensemble  # noqa: E402


class MiniPPL:
    """x_0 ~ N(0, v0);  x_t ~ N(a·x_{t-1}, v);  y_t ~ N(x_t, w), per scalar."""

    def __init__(self, a, v, w, ys):
        self.a, self.v, self.w = a, v, w
        self.ys = ys
        self.v0 = v / (1 - a * a)  # stationary variance

    def init_sample(self, key):
        return rnd.normal(key) * math.sqrt(self.v0)

    def trans_sample(self, key, t, x):
        return self.a * x + rnd.normal(key) * math.sqrt(self.v)

    def trans_logpdf(self, t, x_prev, x):
        d = x - self.a * x_prev
        return -0.5 * d * d / self.v - 0.5 * math.log(2 * math.pi * self.v)

    def obs_logpdf(self, t, x):
        d = self.ys[t] - x
        return -0.5 * d * d / self.w - 0.5 * math.log(2 * math.pi * self.w)


class MiniPPLKernel(apt.SweepKernel):
    """Adapts a :class:`MiniPPL` to the sweep protocol: the host model's
    per-particle callables run under ``vmap`` over the engine's per-particle
    keys, so every draw stays a pure function of (key, stream, step, id)."""

    def __init__(self, model: MiniPPL):
        self.model = model

    @property
    def num_steps(self):
        return self.model.ys.shape[0]

    def init(self, rng, ref0, ref_mask):
        x0 = apt.inject_ref(ref_mask, ref0, vmap(self.model.init_sample)(rng.particle_keys()))
        return x0, vmap(lambda x: self.model.obs_logpdf(0, x))(x0)

    def step(self, t, rng, state, ref_t, ref_mask):
        x = vmap(lambda k, xp: self.model.trans_sample(k, t, xp))(rng.particle_keys(), state)
        x = apt.inject_ref(ref_mask, ref_t, x)
        return x, vmap(lambda xi: self.model.obs_logpdf(t, xi))(x)

    def snapshot(self, state):
        return state

    def transition_logprob(self, t, state, ref_t):
        return vmap(lambda xp: self.model.trans_logpdf(t, xp, ref_t))(state)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--T", type=int, default=30)
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--device", default=None, help="default: the GPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    a, v, w = 0.8, 0.25, 0.5
    rng = np.random.default_rng(0)
    xs = [rng.normal() * math.sqrt(v / (1 - a * a))]
    for _ in range(args.T - 1):
        xs.append(a * xs[-1] + rng.normal() * math.sqrt(v))
    ys = np.asarray(xs) + rng.normal(size=args.T) * math.sqrt(w)

    kernel = apt.make_kernel(MiniPPLKernel(MiniPPL(a, v, w, torch.tensor(ys, dtype=torch.float32,
                                                                          device=device))))
    consts = (a, 0.0, math.sqrt(v), 1.0, math.sqrt(w), 0.0, math.sqrt(v / (1 - a * a)))
    kf = apt.utils.kalman_filter(torch.tensor(ys), *consts)

    smc = apt.sample(apt.rng.key(0), kernel, apt.SMC(args.n), device=device)
    err = abs(float(smc.log_evidence) - float(kf.log_likelihood))
    print(f"SMC over host-PPL model: logZ={float(smc.log_evidence):+.3f}  "
          f"Kalman={float(kf.log_likelihood):+.3f}  |err|={err:.3f}")

    ens = smc_ensemble(apt.rng.key(3), kernel, apt.SMC(args.n), args.runs, store_states=False,
                       device=device)
    ens_err = float((ens.log_evidence.cpu().double() - float(kf.log_likelihood)).abs().max())
    print(f"{args.runs} SMC runs as one batch: largest |logZ - Kalman| = {ens_err:.3f}")

    out = apt.sample(apt.rng.key(1), kernel, apt.PGAS(args.n), args.iters, device=device)
    traj = out.trajectory.cpu().double()  # [iters, T]
    sm = apt.utils.kalman_smoother(torch.tensor(ys), *consts)
    burn = args.iters // 4
    z = (traj[burn:].mean(0) - sm.means.cpu()) / sm.variances.cpu().sqrt()
    zrms = float(torch.sqrt(torch.mean(z * z)))
    print(f"PGAS over host-PPL model: posterior-mean RMS z vs RTS smoother = {zrms:.2f} "
          f"({args.iters} iters, {args.n} particles)")
    return {"err": err, "ens_err": ens_err, "zrms": zrms}


if __name__ == "__main__":
    main()
