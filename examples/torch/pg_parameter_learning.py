"""Particle Gibbs with parameter learning: PGAS alternating with conjugate
updates (PyTorch).

The PyTorch port's counterpart of ``examples/pg_parameter_learning.py``: the
latent trajectory and the static parameters (a, q) of

    x_0 ~ N(0, q),   x_t ~ N(a x_{t-1}, q),   y_t ~ N(x_t, r)

by Gibbs sampling: θ | x_{0:T} (the conjugate update of the regression of x_t
on x_{t-1} under the prior p(a, q²) ∝ 1/q²) alternating with x_{0:T} | θ (one
PGAS iteration, ``step_pg``).

Run:  python examples/torch/pg_parameter_learning.py  [--particles 50] [--steps 150]
      [--iters 400] [--device cuda]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import torch  # noqa: E402

import advancedps_tpu_torch as apt  # noqa: E402
from advancedps_tpu_torch import random as rnd  # noqa: E402
from advancedps_tpu_torch._device import resolve_device  # noqa: E402


def theta_update(key, x, device):
    """A conjugate draw of (a, q) given the trajectory: q² ~ InvGamma((n−1)/2,
    sse/2), then a | q² ~ N(â, q²/Σx²)."""
    k_a, k_q = rnd.split(key)
    xp, xc = x[:-1].double(), x[1:].double()
    n = xp.shape[0]
    sxx = torch.sum(xp * xp)
    a_hat = torch.sum(xp * xc) / sxx
    sse = torch.sum((xc - a_hat * xp) ** 2)
    q2 = (sse / 2.0) / rnd.gamma(k_q, (n - 1) / 2.0, device=device).double()
    a = a_hat + rnd.normal(k_a, device=device).double() * torch.sqrt(q2 / sxx)
    return float(a), float(torch.sqrt(q2))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--particles", type=int, default=50)
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--iters", type=int, default=400)
    p.add_argument("--device", default=None, help="default: the GPU")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    true_a, true_q, r = 0.9, 0.32, 0.5
    _, ys = apt.simulate(apt.rng.key(1234), apt.models.stationary_lgssm(true_a, true_q, r),
                         args.steps)

    def make_model(a, q):
        return apt.TracedSSM(apt.StateSpaceModel(
            prior=apt.models.GaussianPrior(mu=0.0, sigma=q),
            dynamics=apt.models.LinearGaussianDynamics(a=a, b=0.0, q=q),
            observation=apt.models.LinearGaussianObservation(h=1.0, r=r),
        ), ys)

    sampler = apt.PGAS(args.particles)
    key = apt.rng.key(7)
    a, q = 0.5, 1.0  # a poor start
    state = None
    a_chain, q_chain = [], []
    t0 = time.perf_counter()
    for i in range(args.iters):
        k_pg, k_th = rnd.split(apt.rng.fold_in(key, i))
        smp, state = apt.step_pg(k_pg, make_model(a, q), sampler, state, device=device)
        a, q = theta_update(k_th, smp.trajectory, device)
        a_chain.append(a)
        q_chain.append(q)
    dt = time.perf_counter() - t0

    burn = args.iters // 2
    a_post = torch.tensor(a_chain[burn:])
    q_post = torch.tensor(q_chain[burn:])
    print(f"PGAS({args.particles}) + conjugate θ updates, {args.iters} Gibbs iters: "
          f"{dt:.1f}s ({args.iters / dt:.1f} it/s)")
    print(f"a: posterior mean {float(a_post.mean()):.3f} ± {float(a_post.std()):.3f} "
          f"(truth {true_a})")
    print(f"q: posterior mean {float(q_post.mean()):.3f} ± {float(q_post.std()):.3f} "
          f"(truth {true_q})")
    return {"a": float(a_post.mean()), "q": float(q_post.mean())}


if __name__ == "__main__":
    main()
