"""Lévy-SSM latent state inference with PGAS (PyTorch).

The PyTorch port's counterpart of ``examples/levy_ssm.py``: Langevin dynamics
driven by a Gamma-process subordinator, the first state component observed
with Gaussian noise; PGAS chains, as one batch, recover the marginal state
trajectories.

Run:  python examples/torch/levy_ssm.py  [--particles 50] [--steps 200]
      [--iters 100] [--chains 2] [--device cuda]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import torch  # noqa: E402

import advancedps_tpu_torch as apt  # noqa: E402
from advancedps_tpu_torch.parallel import sample_chains  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--particles", type=int, default=50)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--chains", type=int, default=2)
    p.add_argument("--device", default=None, help="default: the GPU")
    args = p.parse_args(argv)

    # ts = range(0, 100; N), θ = -0.5, σe = 1, C = 1, β = 1, μw = 0, σw = 1.
    model = apt.models.levy_ssm(dt=100.0 / args.steps, theta=-0.5, sigma_e=1.0, C=1.0, beta=1.0)
    xs, ys = apt.simulate(apt.rng.key(1234), model, args.steps)
    traced = apt.TracedSSM(model, ys)

    t0 = time.perf_counter()
    chains = sample_chains(apt.rng.key(1), traced, apt.PGAS(args.particles), args.iters,
                           args.chains, trajectory_storage="replay", device=args.device)
    traj = chains.trajectory.cpu()  # [chains, iters, T, 2]
    dt = time.perf_counter() - t0

    burn = args.iters // 4
    mean_traj = traj[:, burn:].mean(dim=(0, 1))
    rmse = torch.sqrt(torch.mean((mean_traj - xs) ** 2, dim=0))
    print(f"PGAS({args.particles}) x {args.iters}, {args.chains} chains, T={args.steps}: "
          f"{dt:.2f}s")
    print(f"marginal-state RMSE vs truth: x1={float(rmse[0]):.3f} x2={float(rmse[1]):.3f}")
    return {"rmse": rmse.tolist(), "finite": bool(torch.isfinite(traj).all())}


if __name__ == "__main__":
    main()
