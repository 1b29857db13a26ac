"""GP state-space model with PGAS: non-Markovian dynamics (PyTorch).

The PyTorch port's counterpart of ``examples/gaussian_process.py``: data from a
stochastic-volatility model, inferred under a GP-SSM whose transition at step t
is the GP posterior given the particle's whole past; independent chains as one
batch, each particle's history moved by B4 over leaves.

Run:  python examples/torch/gaussian_process.py  [--particles 20] [--steps 100]
      [--iters 250] [--chains 2] [--device cuda]
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
    p.add_argument("--particles", type=int, default=20)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--iters", type=int, default=250)
    p.add_argument("--chains", type=int, default=2)
    p.add_argument("--device", default=None, help="default: the GPU")
    args = p.parse_args(argv)

    true_model = apt.models.stochastic_volatility_ssm(a=0.9, q=0.5)
    xs, ys = apt.simulate(apt.rng.key(1234), true_model, args.steps)
    traced = apt.TracedSSM(apt.models.gp_ssm(num_steps=args.steps), ys)

    t0 = time.perf_counter()
    chains = sample_chains(apt.rng.key(1), traced, apt.PGAS(args.particles), args.iters,
                           args.chains, device=args.device)
    traj = chains.trajectory.cpu()  # [chains, iters, T]
    dt = time.perf_counter() - t0

    burn = args.iters // 4
    mean_traj = traj[:, burn:].mean(dim=(0, 1))
    rmse = float(torch.sqrt(torch.mean((mean_traj - xs) ** 2)))
    print(f"GP-SSM PGAS({args.particles}) x {args.iters}, {args.chains} chains, "
          f"T={args.steps}: {dt:.2f}s")
    print(f"posterior-mean RMSE vs latent truth: {rmse:.3f}")
    print(f"final log-evidence per chain: {chains.log_evidence[:, -1].cpu().tolist()}")
    return {"rmse": rmse, "finite": bool(torch.isfinite(chains.log_evidence).all())}


if __name__ == "__main__":
    main()
