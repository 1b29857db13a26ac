"""PGAS chains and an SMC ensemble for a Gaussian state-space model (PyTorch).

The PyTorch port's counterpart of ``examples/gaussian_ssm.py``: a linear-Gaussian
random walk with stationary prior; independent PGAS chains over the latent
states, run as one batch on a leading chain axis; the pooled posterior mean
against the simulated truth and the exact Kalman filter, and the spread of the
log-evidence over an ensemble of SMC runs.

Run:  python examples/torch/gaussian_ssm.py  [--particles 20] [--steps 200]
      [--iters 500] [--chains 4] [--device cuda]
"""

import argparse
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import torch  # noqa: E402

import advancedps_tpu_torch as apt  # noqa: E402
from advancedps_tpu_torch.parallel import sample_chains, smc_ensemble  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--particles", type=int, default=20)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--iters", type=int, default=500)
    p.add_argument("--chains", type=int, default=4)
    p.add_argument("--device", default=None, help="default: the GPU")
    args = p.parse_args(argv)

    a, q, r = 0.9, 0.32, 1.0
    model = apt.models.stationary_lgssm(a=a, q=q, r=r)
    xs, ys = apt.simulate(apt.rng.key(1234), model, args.steps)
    traced = apt.TracedSSM(model, ys)

    t0 = time.perf_counter()
    chains = sample_chains(apt.rng.key(1), traced, apt.PGAS(args.particles), args.iters,
                           args.chains, device=args.device)
    traj = chains.trajectory.cpu()  # [chains, iters, T]
    dt = time.perf_counter() - t0

    burn = args.iters // 4
    mean_traj = traj[:, burn:].mean(dim=(0, 1)).double()
    kf = apt.utils.kalman_filter(ys, a, 0.0, q, 1.0, r, 0.0, math.sqrt(q * q / (1 - a * a)))
    rmse_truth = float(torch.sqrt(torch.mean((mean_traj - xs.double()) ** 2)))
    rmse_kalman = float(torch.sqrt(torch.mean((mean_traj - kf.means.cpu()) ** 2)))

    ens = smc_ensemble(apt.rng.key(2), traced, apt.SMC(64 * args.particles), args.chains,
                       store_states=False, device=args.device)
    lz = ens.log_evidence.cpu().double()

    print(f"{args.chains} PGAS({args.particles}) chains x {args.iters} iters, T={args.steps}: "
          f"{dt:.2f}s ({args.chains * args.iters / dt:.1f} chain-iters/s)")
    print(f"posterior-mean RMSE vs truth:  {rmse_truth:.4f}")
    print(f"posterior-mean RMSE vs Kalman filter means: {rmse_kalman:.4f}")
    print(f"SMC ensemble log-evidence {float(lz.mean()):.3f} ± {float(lz.std()):.3f} "
          f"(exact {float(kf.log_likelihood):.3f})")
    return {"rmse_truth": rmse_truth, "rmse_kalman": rmse_kalman,
            "logz_err": abs(float(lz.mean()) - float(kf.log_likelihood))}


if __name__ == "__main__":
    main()
