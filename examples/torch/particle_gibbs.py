"""PG against PGAS on a stochastic-volatility model: mixing (PyTorch).

The PyTorch port's counterpart of ``examples/particle_gibbs.py``: PG's path
degenerates at early time steps; PGAS's ancestor sampling restores the update
rate 1 − 1/N.  Each sampler runs its chains as one batch.

Run:  python examples/torch/particle_gibbs.py  [--particles 20] [--steps 200]
      [--iters 200] [--chains 2] [--device cuda]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import advancedps_tpu_torch as apt  # noqa: E402
from advancedps_tpu_torch.parallel import sample_chains  # noqa: E402


def update_rate(traj):
    """Share of iterations in which x_t changes, per step (``traj [iters, T]``)."""
    return (traj.diff(dim=0).abs() > 0).double().mean(dim=0)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--particles", type=int, default=20)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--chains", type=int, default=2)
    p.add_argument("--device", default=None, help="default: the GPU")
    args = p.parse_args(argv)

    model = apt.models.stochastic_volatility_ssm(a=0.9, q=0.5)
    _, ys = apt.simulate(apt.rng.key(1234), model, args.steps)
    traced = apt.TracedSSM(model, ys)

    rates = {}
    for name, sampler in [("PG", apt.PG(args.particles, 1.0)), ("PGAS", apt.PGAS(args.particles))]:
        t0 = time.perf_counter()
        chains = sample_chains(apt.rng.key(1), traced, sampler, args.iters, args.chains,
                               trajectory_storage="replay", device=args.device)
        traj = chains.trajectory.cpu()
        dt = time.perf_counter() - t0
        rate = sum(update_rate(traj[c]) for c in range(args.chains)) / args.chains
        rates[name] = rate
        early = float(rate[: args.steps // 3].mean())
        print(f"{name}({args.particles}) x {args.chains} chains: {dt:.2f}s — mean update rate "
              f"{float(rate.mean()):.3f} (early third: {early:.3f})")

    theory = 1.0 - 1.0 / args.particles
    print(f"theoretical optimum 1 - 1/N = {theory:.3f}")
    return {"pg": float(rates["PG"].mean()), "pgas": float(rates["PGAS"].mean()),
            "theory": theory}


if __name__ == "__main__":
    main()
