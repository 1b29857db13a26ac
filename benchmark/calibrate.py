"""The two readings each limit of ``workloads/<name>.json`` is set from.

    python3 -m benchmark.calibrate --workload <name> --seeds 1 2 ... [--control 3]

For every seed, one sweep of the program at the cell's own size (the key the
run gives its sweep 0) and the plain reference on the same observations and
keys: the numbers of :mod:`benchmark.reference.compare`, whose largest over
the seeds is the lower reading.  On the first ``--control`` seeds also the
control, the reference computed in bfloat16 in the program's place, compared
with the reference in float32: the smallest of its numbers is the upper
reading.  With ``--fault NAME`` the program runs with that fault of
:mod:`benchmark.tests.faults` planted, and its numbers are the fault's
readings.  One JSON line a seed on standard output, then a summary line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import manifest
from benchmark.run import program_call
from benchmark.reference import cipher, compare, smc


def control_numbers(cell, ys, keys, ref, torch):
    """The control's numbers against the float32 reference ``ref``."""
    ctl = smc.sweep(cell.reference, cell.config, ys, keys, cell.traffic["particles"],
                    cell.traffic["threshold"], dtype=torch.bfloat16)
    return compare.numbers(ctl.log_evidence, ctl.ess, ctl.resampled, ref)


def main(argv=None, device_name: str = "cuda", cell=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    import importlib

    import torch

    if args.fault is not None:
        from benchmark.tests.faults import FAULTS

        FAULTS[args.fault](setattr)

    cell = manifest.resolve(args.workload) if cell is None else cell
    device = torch.device(device_name)
    apt = importlib.import_module("advancedps_tpu_torch")
    cfg, traffic = cell.config, cell.traffic
    ys, call = program_call(cell, apt, device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sound, control = [], []
    for j, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        k = cipher.fold_in(cipher.key(seed), 0)
        logz, ess, fired = call(k)
        logz, ess, fired = logz.double().cpu(), ess.cpu(), fired.cpu()
        keys = cell.driver.chain_keys(k, traffic)
        ref = smc.sweep(cell.reference, cfg, ys.to(device), keys, traffic["particles"],
                        traffic["threshold"])
        line = {"seed": seed, "program": compare.numbers(logz, ess, fired, ref),
                "firings": int(fired.sum()), "ref_firings": int(ref.resampled.sum()),
                "owner_share": ref.owner_share}
        sound.append(line["program"])
        if j < args.control:
            line["control"] = control_numbers(cell, ys.to(device), keys, ref, torch)
            control.append(line["control"])
        line["s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    names = sorted(sound[0])
    summary = {"workload": args.workload, "fault": args.fault, "seeds": len(sound),
               "control_seeds": len(control),
               "lower": {n: max(s[n] for s in sound) for n in names},
               "upper": {n: min(c[n] for c in control) for n in names} if control else None}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
    sys.exit(0)
