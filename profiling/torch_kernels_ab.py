"""Device time of the PyTorch port's one-chain resampling kernels in two or
more checkouts, for an A/B on one card in one call.

    python profiling/torch_kernels_ab.py ROOT [ROOT ...]

Each ROOT is a checkout holding ``advancedps_tpu_torch/`` (the working tree,
or a ``git archive`` of another commit unpacked under a git-ignored
directory).  For each in the order given, a child process builds that
checkout's kernels and reads, on the same inputs (a fixed seed, N = 1M), the
device time of B1 ``extents_from_logw``, B6 ``scaled_prefix_from_logw`` and
``prefix_sum`` and B4 ``decode_move`` from ``torch.profiler``'s device rows
over a window of calls.  Prints one JSON line a root, then the card's name and
power limit.  Name the roots as parent, change, change, parent to read both
versions in turns.
"""

import json
import os
import subprocess
import sys
import time

N = 1_000_000
REPS = 200


def measure(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from advancedps_tpu_torch.ops import resample as ops

    gen = torch.Generator(device="cuda").manual_seed(0)
    logw = torch.randn(N, generator=gen, device="cuda") * 2.0
    m = torch.max(logw)
    s1 = torch.sum(torch.exp(logw - m))
    e = torch.exp(logw - m)
    f = ops.extents_from_logw(logw, m, s1, 0.37, N)
    x = torch.randn(N, generator=gen, device="cuda")
    calls = {
        "extents_from_logw": lambda: ops.extents_from_logw(logw, m, s1, 0.37, N),
        "scaled_prefix_from_logw": lambda: ops.scaled_prefix_from_logw(logw, m, N / s1),
        "prefix_sum": lambda: ops.prefix_sum(e),
        "decode_move": lambda: ops.decode_move(f, x, N),
    }
    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
        rows = [r for r in prof.key_averages() if r.device_type == DeviceType.CUDA]
        out[name] = sum(r.self_device_time_total for r in rows) / REPS / 1e3
    return out


def main():
    if sys.argv[1:2] == ["--child"]:
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return
    roots = sys.argv[1:]
    if not roots:
        sys.exit("usage: torch_kernels_ab.py ROOT [ROOT ...]")
    for root in roots:
        child = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root],
                               capture_output=True, text=True, timeout=600)
        if child.returncode != 0:
            sys.exit(f"{root}: rc {child.returncode}\n{child.stdout}{child.stderr}")
        ms = json.loads(child.stdout.strip().splitlines()[-1])
        print(json.dumps({"root": root, "device_ms": ms}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
