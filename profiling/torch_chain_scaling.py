"""Device time of the chain-axis scans of the PyTorch port, kernel by kernel,
as the number of chains grows.

    python profiling/torch_chain_scaling.py

On one GPU, for C = 1, 2, 4 and 8 chains of N = 1M and for 64 chains of
16,384, reads from ``torch.profiler``'s device rows over a window of calls
the device time of each kernel that B5 ``decode_ancestors_dense_chains`` (its
scatter and its scan) and B1 ``extents_from_logw_chains`` launch, on inputs
made from a fixed seed.  Prints one JSON line a shape, then the card's name
and power limit.
"""

import json
import os
import re
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

from advancedps_tpu_torch.ops import resample as ops  # noqa: E402

SHAPES = ((1, 1_000_000), (2, 1_000_000), (4, 1_000_000), (8, 1_000_000), (64, 16_384))
REPS = 20


def by_kernel(fn) -> dict:
    """Device ms of one call of ``fn``, by kernel name."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.02)
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.02)
    rows = [r for r in prof.key_averages() if r.device_type == DeviceType.CUDA]
    return {re.search(r"::(\w+)", r.key).group(1): r.self_device_time_total / REPS / 1e3
            for r in rows}


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for c, n in SHAPES:
        logw = torch.randn(c, n, generator=gen, device="cuda") * 2.0
        m = torch.amax(logw, -1)
        s1 = torch.sum(torch.exp(logw - m[:, None]), -1)
        u = torch.rand(c, generator=gen, device="cuda")
        f = ops.extents_from_logw_chains(logw, m, s1, u, n)
        print(json.dumps({
            "chains": c, "n": n,
            "B5 decode_ancestors_dense_chains": by_kernel(
                lambda: ops.decode_ancestors_dense_chains(f, n)),
            "B1 extents_from_logw_chains": by_kernel(
                lambda: ops.extents_from_logw_chains(logw, m, s1, u, n)),
        }), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
