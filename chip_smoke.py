"""Drive the PyTorch/CUDA port's bootstrap-SMC main path on one GPU and check it.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero before the
final line:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. build the CUDA kernels from ``advancedps_tpu_torch/csrc`` with nvcc;
3. each kernel against its plain PyTorch version on the card at M = N = 1M,
   on four weight profiles and the guard case;
4. the flagship sweep (stationary LGSSM a=0.9, q=0.32, r=1.0, T=100,
   N=1,000,000, systematic resampling at ESS ≤ N/2) through ``sample``,
   anchored to the exact Kalman log-likelihood, with the kernels' launch
   counts equal to the number of resampling steps and a bitwise repeat;
5. timings: the median of 5 sweeps, each kernel against its plain version,
   and a profiled sweep for the device busy share.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Imports no JAX: the card's machine has none.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch

N = 1_000_000
T = 100
A, Q, R = 0.9, 0.32, 1.0
REPS = 20  # launches per timing window
SOURCE = "advancedps_tpu_torch/csrc/resample.cu"
TPU_FILE = "advancedps_tpu/ops/pallas_resample.py"


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(out, "nvidia-smi printed nothing")
    return out[0]


def profile_logw(profile: str, gen: torch.Generator) -> torch.Tensor:
    """Weight profiles at M = N: log-normal, uniform, one survivor, 20 survivors."""
    if profile == "lognormal":
        return torch.randn(N, generator=gen, device="cuda") * 2.0
    if profile == "uniform":
        return torch.zeros(N, device="cuda")
    logw = torch.full((N,), -80.0, device="cuda")
    k = 1 if profile == "single" else 20
    idx = torch.randperm(N, generator=gen, device="cuda")[:k]
    logw[idx] = torch.randn(k, generator=gen, device="cuda")
    return logw


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def time_ms(fn) -> float:
    """Mean device time of one call over REPS calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def plain_vs_kernel(plain, kernel):
    """Turns plain, kernel, kernel, plain in one window; mean of each pair."""
    p1, k1, k2, p2 = time_ms(plain), time_ms(kernel), time_ms(kernel), time_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs only on a GPU")
    import advancedps_tpu_torch as apt
    from advancedps_tpu_torch.ops import _build
    from advancedps_tpu_torch.ops import resample as ops

    # ---- 1. device
    card = card_line()
    print(card, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | python {sys.version.split()[0]}",
          flush=True)
    tag = f"[{card}]"

    # ---- 2. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    ptxas = [ln.strip() for ln in lib_path.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build: {time.perf_counter() - t0:.2f}s {lib_path.name}", flush=True)
    for ln in ptxas:
        print(f"  ptxas {ln}", flush=True)

    # ---- 3. kernels vs plain versions on the card, M = N = 1M
    gen = torch.Generator(device="cuda").manual_seed(0)
    err = {"extents_from_logw": 0.0, "decode_ancestors": 0.0, "resample_move": 0.0}
    for i, profile in enumerate(["lognormal", "uniform", "single", "survivors20"]):
        logw = profile_logw(profile, gen)
        m = torch.max(logw)
        s1 = torch.sum(torch.exp(logw - m))
        u = apt.rng.uniform(apt.rng.key(1000 + i))
        f = ops.extents_from_logw(logw, m, s1, u, N)
        f_ref = ops.extents_from_logw_ref(logw, m, s1, u, N)
        diff = (f.long() - f_ref.long()).abs()
        flips = float((diff > 0).float().mean())
        check(bool((f[1:] >= f[:-1]).all()), f"{profile}: extents not nondecreasing")
        # f[-1] is n, or n−1 where fl32(n·cdf − u) rounds down to n−1 (u near 1);
        # the decode reads f[-1] as n (the undershoot guard).
        check(int(f[-1]) in (N - 1, N), f"{profile}: f[-1] = {int(f[-1])}")
        check(int(diff.max()) <= 1 and flips <= 1e-3,
              f"{profile}: extents differ by {int(diff.max())} in {flips:.2e} of entries")
        err["extents_from_logw"] = max(err["extents_from_logw"], float(diff.max()))

        anc = ops.decode_ancestors(f, N)
        anc_ref = ops.decode_ancestors_ref(f, N)
        check(torch.equal(anc, anc_ref), f"{profile}: decoded ancestors differ")
        x = torch.randn(N, generator=gen, device="cuda")
        xd = torch.randn(N, 3, generator=gen, device="cuda")
        for v in (x, xd):
            anc_c, moved = ops.resample_move(anc, v)
            anc_c_ref, moved_ref = ops.resample_move_ref(anc, v)
            check(torch.equal(anc_c, anc_c_ref), f"{profile}: clipped ancestors differ")
            check(torch.equal(bits(moved), bits(moved_ref)), f"{profile}: moved rows differ")
            check(torch.equal(bits(moved), bits(v[anc_c.long()])), f"{profile}: not v[anc]")

        # Guard case: N−1 positions drawn, slot N−1 decodes past the population.
        f_g = ops.extents_from_logw(logw, m, s1, u, N - 1)
        anc_g = ops.decode_ancestors(f_g, N, guard=N - 1)
        check(torch.equal(anc_g, ops.decode_ancestors_ref(f_g, N, guard=N - 1)),
              f"{profile}: guarded ancestors differ")
        check(int(anc_g[-1]) == N, f"{profile}: guarded last slot anc = {int(anc_g[-1])}")
        anc_gc, moved_g = ops.resample_move(anc_g, x)
        check(int(anc_gc[-1]) == N - 1 and float(moved_g[-1]) == 0.0,
              f"{profile}: guarded last slot not clipped / zeroed")
        check(torch.equal(bits(moved_g), bits(ops.resample_move_ref(anc_g, x)[1])),
              f"{profile}: guarded move differs")
        print(f"kernels vs plain [{profile}]: extents ±{int(diff.max())} in {flips:.2e} of "
              f"entries, decode exact, move bitwise (D=1, D=3), guard ok", flush=True)
    torch.cuda.synchronize()

    # ---- 4. the flagship sweep through the public entry point
    model = apt.models.stationary_lgssm(A, Q, R)
    _, ys = apt.simulate(torch.Generator().manual_seed(0), model, T)
    traced = apt.TracedSSM(model, ys)
    key = apt.rng.key(1)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    smc = apt.sample(key, traced, apt.SMC(N), device="cuda")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in ops.KERNEL_WRAPPERS}

    log_z = float(smc.log_evidence)
    kf = apt.utils.kalman_filter(ys, A, 0.0, Q, 1.0, R, 0.0, math.sqrt(Q * Q / (1 - A * A)))
    kf_ll = float(kf.log_likelihood)
    n_rs = int(smc.diagnostics["resampled"].sum())
    print(f"flagship: logZ {log_z:.6f} kalman {kf_ll:.6f} |err| {abs(log_z - kf_ll):.6f} "
          f"resampled {n_rs}/{T} launches {launches} first call {first_s:.3f}s {tag}",
          flush=True)
    check(math.isfinite(log_z), "logZ is not finite")
    check(abs(log_z - kf_ll) < 0.1, f"|logZ - kalman| = {abs(log_z - kf_ll)} >= 0.1")
    check(n_rs > 0, "the gate never fired")
    for name, count in launches.items():
        check(count == n_rs, f"{name} launched {count} times for {n_rs} resampling steps")
    check(tuple(smc.trajectories.shape) == (T, N), "trajectories shape")
    check(bool(torch.isfinite(smc.trajectories).all()), "trajectories not finite")
    check(abs(float(smc.weights.sum()) - 1.0) < 1e-4, "weights do not sum to 1")

    kernel = apt.SSMKernel(traced)
    resampler = apt.SMC(N).resampler
    a = apt.sweep(key, kernel, N, resampler, store_states=False, device="cuda")
    b = apt.sweep(key, kernel, N, resampler, store_states=False, device="cuda")
    check(torch.equal(a.log_evidence, b.log_evidence), "same key: log_evidence differs")
    check(torch.equal(a.ancestors, b.ancestors), "same key: ancestors differ")
    check(torch.equal(a.log_evidence, smc.log_evidence), "sweep and sample disagree")
    print("repeat: same key gives bitwise equal log_evidence and ancestors", flush=True)

    # ---- 5. timings
    times = []
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = apt.sweep(apt.rng.key(10 + i), kernel, N, resampler, store_states=False,
                        device="cuda")
        float(res.log_evidence)
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    print(f"sweep N={N} T={T}: median {med * 1e3:.3f} ms of 5 "
          f"({', '.join(f'{t * 1e3:.3f}' for t in times)}), "
          f"{N * T / med:.4e} particle-steps/s {tag}", flush=True)

    logw = profile_logw("lognormal", gen)
    m = torch.max(logw)
    s1 = torch.sum(torch.exp(logw - m))
    u = apt.rng.uniform(apt.rng.key(7))
    f = ops.extents_from_logw(logw, m, s1, u, N)
    anc = ops.decode_ancestors(f, N)
    x = torch.randn(N, generator=gen, device="cuda")
    timing = {
        "extents_from_logw": plain_vs_kernel(
            lambda: ops.extents_from_logw_ref(logw, m, s1, u, N),
            lambda: ops.extents_from_logw(logw, m, s1, u, N)),
        "decode_ancestors": plain_vs_kernel(
            lambda: ops.decode_ancestors_ref(f, N), lambda: ops.decode_ancestors(f, N)),
        "resample_move": plain_vs_kernel(
            lambda: ops.resample_move_ref(anc, x), lambda: ops.resample_move(anc, x)),
    }
    for name, (k_ms, p_ms) in timing.items():
        print(f"kernel {name} at 1M: {k_ms:.4f} ms, plain {p_ms:.4f} ms {tag}", flush=True)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = apt.sweep(apt.rng.key(20), kernel, N, resampler, store_states=False,
                        device="cuda")
        float(res.log_evidence)
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    # Only device-side rows: an aten op's row repeats its kernels' device time.
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in kernels)
    gate_us = sum(e.cpu_time_total for e in events if e.key == "aten::_local_scalar_dense")
    if busy_us > 0:
        print(f"profiled sweep: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
              f"({busy_us / wall_us:.3f} of wall; unprofiled median {med * 1e3:.3f} ms), "
              f"host blocked at the gate {gate_us / 1e3:.3f} ms in {T - 1} reads, "
              f"{sum(e.count for e in kernels)} kernel launches {tag}", flush=True)
    else:
        print("profiled sweep: device time not measured (profiler saw no device time)",
              flush=True)
    for e in kernels[:10]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}",
              flush=True)

    replaces = {
        "extents_from_logw": f"{TPU_FILE}:237",
        "decode_ancestors": f"{TPU_FILE}:972",
        "resample_move": f"{TPU_FILE}:1090",
    }
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces[name],
         "launches": launches[name], "max_abs_err": err[name],
         "ms": timing[name][0], "plain_ms": timing[name][1]}
        for name in replaces
    ]}
    print(json.dumps(record), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
