"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The run makes its inputs from ``--seed`` (one
key a sweep, ``fold_in(key(seed), i)`` for sweep ``i``; the observations are
the configuration's fixed data set), builds the program's model on the card,
warms the cell's own shapes, then calls the cell's driver back to back for
``--seconds`` (``--trace 0``), or for the traffic's ``trace_sweeps`` untimed
and as many again under ``torch.profiler`` (``--trace 1``).  Once the window
has closed and the program's state is freed, the plain reference re-runs a
sample of the window's sweeps, drawn from the seed (with ``--trace 1``, the
traced ones), on the same observations and keys, and ``correct`` says
whether every number compared (:mod:`benchmark.reference.compare`) is within
its limit (``workloads/<name>.json``).

Standard output: a line describing the card (``nvidia-smi``, before and after
the window), then the result as one JSON object.  Standard error: the run's
log, ending with each number compared beside its limit.  The run exits with
a code other than 0 and prints no result where CUDA has no device, or fewer
than the cell asks for, and where a module of JAX or of the JAX package was
imported.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

from benchmark import manifest, trace  # noqa: E402

#: Top-level module names that no run may have imported: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "advancedps_tpu")
PROGRAM = "advancedps_tpu_torch"
#: Fixed directories inside the checkout for any cache the program's
#: libraries keep (PyTorch's runtime-compiled kernels, Triton, extensions).
CACHE_ENV = {"PYTORCH_KERNEL_CACHE_PATH": "torch_kernels", "TRITON_CACHE_DIR": "triton",
             "TORCH_EXTENSIONS_DIR": "torch_extensions"}
SMI_QUERY = "name,power.limit,clocks.sm,temperature.gpu,power.draw"
#: Bytecode of every module a run imports, in a fixed directory inside the
#: checkout: where the environment forbids writing it (PYTHONDONTWRITEBYTECODE)
#: PyTorch's ~2,000 modules compile from source at every start, which took
#: 7-9 s and most of the spread of ``setup_s`` on the H100 machine.
PYCACHE = ".bench_cache/pycache"
#: Warm-up keys are ``fold_in(key(seed), WARM_BASE - j)``, apart from the window's.
WARM_BASE = 0xFFFFFFFF


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


@dataclass
class Run:
    """What a run measured: the metric readers of ``metrics/`` read this."""

    cell: manifest.Cell
    particles_per_call: int
    steps_per_sweep: int
    row_words: int
    setup_s: float = math.nan
    times: list = field(default_factory=list)  # each timed sweep, s
    window_s: float = math.nan
    memory_peak_bytes: int = 0
    window: trace.Window | None = None  # the traced window
    owner_share: float = math.nan

    @property
    def sweeps(self) -> int:
        return len(self.times)

    @property
    def window_sweeps(self) -> int:
        return self.cell.traffic["trace_sweeps"]

    @property
    def window_steps(self) -> int:
        return self.window_sweeps * self.steps_per_sweep


def forbidden_modules() -> list:
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def _smi_start():
    try:
        return subprocess.Popen(["nvidia-smi", f"--query-gpu={SMI_QUERY}",
                                 "--format=csv,noheader"], stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, text=True)
    except OSError:
        return None


def _smi_read(proc):
    if proc is None:
        return None
    try:
        out = proc.communicate(timeout=30)[0]
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(call, key_of, first: int, count: int, torch, device, until=None):
    """Sweeps back to back from a synchronised start, each timed from its call
    to the read of its log-evidence: ``count`` of them, or until ``until``
    seconds have passed.  Returns ``(times, outputs, wall_s)``."""
    times, outs = [], []
    _sync(torch, device)
    start = end = time.perf_counter()
    i = first
    while True:
        t0 = time.perf_counter()
        logz, ess, fired = call(key_of(i))
        logz = logz.double().cpu()
        end = time.perf_counter()
        times.append(end - t0)
        outs.append((i, logz, ess, fired))
        i += 1
        if (until is None and len(times) >= count) or (until is not None and end - start >= until):
            break
    return times, outs, end - start


def program_call(cell: manifest.Cell, apt, device):
    """The configuration's observations ``ys [T]`` (on the host) and the
    cell's driver call of the program, its model built by the builder the
    configuration names and moved to ``device``."""
    import torch

    ys = torch.tensor(cell.reference.simulate(cell.config))
    prog = cell.config["program"]
    model = getattr(apt.models, prog["builder"])(**{k: cell.config[k] for k in prog["args"]})
    return ys, cell.driver.make(apt, apt.TracedSSM(model, ys).to(device), cell.traffic, device)


def run_cell(workload: str, seed: int, seconds: float, traced: bool, device_name: str = "cuda",
             cell: manifest.Cell | None = None) -> dict:
    """One run of ``workload`` on ``device_name``: ``{"result": the result
    line as a dict, "card": nvidia-smi's line before and after the window,
    "trace_overhead": the traced window's time over the untraced one's, less
    1}``.  Every ``nvidia-smi`` it starts has ended when it returns."""
    cell = manifest.resolve(workload) if cell is None else cell
    smi = {"before": _smi_start() if device_name == "cuda" else None}
    try:
        out = _measure(workload, seed, seconds, traced, device_name, cell, smi)
    finally:
        card = {when: _smi_read(proc) for when, proc in smi.items()}
    out["card"] = {**card, "query": SMI_QUERY}
    return out


def _measure(workload, seed, seconds, traced, device_name, cell, smi) -> dict:
    from benchmark.reference import cipher, compare, smc

    marks = [("start", time.perf_counter())]
    import torch

    device = torch.device(device_name)
    if device.type == "cuda":
        torch.cuda.init()
    marks.append(("torch and CUDA", time.perf_counter()))
    apt = importlib.import_module(PROGRAM)
    cfg, traffic, ref_mod = cell.config, cell.traffic, cell.reference
    T = cfg["num_steps"]
    run = Run(cell=cell, particles_per_call=cell.driver.particles_per_call(traffic),
              steps_per_sweep=T, row_words=ref_mod.row_words(cfg))

    ys, call = program_call(cell, apt, device)
    base = cipher.key(seed)
    marks.append(("program and inputs", time.perf_counter()))

    def key_of(i):
        return cipher.fold_in(base, i)

    for j in range(traffic["warm_sweeps"]):
        logz, _, _ = call(key_of(WARM_BASE - j))
        logz.cpu()
        marks.append((f"warm sweep {j}", time.perf_counter()))
    _sync(torch, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run.setup_s = time.perf_counter() - T_START
    log(f"[{workload}] set-up {run.setup_s:.3f} s; N = {traffic['particles']}, "
        f"C = {traffic['chains']}, T = {T}, threshold {traffic['threshold']}; "
        + ", ".join(f"{name} {b - a:.3f} s" for (_, a), (name, b) in zip(marks, marks[1:]))
        + f" (harness imports {marks[0][1] - T_START:.3f} s)")

    overhead = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        k = traffic["trace_sweeps"]
        _, _, plain_s = _timed(call, key_of, 0, k, torch, device)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            time.sleep(trace.PAD_S)
            run.times, outs, wall = _timed(call, key_of, k, k, torch, device)
            time.sleep(trace.PAD_S)
        run.window_s = wall
        t0 = time.perf_counter()
        run.window = trace.from_profile(prof, wall)
        del prof
        overhead = wall / plain_s - 1.0
        log(f"[{workload}] traced {k} sweeps in {wall:.4f} s against {plain_s:.4f} s untraced "
            f"(overhead {100 * overhead:.2f}%); {len(run.window.device)} device records, "
            f"{len(run.window.runtime)} runtime calls, read in {time.perf_counter() - t0:.1f} s")
        sample = outs
    else:
        run.times, outs, run.window_s = _timed(call, key_of, 0, 0, torch, device, until=seconds)
        import numpy as np

        g = np.random.default_rng([seed, 7])
        picked = g.choice(len(outs), size=min(traffic["reference_sweeps"], len(outs)),
                          replace=False)
        sample = [outs[i] for i in sorted(picked.tolist())]
        q = sorted(run.times)
        log(f"[{workload}] {run.sweeps} sweeps in {run.window_s:.4f} s; a sweep min "
            f"{1e3 * q[0]:.2f}, median {1e3 * q[len(q) // 2]:.2f}, max {1e3 * q[-1]:.2f} ms")
    _sync(torch, device)
    if device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    smi["after"] = _smi_start() if device_name == "cuda" else None
    sample = [(i, z, e.cpu(), f.cpu()) for i, z, e, f in sample]
    del outs, call
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # The reference, on the same observations and keys, after the window.
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    limits = cell.limits
    worst = {name: 0.0 for name in limits}
    failed, owners = 0, []
    for i, logz, ess, fired in sample:
        keys = cell.driver.chain_keys(key_of(i), traffic)
        ref = smc.sweep(ref_mod, cfg, ys.to(device), keys, traffic["particles"],
                        traffic["threshold"])
        got = compare.numbers(logz, ess, fired, ref)
        failed += any(not got[n] <= limits[n] for n in limits)
        worst = {n: max(worst[n], got[n]) for n in limits}
        owners.append(ref.owner_share)
    run.owner_share = sum(owners) / len(owners)
    correct = failed == 0 and all(math.isfinite(v) for v in worst.values())
    log(f"[{workload}] reference over {len(sample)} sweeps in {time.perf_counter() - t0:.1f} s")

    metrics = {}
    for entry in (cell.per_layer if traced else cell.end_to_end):
        value = manifest.metric_reader(entry["name"], cell.root).read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.entry["chips"], "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": correct, "attempted": run.sweeps, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = run.window.busy_s
        dev["window_s"] = run.window.wall_s
        result["breakdown"] = {"device_ops": trace.top_ops(run.window),
                               "idle_gaps": trace.idle_gaps(run.window)}
    result["checks"] = {n: {"value": worst[n], "limit": limits[n]} for n in limits}
    return {"result": result, "trace_overhead": overhead}


def _checkout_caches():
    base = manifest.ROOT / ".bench_cache"
    for var, sub in CACHE_ENV.items():
        os.environ[var] = str(base / sub)
    sys.dont_write_bytecode = False
    sys.pycache_prefix = str(manifest.ROOT / PYCACHE)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _checkout_caches()
    cell = manifest.resolve(args.workload)
    import torch

    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"[{args.workload}] needs {chips} CUDA device(s); "
            f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", cell)
    bad = forbidden_modules()
    if bad:
        log(f"[{args.workload}] refused: modules of JAX or the JAX package were imported: {bad}")
        return 3
    line = {"card": out["card"]}
    if out["trace_overhead"] is not None:
        line["trace_overhead"] = out["trace_overhead"]
    print(json.dumps(line), flush=True)
    res = out["result"]
    for name, c in res["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
