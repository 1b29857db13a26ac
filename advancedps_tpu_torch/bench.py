"""The port's benchmarks: the counterparts of the JAX system's ``bench.py``,
``bench_pgas.py`` and ``bench_scaling.py``, and of its chain entry points.

    python -m advancedps_tpu_torch.bench smc
    python -m advancedps_tpu_torch.bench pgas
    python -m advancedps_tpu_torch.bench scaling [--mode weak|overhead]
        [--per-device 65536] [--total 262144] [--steps 50] [--iters 3]
        [--exchange auto|allgather|neighbor] [--out PATH]
    python -m advancedps_tpu_torch.bench ensemble
    python -m advancedps_tpu_torch.bench chains
    python -m advancedps_tpu_torch.bench schemes [--scheme systematic|stratified|multinomial]
    python -m advancedps_tpu_torch.bench generic

Every mode takes ``--device``; without it the mode runs on the GPU and raises
where there is no CUDA device (it never carries on on the CPU, which is for
callers that name it, as the tests do).  The model is the stationary LGSSM
(a=0.9, q=0.32, r=1.0) over observations simulated from ``rng.key(0)``, the
JAX package's stream.

* ``smc`` (``bench.py``): one bootstrap sweep of N = 1M particles over T = 100
  steps, systematic resampling at ESS ≤ N/2, log-evidence only.  Value: N·T
  over the median of 5 sweeps (particle-steps/s).  Anchor: |logZ − Kalman| < 1.
* ``pgas`` (``bench_pgas.py``): PGAS at N = 1M, T = 100, replay storage.
  Value: iterations/s of the median of 5 windows of 8 iterations; the
  quietest window beside it.  Anchor: the pooled chain means of 6 chains of 8
  iterations (4 dropped) against the RTS smoother (RMS z-score < 3) and the
  final |logZ − Kalman| < 1.
* ``scaling`` (``bench_scaling.py``): sharded PGAS iterations on meshes of 1,
  2, 4 and 8 shards; weak (fixed particles a shard) or overhead (fixed total)
  efficiency.  The shards are logical shards of one device, so overhead mode
  measures the cost of partitioning, not multi-card scaling.
* ``ensemble``: ``parallel.smc_ensemble`` of 8 runs of ``smc``'s sweep as one
  batch.  Value: 8·N·T over the median of 5 (particle-steps/s).
* ``chains``: ``parallel.sample_chains`` of 64 PGAS chains of 16,384
  particles, replay storage, as one batch.  Value: chain-iterations/s of the
  median of 5 windows of 3 iterations.  Anchor: every chain's final
  |logZ − Kalman| < 1.
* ``schemes`` (``profiling/bench_schemes.py``): ``smc``'s sweep with one
  scheme under an always-resample gate (threshold inf: every one of the T − 1
  steps fires, and the sweep reads no gate), beside a never-firing base
  (threshold 0).  Value: N·T over the median of 5 sweeps of the scheme; beside
  it the base's median and the cost of one firing, (median − base median) /
  (T − 1).  Anchor: |logZ − Kalman| < 1, base and scheme.
* ``generic`` (``profiling/bench_generic.py``): the LGSSM of T = 50 steps at
  N = 100k written as a :class:`~advancedps_tpu_torch.generic.GenericModel`
  program of 50 sample sites and 50 observes, and the same model through
  ``SSMKernel``, ESS-gated.  Value: N·T over the median of 5 sweeps of the
  program; beside it the structured form's and their ratio.  Anchor:
  |logZ − Kalman| < 1, both forms.

Each mode writes its diagnostics to stderr and prints one JSON line to stdout:
``metric``, ``value``, ``unit``, ``vs_baseline`` (the value against the native
single-core C++ sweep of :mod:`~advancedps_tpu_torch.ops.native`, in
particle-steps/s or in sweep-equivalents per second), ``device`` (the card's
name and power limit as ``nvidia-smi`` gives them, or ``"cpu"``), ``n_runs``,
``median_s``, ``min_s`` and ``max_s`` of the timed runs, and ``launches``:
each kernel wrapper's launches in the timed runs.  A timed run is timed by the
host clock from a synchronised start to a read of its result; the kernel build
and the first call lie outside it and are reported on stderr.  An anchor that
fails raises :class:`AnchorError`.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from collections import Counter
from typing import Optional, Sequence

import torch

from . import models, rng
from ._device import resolve_device
from .distributions import Normal
from .engine import sweep
from .generic import GenericModel
from .inference import make_kernel, sample
from .ops import _build, native
from .ops import resample as ops
from .parallel import particle_mesh, sample_chains, sharded_step_pg, smc_ensemble
from .pg import PGAS
from .resampling import (ResampleWithESSThreshold, resample_multinomial, resample_stratified,
                         resample_systematic)
from .smc import SMC, SSMKernel
from .ssm import TracedSSM, simulate
from .utils import kalman_filter, kalman_smoother

__all__ = ["AnchorError", "MODES", "SCHEMES", "always_resample", "chains", "device_line",
           "ensemble", "flagship", "generic", "lgssm", "lgssm_program", "main", "pgas", "rts_zrms",
           "scaling", "schemes", "smc"]

N = 1_000_000
T = 100
A, Q, R = 0.9, 0.32, 1.0
SIGMA0 = math.sqrt(Q * Q / (1 - A * A))
#: Timed runs of every mode: sweeps, or windows of iterations.
RUNS = 5
#: bench_pgas.py:34-38: the iterations a chain drops, a timed window's
#: iterations, and the iterations the RTS anchor pools.
WARM_ITERS, BENCH_ITERS, ANCHOR_ITERS = 4, 8, 24
#: bench.py:198-204 and bench_pgas.py:113-119.
EVIDENCE_LIMIT = 1.0
ZRMS_LIMIT = 3.0
ENSEMBLE_RUNS = 8
CHAINS, CHAIN_N, CHAIN_ITERS = 64, 16_384, 3
SHARDS = (1, 2, 4, 8)
#: bench_schemes.py:62-66 (residual stays out, as there).
SCHEMES = {"systematic": resample_systematic, "stratified": resample_stratified,
           "multinomial": resample_multinomial}
#: bench_generic.py:26-28: particles and steps of the generic program.
GENERIC_N, GENERIC_T = 100_000, 50


class AnchorError(RuntimeError):
    """A benchmark's result disagrees with the exact answer."""


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def device_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them, or the
    device type off the GPU."""
    if device.type != "cuda":
        return device.type
    try:
        lines = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
    except (FileNotFoundError, subprocess.CalledProcessError, subprocess.TimeoutExpired):
        lines = []
    if not lines:
        return f"{torch.cuda.get_device_name(device)}, power limit not read"
    index = device.index if device.index is not None else torch.cuda.current_device()
    return lines[min(index, len(lines) - 1)]


def lgssm(steps: int, device: torch.device):
    """The observations ``ys [steps]`` (on the host) and the model traced on
    them, on ``device``."""
    model = models.stationary_lgssm(a=A, q=Q, r=R)
    _, ys = simulate(rng.key(0), model, steps)
    return ys, TracedSSM(model, ys).to(device)


def _kalman(ys):
    return kalman_filter(ys, A, 0.0, Q, 1.0, R, 0.0, SIGMA0)


def _setup(device: torch.device):
    """Build the native baseline and, on the card, the kernels, outside every
    timed window."""
    t0 = time.perf_counter()
    native.library()
    log(f"native baseline build: {time.perf_counter() - t0:.2f}s")
    if device.type == "cuda":
        t0 = time.perf_counter()
        _build.library()
        log(f"kernel build: {time.perf_counter() - t0:.2f}s")


def _launch_counts() -> Counter:
    return Counter({w.__name__: w.launches for w in ops.KERNEL_WRAPPERS})


def _first(label: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"first call ({label}): {time.perf_counter() - t0:.3f}s")
    return out


def _timed(device: torch.device, fn, keys, launches_kernels: bool = True):
    """``fn(key)`` for each key, each timed from a synchronised start to the
    read of its result (``fn`` returns host values).  Returns the seconds,
    the results and the kernel launches of these calls.  On the card the
    calls must launch a resampling kernel, or, with ``launches_kernels``
    false (a sweep that never resamples), none."""
    before = _launch_counts()
    times, outs = [], []
    for k in keys:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        outs.append(fn(k))
        times.append(time.perf_counter() - t0)
    launches = _launch_counts() - before
    if device.type == "cuda" and bool(launches) != launches_kernels:
        raise RuntimeError(f"resampling kernels launched on the card in the timed runs: "
                           f"{dict(launches) or 'none'}")
    return times, outs, launches


def _record(metric: str, value: float, unit: str, vs_baseline: Optional[float],
            device: torch.device, times: Sequence[float], launches: Counter, **extra) -> dict:
    against = "no baseline" if vs_baseline is None else f"{vs_baseline:.4g}x the native baseline"
    log(f"timed runs: {', '.join(f'{t:.4f}' for t in times)} s; median "
        f"{statistics.median(times):.4f} s; {metric} {value:.6g} ({against})")
    return {
        "metric": metric, "value": value, "unit": unit, "vs_baseline": vs_baseline,
        "device": device_line(device), "n_runs": len(times),
        "median_s": statistics.median(times), "min_s": min(times), "max_s": max(times),
        **extra, "launches": dict(sorted(launches.items())),
    }


def _emit(record: dict) -> dict:
    print(json.dumps(record), flush=True)
    return record


def _check_evidence(what: str, log_z, kf_ll: float) -> float:
    err = float((torch.as_tensor(log_z, dtype=torch.float64) - kf_ll).abs().max())
    log(f"{what}: max |logZ - Kalman| {err:.6f} (limit {EVIDENCE_LIMIT})")
    if not err < EVIDENCE_LIMIT:
        raise AnchorError(f"{what}: |logZ - Kalman| = {err} >= {EVIDENCE_LIMIT}")
    return err


def _baseline(ys, n: int) -> float:
    rate = native.native_baseline_rate(ys.numpy(), A, Q, R, SIGMA0, n)
    log(f"native C++ baseline: {rate:.6g} particle-steps/s (n={n}, T={len(ys)}, best of 3)")
    return rate


def flagship(n: int, steps: int, device: torch.device,
             gated: Optional[ResampleWithESSThreshold] = None):
    """``smc``'s sweep: the observations and ``run(key)``, the log-evidence
    (a host float) of one sweep of ``n`` particles keyed ``key``, gated by
    ``gated`` (None: ``SMC(n)``'s systematic resampling at ESS ≤ n/2)."""
    ys, traced = lgssm(steps, device)
    kernel = SSMKernel(traced)
    gated = SMC(n).resampler if gated is None else gated

    def run(key) -> float:
        return sweep(key, kernel, n, gated, store_states=False, device=device).log_evidence.item()

    return ys, run


def smc(device=None, n: int = N, steps: int = T, runs: int = RUNS,
        baseline_n: int = native.N_BASELINE) -> dict:
    """``bench.py``: particle-steps/s of the bootstrap sweep."""
    device = resolve_device(device)
    _setup(device)
    ys, run = flagship(n, steps, device)
    kf_ll = float(_kalman(ys).log_likelihood)
    first = _first(f"N={n}, T={steps}", run, rng.key(1))
    times, log_z, launches = _timed(device, run, [rng.key(2 + i) for i in range(runs)])
    err = _check_evidence("smc", [first, *log_z], kf_ll)
    rate = n * steps / statistics.median(times)
    base = _baseline(ys, baseline_n)
    return _emit(_record(
        "torch_lgssm_sweep_particle_steps_per_sec", rate, "particle-steps/s", rate / base,
        device, times, launches, particles=n, steps=steps, logz_error_vs_kalman=err,
        native_particle_steps_per_sec=base))


def rts_zrms(chain_means, means, variances, kept: int) -> float:
    """RMS z-score of the pooled chain means ``[C, T]`` against the RTS
    smoother's ``means`` and ``variances`` (``bench_pgas.py:103-111``): the
    standard error from the C independent chain means, floored at the
    posterior sd over the ``C · kept`` pooled iterates."""
    cm = torch.as_tensor(chain_means, dtype=torch.float64)
    c = cm.shape[0]
    sd = torch.as_tensor(variances, dtype=torch.float64).sqrt()
    se = torch.maximum(cm.std(0, correction=1) / math.sqrt(c), sd / math.sqrt(c * kept))
    z = (cm.mean(0) - torch.as_tensor(means, dtype=torch.float64)) / se
    return float(z.square().mean().sqrt())


def pgas(device=None, n: int = N, steps: int = T, runs: int = RUNS,
         baseline_n: int = native.N_BASELINE) -> dict:
    """``bench_pgas.py``: PGAS iterations/s, replay storage."""
    device = resolve_device(device)
    _setup(device)
    ys, traced = lgssm(steps, device)
    sampler = PGAS(n)

    def chain(key):
        return sample(key, traced, sampler, BENCH_ITERS, trajectory_storage="replay",
                      device=device)

    _first(f"N={n}, T={steps}, {BENCH_ITERS} iterations",
           lambda: chain(rng.key(1)).log_evidence.cpu())
    times, _, launches = _timed(device, lambda k: chain(k).log_evidence.cpu(),
                                [rng.key(2 + i) for i in range(runs)])
    rate = BENCH_ITERS / statistics.median(times)
    best = BENCH_ITERS / min(times)

    sm = kalman_smoother(ys, A, 0.0, Q, 1.0, R, 0.0, SIGMA0)
    kept = BENCH_ITERS - WARM_ITERS
    n_chains = -(-ANCHOR_ITERS // kept)
    chain_means = []
    for c in range(n_chains):
        res = chain(rng.fold_in(rng.key(9), c))
        chain_means.append(res.trajectory[WARM_ITERS:].double().mean(0).cpu())
    zrms = rts_zrms(torch.stack(chain_means), sm.means, sm.variances, kept)
    log(f"posterior-mean anchor: RMS z-score vs the RTS smoother {zrms:.4f} over {n_chains} "
        f"chains x {BENCH_ITERS} iterations ({WARM_ITERS} dropped; limit {ZRMS_LIMIT})")
    if not zrms < ZRMS_LIMIT:
        raise AnchorError(f"pgas: RMS z-score vs the RTS smoother {zrms} >= {ZRMS_LIMIT}")
    err = _check_evidence("pgas, final iteration", res.log_evidence[-1].cpu(),
                          float(sm.log_likelihood))

    base_iters = _baseline(ys, baseline_n) / (n * steps)
    return _emit(_record(
        "torch_pgas_1m_iterations_per_sec", rate,
        f"iterations/s (N={n}, T={steps}, replay storage; median window)", rate / base_iters,
        device, times, launches, best_iterations_per_sec=best, iterations_per_run=BENCH_ITERS,
        particles=n, steps=steps, rms_z_vs_rts=zrms, logz_error_vs_kalman=err,
        native_sweeps_per_sec=base_iters))


def scaling(device=None, mode: str = "weak", per_device: int = 65536, total: int = 262144,
            steps: int = 50, iters: int = 3, exchange: str = "auto", out: Optional[str] = None,
            shards: Sequence[int] = SHARDS, baseline_n: int = native.N_BASELINE) -> dict:
    """``bench_scaling.py``: sharded PGAS on meshes of ``shards`` logical
    shards of one device, weak or overhead efficiency."""
    if mode not in ("weak", "overhead"):
        raise ValueError(f"unknown scaling mode {mode!r}")
    device = resolve_device(device)
    _setup(device)
    ys, traced = lgssm(steps, device)
    kernel = SSMKernel(traced)
    kf_ll = float(_kalman(ys).log_likelihood)
    rates, seconds, launches = {}, {}, Counter()
    one, top = shards[0], max(shards)

    def efficiency(k: int) -> float:
        """t(one) / t(k) for a fixed total; per shard for a fixed share."""
        return rates[k] / (rates[one] * (k / one if mode == "weak" else 1))

    for k in shards:
        n = per_device * k if mode == "weak" else total
        mesh, sampler = particle_mesh(k, device), PGAS(n)

        def step(key, st):
            smp, st = sharded_step_pg(key, kernel, sampler, mesh, st, exchange=exchange)
            return smp.log_evidence.item(), st

        _, st = step(rng.key(0), None)
        _, st = _first(f"{k} shards, N={n}", step, rng.key(1), st)

        def timed_step(key):
            nonlocal st
            lz, st = step(key, st)
            return lz

        times, log_z, counts = _timed(device, timed_step,
                                      [rng.fold_in(rng.key(2), i) for i in range(iters)])
        launches += counts
        _check_evidence(f"scaling, {k} shards", log_z, kf_ll)
        rates[k], seconds[k] = n * steps / statistics.median(times), times
        log(f"shards={k:2d}  N={n:>9,}  {statistics.median(times) * 1e3:8.1f} ms/iter  "
            f"{rates[k] / 1e6:8.1f} M particle-steps/s  eff={efficiency(k):5.1%}")

    base = _baseline(ys, baseline_n)
    by_shards = {str(k): rates[k] for k in shards}
    eff = {str(k): efficiency(k) for k in shards}
    note = f"{mode} mode on logical shards of one {device.type} device: "
    if mode == "weak":
        extra = {"per_device_particles": per_device, "steps": steps, "exchange": exchange,
                 "particle_steps_per_sec_by_devices": by_shards,
                 "weak_efficiency_by_devices": eff,
                 "note": note + "k shards do k times the work on the same device, so this is "
                                "no multi-card scaling"}
        metric, unit = f"torch_pgas_weak_scaling_eff_{top}shards_{device.type}", "efficiency"
    else:
        extra = {"total_particles": total, "steps": steps, "exchange": exchange,
                 "particle_steps_per_sec_by_devices": by_shards,
                 "overhead_efficiency_by_devices": eff,
                 "note": note + "constant compute, so efficiency < 1 is the partitioning and "
                                "collective overhead of the sharded sweep, not multi-card "
                                "scaling"}
        metric = f"torch_pgas_sharding_overhead_eff_{top}shards_{device.type}"
        unit = "efficiency (t_1shard / t_Kshards at fixed total N)"
    record = _record(metric, eff[str(top)], unit, rates[top] / base, device, seconds[top],
                     launches, **extra, native_particle_steps_per_sec=base)
    if out:
        with open(out, "w") as fh:
            fh.write(json.dumps(record) + "\n")
    return _emit(record)


def ensemble(device=None, n_runs: int = ENSEMBLE_RUNS, n: int = N, steps: int = T,
             runs: int = RUNS, baseline_n: int = native.N_BASELINE) -> dict:
    """``n_runs`` flagship sweeps as one batch (``parallel.smc_ensemble``)."""
    device = resolve_device(device)
    _setup(device)
    ys, traced = lgssm(steps, device)
    sampler = SMC(n)

    def run(key):
        return smc_ensemble(key, traced, sampler, n_runs, store_states=False,
                            device=device).log_evidence.cpu()

    kf_ll = float(_kalman(ys).log_likelihood)
    first = _first(f"{n_runs} x N={n}, T={steps}", run, rng.key(1))
    times, log_z, launches = _timed(device, run, [rng.key(2 + i) for i in range(runs)])
    err = _check_evidence("ensemble, every run", torch.cat([first, *log_z]), kf_ll)
    rate = n_runs * n * steps / statistics.median(times)
    base = _baseline(ys, baseline_n)
    return _emit(_record(
        "torch_lgssm_ensemble_particle_steps_per_sec", rate, "particle-steps/s", rate / base,
        device, times, launches, ensemble_runs=n_runs, particles=n, steps=steps,
        logz_error_vs_kalman=err, native_particle_steps_per_sec=base))


def chains(device=None, n_chains: int = CHAINS, n: int = CHAIN_N, steps: int = T,
           iters: int = CHAIN_ITERS, runs: int = RUNS,
           baseline_n: int = native.N_BASELINE) -> dict:
    """``n_chains`` PGAS chains as one batch (``parallel.sample_chains``),
    replay storage: chain-iterations/s."""
    device = resolve_device(device)
    _setup(device)
    ys, traced = lgssm(steps, device)
    sampler = PGAS(n)

    def window(key):
        return sample_chains(key, traced, sampler, iters, n_chains, trajectory_storage="replay",
                             device=device).log_evidence.cpu()

    kf_ll = float(_kalman(ys).log_likelihood)
    first = _first(f"{n_chains} chains x N={n}, T={steps}, {iters} iterations", window,
                   rng.key(1))
    times, log_z, launches = _timed(device, window, [rng.key(2 + i) for i in range(runs)])
    err = _check_evidence("chains, every chain's final iteration",
                          torch.stack([z[:, -1] for z in (first, *log_z)]), kf_ll)
    rate = n_chains * iters / statistics.median(times)
    base_iters = _baseline(ys, baseline_n) / (n * steps)
    return _emit(_record(
        "torch_pgas_chains_iterations_per_sec", rate,
        f"chain-iterations/s ({n_chains} chains, N={n}, T={steps}, replay storage)",
        rate / base_iters, device, times, launches, chains=n_chains, iterations_per_run=iters,
        particles=n, steps=steps, logz_error_vs_kalman=err, native_sweeps_per_sec=base_iters))


def always_resample(scheme: str) -> ResampleWithESSThreshold:
    """``scheme`` gated at threshold inf: every step fires
    (``bench_schemes.py:119-120``)."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}; valid: {sorted(SCHEMES)}")
    return ResampleWithESSThreshold(SCHEMES[scheme], math.inf)


def schemes(device=None, scheme: str = "systematic", n: int = N, steps: int = T,
            runs: int = RUNS, baseline_n: int = native.N_BASELINE) -> dict:
    """``profiling/bench_schemes.py``: ``smc``'s sweep with ``scheme`` firing
    at every step, beside a base that never fires."""
    gated = always_resample(scheme)
    device = resolve_device(device)
    _setup(device)
    ys, run = flagship(n, steps, device, gated)
    _, run_base = flagship(n, steps, device, ResampleWithESSThreshold(resample_systematic, 0.0))
    kf_ll = float(_kalman(ys).log_likelihood)
    # bench_schemes.py:81-84: key(77) folded per run, the first call run 0.
    keys = [rng.fold_in(rng.key(77), i) for i in range(1 + runs)]
    first_base = _first(f"never-firing base, N={n}, T={steps}", run_base, keys[0])
    base_times, base_z, _ = _timed(device, run_base, keys[1:], launches_kernels=False)
    first = _first(f"{scheme}, every step firing", run, keys[0])
    times, log_z, launches = _timed(device, run, keys[1:])
    _check_evidence("schemes, the never-firing base", [first_base, *base_z], kf_ll)
    err = _check_evidence(f"schemes, {scheme}", [first, *log_z], kf_ll)
    median, base_median = statistics.median(times), statistics.median(base_times)
    per_firing_ms = (median - base_median) / (steps - 1) * 1e3
    log(f"{scheme}: per firing {per_firing_ms:.4f} ms (sweep median {median * 1e3:.3f} ms, base "
        f"median {base_median * 1e3:.3f} ms over {', '.join(f'{t:.4f}' for t in base_times)} s)")
    rate = n * steps / median
    base = _baseline(ys, baseline_n)
    return _emit(_record(
        f"torch_lgssm_{scheme}_always_resample_particle_steps_per_sec", rate, "particle-steps/s",
        rate / base, device, times, launches, scheme=scheme, particles=n, steps=steps,
        base_median_s=base_median, base_min_s=min(base_times), base_max_s=max(base_times),
        per_firing_ms=per_firing_ms, logz_error_vs_kalman=err,
        native_particle_steps_per_sec=base))


def lgssm_program(ys):
    """``bench_generic.py:63-68``: the LGSSM over ``ys`` as a generic program,
    one sample site and one observe a step."""
    ys = [float(y) for y in ys]

    def program(ctx):
        x = ctx.sample(Normal(0.0, SIGMA0), name="x0")
        ctx.observe(Normal(x, R), ys[0])
        for t in range(1, len(ys)):
            x = ctx.sample(Normal(A * x, Q), name=f"x{t}")
            ctx.observe(Normal(x, R), ys[t])

    return program


def generic(device=None, n: int = GENERIC_N, steps: int = GENERIC_T, runs: int = RUNS,
            baseline_n: int = native.N_BASELINE) -> dict:
    """``profiling/bench_generic.py``: the LGSSM as a generic program beside
    the structured kernel on the same observations."""
    device = resolve_device(device)
    _setup(device)
    ys, traced = lgssm(steps, device)
    kf_ll = float(_kalman(ys).log_likelihood)
    gated = SMC(n).resampler
    forms = {"generic": make_kernel(GenericModel(lgssm_program(ys))),
             "structured": SSMKernel(traced)}
    timed = {}
    for form, kernel in forms.items():
        def run(key, kernel=kernel) -> float:
            return sweep(key, kernel, n, gated, store_states=False,
                         device=device).log_evidence.item()

        first = _first(f"{form}, N={n}, T={steps}", run, rng.key(1))
        times, log_z, launches = _timed(device, run, [rng.key(2 + i) for i in range(runs)])
        err = _check_evidence(f"generic, the {form} form", [first, *log_z], kf_ll)
        timed[form] = (times, launches, err, n * steps / statistics.median(times))
    times, launches, err, rate = timed["generic"]
    s_times, s_launches, s_err, s_rate = timed["structured"]
    log(f"generic/structured throughput ratio: {rate / s_rate:.4f}")
    base = _baseline(ys, baseline_n)
    return _emit(_record(
        "torch_generic_lgssm_particle_steps_per_sec", rate, "particle-steps/s", rate / base,
        device, times, launches, particles=n, steps=steps, logz_error_vs_kalman=err,
        structured_median_s=statistics.median(s_times), structured_min_s=min(s_times),
        structured_max_s=max(s_times), structured_particle_steps_per_sec=s_rate,
        structured_logz_error_vs_kalman=s_err, generic_over_structured=rate / s_rate,
        structured_launches=dict(sorted(s_launches.items())),
        native_particle_steps_per_sec=base))


MODES = {"smc": smc, "pgas": pgas, "scaling": scaling, "ensemble": ensemble, "chains": chains,
         "schemes": schemes, "generic": generic}
_HELP = {
    "smc": "particle-steps/s of the bootstrap sweep, N = 1M, T = 100 (bench.py)",
    "pgas": "PGAS iterations/s, N = 1M, T = 100, replay storage (bench_pgas.py)",
    "scaling": "sharded PGAS on 1, 2, 4 and 8 logical shards (bench_scaling.py)",
    "ensemble": "particle-steps/s of 8 bootstrap sweeps of 1M as one batch",
    "chains": "chain-iterations/s of 64 PGAS chains of 16,384 as one batch",
    "schemes": "one scheme firing at every step beside a never-firing base "
               "(profiling/bench_schemes.py)",
    "generic": "the LGSSM as a generic program beside SSMKernel, N = 100k, T = 50 "
               "(profiling/bench_generic.py)",
}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(prog="python -m advancedps_tpu_torch.bench",
                                description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="command", required=True)
    parsers = {name: sub.add_parser(name, help=_HELP[name]) for name in MODES}
    for sp in parsers.values():
        sp.add_argument("--device", default=None,
                        help="torch device (default: the GPU; raises without one)")
    s = parsers["scaling"]
    s.add_argument("--mode", dest="scaling_mode", default="weak", choices=["weak", "overhead"])
    s.add_argument("--per-device", type=int, default=65536)
    s.add_argument("--total", type=int, default=262144, help="total particles in --mode overhead")
    s.add_argument("--steps", type=int, default=50)
    s.add_argument("--iters", type=int, default=3)
    s.add_argument("--exchange", default="auto", choices=["auto", "allgather", "neighbor"])
    s.add_argument("--out", default=None, help="also write the JSON record here")
    parsers["schemes"].add_argument("--scheme", default="systematic", choices=sorted(SCHEMES))
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if args.command == "scaling":
        return scaling(device, args.scaling_mode, args.per_device, args.total, args.steps,
                       args.iters, args.exchange, args.out)
    if args.command == "schemes":
        return schemes(device, args.scheme)
    return MODES[args.command](device)


if __name__ == "__main__":
    main()
